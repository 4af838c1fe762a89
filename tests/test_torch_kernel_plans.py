"""What the hand-written kernels' host side plans, on the CPU.

The CUDA kernels run only on the card, but the layouts and schedules they
are launched with are made in Python (``ops/kernels/stem.py``,
``ops/kernels/shuffle.py``).  These tests hold those against the JAX
package and the plain versions:

* K3 (stem conv): the bf16 kernel's packed weight matrix (K over taps ×
  4 channels, the bias as a 28th tap, GEMM columns permuted) and the fp32
  kernel's weight rows, each times an im2col of the padded input, equal the
  JAX package's Pallas stem (interpret mode); and the tile schedule covers
  every output pixel exactly once.
* K2 (subpixel interleave): the kernel's vector/scalar choice and its index
  map, emulated in torch, equal ``subpixel_interleave_plain`` bit for bit,
  and its thread and row mapping covers every output unit once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cvvae_tpu.ops import conv as jconv
from cvvae_tpu.ops.pallas.stem import stem_conv3d as j_stem

from cvvae_tpu_torch.ops.kernels import _build
from cvvae_tpu_torch.ops.kernels import shuffle as k2
from cvvae_tpu_torch.ops.kernels import stem as k3

torch.set_num_threads(2)


def _np(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# K3: packed weights and tile schedule
# ---------------------------------------------------------------------------

def _padded_taps(x, pads, modes):
    """(B, T, H, W, Cin) -> (B, T', H', W', 27, Cin): each output pixel's
    27 input pixels in (dt, dh, dw) order, padded as the spec says."""
    (t0, t1), (h0, h1), (w0, w1) = pads
    xn = x.permute(0, 4, 1, 2, 3)
    if modes[0] == "edge":
        xn = torch.nn.functional.pad(xn, (0, 0, 0, 0, t0, t1), mode="replicate")
        t0 = t1 = 0
    xn = torch.nn.functional.pad(xn, (w0, w1, h0, h1, t0, t1))
    xp = xn.permute(0, 2, 3, 4, 1)                   # (B, Tp, Hp, Wp, Cin)
    tp, hp, wp = xp.shape[1:4]
    taps = [xp[:, dt:tp - 2 + dt, dh:hp - 2 + dh, dw:wp - 2 + dw]
            for dt in range(3) for dh in range(3) for dw in range(3)]
    return torch.stack(taps, dim=4)


@pytest.mark.parametrize("layout", ["mma", "fma"])
@pytest.mark.parametrize("cin,mode,pads", [
    (3, "edge", ((2, 0), (1, 1), (1, 1))),     # the v1 pixel stem
    (3, "zero", ((1, 1), (1, 1), (1, 1))),
    (4, "edge", ((2, 0), (1, 1), (1, 1))),
    (4, "zero", ((1, 1), (1, 1), (1, 1))),     # the latent stem
])
def test_stem_packed_weights_times_im2col_match_jax(layout, cin, mode, pads):
    """The kernels' weight layouts times an im2col of the input, in fp32,
    against the Pallas stem in interpret mode: |d| <= 1e-5 (1 + |ref|)."""
    modes = (mode, "zero", "zero")
    spec = jconv.Conv3DSpec((3, 3, 3), (1, 1, 1), pads, modes)
    x = _np((1, 5, 16, 12, cin), 15)
    kernel = _np((3, 3, 3, cin, 128), 16, 0.1)
    bias = _np((128,), 17)
    ref = np.asarray(j_stem(jnp.asarray(x), jnp.asarray(kernel),
                            jnp.asarray(bias), spec, interpret=True))
    weight = torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy())
    b = torch.from_numpy(bias)
    taps = _padded_taps(torch.from_numpy(x), pads, modes)
    if layout == "mma":
        # the A rows the bf16 kernel builds: 4 channels a tap, tap 27 = 1, 0..
        a = torch.nn.functional.pad(taps, (0, 4 - cin, 0, 1))
        a[..., 27, 0] = 1.0
        tap, ci = k3.k_order()
        cols = a[..., tap, ci] @ k3.pack_weight(weight, b).T
        got = torch.empty_like(cols)
        got[..., k3.column_channels()] = cols
    else:
        got = taps.reshape(taps.shape[:4] + (27 * cin,)) \
            @ k3.pack_weight_fp32(weight) + b
    assert got.shape == ref.shape
    np.testing.assert_array_less(np.abs(got.numpy() - ref),
                                 1e-5 * (1 + np.abs(ref)))


def test_schedule_constants_are_read_from_the_kernel_sources():
    """The wrappers plan with the kernels' own constexprs: K3's packed K
    is the 28 taps x 4 channels that ``k_order`` lays out, and a name the
    source does not define once raises."""
    assert k3.K_PACKED == 28 * 4 and k3.COUT == 128
    assert k3.TILE_W % 16 == 0 and k2.UNROLL >= 1 and k2.THREADS % 32 == 0
    with pytest.raises(RuntimeError):
        _build.constants("stem.cu", "kNoSuchConstant")


def test_stem_packing_orders_are_permutations():
    """Every (tap, channel) of the 28 x 4 once, every channel once; the
    padding channels of a Cin < 4 stem are zero."""
    tap, ci = k3.k_order()
    assert sorted(zip(tap.tolist(), ci.tolist())) == [
        (t, c) for t in range(28) for c in range(4)]
    cc = k3.column_channels()
    assert sorted(cc.tolist()) == list(range(k3.COUT))
    w = torch.from_numpy(_np((128, 3, 3, 3, 3), 1))
    packed = k3.pack_weight(w, None)
    assert (packed[:, ci == 3] == 0).all() and (packed[:, tap == 27] == 0).all()


@pytest.mark.parametrize("workers_per_block", sorted(
    set(k3.WORKERS_PER_BLOCK.values())))
@pytest.mark.parametrize("b,t_out,h_out,w_out,sms", [
    (2, 5, 19, 37, 132),      # ragged W, one tile a row
    (2, 1, 1, 130, 132),      # T = 1, H = 1, W one past two tiles
    (1, 1, 19, 193, 3),       # W = 129 + a tile, few SMs: many tiles each
    (2, 3, 1, 64, 5),         # whole tiles
    (1, 17, 45, 80, 132),     # more tiles than workers, ragged W
])
def test_stem_tile_schedule_covers_every_pixel_once(workers_per_block, b,
                                                    t_out, h_out, w_out, sms):
    plan = k3.tile_plan(b, t_out, h_out, w_out, sms, workers_per_block)
    assert plan["workers"] == plan["grid"] * workers_per_block
    assert 1 <= plan["grid"] <= sms
    hits = np.zeros((b, t_out, h_out, w_out), np.int64)
    for worker in range(plan["workers"]):
        for idx in range(worker, plan["n_tiles"], plan["workers"]):
            bb, to, ho, w0, npx = k3.tile_origin(idx, plan["n_wt"], t_out,
                                                 h_out, w_out)
            assert 1 <= npx <= k3.TILE_W and w0 % k3.TILE_W == 0
            hits[bb, to, ho, w0:w0 + npx] += 1
    assert (hits == 1).all()


# ---------------------------------------------------------------------------
# K2: the interleave's plan and index map
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _emulate_interleave(phases, bias, n, drop_first, sms=2):
    """The kernel's arithmetic on the CPU: the plan, then every output
    unit (``vec`` elements) from its source unit by the kernel's index map
    (row r = (b, t_out, y); column x; unit ci of the pixel), plus the bias
    as one fp32 add rounded to the dtype."""
    b, t, h, w, nc = phases[0].shape
    c = nc // n
    drop = 1 if (n > 1 and drop_first) else 0
    t_out = n * t - drop
    rows = b * t_out * 2 * h
    plan = k2.launch_plan(phases, bias, c, rows, sms)
    vec, cv, w2, h2 = plan["vec"], c // plan["vec"], 2 * w, 2 * h
    r = torch.arange(rows)[:, None, None]
    x = torch.arange(w2)[None, :, None]
    ci = torch.arange(cv)[None, None, :]
    y, bt = r % h2, r // h2
    to, bb = bt % t_out, bt // t_out
    ts, j = (to + drop) // n, (to + drop) % n
    src = (((bb * t + ts) * h + (y >> 1)) * w * (n * cv) + j * cv
           + (x >> 1) * (n * cv) + ci)
    phase = (y & 1) * 2 + (x & 1)
    units = torch.stack([p.reshape(-1, vec) for p in phases])
    out = units[phase.expand(src.shape), src]        # (rows, 2W, cv, vec)
    if bias is not None:
        bu = bias.reshape(-1, vec)[(j * cv + ci).expand(src.shape)]
        out = (out.float() + bu.float()).to(out.dtype)
    return plan, out.reshape(b, t_out, h2, w2, c)


def _thread_map_covers_once(plan, c, rows, w2):
    """Each block row loop, each (threadIdx.x, threadIdx.y) unit and
    pixel loop of the kernel, counted: every (row, x, ci) once."""
    cv, bx, by, grid = c // plan["vec"], plan["bx"], plan["by"], plan["grid"]
    row_hits = np.zeros(rows, np.int64)
    for blk in range(grid):
        row_hits[blk:rows:grid] += 1
    ci_hits = np.zeros(cv, np.int64)
    for tx in range(bx):
        ci_hits[tx:cv:bx] += 1
    x_hits = np.zeros(w2, np.int64)
    for ty in range(by):
        for x0 in range(ty, w2, by * k2.UNROLL):
            for u in range(k2.UNROLL):
                if x0 + u * by < w2:
                    x_hits[x0 + u * by] += 1
    return (row_hits == 1).all() and (ci_hits == 1).all() and \
        (x_hits == 1).all()


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("c,dtype,vec", [
    (4, torch.bfloat16, 1), (8, torch.bfloat16, 8), (20, torch.bfloat16, 1),
    (256, torch.bfloat16, 8), (4, torch.float32, 4), (20, torch.float32, 4),
])
def test_interleave_plan_and_index_map_match_plain(c, dtype, vec, n, drop,
                                                   with_bias):
    b, t, h, w = 2, 3, 5, 7
    phases = [torch.from_numpy(_np((b, t, h, w, n * c), 30 + i)).to(dtype)
              for i in range(4)]
    phases[1].view(-1)[3] = -0.0                # a pure copy keeps -0
    bias = (torch.from_numpy(_np((n * c,), 40)).to(dtype) if with_bias
            else None)
    plan, got = _emulate_interleave(phases, bias, n, drop)
    assert plan["vec"] == vec
    assert plan["bx"] * plan["by"] <= k2.THREADS
    ref = k2.subpixel_interleave_plain(phases, bias, n=n, drop_first=drop)
    assert got.shape == ref.shape
    assert torch.equal(_bits(got), _bits(ref.contiguous()))
    rows = ref.shape[0] * ref.shape[1] * ref.shape[2]
    assert _thread_map_covers_once(plan, c, rows, 2 * w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["phase", "bias"])
def test_interleave_misaligned_view_takes_the_scalar_path(dtype, which):
    """A phase (or the bias) one element past a 16-byte boundary: the plan
    moves single elements, and its index map stays bit-exact."""
    shape, n, c = (1, 3, 4, 5, 2 * 256), 2, 256
    phases = [torch.from_numpy(_np(shape, i)).to(dtype) for i in range(4)]
    bias = torch.from_numpy(_np((n * c,), 9)).to(dtype)
    aligned, _ = _emulate_interleave(phases, bias, n, True)
    assert aligned["vec"] == 16 // phases[0].element_size()
    if which == "phase":
        flat = torch.empty(phases[2].numel() + 1, dtype=dtype)
        flat[1:] = phases[2].reshape(-1)
        phases[2] = flat[1:].view(shape)
    else:
        flat = torch.empty(bias.numel() + 1, dtype=dtype)
        flat[1:] = bias
        bias = flat[1:]
    plan, got = _emulate_interleave(phases, bias, n, True)
    assert plan["vec"] == 1
    ref = k2.subpixel_interleave_plain(phases, bias, n=n)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("rows,sms", [(12240, 132), (1620, 132), (3, 132),
                                      (1000, 7)])
def test_interleave_grid_gives_every_block_as_many_rows(rows, sms):
    """At most BLOCKS_PER_SM blocks an SM, and the rows split so no block
    takes more than one row over any other."""
    ph = [torch.zeros((1, 1, 1, 1, 256), dtype=torch.bfloat16)] * 4
    grid = k2.launch_plan(ph, None, 256, rows, sms)["grid"]
    assert 1 <= grid <= sms * k2.BLOCKS_PER_SM
    per = [len(range(k, rows, grid)) for k in range(grid)]
    assert min(per) >= 1 and max(per) - min(per) <= 1
