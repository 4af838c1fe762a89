"""K1.bwd's host side on the CPU: its plan, the layouts its wrapper hands
the kernel, and an emulation of the kernel's schedule.

The CUDA kernel (``csrc/groupnorm_bwd.cu``) runs only on the card; what it
is launched with is made in Python (``ops/kernels/groupnorm.py``):

* ``backward_plan`` covers every row of every batch row exactly once,
  keeps its partial sums within their stated fraction of x, and never asks
  for more blocks than the card holds at once (the cooperative launch
  refuses a grid that is not resident);
* the merge adds each (row, channel)'s chunks in an order fixed by the
  plan alone, whatever order the blocks finish in;
* the kernel's schedule emulated here (each tile's sums folded row slot by
  row slot, the fixed-order merge in float64, the rows' sums in row order,
  the apply coefficients) equals ``group_norm_silu_backward_plain`` in
  float64 and in fp32, and ``jax.vjp`` of the JAX package's
  ``group_norm`` (+ ``silu``) in fp32;
* the statistics and parameters are read where they lie (the forward's
  (B', G, 2) buffer at stride 2, no copy), a shape the kernel does not
  take raises before anything is planned, and the ctypes plan matches the
  kernel's struct field for field;
* each K1.bwd variant of ``utils/kernel_variants.py`` applies to the
  source once.

Tolerances: float64 1e-10 (the same algebra in another order); fp32
against the plain version ``chip_smoke.K1_BWD_RMS`` (what the card is
held to); fp32 against JAX 2e-5 * (1 + max|ref|), as
``test_torch_train_kernels.py`` holds the plain version.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.ops.activations import silu as jsilu
from cvvae_tpu.ops.norm import group_norm as jgroup_norm
from cvvae_tpu.ops.norm import group_norm_per_frame as jgroup_norm_per_frame

import chip_smoke
from cvvae_tpu_torch.ops.kernels import _build, groupnorm
from cvvae_tpu_torch.utils import kernel_variants

torch.set_num_threads(2)

#: (B', S, C, G, element size, SMs)
PLAN_CASES = [
    (1, 17 * 256 * 256, 128, 32, 2, 132),   # SD3 level-0 norm, bf16
    (1, 17 * 256 * 256, 128, 32, 4, 132),   # fp32
    (5, 1024, 512, 32, 4, 132),             # per-frame attention norm
    (5, 1024, 512, 32, 2, 132),
    (5, 256 * 256, 128, 32, 2, 132),        # vae2d level 0, per frame
    (1, 9 * 128 * 128, 64, 32, 4, 132),     # Disc3D block 0
    (8, 1600, 512, 32, 2, 132),             # the images' mid-block, per frame
    (300, 40, 128, 32, 4, 132),             # more batch rows than blocks
    (1, 3, 128, 32, 2, 132),                # S below the least rows
    (2, 33, 96, 32, 4, 2),                  # C / G = 3
    (1, 1000, 1022, 2, 4, 4),               # V = 2, 512 threads
    (3, 70, 1021, 1, 2, 3),                 # V = 1, 1024 threads
]


def _max_threads(v):
    return 256 if v > 2 else 1024


@pytest.mark.parametrize("b,s,c,g,e,sms", PLAN_CASES)
def test_backward_plan_covers_every_row_once(b, s, c, g, e, sms):
    """Every (batch row, row) lies in exactly one tile, every tile belongs
    to exactly one block, and within a tile every (row, vector column) to
    exactly one thread."""
    p = groupnorm.backward_plan(b, s, c, g, e, sms)
    assert c % p["v"] == 0 and p["v"] * e <= 16
    nvc = c // p["v"]
    assert p["rows_per_iter"] == p["threads"] // nvc >= 1
    assert p["threads"] % 32 == 0 and p["threads"] <= _max_threads(p["v"])
    seen = np.zeros((b, s), np.int64)
    owner = np.full(p["tiles"], -1)
    for block in range(p["grid"]):
        for t in range(block, p["tiles"], p["grid"]):
            assert owner[t] == -1
            owner[t] = block
            bi, k = divmod(t, p["n_chunks"])
            r0 = k * p["rows_per_chunk"]
            r1 = min(s, r0 + p["rows_per_chunk"])
            assert r1 > r0
            seen[bi, r0:r1] += 1
    assert (owner >= 0).all() and (seen == 1).all()
    assert p["tiles"] == b * p["n_chunks"]
    # the thread slots of a tile: ty takes rows ty, ty + rows_per_iter, ...
    rows = p["rows_per_chunk"]
    slots = np.zeros(rows, np.int64)
    for ty in range(p["rows_per_iter"]):
        slots[ty::p["rows_per_iter"]] += 1
    assert (slots == 1).all()


@pytest.mark.parametrize("b,s,c,g,e,sms", PLAN_CASES)
def test_backward_plan_partial_sums_stay_a_fraction_of_x(b, s, c, g, e, sms):
    """The tiles' fp32 sums take at most 8 / (BWD_MIN_ROWS * e) of x's
    bytes (1/8 in bf16, 1/16 in fp32) where S has BWD_MIN_ROWS rows, else
    one tile a batch row; the scratch adds only the rows' float64 sums."""
    p = groupnorm.backward_plan(b, s, c, g, e, sms)
    x_bytes = b * s * c * e
    if s >= groupnorm.BWD_MIN_ROWS:
        assert p["rows_per_chunk"] >= groupnorm.BWD_MIN_ROWS
        assert p["part_bytes"] * groupnorm.BWD_MIN_ROWS * e <= 8 * x_bytes
    else:
        assert p["n_chunks"] == 1 and p["part_bytes"] == 8 * b * c
    assert p["part_bytes"] == p["tiles"] * c * 2 * 4
    assert p["scratch_floats"] * 4 == p["part_bytes"] + b * c * 2 * 8


@pytest.mark.parametrize("b,s,c,g,e,sms", PLAN_CASES)
def test_backward_grid_never_exceeds_the_resident_capacity(b, s, c, g, e,
                                                           sms):
    """grid <= capacity = SMs x blocks an SM, and the blocks an SM the plan
    counts fit within what the kernel's __launch_bounds__ keeps resident
    (max_threads x min_blocks threads an SM); a shape with more tiles than
    the card holds fills every resident slot."""
    p = groupnorm.backward_plan(b, s, c, g, e, sms)
    per_sm = max(1, groupnorm.BWD_RESIDENT_THREADS // p["threads"])
    assert p["capacity"] == sms * per_sm
    assert p["grid"] <= p["capacity"]
    mt = _max_threads(p["v"])
    min_blocks = max(1, groupnorm.BWD_RESIDENT_THREADS // mt)
    assert per_sm * p["threads"] <= max(mt * min_blocks, p["threads"])
    if p["tiles"] >= p["capacity"]:
        assert p["grid"] == p["capacity"]
    if b <= p["capacity"] and s >= groupnorm.BWD_MIN_ROWS * 2:
        assert p["n_chunks"] >= 2 or p["capacity"] // b < 2


def test_kernel_launch_bounds_follow_the_plans_constants():
    """The source's __launch_bounds__ use kResidentThreads, which the plan
    reads (``_build.constants``); the launch is cooperative, and no sum
    takes an atomic."""
    text = (_build.CSRC / "groupnorm_bwd.cu").read_text()
    assert "__launch_bounds__(max_threads<V>(), min_blocks<V>())" in text
    assert "kResidentThreads / max_threads<V>()" in text
    assert "cudaLaunchCooperativeKernel" in text
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.", text)


def test_ctypes_plan_matches_the_kernels_struct():
    """``_build.GroupNormBwdPlan`` lists the fields of the source's ``struct
    Plan`` in order, int64_t as c_int64 and int as c_int."""
    text = (_build.CSRC / "groupnorm_bwd.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", text, re.S).group(1)
    fields = []
    for decl in re.findall(r"^\s*(int64_t|int) ([^;]+);", body, re.M):
        kind, names = decl
        for name in names.split(","):
            fields.append((name.strip(), kind))
    want = [(n, "int64_t" if t is _build._L else "int")
            for n, t in _build.GroupNormBwdPlan._fields_]
    assert fields == want


# ---------------------------------------------------------------------------
# the merge's order and an emulation of the kernel's schedule
# ---------------------------------------------------------------------------

def _merge(part):
    """The kernel's merge of (..., n_chunks) sums, in float64: lane l adds
    chunks l, l + 32, ... in turn from 0, then a butterfly (lane l adds
    lane l ^ o's sum, o = 16, 8, 4, 2, 1); lane 0's result."""
    part = part.double()
    n = part.shape[-1]
    lanes = []
    for lane in range(32):
        acc = torch.zeros(part.shape[:-1], dtype=torch.float64)
        for k in range(lane, n, 32):
            acc = acc + part[..., k]
        lanes.append(acc)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    return lanes[0]


def _lane_chunks(n):
    return [list(range(lane, n, 32)) for lane in range(32)]


@pytest.mark.parametrize("n", [1, 7, 32, 33, 264])
def test_merge_order_is_fixed_by_the_plan(n):
    """Each chunk is added once, by one lane, in ascending order; the
    result depends on the chunks' values alone, not on the order in which
    the blocks wrote them: blocks finishing in two random orders give the
    same bits.  (Adding in arrival order, as atomics would, does not.)"""
    lanes = _lane_chunks(n)
    assert sorted(k for lane in lanes for k in lane) == list(range(n))
    assert all(lane == sorted(lane) for lane in lanes)
    vals = torch.from_numpy(np.random.RandomState(n).randn(64, n) * 10 **
                            np.random.RandomState(n + 1).uniform(-3, 3, n))
    results = []
    for seed in (0, 1):
        part = torch.full_like(vals, float("nan"))
        for k in np.random.RandomState(seed).permutation(n):
            part[:, k] = vals[:, k]
        results.append(_merge(part))
    assert torch.equal(results[0], results[1])
    np.testing.assert_allclose(results[0].numpy(),
                               vals.numpy().sum(axis=1), rtol=1e-12,
                               atol=1e-12 * np.abs(vals.numpy()).sum())


def _emulate(plan, dy, x, weight, bias, mean, inv, silu, per_frame, acc):
    """The kernel's schedule in ``acc`` (float64, or fp32 as the card
    computes): (dx, dweight, dbias)."""
    bb_, g = mean.shape
    c = x.shape[-1]
    cg = c // g
    xs = x.reshape(bb_, -1, c).to(acc)
    ds = dy.reshape(xs.shape).to(acc)
    s = xs.shape[1]
    m = mean.to(acc).repeat_interleave(cg, dim=1)          # (B', C)
    iv = inv.to(acc).repeat_interleave(cg, dim=1)
    a = iv * weight.to(acc)
    bz = bias.to(acc) - m * a
    part = torch.full((bb_, c, plan["n_chunks"], 2), float("nan"),
                      dtype=torch.float64)
    rpi = plan["rows_per_iter"]

    def dz_of(bi, r0, r1):
        d = ds[bi, r0:r1]
        if silu:
            z = xs[bi, r0:r1] * a[bi] + bz[bi]
            sg = torch.sigmoid(z)
            d = d * sg * (1 + z * (1 - sg))
        return d

    for block in range(plan["grid"]):
        for t in range(block, plan["tiles"], plan["grid"]):
            bi, k = divmod(t, plan["n_chunks"])
            r0 = k * plan["rows_per_chunk"]
            r1 = min(s, r0 + plan["rows_per_chunk"])
            dz = dz_of(bi, r0, r1)
            xm = xs[bi, r0:r1] - m[bi]
            s1 = torch.zeros(c, dtype=acc)
            s2 = torch.zeros(c, dtype=acc)
            for ty in range(rpi):          # the block's fold, slot by slot
                s1 = s1 + dz[ty::rpi].sum(0)
                s2 = s2 + (dz[ty::rpi] * xm[ty::rpi]).sum(0)
            part[bi, :, k, 0] = s1.double()
            part[bi, :, k, 1] = s2.double()
    assert not part.isnan().any()
    row1 = _merge(part[..., 0])
    row2 = _merge(part[..., 1]) * inv.double().repeat_interleave(cg, dim=1)
    dbias = torch.zeros(c, dtype=torch.float64)
    dweight = torch.zeros(c, dtype=torch.float64)
    for bi in range(bb_):                   # the rows in order
        dbias = dbias + row1[bi]
        dweight = dweight + row2[bi]
    w64 = weight.double()
    sa = (w64 * row1).reshape(bb_, g, cg).sum(-1)
    sb = (w64 * row2).reshape(bb_, g, cg).sum(-1)
    n = s * cg
    q = (-sb * inv.double() ** 2 / n).to(acc).repeat_interleave(cg, dim=1)
    r = (-sa * inv.double() / n).to(acc).repeat_interleave(cg, dim=1)
    dx = torch.empty_like(xs)
    for bi in range(bb_):
        dz = dz_of(bi, 0, s)
        dx[bi] = a[bi] * dz + (q[bi] * (xs[bi] - m[bi]) + r[bi])
    out = torch.float32 if acc == torch.float32 else torch.float64
    return (dx.reshape(x.shape).to(x.dtype), dweight.to(out),
            dbias.to(out))


#: (shape, groups, silu, per_frame, SMs the plan assumes)
EMU_CASES = [
    ((2, 3, 10, 14, 64), 32, True, False, 2),
    ((1, 5, 9, 7, 128), 32, False, True, 2),
    ((1, 2, 4, 4, 8), 4, True, False, 132),
    ((1, 7, 11, 13, 64), 8, True, False, 1),     # ragged last chunk
    ((1, 1, 1, 3, 32), 8, True, False, 132),     # S below the least rows
    ((2, 3, 5, 7, 96), 32, True, False, 3),      # C / G = 3
    ((1, 4, 12, 16, 32), 4, False, True, 1),     # tiles of several rows a block
]


def _case_inputs(shape, groups, silu, per_frame, dtype):
    x, dy, w, b = chip_smoke.k1_bwd_inputs(shape, torch.device("cpu"), dtype)
    _, mean, inv = groupnorm._plain_forward(x, w, b, groups, 1e-6, silu,
                                            per_frame)
    bb_ = shape[0] * (shape[1] if per_frame else 1)
    return x, dy, w, b, mean.reshape(bb_, groups), inv.reshape(bb_, groups)


def _plan_for(x, groups, per_frame, sms):
    b = x.shape[0] * (x.shape[1] if per_frame else 1)
    c = x.shape[-1]
    return groupnorm.backward_plan(b, x.numel() // (b * c), c, groups,
                                   x.element_size(), sms)


@pytest.mark.parametrize("shape,groups,silu,per_frame,sms", EMU_CASES)
def test_emulated_schedule_matches_plain_float64(shape, groups, silu,
                                                 per_frame, sms):
    x, dy, w, b, mean, inv = _case_inputs(shape, groups, silu, per_frame,
                                          torch.float64)
    plan = _plan_for(x, groups, per_frame, sms)
    got = _emulate(plan, dy, x, w.double(), b.double(), mean, inv, silu,
                   per_frame, torch.float64)
    ref = groupnorm.group_norm_silu_backward_plain(
        dy, x, w.double(), b.double(), mean, inv, silu=silu,
        per_frame=per_frame)
    for name, g_, r_ in zip(("dx", "dweight", "dbias"), got, ref):
        torch.testing.assert_close(g_, r_, rtol=1e-10, atol=1e-10,
                                   msg=name)


@pytest.mark.parametrize("shape,groups,silu,per_frame,sms", EMU_CASES)
def test_emulated_schedule_matches_plain_fp32(shape, groups, silu, per_frame,
                                              sms):
    """In the card's arithmetic (fp32 elements and tile sums, float64
    merges) within K1_BWD_RMS[fp32] of the plain version, as the card's
    kernel is held."""
    x, dy, w, b, mean, inv = _case_inputs(shape, groups, silu, per_frame,
                                          torch.float32)
    plan = _plan_for(x, groups, per_frame, sms)
    got = _emulate(plan, dy, x, w, b, mean, inv, silu, per_frame,
                   torch.float32)
    ref = groupnorm.group_norm_silu_backward_plain(
        dy, x, w, b, mean, inv, silu=silu, per_frame=per_frame)
    tol = chip_smoke.K1_BWD_RMS[torch.float32]
    for name, g_, r_ in zip(("dx", "dweight", "dbias"), got, ref):
        assert g_.dtype == r_.dtype == torch.float32
        rel = ((g_.double() - r_.double()).norm() / r_.double().norm()).item()
        assert rel <= tol, (name, rel)


@pytest.mark.parametrize("shape,groups,silu,per_frame,sms", EMU_CASES)
def test_emulated_schedule_matches_jax_vjp(shape, groups, silu, per_frame,
                                           sms):
    """The fp32 emulation on JAX's own statistics against ``jax.vjp`` of
    the JAX package's group_norm (+ silu)."""
    r = np.random.RandomState(7)
    c = shape[-1]
    x = (r.randn(*shape) * np.linspace(1, 3, c)
         + np.linspace(-2, 2, c)).astype(np.float32)
    w = (1 + 0.3 * r.randn(c)).astype(np.float32)
    b = (0.3 * r.randn(c)).astype(np.float32)
    dy = r.randn(*shape).astype(np.float32)
    fn = jgroup_norm_per_frame if per_frame else jgroup_norm

    def f(x, w, b):
        y = fn(x, {"scale": w, "bias": b}, num_groups=groups, eps=1e-6)
        return jsilu(y) if silu else y

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = [np.asarray(g_) for g_ in vjp(jnp.asarray(dy))]
    xt, wt, bt, dyt = (torch.from_numpy(a) for a in (x, w, b, dy))
    _, mean, inv = groupnorm._plain_forward(xt, wt, bt, groups, 1e-6, silu,
                                            per_frame)
    bb_ = mean.shape[0]
    plan = _plan_for(xt, groups, per_frame, sms)
    got = _emulate(plan, dyt, xt, wt, bt, mean.reshape(bb_, groups),
                   inv.reshape(bb_, groups), silu, per_frame, torch.float32)
    for name, g_, r_ in zip(("dx", "dweight", "dbias"), got, ref):
        np.testing.assert_allclose(g_.numpy(), r_, rtol=0,
                                   atol=2e-5 * (1 + np.abs(r_).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# what the wrapper hands the kernel
# ---------------------------------------------------------------------------

def test_forward_statistics_are_read_in_place():
    """The forward's (B', G, 2) buffer's views pass as they are, at stride
    2, sharing its storage; other layouts are made contiguous."""
    stats = torch.randn(5, 32, 2)
    mean, inv = stats[..., 0], stats[..., 1]
    m, i, k = groupnorm._stats_layout(mean, inv, "cpu")
    assert k == 2 and m.data_ptr() == stats.data_ptr()
    assert i.data_ptr() == stats.data_ptr() + 4
    m, i, k = groupnorm._stats_layout(mean.contiguous(), inv.contiguous(),
                                      "cpu")
    assert k == 1
    m, i, k = groupnorm._stats_layout(mean.t().contiguous().t(), inv, "cpu")
    assert k == 1 and m.is_contiguous() and i.is_contiguous()
    m, i, k = groupnorm._stats_layout(mean.double(), inv.double(), "cpu")
    assert m.dtype == i.dtype == torch.float32 and k == 1


@pytest.mark.parametrize("wd,bd,want", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float64, torch.float64, torch.float32),
])
def test_parameters_are_read_in_their_own_dtype(wd, bd, want):
    w, b = torch.randn(64, dtype=wd), torch.randn(64, dtype=bd)
    w2, b2 = groupnorm._param_layout(w, b, "cpu")
    assert w2.dtype == b2.dtype == want
    if wd == bd == want:
        assert w2.data_ptr() == w.data_ptr() and b2.data_ptr() == b.data_ptr()


@pytest.mark.parametrize("shape,stats,params,per_frame", [
    ((1, 5, 4, 4, 64), (4, 32), (64,), True),      # rows of the wrong count
    ((1, 2, 2, 2, 2048), (1, 32), (2048,), False),  # C past 1024
    ((1, 5, 4, 4, 64), (1, 32), (32,), False),     # parameters of another C
    ((1, 5, 4, 4, 60), (1, 32), (60,), False),     # C % G != 0
    ((5, 4, 64), (5, 32), (64,), True),            # per frame needs a T axis
])
def test_backward_launch_refuses_shapes_it_does_not_take(shape, stats, params,
                                                        per_frame):
    """What the kernel does not take raises before anything is planned."""
    with pytest.raises(ValueError):
        groupnorm._backward_launch(torch.Size(shape), torch.Size(stats),
                                   torch.Size(params), torch.float32,
                                   torch.float32, True, per_frame, 2, 0)


def test_backward_on_the_cpu_takes_the_plain_version():
    """A CPU tensor never reaches the kernel or its counters."""
    x, dy, w, b, mean, inv = _case_inputs((1, 2, 4, 4, 8), 4, True, False,
                                          torch.float32)
    before = (groupnorm.bwd_launches, dict(groupnorm.bwd_launches_by_shape))
    got = groupnorm.group_norm_silu_backward(dy, x, w, b, mean, inv,
                                             silu=True)
    ref = groupnorm.group_norm_silu_backward_plain(dy, x, w, b, mean, inv,
                                                   silu=True)
    assert all(torch.equal(g_, r_) for g_, r_ in zip(got, ref))
    assert (groupnorm.bwd_launches,
            dict(groupnorm.bwd_launches_by_shape)) == before


@pytest.mark.parametrize("variant", sorted(kernel_variants.K1_BWD_VARIANTS))
def test_k1_bwd_variants_apply_once(variant):
    """Each K1.bwd variant of ``utils/kernel_variants.py`` replaces text
    that ``csrc/groupnorm_bwd.cu`` holds once."""
    text = (_build.CSRC / "groupnorm_bwd.cu").read_text()
    for old, new in kernel_variants.K1_BWD_VARIANTS[variant]:
        assert text.count(old) == 1 and old != new
        text = text.replace(old, new)
