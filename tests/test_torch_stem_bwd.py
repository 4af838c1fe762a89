"""K3.bwd on the CPU: the stem conv's gradient in its weights and bias.

- ``stem_conv3d_backward_plain`` against ``jax.vjp`` of the JAX package's
  ``conv3d`` with a stem spec (Cin 3 -> 128, which reaches
  ``_conv3d_stacked_stem`` on the CPU), fp32, relative 1e-5: both sum in
  fp32, in other orders.
- ``torch.autograd.grad`` through ``stem.stem_conv3d`` (and through
  ``ops.conv.conv3d``, which routes a 3 -> 128 conv there) gives the plain
  backward's result.
- ``stem.bwd_plan`` covers every output position once, and an emulation
  of the kernel's summation order on its plan stays within the bound that
  ``chip_smoke.k3_bwd_excess`` holds the card to: in fp32 one
  round-to-nearest FMA a term along each slot's runs of pixels; in bf16
  the tensor core's k-steps emulated pessimistically (each addend
  truncated to 24 bits of the step's largest, the sum truncated: round
  toward zero), a tile's products then added to the block's fp32 totals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cvvae_tpu.ops.conv import Conv3DSpec as JSpec
from cvvae_tpu.ops.conv import conv3d as jconv3d
from cvvae_tpu_torch.ops import conv
from cvvae_tpu_torch.ops.kernels import _build, stem
from cvvae_tpu_torch.utils import kernel_variants

PADS = {"edge": (((2, 0), (1, 1), (1, 1)), ("edge", "zero", "zero")),
        "zero": (((1, 1), (1, 1), (1, 1)), ("zero", "zero", "zero"))}
SHAPES = [(1, 5, 12, 16, 3), (2, 1, 10, 10, 3)]
RTOL = 1e-5


def _inputs(shape, seed=0):
    """x in [-1, 1], an fp32 kernel in the JAX layout (kT, kH, kW, Cin,
    128), a bias and dy, from numpy."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 3, shape[-1], 128)) / 9).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    return x, kernel, bias


def _specs(pad):
    pads, modes = PADS[pad]
    return (JSpec((3, 3, 3), (1, 1, 1), pads, modes),
            conv.Conv3DSpec((3, 3, 3), (1, 1, 1), pads, modes))


def _out_shape(shape, spec):
    b, t, h, w, _ = shape
    (t0, t1), (h0, h1), (w0, w1) = spec.pads
    return (b, t + t0 + t1 - 2, h + h0 + h1 - 2, w + w0 + w1 - 2, 128)


def _close(got, ref):
    ref = torch.as_tensor(np.asarray(ref, np.float64))
    got = got.double()
    assert got.shape == ref.shape
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= RTOL * scale
    assert ((got - ref).norm() / ref.norm()).item() <= RTOL


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("pad", sorted(PADS))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, pad, with_bias):
    jspec, tspec = _specs(pad)
    x, kernel, bias = _inputs(shape)
    dy = np.random.RandomState(1).standard_normal(
        _out_shape(shape, tspec)).astype(np.float32)

    def f(k, b):
        params = {"kernel": k}
        if with_bias:
            params["bias"] = b
        return jconv3d(jnp.asarray(x), params, jspec)

    y, vjp = jax.vjp(f, jnp.asarray(kernel), jnp.asarray(bias))
    assert y.shape == dy.shape
    dk, db = vjp(jnp.asarray(dy))
    got_w, got_b = stem.stem_conv3d_backward_plain(
        torch.from_numpy(x), torch.from_numpy(dy), tspec, with_bias)
    assert got_w.dtype == torch.float32
    # the port's (O, Cin, kT, kH, kW) against JAX's (kT, kH, kW, Cin, O)
    _close(got_w, np.transpose(np.asarray(dk), (4, 3, 0, 1, 2)))
    if with_bias:
        _close(got_b, db)
    else:
        assert got_b is None


@pytest.mark.parametrize("pad", sorted(PADS))
def test_autograd_through_the_stem_gives_the_plain_backward(pad):
    _, tspec = _specs(pad)
    x, kernel, bias = _inputs(SHAPES[0], seed=2)
    xt = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(np.transpose(kernel, (4, 3, 0, 1, 2)).copy())
    w.requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y = stem.stem_conv3d(xt, w, b, tspec)
    assert type(y.grad_fn).__name__ == "_StemBackward"
    dy = torch.from_numpy(np.random.RandomState(3).standard_normal(
        tuple(y.shape)).astype(np.float32))
    dx, dw, db = torch.autograd.grad(y, (xt, w, b), dy)
    want_w, want_b = stem.stem_conv3d_backward_plain(xt.detach(), dy, tspec)
    assert torch.equal(dw, want_w) and torch.equal(db, want_b)
    # dx, the CPU's alone, against autograd of the plain forward
    xr = xt.detach().requires_grad_()
    (want_x,) = torch.autograd.grad(
        stem.stem_conv3d_plain(xr, w.detach(), b.detach(), tspec), xr, dy)
    assert torch.allclose(dx, want_x, rtol=0, atol=1e-6)


def test_conv3d_routes_the_pixel_stem_through_the_stem_function():
    spec = conv.Conv3DSpec.v1_causal()
    layer = conv.Conv(spec, 3, 128, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_inputs((1, 3, 6, 7, 3))[0])
    y = conv.conv3d(x, layer, spec)
    assert type(y.grad_fn).__name__ == "_StemBackward"
    dy = torch.ones_like(y)
    dw, db = torch.autograd.grad(y, (layer.weight, layer.bias), dy)
    want_w, want_b = stem.stem_conv3d_backward_plain(x, dy, spec)
    assert torch.equal(dw, want_w) and torch.equal(db, want_b)


def test_bf16_gradients_come_back_in_the_parameters_dtype():
    _, tspec = _specs("edge")
    x, kernel, bias = _inputs((1, 3, 6, 7, 3), seed=4)
    w = torch.from_numpy(np.transpose(kernel, (4, 3, 0, 1, 2)).copy())
    w = w.to(torch.bfloat16).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y = stem.stem_conv3d(torch.from_numpy(x).to(torch.bfloat16), w, b, tspec)
    dw, db = torch.autograd.grad(y, (w, b), torch.ones_like(y))
    assert dw.dtype == torch.bfloat16 and db.dtype == torch.float32


PLAN_CASES = [(1, 17, 256, 256, 132), (8, 1, 320, 320, 132), (2, 5, 7, 130, 3),
              (1, 3, 1, 64, 1), (2, 2, 3, 37, 132), (1, 1, 2, 257, 5)]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
RUN = stem.BWD_PX // stem.BWD_RUNS


def _tiles_of(plan, k):
    return range(k * plan["per"], min((k + 1) * plan["per"], plan["n_tiles"]))


def _tile(plan, idx, w):
    """(first output position, pixels) of tile ``idx`` of an output row of
    ``w`` pixels."""
    row, wt = divmod(idx, plan["n_wt"])
    w0 = wt * plan["tile_w"]
    return row * w + w0, min(plan["tile_w"], w - w0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,t,h,w,sms", PLAN_CASES)
def test_bwd_plan_covers_every_output_position_once(b, t, h, w, sms, dtype):
    plan = stem.bwd_plan(b, t, h, w, sms, DTYPES[dtype])
    assert plan["grid"] <= sms * stem.BWD_BLOCKS_PER_SM[DTYPES[dtype]]
    seen = np.zeros(b * t * h * w, np.int64)
    most = 0   # terms a slot adds in order (fp32), tiles a block (bf16)
    for k in range(plan["grid"]):
        runs = np.zeros(stem.BWD_RUNS, np.int64)
        tiles = 0
        for idx in _tiles_of(plan, k):
            p0, np_ = _tile(plan, idx, w)
            assert np_ >= 1
            seen[p0:p0 + np_] += 1
            for q in range(stem.BWD_RUNS):
                runs[q] += max(0, min(np_, (q + 1) * RUN) - q * RUN)
            tiles += 1
        assert tiles > 0                        # no block without work
        most = max(most, runs.max() if dtype == "fp32" else tiles)
    assert (seen == 1).all()
    assert stem.BWD_PX >= stem.BWD_TILE_W[torch.float32] and RUN % 3 == 0
    assert plan["tile_w"] == stem.BWD_TILE_W[DTYPES[dtype]]
    if dtype == "fp32":
        assert plan["slots"] == plan["grid"] * stem.BWD_RUNS
        # the bound's count: every term of a slot, one more for the merge
        assert most + 1 <= plan["terms"]
    else:
        assert plan["slots"] == plan["grid"]
        # a tile's k-steps, each truncating its products, the carried sum
        # and the result; a tile's add to the totals; the merge
        steps = -(-plan["tile_w"] // stem.BWD_KSTEP)
        assert 2 * (stem.BWD_KSTEP + 2) * steps + most + 1 <= plan["terms"]


def _mma_step(prods, acc):
    """One k-step of the tensor core, pessimistically: the exact products
    (k, N, O) and the carried sum (N, O) aligned to the largest magnitude,
    each truncated to its 24 bits, summed (exactly: fewer than 2^29 units),
    and the sum truncated to 24 bits (round toward zero)."""
    terms = np.concatenate([prods, acc[None]], 0)
    unit = np.ldexp(1.0, np.frexp(np.abs(terms).max(0))[1] - 24)
    s = (np.trunc(terms / unit) * unit).sum(0)
    unit = np.ldexp(1.0, np.frexp(s)[1] - 24)
    return np.trunc(s / unit) * unit


def _emulate(x, dy, spec, plan, dtype):
    """The kernel's sums on ``plan``, in its order.  fp32: each slot (block,
    run of RUN pixels a tile) adds its pixels' terms in order, one fp32 FMA
    a term (emulated: the exact product and sum in float64, rounded once to
    fp32).  bf16: each tile's k-steps of BWD_KSTEP pixels through
    ``_mma_step`` from zero, the tile's sums added to the block's fp32
    totals, rounding to nearest.  Then the slots in order in double, rounded
    to fp32."""
    xp = stem._padded(torch.from_numpy(x).double(), spec).numpy()
    b, to, ho, wo, o = dy.shape
    cin = x.shape[-1]
    # each output position's 27 * Cin window values, (dt, dh, dw, ci) order
    win = np.stack([xp[:, kt:kt + to, kh:kh + ho, kw:kw + wo]
                    for kt in range(3) for kh in range(3) for kw in range(3)],
                   axis=4).reshape(-1, 27 * cin)
    win = np.concatenate([win, np.ones((win.shape[0], 1))], 1)  # the bias
    d = dy.reshape(-1, o).astype(np.float64)
    total = np.zeros((27 * cin + 1, o))
    for k in range(plan["grid"]):
        if dtype == "fp32":
            for q in range(stem.BWD_RUNS):
                acc = np.zeros((27 * cin + 1, o), np.float32)
                for idx in _tiles_of(plan, k):
                    p0, np_ = _tile(plan, idx, wo)
                    for p in range(p0 + q * RUN, p0 + min(np_, (q + 1) * RUN)):
                        acc = (acc + np.outer(win[p], d[p])).astype(np.float32)
                total += acc
            continue
        tot = np.zeros((27 * cin + 1, o), np.float32)
        for idx in _tiles_of(plan, k):
            p0, np_ = _tile(plan, idx, wo)
            acc = np.zeros((27 * cin + 1, o))
            for s0 in range(0, np_, stem.BWD_KSTEP):
                ps = slice(p0 + s0, p0 + min(np_, s0 + stem.BWD_KSTEP))
                acc = _mma_step(win[ps, :, None] * d[ps, None, :], acc)
            tot = (tot + acc).astype(np.float32)
        total += tot
    dw = total[:-1].reshape(3, 3, 3, cin, o).transpose(4, 3, 0, 1, 2)
    return (torch.from_numpy(dw.astype(np.float32)),
            torch.from_numpy(total[-1].astype(np.float32)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pad,shape,sms", [("edge", (1, 5, 4, 70, 3), 2),
                                           ("zero", (2, 1, 3, 9, 3), 1),
                                           ("edge", (1, 2, 3, 66, 3), 132)])
def test_emulated_summation_stays_within_the_plans_bound(pad, shape, sms,
                                                         dtype):
    _, tspec = _specs(pad)
    x = _inputs(shape, seed=5)[0]
    rng = np.random.RandomState(6)
    # dy with a common offset, so that the partial sums grow and round
    dy = (rng.standard_normal(_out_shape(shape, tspec)) + 3.0).astype(
        np.float32)
    if dtype == "bf16":  # the kernel's operands: x and dy in bf16
        x, dy = (torch.from_numpy(a).bfloat16().float().numpy()
                 for a in (x, dy))
    plan = stem.bwd_plan(*dy.shape[:4], sms, DTYPES[dtype])
    dw, db = _emulate(x, dy, tspec, plan, dtype)
    worst, excess = chip_smoke.k3_bwd_excess(
        dw, db, torch.from_numpy(x), torch.from_numpy(dy), tspec,
        plan["terms"])
    assert excess <= 0.0
    assert worst > 0.0                      # fp32 sums, not exact
    # and the bound is not vacuous: a term dropped from a block breaks it
    dw_bad = dw.clone()
    dw_bad[0, 0, 1, 1, 1] -= float(x[0, 0, 0, 0, 0] * dy[0, 0, 0, 0, 0])
    assert chip_smoke.k3_bwd_excess(
        dw_bad, db, torch.from_numpy(x), torch.from_numpy(dy), tspec,
        plan["terms"])[1] > 0.0


@pytest.mark.parametrize("variant", sorted(kernel_variants.K3_BWD_VARIANTS))
def test_k3_bwd_variants_apply_once(variant):
    """Each K3.bwd variant of ``utils/kernel_variants.py`` replaces text
    that ``csrc/stem_bwd.cu`` holds once."""
    text = (_build.CSRC / "stem_bwd.cu").read_text()
    for old, new in kernel_variants.K3_BWD_VARIANTS[variant]:
        assert text.count(old) == 1 and old != new
        text = text.replace(old, new)
