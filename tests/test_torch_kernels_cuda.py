"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at small shapes.

Needs a CUDA device (and nvcc to build the kernels); skips without one.
Run on a GPU machine with:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
(``--noconftest``: the suite's conftest configures JAX, which the GPU
machine need not have; this file imports no JAX.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cvvae_tpu_torch.ops.conv import Conv3DSpec
from cvvae_tpu_torch.ops.kernels import (attention, conv_int8, groupnorm,
                                         shuffle, stem)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dev, dtype, scale=1.0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev, dtype)


# K1 is held by chip_smoke.py's bounds (chip_smoke.k1_check), on inputs
# made as it makes them (whose channel means and scales set the groups'
# statistics apart): fp32 elementwise; bf16 elementwise and by ||d|| /
# ||ref|| <= K1_BF16_RMS against the plain version, and within one
# rounding of its fp32 arithmetic.  planted_faults.py shows what they
# catch.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,silu,per_frame",
                         chip_smoke.K1_CHECK_SHAPES)
def test_group_norm_kernel(dev, dtype, shape, groups, silu, per_frame):
    x, w, b = chip_smoke.k1_inputs(shape, dev, dtype)
    kw = dict(num_groups=groups, eps=1e-5, silu=silu, per_frame=per_frame)
    before = groupnorm.launches
    got = groupnorm.group_norm_silu(x, w, b, **kw)
    torch.cuda.synchronize()
    assert groupnorm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _, excess, text = chip_smoke.k1_check(got, x, w, b, **kw)
    assert excess <= 0.0, text


def test_group_norm_kernel_wide_channel_means(dev):
    """Channel means of +-K1_WIDE_OFFSET: one rounding of fp32 arithmetic
    (the plain version's bf16 arithmetic is further off there)."""
    x, w, b = chip_smoke.k1_inputs((1, 5, 10, 14, 512), dev, torch.bfloat16,
                                   chip_smoke.K1_WIDE_OFFSET)
    kw = dict(num_groups=32, eps=1e-5, silu=False, per_frame=True)
    got = groupnorm.group_norm_silu(x, w, b, **kw)
    _, excess, text = chip_smoke.k1_check(got, x, w, b, hold_plain=False,
                                          **kw)
    assert excess <= 0.0, text


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_is_deterministic(dev, dtype):
    """A fixed plan and a fixed merge order: two calls, the same bits."""
    x = _randn((1, 9, 45, 80, 128), 3, dev, dtype, 3.0) + 1.0
    w = _randn((128,), 4, dev, torch.float32)
    b = _randn((128,), 5, dev, torch.float32)
    kw = dict(num_groups=32, eps=1e-6, silu=True)
    first = groupnorm.group_norm_silu(x, w, b, **kw)
    assert torch.equal(first, groupnorm.group_norm_silu(x, w, b, **kw))


# K1 split across ranks (K1.partial, K1.combine): a tensor's H rows in
# unequal runs, one a rank, on chip_smoke.K1_SPLIT_CHECKS
def _split(x, runs, groups, per_frame, w, b, silu, pair=False):
    """(the split output joined along H, the stacked moments) of x split
    into H ``runs``: every run's partial moments, then each run's
    combination; ``pair``: the two-launch forms."""
    partial = (groupnorm.partial_moments_pair if pair
               else groupnorm.partial_moments)
    parts = [p.contiguous() for p in x.split(list(runs), dim=2)]
    moments = torch.stack([partial(p, groups, per_frame) for p in parts])
    kw = dict(num_groups=groups, eps=1e-6, silu=silu, per_frame=per_frame)
    combine = groupnorm.combine_pair if pair else groupnorm.combine_stats
    return torch.cat([combine(p, w, b, moments, **kw)[0] for p in parts],
                     dim=2), moments


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,silu,per_frame,runs",
                         chip_smoke.K1_SPLIT_CHECKS)
def test_group_norm_split_kernels(dev, dtype, shape, groups, silu, per_frame,
                                  runs):
    """One launch of each entry a rank; the joined output within K1's
    bounds of the plain version on the whole (``k1_check``), within TOL
    of the plain split and of K1 on the whole."""
    x, w, b = chip_smoke.k1_inputs(shape, dev, dtype)
    kw = dict(num_groups=groups, eps=1e-6, silu=silu, per_frame=per_frame)
    p0, c0 = groupnorm.partial_launches, groupnorm.combine_launches
    got, _ = _split(x, runs, groups, per_frame, w, b, silu)
    torch.cuda.synchronize()
    assert groupnorm.partial_launches == p0 + len(runs)
    assert groupnorm.combine_launches == c0 + len(runs)
    assert got.dtype == dtype and got.shape == x.shape
    _, excess, text = chip_smoke.k1_check(got, x, w, b, **kw)
    assert excess <= 0.0, text
    tol = chip_smoke.TOL[("K1", dtype)]
    parts = [p.contiguous() for p in x.split(list(runs), dim=2)]
    plain_m = torch.stack([groupnorm.partial_moments_plain(p, groups,
                                                           per_frame)
                           for p in parts])
    plain = torch.cat([groupnorm.combine_plain(p, w, b, plain_m, **kw)
                       for p in parts], dim=2)
    whole = groupnorm.group_norm_silu(x, w, b, **kw)
    for ref in (plain, whole):
        assert chip_smoke.compare(got, ref, tol)[1] <= 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,silu,per_frame,runs",
                         chip_smoke.K1_SPLIT_CHECKS)
def test_group_norm_split_kernels_equal_their_two_launch_forms(
        dev, dtype, shape, groups, silu, per_frame, runs):
    """The one-launch entries against their two-launch forms on the same
    plan: the moments bit-equal (the same fold in the same order), and the
    combination bit-equal on the same moments, its statistics too."""
    x, w, b = chip_smoke.k1_inputs(shape, dev, dtype)
    kw = dict(num_groups=groups, eps=1e-6, silu=silu, per_frame=per_frame)
    got, moments = _split(x, runs, groups, per_frame, w, b, silu)
    ref, ref_m = _split(x, runs, groups, per_frame, w, b, silu, pair=True)
    assert torch.equal(moments, ref_m)
    assert torch.equal(got, ref)
    half = x.split(list(runs), dim=2)[-1].contiguous()
    y, stats = groupnorm.combine_stats(half, w, b, moments, **kw)
    y_ref, stats_ref = groupnorm.combine_pair(half, w, b, moments, **kw)
    assert torch.equal(y, y_ref) and torch.equal(stats, stats_ref)
    assert torch.equal(y, groupnorm.combine(half, w, b, moments, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_split_kernels_repeat_bit_equal(dev, dtype):
    """Two calls in a row give the same bits: the plan's fold order is
    fixed, and each partial leaves its ticket counters at zero for the
    next (a third call on another shape between them uses the same
    scratch)."""
    x, w, b = chip_smoke.k1_inputs((1, 5, 45, 84, 512), dev, dtype)
    other = chip_smoke.k1_inputs((2, 3, 7, 9, 128), dev, dtype)[0]
    kw = dict(num_groups=32, eps=1e-6, silu=False, per_frame=True)
    first = groupnorm.partial_moments(x, 32, True)
    groupnorm.partial_moments(other, 32, False)
    again = groupnorm.partial_moments(x, 32, True)
    assert torch.equal(first, again)
    stack = torch.stack([first, first])
    assert torch.equal(groupnorm.combine(x, w, b, stack, **kw),
                       groupnorm.combine(x, w, b, stack, **kw))


def test_group_norm_split_refuses_what_it_does_not_take(dev):
    x = torch.zeros((1, 2, 4, 4, 8), device=dev)
    m = groupnorm.partial_moments(x, 4, False)
    with pytest.raises(ValueError):
        groupnorm.partial_moments(x.transpose(2, 3), 4, False)
    with pytest.raises(ValueError):
        groupnorm.combine(x, torch.ones(8), torch.zeros(8), m[None].float(),
                          num_groups=4, eps=1e-5)
    with pytest.raises(ValueError):
        groupnorm.combine(x, torch.ones(8), torch.zeros(8), m[None, :, :2],
                          num_groups=4, eps=1e-5)


# K2 is bit-exact (chip_smoke.k2_exact) at chip_smoke.K2_CHECK_SHAPES: the
# scalar path (c of 4 and 20 bf16) and the 16-byte vector path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,drop,c,with_bias", chip_smoke.K2_CHECK_SHAPES)
def test_subpixel_interleave_kernel_bit_exact(dev, dtype, b, n, drop, c,
                                              with_bias):
    phases, bias = chip_smoke.k2_inputs(b, n, c, with_bias, dev, dtype)
    before = shuffle.launches
    got = shuffle.subpixel_interleave(phases, bias, n=n, drop_first=drop)
    ref = shuffle.subpixel_interleave_plain(phases, bias, n=n,
                                            drop_first=drop)
    torch.cuda.synchronize()
    assert shuffle.launches == before + 1
    assert chip_smoke.k2_exact(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["phase", "bias"])
def test_subpixel_interleave_kernel_misaligned_view(dev, dtype, which):
    """A phase or the bias as a view one element past an aligned start:
    the wrapper plans the scalar path, which stays bit-exact."""
    n, c = 2, 256
    phases, bias = chip_smoke.k2_inputs(1, n, c, True, dev, dtype)
    if which == "phase":
        flat = torch.empty(phases[2].numel() + 1, device=dev, dtype=dtype)
        flat[1:] = phases[2].reshape(-1)
        phases[2] = flat[1:].view(phases[0].shape)
    else:
        flat = torch.empty(bias.numel() + 1, device=dev, dtype=dtype)
        flat[1:] = bias
        bias = flat[1:]
    assert shuffle.launch_plan(phases, bias, c, 10, 132)["vec"] == 1
    got = shuffle.subpixel_interleave(phases, bias, n=n)
    ref = shuffle.subpixel_interleave_plain(phases, bias, n=n)
    torch.cuda.synchronize()
    assert chip_smoke.k2_exact(got, ref)


# K3 is held by chip_smoke.k3_check: against the plain version (fp32 2e-5,
# bf16 1e-2, elementwise on 1 + |ref|) and, in bf16, within one rounding
# of the plain version's fp32 arithmetic; at chip_smoke.K3_CHECK_SHAPES
# (W ragged against the tile, H and T of 1, B = 2; edge, zero and no time
# padding) for every Cin.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin", [1, 2, 3, 4])
@pytest.mark.parametrize("pad,shape", chip_smoke.K3_CHECK_SHAPES)
def test_stem_kernel(dev, dtype, cin, pad, shape):
    spec = chip_smoke.k3_spec(pad)
    x, wt, bias = chip_smoke.k3_inputs(shape, cin, dev, dtype)
    before = stem.launches
    got = stem.stem_conv3d(x, wt, bias, spec)
    torch.cuda.synchronize()
    assert stem.launches == before + 1
    _, excess, text = chip_smoke.k3_check(got, x, wt, bias, spec)
    assert excess <= 0.0, text


def test_stem_kernel_without_bias(dev):
    spec = Conv3DSpec.v1_causal()
    x, wt, _ = chip_smoke.k3_inputs((1, 3, 4, 300), 3, dev, torch.bfloat16)
    got = stem.stem_conv3d(x, wt, None, spec)
    _, excess, text = chip_smoke.k3_check(got, x, wt, None, spec)
    assert excess <= 0.0, text


def test_stem_kernel_misaligned_input(dev):
    """An input view that starts mid-granule: the granules the kernel
    copies are aligned, and the row offsets carry the start."""
    spec = Conv3DSpec.v1_causal()
    x, wt, bias = chip_smoke.k3_inputs((1, 3, 5, 70), 3, dev, torch.bfloat16)
    flat = torch.empty(x.numel() + 1, device=dev, dtype=x.dtype)
    flat[1:] = x.reshape(-1)
    xv = flat[1:].view(x.shape)
    got = stem.stem_conv3d(xv, wt, bias, spec)
    _, excess, text = chip_smoke.k3_check(got, x, wt, bias, spec)
    assert excess <= 0.0, text


# K4 is bf16 only (fp32 attention takes the exact path), held by the
# bounds of chip_smoke.py (K4_BF16_MAX, K4_BF16_RMS), where their reasons
# are: the two round their outputs to bf16 apart, one ulp at most; a
# missing tail mask fails both at S = 1100.
K4_BF16_MAX = chip_smoke.K4_BF16_MAX
K4_BF16_RMS = chip_smoke.K4_BF16_RMS


# S: whole and ragged 64-row query tiles and 32-key tiles (65, 127, 1100,
# 7560), and tails that are whole (64, 2048)
@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("s", [64, 65, 127, 1100, 2048, 7560])
@pytest.mark.parametrize("b", [1, 5])
def test_flash_attention_kernel(dev, c, s, b):
    q, k, v = (_randn((b, s, c), i, dev, torch.bfloat16) for i in range(3))
    scale = c ** -0.5
    before = attention.launches
    got = attention.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention.flash_attention_plain(q, k, v, scale)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got).all()
    d, r = got.double() - ref.double(), ref.double()
    assert d.abs().max() <= K4_BF16_MAX * r.abs().max()
    assert d.norm() <= K4_BF16_RMS * r.norm()


# keys growing along S (chip_smoke.k4_inputs): each row's max rises past
# the kernel's slack on later tiles, so its output and running sum are
# rescaled; on N(0, 1) inputs that never happens
@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("b,s", [(2, 127), (1, 1100), (5, 7560)])
def test_flash_attention_kernel_rising_logits(dev, c, b, s):
    q, k, v = chip_smoke.k4_inputs((b, s, c), dev, torch.bfloat16,
                                   rising=True)
    scale = c ** -0.5
    if s > 127:
        assert chip_smoke.k4_max_raises(q, k, scale) >= 1.0
    got = attention.flash_attention(q, k, v, scale)
    ref = attention.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _, excess, text = chip_smoke.k4_check(got, ref)
    assert excess <= 0.0, text


@pytest.mark.parametrize("c", [128, 256])
def test_flash_attention_kernel_other_widths(dev, c):
    """The two widths between the main ones: each consumer warpgroup's
    half of C is another wgmma width (64, 128)."""
    q, k, v = (_randn((2, 1100, c), 7 + i, dev, torch.bfloat16)
               for i in range(3))
    got = attention.flash_attention(q, k, v, c ** -0.5)
    ref = attention.flash_attention_plain(q, k, v, c ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    d, r = got.double() - ref.double(), ref.double()
    assert d.abs().max() <= K4_BF16_MAX * r.abs().max()
    assert d.norm() <= K4_BF16_RMS * r.norm()


def test_flash_attention_refuses_bad_layout(dev):
    before = attention.launches
    q = torch.zeros((1, 1100, 512), device=dev)
    qt = torch.zeros((1, 512, 1100), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(qt, qt, qt, 0.1)
    q96 = torch.zeros((1, 1100, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C=96"):
        attention.flash_attention(q96, q96, q96, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        attention.flash_attention(q.half(), q.half(), q.half(), 0.1)
    with pytest.raises(ValueError, match="differ"):
        attention.flash_attention(q.bfloat16(), q[:, :64].bfloat16(),
                                  q.bfloat16(), 0.1)
    assert attention.launches == before


def test_flash_attention_refuses_fp32(dev):
    """fp32 takes the exact path: K4 raises on it, with no fallback, and
    ``single_head_attention`` does not send it there."""
    from cvvae_tpu_torch.ops.attention import single_head_attention

    q = _randn((1, 1100, 512), 0, dev, torch.float32)
    before = attention.launches
    with pytest.raises(ValueError, match="float32"):
        attention.flash_attention(q, q, q, 0.1)
    got = single_head_attention(q, q, q, scale=0.1)
    torch.cuda.synchronize()
    assert attention.launches == before
    torch.testing.assert_close(
        got, attention.flash_attention_plain(q, q, q, 0.1), atol=0, rtol=0)


def test_wrappers_raise_on_bad_layout(dev):
    x = torch.zeros((1, 2, 4, 4, 8), device=dev)
    with pytest.raises(ValueError):
        groupnorm.group_norm_silu(x.transpose(2, 3), torch.ones(8),
                                  torch.zeros(8), num_groups=4, eps=1e-5)
    with pytest.raises(ValueError):
        groupnorm.group_norm_silu(x.half(), torch.ones(8), torch.zeros(8),
                                  num_groups=4, eps=1e-5)
    p = [torch.zeros((1, 2, 4, 4, 8), device=dev).transpose(2, 3)] * 4
    with pytest.raises(ValueError):
        shuffle.subpixel_interleave(p, None, n=2)


# K5 is bit-equal to its plain version: both sum exact integers and round
# the product and the bias add apart (planted_faults.py shows what this
# catches)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(chip_smoke.k5_check_cases()),
                         ids=lambda c: f"{c[0]}{'-half' if c[1] else ''}")
def test_conv_int8_kernel_bit_exact(dev, dtype, case):
    _, half, (shape, cout, kernel, stride, pads, modes, bias) = case
    args = chip_smoke.k5_inputs(shape, cout, kernel, dev, dtype, bias,
                                half_steps=half)
    before = conv_int8.launches, conv_int8.stage_launches
    got = conv_int8.conv3d_int8(*args, stride, pads, modes)
    torch.cuda.synchronize()
    assert (conv_int8.launches, conv_int8.stage_launches) == (
        before[0] + 1, before[1] + 1)
    ref = conv_int8.conv3d_int8_plain(*args, stride, pads, modes)
    assert chip_smoke.k2_exact(got, ref)


# K5.stage alone: the staged int8 tensor, pads and zero padding included,
# equal to its plain version's
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(chip_smoke.k5_check_cases()),
                         ids=lambda c: f"{c[0]}{'-half' if c[1] else ''}")
def test_int8_stage_kernel_bit_exact(dev, dtype, case):
    _, half, (shape, cout, kernel, stride, pads, modes, bias) = case
    x, _, _, sx, _ = chip_smoke.k5_inputs(shape, cout, kernel, dev, dtype,
                                          bias, half_steps=half)
    got = conv_int8.stage(x, sx, pads, modes, stride[2])
    torch.cuda.synchronize()
    ref = conv_int8.stage_plain(x, sx, pads, modes, stride[2])
    assert got.xq.dtype == torch.int8 and torch.equal(got.xq, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_int8_kernel_misaligned_input(dev, dtype):
    """A view that starts off a 16-byte boundary takes the staging pass's
    scalar loads."""
    shape, cout, kernel, stride, pads, modes, bias = \
        chip_smoke.K5_CHECK_CASES[1]
    x, *rest = chip_smoke.k5_inputs(shape, cout, kernel, dev, dtype, bias)
    flat = torch.empty(x.numel() + 1, device=dev, dtype=dtype)
    xv = flat[1:].view(x.shape)
    xv.copy_(x)
    got = conv_int8.conv3d_int8(xv, *rest, stride, pads, modes)
    ref = conv_int8.conv3d_int8_plain(x, *rest, stride, pads, modes)
    assert chip_smoke.k2_exact(got, ref)
    staged = conv_int8.stage(xv, rest[2], pads, modes)
    assert torch.equal(staged.xq, conv_int8.stage_plain(x, rest[2], pads,
                                                        modes))


@pytest.mark.parametrize("hw_mode", ["zero", "edge"])
def test_int8_upsample_stages_once_on_the_card(dev, hw_mode):
    """The upsample's four phase GEMMs read one staged tensor: one stage
    launch, four GEMM launches, frames equal to the CPU's."""
    from cvvae_tpu_torch.ops import quant
    from cvvae_tpu_torch.ops.upsample_conv import \
        upsample2x_conv3x3_interleave

    m = torch.nn.Module()
    m.weight = torch.nn.Parameter(_randn((96, 64, 3, 3, 3), 11, "cpu",
                                         torch.bfloat16, 0.05))
    m.bias = torch.nn.Parameter(_randn((96,), 12, "cpu", torch.bfloat16, 0.1))
    quant.quantize_conv_params(m, min_cin=1)
    m.register_buffer("scale_x", torch.tensor(2.5 / 127))
    # 5 x 64 x 70 positions: past INT8_MIN_POSITIONS, so int8
    x = _randn((1, 5, 64, 70, 64), 13, "cpu", torch.bfloat16)
    kw = dict(n=2, t_pad=(2, 0), t_mode="edge", hw_mode=hw_mode)
    ref = upsample2x_conv3x3_interleave(x, m, **kw)
    m.to(dev)
    before = conv_int8.launches, conv_int8.stage_launches
    got = upsample2x_conv3x3_interleave(x.to(dev), m, **kw)
    torch.cuda.synchronize()
    assert (conv_int8.launches, conv_int8.stage_launches) == (
        before[0] + 4, before[1] + 1)
    assert chip_smoke.k2_exact(got.cpu(), ref)


def test_quantized_conv_dynamic_scale_on_the_card(dev):
    """Without a calibrated scale, conv3d takes max|x| / 127 from one
    reduction on the card and launches K5 with it."""
    from cvvae_tpu_torch.ops import conv, quant

    spec = conv.Conv3DSpec.v1_causal()
    m = conv.Conv(spec, 64, 32).to(dev)
    quant.quantize_conv_params(m, min_cin=1)
    x = _randn((1, 5, 64, 64, 64), 3, dev, torch.bfloat16)
    before = conv_int8.launches
    with torch.no_grad():  # as served: K5 refuses a gradient (the bias)
        got = m(x)
    torch.cuda.synchronize()
    assert conv_int8.launches == before + 1
    ref = conv_int8.conv3d_int8_plain(x, m.weight_q, m.scale_w,
                                      quant.act_scale(x), m.bias,
                                      spec.stride, spec.pads, spec.modes)
    assert chip_smoke.k2_exact(got, ref)


def test_conv_int8_refuses_what_it_does_not_take(dev):
    x, wq, sw, sx, b = chip_smoke.k5_inputs((1, 3, 5, 7, 32), 16, (3, 3, 3),
                                            dev, torch.float32)
    ok = ((1, 1, 1), ((1, 1), (1, 1), (1, 1)), ("zero",) * 3)
    conv_int8.conv3d_int8(x, wq, sw, sx, b, *ok)
    wide = torch.zeros((16, 32, 3, 3, 4), dtype=torch.int8, device=dev)
    for bad in (
            (x.half(), wq, sw, sx, b) + ok,
            (x.transpose(2, 3), wq, sw, sx, b) + ok,
            (x, wq.float(), sw, sx, b) + ok,
            (x, wq, sw, sx, b, (1, 1, 1), ((1, 1), (-1, 1), (1, 1)), ok[2]),
            (x, wq, sw, sx, b, ok[0], ok[1], ("zero", "reflect", "zero")),
            # a W stride past kMaxSW, a kernel wider than kMaxKW
            (x, wq, sw, sx, b, (1, 1, 4)) + ok[1:],
            (x, wide, sw, sx, b) + ok):
        before = conv_int8.launches, conv_int8.stage_launches
        with pytest.raises(ValueError):
            conv_int8.conv3d_int8(*bad)
        assert (conv_int8.launches, conv_int8.stage_launches) == before
    # the staging pass alone
    for bad in ((x.half(), sx, ok[1], ok[2]),
                (x.transpose(2, 3), sx, ok[1], ok[2]),
                (x, sx, ((1, 1), (-1, 1), (1, 1)), ok[2]),
                (x, sx, ok[1], ("zero", "reflect", "zero"))):
        with pytest.raises(ValueError):
            conv_int8.stage(*bad)
    # a GEMM window past the staged pads, or a W stride that does not
    # divide the staged W
    staged = conv_int8.stage(x, sx, ok[1], ok[2])
    with pytest.raises(ValueError):
        conv_int8.gemm(staged, wq, sw, sx, b, (1, 1, 1),
                       ((2, 0), (1, 1), (1, 1)))
    with pytest.raises(ValueError):
        conv_int8.gemm(staged, wq, sw, sx, b, (1, 1, 2), ok[1])


def test_quantize_calibrates_on_a_window_of_a_clip(dev):
    """``cli --dtype int8 --serving`` calibrates on a view of the clip
    (its first 17x256x256 window): quantize makes it contiguous for the
    kernels, and records a scale for every quantized conv."""
    from cvvae_tpu_torch.models.vae_v1 import VAE1Config
    from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig

    cfg = VideoVAEConfig(net=VAE1Config(ch=32, ch_mult=(1, 2, 4),
                                        num_res_blocks=1,
                                        norm_num_groups=8),
                         tile_spatial_size=None, en_de_n_frames_a_time=None)
    vae = VideoVAE.from_config(cfg, device=dev, dtype=torch.bfloat16)
    x = _randn((1, 9, 96, 96, 3), 4, dev, torch.bfloat16)
    q = vae.quantize(calibration=x[:, :5, :64, :64])
    state = q.state_dict()
    n_q = sum(k.endswith("weight_q") for k in state)
    assert n_q > 0 and n_q == sum(k.endswith("scale_x") for k in state)


def test_streaming_prefetch_matches_serial_on_the_card(dev):
    """Two encode and two decode windows on the card: with prefetch=1
    each window's fetch runs on a side stream into pinned memory, and the
    bytes are the serial stream's."""
    from cvvae_tpu_torch.models.vae_v1 import VAE1Config
    from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
    from cvvae_tpu_torch.streaming import streaming_decode, streaming_encode

    cfg = VideoVAEConfig(net=VAE1Config(ch=32, num_res_blocks=1,
                                        norm_num_groups=8),
                         tile_spatial_size=None, en_de_n_frames_a_time=8)
    vae = VideoVAE.from_config(cfg, device=dev, dtype=torch.bfloat16)
    frames = np.random.RandomState(5).randint(0, 256, (17, 64, 96, 3),
                                              dtype=np.uint8)

    def run(prefetch):
        return list(streaming_decode(vae, streaming_encode(vae, iter(frames)),
                                     prefetch=prefetch))

    serial, early = run(0), run(1)
    assert [len(b) for b in serial] == [9, 8]
    assert len(early) == len(serial)
    for a, b in zip(early, serial):
        np.testing.assert_array_equal(a, b)
