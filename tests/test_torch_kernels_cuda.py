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
from cvvae_tpu_torch.ops.kernels import attention, groupnorm, shuffle, stem

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,drop,c,with_bias", [
    (1, 2, True, 16, True), (2, 2, False, 24, True), (1, 1, False, 8, False),
    (1, 2, True, 256, False)])
def test_subpixel_interleave_kernel_bit_exact(dev, dtype, b, n, drop, c,
                                              with_bias):
    phases = [_randn((b, 3, 5, 7, n * c), i, dev, dtype) for i in range(4)]
    bias = _randn((n * c,), 9, dev, dtype) if with_bias else None
    got = shuffle.subpixel_interleave(phases, bias, n=n, drop_first=drop)
    ref = shuffle.subpixel_interleave_plain(phases, bias, n=n,
                                            drop_first=drop)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


# both accumulate in fp32 and round once; only the summation order
# differs (cuDNN with TF32 off vs 27*Cin sequential FMAs): 1 bf16 ulp
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("cin,spec", [
    (3, Conv3DSpec.v1_causal()),
    (4, Conv3DSpec.v1_plain()),
    (3, Conv3DSpec((3, 3, 3), (1, 1, 1), ((0, 0), (0, 0), (0, 0)),
                   ("zero", "zero", "zero"))),
])
def test_stem_kernel(dev, dtype, tol, cin, spec):
    x = _randn((2, 5, 19, 37, cin), 0, dev, dtype)
    w = _randn((128, cin, 3, 3, 3), 1, dev, dtype, 0.1)
    bias = _randn((128,), 2, dev, dtype)
    got = stem.stem_conv3d(x, w, bias, spec)
    ref = stem.stem_conv3d_plain(x, w, bias, spec)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


# fp32: fp32 FMAs in another order than cuBLAS (TF32 off): elementwise
# 2e-5 * (1 + |ref|).  bf16: the bounds of chip_smoke.py (K4_BF16_MAX,
# K4_BF16_RMS), where their reasons are: the two round their outputs to
# bf16 apart, one ulp at most; a missing tail mask fails both at S = 1100.
K4_BF16_MAX = chip_smoke.K4_BF16_MAX
K4_BF16_RMS = chip_smoke.K4_BF16_RMS


# S: whole and ragged 64-row query tiles and 32-key tiles (65, 127, 1100,
# 7560), and tails that are whole (64, 2048)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("s", [64, 65, 127, 1100, 2048, 7560])
@pytest.mark.parametrize("b", [1, 5])
def test_flash_attention_kernel(dev, dtype, c, s, b):
    q, k, v = (_randn((b, s, c), i, dev, dtype) for i in range(3))
    scale = c ** -0.5
    before = attention.launches
    got = attention.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention.flash_attention_plain(q, k, v, scale)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
        return
    assert torch.isfinite(got).all()
    d, r = got.double() - ref.double(), ref.double()
    assert d.abs().max() <= K4_BF16_MAX * r.abs().max()
    assert d.norm() <= K4_BF16_RMS * r.norm()


# keys growing along S (chip_smoke.k4_inputs): each row's max rises past
# the bf16 kernel's slack on later tiles, so its output and running sum
# are rescaled; on N(0, 1) inputs that never happens (chip_smoke.K4_RAMP
# says why fp32 is not checked so)
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
    q96 = torch.zeros((1, 1100, 96), device=dev)
    with pytest.raises(ValueError, match="C=96"):
        attention.flash_attention(q96, q96, q96, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        attention.flash_attention(q.half(), q.half(), q.half(), 0.1)
    with pytest.raises(ValueError, match="differ"):
        attention.flash_attention(q, q[:, :64], q, 0.1)
    assert attention.launches == before


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
