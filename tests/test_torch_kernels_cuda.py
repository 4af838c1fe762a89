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


# fp32: the kernel's Chan merge vs the plain E[x^2]-mean^2 reorder the
# statistics' last bits.  bf16: the kernel rounds once, the plain version
# (JAX numerics) rounds the folded affine and each op: a few bf16 ulps.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,groups,silu,per_frame", [
    ((2, 3, 10, 14, 64), 32, True, False),
    ((1, 5, 9, 7, 128), 32, False, True),
    ((1, 2, 4, 4, 8), 4, True, False),
    ((1, 3, 33, 35, 512), 32, True, False),
])
def test_group_norm_kernel(dev, dtype, tol, shape, groups, silu, per_frame):
    x = _randn(shape, 0, dev, dtype, 2.0) + 0.5
    w = _randn(shape[-1:], 1, dev, torch.float32)
    b = _randn(shape[-1:], 2, dev, torch.float32)
    before = groupnorm.launches
    got = groupnorm.group_norm_silu(x, w, b, num_groups=groups, eps=1e-5,
                                    silu=silu, per_frame=per_frame)
    torch.cuda.synchronize()
    assert groupnorm.launches == before + 1
    ref = groupnorm.group_norm_silu_plain(x, w, b, num_groups=groups,
                                          eps=1e-5, silu=silu,
                                          per_frame=per_frame)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


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
K4_BF16_MAX = 1.5e-2
K4_BF16_RMS = 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("s", [64, 1100, 2048])
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
