"""The backward kernels K1.bwd and K2.bwd against their plain versions on
the card, the autograd wiring of K1 and K2, and the refusal of K3, K4 and
K5 to give an output without a gradient, at small shapes.

Needs a CUDA device (and nvcc to build the kernels); skips without one.
Run on a GPU machine with:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_kernels_cuda.py
(``--noconftest``: the suite's conftest configures JAX; this file imports
no JAX.)  The bounds are chip_smoke.py's (``K1_BWD_RMS``,
``k2_bwd_check``).
"""

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,silu,per_frame",
                         chip_smoke.K1_CHECK_SHAPES)
def test_group_norm_backward_kernel(dev, dtype, shape, groups, silu,
                                    per_frame):
    x, dy, w, b = chip_smoke.k1_bwd_inputs(shape, dev, dtype)
    before = groupnorm.bwd_launches
    rel, got, _ = chip_smoke.k1_bwd_check(x, dy, w, b, groups, 1e-5, silu,
                                          per_frame)
    torch.cuda.synchronize()
    assert groupnorm.bwd_launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for k, v in rel.items():
        assert v <= chip_smoke.K1_BWD_RMS[dtype], (k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_backward_kernel_is_deterministic(dev, dtype):
    x, dy, w, b = chip_smoke.k1_bwd_inputs((1, 4, 30, 41, 256), dev, dtype)
    _, first, stats = chip_smoke.k1_bwd_check(x, dy, w, b, 32, 1e-6, True,
                                              False)
    again = groupnorm.group_norm_silu_backward(dy, x, w, b, *stats,
                                               silu=True)
    assert all(torch.equal(a, c) for a, c in zip(first, again))


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_autograd_reaches_the_kernels(dev, silu):
    """A gradient through K1 launches K1.bwd and reaches x, weight and
    bias; it matches the plain Function on the CPU."""
    x, dy, w, b = chip_smoke.k1_bwd_inputs((2, 3, 10, 14, 64), dev,
                                           torch.float32)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    before = (groupnorm.launches, groupnorm.bwd_launches)
    y = groupnorm.group_norm_silu(*leaves, num_groups=32, eps=1e-6, silu=silu)
    assert y.grad_fn is not None
    y.backward(dy)
    assert (groupnorm.launches, groupnorm.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    cpu = [t.cpu().requires_grad_() for t in (x, w, b)]
    groupnorm.group_norm_silu(*cpu, num_groups=32, eps=1e-6,
                              silu=silu).backward(dy.cpu())
    for got, ref in zip(leaves, cpu):
        d = (got.grad.cpu().double() - ref.grad.double()).norm()
        assert d / ref.grad.double().norm() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,drop,c,with_bias", chip_smoke.K2_CHECK_SHAPES)
def test_subpixel_interleave_backward_kernel(dev, dtype, b, n, drop, c,
                                             with_bias):
    t = 3
    dy = chip_smoke.randn((b, n * t - (n > 1 and drop), 10, 14, c), 7, dev,
                          dtype)
    before = shuffle.bwd_launches
    exact, excess, _ = chip_smoke.k2_bwd_check(dy, n, t, with_bias, drop)
    assert shuffle.bwd_launches == before + 1
    assert exact
    assert excess <= 0.0


def test_subpixel_interleave_autograd_reaches_the_kernels(dev):
    phases, bias = chip_smoke.k2_inputs(1, 2, 16, True, dev, torch.float32)
    phases = [p.requires_grad_() for p in phases]
    bias = bias.requires_grad_()
    before = (shuffle.launches, shuffle.bwd_launches)
    y = shuffle.subpixel_interleave(phases, bias, n=2)
    assert y.grad_fn is not None
    dy = chip_smoke.randn(tuple(y.shape), 8, dev, torch.float32)
    y.backward(dy)
    assert (shuffle.launches, shuffle.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    ref, db = shuffle.subpixel_interleave_backward_plain(dy, n=2, t=3)
    assert all(torch.equal(p.grad, r) for p, r in zip(phases, ref))
    assert torch.allclose(bias.grad, db, rtol=1e-6, atol=1e-5)


def test_kernels_without_a_backward_refuse_gradients(dev):
    """K3, K4 and K5 raise when grad mode is on and an input needs a
    gradient, and run under no_grad."""
    spec = Conv3DSpec((3, 3, 3), (1, 1, 1), ((2, 0), (1, 1), (1, 1)),
                      ("edge", "zero", "zero"))
    x = torch.randn(1, 3, 8, 8, 3, device=dev)
    w = torch.randn(128, 3, 3, 3, 3, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K3.bwd"):
        stem.stem_conv3d(x, w, None, spec)
    with torch.no_grad():
        assert stem.stem_conv3d(x, w, None, spec).shape == (1, 3, 8, 8, 128)
    q = torch.randn(1, 1024, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(NotImplementedError, match="K4.bwd"):
        attention.flash_attention(q, q.detach(), q.detach(), 0.125)
    xq = torch.randn(1, 3, 8, 8, 16, device=dev, requires_grad=True)
    wq = torch.randint(-127, 128, (16, 16, 3, 3, 3), dtype=torch.int8,
                       device=dev)
    sw = torch.full((16,), 0.01, device=dev)
    sx = torch.tensor(0.02, device=dev)
    with pytest.raises(NotImplementedError, match="K5"):
        conv_int8.conv3d_int8(xq, wq, sw, sx, None, (1, 1, 1),
                              ((1, 1), (1, 1), (1, 1)), ("zero",) * 3)
