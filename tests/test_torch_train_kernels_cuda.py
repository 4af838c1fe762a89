"""The backward kernels K1.bwd, K2.bwd, K3.bwd and K4.bwd against their
plain versions on the card, K4's logsumexp, the autograd wiring of K1, K2,
K3 and K4, and the refusal of K3 (for its input) and K5 to give an output
without a gradient.

Needs a CUDA device (and nvcc to build the kernels); skips without one.
Run on a GPU machine with:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_kernels_cuda.py
(``--noconftest``: the suite's conftest configures JAX; this file imports
no JAX.)  The bounds are chip_smoke.py's (``K1_BWD_RMS``,
``k2_bwd_check``, ``k3_bwd_check``, ``K4_LSE_TOL``, ``K4_BWD_MAX`` and
``K4_BWD_RMS``).
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


def test_group_norm_backward_reads_its_inputs_in_place(dev):
    """K1.bwd reads the forward's statistics at stride 2 and bf16 weight
    and bias as they are: the same bits from contiguous copies of the
    statistics, dweight and dbias in bf16 within K1_BWD_RMS of the plain
    version; a launch is counted by its (B', S, C, SiLU, dtype)."""
    x, dy, w, b = chip_smoke.k1_bwd_inputs((1, 4, 30, 41, 256), dev,
                                           torch.bfloat16)
    w, b = w.bfloat16(), b.bfloat16()
    _, mean, inv = groupnorm._launch(x, w, b, 32, 1e-6, True, False, True)
    assert mean.stride() == (64, 2)
    key = (1, 4 * 30 * 41, 256, True, "bfloat16")
    before = groupnorm.bwd_launches_by_shape[key]
    got = groupnorm.group_norm_silu_backward(dy, x, w, b, mean, inv,
                                             silu=True)
    again = groupnorm.group_norm_silu_backward(
        dy, x, w, b, mean.contiguous(), inv.contiguous(), silu=True)
    torch.cuda.synchronize()
    assert groupnorm.bwd_launches_by_shape[key] == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    ref = groupnorm.group_norm_silu_backward_plain(dy, x, w, b, mean, inv,
                                                   silu=True)
    for g, r in zip(got, ref):
        assert chip_smoke.compare(g, r)[3] <= \
            chip_smoke.K1_BWD_RMS[torch.bfloat16]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad,shape", chip_smoke.K3_BWD_CHECK_SHAPES)
def test_stem_backward_kernel(dev, dtype, pad, shape):
    spec = chip_smoke.k3_spec(pad)
    x = chip_smoke.k3_inputs(shape, 3, dev, dtype)[0]
    dy = chip_smoke.randn((shape[0],) + stem._extents(x, spec) + (128,), 33,
                          dev, dtype)
    before = stem.bwd_launches
    _, excess, text, (dw, db) = chip_smoke.k3_bwd_check(x, dy, spec)
    torch.cuda.synchronize()
    assert stem.bwd_launches == before + 1
    assert dw.dtype == db.dtype == torch.float32
    assert excess <= 0.0, text
    again = stem.stem_conv3d_backward(x, dy, spec)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


def test_stem_autograd_reaches_the_kernels(dev):
    spec = chip_smoke.k3_spec("edge")
    x, w, b = chip_smoke.k3_inputs((1, 5, 9, 70), 3, dev, torch.float32)
    w, b = w.requires_grad_(), b.requires_grad_()
    before = (stem.launches, stem.bwd_launches)
    y = stem.stem_conv3d(x, w, b, spec)
    assert y.grad_fn is not None
    dy = chip_smoke.randn(tuple(y.shape), 34, dev, torch.float32)
    y.backward(dy)
    assert (stem.launches, stem.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = stem.stem_conv3d_backward(x, dy, spec)
    assert torch.equal(w.grad, want[0]) and torch.equal(b.grad, want[1])


@pytest.mark.parametrize("shape,rising", [((2, 600, 64), False),
                                          ((1, 1100, 512), False),
                                          ((5, 7560, 512), True),
                                          ((1, 1100, 128), True)])
def test_flash_attention_writes_its_logsumexp(dev, shape, rising):
    """K4 with the logsumexp: the same output as the serving launch, and
    the rows' logsumexp within K4_LSE_TOL of the plain version's, on
    rising logits too (the running max raised after tile 0)."""
    q, k, v = chip_smoke.k4_inputs(shape, dev, torch.bfloat16, rising)
    scale = shape[-1] ** -0.5
    out, lse = attention._launch(q, k, v, scale, True)
    assert torch.equal(out, attention.flash_attention(q, k, v, scale))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == shape[:2]
    _, excess, text = chip_smoke.k4_lse_check(
        lse, attention.flash_attention_lse_plain(q, k, scale))
    assert excess <= 0.0, text
    if rising:
        assert chip_smoke.k4_max_raises(q, k, scale) >= 1.0


@pytest.mark.parametrize("shape,rising",
                         [s for s in chip_smoke.K4_BWD_SHAPES]
                         + [((2, 600, 64), False)])
def test_flash_attention_backward_kernel(dev, shape, rising):
    args = chip_smoke.k4_bwd_inputs(shape, dev, rising)
    before = attention.bwd_launches
    _, excess, text, got = chip_smoke.k4_bwd_check(*args)
    torch.cuda.synchronize()
    assert attention.bwd_launches == before + 1
    assert excess <= 0.0, text
    again = attention.flash_attention_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape,rising", chip_smoke.K4_BWD_CHECK_SHAPES)
def test_flash_attention_backward_small_cases(dev, shape, rising):
    _, excess, text, _ = chip_smoke.k4_bwd_check(
        *chip_smoke.k4_bwd_inputs(shape, dev, rising))
    assert excess <= 0.0, text


def test_flash_attention_backward_refuses_what_it_does_not_take(dev):
    args = list(chip_smoke.k4_bwd_inputs((1, 64, 64), dev))
    with pytest.raises(ValueError, match="dtype"):
        attention.flash_attention_backward(
            *[a.float() for a in args[:5]], args[5], args[6])
    bad = list(args)
    bad[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention_backward(*bad)
    bad = list(args)
    bad[5] = args[5].double()
    with pytest.raises(ValueError, match="lse"):
        attention.flash_attention_backward(*bad)
    with pytest.raises(ValueError, match="C="):
        attention.flash_attention_backward(
            *[a[..., :48].contiguous() for a in args[:5]], args[5], args[6])


def test_flash_attention_autograd_reaches_the_kernels(dev):
    """A gradient through K4 launches K4 (with the logsumexp) and K4.bwd
    and reaches q, k and v; it matches the plain Function's on the CPU
    within K4.bwd's bounds."""
    q, k, v = chip_smoke.k4_inputs((2, 1024, 64), dev, torch.bfloat16, True)
    do = chip_smoke.randn(tuple(q.shape), 46, dev, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (attention.launches, attention.bwd_launches)
    y = attention.flash_attention(*leaves, 0.125)
    assert y.grad_fn is not None
    y.backward(do)
    assert (attention.launches, attention.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    cpu = [t.cpu().requires_grad_() for t in (q, k, v)]
    attention.flash_attention(*cpu, 0.125).backward(do.cpu())
    for got, ref in zip(leaves, cpu):
        err, _, ref_max, rms = chip_smoke.compare(got.grad.cpu(), ref.grad)
        assert err <= chip_smoke.K4_BWD_MAX * ref_max
        assert rms <= chip_smoke.K4_BWD_RMS


def test_kernels_without_a_backward_refuse_gradients(dev):
    """K3 raises when grad mode is on and its input x needs a gradient
    (K3.bwd gives the weights' and the bias's alone), and runs under
    no_grad; K5 raises when any input needs one."""
    spec = Conv3DSpec((3, 3, 3), (1, 1, 1), ((2, 0), (1, 1), (1, 1)),
                      ("edge", "zero", "zero"))
    x = torch.randn(1, 3, 8, 8, 3, device=dev, requires_grad=True)
    w = torch.randn(128, 3, 3, 3, 3, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K3"):
        stem.stem_conv3d(x, w, None, spec)
    with torch.no_grad():
        assert stem.stem_conv3d(x, w, None, spec).shape == (1, 3, 8, 8, 128)
    assert stem.stem_conv3d(x.detach(), w, None, spec).grad_fn is not None
    xq = torch.randn(1, 3, 8, 8, 16, device=dev, requires_grad=True)
    wq = torch.randint(-127, 128, (16, 16, 3, 3, 3), dtype=torch.int8,
                       device=dev)
    sw = torch.full((16,), 0.01, device=dev)
    sx = torch.tensor(0.02, device=dev)
    with pytest.raises(NotImplementedError, match="K5"):
        conv_int8.conv3d_int8(xq, wq, sw, sx, None, (1, 1, 1),
                              ((1, 1), (1, 1), (1, 1)), ("zero",) * 3)
