"""The plain backward versions of K1 and K2 (what the CPU runs, and what
K1.bwd and K2.bwd are held to on the card), on the CPU:

* K1's against ``torch.autograd`` of its plain forward, against
  ``jax.vjp`` of the JAX package's ``group_norm`` (+ ``silu``) in every
  mode (per frame or not, SiLU or not, eps 1e-5 and 1e-6), and through
  ``gradcheck`` in float64;
* K2's against ``jax.vjp`` of the JAX interleave tail
  (``cvvae_tpu/ops/upsample_conv.py:159-167``), exactly, with and without
  ``drop_first``, and through ``gradcheck``;
* the autograd wiring: ``group_norm_silu`` and ``subpixel_interleave``
  carry a ``grad_fn`` and reach x, the phases, weight and bias.

Tolerances: fp32 against JAX 2e-5 * (1 + |ref|) (both take fp32 moments
with var = E[x^2] - mean^2; the backward sums in another order); the
permutation exact; d(bias) within the bound of fp32 recursive summation
of its terms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.ops.activations import silu as jsilu
from cvvae_tpu.ops.norm import group_norm as jgroup_norm
from cvvae_tpu.ops.norm import group_norm_per_frame as jgroup_norm_per_frame

from cvvae_tpu_torch.ops.kernels import groupnorm, shuffle

torch.set_num_threads(2)

RTOL = 2e-5

K1_MODES = [
    # (shape, groups, eps, silu, per_frame)
    ((2, 3, 5, 6, 16), 4, 1e-6, True, False),
    ((2, 3, 5, 6, 16), 4, 1e-5, False, False),
    ((1, 4, 6, 5, 32), 8, 1e-6, False, True),
    ((2, 3, 4, 4, 8), 2, 1e-5, True, True),
    ((1, 1, 7, 9, 12), 4, 1e-6, True, False),     # C / G = 3
]


def _inputs(shape, seed=0, offset=2.0):
    r = np.random.RandomState(seed)
    c = shape[-1]
    x = (r.randn(*shape) * np.linspace(1, 3, c) +
         np.linspace(-offset, offset, c)).astype(np.float32)
    w = (1 + 0.3 * r.randn(c)).astype(np.float32)
    b = (0.3 * r.randn(c)).astype(np.float32)
    dy = r.randn(*shape).astype(np.float32)
    return x, w, b, dy


def _jax_grads(x, w, b, dy, groups, eps, silu, per_frame):
    fn = jgroup_norm_per_frame if per_frame else jgroup_norm

    def f(x, w, b):
        y = fn(x, {"scale": w, "bias": b}, num_groups=groups, eps=eps)
        return jsilu(y) if silu else y

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _torch_grads(x, w, b, dy, groups, eps, silu, per_frame, dtype):
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (x, w, b)]
    y = groupnorm.group_norm_silu(*leaves, num_groups=groups, eps=eps,
                                  silu=silu, per_frame=per_frame)
    assert y.grad_fn is not None
    y.backward(torch.tensor(dy, dtype=dtype))
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("shape,groups,eps,silu,per_frame", K1_MODES)
def test_k1_backward_matches_jax_vjp(shape, groups, eps, silu, per_frame):
    x, w, b, dy = _inputs(shape)
    y_ref, g_ref = _jax_grads(x, w, b, dy, groups, eps, silu, per_frame)
    y, g = _torch_grads(x, w, b, dy, groups, eps, silu, per_frame,
                        torch.float32)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=RTOL, atol=RTOL)
    for name, got, ref in zip(("dx", "dweight", "dbias"), g, g_ref):
        scale = 1 + np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=RTOL * scale, err_msg=name)


@pytest.mark.parametrize("shape,groups,eps,silu,per_frame", K1_MODES)
def test_k1_backward_matches_autograd_of_plain_forward(shape, groups, eps,
                                                       silu, per_frame):
    """The hand-written plain backward against torch's autograd of the
    plain forward, in float64."""
    x, w, b, dy = _inputs(shape, seed=1)
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (x, w, b)]
    y = groupnorm.group_norm_silu_plain(*leaves, num_groups=groups, eps=eps,
                                        silu=silu, per_frame=per_frame)
    ref = torch.autograd.grad(y, leaves, torch.tensor(dy, dtype=torch.float64))
    _, got = _torch_grads(x, w, b, dy, groups, eps, silu, per_frame,
                          torch.float64)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("per_frame", [False, True])
def test_k1_gradcheck_float64(silu, per_frame):
    x, w, b, _ = _inputs((1, 3, 3, 4, 8), seed=2, offset=0.5)
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (x, w, b)]
    assert torch.autograd.gradcheck(
        lambda x, w, b: groupnorm.group_norm_silu(
            x, w, b, num_groups=4, eps=1e-6, silu=silu, per_frame=per_frame),
        leaves)


def _jax_interleave(phases, bias, n, drop_first):
    """The JAX package's XLA interleave tail (ops/upsample_conv.py:159-167)."""
    b, t, h, w, nc = phases[0].shape
    c = nc // n
    y = jnp.stack(phases, axis=4)
    if bias is not None:
        y = y + bias.astype(y.dtype)
    y = y.reshape(b, t, h, w, 2, 2, n, c)
    y = y.transpose(0, 1, 6, 2, 4, 3, 5, 7)
    y = y.reshape(b, t * n, 2 * h, 2 * w, c)
    if n > 1 and drop_first:
        y = y[:, 1:]
    return y


@pytest.mark.parametrize("n,drop_first,with_bias", [
    (2, True, True), (2, False, True), (1, True, True), (1, False, False),
    (2, True, False)])
def test_k2_backward_matches_jax_vjp_exactly(n, drop_first, with_bias):
    r = np.random.RandomState(3)
    phases = [r.randn(2, 3, 4, 5, n * 6).astype(np.float32) for _ in range(4)]
    bias = r.randn(n * 6).astype(np.float32) if with_bias else None
    y_ref, vjp = jax.vjp(
        lambda b, *p: _jax_interleave(list(p), b, n, drop_first),
        None if bias is None else jnp.asarray(bias),
        *[jnp.asarray(p) for p in phases])
    dy = r.randn(*y_ref.shape).astype(np.float32)
    g_ref = vjp(jnp.asarray(dy))
    tp = [torch.tensor(p, requires_grad=True) for p in phases]
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    y = shuffle.subpixel_interleave(tp, tb, n=n, drop_first=drop_first)
    assert y.grad_fn is not None
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    y.backward(torch.tensor(dy))
    for p, ref in zip(tp, g_ref[1:]):
        np.testing.assert_array_equal(p.grad.numpy(), np.asarray(ref))
    if with_bias:
        # d(bias): two fp32 sums of the same terms in other orders, each
        # within (terms - 1) * 2^-24 * sum|terms| of the exact sum
        full = np.concatenate([np.zeros_like(dy[:, :1]), dy], 1) \
            if (n > 1 and drop_first) else dy
        terms = full.reshape(2, 3, n, 8, 10, 6)
        count = terms.size // (n * 6)
        mag = np.abs(terms).sum(axis=(0, 1, 3, 4)).reshape(-1)
        err = np.abs(tb.grad.numpy() - np.asarray(g_ref[0]))
        assert (err <= 2 * (count - 1) * 2.0 ** -24 * mag).all()


@pytest.mark.parametrize("n,drop_first", [(2, True), (1, True), (2, False)])
def test_k2_gradcheck_float64(n, drop_first):
    r = np.random.RandomState(4)
    phases = [torch.tensor(r.randn(1, 2, 2, 3, n * 3), requires_grad=True)
              for _ in range(4)]
    bias = torch.tensor(r.randn(n * 3), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda b, *p: shuffle.subpixel_interleave(list(p), b, n=n,
                                                  drop_first=drop_first),
        (bias, *phases))


def test_k2_backward_zero_where_the_frame_was_dropped():
    dy = torch.randn(1, 5, 4, 6, 8)
    phases, dbias = shuffle.subpixel_interleave_backward_plain(
        dy, n=2, t=3, drop_first=True)
    for p in phases:
        assert p.shape == (1, 3, 2, 3, 16)
        assert torch.count_nonzero(p[:, 0, ..., :8]) == 0
    torch.testing.assert_close(
        dbias, torch.cat([dy[:, 1::2].sum((0, 1, 2, 3)),
                          dy[:, 0::2].sum((0, 1, 2, 3))]))
