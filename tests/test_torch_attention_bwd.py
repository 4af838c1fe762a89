"""K4's autograd Function and the plain versions of its logsumexp and of
its backward K4.bwd, against the JAX package on the CPU.

- ``flash_attention_backward_plain`` in bf16 against ``jax.vjp`` of the
  JAX package's ``_flash_attention`` in the TPU interpreter, that is the
  stock Pallas backward kernels (``_flash_attention_bwd_dkv`` and
  ``_flash_attention_bwd_dq``) themselves, at S not a multiple of 512 (the
  JAX side pads behind segment ids): max|d| <= 1.5e-2 * max|ref| and
  ||d|| / ||ref|| <= 1e-2 for each of dq, dk and dv.  The stock kernels
  round P and dS to bf16 for their products and take D from their own
  forward's output; the plain version keeps them fp32.
- In fp32, against ``jax.vjp`` of ``single_head_attention``'s exact path
  (what the JAX bf16 engine differentiates, its flash being off by
  default): max|d| <= 1e-5 * max|ref|.
- ``flash_attention_lse_plain`` against ``jax.nn.logsumexp`` of the scaled
  logits: within 1e-6 relative.
- The autograd Function on the CPU: ``gradcheck`` in float64, and its
  gradient against autograd's through ``exact_attention`` (fp32, within
  1e-5 * max|ref|: other sum orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.ops import attention as jattn

from cvvae_tpu_torch.ops import attention as tattn
from cvvae_tpu_torch.ops.exact_attention import exact_attention
from cvvae_tpu_torch.ops.kernels import attention as k4

torch.set_num_threads(2)


def _np(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)) \
        .astype(np.float32)


def _grads_close(got, ref, max_rel, rms_rel=None):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g = g.float().numpy().astype(np.float64)
        r = np.asarray(r, np.float64)
        d = np.abs(g - r)
        assert d.max() <= max_rel * np.abs(r).max(), (name, d.max(),
                                                       np.abs(r).max())
        if rms_rel is not None:
            rms = np.linalg.norm(d) / np.linalg.norm(r)
            assert rms <= rms_rel, (name, rms)


@pytest.mark.parametrize("shape", [(2, 600, 64), (1, 1100, 128)])
def test_backward_plain_matches_the_stock_pallas_backward(shape):
    import jax.experimental.pallas.tpu as pltpu

    q, k, v = (0.5 * _np(shape, 85 + i) for i in range(3))
    do = _np(shape, 90)
    scale = shape[-1] ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jattn._flash_attention(a, b, c, scale),
                         jq, jk, jv)
        ref = [np.asarray(g, np.float32) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    o = k4.flash_attention_plain(tq, tk, tv, scale)
    lse = k4.flash_attention_lse_plain(tq, tk, scale)
    got = k4.flash_attention_backward_plain(tq, tk, tv, o, tdo, lse, scale)
    assert all(g.dtype == torch.bfloat16 and tuple(g.shape) == shape
               for g in got)
    _grads_close(got, ref, 1.5e-2, 1e-2)


def test_backward_plain_fp32_matches_the_exact_path_vjp():
    shape = (2, 600, 32)
    q, k, v = (_np(shape, 70 + i) for i in range(3))
    do = _np(shape, 75)
    scale = shape[-1] ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: jattn.single_head_attention(a, b, c),
                     *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = k4.flash_attention_plain(tq, tk, tv, scale)
    got = k4.flash_attention_backward_plain(
        tq, tk, tv, o, tdo, k4.flash_attention_lse_plain(tq, tk, scale), scale)
    _grads_close(got, ref, 1e-5)


@pytest.mark.parametrize("shape", [(2, 600, 64), (1, 37, 512)])
def test_lse_plain_matches_jax_logsumexp(shape):
    q, k = _np(shape, 60), _np(shape, 61, 3.0)
    scale = shape[-1] ** -0.5
    ref = np.asarray(jax.nn.logsumexp(
        jnp.einsum("bqc,bkc->bqk", q, k,
                   precision=jax.lax.Precision.HIGHEST) * scale, axis=-1))
    got = k4.flash_attention_lse_plain(torch.from_numpy(q),
                                       torch.from_numpy(k), scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:2]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_autograd_function_passes_gradcheck():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 7, 4, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: k4.flash_attention(a, b, c, 0.7), (q, k, v))


def test_autograd_function_gradient_is_the_exact_paths():
    shape = (2, 600, 16)
    q, k, v = (torch.from_numpy(_np(shape, 50 + i)) for i in range(3))
    do = torch.from_numpy(_np(shape, 55))
    grads = []
    for fn in (k4.flash_attention, exact_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, 0.25).backward(do)
        grads.append([t.grad for t in leaves])
    assert k4.launches == k4.bwd_launches == 0
    _grads_close(grads[0], [g.numpy() for g in grads[1]], 1e-5)


def test_no_flash_attention_sends_every_call_to_the_exact_path():
    assert tattn.flash_usable("cuda", torch.bfloat16, 4096)
    with tattn.no_flash_attention():
        assert not tattn.flash_usable("cuda", torch.bfloat16, 4096)
        with tattn.no_flash_attention():
            pass
        assert not tattn.flash_usable("cuda", torch.bfloat16, 4096)
    assert tattn.flash_usable("cuda", torch.bfloat16, 4096)
