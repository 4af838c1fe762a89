"""The port's ops (cvvae_tpu_torch.ops) against the JAX package's, on CPU.

Inputs and weights are made with numpy from a seed and fed to both
packages; where the JAX function is a Pallas kernel it runs in interpret
mode.  On a CPU tensor each of the port's kernel wrappers takes its plain
PyTorch version, so these tests hold the plain versions of K1 (GroupNorm
+SiLU), K2 (subpixel interleave) and K3 (stem conv) against the JAX
package.  fp32 throughout; tolerances are stated per test.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cvvae_tpu.ops import attention as jattn
from cvvae_tpu.ops import conv as jconv
from cvvae_tpu.ops import distributions as jdist
from cvvae_tpu.ops import norm as jnorm
from cvvae_tpu.ops import resample as jresample
from cvvae_tpu.ops import upsample_conv as jup
from cvvae_tpu.ops.activations import silu as jsilu
from cvvae_tpu.ops.pallas.groupnorm import group_norm_silu_pallas
from cvvae_tpu.ops.pallas.shuffle import subpixel_interleave as j_interleave
from cvvae_tpu.ops.pallas.stem import stem_conv3d as j_stem

from cvvae_tpu_torch.ops import attention as tattn
from cvvae_tpu_torch.ops import conv as tconv
from cvvae_tpu_torch.ops import distributions as tdist
from cvvae_tpu_torch.ops import norm as tnorm
from cvvae_tpu_torch.ops import resample as tresample
from cvvae_tpu_torch.ops import upsample_conv as tup
from cvvae_tpu_torch.ops.kernels import groupnorm as k1
from cvvae_tpu_torch.ops.kernels import shuffle as k2
from cvvae_tpu_torch.ops.kernels import stem as k3

torch.set_num_threads(2)

#: fp32 ops: the two packages sum in different orders
ATOL = 2e-5


def _np(shape, seed, scale=1.0, shift=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_params(kernel, bias):
    """JAX conv params (kT,kH,kW,I,O) -> the port's (O,I,kT,kH,kW)."""
    return types.SimpleNamespace(
        weight=_t(kernel.transpose(4, 3, 0, 1, 2)),
        bias=None if bias is None else _t(bias))


def _dense_params(kernel, bias):
    return types.SimpleNamespace(weight=_t(kernel.T), bias=_t(bias))


def _close(got, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# K1: GroupNorm (+SiLU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", [((2, 3, 5, 6, 16), 4),
                                          ((1, 2, 3, 4, 32), 32),
                                          ((2, 4, 6, 12), 2)])
def test_group_norm_matches_jax(shape, groups, silu):
    x = _np(shape, 0, 2.0, 0.5)
    scale, bias = _np(shape[-1:], 1), _np(shape[-1:], 2)
    ref = jnorm.group_norm(jnp.asarray(x), {"scale": scale, "bias": bias},
                           num_groups=groups, eps=1e-5)
    if silu:
        ref = jsilu(ref)
    params = types.SimpleNamespace(weight=_t(scale), bias=_t(bias))
    got = tnorm.group_norm(_t(x), params, num_groups=groups, eps=1e-5,
                           silu=silu)
    _close(got, ref)


def test_group_norm_per_frame_matches_jax():
    x = _np((2, 3, 5, 6, 16), 3, 1.5, -0.3)
    scale, bias = _np((16,), 4), _np((16,), 5)
    ref = jnorm.group_norm_per_frame(jnp.asarray(x),
                                     {"scale": scale, "bias": bias},
                                     num_groups=4, eps=1e-5)
    params = types.SimpleNamespace(weight=_t(scale), bias=_t(bias))
    got = tnorm.group_norm_per_frame(_t(x), params, num_groups=4, eps=1e-5)
    _close(got, ref)


@pytest.mark.parametrize("silu,per_frame", [(True, False), (False, False),
                                            (False, True)])
def test_group_norm_plain_matches_pallas_kernel(silu, per_frame):
    """Plain K1 against the Pallas kernel it replaces (interpret mode), at
    a shape the Pallas version accepts (C % 128 == 0)."""
    x = _np((2, 4, 8, 16, 128), 6)
    scale, bias = _np((128,), 7), _np((128,), 8)
    xj = jnp.asarray(x)
    if per_frame:
        xj = xj.reshape(8, 8, 16, 128)
    ref = group_norm_silu_pallas(xj, jnp.asarray(scale), jnp.asarray(bias),
                                 num_groups=4, eps=1e-5, silu=silu,
                                 interpret=True)
    got = k1.group_norm_silu(_t(x), _t(scale), _t(bias), num_groups=4,
                             eps=1e-5, silu=silu, per_frame=per_frame)
    _close(got, np.asarray(ref).reshape(x.shape))


def test_layer_norm_matches_jax():
    x = _np((2, 3, 4, 5, 16), 9, 3.0, 1.0)
    scale, bias = _np((16,), 10), _np((16,), 11)
    ref = jnorm.layer_norm(jnp.asarray(x), {"scale": scale, "bias": bias})
    params = types.SimpleNamespace(weight=_t(scale), bias=_t(bias))
    _close(tnorm.layer_norm(_t(x), params), ref)


# ---------------------------------------------------------------------------
# convs and K3 (stem)
# ---------------------------------------------------------------------------

SPECS = {
    "v1_causal": jconv.Conv3DSpec.v1_causal(),
    "v1_plain": jconv.Conv3DSpec.v1_plain(),
    "sd3_causal": jconv.Conv3DSpec.sd3_causal(),
    "sd3_plain": jconv.Conv3DSpec.sd3_plain(),
    "spatial2d": jconv.Conv3DSpec.spatial2d(),
    "pointwise": jconv.Conv3DSpec.pointwise(),
    "v1_downsample_t": jconv.Conv3DSpec.v1_downsample(True),
    "v1_downsample_s": jconv.Conv3DSpec.v1_downsample(False),
}


def _port_spec(spec):
    return tconv.Conv3DSpec(spec.kernel, spec.stride, spec.pads, spec.modes,
                            spec.use_bias)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("cin,cout", [(6, 10), (16, 3)])
def test_conv3d_matches_jax(name, cin, cout):
    spec = SPECS[name]
    x = _np((2, 5, 9, 10, cin), 12)
    kernel = _np(spec.kernel + (cin, cout), 13, 0.2)
    bias = _np((cout,), 14)
    ref = jconv.conv3d(jnp.asarray(x), {"kernel": kernel, "bias": bias}, spec)
    got = tconv.conv3d(_t(x), _conv_params(kernel, bias), _port_spec(spec))
    assert got.is_contiguous()
    _close(got, ref)


def test_conv_constructors_match_jax():
    for ctor in ("v1_causal", "v1_plain", "sd3_causal", "sd3_plain"):
        for k, p, stride in ((3, 1, (1, 1, 1)), (5, 2, (2, 1, 1))):
            j = getattr(jconv.Conv3DSpec, ctor)(k, p, stride)
            t = getattr(tconv.Conv3DSpec, ctor)(k, p, stride)
            assert (t.kernel, t.stride, t.pads, t.modes) == \
                (j.kernel, j.stride, j.pads, j.modes), ctor
    for down in (True, False):
        j, t = (m.Conv3DSpec.v1_downsample(down) for m in (jconv, tconv))
        assert (t.kernel, t.stride, t.pads, t.modes) == \
            (j.kernel, j.stride, j.pads, j.modes)
    j, t = jconv.Conv3DSpec.spatial2d(3, 1, (2, 2)), \
        tconv.Conv3DSpec.spatial2d(3, 1, (2, 2))
    assert (t.kernel, t.stride, t.pads, t.modes) == \
        (j.kernel, j.stride, j.pads, j.modes)
    assert tconv.Conv3DSpec.pointwise().fan_in(7) == \
        jconv.Conv3DSpec.pointwise().fan_in(7)


@pytest.mark.parametrize("cin,modes,pads", [
    (3, ("edge", "zero", "zero"), ((2, 0), (1, 1), (1, 1))),  # v1 stem
    (4, ("zero", "zero", "zero"), ((1, 1), (1, 1), (1, 1))),  # latent stem
])
def test_stem_plain_matches_pallas_kernel(cin, modes, pads):
    """Plain K3 against the Pallas stem kernel (interpret mode) for the two
    stems the JAX tests run."""
    spec = jconv.Conv3DSpec((3, 3, 3), (1, 1, 1), pads, modes)
    x = _np((1, 5, 16, 12, cin), 15)
    kernel = _np((3, 3, 3, cin, 128), 16, 0.1)
    bias = _np((128,), 17)
    ref = j_stem(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), spec,
                 interpret=True)
    p = _conv_params(kernel, bias)
    got = k3.stem_conv3d(_t(x), p.weight, p.bias, _port_spec(spec))
    _close(got, ref)


def test_encoder_stem_goes_through_k3_wrapper():
    """conv3d sends the pixel stem (Cin=3, 128 out, 3x3x3, stride 1) to
    the K3 wrapper and leaves the Cin=4 latent stem to F.conv3d."""
    spec = tconv.Conv3DSpec.v1_causal()
    x = _t(_np((1, 3, 6, 7, 3), 18))
    p = _conv_params(_np((3, 3, 3, 3, 128), 19, 0.1), _np((128,), 20))
    assert k3.stem_usable(p.weight, spec)
    torch.testing.assert_close(tconv.conv3d(x, p, spec),
                               k3.stem_conv3d_plain(x, p.weight, p.bias, spec),
                               rtol=0, atol=0)
    latent = _conv_params(_np((3, 3, 3, 4, 128), 21), None)
    assert not k3.stem_usable(latent.weight, spec)


# ---------------------------------------------------------------------------
# K2: subpixel interleave, and the fused upsample around it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,drop", [(2, True), (2, False), (1, False),
                                    (1, True)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_interleave_plain_bit_exact_vs_pallas_kernel(n, drop, with_bias):
    phases = [_np((1, 3, 4, 8, n * 128), 30 + i) for i in range(4)]
    bias = _np((n * 128,), 40) if with_bias else None
    ref = j_interleave([jnp.asarray(p) for p in phases],
                       None if bias is None else jnp.asarray(bias), n=n,
                       drop_first=drop, interpret=True)
    got = k2.subpixel_interleave([_t(p) for p in phases],
                                 None if bias is None else _t(bias), n=n,
                                 drop_first=drop)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


UPSAMPLE_CASES = [
    # n, t_pad, t_mode, hw_mode, drop_first
    (2, (2, 0), "edge", "zero", True),     # v1 causal decoder, time up
    (2, (1, 1), "edge", "zero", True),     # v1 decoder, time up
    (1, (1, 1), "edge", "zero", True),     # v1 decoder, space only
    (2, (1, 1), "zero", "zero", False),
    (1, (2, 0), "edge", "edge", True),     # SD3-style edge padding
]


@pytest.mark.parametrize("n,t_pad,t_mode,hw_mode,drop", UPSAMPLE_CASES)
def test_upsample_interleave_matches_jax(n, t_pad, t_mode, hw_mode, drop):
    x = _np((1, 3, 5, 6, 8), 50)
    kernel = _np((3, 3, 3, 8, 6 * n), 51, 0.2)
    bias = _np((6 * n,), 52)
    kw = dict(n=n, t_pad=t_pad, t_mode=t_mode, hw_mode=hw_mode,
              drop_first=drop)
    ref = jup.upsample2x_conv3x3_interleave(
        jnp.asarray(x), {"kernel": kernel, "bias": bias}, **kw)
    got = tup.upsample2x_conv3x3_interleave(_t(x), _conv_params(kernel, bias),
                                            **kw)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("n,t_pad,t_mode,hw_mode,drop", UPSAMPLE_CASES)
def test_upsample_interleave_matches_naive(n, t_pad, t_mode, hw_mode, drop):
    """The subpixel form == nearest 2x upsample, then the 3x3x3 conv, then
    the channel->time interleave, all in the port."""
    x = _t(_np((2, 3, 4, 5, 8), 53))
    p = _conv_params(_np((3, 3, 3, 8, 4 * n), 54, 0.2), _np((4 * n,), 55))
    got = tup.upsample2x_conv3x3_interleave(
        x, p, n=n, t_pad=t_pad, t_mode=t_mode, hw_mode=hw_mode,
        drop_first=drop)
    spec = tconv.Conv3DSpec((3, 3, 3), (1, 1, 1), (t_pad, (1, 1), (1, 1)),
                            (t_mode, hw_mode, hw_mode))
    naive = tconv.conv3d(tresample.nearest_upsample_2x_spatial(x), p, spec)
    naive = tresample.temporal_interleave(naive, n, drop_first=drop)
    torch.testing.assert_close(got, naive, atol=ATOL, rtol=0)


def test_resample_helpers_match_jax():
    x = _np((1, 3, 4, 5, 6), 56)
    _close(tresample.nearest_upsample_2x_spatial(_t(x)),
           jresample.nearest_upsample_2x_spatial(jnp.asarray(x)), atol=0)
    for n, drop in ((2, True), (2, False), (3, True), (1, True)):
        _close(tresample.temporal_interleave(_t(x), n, drop_first=drop),
               jresample.temporal_interleave(jnp.asarray(x), n,
                                             drop_first=drop), atol=0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [300, 700])
def test_single_head_attention_matches_jax(s):
    """S below the 512-query chunk (one block) and above it (blocked)."""
    q, k, v = (_np((2, s, 16), 60 + i) for i in range(3))
    ref = jattn.single_head_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
    got = tattn.single_head_attention(_t(q), _t(k), _t(v))
    _close(got, ref)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
@pytest.mark.parametrize("hw", [(4, 5), (24, 25)])
def test_self_attention_matches_jax(kind, hw):
    c = 16
    x = _np((1, 3) + hw + (c,), 70)
    ws = [(_np((c, c), 71 + i, 0.25), _np((c,), 75 + i)) for i in range(3)]
    jp = [{"kernel": k, "bias": b} for k, b in ws]
    tp = [_dense_params(k, b) for k, b in ws]
    jfn = (jattn.spatial_self_attention if kind == "spatial"
           else jattn.temporal_self_attention)
    tfn = (tattn.spatial_self_attention if kind == "spatial"
           else tattn.temporal_self_attention)
    ref = jfn(jnp.asarray(x), *jp)
    got = tfn(_t(x), *tp)
    assert got.is_contiguous()
    _close(got, ref)


def test_dense_matches_jax():
    x = _np((3, 4, 16), 80)
    k, b = _np((16, 7), 81), _np((7,), 82)
    _close(tattn.dense(_t(x), _dense_params(k, b)),
           jattn.dense(jnp.asarray(x), {"kernel": k, "bias": b}))


# ---------------------------------------------------------------------------
# posterior
# ---------------------------------------------------------------------------

def test_diagonal_gaussian_matches_jax():
    moments = _np((2, 3, 4, 5, 8), 90, 3.0)
    moments[..., 4:] *= 12.0                 # exercise the logvar clamp
    other = _np((2, 3, 4, 5, 8), 91)
    sample = _np((2, 3, 4, 5, 4), 92)
    jp = jdist.DiagonalGaussian.from_moments(jnp.asarray(moments))
    jo = jdist.DiagonalGaussian.from_moments(jnp.asarray(other))
    tp = tdist.DiagonalGaussian.from_moments(_t(moments))
    to = tdist.DiagonalGaussian.from_moments(_t(other))
    _close(tp.mode(), jp.mode(), atol=0)
    _close(tp.logvar, jp.logvar, atol=0)
    _close(tp.std, jp.std, atol=0, rtol=1e-6)
    np.testing.assert_allclose(tp.kl().numpy(), np.asarray(jp.kl()),
                               rtol=1e-5)
    np.testing.assert_allclose(tp.kl(to).numpy(), np.asarray(jp.kl(jo)),
                               rtol=1e-5)
    np.testing.assert_allclose(tp.nll(_t(sample)).numpy(),
                               np.asarray(jp.nll(jnp.asarray(sample))),
                               rtol=1e-5)


def test_diagonal_gaussian_sample_uses_generator():
    tp = tdist.DiagonalGaussian.from_moments(_t(_np((1, 2, 3, 4, 8), 93)))
    a = tp.sample(torch.Generator().manual_seed(5))
    b = tp.sample(torch.Generator().manual_seed(5))
    c = tp.sample(torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == tp.mean.shape
