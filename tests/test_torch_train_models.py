"""Forward parity of the training stack's nets and losses with the JAX
package, on the CPU in fp32: the 2D constraint nets (``vae2d``, SD3 and
SD2.1 naming), Disc3D, Disc2D (BatchNorm in training and inference mode,
with the running statistics it advances; ActNorm's data init), LPIPS, the
GAN / NLL / constraint-target losses, the adaptive weight and the
posterior's KL.

JAX params load into the port through ``from_jax_params`` with
``strict=True``.  Tolerance: the golden suites' 3e-4 abs on net outputs
(ATOL), 1e-5 relative on scalar losses (RTOL).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.losses import gan as jgan
from cvvae_tpu.losses import vae_loss as jloss
from cvvae_tpu.models import discriminator as jdisc
from cvvae_tpu.models import lpips as jlpips
from cvvae_tpu.models import vae2d as jvae2d
from cvvae_tpu.ops.distributions import DiagonalGaussian as JGaussian

from cvvae_tpu_torch.losses import gan as tgan
from cvvae_tpu_torch.losses import vae_loss as tloss
from cvvae_tpu_torch.models import discriminator as tdisc
from cvvae_tpu_torch.models import lpips as tlpips
from cvvae_tpu_torch.models import vae2d as tvae2d
from cvvae_tpu_torch.ops.distributions import DiagonalGaussian
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

ATOL = 3e-4
RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, jparams):
    module.load_state_dict(from_jax_params(_np(jparams)), strict=True)
    return module


def _rand(shape, seed=0, scale=1.0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def _close(got, ref, atol=ATOL):
    assert tuple(got.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


VAE2D = {
    "sd3": dict(naming="sd3", latent_channels=4,
                block_out_channels=(8, 16, 16), layers_per_block=1,
                norm_num_groups=4),
    "sd21_legacy": dict(naming="sd21", latent_channels=4,
                        block_out_channels=(8, 16, 16), layers_per_block=1,
                        norm_num_groups=4, legacy_quant_conv=True),
}


@pytest.mark.parametrize("name", list(VAE2D))
def test_vae2d_decoder_matches_jax(name):
    cfg = jvae2d.VAE2DConfig(**VAE2D[name])
    p = jvae2d.init_decoder2d(jax.random.PRNGKey(0), cfg)
    net = _load(tvae2d.Decoder2D(tvae2d.VAE2DConfig(**VAE2D[name])), p)
    z = _rand((2, 3, 4, 5, 4))
    with torch.no_grad():
        got = net(torch.from_numpy(z))
    _close(got, jvae2d.apply_decoder2d(p, jnp.asarray(z), cfg))


@pytest.mark.parametrize("name", list(VAE2D))
def test_vae2d_encoder_matches_jax(name):
    cfg = jvae2d.VAE2DConfig(**VAE2D[name])
    p = jvae2d.init_encoder2d(jax.random.PRNGKey(1), cfg)
    net = _load(tvae2d.Encoder2D(tvae2d.VAE2DConfig(**VAE2D[name])), p)
    x = _rand((1, 2, 16, 12, 3), 1)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got, jvae2d.apply_encoder2d(p, jnp.asarray(x), cfg))


DISC3D = [dict(ndf=8, n_layers=4, norm_groups=4),
          dict(ndf=8, n_layers=3, norm_groups=4, causal=True, half_3d=True)]


@pytest.mark.parametrize("kw", DISC3D)
def test_disc3d_matches_jax(kw):
    cfg = jdisc.Disc3DConfig(**kw)
    p = jdisc.init_disc3d(jax.random.PRNGKey(2), cfg)
    net = _load(tdisc.Disc3D(tdisc.Disc3DConfig(**kw)), p)
    x = _rand((1, 5, 32, 32, 3), 2)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got, jdisc.apply_disc3d(p, jnp.asarray(x), cfg))


def test_shipped_discriminator_tree_loads_strictly():
    cfg, p = jdisc.get_cvvae_discriminator(jax.random.PRNGKey(3))
    tcfg = tdisc.get_cvvae_discriminator()
    assert dataclasses_equal(cfg, tcfg)
    _load(tdisc.Disc3D(tcfg), p)


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("train", [True, False])
def test_disc2d_batchnorm_matches_jax(train):
    cfg = jdisc.Disc2DConfig(ndf=8, n_layers=3)
    p = jdisc.init_disc2d(jax.random.PRNGKey(4), cfg)
    net = _load(tdisc.Disc2D(tdisc.Disc2DConfig(ndf=8, n_layers=3)), p)
    x = _rand((2, 2, 32, 32, 3), 4)
    ref, new = jdisc.apply_disc2d(p, jnp.asarray(x), cfg, train=train,
                                  update_stats=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), train=train, update_stats=True)
    _close(got, ref)
    want = from_jax_params(_np(new))
    for k, v in net.state_dict().items():
        if k.endswith(".mean") or k.endswith(".var"):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_disc2d_actnorm_initialises_like_jax():
    cfg = jdisc.Disc2DConfig(ndf=8, n_layers=2, use_actnorm=True)
    p = jdisc.init_disc2d(jax.random.PRNGKey(5), cfg)
    net = _load(tdisc.Disc2D(tdisc.Disc2DConfig(ndf=8, n_layers=2,
                                                use_actnorm=True)), p)
    x = _rand((2, 1, 32, 32, 3), 5)
    ref, new = jdisc.apply_disc2d(p, jnp.asarray(x), cfg, train=True,
                                  update_stats=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), train=True, update_stats=True)
    _close(got, ref)
    for k, v in from_jax_params(_np(new)).items():
        np.testing.assert_allclose(net.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_lpips_matches_jax():
    p = jlpips.init_lpips(jax.random.PRNGKey(6))
    net = _load(tlpips.LPIPS(), p)
    x, y = (np.tanh(_rand((3, 32, 32, 3), s)) for s in (6, 7))
    ref = jlpips.lpips_distance(p, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = tlpips.lpips_distance(net, torch.from_numpy(x),
                                    torch.from_numpy(y))
    assert tuple(got.shape) == (3, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)


def test_load_lpips_params_matches_jax_loader():
    """Both loaders read the same torch state dicts (torchvision's
    vgg16().features and the LPIPS heads) into equal weights."""
    r = np.random.RandomState(8)
    vgg, c_in = {}, 3
    for idx, (c_out, _) in zip(tlpips.VGG_CONV_INDICES, tlpips._VGG_PLAN):
        vgg[f"{idx}.weight"] = r.randn(c_out, c_in, 3, 3).astype(np.float32)
        vgg[f"{idx}.bias"] = r.randn(c_out).astype(np.float32)
        c_in = c_out
    lins = {f"lin{k}.model.1.weight": r.randn(1, c, 1, 1).astype(np.float32)
            for k, c in enumerate(tlpips.LPIPS_CHANNELS)}
    got = tlpips.load_lpips_params(vgg, lins)
    want = from_jax_params(_np(jlpips.load_lpips_params(vgg, lins)))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    tlpips.LPIPS().load_state_dict(got, strict=True)


def test_gan_losses_match_jax():
    real, fake = _rand((2, 3, 4, 4, 1), 9), _rand((2, 3, 4, 4, 1), 10)
    for jf, tf in ((jgan.hinge_d_loss, tgan.hinge_d_loss),
                   (jgan.vanilla_d_loss, tgan.vanilla_d_loss)):
        ref = float(jf(jnp.asarray(real), jnp.asarray(fake)))
        got = float(tf(torch.from_numpy(real), torch.from_numpy(fake)))
        assert abs(got - ref) <= RTOL * abs(ref)
    assert abs(float(tgan.generator_loss(torch.from_numpy(fake)))
               - float(jgan.generator_loss(jnp.asarray(fake)))) <= 1e-6


@pytest.mark.parametrize("kind", ["l1", "l2"])
@pytest.mark.parametrize("perceptual", [0.0, 0.5])
def test_rec_and_nll_match_jax(kind, perceptual):
    lp = jlpips.init_lpips(jax.random.PRNGKey(11))
    net = _load(tlpips.LPIPS(), lp)
    cfg = dict(perceptual_weight=perceptual, rec_loss=kind)
    x, xr = (np.tanh(_rand((1, 3, 16, 16, 3), s)) for s in (12, 13))
    ref = jloss.rec_with_perceptual(jloss.LossConfig(**cfg), lp,
                                    jnp.asarray(x), jnp.asarray(xr))
    with torch.no_grad():
        got = tloss.rec_with_perceptual(tloss.LossConfig(**cfg), net,
                                        torch.from_numpy(x),
                                        torch.from_numpy(xr))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)
    lv = 0.3
    nref = float(jloss.nll_from_rec(ref, jnp.asarray(lv)))
    ngot = float(tloss.nll_from_rec(got, torch.tensor(lv)))
    assert abs(ngot - nref) <= 1e-4 * abs(nref)


@pytest.mark.parametrize("target_type", ["slice", "mean", "random"])
def test_constraint_targets_match_jax(target_type):
    x = _rand((2, 9, 4, 4, 3), 14)
    key = jax.random.PRNGKey(15)
    ref = jloss.constraint_targets(jloss.LossConfig(target_type=target_type),
                                   jnp.asarray(x), key)
    offsets = None
    if target_type == "random":  # the JAX package's draw, handed over
        offsets = torch.from_numpy(np.array(
            jax.random.randint(key, (2,), 1, 5)))
    got = tloss.constraint_targets(tloss.LossConfig(target_type=target_type),
                                   torch.from_numpy(x), offsets=offsets)
    assert tuple(got.shape) == (2, 3, 4, 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_adaptive_weight_and_kl_match_jax():
    cfg = dict(disc_weight=0.5)
    for a, b in ((3.0, 0.5), (1e-3, 0.0), (5e4, 1.0)):
        ref = float(jloss.adaptive_disc_weight(jloss.LossConfig(**cfg),
                                               jnp.asarray(a), jnp.asarray(b)))
        got = float(tloss.adaptive_disc_weight(tloss.LossConfig(**cfg),
                                               torch.tensor(a),
                                               torch.tensor(b)))
        assert abs(got - ref) <= RTOL * abs(ref)
    moments = _rand((2, 3, 4, 4, 8), 16)
    noise = _rand((2, 3, 4, 4, 4), 17)
    jp = JGaussian.from_moments(jnp.asarray(moments))
    tp = DiagonalGaussian.from_moments(torch.from_numpy(moments))
    np.testing.assert_allclose(tp.kl().numpy(), np.asarray(jp.kl()),
                               rtol=1e-5)
    other = DiagonalGaussian.from_moments(torch.from_numpy(moments[::-1].copy()))
    jother = JGaussian.from_moments(jnp.asarray(moments[::-1].copy()))
    np.testing.assert_allclose(tp.kl(other).numpy(),
                               np.asarray(jp.kl(jother)), rtol=1e-5)
    np.testing.assert_allclose(
        tp.sample(noise=torch.from_numpy(noise)).numpy(),
        np.asarray(jp.mean + jp.std * jnp.asarray(noise)), rtol=1e-6,
        atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        tp.sample(noise=torch.zeros(1))


def test_diagonal_gaussian_regularizer_matches_jax():
    from cvvae_tpu.losses.regularizers import \
        diagonal_gaussian_regularizer as jreg
    from cvvae_tpu_torch.losses.regularizers import (
        diagonal_gaussian_regularizer, identity_regularizer)
    moments = _rand((2, 3, 4, 4, 8), 18)
    key = jax.random.PRNGKey(19)
    z_ref, log_ref = jreg(jnp.asarray(moments), key)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (2, 3, 4, 4, 4), jnp.float32)))
    z, log = diagonal_gaussian_regularizer(torch.from_numpy(moments),
                                           noise=noise)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-6,
                               atol=1e-6)
    assert abs(float(log["kl_loss"]) - float(log_ref["kl_loss"])) <= \
        RTOL * abs(float(log_ref["kl_loss"]))
    mode, _ = diagonal_gaussian_regularizer(torch.from_numpy(moments),
                                            sample=False)
    torch.testing.assert_close(mode, torch.from_numpy(moments[..., :4]))
    assert identity_regularizer(mode)[1] == {}
