"""The port's ``VideoVAE`` (encode / decode / reconstruct, tiling and
chunking, layout contracts) against the JAX package's, on CPU in fp32.

Both run the same weights (JAX ``from_config`` -> ``from_jax_params``).
Tolerance is the golden suites' bound, 3e-4 abs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig

from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import (VideoVAE, VideoVAEConfig,
                                              config_for_variant)
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

ATOL = 3e-4
NET = dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
           norm_num_groups=4)
BASE = dict(en_de_n_frames_a_time=None, tile_spatial_size=None)


@pytest.fixture(scope="module")
def weights():
    jvae = JVAE.from_config(JConfig(family="v1", net=JNet(**NET), **BASE),
                            seed=0)
    return jvae.params, from_jax_params(jax.tree.map(np.asarray,
                                                     jvae.params))


def _pair(weights, **overrides):
    params, state = weights
    jvae = JVAE(JConfig(family="v1", net=JNet(**NET),
                        **dict(BASE, **overrides)), params)
    tvae = VideoVAE(VideoVAEConfig(family="v1", net=VAE1Config(**NET),
                                   **dict(BASE, **overrides))).eval()
    tvae.load_state_dict(state, strict=True)
    return jvae, tvae


def _clip(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _close(got, ref):
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


# serving-style rectangular tiles: per-axis ratios give an exact 2-latent
# (16 px) overlap on each axis, and a 2x2 grid exercises the blend cascade
RECT = dict(tile_spatial_size=(48, 40), tile_overlap_ratio=(2 / 6, 2 / 5))


@pytest.mark.parametrize("encode_tile", ["inherit", None])
def test_rect_tiles_match_jax(weights, encode_tile):
    jvae, tvae = _pair(weights, encode_tile_spatial_size=encode_tile, **RECT)
    x = _clip((1, 5, 80, 64, 3))
    zj = jvae.encode(jnp.asarray(x)).mode()
    zt = tvae.encode(torch.from_numpy(x)).mode()
    _close(zt, zj)
    # decode the same latent on both sides: 10x8 latents -> 2x2 tiles
    _close(tvae.decode(torch.from_numpy(np.array(zj))), jvae.decode(zj))


def test_square_tiles_scalar_ratio_match_jax(weights):
    jvae, tvae = _pair(weights, tile_spatial_size=32, tile_overlap_ratio=0.25)
    x = _clip((1, 5, 48, 56, 3), 1)
    _close(tvae.reconstruct(torch.from_numpy(x)),
           jvae.reconstruct(jnp.asarray(x)))


def test_temporal_chunking_matches_jax(weights):
    """en_de_n_frames_a_time=4 on 9 frames: 2 encode windows of 5 frames
    with a 1-frame causal overlap, 2 decode windows of 2 latents."""
    jvae, tvae = _pair(weights, en_de_n_frames_a_time=4)
    x = _clip((1, 9, 16, 24, 3), 2)
    zj = jvae.encode(jnp.asarray(x)).mode()
    zt = tvae.encode(torch.from_numpy(x)).mode()
    assert tuple(zt.shape) == (1, 3, 2, 3, 4)
    _close(zt, zj)
    _close(tvae.decode(torch.from_numpy(np.array(zj))), jvae.decode(zj))


def test_layout_contracts_match_jax(weights):
    jvae, tvae = _pair(weights, num_video_frames=5)
    x5 = _clip((2, 5, 16, 16, 3), 3)
    # 4-D (B,H,W,C) input is a single frame
    x4 = x5[:, 0]
    _close(tvae.encode(torch.from_numpy(x4)).mode(),
           jvae.encode(jnp.asarray(x4)).mode())
    # channels_first 5-D (B,C,T,H,W) in and out
    xcf = np.ascontiguousarray(x5.transpose(0, 4, 1, 2, 3))
    zj = jvae.encode(jnp.asarray(xcf), channels_first=True).mode()
    zt = tvae.encode(torch.from_numpy(xcf), channels_first=True).mode()
    _close(zt, zj)
    # the posterior is channels-last; decode takes (B,C,T,H,W)
    zcf = np.ascontiguousarray(np.asarray(zj).transpose(0, 4, 1, 2, 3))
    _close(tvae.decode(torch.from_numpy(zcf), channels_first=True),
           jvae.decode(jnp.asarray(zcf), channels_first=True))
    # channels_first 4-D ((b t), C, H, W) with num_video_frames / num_frames
    x4cf = np.ascontiguousarray(xcf.transpose(0, 2, 1, 3, 4)
                                .reshape(10, 3, 16, 16))
    zj4 = jvae.encode(jnp.asarray(x4cf), channels_first=True).mode()
    _close(tvae.encode(torch.from_numpy(x4cf), channels_first=True).mode(),
           zj4)
    z4 = np.ascontiguousarray(np.asarray(zj4).transpose(0, 1, 4, 2, 3)
                              .reshape(4, 4, 2, 2))
    _close(tvae.decode(torch.from_numpy(z4), num_frames=2,
                       channels_first=True),
           jvae.decode(jnp.asarray(z4), num_frames=2, channels_first=True))
    # 4-D (B,H,W,z) latent decodes as one latent frame
    z1 = np.asarray(zj)[:, 0].copy()
    _close(tvae.decode(torch.from_numpy(z1)), jvae.decode(jnp.asarray(z1)))


def test_max_batch_size_matches_jax(weights):
    jvae, tvae = _pair(weights)
    x = _clip((3, 5, 16, 16, 3), 4)
    post_t = tvae.encode(torch.from_numpy(x), max_batch_size=2)
    post_j = jvae.encode(jnp.asarray(x), max_batch_size=2)
    _close(post_t.mean, post_j.mean)
    _close(post_t.logvar, post_j.logvar)
    _close(tvae.decode(post_t.mode(), max_batch_size=2),
           jvae.decode(post_j.mode(), max_batch_size=2))


def test_sample_posterior_needs_generator(weights):
    _, tvae = _pair(weights)
    x = torch.from_numpy(_clip((1, 1, 16, 16, 3), 5))
    with pytest.raises(ValueError, match="generator"):
        tvae.reconstruct(x, sample_posterior=True)
    a = tvae.reconstruct(x, sample_posterior=True,
                         generator=torch.Generator().manual_seed(0))
    b = tvae.reconstruct(x, sample_posterior=True,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


def test_config_matches_jax_properties():
    for kw in (dict(tile_spatial_size=(720, 672), tile_overlap_ratio=(0.1, 0.1),
                    encode_tile_spatial_size=None),
               dict(tile_spatial_size=576, num_video_frames=17),
               dict(en_de_n_frames_a_time=None, tile_spatial_size=None)):
        j, t = JConfig(family="v1", **kw), VideoVAEConfig(family="v1", **kw)
        for prop in ("latent_channels", "decode_n_frames_a_time",
                     "pixel_tile_size", "latent_tile_size",
                     "encode_pixel_tile_size", "encode_latent_tile_size",
                     "num_latent_frames"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert dataclasses.asdict(t.net) == dataclasses.asdict(j.net)


def test_unported_features_raise():
    assert config_for_variant("v1-1").family == "v1"
    with pytest.raises(NotImplementedError, match="SD3"):
        config_for_variant("sd3")
    with pytest.raises(NotImplementedError, match="SD3"):
        VideoVAEConfig(family="sd3")
    with pytest.raises(ValueError):
        config_for_variant("nope")
    vae = VideoVAE.from_config(VideoVAEConfig(net=VAE1Config(**NET), **BASE))
    with pytest.raises(NotImplementedError, match="int8"):
        vae.quantize()
    with pytest.raises(NotImplementedError, match="multi-device"):
        vae.with_mesh(None)
