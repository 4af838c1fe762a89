"""The port's SD3 Encoder/Decoder and SD3 ``VideoVAE`` against the JAX
package's ``vae_sd3.apply_encoder`` / ``apply_decoder`` and ``VideoVAE``,
on CPU in fp32.

JAX params come from ``VideoVAE.from_config(cfg, seed)`` and load into
the port through ``from_jax_params`` with ``strict=True``.  Tolerance is
the golden suites' bound, 3e-4 abs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models import vae_sd3 as jsd3
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig

from cvvae_tpu_torch.models import vae_sd3 as tsd3
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

ATOL = 3e-4

#: the shipped structure at a narrow width
NARROW = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=2,
              latent_channels=16, norm_num_groups=32)
CONFIGS = {
    "narrow": NARROW,
    # no mid-block attention, a causal decoder, full 3D second convs
    "noattn_causal_full3d": dict(NARROW, mid_block_add_attention=False,
                                 causal_decoder=True, half_3d=False),
}
BASE = dict(en_de_n_frames_a_time=None, tile_spatial_size=None)


def _pair(kw, **overrides):
    cfg = dict(BASE, **overrides)
    jvae = JVAE.from_config(JConfig(family="sd3", net=jsd3.VAESD3Config(**kw),
                                    **cfg), seed=0)
    tvae = VideoVAE(VideoVAEConfig(family="sd3",
                                   net=tsd3.VAESD3Config(**kw), **cfg)).eval()
    tvae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      jvae.params)),
                         strict=True)
    return jvae, tvae


@pytest.fixture(scope="module")
def narrow():
    return _pair(NARROW)


def _clip(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _close(got, ref):
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_matches_jax(name):
    jvae, tvae = _pair(CONFIGS[name])
    x = _clip((1, 5, 16, 16, 3))
    ref = jsd3.apply_encoder(jvae.params["encoder"], jnp.asarray(x),
                             jvae.config.net)
    with torch.inference_mode():
        got = tvae.encoder(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 2, 2, 2, 32)
    _close(got, ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decoder_matches_jax(name):
    jvae, tvae = _pair(CONFIGS[name])
    z = np.random.RandomState(1).randn(1, 2, 2, 2, 16).astype(np.float32)
    ref = jsd3.apply_decoder(jvae.params["decoder"], jnp.asarray(z),
                             jvae.config.net)
    with torch.inference_mode():
        got = tvae.decoder(torch.from_numpy(z))
    assert tuple(got.shape) == (1, 5, 16, 16, 3)
    _close(got, ref)


def test_module_paths_follow_jax_tree(narrow):
    jvae, tvae = narrow
    state = from_jax_params(jax.tree.map(np.asarray, jvae.params))
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in tvae.state_dict().items()}
    for k in ("encoder.conv_in.weight",
              "encoder.down_blocks.0.resnets.1.norm2.weight",
              "encoder.down_blocks.1.resnets.0.conv_shortcut.weight",
              "encoder.down_blocks.2.downsamplers.0.weight",
              "encoder.mid_block.attentions.0.group_norm.bias",
              "encoder.mid_block.attentions.0.to_q.weight",
              "encoder.conv_norm_out.weight",
              "decoder.mid_block.resnets.1.conv2.weight",
              "decoder.up_blocks.0.upsamplers.0.weight",
              "decoder.up_blocks.3.resnets.2.conv1.bias",
              "decoder.mid_block.attentions.0.to_out.bias",
              "decoder.conv_out.weight"):
        assert k in state, k
    # a time-upsampling level's conv makes 2x the channels
    assert tuple(state["decoder.up_blocks.0.upsamplers.0.weight"].shape) \
        == (128, 64, 3, 3, 3)


def test_dropout_is_refused():
    cfg = tsd3.VAESD3Config(**dict(NARROW, dropout=0.1))
    with pytest.raises(NotImplementedError, match="dropout"):
        tsd3.Encoder(cfg)
    with pytest.raises(NotImplementedError, match="dropout"):
        tsd3.Decoder(cfg)


# serving-style rectangular tiles with per-axis ratios (exact 2-latent
# overlap per axis, a 2x2 grid), the encoder tiled ("inherit") as the SD3
# serving preset runs it, or untiled
RECT = dict(tile_spatial_size=(48, 40), tile_overlap_ratio=(2 / 6, 2 / 5))


@pytest.mark.parametrize("encode_tile", ["inherit", None])
def test_rect_tiles_match_jax(encode_tile):
    jvae, tvae = _pair(NARROW, encode_tile_spatial_size=encode_tile, **RECT)
    x = _clip((1, 5, 80, 64, 3), 2)
    zj = jvae.encode(jnp.asarray(x)).mode()
    zt = tvae.encode(torch.from_numpy(x)).mode()
    assert tuple(zt.shape) == (1, 2, 10, 8, 16)
    _close(zt, zj)
    _close(tvae.decode(torch.from_numpy(np.array(zj))), jvae.decode(zj))


def test_temporal_chunking_matches_jax():
    """en_de_n_frames_a_time=4 on 9 frames: 2 encode windows of 5 frames
    with a 1-frame causal overlap, 2 decode windows of 2 latents."""
    jvae, tvae = _pair(NARROW, en_de_n_frames_a_time=4)
    x = _clip((1, 9, 16, 24, 3), 3)
    zj = jvae.encode(jnp.asarray(x)).mode()
    zt = tvae.encode(torch.from_numpy(x)).mode()
    assert tuple(zt.shape) == (1, 3, 2, 3, 16)
    _close(zt, zj)
    _close(tvae.decode(torch.from_numpy(np.array(zj))), jvae.decode(zj))
