"""The port's v1 Encoder/Decoder against ``vae_v1.apply_encoder`` /
``apply_decoder`` of the JAX package, on CPU in fp32.

JAX params come from ``VideoVAE.from_config(cfg, seed)`` and load into
the port through ``from_jax_params`` with ``strict=True``.  Tolerance is
the golden suites' bound, 3e-4 abs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models import vae_v1 as jv1
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig

from cvvae_tpu_torch.models import vae_v1 as tv1
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

ATOL = 3e-4

TINY = dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
            norm_num_groups=4)
CONFIGS = {
    "tiny": TINY,
    # per-level attention (level 1 on both sides) and a causal decoder
    "attn_causal_dec": dict(TINY, attn_resolutions=(128,),
                            causal_decoder=True),
    # per-frame 2D convs everywhere, full 3D second convs
    "2d_full3d": dict(TINY, use_3d_conv=False, half_3d=False,
                      half_t_mult=False),
}


def _pair(kw):
    jcfg = JConfig(family="v1", net=jv1.VAE1Config(**kw),
                   en_de_n_frames_a_time=None, tile_spatial_size=None)
    jvae = JVAE.from_config(jcfg, seed=0)
    tvae = VideoVAE(VideoVAEConfig(family="v1", net=tv1.VAE1Config(**kw),
                                   en_de_n_frames_a_time=None,
                                   tile_spatial_size=None)).eval()
    tvae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      jvae.params)),
                         strict=True)
    return jcfg.net, jvae, tvae


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_matches_jax(name):
    net, jvae, tvae = _pair(CONFIGS[name])
    x = np.random.RandomState(0).uniform(-1, 1, (1, 5, 32, 32, 3)) \
        .astype(np.float32)
    ref = jv1.apply_encoder(jvae.params["encoder"], jnp.asarray(x), net)
    with torch.inference_mode():
        got = tvae.encoder(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decoder_matches_jax(name):
    net, jvae, tvae = _pair(CONFIGS[name])
    z = np.random.RandomState(1).randn(1, 2, 4, 4, 4).astype(np.float32)
    ref = jv1.apply_decoder(jvae.params["decoder"], jnp.asarray(z), net)
    with torch.inference_mode():
        got = tvae.decoder(torch.from_numpy(z))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_dropout_is_refused():
    """Dropout is a training option: without a generator (serving) it is
    refused and the net is the dropout-free one; with a generator the
    mask is drawn outside the checkpointed block, so remat recomputes
    with the same mask."""
    cfg = tv1.VAE1Config(**dict(TINY, dropout=0.5))
    g = torch.Generator().manual_seed(0)
    enc = tv1.Encoder(cfg, g)
    plain = tv1.Encoder(tv1.VAE1Config(**TINY))
    plain.load_state_dict(enc.state_dict(), strict=True)
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (1, 5, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(enc(x), plain(x), rtol=0, atol=0)
        dropped = enc(x, generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(dropped, plain(x).detach())
    grads = []
    for remat in (False, True):
        enc.zero_grad()
        out = enc(x, remat=remat, generator=torch.Generator().manual_seed(1))
        out.square().sum().backward()
        grads.append([p.grad.clone() for p in enc.parameters()])
        if remat:
            torch.testing.assert_close(out.detach(), dropped, rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_module_paths_follow_jax_tree():
    _, _, tvae = _pair(TINY)
    keys = set(tvae.state_dict())
    for k in ("encoder.down.0.block.0.norm1.weight",
              "encoder.down.0.downsample.weight",
              "encoder.mid.attn_1.q.weight",
              "decoder.mid.attn_1.proj_out_t.bias",
              "decoder.up.1.upsample.weight",
              "decoder.up.3.block.1.conv2.weight",
              "decoder.norm_out.bias"):
        assert k in keys, k
