"""The latent-compat demo end to end on the CPU: a tiny CLIP text tower
encodes two prompts, a tiny SD 2.x UNet samples 4 DDIM steps with CFG
7.5, and a tiny v1 video VAE decodes the latents with ``decode(z /
scaling_factor, num_frames=1)`` -- the port against the JAX package on
the same weights, ids and starting latents, in fp32 at ATOL.  Both compute
the same functions in the same dtypes, so only the order of fp32 sums
differs (5.4e-6 measured), and no call on the port's path goes to
``scaled_dot_product_attention``.

Then the port's script (``scripts/sd21_vae3d_inference.py``) runs
``main`` on checkpoint dirs written here, and its PNG is held to the JAX
script's flow on the same dirs (the JAX package's loaders, pipeline and
2D decoder; the port's random context and starting latents handed over,
since they come from torch's generator) within one uint8 level.  The
decoder's kernel launches at the demo's decode are chip_smoke's lists.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cvvae_tpu.models.clip_text import CLIPTextConfig as JClipConfig
from cvvae_tpu.models.clip_text import apply_clip_text
from cvvae_tpu.models.unet2d import UNet2DConfig as JUNetConfig
from cvvae_tpu.models.unet2d import make_denoiser as jmake_denoiser
from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JVAEConfig
from cvvae_tpu.pipelines import diffusion as jdiff
from cvvae_tpu.utils.convert import convert_clip_text_state_dict as jclip
from cvvae_tpu.utils.convert import convert_unet_state_dict as junet
from tests.torch_ref.unet_stub import UNet2DConditionModel

import chip_smoke
from cvvae_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from cvvae_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, make_denoiser
from cvvae_tpu_torch.models.vae2d import Decoder2D, VAE2DConfig
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.pipelines import diffusion as tdiff
from cvvae_tpu_torch.scripts import sd21_vae3d_inference as script
from cvvae_tpu_torch.utils.convert import from_jax_params

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

ATOL = 5e-5
UNET = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64),
            layers_per_block=1, cross_attention_dim=32, attention_head_dim=8,
            norm_num_groups=8)
CLIP = dict(vocab_size=99, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16)
NET = dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
           norm_num_groups=4)
#: the script's v1 VAE: a reference config.json carries no group count, so
#: its loader builds 32 groups
SCRIPT_NET = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1,
                  z_channels=4)
STEPS, GUIDANCE = 4, 7.5


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    stub = UNet2DConditionModel(**UNET).eval()
    hf = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        bos_token_id=97, eos_token_id=98, **CLIP)).eval()
    vcfg = dict(family="v1", tile_spatial_size=None)
    jvae = JVAE.from_config(JVAEConfig(net=JNet(**NET), **vcfg), seed=0)
    j = dict(unet=junet(stub.state_dict()), clip=jclip(hf.state_dict()),
             vae=jvae)
    unet = UNet2D(UNet2DConfig(**UNET)).eval()
    unet.load_state_dict(from_jax_params(jax.tree.map(np.asarray, j["unet"]),
                                         conv2d=True), strict=True)
    clip = CLIPText(CLIPTextConfig(**CLIP)).eval()
    clip.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      j["clip"])),
                         strict=True)
    vae = VideoVAE(VideoVAEConfig(net=VAE1Config(**NET), **vcfg)).eval()
    vae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                     jvae.params)),
                        strict=True)
    return j, dict(unet=unet, clip=clip, vae=vae, stub=stub)


def _data():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 97, (2, 16)).astype(np.int64)
    ids[:, -1] = 98
    return ids, rng.randn(1, 16, 16, 4).astype(np.float32)


def test_demo_matches_jax(models, monkeypatch):
    j, t = models
    ids, lat = _data()
    emb = np.asarray(apply_clip_text(j["clip"], jnp.asarray(ids, jnp.int32),
                                     JClipConfig(**CLIP)))
    pipe = jdiff.LatentDiffusionPipeline(
        j["vae"], jmake_denoiser(j["unet"], JUNetConfig(**UNET)))
    ref = np.asarray(pipe(jax.random.PRNGKey(0), cond=jnp.asarray(emb[:1]),
                          uncond=jnp.asarray(emb[1:]),
                          latents=jnp.asarray(lat),
                          num_inference_steps=STEPS,
                          guidance_scale=GUIDANCE))

    def refuse(*args, **kwargs):
        raise AssertionError("scaled_dot_product_attention on the demo's "
                             "path")

    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    monkeypatch.setattr(torch._C._nn, "scaled_dot_product_attention", refuse)
    with torch.no_grad():
        temb = t["clip"](torch.from_numpy(ids))
    got = tdiff.LatentDiffusionPipeline(t["vae"], make_denoiser(t["unet"]))(
        cond=temb[:1], uncond=temb[1:], latents=torch.from_numpy(lat),
        num_inference_steps=STEPS, guidance_scale=GUIDANCE).numpy()
    assert got.shape == ref.shape == (1, 128, 128, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def _write_dirs(tmp_path, t):
    """The demo's checkpoints as their publishers lay them out: a diffusers
    UNet dir, a CV-VAE HF dir, an LDM-layout 2D SD VAE file (with a
    post_quant_conv, which the panel reads and does not apply)."""
    from safetensors.torch import save_file

    unet_dir = tmp_path / "unet"
    unet_dir.mkdir()
    with open(unet_dir / "config.json", "w") as f:
        json.dump(dict(UNET, block_out_channels=[32, 64]), f)
    save_file({k: v.contiguous() for k, v in t["stub"].state_dict().items()},
              str(unet_dir / "diffusion_pytorch_model.safetensors"))
    vae_dir = tmp_path / "cv-vae"
    vae = VideoVAE.from_config(VideoVAEConfig(
        family="v1", net=VAE1Config(**SCRIPT_NET), tile_spatial_size=None),
        seed=2, device="cpu")
    chip_smoke.write_reference_checkpoint(str(vae_dir / "vae3d"), vae.config,
                                          vae.state_dict())
    cfg2d = VAE2DConfig(naming="sd21", latent_channels=4,
                        block_out_channels=(32, 32, 64, 64),
                        layers_per_block=1, legacy_quant_conv=True)
    dec = Decoder2D(cfg2d, torch.Generator().manual_seed(4)).eval()
    ref = chip_smoke.reference_layout(dec.state_dict())
    save_file({(k if k.startswith("post_quant_conv") else "decoder." + k):
               v.contiguous() for k, v in ref.items()},
              str(tmp_path / "vae2d.safetensors"))
    return unet_dir, vae_dir


def _jax_script_image(unet_dir, vae3d_dir, vae2d_path, h, w):
    """The JAX script's body on the same dirs (its loaders in bf16, its
    pipeline, its 2D panel), with the port script's context and starting
    latents, which come from torch's generator."""
    from cvvae_tpu.models.unet2d import make_denoiser as jmake
    from cvvae_tpu.models.vae2d import VAE2DConfig as J2DConfig
    from cvvae_tpu.models.vae2d import apply_decoder2d
    from cvvae_tpu.utils.convert import (load_torch_checkpoint_file,
                                         load_unet_checkpoint)

    params, cfg = load_unet_checkpoint(str(unet_dir), dtype=jnp.bfloat16)
    vae3d = JVAE.from_pretrained(str(vae3d_dir), dtype=jnp.bfloat16)
    cond = torch.randn((1, 77, cfg.cross_attention_dim),
                       generator=torch.Generator().manual_seed(1)).numpy()
    lat = torch.randn((1, h // 8, w // 8, 4),
                      generator=torch.Generator().manual_seed(0)).numpy()
    pipe = jdiff.LatentDiffusionPipeline(vae3d, jmake(params, cfg),
                                         scheduler=jdiff.DDIMScheduler())
    latents = pipe(jax.random.PRNGKey(0), cond=jnp.asarray(cond),
                   uncond=jnp.zeros_like(cond), latents=jnp.asarray(lat),
                   num_inference_steps=2, guidance_scale=7.5,
                   output_type="latent")
    panels = [np.asarray(pipe.decode_latents(latents).astype(jnp.float32))[0]]
    tree, _ = load_torch_checkpoint_file(
        str(vae2d_path), prefixes=("decoder", "post_quant_conv"))
    z = latents / vae3d.config.scaling_factor
    frame2d = apply_decoder2d(tree["decoder"], z[:, None],
                              J2DConfig(naming="sd21"))
    panels.append(np.asarray(frame2d.astype(jnp.float32))[0, 0])
    img = np.concatenate(panels, axis=1)
    return np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)


def test_script_main_matches_the_jax_scripts_flow(models, tmp_path):
    import cv2

    _, t = models
    unet_dir, vae_dir = _write_dirs(tmp_path, t)
    out = str(tmp_path / "demo.png")
    assert script.main([
        "--unet_path", str(unet_dir), "--vae3d_path", str(vae_dir),
        "--subfolder", "vae3d", "--vae2d_path",
        str(tmp_path / "vae2d.safetensors"), "--steps", "2", "--height",
        "64", "--width", "64", "--device", "cpu", "--out", out]) == out
    img = cv2.cvtColor(cv2.imread(out), cv2.COLOR_BGR2RGB)
    assert img.shape == (64, 128, 3)
    want = _jax_script_image(unet_dir, vae_dir / "vae3d",
                             tmp_path / "vae2d.safetensors", 64, 64)
    assert np.abs(img.astype(int) - want.astype(int)).max() <= 1


def test_script_needs_no_text_encoder_or_cv2_to_start(models, tmp_path):
    """transformers and cv2 are imported only where they are used: the
    module imports without them, and the 2D panel is optional."""
    source = open(script.__file__).read()
    head = source[:source.index("def main")]
    assert "import cv2" not in head and "transformers" not in head.split(
        '"""', 2)[2]
    _, t = models
    unet_dir, vae_dir = _write_dirs(tmp_path, t)
    out = str(tmp_path / "only3d.png")
    script.main(["--unet_path", str(unet_dir), "--vae3d_path",
                 str(vae_dir / "vae3d"), "--steps", "1", "--height", "32",
                 "--width", "48", "--device", "cpu", "--out", out])
    import cv2
    assert cv2.imread(out).shape == (32, 48, 3)


def test_decode_launches_are_chip_smokes_lists(monkeypatch):
    """The kernel launches chip_smoke holds at the demo's decode
    (``DECODE_K1_SHAPES``, ``DECODE_K2_SHAPES``, ``DECODE_K4_SHAPES``, a
    64x64 latent) are those the full-width v1 decoder makes: the same
    decode of an 8x8 latent makes them at an eighth of the extent, in the
    same order.  Its temporal attention (S = T = 1) stays below K4's
    FLASH_MIN_TOKENS at any extent."""
    from cvvae_tpu_torch.models.video_vae import config_for_variant
    from cvvae_tpu_torch.ops import attention as tattn
    from cvvae_tpu_torch.ops import norm as tnorm
    from cvvae_tpu_torch.ops import upsample_conv

    seen = {"K1": [], "K2": [], "K4": []}

    def wrap(module, name, key):
        real = getattr(module, name)

        def call(*args, **kw):
            seen[key].append((args, kw))
            return real(*args, **kw)
        monkeypatch.setattr(module, name, call)

    wrap(tnorm, "group_norm_silu", "K1")
    wrap(upsample_conv, "subpixel_interleave", "K2")
    wrap(tattn, "single_head_attention", "K4")
    vae = VideoVAE.from_config(config_for_variant("v1"), seed=2,
                               device="cpu")
    lat = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(3))
    pipe = tdiff.LatentDiffusionPipeline(vae, None)
    with torch.no_grad():
        assert pipe.decode_latents(lat).shape == (1, 64, 64, 3)

    def shrink(shape):
        return shape[:2] + (shape[2] // 8, shape[3] // 8) + shape[4:]

    k1 = [(tuple(a[0].shape), kw["silu"], kw.get("per_frame", False))
          for a, kw in seen["K1"]]
    assert all(kw["num_groups"] == 32 and kw["eps"] == 1e-5
               for _, kw in seen["K1"])
    assert list(dict.fromkeys(k1)) == [
        (shrink(s), silu, pf) for s, silu, pf in chip_smoke.DECODE_K1_SHAPES]
    k2 = [(tuple(a[0][0].shape), kw["n"], kw.get("drop_first", True),
           a[1] is not None) for a, kw in seen["K2"]]
    assert list(dict.fromkeys(k2)) == [
        (shrink(s), n, True, True) for s, n in chip_smoke.DECODE_K2_SHAPES]
    k4 = list(dict.fromkeys(tuple(a[0].shape) for a, _ in seen["K4"]))
    (b, s, c), = chip_smoke.DECODE_K4_SHAPES
    assert k4 == [(b, s // 64, c), (64, 1, c)]
    assert 1 < tattn.FLASH_MIN_TOKENS <= s
