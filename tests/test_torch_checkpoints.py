"""Reference-checkpoint loading in the port (``utils/convert.py``,
``VideoVAE.from_pretrained``, ``cli/serve --vae_path``) against the JAX
package's loader, on the CPU in fp32.

Checkpoints in the reference's layout are made from a JAX tree with the
inverse of the key and layout rules (``chip_smoke.reference_layout``); the
JAX package's own ``convert_state_dict`` first maps each one back to the
same tree, so each file is one that JAX's loader reads as intended.  Then
both packages load one directory and their encode + decode agree within
3e-4 abs.  Cases: v1 and SD3; kT = 1 kernels written as Conv2d and as
Conv3d; dense layers written as 1x1 Conv2d and as Linear.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from cvvae_tpu import cli as jcli
from cvvae_tpu.models.vae_sd3 import VAESD3Config as JSD3
from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig
from cvvae_tpu.utils import convert as jconvert

from cvvae_tpu_torch import cli, serve
from cvvae_tpu_torch.data import video_io
from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.utils import convert

torch.set_num_threads(2)

ATOL = 3e-4
# v1's config.json carries no norm_num_groups (the reference's 32), so its
# narrowest width is 32
NETS = {"v1": (JNet, VAE1Config, dict(ch=32, num_res_blocks=1)),
        "sd3": (JSD3, VAESD3Config,
                dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                     norm_num_groups=4, latent_channels=4))}
BASE = dict(en_de_n_frames_a_time=8, tile_spatial_size=None)
LAYOUTS = [pytest.param(c, d, id=f"{'conv2d' if c else 'conv3d'}-"
                                 f"{'dense_conv' if d else 'linear'}")
           for c in (True, False) for d in (True, False)]


@functools.lru_cache(maxsize=None)
def _source(family):
    """(JAX params, the port's config, the port's state dict) of one
    random model."""
    jnet, tnet, net = NETS[family]
    jvae = JVAE.from_config(JConfig(family=family, net=jnet(**net), **BASE),
                            seed=0)
    params = jax.tree.map(np.asarray, jvae.params)
    kw = dict(scaling_factor=1.5305) if family == "sd3" else {}
    config = VideoVAEConfig(family=family, net=tnet(**net), **BASE, **kw)
    return params, config, convert.from_jax_params(params)


def _write(path, family, conv2d=True, dense_conv=True):
    _, config, state = _source(family)
    chip_smoke.write_reference_checkpoint(str(path), config, state,
                                          conv2d=conv2d,
                                          dense_conv=dense_conv)
    return str(path)


def _assert_same_tree(got, ref):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_got, flat_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_same_state(got, ref):
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("conv2d,dense_conv", LAYOUTS)
@pytest.mark.parametrize("family", ["v1", "sd3"])
def test_fabricated_layout_is_what_jax_reads(family, conv2d, dense_conv):
    """JAX's ``convert_state_dict`` maps the fabricated reference state
    back to the source tree, and the port's maps it to the source state
    dict; the layout case really writes 4-D kernels."""
    params, _, state = _source(family)
    ref = chip_smoke.reference_layout(state, conv2d=conv2d,
                                      dense_conv=dense_conv)
    tree, skipped = jconvert.convert_state_dict(
        {k: v.numpy() for k, v in ref.items()})
    assert skipped == []
    _assert_same_tree(tree, params)
    got, skipped = convert.convert_state_dict(ref)
    assert skipped == []
    _assert_same_state(got, state)
    dense = [v for k, v in ref.items() if k.split(".")[-2] in
             ("q", "to_q") and k.endswith("weight")]
    assert dense and all(v.ndim == (4 if dense_conv else 2) for v in dense)
    assert any(v.ndim == 4 for k, v in ref.items()
               if k.endswith("conv2.weight")) == conv2d
    # the reference's module paths
    assert any(".conv.weight" in k for k in ref)
    assert family == "v1" or any("to_out.0.weight" in k for k in ref)


@functools.lru_cache(maxsize=None)
def _clip():
    return np.random.RandomState(0).uniform(-1, 1, (1, 5, 16, 16, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("conv2d,dense_conv", LAYOUTS)
@pytest.mark.parametrize("family", ["v1", "sd3"])
def test_from_pretrained_matches_jax(tmp_path, family, conv2d, dense_conv):
    path = _write(tmp_path / "ckpt", family, conv2d, dense_conv)
    jvae = JVAE.from_pretrained(path)
    tvae = VideoVAE.from_pretrained(path, device="cpu")
    assert tvae.config == _source(family)[1]
    assert tvae.device.type == "cpu" and tvae.dtype == torch.float32
    x = _clip()
    zj = jvae.encode(jnp.asarray(x)).mode()
    zt = tvae.encode(torch.from_numpy(x)).mode()
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=ATOL, rtol=0)
    # both decoders on the JAX latents
    np.testing.assert_allclose(
        tvae.decode(torch.from_numpy(np.array(zj))).numpy(),
        np.asarray(jvae.decode(zj)), atol=ATOL, rtol=0)


def test_from_pretrained_subfolder_dtype_and_device(tmp_path):
    _write(tmp_path / "vae3d", "v1")
    tvae = VideoVAE.from_pretrained(str(tmp_path), subfolder="vae3d",
                                    dtype=torch.bfloat16, device="cpu")
    assert tvae.dtype == torch.bfloat16
    _assert_same_state(tvae.state_dict(), {
        k: v.bfloat16() for k, v in _source("v1")[2].items()})
    assert not any(p.requires_grad for p in tvae.parameters())
    # the card is the default, as for from_config
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VideoVAE.from_pretrained(str(tmp_path), subfolder="vae3d")
    with pytest.raises(FileNotFoundError):
        VideoVAE.from_pretrained(str(tmp_path), device="cpu")


def test_config_from_json_defaults_match_jax():
    """Every default of the config.json reader is JAX's."""
    for cfg_json in ({}, {"_class_name": "CVVAESD3Model"},
                     {"ch": 64, "tile_spatial_size": None,
                      "num_video_frames": 17}):
        got = convert._config_from_json(cfg_json)
        ref = jconvert._config_from_json(cfg_json)
        for f in ("family", "scaling_factor", "en_de_n_frames_a_time",
                  "time_n_compress", "spatial_n_compress",
                  "tile_spatial_size", "tile_overlap_ratio",
                  "num_video_frames"):
            assert getattr(got, f) == getattr(ref, f), f
        assert vars(got.net) == {k: v for k, v in vars(ref.net).items()
                                 if k in vars(got.net)}


@pytest.mark.parametrize("family", ["v1", "sd3"])
def test_lightning_ckpt_matches_jax(tmp_path, family):
    """A state dict nested under "state_dict" with a non-VAE key (the
    warm-start contract, lvdm/models/autoencoder.py:68-86), a raw .pt and
    a .safetensors file: the skipped keys are JAX's, the tensors the
    source's."""
    params, _, state = _source(family)
    ref = chip_smoke.reference_layout(state)
    blob = {"state_dict": dict(ref, **{"loss.logvar": torch.zeros(())}),
            "global_step": 123}
    files = {"last.ckpt": blob, "raw.pt": dict(ref, **{
        "loss.logvar": torch.zeros(())})}
    for name, obj in files.items():
        torch.save(obj, tmp_path / name)
    from safetensors.torch import save_file
    save_file(dict(ref, **{"loss.logvar": torch.zeros(())}),
              str(tmp_path / "sd.safetensors"))
    for name in list(files) + ["sd.safetensors"]:
        path = str(tmp_path / name)
        got, skipped = convert.load_torch_checkpoint_file(path)
        tree, jskipped = jconvert.load_torch_checkpoint_file(path)
        assert skipped == jskipped == ["loss.logvar"]
        _assert_same_state(got, state)
        _assert_same_tree(tree, params)


def test_bf16_safetensors_read_exactly(tmp_path):
    """A bf16 checkpoint converts to the same values in fp32."""
    _, config, state = _source("sd3")
    half = {k: v.bfloat16() for k, v in state.items()}
    chip_smoke.write_reference_checkpoint(str(tmp_path), config, half)
    tvae = VideoVAE.from_pretrained(str(tmp_path), device="cpu")
    _assert_same_state(tvae.state_dict(),
                       {k: v.float() for k, v in half.items()})


def _video(path, n=9, size=16, seed=3):
    frames = np.random.RandomState(seed).randint(0, 255, (n, size, size, 3),
                                                 np.uint8)
    video_io.write_video(str(path), frames, 8.0)
    return str(path)


def test_cli_vae_path_matches_jax(tmp_path):
    """``cli --vae_path --subfolder`` on the CPU: the same PSNR as the JAX
    package's CLI on the same checkpoint and clip, and SSIM and L1 beside
    it."""
    _write(tmp_path / "root" / "vae3d", "v1")
    src = _video(tmp_path / "in.mp4")
    flags = ["--vae_path", str(tmp_path / "root"), "--subfolder", "vae3d",
             "--video_path", src, "--height", "16", "--width", "16",
             "--dtype", "fp32", "--mode", "mode"]
    got = cli.main(flags + ["--save_path", str(tmp_path / "t.mp4"),
                            "--device", "cpu"])
    ref = jcli.main(flags + ["--save_path", str(tmp_path / "j.mp4")])
    assert got["frames"] == ref["frames"] == 9
    assert got["latent_shape"] == ref["latent_shape"] == [1, 3, 2, 2, 4]
    assert abs(got["psnr_db"] - ref["psnr_db"]) <= 2e-3
    assert 0.0 < got["ssim"] < 1.0 and got["l1"] > 0.0


def test_serve_prepare_vae_path(tmp_path):
    """``serve.prepare --vae_path`` on the CPU serves the checkpoint's
    model; with --dtype int8 it composes with --quantized_cache (written
    on the first start, restored on the second, the same bytes)."""
    path = _write(tmp_path / "ckpt", "v1")
    clip = np.random.RandomState(4).randint(0, 256, (5, 16, 16, 3),
                                            dtype=np.uint8)
    common = ["--vae_path", path, "--height", "16", "--width", "16",
              "--warm_frames", "5", "--device", "cpu", "--port", "0"]

    def served(flags):
        server = serve.prepare(serve.build_argparser().parse_args(
            common + flags))
        try:
            return server.worker.submit("reconstruct", clip, False)
        finally:
            server.server_close()

    got = served(["--dtype", "fp32"])
    tvae = VideoVAE.from_pretrained(path, device="cpu")
    cli.apply_serving_preset(tvae, 16, 16)
    x = video_io.to_unit(torch.from_numpy(clip)[None], torch.float32)
    ref = video_io.to_uint8(tvae.decode(tvae.encode(x).mode())[0]).numpy()
    np.testing.assert_array_equal(got, ref)
    cache = ["--dtype", "int8", "--quantized_cache", str(tmp_path / "q")]
    first = served(cache)
    assert (tmp_path / "q" / serve.CACHE_FILE).exists()
    np.testing.assert_array_equal(served(cache), first)
