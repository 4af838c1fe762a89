"""The port's reconstruction metrics (``utils/metrics.py``) against the
JAX package's within 1e-5, and the port's checkpoint-verification tool
(``utils/verify_checkpoints.py``) on a synthetic checkpoint and clip, both
exit paths of its ``--golden`` gate (as ``tests/test_convert.py`` runs the
JAX tool)."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from cvvae_tpu.utils import metrics as jmetrics

from cvvae_tpu_torch.data import video_io
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.utils import metrics, verify_checkpoints

torch.set_num_threads(2)

SHAPES = [(2, 3, 24, 20, 3), (2, 17, 13, 3), (1, 2, 11, 11, 1)]


def _pair(shape, seed, noise):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, shape).astype(np.float32)
    y = np.clip(x + noise * rs.randn(*shape), -1, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("noise", [0.05, 0.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_psnr_and_ssim_match_jax(shape, noise):
    x, y = _pair(shape, 0, noise)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    for got, ref in ((metrics.psnr(tx, ty), jmetrics.psnr(jx, jy)),
                     (metrics.ssim(tx, ty), jmetrics.ssim(jx, jy))):
        assert tuple(got.shape) == (shape[0],)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_metrics_of_identical_clips_and_bf16():
    x, _ = _pair(SHAPES[0], 1, 0.0)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(metrics.psnr(tx, tx).numpy(), 120.0 + 10 *
                               np.log10(4.0), rtol=1e-6)
    np.testing.assert_allclose(metrics.ssim(tx, tx).numpy(), 1.0, atol=1e-5)
    # bf16 inputs are measured in fp32, as JAX does
    xb = tx.bfloat16()
    got = metrics.reconstruction_report(xb, tx)
    ref = jmetrics.reconstruction_report(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(x))
    for k in ("psnr_db", "ssim", "l1"):
        assert abs(got[k] - ref[k]) <= 1e-5 * max(1.0, abs(ref[k])), k


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_reconstruction_report_matches_jax(shape):
    x, y = _pair(shape, 2, 0.1)
    got = metrics.reconstruction_report(torch.from_numpy(x),
                                        torch.from_numpy(y))
    ref = jmetrics.reconstruction_report(jnp.asarray(x), jnp.asarray(y))
    assert got.keys() == ref.keys()
    for k in got:
        assert abs(got[k] - ref[k]) <= 1e-5 * max(1.0, abs(ref[k])), k


def test_verify_checkpoints_harness(tmp_path):
    """The verify tool end to end on a synthetic HF checkpoint dir and a
    synthetic clip: loads, reconstructs, writes the PSNR report, and holds
    the +-0.1 dB golden gate (exit 0 within it, 1 past it; 2 with nothing
    to verify)."""
    config = VideoVAEConfig(net=VAE1Config(ch=32, num_res_blocks=1),
                            en_de_n_frames_a_time=8, tile_spatial_size=None)
    vae = VideoVAE.from_config(config, device="cpu")
    path = str(tmp_path / "ckpt")
    chip_smoke.write_reference_checkpoint(path, config, vae.state_dict())
    clip = str(tmp_path / "clip.mp4")
    video_io.write_video(clip, np.random.default_rng(0).integers(
        0, 255, (9, 32, 32, 3), dtype=np.uint8), fps=8)
    flags = ["--vae_path", path, "--clips", clip, "--height", "32",
             "--width", "32", "--dtype", "fp32", "--device", "cpu"]

    out = str(tmp_path / "report.json")
    assert verify_checkpoints.main(flags + ["--out", out]) == 0
    report = json.load(open(out))
    (key, r), = report.items()
    assert r["frames"] == 9 and np.isfinite(r["psnr_db"])
    assert r["latent_shape"] == [1, 3, 4, 4, 4] and 0 < r["ssim"] < 1

    # the PSNR is the batch path's, against the fp32 frames
    frames, _ = video_io.read_video(clip, height=32, width=32)
    x = torch.from_numpy(video_io.normalize(frames))[None]
    rec = vae.decode(vae.encode(x).mode())
    assert abs(r["psnr_db"] - float(metrics.psnr(x, rec))) <= 1e-4

    golden = str(tmp_path / "golden.json")
    json.dump({key: r["psnr_db"]}, open(golden, "w"))
    assert verify_checkpoints.main(flags + ["--golden", golden]) == 0
    json.dump({key: r["psnr_db"] + 1.0}, open(golden, "w"))
    assert verify_checkpoints.main(flags + ["--golden", golden]) == 1
    assert verify_checkpoints.main(
        ["--vae_path", str(tmp_path / "none"), "--clips", clip,
         "--device", "cpu"]) == 2
