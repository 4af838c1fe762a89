"""The port's int8 serving (``serve --dtype int8``, ``--calibration_video``,
``--quantized_cache``, ``cli --dtype int8``) on the CPU, with tiny nets in
place of the full-width ones.

The net is narrow but reaches the 64 input channels that quantize, and
``INT8_MIN_POSITIONS`` is lowered to 4096 so that its finest level runs
int8 on 5x32x48 clips.  Coarser levels stay float: with int8 there too,
this random net is chaotic (1e-6 of noise on the input alone moves its
frames to 36 dB of themselves).  Against the JAX package's int8 server,
both calibrated on the same synthetic clip in fp32, the frames agree at
>= 40 dB (a value that the two packages' fp32 arithmetic puts on either
side of a rounding step quantizes one step apart).
"""

import argparse
import http.client
import io
import os
import threading

import numpy as np
import pytest
import torch

import jax

from cvvae_tpu import serve as jserve
from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig
from cvvae_tpu.ops import quant as jquant

from cvvae_tpu_torch import cli, serve
from cvvae_tpu_torch.data import video_io
from cvvae_tpu_torch.models import video_vae
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

NET = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1, z_channels=4,
           norm_num_groups=8)
BASE = dict(en_de_n_frames_a_time=None, tile_spatial_size=None)
H, W, T = 32, 48, 5


def _int8_levels(monkeypatch):
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 4096)
    monkeypatch.setattr(jquant, "INT8_MIN_POSITIONS", 4096)


@pytest.fixture
def tiny(monkeypatch):
    """Serve the tiny v1 net, int8 at its finest level."""
    monkeypatch.setattr(video_vae, "config_for_variant",
                        lambda v: VideoVAEConfig(net=VAE1Config(**NET)))
    _int8_levels(monkeypatch)


def _args(*extra):
    return serve.build_argparser().parse_args(
        ["--device", "cpu", "--height", str(H), "--width", str(W),
         "--warm_frames", str(T), "--port", "0"] + list(extra))


def _post(port, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, body=buf.getvalue())
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    assert resp.status == 200, data[:300]
    return data


def _serving(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server.server_address[1]


def _stop(server):
    server.shutdown()
    server.server_close()


def _clip(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (T, H, W, 3),
                                               dtype=np.uint8)


def _reconstruct(args):
    """(/reconstruct bytes, /decode(/encode) bytes, the served model) of
    the server ``serve.prepare(args)`` builds."""
    server = serve.prepare(args)
    try:
        port = _serving(server)
        rec = _post(port, "/reconstruct", _clip())
        z = np.load(io.BytesIO(_post(port, "/encode", _clip())))
        dec = _post(port, "/decode", z)
        return rec, dec, server.worker.vae
    finally:
        _stop(server)


def test_int8_is_the_default_and_serves(tiny):
    args = _args()
    assert args.dtype == "int8"
    rec, dec, vae = _reconstruct(args)
    assert rec == dec
    frames = np.load(io.BytesIO(rec))
    assert frames.shape == (T, H, W, 3) and frames.dtype == np.uint8
    state = vae.state_dict()
    n_q = sum(k.endswith("weight_q") for k in state)
    assert n_q > 0 and n_q == sum(k.endswith("scale_x") for k in state)
    assert vae.dtype == torch.bfloat16


def test_quantized_cache_written_then_restored(tiny, tmp_path):
    cache = str(tmp_path / "q")
    rec, _, vae = _reconstruct(_args("--quantized_cache", cache))
    assert os.path.isfile(os.path.join(cache, serve.CACHE_FILE))
    again, _, restored = _reconstruct(_args("--quantized_cache", cache))
    assert again == rec
    want = vae.state_dict()
    for k, v in restored.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_calibration_video(tiny, tmp_path):
    """--calibration_video: the scales come from the video's first 17
    frames at min(256, H) x min(256, W), as ``quantize`` computes them on
    those frames."""
    frames = np.random.RandomState(3).randint(0, 256, (20, 40, 56, 3),
                                              np.uint8)
    path = str(tmp_path / "calib.mp4")
    video_io.write_video(path, frames, 24.0)
    _, _, vae = _reconstruct(_args("--calibration_video", path))
    read, _ = video_io.read_video(path, height=H, width=W, max_frames=17)
    assert read.shape == (17, H, W, 3)
    base = VideoVAE.from_config(VideoVAEConfig(net=VAE1Config(**NET)),
                                dtype=torch.bfloat16, device="cpu")
    want = base.quantize(calibration=read[None].astype(np.float32) / 127.5
                         - 1.0).state_dict()
    got = vae.state_dict()
    keys = [k for k in want if k.endswith("scale_x")]
    assert keys
    for k in keys:
        assert torch.equal(got[k], want[k]), k


def test_int8_frames_match_jax_int8_server(monkeypatch):
    """The two packages' int8 servers, fp32 activations, each calibrated
    by its own serve module on the reference's synthetic clip.  The
    calibration pass runs at the default threshold (all float at this
    size), so that int8's flips do not move the recorded maxima apart;
    the servers then run int8 at the finest level."""
    jvae = JVAE.from_config(JConfig(family="v1", net=JNet(**NET), **BASE),
                            seed=0)
    tvae = VideoVAE(VideoVAEConfig(family="v1", net=VAE1Config(**NET),
                                   **BASE)).eval().requires_grad_(False)
    tvae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      jvae.params)),
                         strict=True)
    args = argparse.Namespace(height=H, width=W, warm_frames=T,
                              calibration_video=None, quantized_cache=None)
    tq = serve.quantized(tvae, args, T)
    jq = jserve._quantized(jvae, args)
    _int8_levels(monkeypatch)
    servers = [serve.build_server(tq, port=0, act_dtype=torch.float32,
                                  device="cpu"),
               jserve.build_server(jq, port=0)]
    try:
        ports = [_serving(s) for s in servers]
        got, ref = (np.load(io.BytesIO(_post(p, "/reconstruct", _clip(1))))
                    for p in ports)
    finally:
        for s in servers:
            _stop(s)
    mse = np.mean((got.astype(np.float64) - ref.astype(np.float64)) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) >= 40.0


def test_cli_int8(tiny, tmp_path):
    """``cli --dtype int8 --serving``: calibrated on the clip's first
    window, then encode and decode."""
    frames = np.random.RandomState(2).randint(0, 255, (10, H, W, 3),
                                              np.uint8)
    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    video_io.write_video(src, frames, 24.0)
    result = cli.main(["--video_path", src, "--save_path", dst,
                       "--height", str(H), "--width", str(W),
                       "--dtype", "int8", "--device", "cpu", "--mode", "mode",
                       "--serving"])
    assert result["frames"] == 9 and np.isfinite(result["psnr_db"])
    back, _ = video_io.read_video(dst)
    assert back.shape == (9, H, W, 3)
