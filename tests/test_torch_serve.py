"""The port's serving daemon (cvvae_tpu_torch.serve) over real sockets.

Mirrors tests/test_serve.py where it applies: tiny v1 and SD3 configs
behind ``build_server`` on an ephemeral port, on the CPU.  The port's
server and the JAX package's serve the same converted weights; their
uint8 frames agree within +-1 count (fp32 sums in another order can flip
a rounding).
"""

import dataclasses
import http.client
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax

from cvvae_tpu import cli as jcli
from cvvae_tpu import serve as jserve
from cvvae_tpu.models.vae_sd3 import VAESD3Config as JSD3
from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig

from cvvae_tpu_torch import cli, serve
from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

NET = dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
           norm_num_groups=4)
SD3_NET = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
               latent_channels=16, norm_num_groups=4)
BASE = dict(en_de_n_frames_a_time=None, tile_spatial_size=None)
NETS = {"v1": (NET, JNet, VAE1Config), "sd3": (SD3_NET, JSD3, VAESD3Config)}


def _configs(family, **overrides):
    """The (JAX, port) VideoVAEConfig pair of a tiny ``family`` net."""
    kw, jnet, tnet = NETS[family]
    cfg = dict(BASE, **overrides)
    return (JConfig(family=family, net=jnet(**kw), **cfg),
            VideoVAEConfig(family=family, net=tnet(**kw), **cfg))


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server.server_address[1]


def _served(family):
    jcfg, tcfg = _configs(family)
    jvae = JVAE.from_config(jcfg, seed=0)
    tvae = VideoVAE(tcfg).eval()
    tvae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      jvae.params)),
                         strict=True)
    tserver = serve.build_server(tvae, port=0, act_dtype=torch.float32,
                                 device="cpu")
    jserver = jserve.build_server(jvae, port=0)
    yield tvae, _start(tserver), _start(jserver)
    for s in (tserver, jserver):
        s.shutdown()
        s.server_close()


@pytest.fixture(scope="module")
def served():
    yield from _served("v1")


@pytest.fixture(scope="module")
def served_sd3():
    yield from _served("sd3")


def _post(port, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=buf.getvalue())
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _load(data):
    return np.load(io.BytesIO(data), allow_pickle=False)


def test_healthz_and_stats(served):
    _, port, _ = served
    assert _get_json(port, "/healthz") == (200, {"ok": True})
    status, body = _get_json(port, "/stats")
    assert status == 200
    for key in ("queue_depth", "uptime_s", "frames_per_busy_s", "errors"):
        assert key in body


def test_reconstruct_equals_decode_of_encode(served):
    _, port, _ = served
    frames = np.random.RandomState(0).randint(0, 255, (9, 32, 32, 3),
                                              np.uint8)
    status, z_bytes = _post(port, "/encode", frames)
    assert status == 200
    z = _load(z_bytes)
    assert z.shape == (1, 3, 4, 4, 4) and z.dtype == np.float32
    status, x_bytes = _post(port, "/decode", z)
    assert status == 200
    status, r_bytes = _post(port, "/reconstruct", frames)
    assert status == 200
    assert r_bytes == x_bytes
    x = _load(x_bytes)
    assert x.shape == (9, 32, 32, 3) and x.dtype == np.uint8


def test_served_frames_match_jax_server(served):
    _, port, jport = served
    frames = np.random.RandomState(1).randint(0, 255, (5, 32, 32, 3),
                                              np.uint8)
    status, zt = _post(port, "/encode", frames)
    assert status == 200
    status, zj = _post(jport, "/encode", frames)
    assert status == 200
    np.testing.assert_allclose(_load(zt), _load(zj), atol=3e-4, rtol=0)
    status, rt = _post(port, "/reconstruct", frames)
    assert status == 200
    status, rj = _post(jport, "/reconstruct", frames)
    assert status == 200
    a, b = _load(rt).astype(int), _load(rj).astype(int)
    assert a.shape == b.shape == (5, 32, 32, 3)
    assert np.abs(a - b).max() <= 1


def test_sd3_server_matches_jax_server(served_sd3):
    """The SD3 family behind the port's server: latents and frames against
    the JAX package's SD3 server on the same weights."""
    _, port, jport = served_sd3
    frames = np.random.RandomState(3).randint(0, 255, (5, 32, 32, 3),
                                              np.uint8)
    status, zt = _post(port, "/encode", frames)
    assert status == 200
    status, zj = _post(jport, "/encode", frames)
    assert status == 200
    assert _load(zt).shape == (1, 2, 4, 4, 16)
    np.testing.assert_allclose(_load(zt), _load(zj), atol=3e-4, rtol=0)
    status, rt = _post(port, "/reconstruct", frames)
    assert status == 200
    status, rj = _post(jport, "/reconstruct", frames)
    assert status == 200
    status, dt = _post(port, "/decode", _load(zt))
    assert status == 200 and dt == rt
    a, b = _load(rt).astype(int), _load(rj).astype(int)
    assert a.shape == b.shape == (5, 32, 32, 3)
    assert np.abs(a - b).max() <= 1


def test_frame_count_contract(served):
    _, port, _ = served
    frames = np.zeros((8, 32, 32, 3), np.uint8)
    status, z = _post(port, "/encode", frames)
    assert status == 200
    assert _load(z).shape[1] == 2            # 8 frames truncate to 5


def test_bad_requests(served):
    _, port, _ = served
    assert _post(port, "/encode", np.zeros((4, 8, 8, 3), np.float32))[0] \
        == 400
    assert _post(port, "/reconstruct", np.zeros((4, 8, 8), np.uint8))[0] \
        == 400
    assert _post(port, "/decode", np.zeros((3, 3), np.float32))[0] == 400
    assert _post(port, "/nonsense", np.zeros((1,), np.uint8))[0] == 404


def test_oversized_body_is_413():
    vae = VideoVAE.from_config(VideoVAEConfig(net=VAE1Config(**NET), **BASE),
                               device="cpu")
    server = serve.build_server(vae, port=0, max_body_bytes=1024)
    port = _start(server)
    try:
        status, _ = _post(port, "/encode", np.zeros((5, 32, 32, 3), np.uint8))
        assert status == 413
    finally:
        server.shutdown()
        server.server_close()


class _Posterior:
    def __init__(self, z):
        self._z = z

    def mode(self):
        return self._z

    def sample(self, generator):
        return self._z


class _SlowVAE:
    """Stand-in model whose first encode waits on ``gate``."""

    def __init__(self, gate):
        self._gate = gate

    def encode(self, x):
        if self._gate is not None:
            gate, self._gate = self._gate, None
            gate.wait(30.0)
        return _Posterior(torch.zeros((1, 1, 2, 2, 4)))

    def decode(self, z):
        return torch.zeros((1, 5, 8, 8, 3))


def test_queue_full_returns_503():
    gate = threading.Event()
    server = serve.build_server(_SlowVAE(gate), port=0, max_queue=2,
                                act_dtype=torch.float32, device="cpu",
                                put_timeout=0.2)
    port = _start(server)
    frames = np.zeros((5, 8, 8, 3), np.uint8)
    results = []

    def post():
        results.append(_post(port, "/encode", frames)[0])

    threads = [threading.Thread(target=post) for _ in range(3)]
    try:
        threads[0].start()               # the worker takes it and waits
        time.sleep(0.3)
        for t in threads[1:]:            # fill the 2-slot queue
            t.start()
        time.sleep(0.3)
        assert server.worker.queue_depth == 2
        status, body = _post(port, "/encode", frames)
        assert status == 503 and b"queue full" in body
        gate.set()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
        assert results == [200, 200, 200]
    finally:
        gate.set()
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("height,width", [(720, 1280), (1080, 1920),
                                          (720, 720), (576, 1024),
                                          (1088, 1440)])
def test_serving_tile_plan_matches_jax(height, width):
    assert cli.serving_decode_tiles(height, width) == \
        jcli.serving_decode_tiles(height, width)


def test_serving_preset():
    vae = VideoVAE.from_config(VideoVAEConfig(net=VAE1Config(**NET)),
                               device="cpu")
    cli.apply_serving_preset(vae, 720, 1280)
    assert vae.config.tile_spatial_size == (720, 672)
    assert vae.config.encode_pixel_tile_size is None
    assert vae.config.latent_tile_size == (90, 84)


@pytest.mark.parametrize("family", ["v1", "sd3"])
@pytest.mark.parametrize("height,width", [(720, 1280), (576, 1024),
                                          (720, 720)])
def test_serving_preset_matches_jax(family, height, width):
    """v1 encodes the full frame untiled, SD3 in the decode tiles, as the
    JAX server's preset (cvvae_tpu/serve.py) sets them."""
    jcfg, tcfg = _configs(family)
    tile, ratio = jcli.serving_decode_tiles(height, width)
    enc_tile = None if jcfg.family == "v1" else "inherit"
    jcfg = dataclasses.replace(jcfg, tile_spatial_size=tile,
                               tile_overlap_ratio=ratio,
                               encode_tile_spatial_size=enc_tile)
    vae = cli.apply_serving_preset(VideoVAE(tcfg), height, width)
    assert vae.config.encode_tile_spatial_size == enc_tile
    for prop in ("pixel_tile_size", "latent_tile_size",
                 "encode_pixel_tile_size", "encode_latent_tile_size",
                 "tile_overlap_ratio"):
        assert getattr(vae.config, prop) == getattr(jcfg, prop), prop


def test_prepare_builds_an_sd3_server(monkeypatch):
    """``serve.prepare`` (what ``main`` runs) with ``--variant sd3``: the
    SD3 family, its preset, and a warm-up through it (tiny net in place
    of the full-width one)."""
    from cvvae_tpu_torch.models import video_vae

    variants = []

    def tiny(variant):
        variants.append(variant)
        return _configs("sd3", scaling_factor=1.5305)[1]

    monkeypatch.setattr(video_vae, "config_for_variant", tiny)
    args = serve.build_argparser().parse_args(
        ["--variant", "sd3", "--device", "cpu", "--dtype", "fp32",
         "--height", "32", "--width", "48", "--warm_frames", "5",
         "--port", "0"])
    server = serve.prepare(args)
    try:
        cfg = server.worker.vae.config
        assert variants == ["sd3"]
        assert (cfg.family, cfg.latent_channels) == ("sd3", 16)
        assert cfg.encode_tile_spatial_size == "inherit"
        assert cfg.tile_spatial_size is None      # 32x48 runs untiled
        assert server.worker.stats["errors"] == 0
    finally:
        server.server_close()


@pytest.mark.parametrize("flags,match", [
    (["--dtype", "bf16", "--calibration_video", "v.mp4"], "int8"),
    (["--dtype", "bf16", "--quantized_cache", "q"], "quantized_cache"),
    (["--device", "cpu", "--spatial_shards", "100000"], "visible devices"),
    (["--device", "cuda:99"], "cuda:99"),
])
def test_prepare_refuses_what_is_not_here(flags, match):
    args = serve.build_argparser().parse_args(flags)
    with pytest.raises(SystemExit, match=match):
        serve.prepare(args)


def test_cli_main_reconstructs_a_video(tmp_path, monkeypatch):
    """``cli.main`` end to end on the CPU: mp4 in, 4k+1 frames through
    encode/decode, mp4 out (tiny net in place of the full-width one)."""
    from cvvae_tpu_torch.data import video_io
    from cvvae_tpu_torch.models import video_vae

    monkeypatch.setattr(video_vae, "config_for_variant",
                        lambda v: VideoVAEConfig(net=VAE1Config(**NET)))
    frames = np.random.RandomState(2).randint(0, 255, (10, 32, 48, 3),
                                              np.uint8)
    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    video_io.write_video(src, frames, 24.0)
    result = cli.main(["--video_path", src, "--save_path", dst,
                       "--height", "32", "--width", "48", "--dtype", "fp32",
                       "--device", "cpu", "--mode", "mode", "--serving"])
    assert result["frames"] == 9
    assert result["latent_shape"] == [1, 3, 4, 6, 4]
    back, fps = video_io.read_video(dst)
    assert back.shape == (9, 32, 48, 3) and fps == 24.0
