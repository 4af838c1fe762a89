"""The port's spans and request records (``cvvae_tpu_torch/utils/spans.py``)
on its serving path, on the CPU.

A tiny int8 v1 net (its upsample's phase GEMMs run int8 at the lowered
threshold) served over a real socket: its encoder runs untiled and its
decoder in two overlapping tiles, as the 720p serving preset runs v1.
"""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from cvvae_tpu_torch import serve
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.ops import norm, quant
from cvvae_tpu_torch.ops.kernels import conv_int8
from cvvae_tpu_torch.utils import spans

torch.set_num_threads(2)

NET = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
           norm_num_groups=8)
T, H, W = 5, 32, 48
#: the decoder's tiles: (4, 4) latents, 1 overlapping, over the (4, 6)
#: latent; the encoder runs the whole frame
CONFIG = dict(en_de_n_frames_a_time=None, tile_spatial_size=(32, 32),
              tile_overlap_ratio=0.25, encode_tile_spatial_size=None)


def _plan(size, tile, ratio):
    """The tiles' extents along one axis, as ``_spatial_tiled`` cuts."""
    if tile is None or size <= tile:
        return [size]
    stride = round(tile * (1 - ratio))
    out = []
    for i in range(0, size, stride):
        out.append(min(tile, size - i))
        if i + tile >= size:
            break
    return out


def _expected(t, h, w, tile, ratio, net):
    """The tile counters of one net call on (1, t, h, w, C), from the plan
    alone; an untiled call where either axis fits."""
    if tile is None or (h <= tile[0] and w <= tile[1]):
        hs, ws = [h], [w]
    else:
        hs, ws = _plan(h, tile[0], ratio), _plan(w, tile[1], ratio)
    return {f"{net}.calls": len(hs) * len(ws),
            f"{net}.positions": t * sum(hs) * sum(ws),
            f"{net}.input_positions": t * h * w}


@pytest.fixture(scope="module")
def int8_threshold():
    old = quant.INT8_MIN_POSITIONS
    quant.INT8_MIN_POSITIONS = 256
    yield
    quant.INT8_MIN_POSITIONS = old


@pytest.fixture(scope="module")
def served(int8_threshold):
    vae = VideoVAE.from_config(VideoVAEConfig(net=VAE1Config(**NET),
                                              **CONFIG), device="cpu")
    vae = vae.quantize()
    server = serve.build_server(vae, port=0, act_dtype=torch.float32,
                                device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield server, server.server_address[1]
    server.shutdown()
    server.server_close()


def _clip(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (T, H, W, 3),
                                               dtype=np.uint8)


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


def _stats(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/stats")
    out = json.loads(conn.getresponse().read())
    conn.close()
    return out


def _profile():
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True,
        experimental_config=cfg)


def test_a_span_off_is_one_shared_null_context(served, monkeypatch):
    """With no profiler no span opens a range: a served request runs with
    every way of opening one made to raise, and every span is the same
    object."""
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not spans.enabled()
    assert spans.span("cvvae.a") is spans.span("cvvae.b", 1, 2)
    _, port = served
    out = np.load(io.BytesIO(_post(port, "/reconstruct", _clip())))
    assert out.shape == (T, H, W, 3)


def test_a_traced_request(served):
    """Under the profiler, on every thread: the handler's request span and
    the worker's spans carry one request id; the worker's nest inside its
    work span (upload, then encode, decode with its tiles, then
    download, blocks and ops inside); one record with queue, transfer and
    tile numbers, marked as profiled."""
    server, port = served
    n0 = len(server.worker.records.records())
    with _profile() as prof:
        _post(port, "/reconstruct", _clip(1))
    recs = server.worker.records.records()
    assert len(recs) == n0 + 1
    rec = recs[-1]
    assert rec.profiled and rec.ok and rec.kind == "reconstruct"
    assert rec.frames == T
    assert rec.t_submit <= rec.t_take <= rec.t_done
    assert rec.upload_s > 0 and rec.download_s > 0
    assert rec.queue_s >= 0 and rec.latency_s >= rec.upload_s

    ev = [e for e in prof.events() if e.name.startswith("cvvae.")]
    byname = {}
    for e in sorted(ev, key=lambda e: e.time_range.start):
        byname.setdefault(e.name, []).append(e)
    (req,), (work,) = byname["cvvae.serve.request"], byname["cvvae.serve.work"]
    assert req.thread != work.thread
    assert req.concrete_inputs[0] == work.concrete_inputs[0] == rec.id
    (parse,), (ser,) = byname["cvvae.serve.parse"], byname["cvvae.serve.serialize"]
    assert parse.thread == ser.thread == req.thread
    assert parse.concrete_inputs[0] == ser.concrete_inputs[0] == rec.id

    mine = [e for e in ev if e.thread == work.thread]
    a, b = work.time_range.start, work.time_range.end
    for e in mine:
        assert a <= e.time_range.start <= e.time_range.end <= b, e.name
        assert e.concrete_inputs[0] == rec.id, e.name
    (enc,), (dec,) = byname["cvvae.vae.encode"], byname["cvvae.vae.decode"]
    ups, downs = byname["cvvae.serve.upload"], byname["cvvae.serve.download"]
    assert len(ups) == len(downs) == 2      # the clip and the latent
    assert ups[0].time_range.end <= enc.time_range.start
    assert enc.time_range.end <= downs[0].time_range.start
    assert downs[0].time_range.end <= ups[1].time_range.start
    assert ups[1].time_range.end <= dec.time_range.start
    assert dec.time_range.end <= downs[1].time_range.start
    assert sum(e.time_range.elapsed_us() for e in ups + downs) <= \
        1e6 * (rec.upload_s + rec.download_s)

    tiles = byname["cvvae.vae.tile"]
    assert sorted(tuple(e.concrete_inputs[1:]) for e in tiles) == \
        [(0, 0), (0, 1)]
    for t in tiles:
        assert dec.time_range.start <= t.time_range.start
        assert t.time_range.end <= dec.time_range.end
    (blend,) = byname["cvvae.vae.blend"]
    assert max(t.time_range.end for t in tiles) <= blend.time_range.start
    for name in ("cvvae.net.conv_in", "cvvae.net.res", "cvvae.net.attn",
                 "cvvae.net.down", "cvvae.net.up", "cvvae.net.out",
                 "cvvae.op.conv3d", "cvvae.op.conv3d_int8",
                 "cvvae.op.upsample_conv"):
        assert name in byname, name
    res = byname["cvvae.net.res"]
    for e in byname["cvvae.op.conv3d"]:
        assert any(r.time_range.start <= e.time_range.start
                   and e.time_range.end <= r.time_range.end
                   for r in res + byname["cvvae.net.conv_in"]
                   + byname["cvvae.net.down"] + byname["cvvae.net.out"]), e


def test_tile_counters_follow_the_plan(served):
    """A request's tile counters: the untiled encoder once over the clip,
    the decoder over each tile of the plan, overlap included."""
    server, port = served
    _post(port, "/reconstruct", _clip(2))
    rec = server.worker.records.records()[-1]
    cfg = server.worker.vae.config
    want = _expected(T, H, W, cfg.encode_pixel_tile_size, 0.25, "encoder")
    want.update(_expected(2, H // 8, W // 8, cfg.latent_tile_size, 0.25,
                          "decoder"))
    assert rec.tiles == want
    assert want["encoder.positions"] == want["encoder.input_positions"]
    assert want["decoder.calls"] == 2
    assert want["decoder.positions"] == 2 * 4 * (4 + 3)


def test_stats_keys(served):
    """/stats keeps its keys and adds the queue wait and the transfers,
    all read from the request records."""
    server, port = served
    _post(port, "/encode", _clip(3))
    s = _stats(port)
    for key in ("queue_depth", "uptime_s", "frames_per_busy_s", "errors",
                "busy_s", "latency_ms_p50", "latency_ms_p95",
                "queue_wait_ms_p50", "queue_wait_ms_p95", "upload_ms_mean",
                "download_ms_mean", "encoder_calls_mean",
                "decoder_calls_mean"):
        assert key in s, key
    assert 0 <= s["queue_wait_ms_p50"] <= s["latency_ms_p50"]
    recs = [r for r in server.worker.records.records() if r.ok]
    assert s["encoder_calls_mean"] == 1.0    # every request here encodes
    assert s["decoder_calls_mean"] == round(
        sum(2 * (r.kind != "encode") for r in recs) / len(recs), 2)
    assert not hasattr(server.worker, "latencies_ms")


def test_summary_ranks_as_before():
    """p50 and p95 are the ranks ``latencies_ms`` took: the middle one
    and min(n - 1, int(0.95 n)) of the sorted values; failed requests
    are left out."""
    recs = []
    for k in range(40):
        r = spans.RequestRecord(k, "encode", 5, t_submit=0.0,
                                t_take=0.001 * k, t_done=0.01 * (40 - k),
                                upload_s=0.002, download_s=0.004, ok=k != 7)
        recs.append(r)
    s = spans.summary(recs)
    lat = sorted(1e3 * r.latency_s for r in recs if r.ok)
    wait = sorted(1e3 * r.queue_s for r in recs if r.ok)
    assert s["latency_ms_p50"] == round(lat[len(lat) // 2], 1)
    assert s["latency_ms_p95"] == round(lat[int(len(lat) * 0.95)], 1)
    assert s["queue_wait_ms_p95"] == round(wait[int(len(wait) * 0.95)], 1)
    assert s["upload_ms_mean"] == 2.0 and s["download_ms_mean"] == 4.0
    assert s["encoder_calls_mean"] == s["decoder_calls_mean"] == 0.0
    assert spans.summary([]) == {}


def test_benchmark_patch_points_are_called(served, monkeypatch):
    """The nine points the benchmark's traced run wraps (the worker's
    ``_encode`` / ``_decode`` and the model's ``encode`` / ``decode`` on
    their instances; ``serve._npy_load`` / ``_npy_bytes``,
    ``conv_int8.stage`` / ``.gemm`` and ``norm.group_norm_silu`` on their
    modules) are each reached by one served request."""
    server, port = served
    worker, vae = server.worker, server.worker.vae
    calls = {}

    def wrap(owner, name):
        fn = getattr(owner, name)
        key = f"{type(owner).__name__}.{name}"

        def counted(*args, **kwargs):
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(owner, name, counted)

    for owner, name in ((worker, "_encode"), (worker, "_decode"),
                        (vae, "encode"), (vae, "decode"),
                        (serve, "_npy_load"), (serve, "_npy_bytes"),
                        (conv_int8, "stage"), (conv_int8, "gemm"),
                        (norm, "group_norm_silu")):
        wrap(owner, name)
    _post(port, "/reconstruct", _clip(4))
    assert len(calls) == 9 and all(calls.values()), calls
