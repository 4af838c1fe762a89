"""The serving worker's transfer pipeline (``serve.VAEWorker``): a
request's upload staged while another runs, its first work launched
behind the running one's, answers copied out once down.

On the CPU the same steps run in the same order with plain tensors: a
tiny v1 net behind ``build_server`` on an ephemeral port, the worker held
inside a request by a gate so that others queue behind it.  The card test
(``-m cuda``) runs the pinned buffers and the side stream; this file
imports no JAX, so it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_serve_pipeline.py
"""

import http.client
import io
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from benchmark.metrics import upload_staged_pct
from cvvae_tpu_torch import serve
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.utils import spans

torch.set_num_threads(2)

NET = dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
           norm_num_groups=4)
BASE = dict(en_de_n_frames_a_time=None, tile_spatial_size=None)
T, H, W = 9, 32, 32


@pytest.fixture(scope="module")
def vae():
    return VideoVAE.from_config(VideoVAEConfig(net=VAE1Config(**NET), **BASE),
                                device="cpu")


@pytest.fixture
def served(vae):
    servers = []

    def start(max_queue=8, put_timeout=5.0):
        server = serve.build_server(vae, port=0, act_dtype=torch.float32,
                                    device="cpu", max_queue=max_queue,
                                    put_timeout=put_timeout)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return server, server.server_address[1]

    yield start
    for s in servers:
        s.shutdown()
        s.server_close()


def _clip(seed):
    return np.random.RandomState(seed).randint(0, 256, (T, H, W, 3),
                                               dtype=np.uint8)


def _post(port, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=buf.getvalue())
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _wait_until(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.005)


class Gate:
    """Wraps the model's ``name`` method: its ``at``-th call (from 1)
    waits for ``release`` and then raises if ``fail``; every call's start
    and end times are kept."""

    def __init__(self, monkeypatch, model, name, at, fail=False):
        self.fn, self.at, self.fail = getattr(model, name), at, fail
        self.entered, self.release = threading.Event(), threading.Event()
        self.calls = []
        monkeypatch.setattr(model, name, self)

    def __call__(self, *args, **kwargs):
        self.calls.append([time.perf_counter(), None])
        if len(self.calls) == self.at:
            self.entered.set()
            assert self.release.wait(30.0)
            if self.fail:
                raise RuntimeError("a planted failure")
        out = self.fn(*args, **kwargs)
        self.calls[-1][1] = time.perf_counter()
        return out


def _posting(port, requests, results):
    """A client thread that posts ``requests`` ((key, path, body), ...) in
    order, each after the last answer."""
    def run():
        for key, path, body in requests:
            results[key] = _post(port, path, body)
    t = threading.Thread(target=run)
    t.start()
    return t


def _join(threads):
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()


def test_interleaved_answers_equal_one_at_a_time(served, vae, monkeypatch):
    """/encode, /decode and /reconstruct from two clients while the worker
    is held, each queued one staged behind the running request: every
    answer is byte-equal to the same request served alone."""
    server, port = served()
    z = np.load(io.BytesIO(_post(port, "/encode", _clip(9))[1]))
    requests = [("e0", "/encode", _clip(0)), ("r1", "/reconstruct", _clip(1)),
                ("d2", "/decode", z), ("r3", "/reconstruct", _clip(3)),
                ("e4", "/encode", _clip(4)), ("d5", "/decode", z * 0.5)]
    alone = {key: _post(port, path, body) for key, path, body in requests}
    assert all(status == 200 for status, _ in alone.values())
    assert not any(r.staged for r in server.worker.records.records())

    gate = Gate(monkeypatch, vae, "decode", at=1)
    results = {}
    held = _posting(port, [("held", "/reconstruct", _clip(8))], results)
    assert gate.entered.wait(30.0)
    clients = [_posting(port, requests[0::2], results)]
    _wait_until(lambda: server.worker.queue_depth == 1)
    clients.append(_posting(port, requests[1::2], results))
    _wait_until(lambda: server.worker.queue_depth == 2)
    gate.release.set()
    _join([held] + clients)
    for key, _, _ in requests:
        assert results[key] == alone[key], key
    recs = server.worker.records.records()[-len(requests) - 1:]
    assert recs[0].kind == "reconstruct" and not recs[0].staged
    assert recs[1].staged and recs[2].staged     # queued behind the gate


@pytest.mark.parametrize("fails", ["running", "staged"])
def test_a_failure_answers_500_alone(served, vae, monkeypatch, fails):
    """The running request fails with one staged behind it, or the staged
    one fails in its first work: that request answers 500, the other and
    the next 200."""
    server, port = served()
    gate = Gate(monkeypatch, vae, "decode", at=1, fail=fails == "running")
    bad = np.zeros((1, 2, 4, 4, 7), np.float32)      # 7 latent channels
    second = ("b", "/decode", bad if fails == "staged" else
              np.zeros((1, 2, 4, 4, 4), np.float32))
    results = {}
    threads = [_posting(port, [("a", "/reconstruct", _clip(0))], results)]
    assert gate.entered.wait(30.0)
    threads.append(_posting(port, [second], results))
    _wait_until(lambda: server.worker.queue_depth == 1)
    threads.append(_posting(port, [("c", "/reconstruct", _clip(1))],
                            results))
    _wait_until(lambda: server.worker.queue_depth == 2)
    gate.release.set()
    _join(threads)
    want = {"running": {"a": 500, "b": 200, "c": 200},
            "staged": {"a": 200, "b": 500, "c": 200}}[fails]
    assert {k: v[0] for k, v in results.items()} == want
    assert server.worker.stats["errors"] == 1
    assert _post(port, "/reconstruct", _clip(2))[0] == 200
    assert server.worker.queue_depth == 0


def test_staged_only_behind_another_and_queue_ends_at_own_work(
        served, vae, monkeypatch):
    """A request served alone is not staged, and its queue wait ends when
    the worker takes it; one queued behind a running request is staged,
    and its queue wait ends once the running request's work is done and
    before its own encode starts."""
    server, port = served()
    assert _post(port, "/reconstruct", _clip(0))[0] == 200
    alone = server.worker.records.records()[-1]
    assert not alone.staged
    assert alone.t_take == alone.t_staged
    assert alone.t_submit <= alone.t_take <= alone.t_done

    dec = Gate(monkeypatch, vae, "decode", at=1)
    enc = Gate(monkeypatch, vae, "encode", at=0)      # times, no gate
    results = {}
    threads = [_posting(port, [("a", "/reconstruct", _clip(1))], results)]
    assert dec.entered.wait(30.0)
    threads.append(_posting(port, [("b", "/reconstruct", _clip(2))],
                            results))
    _wait_until(lambda: server.worker.queue_depth == 1)
    dec.release.set()
    _join(threads)
    a, b = server.worker.records.records()[-2:]
    assert not a.staged and b.staged
    assert a.t_staged == a.t_take <= enc.calls[0][0]
    assert b.t_submit <= b.t_staged <= enc.calls[1][0]
    assert dec.calls[0][1] <= b.t_take <= enc.calls[1][0]
    assert b.t_take <= a.t_done <= b.t_done
    s = serve.spans.summary([a, b])
    assert s["staged_share"] == 0.5


def test_a_staged_request_counts_in_the_queue(served, vae, monkeypatch):
    """A request staged behind the running one (held in its first work)
    and one queued fill a 2-slot queue: the next answers 503, the three
    others 200."""
    server, port = served(max_queue=2, put_timeout=0.2)
    dec = Gate(monkeypatch, vae, "decode", at=1)
    enc = Gate(monkeypatch, vae, "encode", at=2)
    results = {}
    threads = [_posting(port, [("a", "/reconstruct", _clip(0))], results)]
    assert dec.entered.wait(30.0)
    threads.append(_posting(port, [("b", "/reconstruct", _clip(1))],
                            results))
    _wait_until(lambda: server.worker.queue_depth == 1)
    dec.release.set()
    assert enc.entered.wait(30.0)           # b staged, its encode held
    assert server.worker.queue_depth == 1
    threads.append(_posting(port, [("c", "/encode", _clip(2))], results))
    _wait_until(lambda: server.worker.queue_depth == 2)
    status, body = _post(port, "/encode", _clip(3))
    assert status == 503 and b"queue full" in body
    enc.release.set()
    _join(threads)
    assert {k: v[0] for k, v in results.items()} == {"a": 200, "b": 200,
                                                     "c": 200}
    recs = server.worker.records.records()[-3:]
    assert [r.staged for r in recs] == [False, True, True]
    assert server.worker.queue_depth == 0


def test_many_clients_keep_the_counts(served):
    """Sixteen clients at once against a 3-slot queue, the interpreter
    switching threads every microsecond: every request answers 200 or
    503, the answered ones are counted once each, and the queue ends
    empty."""
    server, port = served(max_queue=3, put_timeout=0.05)
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [_posting(port, [((i, k), "/encode", _clip(i))
                                   for k in range(3)], results)
                   for i in range(16)]
        _join(threads)
    finally:
        sys.setswitchinterval(old)
    codes = [status for status, _ in results.values()]
    assert len(codes) == 48 and set(codes) <= {200, 503}
    assert server.worker.stats["encode"] == codes.count(200) > 0
    assert len(server.worker.records.records()) == codes.count(200)
    assert server.worker.queue_depth == 0


def test_upload_staged_pct_reads_the_records(monkeypatch):
    """The benchmark's reader: the share of the traced records (the first
    left out) that were staged; None for records without the field, as a
    port before the pipeline keeps them."""
    monkeypatch.setattr(spans, "_last_log", None)    # restored after
    log = spans.RequestLog()
    for k, staged in enumerate([True, True, False, True, True, True]):
        log.add(spans.RequestRecord(k, "reconstruct", 17, 0.0, staged=staged,
                                    profiled=k > 0))
    log.add(spans.RequestRecord(9, "reconstruct", 17, 0.0, staged=True))
    assert upload_staged_pct.read(None) == 75.0
    old = types.SimpleNamespace(profiled=True, queue_s=0.1)
    monkeypatch.setattr(spans, "_last_log",
                        types.SimpleNamespace(records=lambda: [old, old]))
    assert upload_staged_pct.read(None) is None


@pytest.mark.cuda
def test_staged_clips_on_the_card():
    """On the card: a clip staged while a long first request runs (its
    decode held on the device), and a third reusing the pinned buffers
    while the second computes: each answer equals the clip served alone,
    and the staged requests are marked; /decode of /encode equals
    /reconstruct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")

    class Slow:
        """A stand-in model: encode pools, decode upsamples; the first
        decode spins the device first, long enough for the next clips to
        arrive and be staged."""
        tile_counts = None

        def __init__(self):
            self.spin = True

        def encode(self, x):
            z = torch.nn.functional.avg_pool3d(
                x.movedim(-1, 1), (1, 8, 8)).movedim(1, -1)
            return types.SimpleNamespace(mode=lambda: z.to(torch.bfloat16))

        def decode(self, z):
            if self.spin:
                self.spin = False
                torch.cuda._sleep(int(3e8))     # ~0.2 s at ~1.5 GHz
            x = z.float().movedim(-1, 1)
            x = torch.nn.functional.interpolate(x, scale_factor=(1, 8, 8))
            return torch.tanh(x * 1.5).movedim(1, -1)

    clips = [np.random.RandomState(k).randint(0, 256, (17, 256, 320, 3),
                                              dtype=np.uint8)
             for k in range(3)]
    worker = serve.VAEWorker(Slow(), act_dtype=torch.bfloat16, device=dev)
    alone = [worker.submit("reconstruct", c, False) for c in clips]
    worker.vae.spin = True
    out = [None] * 3

    def post(k):
        out[k] = worker.submit("reconstruct", clips[k], False)

    threads = [threading.Thread(target=post, args=(k,)) for k in range(3)]
    threads[0].start()
    _wait_until(lambda: not worker.vae.spin)    # 0's decode launched
    threads[1].start()
    _wait_until(lambda: worker.queue_depth == 1)
    threads[2].start()
    _join(threads)
    for k in range(3):
        np.testing.assert_array_equal(out[k], alone[k])
        assert not np.array_equal(out[k], alone[(k + 1) % 3])
    recs = worker.records.records()[-3:]
    assert [r.staged for r in recs] == [False, True, True]
    assert set(worker._pinned_bufs) == {"upload", "download"}
    # the fp32 latent down and up through the same buffers, and a
    # /reconstruct equal to /decode of /encode
    z = worker.submit("encode", clips[0], False)
    assert z.dtype == np.float32 and z.shape == (1, 17, 32, 40, 3)
    np.testing.assert_array_equal(worker.submit("decode", z, False),
                                  alone[0])
