"""Serving daemon: the VideoVAE behind an HTTP boundary.

Port of ``cvvae_tpu/serve.py``.

* one device, one model, one worker thread: requests queue (bounded) and
  run strictly in order; a full queue answers 503.  On the card the next
  request's upload is staged while the running one computes, and answers
  come down through pinned memory (``VAEWorker``).
* binary .npy bodies; uint8 pixels on the wire, normalised and
  denormalised on the device, so host<->device traffic is 1 B/px.
* endpoints:
    GET  /healthz          -> {"ok": true} once warm
    GET  /stats            -> request counts, fps, queue depth, latency
    POST /encode           -> body: (T,H,W,3) uint8 .npy
                              response: latent (1,t',h',w',z) .npy (fp32)
    POST /decode           -> body: latent .npy
                              response: (T,H,W,3) uint8 .npy
    POST /reconstruct      -> encode+decode in one trip
  Query param ?sample=1 on /encode draws from the posterior (else mode).
* warm-up runs before the socket accepts work, so the first request
  finds the kernels built and the allocator warm.
* ``--spatial_shards N`` splits the height axis of every net call over N
  devices (``VideoVAE.with_mesh``, ``parallel/``): this process runs the
  HTTP front and rank 0, N − 1 follower processes the other ranks.  A
  rank that fails closes the mesh: that request and every later one
  answer 500, and /healthz 503.

* ``--dtype int8`` (the default, as in the reference): bf16 activations
  and the int8 conv stack, its activation scales calibrated at start-up
  on ``--calibration_video`` (or, without one, on the reference's
  synthetic noise); ``--quantized_cache DIR`` restores the calibrated
  model from DIR when DIR exists and writes it there when it does not.

Without ``--vae_path`` (a reference HF checkpoint dir) the model has
random weights from seed 0 (``--variant``).

Usage:
    python -m cvvae_tpu_torch.serve --port 8400 --dtype int8 \
        --height 720 --width 1280 --device cuda \
        [--vae_path /path/to/CV-VAE --subfolder vae3d | --variant v1|sd3] \
        [--calibration_video v.mp4]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from cvvae_tpu_torch.data.video_io import (to_uint8, to_unit,
                                           truncate_to_4k1)
from cvvae_tpu_torch.utils import spans


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _npy_load(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


#: how often the worker, waiting for an answer to come down, looks again
#: (seconds); a request that arrives meanwhile wakes it at once
POLL_S = 0.001


class _Job:
    """A request inside the worker: its queue entry, its record, and what
    each of its steps leaves for the next."""

    __slots__ = ("kind", "payload", "sample", "box", "rec", "behind",
                 "queued", "x", "uploaded", "out", "host", "done",
                 "t_launch", "t_ready")

    def __init__(self, kind, payload, sample, box, behind=None):
        self.kind, self.payload, self.sample, self.box = (kind, payload,
                                                          sample, box)
        self.rec: spans.RequestRecord = box["record"]
        #: the request holding the worker when this one was taken
        self.behind: Optional[_Job] = behind
        #: counted in ``queue_depth`` until its own work starts
        self.queued = True
        #: the staged payload on the device, and its copy's event
        self.x = self.uploaded = None
        #: the device result of the last step
        self.out = None
        #: the answer on its way down: the host tensor and its copy's
        #: event (None on the CPU), and when it was seen there
        self.host = self.done = None
        self.t_launch = self.t_ready = None

    def ready(self) -> bool:
        """Whether the answer is on the host (or the request failed)."""
        if self.t_ready is None and self.done is not None \
                and self.done.query():
            self.t_ready = time.perf_counter()
        return self.t_ready is not None


class VAEWorker:
    """Owns the device model; executes requests strictly in order.

    One transfer pipeline on the card, with no host synchronise between
    or inside requests: a request's payload goes up through a reusable
    pinned buffer on a side stream (staged: while another request runs,
    at most one ahead), its first work is launched behind the running
    request's on the compute stream, and the running request's answer
    comes down on the side stream into a second pinned buffer, copied out
    once there.  The CPU runs the same steps in the same order with plain
    tensors."""

    def __init__(self, vae, *, max_queue: int = 8,
                 act_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None,
                 put_timeout: float = 5.0):
        self.vae = vae
        self.dtype = act_dtype if act_dtype is not None else vae.dtype
        self.device = torch.device(device if device is not None
                                   else vae.device)
        self._q: "queue.Queue" = queue.Queue()
        self.max_queue = max_queue
        #: requests submitted whose own work has not started (staged
        #: included), under ``_room``
        self._waiting = 0
        self._room = threading.Condition()
        #: how long submit() waits for queue space before the caller sees
        #: queue.Full (-> HTTP 503)
        self.put_timeout = put_timeout
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        #: the copies' stream, the pinned buffers ("upload", "download")
        #: and the last upload's event, on the card
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._pinned_bufs: dict = {}
        self._up_done = None
        self.stats = {"encode": 0, "decode": 0, "reconstruct": 0,
                      "errors": 0, "frames": 0, "busy_s": 0.0}
        self._busy_until = 0.0
        #: the most recent requests' records (queue wait, transfers,
        #: latency, tile counters); /stats summarises them
        self.records = spans.RequestLog()
        self._ids = itertools.count(1)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def new_request_id(self) -> int:
        return next(self._ids)

    # ---- device ops (worker thread only) ----
    @contextlib.contextmanager
    def _transfer(self, rec: spans.RequestRecord, which: str):
        """A copy between host and device (``which``: "upload" or
        "download"): its span, and its host seconds added to ``rec``."""
        t0 = time.perf_counter()
        try:
            with spans.span(f"cvvae.serve.{which}"):
                yield
        finally:
            key = f"{which}_s"
            setattr(rec, key, getattr(rec, key) + time.perf_counter() - t0)

    def _pinned(self, which: str, like: torch.Tensor) -> torch.Tensor:
        """The pinned buffer ``which``, grown to fit, viewed as ``like``."""
        n = like.numel() * like.element_size()
        buf = self._pinned_bufs.get(which)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            self._pinned_bufs[which] = buf
        return buf[:n].view(like.dtype).view(like.shape)

    def _upload(self, job: _Job) -> None:
        """Stage the payload on the device: on the card through the pinned
        buffer and a copy on the side stream (the tensor allocated there,
        its use recorded on the compute stream)."""
        with self._transfer(job.rec, "upload"):
            host = torch.from_numpy(job.payload)
            if self._side is None:
                job.x = host.to(self.device)
                return
            if self._up_done is not None:
                self._up_done.synchronize()     # the buffer's last copy
            buf = self._pinned("upload", host)
            buf.copy_(host)
            with torch.cuda.stream(self._side):
                job.x = torch.empty(host.shape, dtype=host.dtype,
                                    device=self.device)
                job.x.copy_(buf, non_blocking=True)
                job.uploaded = self._up_done = torch.cuda.Event()
                job.uploaded.record()
            job.x.record_stream(torch.cuda.current_stream(self.device))

    def _staged(self, job: _Job) -> torch.Tensor:
        """The staged payload, once the compute stream waits for its
        copy."""
        x, job.x = job.x, None
        if job.uploaded is not None:
            torch.cuda.current_stream(self.device).wait_event(job.uploaded)
        return x

    def _encode(self, x: torch.Tensor, sample: bool) -> torch.Tensor:
        """The latent of the model's input ``x``: the posterior's mode, or
        a draw from it."""
        post = self.vae.encode(x)
        return post.sample(self._generator) if sample else post.mode()

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """The uint8 frames (T, H, W, 3) of latent ``z``."""
        return to_uint8(self.vae.decode(z.to(self.dtype))[0])

    def _start(self, job: _Job) -> None:
        """The request's first work: the encode (or a /decode's decode)."""
        if job.behind is not None:
            # the work ahead seen done before this launch, which can hold
            # the thread, starts this request's own work
            job.behind.ready()
            job.behind = None
        job.t_launch = time.perf_counter()
        if job.kind == "decode":
            job.out = self._decode(self._staged(job))
        else:
            x = to_unit(self._staged(job)[None], self.dtype)
            job.out = self._encode(x, job.sample)

    def _finish(self, job: _Job) -> None:
        """The rest of the request's work, then its answer's copy down: on
        the card on the side stream into the pinned buffer, after the
        compute stream has made it."""
        if job.kind == "reconstruct":
            job.out = self._decode(job.out)
        elif job.kind == "encode":
            job.out = job.out.float()
        y, job.out = job.out, None
        if self._side is None:
            job.host, job.t_ready = y, time.perf_counter()
            return
        made = torch.cuda.Event()
        made.record(torch.cuda.current_stream(self.device))
        job.host = self._pinned("download", y)
        with torch.cuda.stream(self._side):
            self._side.wait_event(made)
            job.host.copy_(y, non_blocking=True)
            job.done = torch.cuda.Event()
            job.done.record()
        y.record_stream(self._side)

    def _copy_out(self, job: _Job) -> np.ndarray:
        """The answer, down, as the response's own array."""
        if job.done is None:
            return job.host.numpy()
        return torch.empty(job.host.shape,
                           dtype=job.host.dtype).copy_(job.host).numpy()

    # ---- the pipeline (worker thread) ----
    def _run(self, job: _Job, *steps) -> bool:
        """``steps`` of ``job`` inside its work span, the model's tile
        counters' change added to its record; a step that raises answers
        the request with the error.  Whether all ran."""
        counts = getattr(self.vae, "tile_counts", None)
        before = dict(counts) if counts is not None else {}
        try:
            with spans.in_request(job.rec.id), spans.span("cvvae.serve.work"):
                for step in steps:
                    step(job)
            return True
        except Exception as e:  # surfaced as HTTP 500
            self._fail(job, e)
            return False
        finally:
            for k, v in (counts or {}).items():
                job.rec.tiles[k] = (job.rec.tiles.get(k, 0) + v
                                    - before.get(k, 0))

    def _begin(self, item, behind: Optional[_Job]) -> Optional[_Job]:
        """Take a request from the queue: stage its payload and launch its
        first work, behind ``behind``'s where another request holds the
        worker.  None if it failed (and was answered)."""
        job = _Job(*item, behind=behind)
        job.rec.staged = behind is not None
        job.rec.t_staged = time.perf_counter()
        job.rec.profiled = spans.enabled()
        if behind is None:
            self._took(job, job.rec.t_staged)
        if not self._run(job, self._upload, self._start):
            return None
        return job

    def _await(self, job: _Job) -> Optional[_Job]:
        """Wait for ``job``'s answer to be down, taking the next request
        meanwhile if one comes (at most one); it, or None."""
        nxt = None
        while True:
            try:
                ready = job.ready()
            except RuntimeError as e:           # the copy failed
                self._fail(job, e)
                ready = True
            if nxt is None:
                try:
                    item = self._q.get(block=not ready, timeout=POLL_S)
                except queue.Empty:
                    pass
                else:
                    nxt = self._begin(item, behind=job)
                    continue
            if ready:
                return nxt
            if nxt is not None:
                time.sleep(POLL_S)

    def _deliver(self, job: _Job) -> None:
        """Copy the answer out and hand it to the caller."""
        if "err" in job.box:
            return
        rec = job.rec
        try:
            with spans.in_request(rec.id), spans.span("cvvae.serve.work"), \
                    self._transfer(rec, "download"):
                out = self._copy_out(job)
        except Exception as e:  # surfaced as HTTP 500
            self._fail(job, e)
            return
        self.stats[job.kind] += 1
        if job.kind != "decode":
            self.stats["frames"] += int(job.payload.shape[0])
        rec.frames = int(out.shape[0] if job.kind == "decode"
                         else job.payload.shape[0])
        rec.ok = True
        job.box["out"] = out
        self._done(job)

    def _took(self, job: _Job, t: float) -> None:
        """The request's own work starts at ``t``: it leaves the queue."""
        if not job.queued:
            return
        job.queued = False
        job.rec.t_take = t
        with self._room:
            self._waiting -= 1
            self._room.notify()

    def _fail(self, job: _Job, e: Exception) -> None:
        self.stats["errors"] += 1
        job.box["err"] = e
        job.x = job.out = job.host = None
        job.t_ready = time.perf_counter()
        self._took(job, job.t_ready)
        self._done(job)

    def _done(self, job: _Job) -> None:
        rec = job.rec
        rec.t_done = time.perf_counter()
        # requests overlap: the busy seconds are their union
        self.stats["busy_s"] += max(0.0, rec.t_done - max(rec.t_take,
                                                          self._busy_until))
        self._busy_until = rec.t_done
        self.records.add(rec)
        job.box["done"].set()

    def _loop(self):
        job = None          # the request whose work is launched
        while True:
            if job is None:
                job = self._begin(self._q.get(), behind=None)
                continue
            self._run(job, self._finish)
            nxt = self._await(job)
            self._deliver(job)
            if nxt is not None:
                self._took(nxt, max(nxt.t_launch, job.t_ready))
            job = nxt

    def run(self, kind: str, payload: np.ndarray,
            sample: bool = False) -> np.ndarray:
        """One request through the worker's steps on the calling thread,
        outside the queue and the records, with the worker idle: for tools
        that profile or time the work alone."""
        job = _Job(kind, payload, sample, {"record": spans.RequestRecord(
            0, kind, 0, time.perf_counter())})
        for step in (self._upload, self._start, self._finish):
            step(job)
        if job.done is not None:
            job.done.synchronize()
        return self._copy_out(job)

    # ---- caller side ----
    def _has_room(self) -> bool:
        return self.max_queue <= 0 or self._waiting < self.max_queue

    def submit(self, kind: str, payload: np.ndarray, sample: bool,
               timeout: float = 600.0,
               request_id: Optional[int] = None) -> np.ndarray:
        rid = self.new_request_id() if request_id is None else request_id
        box = {"done": threading.Event(),
               "record": spans.RequestRecord(rid, kind, 0,
                                             time.perf_counter())}
        with self._room:
            if not self._room.wait_for(self._has_room, self.put_timeout):
                raise queue.Full
            self._waiting += 1
        self._q.put((kind, payload, sample, box))
        if not box["done"].wait(timeout):
            raise TimeoutError(f"{kind} timed out after {timeout}s")
        if "err" in box:
            raise box["err"]
        return box["out"]

    @property
    def queue_depth(self) -> int:
        """Requests submitted whose own work has not started, the staged
        one included."""
        return self._waiting


def _make_handler(worker: VAEWorker, started: float,
                  max_body_bytes: int = 512 * 1024 * 1024):
    class Handler(BaseHTTPRequestHandler):
        # one worker; ThreadingHTTPServer only parallelises socket IO
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/octet-stream"):
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except BrokenPipeError:
                pass  # client gave up

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                mesh = getattr(worker.vae, "mesh", None)
                if mesh is not None and mesh.closed:
                    return self._send_json(503, {
                        "ok": False, "error": "the device mesh is closed "
                                              "(a rank failed)"})
                return self._send_json(200, {"ok": True})
            if self.path == "/stats":
                s = dict(worker.stats)
                s["queue_depth"] = worker.queue_depth
                s["uptime_s"] = round(time.time() - started, 1)
                busy = s["busy_s"] or 1e-9
                s["frames_per_busy_s"] = round(s["frames"] / busy, 2)
                s["busy_s"] = round(s["busy_s"], 2)
                s.update(spans.summary(worker.records.records()))
                return self._send_json(200, s)
            return self._send_json(404, {"error": "unknown path"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            sample = "sample=1" in query
            kind = path.lstrip("/")
            if kind not in ("encode", "decode", "reconstruct"):
                return self._send_json(404, {"error": "unknown path"})
            rid = worker.new_request_id()
            with spans.in_request(rid):
                self._answer(kind, sample, rid)

        def _answer(self, kind: str, sample: bool, rid: int):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    # reject before reading the body into host memory
                    return self._send_json(413, {
                        "error": f"body {n} B exceeds cap "
                                 f"{max_body_bytes} B"})
                data = self.rfile.read(n)
                with spans.span("cvvae.serve.parse"):
                    arr = _npy_load(data)
                if kind in ("encode", "reconstruct"):
                    if arr.ndim != 4 or arr.shape[-1] != 3 \
                            or arr.dtype != np.uint8:
                        raise ValueError(
                            f"expected (T,H,W,3) uint8, got "
                            f"{arr.shape} {arr.dtype}")
                    arr = arr[:truncate_to_4k1(arr.shape[0])]
                elif arr.ndim != 5:
                    raise ValueError(f"expected 5-D latent, got {arr.shape}")
            except Exception as e:
                return self._send_json(400, {"error": str(e)})
            with spans.span("cvvae.serve.request"):
                try:
                    out = worker.submit(kind, arr, sample, request_id=rid)
                except queue.Full:
                    return self._send_json(503, {"error": "queue full"})
                except Exception as e:
                    return self._send_json(500, {"error": str(e)})
                with spans.span("cvvae.serve.serialize"):
                    body = _npy_bytes(out)
                return self._send(200, body)

    return Handler


class DrainingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose shutdown drains: non-daemon handler
    threads + ``block_on_close`` make ``server_close()`` join every
    in-flight handler, each of which waits on its VAEWorker result."""
    daemon_threads = False


def build_server(vae, port: int = 8400, host: str = "127.0.0.1",
                 max_queue: int = 8, act_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None,
                 max_body_bytes: int = 512 * 1024 * 1024,
                 put_timeout: float = 5.0) -> DrainingHTTPServer:
    """Wrap a ready VideoVAE in the HTTP boundary."""
    worker = VAEWorker(vae, max_queue=max_queue, act_dtype=act_dtype,
                       device=device, put_timeout=put_timeout)
    server = DrainingHTTPServer((host, port), _make_handler(
        worker, time.time(), max_body_bytes))
    server.worker = worker
    return server


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--variant", default="v1", choices=["v1", "sd3"],
                    help="random weights from seed 0; used when --vae_path "
                         "is absent")
    ap.add_argument("--vae_path", default=None,
                    help="reference HF checkpoint dir (config.json + "
                         "*.safetensors)")
    ap.add_argument("--subfolder", default=None,
                    help="checkpoint subfolder, e.g. vae3d / vae3d_sd3")
    ap.add_argument("--dtype", default="int8",
                    choices=["int8", "bf16", "fp32"],
                    help="int8 = bf16 activations + the int8 conv stack")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--warm_frames", type=int, default=17,
                    help="frame-window size run at warm-up (truncated to "
                         "the 4k+1 contract)")
    ap.add_argument("--max_queue", type=int, default=8)
    ap.add_argument("--max_body_mb", type=int, default=512,
                    help="reject request bodies larger than this with "
                         "HTTP 413 before reading them into memory")
    ap.add_argument("--calibration_video", default=None,
                    help="int8 only: video whose first 17 frames (at most "
                         "256x256) calibrate the static activation scales; "
                         "without it they come from synthetic noise")
    ap.add_argument("--quantized_cache", default=None,
                    help="int8 only: directory of the calibrated model "
                         "(torch.save of its state_dict).  Present -> "
                         "restored, skipping calibration; absent -> written "
                         "after calibration")
    ap.add_argument("--spatial_shards", type=int, default=1,
                    help="multi-device serving: shard the height axis of "
                         "every net call over this many devices "
                         "(VideoVAE.with_mesh; the ops exchange conv halos "
                         "between the ranks).  Composes with int8; outputs "
                         "match the single-device server within "
                         "reduction-order tolerance -- GroupNorm "
                         "statistics combined across ranks reorder the "
                         "last ulp, so NOT byte-identical across shard "
                         "counts (tests/test_torch_parallel_serve.py).  "
                         "The ranks are the cards cuda:0..N-1 over NCCL, "
                         "or with --device cpu CPU processes over gloo.  "
                         "1 = single device")
    return ap


#: the file of a --quantized_cache directory
CACHE_FILE = "quantized_state.pt"


def quantized(vae, args: argparse.Namespace, warm_frames: int):
    """The int8 model: restored from ``--quantized_cache`` when that
    directory exists, else quantized and calibrated (and written there
    when it is given).  Calibration runs on the first 17 frames of
    ``--calibration_video`` at min(256, H) x min(256, W), or on the
    reference's synthetic clip, so both calibrate on the same bytes."""
    from cvvae_tpu_torch.data.video_io import read_video
    from cvvae_tpu_torch.ops.quant import load_quantized_state

    cache = args.quantized_cache and os.path.abspath(args.quantized_cache)
    if cache and os.path.isdir(cache):
        t0 = time.perf_counter()
        state = torch.load(os.path.join(cache, CACHE_FILE),
                           map_location=vae.device, weights_only=True)
        q = load_quantized_state(vae.quantize(), state)
        print(f"[serve] restored quantized model from {cache} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        return q
    ch, cw = min(args.height, 256), min(args.width, 256)
    if args.calibration_video:
        frames, _ = read_video(args.calibration_video, height=ch, width=cw,
                               max_frames=17)
        calib = frames[None][:, :truncate_to_4k1(len(frames))]
    else:
        print("[serve] WARNING: int8 without --calibration_video: the "
              "activation scales come from synthetic noise; pass a "
              "representative clip for serving quality", flush=True)
        calib = np.random.default_rng(0).integers(
            0, 255, (1, min(17, warm_frames), ch, cw, 3))
    q = vae.quantize(calibration=calib.astype(np.float32) / 127.5 - 1.0)
    if cache:
        os.makedirs(cache)
        torch.save(q.state_dict(), os.path.join(cache, CACHE_FILE))
        print(f"[serve] wrote quantized model to {cache}", flush=True)
    return q


def prepare(args: argparse.Namespace) -> DrainingHTTPServer:
    """Build the model, install the serving preset and warm it up: the
    step of ``main`` before the socket starts serving."""
    from cvvae_tpu_torch.cli import (apply_serving_preset, require_device,
                                     torch_dtype)
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    if args.dtype != "int8":
        for flag in ("calibration_video", "quantized_cache"):
            if getattr(args, flag):
                raise SystemExit(f"--{flag} applies to --dtype int8 only")
    dtype = torch_dtype(args.dtype)
    device = require_device(args.device)
    if args.spatial_shards > 1:
        n_dev = (torch.cuda.device_count() if device.type == "cuda"
                 else os.cpu_count())
        if args.spatial_shards > n_dev:
            raise SystemExit(f"--spatial_shards {args.spatial_shards} "
                             f"> {n_dev} visible devices")
    if args.vae_path:
        vae = VideoVAE.from_pretrained(args.vae_path,
                                       subfolder=args.subfolder,
                                       dtype=dtype, device=device)
    else:
        vae = VideoVAE.from_config(config_for_variant(args.variant),
                                   dtype=dtype, device=device)
    apply_serving_preset(vae, args.height, args.width)
    warm_frames = truncate_to_4k1(args.warm_frames)
    if args.dtype == "int8":
        vae = quantized(vae, args, warm_frames)
    mesh = None
    if args.spatial_shards > 1:
        from cvvae_tpu_torch.parallel import make_mesh
        n = args.spatial_shards
        mesh = (make_mesh(n) if device.type == "cuda"
                else make_mesh(n, devices=["cpu"] * n, backend="gloo"))
        vae = vae.with_mesh(mesh)
        print(f"[serve] height axis sharded over {n} devices "
              f"({mesh.backend})", flush=True)

    print(f"[serve] warming {args.height}x{args.width} x{warm_frames}f "
          f"{args.dtype} on {device} ...", flush=True)
    server = build_server(vae, port=args.port, host=args.host,
                          max_queue=args.max_queue, act_dtype=dtype,
                          device=device,
                          max_body_bytes=args.max_body_mb * 1024 * 1024)
    warm = np.zeros((warm_frames, args.height, args.width, 3), np.uint8)
    t0 = time.perf_counter()
    server.worker.submit("reconstruct", warm, False, timeout=3600.0)
    # /stats reports steady-state requests only
    server.worker.records.clear()
    server.worker.stats.update(reconstruct=0, frames=0, busy_s=0.0)
    server.mesh = mesh
    print(f"[serve] warm in {time.perf_counter() - t0:.1f}s; "
          f"listening on {args.host}:{server.server_address[1]}", flush=True)
    return server


def main(argv=None):
    args = build_argparser().parse_args(argv)
    server = prepare(args)

    # graceful drain on SIGTERM/SIGINT: shutdown() stops the accept loop,
    # then server_close() joins the handler threads, each blocked on its
    # VAEWorker result, so every accepted request completes
    import signal

    def _stop(signum, frame):
        print(f"[serve] signal {signum}: draining and shutting down",
              flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        server.serve_forever()
        server.server_close()
    finally:
        if server.mesh is not None:
            server.mesh.close()
    print("[serve] stopped", flush=True)


if __name__ == "__main__":
    main()
