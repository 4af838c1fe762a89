"""Serving daemon: the VideoVAE behind an HTTP boundary.

Port of ``cvvae_tpu/serve.py``.

* one device, one model, one worker thread: requests queue (bounded) and
  run strictly in order; a full queue answers 503.
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

Usage:
    python -m cvvae_tpu_torch.serve --port 8400 --variant v1 --dtype bf16 \
        --height 720 --width 1280 --device cuda
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from cvvae_tpu_torch.data.video_io import truncate_to_4k1


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _npy_load(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


class VAEWorker:
    """Owns the device model; executes requests strictly in order."""

    def __init__(self, vae, *, max_queue: int = 8,
                 act_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None,
                 put_timeout: float = 5.0):
        self.vae = vae
        self.dtype = act_dtype if act_dtype is not None else vae.dtype
        self.device = torch.device(device if device is not None
                                   else vae.device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        #: how long submit() waits for queue space before the caller sees
        #: queue.Full (-> HTTP 503)
        self.put_timeout = put_timeout
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self.stats = {"encode": 0, "decode": 0, "reconstruct": 0,
                      "errors": 0, "frames": 0, "busy_s": 0.0}
        #: wall latency (queue wait + device time) of the most recent 512
        #: successful requests
        self.latencies_ms = collections.deque(maxlen=512)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- device ops (worker thread only) ----
    def _encode(self, frames_u8: np.ndarray, sample: bool) -> np.ndarray:
        x = torch.from_numpy(frames_u8).to(self.device)[None]
        x = x.to(self.dtype) / 127.5 - 1.0
        post = self.vae.encode(x)
        z = post.sample(self._generator) if sample else post.mode()
        return z.float().cpu().numpy()

    def _decode(self, z_np: np.ndarray) -> np.ndarray:
        z = torch.from_numpy(z_np).to(device=self.device, dtype=self.dtype)
        x = self.vae.decode(z)[0]
        u8 = ((x.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
        return u8.cpu().numpy()

    def _loop(self):
        while True:
            kind, payload, sample, box = self._q.get()
            t0 = time.perf_counter()
            try:
                if kind == "encode":
                    out = self._encode(payload, sample)
                elif kind == "decode":
                    out = self._decode(payload)
                else:  # reconstruct
                    out = self._decode(self._encode(payload, sample))
                self.stats[kind] += 1
                if kind != "decode":
                    self.stats["frames"] += int(payload.shape[0])
                box["out"] = out
            except Exception as e:  # surfaced as HTTP 500
                self.stats["errors"] += 1
                box["err"] = e
            finally:
                self.stats["busy_s"] += time.perf_counter() - t0
                box["done"].set()

    # ---- caller side ----
    def submit(self, kind: str, payload: np.ndarray, sample: bool,
               timeout: float = 600.0) -> np.ndarray:
        t0 = time.perf_counter()
        box = {"done": threading.Event()}
        self._q.put((kind, payload, sample, box), timeout=self.put_timeout)
        if not box["done"].wait(timeout):
            raise TimeoutError(f"{kind} timed out after {timeout}s")
        if "err" in box:
            raise box["err"]
        self.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return box["out"]

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()


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
                return self._send_json(200, {"ok": True})
            if self.path == "/stats":
                s = dict(worker.stats)
                s["queue_depth"] = worker.queue_depth
                s["uptime_s"] = round(time.time() - started, 1)
                busy = s["busy_s"] or 1e-9
                s["frames_per_busy_s"] = round(s["frames"] / busy, 2)
                s["busy_s"] = round(s["busy_s"], 2)
                lats = sorted(list(worker.latencies_ms))  # snapshot first
                if lats:
                    s["latency_ms_p50"] = round(lats[len(lats) // 2], 1)
                    s["latency_ms_p95"] = round(
                        lats[min(len(lats) - 1, int(len(lats) * 0.95))], 1)
                return self._send_json(200, s)
            return self._send_json(404, {"error": "unknown path"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            sample = "sample=1" in query
            kind = path.lstrip("/")
            if kind not in ("encode", "decode", "reconstruct"):
                return self._send_json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    # reject before reading the body into host memory
                    return self._send_json(413, {
                        "error": f"body {n} B exceeds cap "
                                 f"{max_body_bytes} B"})
                arr = _npy_load(self.rfile.read(n))
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
            try:
                out = worker.submit(kind, arr, sample)
            except queue.Full:
                return self._send_json(503, {"error": "queue full"})
            except Exception as e:
                return self._send_json(500, {"error": str(e)})
            return self._send(200, _npy_bytes(out))

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
    ap.add_argument("--variant", default="v1", choices=["v1", "sd3"])
    ap.add_argument("--dtype", default="bf16",
                    choices=["int8", "bf16", "fp32"])
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
    ap.add_argument("--quantized_cache", default=None,
                    help="int8 only: not ported yet")
    ap.add_argument("--spatial_shards", type=int, default=1,
                    help="multi-device serving: not ported yet (1 only)")
    return ap


def prepare(args: argparse.Namespace) -> DrainingHTTPServer:
    """Build the model, install the serving preset and warm it up: the
    step of ``main`` before the socket starts serving."""
    from cvvae_tpu_torch.cli import (apply_serving_preset, require_device,
                                     torch_dtype)
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    if args.quantized_cache:
        raise SystemExit("--quantized_cache is not ported yet (ROADMAP "
                         "queue A: int8)")
    if args.spatial_shards > 1:
        raise SystemExit("--spatial_shards > 1 is not ported yet (ROADMAP "
                         "queue A: multi-device)")
    dtype = torch_dtype(args.dtype)
    device = require_device(args.device)
    vae = VideoVAE.from_config(config_for_variant(args.variant),
                               dtype=dtype, device=device)
    apply_serving_preset(vae, args.height, args.width)

    warm_frames = truncate_to_4k1(args.warm_frames)
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
    server.worker.latencies_ms.clear()
    server.worker.stats.update(reconstruct=0, frames=0, busy_s=0.0)
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
    server.serve_forever()
    server.server_close()
    print("[serve] stopped", flush=True)


if __name__ == "__main__":
    main()
