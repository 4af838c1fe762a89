"""The traffic generator: one mix file (``benchmark/traffic/<mix>.json``)
in, seeded request bodies and a client loop out.

A mix names the endpoint, the clip's frames, height and width (uint8
RGB on the wire, as ``.npy``), the number of clients and their loop
("closed": each client sends its next request when the last response has
arrived), and ``base_clips``: that many uniform random clips are made
from the seed in set-up, and request k sends base clip k mod n with its
frames rotated by (k div n) mod T, so that no two of the first n * T
requests carry the same bytes and nothing is made or copied in the
window (a body is sent as three slices of the one buffer).
"""

from __future__ import annotations

import dataclasses
import hashlib
import http.client
import io
import json
import threading
import time
from typing import List, Optional

import numpy as np
import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed (weights, clips, the
    calibration clip, the check's sample), any size of seed."""
    digest = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass(frozen=True)
class Mix:
    endpoint: str
    frames: int
    height: int
    width: int
    clients: int
    loop: str
    base_clips: int
    #: responses compared with the reference after the window
    checked: int
    #: the traced run's window, seconds (at most ``--seconds``)
    trace_seconds: float

    @classmethod
    def load(cls, path: str) -> "Mix":
        with open(path) as f:
            data = json.load(f)
        mix = cls(**{f.name: data[f.name] for f in dataclasses.fields(cls)})
        if (mix.endpoint != "/reconstruct" or mix.loop != "closed"
                or data.get("dtype") != "uint8"):
            raise ValueError(f"{path}: the generator serves closed loops of "
                             f"uint8 clips on /reconstruct, not {mix.loop} "
                             f"{data.get('dtype')} {mix.endpoint}")
        return mix


class Bodies:
    """The seeded request bodies of a mix."""

    def __init__(self, mix: Mix, seed: int, device):
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, "clips"))
        clips = torch.randint(0, 256, (mix.base_clips, mix.frames, mix.height,
                                       mix.width, 3), dtype=torch.uint8,
                              generator=g, device=device)
        self.clips = clips.cpu().numpy()
        self.frames = mix.frames
        self.frame_bytes = mix.height * mix.width * 3
        buf = io.BytesIO()
        np.lib.format.write_array_header_1_0(
            buf, np.lib.format.header_data_from_array_1_0(self.clips[0]))
        self.header = buf.getvalue()
        self.length = len(self.header) + self.clips[0].nbytes

    def which(self, k: int):
        """(base clip, rotation) of request k."""
        n = len(self.clips)
        return k % n, (k // n) % self.frames

    def parts(self, k: int):
        """Request k's body as buffers to send in turn."""
        b, r = self.which(k)
        data = memoryview(self.clips[b].reshape(-1))
        cut = r * self.frame_bytes
        return [self.header, data[cut:], data[:cut]]

    def clip(self, k: int) -> np.ndarray:
        """Request k's clip (T, H, W, 3), as its body holds it."""
        b, r = self.which(k)
        return np.roll(self.clips[b], -r, axis=0)


@dataclasses.dataclass
class Record:
    k: int
    client: int
    t_send: float
    t_done: float = 0.0
    status: int = 0
    body: Optional[bytes] = None
    error: str = ""


def post(conn: http.client.HTTPConnection, endpoint: str, parts,
         length: int):
    """Send one request in parts on a kept-alive connection; (status,
    body)."""
    conn.putrequest("POST", endpoint)
    conn.putheader("Content-Type", "application/octet-stream")
    conn.putheader("Content-Length", str(length))
    conn.endheaders()
    for p in parts:
        conn.send(p)
    resp = conn.getresponse()
    return resp.status, resp.read()


def closed_loop(port: int, mix: Mix, bodies: Bodies, seconds: float,
                first_k: int = 0, span=None):
    """``mix.clients`` clients, each sending its next request when its last
    response has arrived, until ``seconds`` after they start together.
    Requests are numbered from ``first_k`` in the order they are sent.
    ``span(name)`` is a context manager opened around each request (the
    traced run's host range).  Returns (every request's record, the
    clock at which the clients started)."""
    records: List[Record] = []
    lock = threading.Lock()
    counter = [first_k]
    start = threading.Barrier(mix.clients + 1)
    stop = [0.0]

    def client(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        start.wait()
        try:
            while time.perf_counter() < stop[0]:
                with lock:
                    k = counter[0]
                    counter[0] += 1
                rec = Record(k, i, time.perf_counter())
                try:
                    if span is None:
                        rec.status, rec.body = post(conn, mix.endpoint,
                                                    bodies.parts(k),
                                                    bodies.length)
                    else:
                        with span("bench.client.request"):
                            rec.status, rec.body = post(
                                conn, mix.endpoint, bodies.parts(k),
                                bodies.length)
                except (OSError, http.client.HTTPException) as e:
                    rec.error = repr(e)
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=600)
                rec.t_done = time.perf_counter()
                with lock:
                    records.append(rec)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(mix.clients)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    stop[0] = t0 + seconds
    start.wait()
    for t in threads:
        t.join(seconds + 660)
        if t.is_alive():
            raise RuntimeError("a client did not finish its last request")
    records.sort(key=lambda r: r.k)
    return records, t0
