"""Spans and request records on the port's serving path.

A span names a stretch of host work on the profiler's clock:

    with spans.span("cvvae.net.res"):
        ...

While no profiler records, ``span`` reads one global flag and returns a
shared null context: no range is built, no clock is read, nothing is
allocated.  While one records (``torch.profiler.profile``, which sets
that flag for every thread of the process), it opens a user range named
``name`` on the calling thread, so a trace shows it on the same timeline
as the device's kernels, nested in the thread's other ranges.  Its inputs
are the id of the request the thread works on (``in_request``) and the
span's own integer fields (a tile's row and column, a chunk's index).  A
profile taken with ``record_shapes=True`` keeps them as each range's
"Concrete Inputs"; the range is opened through
``torch.autograd._record_function_with_args_enter`` because the string
``args`` of ``torch.profiler.record_function`` reach no trace.

Span names begin with ``cvvae.``: ``serve.*`` the HTTP front,
``vae.*`` the model API, ``net.*`` the nets' blocks, ``op.*`` the ops'
public entries.

A ``RequestLog`` keeps the served requests' ``RequestRecord``s (queue,
staging, transfer and done times on ``time.perf_counter``'s clock, and
the tile counters' deltas) in a bounded ring; ``VAEWorker`` owns one and
``/stats`` summarises it (``summary``).  The log last made in this
process stays reachable through ``last_log()`` after its server has
closed, for a reader in the same process.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_local = threading.local()


def enabled() -> bool:
    """Whether a profiler records in this process."""
    return _profiler._is_profiler_enabled


class _Range:
    """A user range of the profiler, its inputs integers."""

    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name, *self.args)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)


def span(name: str, *fields: int):
    """A range named ``name`` while a profiler records, else a null
    context; its inputs the thread's request id (where it has one) and
    ``fields``."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    rid = getattr(_local, "request", None)
    return _Range(name, fields if rid is None else (rid,) + fields)


class in_request:
    """The calling thread works on request ``rid`` inside the block: its
    spans carry the id."""

    __slots__ = ("rid", "prev")

    def __init__(self, rid: int):
        self.rid = rid

    def __enter__(self):
        self.prev = getattr(_local, "request", None)
        _local.request = self.rid

    def __exit__(self, *exc):
        _local.request = self.prev


@dataclasses.dataclass
class RequestRecord:
    """One request through ``VAEWorker``; times in seconds on
    ``time.perf_counter``'s clock."""
    id: int
    kind: str
    #: frames of the clip sent (encode, reconstruct) or answered (decode)
    frames: int
    t_submit: float
    #: the start of the request's own work: when the worker took it, or,
    #: for one staged behind another, when that one's work was seen done
    #: (or its own first launch, if later)
    t_take: float = float("nan")
    t_done: float = float("nan")
    #: its upload began (the worker took it from the queue), while another
    #: request held the worker (``staged``) or not
    t_staged: float = float("nan")
    staged: bool = False
    #: host seconds in the worker's upload and download spans
    upload_s: float = 0.0
    download_s: float = 0.0
    #: the model's tile counters' change over the request
    #: (``VideoVAE.tile_counts``)
    tiles: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: a profiler recorded when the worker took the request
    profiled: bool = False
    ok: bool = False

    @property
    def queue_s(self) -> float:
        return self.t_take - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class RequestLog:
    """The most recent ``maxlen`` request records, safe to read while the
    worker adds to it."""

    def __init__(self, maxlen: int = 4096):
        global _last_log
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        _last_log = self

    def add(self, rec: RequestRecord) -> None:
        with self._lock:
            self._ring.append(rec)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def records(self) -> List[RequestRecord]:
        with self._lock:
            return list(self._ring)


_last_log: Optional[RequestLog] = None


def last_log() -> Optional[RequestLog]:
    """The ``RequestLog`` made last in this process, or None."""
    return _last_log


def _rank(values: List[float], q: float) -> float:
    return values[min(len(values) - 1, int(len(values) * q))]


def summary(records: List[RequestRecord]) -> dict:
    """``/stats``' request keys over the successful records: latency
    (submit to done) and queue wait (submit to take) p50 / p95 in ms, the
    mean upload and download ms, each net's mean calls a request (its
    tiles times its chunks) and the share staged; {} without one."""
    done = [r for r in records if r.ok]
    if not done:
        return {}
    out = {}
    for key, values in (("latency_ms", [r.latency_s for r in done]),
                        ("queue_wait_ms", [r.queue_s for r in done])):
        v = sorted(values)
        out[f"{key}_p50"] = round(1e3 * v[len(v) // 2], 1)
        out[f"{key}_p95"] = round(1e3 * _rank(v, 0.95), 1)
    for key in ("upload", "download"):
        out[f"{key}_ms_mean"] = round(
            1e3 * sum(getattr(r, f"{key}_s") for r in done) / len(done), 2)
    for net in ("encoder", "decoder"):
        out[f"{net}_calls_mean"] = round(sum(
            r.tiles.get(f"{net}.calls", 0) for r in done) / len(done), 2)
    out["staged_share"] = round(sum(r.staged for r in done) / len(done), 3)
    return out
