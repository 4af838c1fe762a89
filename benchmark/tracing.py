"""The traced run: host ranges the benchmark opens around the calls into
each layer of the port, the shapes of the kernel calls it wraps, and the
reduction of a ``torch.profiler`` trace to what the per-layer readers
read.

Wrapped from outside, for the traced run only and undone after it:

* the worker's ``_encode`` / ``_decode`` (``bench.worker.encode`` /
  ``.decode``: the uint8 copy up, the net, the copy down) and the model's
  ``encode`` / ``decode`` inside them (``bench.vae.encode`` / ``.decode``),
  each of the model's ranges ending in a synchronise, so that a device
  event belongs to the range in which it starts;
* the handler's ``.npy`` parse and serialisation (``bench.handler.parse``,
  ``bench.handler.serialize``) and each client's request
  (``bench.client.request``);
* the ops layer's calls of K5 (``conv_int8.stage`` and ``conv_int8.gemm``)
  and K1 (``norm.group_norm_silu``), whose shapes the roofline readers
  turn into work with ``benchmark/work.py``.

Each range is kept twice: as a ``record_function`` (which the profiler
keeps on every thread where it can, ``profile_all_threads``) and in the
benchmark's own list on the host's monotonic clock, laid onto the
profile's clock through two anchor ranges opened on the profiling thread
at the window's ends; the reduction reads the list.

The worker runs one request at a time and waits for the device at the end
of each encode and decode, so a request's device events are those that
start between its ``bench.worker.encode`` and the next request's.  The
first traced request is left out: the profiler can lose device records
near a trace's start.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import torch

from benchmark import work

WORKER_ENCODE = "bench.worker.encode"
WORKER_DECODE = "bench.worker.decode"
VAE_ENCODE = "bench.vae.encode"
VAE_DECODE = "bench.vae.decode"
HANDLER_PARSE = "bench.handler.parse"
HANDLER_SERIALIZE = "bench.handler.serialize"
ANCHOR = "bench.anchor"

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "fp32"}


class Instruments:
    """The wrappers of one traced run; ``calls[i]`` holds the kernel calls
    of the i-th request the worker ran (from 1)."""

    def __init__(self, server):
        self.server = server
        self.request = 0
        self.calls: Dict[int, list] = collections.defaultdict(list)
        #: (name, native thread id, start ns, end ns) of every range
        self.spans: List[tuple] = []
        #: perf_counter_ns() inside each anchor range
        self.anchors: List[int] = []
        self._undo: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str):
        """A host range, in the profile and in ``spans``."""
        t0 = time.perf_counter_ns()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.spans.append((name, threading.get_native_id(), t0,
                               time.perf_counter_ns()))

    def anchor(self) -> None:
        """An anchor range on this (the profiling) thread."""
        with torch.profiler.record_function(ANCHOR):
            self.anchors.append(time.perf_counter_ns())

    def _set(self, owner, name, value):
        had = name in vars(owner)
        self._undo.append((owner, name, vars(owner).get(name), had))
        setattr(owner, name, value)

    def install(self):
        from cvvae_tpu_torch import serve
        from cvvae_tpu_torch.ops import norm
        from cvvae_tpu_torch.ops.kernels import conv_int8

        worker = self.server.worker
        vae = worker.vae
        sync = worker.device.type == "cuda"

        def ranged(name, fn, wait=False, count=False):
            def run(*args, **kwargs):
                if count:
                    self.request += 1
                with self.span(name):
                    out = fn(*args, **kwargs)
                    if wait and sync:
                        torch.cuda.synchronize(worker.device)
                return out
            return run

        self._set(worker, "_encode", ranged(WORKER_ENCODE, worker._encode,
                                            count=True))
        self._set(worker, "_decode", ranged(WORKER_DECODE, worker._decode))
        self._set(vae, "encode", ranged(VAE_ENCODE, vae.encode, wait=True))
        self._set(vae, "decode", ranged(VAE_DECODE, vae.decode, wait=True))
        self._set(serve, "_npy_load", ranged(HANDLER_PARSE, serve._npy_load))
        self._set(serve, "_npy_bytes", ranged(HANDLER_SERIALIZE,
                                              serve._npy_bytes))

        stage, gemm = conv_int8.stage, conv_int8.gemm
        gn = norm.group_norm_silu

        def stage_w(x, scale_x, pads, modes, sw=1):
            self.calls[self.request].append(
                ("K5.stage", tuple(x.shape), _DTYPES.get(x.dtype),
                 dict(pads=tuple(map(tuple, pads)), stride=(1, 1, sw))))
            return stage(x, scale_x, pads, modes, sw)

        def gemm_w(staged, weight_q, scale_w, scale_x, bias, stride, pads,
                   wpk=None, **kw):
            self.calls[self.request].append(
                ("K5", tuple(staged.shape), _DTYPES.get(
                    kw.get("out_dtype") or staged.dtype),
                 dict(cout=int(weight_q.shape[0]),
                      kernel=tuple(weight_q.shape[2:]),
                      stride=tuple(stride), pads=tuple(map(tuple, pads)))))
            return gemm(staged, weight_q, scale_w, scale_x, bias, stride,
                        pads, wpk, **kw)

        def gn_w(x, weight, bias, **kw):
            self.calls[self.request].append(
                ("K1", tuple(x.shape), _DTYPES.get(x.dtype),
                 dict(silu=bool(kw.get("silu", False)))))
            return gn(x, weight, bias, **kw)

        self._set(conv_int8, "stage", stage_w)
        self._set(conv_int8, "gemm", gemm_w)
        self._set(norm, "group_norm_silu", gn_w)

    def remove(self):
        for owner, name, old, had in reversed(self._undo):
            if had:
                setattr(owner, name, old)
            else:
                delattr(owner, name)
        self._undo.clear()


@contextlib.contextmanager
def profiled(cuda: bool):
    """``torch.profiler`` over the block, the ops of every thread where
    this torch can record them."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):
        extra = {}
    with torch.profiler.profile(activities=acts, **extra) as prof:
        yield prof


@dataclasses.dataclass
class Trace:
    """What the readers read from one traced run."""
    #: requests analysed (the traced requests but the first)
    requests: int
    #: device seconds from the first event of the first analysed request to
    #: the last event of the last, and the union of the events inside
    window_s: float
    busy_s: float
    #: device seconds of the analysed requests by kernel group
    groups: Dict[str, float]
    #: device seconds of the analysed requests inside each host range
    ranges: Dict[str, float]
    #: the analysed requests' K1 and K5 calls (kernel, shape, dtype, work
    #: arguments)
    calls: List[tuple]
    #: host seconds of the traced window and the worker's busy seconds in
    #: it (``VAEWorker.stats["busy_s"]`` at its ends)
    host_window_s: float
    worker_busy_s: float
    #: the longest idle stretches of the device, by the host ranges open
    #: when each began: [[name, seconds], ...]
    idle_gaps: List[list]
    cfg: object = None
    clip: Optional[tuple] = None


def reduce(prof, inst: Instruments, host_window_s: float,
           worker_busy_s: float) -> Optional[Trace]:
    """The ``Trace`` of a profile, or None where it holds fewer than two
    requests or no device event."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # the device timeline also carries each host range's projection onto
    # the stream (a GPU user annotation), which is no device work
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("bench.")
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    marks = sorted(e.time_range.start for e in cpu if e.name == ANCHOR)
    if not marks or len(marks) != len(inst.anchors):
        return None
    ns = inst.anchors
    rate = ((marks[-1] - marks[0]) / (ns[-1] - ns[0])
            if len(ns) > 1 and ns[-1] > ns[0] else 1e-3)

    def us(t_ns):
        return marks[0] + (t_ns - ns[0]) * rate

    spans = sorted((name, tid, us(a), us(b))
                   for name, tid, a, b in inst.spans)
    enc = sorted((s for s in spans if s[0] == WORKER_ENCODE),
                 key=lambda s: s[2])
    if len(enc) < 2:
        return None
    starts = [s[2] for s in enc]
    worker = enc[0][1]
    vae_ranges = {n: [(s[2], s[3]) for s in spans if s[0] == n]
                  for n in (VAE_ENCODE, VAE_DECODE)}

    def request_of(t):
        return bisect.bisect_right(starts, t)   # 1-based; 0 before the first

    groups: Dict[str, float] = collections.defaultdict(float)
    ranges: Dict[str, float] = collections.defaultdict(float)
    first = last = None
    inside = []
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        if request_of(s) < 2:
            continue
        inside.append(e)
        first = s if first is None else first
        last = t if last is None else max(last, t)
        d = (t - s) / 1e6
        groups[work.group_of(e.name)] += d
        for name, within in vae_ranges.items():
            if any(a <= s <= b for a, b in within):
                ranges[name] += d
    if first is None:
        return None
    busy, end = 0.0, first
    gaps = []
    for e in inside:
        s, t = e.time_range.start, e.time_range.end
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    calls = [c for i, cs in inst.calls.items() if i >= 2 for c in cs]
    # the worker's ops, where the profile holds that thread
    threads = {e.thread for e in cpu if e.name == WORKER_ENCODE}
    ops = sorted((e for e in cpu if e.thread in threads
                  and not e.name.startswith("bench.")),
                 key=lambda e: e.time_range.start)
    return Trace(requests=len(enc) - 1, window_s=(last - first) / 1e6,
                 busy_s=busy / 1e6, groups=dict(groups), ranges=dict(ranges),
                 calls=calls, host_window_s=host_window_s,
                 worker_busy_s=worker_busy_s,
                 idle_gaps=_name_gaps(gaps, spans, worker, ops))


def _name_gaps(gaps, spans, worker, ops, top: int = 10) -> List[list]:
    """Each idle stretch named by the innermost range open on the worker's
    thread when it began, and the innermost op open there where the
    profile holds the worker's ops; else by a handler's or client's open
    range, else "worker waiting"; the names' summed seconds, longest
    first."""
    o_starts = [e.time_range.start for e in ops]
    total: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        open_ = [s for s in spans if s[2] <= a <= s[3]]
        mine = [s for s in open_ if s[1] == worker]
        if mine:
            name = max(mine, key=lambda s: s[2])[0]
            i = bisect.bisect_right(o_starts, a)
            op = next((o.name for o in reversed(ops[max(0, i - 400):i])
                       if o.time_range.end >= a), None)
            name = f"{name} / {op}" if op else name
        elif open_:
            name = "worker waiting / " + max(open_, key=lambda s: s[2])[0]
        else:
            name = "worker waiting"
        total[name] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:top]]
