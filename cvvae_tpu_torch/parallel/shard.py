"""Sharded net calls: the shard plan, the halo exchange, the gathers and
the cross-rank collectives that the ops run while a net call is split over
the ranks of a mesh (``parallel/mesh.py``).

Port of what the JAX package leaves to XLA's SPMD partitioner
(``cvvae_tpu/parallel/mesh.py``: ``spatial_sharding``,
``temporal_sharding``): there the partitioner inserts the conv halo
exchanges and the partitioned GroupNorm sums; here every op asks the
context of the net call (:func:`current`, set by :func:`sharded`) and
runs its collectives explicitly over ``torch.distributed``.  With no
context every op is the unsharded code.

One axis of (B, T, H, W, C) is split: H (``dim`` 2) or T (``dim`` 1).
Each rank holds a run of whole rows (frames) of it.  The context keeps,
for every tensor of the net call, the run of each rank (``sizes``), so
that an op can tell the global extent, which rank holds a global edge,
and what to exchange.  A tensor's layout is looked up by its shape
without the split axis and the channels: every op of the v1 and SD3 nets
that changes a layout (a strided conv, an upsample) also changes W
(H split) or H and W (T split), so the key tells the levels apart, and
two layouts under one key raise.

The rules every op follows (each is a function of the shapes alone, the
same on every rank, so a :class:`ShardPlanError` is raised by every rank
at the same op, before any collective of that op):

* a conv of kernel k, stride s and global pads (lo, hi) along the axis
  gives output o to the rank that holds input row o·s (the first rank
  from output 0, the last up to the global output extent); the rank
  reads the input rows its outputs' windows cover, from its neighbours
  where they lie outside its own run (:func:`window_plan`), and pads
  only where the window passes a global end: interior sides pad 0;
* a rank that would get no output rows raises;
* every shape-based dispatch (int8 at T·H·W >= INT8_MIN_POSITIONS, the
  time decomposition at T > 1, K4 at S >= FLASH_MIN_TOKENS) takes the
  global extent (:meth:`ShardContext.extents`).

The transport (:class:`Comm`): halo rows and shards go by point-to-point
messages, one a pair of ranks a redistribution; the GroupNorm moments by
an all-gather, the dynamic int8 scale by an all-reduce (MAX).  gloo reads
a CUDA tensor's device pointer as host memory in ``send``/``recv``
(``utils/probe_collectives.py``: the sender aborts with "writev: Bad
address" on an H100), so under gloo every point-to-point message of a
CUDA tensor is staged explicitly through pinned host memory, counted in
``Comm.counts["staged"]``; gloo's all_gather and all_reduce take CUDA
tensors (the probe), and take them directly.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Range = Tuple[int, int]


class ShardPlanError(ValueError):
    """A shape the mesh cannot split as asked.  Raised on every rank alike,
    before any collective of the op that finds it."""


def time_split(t: int, n: int) -> Tuple[int, ...]:
    """T split over ``n`` ranks, as ``VideoVAE.with_mesh(shard_dim="time")``
    of the JAX package requires it: T divisible by n, else its error."""
    if t % n:
        raise ShardPlanError(
            f"time-sharding over {n} devices needs T divisible by {n} (got "
            f"T={t}): GroupNorm statistics span the sequence, so padding "
            f"would change the numerics — feed mesh-multiple windows")
    return (t // n,) * n


def row_split(extent: int, n: int, block: int) -> Tuple[int, ...]:
    """``extent`` rows over ``n`` ranks in runs of whole ``block``-row
    blocks (the net's total stride along the axis), as even as they go:
    the first ranks take one block more where the blocks do not divide,
    the last rank a partial block where ``extent`` is not a multiple of
    ``block``.  Raises where a rank would get no rows."""
    blocks = -(-extent // block)
    if blocks < n:
        raise ShardPlanError(
            f"{extent} rows in blocks of {block} cannot be split over {n} "
            f"ranks: {n - blocks} would hold no rows")
    base, extra = divmod(blocks, n)
    sizes, start = [], 0
    for r in range(n):
        end = min(extent, start + (base + (r < extra)) * block)
        sizes.append(end - start)
        start = end
    return tuple(sizes)


def runs(sizes: Sequence[int]) -> List[Range]:
    """Each rank's [start, end) from the sizes of the runs, in order."""
    out, start = [], 0
    for n in sizes:
        out.append((start, start + n))
        start += n
    return out


def window_plan(sizes: Sequence[int], k: int, s: int, lo: int, hi: int,
                what: str = "conv"):
    """The split of a conv of kernel ``k``, stride ``s`` and global pads
    (``lo``, ``hi``) along the axis, over input runs ``sizes``:
    (``need``, ``pads``, ``out_sizes``) per rank.  Rank r computes the
    outputs [o0, o1) whose first input row o·s it holds (clipped to the
    global output extent); it reads the input rows ``need[r]`` = [i0, i1)
    of the global tensor and pads ``pads[r]`` = (lo', hi') beyond them,
    nonzero only where its windows pass a global end, so that the conv of
    that slab with those pads gives exactly its outputs."""
    total = sum(sizes)
    out_total = (total + lo + hi - k) // s + 1
    starts = [a for a, _ in runs(sizes)]
    o0 = [0] + [min(-(-a // s), out_total) for a in starts[1:]]
    o1 = o0[1:] + [out_total]
    need, pads = [], []
    for r, (a, b) in enumerate(zip(o0, o1)):
        if b <= a:
            raise ShardPlanError(
                f"{what}: kernel {k}, stride {s}, pads ({lo}, {hi}) over "
                f"input runs {tuple(sizes)} (extent {total}) leaves rank "
                f"{r} no output rows of {out_total}")
        i0, i1 = a * s - lo, (b - 1) * s - lo + k
        need.append((max(i0, 0), min(i1, total)))
        pads.append((max(0, -i0), max(0, i1 - total)))
    return need, pads, tuple(b - a for a, b in zip(o0, o1))


def halo_widths(sizes: Sequence[int], k: int, s: int, lo: int,
                hi: int) -> List[Range]:
    """The rows each rank reads beyond its own run, below and above it,
    for the conv of :func:`window_plan` (0 at a global end, where the
    rank pads instead)."""
    need, _, _ = window_plan(sizes, k, s, lo, hi)
    return [(max(0, a - i0), max(0, i1 - b))
            for (a, b), (i0, i1) in zip(runs(sizes), need)]


class Comm:
    """One rank's transport over the default process group: the
    point-to-point messages of a redistribution, an all-gather and an
    all-reduce (MAX), with counts of each (``counts``).  Under gloo a CUDA
    tensor's point-to-point message goes through pinned host memory."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.backend = backend
        #: gloo's send/recv read the tensor's pointer as host memory
        self.stage_p2p = backend == "gloo" and self.device.type == "cuda"
        self.counts: Dict[str, int] = {}
        self.reset()

    def reset(self) -> None:
        """Zero the counts: redistributions that sent or received
        (``exchanges``), messages sent and received and their bytes, the
        messages staged through host memory (``staged``: each send and
        each receive of a CUDA tensor under gloo), the bytes of the slabs
        joined from pieces (``slab_bytes``), all-gathers, all-reduces, and
        the host seconds spent in all of it (``seconds``, a float: on the
        card it includes waiting for the device before a staged copy)."""
        self.counts = dict.fromkeys(
            ("exchanges", "sent", "received", "bytes", "staged", "slab_bytes",
             "all_gathers", "all_reduces"), 0)
        self.counts["seconds"] = 0.0

    def redistribute(self, x: Optional[torch.Tensor], dim: int,
                     have: Sequence[Range], need: Sequence[Range],
                     like: Tuple[tuple, torch.dtype]) -> torch.Tensor:
        """Rows ``need[rank]`` of a tensor whose rank r holds rows
        ``have[r]`` along ``dim`` (``x``: this rank's, None where it holds
        none): every rank sends each other rank the rows of its own that
        the other needs, one message a pair, and receives the rest; the
        pieces are joined in row order.  ``like``: the tensor's shape (the
        ``dim`` entry ignored) and dtype, for the receive buffers."""
        me = self.rank
        shape, dtype = like
        sends, recvs, pieces = [], [], []
        for other in range(self.world):
            if other == me:
                continue
            a, b = max(need[other][0], have[me][0]), min(need[other][1],
                                                           have[me][1])
            if b > a:
                sends.append((x.narrow(dim, a - have[me][0], b - a), other))
        for src in range(self.world):
            a, b = max(need[me][0], have[src][0]), min(need[me][1],
                                                         have[src][1])
            if b <= a:
                continue
            if src == me:
                pieces.append(x.narrow(dim, a - have[me][0], b - a))
            else:
                piece_shape = list(shape)
                piece_shape[dim] = b - a
                pieces.append(None)
                recvs.append((len(pieces) - 1, tuple(piece_shape), src))
        if not pieces and not sends:
            raise ShardPlanError(f"rank {me} needs rows {need[me]} and "
                                 f"receives none")
        t0 = time.perf_counter()
        if sends or recvs:
            self.counts["exchanges"] += 1
            for i, got in self._p2p(sends, recvs, dtype):
                pieces[i] = got
        if len(pieces) > 1:
            out = torch.cat(pieces, dim)
            self.counts["slab_bytes"] += out.numel() * out.element_size()
        else:
            out = pieces[0] if pieces else None
        self.counts["seconds"] += time.perf_counter() - t0
        return out

    def _p2p(self, sends, recvs, dtype):
        """Post every send and receive, wait for all; yields (index, the
        received tensor on this rank's device) for each receive."""
        works, keep, out = [], [], []
        for t, dst in sends:
            t = t.contiguous()
            if self.stage_p2p:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t)
                self.counts["staged"] += 1
                t = host
            keep.append(t)
            works.append(dist.isend(t, dst))
            self.counts["sent"] += 1
            self.counts["bytes"] += t.numel() * t.element_size()
        for i, shape, src in recvs:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self.stage_p2p,
                              device="cpu" if self.stage_p2p else self.device)
            works.append(dist.irecv(buf, src))
            self.counts["received"] += 1
            self.counts["bytes"] += buf.numel() * buf.element_size()
            out.append((i, buf))
        for w in works:
            w.wait()
        for i, buf in out:
            if self.stage_p2p:
                self.counts["staged"] += 1
                buf = buf.to(self.device)
            yield i, buf

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all), stacked in rank order."""
        t0 = time.perf_counter()
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t)
        self.counts["all_gathers"] += 1
        self.counts["seconds"] += time.perf_counter() - t0
        return torch.stack(out)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks (a new tensor)."""
        t0 = time.perf_counter()
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        self.counts["all_reduces"] += 1
        self.counts["seconds"] += time.perf_counter() - t0
        return t


class ShardContext:
    """The sharding of one net call on this rank: the transport, the split
    axis of (B, T, H, W, C) (``dim``: 1 time, 2 height) and the runs of
    every tensor the call has made so far."""

    def __init__(self, comm: Comm, dim: int, x: torch.Tensor,
                 sizes: Sequence[int]):
        if dim not in (1, 2):
            raise ValueError(f"the split axis is T (1) or H (2), got {dim}")
        self.comm, self.dim = comm, dim
        self._layouts: Dict[tuple, Tuple[int, ...]] = {}
        self.register(x, sizes)

    @property
    def rank(self) -> int:
        return self.comm.rank

    def _key(self, t: torch.Tensor) -> tuple:
        return tuple(n for i, n in enumerate(t.shape[:-1]) if i != self.dim)

    def register(self, t: torch.Tensor, sizes: Sequence[int]) -> None:
        """Record the runs ``sizes`` of the net call's tensor ``t``."""
        sizes = tuple(int(n) for n in sizes)
        key = self._key(t)
        old = self._layouts.get(key)
        if old is not None and old != sizes:
            raise RuntimeError(
                f"two layouts of the split axis under one shape {key}: "
                f"{old} and {sizes}; the net changes the split axis without "
                f"changing the others")
        if t.shape[self.dim] != sizes[self.rank]:
            raise RuntimeError(f"rank {self.rank} holds {t.shape[self.dim]} "
                               f"rows, its run says {sizes[self.rank]}")
        self._layouts[key] = sizes

    def sizes(self, t: torch.Tensor) -> Tuple[int, ...]:
        """Every rank's run of the split axis of ``t``."""
        sizes = self._layouts.get(self._key(t))
        if sizes is None or sizes[self.rank] != t.shape[self.dim]:
            raise RuntimeError(f"no layout for a tensor of shape "
                               f"{tuple(t.shape)} in this net call")
        return sizes

    def extents(self, t: torch.Tensor) -> Tuple[int, int, int]:
        """The global (T, H, W) of the net call's tensor ``t``."""
        thw = list(t.shape[1:4])
        thw[self.dim - 1] = sum(self.sizes(t))
        return tuple(thw)

    def first(self, t: torch.Tensor) -> bool:
        """Whether this rank holds row 0 of ``t``'s split axis."""
        return runs(self.sizes(t))[self.rank][0] == 0

    def window(self, x: torch.Tensor, k: int, s: int, lo: int, hi: int):
        """The slab this rank convolves for a conv of kernel ``k``, stride
        ``s`` and global pads (``lo``, ``hi``) along the split axis: its
        rows with the halo rows of its neighbours (exchanged here), the
        pads it applies (0 on interior sides) and every rank's output
        runs."""
        sizes = self.sizes(x)
        need, pads, out = window_plan(sizes, k, s, lo, hi)
        have = runs(sizes)
        if need == have:
            return x, pads[self.rank], out
        slab = self.comm.redistribute(x, self.dim, have, need,
                                      (tuple(x.shape), x.dtype))
        return slab, pads[self.rank], out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole split axis of ``x`` on every rank."""
        sizes = self.sizes(x)
        full = [(0, sum(sizes))] * self.comm.world
        return self.comm.redistribute(x, self.dim, runs(sizes), full,
                                      (tuple(x.shape), x.dtype))

    def local(self, full: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
        """This rank's run of a tensor whose whole split axis it holds."""
        a, b = runs(sizes)[self.rank]
        return full.narrow(self.dim, a, b - a).contiguous()

    def gather_moments(self, moments: torch.Tensor) -> torch.Tensor:
        return self.comm.all_gather(moments)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_max(t)


_local = threading.local()


def current() -> Optional[ShardContext]:
    """The shard context of the net call running in this thread, or
    None."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def sharded(ctx: ShardContext):
    """Run the block's ops under ``ctx`` (this thread only)."""
    prev = current()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev

