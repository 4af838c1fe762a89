"""Data-parallel training over ``torch.distributed``.

Port of the data-parallel half of ``cvvae_tpu/parallel/mesh.py``
(``batch_sharding``, ``shard_parallel_step``, ``put_batch``,
``put_replicated``).  The JAX package jits the whole step over a mesh: the
state and the rng replicated, the batch split on axis 0, so a DP step is
the full-batch step by construction.  PyTorch runs one process a rank
(torchrun, or a caller that forms the default process group itself), each
holding only its own shard of the batch, and every coupling between the
shards is written out here:

* the gradients: the mean over ranks of each rank's gradient of its own
  mean loss, reduced between the backward and the update in fp32 flat
  buckets in parameter order (one ``all_reduce`` SUM a bucket, then one
  division by the world size), so every rank holds the same bits.  Every
  loss term is a mean over samples, so with equal shards this is the
  gradient of the global batch;
* the adaptive discriminator weight: its two gradients at the decoder's
  last conv weight are reduced as means before their norms, as the JAX
  package takes them of the global losses;
* the draws: where every rank's batch has one shape, each rank draws the
  global batch's posterior noise from the step's generator and keeps its
  own rows (with an encoder constraint the moments are [3D rows; 2D
  rows], and a rank's rows come from both halves); the constraint frames'
  offsets, drawn next from the same generator, are the same on every rank.
  A DP step then draws what one process draws on the concatenated batch.
  Where the shapes differ (the shipped recipe's mixer is seeded by rank),
  each rank draws from a generator keyed by (the step's seed, rank);
* the metrics: one ``all_reduce`` of the stacked scalars, then the mean.

The clip, AdamW and the EMA then run on the reduced gradients identically
on every rank.  ``put_replicated`` broadcasts rank 0's state and checks
the ranks' digests.  Collectives take the tensors where they are: CUDA
tensors go to gloo as they go to NCCL (gloo stages them itself).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the largest bucket of a reduce or a broadcast, in bytes (DDP's default
#: ``bucket_cap_mb``)
BUCKET_BYTES = 25 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's place in the default process group, seen as a data
    mesh of one axis: ``world`` ranks, one a process, this one ``rank`` on
    ``device``."""
    rank: int
    world: int
    device: torch.device
    backend: str


def process_mesh(device=None) -> ProcessMesh:
    """The default process group as a data mesh, this rank on ``device``
    (default ``cuda:{LOCAL_RANK}``).  The group is formed first, by
    ``multihost_init`` under torchrun or by the caller."""
    if not dist.is_initialized():
        raise RuntimeError("process_mesh: no process group; call "
                           "multihost_init() under torchrun, or "
                           "torch.distributed.init_process_group first")
    if device is None:
        device = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"process_mesh: {device}: no CUDA device; pass "
                           f"device='cpu' for a CPU rank")
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"process_mesh: NCCL needs a CUDA device, not "
                         f"{device}")
    return ProcessMesh(dist.get_rank(), dist.get_world_size(), device,
                       backend)


def batch_sharding(mesh: ProcessMesh, axis: str = "data"):
    """Axis 0 (the batch) split over the mesh axis ``axis``."""
    from cvvae_tpu_torch.parallel.mesh import Sharding
    return Sharding(mesh, (axis,))


def put_batch(batch: Dict, mesh: ProcessMesh, axis: str = "data") -> Dict:
    """This rank's rows of a global batch, on its device: of each array or
    tensor with B rows, rows [rank·B/world, (rank+1)·B/world).  Other
    entries pass as they are."""
    dim = batch_sharding(mesh, axis).dim
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        if v.shape[dim] % mesh.world:
            raise ValueError(f"put_batch: {k} has {v.shape[dim]} rows, not "
                             f"a multiple of the {mesh.world} ranks")
        n = v.shape[dim] // mesh.world
        out[k] = v.narrow(dim, mesh.rank * n, n).to(mesh.device)
    return out


# ---------------------------------------------------------------------------
# the replicated state
# ---------------------------------------------------------------------------

def _counters(state) -> List[int]:
    return [state.step, state.opt_g.count, state.opt_d.count,
            -1 if state.ema is None else state.ema.num_updates]


def _set_counters(state, values: Sequence[int]) -> None:
    state.step, state.opt_g.count, state.opt_d.count = values[:3]
    if state.ema is not None:
        state.ema.num_updates = values[3]


def _leaves(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


def _state_tensors(state) -> List[torch.Tensor]:
    """The state's tensors in a fixed order (``TrainState.state_dict``'s):
    the parameters and buffers of both nets, both optimizers' moments and
    the EMA's shadow.  Each shares its storage with the state."""
    return list(_leaves(state.state_dict()))


def train_state_digest(state) -> str:
    """sha256 of the state's counters and the bytes of every tensor."""
    h = hashlib.sha256(repr(_counters(state)).encode())
    for t in _state_tensors(state):
        h.update(str(t.dtype).encode())
        h.update(t.detach().contiguous().cpu().reshape(-1)
                 .view(torch.uint8).numpy())
    return h.hexdigest()


def check_replicated(state, mesh: ProcessMesh) -> str:
    """Raise unless every rank holds the same state (``train_state_digest``
    all-gathered); returns the digest."""
    digest = train_state_digest(state)
    every = [None] * mesh.world
    dist.all_gather_object(every, digest)
    if len(set(every)) != 1:
        raise RuntimeError(f"the ranks hold different states: digests by "
                           f"rank {every}")
    return digest


def _buckets(tensors: Sequence[torch.Tensor], cap: int = BUCKET_BYTES
             ) -> List[List[torch.Tensor]]:
    """Runs of consecutive tensors of one dtype, each run at most ``cap``
    bytes (a larger tensor alone)."""
    out, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not out or out[-1][-1].dtype != t.dtype or size + nbytes > cap:
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


def _flat(group: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(dtype or t.dtype)
                      for t in group])


def _views(flat: torch.Tensor, group: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """``flat`` cut into contiguous tensors of the group's shapes."""
    return [v.view(t.shape) for t, v in
            zip(group, flat.split([t.numel() for t in group]))]


def put_replicated(state, mesh: ProcessMesh):
    """Rank 0's state on every rank, in place: its step, optimizer counts
    and EMA count, then its tensors (parameters, discriminator, moments,
    EMA) broadcast in buckets; then ``check_replicated``.  Returns
    ``state``."""
    counters = torch.tensor(_counters(state), dtype=torch.int64,
                            device=mesh.device)
    dist.broadcast(counters, src=0)
    _set_counters(state, counters.tolist())
    for group in _buckets(_state_tensors(state)):
        flat = _flat(group)
        dist.broadcast(flat, src=0)
        with torch.no_grad():
            for t, v in zip(group, _views(flat, group)):
                t.copy_(v)
    check_replicated(state, mesh)
    return state


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """The generator of ``rank``'s draws in a step whose ranks' batches
    differ in shape: keyed by the step generator's seed and the rank."""
    seed = (generator.initial_seed() * 1_000_003 + rank + 1) % 2 ** 63
    return torch.Generator(device=generator.device).manual_seed(seed)


class ReplicaSync:
    """The collectives that keep the replicas of a data-parallel step in
    step (the engine's ``sync`` hooks), with the current step's
    ``counts``: collectives, bytes of their payloads, host seconds, and
    the gradient buckets and bytes among them.  With NCCL a collective
    returns once queued, so its host seconds are the queueing; gloo
    returns when it is done."""

    def __init__(self, mesh: ProcessMesh):
        self.mesh = mesh
        self.same_shapes = True
        self.reset()

    def reset(self) -> None:
        """Start a step's counts."""
        self.counts = {"collectives": 0, "bytes": 0, "seconds": 0.0,
                       "grad_buckets": 0, "grad_bytes": 0}

    def _run(self, tensor: torch.Tensor, fn, *args, **kw) -> None:
        """``fn(*args, **kw)``, a collective whose payload is ``tensor``,
        counted."""
        t0 = time.perf_counter()
        fn(*args, **kw)
        self.counts["seconds"] += time.perf_counter() - t0
        self.counts["collectives"] += 1
        self.counts["bytes"] += tensor.numel() * tensor.element_size()

    def begin(self, x: torch.Tensor, generator: Optional[torch.Generator]
              ) -> Optional[torch.Generator]:
        """Compare the ranks' batch shapes (one all-gather); returns the
        generator of this rank's draws: ``generator`` where the shapes
        agree, else ``rank_generator`` of it."""
        shape = torch.zeros(8, dtype=torch.int64, device=self.mesh.device)
        shape[:x.ndim] = torch.tensor(x.shape)
        every = [torch.empty_like(shape) for _ in range(self.mesh.world)]
        self._run(shape, dist.all_gather, every, shape)
        self.same_shapes = all(torch.equal(e, every[0]) for e in every)
        if self.same_shapes or generator is None:
            return generator
        return rank_generator(generator, self.mesh.rank)

    def noise(self, generator: Optional[torch.Generator],
              like: torch.Tensor, blocks: int) -> Optional[torch.Tensor]:
        """This rank's rows of the global posterior noise: ``like`` (the
        posterior's mean) is ``blocks`` runs of b rows; the global draw,
        one ``torch.randn`` of ``blocks`` runs of world·b rows, is the one
        process's on the concatenated batch, and this rank keeps rows
        [rank·b, (rank+1)·b) of each run.  None where the ranks' shapes
        differ or there is no generator (the caller draws its own)."""
        if not self.same_shapes or generator is None:
            return None
        world, rest = self.mesh.world, tuple(like.shape[1:])
        b = like.shape[0] // blocks
        full = torch.randn((blocks * world * b,) + rest, generator=generator,
                           device=like.device, dtype=like.dtype)
        return full.view((blocks, world, b) + rest)[:, self.mesh.rank] \
            .reshape(like.shape)

    def mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's mean over ranks: fp32 flat buckets in the given
        order, one all_reduce SUM a bucket, one division by the world
        size.  The means are contiguous fp32 views of the buckets, so that
        every rank holds them in one layout (a gradient's layout follows
        the rank's batch shape, and a sum over it follows its layout)."""
        out = []
        for group in _buckets(tensors):
            flat = _flat(group, torch.float32)
            self._run(flat, dist.all_reduce, flat, op=dist.ReduceOp.SUM)
            flat.div_(self.mesh.world)
            out += _views(flat, group)
        return out

    def mean_grads(self, grads: Dict[str, torch.Tensor],
                   skip: Iterable[str] = ()) -> None:
        """A step's gradients (but those named in ``skip``) replaced in
        ``grads`` by their means, counted apart."""
        keys = [k for k in grads if k not in set(skip)]
        c = self.counts
        before = c["collectives"], c["bytes"]
        grads.update(zip(keys, self.mean([grads[k] for k in keys])))
        c["grad_buckets"] += c["collectives"] - before[0]
        c["grad_bytes"] += c["bytes"] - before[1]

    def mean_scalars(self, scalars: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The mean over ranks of each scalar (one all_reduce of the
        stacked values, in key order); 0-d fp32 tensors."""
        keys = sorted(scalars)
        stacked = torch.stack([torch.as_tensor(
            scalars[k], dtype=torch.float32, device=self.mesh.device)
            .reshape(()) for k in keys])
        self._run(stacked, dist.all_reduce, stacked,
                  op=dist.ReduceOp.SUM)
        stacked = stacked / self.mesh.world
        return dict(zip(keys, stacked.unbind()))

    def any(self, flag: bool) -> bool:
        """True on every rank where it is true on one (all_reduce MAX)."""
        t = torch.tensor([int(flag)], device=self.mesh.device)
        self._run(t, dist.all_reduce, t, op=dist.ReduceOp.MAX)
        return bool(t.item())


class ParallelStep:
    """``shard_parallel_step``'s step: ``(state, batch, generator=None,
    draws=None) -> (state, metrics)``, the engine's step with ``sync``'s
    collectives; ``sync.counts`` holds the last step's."""

    def __init__(self, engine, mesh: ProcessMesh):
        if engine.device != mesh.device:
            raise ValueError(f"the engine runs on {engine.device}, the "
                             f"mesh's rank on {mesh.device}")
        self.engine = engine
        self.sync = ReplicaSync(mesh)

    def __call__(self, state, batch, generator=None, draws=None):
        self.sync.reset()
        return self.engine.train_step(state, batch, generator, draws,
                                      sync=self.sync)


def shard_parallel_step(engine, mesh: ProcessMesh) -> ParallelStep:
    """The data-parallel step of ``engine`` over ``mesh``: each rank runs
    it on its own shard of the batch, from the replicated state, and every
    rank ends with the same state (the full-batch step's, where the shards
    are equal)."""
    return ParallelStep(engine, mesh)
