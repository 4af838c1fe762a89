"""Device meshes for multi-device inference over ``torch.distributed``.

Port of ``cvvae_tpu/parallel/mesh.py`` (the inference half; the data-
parallel half is ``parallel/data.py``).  JAX drives a
mesh from one program; PyTorch runs one process a rank.  The port keeps
the one program: :func:`make_mesh`, called by that program (the
controller, rank 0), starts the n − 1 follower processes itself (the
``spawn`` method: the controller may already hold a CUDA context), forms
the process group with them and returns a :class:`Mesh`.  The followers
run :func:`follow`, a loop that takes its orders from the controller over
a pipe each: load a model, run a net over this rank's shard, report
counts, stop.  Tensors go over ``torch.distributed`` (``parallel/shard.py``
for the transport).  ``VideoVAE.with_mesh`` broadcasts the model once and
then sends every net call through :meth:`Mesh.run_net`: the input's
shards to the followers, the net on every rank under a shard context, the
output's shards back to the controller.  Tiling, chunking, streaming and
the server run unchanged on the controller.

``devices`` places the ranks (default ``cuda:0`` … ``cuda:n−1``; the tests
give ``cpu``); ``backend`` is the caller's choice and is never swapped:
NCCL refuses two ranks on one card ("Duplicate GPU detected",
``utils/probe_collectives.py``), so a one-card machine runs its ranks
over gloo.  A rank that cannot reach its device, a follower that dies and
a rank whose net call fails other than by a shard-plan error raise on the
controller, and the mesh is then closed: nothing falls back.

``batch_sharding``, ``shard_parallel_step``, ``put_batch`` and
``put_replicated`` belong to data-parallel training, which runs one
process a rank instead (every rank its own ``Trainer.fit``, no
controller): they live in ``parallel/data.py`` and are exported here
under the JAX package's names.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import importlib
import multiprocessing
import os
import socket
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cvvae_tpu_torch.parallel import shard

#: seconds a collective or a follower's reply may take before the mesh
#: gives up on it (a 720p full-width net call takes a few seconds a rank)
TIMEOUT_S = 600.0
#: seconds a follower may take to start, reach its device and join
START_TIMEOUT_S = 300.0


def multihost_init(backend: Optional[str] = None) -> None:
    """Join the process group that ``torchrun`` describes in the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as the JAX
    package's ``multihost_init`` joins the one COORDINATOR_ADDRESS names.
    A no-op outside such a launch or where the group exists."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and \
            not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method="env://")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which axis of a (B, T, H, W, C) tensor a mesh splits (``spec``, as
    JAX's PartitionSpec: the mesh axis name at the split position, None
    elsewhere; () replicated)."""
    mesh: "Mesh"
    spec: Tuple[Optional[str], ...] = ()

    @property
    def dim(self) -> Optional[int]:
        """The tensor axis that is split, or None (replicated)."""
        for i, a in enumerate(self.spec):
            if a is not None:
                return i
        return None


def replicated(mesh: "Mesh") -> Sharding:
    return Sharding(mesh, ())


def spatial_sharding(mesh: "Mesh", axis: str = "data") -> Sharding:
    """Split H of (B, T, H, W, C) over the mesh axis ``axis``."""
    return Sharding(mesh, (None, None, axis))


def temporal_sharding(mesh: "Mesh", axis: str = "data") -> Sharding:
    """Split T of (B, T, H, W, C) over the mesh axis ``axis``."""
    return Sharding(mesh, (None, axis))


#: this process's models on the mesh, by id: the controller's own models
#: (``Mesh.load``) or a follower's copies
_rank_models: Dict[int, Any] = {}


#: this process's transport on the mesh (the controller's or a
#: follower's), for its counts
_rank_comm: List[shard.Comm] = []


def rank_model(model_id: int):
    """This rank's copy of the mesh model ``model_id``."""
    return _rank_models[model_id]


def rank_counts() -> Dict[str, Any]:
    """This rank's kernel launch counters (``utils/profiling.COUNTERS``),
    K1's split entries' launches by shape ("K1 split by shape") and its
    transport's counts (``shard.Comm.reset``), by name."""
    from cvvae_tpu_torch.ops.kernels import groupnorm
    from cvvae_tpu_torch.utils import profiling
    out = dict(profiling.launch_counts())
    out["K1 split by shape"] = dict(groupnorm.split_launches_by_shape)
    for comm in _rank_comm[-1:]:
        out.update(comm.counts)
    return out


def reset_rank_counts() -> None:
    """Zero this rank's kernel launch counters and transport counts."""
    from cvvae_tpu_torch.ops.kernels import groupnorm
    from cvvae_tpu_torch.utils import profiling
    for key, (mod, attr) in profiling.COUNTERS.items():
        setattr(importlib.import_module(f"cvvae_tpu_torch.ops.kernels.{mod}"),
                attr, 0)
    groupnorm.split_launches_by_shape.clear()
    for comm in _rank_comm[-1:]:
        comm.reset()


def state_digest(model_id: int) -> List[Tuple[str, str, str]]:
    """(key, dtype, sha256 of the bytes) of each entry of this rank's copy
    of a mesh model's state: every rank's must equal the controller's
    (``Mesh.call("cvvae_tpu_torch.parallel.mesh:state_digest", id)``)."""
    out = []
    for k, v in rank_model(model_id).state_dict().items():
        raw = v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        out.append((k, str(v.dtype),
                    hashlib.sha256(raw.numpy().tobytes()).hexdigest()))
    return out


def _settings_modules():
    from cvvae_tpu_torch.ops import attention, conv, quant
    return {"quant": quant, "attention": attention, "conv": conv}


#: the module-level switches a net's dispatch reads: (module, attribute)
_SETTINGS = (("quant", "INT8_MIN_POSITIONS"),
             ("attention", "FLASH_MIN_TOKENS"), ("attention", "_flash_on"),
             ("conv", "TIME_SPLIT_ELEMENTS"))


def dispatch_settings() -> Dict[str, Any]:
    """The switches this process's ops dispatch on, sent with every net
    call so that every rank computes the same function: the int8, K4 and
    time-split thresholds, ``no_flash_attention``, cuDNN's and cuBLAS's
    TF32."""
    mods = _settings_modules()
    out = {f"{m}.{a}": getattr(mods[m], a) for m, a in _SETTINGS}
    out["cudnn.allow_tf32"] = torch.backends.cudnn.allow_tf32
    out["matmul.allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    return out


def apply_settings(settings: Dict[str, Any]) -> None:
    mods = _settings_modules()
    for m, a in _SETTINGS:
        setattr(mods[m], a, settings[f"{m}.{a}"])
    torch.backends.cudnn.allow_tf32 = settings["cudnn.allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul.allow_tf32"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reach(device: torch.device) -> None:
    """Raise unless this process can put a tensor on ``device``."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device}: no CUDA device in this process")
        torch.cuda.set_device(device)
    torch.zeros(1, device=device).add_(1).cpu()


def _comm_device(device: torch.device, backend: str) -> torch.device:
    """Where a bulk broadcast's buffer lives: NCCL takes CUDA tensors
    only, gloo is given host memory."""
    return device if backend == "nccl" else torch.device("cpu")


class Mesh:
    """A mesh of ``world`` ranks along one named axis, rank 0 this
    process.  ``shape`` maps each axis name to its size, as JAX's
    ``Mesh.shape``.  Close it (``close`` or ``with``) to stop the
    followers; they are daemon processes and die with the controller
    too."""

    def __init__(self, axis_names, axis_sizes, devices, backend, procs,
                 conns):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, axis_sizes))
        self.devices = [torch.device(d) for d in devices]
        self.backend = backend
        self.world = len(self.devices)
        self.comm = shard.Comm(0, self.world, self.devices[0], backend)
        _rank_comm.append(self.comm)
        self._procs, self._conns = procs, conns
        self._lock = threading.Lock()
        self._next_model = 0
        self.closed = False

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- the followers ----

    def _check_open(self):
        if self.closed:
            raise RuntimeError("the mesh is closed")
        dead = [(r + 1, p.exitcode) for r, p in enumerate(self._procs)
                if not p.is_alive()]
        if dead:
            self._fail()
            raise RuntimeError(f"mesh follower(s) died: (rank, exit code) "
                               f"{dead}; the mesh is closed")

    def _order(self, *msg):
        for c in self._conns:
            c.send(msg)

    def _replies(self, timeout: float = TIMEOUT_S) -> List[Any]:
        """One reply from each follower; raises on an error reply (closing
        the mesh unless it is a shard-plan error), a death or a timeout."""
        out, plan_errors = [], []
        for r, (c, p) in enumerate(zip(self._conns, self._procs), start=1):
            deadline = time.monotonic() + timeout
            while not c.poll(0.05):
                if not p.is_alive() or time.monotonic() > deadline:
                    what = (f"died (exit code {p.exitcode})"
                            if not p.is_alive()
                            else f"did not answer in {timeout}s")
                    self._fail()
                    raise RuntimeError(f"mesh follower rank {r} {what}; the "
                                       f"mesh is closed")
            try:
                kind, value = c.recv()
            except EOFError:
                self._fail()
                raise RuntimeError(f"mesh follower rank {r} closed its pipe; "
                                   f"the mesh is closed") from None
            if kind == "plan_error":
                plan_errors.append(value)
            elif kind == "error":
                self._fail()
                raise RuntimeError(f"mesh follower rank {r} failed; the mesh "
                                   f"is closed:\n{value}")
            out.append(value)
        if plan_errors:
            raise shard.ShardPlanError(plan_errors[0])
        return out

    def _fail(self):
        """Close the mesh after a failure: the collectives may be out of
        step, so the followers are killed, not asked to stop."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(10)
        self._shut()

    def _shut(self):
        if not self.closed:
            self.closed = True
            if dist.is_initialized():
                dist.destroy_process_group()

    def close(self) -> None:
        """Stop the followers and leave the process group."""
        with self._lock:
            if self.closed:
                return
            try:
                self._order("stop")
            except (BrokenPipeError, OSError):
                pass
            for p in self._procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join(10)
            self._shut()

    def call(self, fn: str, *args) -> List[Any]:
        """``fn`` ("module:attribute", importable on every rank) called
        with ``args`` on every rank, the followers' calls ordered before
        the controller's runs; each rank's result, in rank order."""
        mod, attr = fn.split(":")
        with self._lock:
            self._check_open()
            self._order("call", fn, args)
            mine = getattr(importlib.import_module(mod), attr)(*args)
            return [mine] + self._replies()

    # ---- models and net calls ----

    def load(self, vae) -> int:
        """Send ``vae``'s config and its whole state (int8 weights and
        calibrated scales included) to every follower, which builds its
        copy on its device; returns the model's id on the mesh."""
        state = vae.state_dict()
        entries = [(k, tuple(v.shape), v.dtype, v.numel() * v.element_size())
                   for k, v in state.items()]
        with self._lock:
            self._check_open()
            model_id = self._next_model
            self._next_model += 1
            _rank_models[model_id] = vae
            nbytes = sum(e[3] for e in entries)
            self._order("load", model_id, vae.config, entries, nbytes)
            flat = torch.cat([v.detach().reshape(-1).contiguous().cpu()
                              .view(torch.uint8) for v in state.values()])
            try:
                dist.broadcast(flat.to(_comm_device(self.device,
                                                    self.backend)), src=0)
            except RuntimeError:
                self._fail()
                raise
            self._replies()
        return model_id

    def run_net(self, model_id: int, net, name: str, x: torch.Tensor,
                dim: int, sizes: Sequence[int]) -> torch.Tensor:
        """``net`` (this process's copy of the model's ``name`` net) over
        the mesh: ``x`` split along ``dim`` into runs ``sizes``, one a
        rank, every rank running the net on its run under a shard context,
        the output's runs joined on this rank."""
        with self._lock:
            self._check_open()
            have = [(0, x.shape[dim])] + [(0, 0)] * (self.world - 1)
            need = shard.runs(sizes)
            self._order("net", model_id, name, tuple(x.shape), x.dtype, dim,
                        tuple(sizes), dispatch_settings())
            try:
                mine = self.comm.redistribute(x, dim, have, need,
                                              (tuple(x.shape), x.dtype))
                y = _run_local(self.comm, net, mine, dim, sizes)
            except shard.ShardPlanError:
                self._replies()
                raise
            except BaseException:
                self._fail()
                raise
            self._replies()
            return y


def _run_local(comm: shard.Comm, net, x: torch.Tensor, dim: int,
               sizes: Sequence[int]) -> Optional[torch.Tensor]:
    """Run ``net`` on this rank's run ``x`` under a shard context and
    bring the output's runs to rank 0: rank 0 gets the whole output,
    the others None."""
    ctx = shard.ShardContext(comm, dim, x, sizes)
    with torch.inference_mode(), shard.sharded(ctx):
        y = net(x)
        out_sizes = ctx.sizes(y)
    have = shard.runs(out_sizes)
    total = have[-1][1]
    need = [(0, total)] + [have[r] for r in range(1, comm.world)]
    y = comm.redistribute(y, dim, have, need, (tuple(y.shape), y.dtype))
    return y if comm.rank == 0 else None


def _build_like(config, entries, flat: torch.Tensor, device: torch.device):
    """A VideoVAE of ``config`` holding the broadcast state: built on the
    meta device, each conv that the state gives ``weight_q`` quantized the
    same way (with ``scale_x`` where it has one), loaded strictly."""
    from cvvae_tpu_torch.models.video_vae import VideoVAE

    state, off = {}, 0
    for key, shape, dtype, nb in entries:
        state[key] = flat[off:off + nb].clone().view(dtype).reshape(shape)
        off += nb
    with torch.device("meta"):
        vae = VideoVAE(config)
    for key in state:
        if key.endswith(".weight_q"):
            m = vae.get_submodule(key[:-len(".weight_q")])
            del m.weight
            for name in ("weight_q", "scale_w", "scale_x"):
                k = key[:-len("weight_q")] + name
                if k in state:
                    m.register_buffer(name, torch.empty_like(
                        state[k], device="meta"))
    vae.load_state_dict(state, strict=True, assign=True)
    return vae.to(device).eval().requires_grad_(False)


def follow(conn, rank: int, world: int, device: torch.device,
           backend: str) -> None:
    """A follower's loop: take orders from the controller's pipe until it
    says stop or closes.  A net call's shard-plan error is reported and
    the loop goes on (every rank raised it at the same op); any other
    error is reported and ends the process, so the controller's
    collectives fail instead of waiting."""
    comm = shard.Comm(rank, world, device, backend)
    _rank_comm.append(comm)
    models = _rank_models
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        kind = msg[0]
        if kind == "stop":
            return
        try:
            if kind == "load":
                _, model_id, config, entries, nbytes = msg
                flat = torch.empty(nbytes, dtype=torch.uint8,
                                   device=_comm_device(device, backend))
                dist.broadcast(flat, src=0)
                models[model_id] = _build_like(config, entries, flat.cpu(),
                                               device)
                conn.send(("ok", None))
            elif kind == "net":
                _, model_id, name, shape, dtype, dim, sizes, settings = msg
                apply_settings(settings)
                have = [(0, shape[dim])] + [(0, 0)] * (world - 1)
                x = comm.redistribute(None, dim, have, shard.runs(sizes),
                                      (shape, dtype))
                _run_local(comm, getattr(models[model_id], name), x, dim,
                           sizes)
                conn.send(("ok", None))
            elif kind == "call":
                _, fn, args = msg
                mod, attr = fn.split(":")
                conn.send(("ok", getattr(importlib.import_module(mod),
                                         attr)(*args)))
            else:
                raise ValueError(f"unknown order {kind!r}")
        except shard.ShardPlanError as e:
            conn.send(("plan_error", str(e)))
        except BaseException:
            conn.send(("error", traceback.format_exc()))
            raise


def _follower_main(conn, init_method: str, world: int, rank: int,
                   device: str, backend: str, threads: int) -> None:
    device = torch.device(device)
    if device.type == "cpu" and threads > 0:
        torch.set_num_threads(threads)
    try:
        _reach(device)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        return
    conn.send(("ok", None))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        follow(conn, rank, world, device, backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None, *,
              devices: Optional[Sequence[Any]] = None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None) -> Mesh:
    """A mesh of ``n_devices`` ranks: this process is rank 0 on
    ``devices[0]``; ranks 1 … n−1 are follower processes started here on
    the others.  ``devices`` defaults to ``cuda:0`` … ``cuda:n−1`` (n
    defaulting to the visible cards), ``backend`` to NCCL on CUDA devices
    and gloo on CPU ones; ``init_method`` to a free ``tcp://localhost``
    port (a ``file://`` path keeps concurrent test runs apart).  One mesh
    a process: the process group is the default one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices="
                               "['cpu'] * n for a mesh of CPU processes")
        n = torch.cuda.device_count() if n_devices is None else n_devices
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None and len(devices) != n_devices:
        raise ValueError(f"make_mesh: {n_devices} devices asked, "
                         f"{len(devices)} given")
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if len(axis_sizes) != len(axis_names) or \
            int(torch.tensor(list(axis_sizes)).prod()) != n:
        raise ValueError(f"make_mesh: axis sizes {tuple(axis_sizes)} for "
                         f"{n} devices")
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    if dist.is_initialized():
        raise RuntimeError("make_mesh: this process is already in a process "
                           "group (one mesh a process; close the other)")
    _reach(devices[0])
    init_method = init_method or f"tcp://localhost:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    threads = max(1, torch.get_num_threads() // n)
    procs, conns = [], []
    for rank in range(1, n):
        mine, theirs = ctx.Pipe()
        p = ctx.Process(target=_follower_main, daemon=True, args=(
            theirs, init_method, n, rank, str(devices[rank]), backend,
            threads))
        p.start()
        theirs.close()
        procs.append(p)
        conns.append(mine)
    mesh = Mesh(axis_names, axis_sizes, devices, backend, procs, conns)
    try:
        mesh._replies(START_TIMEOUT_S)   # every follower reached its device
    except RuntimeError as e:
        raise RuntimeError(f"make_mesh: a follower did not start or "
                           f"cannot reach its device: {e}") from None
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=0, timeout=datetime.timedelta(
                                seconds=TIMEOUT_S))
    return mesh


# the data-parallel half of the JAX package's mesh.py, under its names
from cvvae_tpu_torch.parallel.data import (  # noqa: E402,F401
    batch_sharding, put_batch, put_replicated, shard_parallel_step)
