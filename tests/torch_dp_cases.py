"""Shared cases of the data-parallel tests (``tests/test_torch_data_parallel
*.py``): tiny SD3 training engines on the CPU, and ranks run as torchrun
runs them -- one spawned process a rank, each in a gloo group of its own
(a ``file://`` rendezvous under the test's temporary directory) running
the same function -- whose results come back to the test.

Nothing here imports JAX: the ranks import this module.
"""

import datetime
import multiprocessing
import os
import pickle
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from cvvae_tpu_torch.losses.vae_loss import LossConfig
from cvvae_tpu_torch.models.discriminator import Disc3DConfig
from cvvae_tpu_torch.models.vae2d import VAE2DConfig
from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.parallel import data as dp
from cvvae_tpu_torch.training import optim
from cvvae_tpu_torch.training.engine import (EngineConfig, TrainingEngine,
                                             named_params)
from cvvae_tpu_torch.training.trainer import Trainer, step_generator

#: the gloo group's timeout in the ranks: a rank whose peer is stuck
#: fails after it
GROUP_TIMEOUT_S = 120
#: tests/test_parallel.py's DP tolerances: loss/total (and here every
#: metric) relative, parameters after a step
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
TINY2D = VAE2DConfig(naming="sd3", latent_channels=4,
                     block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                     norm_num_groups=4)


def tiny_config(constraint="latent", compute_dtype="float32", loss=None,
                grad_clip=1.0):
    return EngineConfig(
        family="sd3",
        net=VAESD3Config(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                         latent_channels=4, norm_num_groups=4),
        disc=Disc3DConfig(ndf=8, n_layers=2, norm_groups=4),
        loss=LossConfig(perceptual_weight=0.0, **(loss or {})),
        optim=optim.OptimConfig(base_lr=1e-3, num_warmup_steps=0,
                                num_training_steps=100, grad_clip=grad_clip),
        constraint=constraint, constraint_decoder=TINY2D,
        constraint_encoder=TINY2D, remat=False, compute_dtype=compute_dtype)


def engine(**kw) -> TrainingEngine:
    return TrainingEngine(tiny_config(**kw), device="cpu")


def clip(shape, seed=1):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def snapshot(state):
    """The parameters of both nets, copied to plain tensors."""
    return {which: {k: v.detach().clone() for k, v in
                    named_params(getattr(state, which)).items()}
            for which in ("params", "disc_params")}


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank_main(results, init, world, rank, target, args):
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        # pickled here: a queue would pass tensors through shared memory
        # that dies with this process
        results.put((rank, "ok", pickle.dumps(target(rank, world, *args))))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(n, tmp_dir, target, *args, timeout=420, errors=False):
    """``target(rank, world, *args)`` in ``n`` spawned processes of one gloo
    group; their results in rank order.  Any rank's error raises here,
    unless ``errors``: then each rank's ("ok" | "error", result or
    traceback)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{os.path.join(str(tmp_dir), f'rendezvous-{time.time_ns()}')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(results, init, n, r, target, args))
             for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                rank, kind, value = results.get(timeout=1.0)
                got[rank] = (kind, value)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(n)) - set(got))}"
                                       f" gave no result in {timeout}s")
                if any(not p.is_alive() and p.exitcode and r not in got
                       for r, p in enumerate(procs)):
                    time.sleep(2.0)  # a last result may still be in flight
                    while not results.empty():
                        rank, kind, value = results.get()
                        got[rank] = (kind, value)
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in got]
                    if dead:
                        raise RuntimeError(f"ranks died with no result: "
                                           f"(rank, exit code) {dead}")
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
    out = [(k, pickle.loads(v) if k == "ok" else v)
           for k, v in (got[r] for r in range(n))]
    if errors:
        return out
    bad = [(r, v) for r, (k, v) in enumerate(out) if k != "ok"]
    if bad:
        raise RuntimeError("\n".join(f"rank {r}:\n{v}" for r, v in bad))
    return [v for _, v in out]


def mesh():
    return dp.process_mesh("cpu")


def dp_steps(rank, world, case):
    """``case["steps"]`` data-parallel steps of ``engine(**case["engine"])``
    from its seeded init, each with the trainer's step generator: this
    rank's rows of the global clip ``case["shape"]`` (or, with
    ``case["shapes"]``, a clip of its own shape).  For each step: the
    state dict it started from, and after it the metrics, the state's
    digest (checked equal across ranks), the global gradient norm, the
    step's collective counts, the parameters and (with ``keep_grads``) the
    reduced gradients."""
    m = mesh()
    eng = engine(**case["engine"])
    eng.keep_grads = case.get("keep_grads", False)
    st = dp.put_replicated(eng.init_state(0), m)
    step = dp.shard_parallel_step(eng, m)
    if "shapes" in case:
        batch = {"frames": torch.from_numpy(clip(case["shapes"][rank],
                                                 seed=10 + rank))}
    else:
        batch = dp.put_batch({"frames": clip(case["shape"])}, m)
    out = []
    for k in range(case["steps"]):
        start = _cpu(st.state_dict())
        st, metrics = step(st, batch, step_generator(eng.device, 0, k))
        out.append({
            "start": start,
            "metrics": {n: float(v) for n, v in metrics.items()},
            "digest": dp.check_replicated(st, m),
            "grad_norm": float(eng.last_grad_norm),
            "counts": dict(step.sync.counts),
            "same_shapes": step.sync.same_shapes,
            "params": snapshot(st),
            "grads": (None if eng.last_grads is None else
                      {n: g.clone() for n, g in eng.last_grads.items()})})
    return out


def dp_many(rank, world, cases):
    """``dp_steps`` of each case of ``cases`` (a dict), by name."""
    return {name: dp_steps(rank, world, case) for name, case in cases.items()}


def one_process_step(case, start, x=None):
    """A DP step's step in this process from the state dict it started
    from, on the concatenated batch (or ``x``), with the same generator:
    (metrics, parameters after)."""
    eng = engine(**case["engine"])
    st = eng.init_state(0).load_state_dict(start)
    frames = torch.from_numpy(clip(case["shape"]) if x is None else x)
    st, metrics = eng.train_step(st, {"frames": frames}, step_generator(
        eng.device, 0, st.step))
    return {n: float(v) for n, v in metrics.items()}, snapshot(st)


def check_step(got, ref_metrics, ref_params):
    """A DP step against the one process's: every metric within LOSS_RTOL
    (atol 1e-6), every parameter within PARAM_ATOL / PARAM_RTOL.  Returns
    the largest parameter error."""
    assert set(got["metrics"]) == set(ref_metrics)
    for k, r in ref_metrics.items():
        assert abs(got["metrics"][k] - r) <= LOSS_RTOL * abs(r) + 1e-6, \
            (k, got["metrics"][k], r)
    worst = 0.0
    for which, ref in ref_params.items():
        for k, r in ref.items():
            torch.testing.assert_close(got["params"][which][k], r,
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL)
            worst = max(worst, (got["params"][which][k] - r).abs().max()
                        .item())
    return worst


def from_states(rank, world, cfg, frozen, x, starts):
    """Data-parallel steps of a ``TrainingEngine(cfg)`` on the frozen nets'
    state dicts ``frozen``, each from a given state: for each (state dict,
    the global batch's draws) of ``starts``, this rank's rows of ``x`` and
    of the draws' "noise" ("offsets" shared).  Returns [(metrics, state
    dict after, digest)]."""
    m = mesh()
    eng = TrainingEngine(
        cfg, device="cpu", allow_random_lpips=True,
        lpips_params=frozen.get("lpips"),
        constraint_decoder_params=frozen.get("constraint_decoder"),
        constraint_encoder_params=frozen.get("constraint_encoder"))
    st = eng.init_state(0)
    step = dp.shard_parallel_step(eng, m)
    batch = dp.put_batch({"frames": x}, m)
    out = []
    for start, draws in starts:
        dp.put_replicated(st.load_state_dict(start), m)
        mine = dict(draws, noise=dp.put_batch(
            {"noise": draws["noise"]}, m)["noise"])
        st, metrics = step(st, batch, draws=mine)
        out.append(({n: float(v) for n, v in metrics.items()},
                    _cpu(st.state_dict()), dp.check_replicated(st, m)))
    return out


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    return obj


# ---------------------------------------------------------------------------
# the trainer and train.main on ranks
# ---------------------------------------------------------------------------

def data_iter(seed, fail_at=None):
    rng = np.random.RandomState(seed)
    i = 0
    while True:
        if i == fail_at:
            raise RuntimeError(f"data source failed at batch {i}")
        yield {"frames": rng.randn(1, 5, 16, 16, 3).astype(np.float32) * 0.3}
        i += 1


def fit_rank(rank, world, logdir, max_steps, resume=False, skip=0,
             fail_at=None, signal_at=None, trainer_kw=None):
    """``Trainer(mesh=...).fit`` on this rank's data (seeded by rank, its
    first ``skip`` batches dropped); rank r's logdir is ``logdir`` + r.
    ``fail_at``: {rank: the batch whose fetch raises there}; ``signal_at``:
    (rank, step) that sends itself SIGUSR1 after that step.  Returns the
    state's digest, its step, the step log, the ranks' validation of one
    batch each, what the rank's logdir holds and the parameters."""
    import signal
    m = mesh()
    eng = engine()
    it = data_iter(100 + rank, (fail_at or {}).get(rank))
    for _ in range(skip):
        next(it)

    def on_step(entry):
        if signal_at is not None and (rank, entry["step"]) == signal_at:
            os.kill(os.getpid(), signal.SIGUSR1)

    mine = f"{logdir}{rank}"
    trainer = Trainer(eng, mine, max_steps=max_steps, image_every=0,
                      mesh=m, step_callback=on_step, **(trainer_kw or {}))
    st = trainer.fit(it, resume=resume)
    val = trainer.validate(st, data_iter(200 + rank), st.step)
    return {"digest": dp.check_replicated(st, m), "step": st.step,
            "log": trainer.step_log, "val": val,
            "files": _files(mine), "params": snapshot(st)}


def fit_many(rank, world, runs):
    """``fit_rank`` with each keyword dict of ``runs`` in turn."""
    return [fit_rank(rank, world, **kw) for kw in runs]


def _files(root):
    if not os.path.exists(root):
        return None
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def train_main_rank(rank, world, argvs):
    """``train.main(argv)`` on this rank for each argv of ``argvs`` in
    turn: the state's digest (checked equal across ranks), the engine's
    base_lr, each step's (kind, shape, reduce counts), whether this rank
    wrote, the step and the parameters."""
    import warnings
    from cvvae_tpu_torch import train
    out = []
    for argv in argvs:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trainer, state = train.main(argv)
        out.append({
            "digest": dp.check_replicated(state, mesh()),
            "base_lr": trainer.engine.cfg.optim.base_lr,
            "log": [(e["kind"], e["shape"], e["reduce"])
                    for e in trainer.step_log],
            "step": state.step, "is_writer": trainer.is_writer,
            "params": snapshot(state)})
    return out

