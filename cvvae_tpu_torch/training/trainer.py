"""Training loop: the Lightning-Trainer analogue (fit / validate).

Port of ``cvvae_tpu/training/trainer.py``: per-step optimisation with the
G/D alternation (in the engine), metric and LR logging, image panels at the
reference's cadence, rolling / permanent / best-k checkpoints, resume,
SIGUSR1 -> checkpoint ("melk") and a checkpoint on any exception.

Batches go to the card through ``data.pipeline.device_prefetch`` (pinned
memory, non-blocking copies one batch ahead).  Each step's draws come
from a generator seeded with (seed + 1, step), so a run resumed at step k
draws what an uninterrupted run would.  ``step_log`` keeps each step's
kind ("g" or "d"), batch shape and wall seconds; on the card a step is
timed to its end (``torch.cuda.synchronize``).

With ``mesh`` (``parallel.process_mesh()``, as the JAX package's
``Trainer(mesh=)``) every rank runs ``fit`` on its own shard of the data:
the step is ``shard_parallel_step``'s, the state starts replicated
(``put_replicated``: rank 0's, after its resume), rank 0 alone writes
metrics, panels and checkpoints (its loggers' and manager's ``writer``),
the SIGUSR1 flag is agreed each step (all_reduce MAX), ``validate``
averages the ranks' own validation batches and ``validate_tiled`` runs on
rank 0.  A step's log entry has its collectives' counts (``reduce``).  A
rank that fails leaves its peers' collectives to fail in turn (at once
under gloo, whose peer is gone; at the group's timeout at the latest), and
rank 0 checkpoints on the way out as in one process.
"""

from __future__ import annotations

import contextlib
import signal
import time
from typing import Callable, Iterator, Optional

import torch

from cvvae_tpu_torch.training.checkpoint import CheckpointManager
from cvvae_tpu_torch.training.engine import (TrainingEngine, TrainState,
                                             ema_scope)
from cvvae_tpu_torch.training.logging import ImageLogger, MetricsLogger


def step_generator(device: torch.device, seed: int,
                   step: int) -> torch.Generator:
    """The generator of step ``step``'s draws."""
    return torch.Generator(device=device).manual_seed(
        (seed + 1) * 1_000_003 + step)


class Trainer:
    def __init__(self, engine: TrainingEngine, logdir: str, *,
                 max_steps: int = 200_000,
                 ckpt_every: int = 2000, ckpt_keep: int = 3,
                 permanent_every: int = 10_000,
                 log_every: int = 1, image_every: int = 250,
                 val_every: Optional[int] = None, mesh=None, seed: int = 0,
                 step_callback: Optional[Callable[[dict], None]] = None):
        self.engine = engine
        self.logdir = logdir
        self.max_steps = max_steps
        self._mesh = mesh
        if mesh is not None:
            from cvvae_tpu_torch.parallel.data import shard_parallel_step
            self._step_fn = shard_parallel_step(engine, mesh)
            self._replicas = self._step_fn.sync
        else:
            self._step_fn, self._replicas = engine.train_step, None
        #: rank 0 (or the one process) writes the logs and checkpoints
        self.is_writer = mesh is None or mesh.rank == 0
        self.metrics = MetricsLogger(logdir, writer=self.is_writer)
        self.images = ImageLogger(logdir, every=image_every,
                                  writer=self.is_writer)
        self.ckpt = CheckpointManager(logdir, rolling_every=ckpt_every,
                                      keep=ckpt_keep,
                                      permanent_every=permanent_every,
                                      writer=self.is_writer)
        self.val_every = val_every
        self.log_every = log_every
        self.seed = seed
        #: called after each step with its ``step_log`` entry
        self.step_callback = step_callback
        self.step_log = []
        # the APPLIED LR: the schedules the engine injects, at the global
        # step
        self._lr_schedule = engine.lr_schedule_g

    def _sync(self):
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def fit(self, data: Iterator, *, state: Optional[TrainState] = None,
            resume: bool = False,
            val_data: Optional[Iterator] = None) -> TrainState:
        from cvvae_tpu_torch.data.pipeline import device_prefetch
        engine = self.engine
        if state is None:
            state = engine.init_state(self.seed)
        if resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
            print(f"[trainer] resumed at step {state.step}")
        if self._mesh is not None:
            from cvvae_tpu_torch.parallel.data import put_replicated
            put_replicated(state, self._mesh)
        data = device_prefetch(data, engine.device)
        melk_requested = {"flag": False}

        def _melk(signum, frame):  # SIGUSR1 -> checkpoint
            melk_requested["flag"] = True

        try:
            previous = signal.signal(signal.SIGUSR1, _melk)
        except (ValueError, OSError):
            previous = None  # not the main thread
        step = state.step
        try:
            while step < self.max_steps:
                batch = next(data)
                batch = {k: v for k, v in batch.items()
                         if isinstance(v, torch.Tensor)}
                kind = "g" if engine.is_g_step(step) else "d"
                self._sync()
                t0 = time.perf_counter()
                state, metrics = self._step_fn(
                    state, batch, step_generator(engine.device, self.seed,
                                                 step))
                self._sync()
                entry = {"step": step, "kind": kind,
                         "shape": tuple(batch["frames"].shape),
                         "seconds": time.perf_counter() - t0,
                         "metrics": {k: float(v) for k, v in metrics.items()}}
                if self._replicas is not None:
                    entry["reduce"] = dict(self._replicas.counts)
                self.step_log.append(entry)
                if self.step_callback is not None:
                    self.step_callback(entry)
                step = state.step
                if self.log_every and step % self.log_every == 0:
                    self.metrics.log(step, {f"train/{k}": v for k, v in
                                            entry["metrics"].items()},
                                     lr=self._lr_schedule(step))
                if self.images.due(step):
                    self._log_images(state, batch["frames"], step)
                self.ckpt.maybe_save(step, state, metrics={
                    f"train/{k}": v for k, v in entry["metrics"].items()})
                if self._replicas is not None:  # one rank's signal is all's
                    melk_requested["flag"] = self._replicas.any(
                        melk_requested["flag"])
                if melk_requested["flag"]:
                    self.ckpt.save_now(step, state)
                    melk_requested["flag"] = False
                if val_data is not None and self.val_every and \
                        step % self.val_every == 0:
                    self.validate(state, val_data, step)
        except BaseException:
            self.ckpt.save_now(step, state)  # checkpoint, then re-raise
            raise
        finally:
            if previous is not None:
                signal.signal(signal.SIGUSR1, previous)
        self.ckpt.close()
        return state

    @torch.no_grad()
    def _log_images(self, state: TrainState, x: torch.Tensor, step: int):
        """An extra forward for the reconstruction panels, with the patch
        discriminator's logit maps."""
        engine = self.engine
        _, _, _, xrec, _ = engine._forward(
            state.params, x, generator=step_generator(engine.device,
                                                      self.seed, step))
        xrec = xrec[:x.shape[0]]
        self.images.log(step, x.float().cpu().numpy(),
                        xrec.float().cpu().numpy(),
                        logits_real=state.disc_params(x).float().cpu().numpy(),
                        logits_fake=state.disc_params(xrec).float().cpu()
                        .numpy())

    def validate(self, state: TrainState, val_data: Iterator, step: int,
                 n_batches: int = 1, split: str = "val") -> dict:
        """The full validation dict (``engine.val_step``) on ``n_batches``
        batches, with the raw weights and, with an EMA, the shadow weights
        under a ``_ema`` postfix; image panels of the first batch."""
        engine = self.engine
        passes = [("", None)]
        if state.ema is not None:
            passes.append(("_ema", state.ema))
        out = {}
        for tag, ema in passes:
            sums, count = {}, 0
            scope = (ema_scope(state.params, ema) if ema is not None
                     else contextlib.nullcontext())
            with scope:
                for i in range(n_batches):
                    x = torch.as_tensor(next(val_data)["frames"]).to(
                        engine.device)
                    metrics, xrec = engine.val_step(
                        state.params, state.disc_params, {"frames": x},
                        state.step, generator=step_generator(
                            engine.device, self.seed, i))
                    for k, v in metrics.items():
                        sums[k] = sums.get(k, 0.0) + float(v)
                    count += 1
                    if i == 0:
                        self.images.log(step, x.float().cpu().numpy(),
                                        xrec[:x.shape[0]].float().cpu()
                                        .numpy(), split=f"{split}{tag}")
            out.update({f"{split}{tag}/{k}": v / count
                        for k, v in sums.items()})
        if self._replicas is not None:  # the mean of the ranks' means
            out = {k: float(v) for k, v in
                   self._replicas.mean_scalars(out).items()}
        self.metrics.log(step, out)
        return out

    def test(self, state: TrainState, test_data: Iterator,
             n_batches: int = 8) -> dict:
        """The test split: the validation dict under ``test/`` keys."""
        return self.validate(state, test_data, state.step,
                             n_batches=n_batches, split="test")

    @torch.no_grad()
    def validate_tiled(self, state: TrainState, clips: Iterator, step: int,
                       n_clips: int = 1, tile_spatial_size: int = 576,
                       tile_overlap_ratio: float = 0.2222,
                       split: str = "val_tiled") -> dict:
        """Full-resolution evaluation through the serving path (temporal
        chunking and spatial tiles): PSNR, SSIM and L1.  Rank 0's alone in
        data-parallel training (the others return {})."""
        if not self.is_writer:
            return {}
        from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
        from cvvae_tpu_torch.utils.metrics import reconstruction_report
        cfg = self.engine.cfg
        vae = VideoVAE(VideoVAEConfig(
            family=cfg.family, net=cfg.net,
            tile_spatial_size=tile_spatial_size,
            tile_overlap_ratio=tile_overlap_ratio)).to(self.engine.device)
        vae.encoder.load_state_dict(state.params.encoder.state_dict())
        vae.decoder.load_state_dict(state.params.decoder.state_dict())
        vae.eval()
        sums, count = {}, 0
        for i in range(n_clips):
            x = torch.as_tensor(next(clips)["frames"]).to(self.engine.device)
            xrec = vae.reconstruct(x)
            for k, v in reconstruction_report(x, xrec).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
            if i == 0:
                self.images.log(step, x.float().cpu().numpy(),
                                xrec.float().cpu().numpy(), split=split)
        out = {f"{split}/{k}": v / count for k, v in sums.items()}
        self.metrics.log(step, out)
        return out
