"""Checkpointing with the reference's cadences, to ``torch.save`` files.

Port of ``cvvae_tpu/training/checkpoint.py`` (orbax there): the whole
training state (``TrainState.state_dict()``: step, generator and
discriminator parameters, both optimizers' moments and counts, the EMA)
goes to one file a checkpoint, with

* ``rolling/``: every ``rolling_every`` steps, the last ``keep`` kept
  (the reference's save_last);
* ``best/``: at the same cadence, the ``best_k`` lowest values of the
  monitored metric (``train/loss/rec``);
* ``permanent/``: weights only (``params``), every ``permanent_every``
  steps, all kept.

A file is written to a temporary name and renamed, so a cut run leaves no
half-written checkpoint.  Random draws need no saved state: the trainer
seeds each step's generator from the step.  In data-parallel training
only rank 0's manager is the ``writer``: the others write nothing and
find no checkpoint to resume from, since their state comes from rank 0's
broadcast.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"step_(\d+)\.pt$")


def _steps(directory: str):
    return sorted(int(_NAME.search(p).group(1))
                  for p in glob.glob(os.path.join(directory, "step_*.pt")))


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def _save(directory: str, step: int, obj: Dict[str, Any]) -> str:
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


class CheckpointManager:
    def __init__(self, directory: str, *, rolling_every: int = 2000,
                 keep: int = 3, permanent_every: int = 10000,
                 monitor: Optional[str] = "train/loss/rec",
                 best_k: int = 3, writer: bool = True):
        self.writer = writer
        self.directory = os.path.abspath(directory)
        self.rolling = os.path.join(self.directory, "rolling")
        self.best = os.path.join(self.directory, "best")
        self.permanent = os.path.join(self.directory, "permanent")
        self.rolling_every = rolling_every
        self.keep = keep
        self.permanent_every = permanent_every
        self.monitor = monitor
        self.best_k = best_k

    def _prune(self, directory: str, keep: int) -> None:
        for step in _steps(directory)[:-keep] if keep else []:
            os.remove(_path(directory, step))

    def maybe_save(self, step: int, state, metrics: Optional[dict] = None
                   ) -> None:
        if not self.writer:
            return
        if self.rolling_every and step % self.rolling_every == 0:
            blob = _to_cpu(state.state_dict())
            _save(self.rolling, step, blob)
            self._prune(self.rolling, self.keep)
            if (self.monitor and self.best_k and metrics is not None
                    and self.monitor in metrics):
                self._save_best(step, blob, float(metrics[self.monitor]))
        if self.permanent_every and step and step % self.permanent_every == 0:
            _save(self.permanent, step,
                  {"step": step, "params": _to_cpu(state.params.state_dict())})

    def _save_best(self, step: int, blob: dict, value: float) -> None:
        index_path = os.path.join(self.best, "index.json")
        index = {}
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = {int(k): v for k, v in json.load(f).items()}
        index[step] = value
        kept = sorted(index, key=lambda s: (index[s], s))[:self.best_k]
        if step in kept:
            _save(self.best, step, blob)
        for s in list(index):
            if s not in kept:
                index.pop(s)
                if os.path.exists(_path(self.best, s)):
                    os.remove(_path(self.best, s))
        os.makedirs(self.best, exist_ok=True)
        with open(index_path, "w") as f:
            json.dump({str(k): v for k, v in index.items()}, f)

    def best_step(self) -> Optional[int]:
        index_path = os.path.join(self.best, "index.json")
        if not os.path.exists(index_path):
            return None
        with open(index_path) as f:
            index = {int(k): v for k, v in json.load(f).items()}
        return min(index, key=lambda s: (index[s], s)) if index else None

    def save_now(self, step: int, state) -> Optional[str]:
        """The forced checkpoint on a signal or an exception."""
        if not self.writer:
            return None
        path = _save(self.rolling, step, _to_cpu(state.state_dict()))
        self._prune(self.rolling, self.keep)
        return path

    def latest_step(self) -> Optional[int]:
        """The newest rolling checkpoint's step (None for a manager that
        is not the writer)."""
        if not self.writer:
            return None
        steps = _steps(self.rolling)
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None,
                which: str = "rolling"):
        """Load the latest (or the given) checkpoint of ``which``
        ("rolling" or "best") into ``state`` in place, strictly."""
        directory = self.rolling if which == "rolling" else self.best
        step = step if step is not None else (
            self.latest_step() if which == "rolling" else self.best_step())
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        blob = torch.load(_path(directory, step), map_location="cpu",
                          weights_only=True)
        return state.load_state_dict(blob)

    def close(self) -> None:
        """Writes are synchronous; nothing to wait for."""
