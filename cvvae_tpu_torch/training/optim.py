"""Optimizers and LR schedules.

Port of ``cvvae_tpu/training/optim.py``: the shipped recipe's AdamW
(betas (0.9, 0.98), eps 1e-4, weight decay 0.01) behind a clip of the
global gradient norm at 1.0, a cosine schedule with 1000 warm-up steps
over 60000 and a 0.005 floor, and a generator LR of 2x the base.

The optimizer keeps optax's semantics (``optax.chain(clip_by_global_norm,
adamw)`` with the LR injected each step), which torch's own differ from:

* the clip is ``g if ||g|| < max else g / ||g|| * max`` (torch's
  ``clip_grad_norm_`` scales by max / (||g|| + 1e-6));
* AdamW decays every parameter, 0-d ones (the learned logvars) included,
  with update -lr * (m̂ / (sqrt(v̂) + eps) + wd * p);
* the LR is an argument of each step, evaluated from the *global* training
  step by the caller, so both optimizers follow one schedule under G/D
  alternation;
* ``mask`` zeroes the gradients and the updates of frozen parameters (the
  moments still decay), as the engine's ``_mask_frozen`` does on both.

Schedules are evaluated in float32, as the JAX package evaluates them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    base_lr: float = 2.0e-5
    lr_g_factor: float = 2.0
    betas: tuple = (0.9, 0.98)
    eps: float = 1.0e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    scheduler: str = "cosine"
    num_warmup_steps: int = 1000
    num_training_steps: int = 60000
    min_lr_ratio: float = 0.005


_f = np.float32


def cosine_schedule_with_warmup(base_lr: float, num_warmup_steps: int,
                                num_training_steps: int,
                                num_cycles: float = 0.5,
                                min_lr_ratio: float = 0.0) -> Callable:
    """Linear warm-up, then cosine decay to base_lr * min_lr_ratio."""

    def schedule(step):
        step = _f(step)
        warm = step / _f(max(1.0, num_warmup_steps))
        progress = (step - _f(num_warmup_steps)) / _f(
            max(1.0, num_training_steps - num_warmup_steps))
        cos = _f(0.5) * (_f(1.0 + min_lr_ratio) + _f(1.0 - min_lr_ratio)
                         * np.cos(_f(math.pi * num_cycles * 2.0) * progress))
        factor = warm if step < num_warmup_steps else max(_f(0.0), cos)
        return float(_f(base_lr) * _f(factor))

    return schedule


def linear_schedule_with_warmup(base_lr: float, num_warmup_steps: int,
                                num_training_steps: int) -> Callable:
    def schedule(step):
        step = _f(step)
        warm = step / _f(max(1.0, num_warmup_steps))
        lin = max(_f(0.0), (_f(num_training_steps) - step) / _f(
            max(1.0, num_training_steps - num_warmup_steps)))
        return float(_f(base_lr) * (warm if step < num_warmup_steps
                                    else lin))

    return schedule


def polynomial_schedule_with_warmup(base_lr: float, num_warmup_steps: int,
                                    num_training_steps: int,
                                    lr_end: float = 1e-7,
                                    power: float = 1.0) -> Callable:
    """Linear warm-up, then (lr0 - lr_end) * (1 - progress)^power +
    lr_end, then lr_end."""

    def schedule(step):
        step = _f(step)
        warm = _f(base_lr) * step / _f(max(1.0, num_warmup_steps))
        remaining = _f(1.0) - (step - _f(num_warmup_steps)) / _f(
            max(1.0, num_training_steps - num_warmup_steps))
        decay = _f(base_lr - lr_end) * remaining ** _f(power) + _f(lr_end)
        if step < num_warmup_steps:
            return float(warm)
        return float(_f(lr_end) if step > num_training_steps else decay)

    return schedule


def constant_schedule(base_lr: float, num_warmup_steps: int = 0) -> Callable:
    def schedule(step):
        if num_warmup_steps:
            return float(_f(base_lr) * min(_f(1.0), _f(step)
                                           / _f(num_warmup_steps)))
        return float(_f(base_lr))

    return schedule


def get_schedule(name: str, base_lr: float, *, num_warmup_steps: int = 0,
                 num_training_steps: Optional[int] = None,
                 min_lr_ratio: float = 0.0) -> Callable:
    if name == "constant":
        return constant_schedule(base_lr)
    if name == "constant_with_warmup":
        return constant_schedule(base_lr, num_warmup_steps)
    if name == "cosine":
        return cosine_schedule_with_warmup(
            base_lr, num_warmup_steps, num_training_steps,
            min_lr_ratio=min_lr_ratio)
    if name == "linear":
        return linear_schedule_with_warmup(
            base_lr, num_warmup_steps, num_training_steps)
    if name == "polynomial":
        return polynomial_schedule_with_warmup(
            base_lr, num_warmup_steps, num_training_steps)
    raise ValueError(f"unknown scheduler {name!r}")


def make_schedule(cfg: OptimConfig, lr_factor: float = 1.0) -> Callable:
    """The LR as a function of the GLOBAL training step."""
    return get_schedule(
        cfg.scheduler, cfg.base_lr * lr_factor,
        num_warmup_steps=cfg.num_warmup_steps,
        num_training_steps=cfg.num_training_steps,
        min_lr_ratio=cfg.min_lr_ratio)


@dataclasses.dataclass
class AdamWState:
    """optax's ScaleByAdamState: the update count and the first and second
    moments, keyed by parameter name."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g / ||g|| * max where ||g|| >=
    max.  Returns ||g|| (fp32, before the clip)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    for g in grads.values():
        # (g / ||g||) * max, as optax computes it, where the clip applies
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))
    return norm


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip),
    adamw(lr, b1, b2, eps, weight_decay))`` over named parameters."""

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            0, {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamWState, lr: float,
             frozen: Iterable[str] = ()) -> torch.Tensor:
        """Clip ``grads`` (in place), update the moments and apply the
        updates to ``params`` in place; names in ``frozen`` get zero
        gradients and no update.  Returns the global norm before the
        clip."""
        cfg = self.cfg
        frozen = set(frozen)
        for k in frozen:
            grads[k].zero_()
        norm = clip_by_global_norm(grads, cfg.grad_clip)
        b1, b2 = cfg.betas
        state.count += 1
        dev = next(iter(params.values())).device
        c = torch.tensor(state.count, dtype=torch.int32, device=dev)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** c
        for k, p in params.items():
            g = grads[k]
            mu, nu = state.mu[k], state.nu[k]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * g.square() + b2 * nu)
            if k in frozen:
                continue
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p
            p.add_(-lr * u)
        return norm
