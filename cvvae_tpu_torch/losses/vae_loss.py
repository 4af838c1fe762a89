"""Reconstruction / NLL / constraint losses for VAE-GAN training.

Port of ``cvvae_tpu/losses/vae_loss.py``:

* per-frame L1 (or L2) plus weighted per-frame LPIPS;
* learned-logvar NLL: sum(rec / exp(logvar) + logvar) / (B*T);
* the 2D-constraint branch's target frames by ``target_type`` in
  {random, slice, mean}: the random frame offsets come from a generator,
  or are given (a test hands in the JAX package's draws);
* the adaptive discriminator weight ||grad nll|| / (||grad g|| + 1e-4),
  clipped to [0, 1e4], times ``disc_weight``.

All loss arithmetic is fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from cvvae_tpu_torch.models.lpips import lpips_distance


@dataclasses.dataclass(frozen=True)
class LossConfig:
    disc_start: int = 1
    logvar_init: float = 0.0
    disc_factor: float = 1.0
    disc_weight: float = 0.5
    perceptual_weight: float = 0.5
    rec_loss: str = "l1"                 # "l1" | "l2"
    learn_logvar: bool = True
    kl_weight: float = 1.0
    adaptive_disc_weight: bool = True
    disc_loss: str = "hinge"             # "hinge" | "vanilla"
    rec2d_weight: float = 1.0
    target_type: str = "random"          # "random" | "slice" | "mean"
    time_n_compress: int = 4


def elementwise_rec_loss(x: torch.Tensor, y: torch.Tensor,
                         kind: str) -> torch.Tensor:
    x, y = x.float(), y.float()
    if kind == "l1":
        return (x - y).abs()
    if kind == "l2":
        return (x - y).square()
    raise ValueError(kind)


def perceptual_per_frame(lpips_net, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """LPIPS on video: T folded into batch -> (B*T, 1, 1, 1)."""
    b, t = x.shape[:2]
    return lpips_distance(lpips_net, x.reshape((b * t,) + tuple(x.shape[2:])),
                          y.reshape((b * t,) + tuple(y.shape[2:])))


def nll_from_rec(rec: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """sum(rec / exp(logvar) + logvar) / (B*T) for a (B*T, H, W, C) rec."""
    nll = rec / torch.exp(logvar) + logvar
    return nll.sum() / nll.shape[0]


def rec_with_perceptual(cfg: LossConfig, lpips_net, x: torch.Tensor,
                        xrec: torch.Tensor) -> torch.Tensor:
    """The per-frame rec loss map (B*T, H, W, C): pointwise + LPIPS
    broadcast."""
    b, t = x.shape[:2]
    rec = elementwise_rec_loss(x, xrec, cfg.rec_loss)
    rec = rec.reshape((b * t,) + tuple(rec.shape[2:]))
    if cfg.perceptual_weight > 0 and lpips_net is not None:
        p = perceptual_per_frame(lpips_net, x, xrec).float()
        rec = rec + cfg.perceptual_weight * p
    return rec


def constraint_targets(cfg: LossConfig, x: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       offsets: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The 2D target frames of the latent-constraint branch: x (B, T, H,
    W, C) with T = n*d + 1 -> (B, d+1, H, W, C).  ``random`` takes frame 0
    and one frame of each later group of n, at ``offsets`` (drawn from
    ``generator`` when not given)."""
    n = cfg.time_n_compress
    t = x.shape[1]
    d = (t - 1) // n
    if cfg.target_type == "slice":
        return x[:, ::n]
    if cfg.target_type == "mean":
        rest = x[:, 1:].reshape((x.shape[0], d, n) + tuple(x.shape[2:]))
        return torch.cat([x[:, :1], rest.mean(dim=2)], dim=1)
    if cfg.target_type == "random":
        if offsets is None:
            offsets = torch.randint(1, n + 1, (d,), generator=generator,
                                    device=x.device)
        idx = torch.cat([torch.zeros(1, dtype=torch.long),
                         offsets.long().cpu()
                         + torch.arange(d, dtype=torch.long) * n])
        return x.index_select(1, idx.to(x.device))
    raise ValueError(cfg.target_type)


def adaptive_disc_weight(cfg: LossConfig, nll_grad_norm: torch.Tensor,
                         g_grad_norm: torch.Tensor) -> torch.Tensor:
    """d_weight = ||grad nll|| / (||grad g|| + 1e-4), clipped to [0, 1e4],
    times disc_weight; a constant for the backward pass."""
    w = (nll_grad_norm / (g_grad_norm + 1e-4)).clamp(0.0, 1e4)
    return w.detach() * cfg.disc_weight


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))
