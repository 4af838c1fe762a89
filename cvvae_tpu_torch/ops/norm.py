"""Normalisation layers on channels-last tensors, fp32 statistics.

Port of ``cvvae_tpu/ops/norm.py``.  ``params`` is any object with
``weight`` and ``bias`` tensors of shape (C,) — the ``Affine`` module
that ``norm_init`` makes, whose keys the JAX params' ``scale``/``bias``
convert to.  GroupNorm eps is explicit: 1e-5 for v1, 1e-6 for SD3.

On a CUDA tensor, ``group_norm`` (with or without SiLU) and
``group_norm_per_frame`` run the hand-written kernel K1
(``ops/kernels/groupnorm.py``); on a CPU tensor they run its plain
version, which keeps the JAX numerics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cvvae_tpu_torch.ops.kernels.groupnorm import group_norm_silu


class Affine(nn.Module):
    """The per-channel ``weight``/``bias`` of a GroupNorm or LayerNorm."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


def norm_init(channels: int) -> Affine:
    return Affine(channels)


def group_norm(x: torch.Tensor, params, *, num_groups: int = 32,
               eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """GroupNorm over (B, ..., C), statistics per (batch, group) over every
    other axis; ``silu`` applies SiLU to the result (fused on the card)."""
    return group_norm_silu(x, params.weight, params.bias,
                           num_groups=num_groups, eps=eps, silu=silu)


def group_norm_per_frame(x: torch.Tensor, params, *, num_groups: int = 32,
                         eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """GroupNorm with T folded into batch: statistics per (batch, frame,
    group) over (H, W, C/G), as the reference attention blocks and the 2D
    constraint nets compute; ``silu`` as in ``group_norm``."""
    return group_norm_silu(x, params.weight, params.bias,
                           num_groups=num_groups, eps=eps, silu=silu,
                           per_frame=True)


def layer_norm(x: torch.Tensor, params, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), params.weight.float(),
                       params.bias.float(), eps)
    return out.to(x.dtype)


def batch_norm_inference(x: torch.Tensor, params, *,
                         eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm with the running statistics (``params.mean``,
    ``params.var``), in fp32, cast back to x's dtype."""
    out = (x.float() - params.mean.float()) * torch.rsqrt(
        params.var.float() + eps)
    out = out * params.weight.float() + params.bias.float()
    return out.to(x.dtype)


def batch_norm_train(x: torch.Tensor, params, *, eps: float = 1e-5,
                     momentum: float = 0.1):
    """BatchNorm in training mode: batch statistics over every axis but
    the channel.  Returns (y, {"mean", "var"}): the running statistics
    advanced by torch's momentum rule (biased variance normalises,
    unbiased goes into the running update), for the caller to store."""
    xf = x.float()
    axes = tuple(range(xf.ndim - 1))
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, unbiased=False)
    n = xf.numel() // xf.shape[-1]
    unbiased = var * n / max(n - 1, 1)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * params.weight.float() + params.bias.float()
    new_stats = {
        "mean": (1 - momentum) * params.mean.float() + momentum * mean,
        "var": (1 - momentum) * params.var.float() + momentum * unbiased,
    }
    return out.to(x.dtype), new_stats
