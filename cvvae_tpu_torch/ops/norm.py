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
                         eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm with T folded into batch: statistics per (batch, frame,
    group) over (H, W, C/G), as the reference attention blocks compute."""
    return group_norm_silu(x, params.weight, params.bias,
                           num_groups=num_groups, eps=eps, per_frame=True)


def layer_norm(x: torch.Tensor, params, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), params.weight.float(),
                       params.bias.float(), eps)
    return out.to(x.dtype)
