"""Diagonal Gaussian posterior (port of ``cvvae_tpu/ops/distributions.py``).

Channels-last: moments (B, T, H, W, 2*z) -> mean/logvar (B, T, H, W, z);
logvar clamped to [-30, 20]; kl/nll reduce over all non-batch axes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_LOGVAR_MIN = -30.0
_LOGVAR_MAX = 20.0


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(moments, 2, dim=-1)
        return cls(mean, logvar.clamp(_LOGVAR_MIN, _LOGVAR_MAX))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Draw from the posterior; ``generator`` lives on the mean's
        device.  It does not reproduce the JAX package's draws."""
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> torch.Tensor:
        """KL divergence summed over non-batch dims -> (B,)."""
        dims = tuple(range(1, self.mean.ndim))
        if other is None:
            return 0.5 * torch.sum(
                self.mean.square() + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean).square() / other.var
            + self.var / other.var - 1.0 - self.logvar + other.logvar,
            dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * torch.sum(
            logtwopi + self.logvar + (sample - self.mean).square() / self.var,
            dim=dims)
