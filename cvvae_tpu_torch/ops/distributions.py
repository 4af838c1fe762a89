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

    def sample(self, generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Draw from the posterior: mean + std · noise, with ``noise`` as
        given (of the mean's shape; a test hands in the JAX package's
        draws) or N(0, 1) from ``generator``, which lives on the mean's
        device.  A generator does not reproduce the JAX package's
        draws."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device,
                                dtype=self.mean.dtype)
        elif tuple(noise.shape) != tuple(self.mean.shape):
            raise ValueError(f"noise {tuple(noise.shape)} is not of the "
                             f"posterior's shape {tuple(self.mean.shape)}")
        return self.mean + self.std * noise.to(self.mean)

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
