"""Latent regularizers: port of ``cvvae_tpu/losses/regularizers.py``.

* ``diagonal_gaussian_regularizer``: sample the posterior (or take its
  mode), return the batch-mean KL in the log dict;
* ``identity_regularizer``: pass-through.

The training engine inlines the diagonal-Gaussian path; these are the
standalone API.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cvvae_tpu_torch.ops.distributions import DiagonalGaussian


def diagonal_gaussian_regularizer(
        moments: torch.Tensor, generator: Optional[torch.Generator] = None,
        *, noise: Optional[torch.Tensor] = None, sample: bool = True
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    posterior = DiagonalGaussian.from_moments(moments)
    z = (posterior.sample(generator, noise=noise) if sample
         else posterior.mode())
    kl = posterior.kl()
    return z, {"kl_loss": kl.sum() / kl.shape[0]}


def identity_regularizer(z: torch.Tensor, generator=None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return z, {}
