"""GAN objectives (hinge / vanilla): port of ``cvvae_tpu/losses/gan.py``."""

import torch
import torch.nn.functional as F


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    loss_real = F.relu(1.0 - logits_real).mean()
    loss_fake = F.relu(1.0 + logits_fake).mean()
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """G maximises D's output on fakes: -E[D(x_rec)]."""
    return -logits_fake.mean()
