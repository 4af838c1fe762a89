"""Activations used across the port."""

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    """swish / SiLU: x * sigmoid(x)."""
    return x * torch.sigmoid(x)
