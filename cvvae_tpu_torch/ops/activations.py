"""Activations used across the port."""

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    """swish / SiLU: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)
