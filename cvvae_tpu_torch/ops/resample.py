"""Spatial/temporal up-sampling helpers (channels-last).

Port of ``cvvae_tpu/ops/resample.py``; the tests use these as the naive
reference for the fused upsample (``ops/upsample_conv.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_upsample_2x_spatial(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of H and W on (B,T,H,W,C)."""
    b, t, h, w, c = x.shape
    x = x[:, :, :, None, :, None, :].expand(b, t, h, 2, w, 2, c)
    return x.reshape(b, t, 2 * h, 2 * w, c)


def temporal_interleave(x: torch.Tensor, n: int,
                        drop_first: bool = True) -> torch.Tensor:
    """``b t h w (n c) -> b (t n) h w c``, then drop the first frame so
    that T_out = n*T - 1."""
    if n == 1:
        return x
    b, t, h, w, nc = x.shape
    c = nc // n
    x = x.reshape(b, t, h, w, n, c).movedim(4, 2)
    x = x.reshape(b, t * n, h, w, c)
    if drop_first:
        x = x[:, 1:]
    return x


def avg_pool3d(x: torch.Tensor, window, stride) -> torch.Tensor:
    """Average pooling on (B,T,H,W,C), VALID padding (torch default)."""
    out = F.avg_pool3d(x.permute(0, 4, 1, 2, 3), window, stride)
    return out.permute(0, 2, 3, 4, 1).contiguous()
