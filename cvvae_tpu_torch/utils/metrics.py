"""Reconstruction quality metrics (PSNR / SSIM) — port of
``cvvae_tpu/utils/metrics.py``.

The standard definitions on [-1, 1]-scaled video tensors (channels-last),
reduced per sample, computed in fp32 on the tensors' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(x: torch.Tensor, y: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Per-sample PSNR (dB).  x, y: (B, ...) same shape."""
    d = x.float() - y.float()
    mse = d.square().mean(dim=tuple(range(1, d.ndim)))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    r = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2
    g = torch.exp(-0.5 * (r / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 2.0,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-sample mean SSIM over frames/channels.

    x, y: (B, T, H, W, C) or (B, H, W, C) in [-1, 1]; 11x11 Gaussian
    window (a depthwise ``F.conv2d``, fp32, no padding), Wang et al.'s
    constants.
    """
    if x.ndim == 4:
        x, y = x[:, None], y[:, None]
    b, t, h, w, c = x.shape

    def planes(v):        # every (frame, channel) plane as one image
        return v.float().permute(0, 1, 4, 2, 3).reshape(-1, 1, h, w)

    xf, yf = planes(x), planes(y)
    win = _gaussian_kernel(device=xf.device)[None, None]

    def filt(v):
        return F.conv2d(v, win)

    mu_x, mu_y = filt(xf), filt(yf)
    sxx = filt(xf * xf) - mu_x * mu_x
    syy = filt(yf * yf) - mu_y * mu_y
    sxy = filt(xf * yf) - mu_x * mu_y
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2))
    per_image = ssim_map.mean(dim=(1, 2, 3))
    return per_image.reshape(b, t * c).mean(dim=1)


def reconstruction_report(x: torch.Tensor, x_rec: torch.Tensor) -> dict:
    return {
        "psnr_db": float(psnr(x, x_rec).mean()),
        "ssim": float(ssim(x, x_rec).mean()),
        "l1": float((x.float() - x_rec.float()).abs().mean()),
    }
