"""Fused nearest-2x-upsample + 3x3 conv via subpixel phase decomposition.

Port of ``cvvae_tpu/ops/upsample_conv.py`` (float path).  Nearest 2x
duplicates pixels, so each output phase (parity of the output row and
column) sees only two distinct source pixels per axis:

    y[2i]   = w0 * x[i-1] + (w1 + w2) * x[i]
    y[2i+1] = (w0 + w1) * x[i] + w2 * x[i+1]

The op is four (kT, 2, 2) convs on the original tensor, interleaved
subpixel-style; the interleave, the bias add and the (n c) channel->time
split are one pass, which on a CUDA tensor is the hand-written kernel K2
(``ops/kernels/shuffle.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from cvvae_tpu_torch.ops.kernels.shuffle import subpixel_interleave


def _phase_kernels(w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """w: (O, I, kT, 3, 3) -> four (O, I, kT, 2, 2) phase kernels, ordered
    (h_even, w_even), (h_even, w_odd), (h_odd, w_even), (h_odd, w_odd)."""
    h_even = torch.cat([w[:, :, :, 0:1], w[:, :, :, 1:2] + w[:, :, :, 2:3]], 3)
    h_odd = torch.cat([w[:, :, :, 0:1] + w[:, :, :, 1:2], w[:, :, :, 2:3]], 3)
    out = []
    for wh in (h_even, h_odd):
        w_even = torch.cat([wh[..., 0:1], wh[..., 1:2] + wh[..., 2:3]], 4)
        w_odd = torch.cat([wh[..., 0:1] + wh[..., 1:2], wh[..., 2:3]], 4)
        out.extend([w_even, w_odd])
    return tuple(out)


def upsample2x_conv3x3_interleave(x: torch.Tensor, params, *, n: int,
                                  t_pad: Tuple[int, int], t_mode: str,
                                  hw_mode: str = "zero",
                                  drop_first: bool = True) -> torch.Tensor:
    """``temporal_interleave(conv3d(nearest_2x_hw(x)), n)`` in one pass.

    x: (B,T,H,W,C) -> (B, n*T' - drop_first, 2H, 2W, C_out/n); ``params``
    holds ``weight`` (n*c, C, kT, 3, 3) and ``bias`` (n*c,) or None."""
    kernel = params.weight.to(x.dtype)
    xn = x.permute(0, 4, 1, 2, 3)
    if t_mode == "edge" and (t_pad[0] or t_pad[1]):
        xn = F.pad(xn, (0, 0, 0, 0) + tuple(t_pad), mode="replicate")
        t_zero = (0, 0)
    else:
        t_zero = tuple(t_pad)
    if hw_mode == "edge":
        xn = F.pad(xn, (1, 1, 1, 1, 0, 0), mode="replicate")
        pads = {"even": (0, -1), "odd": (-1, 0)}
    else:
        pads = {"even": (1, 0), "odd": (0, 1)}

    ks = _phase_kernels(kernel)
    corners = (("even", "even"), ("even", "odd"), ("odd", "even"),
               ("odd", "odd"))
    phases = []
    for k, (hp, wp) in zip(ks, corners):
        xp = F.pad(xn, pads[wp] + pads[hp] + t_zero)
        xp = xp.contiguous(memory_format=torch.channels_last_3d)
        y = F.conv3d(xp, k)
        phases.append(y.permute(0, 2, 3, 4, 1).contiguous())
    return subpixel_interleave(phases, params.bias, n=n, drop_first=drop_first)
