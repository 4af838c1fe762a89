"""3D convolution with the exact padding semantics of CV-VAE.

Port of ``cvvae_tpu/ops/conv.py``.  Public tensors are channels-last
(B, T, H, W, C); weights are torch's (O, I, kT, kH, kW).  A conv sees the
same bytes as a logical NCDHW tensor in ``torch.channels_last_3d``
memory, so the permutes around ``F.conv3d`` are free.

Edge ("replicate") padding is materialised with ``F.pad``; zero padding
goes to ``F.conv3d`` when it is symmetric and to ``F.pad`` (which also
takes negative pads, as crops) when it is not.  On a CUDA tensor a
3×3×3 stride-1 conv from 3 channels (the encoder's ``conv_in``) runs the
hand-written kernel K3 (``ops/kernels/stem.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvvae_tpu_torch.ops.kernels import stem

Pad = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Conv3DSpec:
    """Static description of a conv layer: kernel/stride/padding policy."""

    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int] = (1, 1, 1)
    #: ((t_lo, t_hi), (h_lo, h_hi), (w_lo, w_hi))
    pads: Tuple[Pad, Pad, Pad] = ((0, 0), (0, 0), (0, 0))
    #: per-axis mode: "zero" | "edge"
    modes: Tuple[str, str, str] = ("zero", "zero", "zero")
    use_bias: bool = True

    @staticmethod
    def v1_causal(k: int = 3, p: int = 1, stride=(1, 1, 1)) -> "Conv3DSpec":
        """CausalConv3d: zeros space / replicate past time."""
        return Conv3DSpec((k, k, k), tuple(stride), ((2 * p, 0), (p, p), (p, p)),
                          ("edge", "zero", "zero"))

    @staticmethod
    def v1_plain(k: int = 3, p: int = 1, stride=(1, 1, 1)) -> "Conv3DSpec":
        """nn.Conv3d(padding=p), zero padding everywhere."""
        return Conv3DSpec((k, k, k), tuple(stride), ((p, p), (p, p), (p, p)),
                          ("zero", "zero", "zero"))

    @staticmethod
    def sd3_causal(k: int = 3, p: int = 1, stride=(1, 1, 1)) -> "Conv3DSpec":
        """SD3 CausalConv3d: replicate space and past time."""
        return Conv3DSpec((k, k, k), tuple(stride), ((2 * p, 0), (p, p), (p, p)),
                          ("edge", "edge", "edge"))

    @staticmethod
    def sd3_plain(k: int = 3, p: int = 1, stride=(1, 1, 1)) -> "Conv3DSpec":
        """Conv3d(padding=p, padding_mode="replicate"): edge pad all axes."""
        return Conv3DSpec((k, k, k), tuple(stride), ((p, p), (p, p), (p, p)),
                          ("edge", "edge", "edge"))

    @staticmethod
    def spatial2d(k: int = 3, p: int = 1, stride_hw=(1, 1)) -> "Conv3DSpec":
        """Conv2dWithExtraDim: per-frame 2D conv == (1,k,k) 3D conv."""
        return Conv3DSpec((1, k, k), (1,) + tuple(stride_hw),
                          ((0, 0), (p, p), (p, p)), ("zero", "zero", "zero"))

    @staticmethod
    def pointwise() -> "Conv3DSpec":
        """1x1x1 conv (nin_shortcut)."""
        return Conv3DSpec((1, 1, 1))

    @staticmethod
    def v1_downsample(down_time: bool) -> "Conv3DSpec":
        """v1 Downsample3D: asym zero pad (0,1) space, replicate (2,0)
        time, stride 2 (or (1,2,2))."""
        return Conv3DSpec((3, 3, 3), (2 if down_time else 1, 2, 2),
                          ((2, 0), (0, 1), (0, 1)), ("edge", "zero", "zero"))

    def fan_in(self, c_in: int) -> int:
        kt, kh, kw = self.kernel
        return c_in * kt * kh * kw


def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Conv(nn.Module):
    """A conv's parameters: ``weight`` (O, I, kT, kH, kW) and ``bias``
    (O,), initialised as torch's Conv default (U(±1/sqrt(fan_in)))."""

    def __init__(self, spec: Conv3DSpec, c_in: int, c_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        bound = 1.0 / math.sqrt(spec.fan_in(c_in))
        self.weight = nn.Parameter(uniform_(
            torch.empty((c_out, c_in) + tuple(spec.kernel)), bound, generator))
        self.bias = (nn.Parameter(uniform_(torch.empty(c_out), bound, generator))
                     if spec.use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self, self.spec)


def conv3d(x: torch.Tensor, params, spec: Conv3DSpec) -> torch.Tensor:
    """Run the conv described by ``spec`` on ``x`` (B,T,H,W,C); ``params``
    has ``weight`` (O,I,kT,kH,kW) and ``bias`` (O,) or None.  Returns a
    contiguous (B,T',H',W',O) tensor."""
    weight, bias = params.weight, params.bias
    if stem.stem_usable(weight, spec):
        return stem.stem_conv3d(x, weight, bias, spec)
    xn = x.permute(0, 4, 1, 2, 3)
    edge = [p if m == "edge" else (0, 0) for p, m in zip(spec.pads, spec.modes)]
    zero = [p if m == "zero" else (0, 0) for p, m in zip(spec.pads, spec.modes)]
    if any(p != (0, 0) for p in edge):
        xn = F.pad(xn, _torch_pad(edge), mode="replicate")
    if all(lo == hi and lo >= 0 for lo, hi in zero):
        padding = tuple(lo for lo, _ in zero)
    else:
        xn = F.pad(xn, _torch_pad(zero))
        padding = 0
    xn = xn.contiguous(memory_format=torch.channels_last_3d)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv3d(xn, weight.to(x.dtype), b, stride=spec.stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _torch_pad(pads) -> Tuple[int, ...]:
    """((t_lo,t_hi),(h_lo,h_hi),(w_lo,w_hi)) -> F.pad order (last dim
    first)."""
    (t0, t1), (h0, h1), (w0, w1) = pads
    return (w0, w1, h0, h1, t0, t1)
