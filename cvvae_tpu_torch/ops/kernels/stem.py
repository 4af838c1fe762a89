"""K3: 3×3×3 stride-1 conv with few input channels (the encoder's
``conv_in`` on RGB pixels) — hand-written CUDA kernel and its plain
PyTorch version.

Replaces ``cvvae_tpu/ops/pallas/stem.py::stem_conv3d``.  What bounds it on
an H100: the 128-channel output write (4.0 GB in bf16 for a 17-frame
720p clip) and the fp32 FMA rate — with Cin=3 a tensor-core tile has almost
nothing to contract over, so the kernel does not use them.  The design
(``csrc/stem.cu``): a block computes a 4×32-pixel tile of one output frame
for all 128 channels from a shared-memory input patch and the 27·Cin×128
weights; the padding is folded into the patch load (time clamped in edge
mode, H/W and zero-mode time masked), so no padded copy of the input is
made; accumulation is fp32 with one rounding to the output dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0

COUT = 128
MAX_CIN = 4


def stem_usable(weight: torch.Tensor, spec) -> bool:
    """The convs K3 takes: 3×3×3, stride 1, 3 input channels (the pixel
    stem), 128 outputs, zero H/W padding, no negative pads.  The decoder's
    Cin=4 latent stem stays on cuDNN, as it stays on XLA in the JAX
    package."""
    return (tuple(spec.kernel) == (3, 3, 3) and tuple(spec.stride) == (1, 1, 1)
            and weight.shape[1] == 3 and weight.shape[0] == COUT
            and spec.modes[1] == "zero" and spec.modes[2] == "zero"
            and all(p >= 0 for pad in spec.pads for p in pad))


def stem_conv3d_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], spec) -> torch.Tensor:
    """x (B,T,H,W,Cin), weight (O,Cin,3,3,3) -> (B,T',H',W',O)."""
    (t0, t1), (h0, h1), (w0, w1) = spec.pads
    xn = x.permute(0, 4, 1, 2, 3)
    if spec.modes[0] == "edge":
        xn = F.pad(xn, (0, 0, 0, 0, t0, t1), mode="replicate")
        t0 = t1 = 0
    xn = F.pad(xn, (w0, w1, h0, h1, t0, t1))
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv3d(xn, weight.to(x.dtype), b)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def stem_conv3d(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], spec) -> torch.Tensor:
    """The stem conv of a contiguous (B, T, H, W, Cin) tensor.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if x.device.type == "cpu":
        return stem_conv3d_plain(x, weight, bias, spec)
    _build.require_cuda_layout("stem_conv3d", x, 5)
    b, t, h, w, cin = x.shape
    if (tuple(spec.kernel) != (3, 3, 3) or tuple(spec.stride) != (1, 1, 1)
            or weight.shape != (COUT, cin, 3, 3, 3) or cin > MAX_CIN
            or spec.modes[1] != "zero" or spec.modes[2] != "zero"
            or any(p < 0 for pad in spec.pads for p in pad)):
        raise ValueError(f"stem_conv3d: unsupported conv (weight "
                         f"{tuple(weight.shape)}, spec {spec})")
    (pt0, pt1), (ph0, ph1), (pw0, pw1) = spec.pads
    t_out, h_out, w_out = t + pt0 + pt1 - 2, h + ph0 + ph1 - 2, w + pw0 + pw1 - 2
    if min(t_out, h_out, w_out) < 1 or b * t_out > 65535:
        raise ValueError(f"stem_conv3d: bad output extent for {tuple(x.shape)}")
    # (O, I, kT, kH, kW) -> (kT, kH, kW, I, O): the kernel's weight rows
    w32 = weight.detach().to(device=x.device, dtype=torch.float32)
    w32 = w32.permute(2, 3, 4, 1, 0).contiguous()
    b32 = (torch.zeros(COUT, device=x.device, dtype=torch.float32)
           if bias is None else
           bias.detach().to(device=x.device, dtype=torch.float32).contiguous())
    y = torch.empty((b, t_out, h_out, w_out, COUT), device=x.device,
                    dtype=x.dtype)
    rc = _build.library().cvvae_stem_conv3d(
        x.data_ptr(), w32.data_ptr(), b32.data_ptr(), y.data_ptr(), b, t, h,
        w, cin, t_out, h_out, w_out, pt0, ph0, pw0,
        int(spec.modes[0] == "edge"), _build.DTYPE_CODES[x.dtype],
        x.device.index or 0, _build.stream_of(x))
    _build.check(rc, "stem_conv3d")
    launches += 1
    return y
