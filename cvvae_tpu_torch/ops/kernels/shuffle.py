"""K2: subpixel + channel->time interleave — hand-written CUDA kernel and
its plain PyTorch version.

Replaces ``cvvae_tpu/ops/pallas/shuffle.py::subpixel_interleave``.  It is
the tail of every decoder upsample: four phase-conv outputs
(B, T, H, W, n·c) plus a bias become (B, n·T − drop, 2H, 2W, c).
What bounds it on an H100: device memory — a pure permutation plus the
bias add, one read and one write (4.2 GB written per call at the last
upsample of a 720×672 decode tile in bf16).  The design
(``csrc/shuffle.cu``): each block walks whole output rows, each output
element reads its one source element (phase ``(y%2)*2 + x%2``, frame
``τ = t_out + drop``, source ``[b, τ//n, y//2, x//2, (τ%n)·c + ch]``), so
loads and stores are both contiguous along c.  The bias add is one fp32
add rounded to the dtype, which is what torch's own add does, so the
kernel is bit-exact against the plain version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0


def subpixel_interleave_plain(phases: Sequence[torch.Tensor],
                              bias: Optional[torch.Tensor], *, n: int,
                              drop_first: bool = True) -> torch.Tensor:
    b, t, h, w, nc = phases[0].shape
    c = nc // n
    y = torch.stack(list(phases), dim=4)            # (B,T,H,W,4,n*c)
    if bias is not None:
        y = y + bias.to(y.dtype)
    y = y.reshape(b, t, h, w, 2, 2, n, c)
    y = y.permute(0, 1, 6, 2, 4, 3, 5, 7)           # (B,T,n,H,2,W,2,c)
    y = y.reshape(b, t * n, 2 * h, 2 * w, c)
    if n > 1 and drop_first:
        y = y[:, 1:]
    return y.contiguous()


def subpixel_interleave(phases: Sequence[torch.Tensor],
                        bias: Optional[torch.Tensor], *, n: int,
                        drop_first: bool = True) -> torch.Tensor:
    """Interleave four phase tensors ordered (h_even,w_even),
    (h_even,w_odd), (h_odd,w_even), (h_odd,w_odd).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if len(phases) != 4:
        raise ValueError(f"expected 4 phase tensors, got {len(phases)}")
    p0 = phases[0]
    if p0.device.type == "cpu":
        return subpixel_interleave_plain(phases, bias, n=n,
                                         drop_first=drop_first)
    for p in phases:
        _build.require_cuda_layout("subpixel_interleave", p, 5)
        if p.shape != p0.shape or p.dtype != p0.dtype or p.device != p0.device:
            raise ValueError("subpixel_interleave: phases differ in shape, "
                             "dtype or device")
    if n not in (1, 2):
        raise ValueError(f"subpixel_interleave: n={n} not supported")
    b, t, h, w, nc = p0.shape
    if nc % n:
        raise ValueError(f"subpixel_interleave: {nc} channels do not split "
                         f"into n={n} groups")
    c = nc // n
    drop = 1 if (n > 1 and drop_first) else 0
    if bias is not None:
        if bias.shape != (nc,):
            raise ValueError(f"subpixel_interleave: bias shape "
                             f"{tuple(bias.shape)} != ({nc},)")
        bias = bias.detach().to(device=p0.device, dtype=p0.dtype).contiguous()
    out = torch.empty((b, n * t - drop, 2 * h, 2 * w, c), device=p0.device,
                      dtype=p0.dtype)
    rc = _build.library().cvvae_subpixel_interleave(
        *(p.data_ptr() for p in phases),
        None if bias is None else bias.data_ptr(), out.data_ptr(), b, t, h, w,
        c, n, drop, _build.DTYPE_CODES[p0.dtype], p0.device.index or 0,
        _build.stream_of(p0))
    _build.check(rc, "subpixel_interleave")
    launches += 1
    return out
