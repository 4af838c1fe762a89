"""K2: subpixel + channel->time interleave — hand-written CUDA kernel and
its plain PyTorch version.

Replaces ``cvvae_tpu/ops/pallas/shuffle.py::subpixel_interleave``.  It is
the tail of every decoder upsample: four phase-conv outputs
(B, T, H, W, n·c) plus a bias become (B, n·T − drop, 2H, 2W, c).  Output
pixel (y, x) of frame t_out reads phase ``(y%2)*2 + x%2`` at source
``[b, τ//n, y//2, x//2, (τ%n)·c + ch]`` with ``τ = t_out + drop``.  What
bounds it on an H100: device memory, one read of the phases and one write
of the output (8.7 GB at the last upsample of a 720×672 decode tile in
bf16, 2.6 ms at 3.35 TB/s).  The design (``csrc/shuffle.cu``) is a copy at
HBM's rate: 16-byte vectors where c and every pointer allow it
(``launch_plan``; else the same kernel moves single elements), a block of
(c/vec, pixels) threads so each thread keeps its channel offset and bias
vector in registers for a whole output row and never divides per element,
four independent loads in flight before their stores, and a persistent
grid over output rows.  The bias add is one fp32 add rounded to the dtype,
which is what torch's own add does, so the kernel is bit-exact against
the plain version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0

#: threads a block at most, and loads a thread issues before their stores
#: (kThreads, kUnroll of csrc/shuffle.cu)
THREADS, UNROLL = _build.constants("shuffle.cu", "kThreads", "kUnroll")
#: resident blocks an SM the grid aims at
BLOCKS_PER_SM = 8


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


def launch_plan(phases: Sequence[torch.Tensor],
                bias: Optional[torch.Tensor], c: int, rows: int,
                sms: int) -> dict:
    """The kernel's plan: ``vec`` elements a moved unit (16 bytes where c
    is a multiple of it and every phase and the bias start 16-byte
    aligned, else 1); a block of (bx, by) threads, bx of the pixel's c/vec
    units and by pixels; ``grid`` blocks walking the ``rows`` output
    rows, block k rows k, k + grid, ..."""
    elem = phases[0].element_size()
    vec = 16 // elem
    ptrs = [p.data_ptr() for p in phases]
    if bias is not None:
        ptrs.append(bias.data_ptr())
    if c % vec or any(ptr % 16 for ptr in ptrs):
        vec = 1
    bx = min(c // vec, THREADS)
    # as many rows to every block: ceil(rows / blocks) each, over at most
    # BLOCKS_PER_SM blocks an SM
    per_block = -(-rows // (sms * BLOCKS_PER_SM))
    return dict(vec=vec, bx=bx, by=max(1, THREADS // bx),
                grid=max(1, -(-rows // per_block)))


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
    plan = launch_plan(phases, bias, c, out.shape[0] * out.shape[1] * 2 * h,
                       torch.cuda.get_device_properties(
                           p0.device).multi_processor_count)
    rc = _build.library().cvvae_subpixel_interleave(
        *(p.data_ptr() for p in phases),
        None if bias is None else bias.data_ptr(), out.data_ptr(), b, t, h, w,
        c, n, drop, plan["vec"], plan["bx"], plan["by"], plan["grid"],
        _build.DTYPE_CODES[p0.dtype], p0.device.index or 0,
        _build.stream_of(p0))
    _build.check(rc, "subpixel_interleave")
    launches += 1
    return out
