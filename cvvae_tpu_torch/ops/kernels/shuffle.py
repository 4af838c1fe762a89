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

K2.bwd (``csrc/shuffle_bwd.cu``), the gradient, which the TPU package
leaves to XLA's autodiff of its interleave: ``subpixel_interleave`` is a
``torch.autograd.Function`` whose backward launches K2.bwd on the card
(``subpixel_interleave_backward_plain`` on a CPU tensor): the inverse
permutation of dy into the four phases, bit-exact, zero where a frame was
dropped, and d(bias) summed per thread in fp32 and merged over the threads
in a fixed order in double.  Bound: device memory, one read of dy and one
write of the phases.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel K2 and of its backward K2.bwd (the CPU path
#: does not count)
launches = 0
bwd_launches = 0

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


def subpixel_interleave_backward_plain(dy: torch.Tensor, *, n: int,
                                       t: int, drop_first: bool = True,
                                       with_bias: bool = True):
    """K2.bwd's plain version: the four phase gradients (B, T, H, W, n·c)
    of ``dy`` (B, n·T − drop, 2H, 2W, c), zero where a frame was dropped,
    and d(bias) (n·c,) in fp32 (None ``with_bias`` False)."""
    b, _, h2, w2, c = dy.shape
    h, w = h2 // 2, w2 // 2
    if n > 1 and drop_first:
        dy = torch.cat([dy.new_zeros((b, 1, h2, w2, c)), dy], dim=1)
    y = dy.reshape(b, t, n, h, 2, w, 2, c).permute(0, 1, 3, 5, 4, 6, 2, 7)
    y = y.reshape(b, t, h, w, 4, n * c)
    phases = [y[..., k, :].contiguous() for k in range(4)]
    dbias = (y.to(torch.promote_types(y.dtype, torch.float32))
             .sum(dim=(0, 1, 2, 3, 4)) if with_bias else None)
    return phases, dbias


def subpixel_interleave(phases: Sequence[torch.Tensor],
                        bias: Optional[torch.Tensor], *, n: int,
                        drop_first: bool = True) -> torch.Tensor:
    """Interleave four phase tensors ordered (h_even,w_even),
    (h_even,w_odd), (h_odd,w_even), (h_odd,w_odd), differentiable in the
    phases and the bias.

    A CPU tensor takes the plain version forward and backward; a CUDA
    tensor launches K2 forward and K2.bwd backward, or raises."""
    if len(phases) != 4:
        raise ValueError(f"expected 4 phase tensors, got {len(phases)}")
    return _Interleave.apply(n, drop_first, bias, *phases)


class _Interleave(torch.autograd.Function):
    """K2 and K2.bwd, or their plain versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, n, drop_first, bias, *phases):
        ctx.opts = (n, drop_first, phases[0].shape[1], bias is not None,
                    None if bias is None else bias.dtype)
        if phases[0].device.type == "cpu":
            return subpixel_interleave_plain(phases, bias, n=n,
                                             drop_first=drop_first)
        return _launch(phases, bias, n, drop_first)

    @staticmethod
    def backward(ctx, dy):
        n, drop_first, t, with_bias, bias_dtype = ctx.opts
        with_bias = with_bias and ctx.needs_input_grad[2]
        phases, dbias = subpixel_interleave_backward(
            dy, n=n, t=t, drop_first=drop_first, with_bias=with_bias)
        if dbias is not None:
            dbias = dbias.to(bias_dtype)
        return (None, None, dbias, *phases)


def _launch(phases, bias, n, drop_first):
    global launches
    p0 = phases[0]
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


def subpixel_interleave_backward(dy: torch.Tensor, *, n: int, t: int,
                                 drop_first: bool = True,
                                 with_bias: bool = True):
    """K2.bwd (``csrc/shuffle_bwd.cu``): the four phase gradients and
    d(bias) (fp32, or None) of a contiguous CUDA ``dy``; a CPU tensor takes
    the plain version."""
    global bwd_launches
    if dy.device.type == "cpu":
        return subpixel_interleave_backward_plain(
            dy, n=n, t=t, drop_first=drop_first, with_bias=with_bias)
    dy = dy.contiguous()
    _build.require_cuda_layout("subpixel_interleave_backward", dy, 5)
    if n not in (1, 2):
        raise ValueError(f"subpixel_interleave_backward: n={n} not supported")
    b, t_out, h2, w2, c = dy.shape
    drop = 1 if (n > 1 and drop_first) else 0
    if t_out != n * t - drop or h2 % 2 or w2 % 2:
        raise ValueError(f"subpixel_interleave_backward: dy {tuple(dy.shape)} "
                         f"is no output of T={t}, n={n}, drop={drop}")
    h, w = h2 // 2, w2 // 2
    phases = [torch.empty((b, t, h, w, n * c), device=dy.device,
                          dtype=dy.dtype) for _ in range(4)]
    rows = b * n * t * h2
    plan = launch_plan([dy] + phases, None, c, rows,
                       torch.cuda.get_device_properties(
                           dy.device).multi_processor_count)
    part = dbias = None
    if with_bias:
        part = torch.empty((plan["grid"], plan["by"], n * c),
                           device=dy.device, dtype=torch.float32)
        dbias = torch.empty(n * c, device=dy.device, dtype=torch.float32)
    rc = _build.library().cvvae_subpixel_interleave_bwd(
        dy.data_ptr(), *(p.data_ptr() for p in phases),
        None if part is None else part.data_ptr(),
        None if dbias is None else dbias.data_ptr(), b, t, h, w, c, n, drop,
        plan["vec"], plan["bx"], plan["by"], plan["grid"],
        _build.DTYPE_CODES[dy.dtype], dy.device.index or 0,
        _build.stream_of(dy))
    _build.check(rc, "subpixel_interleave_backward")
    bwd_launches += 1
    return phases, dbias
