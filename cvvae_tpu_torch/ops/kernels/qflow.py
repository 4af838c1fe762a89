"""K6: the int8-resident activations' requantization and residual add —
a hand-written CUDA kernel (``csrc/qflow.cu``, two entries) and its plain
PyTorch versions.

Replaces the elementwise ops that ``cvvae_tpu/ops/qflow.py`` leaves to
XLA (no Pallas kernel): ``requant`` (:69-76), round half to even of x /
scale clipped to ±127, of a bf16 or fp32 tensor at a scalar or
per-channel scale; and ``qadd`` (:175-179), the residual add of two int8
tensors dequantized by their scales, added in fp32 and requantized.  Each
step is one IEEE-rounded fp32 operation in both versions, so the kernel
is bit-equal to its plain version.

What bounds it on an H100: device memory.  ``qadd`` moves 3 bytes an
element (0.943 ms at the v1 decoder's (1,17,720,672,128) at 3.35 TB/s);
``requant`` of bf16 3 bytes, of fp32 5.

The add has two paths, chosen here by ``add_plan``: where C is a multiple
of 16, the sliced kernel, on a grid whose stride (16 values a thread) is a
multiple of C, so that each thread's 16 channels, and their scales held in
registers, stay the same on every iteration; else the general kernel,
which finds each value's channel and loads its scales.
"""

from __future__ import annotations

import functools
import math

import torch

from cvvae_tpu_torch.ops.kernels import _build

#: launches of the requantization entry and of the residual add, either
#: path (the CPU path does not count)
requant_launches = 0
qadd_launches = 0

#: the sliced add's threads a block and blocks an SM (``csrc/qflow.cu``)
ADD_THREADS, ADD_BLOCKS = _build.constants("qflow.cu", "kThreads",
                                           "kAddBlocks")
#: an H100's SMs
SMS = 132


@functools.lru_cache(maxsize=256)
def add_plan(n: int, c: int) -> dict:
    """K6's add on n values of C channels.  Where C is a multiple of 16,
    path "sliced" on ``blocks`` blocks: about ADD_BLOCKS an SM (no more
    than the 16-value groups fill), rounded up to a multiple of C /
    gcd(C, 16 * ADD_THREADS), so that the grid's stride of 16 *
    ADD_THREADS * blocks values is a multiple of C.  Else path "general",
    blocks 0 (the kernel sizes its own grid)."""
    groups = n // 16
    if c % 16 or n % c:
        return dict(path="general", blocks=0)
    step = c // math.gcd(c, 16 * ADD_THREADS)
    want = max(1, min(SMS * ADD_BLOCKS, -(-groups // ADD_THREADS)))
    blocks = -(-want // step) * step
    if blocks * ADD_THREADS > 2 ** 31 - 1:
        return dict(path="general", blocks=0)
    return dict(path="sliced", blocks=blocks)


def _scale(scale: torch.Tensor, device) -> torch.Tensor:
    return scale.to(device=device, dtype=torch.float32)


def requant_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x -> int8 codes at ``scale`` (a scalar, or one a channel of x's
    last axis): round half to even of x / scale, clipped to ±127."""
    return torch.clamp(torch.round(x.float() / _scale(scale, x.device)),
                       -127, 127).to(torch.int8)


def qadd_plain(xq: torch.Tensor, sx: torch.Tensor, hq: torch.Tensor,
               sh: torch.Tensor, out_scale: torch.Tensor) -> torch.Tensor:
    """The int8 codes of xq·sx + hq·sh (each product and the sum in fp32)
    at ``out_scale``; each scale a scalar or one a channel."""
    dev = xq.device
    return requant_plain(xq.float() * _scale(sx, dev)
                         + hq.float() * _scale(sh, dev), out_scale)


def _flag(name: str, scale: torch.Tensor, c: int):
    """(the scale as the kernel reads it, its per-channel flag)."""
    if scale.numel() not in (1, c):
        raise ValueError(f"qflow: {name} {tuple(scale.shape)} is neither a "
                         f"scalar nor one a channel ({c})")
    return scale.reshape(-1).contiguous(), int(scale.numel() > 1)


def requant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of a contiguous bf16 or fp32 tensor ``x`` at ``scale``.
    A CPU tensor takes the plain version; a CUDA tensor launches K6's
    requantization or raises."""
    global requant_launches
    if x.device.type == "cpu":
        return requant_plain(x, scale)
    _build.refuse_gradient("qflow_requant (K6)", "none: int8 is "
                           "inference-only", x)
    _build.require_cuda_layout("qflow_requant", x, x.ndim)
    c = x.shape[-1]
    s32, pc = _flag("scale", _scale(scale, x.device), c)
    y = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    rc = _build.library().cvvae_qflow_requant(
        x.data_ptr(), s32.data_ptr(), pc, y.data_ptr(), x.numel(), c,
        _build.DTYPE_CODES[x.dtype], int(x.data_ptr() % 16 == 0),
        x.device.index or 0, _build.stream_of(x))
    _build.check(rc, "qflow_requant")
    requant_launches += 1
    return y


def qadd(xq: torch.Tensor, sx: torch.Tensor, hq: torch.Tensor,
         sh: torch.Tensor, out_scale: torch.Tensor) -> torch.Tensor:
    """The residual add of two contiguous int8 tensors of one shape with
    their scales, requantized at ``out_scale``.  A CPU tensor takes the
    plain version; a CUDA tensor launches K6's add or raises."""
    global qadd_launches
    if xq.device.type == "cpu":
        return qadd_plain(xq, sx, hq, sh, out_scale)
    for t in (xq, hq):
        if not (t.is_cuda and t.dtype == torch.int8 and t.is_contiguous()
                and t.data_ptr() % 16 == 0):
            raise ValueError(f"qflow_add: expected contiguous 16-byte "
                             f"aligned int8 CUDA tensors, got {t.dtype} on "
                             f"{t.device}")
    if xq.shape != hq.shape or xq.device != hq.device:
        raise ValueError(f"qflow_add: {tuple(xq.shape)} on {xq.device} "
                         f"against {tuple(hq.shape)} on {hq.device}")
    dev, c = xq.device, xq.shape[-1]
    scales = [_flag(n, _scale(s, dev), c) for n, s in
              (("sx", sx), ("sh", sh), ("out_scale", out_scale))]
    y = torch.empty(xq.shape, device=dev, dtype=torch.int8)
    (s1, p1), (s2, p2), (s3, p3) = scales
    rc = _build.library().cvvae_qflow_add(
        xq.data_ptr(), s1.data_ptr(), p1, hq.data_ptr(), s2.data_ptr(), p2,
        s3.data_ptr(), p3, y.data_ptr(), xq.numel(), c,
        add_plan(xq.numel(), c)["blocks"], dev.index or 0,
        _build.stream_of(xq))
    _build.check(rc, "qflow_add")
    qadd_launches += 1
    return y
