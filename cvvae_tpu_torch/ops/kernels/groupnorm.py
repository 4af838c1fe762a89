"""K1: GroupNorm (+ optional SiLU) — hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``cvvae_tpu/ops/pallas/groupnorm.py::group_norm_silu_pallas``.
What bounds it on an H100: device memory (two reads and one write of x;
at the encoder's level-0 shape x is about 4 GB in bf16), no tensor cores.
The design (``csrc/groupnorm.cu``): blocks over (batch, S-chunk) write
per-chunk shifted group moments, one block per batch merges them in a
fixed order with Chan's formula (deterministic, no atomics, no
E[x²]−mean² cancellation), and an elementwise pass applies the folded
affine in fp32 with one rounding, then SiLU.

The plain version keeps the JAX package's numerics (``cvvae_tpu/ops/
norm.py``): fp32 statistics with var = E[x²]−mean², the affine folded and
applied in the input dtype, SiLU in the input dtype.  In fp32 the two
agree to about 1e-5; in bf16 the kernel's single rounding differs from the
plain version's several by a few bf16 ulps.
"""

from __future__ import annotations

import torch

from cvvae_tpu_torch.ops.activations import silu as _silu
from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0


def group_norm_silu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int, eps: float,
                          silu: bool = False,
                          per_frame: bool = False) -> torch.Tensor:
    """GroupNorm over (B, ..., C); statistics per (batch, group) over every
    other axis — or per (batch, frame, group) with ``per_frame``."""
    shape = x.shape
    if per_frame:
        x = x.reshape((shape[0] * shape[1],) + tuple(shape[2:]))
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    cg = c // num_groups
    grouped = x.reshape(x.shape[0], -1, num_groups, cg)
    xf = grouped.float()
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    inv = torch.rsqrt(var + eps)
    scale = weight.float().reshape(num_groups, cg)
    shift = bias.float().reshape(num_groups, cg)
    a = (inv * scale).to(x.dtype)
    b = (shift - mean * inv * scale).to(x.dtype)
    out = grouped * a + b
    if silu:
        out = _silu(out)
    return out.reshape(shape)


def _rows_per_chunk(s: int) -> int:
    # ~2048 chunks per batch row: enough blocks for 132 SMs, few enough
    # partial moments for the sequential merge
    return max(64, -(-s // 2048))


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    *, num_groups: int, eps: float, silu: bool = False,
                    per_frame: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) of a contiguous (B, T, H, W, C) tensor.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, num_groups=num_groups,
                                     eps=eps, silu=silu, per_frame=per_frame)
    _build.require_cuda_layout("group_norm_silu", x, x.ndim)
    if x.ndim < 3 or (per_frame and x.ndim < 4):
        raise ValueError(f"group_norm_silu: bad shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % num_groups or c > 1024 or num_groups > 1024:
        raise ValueError(f"group_norm_silu: C={c}, G={num_groups} not "
                         f"supported (C % G == 0, C <= 1024)")
    b = x.shape[0] * (x.shape[1] if per_frame else 1)
    s = x.numel() // (b * c)
    rows = _rows_per_chunk(s)
    n_chunks = -(-s // rows)
    y = torch.empty_like(x)
    part = torch.empty((b, n_chunks, num_groups, 2), device=x.device,
                       dtype=torch.float32)
    coef = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    w32 = weight.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b32 = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    rc = _build.library().cvvae_group_norm(
        x.data_ptr(), y.data_ptr(), w32.data_ptr(), b32.data_ptr(),
        part.data_ptr(), coef.data_ptr(), b, s, c, num_groups, eps,
        int(silu), _build.DTYPE_CODES[x.dtype], rows, n_chunks,
        x.device.index or 0, _build.stream_of(x))
    _build.check(rc, "group_norm_silu")
    launches += 1
    return y
