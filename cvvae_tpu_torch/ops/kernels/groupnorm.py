"""K1: GroupNorm (+ optional SiLU) — hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``cvvae_tpu/ops/pallas/groupnorm.py::group_norm_silu_pallas``.
What bounds it on an H100: device memory (one read and one write of x is
the least traffic: 8.02 GB at the encoder's level-0 shape in bf16, 2.39
ms at 3.35 TB/s), no tensor cores.  The design (``csrc/groupnorm.cu``):
a stats pass over a grid of about 8 blocks an SM reads x in 16-byte
loads, folds channels to groups in registers and writes each block's
group moments about one fixed value of the group, in double; one warp
per (batch row, group) adds them in a fixed order (deterministic, no
atomics) and folds mean, 1/std, scale and bias into a per-channel affine;
an apply pass on the same plan writes fma(x, a, b) in fp32 with one
rounding, then SiLU, in 16-byte stores.  ``launch_plan`` makes the plan
(vector width, threads, rows a block) here, where it is tested.

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


#: blocks the plan aims at over all batch rows: 8 blocks of 256 threads
#: fill each of the H100's 132 SMs
TARGET_BLOCKS = 132 * 8


def launch_plan(b: int, s: int, c: int, g: int, elem_size: int) -> dict:
    """The kernel's plan for (b, s, c) with g groups: the vector width v
    (elements a load: 16 bytes, else 2 or 1, the widest that divides C and
    divides or is a multiple of C/G), the groups a vector spans (ns), the
    threads a block, and the blocks a batch row with their rows.  Block k
    of a batch row reads rows [k * rows_per_block, min(s, (k + 1) *
    rows_per_block))."""
    cg = c // g
    v = next(v for v in (16 // elem_size, 2, 1)
             if c % v == 0 and (cg % v == 0 or v % cg == 0))
    nvc = c // v
    threads = 256 if nvc <= 256 else -(-nvc // 32) * 32
    rows_per_iter = threads // nvc
    want = max(1, TARGET_BLOCKS // b)
    rows_per_block = max(rows_per_iter, -(-s // want))
    return dict(v=v, ns=v // cg if v > cg else 1, threads=threads,
                rows_per_iter=rows_per_iter, rows_per_block=rows_per_block,
                n_blocks=-(-s // rows_per_block))


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
    if not 0 < b <= 65535 or s == 0:
        raise ValueError(f"group_norm_silu: bad shape {tuple(x.shape)}")
    plan = launch_plan(b, s, c, num_groups, x.element_size())
    if x.data_ptr() % (plan["v"] * x.element_size()):
        raise ValueError("group_norm_silu: input is not aligned to its "
                         f"{plan['v']}-element loads")
    y = torch.empty_like(x)
    part = torch.empty((b, plan["n_blocks"], num_groups, 2), device=x.device,
                       dtype=torch.float64)
    coef = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    w32 = weight.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b32 = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    rc = _build.library().cvvae_group_norm(
        x.data_ptr(), y.data_ptr(), w32.data_ptr(), b32.data_ptr(),
        part.data_ptr(), coef.data_ptr(), b, s, c, num_groups, eps,
        int(silu), _build.DTYPE_CODES[x.dtype], plan["v"], plan["ns"],
        plan["threads"], plan["rows_per_block"], plan["n_blocks"],
        x.device.index or 0, _build.stream_of(x))
    _build.check(rc, "group_norm_silu")
    launches += 1
    return y
