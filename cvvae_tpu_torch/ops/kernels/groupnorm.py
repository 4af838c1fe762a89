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

K1.bwd (``csrc/groupnorm_bwd.cu``), the gradient, which the TPU package
leaves to XLA's autodiff of ``group_norm`` + ``silu``: ``group_norm_silu``
is a ``torch.autograd.Function`` whose forward keeps each (row, group)'s
mean and 1/std (K1 writes them from its merge when an input needs a
gradient, and not otherwise) and whose backward launches K1.bwd on the
card, or runs ``group_norm_silu_backward_plain`` on a CPU tensor.  Bound:
device memory, like K1.  K1.bwd reads x and dy twice (per-channel sums of
dz and dz·x̂ over K1's row blocks, merged in a fixed order in double, then
dx) and writes dx once, and is deterministic.
"""

from __future__ import annotations

import torch

from cvvae_tpu_torch.ops.activations import silu as _silu
from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel K1 and of its backward K1.bwd (the CPU path
#: does not count; a checkpointed block that runs again in the backward
#: counts again)
launches = 0
bwd_launches = 0


def _group_stats(x: torch.Tensor, num_groups: int, eps: float,
                 per_frame: bool):
    """(grouped x (B', S, G, C/G), mean, 1/std (B', 1, G, 1)) in the
    plain version's arithmetic: fp32 statistics (float64 for float64
    input) with var = E[x²] − mean²."""
    shape = x.shape
    if per_frame:
        x = x.reshape((shape[0] * shape[1],) + tuple(shape[2:]))
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    grouped = x.reshape(x.shape[0], -1, num_groups, c // num_groups)
    xf = grouped.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    return grouped, mean, torch.rsqrt(var + eps)


def group_norm_silu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int, eps: float,
                          silu: bool = False,
                          per_frame: bool = False) -> torch.Tensor:
    """GroupNorm over (B, ..., C); statistics per (batch, group) over every
    other axis — or per (batch, frame, group) with ``per_frame``."""
    return _plain_forward(x, weight, bias, num_groups, eps, silu,
                          per_frame)[0]


def _plain_forward(x, weight, bias, num_groups, eps, silu, per_frame):
    """The plain forward and its (mean, 1/std), each (B', G)."""
    grouped, mean, inv = _group_stats(x, num_groups, eps, per_frame)
    g, cg = grouped.shape[2:]
    acc = mean.dtype
    scale = weight.to(acc).reshape(g, cg)
    shift = bias.to(acc).reshape(g, cg)
    a = (inv * scale).to(x.dtype)
    b = (shift - mean * inv * scale).to(x.dtype)
    out = grouped * a + b
    if silu:
        out = _silu(out)
    return (out.reshape(x.shape), mean.reshape(mean.shape[0], g),
            inv.reshape(inv.shape[0], g))


def group_norm_silu_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                                   weight: torch.Tensor, bias: torch.Tensor,
                                   mean: torch.Tensor, inv: torch.Tensor, *,
                                   silu: bool = False,
                                   per_frame: bool = False):
    """K1.bwd's plain version: (dx, dweight, dbias) from dy and the
    forward's (mean, 1/std), each (B', G).  With x̂ = (x − mean)·inv, z =
    x̂·γ + β and dz = dy·σ(z)(1 + z(1 − σ(z))) (dy without SiLU): dβ = Σdz,
    dγ = Σdz·x̂ per channel; A = Σdz·γ, B = Σdz·γ·x̂ per (row, group); dx =
    inv·(dz·γ − (A + x̂·B)/N), N the group's size.  fp32 arithmetic
    (float64 for float64 input), dx in x's dtype, dγ and dβ in fp32."""
    shape = x.shape
    b = shape[0] * shape[1] if per_frame else shape[0]
    g = mean.shape[1]
    acc = mean.dtype
    xg = x.reshape(b, -1, g, x.shape[-1] // g).to(acc)
    dz = dy.reshape(xg.shape).to(acc)
    m, r = mean[:, None, :, None], inv[:, None, :, None]
    gamma = weight.to(acc).reshape(g, -1)
    xh = (xg - m) * r
    if silu:
        z = xh * gamma + bias.to(acc).reshape(g, -1)
        s = torch.sigmoid(z)
        dz = dz * s * (1 + z * (1 - s))
    dbias = dz.sum(dim=(0, 1)).reshape(-1)
    dweight = (dz * xh).sum(dim=(0, 1)).reshape(-1)
    dzg = dz * gamma
    n = xg.shape[1] * xg.shape[3]
    a_sum = dzg.sum(dim=(1, 3), keepdim=True)
    b_sum = (dzg * xh).sum(dim=(1, 3), keepdim=True)
    dx = r * (dzg - (a_sum + xh * b_sum) / n)
    return dx.reshape(shape).to(x.dtype), dweight, dbias


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
    """GroupNorm(+SiLU) of a contiguous (B, T, H, W, C) tensor,
    differentiable in x, weight and bias.

    A CPU tensor takes the plain version forward and backward; a CUDA
    tensor launches K1 forward and K1.bwd backward, or raises."""
    return _GroupNormSilu.apply(x, weight, bias, num_groups, eps, silu,
                                per_frame)


class _GroupNormSilu(torch.autograd.Function):
    """K1 and K1.bwd, or their plain versions on a CPU tensor; the forward
    keeps each (row, group)'s mean and 1/std for the backward only when
    an input needs a gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu, per_frame):
        need = any(ctx.needs_input_grad[:3])
        if x.device.type == "cpu":
            y, mean, inv = _plain_forward(x, weight, bias, num_groups, eps,
                                          silu, per_frame)
        else:
            y, mean, inv = _launch(x, weight, bias, num_groups, eps, silu,
                                   per_frame, need)
        if need:
            ctx.save_for_backward(x, weight, bias, mean, inv)
            ctx.opts = (silu, per_frame)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, inv = ctx.saved_tensors
        silu, per_frame = ctx.opts
        dx, dw, db = group_norm_silu_backward(
            dy, x, weight, bias, mean, inv, silu=silu, per_frame=per_frame)
        return (dx, dw.to(weight.dtype), db.to(bias.dtype), None, None, None,
                None)


def _check_shape(name: str, x: torch.Tensor, num_groups: int,
                 per_frame: bool):
    """(B', S, C) of a K1 launch on ``x``, or raise."""
    _build.require_cuda_layout(name, x, x.ndim)
    if x.ndim < 3 or (per_frame and x.ndim < 4):
        raise ValueError(f"{name}: bad shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % num_groups or c > 1024 or num_groups > 1024:
        raise ValueError(f"{name}: C={c}, G={num_groups} not "
                         f"supported (C % G == 0, C <= 1024)")
    b = x.shape[0] * (x.shape[1] if per_frame else 1)
    s = x.numel() // (b * c)
    if not 0 < b <= 65535 or s == 0:
        raise ValueError(f"{name}: bad shape {tuple(x.shape)}")
    return b, s, c


def _launch(x, weight, bias, num_groups, eps, silu, per_frame, keep_stats):
    """K1 on a CUDA tensor: (y, mean, 1/std), the last two (B', G) fp32
    where ``keep_stats``, else None."""
    global launches
    b, s, c = _check_shape("group_norm_silu", x, num_groups, per_frame)
    plan = launch_plan(b, s, c, num_groups, x.element_size())
    if x.data_ptr() % (plan["v"] * x.element_size()):
        raise ValueError("group_norm_silu: input is not aligned to its "
                         f"{plan['v']}-element loads")
    y = torch.empty_like(x)
    part = torch.empty((b, plan["n_blocks"], num_groups, 2), device=x.device,
                       dtype=torch.float64)
    coef = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    stats = (torch.empty((b, num_groups, 2), device=x.device,
                         dtype=torch.float32) if keep_stats else None)
    w32 = weight.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b32 = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    rc = _build.library().cvvae_group_norm(
        x.data_ptr(), y.data_ptr(), w32.data_ptr(), b32.data_ptr(),
        part.data_ptr(), coef.data_ptr(),
        None if stats is None else stats.data_ptr(), b, s, c, num_groups, eps,
        int(silu), _build.DTYPE_CODES[x.dtype], plan["v"], plan["ns"],
        plan["threads"], plan["rows_per_block"], plan["n_blocks"],
        x.device.index or 0, _build.stream_of(x))
    _build.check(rc, "group_norm_silu")
    launches += 1
    if stats is None:
        return y, None, None
    return y, stats[..., 0], stats[..., 1]


def group_norm_silu_backward(dy: torch.Tensor, x: torch.Tensor,
                             weight: torch.Tensor, bias: torch.Tensor,
                             mean: torch.Tensor, inv: torch.Tensor, *,
                             silu: bool = False, per_frame: bool = False):
    """K1.bwd (``csrc/groupnorm_bwd.cu``): (dx, dweight, dbias) of a
    contiguous CUDA ``x`` from ``dy`` and the forward's (mean, 1/std),
    each (B', G) fp32; dweight and dbias in fp32.  A CPU tensor takes the
    plain version."""
    global bwd_launches
    if x.device.type == "cpu":
        return group_norm_silu_backward_plain(dy, x, weight, bias, mean, inv,
                                              silu=silu, per_frame=per_frame)
    g = mean.shape[1]
    b, s, c = _check_shape("group_norm_silu_backward", x, g, per_frame)
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"group_norm_silu_backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} against x {tuple(x.shape)} {x.dtype}")
    plan = launch_plan(b, s, c, g, x.element_size())
    if (x.data_ptr() | dy.data_ptr()) % (plan["v"] * x.element_size()):
        raise ValueError("group_norm_silu_backward: x or dy is not aligned "
                         f"to its {plan['v']}-element loads")
    stats = torch.stack([mean, inv], -1).float().contiguous()
    w32 = weight.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b32 = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty(c, device=x.device, dtype=torch.float32)
    db = torch.empty(c, device=x.device, dtype=torch.float32)
    part = torch.empty((b, plan["n_blocks"], c, 2), device=x.device,
                       dtype=torch.float32)
    rowsum = torch.empty((b, c, 2), device=x.device, dtype=torch.float64)
    coef = torch.empty((b, 5, c), device=x.device, dtype=torch.float32)
    rc = _build.library().cvvae_group_norm_bwd(
        x.data_ptr(), dy.data_ptr(), stats.data_ptr(), w32.data_ptr(),
        b32.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        part.data_ptr(), rowsum.data_ptr(), coef.data_ptr(), b, s, c, g,
        int(silu), _build.DTYPE_CODES[x.dtype], plan["v"], plan["threads"],
        plan["rows_per_block"], plan["n_blocks"], x.device.index or 0,
        _build.stream_of(x))
    _build.check(rc, "group_norm_silu_backward")
    bwd_launches += 1
    return dx, dw, db
