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

Split across ranks (a tensor whose rows lie on the ranks of a mesh,
``parallel/shard.py``), ``group_norm_silu_sharded`` runs the same
statistics in two entries around one all-gather: each rank's partial
(count, mean, M2) per (row, group), in double on the card, then their
combination in rank order by Chan's formula and the apply.  Each rank
shifts by its own first row, so the moments about the shift do not add
across ranks; (count, mean, M2) do, with no extra collective.  The plain
version splits the JAX package's arithmetic the same way: fp32 (count,
Σx, Σx²) per rank, summed in rank order, var = E[x²]−mean².

K1.bwd (``csrc/groupnorm_bwd.cu``), the gradient, which the TPU package
leaves to XLA's autodiff of ``group_norm`` + ``silu``: ``group_norm_silu``
is a ``torch.autograd.Function`` whose forward keeps each (row, group)'s
mean and 1/std (K1 writes them from its merge when an input needs a
gradient, and not otherwise) and whose backward launches K1.bwd on the
card, or runs ``group_norm_silu_backward_plain`` on a CPU tensor.  Bound:
device memory, like K1.  K1.bwd is one cooperative launch of a grid that
the card holds at once (``backward_plan``, its own plan): per-channel sums
of dz and dz·x̂ over chunks of rows, a grid-wide barrier, a merge in a
fixed order in double, a second barrier, then dγ, dβ and dx.  It reads x
and dy twice (the second time from L2 where they fit), writes dx once, and
is deterministic.  It reads the forward's (B', G, 2) statistics and γ, β
as they are (no copies), and writes dγ, dβ in γ's dtype.

K1's int8 mode (``group_norm_silu_int8``, for ``ops/qflow.py``'s
``qgroup_norm_silu``, ``cvvae_tpu/ops/qflow.py:138-172``) reads an int8
tensor with a scalar or per-channel scale and computes the JAX package's
function there, not K1's own statistics: the fp32 mean and mean of
squares of the dequantized values, var = E[x²] − mean² (not clamped), the
dequant folded into the affine, SiLU in fp32, and an int8 output at the
consumer's scalar scale (or bf16 / fp32).  Its plan is ``launch_plan``
with 1-byte elements (16 a load).  Bound: device memory, 2 bytes an
element with an int8 output.
"""

from __future__ import annotations

import collections
import functools
import math

import torch

from cvvae_tpu_torch.ops.activations import silu as _silu
from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel K1 and of its backward K1.bwd (the CPU path
#: does not count; a checkpointed block that runs again in the backward
#: counts again)
launches = 0
bwd_launches = 0
#: launches of K1 split across ranks (``group_norm_silu_sharded``): its
#: partial moments (gn_stats, gn_partial) and its combination with the
#: apply (gn_combine, gn_apply), one of each a sharded norm
partial_launches = 0
combine_launches = 0
#: launches of K1's int8 mode (``group_norm_silu_int8``)
int8_launches = 0
#: K1.bwd's launches by (B', S, C, SiLU, dtype name)
bwd_launches_by_shape: collections.Counter = collections.Counter()
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _grouped(x: torch.Tensor, num_groups: int,
             per_frame: bool) -> torch.Tensor:
    """x as (B', S, G, C/G): B' the batch (times T with ``per_frame``)."""
    shape = x.shape
    if per_frame:
        x = x.reshape((shape[0] * shape[1],) + tuple(shape[2:]))
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    return x.reshape(x.shape[0], -1, num_groups, c // num_groups)


def _group_stats(x: torch.Tensor, num_groups: int, eps: float,
                 per_frame: bool):
    """(grouped x (B', S, G, C/G), mean, 1/std (B', 1, G, 1)) in the
    plain version's arithmetic: fp32 statistics (float64 for float64
    input) with var = E[x²] − mean²."""
    grouped = _grouped(x, num_groups, per_frame)
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
    return _apply_plain(x, grouped, mean, inv, weight, bias, silu)


def _apply_plain(x, grouped, mean, inv, weight, bias, silu):
    """The plain apply from (mean, 1/std), each (B', 1, G, 1): the affine
    folded in the statistics' dtype and applied in x's; returns it with
    (mean, 1/std) as (B', G)."""
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


def partial_moments_plain(x: torch.Tensor, num_groups: int,
                          per_frame: bool) -> torch.Tensor:
    """One rank's share of the plain statistics: (B', G, 3) of (count,
    Σx, Σx²) over its rows, in the plain version's arithmetic (fp32, or
    float64 for float64 input)."""
    grouped = _grouped(x, num_groups, per_frame)
    xf = grouped.to(torch.promote_types(x.dtype, torch.float32))
    n = torch.full(xf.shape[:1] + xf.shape[2:3],
                   float(xf.shape[1] * xf.shape[3]), dtype=xf.dtype,
                   device=xf.device)
    return torch.stack([n, xf.sum(dim=(1, 3)), xf.square().sum(dim=(1, 3))],
                       dim=-1)


def combine_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  moments: torch.Tensor, *, num_groups: int, eps: float,
                  silu: bool = False, per_frame: bool = False) -> torch.Tensor:
    """The rest of the plain split: every rank's ``partial_moments_plain``
    stacked (R, B', G, 3) in rank order, summed in that order, then mean,
    var = E[x²]−mean², and the apply of ``group_norm_silu_plain``."""
    total = moments[0]
    for r in range(1, moments.shape[0]):
        total = total + moments[r]
    n, s1, s2 = total.unbind(-1)
    mean = (s1 / n)[:, None, :, None]
    var = (s2 / n)[:, None, :, None] - mean.square()
    grouped = _grouped(x, num_groups, per_frame)
    return _apply_plain(x, grouped, mean, torch.rsqrt(var + eps), weight,
                        bias, silu)[0]


def group_norm_silu_sharded(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, *, num_groups: int,
                            eps: float, silu: bool, per_frame: bool,
                            gather) -> torch.Tensor:
    """GroupNorm(+SiLU) of this rank's rows of a tensor whose rows (the
    axes the statistics span) lie on several ranks: each (row, group)'s
    statistics over every rank's rows.  ``gather`` takes this rank's
    :func:`partial_moments` and returns every rank's, (R, B', G, 3) in
    rank order (an all-gather); :func:`combine` then normalises.
    Inference only.

    A CPU tensor takes the plain split; a CUDA tensor launches K1's
    partial entry, gathers, and launches its combine entry, or raises."""
    moments = gather(partial_moments(x, num_groups, per_frame))
    return combine(x, weight, bias, moments, num_groups=num_groups, eps=eps,
                   silu=silu, per_frame=per_frame)


def _split_plan(name, x, num_groups, per_frame):
    """(B', S, C, the launch plan's arguments) of a split K1 launch."""
    _build.refuse_gradient(f"{name} (K1 split)", "none: the mesh runs "
                           "inference", x)
    b, s, c = _check_shape(name, x, num_groups, per_frame)
    plan = launch_plan(b, s, c, num_groups, x.element_size())
    if x.data_ptr() % (plan["v"] * x.element_size()):
        raise ValueError(f"{name}: input is not aligned to its "
                         f"{plan['v']}-element loads")
    return b, s, c, plan, (plan["v"], plan["ns"], plan["threads"],
                           plan["rows_per_block"], plan["n_blocks"],
                           x.device.index or 0, _build.stream_of(x))


def partial_moments(x: torch.Tensor, num_groups: int,
                    per_frame: bool) -> torch.Tensor:
    """This rank's share of a split GroupNorm's statistics, (B', G, 3):
    on the card K1's partial entry (gn_stats, gn_partial: count, mean and
    M2 in double), on the CPU ``partial_moments_plain``."""
    global partial_launches
    if x.device.type == "cpu":
        return partial_moments_plain(x, num_groups, per_frame)
    b, s, c, plan, args = _split_plan("group_norm_partial", x, num_groups,
                                      per_frame)
    part = torch.empty((b, plan["n_blocks"], num_groups, 2), device=x.device,
                       dtype=torch.float64)
    moments = torch.empty((b, num_groups, 3), device=x.device,
                          dtype=torch.float64)
    rc = _build.library().cvvae_group_norm_partial(
        x.data_ptr(), part.data_ptr(), moments.data_ptr(), b, s, c,
        num_groups, _build.DTYPE_CODES[x.dtype], *args)
    _build.check(rc, "group_norm_partial")
    partial_launches += 1
    return moments


def combine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            moments: torch.Tensor, *, num_groups: int, eps: float,
            silu: bool = False, per_frame: bool = False) -> torch.Tensor:
    """This rank's rows of a split GroupNorm(+SiLU) from every rank's
    :func:`partial_moments` stacked (R, B', G, 3) in rank order: on the
    card K1's combine entry (gn_combine: Chan's formula over the ranks in
    rank order, in double, and the affine; gn_apply), on the CPU
    ``combine_plain``."""
    global combine_launches
    if x.device.type == "cpu":
        return combine_plain(x, weight, bias, moments, num_groups=num_groups,
                             eps=eps, silu=silu, per_frame=per_frame)
    b, s, c, _, args = _split_plan("group_norm_combine", x, num_groups,
                                   per_frame)
    moments = moments.contiguous()
    if tuple(moments.shape[1:]) != (b, num_groups, 3) or \
            moments.dtype != torch.float64 or moments.device != x.device:
        raise ValueError(f"group_norm_combine: moments "
                         f"{tuple(moments.shape)} {moments.dtype} on "
                         f"{moments.device}, expected (R, {b}, {num_groups}, "
                         f"3) float64 on {x.device}")
    y = torch.empty_like(x)
    coef = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    w32 = weight.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b32 = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    rc = _build.library().cvvae_group_norm_combine(
        x.data_ptr(), y.data_ptr(), w32.data_ptr(), b32.data_ptr(),
        moments.data_ptr(), moments.shape[0], coef.data_ptr(), None, b, s, c,
        num_groups, eps, int(silu), _build.DTYPE_CODES[x.dtype], *args)
    _build.check(rc, "group_norm_combine")
    combine_launches += 1
    return y


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
    divides or is a multiple of C/G, spanning at most 8 groups: the stats
    pass keeps 16 bytes of shared memory a thread a group it spans, within
    the 48 KB a launch has), the groups a vector spans (ns), the
    threads a block, and the blocks a batch row with their rows.  Block k
    of a batch row reads rows [k * rows_per_block, min(s, (k + 1) *
    rows_per_block))."""
    cg = c // g
    v = next(v for v in (16 // elem_size, 2, 1)
             if c % v == 0 and (cg % v == 0 or (v % cg == 0
                                                and v // cg <= 8)))
    nvc = c // v
    threads = 256 if nvc <= 256 else -(-nvc // 32) * 32
    rows_per_iter = threads // nvc
    want = max(1, TARGET_BLOCKS // b)
    rows_per_block = max(rows_per_iter, -(-s // want))
    return dict(v=v, ns=v // cg if v > cg else 1, threads=threads,
                rows_per_iter=rows_per_iter, rows_per_block=rows_per_block,
                n_blocks=-(-s // rows_per_block))


#: K1.bwd's threads an SM holds at once, and its rows a tile at the least
#: (``csrc/groupnorm_bwd.cu``)
BWD_RESIDENT_THREADS, BWD_MIN_ROWS = _build.constants(
    "groupnorm_bwd.cu", "kResidentThreads", "kMinRows")


def backward_plan(b: int, s: int, c: int, g: int, elem_size: int,
                  sms: int) -> dict:
    """K1.bwd's plan for (b, s, c) with g groups on a card of ``sms`` SMs.

    The vector width v (16 bytes, else 2 or 1 elements: the widest that
    divides C), the threads a block (one thread a vector column, 256 at
    the least), the blocks the card holds at once (``capacity``: SMs ×
    max(1, BWD_RESIDENT_THREADS / threads), which the kernel's
    ``__launch_bounds__`` guarantees) and the tiles: each batch row in
    ``n_chunks`` chunks of ``rows_per_chunk`` rows (chunk k: rows [k ·
    rows_per_chunk, min(s, (k + 1) · rows_per_chunk))), at least
    BWD_MIN_ROWS rows where s has them, no more tiles than the capacity
    where b allows.  The grid is min(tiles, capacity); block i takes tiles
    i, i + grid, ... (tile t is chunk t % n_chunks of batch row t //
    n_chunks), and its apply pass takes them in reverse.  ``part_bytes``:
    the tiles' fp32 sums (2 a channel), at most 8 / (BWD_MIN_ROWS ·
    elem_size) of x where s ≥ BWD_MIN_ROWS, else one tile a batch row.
    ``scratch_floats``: those sums, then each (row, channel)'s two float64
    sums."""
    v = next(v for v in (16 // elem_size, 2, 1) if c % v == 0)
    nvc = c // v
    threads = 256 if nvc <= 256 else -(-nvc // 32) * 32
    capacity = sms * max(1, BWD_RESIDENT_THREADS // threads)
    n_chunks = max(1, min(s // BWD_MIN_ROWS, capacity // b))
    rows = -(-s // n_chunks)
    n_chunks = -(-s // rows)
    tiles = b * n_chunks
    return dict(v=v, threads=threads, rows_per_iter=threads // nvc,
                capacity=capacity, n_chunks=n_chunks, rows_per_chunk=rows,
                tiles=tiles, grid=min(tiles, capacity),
                part_bytes=tiles * c * 2 * 4,
                scratch_floats=tiles * c * 2 + b * c * 4)


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
    return _dims(name, x.shape, num_groups, per_frame)


def _dims(name: str, shape, num_groups: int, per_frame: bool):
    """(B', S, C) of a K1 or K1.bwd launch on a tensor of ``shape``, or
    raise."""
    if len(shape) < 3 or (per_frame and len(shape) < 4):
        raise ValueError(f"{name}: bad shape {tuple(shape)}")
    c = shape[-1]
    if c % num_groups or c > 1024 or num_groups > 1024:
        raise ValueError(f"{name}: C={c}, G={num_groups} not "
                         f"supported (C % G == 0, C <= 1024)")
    b = shape[0] * (shape[1] if per_frame else 1)
    s = math.prod(shape) // (b * c) if b * c else 0
    if not 0 < b <= 65535 or s == 0:
        raise ValueError(f"{name}: bad shape {tuple(shape)}")
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
    each (B', G) fp32; dweight and dbias in weight's dtype (fp32 sums,
    rounded once).  A CPU tensor takes the plain version.

    Nothing is copied on the path: the statistics are read where they lie
    (the forward's (B', G, 2) buffer, or any (B', G) view whose groups are
    evenly spaced), and weight and bias in their own dtype.  What depends
    on the shapes alone (checks, plan, the kernel's struct) is made once a
    shape, so a small call spends little host time before its launch."""
    global bwd_launches
    if not x.is_cuda:
        return group_norm_silu_backward_plain(dy, x, weight, bias, mean, inv,
                                              silu=silu, per_frame=per_frame)
    if not x.is_contiguous() or x.dtype not in _DTYPE_NAMES:
        _build.require_cuda_layout("group_norm_silu_backward", x, x.ndim)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"group_norm_silu_backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} against x {tuple(x.shape)} {x.dtype}")
    device = x.get_device()
    mean, inv, stride = _stats_layout(mean, inv, device)
    weight, bias = _param_layout(weight, bias, device)
    align, scratch_floats, key, cplan = _backward_launch(
        x.shape, mean.shape, weight.shape, x.dtype, weight.dtype, bool(silu),
        bool(per_frame), stride, device)
    if x.data_ptr() % align:
        raise ValueError("group_norm_silu_backward: x is not aligned to its "
                         f"{align // x.element_size()}-element loads")
    if dy.data_ptr() % align or not dy.is_contiguous():
        dy = dy.clone(memory_format=torch.contiguous_format)
    dx = torch.empty_like(x)
    dparams = x.new_empty((2, key[2]), dtype=weight.dtype)
    scratch = x.new_empty(scratch_floats, dtype=torch.float32)
    rc = _build.library().cvvae_group_norm_bwd(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), dx.data_ptr(),
        dparams.data_ptr(), scratch.data_ptr(), cplan,
        _build.stream_of(x))
    _build.check(rc, "group_norm_silu_backward")
    bwd_launches += 1
    bwd_launches_by_shape[key] += 1
    dweight, dbias = dparams.unbind(0)
    return dx, dweight, dbias


@functools.lru_cache(maxsize=512)
def _backward_launch(shape, stats_shape, param_shape, dtype, wdtype, silu,
                     per_frame, stride, device):
    """What K1.bwd's launch on these shapes needs, made once: (the loads'
    alignment in bytes, the scratch's floats, the (B', S, C, SiLU, dtype)
    key of ``bwd_launches_by_shape``, the kernel's plan struct); raises on
    a shape the kernel does not take."""
    name = "group_norm_silu_backward"
    g = stats_shape[1]
    b, s, c = _dims(name, shape, g, per_frame)
    if tuple(stats_shape) != (b, g) or tuple(param_shape) != (c,):
        raise ValueError(f"{name}: statistics {tuple(stats_shape)} and "
                         f"parameters {tuple(param_shape)} against x "
                         f"{tuple(shape)} ({b} rows, {g} groups, C={c})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = backward_plan(b, s, c, g, dtype.itemsize, sms)
    cplan = _build.GroupNormBwdPlan(
        s, plan["rows_per_chunk"], b, c, g, plan["v"], plan["threads"],
        plan["n_chunks"], plan["grid"], int(silu), _build.DTYPE_CODES[dtype],
        _build.DTYPE_CODES[wdtype], stride, device)
    return (plan["v"] * dtype.itemsize, plan["scratch_floats"],
            (b, s, c, silu, _DTYPE_NAMES[dtype]), cplan)


def _stats_layout(mean, inv, device):
    """(mean, 1/std, stride): fp32 on card ``device`` with the groups of a
    row ``stride`` elements apart, as the kernel reads them; the forward's
    views of its (B', G, 2) buffer pass as they are (stride 2)."""
    if not (mean.dtype == inv.dtype == torch.float32 and mean.is_cuda
            and inv.is_cuda and mean.get_device() == inv.get_device()
            == device):
        mean = mean.to(device=device, dtype=torch.float32)
        inv = inv.to(device=device, dtype=torch.float32)
    if mean.dim() == 2 and inv.dim() == 2:
        k = mean.stride(1)
        if (k > 0 and inv.stride(1) == k
                and mean.stride(0) == inv.stride(0) == mean.shape[1] * k):
            return mean, inv, k
    return mean.contiguous(), inv.contiguous(), 1


def _param_layout(weight, bias, device):
    """weight and bias as the kernel reads them: contiguous on card
    ``device``, both fp32 or both bf16 (else both in fp32)."""
    dtype = weight.dtype
    if (dtype == bias.dtype and dtype in _DTYPE_NAMES and weight.is_cuda
            and bias.is_cuda and weight.get_device() == bias.get_device()
            == device and weight.is_contiguous() and bias.is_contiguous()):
        return weight, bias
    if dtype != bias.dtype or dtype not in _DTYPE_NAMES:
        dtype = torch.float32
    return (weight.to(device=device, dtype=dtype).contiguous(),
            bias.to(device=device, dtype=dtype).contiguous())


def _int8_requant(h: torch.Tensor, out_scale: torch.Tensor) -> torch.Tensor:
    so = out_scale.to(device=h.device, dtype=torch.float32)
    return torch.clamp(torch.round(h / so), -127, 127).to(torch.int8)


def _fp32_means(xf: torch.Tensor, axes) -> tuple:
    """(mean, mean of squares) of fp32 ``xf`` over ``axes``, kept as size-1
    axes, each an fp32 sum divided by the count.  On the CPU the sum runs
    one value at a time in the row-major order of the reduced axes, in
    fp32, as XLA's CPU reduction sums: the JAX package's moments there, bit
    for bit (the residency chain is chaotic at int8, so a last-bit change
    of a moment flips codes that the next convs spread).  On the card it is
    PyTorch's own fp32 sum."""
    n = xf.new_tensor(float(math.prod(xf.shape[a] for a in axes)))
    if xf.device.type != "cpu":
        return (xf.sum(dim=axes, keepdim=True) / n,
                xf.square().sum(dim=axes, keepdim=True) / n)
    kept = [a for a in range(xf.ndim) if a not in axes]
    rows = xf.permute(kept + list(axes)).reshape(
        [xf.shape[a] for a in kept] + [-1])
    squares = rows.square()
    s1 = torch.zeros(rows.shape[:-1], dtype=torch.float32)
    s2 = torch.zeros_like(s1)
    for i in range(rows.shape[-1]):
        s1.add_(rows[..., i])
        s2.add_(squares[..., i])
    shape = [1 if a in axes else xf.shape[a] for a in range(xf.ndim)]
    return (s1 / n).reshape(shape), (s2 / n).reshape(shape)


def group_norm_silu_int8_plain(q: torch.Tensor, scale: torch.Tensor,
                               weight: torch.Tensor, bias: torch.Tensor, *,
                               num_groups: int, eps: float,
                               out_scale=None,
                               out_dtype=torch.bfloat16) -> torch.Tensor:
    """K1's int8 mode in plain PyTorch, the JAX package's arithmetic
    (``cvvae_tpu/ops/qflow.py:138-172``): ``q`` (B, ..., C) int8 with
    ``scale`` an fp32 scalar or (C,); fp32 moments over every axis but B
    and C/G's groups (``_fp32_means``), var = E[x²] − mean², a = inv·γ·s,
    b = β − mean·inv·γ,
    h = q·a + b, SiLU; int8 requantized at the scalar ``out_scale``, or
    ``out_dtype``."""
    c = q.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups "
                         f"{num_groups}")
    cg = c // num_groups
    grouped = q.reshape(q.shape[:-1] + (num_groups, cg))
    s = scale.to(device=q.device, dtype=torch.float32)
    s_g = s.expand(c).reshape(num_groups, cg) if s.ndim else s
    axes = tuple(range(1, grouped.ndim - 2)) + (grouped.ndim - 1,)
    xf = grouped.float() * s_g
    mean, msq = _fp32_means(xf, axes)
    inv = torch.rsqrt(msq - mean.square() + eps)
    w = weight.to(device=q.device, dtype=torch.float32).reshape(num_groups,
                                                                 cg)
    b = bias.to(device=q.device, dtype=torch.float32).reshape(num_groups, cg)
    a = inv * w * s_g
    shift = b - mean * inv * w
    h = grouped.float() * a + shift
    h = (h * torch.sigmoid(h)).reshape(q.shape)
    if out_scale is None:
        return h.to(out_dtype)
    return _int8_requant(h, out_scale)


def group_norm_silu_int8(q: torch.Tensor, scale: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor, *,
                         num_groups: int, eps: float, out_scale=None,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """GroupNorm + SiLU of a contiguous int8 (B, ..., C) tensor ``q`` with
    dequantizing ``scale`` (an fp32 scalar or (C,)): int8 at the scalar
    ``out_scale``, or ``out_dtype`` (bf16 or fp32) without one; statistics
    per (batch, group) over every other axis.  Inference only.

    A CPU tensor takes the plain version; a CUDA tensor launches K1's int8
    mode or raises."""
    global int8_launches
    if q.device.type == "cpu":
        return group_norm_silu_int8_plain(
            q, scale, weight, bias, num_groups=num_groups, eps=eps,
            out_scale=out_scale, out_dtype=out_dtype)
    name = "group_norm_silu_int8"
    _build.refuse_gradient(f"{name} (K1 int8)", "none: int8 is "
                           "inference-only", weight, bias)
    if not (q.is_cuda and q.dtype == torch.int8 and q.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous int8 CUDA tensor, "
                         f"got {q.dtype} on {q.device}")
    b, s, c = _dims(name, q.shape, num_groups, False)
    if scale.numel() not in (1, c) or (out_scale is not None
                                      and out_scale.numel() != 1):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} (a scalar or "
                         f"({c},)) and out_scale (a scalar) do not fit")
    if out_scale is None and out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: out_dtype {out_dtype}: bfloat16 or "
                         f"float32, or give out_scale for int8")
    plan = launch_plan(b, s, c, num_groups, 1)
    if q.data_ptr() % plan["v"]:
        raise ValueError(f"{name}: input is not aligned to its "
                         f"{plan['v']}-byte loads")
    dev = q.device
    dtype = torch.int8 if out_scale is not None else out_dtype
    y = torch.empty(q.shape, device=dev, dtype=dtype)
    part = torch.empty((b, plan["n_blocks"], num_groups, 2), device=dev,
                       dtype=torch.float64)
    coef = torch.empty((b, 2, c), device=dev, dtype=torch.float32)
    s32 = scale.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    o32 = (None if out_scale is None else
           out_scale.to(device=dev, dtype=torch.float32).reshape(1))
    w32 = weight.detach().to(device=dev, dtype=torch.float32).contiguous()
    b32 = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    rc = _build.library().cvvae_group_norm_int8(
        q.data_ptr(), s32.data_ptr(), int(s32.numel() > 1), y.data_ptr(),
        w32.data_ptr(), b32.data_ptr(), part.data_ptr(), coef.data_ptr(),
        None if o32 is None else o32.data_ptr(), b, s, c, num_groups, eps,
        _build.INT8_CODE if o32 is not None else _build.DTYPE_CODES[dtype],
        plan["v"], plan["ns"], plan["threads"], plan["rows_per_block"],
        plan["n_blocks"], dev.index or 0, _build.stream_of(q))
    _build.check(rc, name)
    int8_launches += 1
    return y
