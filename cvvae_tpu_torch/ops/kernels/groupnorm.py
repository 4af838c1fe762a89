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
statistics in two entries around one all-gather, one launch each: each
rank's partial (count, mean, M2) per (row, group), in double on the card
(K1.partial: the stats pass, then the block that finishes its batch row
last, told by a ticket counter, folds the row's blocks in block order),
then their combination in rank order by Chan's formula, the affine and
the apply, each thread for its own channels (K1.combine).  Both run on
``split_plan``; the plan and the launch's struct are made once a shape,
and the partial's scratch (ticket counters and block moments) is one
allocation a card and stream, so little host time goes before a launch.
Each rank shifts by its own first row, so the moments about the shift do
not add across ranks; (count, mean, M2) do, with no extra collective.
The plain
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
element with an int8 output.  Its plain version sums the moments in
XLA's CPU order (the JAX package's bits); within
``int8_moment_order("kernel")`` it takes the kernel's own order
(``_kernel_moments``), which an int8 chain, chaotic in the last bit of
a moment, needs for a card-vs-CPU comparison.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math
from fractions import Fraction

import numpy as np
import torch

from cvvae_tpu_torch.ops.activations import silu as _silu
from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel K1 and of its backward K1.bwd (the CPU path
#: does not count; a checkpointed block that runs again in the backward
#: counts again)
launches = 0
bwd_launches = 0
#: launches of K1 split across ranks (``group_norm_silu_sharded``): its
#: partial moments (gn_partial) and its combination with the apply
#: (gn_combine), one of each a sharded norm
partial_launches = 0
combine_launches = 0
#: launches of K1's int8 mode (``group_norm_silu_int8``)
int8_launches = 0
#: K1.bwd's launches by (B', S, C, SiLU, dtype name)
bwd_launches_by_shape: collections.Counter = collections.Counter()
#: the split entries' launches by "<partial|combine> <x's shape>
#: per_frame=<bool>"
split_launches_by_shape: collections.Counter = collections.Counter()
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


def partial_moments(x: torch.Tensor, num_groups: int,
                    per_frame: bool) -> torch.Tensor:
    """This rank's share of a split GroupNorm's statistics, (B', G, 3):
    on the card K1's partial entry (``gn_partial``, one launch: count,
    mean and M2 in double), on the CPU ``partial_moments_plain``."""
    global partial_launches
    if x.is_cpu:
        return partial_moments_plain(x, num_groups, per_frame)
    dev, cplan, launch = _split_launch("group_norm_partial", x, num_groups,
                                       per_frame)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    scratch = _partial_scratch(dev, stream, launch.part_bytes)
    moments = x.new_empty(launch.moments_shape, dtype=torch.float64)
    rc = _build.library().cvvae_group_norm_partial(
        x.data_ptr(), scratch.data_ptr(), moments.data_ptr(), cplan, stream)
    _build.check(rc, "group_norm_partial")
    partial_launches += 1
    split_launches_by_shape[launch.partial_key] += 1
    return moments


def combine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            moments: torch.Tensor, *, num_groups: int, eps: float,
            silu: bool = False, per_frame: bool = False) -> torch.Tensor:
    """This rank's rows of a split GroupNorm(+SiLU) from every rank's
    :func:`partial_moments` stacked (R, B', G, 3) in rank order: on the
    card K1's combine entry (``gn_combine``, one launch: Chan's formula
    over the ranks in rank order, in double, the affine and the apply), on
    the CPU ``combine_plain``."""
    if x.is_cpu:
        return combine_plain(x, weight, bias, moments, num_groups=num_groups,
                             eps=eps, silu=silu, per_frame=per_frame)
    return _combine(x, weight, bias, moments, num_groups, eps, silu,
                    per_frame, False)[0]


def combine_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  moments: torch.Tensor, *, num_groups: int, eps: float,
                  silu: bool = False, per_frame: bool = False):
    """(y, stats) of K1's combine entry on a CUDA tensor: y as
    :func:`combine`'s, stats (B', G, 2) fp32 each (row, group)'s mean and
    1/std, which the entry writes for a caller that asks."""
    return _combine(x, weight, bias, moments, num_groups, eps, silu,
                    per_frame, True)


def _combine(x, weight, bias, moments, num_groups, eps, silu, per_frame,
             keep_stats):
    """K1's combine entry on CUDA ``x``: (y, stats or None)."""
    global combine_launches
    dev, cplan, launch = _split_launch("group_norm_combine", x, num_groups,
                                       per_frame)
    moments, w32, b32 = _combine_operands(x, weight, bias, moments, dev,
                                          launch)
    y = torch.empty_like(x)
    stats = (torch.empty((launch.dims[0], num_groups, 2), device=x.device,
                         dtype=torch.float32) if keep_stats else None)
    rc = _build.library().cvvae_group_norm_combine(
        x.data_ptr(), y.data_ptr(), w32.data_ptr(), b32.data_ptr(),
        moments.data_ptr(), moments.shape[0],
        None if stats is None else stats.data_ptr(), cplan, eps, silu,
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(rc, "group_norm_combine")
    combine_launches += 1
    split_launches_by_shape[launch.combine_key] += 1
    return y, stats


def partial_moments_pair(x: torch.Tensor, num_groups: int,
                         per_frame: bool) -> torch.Tensor:
    """K1.partial in its two-launch form on a CUDA tensor (``gn_stats``,
    then ``gn_partial_fold``: the same sums in the same order), on no path
    and not counted: the reference of the card's checks and of
    ``utils/kernel_variants.py``."""
    dev, cplan, launch = _split_launch("group_norm_partial_pair", x,
                                       num_groups, per_frame)
    part = torch.empty(launch.part_bytes // 8, device=x.device,
                       dtype=torch.float64)
    moments = torch.empty(launch.moments_shape, device=x.device,
                          dtype=torch.float64)
    rc = _build.library().cvvae_group_norm_partial_pair(
        x.data_ptr(), part.data_ptr(), moments.data_ptr(), cplan,
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(rc, "group_norm_partial_pair")
    return moments


def combine_pair(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 moments: torch.Tensor, *, num_groups: int, eps: float,
                 silu: bool = False, per_frame: bool = False):
    """K1.combine in its two-launch form on a CUDA tensor
    (``gn_combine_coef`` writes the affine, ``gn_apply`` applies it), on
    no path and not counted, as :func:`partial_moments_pair`: (y, stats)
    as :func:`combine_stats` gives them."""
    dev, cplan, launch = _split_launch("group_norm_combine_pair", x,
                                       num_groups, per_frame)
    moments, w32, b32 = _combine_operands(x, weight, bias, moments, dev,
                                          launch)
    b, _, c = launch.dims
    y = torch.empty_like(x)
    coef = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    stats = torch.empty((b, num_groups, 2), device=x.device,
                        dtype=torch.float32)
    rc = _build.library().cvvae_group_norm_combine_pair(
        x.data_ptr(), y.data_ptr(), w32.data_ptr(), b32.data_ptr(),
        moments.data_ptr(), moments.shape[0], coef.data_ptr(),
        stats.data_ptr(), cplan, eps, silu,
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(rc, "group_norm_combine_pair")
    return y, stats


#: the split entries' plan (``csrc/groupnorm.cu``): blocks an SM it aims
#: at over all batch rows and rows a block at the least; the ticket
#: counters at the head of a partial's scratch (uint32, one a batch row)
SPLIT_BLOCKS_PER_SM, SPLIT_MIN_ROWS, SPLIT_TICKETS = _build.constants(
    "groupnorm.cu", "kSplitBlocksPerSm", "kSplitMinRows", "kTickets")


def split_plan(b: int, s: int, c: int, g: int, elem_size: int,
               blocks_per_sm: int | None = None,
               min_rows: int | None = None) -> dict:
    """K1.partial's and K1.combine's plan for one rank's (b, s, c) with g
    groups: ``launch_plan``'s vector width, groups a vector spans and
    threads; about ``blocks_per_sm`` (SPLIT_BLOCKS_PER_SM) blocks an SM of
    the H100's 132 over all batch rows, each a run of ``rows_per_block``
    rows, at least ``min_rows`` (SPLIT_MIN_ROWS) where s has them.  Block k
    of a batch row reads rows [k * rows_per_block, min(s, (k + 1) *
    rows_per_block)), and the partial's fold adds the blocks' moments in
    the order of k.  With 8 blocks an SM and 1 row it is ``launch_plan``."""
    bps = SPLIT_BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm
    least = SPLIT_MIN_ROWS if min_rows is None else min_rows
    plan = launch_plan(b, s, c, g, elem_size)
    want = max(1, 132 * bps // b)
    rows = max(plan["rows_per_iter"], min(s, least), -(-s // want))
    plan.update(rows_per_block=rows, n_blocks=-(-s // rows))
    return plan


class _SplitLaunch(collections.namedtuple(
        "_SplitLaunch", "dims align part_bytes moments_shape partial_key "
        "combine_key")):
    """What a split entry's launch on one shape needs besides its plan
    struct: (B', S, C), the loads' alignment in bytes, the block moments'
    bytes, the moments' shape and the keys of ``split_launches_by_shape``."""


def _split_launch(name, x, num_groups, per_frame):
    """(x's card, the kernel's plan struct, ``_SplitLaunch``) of a split
    entry's launch on CUDA ``x``, or raise; the plan made once a shape."""
    if x.requires_grad and torch.is_grad_enabled():
        _build.refuse_gradient(f"{name} (K1 split)", "none: the mesh runs "
                               "inference", x)
    if not x.is_contiguous() or x.dtype not in _DTYPE_NAMES:
        _build.require_cuda_layout(name, x, x.ndim)
    dev = x.get_device()
    key = (x.shape, x.dtype, num_groups, per_frame, dev)
    found = _split_plans.get(key)
    if found is None:
        found = _split_plans[key] = _split_plan_of(name, *key)
    if x.data_ptr() % found[1].align:
        raise ValueError(f"{name}: input is not aligned to its "
                         f"{found[1].align // x.element_size()}-element "
                         f"loads")
    return (dev,) + found


#: each split launch's (plan struct, ``_SplitLaunch``) by (shape, dtype,
#: groups, per_frame, card), made by ``_split_plan_of``
_split_plans: dict = {}


def _split_plan_of(name, shape, dtype, num_groups, per_frame, dev):
    """(the plan struct, ``_SplitLaunch``) of a split launch on a tensor of
    ``shape`` and ``dtype`` on card ``dev``; raises on a shape the kernels
    do not take."""
    if dev < 0:
        raise ValueError(f"{name}: expected a CUDA tensor")
    b, s, c = _dims(name, shape, num_groups, per_frame)
    plan = split_plan(b, s, c, num_groups, dtype.itemsize)
    cplan = _build.GroupNormSplitPlan(
        s, plan["rows_per_block"], b, c, num_groups, plan["v"], plan["ns"],
        plan["threads"], plan["n_blocks"], _build.DTYPE_CODES[dtype], dev)
    tail = f" {tuple(shape)} per_frame={per_frame}"
    return cplan, _SplitLaunch(
        (b, s, c), plan["v"] * dtype.itemsize,
        b * plan["n_blocks"] * num_groups * 2 * 8, (b, num_groups, 3),
        "partial" + tail, "combine" + tail)


def use_split_plan(blocks_per_sm: int | None = None,
                   min_rows: int | None = None) -> None:
    """Plan the split entries with ``blocks_per_sm`` and ``min_rows``
    (``split_plan``'s; None: the source's constants) from here on: for
    ``utils/kernel_variants.py``, which times the kernels on other plans."""
    global SPLIT_BLOCKS_PER_SM, SPLIT_MIN_ROWS
    source = _build.constants("groupnorm.cu", "kSplitBlocksPerSm",
                              "kSplitMinRows")
    SPLIT_BLOCKS_PER_SM = source[0] if blocks_per_sm is None \
        else blocks_per_sm
    SPLIT_MIN_ROWS = source[1] if min_rows is None else min_rows
    _split_plans.clear()


#: each (card, stream)'s partial scratch: SPLIT_TICKETS ticket counters,
#: zero between launches (each launch leaves them zero), then the block
#: moments; grown where a launch needs more, never shrunk
_scratch: dict = {}


def _partial_scratch(dev: int, stream: int, part_bytes: int) -> torch.Tensor:
    need = SPLIT_TICKETS * 4 + part_bytes
    buf = _scratch.get((dev, stream))
    if buf is None or buf.numel() < need:
        size = need if buf is None else max(need, 2 * buf.numel())
        buf = torch.zeros(size, device=torch.device("cuda", dev),
                          dtype=torch.uint8)
        _scratch[(dev, stream)] = buf
    return buf


def _combine_operands(x, weight, bias, moments, dev, launch):
    """(moments, weight, bias) as the combine entry reads them: moments
    (R, B', G, 3) float64 contiguous on x's card (else raise), weight and
    bias fp32 contiguous on it (copied only where they are not)."""
    b, _, c = launch.dims
    if (moments.dtype != torch.float64 or moments.get_device() != dev
            or moments.shape[1:] != launch.moments_shape):
        raise ValueError(f"group_norm_combine: moments "
                         f"{tuple(moments.shape)} {moments.dtype} on "
                         f"{moments.device}, expected (R, "
                         f"{', '.join(map(str, launch.moments_shape))}) "
                         f"float64 on {x.device}")
    return (moments.contiguous(), _fp32_on(weight, dev, c),
            _fp32_on(bias, dev, c))


def _fp32_on(t: torch.Tensor, dev: int, c: int) -> torch.Tensor:
    """``t`` as a contiguous fp32 (c,) tensor on card ``dev``: itself where
    it is one."""
    if not (t.dtype == torch.float32 and t.get_device() == dev
            and t.is_contiguous()):
        t = t.detach().to(device=torch.device("cuda", dev),
                          dtype=torch.float32).contiguous()
    if t.shape != (c,):
        raise ValueError(f"group_norm_combine: a parameter of shape "
                         f"{tuple(t.shape)}, expected ({c},)")
    return t


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


def _fma(x: float, n: int, y: float) -> float:
    """x·n + y with one rounding to float64, as the card's double fused
    multiply-add rounds it (Python's int true division rounds
    correctly)."""
    xn, xd = x.as_integer_ratio()
    yn, yd = y.as_integer_ratio()
    d = max(xd, yd)  # both powers of two
    return (xn * n * (d // xd) + yn * (d // yd)) / d


def _rsqrt_rn(x: np.ndarray) -> np.ndarray:
    """1/sqrt(x) of float32 ``x`` correctly rounded to float32 (the card's
    ``__frsqrt_rn``): float64's, moved to the neighbour where an exact
    test against the midpoints says so."""
    r = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    for i in zip(*np.nonzero(np.isfinite(r) & (x > 0))):
        xv, c = Fraction(float(x[i])), r[i]
        up = np.nextafter(c, np.float32(np.inf))
        down = np.nextafter(c, np.float32(0))
        if ((Fraction(float(c)) + Fraction(float(up))) / 2) ** 2 * xv < 1:
            r[i] = up
        elif ((Fraction(float(c)) + Fraction(float(down))) / 2) ** 2 * xv > 1:
            r[i] = down
    return r


def _kernel_moments(q: torch.Tensor, s: torch.Tensor, num_groups: int,
                    eps: float):
    """(mean, 1/std), each (B, G) fp32, of q·s in K1.int8's own order
    (``csrc/groupnorm.cu``): gnq_stats' exact per-channel sums of q and q²
    over each block of ``int8_plan``'s rows; gnq_merge's (group, row)
    block, whose thread t adds s[c]·Σq and s[c]²·Σq² (a fused
    multiply-add, in double) over the (block, channel) pairs t, t + 256,
    ..., then a tree over the 256 threads; mean and mean of squares
    rounded once to fp32, var = fl(msq − fl(mean²)), 1/std correctly
    rounded.  Computed on the CPU, for any device's q; the oracle of the
    kernel's moments, which no path runs."""
    b, c = q.shape[0], q.shape[-1]
    rows = q.reshape(b, -1, c).cpu().to(torch.int64)
    n_rows = rows.shape[1]
    plan = int8_plan(b, n_rows, c)
    nb, rpb = plan["n_blocks"], plan["rows_per_block"]
    rows = torch.nn.functional.pad(rows, (0, 0, 0, nb * rpb - n_rows))
    part = rows.reshape(b, nb, rpb, c)
    s1 = part.sum(2).numpy()
    s2 = part.square().sum(2).numpy()
    sc = s.cpu().float().expand(c).numpy().astype(np.float64)
    cg = c // num_groups
    threads = MERGE_THREADS
    red = np.zeros((2, b, num_groups, threads))
    for bi in range(b):
        for g in range(num_groups):
            for i in range(nb * cg):
                k, ch = divmod(i, cg)
                ch += g * cg
                t = i % threads
                # s·Σq is exact in double (|Σq| < 2^25), so its fma is
                # an add of the product
                red[0, bi, g, t] += sc[ch] * s1[bi, k, ch]
                red[1, bi, g, t] = _fma(sc[ch] * sc[ch], int(s2[bi, k, ch]),
                                        red[1, bi, g, t])
    o = threads // 2
    while o:
        red[..., :o] = red[..., :o] + red[..., o:2 * o]
        o //= 2
    n = float(n_rows) * cg
    mean = (red[0, ..., 0] / n).astype(np.float32)
    msq = (red[1, ..., 0] / n).astype(np.float32)
    var = msq - mean * mean
    inv = _rsqrt_rn(var + np.float32(eps))
    return (torch.from_numpy(mean).to(q.device),
            torch.from_numpy(inv).to(q.device))


#: the order the CPU's plain int8 GroupNorm sums its moments in
#: (``int8_moment_order``)
_plain_int8_order = "xla"


@contextlib.contextmanager
def int8_moment_order(order: str):
    """Within the block, the plain int8 GroupNorm takes its moments in
    ``order``: "xla" (the default: XLA's CPU order on the CPU, the JAX
    package's bits; PyTorch's sum on the card) or "kernel" (K1.int8's own,
    ``_kernel_moments``).  For the tests and ``chip_smoke.py``, which hold
    the card's chain against a CPU chain in the kernel's order."""
    global _plain_int8_order
    if order not in ("xla", "kernel"):
        raise ValueError(f"int8 moment order {order!r}: 'xla' or 'kernel'")
    before, _plain_int8_order = _plain_int8_order, order
    try:
        yield
    finally:
        _plain_int8_order = before


def _int8_coef(q: torch.Tensor, scale: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, num_groups: int, eps: float):
    """The folded affine (a, b), each (B, C) fp32, of K1's int8 mode on
    ``q`` (B, ..., C): the fp32 moments of q·s over every axis but B and
    the groups (JAX's, ``_fp32_means``; K1.int8's within
    ``int8_moment_order("kernel")``, ``_kernel_moments``), var = E[x²] −
    mean², a = inv·γ·s, b = β − mean·inv·γ."""
    c = q.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups "
                         f"{num_groups}")
    cg = c // num_groups
    grouped = q.reshape(q.shape[:-1] + (num_groups, cg))
    s = scale.to(device=q.device, dtype=torch.float32)
    s_g = s.expand(c).reshape(num_groups, cg) if s.ndim else s
    if _plain_int8_order == "kernel":
        mean, inv = (m.reshape(q.shape[:1] + (1,) * (grouped.ndim - 3)
                               + (num_groups, 1))
                     for m in _kernel_moments(q, s, num_groups, eps))
    else:
        axes = tuple(range(1, grouped.ndim - 2)) + (grouped.ndim - 1,)
        mean, msq = _fp32_means(grouped.float() * s_g, axes)
        inv = torch.rsqrt(msq - mean.square() + eps)
    w = weight.to(device=q.device, dtype=torch.float32).reshape(num_groups,
                                                                 cg)
    b = bias.to(device=q.device, dtype=torch.float32).reshape(num_groups, cg)
    a = (inv * w * s_g).reshape(q.shape[0], c)
    shift = (b - mean * inv * w).reshape(q.shape[0], c)
    return a, shift


def _int8_apply_plain(qf: torch.Tensor, a: torch.Tensor, shift: torch.Tensor,
                      out_scale, out_dtype) -> torch.Tensor:
    """SiLU(qf·a + shift) (the product and the sum each rounded to fp32),
    as int8 at the scalar ``out_scale`` or as ``out_dtype``: K1's int8
    mode's arithmetic on codes ``qf`` (fp32, broadcast against ``a`` and
    ``shift``)."""
    h = qf * a + shift
    h = h * torch.sigmoid(h)
    if out_scale is None:
        return h.to(out_dtype)
    return _int8_requant(h, out_scale)


#: every int8 code, in the order of its byte (0..127, then -128..-1): the
#: table's last axis
INT8_CODES = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
    torch.int8)


def int8_table_plain(a: torch.Tensor, shift: torch.Tensor, out_scale=None,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """K1's int8 mode's table: for (B, C) coefficients, the (B, C, 256)
    outputs of every code, entry u that of the code whose byte is u
    (``INT8_CODES``), by ``_int8_apply_plain``: the oracle that the
    kernel's table is held to (``chip_smoke.k1_int8_table_check``)."""
    codes = INT8_CODES.to(a.device).float()
    return _int8_apply_plain(codes, a[..., None], shift[..., None], out_scale,
                             out_dtype)


def int8_lookup(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """y[b, ..., c] = table[b, c, byte of q[b, ..., c]] for a (B, C, 256)
    table and int8 ``q`` (B, ..., C)."""
    b, c = q.shape[0], q.shape[-1]
    u = q.reshape(b, -1, c).view(torch.uint8).long()
    idx = (torch.arange(c, device=q.device) * 256 + u).reshape(b, -1)
    return torch.gather(table.reshape(b, c * 256), 1, idx).reshape(q.shape)


def group_norm_silu_int8_plain(q: torch.Tensor, scale: torch.Tensor,
                               weight: torch.Tensor, bias: torch.Tensor, *,
                               num_groups: int, eps: float,
                               out_scale=None,
                               out_dtype=torch.bfloat16) -> torch.Tensor:
    """K1's int8 mode in plain PyTorch, the JAX package's arithmetic
    (``cvvae_tpu/ops/qflow.py:138-172``): ``q`` (B, ..., C) int8 with
    ``scale`` an fp32 scalar or (C,); the folded affine of its fp32
    moments (``_int8_coef``), and h = q·a + b, SiLU, requantized at the
    scalar ``out_scale`` or cast to ``out_dtype``, element by element
    (``_int8_apply_plain``)."""
    a, shift = _int8_coef(q, scale, weight, bias, num_groups, eps)
    mid = (1,) * (q.ndim - 2)
    b, c = a.shape
    return _int8_apply_plain(q.float(), a.reshape((b,) + mid + (c,)),
                             shift.reshape((b,) + mid + (c,)), out_scale,
                             out_dtype)


#: K1's int8 mode's schedule (``csrc/groupnorm.cu``): codes a stats load
#: (where C allows) and threads a stats block at most, rows a stats block
#: may take, threads of a merge block and of an apply block, and channels
#: a 64 KB half of the apply's table
(INT8_STATS_V, INT8_STATS_THREADS, INT8_MAX_BLOCK_ROWS, MERGE_THREADS,
 INT8_APPLY_THREADS, INT8_HALF_CHANNELS) = _build.constants(
    "groupnorm.cu", "kStatsV", "kStatsThreads", "kMaxBlockRows",
    "kMergeThreads", "kApplyThreads", "kHalfChannels")
#: the stats pass's shared memory may not pass the 48 KB a launch has
#: without asking
INT8_STATS_SMEM = 48 * 1024
#: the shared memory an H100 block may have; stats and apply blocks: one
#: an SM
BLOCK_SMEM = 232448
INT8_BLOCKS = 132


@functools.lru_cache(maxsize=256)
def int8_plan(b: int, s: int, c: int) -> dict:
    """K1's int8 mode's plan for int8 x (b, s, c).  The stats pass (also
    the arithmetic apply's plan): v codes a load (INT8_STATS_V, else 2 or
    1, the widest dividing C), threads (the multiple of C / v up to
    INT8_STATS_THREADS), rows_per_iter, and blocks a batch row with their
    rows (one an SM over all, at most INT8_MAX_BLOCK_ROWS a block, where
    the int32 sums of q² still fit), its shared memory (stats_smem: every
    thread's per-channel sums).  The table apply: the channel slice cs a
    block takes (128, 64, or 32, the widest dividing C; 0 where C is no
    multiple of 32: the arithmetic apply), the slices, and apply blocks a
    (batch row, slice) with their rows, one an SM over all; table_smem its
    shared-memory table (a 64 KB half per 64 channels)."""
    v = next(v for v in (INT8_STATS_V, 2, 1) if c % v == 0)
    nvc = c // v
    rows_per_iter = INT8_STATS_THREADS // nvc
    threads = -(-rows_per_iter * nvc // 32) * 32
    want = max(1, INT8_BLOCKS // b)
    rows_per_block = min(INT8_MAX_BLOCK_ROWS,
                         max(rows_per_iter, -(-s // want)))
    cs = next((cs for cs in (128, 64, 32) if c % cs == 0), 0)
    n_slices = c // cs if cs else 0
    per_slice = max(1, INT8_BLOCKS // (b * n_slices)) if cs else 0
    apply_rows = -(-s // per_slice) if cs else 0
    halves = -(-cs // INT8_HALF_CHANNELS)
    return dict(v=v, threads=threads, rows_per_iter=rows_per_iter,
                rows_per_block=rows_per_block,
                n_blocks=-(-s // rows_per_block),
                stats_smem=4 * 2 * rows_per_iter * c, cs=cs,
                n_slices=n_slices, apply_rows_per_block=apply_rows,
                apply_blocks=-(-s // apply_rows) if cs else 0,
                table_smem=halves * 256 * INT8_HALF_CHANNELS * 4)


def int8_table_entries(words: torch.Tensor, c: int, cs: int,
                       dtype) -> torch.Tensor:
    """The kernel's table scratch, (B, C / cs, 256, cs) 32-bit words, as
    (B, C, 256) values of ``dtype`` (int8 codes, bf16 or fp32)."""
    b = words.shape[0]
    w = words.reshape(b, c // cs, 256, cs).permute(0, 1, 3, 2).reshape(
        b, c, 256).contiguous()
    if dtype == torch.float32:
        return w.view(torch.float32)
    if dtype == torch.int8:
        return (w & 0xff).to(torch.uint8).view(torch.int8)
    return (((w & 0xffff) ^ 0x8000) - 0x8000).to(torch.int16).view(
        torch.bfloat16)


def _int8_launch(q, scale, weight, bias, num_groups, eps, out_scale,
                 out_dtype):
    """K1's int8 mode on a CUDA tensor: (y, coef (B, 2, C) fp32, the
    table's words or None, the plan)."""
    global int8_launches
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
    plan = int8_plan(b, s, c)
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: input is not aligned to 16 bytes")
    dev = q.device
    dtype = torch.int8 if out_scale is not None else out_dtype
    y = torch.empty(q.shape, device=dev, dtype=dtype)
    # the scratch in one allocation: the table's words, the stats' sums,
    # the affine
    n_part = b * plan["n_blocks"] * c * 2
    n_table = b * c * 256 if plan["cs"] else 0
    scratch = torch.empty(n_table + n_part + b * 2 * c, device=dev,
                          dtype=torch.int32)
    table = scratch[:n_table].view(b, c * 256) if n_table else None
    part = scratch[n_table:n_table + n_part]
    coef = scratch[n_table + n_part:].view(torch.float32).view(b, 2, c)
    s32 = scale.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    o32 = (None if out_scale is None else
           out_scale.to(device=dev, dtype=torch.float32).reshape(1))
    w32 = weight.detach().to(device=dev, dtype=torch.float32).contiguous()
    b32 = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    rc = _build.library().cvvae_group_norm_int8(
        q.data_ptr(), s32.data_ptr(), int(s32.numel() > 1), y.data_ptr(),
        w32.data_ptr(), b32.data_ptr(), part.data_ptr(), coef.data_ptr(),
        None if table is None else table.data_ptr(),
        None if o32 is None else o32.data_ptr(), b, s, c, num_groups, eps,
        _build.INT8_CODE if o32 is not None else _build.DTYPE_CODES[dtype],
        plan["v"], plan["threads"], plan["rows_per_block"],
        plan["n_blocks"], plan["cs"], plan["apply_rows_per_block"],
        plan["apply_blocks"], dev.index or 0, _build.stream_of(q))
    _build.check(rc, name)
    int8_launches += 1
    return y, coef, table, plan


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
    if q.device.type == "cpu":
        return group_norm_silu_int8_plain(
            q, scale, weight, bias, num_groups=num_groups, eps=eps,
            out_scale=out_scale, out_dtype=out_dtype)
    return _int8_launch(q, scale, weight, bias, num_groups, eps, out_scale,
                        out_dtype)[0]
