"""K4: single-head flash attention, and its backward K4.bwd —
hand-written CUDA kernels and their plain PyTorch versions.

Replaces ``cvvae_tpu/ops/attention.py:60`` ``_flash_attention`` (the
stock Pallas TPU flash attention, which pads S to a multiple of 512
behind segment ids) and, for its gradient, the stock kernel's
``custom_vjp`` (``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``).  What bounds K4 on an H100: 4·B·S²·C FLOP
(2.12 TFLOP at the v1 encoder's (5, 14400, 512), 2.15 ms at 989 TFLOP/s
bf16); q, k, v and out are 0.3 GB.  The design (``csrc/attention.cu``),
bf16: a block of two warpgroups per 64-query tile, each owning half of C
(the 64×512 fp32 output does not fit one warpgroup's registers).  Each
computes its half of the logits with wgmma (Q's fragments in registers,
K from shared memory), the halves are summed through shared memory, both
run the same online softmax (fp32 row max and sum), and P stays in
registers as the A operand of the P·V wgmma, which runs while the next
tile's logits are turned into probabilities.  Two threads issue TMA loads
of 32-key K and V tiles into two-stage rings; blocks of neighbouring query
tiles pair up in a cluster and multicast each tile to both.  The ragged
tail is masked in the kernel (TMA zero-fills rows ≥ S; keys ≥ S get
logit −inf).  The kernel is bf16 only, as the reference's flash is
(``_flash_usable``): fp32 attention takes the exact path.

``flash_attention`` is a ``torch.autograd.Function``.  Where an input
needs a gradient, K4 also writes each query row's logsumexp of its scaled
logits (fp32, (B, S), natural log, taken against the running max its row
sum was accumulated with); the serving launch passes no buffer for it.
The backward launches K4.bwd (``csrc/attention_bwd.cu``): D =
rowsum(dO∘O) in fp32; dkv, a thread-block cluster per 64-key tile that
splits C into slices of 128 columns (4 CTAs at C = 512,
``backward_plan``), each CTA forming its slice's partial logits and dP
with wgmma (operands by TMA into mbarrier rings), the
partials summed across the cluster in rank order through distributed
shared memory, P recomputed from the logsumexp and dS = P∘(dP − D) in
fp32, dv += Pᵀ·dO and dk += dSᵀ·Q over the slice; dkv leaves dSᵀ in bf16
in a scratch buffer, and dq is the wgmma product dS·K over it.  No
atomics (two calls give the same bits).  Bound: 10·B·S²·C FLOP, which is
also what it executes.

The plain versions are the port's exact attention and its gradient
(``ops/exact_attention.py``): fp32 logits and softmax, weights cast to
v's dtype, the value product accumulated in fp32 and rounded once.  The
kernel rounds the unnormalised probabilities to bf16 and the plain
version the normalised weights, a few bf16 ulps apart; K4.bwd rounds P
and dS to bf16 as product operands, its plain version keeps them fp32.
"""

from __future__ import annotations

import torch

from cvvae_tpu_torch.ops.exact_attention import (attention_backward,
                                                 attention_lse,
                                                 exact_attention)
from cvvae_tpu_torch.ops.kernels import _build

#: head widths the kernels are instantiated for
WIDTHS = (64, 128, 256, 512)

#: launches of K4 and of its backward K4.bwd (the CPU path does not count)
launches = 0
bwd_launches = 0

#: K4.bwd's schedule, read from its source: rows a tile; dkv's head-dim
#: columns a CTA and walk tiles in flight; dq's columns a CTA and key tiles
#: in flight; threads a CTA
(BWD_TILE, BWD_SLICE, BWD_STAGES, BWD_DQ_COLS, BWD_DQ_STAGES,
 BWD_THREADS) = _build.constants(
    "attention_bwd.cu", "kTile", "kSliceCols", "kStages", "kDqCols",
    "kDqStages", "kThreads")
#: shared memory one block may have on an H100
SMEM_LIMIT = 232448


def backward_plan(b: int, s: int, c: int, slice_cols: int = BWD_SLICE,
                  stages: int = BWD_STAGES) -> dict:
    """K4.bwd's launches as ``csrc/attention_bwd.cu`` makes them for
    (B, S, C) inputs.

    dkv: each CTA owns ``slice`` head-dim columns (C where C <
    ``slice_cols``), a cluster of ``cluster`` = C / slice CTAs takes one
    64-key tile: grid (cluster · tiles, B), rank r = x mod cluster on
    columns [r·slice, (r+1)·slice); ``smem``: its ``Layout`` (the own
    tile, ``stages`` walk tiles, two fp32 exchange buffers, two bf16 P/dS
    buffers, 1 KB for alignment).  dq: ``dq_cols`` columns a CTA, grid
    (C / dq_cols · tiles, B), ``dq_smem`` its ring.  ``scratch_bytes``:
    D (B·S fp32, rounded up to 1 KB), then dSᵀ (B·S'·S' bf16, S' = 64 ·
    tiles), which dkv writes and dq reads."""
    sl = min(c, slice_cols)
    cw = min(c, BWD_DQ_COLS)
    tiles = -(-s // BWD_TILE)
    sp = tiles * BWD_TILE
    tile_bytes = BWD_TILE * sl * 2
    exchange = 2 * BWD_TILE * BWD_TILE * 4
    operands = 2 * BWD_TILE * BWD_TILE * 2
    return {"slice": sl, "cluster": c // sl, "tiles": tiles,
            "grid": (c // sl * tiles, b), "threads": BWD_THREADS,
            "smem": (2 + 2 * stages) * tile_bytes + 2 * exchange
            + 2 * operands + 1024,
            "dq_cols": cw, "dq_grid": (c // cw * tiles, b),
            "dq_smem": BWD_DQ_STAGES * BWD_TILE * (BWD_TILE + cw) * 2
            + 1024,
            "scratch_bytes": -(-b * s * 4 // 1024) * 1024 + b * sp * sp * 2}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """K4's plain version: the port's exact attention."""
    return exact_attention(q, k, v, scale)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """The logsumexp K4 writes, plain: (B, S) fp32, natural log."""
    return attention_lse(q, k, scale)


def flash_attention_backward_plain(q, k, v, o, do, lse, scale: float):
    """K4.bwd's plain version: (dq, dk, dv), every sum in fp32."""
    return attention_backward(q, k, v, o, do, lse, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v of contiguous (B, S, C) bf16 tensors,
    differentiable in q, k and v.

    A CPU tensor takes the plain versions forward and backward; a CUDA
    tensor launches K4 forward and K4.bwd backward, or raises (fp32 too:
    it takes the exact path, not this one)."""
    return _FlashAttention.apply(q, k, v, scale)


class _FlashAttention(torch.autograd.Function):
    """K4 and K4.bwd, or their plain versions on a CPU tensor; the forward
    keeps the rows' logsumexp for the backward only when an input needs a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        need = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, scale)
            lse = flash_attention_lse_plain(q, k, scale) if need else None
        else:
            out, lse = _launch(q, k, v, scale, need)
        if need:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, do, lse, ctx.scale),
                None)


def _check(name: str, tensors) -> None:
    """Raise unless ``tensors`` are contiguous (B, S, C) bf16 CUDA tensors
    of one shape that K4 and K4.bwd take."""
    for i, t in enumerate(tensors):
        _build.require_cuda_layout(f"{name} input {i}", t, 3)
    t0 = tensors[0]
    if t0.dtype != torch.bfloat16:
        raise ValueError(f"{name}: dtype {t0.dtype} not supported "
                         f"(bfloat16; fp32 takes ops/attention.py's exact "
                         f"path)")
    layouts = [(tuple(t.shape), t.dtype, t.device) for t in tensors]
    if any(lay != layouts[0] for lay in layouts):
        raise ValueError(f"{name}: inputs differ: {layouts}")
    b, s, c = t0.shape
    if c not in WIDTHS:
        raise ValueError(f"{name}: C={c} not supported {WIDTHS}")
    if not 0 < b <= 65535 or s == 0:
        raise ValueError(f"{name}: bad shape {tuple(t0.shape)}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _launch(q, k, v, scale, with_lse=False):
    """K4 on CUDA tensors: (out, the rows' logsumexp (B, S) fp32 where
    ``with_lse``, else None)."""
    global launches
    _check("flash_attention", (q, k, v))
    b, s, c = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, s), device=q.device, dtype=torch.float32)
           if with_lse else None)
    rc = _build.library().cvvae_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, c, float(scale),
        _build.DTYPE_CODES[q.dtype], q.device.index or 0, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    launches += 1
    return out, lse


def flash_attention_backward(q, k, v, o, do, lse, scale: float):
    """K4.bwd (``csrc/attention_bwd.cu``): (dq, dk, dv) in bf16 of
    contiguous CUDA (B, S, C) bf16 q, k, v, the forward's output ``o`` and
    its gradient ``do``, and the (B, S) fp32 logsumexp K4 wrote.  A CPU
    tensor takes the plain version.  The kernel's scratch (D, then dSᵀ:
    B·S'² bf16, S' = S rounded up to 64) is allocated here."""
    global bwd_launches
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, do, lse, scale)
    do = do.contiguous()
    _check("flash_attention_backward", (q, k, v, o, do))
    b, s, c = q.shape
    if (lse is None or lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, s) or not lse.is_contiguous()):
        raise ValueError("flash_attention_backward: lse must be the "
                         "forward's contiguous (B, S) fp32 logsumexp")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = torch.empty(backward_plan(b, s, c)["scratch_bytes"],
                          device=q.device, dtype=torch.uint8)
    rc = _build.library().cvvae_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, c, float(scale), _build.DTYPE_CODES[q.dtype],
        q.device.index or 0, _build.stream_of(q))
    _build.check(rc, "flash_attention_backward")
    bwd_launches += 1
    return dq, dk, dv
