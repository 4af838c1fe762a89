"""K4: single-head flash attention — hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``cvvae_tpu/ops/attention.py:60`` ``_flash_attention`` (the
stock Pallas TPU flash attention, which pads S to a multiple of 512
behind segment ids).  What bounds it on an H100: 4·B·S²·C FLOP (2.12
TFLOP at the v1 encoder's (5, 14400, 512), 2.15 ms at 989 TFLOP/s bf16);
q, k, v and out are 0.3 GB.  The design (``csrc/attention.cu``), bf16: a
block of two warpgroups per 64-query tile, each owning half of C (the
64×512 fp32 output does not fit one warpgroup's registers).  Each
computes its half of the logits with wgmma (Q's fragments in registers,
K from shared memory), the halves are summed through shared memory, both
run the same online softmax (fp32 row max and sum), and P stays in
registers as the A operand of the P·V wgmma, which runs while the next
tile's logits are turned into probabilities.  Two threads issue TMA loads
of 32-key K and V tiles into two-stage rings; blocks of neighbouring query
tiles pair up in a cluster and multicast each tile to both.  The ragged
tail is masked in the kernel (TMA zero-fills rows ≥ S; keys ≥ S get
logit −inf).  fp32 keeps 32-query tiles of fp32 FMAs (no TF32).

The plain version is the port's exact attention: fp32 logits and
softmax, weights cast to v's dtype, the value product accumulated in
fp32 and rounded once, blocked over 512-query chunks so the (S, S)
logits never exist at once.  In fp32 the two agree to about 1e-6; in
bf16 the kernel rounds the unnormalised probabilities and the plain
version the normalised weights, a few bf16 ulps apart.
"""

from __future__ import annotations

import torch

from cvvae_tpu_torch.ops.kernels import _build

#: head widths the kernel is instantiated for
WIDTHS = (64, 128, 256, 512)

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0


def _attention_block(q_blk: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, scale: float) -> torch.Tensor:
    """Exact attention for one query block.  q_blk:(B,Sq,C) k,v:(B,S,C)."""
    logits = torch.matmul(q_blk.float(), k.float().transpose(1, 2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, q_chunk: int = 512) -> torch.Tensor:
    """Exact single-head attention on (B, S, C): one block up to
    ``q_chunk`` queries, else a full-row softmax per block of
    ``q_chunk`` queries."""
    if q.shape[1] <= q_chunk:
        return _attention_block(q, k, v, scale)
    k = k.float()  # once, not per block
    return torch.cat([_attention_block(q[:, i:i + q_chunk], k, v, scale)
                      for i in range(0, q.shape[1], q_chunk)], dim=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v of contiguous (B, S, C) tensors.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda_layout(f"flash_attention {name}", t, 3)
    layouts = [(tuple(t.shape), t.dtype, t.device) for t in (q, k, v)]
    if layouts[1] != layouts[0] or layouts[2] != layouts[0]:
        raise ValueError(f"flash_attention: q, k, v differ: {layouts}")
    b, s, c = q.shape
    if c not in WIDTHS:
        raise ValueError(f"flash_attention: C={c} not supported {WIDTHS}")
    if not 0 < b <= 65535 or s == 0:
        raise ValueError(f"flash_attention: bad shape {tuple(q.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    rc = _build.library().cvvae_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, c,
        float(scale), _build.DTYPE_CODES[q.dtype], q.device.index or 0,
        _build.stream_of(q))
    _build.check(rc, "flash_attention")
    launches += 1
    return out
