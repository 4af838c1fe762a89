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
logit −inf).  The kernel is bf16 only, as the reference's flash is
(``_flash_usable``): fp32 attention takes the exact path.

The plain version is the port's exact attention
(``ops/exact_attention.py``): fp32 logits and softmax, weights
cast to v's dtype, the value product accumulated in fp32 and rounded
once.  The kernel rounds the unnormalised probabilities to bf16 and the
plain version the normalised weights, a few bf16 ulps apart.
"""

from __future__ import annotations

import torch

from cvvae_tpu_torch.ops.exact_attention import exact_attention
from cvvae_tpu_torch.ops.kernels import _build

#: head widths the kernel is instantiated for
WIDTHS = (64, 128, 256, 512)

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """K4's plain version: the port's exact attention."""
    return exact_attention(q, k, v, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v of contiguous (B, S, C) bf16 tensors.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises (fp32 too: it takes the exact path, not this one)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _build.refuse_gradient("flash_attention (K4)", "K4.bwd", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda_layout(f"flash_attention {name}", t, 3)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(bfloat16; fp32 takes ops/attention.py's exact "
                         f"path)")
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
