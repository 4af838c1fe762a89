"""Single-head attention for the VAE mid-blocks.

Port of ``cvvae_tpu/ops/attention.py`` (the exact path; the flash kernel
is not ported yet).  Spatial attention runs over the tokens of one frame,
temporal attention over the frames of one pixel.  Logits and softmax are
fp32; the value product accumulates in fp32 and rounds once to the input
dtype.  Long sequences are blocked over 512-query chunks, so the
(S, S) logits never exist at once: at the untiled 720p encoder mid-block
(5 frames of 14400 tokens) one block of logits is 5×512×14400 fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvvae_tpu_torch.ops.conv import uniform_


class Dense(nn.Module):
    """A dense layer's parameters, torch Linear layout: ``weight`` (O, I)
    and ``bias`` (O,), initialised as torch's Linear default."""

    def __init__(self, c_in: int, c_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(c_in)
        self.weight = nn.Parameter(uniform_(torch.empty(c_out, c_in), bound,
                                            generator))
        self.bias = nn.Parameter(uniform_(torch.empty(c_out), bound, generator))


def dense(x: torch.Tensor, params) -> torch.Tensor:
    """y = x @ W^T + b over the last axis."""
    b = None if params.bias is None else params.bias.to(x.dtype)
    return F.linear(x, params.weight.to(x.dtype), b)


def _attention_block(q_blk: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Exact attention for one query block.  q_blk:(B,Sq,C) k,v:(B,S,C)."""
    logits = torch.matmul(q_blk.float(), k.float().transpose(1, 2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def _me_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, q_chunk: int = 512) -> torch.Tensor:
    """Query-blocked exact attention: a full-row softmax per block of
    ``q_chunk`` queries."""
    k = k.float()  # once, not per block
    return torch.cat([_attention_block(q[:, i:i + q_chunk], k, v, scale)
                      for i in range(0, q.shape[1], q_chunk)], dim=1)


def single_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          query_chunk_size: int = 512) -> torch.Tensor:
    """Single-head scaled dot-product attention on (B, S, C) tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] <= query_chunk_size:
        return _attention_block(q, k, v, scale)
    return _me_attention(q, k, v, scale, query_chunk_size)


def spatial_self_attention(x: torch.Tensor, wq, wk, wv, *,
                           query_chunk_size: int = 512) -> torch.Tensor:
    """Per-frame single-head spatial attention, (B,T,H,W,C) -> same.
    The caller applies the pre-norm and the output projection."""
    b, t, h, w, c = x.shape
    tokens = x.reshape(b * t, h * w, c)
    out = single_head_attention(dense(tokens, wq), dense(tokens, wk),
                                dense(tokens, wv),
                                query_chunk_size=query_chunk_size)
    return out.reshape(b, t, h, w, c)


def temporal_self_attention(x: torch.Tensor, wq, wk, wv) -> torch.Tensor:
    """Per-pixel single-head temporal attention ((b h w) t c grouping)."""
    b, t, h, w, c = x.shape
    tokens = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    out = single_head_attention(dense(tokens, wq), dense(tokens, wk),
                                dense(tokens, wv))
    return out.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4).contiguous()
