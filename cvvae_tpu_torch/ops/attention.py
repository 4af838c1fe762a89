"""Single-head attention for the VAE mid-blocks.

Port of ``cvvae_tpu/ops/attention.py``.  Spatial attention runs over the
tokens of one frame, temporal attention over the frames of one pixel.

The reference's dispatch (``_flash_usable``): a bf16 CUDA tensor with S
>= 1024 tokens (the spatial mid-block attention at C = 512: 5 frames of
14400 tokens in the untiled 720p v1 encoder, 7560 in a 720x672 tile)
runs the hand-written flash kernel K4 (``ops/kernels/attention.py``).
Everything else -- fp32 on the card too, the CPU, the temporal pass (S =
T' <= 5), short sequences -- takes the exact path, the counterpart of the
reference's ``_attention_block`` / ``_me_attention``
(``ops/exact_attention.py``).  ``no_flash_attention()`` sends every call
in its block to the exact path: the JAX package's switch of that name, on
the card used only as a reference for K4 and K4.bwd (``chip_smoke.py``,
the tests).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvvae_tpu_torch.ops.conv import uniform_
from cvvae_tpu_torch.ops.exact_attention import exact_attention
from cvvae_tpu_torch.ops.kernels.attention import flash_attention
from cvvae_tpu_torch.parallel import shard


class Dense(nn.Module):
    """A dense layer's parameters, torch Linear layout: ``weight`` (O, I)
    and ``bias`` (O,) (None without ``bias``), initialised as torch's
    Linear default."""

    def __init__(self, c_in: int, c_out: int,
                 generator: Optional[torch.Generator] = None,
                 bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(c_in)
        self.weight = nn.Parameter(uniform_(torch.empty(c_out, c_in), bound,
                                            generator))
        self.bias = (nn.Parameter(uniform_(torch.empty(c_out), bound,
                                           generator)) if bias else None)


def dense(x: torch.Tensor, params) -> torch.Tensor:
    """y = x @ W^T + b over the last axis."""
    b = None if params.bias is None else params.bias.to(x.dtype)
    return F.linear(x, params.weight.to(x.dtype), b)


#: bf16 sequences at least this long go to K4 on the card
FLASH_MIN_TOKENS = 1024

#: False inside ``no_flash_attention()``
_flash_on = True


@contextlib.contextmanager
def no_flash_attention():
    """Every attention call in the block takes the exact path (the JAX
    package's ``no_flash_attention``, ``cvvae_tpu/ops/attention.py:101``)."""
    global _flash_on
    prev, _flash_on = _flash_on, False
    try:
        yield
    finally:
        _flash_on = prev


def flash_usable(device_type: str, dtype: torch.dtype, s: int) -> bool:
    """Whether (B, S, C) attention on ``device_type`` in ``dtype`` runs K4:
    the reference's ``_flash_usable``, a bf16 tensor on the card with S >=
    FLASH_MIN_TOKENS, outside ``no_flash_attention()``."""
    return (_flash_on and device_type == "cuda" and dtype == torch.bfloat16
            and s >= FLASH_MIN_TOKENS)


def single_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          query_chunk_size: int = 512) -> torch.Tensor:
    """Single-head scaled dot-product attention on (B, S, C) tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if flash_usable(q.device.type, q.dtype, q.shape[1]):
        return flash_attention(q, k, v, scale)
    return exact_attention(q, k, v, scale, query_chunk_size)


def spatial_self_attention(x: torch.Tensor, wq, wk, wv, *,
                           query_chunk_size: int = 512) -> torch.Tensor:
    """Per-frame single-head spatial attention, (B,T,H,W,C) -> same.
    The caller applies the pre-norm and the output projection.  In a net
    call split over a mesh along H, each frame's tokens are gathered from
    every rank and attended in full here (K4 takes q, k and v of one
    length), and this rank keeps its rows."""
    return _split_attention(x, 2, lambda v: _spatial(v, wq, wk, wv,
                                                     query_chunk_size))


def _spatial(x, wq, wk, wv, query_chunk_size):
    b, t, h, w, c = x.shape
    tokens = x.reshape(b * t, h * w, c)
    out = single_head_attention(dense(tokens, wq), dense(tokens, wk),
                                dense(tokens, wv),
                                query_chunk_size=query_chunk_size)
    return out.reshape(b, t, h, w, c)


def temporal_self_attention(x: torch.Tensor, wq, wk, wv) -> torch.Tensor:
    """Per-pixel single-head temporal attention ((b h w) t c grouping).
    Split over a mesh along T, each pixel's frames are gathered from every
    rank, as ``spatial_self_attention`` gathers along H."""
    return _split_attention(x, 1, lambda v: _temporal(v, wq, wk, wv))


def _temporal(x, wq, wk, wv):
    b, t, h, w, c = x.shape
    tokens = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    out = single_head_attention(dense(tokens, wq), dense(tokens, wk),
                                dense(tokens, wv))
    return out.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4).contiguous()


def _split_attention(x: torch.Tensor, dim: int, attend) -> torch.Tensor:
    """``attend(x)`` where the attention mixes along ``dim``: unsplit, or
    split over a mesh along another axis, it runs on this rank's tensor;
    split along ``dim``, on the gathered whole, and this rank keeps its
    run."""
    ctx = shard.current()
    if ctx is None or ctx.dim != dim:
        return attend(x)
    sizes = ctx.sizes(x)
    out = ctx.local(attend(ctx.gather(x)), sizes)
    ctx.register(out, sizes)
    return out
