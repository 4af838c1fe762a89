"""Exact single-head attention, the counterpart of the reference's
``_attention_block`` / ``_me_attention`` (``cvvae_tpu/ops/attention.py``).

fp32 logits and softmax, the value product accumulated in fp32 and
rounded once, blocked over 512-query chunks so the (S, S) logits never
exist at once.  Its products are ``torch.matmul``, as the reference
leaves them to XLA.  ``ops/attention.py`` runs it wherever K4 does not
apply, and it is K4's plain version (``ops/kernels/attention.py``).
"""

from __future__ import annotations

import torch


def _attention_block(q_blk: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, scale: float) -> torch.Tensor:
    """Exact attention for one query block.  q_blk:(B,Sq,C) k,v:(B,S,C)."""
    logits = torch.matmul(q_blk.float(), k.float().transpose(1, 2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, q_chunk: int = 512) -> torch.Tensor:
    """Exact single-head attention on (B, S, C): one block up to
    ``q_chunk`` queries, else a full-row softmax per block of ``q_chunk``
    queries."""
    if q.shape[1] <= q_chunk:
        return _attention_block(q, k, v, scale)
    k = k.float()  # once, not per block
    return torch.cat([_attention_block(q[:, i:i + q_chunk], k, v, scale)
                      for i in range(0, q.shape[1], q_chunk)], dim=1)
