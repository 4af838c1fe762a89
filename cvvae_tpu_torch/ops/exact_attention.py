"""Exact single-head attention, the counterpart of the reference's
``_attention_block`` / ``_me_attention`` (``cvvae_tpu/ops/attention.py``),
and the plain versions of K4's logsumexp and of its backward K4.bwd.

fp32 logits and softmax, the value product accumulated in fp32 and
rounded once, blocked over 512-query chunks so the (S, S) logits never
exist at once.  Its products are ``torch.matmul``, as the reference
leaves them to XLA.  ``ops/attention.py`` runs it wherever K4 does not
apply, and it is K4's plain version (``ops/kernels/attention.py``).
float64 inputs are computed in float64 (a gradient check's), every other
dtype in fp32.
"""

from __future__ import annotations

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the sums are taken in: fp32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _attention_block(q_blk: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, scale: float) -> torch.Tensor:
    """Exact attention for one query block.  q_blk:(B,Sq,C) k,v:(B,S,C)."""
    acc = _acc(q_blk.dtype)
    logits = torch.matmul(q_blk.to(acc), k.to(acc).transpose(1, 2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, q_chunk: int = 512) -> torch.Tensor:
    """Exact single-head attention on (B, S, C): one block up to
    ``q_chunk`` queries, else a full-row softmax per block of ``q_chunk``
    queries."""
    if q.shape[1] <= q_chunk:
        return _attention_block(q, k, v, scale)
    k = k.to(_acc(k.dtype))  # once, not per block
    return torch.cat([_attention_block(q[:, i:i + q_chunk], k, v, scale)
                      for i in range(0, q.shape[1], q_chunk)], dim=1)


def attention_lse(q: torch.Tensor, k: torch.Tensor, scale: float,
                  q_chunk: int = 512) -> torch.Tensor:
    """Each query row's logsumexp of its scaled logits, natural log,
    (B, S) in fp32 (float64 for float64): what K4 writes for K4.bwd."""
    acc = _acc(q.dtype)
    kt = k.to(acc).transpose(1, 2)
    return torch.cat([torch.logsumexp(
        torch.matmul(q[:, i:i + q_chunk].to(acc), kt) * scale, dim=-1)
        for i in range(0, q.shape[1], q_chunk)], dim=1)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                       scale: float, q_chunk: int = 512):
    """(dq, dk, dv) of softmax(q·kᵀ·scale)·v from the output ``o``, its
    gradient ``do`` and the rows' logsumexp ``lse`` (natural log): P
    recomputed as exp(scale·q·kᵀ − lse), D = rowsum(do∘o), dv = Pᵀ·do,
    dS = P∘(do·vᵀ − D), dq = dS·k·scale, dk = dSᵀ·q·scale.  Every sum in
    fp32 (float64 for float64), blocked over ``q_chunk`` queries; the
    outputs in the inputs' dtypes.  K4.bwd's plain version."""
    acc = _acc(q.dtype)
    kf, vf = k.to(acc), v.to(acc)
    d = (do.to(acc) * o.to(acc)).sum(-1)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dq = []
    for i in range(0, q.shape[1], q_chunk):
        qb, dob = q[:, i:i + q_chunk].to(acc), do[:, i:i + q_chunk].to(acc)
        p = torch.exp(torch.matmul(qb, kf.transpose(1, 2)) * scale
                      - lse[:, i:i + q_chunk, None].to(acc))
        dv += torch.matmul(p.transpose(1, 2), dob)
        ds = p * (torch.matmul(dob, vf.transpose(1, 2))
                  - d[:, i:i + q_chunk, None])
        dq.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(1, 2), qb)
    return (torch.cat(dq, dim=1).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))
