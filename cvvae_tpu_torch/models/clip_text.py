"""CLIP text encoder (transformers ``CLIPTextModel``): the latent-compat
demo's prompt encoder.

Port of ``cvvae_tpu/models/clip_text.py`` as an ``nn.Module`` whose paths
follow the JAX params tree (``token_embedding``, ``position_embedding``,
``layers.{i}.{ln1, attn.{q,k,v,out}, ln2, fc1, fc2}``, ``final_ln``), so
``utils/convert.py``'s ``from_jax_params`` (the JAX tree) and
``convert_clip_text_state_dict`` (a transformers checkpoint) load it with
``strict=True``.

The SD 2.1 text tower (OpenCLIP ViT-H's text encoder in transformers'
CLIPTextModel layout): token plus learned position embeddings, pre-LN
blocks of causal multi-head self-attention and a GELU MLP, a final
LayerNorm.  SD 1.x towers (``hidden_act="quick_gelu"``) take the config.
An optional (B, S) key padding mask adds to the causal mask.

It computes what ``apply_clip_text`` computes, in the ``dtype`` the caller
names (the weights cast to it): q scaled by head_dim^-0.5 before the
score product, the scores cast to fp32 plus the additive fp32 mask
(fp32's most negative value, not -inf), the softmax in fp32, the
LayerNorms in fp32 (``models/unet2d._layer_norm``).  A prompt is 77
tokens, run once a sample, so no kernel is needed.  Tokenizing stays
with transformers' ``CLIPTokenizer``, outside the package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvvae_tpu_torch.models.unet2d import _dense, _layer_norm
from cvvae_tpu_torch.models.vae2d import Node
from cvvae_tpu_torch.models.video_vae import on_device
from cvvae_tpu_torch.ops.attention import Dense
from cvvae_tpu_torch.ops.norm import norm_init


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024            # SD 2.1 (ViT-H text); SD 1.x: 768
    intermediate_size: int = 4096
    num_hidden_layers: int = 23        # SD 2.1 ships 23; SD 1.x: 12
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"           # SD 1.x: "quick_gelu"
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "gelu":                  # transformers: the exact (erf) form
        return F.gelu(x)
    if kind in ("gelu_new", "gelu_pytorch_tanh"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported hidden_act {kind!r}")


#: the additive mask's value at a masked key
_BIG_NEG = torch.finfo(torch.float32).min


def _mask(seq_len: int, attention_mask: Optional[torch.Tensor],
          device) -> torch.Tensor:
    """The additive fp32 mask, (1 or B, 1, S, S): 0 on and below the
    diagonal, fp32's most negative value above it, plus that value on the
    keys ``attention_mask`` zeroes."""
    i = torch.arange(seq_len, device=device)
    mask = torch.where(i[:, None] >= i[None, :], 0.0, _BIG_NEG)[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask.to(device).bool(), 0.0, _BIG_NEG)
        mask = mask + pad[:, None, None, :]
    return mask


class CLIPText(nn.Module):
    """input_ids (B, S) -> last_hidden_state (B, S, H) in ``dtype``."""

    def __init__(self, cfg: CLIPTextConfig,
                 g: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        # N(0, 0.02) tables, as transformers initialises them, from ``g``
        self.token_embedding, self.position_embedding = (
            nn.Embedding(n, h, _weight=torch.empty(n, h).normal_(
                0.0, 0.02, generator=g))
            for n in (cfg.vocab_size, cfg.max_position_embeddings))
        self.layers = nn.ModuleList([Node(
            ln1=norm_init(h),
            attn=Node(**{n: Dense(h, h, g) for n in ("q", "k", "v", "out")}),
            ln2=norm_init(h), fc1=Dense(h, cfg.intermediate_size, g),
            fc2=Dense(cfg.intermediate_size, h, g))
            for _ in range(cfg.num_hidden_layers)])
        self.final_ln = norm_init(h)

    @classmethod
    def from_config(cls, cfg: CLIPTextConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: Any = "cuda") -> "CLIPText":
        """Random weights drawn on the CPU from a generator seeded with
        ``seed``, then moved to ``device`` in ``dtype``; on the card unless
        the caller asks for the CPU, and without a card the default
        raises."""
        device = on_device(device, "CLIPText.from_config")
        net = cls(cfg, torch.Generator().manual_seed(seed))
        return net.to(device=device, dtype=dtype).eval().requires_grad_(False)

    def _self_attention(self, p, x: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, h = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        q = _dense(x, p.q).reshape(b, s, nh, hd).transpose(1, 2) * hd ** -0.5
        k = _dense(x, p.k).reshape(b, s, nh, hd).transpose(1, 2)
        v = _dense(x, p.v).reshape(b, s, nh, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() + mask
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, h)
        return _dense(out, p.out)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None, *,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        cfg = self.config
        eps = cfg.layer_norm_eps
        s = input_ids.shape[1]
        ids = input_ids.to(self.token_embedding.weight.device).long()
        h = (self.token_embedding.weight.to(dtype)[ids]
             + self.position_embedding.weight.to(dtype)[:s][None])
        mask = _mask(s, attention_mask, h.device)
        for layer in self.layers:
            h = h + self._self_attention(layer.attn,
                                         _layer_norm(h, layer.ln1, eps), mask)
            z = _dense(_layer_norm(h, layer.ln2, eps), layer.fc1)
            h = h + _dense(_act(z, cfg.hidden_act), layer.fc2)
        return _layer_norm(h, self.final_ln, eps)


def pooled_output(last_hidden: torch.Tensor, input_ids: torch.Tensor,
                  eos_token_id: int = 49407) -> torch.Tensor:
    """transformers' pooled_output: the hidden state at each row's first
    EOS token.

    Kept from the JAX package: a row without ``eos_token_id`` falls back to
    the argmax of its ids (transformers' legacy pooling) on its own,
    whereas transformers chooses legacy or EOS pooling for all rows from
    the model config.  The standard ``CLIPTokenizer`` always appends EOS,
    so that row never occurs there; custom ids without EOS differ from a
    non-legacy reference."""
    ids = input_ids.to(last_hidden.device).long()
    is_eos = ids == eos_token_id
    first_eos = is_eos.int().argmax(dim=-1)
    idx = torch.where(is_eos.any(dim=-1), first_eos, ids.argmax(dim=-1))
    return last_hidden[torch.arange(ids.shape[0], device=ids.device), idx]


def make_text_embedder(model: CLIPText, dtype: torch.dtype = torch.bfloat16):
    """(B, S) ids -> (B, S, H) embeddings in ``dtype``, without autograd,
    for the diffusion pipeline."""
    @torch.inference_mode()
    def embed(input_ids):
        return model(input_ids, dtype=dtype)
    return embed
