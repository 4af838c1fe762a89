"""UNet2DConditionModel (the Stable Diffusion 2.x image denoiser).

Port of ``cvvae_tpu/models/unet2d.py`` as an ``nn.Module`` whose submodule
paths follow the JAX params tree, so ``utils/convert.py``'s
``from_jax_params(..., conv2d=True)`` (the JAX tree) and
``convert_unet_state_dict`` (a diffusers checkpoint) load it with
``strict=True``.  It makes the latent-compat demo executable: plug it into
``pipelines/diffusion.LatentDiffusionPipeline`` as the denoiser and decode
its latents with the video VAE.

The SD 2.x layout: conv_in, a sinusoidal time embedding through a 2-layer
MLP, cross-attention down blocks (ResnetBlock2D + Transformer2DModel with
linear projections) with strided-conv downsamplers, a mid block, up
blocks that concatenate their skips with nearest-2x upsamplers, then
GroupNorm+SiLU and conv_out.

Every function computes what the JAX package's computes, in its dtypes.
Tensors are (B, H, W, C) contiguous and the model runs in the dtype of
its input ``x``: the weights are cast to it, the time MLP runs in fp32
and its output is cast to it, as ``apply_unet`` does (the context is
taken in x's dtype too; pass both in one dtype, as the JAX pipeline
does).  The JAX UNet calls no Pallas kernel, so neither does this one:

* GroupNorm and LayerNorm are ``_group_norm`` / ``_layer_norm`` written as
  the JAX package writes them: fp32, the mean, then the mean of the
  squared deviations (two passes), normalise, the affine in fp32, one cast
  at the end.  eps 1e-5 in the resnets and ``conv_norm_out``, 1e-6 in the
  transformers.
* Convs are ``F.conv2d`` (cuDNN on the card) on the tensors' NHWC memory,
  with the bias added after, as XLA's conv plus its add.
* The multi-head attention (head dim 64 at SD 2.1) is two ``torch.matmul``
  s with the logits cast to fp32 for the softmax and the weights cast back
  before the second product, as the JAX package's einsums.
* The GEGLU takes the tanh GELU: ``jax.nn.gelu``'s default.  diffusers
  takes the exact (erf) GELU; the port shares the JAX package's choice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvvae_tpu_torch.models.vae2d import Node
from cvvae_tpu_torch.models.video_vae import on_device
from cvvae_tpu_torch.ops.activations import silu
from cvvae_tpu_torch.ops.attention import Dense
from cvvae_tpu_torch.ops.conv import uniform_
from cvvae_tpu_torch.ops.norm import norm_init

Generator = Optional[torch.Generator]


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64          # dim per head; heads = ch // dim
    norm_num_groups: int = 32
    #: which down blocks carry cross-attention transformers (SD 2.x: all
    #: but the last); the up blocks mirror them in reverse
    down_block_has_attn: Optional[Tuple[bool, ...]] = None

    def attn_flags(self) -> Tuple[bool, ...]:
        if self.down_block_has_attn is not None:
            return self.down_block_has_attn
        n = len(self.block_out_channels)
        return tuple(i < n - 1 for i in range(n))


class Conv2d(nn.Module):
    """A 2D conv's parameters, torch Conv2d layout (``weight`` (O, I, kH,
    kW), ``bias`` (O,)), initialised as torch's Conv2d default."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1,
                 g: Generator = None):
        super().__init__()
        self.stride, self.pad = stride, k // 2
        bound = 1.0 / math.sqrt(c_in * k * k)
        self.weight = nn.Parameter(uniform_(torch.empty(c_out, c_in, k, k),
                                            bound, g))
        self.bias = nn.Parameter(uniform_(torch.empty(c_out), bound, g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``_conv``: the conv in x's dtype on (B, H, W, C), then the bias.
        The loaders keep the weights in ``channels_last`` memory, so that
        cuDNN's NHWC path needs no copy of them."""
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None,
                     self.stride, self.pad)
        return y.permute(0, 2, 3, 1).contiguous() + self.bias.to(x.dtype)


def _dense(x: torch.Tensor, p) -> torch.Tensor:
    """x @ W^T in x's dtype, then the bias where there is one."""
    y = F.linear(x, p.weight.to(x.dtype))
    return y if p.bias is None else y + p.bias.to(x.dtype)


def _group_norm(x: torch.Tensor, p, groups: int,
                eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (B, H, W, C) as the JAX UNet's ``_group_norm``: fp32
    moments per (batch, group), the variance as the mean of squared
    deviations, the affine in fp32, one cast back to x's dtype."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h, w, groups, c // groups)
    d = xf - xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (d * d).mean(dim=(1, 2, 4), keepdim=True)
    xf = (d * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xf * p.weight.float() + p.bias.float()).to(x.dtype)


def _layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis as the JAX package's ``_layer_norm``:
    fp32, two passes, one cast back to x's dtype."""
    xf = x.float()
    d = xf - xf.mean(dim=-1, keepdim=True)
    var = (d * d).mean(dim=-1, keepdim=True)
    xf = d * torch.rsqrt(var + eps) * p.weight.float() + p.bias.float()
    return xf.to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' get_timestep_embedding(flip_sin_to_cos=True,
    downscale_freq_shift=0): [cos | sin] halves, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock2D(nn.Module):
    def __init__(self, c_in: int, c_out: int, temb: int, groups: int,
                 g: Generator = None):
        super().__init__()
        self.groups = groups
        self.norm1 = norm_init(c_in)
        self.conv1 = Conv2d(c_in, c_out, g=g)
        self.time_emb_proj = Dense(temb, c_out, g)
        self.norm2 = norm_init(c_out)
        self.conv2 = Conv2d(c_out, c_out, g=g)
        if c_in != c_out:
            self.conv_shortcut = Conv2d(c_in, c_out, 1, g=g)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(silu(_group_norm(x, self.norm1, self.groups)))
        h = h + _dense(silu(emb), self.time_emb_proj)[:, None, None, :]
        h = self.conv2(silu(_group_norm(h, self.norm2, self.groups)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """diffusers Attention: to_q/k/v without bias, multi-head, to_out."""

    def __init__(self, dim: int, ctx_dim: int, head_dim: int,
                 g: Generator = None):
        super().__init__()
        self.head_dim = head_dim
        self.to_q = Dense(dim, dim, g, bias=False)
        self.to_k = Dense(ctx_dim, dim, g, bias=False)
        self.to_v = Dense(ctx_dim, dim, g, bias=False)
        self.to_out = Dense(dim, dim, g)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """softmax(q kᵀ / sqrt(head_dim)) v: the logits of x's dtype cast
        to fp32, the softmax in fp32, its weights cast back to x's dtype."""
        hd = self.head_dim
        q = _dense(x, self.to_q)
        b, sq, c = q.shape
        q, k, v = (t.reshape(b, -1, c // hd, hd).transpose(1, 2)
                   for t in (q, _dense(ctx, self.to_k),
                             _dense(ctx, self.to_v)))
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        attn = torch.softmax(scores.div_(math.sqrt(hd)), dim=-1)
        del scores
        o = torch.matmul(attn.to(x.dtype), v)
        return _dense(o.transpose(1, 2).reshape(b, sq, c), self.to_out)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, head_dim: int,
                 g: Generator = None):
        super().__init__()
        self.norm1 = norm_init(dim)
        self.attn1 = Attention(dim, dim, head_dim, g)
        self.norm2 = norm_init(dim)
        self.attn2 = Attention(dim, ctx_dim, head_dim, g)
        self.norm3 = norm_init(dim)
        self.ff_proj = Dense(dim, 8 * dim, g)     # GEGLU: value | gate
        self.ff_out = Dense(4 * dim, dim, g)

    def forward(self, y: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = _layer_norm(y, self.norm1)
        y = y + self.attn1(h, h)
        y = y + self.attn2(_layer_norm(y, self.norm2), context)
        z, gate = _dense(_layer_norm(y, self.norm3), self.ff_proj).chunk(2, -1)
        return y + _dense(z * F.gelu(gate, approximate="tanh"), self.ff_out)


class Transformer2DModel(nn.Module):
    """Transformer2DModel with use_linear_projection=True (SD 2.x)."""

    def __init__(self, dim: int, ctx_dim: int, head_dim: int, groups: int,
                 g: Generator = None):
        super().__init__()
        self.groups = groups
        self.norm = norm_init(dim)
        self.proj_in = Dense(dim, dim, g)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, ctx_dim, head_dim, g)])
        self.proj_out = Dense(dim, dim, g)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = _group_norm(x, self.norm, self.groups, eps=1e-6)
        y = _dense(y.reshape(b, h * w, c), self.proj_in)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return x + _dense(y, self.proj_out).reshape(b, h, w, c)


def _upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


class UNet2D(nn.Module):
    """x (B, H, W, C_in) latents, t (a number, or a 0-d or (B,) tensor of
    timesteps), context (B, S, cross_attention_dim) -> the model output
    (B, H, W, C_out), all in x's dtype."""

    def __init__(self, cfg: UNet2DConfig, g: Generator = None):
        super().__init__()
        self.config = cfg
        chs = cfg.block_out_channels
        n, temb, groups = len(chs), chs[0] * 4, cfg.norm_num_groups
        flags = cfg.attn_flags()

        def attn(c):
            return Transformer2DModel(c, cfg.cross_attention_dim,
                                      cfg.attention_head_dim, groups, g)

        self.conv_in = Conv2d(cfg.in_channels, chs[0], g=g)
        self.time_embedding = Node(linear_1=Dense(chs[0], temb, g),
                                   linear_2=Dense(temb, temb, g))
        down, c_prev, skips = [], chs[0], [chs[0]]
        for i, c in enumerate(chs):
            blk = dict(resnets=[
                ResnetBlock2D(c_prev if j == 0 else c, c, temb, groups, g)
                for j in range(cfg.layers_per_block)])
            skips += [c] * cfg.layers_per_block
            if flags[i]:
                blk["attentions"] = [attn(c) for _ in range(
                    cfg.layers_per_block)]
            if i != n - 1:
                blk["downsamplers"] = [Conv2d(c, c, stride=2, g=g)]
                skips.append(c)
            down.append(Node(**blk))
            c_prev = c
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Node(
            resnets=[ResnetBlock2D(chs[-1], chs[-1], temb, groups, g),
                     ResnetBlock2D(chs[-1], chs[-1], temb, groups, g)],
            attentions=[attn(chs[-1])])
        up, c_prev = [], chs[-1]
        for i, c in enumerate(reversed(chs)):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(c_prev + skips.pop(), c, temb,
                                             groups, g))
                c_prev = c
            blk = dict(resnets=resnets)
            if flags[n - 1 - i]:
                blk["attentions"] = [attn(c) for _ in range(
                    cfg.layers_per_block + 1)]
            if i != n - 1:
                blk["upsamplers"] = [Conv2d(c, c, g=g)]
            up.append(Node(**blk))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = norm_init(chs[0])
        self.conv_out = Conv2d(chs[0], cfg.out_channels, g=g)

    @classmethod
    def from_config(cls, cfg: UNet2DConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: Any = "cuda") -> "UNet2D":
        """Random weights with torch's default init, drawn on the CPU from
        a ``torch.Generator`` seeded with ``seed``, then moved to
        ``device`` in ``dtype``; on the card unless the caller asks for the
        CPU (``device="cpu"``), and without a card the default raises."""
        device = on_device(device, "UNet2D.from_config")
        return to_device(cls(cfg, torch.Generator().manual_seed(seed)),
                         device, dtype)

    def forward(self, x: torch.Tensor, t, context: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.config
        groups = cfg.norm_num_groups
        x = x.contiguous()
        context = context.to(x.dtype)
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        te = self.time_embedding
        emb = _dense(timestep_embedding(t, cfg.block_out_channels[0]),
                     te.linear_1)
        emb = _dense(silu(emb), te.linear_2).to(x.dtype)

        flags = cfg.attn_flags()
        h = self.conv_in(x)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(h, emb)
                if flags[i]:
                    h = blk.attentions[j](h, context)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, emb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, emb)

        up_flags = flags[::-1]
        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), emb)
                if up_flags[i]:
                    h = blk.attentions[j](h, context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](_upsample_nearest_2x(h))

        h = silu(_group_norm(h, self.conv_norm_out, groups))
        return self.conv_out(h)


def to_device(unet: UNet2D, device, dtype) -> UNet2D:
    """``unet`` on ``device`` in ``dtype``, its conv weights in
    ``channels_last`` memory, frozen, in eval mode."""
    unet = unet.to(device=device, dtype=dtype,
                   memory_format=torch.channels_last)
    return unet.eval().requires_grad_(False)


def make_denoiser(unet: UNet2D, dtype: Optional[torch.dtype] = None):
    """A LatentDiffusionPipeline denoiser: (latents, t, cond) -> the UNet's
    output, without autograd.  With ``dtype`` None the UNet runs in the
    latents' dtype, as the JAX package's denoiser does; with a ``dtype``
    it runs in that one (latents and cond cast to it) and its output comes
    back in the latents' dtype."""
    @torch.inference_mode()
    def denoiser(latents, t, cond):
        if dtype is None:
            return unet(latents, t, cond)
        return unet(latents.to(dtype), t, cond.to(dtype)).to(latents.dtype)
    return denoiser
