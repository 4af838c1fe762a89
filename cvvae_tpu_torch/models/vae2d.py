"""2D image-VAE nets applied per frame: the frozen constraint nets of the
latent-constraint training recipe.

Port of ``cvvae_tpu/models/vae2d.py`` as ``nn.Module``s whose submodule
paths follow the JAX params tree: the SD3 (diffusers) naming
(``mid_block.resnets.0``, ``mid_block.attentions.0.to_q``,
``up_blocks.{i}.upsamplers.0``, ``conv_norm_out``) or the SD2.1 (v1-style)
naming (``mid.block_1``, ``mid.attn_1.q``, ``up.{i}.upsample``,
``norm_out``, the optional ``post_quant_conv`` / ``quant_conv``), so
``utils/convert.py::from_jax_params`` loads either with ``strict=True``.
``Decoder2D`` / ``Encoder2D`` are the JAX package's ``init_decoder2d`` /
``apply_decoder2d`` and ``init_encoder2d`` / ``apply_encoder2d``.

As in the JAX package, frames stay on a 5D (B, T, H, W, C) tensor: every
conv is a (1, k, k) conv, and GroupNorm (K1 on the card, per frame, fused
with SiLU where the block has one) and attention are per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from cvvae_tpu_torch.ops.attention import Dense, dense, spatial_self_attention
from cvvae_tpu_torch.ops.conv import Conv, Conv3DSpec
from cvvae_tpu_torch.ops.norm import group_norm_per_frame, norm_init
from cvvae_tpu_torch.ops.resample import nearest_upsample_2x_spatial

NORM_EPS = 1e-6

_CONV = Conv3DSpec.spatial2d()            # (1,3,3) zero pad 1
_POINT = Conv3DSpec.pointwise()
# Downsample2D(padding=0) + F.pad (0,1,0,1): asym zero pad, k3 s2
_DOWN = Conv3DSpec((1, 3, 3), (1, 2, 2), ((0, 0), (0, 1), (0, 1)),
                   ("zero", "zero", "zero"))

Generator = Optional[torch.Generator]


@dataclasses.dataclass(frozen=True)
class VAE2DConfig:
    naming: str = "sd3"                 # "sd3" (diffusers) | "sd21" (v1-style)
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    double_z: bool = True
    mid_block_add_attention: bool = True
    legacy_quant_conv: bool = False     # SD2.1 wrapper's 1x1 quant convs

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)


class Node(nn.Module):
    """A named container: list values become ``nn.ModuleList``s."""

    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            setattr(self, k, nn.ModuleList(v) if isinstance(v, list) else v)


def _shortcut_name(cfg: VAE2DConfig) -> str:
    return "conv_shortcut" if cfg.naming == "sd3" else "nin_shortcut"


class ResBlock2D(nn.Module):
    def __init__(self, cfg: VAE2DConfig, c_in: int, c_out: int,
                 g: Generator = None):
        super().__init__()
        self.groups = cfg.norm_num_groups
        self.norm1 = norm_init(c_in)
        self.conv1 = Conv(_CONV, c_in, c_out, g)
        self.norm2 = norm_init(c_out)
        self.conv2 = Conv(_CONV, c_out, c_out, g)
        self.shortcut = _shortcut_name(cfg)
        if c_in != c_out:
            setattr(self, self.shortcut, Conv(_POINT, c_in, c_out, g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm_per_frame(x, self.norm1, num_groups=self.groups,
                                 eps=NORM_EPS, silu=True)
        h = self.conv1(h)
        h = group_norm_per_frame(h, self.norm2, num_groups=self.groups,
                                 eps=NORM_EPS, silu=True)
        h = self.conv2(h)
        sc = getattr(self, self.shortcut, None)
        if sc is not None:
            x = sc(x)
        return x + h


class Attn2D(nn.Module):
    def __init__(self, cfg: VAE2DConfig, channels: int, g: Generator = None):
        super().__init__()
        self.groups = cfg.norm_num_groups
        self.names = (("group_norm", "to_q", "to_k", "to_v", "to_out")
                      if cfg.naming == "sd3"
                      else ("norm", "q", "k", "v", "proj_out"))
        setattr(self, self.names[0], norm_init(channels))
        for n in self.names[1:]:
            setattr(self, n, Dense(channels, channels, g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nrm, q, k, v, o = (getattr(self, n) for n in self.names)
        h = group_norm_per_frame(x, nrm, num_groups=self.groups, eps=NORM_EPS)
        h = spatial_self_attention(h, q, k, v)
        return x + dense(h, o)


def _upsample(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    return conv(nearest_upsample_2x_spatial(x))


class Decoder2D(nn.Module):
    """z (B, T, H', W', latent) -> per-frame decode (B, T, 8H', 8W', 3)."""

    def __init__(self, cfg: VAE2DConfig, g: Generator = None):
        super().__init__()
        self.cfg = cfg
        rev = tuple(reversed(cfg.block_out_channels))
        c_mid = rev[0]
        if cfg.naming == "sd21" and cfg.legacy_quant_conv:
            self.post_quant_conv = Conv(_POINT, cfg.latent_channels,
                                        cfg.latent_channels, g)
        self.conv_in = Conv(_CONV, cfg.latent_channels, c_mid, g)
        mid_res = [ResBlock2D(cfg, c_mid, c_mid, g),
                   ResBlock2D(cfg, c_mid, c_mid, g)]
        mid_attn = (Attn2D(cfg, c_mid, g) if cfg.mid_block_add_attention
                    else None)
        levels = []
        c_prev = c_mid
        for i in range(cfg.num_levels):
            c_out = rev[i]
            resnets = [ResBlock2D(cfg, c_prev if j == 0 else c_out, c_out, g)
                       for j in range(cfg.layers_per_block + 1)]
            up = (Conv(_CONV, c_out, c_out, g) if i != cfg.num_levels - 1
                  else None)
            levels.append((resnets, up))
            c_prev = c_out
        if cfg.naming == "sd3":
            self.mid_block = Node(resnets=mid_res, **(
                {"attentions": [mid_attn]} if mid_attn is not None else {}))
            self.up_blocks = nn.ModuleList([
                Node(resnets=r, **({"upsamplers": [u]} if u is not None
                                   else {})) for r, u in levels])
            self.conv_norm_out = norm_init(rev[-1])
        else:
            self.mid = Node(block_1=mid_res[0], block_2=mid_res[1], **(
                {"attn_1": mid_attn} if mid_attn is not None else {}))
            # v1 naming: up[level] with level 0 = highest resolution
            self.up = nn.ModuleList([
                Node(block=r, **({"upsample": u} if u is not None else {}))
                for r, u in reversed(levels)])
            self.norm_out = norm_init(rev[-1])
        self.conv_out = Conv(_CONV, rev[-1], cfg.out_channels, g)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if hasattr(self, "post_quant_conv"):
            z = self.post_quant_conv(z)
        h = self.conv_in(z)
        if cfg.naming == "sd3":
            mid_res = list(self.mid_block.resnets)
            mid_attn = (self.mid_block.attentions[0]
                        if hasattr(self.mid_block, "attentions") else None)
            levels = [(lvl.resnets, lvl.upsamplers[0]
                       if hasattr(lvl, "upsamplers") else None)
                      for lvl in self.up_blocks]
            norm_out = self.conv_norm_out
        else:
            mid_res = [self.mid.block_1, self.mid.block_2]
            mid_attn = getattr(self.mid, "attn_1", None)
            levels = [(lvl.block, getattr(lvl, "upsample", None))
                      for lvl in reversed(self.up)]
            norm_out = self.norm_out
        h = mid_res[0](h)
        if mid_attn is not None:
            h = mid_attn(h)
        h = mid_res[1](h)
        for resnets, up in levels:
            for r in resnets:
                h = r(h)
            if up is not None:
                h = _upsample(up, h)
        h = group_norm_per_frame(h, norm_out, num_groups=cfg.norm_num_groups,
                                 eps=NORM_EPS, silu=True)
        return self.conv_out(h)


class Encoder2D(nn.Module):
    """x (B, T, H, W, 3) -> per-frame moments (B, T, H/8, W/8, 2*latent)."""

    def __init__(self, cfg: VAE2DConfig, g: Generator = None):
        super().__init__()
        self.cfg = cfg
        chans = cfg.block_out_channels
        self.conv_in = Conv(_CONV, cfg.in_channels, chans[0], g)
        levels = []
        c_prev = chans[0]
        for i in range(cfg.num_levels):
            c_out = chans[i]
            resnets = [ResBlock2D(cfg, c_prev if j == 0 else c_out, c_out, g)
                       for j in range(cfg.layers_per_block)]
            down = (Conv(_DOWN, c_out, c_out, g) if i != cfg.num_levels - 1
                    else None)
            levels.append((resnets, down))
            c_prev = c_out
        c_mid = chans[-1]
        mid_res = [ResBlock2D(cfg, c_mid, c_mid, g),
                   ResBlock2D(cfg, c_mid, c_mid, g)]
        mid_attn = (Attn2D(cfg, c_mid, g) if cfg.mid_block_add_attention
                    else None)
        z_out = 2 * cfg.latent_channels if cfg.double_z else cfg.latent_channels
        if cfg.naming == "sd3":
            self.down_blocks = nn.ModuleList([
                Node(resnets=r, **({"downsamplers": [d]} if d is not None
                                   else {})) for r, d in levels])
            self.mid_block = Node(resnets=mid_res, **(
                {"attentions": [mid_attn]} if mid_attn is not None else {}))
            self.conv_norm_out = norm_init(c_mid)
        else:
            self.down = nn.ModuleList([
                Node(block=r, **({"downsample": d} if d is not None else {}))
                for r, d in levels])
            self.mid = Node(block_1=mid_res[0], block_2=mid_res[1], **(
                {"attn_1": mid_attn} if mid_attn is not None else {}))
            self.norm_out = norm_init(c_mid)
        self.conv_out = Conv(_CONV, c_mid, z_out, g)
        if cfg.naming == "sd21" and cfg.legacy_quant_conv:
            self.quant_conv = Conv(_POINT, z_out, z_out, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.conv_in(x)
        if cfg.naming == "sd3":
            levels = [(lvl.resnets, lvl.downsamplers[0]
                       if hasattr(lvl, "downsamplers") else None)
                      for lvl in self.down_blocks]
            mid_res = list(self.mid_block.resnets)
            mid_attn = (self.mid_block.attentions[0]
                        if hasattr(self.mid_block, "attentions") else None)
            norm_out = self.conv_norm_out
        else:
            levels = [(lvl.block, getattr(lvl, "downsample", None))
                      for lvl in self.down]
            mid_res = [self.mid.block_1, self.mid.block_2]
            mid_attn = getattr(self.mid, "attn_1", None)
            norm_out = self.norm_out
        for resnets, down in levels:
            for r in resnets:
                h = r(h)
            if down is not None:
                h = down(h)
        h = mid_res[0](h)
        if mid_attn is not None:
            h = mid_attn(h)
        h = mid_res[1](h)
        h = group_norm_per_frame(h, norm_out, num_groups=cfg.norm_num_groups,
                                 eps=NORM_EPS, silu=True)
        h = self.conv_out(h)
        if hasattr(self, "quant_conv"):
            h = self.quant_conv(h)
        return h

