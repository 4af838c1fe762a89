"""CV-VAE SD3 encoder & decoder (SD3/SD3.5-compatible, 16ch latents).

Port of ``cvvae_tpu/models/vae_sd3.py`` as ``nn.Module``s whose submodule
paths follow the JAX params tree (``down_blocks.{i}.resnets.{j}.norm1``,
``mid_block.attentions.0.to_q``, ``up_blocks.{i}.upsamplers.0``, …), so
``utils/convert.py`` maps one onto the other without a key table.
Differences from the v1 family:

* every conv replicate-pads (past-only in time for the causal encoder);
* GroupNorm eps is 1e-6;
* down/upsample convs pad symmetrically by 1;
* the residual shortcut is a 1x1x1 conv when the width changes;
* the mid-block attention is per-frame single-head with Linear q/k/v and
  a per-frame GroupNorm pre-norm.

Shipped config: block_out_channels (128,256,512,512), layers_per_block 2,
causal encoder, non-causal decoder, half_3d.  Layout is channels-last
(B, T, H, W, C).  The training options (dropout from an explicit
generator, remat per resblock, ``features_only`` and
``apply_decoder_head``) are v1's (``models/vae_v1.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from cvvae_tpu_torch.models.vae_v1 import (apply_decoder_head, dropout_apply,
                                           run_resblock)
from cvvae_tpu_torch.ops.attention import Dense, dense, spatial_self_attention
from cvvae_tpu_torch.ops.conv import Conv, Conv3DSpec
from cvvae_tpu_torch.ops.norm import group_norm, group_norm_per_frame, norm_init
from cvvae_tpu_torch.ops.upsample_conv import upsample2x_conv3x3_interleave

NORM_EPS = 1e-6

Generator = Optional[torch.Generator]


@dataclasses.dataclass(frozen=True)
class VAESD3Config:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    double_z: bool = True
    mid_block_add_attention: bool = True
    causal_encoder: bool = True
    causal_decoder: bool = False
    half_3d: bool = True
    dropout: float = 0.0

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    def conv_spec(self, causal: bool, k: int = 3, p: int = 1,
                  stride=(1, 1, 1)) -> Conv3DSpec:
        if causal:
            return Conv3DSpec.sd3_causal(k, p, stride)
        return Conv3DSpec.sd3_plain(k, p, stride)


def _encoder_down_time(cfg: VAESD3Config, i: int) -> bool:
    return (i % 2 == 0) and (i != cfg.num_levels - 1)


def _decoder_up_time(cfg: VAESD3Config, i: int) -> bool:
    # i indexes up_blocks in reversed-channel order
    return (i % 2 == 0) and (i != cfg.num_levels - 1)


class ResnetBlock(nn.Module):
    def __init__(self, cfg: VAESD3Config, c_in: int, c_out: int, causal: bool,
                 g: Generator = None):
        super().__init__()
        self.dropout, self.c_out = cfg.dropout, c_out
        self.groups = cfg.norm_num_groups
        conv1 = cfg.conv_spec(causal)
        conv2 = Conv3DSpec.spatial2d() if cfg.half_3d else conv1
        self.norm1 = norm_init(c_in)
        self.conv1 = Conv(conv1, c_in, c_out, g)
        self.norm2 = norm_init(c_out)
        self.conv2 = Conv(conv2, c_out, c_out, g)
        self.conv_shortcut = (Conv(Conv3DSpec.pointwise(), c_in, c_out, g)
                              if c_in != c_out else None)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = group_norm(x, self.norm1, num_groups=self.groups, eps=NORM_EPS,
                       silu=True)
        h = self.conv1(h)
        h = group_norm(h, self.norm2, num_groups=self.groups, eps=NORM_EPS,
                       silu=True)
        h = dropout_apply(h, mask, self.dropout)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Per-frame single-head self-attention with residual (diffusers
    Attention(heads=1, residual_connection=True) on each frame)."""

    def __init__(self, channels: int, num_groups: int, g: Generator = None):
        super().__init__()
        self.groups = num_groups
        self.group_norm = norm_init(channels)
        self.to_q, self.to_k, self.to_v, self.to_out = (
            Dense(channels, channels, g) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm_per_frame(x, self.group_norm, num_groups=self.groups,
                                 eps=NORM_EPS)
        h = spatial_self_attention(h, self.to_q, self.to_k, self.to_v)
        return x + dense(h, self.to_out)


class Upsample(nn.Module):
    """Nearest 2x in space + conv, and a channel->time 2x split at
    time-upsampling levels; runs as the fused subpixel form, edge-padded
    in space and time."""

    def __init__(self, cfg: VAESD3Config, channels: int, up_time: bool,
                 causal: bool, g: Generator = None):
        super().__init__()
        self.n = 2 if up_time else 1
        self.causal = causal
        conv = Conv(cfg.conv_spec(causal), channels, channels * self.n, g)
        self.weight, self.bias = conv.weight, conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_conv3x3_interleave(
            x, self, n=self.n, t_pad=(2, 0) if self.causal else (1, 1),
            t_mode="edge", hw_mode="edge")


class Block(nn.Module):
    """One resolution level: ``resnets`` and an optional
    ``downsamplers``/``upsamplers`` list of one."""

    def __init__(self, resnets, downsampler=None, upsampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.downsamplers = (nn.ModuleList([downsampler])
                             if downsampler is not None else None)
        self.upsamplers = (nn.ModuleList([upsampler])
                           if upsampler is not None else None)

    def forward(self, h: torch.Tensor, **run) -> torch.Tensor:
        for r in self.resnets:
            h = run_resblock(r, h, **run)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class MidBlock(nn.Module):
    def __init__(self, cfg: VAESD3Config, channels: int, causal: bool,
                 g: Generator = None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(cfg, channels, channels, causal, g) for _ in range(2)])
        self.attentions = (
            nn.ModuleList([Attention(channels, cfg.norm_num_groups, g)])
            if cfg.mid_block_add_attention else None)

    def forward(self, h: torch.Tensor, **run) -> torch.Tensor:
        h = run_resblock(self.resnets[0], h, **run)
        if self.attentions is not None:
            h = self.attentions[0](h)
        return run_resblock(self.resnets[1], h, **run)


class Encoder(nn.Module):
    """x: (B, T, H, W, 3) -> moments (B, T', H/8, W/8, 2*latent)."""

    def __init__(self, cfg: VAESD3Config, g: Generator = None):
        super().__init__()
        causal = cfg.causal_encoder
        self.groups = cfg.norm_num_groups
        chans = cfg.block_out_channels
        self.conv_in = Conv(cfg.conv_spec(causal), cfg.in_channels, chans[0], g)
        blocks = []
        c_prev = chans[0]
        for i, c_out in enumerate(chans):
            resnets = [ResnetBlock(cfg, c_prev if j == 0 else c_out, c_out,
                                   causal, g)
                       for j in range(cfg.layers_per_block)]
            down = None
            if i != cfg.num_levels - 1:
                stride = (2, 2, 2) if _encoder_down_time(cfg, i) else (1, 2, 2)
                down = Conv(cfg.conv_spec(causal, stride=stride), c_out,
                            c_out, g)
            blocks.append(Block(resnets, downsampler=down))
            c_prev = c_out
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(cfg, chans[-1], causal, g)
        z_out = 2 * cfg.latent_channels if cfg.double_z else cfg.latent_channels
        self.conv_norm_out = norm_init(chans[-1])
        self.conv_out = Conv(cfg.conv_spec(causal), chans[-1], z_out, g)

    def forward(self, x: torch.Tensor, *, remat: bool = False,
                generator: Generator = None) -> torch.Tensor:
        """``remat``: each resblock under ``torch.utils.checkpoint``;
        ``generator``: dropout where the config has it (training)."""
        run = dict(remat=remat, generator=generator)
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h, **run)
        h = self.mid_block(h, **run)
        h = group_norm(h, self.conv_norm_out, num_groups=self.groups,
                       eps=NORM_EPS, silu=True)
        return self.conv_out(h)


class Decoder(nn.Module):
    """z: (B, T', H', W', latent) -> x_hat (B, 4(T'-1)+1, 8H', 8W', 3)."""

    def __init__(self, cfg: VAESD3Config, g: Generator = None):
        super().__init__()
        causal = cfg.causal_decoder
        self.groups = cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = Conv(cfg.conv_spec(causal), cfg.latent_channels,
                            rev[0], g)
        self.mid_block = MidBlock(cfg, rev[0], causal, g)
        blocks = []
        c_prev = rev[0]
        for i, c_out in enumerate(rev):
            resnets = [ResnetBlock(cfg, c_prev if j == 0 else c_out, c_out,
                                   causal, g)
                       for j in range(cfg.layers_per_block + 1)]
            up = None
            if i != cfg.num_levels - 1:
                up = Upsample(cfg, c_out, _decoder_up_time(cfg, i), causal, g)
            blocks.append(Block(resnets, upsampler=up))
            c_prev = c_out
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = norm_init(rev[-1])
        self.conv_out = Conv(cfg.conv_spec(causal), rev[-1], cfg.in_channels, g)

    def forward(self, z: torch.Tensor, *, remat: bool = False,
                generator: Generator = None,
                features_only: bool = False) -> torch.Tensor:
        """As the encoder's; ``features_only`` stops before ``conv_out``
        (``apply_decoder_head`` runs it)."""
        run = dict(remat=remat, generator=generator)
        h = self.mid_block(self.conv_in(z), **run)
        for blk in self.up_blocks:
            h = blk(h, **run)
        h = group_norm(h, self.conv_norm_out, num_groups=self.groups,
                       eps=NORM_EPS, silu=True)
        if features_only:
            return h
        return self.conv_out(h)
