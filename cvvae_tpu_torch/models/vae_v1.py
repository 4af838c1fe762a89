"""CV-VAE v1 / v1-1 encoder & decoder (SD 2.1 / SVD-compatible, 4ch latents).

Port of ``cvvae_tpu/models/vae_v1.py`` as ``nn.Module``s whose submodule
paths follow the JAX params tree (``down.{i}.block.{j}.norm1``,
``mid.attn_1.q``, ``up.{i}.upsample``, …), so ``utils/convert.py`` maps
one onto the other without a key table.  Structure (defaults ch=128,
ch_mult=(1,2,4,4), 2 res blocks):

  Encoder: conv_in -> 4 levels x (2 x ResnetBlock3D) with Downsample3D at
  levels 0-2 (time downsample at even levels -> T/4, HW/8) -> mid
  (res, spatial-attn, res) -> GroupNorm/swish/conv_out (2*z channels).

  Decoder mirrors with 3 res blocks per level, Upsample3D at levels 3..1
  (time upsample at odd levels), and a spatial+temporal attention
  mid-block.  The encoder is causal in time; the decoder is not.

Layout is channels-last (B, T, H, W, C).  GroupNorm eps is 1e-5.  The
training options follow the JAX package: dropout (drawn from an explicit
generator), remat per resblock (``torch.utils.checkpoint``), and the
decoder split into features and head (``features_only``,
``apply_decoder_head``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from cvvae_tpu_torch.ops.attention import (
    Dense, dense, spatial_self_attention, temporal_self_attention)
from cvvae_tpu_torch.ops.conv import Conv, Conv3DSpec, conv3d
from cvvae_tpu_torch.ops.norm import (
    group_norm, group_norm_per_frame, layer_norm, norm_init)
from cvvae_tpu_torch.ops.upsample_conv import upsample2x_conv3x3_interleave

NORM_EPS = 1e-5

Generator = Optional[torch.Generator]


@dataclasses.dataclass(frozen=True)
class VAE1Config:
    z_channels: int = 4
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    norm_num_groups: int = 32
    attn_resolutions: Tuple[int, ...] = ()
    resolution: int = 256
    dropout: float = 0.0
    double_z: bool = True
    use_3d_conv: bool = True
    half_3d: bool = True
    causal_encoder: bool = True
    causal_decoder: bool = False
    half_t_mult: bool = True
    encoder_attn: str = "spatial"
    decoder_attn: str = "spatial-temporal"

    @property
    def num_levels(self) -> int:
        return len(self.ch_mult)

    def conv_spec(self, causal: bool, k: int = 3, p: int = 1,
                  stride=(1, 1, 1)) -> Conv3DSpec:
        if not self.use_3d_conv:
            return Conv3DSpec.spatial2d(k, p, stride[1:])
        if causal:
            return Conv3DSpec.v1_causal(k, p, stride)
        return Conv3DSpec.v1_plain(k, p, stride)


def run_resblock(block: nn.Module, h: torch.Tensor, *, remat: bool = False,
                 generator: Generator = None) -> torch.Tensor:
    """One resblock as the JAX package's ``res`` runs it: with dropout
    where the config has it and a ``generator`` is given (training; the
    JAX package's ``deterministic=False``), and under
    ``torch.utils.checkpoint`` (``use_reentrant=False``) with ``remat``.
    The dropout mask is drawn here, before the checkpointed call, so the
    recompute in the backward reuses it: a checkpoint restores the global
    RNG's state, not an explicit generator's."""
    mask = None
    if block.dropout > 0 and generator is not None:
        shape = tuple(h.shape[:-1]) + (block.c_out,)
        mask = torch.rand(shape, generator=generator, device=h.device) \
            < 1.0 - block.dropout
    if remat:
        return torch.utils.checkpoint.checkpoint(block, h, mask,
                                                 use_reentrant=False)
    return block(h, mask)


def dropout_apply(h: torch.Tensor, mask: Optional[torch.Tensor],
                  rate: float) -> torch.Tensor:
    """``where(mask, h / keep, 0)`` in h's dtype (the JAX package's
    inverted dropout); ``mask`` None is no dropout."""
    if mask is None:
        return h
    keep = 1.0 - rate
    return torch.where(mask, h / keep, torch.zeros_like(h)).to(h.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cfg: VAE1Config, c_in: int, c_out: int, causal: bool,
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
        self.nin_shortcut = (Conv(Conv3DSpec.pointwise(), c_in, c_out, g)
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
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Mid-block attention with residual.  kind="spatial": per-frame
    single-head spatial attention; "spatial-temporal": then a
    LayerNorm/Linear temporal pass before the residual add."""

    def __init__(self, channels: int, kind: str, num_groups: int,
                 g: Generator = None):
        super().__init__()
        self.kind, self.groups = kind, num_groups
        self.norm = norm_init(channels)
        self.q, self.k, self.v, self.proj_out = (
            Dense(channels, channels, g) for _ in range(4))
        if kind == "spatial-temporal":
            self.norm_t = norm_init(channels)
            self.q_t, self.k_t, self.v_t, self.proj_out_t = (
                Dense(channels, channels, g) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm_per_frame(x, self.norm, num_groups=self.groups,
                                 eps=NORM_EPS)
        h = spatial_self_attention(h, self.q, self.k, self.v)
        h = dense(h, self.proj_out)
        if self.kind == "spatial-temporal":
            h = layer_norm(h, self.norm_t, eps=1e-5)
            h = temporal_self_attention(h, self.q_t, self.k_t, self.v_t)
            h = dense(h, self.proj_out_t)
        return x + h


def _upsample_spec(causal: bool) -> Conv3DSpec:
    # spatial (1,1) zeros; time replicate — (2,0) causal, (1,1) otherwise
    t_pad = (2, 0) if causal else (1, 1)
    return Conv3DSpec((3, 3, 3), (1, 1, 1), (t_pad, (1, 1), (1, 1)),
                      ("edge", "zero", "zero"))


class Upsample(nn.Module):
    """Upsample3D: nearest 2x in space + conv, and a channel->time 2x
    split at time-upsampling levels; runs as the fused subpixel form."""

    def __init__(self, channels: int, up_time: bool, causal: bool,
                 g: Generator = None):
        super().__init__()
        self.n = 2 if up_time else 1
        self.causal = causal
        conv = Conv(_upsample_spec(causal), channels, channels * self.n, g)
        self.weight, self.bias = conv.weight, conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_conv3x3_interleave(
            x, self, n=self.n, t_pad=(2, 0) if self.causal else (1, 1),
            t_mode="edge", hw_mode="zero")


class Level(nn.Module):
    """One resolution level: ``block`` (and ``attn``) lists plus an
    optional ``downsample``/``upsample``."""

    def __init__(self, blocks, attns=None, downsample=None, upsample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns) if attns else None
        self.downsample = downsample
        self.upsample = upsample

    def forward(self, h: torch.Tensor, **run) -> torch.Tensor:
        for i, blk in enumerate(self.block):
            h = run_resblock(blk, h, **run)
            if self.attn is not None:
                h = self.attn[i](h)
        if self.downsample is not None:
            h = self.downsample(h)
        if self.upsample is not None:
            h = self.upsample(h)
        return h


class Mid(nn.Module):
    def __init__(self, cfg: VAE1Config, channels: int, causal: bool,
                 attn_kind: str, g: Generator = None):
        super().__init__()
        self.block_1 = ResnetBlock(cfg, channels, channels, causal, g)
        self.attn_1 = AttnBlock(channels, attn_kind, cfg.norm_num_groups, g)
        self.block_2 = ResnetBlock(cfg, channels, channels, causal, g)

    def forward(self, h: torch.Tensor, **run) -> torch.Tensor:
        h = self.attn_1(run_resblock(self.block_1, h, **run))
        return run_resblock(self.block_2, h, **run)


def _encoder_attn_levels(cfg: VAE1Config):
    res, flags = cfg.resolution, []
    for i in range(cfg.num_levels):
        flags.append(res in cfg.attn_resolutions)
        if i != cfg.num_levels - 1:
            res //= 2
    return flags


def _decoder_attn_levels(cfg: VAE1Config):
    res = cfg.resolution // 2 ** (cfg.num_levels - 1)
    flags = [False] * cfg.num_levels
    for i in reversed(range(cfg.num_levels)):
        flags[i] = res in cfg.attn_resolutions
        if i != 0:
            res *= 2
    return flags


class Encoder(nn.Module):
    """x: (B, T, H, W, 3) -> moments (B, T', H/8, W/8, 2*z)."""

    def __init__(self, cfg: VAE1Config, g: Generator = None):
        super().__init__()
        causal = cfg.causal_encoder
        self.groups = cfg.norm_num_groups
        self.conv_in = Conv(cfg.conv_spec(causal), cfg.in_channels, cfg.ch, g)
        in_mult = (1,) + tuple(cfg.ch_mult)
        attn_levels = _encoder_attn_levels(cfg)
        levels = []
        for level in range(cfg.num_levels):
            c_in, c_out = cfg.ch * in_mult[level], cfg.ch * cfg.ch_mult[level]
            blocks = [ResnetBlock(cfg, c_in if i == 0 else c_out, c_out,
                                  causal, g)
                      for i in range(cfg.num_res_blocks)]
            attns = ([AttnBlock(c_out, cfg.encoder_attn, self.groups, g)
                      for _ in range(cfg.num_res_blocks)]
                     if attn_levels[level] else None)
            down = None
            if level != cfg.num_levels - 1:
                down_time = (level % 2 == 0) if cfg.half_t_mult else True
                down = Conv(Conv3DSpec.v1_downsample(down_time), c_out, c_out, g)
            levels.append(Level(blocks, attns, downsample=down))
        self.down = nn.ModuleList(levels)
        c_mid = cfg.ch * cfg.ch_mult[-1]
        self.mid = Mid(cfg, c_mid, causal, cfg.encoder_attn, g)
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.norm_out = norm_init(c_mid)
        self.conv_out = Conv(cfg.conv_spec(causal), c_mid, z_out, g)

    def forward(self, x: torch.Tensor, *, remat: bool = False,
                generator: Generator = None) -> torch.Tensor:
        """``remat``: each resblock under ``torch.utils.checkpoint``;
        ``generator``: dropout where the config has it (training)."""
        run = dict(remat=remat, generator=generator)
        h = self.conv_in(x)
        for level in self.down:
            h = level(h, **run)
        h = self.mid(h, **run)
        h = group_norm(h, self.norm_out, num_groups=self.groups, eps=NORM_EPS,
                       silu=True)
        return self.conv_out(h)


class Decoder(nn.Module):
    """z: (B, T', H', W', z) -> x_hat (B, 4(T'-1)+1, 8H', 8W', 3)."""

    def __init__(self, cfg: VAE1Config, g: Generator = None):
        super().__init__()
        causal = cfg.causal_decoder
        self.groups = cfg.norm_num_groups
        c_mid = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.conv_spec(causal), cfg.z_channels, c_mid, g)
        self.mid = Mid(cfg, c_mid, causal, cfg.decoder_attn, g)
        attn_levels = _decoder_attn_levels(cfg)
        levels = [None] * cfg.num_levels
        block_in = c_mid
        for level in reversed(range(cfg.num_levels)):
            block_out = cfg.ch * cfg.ch_mult[level]
            blocks = [ResnetBlock(cfg, block_in if i == 0 else block_out,
                                  block_out, causal, g)
                      for i in range(cfg.num_res_blocks + 1)]
            block_in = block_out
            attns = ([AttnBlock(block_out, cfg.decoder_attn, self.groups, g)
                      for _ in range(cfg.num_res_blocks + 1)]
                     if attn_levels[level] else None)
            up = None
            if level != 0:
                up_time = (level % 2 == 1) if cfg.half_t_mult else True
                up = Upsample(block_out, up_time, causal, g)
            levels[level] = Level(blocks, attns, upsample=up)
        self.up = nn.ModuleList(levels)
        self.norm_out = norm_init(block_in)
        self.conv_out = Conv(cfg.conv_spec(causal), block_in, cfg.out_ch, g)

    def forward(self, z: torch.Tensor, *, remat: bool = False,
                generator: Generator = None,
                features_only: bool = False) -> torch.Tensor:
        """As the encoder's; ``features_only`` stops before ``conv_out``
        (``apply_decoder_head`` runs it)."""
        run = dict(remat=remat, generator=generator)
        h = self.mid(self.conv_in(z), **run)
        for level in reversed(self.up):
            h = level(h, **run)
        h = group_norm(h, self.norm_out, num_groups=self.groups, eps=NORM_EPS,
                       silu=True)
        if features_only:
            return h
        return self.conv_out(h)


def apply_decoder_head(conv_out, h: torch.Tensor, cfg) -> torch.Tensor:
    """The decoder's final conv alone, with ``conv_out``'s ``weight`` and
    ``bias`` (any object holding them): the training engine takes the
    gradients of the NLL and GAN losses w.r.t. that weight only (the
    adaptive discriminator weight) on the decoder's features."""
    return conv3d(h, conv_out, cfg.conv_spec(cfg.causal_decoder))
