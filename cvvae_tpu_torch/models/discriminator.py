"""PatchGAN discriminators (2D and 3D).

Port of ``cvvae_tpu/models/discriminator.py`` as ``nn.Module``s whose
submodule paths follow the JAX params tree (``stem``,
``blocks.{i}.norm1``, ``blocks.{i}.nin_shortcut``, ``norms.{i}``,
``head``; ``layers.{i}.conv``, ``layers.{i}.bn``, ``layers.{i}.an``), so
``utils/convert.py::from_jax_params`` loads them with ``strict=True``.

* ``Disc3D``: the shipped 3D PatchGAN (input_nc 3, ndf 64, n_layers 4,
  causal False, half_3d False): a conv3d stem at stride 2, a pyramid of
  residual blocks that average-pool by 2 (an odd T first duplicates its
  first frame), GroupNorm + LeakyReLU between blocks, a conv3d head.  Its
  GroupNorms are K1 on the card (eps 1e-5, SiLU fused in the blocks).
* ``Disc2D``: the Pix2Pix 2D PatchGAN per frame, with BatchNorm (batch
  statistics in training, running statistics otherwise; ``update_stats``
  advances the running statistics in place, as torch does) or ActNorm
  (data-initialised on the first training forward).  The shipped recipe
  uses the 3D one; this is API parity.

Init: conv weights N(0, 0.02), biases 0; BatchNorm scale N(1, 0.02).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from cvvae_tpu_torch.ops.activations import leaky_relu
from cvvae_tpu_torch.ops.conv import Conv, Conv3DSpec, conv3d
from cvvae_tpu_torch.ops.norm import (batch_norm_inference, batch_norm_train,
                                      group_norm, norm_init)
from cvvae_tpu_torch.ops.resample import avg_pool3d

NORM_EPS = 1e-5

Generator = Optional[torch.Generator]


def _gan_conv(spec: Conv3DSpec, c_in: int, c_out: int, g: Generator,
              bias: bool = True) -> Conv:
    conv = Conv(dataclasses.replace(spec, use_bias=bias), c_in, c_out)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.02, generator=g)
        if conv.bias is not None:
            conv.bias.zero_()
    return conv


# ---------------------------------------------------------------------------
# 2D PatchGAN (per frame)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Disc2DConfig:
    input_nc: int = 3
    ndf: int = 64
    n_layers: int = 3
    use_actnorm: bool = False


def _disc2d_spec(stride: int) -> Conv3DSpec:
    return Conv3DSpec((1, 4, 4), (1, stride, stride),
                      ((0, 0), (1, 1), (1, 1)), ("zero", "zero", "zero"))


def _disc2d_channels(cfg: Disc2DConfig):
    """[(c_in, c_out, stride, has_norm), ...]"""
    layers = [(cfg.input_nc, cfg.ndf, 2, False)]
    nf = 1
    for n in range(1, cfg.n_layers):
        nf_prev, nf = nf, min(2 ** n, 8)
        layers.append((cfg.ndf * nf_prev, cfg.ndf * nf, 2, True))
    nf_prev, nf = nf, min(2 ** cfg.n_layers, 8)
    layers.append((cfg.ndf * nf_prev, cfg.ndf * nf, 1, True))
    layers.append((cfg.ndf * nf, 1, 1, False))
    return layers


class BatchNorm(nn.Module):
    """BatchNorm's ``weight`` (scale), ``bias`` and running ``mean`` and
    ``var`` (buffers)."""

    def __init__(self, c: int, g: Generator = None):
        super().__init__()
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(c, generator=g))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


class ActNorm(nn.Module):
    """ActNorm: ``weight * (h + loc)`` per channel; ``initialized`` 0 until
    the first training forward sets loc and scale from the data."""

    def __init__(self, c: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(c))
        self.weight = nn.Parameter(torch.ones(c))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.uint8))

    def forward(self, h: torch.Tensor, train: bool,
                update_stats: bool = False) -> torch.Tensor:
        if not train:
            return self.weight * (h + self.loc)
        axes = tuple(range(h.ndim - 1))
        with torch.no_grad():
            loc0 = -h.mean(dim=axes)
            scale0 = 1.0 / (h.std(dim=axes, unbiased=True) + 1e-6)
        first = bool(self.initialized == 0)
        loc = loc0 if first else self.loc
        scale = scale0 if first else self.weight
        if update_stats and first:
            with torch.no_grad():
                self.loc.copy_(loc0)
                self.weight.copy_(scale0)
                self.initialized.fill_(1)
        return scale * (h + loc)


class Disc2D(nn.Module):
    def __init__(self, cfg: Disc2DConfig, g: Generator = None):
        super().__init__()
        self.cfg = cfg
        layers = []
        for c_in, c_out, stride, has_norm in _disc2d_channels(cfg):
            bn = has_norm and not cfg.use_actnorm
            kids = {"conv": _gan_conv(_disc2d_spec(stride), c_in, c_out, g,
                                      bias=not bn)}
            if has_norm and cfg.use_actnorm:
                kids["an"] = ActNorm(c_out)
            elif has_norm:
                kids["bn"] = BatchNorm(c_out, g)
            layers.append(nn.ModuleDict(kids))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        """x (B, T, H, W, C) -> per-frame patch logits (B, T, H', W', 1).
        ``update_stats`` advances BatchNorm's running statistics (and
        initialises ActNorm) in place."""
        b, t = x.shape[:2]
        h = x.reshape((b * t, 1) + tuple(x.shape[2:]))
        for i, layer in enumerate(self.layers):
            stride = _disc2d_channels(self.cfg)[i][2]
            h = conv3d(h, layer["conv"], _disc2d_spec(stride))
            if "an" in layer:
                h = layer["an"](h, train, update_stats)
            elif "bn" in layer:
                bn = layer["bn"]
                if train:
                    h, stats = batch_norm_train(h, bn)
                    if update_stats:
                        with torch.no_grad():
                            bn.mean.copy_(stats["mean"])
                            bn.var.copy_(stats["var"])
                else:
                    h = batch_norm_inference(h, bn)
            if i < len(self.layers) - 1:
                h = leaky_relu(h, 0.2)
        return h.reshape((b, t) + tuple(h.shape[2:]))


# ---------------------------------------------------------------------------
# 3D PatchGAN
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Disc3DConfig:
    input_nc: int = 3
    ndf: int = 64
    n_layers: int = 4
    causal: bool = False
    half_3d: bool = False
    norm_groups: int = 32

    def conv_spec(self, k=3, p=1, stride=(1, 1, 1)) -> Conv3DSpec:
        if self.causal:
            return Conv3DSpec.v1_causal(k, p, stride)
        return Conv3DSpec.v1_plain(k, p, stride)


def _pool_down(h: torch.Tensor) -> torch.Tensor:
    """avg_pool3d(2, 2) with an odd T's first frame duplicated."""
    if h.shape[1] % 2 == 1:
        h = torch.cat([h[:, :1], h], dim=1)
    return avg_pool3d(h, 2, 2)


class ResBlockDown(nn.Module):
    def __init__(self, cfg: Disc3DConfig, c_in: int, c_out: int,
                 g: Generator = None):
        super().__init__()
        self.groups = cfg.norm_groups
        spec1 = cfg.conv_spec()
        spec2 = Conv3DSpec.spatial2d() if cfg.half_3d else spec1
        self.norm1 = norm_init(c_in)
        self.conv1 = _gan_conv(spec1, c_in, c_out, g)
        self.norm2 = norm_init(c_out)
        self.conv2 = _gan_conv(spec2, c_out, c_out, g)
        self.nin_shortcut = (_gan_conv(Conv3DSpec.pointwise(), c_in, c_out, g)
                             if c_in != c_out else None)

    def forward(self, x: torch.Tensor, downsample: bool) -> torch.Tensor:
        h = group_norm(x, self.norm1, num_groups=self.groups, eps=NORM_EPS,
                       silu=True)
        h = self.conv1(h)
        if downsample:
            h = _pool_down(h)
        h = group_norm(h, self.norm2, num_groups=self.groups, eps=NORM_EPS,
                       silu=True)
        h = self.conv2(h)
        if downsample:
            x = _pool_down(x)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


def _disc3d_blocks(cfg: Disc3DConfig):
    """[(c_in, c_out, downsample), ...] of the residual pyramid."""
    blocks = []
    nf = 1
    for n in range(1, cfg.n_layers - 1):
        nf_prev, nf = nf, min(2 ** n, 8)
        blocks.append((cfg.ndf * nf_prev, cfg.ndf * nf, True))
    for _ in range(2):
        nf_prev, nf = nf, min(2 ** cfg.n_layers, 8)
        blocks.append((cfg.ndf * nf_prev, cfg.ndf * nf, False))
    return blocks


class Disc3D(nn.Module):
    """x (B, T, H, W, C) -> patch logits (B, T', H', W', 1)."""

    def __init__(self, cfg: Disc3DConfig, g: Generator = None):
        super().__init__()
        self.cfg = cfg
        self.stem = _gan_conv(cfg.conv_spec(stride=(2, 2, 2)), cfg.input_nc,
                              cfg.ndf, g)
        plan = _disc3d_blocks(cfg)
        self.blocks = nn.ModuleList(
            [ResBlockDown(cfg, c_in, c_out, g) for c_in, c_out, _ in plan])
        self.norms = nn.ModuleList([norm_init(c_out) for _, c_out, _ in plan])
        self.head = _gan_conv(cfg.conv_spec(), plan[-1][1], 1, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = leaky_relu(self.stem(x), 0.2)
        for blk, nrm, (_, _, down) in zip(self.blocks, self.norms,
                                          _disc3d_blocks(cfg)):
            h = blk(h, down)
            h = group_norm(h, nrm, num_groups=cfg.norm_groups, eps=NORM_EPS)
            h = leaky_relu(h, 0.2)
        return self.head(h)


def get_cvvae_discriminator(generator: Generator = None):
    """The shipped discriminator's config and, with a generator, a random
    one."""
    cfg = Disc3DConfig(input_nc=3, ndf=64, n_layers=4, causal=False,
                       half_3d=False)
    if generator is None:
        return cfg
    return cfg, Disc3D(cfg, generator)
