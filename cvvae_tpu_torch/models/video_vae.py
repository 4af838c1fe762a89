"""VideoVAE — the user-facing model API (encode / decode / tiling).

Port of ``cvvae_tpu/models/video_vae.py`` (the v1 family).  Capabilities:

* temporal-chunked encode/decode: encode windows of
  ``en_de_n_frames_a_time``+1 frames with a single-frame causal overlap,
  dropping the first latent of later windows; decode windows of
  ``en_de/time_n_compress``+1 latents;
* spatial tiling with linear seam blending, square or rectangular tiles
  with per-axis overlap ratios, blended in the reference's in-place
  cascade (each tile against already-blended neighbours);
* 4D/5D reshape contracts and ``channels_first`` (B, C, T, H, W) I/O;
* DiagonalGaussian posterior and the SD2.1 scaling factor 0.18215.

Native layout is channels-last (B, T, H, W, C).  Tiles run one after
another, so peak device memory is one tile's working set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from cvvae_tpu_torch.models import vae_v1
from cvvae_tpu_torch.ops.distributions import DiagonalGaussian


@dataclasses.dataclass(frozen=True)
class VideoVAEConfig:
    family: str = "v1"
    net: Any = None                        # VAE1Config
    scaling_factor: float = 0.18215
    en_de_n_frames_a_time: Optional[int] = 16
    time_n_compress: int = 4
    spatial_n_compress: int = 8
    tile_spatial_size: Optional[Any] = 576
    #: scalar or an (h, w) pair of per-axis overlap ratios
    tile_overlap_ratio: Any = 0.2222
    num_video_frames: Optional[int] = None
    #: encoder-side tile size; "inherit" follows tile_spatial_size
    encode_tile_spatial_size: Any = "inherit"

    def __post_init__(self):
        if self.family != "v1":
            raise NotImplementedError(
                f"family {self.family!r}: only v1 is ported; SD3 is "
                f"ROADMAP queue A item 'SD3'")
        if self.net is None:
            object.__setattr__(self, "net", vae_v1.VAE1Config())
        if self.en_de_n_frames_a_time is not None:
            if self.en_de_n_frames_a_time % self.time_n_compress:
                raise ValueError("en_de_n_frames_a_time must be a multiple "
                                 "of time_n_compress")

    @property
    def latent_channels(self) -> int:
        return self.net.z_channels

    @property
    def decode_n_frames_a_time(self) -> Optional[int]:
        if self.en_de_n_frames_a_time is None:
            return None
        return self.en_de_n_frames_a_time // self.time_n_compress

    def _latent(self, t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            return tuple(v // self.spatial_n_compress for v in t)
        return t // self.spatial_n_compress

    @property
    def pixel_tile_size(self):
        t = self.tile_spatial_size
        return tuple(t) if isinstance(t, (tuple, list)) else t

    @property
    def latent_tile_size(self):
        return self._latent(self.tile_spatial_size)

    @property
    def encode_pixel_tile_size(self):
        t = self.encode_tile_spatial_size
        if isinstance(t, str) and t == "inherit":
            return self.pixel_tile_size
        return tuple(t) if isinstance(t, (tuple, list)) else t

    @property
    def encode_latent_tile_size(self):
        return self._latent(self.encode_pixel_tile_size)

    @property
    def num_latent_frames(self) -> Optional[int]:
        if self.num_video_frames is None:
            return None
        return 1 + (self.num_video_frames - 1) // self.time_n_compress


def _blend_h(a: torch.Tensor, b: torch.Tensor, overlap: int) -> torch.Tensor:
    """Linear horizontal seam blend."""
    w = (torch.arange(overlap, dtype=torch.float32, device=b.device)
         / overlap).reshape(1, 1, 1, -1, 1).to(b.dtype)
    blended = (1 - w) * a[:, :, :, -overlap:, :] + w * b[:, :, :, :overlap, :]
    return torch.cat([blended, b[:, :, :, overlap:, :]], dim=3)


def _blend_v(a: torch.Tensor, b: torch.Tensor, overlap: int) -> torch.Tensor:
    """Linear vertical seam blend."""
    w = (torch.arange(overlap, dtype=torch.float32, device=b.device)
         / overlap).reshape(1, 1, -1, 1, 1).to(b.dtype)
    blended = (1 - w) * a[:, :, -overlap:, :, :] + w * b[:, :, :overlap, :, :]
    return torch.cat([blended, b[:, :, overlap:, :, :]], dim=2)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class VideoVAE(nn.Module):
    """The v1 video VAE: ``encoder`` and ``decoder`` modules plus the
    tiling/chunking config.  ``config`` may be replaced (e.g. with the
    serving tile preset) without touching the weights."""

    def __init__(self, config: VideoVAEConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.encoder = vae_v1.Encoder(config.net, generator)
        self.decoder = vae_v1.Decoder(config.net, generator)

    @classmethod
    def from_config(cls, config: VideoVAEConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: Any = "cpu") -> "VideoVAE":
        """Random weights with torch's default init, drawn on the CPU from
        a ``torch.Generator`` seeded with ``seed`` (so every device gets
        the same weights), then moved to ``device`` in ``dtype``."""
        g = torch.Generator().manual_seed(seed)
        vae = cls(config, g).to(device=device, dtype=dtype)
        return vae.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.encoder.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.conv_in.weight.dtype

    def quantize(self, *args, **kwargs):
        raise NotImplementedError(
            "int8 serving is not ported yet (ROADMAP queue A: int8 with its "
            "hand-written int8 conv)")

    def with_mesh(self, *args, **kwargs):
        raise NotImplementedError(
            "multi-device inference is not ported yet (ROADMAP queue A: "
            "multi-device)")

    # ---- spatial tiling ----

    def _spatial_tiled(self, x: torch.Tensor, net, tile,
                       out_tile) -> torch.Tensor:
        if tile is None:
            return net(x)
        tile_h, tile_w = _pair(tile)
        if x.shape[2] <= tile_h and x.shape[3] <= tile_w:
            return net(x)
        out_h, out_w = _pair(out_tile)
        ratio_h, ratio_w = _pair(self.config.tile_overlap_ratio)
        in_stride_h = round(tile_h * (1 - ratio_h))
        in_stride_w = round(tile_w * (1 - ratio_w))
        out_overlap_h = round(out_h * ratio_h)
        out_overlap_w = round(out_w * ratio_w)
        out_stride_h = out_h - out_overlap_h
        out_stride_w = out_w - out_overlap_w

        rows = []
        for i in range(0, x.shape[2], in_stride_h):
            row = []
            for j in range(0, x.shape[3], in_stride_w):
                row.append(net(x[:, :, i:i + tile_h, j:j + tile_w, :]
                               .contiguous()))
                if j + tile_w >= x.shape[3]:
                    break
            rows.append(row)
            if i + tile_h >= x.shape[2]:
                break

        # the reference blends tiles in place, so each tile meets
        # already-blended neighbours: keep that cascade
        for i in range(len(rows)):
            for j in range(len(rows[i])):
                t = rows[i][j]
                if i > 0:
                    t = _blend_v(rows[i - 1][j], t, out_overlap_h)
                if j > 0:
                    t = _blend_h(rows[i][j - 1], t, out_overlap_w)
                rows[i][j] = t

        out_rows = []
        for i, cols in enumerate(rows):
            cropped = []
            for j, t in enumerate(cols):
                if i < len(rows) - 1:
                    t = t[:, :, :out_stride_h]
                if j < len(cols) - 1:
                    t = t[:, :, :, :out_stride_w]
                cropped.append(t)
            out_rows.append(torch.cat(cropped, dim=3))
        return torch.cat(out_rows, dim=2)

    def spatial_tiled_encode(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return self._spatial_tiled(x, self.encoder, cfg.encode_pixel_tile_size,
                                   cfg.encode_latent_tile_size)

    def spatial_tiled_decode(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return self._spatial_tiled(z, self.decoder, cfg.latent_tile_size,
                                   cfg.pixel_tile_size)

    # ---- temporal chunking ----

    @staticmethod
    def _chunked(v: torch.Tensor, stride: Optional[int], fn) -> torch.Tensor:
        if stride is None:
            return fn(v)
        if v.ndim != 5:
            raise ValueError(f"expected a 5-D tensor, got {tuple(v.shape)}")
        n_rounds = max(1, math.ceil((v.shape[1] - 1) / stride))
        outs = []
        for n in range(n_rounds):
            out = fn(v[:, n * stride:(n + 1) * stride + 1].contiguous())
            outs.append(out if n == 0 else out[:, 1:])
        return torch.cat(outs, dim=1)

    def tiled_encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._chunked(x, self.config.en_de_n_frames_a_time,
                             self.spatial_tiled_encode)

    def tiled_decode(self, z: torch.Tensor) -> torch.Tensor:
        return self._chunked(z, self.config.decode_n_frames_a_time,
                             self.spatial_tiled_decode)

    # ---- public API ----

    @torch.inference_mode()
    def encode(self, x: torch.Tensor, *, channels_first: bool = False,
               max_batch_size: Optional[int] = None) -> DiagonalGaussian:
        """Encode video -> posterior.  x: (B,T,H,W,C), (B,H,W,C) or, with
        ``channels_first``, (B,C,T,H,W) / (B,C,H,W)."""
        cfg = self.config
        if max_batch_size is not None and x.shape[0] > max_batch_size:
            parts = [self.encode(x[i:i + max_batch_size],
                                 channels_first=channels_first)
                     for i in range(0, x.shape[0], max_batch_size)]
            return DiagonalGaussian(torch.cat([p.mean for p in parts]),
                                    torch.cat([p.logvar for p in parts]))
        if channels_first:
            if x.ndim == 4:
                if cfg.num_video_frames is not None:
                    t = cfg.num_video_frames
                    x = x.reshape(x.shape[0] // t, t, *x.shape[1:]) \
                        .permute(0, 2, 1, 3, 4)
                else:
                    x = x[:, :, None]
            x = x.permute(0, 2, 3, 4, 1)
        elif x.ndim == 4:
            x = x[:, None]
        moments = self.tiled_encode(x.contiguous())
        return DiagonalGaussian.from_moments(moments)

    @torch.inference_mode()
    def decode(self, z: torch.Tensor, *, num_frames: Optional[int] = None,
               channels_first: bool = False,
               max_batch_size: Optional[int] = None) -> torch.Tensor:
        """Decode latents -> video, same layout convention as encode."""
        cfg = self.config
        if max_batch_size is not None and z.shape[0] > max_batch_size:
            return torch.cat(
                [self.decode(z[i:i + max_batch_size], num_frames=num_frames,
                             channels_first=channels_first)
                 for i in range(0, z.shape[0], max_batch_size)])
        if channels_first:
            if z.ndim == 4:
                t = num_frames or cfg.num_latent_frames
                if t is not None:
                    z = z.reshape(z.shape[0] // t, t, *z.shape[1:]) \
                        .permute(0, 2, 1, 3, 4)
                else:
                    z = z[:, :, None]
            z = z.permute(0, 2, 3, 4, 1)
        elif z.ndim == 4:
            z = z[:, None]
        x = self.tiled_decode(z.contiguous())
        if channels_first:
            x = x.permute(0, 4, 1, 2, 3)
        return x

    def reconstruct(self, x: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    sample_posterior: bool = False,
                    channels_first: bool = False) -> torch.Tensor:
        posterior = self.encode(x, channels_first=channels_first)
        if sample_posterior:
            if generator is None:
                raise ValueError("sample_posterior needs a generator")
            z = posterior.sample(generator)
        else:
            z = posterior.mode()
        return self.decode(z, channels_first=channels_first)


def config_for_variant(variant: str) -> VideoVAEConfig:
    if variant in ("v1", "v1-1", "vae3d", "vae3d_v1-1"):
        return VideoVAEConfig(family="v1")
    if variant in ("sd3", "vae3d_sd3"):
        raise NotImplementedError(
            "the SD3 family is not ported yet (ROADMAP queue A: SD3)")
    raise ValueError(f"unknown variant {variant!r}")
