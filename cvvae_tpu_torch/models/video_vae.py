"""VideoVAE — the user-facing model API (encode / decode / tiling).

Port of ``cvvae_tpu/models/video_vae.py`` (the v1 and SD3 families).
Capabilities:

* temporal-chunked encode/decode: encode windows of
  ``en_de_n_frames_a_time``+1 frames with a single-frame causal overlap,
  dropping the first latent of later windows; decode windows of
  ``en_de/time_n_compress``+1 latents;
* spatial tiling with linear seam blending, square or rectangular tiles
  with per-axis overlap ratios, blended in the reference's in-place
  cascade (each tile against already-blended neighbours);
* 4D/5D reshape contracts and ``channels_first`` (B, C, T, H, W) I/O;
* DiagonalGaussian posterior; scaling factor 0.18215 (v1, SD 2.1) or
  1.5305 (SD3).

Native layout is channels-last (B, T, H, W, C).  Tiles run one after
another, so peak device memory is one tile's working set.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import math
import os
from typing import Any, Optional

import torch
from torch import nn

from cvvae_tpu_torch.models import vae_sd3, vae_v1
from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.ops.distributions import DiagonalGaussian
from cvvae_tpu_torch.utils import spans

#: family -> the module holding its Encoder and Decoder
_FAMILIES = {"v1": vae_v1, "sd3": vae_sd3}


@dataclasses.dataclass(frozen=True)
class VideoVAEConfig:
    family: str = "v1"                     # "v1" | "sd3"
    net: Any = None                        # VAE1Config | VAESD3Config
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
        if self.family not in _FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.net is None:
            net = (vae_v1.VAE1Config() if self.family == "v1"
                   else vae_sd3.VAESD3Config())
            object.__setattr__(self, "net", net)
        if self.en_de_n_frames_a_time is not None:
            if self.en_de_n_frames_a_time % self.time_n_compress:
                raise ValueError("en_de_n_frames_a_time must be a multiple "
                                 "of time_n_compress")

    @property
    def latent_channels(self) -> int:
        return (self.net.z_channels if self.family == "v1"
                else self.net.latent_channels)

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


def on_device(device, who: str) -> torch.device:
    """``device``, or RuntimeError when it is the card and there is none;
    ``who`` names the entry point in the message."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to "
                           f"build the model on the CPU")
    return device


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _positions(v: torch.Tensor) -> int:
    """B·T·H·W of a (B, T, H, W, C) tensor."""
    return math.prod(v.shape[:4])


class VideoVAE(nn.Module):
    """The video VAE: its family's ``encoder`` and ``decoder`` modules plus
    the tiling/chunking config.  ``config`` may be replaced (e.g. with the
    serving tile preset) without touching the weights.

    ``tile_counts`` counts, for each net ("encoder", "decoder"), its calls
    (``<net>.calls``), the positions (B·T·H·W) they ran on
    (``<net>.positions``) and the positions of the inputs the tiling was
    asked to cover (``<net>.input_positions``): positions over input
    positions, less one, is the share of the net's work the tile and chunk
    overlaps do twice."""

    def __init__(self, config: VideoVAEConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        nets = _FAMILIES[config.family]
        self.encoder = nets.Encoder(config.net, generator)
        self.decoder = nets.Decoder(config.net, generator)
        self.tile_counts: collections.Counter = collections.Counter()

    @classmethod
    def from_config(cls, config: VideoVAEConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: Any = "cuda") -> "VideoVAE":
        """Random weights with torch's default init, drawn on the CPU from
        a ``torch.Generator`` seeded with ``seed`` (so every device gets
        the same weights), then moved to ``device`` in ``dtype``.

        The model runs on the card unless the caller asks for the CPU
        (``device="cpu"``); without a card the default raises."""
        device = on_device(device, "VideoVAE.from_config")
        g = torch.Generator().manual_seed(seed)
        vae = cls(config, g).to(device=device, dtype=dtype)
        return vae.eval().requires_grad_(False)

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None,
                        dtype: torch.dtype = torch.float32,
                        device: Any = "cuda") -> "VideoVAE":
        """Load a reference HF checkpoint directory (config.json +
        *.safetensors; ``utils/convert.py``) onto ``device`` in ``dtype``.

        As ``from_config``: on the card unless the caller asks for the CPU,
        and without a card the default raises."""
        from cvvae_tpu_torch.utils.convert import load_reference_checkpoint
        device = on_device(device, "VideoVAE.from_pretrained")
        if subfolder:
            path = os.path.join(path, subfolder)
        return load_reference_checkpoint(cls, path, dtype=dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.encoder.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.conv_in.weight.dtype

    def _is_quantized(self) -> bool:
        return any(quant.is_quantized(m) for m in self.modules())

    def quantize(self, *, min_cin: int = 64, calibration=None,
                 margin: float = 1.1, skip_paths=()) -> "VideoVAE":
        """int8 serving mode (``ops/quant.py``): a new VideoVAE whose big
        convs hold int8 weights with per-channel scales; this one is left
        as it is.

        With ``calibration`` (a (B,T,H,W,3) pixel clip in [-1, 1], e.g. a
        17x256x256 window of the video to be served), one untiled encoder
        and one decoder net call on it (the decoder on the mean half of the
        moments) record each quantized conv's max|x|, and each gains a
        static ``scale_x`` (x ``margin``).  Without it the activation
        scales are taken per call (``quant.act_scale``)."""
        q = copy.deepcopy(self)
        quant.quantize_conv_params(q, min_cin=min_cin,
                                   skip_paths=tuple(skip_paths))
        if calibration is None:
            return q
        # a window of a clip is a view; the kernels take contiguous input
        x = torch.as_tensor(calibration).to(
            device=self.device, dtype=self.dtype).contiguous()
        with torch.inference_mode(), quant.calibration_scope() as rec:
            moments = q.encoder(x)
            q.decoder(moments[..., :moments.shape[-1] // 2])
        quant.attach_activation_scales(rec, margin=margin)
        return q

    def with_mesh(self, mesh, axis: str = "data",
                  shard_dim: str = "height") -> "VideoVAE":
        """Multi-device inference: every net call split along one axis
        over ``mesh`` (``parallel.make_mesh``), the weights replicated.
        This process's model is sent once to every follower of the mesh
        (its whole state: int8 weights and calibrated scales too, so
        ``quantize`` comes first); the returned VideoVAE shares this one's
        modules and sends each encoder or decoder call through the mesh,
        where the ops exchange conv halos and combine GroupNorm statistics
        across ranks (``parallel/shard.py``).  Tiling and chunking are
        unchanged and run here.

        shard_dim: "height" (each rank a run of whole blocks of the net's
        total stride: 8 pixel rows for the encoder, one latent row for the
        decoder) or "time" (T divisible by the mesh size, as the JAX
        package requires: GroupNorm statistics span the sequence, so
        padding would change the numerics; v1's decoder gives 4T'-3
        frames as unsharded).  As ``cvvae_tpu/models/video_vae.py``'s
        ``with_mesh``."""
        from cvvae_tpu_torch.parallel import (spatial_sharding,
                                              temporal_sharding)
        if shard_dim not in ("height", "time"):
            raise ValueError(shard_dim)
        sharding = (spatial_sharding if shard_dim == "height"
                    else temporal_sharding)(mesh, axis)
        n = int(mesh.shape[axis])
        if n != mesh.world:
            raise ValueError(f"with_mesh: axis {axis!r} has {n} of the "
                             f"mesh's {mesh.world} devices; only a "
                             f"one-axis split is ported")
        if self.device != mesh.device:
            raise ValueError(f"with_mesh: the model is on {self.device}, "
                             f"the mesh's rank 0 on {mesh.device}")
        return _MeshVideoVAE(self, mesh, sharding.dim, mesh.load(self))

    # ---- the raw per-window nets ----

    def _encoder(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def _decoder(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    # ---- spatial tiling ----

    def _run_net(self, name: str, net, x: torch.Tensor) -> torch.Tensor:
        self.tile_counts[f"{name}.calls"] += 1
        self.tile_counts[f"{name}.positions"] += _positions(x)
        return net(x)

    def _spatial_tiled(self, x: torch.Tensor, name: str, net, tile,
                       out_tile) -> torch.Tensor:
        if tile is None:
            return self._run_net(name, net, x)
        tile_h, tile_w = _pair(tile)
        if x.shape[2] <= tile_h and x.shape[3] <= tile_w:
            return self._run_net(name, net, x)
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
                with spans.span("cvvae.vae.tile", len(rows), len(row)):
                    row.append(self._run_net(
                        name, net,
                        x[:, :, i:i + tile_h, j:j + tile_w, :].contiguous()))
                if j + tile_w >= x.shape[3]:
                    break
            rows.append(row)
            if i + tile_h >= x.shape[2]:
                break

        with spans.span("cvvae.vae.blend"):
            return self._blend(rows, out_overlap_h, out_overlap_w,
                               out_stride_h, out_stride_w)

    @staticmethod
    def _blend(rows, out_overlap_h, out_overlap_w, out_stride_h,
               out_stride_w) -> torch.Tensor:
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
        return self._spatial_tiled(x, "encoder", self._encoder,
                                   cfg.encode_pixel_tile_size,
                                   cfg.encode_latent_tile_size)

    def spatial_tiled_decode(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return self._spatial_tiled(z, "decoder", self._decoder,
                                   cfg.latent_tile_size, cfg.pixel_tile_size)

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
            with spans.span("cvvae.vae.chunk", n):
                out = fn(v[:, n * stride:(n + 1) * stride + 1].contiguous())
            outs.append(out if n == 0 else out[:, 1:])
        return torch.cat(outs, dim=1)

    def tiled_encode(self, x: torch.Tensor) -> torch.Tensor:
        self.tile_counts["encoder.input_positions"] += _positions(x)
        return self._chunked(x, self.config.en_de_n_frames_a_time,
                             self.spatial_tiled_encode)

    def tiled_decode(self, z: torch.Tensor) -> torch.Tensor:
        self.tile_counts["decoder.input_positions"] += _positions(z)
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
        with spans.span("cvvae.vae.encode"):
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
        with spans.span("cvvae.vae.decode"):
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


class _MeshVideoVAE(VideoVAE):
    """``VideoVAE.with_mesh``'s model: the base model's modules and config,
    each net call split over the mesh (``Mesh.run_net``)."""

    def __init__(self, base: VideoVAE, mesh, dim: int, model_id: int):
        nn.Module.__init__(self)
        self.config = base.config
        self.encoder, self.decoder = base.encoder, base.decoder
        self.tile_counts = collections.Counter()
        #: the split axis of (B, T, H, W, C): 1 time, 2 height
        self.mesh, self.dim, self.model_id = mesh, dim, model_id

    def _run(self, name: str, v: torch.Tensor, block: int) -> torch.Tensor:
        from cvvae_tpu_torch.parallel import shard
        if v.ndim != 5:
            raise ValueError(f"expected a 5-D tensor, got {tuple(v.shape)}")
        n = self.mesh.world
        sizes = (shard.time_split(v.shape[1], n) if self.dim == 1
                 else shard.row_split(v.shape[2], n, block))
        return self.mesh.run_net(self.model_id, getattr(self, name), name,
                                 v.contiguous(), self.dim, sizes)

    def _encoder(self, x: torch.Tensor) -> torch.Tensor:
        return self._run("encoder", x, self.config.spatial_n_compress)

    def _decoder(self, z: torch.Tensor) -> torch.Tensor:
        return self._run("decoder", z, 1)

    def quantize(self, **kwargs):
        raise ValueError("quantize the model before with_mesh: the mesh "
                         "holds the state it was given")

    def with_mesh(self, *args, **kwargs):
        raise ValueError("this model already runs over a mesh")


def config_for_variant(variant: str) -> VideoVAEConfig:
    if variant in ("v1", "v1-1", "vae3d", "vae3d_v1-1"):
        return VideoVAEConfig(family="v1")
    if variant in ("sd3", "vae3d_sd3"):
        return VideoVAEConfig(family="sd3", scaling_factor=1.5305)
    raise ValueError(f"unknown variant {variant!r}")
