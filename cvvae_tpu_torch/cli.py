"""Video reconstruction CLI — port of ``cvvae_tpu/cli.py``.

Read an mp4, truncate to 4k+1 frames, normalise to [-1,1], encode ->
sample the posterior (or take its mode) -> decode, write the
reconstruction.

Usage:
    python -m cvvae_tpu_torch.cli --video_path in.mp4 --save_path out.mp4 \
        [--height 576 --width 1024] [--dtype bf16] [--device cuda] \
        [--mode sample|mode] [--serving] [--metrics]

The model runs with random weights made from --seed (loading the
reference checkpoints is not ported yet).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--variant", type=str, default="v1", help="v1 | v1-1")
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--dtype", type=str, default="bf16",
                   choices=["bf16", "fp32", "int8"])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--mode", type=str, default="sample",
                   choices=["sample", "mode"],
                   help="posterior sampling (reference default) or mean")
    p.add_argument("--serving", action="store_true",
                   help="serving preset: untiled full-frame encode and "
                        "rectangular decode tiles sized to the frame")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", action="store_true",
                   help="print PSNR + timing JSON to stdout")
    return p


def _serving_axis_plan(size: int):
    """Split one spatial axis into the fewest tiles of at most 720 px with
    an exact 8-latent (64-px) blended overlap.  Returns (tile_px,
    overlap_ratio) with ratio == 8/latent_tile, so the tile math in
    VideoVAE._spatial_tiled rounds back to exactly 64 px on this axis."""
    lat = size // 8
    n = max(1, -(-size // 720))
    while True:
        lat_stride = -(-(lat - 8) // n)
        tile_lat = lat_stride + 8
        if tile_lat * 8 <= 720 or lat_stride <= 1:
            break
        n += 1
    return tile_lat * 8, 8 / tile_lat


def serving_decode_tiles(height: int, width: int):
    """Decode tile plan of the serving preset: frames up to 720 px run
    untiled; larger frames use rectangular tiles with an 8-latent (64-px)
    blended overlap per axis — 1280x720 -> two 720x672 tiles.  Returns
    (tile_spatial_size, tile_overlap_ratio) for VideoVAEConfig."""
    if height <= 720 and width <= 720:
        return None, 0.2222
    th, rh = _serving_axis_plan(height)
    tw, rw = _serving_axis_plan(width)
    return (th, tw), (rh, rw)


def apply_serving_preset(vae, height: int, width: int):
    """Install the serving preset on ``vae`` for (height, width) frames:
    v1's zero-padded encoder runs the full frame untiled, the decoder uses
    the rectangular tile plan."""
    tile, ratio = serving_decode_tiles(height, width)
    vae.config = dataclasses.replace(
        vae.config, tile_spatial_size=tile, tile_overlap_ratio=ratio,
        encode_tile_spatial_size=None)
    return vae


def torch_dtype(name: str) -> torch.dtype:
    if name == "int8":
        raise SystemExit("--dtype int8 is not ported yet (ROADMAP queue A: "
                         "int8 with its hand-written int8 conv)")
    return torch.float32 if name == "fp32" else torch.bfloat16


def require_device(name: str) -> torch.device:
    """The requested device, or SystemExit when this machine lacks it."""
    device = torch.device(name)
    if device.type == "cuda" and (
            not torch.cuda.is_available()
            or (device.index or 0) >= torch.cuda.device_count()):
        raise SystemExit(f"--device {name}: no such CUDA device here")
    return device


def main(argv=None) -> dict:
    from cvvae_tpu_torch.data import video_io
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    args = build_argparser().parse_args(argv)
    dtype = torch_dtype(args.dtype)
    device = require_device(args.device)
    vae = VideoVAE.from_config(config_for_variant(args.variant),
                               seed=args.seed, dtype=dtype, device=device)
    if args.serving:
        apply_serving_preset(vae, args.height, args.width)

    frames, fps = video_io.read_video(
        args.video_path, height=args.height, width=args.width,
        max_frames=args.max_frames)
    n = video_io.truncate_to_4k1(len(frames))
    x_np = video_io.normalize(frames[:n])
    x = torch.from_numpy(x_np).to(device=device, dtype=dtype)[None]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    posterior = vae.encode(x)
    if args.mode == "sample":
        g = torch.Generator(device=device).manual_seed(args.seed)
        z = posterior.sample(g)
    else:
        z = posterior.mode()
    sync()
    t_encode = time.perf_counter() - t0

    t0 = time.perf_counter()
    x_rec = vae.decode(z)
    sync()
    t_decode = time.perf_counter() - t0

    rec_np = x_rec[0].float().cpu().numpy()
    video_io.write_video(args.save_path, video_io.denormalize(rec_np), fps)
    mse = float(np.mean((rec_np - x_np) ** 2))
    psnr = float(10.0 * np.log10(4.0 / mse)) if mse > 0 else float("inf")
    result = {
        "frames": int(n), "height": args.height, "width": args.width,
        "device": str(device), "latent_shape": list(z.shape),
        "encode_s": t_encode, "decode_s": t_decode, "psnr_db": psnr,
        "save_path": args.save_path,
    }
    if args.metrics:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
