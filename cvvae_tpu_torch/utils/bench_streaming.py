"""Sustained long-video streaming throughput on the card — port of
``tools/bench_streaming.py``.

Streams a 720p clip through ``streaming.py`` with the serving config (v1:
untiled full-frame encode, two 720x672 decode tiles; ``--dtype int8``
calibrated as ``serve`` calibrates) and reports steady-state fps for the
encode + decode round trip.  Frames come from ``--video`` (OpenCV) or,
without it, a seeded synthetic 720p clip: 17 uint8 noise frames repeated
(kernel times depend on shapes, not on pixel values).

    python -m cvvae_tpu_torch.utils.bench_streaming [--dtype int8|bf16] \\
        [--max_frames 901] [--video clip.mp4] \\
        [--pipelined | --breakdown | --device_resident]

* default: frames on the host -> ``streaming_encode`` ->
  ``streaming_decode`` -> uint8 blocks on the host (uploads and fetches
  included); ``--pipelined`` adds the frame thread and the early fetch;
  ``--breakdown`` also times reading the frames alone and the stream of
  frames already in memory;
* ``--device_resident``: the stream's windows with every window's frames
  already on the card (one real window staged per window shape, replayed)
  and every decoded block reduced to a checksum on the card, so the only
  fetch is one scalar at the end; two passes over the plan, the second
  timed.  Prints the sustained fps, the pass's peak device memory
  (``torch.cuda.max_memory_allocated``) and one encode and one decode
  window's peak.

Every number is printed with the card's name and power limit.  Refuses to
run without a card.
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

#: the frame size streamed (H, W)
SIZE = (720, 1280)


def synthetic_frames(n: int, seed: int = 0):
    """``n`` 720p uint8 frames cycling through 17 seeded noise frames."""
    pool = np.random.RandomState(seed).randint(0, 256, (17,) + SIZE + (3,),
                                               dtype=np.uint8)
    return itertools.islice(itertools.cycle(pool), n)


def frames_of(args, n: int):
    if args.video is None:
        return synthetic_frames(n)
    from cvvae_tpu_torch.streaming import read_video_frames
    frames, _ = read_video_frames(args.video, height=SIZE[0], width=SIZE[1],
                                  max_frames=n)
    return frames


def window_plan(n_frames: int, window: int):
    """The frame counts of the stream's encode windows (window+1 frames,
    one shared; a 1-frame tail is overlap only)."""
    shapes, start, first = [], 0, True
    while True:
        stop = min(start + window + 1, n_frames)
        if stop - start > 1 or first:
            shapes.append(stop - start)
        if stop >= n_frames:
            return shapes
        start, first = stop - 1, False


def sync_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def window_peak(fn) -> float:
    """GiB the card held at most during ``fn``, above what it held
    before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


@torch.inference_mode()
def device_resident_stream(vae, args, dtype, card: str) -> None:
    from cvvae_tpu_torch.data.video_io import to_uint8, to_unit

    window = vae.config.en_de_n_frames_a_time
    dwin = vae.config.decode_n_frames_a_time
    plan = window_plan(args.max_frames, window)
    host = np.stack(list(frames_of(args, max(plan))))
    if host.shape[0] < max(plan):
        raise SystemExit(f"--device_resident needs a clip of >= {max(plan)} "
                         f"frames at 720p; {args.video} has {host.shape[0]}")
    dev = vae.device
    staged = {t: torch.from_numpy(host[:t]).to(dev) for t in set(plan)}
    del host

    def decode(piece, drop_first):
        u8 = to_uint8(vae.spatial_tiled_decode(piece.contiguous())[0])
        return u8[1:] if drop_first else u8

    def run():
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        out = {"frames": 0, "first": True}

        def emit(piece):
            u8 = decode(piece, not out["first"])
            acc.add_(u8.sum(dtype=torch.int64))
            out["frames"] += u8.shape[0]
            out["first"] = False

        buf = None
        for i, t in enumerate(plan):
            z = vae.encode(to_unit(staged[t][None], dtype)).mode()
            z = z if i == 0 else z[:, 1:]
            buf = z if buf is None else torch.cat([buf, z], dim=1)
            while buf.shape[1] >= dwin + 1:
                emit(buf[:, :dwin + 1])
                buf = buf[:, dwin:]          # keep the overlap latent
        if buf.shape[1] > 1 or (out["first"] and buf.shape[1] == 1):
            emit(buf)                        # the tail window
        return acc.item(), out["frames"]     # the one fetch

    run()                                            # warm every shape
    torch.cuda.reset_peak_memory_stats()
    (checksum, n_out), dt = sync_wall(run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if n_out != args.max_frames:
        raise SystemExit(f"the plan gave {n_out} frames, not "
                         f"{args.max_frames}")
    print(f"[bench_streaming] device-resident stream: {n_out} frames "
          f"{SIZE[0]}p ({args.dtype}) in {dt!r} s -> {n_out / dt!r} fps "
          f"sustained ({n_out / dt / 30:.3f}x realtime-30); checksum "
          f"{checksum}; peak device memory {peak!r} GiB; card {card}",
          flush=True)
    t = max(plan)
    enc = window_peak(lambda: vae.encode(to_unit(staged[t][None], dtype)))
    z = torch.zeros((1, dwin + 1, SIZE[0] // 8, SIZE[1] // 8,
                     vae.config.latent_channels), dtype=dtype, device=dev)
    dec = window_peak(lambda: vae.spatial_tiled_decode(z))
    print(f"[bench_streaming]   one encode window (1, {t}, {SIZE[0]}, "
          f"{SIZE[1]}, 3): peak {enc!r} GiB above the resident; one decode "
          f"window {tuple(z.shape)}: {dec!r} GiB; card {card}", flush=True)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="int8", choices=["int8", "bf16"])
    ap.add_argument("--video", default=None,
                    help="a 720p-or-larger clip; without it, seeded "
                         "synthetic frames")
    ap.add_argument("--max_frames", type=int, default=301)
    ap.add_argument("--pipelined", action="store_true",
                    help="frame thread + early fetch (reconstruct_stream's "
                         "pipelined mode)")
    ap.add_argument("--breakdown", action="store_true",
                    help="also time reading the frames alone and the "
                         "stream of frames already in memory")
    ap.add_argument("--device_resident", action="store_true",
                    help="stream the windows card to card (one staged "
                         "uint8 window per shape, replayed) with an on-card "
                         "checksum of every block: the card's sustained "
                         "rate without the host link")
    return ap


def main(argv=None):
    from argparse import Namespace

    from cvvae_tpu_torch import serve
    from cvvae_tpu_torch.cli import apply_serving_preset, require_device
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant
    from cvvae_tpu_torch.streaming import (reconstruct_stream,
                                           streaming_decode, streaming_encode)
    from cvvae_tpu_torch.utils.profiling import card as card_line

    args = build_argparser().parse_args(argv)
    device = require_device("cuda")
    card = card_line()
    dtype = torch.bfloat16
    vae = VideoVAE.from_config(config_for_variant("v1"), dtype=dtype,
                               device=device)
    apply_serving_preset(vae, *SIZE)
    if args.dtype == "int8":
        vae = serve.quantized(vae, Namespace(
            height=SIZE[0], width=SIZE[1], calibration_video=args.video,
            quantized_cache=None), 17)

    if args.device_resident:
        device_resident_stream(vae, args, dtype, card)
        return

    def stream(frames, pipelined=False):
        if pipelined:
            return reconstruct_stream(vae, frames, lambda block: None,
                                      dtype=dtype, pipelined=True)
        return sum(len(x) for x in streaming_decode(
            vae, streaming_encode(vae, frames, dtype=dtype)))

    # warm-up: three windows, so every window shape and the drop-first
    # decode runs outside the timed region
    stream(synthetic_frames(49, seed=1))
    if args.breakdown:
        t0 = time.perf_counter()
        host_frames = list(frames_of(args, args.max_frames))
        dt = time.perf_counter() - t0
        print(f"[bench_streaming]   frames read alone: "
              f"{len(host_frames) / dt!r} fps", flush=True)
        n, dt = sync_wall(lambda: stream(iter(host_frames)))
        print(f"[bench_streaming]   stream of frames in memory: {n / dt!r} "
              f"fps (card + uploads + fetches); card {card}", flush=True)
        del host_frames
    n_out, dt = sync_wall(lambda: stream(frames_of(args, args.max_frames),
                                         args.pipelined))
    tag = "pipelined" if args.pipelined else "serial"
    print(f"[bench_streaming] streamed {n_out} frames {SIZE[0]}p "
          f"({args.dtype}, {tag}) in {dt!r} s -> {n_out / dt!r} fps "
          f"sustained with the frame source and the host link "
          f"({n_out / dt / 30:.3f}x realtime-30); card {card}", flush=True)


if __name__ == "__main__":
    main()
