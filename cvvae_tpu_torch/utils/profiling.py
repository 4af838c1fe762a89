"""Where a served request's device time goes: ``torch.profiler`` over one
``/reconstruct`` of the serving worker, on a CUDA card; or, with
``--unet_step``, over one CFG step of the latent-compat demo's SD 2.1
UNet.

    python -m cvvae_tpu_torch.utils.profiling --variant sd3 \
        [--dtype int8|bf16|fp32] [--out FILE]
    python -m cvvae_tpu_torch.utils.profiling --unet_step \
        [--dtype bf16|fp32] [--out FILE]

The request is the served unit of work: a 17x720x1280 clip, served in
``--dtype`` (int8, the server's default, calibrates on the synthetic clip
as ``serve`` does).
Builds, presets and warms the server exactly as ``serve.main`` does
(``serve.prepare``), runs one request unprofiled, then one inside the
profiler, and prints the wall time, the summed kernel time (the device's
busy share of the wall: one stream, so kernels do not overlap), the
kernel time by group, the top kernels, and for the top kernels the ops
that launched them with their input shapes (which convs run a cuDNN
kernel).  ``--out`` also writes the
profiler's full table there.  The UNet step is the demo's unit of work:
the full-width UNet from seeded random weights, a batch of 2 (uncond,
cond) 64x64 latents (512x512 pixels) at t = 500 with a 77-token context,
in ``--dtype``.  Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

#: the served clip (T, H, W) and the number of top kernels printed
CLIP = (17, 720, 1280)
#: the demo's CFG UNet step: (batch, latent H, latent W), context tokens
UNET_STEP = (2, 64, 64)
UNET_CONTEXT = 77
TOP = 25
#: (kernel, launching op, input shapes) rows printed, by device time
TOP_SHAPES = 15

#: kernel-name patterns -> the group PERF.md reports them under (first
#: match wins)
GROUPS = [
    ("K4 flash attention", r"flash_fwd"),
    ("K1 GroupNorm+SiLU", r"gn_stats|gn_merge|gn_apply"),
    ("K2 subpixel interleave", r"subpixel|interleave"),
    ("K3 stem conv", r"stem"),
    ("K5.gemm int8 GEMM", r"int8_gemm"),
    ("K5.stage int8 staging", r"int8_stage"),
    # cuBLAS's products before cuDNN's: both name kernels sm90_xmma_*
    ("GEMMs (dense, attention)", r"xmma_gemm|nvjet|cublas|gemv"),
    ("cuDNN convs", r"xmma|implicit_gemm|conv|cudnn|cutlass|fprop"),
    ("replicate pads", r"replication_pad"),
    ("zero pads", r"constant_pad"),
    ("layout copies", r"copy|CatArray|cat_"),
    ("GEMMs (dense, attention)", r"gemm|sm90_|ampere_|cublas"),
    ("softmax", r"(?i)softmax"),
    ("reductions (norm moments)", r"reduce_kernel"),
    ("elementwise", r"elementwise|Functor|vectorized"),
    ("host<->device copies", r"Memcpy|memcpy"),
]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def profile_reconstruct(variant: str, dtype: str = "int8", out=None) -> None:
    from cvvae_tpu_torch import serve

    if not torch.cuda.is_available():
        raise SystemExit("profiling: needs a CUDA card")
    t, h, w = CLIP
    server = serve.prepare(serve.build_argparser().parse_args(
        ["--variant", variant, "--dtype", dtype, "--height", str(h),
         "--width", str(w), "--warm_frames", str(t), "--device", "cuda",
         "--port", "0"]))
    worker = server.worker
    clip = np.random.RandomState(0).randint(0, 256, (t, h, w, 3),
                                            dtype=np.uint8)

    def request():
        out = worker._decode(worker._encode(clip, False))
        torch.cuda.synchronize()
        return out

    _profile(request, f"{variant} {t}x{h}x{w} {dtype} /reconstruct", out)
    server.server_close()


def profile_unet_step(dtype: str = "bf16", out=None) -> None:
    from cvvae_tpu_torch.models.unet2d import (UNet2D, UNet2DConfig,
                                               make_denoiser)

    if not torch.cuda.is_available():
        raise SystemExit("profiling: needs a CUDA card")
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    unet = UNet2D.from_config(UNet2DConfig(), seed=0, dtype=dt)
    denoise = make_denoiser(unet)
    g = torch.Generator().manual_seed(1)
    b, h, w = UNET_STEP
    lat = torch.randn((b, h, w, 4), generator=g).to("cuda", dt)
    ctx = torch.randn((b, UNET_CONTEXT, unet.config.cross_attention_dim),
                      generator=g).to("cuda", dt)

    def step():
        out = denoise(lat, 500, ctx)
        torch.cuda.synchronize()
        return out

    step()
    _profile(step, f"SD 2.1 UNet CFG step ({b},{h},{w},4) {dtype}", out)


def _profile(run, label: str, out=None) -> None:
    """``run`` once unprofiled, then once in the profiler; print the wall
    times, the kernel time and busy share, the kernel time by group, the
    top kernels and the ops (with their input shapes) behind them."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    run()
    steady = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0

    # device-side events only: a CPU op's own device time repeats its
    # kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    groups = {name: [0.0, 0] for name, _ in GROUPS}
    groups["other"] = [0.0, 0]
    for e in kernels:
        name = next((g for g, pat in GROUPS if re.search(pat, e.key)), "other")
        groups[name][0] += e.self_device_time_total
        groups[name][1] += e.count
    print(f"[profile] {label}: unprofiled wall {steady!r} s, "
          f"profiled wall {wall!r} s, kernel time {total / 1e6!r} s "
          f"(busy {100 * total / 1e6 / wall:.1f}%); card {card()}")
    for name, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        if us:
            print(f"[profile] {name:28s} {us / 1e3:10.2f} ms "
                  f"{100 * us / total:5.1f}%  {n} calls")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:TOP]:
        print(f"[profile]   {e.self_device_time_total / 1e3:10.2f} ms "
              f"{e.count:5d}x {e.key[:110]}")
    # each kernel is attached to the op that launched it
    by_op = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        for k in e.kernels:
            row = by_op[(k.name, e.name, str(e.input_shapes))]
            row[0] += k.duration
            row[1] += 1
    for (kernel, op, shapes), (us, n) in sorted(
            by_op.items(), key=lambda kv: -kv[1][0])[:TOP_SHAPES]:
        print(f"[profile] shapes {us / 1e3:10.2f} ms {n:4d}x {kernel[:70]} "
              f"<- {op} {shapes[:160]}")
    if out:
        with open(out, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=200))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="sd3", choices=["v1", "sd3"])
    ap.add_argument("--dtype", default=None,
                    choices=["int8", "bf16", "fp32"],
                    help="int8 by default; bf16 with --unet_step")
    ap.add_argument("--unet_step", action="store_true",
                    help="one CFG step of the demo's SD 2.1 UNet instead")
    ap.add_argument("--out", default=None,
                    help="also write the profiler's full table here")
    args = ap.parse_args(argv)
    if args.unet_step:
        if args.dtype == "int8":
            ap.error("--unet_step runs in bf16 or fp32")
        profile_unet_step(args.dtype or "bf16", args.out)
    else:
        profile_reconstruct(args.variant, args.dtype or "int8", args.out)


if __name__ == "__main__":
    main()
