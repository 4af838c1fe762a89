#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its findings; any failure exits non-zero):

1. device  -- require a CUDA card; print torch / CUDA / cuDNN versions
   and the card's name and power limit (nvidia-smi).
2. build   -- build the hand-written kernels from ``cvvae_tpu_torch/csrc``.
3. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes the 720p serving paths give it (bf16; K1/K3/K4 also fp32),
   with median CUDA-event times taken in turns (plain, kernel, kernel,
   plain).
4. slice   -- full-width v1 and SD3 in fp32 (TF32 off): encode + decode
   on the card (kernels) against the CPU (plain versions); the SD3 clip's
   32x32 latent makes K4 run in both mid-blocks.
5. serving -- for v1, then SD3: the server ``serve.main`` builds
   (``serve.prepare``) for 17x720x1280 bf16 clips on an ephemeral port;
   /healthz, /reconstruct, /encode, /decode, /stats; shapes, finiteness,
   byte equality of /reconstruct and /decode(/encode), and a launch of
   every kernel of that path (counts set to 0 just before, read just
   after).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON summary.  It imports nothing of JAX.
"""

from __future__ import annotations

import gc
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: tolerances of the kernel-vs-plain checks, as |got - ref| <= tol * (1 +
#: |ref|) elementwise (atol = rtol = tol)
TOL = {
    # K1 fp32: Chan merge vs E[x^2]-mean^2 and __expf reorder the last bits
    ("K1", torch.float32): 1e-5,
    # K1 bf16: the kernel rounds once, the plain version (JAX numerics)
    # rounds the folded affine, the product, the sum and the SiLU: a few
    # bf16 ulps (2^-8 relative each)
    ("K1", torch.bfloat16): 2e-2,
    # K3 fp32: 81 fp32 FMAs in another order than cuDNN (TF32 off)
    ("K3", torch.float32): 2e-5,
    # K3 bf16: both accumulate in fp32 and round once: 1 bf16 ulp
    ("K3", torch.bfloat16): 1e-2,
    # K4 fp32: fp32 FMAs and an online softmax against cuBLAS (TF32 off)
    # and a full-row softmax: sums in another order
    ("K4", torch.float32): 2e-5,
}
#: K4 bf16, held by two bounds instead: max|got - ref| <= K4_BF16_MAX *
#: max|ref| and ||got - ref|| / ||ref|| <= K4_BF16_RMS.  The two round
#: their outputs to bf16 apart (the kernel rounds the unnormalised
#: probabilities, the plain version the normalised weights), one ulp at
#: most, and an ulp is <= 2^-7 of max|ref|; on an H100 they differ by at
#: most 7.2e-3 * max|ref| and 3.6e-3 RMS at every shape checked here and
#: in the card tests.  A missing tail mask gives 2.5e-2 and 2.8e-2 at S =
#: 1100; a dropped key tile or a 10% scale error 0.17 * max|ref| and more.
K4_BF16_MAX = 1.5e-2
K4_BF16_RMS = 5e-3
#: whole slice, card against CPU, fp32 (TF32 off): relative to max|ref|
SLICE_TOL = 1e-3
#: each family's slice clip (B, T, H, W, 3): SD3's 32x32 latent is 1024
#: tokens, the card's K4 threshold
SLICE_CLIPS = {"v1": (1, 9, 64, 64, 3), "sd3": (1, 5, 256, 256, 3)}
#: the served clip (T, H, W)
SERVE_CLIP = (17, 720, 1280)
#: latent channels and the kernels each served path must launch
PATHS = {"v1": (4, ("K1", "K2", "K3", "K4")),
         "sd3": (16, ("K1", "K2", "K4"))}

KERNELS = {
    "K1": dict(name="group_norm_silu", route="cuda",
               source="cvvae_tpu_torch/csrc/groupnorm.cu",
               replaces="cvvae_tpu/ops/pallas/groupnorm.py:90"),
    "K2": dict(name="subpixel_interleave", route="cuda",
               source="cvvae_tpu_torch/csrc/shuffle.cu",
               replaces="cvvae_tpu/ops/pallas/shuffle.py:148"),
    "K3": dict(name="stem_conv3d", route="cuda",
               source="cvvae_tpu_torch/csrc/stem.cu",
               replaces="cvvae_tpu/ops/pallas/stem.py:209"),
    "K4": dict(name="flash_attention", route="cuda",
               source="cvvae_tpu_torch/csrc/attention.cu",
               replaces="cvvae_tpu/ops/attention.py:60"),
}


def kernel_modules():
    from cvvae_tpu_torch.ops.kernels import attention, groupnorm, shuffle, stem
    return {"K1": groupnorm, "K2": shuffle, "K3": stem, "K4": attention}


def say(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def randn(shape, seed, device, dtype, scale=1.0, shift=0.0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return (x * scale + shift).to(dtype)


def compare(got, ref, tol=0.0):
    """(max |got - ref|, max of |got - ref| - tol * (1 + |ref|), max |ref|,
    ||got - ref|| / ||ref||), taken over 2^26-element slices so no
    full-size fp32 temporary exists.  A non-finite output is an infinite
    error."""
    if not torch.isfinite(got).all():
        return (float("inf"),) * 4
    g, r = got.reshape(-1), ref.reshape(-1)
    err = excess = ref_max = d2 = r2 = 0.0
    for i in range(0, g.numel(), 1 << 26):
        a, b = g[i:i + (1 << 26)].double(), r[i:i + (1 << 26)].double()
        d = (a - b).abs()
        err = max(err, d.max().item())
        excess = max(excess, (d - tol * (1 + b.abs())).max().item())
        ref_max = max(ref_max, b.abs().max().item())
        d2 += d.square().sum().item()
        r2 += b.square().sum().item()
    return err, excess, ref_max, (d2 / r2) ** 0.5


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of one call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def in_turns(plain, kernel):
    """plain, kernel, kernel, plain -> (kernel ms, plain ms)."""
    p1 = time_ms(plain)
    k1 = time_ms(kernel)
    k2 = time_ms(kernel)
    p2 = time_ms(plain)
    return statistics.median([k1, k2]), statistics.median([p1, p2])


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _check_kernels(dev):
    from cvvae_tpu_torch.ops.conv import Conv3DSpec
    from cvvae_tpu_torch.ops.kernels import attention, groupnorm, shuffle, stem

    summary = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
               for k in KERNELS}

    def record(key, label, err, excess, bound, k_ms, p_ms, timed):
        ok = excess <= 0.0
        say(f"[kernels] {key} {label}: max_abs_err={err!r} {bound} "
            f"kernel_ms={k_ms!r} plain_ms={p_ms!r} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{key} {label}: disagrees with its plain "
                             f"version (max_abs_err {err}; {bound})")
        s = summary[key]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if timed:
            s["ms"], s["plain_ms"] = k_ms, p_ms

    # K1: encoder level 0 (SiLU), mid-block per-frame norm (no SiLU),
    # decoder tile level 0->1 (SiLU); the timed shape is the largest
    k1_cases = [
        ((1, 17, 720, 1280, 128), True, False, True),
        ((1, 5, 90, 160, 512), False, True, False),
        ((1, 5, 90, 84, 512), True, False, False),
        ((1, 17, 720, 672, 256), True, False, False),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for shape, silu, per_frame, timed in k1_cases:
            c = shape[-1]
            x = randn(shape, 1, dev, dtype, 2.0, 0.5)
            w = randn((c,), 2, dev, torch.float32, 0.5, 1.0)
            b = randn((c,), 3, dev, torch.float32, 0.5)
            kw = dict(num_groups=32, eps=1e-5, silu=silu, per_frame=per_frame)
            got = groupnorm.group_norm_silu(x, w, b, **kw)
            ref = groupnorm.group_norm_silu_plain(x, w, b, **kw)
            torch.cuda.synchronize()
            if got.shape != x.shape or got.dtype != dtype:
                raise SystemExit(f"K1 output {tuple(got.shape)} {got.dtype}")
            tol = TOL[("K1", dtype)]
            err, excess = compare(got, ref, tol)[:2]
            del got, ref
            k_ms = p_ms = None
            if timed:
                k_ms, p_ms = in_turns(
                    lambda: groupnorm.group_norm_silu_plain(x, w, b, **kw),
                    lambda: groupnorm.group_norm_silu(x, w, b, **kw))
            record("K1", f"{tuple(shape)} {dtype} silu={silu} "
                   f"per_frame={per_frame}", err, excess,
                   f"tol={tol!r}*(1+|ref|)",
                   k_ms, p_ms, timed and dtype == torch.bfloat16)
            del x
            torch.cuda.empty_cache()

    # K2: the three upsample tails of one 720x672 decoder tile
    k2_cases = [((1, 5, 90, 84, 1024), 2, False),
                ((1, 9, 180, 168, 512), 1, False),
                ((1, 9, 360, 336, 512), 2, True)]
    for dtype in (torch.bfloat16, torch.float32):
        for i, (shape, n, timed) in enumerate(k2_cases):
            if dtype == torch.float32 and timed:
                continue  # the path runs bf16; fp32 is checked smaller
            phases = [randn(shape, 10 + j, dev, dtype) for j in range(4)]
            bias = randn(shape[-1:], 20, dev, dtype)
            got = shuffle.subpixel_interleave(phases, bias, n=n)
            ref = shuffle.subpixel_interleave_plain(phases, bias, n=n)
            torch.cuda.synchronize()
            exact = got.shape == ref.shape and torch.equal(got, ref)
            err = (0.0 if exact else compare(got, ref)[0]
                   if got.shape == ref.shape else float("inf"))
            del got, ref
            k_ms = p_ms = None
            if timed:
                k_ms, p_ms = in_turns(
                    lambda: shuffle.subpixel_interleave_plain(phases, bias, n=n),
                    lambda: shuffle.subpixel_interleave(phases, bias, n=n))
            record("K2", f"{tuple(shape)} n={n} {dtype} bit-exact={exact}",
                   err, 0.0 if exact else 1.0, "tol=bit-exact", k_ms, p_ms,
                   timed)
            del phases
            torch.cuda.empty_cache()

    # K3: the encoder's conv_in on a 17-frame 720p clip
    spec = Conv3DSpec.v1_causal()
    for dtype in (torch.bfloat16, torch.float32):
        x = randn((1, 17, 720, 1280, 3), 30, dev, dtype).clamp(-1, 1)
        w = randn((128, 3, 3, 3, 3), 31, dev, dtype, 1 / 9)
        b = randn((128,), 32, dev, dtype, 0.1)
        got = stem.stem_conv3d(x, w, b, spec)
        ref = stem.stem_conv3d_plain(x, w, b, spec)
        torch.cuda.synchronize()
        tol = TOL[("K3", dtype)]
        err, excess = compare(got, ref, tol)[:2]
        del got, ref
        k_ms, p_ms = in_turns(lambda: stem.stem_conv3d_plain(x, w, b, spec),
                              lambda: stem.stem_conv3d(x, w, b, spec))
        record("K3", f"(1, 17, 720, 1280, 3) {dtype}", err, excess,
               f"tol={tol!r}*(1+|ref|)", k_ms, p_ms, dtype == torch.bfloat16)
        del x
        torch.cuda.empty_cache()

    # K4: the v1 encoder's untiled mid-block (the summary's time), a
    # 720x672 tile's mid-block (v1 decoder, every SD3 tile), and a ragged
    # S that is no multiple of any tile
    k4_cases = [((5, 14400, 512), torch.bfloat16, True),
                ((5, 7560, 512), torch.bfloat16, True),
                ((5, 7560, 512), torch.float32, True),
                ((1, 1100, 512), torch.bfloat16, False),
                ((1, 1100, 512), torch.float32, False)]
    for shape, dtype, timed in k4_cases:
        q, k, v = (randn(shape, 40 + i, dev, dtype) for i in range(3))
        scale = shape[-1] ** -0.5
        got = attention.flash_attention(q, k, v, scale)
        ref = attention.flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != dtype:
            raise SystemExit(f"K4 output {tuple(got.shape)} {got.dtype}")
        if dtype == torch.bfloat16:
            err, _, ref_max, rms = compare(got, ref)
            excess = max(err - K4_BF16_MAX * ref_max, rms - K4_BF16_RMS)
            bound = (f"max|ref|={ref_max!r} rms={rms!r} tol={K4_BF16_MAX}"
                     f"*max|ref| and rms {K4_BF16_RMS}")
        else:
            tol = TOL[("K4", dtype)]
            err, excess = compare(got, ref, tol)[:2]
            bound = f"tol={tol!r}*(1+|ref|)"
        del got, ref
        k_ms = p_ms = None
        if timed:
            k_ms, p_ms = in_turns(
                lambda: attention.flash_attention_plain(q, k, v, scale),
                lambda: attention.flash_attention(q, k, v, scale))
        record("K4", f"{shape} {dtype}", err, excess, bound, k_ms, p_ms,
               shape == (5, 14400, 512))
        del q, k, v
        torch.cuda.empty_cache()
    return summary


# --------------------------------------------------------------------------
# phase 4: the whole slice, card against CPU
# --------------------------------------------------------------------------

def _check_slice(dev, family):
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    k4 = kernel_modules()["K4"]
    cfg = config_for_variant(family)
    clip = SLICE_CLIPS[family]
    x = np.random.RandomState(0).uniform(-1, 1, clip)
    x = torch.from_numpy(x.astype(np.float32))
    outs = {}
    for d in ("cpu", dev):
        vae = VideoVAE.from_config(cfg, seed=0, device=d)
        k4.launches = 0
        t0 = time.perf_counter()
        z = vae.encode(x.to(d)).mode()
        rec = vae.decode(z)
        if d != "cpu":
            torch.cuda.synchronize()
        say(f"[slice] {family} {d}: reconstruct {tuple(x.shape)} -> latent "
            f"{tuple(z.shape)}, frames {tuple(rec.shape)} in "
            f"{time.perf_counter() - t0:.2f}s; K4 launches {k4.launches}")
        outs[str(d)] = (z.cpu(), rec.cpu())
        del vae
    if family == "sd3" and k4.launches <= 0:
        raise SystemExit("slice sd3: K4 was not launched on the card")
    (zc, rc), (zg, rg) = outs["cpu"], outs[str(dev)]
    b, t, h, w, _ = clip
    for name, ref, got, shape in (
            ("latent", zc, zg, (b, (t - 1) // 4 + 1, h // 8, w // 8,
                                cfg.latent_channels)),
            ("frames", rc, rg, clip)):
        if tuple(got.shape) != shape or not torch.isfinite(got).all():
            raise SystemExit(f"slice {family} {name}: shape "
                             f"{tuple(got.shape)} or non-finite values")
        err = (got - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        ok = err <= SLICE_TOL * scale
        say(f"[slice] {family} {name}: max_abs_err={err!r} "
            f"(max|ref|={scale!r}, tol={SLICE_TOL}*max(1,max|ref|)) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"slice {family} {name}: card and CPU disagree")


# --------------------------------------------------------------------------
# phase 5: serving
# --------------------------------------------------------------------------

def _request(port, method, path, arr=None, timeout=900):
    body = None
    if arr is not None:
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        body = buf.getvalue()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    wall = time.perf_counter() - t0
    conn.close()
    if resp.status != 200:
        raise SystemExit(f"{method} {path}: HTTP {resp.status} {data[:300]!r}")
    return data, wall


def _serve(dev, smi, variant):
    from cvvae_tpu_torch import serve

    t, h, w = SERVE_CLIP
    z_ch, needed = PATHS[variant]
    args = serve.build_argparser().parse_args(
        ["--variant", variant, "--dtype", "bf16", "--height", str(h),
         "--width", str(w), "--warm_frames", str(t), "--device", str(dev),
         "--port", "0"])
    t0 = time.perf_counter()
    server = serve.prepare(args)
    say(f"[serve] {variant}: prepare (build + preset + warm-up) "
        f"{time.perf_counter() - t0:.2f}s; encoder tile "
        f"{server.worker.vae.config.encode_pixel_tile_size}, decoder tile "
        f"{server.worker.vae.config.pixel_tile_size}")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    mods = kernel_modules()
    try:
        clip = np.random.RandomState(0).randint(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in mods.values():
            m.launches = 0
        health, _ = _request(port, "GET", "/healthz")
        if json.loads(health) != {"ok": True}:
            raise SystemExit(f"/healthz: {health!r}")
        rec_b, t_rec = _request(port, "POST", "/reconstruct", clip)
        z_b, t_enc = _request(port, "POST", "/encode", clip)
        z = np.load(io.BytesIO(z_b), allow_pickle=False)
        dec_b, t_dec = _request(port, "POST", "/decode", z)
        stats_b, _ = _request(port, "GET", "/stats")
        launches = {k: m.launches for k, m in mods.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
        # the worker thread lives on: drop its model so the next path
        # starts from a free card
        server.worker.vae = None
        del server
        gc.collect()
        torch.cuda.empty_cache()
    rec = np.load(io.BytesIO(rec_b), allow_pickle=False)
    dec = np.load(io.BytesIO(dec_b), allow_pickle=False)
    say(f"[serve] {variant}: latent {z.shape} {z.dtype}; frames {rec.shape} "
        f"{rec.dtype}")
    if z.shape != (1, (t - 1) // 4 + 1, h // 8, w // 8, z_ch) \
            or not np.isfinite(z).all():
        raise SystemExit(f"{variant} /encode: latent {z.shape}, finite="
                         f"{bool(np.isfinite(z).all())}")
    if rec.shape != (t, h, w, 3) or rec.dtype != np.uint8:
        raise SystemExit(f"{variant} /reconstruct: frames {rec.shape} "
                         f"{rec.dtype}")
    same = rec_b == dec_b
    say(f"[serve] {variant}: /reconstruct bytes == /decode(/encode) bytes: "
        f"{same}")
    if not same:
        raise SystemExit(f"{variant}: /reconstruct and /decode(/encode) "
                         f"differ")
    say(f"[serve] {variant}: stats {stats_b.decode()}")
    say(f"[serve] {variant}: request wall s (after warm-up): "
        f"reconstruct={t_rec!r} encode={t_enc!r} decode={t_dec!r}; peak "
        f"device memory {peak / 2**30:.2f} GiB; card {smi}")
    say(f"[serve] {variant}: kernel launches in the served requests: "
        f"{launches}")
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{variant}: kernels not launched by the main "
                         f"path: {missing}")
    return launches


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "false); this script runs only on a GPU machine")
        return 1
    sys.path.insert(0, ROOT)
    from cvvae_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    # fp32 references in full fp32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    say(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"cuDNN {torch.backends.cudnn.version()}, python "
        f"{sys.version.split()[0]}")
    say(f"[device] {smi}")
    t_start = time.perf_counter()

    # phase 2: build
    t0 = time.perf_counter()
    _build.library()
    say(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_build.last_build_seconds:.2f}s)"
        f" into {_build.build_dir()}")
    log = _build.build_dir() / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                say(f"[build] {line.strip()}")

    # phase 3: kernels against their plain versions
    summary = _check_kernels(dev)
    # phase 4: the slice, card against CPU
    for family in SLICE_CLIPS:
        _check_slice(dev, family)
    # phase 5: serving, each path with its own counts
    by_path = {variant: _serve(dev, smi, variant) for variant in PATHS}

    kernels = [dict(KERNELS[k],
                    launches=sum(n[k] for n in by_path.values()),
                    launches_by_path={p: n[k] for p, n in by_path.items()},
                    **summary[k])
               for k in KERNELS]
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    say(f"[card] {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
