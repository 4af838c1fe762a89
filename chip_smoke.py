#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its findings; any failure exits non-zero):

1. device  -- require a CUDA card; print torch / CUDA / cuDNN versions
   and the card's name and power limit (nvidia-smi).
2. build   -- build the hand-written kernels from ``cvvae_tpu_torch/csrc``.
3. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes the 720p serving path gives it (bf16; K1/K3 also fp32), with
   median CUDA-event times taken in turns (plain, kernel, kernel, plain).
4. slice   -- full-width v1 in fp32 (TF32 off): ``VideoVAE.reconstruct``
   on the card (kernels) against the CPU (plain versions).
5. serving -- the server ``serve.main`` builds (``serve.prepare``) for
   17x720x1280 bf16 clips on an ephemeral port; /healthz, /reconstruct,
   /encode, /decode, /stats; shapes, finiteness, byte equality of
   /reconstruct and /decode(/encode), and a launch of every kernel.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON summary.  It imports nothing of JAX.
"""

from __future__ import annotations

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
}
#: whole slice, card against CPU, fp32 (TF32 off): relative to max|ref|
SLICE_TOL = 1e-3
#: the slice's clip (B, T, H, W, 3) and the served clip (T, H, W)
SLICE_CLIP = (1, 9, 64, 64, 3)
SERVE_CLIP = (17, 720, 1280)

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
}


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


def compare(got, ref, tol):
    """(max |got - ref|, max of |got - ref| - tol * (1 + |ref|)), taken
    over 2^26-element slices so no full-size fp32 temporary exists."""
    g, r = got.reshape(-1), ref.reshape(-1)
    err = excess = 0.0
    for i in range(0, g.numel(), 1 << 26):
        a, b = g[i:i + (1 << 26)].float(), r[i:i + (1 << 26)].float()
        d = (a - b).abs()
        err = max(err, d.max().item())
        excess = max(excess, (d - tol * (1 + b.abs())).max().item())
    return err, excess


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
    from cvvae_tpu_torch.ops.kernels import groupnorm, shuffle, stem

    summary = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
               for k in KERNELS}

    def record(key, label, err, excess, tol, k_ms, p_ms, timed):
        ok = excess <= 0.0
        say(f"[kernels] {key} {label}: max_abs_err={err!r} "
            f"tol={tol!r}*(1+|ref|) "
            f"kernel_ms={k_ms!r} plain_ms={p_ms!r} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{key} {label}: disagrees with its plain "
                             f"version (max_abs_err {err}, tol {tol})")
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
            err, excess = compare(got, ref, tol)
            del got, ref
            k_ms = p_ms = None
            if timed:
                k_ms, p_ms = in_turns(
                    lambda: groupnorm.group_norm_silu_plain(x, w, b, **kw),
                    lambda: groupnorm.group_norm_silu(x, w, b, **kw))
            record("K1", f"{tuple(shape)} {dtype} silu={silu} "
                   f"per_frame={per_frame}", err, excess, tol,
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
            err = (0.0 if exact else compare(got, ref, 0.0)[0]
                   if got.shape == ref.shape else float("inf"))
            del got, ref
            k_ms = p_ms = None
            if timed:
                k_ms, p_ms = in_turns(
                    lambda: shuffle.subpixel_interleave_plain(phases, bias, n=n),
                    lambda: shuffle.subpixel_interleave(phases, bias, n=n))
            record("K2", f"{tuple(shape)} n={n} {dtype} bit-exact={exact}",
                   err, 0.0 if exact else 1.0, 0.0, k_ms, p_ms, timed)
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
        err, excess = compare(got, ref, tol)
        del got, ref
        k_ms, p_ms = in_turns(lambda: stem.stem_conv3d_plain(x, w, b, spec),
                              lambda: stem.stem_conv3d(x, w, b, spec))
        record("K3", f"(1, 17, 720, 1280, 3) {dtype}", err, excess, tol,
               k_ms, p_ms, dtype == torch.bfloat16)
        del x
        torch.cuda.empty_cache()
    return summary


# --------------------------------------------------------------------------
# phase 4: the whole slice, card against CPU
# --------------------------------------------------------------------------

def _check_slice(dev):
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    cfg = config_for_variant("v1")
    x = np.random.RandomState(0).uniform(-1, 1, SLICE_CLIP)
    x = torch.from_numpy(x.astype(np.float32))
    outs = {}
    for d in ("cpu", dev):
        vae = VideoVAE.from_config(cfg, seed=0, device=d)
        t0 = time.perf_counter()
        z = vae.encode(x.to(d)).mode()
        rec = vae.decode(z)
        if d != "cpu":
            torch.cuda.synchronize()
        say(f"[slice] {d}: reconstruct {tuple(x.shape)} -> latent "
            f"{tuple(z.shape)}, frames {tuple(rec.shape)} in "
            f"{time.perf_counter() - t0:.2f}s")
        outs[str(d)] = (z.cpu(), rec.cpu())
        del vae
    (zc, rc), (zg, rg) = outs["cpu"], outs[str(dev)]
    b, t, h, w, _ = SLICE_CLIP
    for name, ref, got, shape in (
            ("latent", zc, zg, (b, (t - 1) // 4 + 1, h // 8, w // 8, 4)),
            ("frames", rc, rg, SLICE_CLIP)):
        if tuple(got.shape) != shape or not torch.isfinite(got).all():
            raise SystemExit(f"slice {name}: shape {tuple(got.shape)} or "
                             f"non-finite values")
        err = (got - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        ok = err <= SLICE_TOL * scale
        say(f"[slice] {name}: max_abs_err={err!r} (max|ref|={scale!r}, "
            f"tol={SLICE_TOL}*max(1,max|ref|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"slice {name}: card and CPU disagree")


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


def _serve(dev, smi):
    from cvvae_tpu_torch import serve
    from cvvae_tpu_torch.ops.kernels import groupnorm, shuffle, stem

    t, h, w = SERVE_CLIP
    args = serve.build_argparser().parse_args(
        ["--variant", "v1", "--dtype", "bf16", "--height", str(h),
         "--width", str(w), "--warm_frames", str(t), "--device", str(dev),
         "--port", "0"])
    t0 = time.perf_counter()
    server = serve.prepare(args)
    say(f"[serve] prepare (build + preset + warm-up) "
        f"{time.perf_counter() - t0:.2f}s")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    mods = {"K1": groupnorm, "K2": shuffle, "K3": stem}
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
    rec = np.load(io.BytesIO(rec_b), allow_pickle=False)
    dec = np.load(io.BytesIO(dec_b), allow_pickle=False)
    say(f"[serve] latent {z.shape} {z.dtype}; frames {rec.shape} {rec.dtype}")
    if z.shape != (1, (t - 1) // 4 + 1, h // 8, w // 8, 4) \
            or not np.isfinite(z).all():
        raise SystemExit(f"/encode: latent {z.shape}, finite="
                         f"{bool(np.isfinite(z).all())}")
    if rec.shape != (t, h, w, 3) or rec.dtype != np.uint8:
        raise SystemExit(f"/reconstruct: frames {rec.shape} {rec.dtype}")
    same = rec_b == dec_b
    say(f"[serve] /reconstruct bytes == /decode(/encode) bytes: {same}")
    if not same:
        raise SystemExit("/reconstruct and /decode(/encode) differ")
    say(f"[serve] stats {stats_b.decode()}")
    say(f"[serve] request wall s (after warm-up): reconstruct={t_rec!r} "
        f"encode={t_enc!r} decode={t_dec!r}; peak device memory "
        f"{peak / 2**30:.2f} GiB; card {smi}")
    say(f"[serve] kernel launches in the served requests: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise SystemExit(f"kernels not launched by the main path: {missing}")
    return launches, {"reconstruct_s": t_rec, "encode_s": t_enc,
                      "decode_s": t_dec, "peak_bytes": peak}


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
    _check_slice(dev)
    # phase 5: serving
    launches, _ = _serve(dev, smi)

    kernels = [dict(KERNELS[k], launches=launches[k], **summary[k])
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
