"""Where a served request's device time goes: ``torch.profiler`` over one
``/reconstruct`` of the serving worker, on a CUDA card; or, with
``--unet_step``, over one CFG step of the latent-compat demo's SD 2.1
UNet.

    python -m cvvae_tpu_torch.utils.profiling --variant sd3 \
        [--dtype int8|bf16|fp32] [--out FILE]
    python -m cvvae_tpu_torch.utils.profiling --unet_step \
        [--dtype bf16|fp32] [--out FILE]
    python -m cvvae_tpu_torch.utils.profiling --edge_conv [--frames 17] \
        [--dtype fp32|bf16] [--tf32] [--out FILE]

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
in ``--dtype``.  ``--edge_conv`` profiles v1's level-0 causal edge-pad
conv by path instead (``profile_edge_conv``).  Refuses to run without a
card.

The module also holds the port's ``sync``, ``trace`` and ``Timer``
(``cvvae_tpu/utils/profiling.py``'s; its XLA compilation cache has no
counterpart), the kernel groups every profile books device time under
(``GROUPS``; ``group_kernels``), each hand-written kernel's launch
counter (``launch_counts``) and the kernel names of ``csrc/``
(``csrc_kernels``), so a profile's launches can be held to the counters.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import os
import re
import socket
import subprocess
import time
from typing import Dict

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
#: the edge conv ``--edge_conv`` profiles: v1's level-0 causal conv on a
#: 720p clip, (B, T, H, W, C) -> 128 channels
EDGE_CONV = (1, 17, 720, 1280, 128)

#: kernel-name patterns -> the group PERF.md reports them under (first
#: match wins): each backward kernel's group stands before the forward
#: pattern that would take it
GROUPS = [
    ("K4.bwd flash attention backward", r"flash_bwd|\browdot\b"),
    ("K4 flash attention", r"flash_fwd"),
    ("K1.bwd GroupNorm+SiLU backward", r"\bgn_bwd\b"),
    # K1 split across the ranks of a mesh: one kernel an entry (and the
    # second launch of each entry's two-launch form, on no path, whose
    # gn_stats and gn_apply are K1's and fall in K1's group)
    ("K1.partial split GroupNorm moments", r"\bgn_partial(_fold)?\b"),
    ("K1.combine split GroupNorm combination", r"\bgn_combine(_coef)?\b"),
    ("K1 GroupNorm+SiLU", r"gn_stats|gn_merge|gn_apply"),
    # K1's int8 mode (the int8-resident activations, ops/qflow.py)
    ("K1.int8 GroupNorm+SiLU on int8",
     r"\bgnq_(stats|merge|apply|apply_arith)\b"),
    ("K2.bwd subpixel interleave backward",
     r"subpixel_unshuffle|\bbias_grad\b"),
    ("K2 subpixel interleave", r"subpixel|interleave"),
    ("K3.bwd stem conv backward", r"stem_bwd"),
    ("K3 stem conv", r"stem"),
    ("K5.gemm int8 GEMM", r"int8_gemm"),
    ("K5.stage int8 staging", r"int8_stage"),
    ("K6 int8 residual add", r"\bqflow_add(_sliced)?\b"),
    ("K6.requant int8 requantization", r"\bqflow_requant\b"),
    # cuBLAS's products before cuDNN's: both name kernels sm90_xmma_*
    ("GEMMs (dense, attention)", r"xmma_gemm|nvjet|cublas|gemv"),
    # cuDNN's fp32 weight-gradient engine names no conv
    ("cuDNN convs", r"xmma|implicit_gemm|conv|cudnn|cutlass|fprop|wgrad"),
    ("replicate pads", r"replication_pad"),
    ("zero pads", r"constant_pad"),
    ("layout copies", r"copy|CatArray|cat_"),
    ("GEMMs (dense, attention)", r"gemm|sm90_|ampere_|cublas"),
    ("softmax", r"(?i)softmax"),
    ("reductions (norm moments)", r"reduce_kernel"),
    ("elementwise", r"elementwise|Functor|vectorized"),
    ("device copies (memcpy DtoD)", r"Memcpy DtoD"),
    ("host<->device copies", r"Memcpy|memcpy"),
]

#: each hand-written kernel's group -> (its launch counter's key, the one
#: kernel its wrapper runs exactly once a counted launch): K1 runs
#: gn_stats, gn_merge and gn_apply, its split entries gn_partial and
#: gn_combine; K2.bwd adds bias_grad with a bias;
#: K3.bwd is the partial sums and stem_bwd_merge; K4.bwd rowdot, dkv, dq
KERNEL_GROUPS = {
    "K1 GroupNorm+SiLU": ("K1", r"\bgn_merge\b"),
    "K1.partial split GroupNorm moments": ("K1.partial", r"\bgn_partial\b"),
    "K1.combine split GroupNorm combination": ("K1.combine",
                                               r"\bgn_combine\b"),
    "K1.bwd GroupNorm+SiLU backward": ("K1.bwd", r"\bgn_bwd\b"),
    "K2 subpixel interleave": ("K2", r"subpixel_shuffle"),
    "K2.bwd subpixel interleave backward": ("K2.bwd", r"subpixel_unshuffle"),
    "K3 stem conv": ("K3", r"stem_conv_(mma|fma)"),
    "K3.bwd stem conv backward": ("K3.bwd", r"stem_bwd_merge"),
    "K4 flash attention": ("K4", r"flash_fwd"),
    "K4.bwd flash attention backward": ("K4.bwd", r"\browdot\b"),
    "K5.gemm int8 GEMM": ("K5", r"int8_gemm"),
    "K5.stage int8 staging": ("K5.stage", r"int8_stage"),
    "K1.int8 GroupNorm+SiLU on int8": ("K1.int8", r"\bgnq_merge\b"),
    "K6 int8 residual add": ("K6", r"\bqflow_add(_sliced)?\b"),
    "K6.requant int8 requantization": ("K6.requant", r"\bqflow_requant\b"),
}

#: each kernel's launch counter in ``ops/kernels``: key -> (module,
#: attribute); a wrapper adds one where it launches its kernel
COUNTERS = {"K1": ("groupnorm", "launches"),
            "K1.partial": ("groupnorm", "partial_launches"),
            "K1.combine": ("groupnorm", "combine_launches"),
            "K1.bwd": ("groupnorm", "bwd_launches"),
            "K2": ("shuffle", "launches"),
            "K2.bwd": ("shuffle", "bwd_launches"),
            "K3": ("stem", "launches"),
            "K3.bwd": ("stem", "bwd_launches"),
            "K4": ("attention", "launches"),
            "K4.bwd": ("attention", "bwd_launches"),
            "K5": ("conv_int8", "launches"),
            "K5.stage": ("conv_int8", "stage_launches"),
            # the int8-resident mode (ops/qflow.py): K5's GEMMs with an
            # int8 output (also in K5's count), K1's int8 mode, K6
            "K5.int8": ("conv_int8", "int8_out_launches"),
            "K1.int8": ("groupnorm", "int8_launches"),
            "K6": ("qflow", "qadd_launches"),
            "K6.requant": ("qflow", "requant_launches")}

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
#: each source's kernel key; ``conv_int8.cu`` holds K5.stage's kernel too
SOURCE_KEYS = {"groupnorm.cu": "K1", "groupnorm_bwd.cu": "K1.bwd",
               "shuffle.cu": "K2", "shuffle_bwd.cu": "K2.bwd",
               "stem.cu": "K3", "stem_bwd.cu": "K3.bwd",
               "attention.cu": "K4", "attention_bwd.cu": "K4.bwd",
               "conv_int8.cu": "K5", "qflow.cu": "K6"}
KERNEL_KEYS = {"int8_stage": "K5.stage", "gn_partial": "K1.partial",
               "gn_partial_fold": "K1.partial", "gn_combine": "K1.combine",
               "gn_combine_coef": "K1.combine", "gnq_stats": "K1.int8",
               "gnq_merge": "K1.int8", "gnq_apply": "K1.int8",
               "gnq_apply_arith": "K1.int8",
               "qflow_requant": "K6.requant"}


def group_of(kernel: str) -> str:
    """The group of ``GROUPS`` a kernel's name falls in ("other" if
    none)."""
    return next((g for g, pat in GROUPS if re.search(pat, kernel)), "other")


def key_of(group: str):
    """The kernel key ("K1", "K4.bwd", ...) of a hand-written kernel's
    group, else None."""
    return KERNEL_GROUPS.get(group, (None,))[0]


def launch_counts() -> Dict[str, int]:
    """Each hand-written kernel's launch counter, by key."""
    return {k: getattr(importlib.import_module(
        f"cvvae_tpu_torch.ops.kernels.{m}"), attr)
        for k, (m, attr) in COUNTERS.items()}


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def global_names(text: str):
    """The names of the ``__global__`` functions in CUDA source ``text``,
    past their ``__launch_bounds__(...)``-style attributes."""
    text, names = _strip_comments(text), []
    word = re.compile(r"\s*(\w+)\s*")
    for m in re.finditer(r"\b__global__\b", text):
        i = m.end()
        while True:
            w = word.match(text, i)
            name, i = w.group(1), w.end()
            if text[i] != "(":
                continue                     # void, static, ...
            if not (name.startswith("__") and name.endswith("__")):
                names.append(name)
                break
            depth = 0                        # an attribute's arguments
            for j in range(i, len(text)):
                depth += {"(": 1, ")": -1}.get(text[j], 0)
                if depth == 0:
                    i = j + 1
                    break
    return names


def csrc_kernels(csrc: str = CSRC) -> Dict[str, str]:
    """{kernel name: its key} of every ``__global__`` function in
    ``csrc/*.cu``."""
    out = {}
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                for name in global_names(fh.read()):
                    out[name] = KERNEL_KEYS.get(name, SOURCE_KEYS[f])
    return out


def annotation(e) -> bool:
    """Whether a profiler event is a host range (``record_function``,
    the port's spans) or its projection onto a stream, which is no device
    work."""
    return bool(getattr(e, "is_user_annotation", False))


def kernel_events(prof):
    """The device-side events of a ``torch.profiler`` run (kernels,
    copies, memsets); a CPU op's own device time repeats its kernels'."""
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not annotation(e)]


def device_averages(prof):
    """``prof.key_averages()``'s device-side rows, the host ranges'
    projections left out."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not annotation(e)]


def group_kernels(events) -> Dict[str, dict]:
    """Device events (``kernel_events``) -> {group: {"us": device µs,
    "calls": kernels, "launches": counted launches of a hand-written
    kernel (the runs of its ``KERNEL_GROUPS`` marker kernel), else
    None}}."""
    groups = {}
    for e in events:
        g = group_of(e.name)
        row = groups.setdefault(g, {"us": 0.0, "calls": 0,
                                    "launches": None})
        row["us"] += e.time_range.elapsed_us()
        row["calls"] += 1
        if g in KERNEL_GROUPS:
            row["launches"] = (row["launches"] or 0) + bool(
                re.search(KERNEL_GROUPS[g][1], e.name))
    return groups


def device_timeline(events) -> dict:
    """The device's timeline from single device events: {"span_us": first
    start to last end, "busy_us": the union of the events' intervals,
    "idle_us": span - busy, "idle_by_group": {group of the event that
    ended a gap: [µs, gaps]}}.  With one stream, the device idles where
    the host has not yet enqueued the next kernel (or waits on a sync)."""
    ev = sorted(events, key=lambda e: e.time_range.start)
    if not ev:
        return {"span_us": 0.0, "busy_us": 0.0, "idle_us": 0.0,
                "idle_by_group": {}}
    busy, end = 0.0, ev[0].time_range.start
    idle = collections.defaultdict(lambda: [0.0, 0])
    for e in ev:
        s, t = e.time_range.start, e.time_range.end
        if s > end:
            row = idle[group_of(e.name)]
            row[0] += s - end
            row[1] += 1
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    span = end - ev[0].time_range.start
    return {"span_us": span, "busy_us": busy, "idle_us": span - busy,
            "idle_by_group": dict(idle)}


def _frame(frame: str, root: str) -> str:
    return frame[frame.index(root):] if root in frame else frame


def launch_sources(prof, root: str = "cvvae_tpu_torch",
                   skip: str = "cvvae_tpu_torch/utils/"
                   ) -> Dict[str, Dict[str, list]]:
    """{group: {source: [device events, device µs]}}: each device event
    booked to the call that launched it -- the innermost frame of ``root``
    (outside ``skip``) on the Python stack of the op above its launch
    (profiles taken ``with_stack=True``), else the outermost op above it
    (a backward node runs without a Python stack)."""
    out = collections.defaultdict(lambda: collections.defaultdict(
        lambda: [0, 0.0]))
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels or annotation(e):
            continue
        node, top, src = e, e, None
        while node is not None and src is None:
            src = next((_frame(f, root) for f in (node.stack or [])
                        if root in f and skip not in f), None)
            top, node = node, node.cpu_parent
        src = src or top.name
        for k in e.kernels:
            row = out[group_of(k.name)][src]
            row[0] += 1
            row[1] += k.duration
    return {g: dict(v) for g, v in out.items()}


def sync(tree) -> float:
    """Wait for every tensor in ``tree`` (a tensor, or dicts, lists and
    tuples of them) and return the sum of all their elements taken in
    fp32, the JAX package's checksum."""
    leaves = []

    def visit(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                visit(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(tree)
    if not leaves:
        return 0.0
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    return float(sum(t.detach().float().sum().cpu() for t in leaves))


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace (CPU, and CUDA where there is a card) of
    the block, written on exit into ``logdir`` as a Chrome trace that
    TensorBoard's profiler plugin reads (``*.pt.trace.json``); yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json"))


class Timer:
    """Accumulating stage timer; ``sync`` waits for the card before the
    clock is read.

        t = Timer()
        with t("encode"):
            z = vae.encode(x).mode()
            t.sync(z)
        print(t.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @staticmethod
    def sync(tree):
        sync(tree)

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24s} {total:8.3f}s  x{n}"
                         f"  ({1000 * total / n:.1f} ms/call)")
        return "\n".join(lines)


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
        out = worker.run("reconstruct", clip)
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


def print_groups(groups: Dict[str, dict], total_us: float,
                 prefix: str = "[profile]") -> None:
    """One line a group of ``group_kernels``, by device time: ms, share of
    the kernel time, kernels, and a hand-written kernel's launches."""
    for name, row in sorted(groups.items(), key=lambda kv: -kv[1]["us"]):
        if row["us"]:
            launches = ("" if row["launches"] is None
                        else f", {row['launches']} launches")
            print(f"{prefix} {name:36s} {row['us'] / 1e3:10.3f} ms "
                  f"{100 * row['us'] / total_us:5.1f}%  {row['calls']} "
                  f"calls{launches}")


def profile_edge_conv(frames: int, dtype: str = "fp32", tf32: bool = False,
                      out=None) -> None:
    """Where the time of one edge-pad conv goes: v1's level-0 causal conv
    (``EDGE_CONV`` with ``frames`` frames, 3x3x3 to 128 channels) by each
    path -- the materialised pad (``_edge_pad`` then ``_window_conv``),
    ``_conv3d_edge_time_fast`` and ``_conv3d_edge_fast`` -- one call each in
    the profiler, with TF32 off unless ``tf32``; prints each path's wall
    time, its kernel time by group and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from cvvae_tpu_torch.ops import conv

    if not torch.cuda.is_available():
        raise SystemExit("profiling: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    shape = (EDGE_CONV[0], frames) + EDGE_CONV[2:]
    c = shape[-1]
    g = torch.Generator(device="cuda").manual_seed(70)
    x = torch.randn(shape, generator=g, device="cuda").to(dt)
    w = (torch.randn((128, c, 3, 3, 3), generator=g, device="cuda")
         * (3 * 27 * c) ** -0.5).to(dt)
    b = (torch.randn((128,), generator=g, device="cuda") * 0.1).to(dt)
    spec = conv.Conv3DSpec.v1_causal()
    zero = [p if m == "zero" else (0, 0) for p, m in zip(spec.pads,
                                                         spec.modes)]
    padded = (frames + 2) * (shape[2] + 2) * (shape[3] + 2) * c
    paths = {
        "materialised": lambda: conv._window_conv(
            conv._edge_pad(x, spec.pads, spec.modes), w, zero, spec.stride,
            b),
        "time_fast": lambda: conv._conv3d_edge_time_fast(x, w, spec, bias=b),
        "edge_fast": lambda: conv._conv3d_edge_fast(x, w, spec, bias=b)}
    print(f"[edge_conv] {shape}->128 {dtype}, TF32 "
          f"{'on' if tf32 else 'off'}: x {x.numel()} elements, the "
          f"materialised pad {padded} (2^31 = {2 ** 31}); card {card()}")
    for name, fn in paths.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del y
        kernels = device_averages(prof)
        total = sum(e.self_device_time_total for e in kernels)
        print(f"[edge_conv] {name}: profiled wall {wall!r} s, kernel time "
              f"{total / 1e6!r} s")
        print_groups(group_kernels(kernel_events(prof)), total,
                     "[edge_conv]")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                        reverse=True)[:8]:
            print(f"[edge_conv]   {e.self_device_time_total / 1e3:12.3f} ms "
                  f"{e.count:5d}x {e.key[:140]}")
        if out:
            with open(out, "a") as f:
                f.write(f"# {name} {shape} {dtype}\n" + prof.key_averages(
                ).table(sort_by="self_device_time_total", row_limit=40))
        torch.cuda.empty_cache()


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
    kernels = device_averages(prof)
    total = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] {label}: unprofiled wall {steady!r} s, "
          f"profiled wall {wall!r} s, kernel time {total / 1e6!r} s "
          f"(busy {100 * total / 1e6 / wall:.1f}%); card {card()}")
    print_groups(group_kernels(kernel_events(prof)), total)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:TOP]:
        print(f"[profile]   {e.self_device_time_total / 1e3:10.2f} ms "
              f"{e.count:5d}x {e.key[:110]}")
    # each kernel is attached to the op that launched it
    by_op = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if annotation(e):
            continue
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
    ap.add_argument("--edge_conv", action="store_true",
                    help="v1's level-0 causal edge conv by path instead "
                         "(fp32 by default, TF32 off)")
    ap.add_argument("--frames", type=int, default=EDGE_CONV[1],
                    help="with --edge_conv: the clip's frames")
    ap.add_argument("--tf32", action="store_true",
                    help="with --edge_conv: let cuDNN take TF32")
    ap.add_argument("--out", default=None,
                    help="also write the profiler's full table here")
    args = ap.parse_args(argv)
    if args.edge_conv:
        if args.dtype == "int8":
            ap.error("--edge_conv runs in bf16 or fp32")
        profile_edge_conv(args.frames, args.dtype or "fp32", args.tf32,
                          args.out)
    elif args.unet_step:
        if args.dtype == "int8":
            ap.error("--unet_step runs in bf16 or fp32")
        profile_unet_step(args.dtype or "bf16", args.out)
    else:
        profile_reconstruct(args.variant, args.dtype or "int8", args.out)


if __name__ == "__main__":
    main()
