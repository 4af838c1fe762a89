"""Profile real training steps at the shipped scale on the card.

Port of ``tools/profile_train_step.py``.  Shipped recipe
(configs/cvvae_sd3_constraint_training.yaml:92-180): SD3 VAE
(128,256,512,512), latent constraint, GAN (+ LPIPS with
``--perceptual``), per-rank batches of 8 images at 320px and 1x17-frame
video at 256px (the multiplexer feeds one batch type per step).  For each
batch kind, from a fresh state: the first G and the first D step's wall
time, a memory report (in use, peak and limit), the best of ``--iters``
steady G+D pairs as steps/s, and an optional trace.  The weights are
seeded random; LPIPS too (timing only).

Beyond the JAX tool: one G and one D step in ``torch.profiler`` after the
steady pairs, each with its device time by kernel group
(``profiling.GROUPS``), the busy share of its wall, the hand-written
kernels' launches (from the profile, and from their launch counters over
the same step), the device's idle time booked to the kernel group that
ended each gap, and the calls that launched the most device events
(their Python source line); the host's time to issue each steady step beside its
synchronised wall; and with ``--memory_snapshot FILE`` a
``torch.cuda.memory`` history of one G step of the first batch kind,
pickled to FILE, whose peak is booked by net (``memory_by_net``).  The
body is ``profile_steps(cfg, batches)``, so a caller can profile any
``EngineConfig`` (v1: ``chip_smoke.v1_engine_config()``).

fp32 convs take torch's default, TF32 on cuDNN, unless ``--no_tf32``.
The JAX tool's ``donate_state=True`` has no torch counterpart: the port's
step updates its state in place.  The persistent XLA compilation cache
has none either.

    python -m cvvae_tpu_torch.utils.profile_train_step [--remat/--no-remat]
        [--perceptual] [--image_bs 8] [--image_size 320]
        [--video_frames 17] [--video_size 256]
        [--compute float32|bfloat16] [--iters 3] [--trace DIR]
        [--memory_snapshot FILE] [--no_tf32] [--device cuda|cpu]

Runs on the card unless ``--device cpu``; refuses to run when asked for
``cuda`` without one.
"""

from __future__ import annotations

import argparse
import collections
import pickle
import time
from typing import Callable, Dict, Optional

import torch

from cvvae_tpu_torch.utils import profiling

GIB = 2 ** 30


def engine_config(remat: bool = True, perceptual: bool = False,
                  compute: str = "float32"):
    """The JAX tool's EngineConfig (``tools/profile_train_step.py``)."""
    from cvvae_tpu_torch.losses.vae_loss import LossConfig
    from cvvae_tpu_torch.training.engine import EngineConfig
    from cvvae_tpu_torch.training.optim import OptimConfig

    return EngineConfig(
        family="sd3", constraint="latent",
        loss=LossConfig(perceptual_weight=0.5 if perceptual else 0.0,
                        disc_start=0),
        optim=OptimConfig(), remat=remat, compute_dtype=compute)


def make_batches(image_bs: int = 8, image_size: int = 320,
                 video_frames: int = 17, video_size: int = 256,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """{name: frames}: N(0, 1) * 0.3 images (bs, 1, size, size, 3) and a
    clip (1, frames, size, size, 3), drawn from seeds 1 and 2."""
    def draw(shape, seed):
        g = torch.Generator().manual_seed(seed)
        return (torch.randn(shape, generator=g) * 0.3).to(device)

    return {
        f"image_bs{image_bs}_{image_size}px": draw(
            (image_bs, 1, image_size, image_size, 3), 1),
        f"video_1x{video_frames}f_{video_size}px": draw(
            (1, video_frames, video_size, video_size, 3), 2)}


def memory_report(device) -> dict:
    """In use, peak (since the last reset) and limit in GiB, from
    ``torch.cuda.memory_stats`` and ``mem_get_info``; {} on the CPU."""
    if torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"in_use_gib": stats["allocated_bytes.all.current"] / GIB,
            "peak_gib": stats["allocated_bytes.all.peak"] / GIB,
            "reserved_peak_gib": stats["reserved_bytes.all.peak"] / GIB,
            "limit_gib": torch.cuda.mem_get_info(device)[1] / GIB}


def _step(engine, st, batch, gen):
    """One step: (state, host s to issue it, synchronised wall s)."""
    t0 = time.perf_counter()
    st, m = engine.train_step(st, batch, gen)
    host = time.perf_counter() - t0
    profiling.sync(m)
    return st, host, time.perf_counter() - t0


def profile_step(engine, st, batch, gen, counts: Callable[[], dict],
                 stacks: bool = True):
    """One step in ``torch.profiler``: (state, {"wall_s", "host_s",
    "kernel_s", "busy", "groups", "timeline", "top": the ten kernels with
    the most device time, "sources": the calls that
    launched the device events (``profiling.launch_sources``; with
    ``stacks``, their Python source lines), "counts":
    the launch counters' change over the step, "kernels": the device
    events' names})."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = counts()
    # the Python stacks reach the events only with a verbose config
    verbose = {}
    if stacks and hasattr(torch._C._profiler, "_ExperimentalConfig"):
        verbose["experimental_config"] = \
            torch._C._profiler._ExperimentalConfig(verbose=True)
    with profile(activities=acts, with_stack=stacks, **verbose) as prof:
        st, host, wall = _step(engine, st, batch, gen)
    after = counts()
    events = profiling.kernel_events(prof)
    kernel_us = sum(e.time_range.elapsed_us() for e in events)
    return st, {
        "wall_s": wall, "host_s": host, "kernel_s": kernel_us / 1e6,
        "busy": kernel_us / 1e6 / wall,
        "groups": profiling.group_kernels(events),
        "timeline": profiling.device_timeline(events),
        "sources": profiling.launch_sources(prof),
        "top": [(e.key, e.self_device_time_total, e.count) for e in sorted(
            (e for e in prof.key_averages()
             if e.device_type == profiling.DeviceType.CUDA),
            key=lambda e: -e.self_device_time_total)[:10]],
        "counts": {k: after[k] - before[k] for k in after},
        "kernels": sorted({e.name for e in events})}


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


#: the port's files whose frames name the net an allocation belongs to
#: (the innermost such frame wins)
NET_FILES = [("models/vae_sd3.py", "VAE"), ("models/vae_v1.py", "VAE"),
             ("models/vae2d.py", "2D constraint net"),
             ("models/lpips.py", "LPIPS"),
             ("models/discriminator.py", "discriminator"),
             ("training/optim.py", "optimizer update"),
             ("losses/", "losses")]


def _net_of(frames) -> str:
    for f in frames:
        name = f.get("filename", "").replace("\\", "/")
        for part, net in NET_FILES:
            if part in name:
                return net
    return "backward (gradients, autograd temporaries)"


def memory_by_net(engine, st, batch, gen, path: Optional[str] = None
                  ) -> dict:
    """One step (of the kind ``st.step`` gives) under
    ``torch.cuda.memory._record_memory_history``: {"resident": bytes held
    before the step by net (parameters and buffers) and the optimizer
    state and EMA, "at_peak": the step's own allocations still live at its
    peak, booked by the innermost frame of the port's nets
    (``NET_FILES``), "peak": the allocator's peak}; the snapshot is
    pickled to ``path`` where given."""
    frozen = {"LPIPS": engine.frozen.get("lpips"),
              "2D constraint decoder": engine.frozen.get(
                  "constraint_decoder"),
              "2D constraint encoder": engine.frozen.get(
                  "constraint_encoder")}
    resident = {"VAE": _bytes(list(st.params.parameters())
                              + list(st.params.buffers())),
                "discriminator": _bytes(list(st.disc_params.parameters())
                                        + list(st.disc_params.buffers()))}
    for name, net in frozen.items():
        if net is not None:
            resident[name] = _bytes(list(net.parameters())
                                    + list(net.buffers()))
    resident["optimizer state"] = _bytes(
        list(st.opt_g.mu.values()) + list(st.opt_g.nu.values())
        + list(st.opt_d.mu.values()) + list(st.opt_d.nu.values()))
    if st.ema is not None:
        resident["EMA"] = _bytes(st.ema.shadow.values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=4_000_000,
                                             stacks="python")
    try:
        st, _, _ = _step(engine, st, batch, gen)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    if path:
        with open(path, "wb") as f:
            pickle.dump(snap, f)
    trace = snap["device_traces"][torch.cuda.current_device()]
    live, total, top, at_peak = {}, 0, 0, {}
    for e in trace:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            total += e["size"]
            if total > top:
                top, at_peak = total, dict(live)
        elif e["action"] == "free_completed" and e["addr"] in live:
            total -= live.pop(e["addr"])["size"]
    booked = collections.Counter()
    for e in at_peak.values():
        booked[_net_of(e.get("frames", []))] += e["size"]
    return st, {"resident": resident, "resident_total": base,
                "at_peak": dict(booked), "step_peak": top, "peak": peak,
                "trace_entries": len(trace)}


def profile_steps(cfg, batches: Dict[str, torch.Tensor], *, iters: int = 3,
                  trace: Optional[str] = None,
                  allow_random_lpips: bool = False, device="cuda",
                  seed: int = 0,
                  counts: Callable[[], dict] = profiling.launch_counts,
                  memory_snapshot: Optional[str] = None,
                  stacks: bool = True,
                  log: Callable[[str], None] = print) -> dict:
    """The tool's procedure for ``cfg`` (an ``EngineConfig``) on
    ``batches`` ({name: (B, T, H, W, 3) frames on ``device``}); returns
    {name: results} and prints the JAX tool's lines, then the profiled
    steps'.  ``counts`` reads the launch counters (the caller's own may
    be given); ``stacks`` records the Python stacks of the profiled steps
    (slower) to name the source lines behind their launches."""
    from cvvae_tpu_torch.training.engine import TrainingEngine

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device; pass "
                         "--device cpu to run on the CPU")
    on_card = device.type == "cuda"
    if on_card:
        from cvvae_tpu_torch.ops.kernels import _build
        _build.library()                 # the kernels' build is not a step
    engine = TrainingEngine(cfg, seed=seed,
                            allow_random_lpips=allow_random_lpips,
                            device=device)
    card = profiling.card() if on_card else "cpu"
    log(f"# {cfg.family} {cfg.compute_dtype}, remat {cfg.remat}, "
        f"perceptual {cfg.loss.perceptual_weight}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}; card {card}")
    results, snapshot_due = {}, bool(memory_snapshot)
    for name, frames in batches.items():
        batch = {"frames": frames}
        r = results[name] = {}
        # a fresh state per batch kind, as the JAX tool's
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        st = engine.init_state(seed)
        gen = torch.Generator(device=device).manual_seed(3)
        st, _, r["g_first_s"] = _step(engine, st, batch, gen)
        log(f"{name}: G first step {r['g_first_s']:.3f} s")
        st, _, r["d_first_s"] = _step(engine, st, batch, gen)
        log(f"{name}: D first step {r['d_first_s']:.3f} s")
        r["memory"] = memory_report(device)
        if r["memory"]:
            m = r["memory"]
            log(f"  [{name}] memory in use {m['in_use_gib']:.2f} GiB, "
                f"peak {m['peak_gib']:.2f} GiB, limit "
                f"{m['limit_gib']:.2f} GiB")
        pairs = []
        for _ in range(iters):
            st, g_host, g = _step(engine, st, batch, gen)
            st, d_host, d = _step(engine, st, batch, gen)
            pairs.append((g + d, g, d, g_host, d_host))
        if pairs:
            best = min(pairs)
            r.update(pair_s=best[0], steps_per_s=2 / best[0], g_s=best[1],
                     d_s=best[2], g_host_s=best[3], d_host_s=best[4],
                     pairs=pairs)
            log(f"{name}: steady G+D pair {best[0] * 1000:.0f} ms "
                f"-> {2 / best[0]:.2f} steps/s (G {best[1]!r} s, host "
                f"{best[3]!r} s to issue it; D {best[2]!r} s, host "
                f"{best[4]!r} s); G s of the {len(pairs)} pairs "
                f"{[p[1] for p in pairs]}, D s {[p[2] for p in pairs]}")
        for kind in ("G", "D"):
            st, p = profile_step(engine, st, batch, gen, counts, stacks)
            r[kind] = p
            _log_profile(log, f"{name} {kind}", p, card)
        if snapshot_due:
            snapshot_due = False
            st, mem = memory_by_net(engine, st, batch, gen, memory_snapshot)
            r["memory_by_net"] = mem
            _log_memory(log, name, mem)
        if trace:
            with profiling.trace(trace):
                st, _, _ = _step(engine, st, batch, gen)
            log(f"  trace written to {trace}")
        del st
    return results


def _log_profile(log, label, p, card):
    t = p["timeline"]
    log(f"[train_profile] {label} step: wall {p['wall_s']!r} s (profiled), "
        f"host {p['host_s']!r} s to issue it, kernel time "
        f"{p['kernel_s']!r} s, busy {100 * p['busy']:.1f}%, device idle "
        f"{t['idle_us'] / 1e3:.3f} ms of a {t['span_us'] / 1e3:.3f} ms "
        f"span; card {card}")
    total = p["kernel_s"] * 1e6 or 1.0
    profiling.print_groups(p["groups"], total, f"[train_profile] {label} ")
    for name, us, n in p["top"][:6]:
        log(f"[train_profile] {label} top kernel {us / 1e3:.3f} ms {n}x "
            f"{profiling.group_of(name)}: {name[:120]}")
    for g, (us, n) in sorted(t["idle_by_group"].items(),
                             key=lambda kv: -kv[1][0])[:8]:
        log(f"[train_profile] {label} idle before {g}: {us / 1e3:.3f} ms "
            f"in {n} gaps")
    top = sorted(((g, src, n, us) for g, rows in p["sources"].items()
                  for src, (n, us) in rows.items()), key=lambda r: -r[2])
    for g, src, n, us in top[:12]:
        log(f"[train_profile] {label} launched by {src}: {n} {g} "
            f"({us / 1e3:.3f} device ms)")
    for g, rows in sorted(p["sources"].items(),
                          key=lambda kv: -p["groups"].get(
                              kv[0], {"us": 0})["us"]):
        for src, (n, us) in sorted(rows.items(),
                                   key=lambda kv: -kv[1][1])[:2]:
            log(f"[train_profile] {label} {g} by device time: {src}: "
                f"{us / 1e3:.3f} ms in {n}")
    hand = {profiling.key_of(g): row["launches"]
            for g, row in p["groups"].items() if profiling.key_of(g)}
    log(f"[train_profile] {label} launches: profile {hand}, counters "
        f"{ {k: v for k, v in p['counts'].items() if v} }")


def _log_memory(log, name, mem):
    log(f"[train_memory] {name}: resident before the step "
        f"{mem['resident_total'] / GIB:.3f} GiB: " + ", ".join(
            f"{k} {v / GIB:.3f}" for k, v in mem["resident"].items()))
    log(f"[train_memory] {name}: the step's own allocations at its peak "
        f"{mem['step_peak'] / GIB:.3f} GiB: " + ", ".join(
            f"{k} {v / GIB:.3f}" for k, v in sorted(
                mem["at_peak"].items(), key=lambda kv: -kv[1]))
        + f"; allocator peak {mem['peak'] / GIB:.3f} GiB "
          f"({mem['trace_entries']} trace entries)")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--perceptual", action="store_true",
                    help="include LPIPS (random-init; timing only)")
    ap.add_argument("--image_bs", type=int, default=8)
    ap.add_argument("--image_size", type=int, default=320)
    ap.add_argument("--video_frames", type=int, default=17)
    ap.add_argument("--video_size", type=int, default=256)
    ap.add_argument("--compute", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--memory_snapshot", default=None,
                    help="record one G step's allocations (first batch "
                         "kind), pickle the snapshot here and book its "
                         "peak by net")
    ap.add_argument("--no_tf32", action="store_true",
                    help="cuDNN convs in full fp32 (TF32 off), as "
                         "chip_smoke.py runs its checks; by default "
                         "torch's own (TF32 convs)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device; pass "
                         "--device cpu to run on the CPU")
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = engine_config(args.remat, args.perceptual, args.compute)
    batches = make_batches(args.image_bs, args.image_size,
                           args.video_frames, args.video_size, args.device)
    return profile_steps(cfg, batches, iters=args.iters, trace=args.trace,
                         allow_random_lpips=args.perceptual,
                         device=args.device,
                         memory_snapshot=args.memory_snapshot)


if __name__ == "__main__":
    main()
