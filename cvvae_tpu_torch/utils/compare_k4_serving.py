"""Time K4's serving launch (no logsumexp), or with ``--backward`` K4.bwd,
of several checkouts on one card, in turns: one process a checkout, each
importing that checkout's ``cvvae_tpu_torch`` and building its kernels.

    python -m cvvae_tpu_torch.utils.compare_k4_serving \\
        --roots OLD NEW NEW OLD [--shape 5 14400 512] [--reps 20]
    python -m cvvae_tpu_torch.utils.compare_k4_serving --backward \\
        --roots OLD NEW NEW OLD [--reps 20]

Serving: each process times ``flash_attention(q, k, v, scale)`` on seeded
bf16 N(0, 1) inputs under ``torch.no_grad()`` with CUDA events (the median
of ``--reps`` calls after a warm-up) and prints one JSON line.

``--backward``: each process times ``flash_attention_backward`` at
``chip_smoke.K4_BWD_SHAPES`` on ``chip_smoke.k4_bwd_inputs`` (that
checkout's own), in the way ``compare_k1_bwd.py`` reads K1.bwd: CUDA-event
ms (``chip_smoke.time_ms``: what the caller waits, host time included),
the device time of its kernels by launch (``torch.profiler`` over
``--reps`` calls, taken after every other reading; the launches are told
apart by name: ``rowdot``, ``dkv``, ``dq``) and the host time to enqueue
it (wall time of ``--reps`` calls without a synchronise).

The script prints each checkout's readings, their medians, the card's
name and power limit.  Give the checkouts as A B B A so that a drift of
the card's clock falls on both alike.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, statistics, sys, torch
sys.path.insert(0, sys.argv[1])
from cvvae_tpu_torch.ops.kernels import attention
shape, reps = tuple(json.loads(sys.argv[2])), int(sys.argv[3])
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
           for _ in range(3))
scale = shape[-1] ** -0.5
times = []
with torch.no_grad():
    attention.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        attention.flash_attention(q, k, v, scale)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
print(json.dumps({"ms": statistics.median(times),
                  "module": attention.__file__}))
"""

_CHILD_BWD = r"""
import json, sys, time, torch
sys.path.insert(0, sys.argv[1])
from torch.autograd import DeviceType
import chip_smoke
from cvvae_tpu_torch.ops.kernels import attention
reps = int(sys.argv[2])
dev = torch.device("cuda", 0)
LAUNCHES = ("rowdot", "dkv", "dq")


def launch_of(name):
    return next((k for k in LAUNCHES if k in name), "other")


def device_ms(fn):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(LAUNCHES + ("other",), 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[launch_of(e.key)] += e.self_device_time_total / 1e3 / reps
    out["total"] = sum(out.values())
    return out


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def call(shape, rising):
    args = chip_smoke.k4_bwd_inputs(shape, dev, rising)
    return lambda: attention.flash_attention_backward(*args)


# CUDA events and host times of every shape first, the profiles last, so
# that the profiler cannot slow the host's side of the other readings
rows = []
for shape, rising in chip_smoke.K4_BWD_SHAPES:
    fn = call(shape, rising)
    rows.append(dict(shape=list(shape), rising=rising,
                     ms=chip_smoke.time_ms(fn, reps), host_ms=host_ms(fn)))
    del fn
    torch.cuda.empty_cache()
for row in rows:
    row["device_ms"] = device_ms(call(tuple(row["shape"]), row["rising"]))
    print(json.dumps(dict(module=attention.__file__, **row)), flush=True)
    torch.cuda.empty_cache()
"""


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _serving(args, smi) -> int:
    by_root = {}
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, root, json.dumps(args.shape),
             str(args.reps)], capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stdout + out.stderr)
            return 1
        line = json.loads(out.stdout.strip().splitlines()[-1])
        by_root.setdefault(root, []).append(line["ms"])
        print(f"[k4 serving] {root} {tuple(args.shape)}: {line['ms']!r} ms "
              f"({line['module']})", flush=True)
    print(json.dumps({"shape": args.shape, "card": smi, "ms": {
        r: {"runs": v, "median": statistics.median(v)}
        for r, v in by_root.items()}}))
    return 0


def _backward(args, smi) -> int:
    readings = {}  # root -> shape label -> [row, ...]
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", _CHILD_BWD, root,
                              str(args.reps)],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stdout[-4000:] + out.stderr[-4000:])
            return 1
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                label = f"{tuple(row['shape'])}" + (" rising" if row["rising"]
                                                    else "")
                readings.setdefault(root, {}).setdefault(label, []).append(row)
                print(json.dumps(dict(root=root, **row)), flush=True)
    summary = {
        root: {label: dict(
            ms=statistics.median(r["ms"] for r in rows),
            host_ms=statistics.median(r["host_ms"] for r in rows),
            device_ms={part: statistics.median(r["device_ms"][part]
                                               for r in rows)
                       for part in rows[0]["device_ms"]})
            for label, rows in by_label.items()}
        for root, by_label in readings.items()}
    print(json.dumps({"card": smi, "medians": summary}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--shape", nargs=3, type=int, default=[5, 14400, 512])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--backward", action="store_true",
                    help="time K4.bwd at chip_smoke.K4_BWD_SHAPES")
    args = ap.parse_args(argv)
    smi = _smi()
    return (_backward if args.backward else _serving)(args, smi)


if __name__ == "__main__":
    sys.exit(main())
