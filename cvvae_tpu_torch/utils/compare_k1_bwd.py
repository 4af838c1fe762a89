"""Time K1.bwd (the GroupNorm+SiLU backward) of several checkouts on one
card, in turns: one process a checkout, each importing that checkout's
``cvvae_tpu_torch`` and ``chip_smoke.py`` and building its kernels.

    python -m cvvae_tpu_torch.utils.compare_k1_bwd \\
        --roots OLD NEW NEW OLD [--reps 20] [--launches smoke.log] [--steps]

Each process times ``group_norm_silu_backward`` at ``chip_smoke``'s
``K1_BWD_SHAPES`` in fp32 and bf16, and at the level-0 shape without SiLU
(beside it with SiLU, what the SiLU derivative costs), on
``chip_smoke.k1_bwd_inputs`` with K1's statistics.  Each reading is three
numbers of one call: CUDA-event ms (``chip_smoke.time_ms``: what the
caller waits, host time included), the device time of its kernels
(``torch.profiler`` over ``--reps`` calls, taken after every other
reading) and the host time to enqueue it (wall time of ``--reps`` calls
without a synchronise).  Where there is no SiLU,
``native_group_norm_backward`` is read the same way.

``--launches`` names the output of a ``chip_smoke.py`` run: its phase 8
lines list K1.bwd's launches by (B', S, C, SiLU, dtype) for the first G
and D step of each batch kind; each process times those shapes too, and
the script prints each step's sum of launches x ms for each checkout.
``--steps`` then runs each checkout's ``chip_smoke._train_main`` (the
shipped recipe through ``train.main``, fp32 then bf16) once and relays its
per-step lines.

Give the checkouts as A B B A so that a drift of the card's clock falls on
both alike.  Prints one JSON line per process and reading, then the
medians by checkout and the card's name and power limit.  Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

_CHILD = r"""
import json, math, sys, time, torch
sys.path.insert(0, sys.argv[1])
from torch.autograd import DeviceType
import chip_smoke
from cvvae_tpu_torch.ops.kernels import groupnorm
reps, extra = int(sys.argv[2]), json.loads(sys.argv[3])
dev = torch.device("cuda", 0)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def device_ms(fn):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def timed(fn):
    return dict(ms=chip_smoke.time_ms(fn, reps), host_ms=host_ms(fn))


cases = [(w, tuple(s), g, e, si, pf, dt)
         for w, s, g, e, si, pf in chip_smoke.K1_BWD_SHAPES
         for dt in ("float32", "bfloat16")]
w0, s0, g0, e0, _, pf0 = chip_smoke.K1_BWD_SHAPES[0]
cases += [(w0 + " without SiLU", tuple(s0), g0, e0, False, pf0, dt)
          for dt in ("float32", "bfloat16")]
cases += [("step shape", tuple(k[:3]), math.gcd(32, k[2]), 1e-6, k[3], False,
           k[4]) for k in extra]


def calls(case):
    where, shape, groups, eps, silu, per_frame, dtype = case
    x, dy, w, b = chip_smoke.k1_bwd_inputs(shape, dev, getattr(torch, dtype))
    _, mean, inv = groupnorm._launch(x, w, b, groups, eps, silu, per_frame,
                                     True)
    fns = {"kernel": lambda: groupnorm.group_norm_silu_backward(
        dy, x, w, b, mean, inv, silu=silu, per_frame=per_frame)}
    if not silu and where != "step shape":
        fns["library"] = chip_smoke.library_group_norm_backward(
            dy, x, mean, inv, w, groups, per_frame)
    return fns


# CUDA events and host times of every case first, the profiles last, so
# that the profiler cannot slow the host's side of the other readings
rows = []
for case in cases:
    rows.append({k: timed(f) for k, f in calls(case).items()})
    torch.cuda.empty_cache()
for case, row in zip(cases, rows):
    for k, f in calls(case).items():
        row[k]["device_ms"] = device_ms(f)
    where, shape, _, _, silu, _, dtype = case
    print(json.dumps(dict(where=where, shape=list(shape), silu=silu,
                          dtype=dtype, **row)), flush=True)
    torch.cuda.empty_cache()
"""

_STEPS = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev, smi = torch.device("cuda", 0), chip_smoke.nvidia_smi_line()
for compute in ("float32", "bfloat16"):
    chip_smoke._train_main(dev, smi, compute)
"""

#: a phase-8 line of chip_smoke.py with K1.bwd's launches by shape
_STEP_LINE = re.compile(
    r"^\[train\] main (\w+) ([GD]) (\[[^\]]*\]|\([^)]*\)):.*launches, ms: "
    r"(\[.*\]); card")


def step_shapes(log: str) -> dict:
    """{step label: {(B', S, C, SiLU, dtype): launches}} from the phase 8
    lines of a chip_smoke.py output."""
    steps = {}
    for line in log.splitlines():
        m = _STEP_LINE.match(line)
        if m:
            label = f"{m.group(1)} {m.group(2)} {m.group(3)}"
            steps[label] = {tuple(k): n for k, n, _ in json.loads(m.group(4))}
    return steps


def key_of(row) -> tuple:
    return (row["where"], tuple(row["shape"]), row["silu"], row["dtype"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--launches", default=None,
                    help="output of a chip_smoke.py run (phase 8 lines)")
    ap.add_argument("--steps", action="store_true")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    steps = {}
    if args.launches:
        with open(args.launches) as f:
            steps = step_shapes(f.read())
    keys = sorted({k for s in steps.values() for k in s})
    readings = {}  # root -> case key -> [row, ...]
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, root, str(args.reps),
             json.dumps([list(k) for k in keys])],
            capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stdout[-4000:] + out.stderr[-4000:])
            return 1
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                readings.setdefault(root, {}).setdefault(
                    key_of(row), []).append(row)
                print(json.dumps(dict(root=root, **row)), flush=True)

    def median(root, key, part, field):
        rows = readings[root][key]
        if part not in rows[0]:
            return None
        return statistics.median(r[part][field] for r in rows)

    summary = {}
    for root, by_key in readings.items():
        summary[root] = {
            " ".join(map(str, k)): {
                f"{part}_{field}": median(root, k, part, field)
                for part in ("kernel", "library")
                for field in ("ms", "device_ms", "host_ms")}
            for k in by_key if k[0] != "step shape"}
        for label, shapes in steps.items():
            summary[root][f"step {label}: sum of launches x ms"] = sum(
                n * median(root, ("step shape", tuple(k[:3]), k[3], k[4]),
                           "kernel", "ms")
                for k, n in shapes.items())
    print(json.dumps({"card": smi, "medians": summary}), flush=True)
    if args.steps:
        for root in dict.fromkeys(os.path.abspath(r) for r in args.roots):
            out = subprocess.run([sys.executable, "-c", _STEPS, root],
                                 capture_output=True, text=True, cwd=root)
            for line in out.stdout.splitlines():
                if line.startswith("[train] main"):
                    print(f"[{root}] {line}", flush=True)
            if out.returncode:
                print(out.stdout[-4000:] + out.stderr[-4000:])
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
