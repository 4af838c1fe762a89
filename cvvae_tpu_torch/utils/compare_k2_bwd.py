"""Time K2.bwd of several checkouts on one card, in turns: one process a
checkout, each importing that checkout's ``cvvae_tpu_torch`` and building
its kernels.

    python -m cvvae_tpu_torch.utils.compare_k2_bwd \\
        --roots OLD NEW NEW OLD [--reps 20]

Each process times ``subpixel_interleave_backward`` at that checkout's
``chip_smoke.K2_BWD_SHAPES``, in fp32 and bf16, with and without the bias,
on seeded N(0, 1) ``dy``: CUDA-event ms (``chip_smoke.time_ms``: what the
caller waits, host time included), the device time of its kernels by
launch (``torch.profiler`` over ``--reps`` calls, taken after every other
reading; the launches are told apart by name: ``subpixel_unshuffle``, the
copy, and ``bias_grad``, the merge of d(bias)) and the host time to
enqueue it (wall time of ``--reps`` calls without a synchronise).

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

#: the child's head: its checkout first on the path, and the device and
#: host timing of a call; a child defines ``LAUNCHES`` (the names that tell
#: its kernel's launches apart) before it
TIMING = r"""
import json, sys, time, torch
sys.path.insert(0, sys.argv[1])
from torch.autograd import DeviceType
import chip_smoke
reps = int(sys.argv[2])
dev = torch.device("cuda", 0)


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
"""

_CHILD = 'LAUNCHES = ("subpixel_unshuffle", "bias_grad")\n' + TIMING + r"""
from cvvae_tpu_torch.ops.kernels import shuffle


def call(shape, n, dtype, bias):
    b, t, h, w, nc = shape
    dy = chip_smoke.randn((b, n * t - (n > 1), 2 * h, 2 * w, nc // n), 9,
                          dev, dtype)
    return lambda: shuffle.subpixel_interleave_backward(dy, n=n, t=t,
                                                        with_bias=bias)


# CUDA events and host times of every case first, the profiles last, so
# that the profiler cannot slow the host's side of the other readings
rows = []
for shape, n in chip_smoke.K2_BWD_SHAPES:
    for dtype in ("float32", "bfloat16"):
        for bias in (True, False):
            fn = call(shape, n, getattr(torch, dtype), bias)
            rows.append(dict(shape=list(shape), n=n, dtype=dtype, bias=bias,
                             ms=chip_smoke.time_ms(fn, reps),
                             host_ms=host_ms(fn)))
            del fn
            torch.cuda.empty_cache()
for row in rows:
    row["device_ms"] = device_ms(call(tuple(row["shape"]), row["n"],
                                      getattr(torch, row["dtype"]),
                                      row["bias"]))
    print(json.dumps(dict(module=shuffle.__file__, **row)), flush=True)
    torch.cuda.empty_cache()
"""


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def compare(child: str, label, doc: str, argv=None) -> int:
    """Run ``child`` (a program that starts with TIMING and prints one JSON
    row a case) once a checkout of ``--roots``, in the order given, and
    print every row, then the card and each checkout's medians by case
    (``label(row)``)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    smi = _smi()
    readings = {}  # root -> case label -> [row, ...]
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", child, root,
                              str(args.reps)],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stdout[-4000:] + out.stderr[-4000:])
            return 1
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                readings.setdefault(root, {}).setdefault(label(row),
                                                         []).append(row)
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
    return compare(_CHILD, lambda row: (
        f"{tuple(row['shape'])} n={row['n']} {row['dtype']}"
        f"{' bias' if row['bias'] else ''}"), __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
