"""Time K4's serving launch (no logsumexp) of several checkouts on one
card, in turns: one process a checkout, each importing that checkout's
``cvvae_tpu_torch`` and building its kernels.

    python -m cvvae_tpu_torch.utils.compare_k4_serving \\
        --roots OLD NEW NEW OLD [--shape 5 14400 512] [--reps 20]

Each process times ``flash_attention(q, k, v, scale)`` on seeded bf16
N(0, 1) inputs under ``torch.no_grad()`` with CUDA events (the median of
``--reps`` calls after a warm-up) and prints one JSON line; the script
prints each checkout's readings, their median, the card's name and power
limit.  Give the checkouts as A B B A so that a drift of the card's clock
falls on both alike.  Needs a CUDA card and nvcc.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--shape", nargs=3, type=int, default=[5, 14400, 512])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
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


if __name__ == "__main__":
    sys.exit(main())
