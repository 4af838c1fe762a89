"""The readings a cell's check limits are set from, on the card, in one
process: sound runs of the program on many seeds, and the control on a
few.

    python3 -m benchmark.readings --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds 6] [--out FILE]

Each seed is set up as a run sets it up, serves a short window of the
cell's own traffic, and has the same sample of its responses compared
with the plain reference as a run compares it.  The control is the step
one precision below the configuration's: for an int8 configuration the
reference itself in int4 in the program's place, for a bf16 one the
program with its own int8 path on.  Prints one JSON line a reading and a
summary: the largest reading of the sound runs and the smallest of the
control, a number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, harness


def program_reading(cell, seed, seconds, precision=None, device="cuda:0"):
    """({request: served frames} of the run's sample, the closed session,
    the window's seconds, its requests) of one short window of the
    program."""
    s = harness.Session(cell, seed, device, precision)
    s.warm()
    records, window_s, _, _ = s.window(seconds)
    picked = harness.sample(records, s.bodies, seed, cell.mix.checked)
    got = {r.k: check.served(r.body, s.device) for r in picked}
    s.close()
    return got, s, window_s, len(records)


def readings(cell, seeds, control_seeds, seconds, device="cuda:0",
             emit=print):
    """Each seed's reading of the program, and the control's on
    ``control_seeds``, passed to ``emit`` as dicts; returns them."""
    int8 = cell.cfg.precision == "int8"
    rows = []
    for seed in dict.fromkeys(list(seeds) + list(control_seeds)):
        t0 = time.perf_counter()
        got, s, window_s, n = program_reading(cell, seed, seconds,
                                              device=device)
        ks = sorted(got)
        refs = harness.reference_outputs(s, ks, 8 if int8 else None)
        if seed in seeds:
            rows.append({"workload": cell.name, "seed": seed,
                         "kind": "program", "requests": n,
                         "window_s": window_s,
                         "numbers": check.compare([(got[k], refs[k])
                                                   for k in ks]),
                         "seconds": time.perf_counter() - t0})
            emit(rows[-1])
        if seed in control_seeds:
            t0 = time.perf_counter()
            if int8:
                ctl = harness.reference_outputs(s, ks, 4)
                kind = "control: the reference in int4"
            else:
                ctl, c, _, _ = program_reading(cell, seed, seconds, "int8",
                                               device)
                if sorted(ctl) != ks:   # the int8 window sampled others
                    ks = sorted(ctl)
                    refs = harness.reference_outputs(c, ks, None)
                kind = "control: the program in int8"
            rows.append({"workload": cell.name, "seed": seed, "kind": kind,
                         "numbers": check.compare([(ctl[k], refs[k])
                                                   for k in ks]),
                         "seconds": time.perf_counter() - t0})
            emit(rows[-1])
        del got, refs, s
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows


def summary(name, rows) -> dict:
    """The largest reading of the sound runs and the smallest of the
    control, a number."""
    out = {"workload": name, "summary": True}
    for n in check.NUMBERS:
        prog = [r["numbers"][n] for r in rows if r["kind"] == "program"]
        ctl = [r["numbers"][n] for r in rows if r["kind"] != "program"]
        out[n] = {"program_max": max(prog) if prog else None,
                  "control_min": min(ctl) if ctl else None}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("readings: needs the card")
    cell = harness.Cell(harness.load_spec(), args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    rows = readings(cell, args.seeds, args.control_seeds, args.seconds,
                    emit=emit)
    emit(summary(cell.name, rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
