"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that names, its traffic
in ``benchmark/traffic/<mix>.json``, each per-layer metric's reader in
``benchmark/metrics/<metric>.py`` and the check's limits in
``benchmark/limits/<cell>.json``.

The window: the mix's clients run their closed loop for ``--seconds``,
and the requests in flight when it closes run to their end; the window
lasts from the clients' start to the last response.  ``frames_per_s`` is
the frames of every response over the window's seconds; ``request_p90_s``
the 90th percentile of every request's time from its send to its last
response byte; ``peak_gib`` the card's allocated peak in the window alone;
``setup_s`` the seconds from the process's start to the window's.  With
``--trace 1`` the window is the mix's ``trace_seconds`` under
``torch.profiler`` and the line holds the per-layer metrics.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import random
import statistics
import sys
import time
from typing import Optional

import torch

from benchmark import check, program, tracing, traffic
from benchmark.reference.cvvae import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level modules a run must not have loaded: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "cvvae_tpu")
GIB = 2 ** 30


def log(*args) -> None:
    print("[bench]", *args, file=sys.stderr, flush=True)


def banned_modules() -> list:
    """Top-level names of ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``cvvae_tpu_torch`` is not
    ``cvvae_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Cell:
    """A cell of a benchmark file and everything it names."""

    def __init__(self, spec: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in the benchmark")
        self.spec = spec
        self.name = name
        self.cell = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.cell["config"]]
        with open(os.path.join(root, conf["file"])) as f:
            self.cfg = Config(json.load(f))
        self.mix = traffic.Mix.load(os.path.join(
            root, "benchmark", "traffic", f"{self.cell['traffic']}.json"))
        self.limits_path = os.path.join(root, "benchmark", "limits",
                                        f"{name}.json")

    def metrics(self, kind: str) -> list:
        return [m for m in self.spec[kind]
                if name_in(self.name, m.get("workloads"))]


def name_in(name: str, names) -> bool:
    return names is None or name in names


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


class Session:
    """A cell set up from a seed: weights, bodies, the served model."""

    def __init__(self, cell: Cell, seed: int, device, precision=None):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.precision = precision or cell.cfg.precision
        cfg, mix = cell.cfg, cell.mix
        t = [time.perf_counter()]
        weights = program.make_weights(cfg, seed, self.device,
                                       program.act_dtype(self.precision))
        self.calib = program.calibration_clip(cfg, seed, self.device)
        t.append(time.perf_counter())
        vae = program.build(cfg, weights, mix.height, mix.width, self.calib,
                            self.precision)
        t.append(time.perf_counter())
        #: the reference's copy, on the host while the program runs
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        self.bodies = traffic.Bodies(mix, seed, self.device)
        self.server, self.thread = program.serve(vae, self.precision,
                                                 self.device)
        del vae
        self.port = self.server.server_address[1]
        self.next_k = 0
        t.append(time.perf_counter())
        log(f"set-up: weights {t[1] - t[0]:.3f} s, model "
            f"{t[2] - t[1]:.3f} s, bodies and server {t[3] - t[2]:.3f} s")

    def warm(self, requests: int = 1) -> None:
        """Requests of the mix's shape before any window: every kernel
        built and the allocator warm."""
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=3600)
        try:
            for _ in range(requests):
                status, body = traffic.post(conn, self.cell.mix.endpoint,
                                            self.bodies.parts(self.next_k),
                                            self.bodies.length)
                self.next_k += 1
                if status != 200:
                    raise RuntimeError(f"warm-up request: HTTP {status}: "
                                       f"{body[:300]!r}")
        finally:
            conn.close()

    def window(self, seconds: float, trace: bool = False):
        """The closed loop for ``seconds``; (records, window seconds, peak
        bytes, the trace or None)."""
        cuda = self.device.type == "cuda"
        worker = self.server.worker
        inst = prof = None
        if trace:
            inst = tracing.Instruments(self.server)
            inst.install()
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        busy0 = worker.stats["busy_s"]
        try:
            if trace:
                with tracing.profiled(cuda) as prof:
                    inst.anchor()
                    records, t0 = traffic.closed_loop(
                        self.port, self.cell.mix, self.bodies, seconds,
                        self.next_k, inst.span)
                    inst.anchor()
            else:
                records, t0 = traffic.closed_loop(
                    self.port, self.cell.mix, self.bodies, seconds,
                    self.next_k)
        finally:
            if inst is not None:
                inst.remove()
        t1 = max([r.t_done for r in records] + [t0])
        self.t_window = t0
        busy = worker.stats["busy_s"] - busy0
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        self.next_k += len(records)
        tr = None
        if trace:
            tr = tracing.reduce(prof, inst, t1 - t0, busy)
            if tr is not None:
                tr.cfg, tr.clip = self.cell.cfg, (
                    self.cell.mix.frames, self.cell.mix.height,
                    self.cell.mix.width)
        return records, t1 - t0, peak, tr

    def close(self) -> None:
        """Stop the server and free the program's device memory."""
        program.stop(self.server, self.thread)
        self.server = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def ok(rec: traffic.Record, bodies: traffic.Bodies) -> bool:
    """A well-formed response: HTTP 200 and a .npy of the clip's shape."""
    return (rec.status == 200 and rec.body is not None
            and len(rec.body) == bodies.length
            and rec.body[:len(bodies.header)] == bodies.header)


def p90(values) -> float:
    """The 90th percentile, linear between order statistics."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def end_to_end(records, window_s, peak, setup_s, bodies) -> dict:
    good = [r for r in records if ok(r, bodies)]
    frames = len(good) * bodies.frames
    lat = [r.t_done - r.t_send for r in good]
    return {"frames_per_s": frames / window_s,
            "request_p90_s": p90(lat) if lat else float("nan"),
            "peak_gib": peak / GIB, "setup_s": setup_s}


def sample(records, bodies, seed: int, n: int) -> list:
    """``n`` well-formed responses drawn from the seed."""
    good = [r for r in records if ok(r, bodies)]
    rng = random.Random(traffic.sub_seed(seed, "check"))
    return rng.sample(good, min(n, len(good)))


def reference_outputs(session: Session, ks, bits: Optional[int]) -> dict:
    """The plain reference's frames for requests ``ks`` (the program's
    state freed first), as uint8 (T, H, W, 3) tensors on the card."""
    from benchmark.reference.cvvae import Reference
    ref = Reference(session.cell.cfg, session.weights, session.device, bits)
    if bits is not None:
        ref.calibrate(session.calib)
    out = {}
    for k in ks:
        clip = torch.from_numpy(session.bodies.clip(k))
        out[k] = ref.reconstruct(clip)
    del ref
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run: the result line's object (and the check's lines on
    standard error)."""
    import cvvae_tpu_torch
    if not os.path.abspath(cvvae_tpu_torch.__file__).startswith(ROOT + os.sep):
        raise SystemExit(f"the port {cvvae_tpu_torch.__file__} is not this "
                         f"checkout's ({ROOT})")
    log(f"{cell.name} seed {seed}: imports {time.perf_counter() - t_start:.3f} s")
    s = Session(cell, seed, device)
    t0 = time.perf_counter()
    s.warm()
    log(f"warm-up request {time.perf_counter() - t0:.3f} s")
    length = min(seconds, cell.mix.trace_seconds) if trace else seconds
    records, window_s, peak, tr = s.window(length, trace)
    setup_s = s.t_window - t_start
    log(f"window {window_s:.3f} s, {len(records)} requests, setup "
        f"{setup_s:.3f} s, peak {peak / GIB:.3f} GiB")
    if trace:
        log("trace: nothing to read" if tr is None else
            f"trace: {tr.requests} requests read, device window "
            f"{tr.window_s:.6f} s, busy {tr.busy_s:.6f} s, "
            f"{len(tr.calls)} kernel calls recorded")
    good = [r for r in records if ok(r, s.bodies)]
    attempted, failed = len(records), len(records) - len(good)
    for r in records:
        if not ok(r, s.bodies):
            log(f"request {r.k}: HTTP {r.status} {r.error} "
                f"{(r.body or b'')[:200]!r}")
    picked = sample(records, s.bodies, seed, cell.mix.checked)
    s.close()
    t0 = time.perf_counter()
    bits = 8 if cell.cfg.precision == "int8" else None
    refs = reference_outputs(s, [r.k for r in picked], bits)
    numbers = check.compare([(check.served(r.body, s.device), refs[r.k])
                             for r in picked])
    log(f"reference {time.perf_counter() - t0:.3f} s for "
        f"{len(picked)} responses")
    limits = check.load_limits(cell.limits_path)
    correct, judged = check.judge(numbers, limits, attempted, failed,
                                  len(picked))
    for line in check.lines(judged):
        log(line)
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        result["metrics"] = per_layer(cell, tr)
    else:
        e2e = end_to_end(records, window_s, peak, setup_s, s.bodies)
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.metrics("end_to_end")}
    dev = {"platform": "gpu" if s.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(s.device)
                    if s.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {
            "device_ops": [[g, v] for g, v in sorted(
                tr.groups.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": tr.idle_gaps}
    result["device"] = dev
    result["check"] = judged
    return result


def per_layer(cell: Cell, tr) -> dict:
    """Each per-layer metric's reader on the trace; a reader that finds
    nothing leaves its metric out."""
    out = {}
    for m in cell.metrics("per_layer"):
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        value = reader.read(tr) if tr is not None else None
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    cell = Cell(load_spec(), args.workload)
    chips = cell.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                 t_start)
    found = banned_modules()
    if found:
        log(f"the run loaded {found}: the benchmark drives the port alone")
        return 3
    print(json.dumps(result), flush=True)
    return 0
