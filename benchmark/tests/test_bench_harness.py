"""The benchmark's harness on the CPU: what it imports, its arithmetic, the
files ``BENCHMARK.json`` names, and runs of a tiny cell end to end
(``benchmark/tests/tiny``, a checkout of its own) with and without a
fault planted in the served path.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, harness, readings, traffic, work

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
TINY = os.path.join(HERE, "tiny")
CELLS = ["tiny-v1-int8", "tiny-sd3-bf16"]


def sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Top-level names of the modules a file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_no_port_in_the_reference():
    """No file of the benchmark imports JAX or the JAX package, their
    top-level names compared whole (``cvvae_tpu_torch`` begins with
    ``cvvae_tpu``), and the reference imports nothing of the port."""
    for path in sources(BENCH):
        names = set(imported(path))
        assert not names & set(harness.BANNED), path
    for path in sources(os.path.join(BENCH, "reference")):
        assert "cvvae_tpu_torch" not in set(imported(path)), path


def test_a_run_loads_no_jax():
    """Importing everything a run imports, the port's serving path with
    it, leaves no JAX module loaded."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness as h, benchmark.readings\n"
            "import importlib, pkgutil, benchmark.metrics as m\n"
            "[importlib.import_module('benchmark.metrics.' + i.name)"
            " for i in pkgutil.iter_modules(m.__path__)]\n"
            "import cvvae_tpu_torch.serve, cvvae_tpu_torch.cli\n"
            "import cvvae_tpu_torch.models.video_vae\n"
            "print(h.banned_modules())\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cvvae_tpu_torch_x", sys)
    assert "cvvae_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "cvvae_tpu.ops", sys)
    assert "cvvae_tpu" in harness.banned_modules()


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_work_is_chip_smokes(dtype):
    """The frozen work arithmetic gives chip_smoke.work's bytes and
    operations at the path shapes."""
    sys.path.insert(0, REPO)
    import chip_smoke

    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    for shape, silu, _, _ in chip_smoke.K1_CASES:
        assert work.work("K1", shape, dtype, silu=silu) == \
            chip_smoke.work("K1", shape, tdt, silu=silu)
    for _, x, cout, kernel, stride, pads, _ in chip_smoke.K5_PATH_SHAPES:
        assert work.work("K5", x, dtype, cout=cout, kernel=kernel,
                         stride=stride, pads=pads) == chip_smoke.work(
            "K5", x, tdt, cout=cout, kernel=kernel, stride=stride,
            pads=pads)
        assert work.work("K5.stage", x, dtype, stride=stride, pads=pads) \
            == chip_smoke.work("K5.stage", x, tdt, stride=stride, pads=pads)
        t, _ = chip_smoke.bound("K5", x, tdt, cout=cout, kernel=kernel,
                                stride=stride, pads=pads)
        assert work.bound_s("K5", x, dtype, cout=cout, kernel=kernel,
                            stride=stride, pads=pads) * 1e3 == \
            pytest.approx(t, rel=1e-12)


def test_groups_are_profilings():
    from cvvae_tpu_torch.utils import profiling
    assert work.GROUPS == profiling.GROUPS
    for name in ("int8_gemm_kernel", "gn_apply<bf16>", "void cudnn::x",
                 "sm90_xmma_fprop_implicit_gemm", "replication_pad3d",
                 "elementwise_kernel", "Memcpy HtoD (Pageable -> Device)"):
        assert work.group_of(name) == profiling.group_of(name)


def record(k, t_send, t_done, bodies, status=200):
    body = bodies.header + bytes(bodies.length - len(bodies.header))
    return traffic.Record(k, k % 2, t_send, t_done, status, body)


def test_p90_and_window_rate():
    """p90 interpolates between order statistics; the rate counts the
    frames of every well-formed response over the window's seconds."""
    for n in (1, 2, 9, 10, 37, 101):
        v = list(np.random.default_rng(n).uniform(0.4, 2.0, n))
        assert harness.p90(v) == pytest.approx(np.percentile(v, 90))
    mix = traffic.Mix("/reconstruct", 5, 8, 8, 2, "closed", 2, 1, 1.0)
    bodies = traffic.Bodies(mix, 3, "cpu")
    recs = [record(k, 0.5 * k, 0.5 * k + 1.0, bodies) for k in range(9)]
    recs.append(record(9, 4.5, 5.5, bodies, status=503))
    e2e = harness.end_to_end(recs, 10.0, 3 * 2 ** 30, 42.5, bodies)
    assert e2e["frames_per_s"] == pytest.approx(9 * 5 / 10.0)
    assert e2e["request_p90_s"] == pytest.approx(1.0)
    assert e2e["peak_gib"] == 3.0 and e2e["setup_s"] == 42.5
    assert statistics.quantiles([1, 2, 3, 4], n=10, method="inclusive")[8] \
        == harness.p90([4, 3, 2, 1])


def test_bodies_are_distinct_and_rebuildable():
    mix = traffic.Mix("/reconstruct", 5, 4, 6, 2, "closed", 3, 1, 1.0)
    b = traffic.Bodies(mix, 2 ** 40 + 9, "cpu")
    seen = set()
    for k in range(3 * 5):
        body = b"".join(bytes(p) for p in b.parts(k))
        assert len(body) == b.length
        arr = np.load(__import__("io").BytesIO(body))
        assert np.array_equal(arr, b.clip(k))
        seen.add(body)
    assert len(seen) == 15
    again = traffic.Bodies(mix, 2 ** 40 + 9, "cpu")
    assert np.array_equal(again.clips, b.clips)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("root", [REPO, TINY])
def test_every_file_is_found_by_name(root):
    spec = harness.load_spec(root)
    cells = [w["name"] for w in spec["workloads"]]
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(
            os.path.join(root, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        cell = harness.Cell(spec, w["name"], root)
        assert cell.cfg.family in ("v1", "sd3")
        assert set(check.load_limits(cell.limits_path)) >= set(check.NUMBERS)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in spec["per_layer"]:
        reader = __import__(f"benchmark.metrics.{m['name']}",
                            fromlist=["read"])
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    if root == REPO:
        assert spec["command"][1] == "benchmark/run.py"
        assert spec["paths"] == ["benchmark"]


@pytest.fixture
def tiny_int8(monkeypatch):
    """The port's int8 threshold at the tiny configurations' own."""
    from cvvae_tpu_torch.ops import quant
    cell = harness.Cell(harness.load_spec(TINY), CELLS[0], TINY)
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS",
                        cell.cfg.int8["min_positions"])


def tiny_run(name, trace=False, seed=2 ** 33 + 5):
    cell = harness.Cell(harness.load_spec(TINY), name, TINY)
    return harness.run(cell, seed, 1.5, trace, "cpu",
                       __import__("time").perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name, tiny_int8, capsys):
    """A whole run at a tiny configuration and traffic: a result in the
    contract's shape, correct, the check's lines last on standard
    error."""
    result = tiny_run(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"frames_per_s", "request_p90_s",
                                      "peak_gib", "setup_s"}
    assert result["metrics"]["frames_per_s"]["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    json.dumps(result)
    err = capsys.readouterr().err.strip().splitlines()
    assert [e.split()[2] for e in err[-len(result["check"]):]] == \
        list(result["check"])


def test_rehearsal_traced(tiny_int8):
    result = tiny_run(CELLS[1], trace=True)
    assert result["correct"]
    assert list(result)[-1] == "check"


def test_fault_an_altered_answer_is_caught(tiny_int8, monkeypatch):
    """The timed path broken underneath: the worker's answer altered where
    it is produced (one frame of each response a frame of another), and
    the run comes out not correct."""
    from benchmark import program

    serve = program.serve

    def broken(vae, precision, device):
        server, thread = serve(vae, precision, device)
        decode = server.worker._decode

        def altered(z):
            out = decode(z)
            out[len(out) // 2] = out[0]
            return out

        server.worker._decode = altered
        return server, thread

    monkeypatch.setattr(program, "serve", broken)
    result = tiny_run(CELLS[1])
    assert not result["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, tiny_int8):
    """The control at the tiny size, one precision below the
    configuration's (the reference in int4 for int8, the program's int8
    for bf16), fails the cell's limits on every seed."""
    cell = harness.Cell(harness.load_spec(TINY), name, TINY)
    limits = check.load_limits(cell.limits_path)
    rows = readings.readings(cell, [], [11, 12, 13], 1.0, device="cpu",
                             emit=lambda r: None)
    assert len(rows) == 3
    for r in rows:
        ok, _ = check.judge(r["numbers"], limits, 1, 0, 1)
        assert not ok, r


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "v1-int8-clip720", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_command_fails_with_the_benchmark_alone(tmp_path):
    """In a directory that holds BENCHMARK.json and the benchmark's files
    only, a run fails and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "v1-int8-clip720", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_rehearsal_on_the_card(tiny_int8):
    """The tiny cell on the card: K5 and the rest at tiny shapes, correct
    against the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell(harness.load_spec(TINY), CELLS[0], TINY)
    result = harness.run(cell, 7, 1.5, False, "cuda:0",
                         __import__("time").perf_counter())
    assert result["correct"], result["check"]


class FakeProfile:
    """A profile's events: (name, device type, start us, end us, thread)."""

    def __init__(self, rows):
        from types import SimpleNamespace
        self.rows = [SimpleNamespace(name=n, device_type=d, thread=th,
                                     time_range=SimpleNamespace(start=a,
                                                                end=b))
                     for n, d, a, b, th in rows]

    def events(self):
        return self.rows


def test_trace_reduction():
    """Three requests 1000 us apart: a conv of 300 us in the encode, 150
    us idle, a K1 launch of 500 us in the decode, 50 us idle before the
    next request's conv; the host clock 7 ms off the profile's.  The
    first request is left out; busy, window, groups, ranges and the idle
    gaps' names follow."""
    from torch.autograd import DeviceType

    from benchmark import tracing

    inst = tracing.Instruments(server=None)
    off = 7000            # host us - profile us
    w = 11                # the worker's thread
    rows = [(tracing.ANCHOR, DeviceType.CPU, 0.0, 1.0, 1),
            (tracing.ANCHOR, DeviceType.CPU, 5000.0, 5001.0, 1)]
    inst.anchors = [off * 1000, (5000 + off) * 1000]
    for i in range(3):
        t = 1000.0 * (i + 1)
        for name, a, b in ((tracing.WORKER_ENCODE, t, t + 450),
                           (tracing.VAE_ENCODE, t + 10, t + 440),
                           (tracing.WORKER_DECODE, t + 450, t + 990),
                           (tracing.VAE_DECODE, t + 460, t + 980)):
            inst.spans.append((name, w, int((a + off) * 1000),
                               int((b + off) * 1000)))
        rows += [("cudnn::conv_fprop", DeviceType.CUDA, t + 20, t + 320, 0),
                 ("gn_apply", DeviceType.CUDA, t + 470, t + 970, 0),
                 # a host range's projection onto the stream: no work
                 (tracing.VAE_DECODE, DeviceType.CUDA, t + 460, t + 980, 0)]
        inst.calls[i + 1].append(("K1", (1, 1, 10, 10, 32), "bf16",
                                  {"silu": True}))
    tr = tracing.reduce(FakeProfile(rows), inst, 3.0, 2.7)
    assert tr.requests == 2
    assert tr.window_s == pytest.approx((3970 - 2020) / 1e6)
    assert tr.busy_s == pytest.approx(1600 / 1e6)
    assert tr.groups == pytest.approx({"cuDNN convs": 600e-6,
                                       "K1 GroupNorm+SiLU": 1000e-6})
    assert tr.ranges == pytest.approx({tracing.VAE_ENCODE: 600e-6,
                                       tracing.VAE_DECODE: 1000e-6})
    assert len(tr.calls) == 2
    names = dict(tr.idle_gaps)
    assert names == pytest.approx({tracing.VAE_ENCODE: 2 * 150e-6,
                                   tracing.VAE_DECODE: 50e-6})
    assert sum(names.values()) == pytest.approx(tr.window_s - tr.busy_s)
    from benchmark.metrics import device_idle_pct, decode_ms, worker_idle_pct
    assert device_idle_pct.read(tr) == pytest.approx(
        100 * (1 - 1600 / 1950))
    assert decode_ms.read(tr) == pytest.approx(0.5)
    assert worker_idle_pct.read(tr) == pytest.approx(10.0)
