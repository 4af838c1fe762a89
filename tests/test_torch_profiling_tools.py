"""The port's profiling helpers (``cvvae_tpu_torch/utils/profiling.py``):
the kernel groups against the ``__global__`` kernels of ``csrc/``, the
launch markers, the device timeline, and ``Timer``, ``trace`` and
``sync`` against the JAX package's (``cvvae_tpu/utils/profiling.py``), on
the CPU.

Tolerances: ``Timer.report`` is compared as text (equal); ``sync``'s
checksum is an fp32 sum taken in another order than XLA's: |d| <= 1e-6 *
sum |x|.
"""

import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cvvae_tpu.utils import profiling as jprof

from cvvae_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cvvae_tpu_torch", "csrc")

#: each source's kernel, by file; conv_int8.cu's staging pass is K5.stage
EXPECTED = {"groupnorm.cu": "K1", "groupnorm_bwd.cu": "K1.bwd",
            "shuffle.cu": "K2", "shuffle_bwd.cu": "K2.bwd",
            "stem.cu": "K3", "stem_bwd.cu": "K3.bwd",
            "attention.cu": "K4", "attention_bwd.cu": "K4.bwd",
            "conv_int8.cu": "K5", "qflow.cu": "K6"}


def csrc_globals():
    """[(source, kernel name)] of every ``__global__`` in csrc/*.cu."""
    out = []
    for f in sorted(os.listdir(CSRC)):
        if f.endswith(".cu"):
            with open(os.path.join(CSRC, f)) as fh:
                text = fh.read()
            names = profiling.global_names(text)
            code = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
            assert len(names) == len(re.findall(r"__global__", code)), f
            out += [(f, n) for n in names]
    return out


GLOBALS = csrc_globals()


#: kernels whose key is not their source's: K5's staging pass, K1's
#: kernels of its split across ranks (an entry's kernel and the second
#: launch of its two-launch form) and the four of its int8 mode, K6's
#: requantization
OWN_KEYS = {"int8_stage": "K5.stage", "gn_partial": "K1.partial",
            "gn_partial_fold": "K1.partial", "gn_combine": "K1.combine",
            "gn_combine_coef": "K1.combine", "gnq_stats": "K1.int8",
            "gnq_merge": "K1.int8", "gnq_apply": "K1.int8",
            "gnq_apply_arith": "K1.int8", "qflow_requant": "K6.requant"}


def test_csrc_holds_the_known_kernels():
    assert len(GLOBALS) == 29
    assert {f for f, _ in GLOBALS} == set(EXPECTED)
    assert profiling.csrc_kernels() == {
        n: OWN_KEYS.get(n, EXPECTED[f]) for f, n in GLOBALS}


def name_forms(name):
    """The forms the profiler gives a kernel's name: bare, a template
    instance in the anonymous namespace with its arguments, a plain
    function with its arguments."""
    return [name,
            f"void (anonymous namespace)::{name}<float, 4, true>(float "
            f"const*, (anonymous namespace)::Phases, float*, long, int)",
            f"{name}(__nv_bfloat16 const*, __nv_bfloat16 const*, float*, "
            f"long, int)"]


@pytest.mark.parametrize("source,name", GLOBALS,
                         ids=[n for _, n in GLOBALS])
def test_every_csrc_kernel_falls_in_its_own_group(source, name):
    want = OWN_KEYS.get(name, EXPECTED[source])
    for form in name_forms(name):
        group = profiling.group_of(form)
        assert profiling.key_of(group) == want, (form, group)
        if source.endswith("_bwd.cu"):
            assert group.split()[0].endswith(".bwd"), group
        assert group != "elementwise"


def test_pytorch_kernels_stay_out_of_the_kernel_groups():
    for kernel in ["void at::native::vectorized_elementwise_kernel<4, "
                   "at::native::CUDAFunctor_add<float>>",
                   "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_"
                   "nhwckrsc_nhwc",
                   "void at::native::reduce_kernel<512, 1>",
                   "Memcpy HtoD (Pageable -> Device)"]:
        assert profiling.key_of(profiling.group_of(kernel)) is None, kernel


@pytest.mark.parametrize("kernel", [
    "void wgrad_alg1_nd_float_engine<float, float, 3, 0, 5, 7, 4, 3, 5, "
    "false, true>(int, int, int, float const*, int, float*)",
    "void convolveNd_dgrad_float_engine<float, 3, 512, 6, 5, 3, 3, 3, "
    "false>(int, int, int, float const*, int, float const*)",
    "void cudnn::cnn::conv2d_grouped_direct_kernel_int64<long, float>"])
def test_cudnn_fp32_engines_are_convs(kernel):
    """The fp32 (TF32 off) engines of cuDNN's training convs."""
    assert profiling.group_of(kernel) == "cuDNN convs"


def test_each_launch_marker_names_its_groups_kernel():
    """A marker names one kernel of its group (K3's, the bf16 or the fp32
    one; K6's, the sliced or the general add: a launch runs one of the
    two)."""
    names = [n for _, n in GLOBALS]
    for group, (key, marker) in profiling.KERNEL_GROUPS.items():
        hits = [n for n in names if re.search(marker, n)]
        assert len(hits) == (2 if key in ("K3", "K6") else 1), (group, hits)
        assert {profiling.group_of(n) for n in hits} == {group}
        assert key in profiling.COUNTERS


def _ev(name, start, end):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def test_groups_count_launches_and_the_timeline_books_idle():
    """One K1 launch is three kernels, one K4.bwd launch three; the idle
    gaps are booked to the group of the kernel that ends them."""
    ev = [_ev("gn_stats<float, 4, 2>", 0, 10), _ev("gn_merge<float>", 10, 12),
          _ev("gn_apply<float, 4, true>", 20, 30),
          _ev("rowdot(bf16 const*)", 30, 31),
          _ev("flash_bwd_dkv<128, 4>", 35, 60),
          _ev("flash_bwd_dq<128>", 60, 70),
          _ev("void at::native::vectorized_elementwise_kernel<4>", 65, 80)]
    g = profiling.group_kernels(ev)
    assert g["K1 GroupNorm+SiLU"] == {"us": 22, "calls": 3, "launches": 1}
    assert g["K4.bwd flash attention backward"] == {"us": 36, "calls": 3,
                                                    "launches": 1}
    assert g["elementwise"]["launches"] is None
    t = profiling.device_timeline(ev)
    assert t["span_us"] == 80 and t["busy_us"] == 68 and t["idle_us"] == 12
    assert t["idle_by_group"] == {"K1 GroupNorm+SiLU": [8, 1],
                                  "K4.bwd flash attention backward": [4, 1]}


def _cpu_ev(name, kernels=(), stack=(), parent=None):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CPU, stack=list(stack),
        cpu_parent=parent, kernels=[types.SimpleNamespace(name=k, duration=d)
                                    for k, d in kernels])


def test_launch_sources_book_each_kernel_to_its_call():
    """A launch is booked to the innermost frame of the port on its op's
    stack (the profiling tools' own frames skipped), else to the
    outermost op above it (a backward node)."""
    op = _cpu_ev("aten::add", stack=[
        "/x/cvvae_tpu_torch/utils/profile_train_step.py(99): _step",
        "/x/torch/nn/functional.py(5): pad",
        "/x/cvvae_tpu_torch/ops/conv.py(210): _window_conv",
        "/x/cvvae_tpu_torch/training/engine.py(300): _g_loss"])
    node = _cpu_ev("autograd::engine::evaluate_function: AddBackward0")
    inner = _cpu_ev("aten::mul", parent=node)
    ev = [_cpu_ev("cudaLaunchKernel", [("vectorized_elementwise_kernel", 3.0)],
                  parent=op),
          _cpu_ev("cudaLaunchKernel", [("vectorized_elementwise_kernel", 2.0)],
                  parent=op),
          _cpu_ev("cudaLaunchKernel", [("gn_bwd<4, true>", 5.0)],
                  parent=inner), op, node, inner]
    got = profiling.launch_sources(types.SimpleNamespace(events=lambda: ev))
    assert got == {
        "elementwise": {"cvvae_tpu_torch/ops/conv.py(210): _window_conv":
                        [2, 5.0]},
        "K1.bwd GroupNorm+SiLU backward": {
            "autograd::engine::evaluate_function: AddBackward0": [1, 5.0]}}


def test_launch_counts_read_every_counter():
    counts = profiling.launch_counts()
    assert set(counts) == set(profiling.COUNTERS)
    assert all(isinstance(v, int) for v in counts.values())


def test_timer_report_equals_jax(monkeypatch):
    """The same fed durations give the same report, line for line."""
    def fed():
        ticks = iter([0.0, 0.25, 1.0, 1.125, 2.0, 2.5, 3.0, 3.0625,
                      4.0, 6.0])
        return lambda: next(ticks)

    reports = []
    for timer in (profiling.Timer(), jprof.Timer()):
        monkeypatch.setattr(time, "perf_counter", fed())
        for name in ("encode", "decode", "encode", "decode", "stream"):
            with timer(name):
                pass
        reports.append(timer.report())
    assert reports[0] == reports[1]
    assert reports[0].splitlines()[0].startswith("stream")


def test_sync_gives_jax_checksum():
    rs = np.random.RandomState(0)
    arrays = {"b": [rs.randn(64, 33).astype(np.float32),
                    rs.randn(7).astype(np.float32)],
              "a": rs.randn(3, 5, 2).astype(np.float32) * 100}
    tt = {"b": [torch.from_numpy(a) for a in arrays["b"]],
          "a": torch.from_numpy(arrays["a"]).to(torch.bfloat16)}
    jt = {"b": [jnp.asarray(a) for a in arrays["b"]],
          "a": jnp.asarray(arrays["a"]).astype(jnp.bfloat16)}
    got, ref = profiling.sync(tt), jprof.sync(jt)
    mag = sum(float(np.abs(np.asarray(v, np.float32)).sum())
              for v in jax_leaves(jt))
    assert isinstance(got, float) and abs(got - ref) <= 1e-6 * mag
    assert profiling.sync({"none": None}) == jprof.sync({}) == 0.0
    assert profiling.sync(torch.ones(3)) == 3.0


def jax_leaves(tree):
    import jax
    return [np.asarray(v.astype(jnp.float32)) for v in
            jax.tree_util.tree_leaves(tree)]


def test_timer_sync_waits_and_trace_writes_a_file(tmp_path):
    logdir = tmp_path / "trace"
    timer = profiling.Timer()
    with profiling.trace(str(logdir)) as prof:
        with timer("matmul"):
            y = torch.randn(64, 64) @ torch.randn(64, 64)
            timer.sync(y)
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.events() and timer.counts == {"matmul": 1}


def test_new_tools_import_no_jax():
    code = ("import sys\n"
            "import cvvae_tpu_torch.utils.profiling\n"
            "import cvvae_tpu_torch.utils.profile_train_step\n"
            "import cvvae_tpu_torch.utils.profile_stages\n"
            "import cvvae_tpu_torch.utils.profile_stages_sd3\n"
            "import cvvae_tpu_torch.utils.convert_lpips\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cvvae_tpu' or "
            "m.startswith('cvvae_tpu.') or m == 'tools' or "
            "m.startswith('tools.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("argv", [["--edge_conv"], ["--unet_step"], []])
def test_profiling_cli_refuses_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profiling.main(argv)
