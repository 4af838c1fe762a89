"""Build and load the hand-written CUDA kernels (``cvvae_tpu_torch/csrc``).

Each source is compiled by its own ``nvcc`` for ``sm_90a`` (all started
together), and the objects are linked into one shared library with a
plain C interface, loaded with ctypes.  The build happens
at first use, into ``build/kernels/<hash of the sources>/`` at the root of
the checkout (listed in ``.gitignore``), so a changed source rebuilds and
an unchanged one loads the existing library.  Nothing here runs at import:
the CPU path never needs ``nvcc``.  A build or load failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libcvvae_kernels.so"

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: ... and int8's, which only the int8 entries take (K5.stage's input,
#: K5.gemm's output, K1's int8 mode)
INT8_CODE = 2

#: seconds the last build took (0.0 when an existing library was loaded)
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float


class GroupNormBwdPlan(ctypes.Structure):
    """K1.bwd's plan as ``csrc/groupnorm_bwd.cu``'s ``Plan`` lays it out,
    passed by value."""
    _fields_ = [("S", _L), ("rows_per_chunk", _L)] + [
        (name, _I) for name in ("B", "C", "G", "V", "threads", "n_chunks",
                                "grid", "silu", "dtype", "wdtype",
                                "stat_stride", "device")]


_SIGNATURES = {
    "cvvae_group_norm": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _F, _I,
                         _I, _I, _I, _I, _L, _I, _I, _P],
    "cvvae_group_norm_partial": [_P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I,
                                 _L, _I, _I, _P],
    "cvvae_group_norm_combine": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _L, _I,
                                 _I, _F, _I, _I, _I, _I, _I, _L, _I, _I, _P],
    "cvvae_group_norm_bwd": [_P] * 9 + [GroupNormBwdPlan, _P],
    "cvvae_group_norm_int8": [_P, _P, _I] + [_P] * 6 + [_I, _L, _I, _I, _F,
                                                        _I, _I, _I, _I, _L,
                                                        _I, _I, _P],
    "cvvae_subpixel_interleave_bwd": [_P] * 7 + [_L] + [_I] * 12 + [_P],
    "cvvae_subpixel_interleave": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cvvae_stem_conv3d": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _P],
    "cvvae_stem_conv3d_bwd": [_P] * 5 + [_L] + [_I] * 16 + [_P],
    "cvvae_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "cvvae_flash_attention_bwd": [_P] * 10 + [_I, _I, _I, _F, _I, _I, _P],
    "cvvae_int8_stage": [_P] * 3 + [_I] * 19 + [_P],
    "cvvae_int8_gemm": [_P] * 7 + [_I] * 21 + [_P],
    "cvvae_qflow_requant": [_P, _P, _I, _P, _L, _I, _I, _I, _I, _P],
    "cvvae_qflow_add": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _L, _I, _I, _P],
}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def constants(source: str, *names: str, text: str | None = None) -> tuple:
    """The values of ``constexpr int <name> = <integer>;`` in
    ``csrc/<source>`` (or in ``text``, a variant of it): a kernel's
    compile-time schedule, read from its source so that the wrapper
    planning its launches (and the CPU tests of that plan) use the
    kernel's own numbers."""
    text = (CSRC / source).read_text() if text is None else text
    values = []
    for name in names:
        found = re.findall(rf"^constexpr int {name} = (\d+);", text, re.M)
        if len(found) != 1:
            raise RuntimeError(f"{source}: no single 'constexpr int {name}'")
        values.append(int(found[0]))
    return tuple(values)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands side by side; (cmd, returncode, output) each."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    results = []
    for c, p in procs:
        text = p.communicate()[0]
        results.append((c, p.returncode, text))
    return results


def build(out: Path, sources=None) -> None:
    """Build ``sources`` (default: every file of ``csrc/``) into the
    library ``out``: one nvcc per source, all started together, then one
    link."""
    global last_build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    arch = [_nvcc(), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-Xcompiler", "-fPIC"]
    objs, compiles = [], []
    for src in sources or _sources():
        if src.suffix == ".cu":
            # nvcc tells an object by its ".o" suffix
            objs.append(str(out.with_name(f"{src.stem}.{pid}.o")))
            compiles.append(arch + ["-Xptxas", "-v", "-c", str(src),
                                    "-o", objs[-1]])
    tmp = out.with_name(f"{out.name}.{pid}.tmp")
    t0 = time.perf_counter()
    results = _run_all(compiles)
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([arch + ["-shared", "-o", str(tmp)] + objs])
    (out.parent / "build.log").write_text("".join(
        " ".join(c) + "\n" + text for c, _, text in results))
    for o in objs:
        Path(o).unlink(missing_ok=True)
    failed = [(c, rc, text) for c, rc, text in results if rc != 0]
    if failed:
        c, rc, text = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n"
                           f"{text[-4000:]}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0


#: the library the wrappers launch; set at the first ``library`` call
_current: Path | None = None


def library(path: Path | None = None) -> ctypes.CDLL:
    """The loaded kernel library that every wrapper launches: by default
    the one built from ``csrc/`` (built first if needed).  ``path`` names
    another library made by ``build`` (a copy of the sources built
    elsewhere); it serves this and every later call until another is
    named."""
    global _current
    if path is not None:
        _current = Path(path)
    elif _current is None:
        _current = build_dir() / LIB_NAME
        if not _current.exists():
            build(_current)
    return _load(_current)


@functools.cache
def _load(path: Path) -> ctypes.CDLL:
    """A built library, its functions typed."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda_layout(name: str, t: torch.Tensor, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous BTHWC-style CUDA tensor of a
    dtype the kernels take.  Nothing is copied: the caller hands over the
    layout the kernel reads."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input is not contiguous in (B,T,H,W,C) "
                         f"order (strides {t.stride()}); call .contiguous() "
                         f"where it is produced")


def refuse_gradient(name: str, backward: str, *tensors) -> None:
    """Raise where a kernel without a backward kernel would be asked for
    a gradient: grad mode on and any of ``tensors`` requiring one.  The
    kernel's output would carry no ``grad_fn`` and the gradient would be
    lost without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel ({backward}) yet, so its output "
            f"cannot carry a gradient on the card; run it under "
            f"torch.no_grad(), or see ROADMAP.md queue B for {backward}")
