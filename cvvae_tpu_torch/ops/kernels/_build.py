"""Build and load the hand-written CUDA kernels (``cvvae_tpu_torch/csrc``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ctypes.  The build happens
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

#: seconds the last build took (0.0 when an existing library was loaded)
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "cvvae_group_norm": [_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _F, _I, _I,
                         _L, _I, _I, _P],
    "cvvae_subpixel_interleave": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _P],
    "cvvae_stem_conv3d": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


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


def _build(out: Path) -> None:
    global last_build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp)] + [str(p) for p in _sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path = build_dir() / LIB_NAME
    if not path.exists():
        _build(path)
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
    return torch.cuda.current_stream(t.device).cuda_stream


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
