#!/usr/bin/env python3
"""Planted faults against the checks of K1 and K4: do the bounds that
``chip_smoke.py`` and the card tests hold the kernels to catch a broken
kernel?

    python3 planted_faults.py

Copies ``cvvae_tpu_torch/csrc/`` into temporary directories (outside the
checkout) and builds it once as it is and once with each fault of FAULTS
planted, all builds side by side.  Each build is made the library the
wrappers launch (``_build.library(path)``) and run where its fault lies:

- K1, bf16 and fp32, at the shapes of ``chip_smoke.K1_CASES`` and
  ``chip_smoke.K1_CHECK_SHAPES`` on ``chip_smoke.k1_inputs``, held by
  ``chip_smoke.k1_check``;
- K4, bf16, at the bf16 shapes of ``chip_smoke.K4_CASES`` on
  ``chip_smoke.k4_inputs`` (N(0, 1) and rising logits), held by
  ``chip_smoke.k4_check``.

Prints one line per build, kernel and case, with the check's reading and
whether it fails.  Exits non-zero if the kernel as it is fails a case or a
fault passes every case.  Needs a CUDA card and nvcc.  It imports nothing
of JAX.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import sys
import tempfile
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from cvvae_tpu_torch.ops.kernels import _build, attention, groupnorm  # noqa: E402

#: fault -> (kernel, source file, its text, the replacement)
FAULTS = {
    "last block's moments dropped from the merge": (
        "K1", "groupnorm.cu",
        "for (int k = lane; k < p.n_blocks; k += 32) {",
        "for (int k = lane; k < p.n_blocks - 1; k += 32) {"),
    "each frame after the first read from one row early": (
        "K1", "groupnorm.cu",
        "const T* xb = x + (int64_t)b * p.S * p.C;",
        "const T* xb = x + ((int64_t)b * p.S - (b > 0)) * p.C;"),
    "the merge reads the next group's moments": (
        "K1", "groupnorm.cu",
        "part + (((int64_t)b * p.n_blocks + k) * p.G + g) * 2;",
        "part + (((int64_t)b * p.n_blocks + k) * p.G + (g + 1) % p.G) * 2;"),
    "the output's rescale removed": (
        "K4", "attention.cu",
        "if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) "
        "return;",
        "return;"),
    "alpha left out of the running sum": (
        "K4", "attention.cu",
        "l[h] = l[h] * alpha[h] + sum[h];",
        "l[h] = l[h] + sum[h];"),
    "each row's output rescaled by the other row's alpha": (
        "K4", "attention.cu",
        "o[4 * j] *= alpha[0];\n    o[4 * j + 1] *= alpha[0];\n"
        "    o[4 * j + 2] *= alpha[1];\n    o[4 * j + 3] *= alpha[1];",
        "o[4 * j] *= alpha[1];\n    o[4 * j + 1] *= alpha[1];\n"
        "    o[4 * j + 2] *= alpha[0];\n    o[4 * j + 3] *= alpha[0];"),
}


def _k1_cases():
    """(label, fails) of every K1 case on the library now loaded."""
    dev = torch.device("cuda", 0)
    cases = [(s, 32, silu, pf) for s, silu, pf, _ in chip_smoke.K1_CASES]
    for dtype in (torch.bfloat16, torch.float32):
        for shape, groups, silu, per_frame in cases + chip_smoke.K1_CHECK_SHAPES:
            x, w, b = chip_smoke.k1_inputs(shape, dev, dtype)
            kw = dict(num_groups=groups, eps=1e-5, silu=silu,
                      per_frame=per_frame)
            got = groupnorm.group_norm_silu(x, w, b, **kw)
            torch.cuda.synchronize()
            _, excess, text = chip_smoke.k1_check(got, x, w, b, **kw)
            del x, got
            torch.cuda.empty_cache()
            yield f"K1 {shape} G={groups} {dtype}: {text}", excess > 0.0


def _k4_cases():
    """(label, fails) of every bf16 K4 case on the library now loaded."""
    dev = torch.device("cuda", 0)
    for shape, dtype, _, rising in chip_smoke.K4_CASES:
        if dtype != torch.bfloat16:
            continue  # the faults are planted in the bf16 kernel
        q, k, v = chip_smoke.k4_inputs(shape, dev, dtype, rising)
        scale = shape[-1] ** -0.5
        got = attention.flash_attention(q, k, v, scale)
        ref = attention.flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        _, excess, text = chip_smoke.k4_check(got, ref)
        del q, k, v, got, ref
        torch.cuda.empty_cache()
        yield (f"K4 {shape}{' rising logits' if rising else ''}: {text}",
               excess > 0.0)


def _build_copy(tmp: Path, i: int, fault) -> Path:
    """csrc/ copied into tmp, ``fault`` planted, built: the library."""
    src = tmp / f"csrc{i}"
    shutil.copytree(_build.CSRC, src)
    if fault is not None:
        _, name, old, new = fault
        path = src / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{old!r} is not in {name} once")
        path.write_text(text.replace(old, new))
    out = tmp / f"lib{i}" / _build.LIB_NAME
    _build.build(out, sorted(src.iterdir()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("planted_faults: needs a CUDA device")
        return 1
    print(f"[card] {chip_smoke.nvidia_smi_line()}")
    builds = {"as committed": None, **FAULTS}
    not_told_apart = []
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            libs = dict(zip(builds, pool.map(
                lambda a: _build_copy(Path(tmp), *a),
                enumerate(builds.values()))))
        for name, fault in builds.items():
            _build.library(libs[name])
            kernels = ("K1", "K4") if fault is None else (fault[0],)
            caught = False
            for kernel in kernels:
                cases = _k1_cases() if kernel == "K1" else _k4_cases()
                for label, fails in cases:
                    caught |= fails
                    print(f"[{name}] {label}: "
                          f"{'FAILS' if fails else 'passes'}", flush=True)
                    if fails and fault is None:
                        not_told_apart.append(f"{name}: {label}")
            if fault is not None and not caught:
                not_told_apart.append(name)
    if not_told_apart:
        print(f"planted_faults: not told apart: {not_told_apart}")
        return 1
    print("planted_faults: the kernels pass every case; every fault fails "
          "one")
    return 0


if __name__ == "__main__":
    sys.exit(main())
