"""Time variants of a hand-written kernel's source on the card.

    python -m cvvae_tpu_torch.utils.kernel_variants

Each variant is ``csrc/`` copied into a temporary directory with some
text of one source replaced, built (all side by side) and made the
library the wrappers launch (``_build.library(path)``).  Every variant is
first held bit-exact to K5's plain version on ``chip_smoke``'s check
cases, then timed (K5.stage then K5.gemm, the packed weight made
beforehand) at each of ``chip_smoke.K5_PATH_SHAPES`` in bf16, in turns,
twice.  Prints the registers and spills ptxas reports for K5's bf16 GEMM.
Needs a CUDA card and nvcc; imports nothing of JAX.

``VARIANTS`` holds the design choices of ``csrc/conv_int8.cu`` undone one
at a time, so that each choice's effect is measured in one call.
"""

from __future__ import annotations

import concurrent.futures
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

#: name -> [(text of csrc/conv_int8.cu, its replacement), ...]
VARIANTS = {
    "as committed": [],
    "A loaded per tap": [("constexpr bool kReuseA = true;",
                          "constexpr bool kReuseA = false;")],
    "BM 128 only": [("  const bool wide = waste256 <= waste128;",
                     "  const bool wide = false;")],
    "2-stage rings": [("constexpr int kAStages = 3;",
                       "constexpr int kAStages = 2;"),
                      ("constexpr int kBStages = 6;",
                       "constexpr int kBStages = 2;")],
    "one block a tile": [("a.n_tiles > n_sms ? n_sms : a.n_tiles;",
                          "a.n_tiles;")],
}


def _build_variant(tmp: Path, i: int, replacements):
    from cvvae_tpu_torch.ops.kernels import _build

    src = tmp / f"csrc{i}"
    shutil.copytree(_build.CSRC, src)
    path = src / "conv_int8.cu"
    text = path.read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise SystemExit(f"{old!r} is not in conv_int8.cu once")
        text = text.replace(old, new)
    path.write_text(text)
    out = tmp / f"lib{i}" / _build.LIB_NAME
    _build.build(out, sorted(src.iterdir()))
    return out


def main() -> int:
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, conv_int8

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {chip_smoke.nvidia_smi_line()}")
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
            jobs = {n: pool.submit(_build_variant, Path(tmp), i, r)
                    for i, (n, r) in enumerate(VARIANTS.items())}
            libs = {n: j.result() for n, j in jobs.items()}
        for name, lib in libs.items():
            log = (lib.parent / "build.log").read_text().splitlines()
            for i, line in enumerate(log):
                if ("Compiling" in line
                        and "int8_gemmI13__nv_bfloat16Li256E" in line):
                    info = [s for s in log[i:i + 6]
                            if "spill" in s or "Used" in s][:2]
                    print(f"[{name}] " + " | ".join(
                        s.split(":", 1)[-1].strip() for s in info))
                    break
            _build.library(lib)
            bad = []
            for dtype in (torch.bfloat16, torch.float32):
                for i, half, (shape, cout, kernel, stride, pads, modes,
                              bias) in chip_smoke.k5_check_cases():
                    a = chip_smoke.k5_inputs(shape, cout, kernel, dev, dtype,
                                             bias, half_steps=half)
                    if not chip_smoke.k2_exact(
                            conv_int8.conv3d_int8(*a, stride, pads, modes),
                            conv_int8.conv3d_int8_plain(*a, stride, pads,
                                                        modes)):
                        bad.append((i, half, str(dtype)))
            print(f"[{name}] check cases not bit-exact: {bad}", flush=True)
            if bad:
                return 1
        order = list(libs) + list(libs)[::-1]
        for name, shape, cout, kernel, stride, pads, modes in \
                chip_smoke.K5_PATH_SHAPES:
            x, wq, sw, sx, b = chip_smoke.k5_inputs(shape, cout, kernel, dev,
                                                    torch.bfloat16)
            wpk = conv_int8.pack_weight(wq)
            times = {n: [] for n in libs}
            for n in order:
                _build.library(libs[n])
                times[n].append(chip_smoke.time_ms(
                    lambda: conv_int8.conv3d_int8(x, wq, sw, sx, b, stride,
                                                  pads, modes, wpk)))
            for n, t in times.items():
                print(f"[{n}] {name} {shape}->{cout} bf16: median ms "
                      f"{statistics.median(t)!r} (in turns: {t})", flush=True)
            del x, wq, sw, sx, b, wpk
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
