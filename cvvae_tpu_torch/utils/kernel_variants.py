"""Time variants of a hand-written kernel's source on the card.

    python -m cvvae_tpu_torch.utils.kernel_variants \
        [--kernel K5|K1.bwd|K2.bwd|K3.bwd|K4.bwd]

Each variant is ``csrc/`` copied into a temporary directory with some
text of one source replaced, built (all side by side) and made the
library the wrappers launch (``_build.library(path)``).

- K5 (the default): every variant is first held bit-exact to K5's plain
  version on ``chip_smoke``'s check cases, then timed (K5.stage then
  K5.gemm, the packed weight made beforehand) at each of
  ``chip_smoke.K5_PATH_SHAPES`` in bf16, in turns, twice.  Prints the
  registers and spills ptxas reports for K5's bf16 GEMM.
- K1.bwd: every variant is first held to ``chip_smoke.K1_BWD_RMS`` of
  the plain version on ``chip_smoke.K1_CHECK_SHAPES`` (fp32 and bf16),
  then timed at each of ``chip_smoke.K1_BWD_SHAPES`` in fp32 and bf16, in
  turns, twice.  Prints the registers and spills of its bf16 and fp32
  kernels with SiLU.
- K2.bwd: every variant is first held by ``chip_smoke.k2_bwd_check`` on
  ``chip_smoke.K2_CHECK_SHAPES`` (fp32 and bf16), then timed with the
  bias at ``chip_smoke.K2_BWD_SHAPES`` in fp32 and bf16, in turns, twice.
  Prints the registers and spills of its copy and merge kernels.
- K3.bwd: every variant is first held by ``chip_smoke.k3_bwd_check`` on
  ``chip_smoke.K3_BWD_CHECK_SHAPES`` (fp32 and bf16), then timed at
  ``chip_smoke.K3_BWD_SHAPES`` in fp32 and bf16, in turns, twice.
- K4.bwd: every variant is first held to ``chip_smoke.K4_BWD_MAX`` and
  ``K4_BWD_RMS`` of the plain version at ``chip_smoke.K4_BWD_CHECK_SHAPES``
  and ``K4_BWD_SHAPES``, then timed at ``K4_BWD_SHAPES``, in turns,
  twice.  Prints the registers and spills of its dkv and dq kernels at
  every width, and the shared memory that a cluster of 2 at C = 512 and a
  fourth walk stage would need (``attention.backward_plan``; neither fits,
  and two stages deadlock: the partials run a tile ahead of the update,
  so three walk tiles are in use at once; none of them is a variant).

Needs a CUDA card and nvcc; imports nothing of JAX.  ``VARIANTS`` (K5,
``csrc/conv_int8.cu``), ``K1_BWD_VARIANTS`` (``csrc/groupnorm_bwd.cu``),
``K2_BWD_VARIANTS`` (``csrc/shuffle_bwd.cu``), ``K3_BWD_VARIANTS``
(``csrc/stem_bwd.cu``) and ``K4_BWD_VARIANTS`` (``csrc/attention_bwd.cu``)
hold each kernel's
design choices undone one at a time, so that each choice's effect is
measured in one call.
"""

from __future__ import annotations

import argparse
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


#: name -> [(text of csrc/groupnorm_bwd.cu, its replacement), ...]
K1_BWD_VARIANTS = {
    "as committed": [],
    "the SiLU derivative by an IEEE division, both dtypes": [
        ("    const float s = __frcp_rn(1.f + __expf(-z));",
         "    const float s = 1.f / (1.f + __expf(-z));"),
        ("    const float h = 0.5f * z;\n"
         "    const float t = tanh_approx(h);\n"
         "    return d * fmaf(0.5f, t, 0.5f) * fmaf(h, 1.f - t, 1.f);",
         "    const float s = 1.f / (1.f + __expf(-z));\n"
         "    return d * s * (1.f + z * (1.f - s));")],
    "bf16 on the fp32 form (one rounded reciprocal)": [
        ("  if constexpr (std::is_same<T, float>::value) {",
         "  if constexpr (true) {")],
    "4 loads in flight in bf16": [
        ("constexpr int kUnrollBf16 = 2;", "constexpr int kUnrollBf16 = 4;")],
    "the apply pass forwards": [
        ("    for_rows<T, V, true>(", "    for_rows<T, V, false>(")],
}

#: name -> [(text of csrc/attention_bwd.cu, its replacement), ...]
K4_BWD_VARIANTS = {
    "as committed": [],
    "the next partials after the exchange": [
        ("      update(i - 1);\n      partials(i + 1);\n      exchange(i);\n"
         "      wgmma_wait<1>();  // tile i-1's update\n      release(i - 1);\n"
         "      store(i);\n",
         "      update(i - 1);\n      exchange(i);\n"
         "      wgmma_wait<0>();  // tile i-1's update\n      release(i - 1);\n"
         "      store(i);\n      partials(i + 1);\n")],
    "all-gather exchange": [
        ("constexpr bool kReduceScatter = true;",
         "constexpr bool kReduceScatter = false;")],
    "proxy fences of every state space": [
        ('  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");',
         '  asm volatile("fence.proxy.async;\\n" ::: "memory");')],
}

#: name -> [(text of csrc/shuffle_bwd.cu, its replacement), ...]
K2_BWD_VARIANTS = {
    "as committed": [],
    "sums indexed by the row's channel group (local memory)": [
        ("        if (j == 0) {\n"
         "#pragma unroll\n"
         "          for (int e = 0; e < E; ++e) acc[0][e] += row[e];\n"
         "        } else {\n"
         "#pragma unroll\n"
         "          for (int e = 0; e < E; ++e) acc[1][e] += row[e];\n"
         "        }",
         "#pragma unroll\n"
         "        for (int e = 0; e < E; ++e) acc[j][e] += row[e];")],
    "8 loads in flight": [("constexpr int kUnroll = 4;",
                           "constexpr int kUnroll = 8;")],
    "2 loads in flight": [("constexpr int kUnroll = 4;",
                           "constexpr int kUnroll = 2;")],
    "merge over 8 slot ranges a channel": [
        ("constexpr int kMergeSplit = 32;", "constexpr int kMergeSplit = 8;")],
}

#: name -> [(text of csrc/stem_bwd.cu, its replacement), ...]
K3_BWD_VARIANTS = {
    "as committed": [],
    "bf16: 64-pixel tiles": [
        ("constexpr int kTW = 128;", "constexpr int kTW = 64;")],
    "bf16: a 2-stage ring (one tile in flight)": [
        ("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "fp32: 128-pixel tiles (2 stages)": [
        ("constexpr int kFmaTW = 64;", "constexpr int kFmaTW = 128;"),
        ("constexpr int kPX = 66;", "constexpr int kPX = 132;"),
        ("constexpr int kFmaStages = 3;", "constexpr int kFmaStages = 2;")],
    "fp32: the next tile's x loaded after the products": [
        ("constexpr bool kPrefetchX = true;",
         "constexpr bool kPrefetchX = false;")],
    "fp32: one patch row x 4 channels a thread (18 warps)": [
        ("constexpr int kRows = 3;", "constexpr int kRows = 1;"),
        ("constexpr int kCh = 2;", "constexpr int kCh = 4;")],
    "fp32: one wave (a block an SM)": [
        ("constexpr int kFmaBlocksPerSm = 2;",
         "constexpr int kFmaBlocksPerSm = 1;")],
}

#: each kernel's variants: (source, variants)
KERNEL_VARIANTS = {"K5": ("conv_int8.cu", VARIANTS),
                   "K1.bwd": ("groupnorm_bwd.cu", K1_BWD_VARIANTS),
                   "K2.bwd": ("shuffle_bwd.cu", K2_BWD_VARIANTS),
                   "K3.bwd": ("stem_bwd.cu", K3_BWD_VARIANTS),
                   "K4.bwd": ("attention_bwd.cu", K4_BWD_VARIANTS)}


def _build_variant(tmp: Path, i: int, replacements, source="conv_int8.cu"):
    from cvvae_tpu_torch.ops.kernels import _build

    src = tmp / f"csrc{i}"
    shutil.copytree(_build.CSRC, src)
    path = src / source
    text = path.read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise SystemExit(f"{old!r} is not in {source} once")
        text = text.replace(old, new)
    path.write_text(text)
    out = tmp / f"lib{i}" / _build.LIB_NAME
    _build.build(out, sorted(src.iterdir()))
    return out


def _k1_bwd(libs, dev) -> int:
    """K1.bwd's variants: held to K1_BWD_RMS on K1_CHECK_SHAPES, then
    timed at K1_BWD_SHAPES in turns."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, groupnorm

    dtypes = (torch.float32, torch.bfloat16)
    for name, lib in libs.items():
        log = (lib.parent / "build.log").read_text().splitlines()
        for i, line in enumerate(log):
            if "Compiling" in line and (
                    "gn_bwdI13__nv_bfloat16fLi8ELb1E" in line
                    or "gn_bwdIffLi4ELb1E" in line):
                info = [s for s in log[i:i + 4]
                        if "spill" in s or "Used" in s][:2]
                kernel = line.split("gn_bwd")[1][:20]
                print(f"[{name}] {kernel}: " + " | ".join(
                    s.split(":", 1)[-1].strip() for s in info))
        _build.library(lib)
        bad = []
        for dtype in dtypes:
            for shape, groups, silu, per_frame in chip_smoke.K1_CHECK_SHAPES:
                x, dy, w, b = chip_smoke.k1_bwd_inputs(shape, dev, dtype)
                rel, _, _ = chip_smoke.k1_bwd_check(x, dy, w, b, groups, 1e-5,
                                                    silu, per_frame)
                if max(rel.values()) > chip_smoke.K1_BWD_RMS[dtype]:
                    bad.append((shape, str(dtype), rel))
        print(f"[{name}] check cases past K1_BWD_RMS: {bad}", flush=True)
        if bad:
            return 1
    order = list(libs) + list(libs)[::-1]
    for where, shape, groups, eps, silu, per_frame in chip_smoke.K1_BWD_SHAPES:
        for dtype in dtypes:
            x, dy, w, b = chip_smoke.k1_bwd_inputs(shape, dev, dtype)
            _, mean, inv = groupnorm._launch(x, w, b, groups, eps, silu,
                                             per_frame, True)
            times = {n: [] for n in libs}
            for n in order:
                _build.library(libs[n])
                times[n].append(chip_smoke.time_ms(
                    lambda: groupnorm.group_norm_silu_backward(
                        dy, x, w, b, mean, inv, silu=silu,
                        per_frame=per_frame)))
            for n, t in times.items():
                print(f"[{n}] {where} {shape} {dtype}: median ms "
                      f"{statistics.median(t)!r} (in turns: {t})", flush=True)
            del x, dy, w, b, mean, inv
            torch.cuda.empty_cache()
    return 0


def _k2_bwd(libs, dev) -> int:
    """K2.bwd's variants: held by chip_smoke.k2_bwd_check on
    K2_CHECK_SHAPES (fp32 and bf16), then timed with the bias at
    K2_BWD_SHAPES in fp32 and bf16, in turns."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, shuffle

    dtypes = (torch.float32, torch.bfloat16)
    for name, lib in libs.items():
        log = (lib.parent / "build.log").read_text().splitlines()
        for i, line in enumerate(log):
            if "Compiling" in line and ("subpixel_unshuffle" in line
                                        or "bias_grad" in line):
                info = [s for s in log[i:i + 4]
                        if "spill" in s or "Used" in s][:2]
                kernel = line.split("Compiling entry function")[-1][:60]
                print(f"[{name}] {kernel.strip()}: " + " | ".join(
                    s.split(":", 1)[-1].strip() for s in info))
        _build.library(lib)
        bad = []
        for dtype in dtypes:
            for b, n, drop, c, with_bias in chip_smoke.K2_CHECK_SHAPES:
                dy = chip_smoke.randn((b, n * 3 - (n > 1 and drop), 10, 14, c),
                                      7, dev, dtype)
                exact, excess, _ = chip_smoke.k2_bwd_check(dy, n, 3,
                                                           with_bias, drop)
                if not exact or excess > 0.0:
                    bad.append((b, n, drop, c, with_bias, str(dtype)))
        print(f"[{name}] check cases failed: {bad}", flush=True)
        if bad:
            return 1
    order = list(libs) + list(libs)[::-1]
    for shape, n in chip_smoke.K2_BWD_SHAPES:
        b, t, h, w, nc = shape
        for dtype in dtypes:
            dy = chip_smoke.randn((b, n * t - (n > 1), 2 * h, 2 * w, nc // n),
                                  9, dev, dtype)
            times = {name: [] for name in libs}
            for name in order:
                _build.library(libs[name])
                times[name].append(chip_smoke.time_ms(
                    lambda: shuffle.subpixel_interleave_backward(dy, n=n,
                                                                 t=t), 10))
            for name, t_ in times.items():
                print(f"[{name}] {shape} n={n} {dtype}: median ms "
                      f"{statistics.median(t_)!r} (in turns: {t_})",
                      flush=True)
            del dy
            torch.cuda.empty_cache()
    return 0


def _k3_bwd(libs, dev) -> int:
    """K3.bwd's variants: held by chip_smoke.k3_bwd_check on
    K3_BWD_CHECK_SHAPES (fp32 and bf16), then timed at K3_BWD_SHAPES in
    fp32 and bf16, in turns.  Each variant runs on the plan its own
    source's constants give (``stem.use_bwd_source``)."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, stem

    def use(name):
        lib = libs[name]
        _build.library(lib)
        stem.use_bwd_source((lib.parent.parent / lib.parent.name.replace(
            "lib", "csrc") / "stem_bwd.cu").read_text())

    dtypes = (torch.float32, torch.bfloat16)
    for name, lib in libs.items():
        log = (lib.parent / "build.log").read_text().splitlines()
        for i, line in enumerate(log):
            if "Compiling" in line and (
                    "stem_bwd_fmaILi3E" in line
                    or "stem_bwd_mmaILi3E" in line):
                info = [s for s in log[i:i + 4]
                        if "spill" in s or "Used" in s][:2]
                print(f"[{name}] {line.split('stem_bwd_')[1][:40]}: "
                      + " | ".join(s.split(":", 1)[-1].strip() for s in info))
        use(name)
        bad = []
        for dtype in dtypes:
            for pad, shape in chip_smoke.K3_BWD_CHECK_SHAPES:
                spec = chip_smoke.k3_spec(pad)
                x = chip_smoke.k3_inputs(shape, 3, dev, dtype)[0]
                dy = chip_smoke.randn((shape[0],) + stem._extents(x, spec)
                                      + (stem.COUT,), 33, dev, dtype)
                if chip_smoke.k3_bwd_check(x, dy, spec)[1] > 0.0:
                    bad.append((pad, shape, str(dtype)))
        print(f"[{name}] check cases failed: {bad}", flush=True)
        if bad:
            return 1
    order = list(libs) + list(libs)[::-1]
    spec = chip_smoke.k3_spec("edge")
    for where, shape in chip_smoke.K3_BWD_SHAPES:
        for dtype in dtypes:
            x = chip_smoke.k3_inputs(shape, 3, dev, dtype)[0]
            dy = chip_smoke.randn(tuple(shape) + (stem.COUT,), 33, dev, dtype)
            times = {name: [] for name in libs}
            for name in order:
                use(name)
                times[name].append(chip_smoke.time_ms(
                    lambda: stem.stem_conv3d_backward(x, dy, spec), 10))
            for name, t_ in times.items():
                print(f"[{name}] {where} {shape} {dtype}: median ms "
                      f"{statistics.median(t_)!r} (in turns: {t_})",
                      flush=True)
            del x, dy
            torch.cuda.empty_cache()
    stem.use_bwd_source()
    return 0


def _k4_bwd(libs, dev) -> int:
    """K4.bwd's variants: held to K4_BWD_MAX / K4_BWD_RMS at
    K4_BWD_CHECK_SHAPES and K4_BWD_SHAPES, then timed at K4_BWD_SHAPES in
    turns."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, attention

    for label, kw in (("cluster of 2 at C=512", dict(slice_cols=256)),
                      ("4 walk stages", dict(stages=4))):
        p = attention.backward_plan(8, 1600, 512, **kw)
        print(f"[{label}] shared memory {p['smem']} bytes > "
              f"{attention.SMEM_LIMIT}: does not fit")
    for name, lib in libs.items():
        log = (lib.parent / "build.log").read_text().splitlines()
        for i, line in enumerate(log):
            if "Compiling" in line and "flash_bwd_d" in line:
                info = [s for s in log[i:i + 4]
                        if "spill" in s or "Used" in s][:2]
                kernel = line.split("flash_bwd_")[1].split("EEEv")[0]
                print(f"[{name}] {kernel}: " + " | ".join(
                    s.split(":", 1)[-1].strip() for s in info))
        _build.library(lib)
        bad = []
        for shape, rising in (chip_smoke.K4_BWD_CHECK_SHAPES
                              + chip_smoke.K4_BWD_SHAPES):
            args = chip_smoke.k4_bwd_inputs(shape, dev, rising)
            _, excess, text, _ = chip_smoke.k4_bwd_check(*args)
            if excess > 0.0:
                bad.append((shape, text))
            del args
            torch.cuda.empty_cache()
        print(f"[{name}] cases past K4_BWD_MAX / K4_BWD_RMS: {bad}",
              flush=True)
        if bad:
            return 1
    order = list(libs) + list(libs)[::-1]
    for shape, rising in chip_smoke.K4_BWD_SHAPES:
        args = chip_smoke.k4_bwd_inputs(shape, dev, rising)
        times = {n: [] for n in libs}
        for n in order:
            _build.library(libs[n])
            times[n].append(chip_smoke.time_ms(
                lambda: attention.flash_attention_backward(*args), 10))
        for n, t in times.items():
            print(f"[{n}] {shape}{' rising' if rising else ''}: median ms "
                  f"{statistics.median(t)!r} (in turns: {t})", flush=True)
        del args
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, conv_int8

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNEL_VARIANTS),
                    default="K5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {chip_smoke.nvidia_smi_line()}")
    source, variants = KERNEL_VARIANTS[args.kernel]
    if args.kernel != "K5":
        with tempfile.TemporaryDirectory() as tmp:
            with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
                jobs = {n: pool.submit(_build_variant, Path(tmp), i, r,
                                       source)
                        for i, (n, r) in enumerate(variants.items())}
                libs = {n: j.result() for n, j in jobs.items()}
            run = {"K1.bwd": _k1_bwd, "K2.bwd": _k2_bwd, "K3.bwd": _k3_bwd,
                   "K4.bwd": _k4_bwd}[args.kernel]
            return run(libs, dev)
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
