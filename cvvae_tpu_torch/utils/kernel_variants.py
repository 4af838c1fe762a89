"""Time variants of a hand-written kernel's source on the card.

    python -m cvvae_tpu_torch.utils.kernel_variants \
        [--kernel K5|K5.int8|K1.int8|K1.split|K6|quant8|K1.bwd|K2.bwd|
                  K3.bwd|K4.bwd] [--turns N] [--sass]

Each variant is ``csrc/`` copied into a temporary directory with some
text of one source replaced, built (all side by side) and made the
library the wrappers launch (``_build.library(path)``).

- K5 (the default): every variant is first held bit-exact to K5's plain
  version on ``chip_smoke``'s check cases, then timed (K5.stage then
  K5.gemm, the packed weight made beforehand) at each of
  ``chip_smoke.K5_PATH_SHAPES`` in bf16, in turns, twice.  Prints the
  registers and spills ptxas reports for K5's bf16 GEMM.
- K5.int8 (K5.gemm's int8-output epilogue): every variant is first held
  bit-exact, int8 out, on ``chip_smoke.K5_CHECK_CASES`` and
  ``K5_INT8_CASES``, then timed at the residency chain's two convs
  (``chip_smoke.QFLOW_SHAPES``, 3x3x3 and 1x3x3; int8 out, bf16 out
  beside it), in turns, twice.  Prints the registers and spills of the
  int8-output GEMMs.
- K1.int8 (K1's int8 mode): every variant is first held by
  ``chip_smoke.k1_int8_check`` on ``chip_smoke.QFLOW_K1_CASES``, then
  timed at ``chip_smoke.QFLOW_SHAPES`` (int8 and bf16 out), in turns,
  twice.
- K1.split (K1 split across ranks, ``csrc/groupnorm.cu``: K1.partial and
  K1.combine): its variants need no build of their own, since the
  two-launch forms of both entries are entries of the library and the
  plan is the wrapper's (``groupnorm.use_split_plan``): the entries as
  committed, the two-launch pair on K1's own plan (the entries before
  their redesign), then each choice undone in turn (the combination as
  its own launch, K1's plan, the fold as its own launch with no ticket).
  Prints the registers and spills of the entries' kernels (and of the
  two-launch forms' gn_stats and gn_apply) at the path's vector widths.
  Every variant is first held by ``chip_smoke.k1_check`` on
  ``chip_smoke.K1_SPLIT_CHECKS`` (bf16 and fp32), then each entry is timed
  on one H half of each ``chip_smoke.K1_SPLIT_CASES`` shape, bf16 and
  fp32, in turns: CUDA events (``chip_smoke.time_ms``, the host's time
  before the launch included) and the device's time
  (``chip_smoke.device_ms``), each with its median and spread, and the
  host's time to issue a call (``chip_smoke.host_ms``).
- K6 (``csrc/qflow.cu``, its residual add): every variant is first held
  bit-equal by ``chip_smoke.k6_checks`` on ``QFLOW_K6_CASES`` (both
  paths), then K6's add (per-channel scales) and K6.requant (bf16, a
  scalar scale) are timed at ``QFLOW_SHAPES``, in turns, twice.  Prints
  the registers and spills of the add's kernels.
- quant8 (``csrc/common.cuh``, in every kernel that rounds to int8):
  every variant is first held bit-equal to the plain versions of
  K5.stage (``chip_smoke.K5_CHECK_CASES``' inputs, bf16) and K6
  (``chip_smoke.k6_checks`` on ``QFLOW_K6_CASES``), then times the
  callers that were not redesigned around it: K5.stage (bf16) at the v1
  level-0 and upsample shapes of ``chip_smoke.K5_PATH_SHAPES``, K6
  (``qadd``, per-channel scales) and K6.requant (bf16, a scalar scale)
  at ``QFLOW_SHAPES``, in turns, twice.
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
``csrc/conv_int8.cu``), ``K5_INT8_VARIANTS`` (its int8-output epilogue),
``K1_INT8_VARIANTS`` (``csrc/groupnorm.cu``), ``K1_BWD_VARIANTS``
(``csrc/groupnorm_bwd.cu``),
``K6_VARIANTS`` (``csrc/qflow.cu``),
``K2_BWD_VARIANTS`` (``csrc/shuffle_bwd.cu``), ``K3_BWD_VARIANTS``
(``csrc/stem_bwd.cu``) and ``K4_BWD_VARIANTS`` (``csrc/attention_bwd.cu``)
hold each kernel's
design choices undone one at a time, so that each choice's effect is
measured in one call; ``QUANT8_VARIANTS`` (``csrc/common.cuh``) puts
back the ``quant8`` of the tree before its redesign.

``--turns N`` takes every reading N times forward and back (2N readings a
variant; each line prints them, their median and their spread, max − min).
``--sass`` prints, for the int8 kernels of K5.int8, K1.int8, K6 and quant8,
the counts of a few instruction classes in each variant's SASS
(``cuobjdump -sass`` of its library): the instructions, the convergence
regions (BSSY), conditional branches, votes, calls, the conversions
(I2F, F2I, FRND), the multi-function unit's reciprocals (MUFU.RCP) and
the IEEE division's range checks (FCHK).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import re
import shutil
import statistics
import subprocess
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

#: the quant8 before the fma residual (common.cuh): the correctly rounded
#: quotient by an IEEE division where t lies within 2^-13 of a
#: half-integer, on a branch
OLD_QUANT8 = """
__device__ __forceinline__ int quant8_div(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  if (fabsf(t) >= 128.f) return t > 0.f ? 127 : -127;
  const float n = rintf(t);
  if (0.5f - fabsf(t - n) > 0x1p-13f) return max(-127, min(127, (int)n));
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}
"""

#: name -> [(text of csrc/conv_int8.cu, its replacement), ...]: the
#: int8-output epilogue's design choices
K5_INT8_VARIANTS = {
    "as committed": [],
    "direct stores in place of the staged TMA store": [
        ("  a.staged = dtype == CVVAE_I8 && O % 16 == 0 &&",
         "  a.staged = false && dtype == CVVAE_I8 && O % 16 == 0 &&")],
    "the old quant8 (a division on a branch) in the staged epilogue": [
        ("// ------------------------------------------------------------- "
         "K5.gemm --\n",
         OLD_QUANT8 + "// -----------------------------------------------"
         "-------------- K5.gemm --\n"),
        ("                         quant8_fast(value(acc[4 * j + k], k >> 1),\n"
         "                                     rq[k >> 1], rare[k]));",
         "                         (uint32_t)quant8_div(value(acc[4 * j + k], "
         "k >> 1),\n"
         "                                              out_scale_of(k >> 1), "
         "__frcp_rn(out_scale_of(k >> 1))));")],
}

#: name -> [(text of csrc/groupnorm.cu, its replacement), ...]: K1's int8
#: mode's design choices (its statistics are the committed integer sums in
#: every variant)
K1_INT8_VARIANTS = {
    "as committed": [],
    "the arithmetic apply": [
        ("constexpr bool kTableApply = true;",
         "constexpr bool kTableApply = false;")],
    "the arithmetic apply with the old quant8 (the apply before the table)": [
        ("constexpr bool kTableApply = true;",
         "constexpr bool kTableApply = false;" + OLD_QUANT8),
        ("            o.v[j] = (int8_t)quant8(t, os, ro);",
         "            o.v[j] = (int8_t)quant8_div(t, os, ro);")],
}

#: the committed quant8 (common.cuh), as its text reads
QUANT8 = ("__device__ __forceinline__ int quant8(float v, float s, float r) "
          "{\n  bool rare = false;\n"
          "  uint32_t c = quant8_fast(v, quant8_rq(r), rare);\n"
          "  if (rare) c = quant8_tie_call(v, s, r);\n"
          "  return (int)(int8_t)(c & 0xffu);\n}\n")

#: name -> [(text of csrc/common.cuh, its replacement), ...]
QUANT8_VARIANTS = {
    "as committed": [],
    "the old quant8 (a division on a branch) everywhere": [
        (QUANT8, OLD_QUANT8 + "__device__ __forceinline__ int quant8(float v, "
         "float s, float r) {\n  return quant8_div(v, s, r);\n}\n")],
}

#: name -> [(text of csrc/qflow.cu, its replacement), ...]: K6's sliced
#: add with each design choice undone, and the general add (the tree's
#: before the sliced one) launched everywhere
K6_VARIANTS = {
    "as committed": [],
    "per-value scale loads": [("constexpr bool kHoldScales = true;",
                               "constexpr bool kHoldScales = false;")],
    "per-value __frcp_rn": [("constexpr bool kHoldFactors = true;",
                             "constexpr bool kHoldFactors = false;")],
    "I2F conversion": [("constexpr bool kPermConvert = true;",
                        "constexpr bool kPermConvert = false;")],
    "one group in flight": [("constexpr int kAddGroups = 2;",
                             "constexpr int kAddGroups = 1;")],
    "3 blocks an SM (80 registers a thread)": [
        ("constexpr int kAddBlocks = 2;", "constexpr int kAddBlocks = 3;")],
    "the general add whole (the kernel before the sliced one)": [
        ("constexpr bool kSlicedAdd = true;",
         "constexpr bool kSlicedAdd = false;")],
}

#: K1 split's design choices, each undone in turn, all in the one library
#: (the two-launch forms of both entries are entries of it): name -> (the
#: partial's form, the combination's form, the plan: (blocks an SM, rows
#: a block at the least), None for the source's)
K1_SPLIT_VARIANTS = {
    "as committed": ("one", "one", None),
    "the two-launch pair on K1's plan (the entries before the redesign)": (
        "pair", "pair", (8, 1)),
    "the combination as its own launch (the affine through device "
    "memory)": ("one", "pair", None),
    "K1's plan (8 blocks an SM, 1 row a block at the least)": (
        "one", "one", (8, 1)),
    "the fold as its own launch (no ticket)": ("pair", "one", None),
}

#: the instantiations of the split entries' kernels (and of the two-launch
#: forms' gn_stats and gn_apply) on the path's shapes whose registers and
#: spills ``--kernel K1.split`` prints: bf16 8-channel vectors over 1 and
#: 2 groups, fp32 4-channel vectors over 1
K1_SPLIT_MARKS = tuple(
    f"{k}I{t}" for k in ("gn_partial", "gn_stats")
    for t in ("13__nv_bfloat16Li8ELi1E", "13__nv_bfloat16Li8ELi2E",
              "fLi4ELi1E")) + tuple(
    f"{k}I{t}" for k in ("gn_combine", "gn_apply")
    for t in ("13__nv_bfloat16Li8E", "fLi4E"))

#: each kernel's variants: (source, variants)
KERNEL_VARIANTS = {"K5": ("conv_int8.cu", VARIANTS),
                   "K6": ("qflow.cu", K6_VARIANTS),
                   "K5.int8": ("conv_int8.cu", K5_INT8_VARIANTS),
                   "K1.int8": ("groupnorm.cu", K1_INT8_VARIANTS),
                   "quant8": ("common.cuh", QUANT8_VARIANTS),
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


def _ptxas(libs, marks):
    """Print the registers and spills ptxas reports for the kernels whose
    mangled names hold one of ``marks``, for each variant."""
    for name, lib in libs.items():
        log = (lib.parent / "build.log").read_text().splitlines()
        for i, line in enumerate(log):
            if "Compiling" in line and any(m in line for m in marks):
                info = [s for s in log[i:i + 6]
                        if "spill" in s or "Used" in s][:2]
                kernel = line.split("entry function '")[1].split("'")[0]
                print(f"[{name}] {kernel[-40:]}: " + " | ".join(
                    s.split(":", 1)[-1].strip() for s in info), flush=True)


#: rounds of A B ... B A that ``_timed`` takes (``--turns``)
TURNS = 1

#: the kernels whose SASS ``--sass`` counts: a mark of their mangled names
SASS_MARKS = {"K5.int8": ("int8_gemmIa",),
              "K1.int8": ("gnq_stats", "gnq_merge", "gnq_apply"),
              "quant8": ("int8_stageI", "qflow_requant", "qflow_add"),
              "K6": ("qflow_add",)}
#: instruction classes --sass counts: name -> a pattern of the opcode
SASS_CLASSES = {"BSSY": r"BSSY", "@P BRA": r"@!?P\w+ +BRA",
                "VOTE": r"VOTE", "CALL": r"CALL", "I2F": r"I2F\b",
                "F2I": r"F2I\b", "FRND": r"FRND", "MUFU.RCP": r"MUFU\.RCP",
                "FCHK": r"FCHK"}


def sass_counts(text: str, marks) -> dict:
    """{kernel: {"instructions": n, class: count, ...}} of the functions of
    a ``cuobjdump -sass`` listing whose mangled names hold one of
    ``marks`` (NOPs left out)."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", "\n" + text)[1:]:
        kernel, _, body = fn.partition("\n")
        if not any(m in kernel for m in marks):
            continue
        insns = [i for i in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);",
                                       body) if not i.startswith("NOP")]
        out[kernel.strip()] = dict(
            instructions=len(insns),
            **{k: sum(1 for i in insns if re.match(p, i))
               for k, p in SASS_CLASSES.items()})
    return out


def _sass(libs, marks):
    """Print ``sass_counts`` of each variant's library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name, lib in libs.items():
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        for kernel, counts in sass_counts(text, marks).items():
            print(f"[{name}] {kernel[-48:]} SASS: {counts}", flush=True)


def _timed(libs, cases):
    """Each (label, call) of ``cases`` timed with every library, in turns
    (A B ... B A, TURNS times), 10 calls a reading."""
    from cvvae_tpu_torch.ops.kernels import _build
    import chip_smoke

    order = (list(libs) + list(libs)[::-1]) * TURNS
    for label, fn in cases:
        times = {n: [] for n in libs}
        for n in order:
            _build.library(libs[n])
            times[n].append(chip_smoke.time_ms(fn, 10))
        for n, t in times.items():
            print(f"[{n}] {label}: median ms {statistics.median(t)!r}, "
                  f"spread {max(t) - min(t)!r} (in turns: {t})", flush=True)


def _k5_int8(libs, dev) -> int:
    """K5's int8-output variants: held bit-exact to the plain version on
    K5_CHECK_CASES (direct stores) and K5_INT8_CASES (staged), int8 out,
    then timed at the residency chain's two convs (QFLOW_SHAPES, 3x3x3 and
    1x3x3, int8 out at per-channel scales, bf16 out beside them) in
    turns."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, conv_int8

    _ptxas(libs, ("int8_gemmIaLi",))
    for name, lib in libs.items():
        _build.library(lib)
        bad = []
        for i, (shape, cout, kernel, stride, pads, modes, bias) in enumerate(
                chip_smoke.K5_CHECK_CASES + chip_smoke.K5_INT8_CASES):
            xq, wq, sw, sx, b, so = chip_smoke.k5_int8_inputs(
                shape, cout, kernel, dev, bias)
            exact, _ = chip_smoke.k5_int8_check(xq, wq, sw, sx, b, kernel,
                                                stride, pads, modes, so,
                                                torch.int8)
            if not exact:
                bad.append(i)
        print(f"[{name}] check cases not bit-exact: {bad}", flush=True)
        if bad:
            return 1
    for where, shape in chip_smoke.QFLOW_SHAPES:
        for kernel, pads in (((3, 3, 3), ((1, 1), (1, 1), (1, 1))),
                             ((1, 3, 3), ((0, 0), (1, 1), (1, 1)))):
            xq, wq, sw, sx, b, so = chip_smoke.k5_int8_inputs(
                shape, shape[-1], kernel, dev)
            wpk = conv_int8.pack_weight(wq)
            modes = ("zero",) * 3
            _timed(libs, [(f"{where} {shape} k={kernel} out {dt}",
                           lambda kw=kw: conv_int8.conv3d_int8_resident(
                               xq, wq, sw, sx, b, (1, 1, 1), pads, modes, wpk,
                               **kw))
                          for dt, kw in (("int8", dict(out_scale=so)),
                                         ("bf16", dict(
                                             out_dtype=torch.bfloat16)))])
            del xq, wq, wpk
            torch.cuda.empty_cache()
    return 0


def _k1_int8(libs, dev) -> int:
    """K1's int8-mode variants: held by chip_smoke.k1_int8_check on
    QFLOW_K1_CASES (int8, bf16 and fp32 out), then timed at QFLOW_SHAPES
    (int8 out at a per-channel input scale, bf16 out at a scalar one) in
    turns."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, groupnorm

    _ptxas(libs, ("gnq_apply", "gnq_stats"))
    outs = ((torch.tensor(0.03, device=dev), torch.int8),
            (None, torch.bfloat16), (None, torch.float32))
    for name, lib in libs.items():
        _build.library(lib)
        bad = []
        for shape, groups in chip_smoke.QFLOW_K1_CASES:
            q, s, w, b = chip_smoke.k1_int8_inputs(shape, dev, True)
            for out_scale, out_dtype in outs:
                got = groupnorm.group_norm_silu_int8(
                    q, s, w, b, num_groups=groups, eps=chip_smoke.QFLOW_EPS,
                    out_scale=out_scale, out_dtype=out_dtype)
                if chip_smoke.k1_int8_check(got, q, s, w, b, groups,
                                            out_scale, out_dtype)[1] > 0.0:
                    bad.append((shape, str(out_dtype)))
        print(f"[{name}] check cases failed: {bad}", flush=True)
        if bad:
            return 1
    for where, shape in chip_smoke.QFLOW_SHAPES:
        cases = []
        for per_channel, (out_scale, out_dtype) in zip((True, False),
                                                        outs[:2]):
            q, s, w, b = chip_smoke.k1_int8_inputs(shape, dev, per_channel)
            kw = dict(num_groups=chip_smoke.QFLOW_GROUPS,
                      eps=chip_smoke.QFLOW_EPS, out_scale=out_scale,
                      out_dtype=out_dtype)
            cases.append((f"{where} {shape} out {out_dtype}",
                          lambda a=(q, s, w, b), kw=kw:
                          groupnorm.group_norm_silu_int8(*a, **kw)))
        _timed(libs, cases)
        del cases
        torch.cuda.empty_cache()
    return 0


def _quant8(libs, dev) -> int:
    """quant8's variants: held bit-equal by K5.stage's and K6's plain
    versions, then K5.stage, K6 and K6.requant timed in turns."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, conv_int8
    from cvvae_tpu_torch.ops.kernels import qflow as k6

    for name, lib in libs.items():
        _build.library(lib)
        bad = [label for shape in chip_smoke.QFLOW_K6_CASES
               for label, same in chip_smoke.k6_checks(shape, dev)
               if not same]
        for i, (shape, cout, kernel, stride, pads, modes,
                bias) in enumerate(chip_smoke.K5_CHECK_CASES):
            x, _, _, sx, _ = chip_smoke.k5_inputs(shape, cout, kernel, dev,
                                                  torch.bfloat16)
            if not torch.equal(
                    conv_int8.stage(x, sx, pads, modes, stride[2]).xq,
                    conv_int8.stage_plain(x, sx, pads, modes, stride[2])):
                bad.append(f"K5.stage case {i}")
        print(f"[{name}] checks not bit-equal: {bad}", flush=True)
        if bad:
            return 1
    for where, shape, _, kernel, stride, pads, modes in (
            chip_smoke.K5_PATH_SHAPES[0], chip_smoke.K5_PATH_SHAPES[3]):
        x, _, _, sx, _ = chip_smoke.k5_inputs(shape, 128, kernel, dev,
                                              torch.bfloat16)
        _timed(libs, [(f"K5.stage {where} {shape} bf16",
                       lambda: conv_int8.stage(x, sx, pads, modes,
                                               stride[2]))])
        del x
        torch.cuda.empty_cache()
    for where, shape in chip_smoke.QFLOW_SHAPES:
        xq = chip_smoke.qflow_codes(shape, dev, 21)
        hq = chip_smoke.qflow_codes(shape, dev, 22)
        sx = chip_smoke.qflow_scale(shape[-1], dev, True)
        x = chip_smoke.randn(shape, 3, dev, torch.bfloat16)
        s1 = torch.tensor(0.03, device=dev)
        _timed(libs, [(f"K6 qadd {where} {shape}",
                       lambda: k6.qadd(xq, sx, hq, sx, sx * 1.7)),
                      (f"K6.requant {where} {shape} bf16",
                       lambda: k6.requant(x, s1))])
        del xq, hq, x
        torch.cuda.empty_cache()
    return 0


def _k1_split_entries(name):
    """(partial, combine) of K1 split's variant ``name``, its plan in use
    from here on."""
    from cvvae_tpu_torch.ops.kernels import groupnorm as gn

    partial_form, combine_form, plan = K1_SPLIT_VARIANTS[name]
    gn.use_split_plan(*(plan or (None, None)))
    partial = (gn.partial_moments if partial_form == "one"
               else gn.partial_moments_pair)
    if combine_form == "one":
        return partial, gn.combine
    return partial, lambda *a, **kw: gn.combine_pair(*a, **kw)[0]


def _k1_split(dev) -> int:
    """K1 split's variants: held by ``chip_smoke.k1_check`` on
    K1_SPLIT_CHECKS, then each entry timed on one H half of each
    K1_SPLIT_CASES shape in turns, by CUDA events and by the device."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build
    from cvvae_tpu_torch.ops.kernels import groupnorm as gn

    _build.library()
    _ptxas({"as committed": _build.build_dir() / _build.LIB_NAME},
           K1_SPLIT_MARKS)
    for name in K1_SPLIT_VARIANTS:
        partial, combine = _k1_split_entries(name)
        bad = []
        for dtype in (torch.bfloat16, torch.float32):
            for shape, groups, silu, per_frame, runs in \
                    chip_smoke.K1_SPLIT_CHECKS:
                x, w, b = chip_smoke.k1_inputs(shape, dev, dtype)
                kw = dict(num_groups=groups, eps=1e-6, silu=silu,
                          per_frame=per_frame)
                parts = [p.contiguous() for p in x.split(list(runs), dim=2)]
                moments = torch.stack([partial(p, groups, per_frame)
                                       for p in parts])
                got = torch.cat([combine(p, w, b, moments, **kw)
                                 for p in parts], dim=2)
                if chip_smoke.k1_check(got, x, w, b, **kw)[1] > 0.0:
                    bad.append((shape, runs, str(dtype)))
        print(f"[{name}] check cases failed: {bad}", flush=True)
        if bad:
            gn.use_split_plan()
            return 1
    order = (list(K1_SPLIT_VARIANTS) + list(K1_SPLIT_VARIANTS)[::-1]) * TURNS
    for shape, silu, per_frame in chip_smoke.K1_SPLIT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = chip_smoke.k1_inputs(shape, dev, dtype)
            half = x.split(shape[2] // 2, dim=2)[0].contiguous()
            del x
            kw = dict(num_groups=32, eps=1e-6, silu=silu,
                      per_frame=per_frame)
            moments = torch.stack([gn.partial_moments(half, 32, per_frame)]
                                  * 2)
            readings = {n: {(e, m): [] for e in ("partial", "combine")
                            for m in ("event", "device", "host")}
                        for n in K1_SPLIT_VARIANTS}
            for n in order:
                partial, combine = _k1_split_entries(n)
                for entry, fn in (
                        ("partial", lambda p=partial: p(half, 32, per_frame)),
                        ("combine", lambda c=combine: c(half, w, b, moments,
                                                        **kw))):
                    r = readings[n]
                    r[entry, "event"].append(chip_smoke.time_ms(fn, 10))
                    r[entry, "device"].append(chip_smoke.device_ms(fn))
                    r[entry, "host"].append(chip_smoke.host_ms(fn))
            label = f"{tuple(half.shape)} {str(dtype)[6:]}"
            for n, r in readings.items():
                for (entry, kind), t_ in r.items():
                    print(f"[{n}] K1.{entry} {label} {kind} ms: median "
                          f"{statistics.median(t_)!r}, spread "
                          f"{max(t_) - min(t_)!r} (in turns: {t_})",
                          flush=True)
            del half, moments
            torch.cuda.empty_cache()
    gn.use_split_plan()
    return 0


def _k6(libs, dev) -> int:
    """K6's variants: held bit-equal by ``chip_smoke.k6_checks`` on
    QFLOW_K6_CASES, then K6's add (per-channel scales) and K6.requant
    (bf16, a scalar scale) timed at QFLOW_SHAPES, in turns."""
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build
    from cvvae_tpu_torch.ops.kernels import qflow as k6

    _ptxas(libs, ("qflow_add",))
    for name, lib in libs.items():
        _build.library(lib)
        bad = [label for shape in chip_smoke.QFLOW_K6_CASES
               for label, same in chip_smoke.k6_checks(shape, dev)
               if not same]
        print(f"[{name}] checks not bit-equal: {bad}", flush=True)
        if bad:
            return 1
    for where, shape in chip_smoke.QFLOW_SHAPES:
        xq = chip_smoke.qflow_codes(shape, dev, 21)
        hq = chip_smoke.qflow_codes(shape, dev, 22)
        sx = chip_smoke.qflow_scale(shape[-1], dev, True)
        so = sx * 1.7
        x = chip_smoke.randn(shape, 3, dev, torch.bfloat16)
        s1 = torch.tensor(0.03, device=dev)
        _timed(libs, [(f"K6 qadd {where} {shape}",
                       lambda: k6.qadd(xq, sx, hq, sx, so)),
                      (f"K6.requant {where} {shape} bf16",
                       lambda: k6.requant(x, s1))])
        del xq, hq, x
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    global TURNS
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, conv_int8

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNEL_VARIANTS) +
                    ["K1.split"], default="K5")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    TURNS = args.turns
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {chip_smoke.nvidia_smi_line()}")
    if args.kernel == "K1.split":
        return _k1_split(dev)
    source, variants = KERNEL_VARIANTS[args.kernel]
    if args.kernel != "K5":
        with tempfile.TemporaryDirectory() as tmp:
            with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
                jobs = {n: pool.submit(_build_variant, Path(tmp), i, r,
                                       source)
                        for i, (n, r) in enumerate(variants.items())}
                libs = {n: j.result() for n, j in jobs.items()}
            if args.sass and args.kernel in SASS_MARKS:
                _sass(libs, SASS_MARKS[args.kernel])
            run = {"K1.bwd": _k1_bwd, "K2.bwd": _k2_bwd, "K3.bwd": _k3_bwd,
                   "K4.bwd": _k4_bwd, "K5.int8": _k5_int8,
                   "K1.int8": _k1_int8, "quant8": _quant8,
                   "K6": _k6}[args.kernel]
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
