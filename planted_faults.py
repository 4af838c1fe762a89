#!/usr/bin/env python3
"""Planted faults against the checks of K1-K6, K1 split, K1.bwd, K2.bwd,
K3.bwd, K4.bwd, K5 from int8, K1's int8 mode and of the edge-pad convs:
do the bounds that ``chip_smoke.py`` and the card tests hold them to
catch a broken kernel or decomposition?

    python3 planted_faults.py

Copies ``cvvae_tpu_torch/csrc/`` into temporary directories (outside the
checkout) and builds it once as it is and once with each fault of FAULTS
planted, all builds side by side.  Each build is made the library the
wrappers launch (``_build.library(path)``) and run where its fault lies:

- K1, bf16 and fp32, at the shapes of ``chip_smoke.K1_CASES`` and
  ``chip_smoke.K1_CHECK_SHAPES`` on ``chip_smoke.k1_inputs``, held by
  ``chip_smoke.k1_check``; K1 split across ranks (K1.partial, K1.combine)
  at ``chip_smoke.K1_SPLIT_CHECKS`` and the per-frame shapes of
  ``chip_smoke.K1_SPLIT_CASES``, its joined output held the same way;
- K4 (bf16 only) at the shapes of ``chip_smoke.K4_CASES`` on
  ``chip_smoke.k4_inputs`` (N(0, 1) and rising logits), held by
  ``chip_smoke.k4_check``, and the logsumexp it writes for a gradient by
  ``chip_smoke.k4_lse_check``;
- K3, bf16 and fp32, at ``chip_smoke.K3_SHAPE`` and
  ``chip_smoke.K3_CHECK_SHAPES`` (Cin 3) on ``chip_smoke.k3_inputs``, held
  by ``chip_smoke.k3_check``;
- K2, bf16 and fp32, at ``chip_smoke.K2_CASES`` and
  ``chip_smoke.K2_CHECK_SHAPES``, held bit-exact (``chip_smoke.k2_exact``);
- K5 (K5.stage then K5.gemm), bf16 and fp32, at
  ``chip_smoke.k5_check_cases`` on ``chip_smoke.k5_inputs``, held
  bit-exact to its plain version;
- K1.bwd and K2.bwd, bf16 and fp32, at ``chip_smoke.K1_CHECK_SHAPES`` and
  ``chip_smoke.K2_CHECK_SHAPES``, held by ``chip_smoke.k1_bwd_check``
  (``K1_BWD_RMS``) and ``chip_smoke.k2_bwd_check`` (d(bias) within the
  bound of ``shuffle.bwd_plan``);
- K3.bwd, bf16 and fp32, at ``chip_smoke.K3_BWD_SHAPES`` and
  ``chip_smoke.K3_BWD_CHECK_SHAPES``, held by ``chip_smoke.k3_bwd_check``
  (the float64 sums within the bound of ``stem.bwd_plan``);
- K4.bwd at ``chip_smoke.K4_BWD_CHECK_SHAPES``, held by
  ``chip_smoke.k4_bwd_check``;
- the int8-resident modes on phase 13's small cases: K5 from an int8
  input (int8, bf16 and fp32 out) at ``chip_smoke.K5_CHECK_CASES``, held
  bit-exact (``chip_smoke.k5_int8_check``); K1's int8 mode at
  ``chip_smoke.QFLOW_K1_CASES``, held by ``chip_smoke.k1_int8_check``; K6
  at ``chip_smoke.QFLOW_K6_CASES`` (its add on both paths), held bit-exact
  (``chip_smoke.k6_checks``, whose inputs hold ties of the quotient), and
  quant8 through K6.requant on every fp32 value of |v / s| <= 128 at
  ``chip_smoke.QUANT8_SCALES[0]`` (``chip_smoke.quant8_exhaustive``); K5's
  staged int8 epilogue at ``chip_smoke.K5_INT8_CASES``; K1's int8 mode
  also against the plain table (``chip_smoke.k1_int8_table_check``).

A fault is one replacement of text in a source, or several (tuples of
texts and their replacements).

The edge-pad decompositions of ``cvvae_tpu_torch/ops/conv.py`` are held
the same way: the faults of EDGE_FAULTS are planted in copies of that
file, each loaded as a module of its own, and its decompositions are run
in bf16 at the 720p shapes of ``chip_smoke.EDGE_CASES`` against the
committed materialised pad, held by ``chip_smoke.edge_check``.

Prints one line per build, kernel and case, with the check's reading and
whether it fails.  Exits non-zero if the kernel as it is fails a case or a
fault passes every case.  Needs a CUDA card and nvcc.  It imports nothing
of JAX.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import os
import shutil
import sys
import tempfile
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from cvvae_tpu_torch.ops import conv  # noqa: E402
from cvvae_tpu_torch.ops.kernels import (  # noqa: E402
    _build, attention, conv_int8, groupnorm, shuffle, stem)

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
    "a block left out of K1.partial's fold": (
        "K1.split", "groupnorm.cu",
        "  const int n = p.n_blocks;",
        "  const int n = p.n_blocks - 1;"),
    "K1.combine folding rank 0's moments in place of rank 1's": (
        "K1.split", "groupnorm.cu",
        "    const double* q = moments + (((int64_t)r * B + b) * p.G + g) * 3;",
        "    const double* q =\n"
        "        moments + (((int64_t)(r == 1 ? 0 : r) * B + b) * p.G + g) "
        "* 3;"),
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
    "time's edge clamp dropped (edge frames read as zero)": (
        "K3", "stem.cu",
        "    ti = min(max(ti, 0), g.T_in - 1);",
        "    ok = ok && ti >= 0 && ti < g.T_in;"),
    "the last k-step skipped (taps 24-26 and the bias)": (
        "K3", "stem.cu",
        "for (int s = 1; s < kKSteps; ++s)",
        "for (int s = 1; s < kKSteps - 1; ++s)"),
    "the W padding mask dropped": (
        "K3", "stem.cu",
        "const bool ok = b0 >= 0 && wi >= 0 && wi < g.W;",
        "const bool ok = b0 >= 0;"),
    "the last vector of each pixel not written": (
        "K2", "shuffle.cu",
        "for (int ci = threadIdx.x; ci < cv; ci += blockDim.x) {",
        "for (int ci = threadIdx.x; ci < cv - 1; ci += blockDim.x) {"),
    "the other channel group's bias": (
        "K2", "shuffle.cu",
        "reinterpret_cast<const V*>(bias)[j * cv + ci];",
        "reinterpret_cast<const V*>(bias)[((j + 1) % n) * cv + ci];"),
    "the staging pass's edge pads read as zeros (not replicated)": (
        "K5", "conv_int8.cu",
        "    if (!edge) return -1;",
        "    return -1;"),
    "the last tap row dropped from the GEMM's K loop": (
        "K5", "conv_int8.cu",
        "  return a.kT * a.kH;",
        "  return a.kT * a.kH - 1;"),
    "scale_w[0] used for every channel": (
        "K5", "conv_int8.cu",
        "__ldg(scale_w + c)",
        "__ldg(scale_w)"),
    "every tap of a reused A strip read from its first row": (
        "K5", "conv_int8.cu",
        "          int row0 = dw;",
        "          int row0 = 0;"),
    "SiLU's derivative without its (1 + z(1 - s)) factor": (
        "K1.bwd", "groupnorm_bwd.cu",
        ("    return d * s * (1.f + z * (1.f - s));",
         "    return d * fmaf(0.5f, t, 0.5f) * fmaf(h, 1.f - t, 1.f);"),
        ("    return d * s;",
         "    return d * fmaf(0.5f, t, 0.5f);")),
    "the last block's sums dropped from the backward merge": (
        "K1.bwd", "groupnorm_bwd.cu",
        "for (int k = lane; k < p.n_chunks; k += 32) {",
        "for (int k = lane; k < p.n_chunks - 1; k += 32) {"),
    "the B term (q * (x - mean)) left out of dx": (
        "K1.bwd", "groupnorm_bwd.cu",
        "      q[j] = qr[2 * ((c0 + j) / cg)];",
        "      q[j] = 0.f;"),
    "dweight and dbias swapped": (
        "K1.bwd", "groupnorm_bwd.cu",
        "    A.dparams[c] = from_f32<W>((float)t2);\n"
        "    A.dparams[p.C + c] = from_f32<W>((float)t1);",
        "    A.dparams[c] = from_f32<W>((float)t1);\n"
        "    A.dparams[p.C + c] = from_f32<W>((float)t2);"),
    "the apply pass reading the rows' sums before the grid barrier": (
        "K1.bwd", "groupnorm_bwd.cu",
        "  grid.sync();  // the rows' sums are complete",
        "  // (no barrier: the rows' sums are read as they stand)"),
    "odd output columns copied into the even phase": (
        "K2.bwd", "shuffle_bwd.cu",
        "          ((x & 1) ? po : pe)[(int64_t)(x >> 1) * (n * cv)] = v[u];",
        "          pe[(int64_t)(x >> 1) * (n * cv)] = v[u];"),
    "both channel groups' bias sums added into the first": (
        "K2.bwd", "shuffle_bwd.cu",
        "          for (int e = 0; e < E; ++e) acc[1][e] += row[e];",
        "          for (int e = 0; e < E; ++e) acc[0][e] += row[e];"),
    "the bias merge skips the last slot": (
        "K2.bwd", "shuffle_bwd.cu",
        "  const int s1 = min(slots, (ty + 1) * per);",
        "  const int s1 = min(slots - 1, (ty + 1) * per);"),
    "the merge's slot ranges overlap by one": (
        "K2.bwd", "shuffle_bwd.cu",
        "    for (int s = ty * per; s < s1; ++s)",
        "    for (int s = ty * per - (ty > 0); s < s1; ++s)"),
    "the block's tree skips its last level": (
        "K2.bwd", "shuffle_bwd.cu",
        "      for (h >>= 1; h > 0; h >>= 1) {",
        "      for (h >>= 1; h > 1; h >>= 1) {"),
    "the edge-time clamp off by a frame": (
        "K3.bwd", "stem_bwd.cu",
        "    ti = min(max(ti, 0), g.T_in - 1);",
        "    ti = min(max(ti, 1), g.T_in - 1);"),
    "the last block's partial dropped from the merge": (
        "K3.bwd", "stem_bwd.cu",
        "  const int s1 = min(slots, (r + 1) * per);",
        "  const int s1 = min(slots - 1, (r + 1) * per);"),
    "dy's rows past the tile's pixels not zeroed (stale rows summed)": (
        # both operands: fp32's copy leaves a stage's rows past the tile
        # as the last tile left them, and bf16's im2col keeps x's pixels
        # there (bf16's dy rows there are TMA's zeros)
        "K3.bwd", "stem_bwd.cu",
        ("    const bool on = live(p, t);\n",
         "      const bool live0 = live(k, t), live1 = live(k + 1, t);"),
        ("    const bool on = live(p, t);\n    if (!on) continue;\n",
         "      const bool live0 = true, live1 = true;")),
    "dbias's column of ones zero on odd pixels": (
        "K3.bwd", "stem_bwd.cu",
        "          (one0 ? 0x3F80u : 0u) | ((one1 ? 0x3F80u : 0u) << 16);",
        "          (one0 ? 0x3F80u : 0u);"),
    "the logsumexp taken against the first tile's (stale) running max": (
        "K4", "attention.cu",
        ("    softmax_tile(s, 0, S, scale_log2, t4, m, l, alpha);\n"
         "    to_fragments(s, pa);\n  }",
         "(m[h] + log2f(l[h])) * kLn2"),
        ("    softmax_tile(s, 0, S, scale_log2, t4, m, l, alpha);\n"
         "    to_fragments(s, pa);\n  }\n"
         "  const float m_first[2] = {m[0], m[1]};",
         "(m_first[h] + log2f(l[h])) * kLn2")),
    "D left out of dS": (
        "K4.bwd", "attention_bwd.cu",
        "      ds[e] = pv[e] * (dpv[e] - dv[u][e & 1]);",
        "      ds[e] = pv[e] * dpv[e];"),
    "the scale applied twice to dq": (
        "K4.bwd", "attention_bwd.cu",
        "          pack_bf16(acc[4 * j + 2 * h] * scale, "
        "acc[4 * j + 2 * h + 1] * scale);",
        "          pack_bf16(acc[4 * j + 2 * h] * scale * scale,\n"
        "                    acc[4 * j + 2 * h + 1] * scale * scale);"),
    "dq's last key tile skipped": (
        "K4.bwd", "attention_bwd.cu",
        "  const int q0 = (blockIdx.x / parts) * kTile, b = blockIdx.y;\n"
        "  const int n_tiles = (S + kTile - 1) / kTile;",
        "  const int q0 = (blockIdx.x / parts) * kTile, b = blockIdx.y;\n"
        "  const int n_tiles = (S - 1) / kTile;"),
    "the last cluster rank's partial left out of the sum": (
        "K4.bwd", "attention_bwd.cu",
        "    for (int q = 1; q < C; ++q) {\n      sv[0] += x.s[u][q].x;",
        "    for (int q = 1; q < C - 1; ++q) {\n      sv[0] += x.s[u][q].x;"),
    "every cluster rank loading rank 0's head-dim slice": (
        "K4.bwd", "attention_bwd.cu",
        "  const int group = rank * SL / kBox;",
        "  const int group = 0;"),
    "K6 rounding with roundf (ties away from zero), not half to even": (
        "K6", "qflow.cu",
        "  return (uint32_t)(quant8(v, s, __frcp_rn(s)) & 0xff);",
        "  return (uint32_t)(max(-127, min(127, (int)roundf(v / s))) & 0xff);"),
    "K6's sliced add holding sh where sx belongs": (
        "K6", "qflow.cu",
        "      fx[i] = sx.at(cb + i);",
        "      fx[i] = sh.at(cb + i);"),
    "K6's sliced add's channel base one slice off": (
        "K6", "qflow.cu",
        "  const int cb = (int)(((int64_t)t * 16) % C);",
        "  const int cb = (int)(((int64_t)t * 16 + 16) % C);"),
    "K1's int8 mode reading the scalar scale where it is per channel": (
        "K1.int8", "groupnorm.cu",
        "  auto scale = [&](int c) { return qs.s[c * qs.per_channel]; };",
        "  auto scale = [&](int c) { return qs.s[0]; };"),
    "K5's int8 epilogue skipping the bias": (
        "K5.int8", "conv_int8.cu",
        ("      const float bc = bias != nullptr && c < a.O ? __ldg(bias + c) "
         ": 0.f;",
         "          bq[h] = bias != nullptr && c < a.O ? __ldg(bias + c) : "
         "0.f;"),
        ("      const float bc = bias != nullptr && c < a.O && sizeof(T) > 1\n"
         "                           ? __ldg(bias + c) : 0.f;",
         "          bq[h] = 0.f;")),
    "K1.int8's table built one code off": (
        "K1.int8", "groupnorm.cu",
        "    const float y = qsilu((int)(int8_t)u, coef_a(c), coef_b(c));",
        "    const float y = qsilu((int)(int8_t)(u + 1), coef_a(c), "
        "coef_b(c));"),
    "quant8's rare case rounding a tie away from zero, not to even": (
        "K6", "common.cuh",
        "  const float code = fminf(d > hi ? a + 0.5f : d < -lo ? a - 0.5f : "
        "rintf(a),",
        "  const float code = fminf(d > hi ? a + 0.5f : d < -lo ? a - 0.5f : "
        "a + 0.5f,"),
}


def replacements(fault):
    """[(text, replacement), ...] of a FAULTS entry."""
    _, _, old, new = fault
    if isinstance(old, str):
        return [(old, new)]
    return list(zip(old, new))


#: faults planted in a copy of ops/conv.py: fault -> [(its text, the
#: replacement), ...]
EDGE_FAULTS = {
    "the first output's fix dropped on each edge axis": [
        ("    o = 0\n    while o * stride < lo",
         "    o = 1\n    while o * stride < lo")],
    "the hi side's fix made from the lo side's slab": [
        ('sl = slice(0, 1) if side == "lo" else slice(size - 1, size)',
         "sl = slice(0, 1)")],
    "a slab's later edge axes zero-padded (its corners counted by no axis)": [
        ("slabs[side] = _edge_pad(_axis(x, axis, sl), slab_edge,\n"
         '                                        ("edge",) * 3)',
         "slabs[side] = _axis(x, axis, sl)"),
        ("slab_zero = [(0, 0) if a == axis or a in later else spec.pads[a]",
         "slab_zero = [(0, 0) if a == axis else spec.pads[a]")],
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
            err, excess, text = chip_smoke.k1_check(got, x, w, b, **kw)
            del x, got
            torch.cuda.empty_cache()
            yield (f"K1 {shape} G={groups} {dtype}: max_abs_err={err!r} "
                   f"{text}", excess > 0.0)


def _k1_split_cases():
    """(label, fails) of every case of K1 split across ranks on the library
    now loaded, bf16 and fp32: ``chip_smoke.K1_SPLIT_CHECKS`` (2 and 3
    ranks on unequal runs of H rows) and the per-frame shapes of
    ``chip_smoke.K1_SPLIT_CASES`` on two H halves; every run's partial
    moments, then each run's combination, joined and held by
    ``chip_smoke.k1_check``."""
    dev = torch.device("cuda", 0)
    cases = chip_smoke.K1_SPLIT_CHECKS + [
        (s, 32, silu, pf, (s[2] // 2, s[2] - s[2] // 2))
        for s, silu, pf in chip_smoke.K1_SPLIT_CASES if pf]
    for dtype in (torch.bfloat16, torch.float32):
        for shape, groups, silu, per_frame, runs in cases:
            x, w, b = chip_smoke.k1_inputs(shape, dev, dtype)
            kw = dict(num_groups=groups, eps=1e-6, silu=silu,
                      per_frame=per_frame)
            parts = [p.contiguous() for p in x.split(list(runs), dim=2)]
            moments = torch.stack([groupnorm.partial_moments(
                p, groups, per_frame) for p in parts])
            got = torch.cat([groupnorm.combine(p, w, b, moments, **kw)
                             for p in parts], dim=2)
            torch.cuda.synchronize()
            err, excess, text = chip_smoke.k1_check(got, x, w, b, **kw)
            del x, parts, got
            torch.cuda.empty_cache()
            yield (f"K1.split {shape} runs={runs} {dtype}: "
                   f"max_abs_err={err!r} {text}", excess > 0.0)


def _k4_cases():
    """(label, fails) of every K4 case on the library now loaded."""
    dev = torch.device("cuda", 0)
    for shape, _, rising in chip_smoke.K4_CASES:
        q, k, v = chip_smoke.k4_inputs(shape, dev, torch.bfloat16, rising)
        scale = shape[-1] ** -0.5
        got = attention.flash_attention(q, k, v, scale)
        ref = attention.flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err, excess, text = chip_smoke.k4_check(got, ref)
        _, lse = attention._launch(q, k, v, scale, True)
        _, lse_excess, lse_text = chip_smoke.k4_lse_check(
            lse, attention.flash_attention_lse_plain(q, k, scale))
        del q, k, v, got, ref, lse
        torch.cuda.empty_cache()
        yield (f"K4 {shape}{' rising logits' if rising else ''}: "
               f"max_abs_err={err!r} {text}; {lse_text} excess "
               f"{lse_excess!r}", max(excess, lse_excess) > 0.0)


def _k4_bwd_cases():
    """(label, fails) of every K4.bwd case on the library now loaded: the
    shapes of ``chip_smoke.K4_BWD_CHECK_SHAPES``, held by
    ``chip_smoke.k4_bwd_check``."""
    dev = torch.device("cuda", 0)
    for shape, rising in chip_smoke.K4_BWD_CHECK_SHAPES:
        args = chip_smoke.k4_bwd_inputs(shape, dev, rising)
        _, excess, text, _ = chip_smoke.k4_bwd_check(*args)
        del args
        torch.cuda.empty_cache()
        yield (f"K4.bwd {shape}{' rising logits' if rising else ''}: {text}",
               excess > 0.0)


def _k3_cases():
    """(label, fails) of every K3 case on the library now loaded."""
    dev = torch.device("cuda", 0)
    cases = [("edge", chip_smoke.K3_SHAPE[:-1])] + chip_smoke.K3_CHECK_SHAPES
    for dtype in (torch.bfloat16, torch.float32):
        for pad, shape in cases:
            spec = chip_smoke.k3_spec(pad)
            x, w, b = chip_smoke.k3_inputs(shape, 3, dev, dtype)
            got = stem.stem_conv3d(x, w, b, spec)
            torch.cuda.synchronize()
            err, excess, text = chip_smoke.k3_check(got, x, w, b, spec)
            del x, got
            torch.cuda.empty_cache()
            yield (f"K3 {shape} {pad} {dtype}: max_abs_err={err!r} {text}",
                   excess > 0.0)


def _k2_cases():
    """(label, fails) of every K2 case on the library now loaded."""
    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, n in chip_smoke.K2_CASES:
            if dtype == torch.float32 and shape == chip_smoke.K2_CASES[-1][0]:
                continue  # as in chip_smoke.py: fp32 is checked smaller
            phases = [chip_smoke.randn(shape, 10 + j, dev, dtype)
                      for j in range(4)]
            bias = chip_smoke.randn(shape[-1:], 20, dev, dtype)
            exact = chip_smoke.k2_exact(
                shuffle.subpixel_interleave(phases, bias, n=n),
                shuffle.subpixel_interleave_plain(phases, bias, n=n))
            del phases
            torch.cuda.empty_cache()
            yield f"K2 {shape} n={n} {dtype}: bit-exact={exact}", not exact
        for b, n, drop, c, with_bias in chip_smoke.K2_CHECK_SHAPES:
            phases, bias = chip_smoke.k2_inputs(b, n, c, with_bias, dev, dtype)
            exact = chip_smoke.k2_exact(
                shuffle.subpixel_interleave(phases, bias, n=n,
                                            drop_first=drop),
                shuffle.subpixel_interleave_plain(phases, bias, n=n,
                                                  drop_first=drop))
            yield (f"K2 {(b, 3, 5, 7, n * c)} n={n} drop={drop} "
                   f"bias={with_bias} {dtype}: bit-exact={exact}", not exact)


def _k1_bwd_cases():
    """(label, fails) of every K1.bwd case on the library now loaded: the
    shapes of ``chip_smoke.K1_CHECK_SHAPES``, held to
    ``chip_smoke.K1_BWD_RMS`` by ``chip_smoke.k1_bwd_check``."""
    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, groups, silu, per_frame in chip_smoke.K1_CHECK_SHAPES:
            x, dy, w, b = chip_smoke.k1_bwd_inputs(shape, dev, dtype)
            rel, _, _ = chip_smoke.k1_bwd_check(x, dy, w, b, groups, 1e-5,
                                                silu, per_frame)
            tol = chip_smoke.K1_BWD_RMS[dtype]
            yield (f"K1.bwd {shape} G={groups} silu={silu} {dtype}: "
                   f"||d||/||ref|| {rel} (<= {tol})",
                   not all(v <= tol for v in rel.values()))


def _k2_bwd_cases():
    """(label, fails) of every K2.bwd case on the library now loaded: the
    cases of ``chip_smoke.K2_CHECK_SHAPES``, held by
    ``chip_smoke.k2_bwd_check`` (phases bit-exact, d(bias) within the
    summation bound)."""
    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32):
        for b, n, drop, c, with_bias in chip_smoke.K2_CHECK_SHAPES:
            dy = chip_smoke.randn((b, n * 3 - (n > 1 and drop), 10, 14, c),
                                  7, dev, dtype)
            exact, excess, _ = chip_smoke.k2_bwd_check(dy, n, 3, with_bias,
                                                       drop)
            yield (f"K2.bwd {tuple(dy.shape)} n={n} drop={drop} "
                   f"bias={with_bias} {dtype}: phases bit-exact={exact}, "
                   f"dbias excess {excess!r}", not exact or excess > 0.0)


def _k3_bwd_cases():
    """(label, fails) of every K3.bwd case on the library now loaded: the
    shapes of ``chip_smoke.K3_BWD_SHAPES`` and
    ``chip_smoke.K3_BWD_CHECK_SHAPES``, bf16 and fp32, held by
    ``chip_smoke.k3_bwd_check``."""
    dev = torch.device("cuda", 0)
    cases = ([("edge", shape) for _, shape in chip_smoke.K3_BWD_SHAPES]
             + chip_smoke.K3_BWD_CHECK_SHAPES)
    for dtype in (torch.bfloat16, torch.float32):
        for pad, shape in cases:
            spec = chip_smoke.k3_spec(pad)
            x = chip_smoke.k3_inputs(shape, 3, dev, dtype)[0]
            t_out, h_out, w_out = stem._extents(x, spec)
            dy = chip_smoke.randn((shape[0], t_out, h_out, w_out, stem.COUT),
                                  33, dev, dtype)
            _, excess, text, _ = chip_smoke.k3_bwd_check(x, dy, spec)
            del x, dy
            torch.cuda.empty_cache()
            yield f"K3.bwd {shape} {pad} {dtype}: {text}", excess > 0.0


def _k5_cases():
    """(label, fails) of every K5 check case on the library now loaded."""
    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32):
        for _, half, (shape, cout, kernel, stride, pads, modes, bias) in \
                chip_smoke.k5_check_cases():
            args = chip_smoke.k5_inputs(shape, cout, kernel, dev, dtype, bias,
                                        half_steps=half)
            exact = chip_smoke.k2_exact(
                conv_int8.conv3d_int8(*args, stride, pads, modes),
                conv_int8.conv3d_int8_plain(*args, stride, pads, modes))
            yield (f"K5 {shape}->{cout} k={kernel} s={stride} pads={pads} "
                   f"{modes} half_steps={half} {dtype}: bit-exact={exact}",
                   not exact)


def _k5_int8_cases():
    """(label, fails) of every case of K5 from an int8 input on the library
    now loaded: ``chip_smoke.K5_CHECK_CASES``, int8 out at per-channel
    scales (direct stores) and bf16 and fp32 out, and
    ``chip_smoke.K5_INT8_CASES`` (int8 out, staged), bit-exact."""
    dev = torch.device("cuda", 0)
    cases = [(f"case {i}", c, (torch.int8, torch.bfloat16, torch.float32))
             for i, c in enumerate(chip_smoke.K5_CHECK_CASES)]
    cases += [(f"staged case {i}", c, (torch.int8,))
              for i, c in enumerate(chip_smoke.K5_INT8_CASES)]
    for label, (shape, cout, kernel, stride, pads, modes, with_bias), \
            dtypes in cases:
        xq, wq, sw, sx, b, so = chip_smoke.k5_int8_inputs(
            shape, cout, kernel, dev, with_bias)
        for out_dtype in dtypes:
            exact, err = chip_smoke.k5_int8_check(
                xq, wq, sw, sx, b, kernel, stride, pads, modes, so, out_dtype)
            yield (f"K5.int8 {label} {shape}->{cout} bias={with_bias} out "
                   f"{out_dtype}: bit-exact={exact} max|d|={err!r}",
                   not exact)


def _k1_int8_cases():
    """(label, fails) of every case of K1's int8 mode on the library now
    loaded: ``chip_smoke.QFLOW_K1_CASES``, scalar and per-channel scales,
    int8, bf16 and fp32 out, held by ``chip_smoke.k1_int8_check``."""
    dev = torch.device("cuda", 0)
    for shape, groups in chip_smoke.QFLOW_K1_CASES:
        for per_channel in (False, True):
            q, s, w, b = chip_smoke.k1_int8_inputs(shape, dev, per_channel)
            for out_scale, out_dtype in (
                    (torch.tensor(0.03, device=dev), torch.int8),
                    (None, torch.bfloat16), (None, torch.float32)):
                got = groupnorm.group_norm_silu_int8(
                    q, s, w, b, num_groups=groups, eps=chip_smoke.QFLOW_EPS,
                    out_scale=out_scale, out_dtype=out_dtype)
                _, excess, text = chip_smoke.k1_int8_check(
                    got, q, s, w, b, groups, out_scale, out_dtype)
                yield (f"K1.int8 {shape} G={groups} per_channel="
                       f"{per_channel} out {out_dtype}: {text}", excess > 0.0)
                same, text = chip_smoke.k1_int8_table_check(
                    q, s, w, b, groups, out_scale, out_dtype)
                yield (f"K1.int8 {shape} G={groups} per_channel="
                       f"{per_channel} out {out_dtype} against the plain "
                       f"table: {text}", not same)


def _k6_cases():
    """(label, fails) of every K6 case on the library now loaded:
    ``chip_smoke.QFLOW_K6_CASES`` through ``chip_smoke.k6_checks``,
    bit-exact."""
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        for shape in chip_smoke.QFLOW_K6_CASES:
            for label, same in chip_smoke.k6_checks(shape, dev):
                yield f"{label}: bit-exact={same}", not same
        held, _ = chip_smoke.quant8_exhaustive(dev, chip_smoke.QUANT8_SCALES[:1])
        for sv, n, off in held:
            yield (f"quant8 through K6.requant on every fp32 value of |v / s| "
                   f"<= 128 at s = {sv!r}: {off} of {n} off", off > 0)


def edge_cases(module=None, dev=None, cases=None,
               dtypes=(torch.bfloat16,)):
    """(label, fails) of every edge-conv case (by default
    ``chip_smoke.EDGE_CASES`` in bf16 on the card): the decompositions of
    ``module`` (by default the committed ops/conv.py) against the
    committed materialised pad."""
    dev = dev or torch.device("cuda", 0)
    for name, shape, ctor, cout in cases or chip_smoke.EDGE_CASES:
        spec = getattr(conv.Conv3DSpec, ctor)()
        materialised = chip_smoke.edge_paths(spec)["materialised"]
        paths = chip_smoke.edge_paths(spec, module)
        del paths["materialised"]
        for dtype in dtypes:
            x, w, b = chip_smoke.edge_inputs(shape, cout, dev, dtype)
            ref = materialised(x, w, b)
            mag = (materialised(x.abs(), w.abs(), b.abs())
                   if dtype == torch.bfloat16 else None)
            for path, fn in paths.items():
                err, excess, text = chip_smoke.edge_check(fn(x, w, b), ref,
                                                          mag)
                yield (f"edge {name} {shape}->{cout} {dtype} {path}: "
                       f"max_abs_err={err!r} excess={excess!r} {text}",
                       excess > 0.0)
            del x, ref, mag
            if dev.type == "cuda":
                torch.cuda.empty_cache()


def planted_conv(tmp: Path, i: int, replacements):
    """ops/conv.py copied into tmp with ``replacements`` made, loaded as a
    module of its own."""
    text = Path(conv.__file__).read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise SystemExit(f"{old!r} is not in conv.py once")
        text = text.replace(old, new)
    path = tmp / f"conv{i}.py"
    path.write_text(text)
    spec = importlib.util.spec_from_file_location(f"planted_conv{i}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclass looks itself up there
    spec.loader.exec_module(module)
    return module


#: each kernel's cases, and the edge convs'
CASES = {"K1": _k1_cases, "K1.split": _k1_split_cases, "K2": _k2_cases,
         "K3": _k3_cases, "K4": _k4_cases,
         "K5": _k5_cases, "K1.bwd": _k1_bwd_cases, "K2.bwd": _k2_bwd_cases,
         "K3.bwd": _k3_bwd_cases, "K4.bwd": _k4_bwd_cases,
         "K5.int8": _k5_int8_cases, "K1.int8": _k1_int8_cases,
         "K6": _k6_cases, "edge": edge_cases}


def _build_copy(tmp: Path, i: int, fault) -> Path:
    """csrc/ copied into tmp, ``fault`` planted, built: the library."""
    src = tmp / f"csrc{i}"
    shutil.copytree(_build.CSRC, src)
    if fault is not None:
        name = fault[1]
        path = src / name
        text = path.read_text()
        for old, new in replacements(fault):
            if text.count(old) != 1:
                raise SystemExit(f"{old!r} is not in {name} once")
            text = text.replace(old, new)
        path.write_text(text)
    out = tmp / f"lib{i}" / _build.LIB_NAME
    _build.build(out, sorted(src.iterdir()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("planted_faults: needs a CUDA device")
        return 1
    # fp32 references in full fp32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {chip_smoke.nvidia_smi_line()}")
    builds = {"as committed": None, **FAULTS}
    not_told_apart = []

    def run(name, cases, planted):
        caught = False
        for label, fails in cases:
            caught |= fails
            print(f"[{name}] {label}: {'FAILS' if fails else 'passes'}",
                  flush=True)
            if fails and not planted:
                not_told_apart.append(f"{name}: {label}")
        if planted and not caught:
            not_told_apart.append(name)

    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            libs = dict(zip(builds, pool.map(
                lambda a: _build_copy(Path(tmp), *a),
                enumerate(builds.values()))))
        for name, fault in builds.items():
            _build.library(libs[name])
            kernels = tuple(CASES) if fault is None else (fault[0],)
            run(name, (case for k in kernels for case in CASES[k]()),
                fault is not None)
        for i, (name, replacements) in enumerate(EDGE_FAULTS.items()):
            run(name, edge_cases(planted_conv(Path(tmp), i, replacements)),
                True)
    if not_told_apart:
        print(f"planted_faults: not told apart: {not_told_apart}")
        return 1
    print("planted_faults: the kernels and the edge convs pass every case; "
          "every fault fails one")
    return 0


if __name__ == "__main__":
    sys.exit(main())
