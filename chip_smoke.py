#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its findings; any failure exits non-zero):

1. device  -- require a CUDA card; print torch / CUDA / cuDNN versions
   and the card's name and power limit (nvidia-smi).
2. build   -- build the hand-written kernels from ``cvvae_tpu_torch/csrc``.
3. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes the 720p serving paths give it (bf16; K1-K3 also fp32),
   with median CUDA-event times taken in turns (plain, kernel, kernel,
   plain, then library, library where one PyTorch call computes the same
   function: SDPA for K4, ``F.group_norm`` for K1's per-frame shape),
   each beside its bound (``bound``: bytes over the HBM rate or FLOP over
   the peak, the larger) and its share of it.  K1 is also run twice at its
   largest shape and must be bit-identical; K1 and K3 in bf16 are also
   held to one rounding of fp32 arithmetic (``k1_check``, ``k3_check``);
   K2 is timed at its three shapes; K4 (bf16 only) is also checked on
   logits that rise along S, so that its online softmax rescales, with
   the logsumexp it writes for a gradient held to its plain version
   (``k4_lse_check``) and its serving launch timed in turns with the one
   that writes it; fp32 attention's exact path is timed beside SDPA fp32
   as a record.
   Then the edge-pad convs: at the v1 720p level-0 shape, a 720x672
   SD3 tile and v1's two small-Cout heads, the reference's
   decompositions (``_conv3d_edge_time_fast``, ``_conv3d_edge_fast``)
   against the materialised pad, in fp32 (the pad's conv computed in
   time chunks, ``edge_reference``) and bf16 (``edge_check``), and
   the three timed in turns.  K5 (the int8 conv: K5.stage, then
   K5.gemm) bit-equal to its plain version in bf16 and fp32 on small
   ragged cases (``K5_CHECK_CASES``) and at the four int8 path shapes
   (``K5_PATH_SHAPES``, there on the first 3 and last 2 output frames at
   full H and W), each timed in bf16 (stage and GEMM in one window)
   beside the bf16 conv it replaces (``bf16_conv_ms``, a yardstick);
   K5.stage alone bit-equal to its plain version at the path shapes and
   timed there with its bytes bound.
4. slice   -- full-width v1 and SD3 in fp32 (TF32 off): encode + decode
   on the card (kernels) against the CPU (plain versions); fp32 attention
   takes the exact path, so K4 must launch no time here.  Then each
   family quantized and calibrated once on the CPU, its state carried to
   the card, and the card's int8 frames held to the CPU's (PSNR).
5. serving -- for v1 and SD3 in bf16, then in int8 (calibrated on the
   reference's synthetic clip): the server ``serve.main`` builds
   (``serve.prepare``) for 17x720x1280 clips on an ephemeral port;
   /healthz, /reconstruct, /encode, /decode, /stats; shapes, finiteness,
   byte equality of /reconstruct and /decode(/encode), a launch of every
   kernel of that path (counts set to 0 just before, read just after;
   K5.stage and K5.gemm counted apart),
   the latencies, and int8's /reconstruct against bf16's (PSNR).
6. stream  -- a seeded 45x720x1280 uint8 clip through ``streaming.py``
   with the served v1 int8 model (encode windows 17, 17, 13; decode
   windows 5, 5, 4): the serial stream's bytes equal the batch path's,
   prefetch 1 and 3 and the pipelined loop equal the serial stream's,
   chunk_batch=2's latents (the encoder at B = 2) bit-equal to the serial
   ones;
   the stream's launches (counts set to 0 just before), wall time, fps and
   peak memory beside one 17-frame window's.
7. ckpt    -- full-width random v1 and SD3 models written as the
   reference's HF directories (``write_reference_checkpoint``) and loaded
   with ``VideoVAE.from_pretrained``: weights, latents and frames
   bit-equal to the source model's on a 17x256x256 clip; a Lightning .ckpt
   with a non-VAE key; an int8 /reconstruct served from --vae_path equal
   to the one served from the same seed.
8. train   -- K1.bwd and K2.bwd at the SD3 training path's shapes
   (``K1_BWD_SHAPES``, ``K2_BWD_SHAPES``; K2.bwd's d(bias) within the
   bound of ``shuffle.bwd_plan``) against their plain versions
   in fp32 and bf16, twice bit-identical, timed in both in turns (with
   ``native_group_norm_backward`` as K1.bwd's library call where there is
   no SiLU); K4.bwd at ``K4_BWD_SHAPES`` (``k4_bwd_check``, twice
   bit-identical, timed beside SDPA's backward) and at
   ``K4_BWD_CHECK_SHAPES`` (every width, ragged S; checked, twice
   bit-identical); one G step then one D
   step of the full-width shipped recipe (random LPIPS) on the card and on
   the CPU from one state and one set of draws (losses, gradient norms,
   parameter updates; every parameter with a nonzero gradient; K1,
   K1.bwd, K2, K2.bwd launched and K3, K4, K5 not); the card's G step
   twice from that state, with cuDNN's default and deterministic
   algorithms (bitwise reproducible or not); a bf16 G and D step at the
   shipped clip against the same steps inside ``no_flash_attention()``
   (K4 and K4.bwd launched as ``TRAIN_BF16_LAUNCHES`` says; ``loss/rec``
   against fp32's); ``train.main`` on the shipped YAML for
   ``TRAIN_MAIN_STEPS`` steps on seeded local data (a JPEG tar and cv2
   mp4 clips), in fp32 and in bf16: per-step wall time by kind and batch
   shape, peak memory, finite losses, launches a step, and a checkpoint
   written and reloaded (fp32); for the first G and D step of each batch
   kind, K1.bwd's launches by (B', S, C, SiLU, dtype) and their sum of
   launches x the kernel's time at each of those shapes.  K3.bwd at
   ``K3_BWD_SHAPES`` (fp32 and bf16, held to the float64 sums within its
   plan's bound, twice bit-identical, timed beside its plain version and
   a yardstick); v1 (``v1_engine_config``): one G and one D step card
   against CPU as for SD3 (K3 and K3.bwd launched), then bf16 G and D
   steps on the shipped clip and images (``TRAIN_V1_BATCHES``, each pair
   twice) from the same engine: wall s, peak memory, launches.
9. diffusion -- the latent-compat demo: K1, K2 and K4 at the shapes the
   v1 decode of a 64x64 latent with num_frames=1 gives them
   (``DECODE_K1_SHAPES``, ``DECODE_K2_SHAPES``, ``DECODE_K4_SHAPES``)
   against their plain versions as phase 3 holds them, timed in bf16; the
   SD 2.1 UNet, the 23-layer CLIP text tower and the v1 VAE from seeded
   random weights, written as diffusers / transformers / CV-VAE dirs and
   loaded back bit-equal; one fp32 UNet forward on the card against the
   CPU; the demo in bf16 (seeded token ids through CLIP, 50 DDIM steps with
   CFG 7.5 at 512x512, ``decode_latents``): the frame's shape and
   finiteness, wall s, ms a UNet step, decode ms, peak memory, and the
   launches (counts set to 0 just before: none in the sample, whose UNet
   is plain PyTorch as the JAX UNet calls no Pallas kernel; K1, K2 and K4
   in the decode); a 4-step bf16 sample against fp32 by the decoded
   frame's PSNR; the port's script once on those dirs.
10. tools -- the profiling tools: ``profile_train_step.profile_steps``
   for bf16 steps on the shipped clip, SD3 (the tool's config) then v1
   (``v1_engine_config``), each profiled step's launches by K group equal
   to this script's launch counters over the same step and every kernel
   of ``csrc/`` in its own group (``profiling.GROUPS``); ``profile_stages``
   for v1 in bf16 at the 720 tile with 17 frames (``TOOLS_STAGES``): the
   JAX tool's stage names, and the stage intervals' sum within
   ``TOOLS_STAGE_TOL`` of the whole forward's; ``Timer`` and ``trace``
   around one served v1 bf16 /reconstruct: a trace file written.
11. mesh -- multi-device inference with two ranks sharing the card over
   gloo (NCCL refuses two ranks on one card): (a) K1 split over the two
   H halves of its 720p shapes (``K1_SPLIT_CASES``, bf16 and fp32)
   against one K1 on the whole and K1's bounds, each split entry timed
   on one half beside its plain version, its bytes bound and K1 on the
   half; then one mesh (``make_mesh``; its follower process stopped at
   the end): (b) full-width v1 and SD3 bf16 encode and decode of the
   17x720x1280 clip H-split against unsharded (PSNR >= ``MESH_BF16_PSNR``),
   warm wall s and each rank's transport counts; (c) fp32 (TF32 off)
   H-split v1 and SD3 and T-split v1 on 256x256 clips (max|d| <=
   ``MESH_FP32_ATOL``); (d) ``build_server`` on the calibrated v1 int8
   model over the mesh beside it unsharded: /reconstruct ==
   /decode(/encode), frames by PSNR as (b); (e) every rank's launches
   (counts set to 0 on every rank just before the served requests) of
   each kernel of the path, equal across ranks, K1's two split entries
   and one all-gather a norm, every message staged through host memory.
12. dp -- data-parallel training, two spawned ranks on the card in a gloo
   group (``parallel/data.py``, as torchrun's ranks run it): (a) the
   shipped SD3 recipe at full width (random LPIPS), fp32 with TF32 off, a
   (1,17,256,256,3) clip a rank, steps G (gate closed), D and G (the
   adaptive weight open), each against one process on the card on the
   batch of two from the step's start state and generator (``DP_*``
   tolerances); (b) a bf16 SD3 D and G step; (c) a bf16 v1 G step; (d)
   ``train.main`` on the shipped YAML for ``DP_MAIN_STEPS`` bf16 steps
   (rank 0 alone writing); the ranks' states bit-identical after every
   step; each rank's wall s, its collectives' bytes and host s, each
   rank's launches (K1, K1.bwd, K2, K2.bwd, K4, K4.bwd; K3, K3.bwd in v1).

13. qflow -- int8 activation residency (``ops/qflow.py``): K5 from an
   int8 input (int8 out at per-channel scales, bf16 and fp32 out) on
   ``K5_CHECK_CASES`` and through its staged int8 epilogue on
   ``K5_INT8_CASES``, K1's int8 mode on ``QFLOW_K1_CASES`` and K6 on
   ``QFLOW_K6_CASES`` (its add on both paths) against their plain
   versions (K5 and K6 bit-equal, K1's int8 mode by ``k1_int8_check``, its
   table and every output bit-equal to the plain table of its own affine,
   ``k1_int8_table_check``, and its affine bit-equal to the plain one in
   the kernel's order of moments, ``k1_int8_coef_check``); quant8 through
   K6.requant on every fp32 value of |v / s| <= 128 at ``QUANT8_SCALES``
   (``quant8_exhaustive``); the int8-res chain on a ``QFLOW_CHAIN_CLIP``
   clip against the CPU's in K1.int8's order of moments, >=
   ``QFLOW_CHAIN_DB`` (and, a reading, against XLA's order:
   ``qflow_chain_card_vs_cpu``); each mode's agreement (dB) with
   the fp32 chain on a ``QFLOW_NUMERICS`` clip at each width; at each of
   ``QFLOW_SHAPES`` (the v1 decoder's two largest resblock stages, as
   ``tools/probe_residency.py`` times them): K5 from int8 at the chain's
   two convs (int8 and bf16 out, on the first and last output frames,
   both timed), K1's int8 mode (a per-channel scale to int8, a scalar to
   bf16; its table against the plain table), K6's
   add (the sliced path there, the general one at ``QFLOW_K6_GENERAL``)
   and requantization (with ``torch.quantize_per_tensor`` beside it, a
   yardstick), each timed beside its plain version and its
   bound; the 3-resblock chain's launches (counts set to 0 just before;
   K5, K5.stage, K5.int8, K1.int8, K6, K6.requant, and no K1-K4); the
   three chains (bf16, int8-conv: ``ops/quant.py``'s conv-only int8,
   int8-res) timed in turns, ms a block, and one int8-res chain's
   device ms by kernel group (``utils/profiling.group_kernels``).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON summary (launches on the served, streamed, training,
diffusion, tools, mesh, dp and int8-res paths, the mesh's and dp's by
rank, and at each timed shape ms, plain_ms, bound_ms, bound_by, share and
library_ms; the top-level numbers are those of the bf16 shape with the
largest bound, or of ``MAIN_DTYPES``' dtype).
It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import functools
import gc
import http.client
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: tolerances of the kernel-vs-plain checks, as |got - ref| <= tol * (1 +
#: |ref|) elementwise (atol = rtol = tol)
TOL = {
    # K1 fp32: double moments about a value of the group vs E[x^2]-mean^2,
    # and __expf, reorder the last bits
    ("K1", torch.float32): 1e-5,
    # K1 bf16 against the plain version: the kernel rounds once, the plain
    # version (JAX numerics) rounds the folded affine, the product, the
    # sum and the SiLU: a few bf16 ulps (2^-8 relative each)
    ("K1", torch.bfloat16): 2e-2,
    # K3 fp32: 81 fp32 FMAs in another order than cuDNN (TF32 off)
    ("K3", torch.float32): 2e-5,
    # K3 bf16: both accumulate in fp32 and round once: 1 bf16 ulp
    ("K3", torch.bfloat16): 1e-2,
}
#: K4 bf16, held by two bounds instead: max|got - ref| <= K4_BF16_MAX *
#: max|ref| and ||got - ref|| / ||ref|| <= K4_BF16_RMS.  The two round
#: their outputs to bf16 apart (the kernel rounds the unnormalised
#: probabilities, the plain version the normalised weights), one ulp at
#: most, and an ulp is <= 2^-7 of max|ref|; on an H100 they differ by at
#: most 7.2e-3 * max|ref| and 3.6e-3 RMS at every shape checked here and
#: in the card tests.  A missing tail mask gives 2.5e-2 and 2.8e-2 at S =
#: 1100; a dropped key tile or a 10% scale error 0.17 * max|ref| and more.
K4_BF16_MAX = 1.5e-2
K4_BF16_RMS = 5e-3
#: the bf16 kernel raises a row's running max only when a tile exceeds it
#: by more than this, in log2 units (kSlack in csrc/attention.cu)
K4_SLACK_LOG2 = 8.0
#: K4's logsumexp (written for a gradient) against its plain version,
#: |got - ref| <= K4_LSE_TOL * (1 + |ref|): both take fp32 sums of the same
#: bf16 products in other orders, and the kernel's exp2 is within 2 ulps.
#: A logsumexp taken against a stale running max is off by the raise,
#: K4_SLACK_LOG2 * ln 2 = 5.5 and more
K4_LSE_TOL = 1e-4
#: K4.bwd against its plain version, each of dq, dk and dv: max|got - ref|
#: <= K4_BWD_MAX * max|ref| and ||got - ref|| / ||ref|| <= K4_BWD_RMS.  The
#: kernel rounds P and dS to bf16 as product operands, the plain version
#: keeps them fp32; both round the outputs once.  The CPU tests hold the
#: plain version to the stock Pallas backward by the same bounds
#: (tests/test_torch_attention_bwd.py, 6.3e-3 and 2.6e-3 there).  D left
#: out moves dq and dk by some 5%, a key tile skipped by 10% and more, the
#: scale applied twice by 80% and more
K4_BWD_MAX = 1.5e-2
K4_BWD_RMS = 1e-2
#: K4 checks with rising logits scale k by 1 at key 0 to K4_RAMP at key
#: S - 1: each row's max then rises past the slack on later tiles, and the
#: kernel's rescale of its output and sum runs (on N(0, 1) inputs the max
#: over all keys is within the slack of the first tile's, so it never
#: does)
K4_RAMP = 8.0
#: K1 bf16, beside its elementwise bound: ||got - ref|| / ||ref|| <=
#: K1_BF16_RMS.  The plain version rounds the folded affine, the product,
#: the sum and the SiLU to bf16, the kernel once; on an H100 they differ by
#: 3.3e-3 to 4.7e-3 RMS at every shape checked here and in the card tests,
#: and faults planted in the kernel fail it (planted_faults.py).
K1_BF16_RMS = 6e-3
#: K1 bf16 is also held to the plain version's arithmetic in fp32 on the
#: same bf16 inputs: the kernel computes in fp32 and rounds once, so |got
#: - ref32| <= 2^-8 |ref32| (half a bf16 ulp) + K1_F32_SLACK * (1 +
#: |ref32|) (its fp32 arithmetic against the plain version's, as in fp32)
K1_BF16_ROUNDING = 2.0 ** -8
K1_F32_SLACK = 2e-5
#: K3 bf16 is held the same way to the plain version run in fp32 on the
#: same bf16-valued inputs, weights and bias: the kernel accumulates in
#: fp32 and rounds once, so |got - ref32| <= 2^-8 |ref32| + K3_F32_SLACK *
#: (1 + |ref32|) (its fp32 sums in another order than cuDNN's)
K3_F32_SLACK = 1e-5
#: the card's published peaks (H100 SXM data sheet, dense): HBM bytes/s,
#: and FLOP/s by the inputs' type (bf16 tensor cores, fp32 without TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
#: whole slice, card against CPU, fp32 (TF32 off): relative to max|ref|
SLICE_TOL = 1e-3
#: each family's slice clip (B, T, H, W, 3): SD3's 32x32 latent is 1024
#: tokens, the K4 threshold, which fp32 must not cross into K4
SLICE_CLIPS = {"v1": (1, 9, 64, 64, 3), "sd3": (1, 5, 256, 256, 3)}
#: each family's int8 slice clip: level 0 reaches
#: INT8_MIN_POSITIONS and runs K5 on the card, the plain version on the CPU
INT8_SLICE_CLIPS = {"v1": (1, 9, 64, 64, 3), "sd3": (1, 5, 128, 128, 3)}
#: the served clip (T, H, W)
SERVE_CLIP = (17, 720, 1280)
#: phase 6's streamed clip (T, H, W): encode windows of 17, 17 and 13
#: frames, decode windows of 5, 5 and 4 latents, so both ragged tails run
STREAM_CLIP = (45, 720, 1280)
#: the served path phase 6 streams: (variant, --dtype)
STREAM_PATH = ("v1", "int8")
#: phase 7's clip (T, H, W) for the loaded models' outputs
CKPT_CLIP = (17, 256, 256)
#: K1's shapes on the 720p paths (shape, silu, per_frame, timed in bf16):
#: encoder level 0 (SiLU), the mid-block per-frame norm (no SiLU; the one
#: shape F.group_norm also computes, as (5, 512, 14400)), a mid-block
#: ResnetBlock norm of a 720x672 tile, decoder tile level 0->1 (SiLU)
K1_CASES = [
    ((1, 17, 720, 1280, 128), True, False, True),
    ((1, 5, 90, 160, 512), False, True, True),
    ((1, 5, 90, 84, 512), True, False, False),
    ((1, 17, 720, 672, 256), True, False, False),
]
#: K1's small check cases (shape, groups, silu, per_frame), held to phase
#: 3's bounds by the card tests and by planted_faults.py
K1_CHECK_SHAPES = [
    ((2, 3, 10, 14, 64), 32, True, False),
    ((1, 5, 9, 7, 128), 32, False, True),     # per-frame, B*T = 5
    ((1, 2, 4, 4, 8), 4, True, False),
    ((1, 3, 33, 35, 512), 32, True, False),
    ((1, 7, 11, 13, 512), 32, True, False),   # ragged S: a 1-row last block
    ((1, 1, 1, 53, 128), 32, True, False),    # ragged S, four blocks
    ((1, 1, 1, 3, 128), 32, True, False),     # S below one block's rows
    ((1, 4, 30, 41, 128), 32, True, False),
    ((1, 4, 30, 41, 256), 32, False, False),
    ((1, 5, 10, 14, 512), 32, False, True),   # per-frame, B*T = 5
    ((2, 3, 5, 7, 96), 32, True, False),      # C / G = 3: narrow loads
]
#: K1's inputs have channel means from -K1_OFFSET to +K1_OFFSET ...
K1_OFFSET = 0.75
#: ... and in one more phase-3 check from -K1_WIDE_OFFSET to
#: +K1_WIDE_OFFSET, where the plain version's bf16 arithmetic is itself
#: further from fp32 arithmetic than the elementwise bound: there the
#: kernel is held to fp32 arithmetic alone
K1_WIDE_OFFSET = 8.0
#: K4's checks in phase 3, bf16 (shape, timed, rising logits): the v1
#: encoder's untiled mid-block, a 720x672 tile's mid-block (v1 decoder,
#: every SD3 tile), and a ragged S that is no multiple of any tile.  K4 is
#: bf16 only, as the reference's flash is (``ops/attention.flash_usable``)
K4_CASES = [
    ((5, 14400, 512), True, False),
    ((5, 7560, 512), True, False),
    ((1, 1100, 512), False, False),
    ((5, 7560, 512), False, True),
    ((1, 1100, 512), False, True),
]
#: fp32 attention takes the exact path; it is timed at the two mid-block
#: shapes beside SDPA fp32 (TF32 off), as a record
ATTN_FP32_SHAPES = [(5, 7560, 512), (5, 14400, 512)]
#: the edge-pad convs' checks in phase 3: (name, input (B, T, H, W, C),
#: spec constructor, output channels) -- a v1 causal conv at the 720p
#: encoder's level 0, an SD3 causal conv at a 720x672 level-0 tile, and
#: v1's two heads, which the reference gives a lowering of their own
#: (``_conv3d_small_cout``): the decoder's RGB conv_out on that tile and
#: the untiled encoder's conv_out to 2 x 4 latent channels
EDGE_CASES = [("v1_causal", (1, 17, 720, 1280, 128), "v1_causal", 128),
              ("sd3_causal", (1, 17, 720, 672, 128), "sd3_causal", 128),
              ("v1_decoder_conv_out", (1, 17, 720, 672, 128), "v1_causal", 3),
              ("v1_encoder_conv_out", (1, 5, 90, 160, 512), "v1_causal", 8)]
#: each time chunk of the fp32 reference convolves at most this many
#: elements of the materialised pad: past 2^31 (v1's 720p level-0 clip,
#: 19 x 722 x 1282 x 128 = 2.25e9) cuDNN's fp32 conv takes a slow kernel
#: (``python -m cvvae_tpu_torch.utils.profiling --edge_conv``)
EDGE_REF_CHUNK = 2 ** 30
#: fp32 (TF32 off): the decomposition against the materialised pad,
#: |d| <= EDGE_F32_TOL * (1 + |ref|); the two sum the same terms in another
#: order (the fixes' taps summed first)
EDGE_F32_TOL = 2e-5
#: bf16, the decomposition against the materialised pad, both in bf16:
#: elementwise |d| <= EDGE_BF16_ULP * |ref| + EDGE_BF16_MAG * mag, mag =
#: sum |w| |x| + |bias| over the value's terms (the materialised conv of
#: |x|, |w|, |bias|).  Away from the boundary slices both round one fp32
#: sum of the same terms once, at most one ulp (2^-7 |ref|) apart.  At the
#: boundary the decomposition also rounds the main conv, the fix's summed
#: taps, the fix and the add, each within 2^-8 of what it rounds; the mag
#: term covers these.  With the inputs of edge_inputs 2^-8 * mag is 0.15
#: of the outputs' standard deviation at Cin = 128, 0.29 at 512.  On an
#: H100 at EDGE_CASES, (|d| - 2^-7 |ref|) / mag reads at most 6.9e-4; the
#: faults of planted_faults.EDGE_FAULTS read 0.053 to 0.127
EDGE_BF16_ULP = 2.0 ** -7
EDGE_BF16_MAG = 2.0 ** -8
#: ... and ||d|| / ||ref|| <= EDGE_BF16_RMS: a few roundings in the
#: boundary slices only.  On an H100 at EDGE_CASES it reads 1.2e-3 (2 of
#: 17 frames on the boundary) to 2.3e-3 (2 of 5); on the CPU 3.5e-3 on a
#: 1x4x5 SD3 conv, where every value is on the boundary.  The faults read
#: 0.0106 (corners uncounted) to 0.36
EDGE_BF16_RMS = 5e-3
#: K2's shapes on the 720p decode path, one 720x672 tile's three upsample
#: tails (phase shape, n); the last is the largest
K2_CASES = [((1, 5, 90, 84, 1024), 2), ((1, 9, 180, 168, 512), 1),
            ((1, 9, 360, 336, 512), 2)]
#: K3's shape on the v1 path: the encoder's conv_in on the served clip
K3_SHAPE = (1, 17, 720, 1280, 3)
#: K2's small check cases (B, n, drop_first, c, bias), held bit-exact by
#: the card tests and by planted_faults.py: the scalar path (c of 4 and 20
#: bf16, 20 fp32 is vectors) and the vector path (16-byte units)
K2_CHECK_SHAPES = [
    (1, 2, True, 16, True), (2, 2, False, 24, True), (1, 1, False, 8, False),
    (1, 2, True, 256, False), (1, 2, True, 4, True), (2, 1, False, 20, True),
    (1, 2, True, 20, False), (1, 1, False, 256, True), (1, 2, True, 512, True),
    (2, 2, False, 512, False)]
#: K3's time padding kinds: (pads, modes) of a 3x3x3 conv
K3_PADS = {"edge": (((2, 0), (1, 1), (1, 1)), ("edge", "zero", "zero")),
           "zero": (((1, 1), (1, 1), (1, 1)), ("zero", "zero", "zero")),
           "none": (((0, 0), (0, 0), (0, 0)), ("zero", "zero", "zero"))}
#: K3's small check cases (padding, (B, T, H, W)), each for Cin 1-4 in the
#: card tests: W ragged against the 64-pixel tile (37, 130 = two tiles + 2,
#: 257 = 129 + a 128-pixel tile), H and T of 1, B = 2
K3_CHECK_SHAPES = [(pad, (2, t, h, w)) for pad in K3_PADS
                   for t, h, w in ((5, 19, 37), (1, 1, 130), (5, 1, 257),
                                   (1, 19, 130), (5, 19, 257))
                   if pad != "none" or min(t, h) >= 3]
#: K5's small check cases, each bf16 and fp32, held bit-equal by phase 3,
#: the card tests and planted_faults.py: (x (B, T, H, W, Cin), Cout,
#: kernel, stride, pads, modes, bias).  W ragged against the 128-pixel
#: block (37, 130, 257 at stride 2), Cout off the 128-channel block (16,
#: 24, 136), Cin 32, 40, 48, 96 (40 and 48 end in a part-filled
#: 32-channel slab, 40 on scalar loads), strides 2, every pad mode, the
#: upsample phases' (kT, 2, 2) windows
K5_CHECK_CASES = [
    ((1, 5, 7, 37, 32), 16, (3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1)), ("edge", "zero", "zero"), True),
    ((2, 4, 5, 9, 48), 24, (3, 3, 3), (1, 1, 1),
     ((1, 1), (1, 1), (1, 1)), ("edge", "edge", "edge"), True),
    ((1, 3, 6, 130, 96), 24, (3, 3, 3), (1, 1, 1),
     ((1, 1), (1, 1), (1, 1)), ("zero", "zero", "zero"), False),
    ((1, 3, 6, 9, 64), 136, (3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1)), ("edge", "edge", "edge"), True),
    ((1, 5, 9, 11, 32), 16, (3, 3, 3), (2, 2, 2),
     ((2, 0), (0, 1), (0, 1)), ("edge", "zero", "zero"), True),
    ((1, 3, 10, 257, 48), 24, (3, 3, 3), (1, 2, 2),
     ((2, 0), (0, 1), (0, 1)), ("edge", "zero", "zero"), True),
    ((1, 4, 6, 9, 40), 16, (3, 3, 3), (2, 2, 2),
     ((2, 0), (1, 1), (1, 1)), ("edge", "edge", "edge"), True),
    ((1, 2, 5, 9, 96), 16, (1, 3, 3), (1, 1, 1),
     ((0, 0), (1, 1), (1, 1)), ("zero", "zero", "zero"), True),
    ((1, 3, 5, 7, 32), 24, (3, 2, 2), (1, 1, 1),
     ((2, 0), (1, 0), (1, 0)), ("edge", "zero", "zero"), False),
    ((1, 3, 5, 7, 48), 16, (3, 2, 2), (1, 1, 1),
     ((1, 1), (0, 1), (0, 1)), ("edge", "edge", "edge"), True),
    ((1, 3, 5, 7, 96), 24, (3, 2, 2), (1, 1, 1),
     ((1, 1), (1, 0), (0, 1)), ("edge", "edge", "edge"), True),
    ((1, 3, 5, 7, 64), 16, (3, 2, 2), (1, 1, 1),
     ((1, 1), (0, 1), (1, 0)), ("edge", "zero", "zero"), True),
]
#: K5_CHECK_CASES also run with x on half steps of scale_x (k5_inputs)
K5_HALF_STEP_CASES = (0, 1, 3)
#: K5 at the int8 paths' shapes, bf16 (name, x, Cout, kernel, stride,
#: pads, modes): the v1 encoder's level-0 causal conv, an SD3 720x672
#: tile's, the v1 encoder's first downsample, and the largest upsample
#: phase conv (a v1 decoder tile's level 2 -> 1, 512 = 2 x 256 outputs)
K5_PATH_SHAPES = [
    ("v1_causal", (1, 17, 720, 1280, 128), 128, (3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1)), ("edge", "zero", "zero")),
    ("sd3_causal", (1, 17, 720, 672, 128), 128, (3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1)), ("edge", "edge", "edge")),
    ("v1_downsample", (1, 17, 720, 1280, 128), 128, (3, 3, 3), (2, 2, 2),
     ((2, 0), (0, 1), (0, 1)), ("edge", "zero", "zero")),
    ("upsample_phase", (1, 9, 360, 336, 256), 512, (3, 2, 2), (1, 1, 1),
     ((1, 1), (1, 0), (1, 0)), ("edge", "zero", "zero")),
]
#: output frames of K5's path shapes held to the plain version, whose
#: float64 sums would not fit the card at every frame: the first 3 and the
#: last 2, which hold every time boundary and the largest offsets
K5_HEAD_FRAMES, K5_TAIL_FRAMES = 3, 2
#: the int8 slice, card against CPU in fp32: PSNR of the frames, in dB,
#: with the data range tests/test_quant.py takes, 2 max|ref| (a random
#: net's frames are not bounded to [-1, 1]).  K5 is bit-equal to the CPU's
#: plain version; the rest of the net rounds in another order on the card,
#: and a value moved across a rounding step of an int8 quantizer moves by
#: a whole step, which the net carries on
INT8_SLICE_PSNR = 40.0
#: the served int8 /reconstruct against the served bf16 one, PSNR in dB
#: (ROADMAP's gate for int8 serving), taken as the reference's bench.py
#: takes it: on the frames before the uint8 cast, over 2 max|bf16 frames|.
#: A random net's frames reach +-3.4, past the [-1, 1] the uint8 bytes
#: keep, so the bytes' PSNR over 255 reads about 10.6 dB less
INT8_SERVE_PSNR = 35.0
#: each served path: (variant, --dtype) -> (latent channels, the kernels
#: it must launch)
PATHS = {("v1", "bf16"): (4, ("K1", "K2", "K3", "K4")),
         ("sd3", "bf16"): (16, ("K1", "K2", "K4")),
         ("v1", "int8"): (4, ("K1", "K2", "K3", "K4", "K5", "K5.stage")),
         ("sd3", "int8"): (16, ("K1", "K2", "K4", "K5", "K5.stage"))}

KERNELS = {
    "K1": dict(name="group_norm_silu", route="cuda",
               source="cvvae_tpu_torch/csrc/groupnorm.cu",
               replaces="cvvae_tpu/ops/pallas/groupnorm.py:90"),
    "K2": dict(name="subpixel_interleave", route="cuda",
               source="cvvae_tpu_torch/csrc/shuffle.cu",
               replaces="cvvae_tpu/ops/pallas/shuffle.py:148"),
    "K3": dict(name="stem_conv3d", route="cuda",
               source="cvvae_tpu_torch/csrc/stem.cu",
               replaces="cvvae_tpu/ops/pallas/stem.py:209"),
    "K4": dict(name="flash_attention", route="cuda",
               source="cvvae_tpu_torch/csrc/attention.cu",
               replaces="cvvae_tpu/ops/attention.py:60"),
    # no Pallas kernel: the int8 conv XLA computes for the reference; its
    # timed numbers are stage + GEMM (conv3d_int8), its launches the GEMM's
    "K5": dict(name="conv3d_int8", route="cuda",
               source="cvvae_tpu_torch/csrc/conv_int8.cu",
               replaces="cvvae_tpu/ops/quant.py:256"),
    # K5's staging pass: the reference's quantize_act_static and its edge
    # pad on the int8 tensor (XLA)
    "K5.stage": dict(name="int8_stage", route="cuda",
                     source="cvvae_tpu_torch/csrc/conv_int8.cu",
                     replaces="cvvae_tpu/ops/quant.py:75"),
    # K1 split across the ranks of a mesh (phase 11): one rank's partial
    # moments (gn_stats, gn_partial), then, after the all-gather, their
    # combination and the apply (gn_combine, gn_apply); the TPU kernel is
    # K1's, whose statistics XLA's partitioner sums across chips
    "K1.partial": dict(name="group_norm_partial", route="cuda",
                       source="cvvae_tpu_torch/csrc/groupnorm.cu",
                       replaces="cvvae_tpu/ops/pallas/groupnorm.py:90"),
    "K1.combine": dict(name="group_norm_combine", route="cuda",
                       source="cvvae_tpu_torch/csrc/groupnorm.cu",
                       replaces="cvvae_tpu/ops/pallas/groupnorm.py:90"),
    # the backward kernels of the training path: the reference leaves both
    # gradients to XLA's autodiff of the functions K1 and K2 compute
    "K1.bwd": dict(name="group_norm_silu_backward", route="cuda",
                   source="cvvae_tpu_torch/csrc/groupnorm_bwd.cu",
                   replaces="cvvae_tpu/ops/pallas/groupnorm.py:90"),
    "K2.bwd": dict(name="subpixel_interleave_backward", route="cuda",
                   source="cvvae_tpu_torch/csrc/shuffle_bwd.cu",
                   replaces="cvvae_tpu/ops/pallas/shuffle.py:148"),
    # no Pallas kernel: the reference's gradient of the stem conv is XLA's
    # autodiff of its stacked-stem lowering
    "K3.bwd": dict(name="stem_conv3d_backward", route="cuda",
                   source="cvvae_tpu_torch/csrc/stem_bwd.cu",
                   replaces="cvvae_tpu/ops/conv.py:234"),
    # the stock flash attention's backward: its custom_vjp's two Pallas
    # kernels, _flash_attention_bwd_dkv (pallas_call
    # jax/experimental/pallas/ops/tpu/flash_attention.py:1121) and
    # _flash_attention_bwd_dq (:1456), which cvvae_tpu/ops/attention.py:82
    # reaches
    "K4.bwd": dict(name="flash_attention_backward", route="cuda",
                   source="cvvae_tpu_torch/csrc/attention_bwd.cu",
                   replaces="cvvae_tpu/ops/attention.py:82"),
    # the int8-resident mode (phase 13; cvvae_tpu/ops/qflow.py, whose
    # functions XLA computes, no Pallas kernel): K5 from an int8 input to
    # an int8 output, its timed numbers stage + GEMM, its launches the
    # GEMM's with an int8 output; K1's int8 mode; K6's residual add and
    # requantization
    "K5.int8": dict(name="conv3d_int8_resident", route="cuda",
                    source="cvvae_tpu_torch/csrc/conv_int8.cu",
                    replaces="cvvae_tpu/ops/qflow.py:79"),
    "K1.int8": dict(name="group_norm_silu_int8", route="cuda",
                    source="cvvae_tpu_torch/csrc/groupnorm.cu",
                    replaces="cvvae_tpu/ops/qflow.py:138"),
    "K6": dict(name="qadd", route="cuda",
               source="cvvae_tpu_torch/csrc/qflow.cu",
               replaces="cvvae_tpu/ops/qflow.py:175"),
    "K6.requant": dict(name="requant", route="cuda",
                       source="cvvae_tpu_torch/csrc/qflow.cu",
                       replaces="cvvae_tpu/ops/qflow.py:69"),
}
#: each kernel's dtype whose timed entry with the largest bound gives the
#: kernels line its top-level numbers (bf16 where none is named): the
#: int8-resident modes' int8 outputs, K6.requant's bf16 input
MAIN_DTYPES = {"K5.int8": "int8", "K1.int8": "int8", "K6": "int8"}


def kernel_modules():
    from cvvae_tpu_torch.ops.kernels import (attention, conv_int8, groupnorm,
                                             qflow, shuffle, stem)
    return {"K1": groupnorm, "K2": shuffle, "K3": stem, "K4": attention,
            "K5": conv_int8, "K6": qflow}


#: each kernel's launch counter: (its module's key, the attribute)
COUNTERS = {**{k: (k, "launches") for k in ("K1", "K2", "K3", "K4", "K5")},
            "K5.stage": ("K5", "stage_launches"),
            "K1.partial": ("K1", "partial_launches"),
            "K1.combine": ("K1", "combine_launches"),
            "K1.bwd": ("K1", "bwd_launches"),
            "K2.bwd": ("K2", "bwd_launches"),
            "K3.bwd": ("K3", "bwd_launches"),
            "K4.bwd": ("K4", "bwd_launches"),
            "K5.int8": ("K5", "int8_out_launches"),
            "K1.int8": ("K1", "int8_launches"),
            "K6": ("K6", "qadd_launches"),
            "K6.requant": ("K6", "requant_launches")}


def launch_counts():
    mods = kernel_modules()
    return {k: getattr(mods[m], attr) for k, (m, attr) in COUNTERS.items()}


def reset_launch_counts():
    mods = kernel_modules()
    for m, attr in COUNTERS.values():
        setattr(mods[m], attr, 0)
    mods["K1"].bwd_launches_by_shape.clear()


def say(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def randn(shape, seed, device, dtype, scale=1.0, shift=0.0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return (x * scale + shift).to(dtype)


def k1_inputs(shape, dev, dtype, offset=K1_OFFSET):
    """x, weight, bias of a K1 check: x ~ N(o_c, s_c^2), its mean o_c
    running from -offset to +offset and its scale s_c from 1 to 3 over
    the channels, so the groups' statistics differ and a kernel that
    applies one group's to another fails."""
    c = shape[-1]
    scale = torch.linspace(1.0, 3.0, c, device=dev)
    shift = torch.linspace(-offset, offset, c, device=dev)
    x = (randn(shape, 1, dev, torch.float32) * scale + shift).to(dtype)
    return (x, randn((c,), 2, dev, torch.float32, 0.5, 1.0),
            randn((c,), 3, dev, torch.float32, 0.5))


def k2_inputs(b, n, c, with_bias, dev, dtype):
    """Four (B, 3, 5, 7, n*c) phases and an (n*c,) bias (or None), N(0, 1),
    with one -0 in the first phase (a pure copy keeps it)."""
    phases = [randn((b, 3, 5, 7, n * c), 50 + i, dev, dtype) for i in range(4)]
    phases[0].view(-1)[0] = -0.0
    return phases, (randn((n * c,), 59, dev, dtype) if with_bias else None)


def k5_inputs(shape, cout, kernel, dev, dtype, with_bias=True, seed=60,
              half_steps=False):
    """x ~ N(0, 1) in ``dtype``, an int8 kernel (cout, Cin, *kernel)
    uniform on [-127, 127], per-channel scales around 1/127, scale_x
    3/127 (so |x| > 3 clips) and a bias of scale 0.1 (or None).  With
    ``half_steps``, x holds (k + 1/2) / 32 for k in [-130, 130) and scale_x
    is 1/32, so x / scale_x falls on half-integers, where K5 takes its
    division and rounds half to even."""
    g = torch.Generator(device=dev).manual_seed(seed)
    wq = torch.randint(-127, 128, (cout, shape[-1]) + tuple(kernel),
                       generator=g, device=dev, dtype=torch.int8)
    scale_w = (torch.rand(cout, generator=g, device=dev) + 0.5) / 127
    if half_steps:
        k = torch.randint(-130, 130, shape, generator=g, device=dev)
        x, scale_x = ((k + 0.5) / 32).to(dtype), 1 / 32
    else:
        x, scale_x = randn(shape, seed + 1, dev, dtype), 3.0 / 127
    return (x, wq, scale_w, torch.tensor(scale_x, device=dev),
            randn((cout,), seed + 2, dev, torch.float32, 0.1)
            if with_bias else None)


def k5_check_cases():
    """(index, half_steps, case) of K5's small checks: every case of
    K5_CHECK_CASES, and those of K5_HALF_STEP_CASES again on half steps."""
    for i, case in enumerate(K5_CHECK_CASES):
        yield i, False, case
    for i in K5_HALF_STEP_CASES:
        yield i, True, K5_CHECK_CASES[i]


def k5_frames(x, kernel, stride, pads, modes, first, last):
    """The input frames and time pads from which output frames [first,
    last) of the conv come out as output frames [0, last - first): the
    frames they read, their edge repeats gathered and their zero pads
    kept as pads."""
    (lo, hi), k, s = pads[0], kernel[0], stride[0]
    t = x.shape[1]
    start, stop = first * s - lo, (last - 1) * s - lo + k
    if modes[0] == "edge":
        idx = torch.arange(start, stop, device=x.device).clamp(0, t - 1)
        return x.index_select(1, idx), (0, 0)
    return (x[:, max(start, 0):min(stop, t)],
            (max(-start, 0), max(stop - t, 0)))


def k2_exact(got, ref):
    """Bit-identical, -0 and NaN payloads included."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got.view(view), ref.view(view))


def k3_spec(pad):
    from cvvae_tpu_torch.ops.conv import Conv3DSpec

    pads, modes = K3_PADS[pad]
    return Conv3DSpec((3, 3, 3), (1, 1, 1), pads, modes)


def k3_inputs(shape, cin, dev, dtype):
    """x in [-1, 1] (pixels), weights of scale 1/9 and a bias of 0.1."""
    x = randn(tuple(shape) + (cin,), 30, dev, dtype).clamp(-1, 1)
    return (x, randn((128, cin, 3, 3, 3), 31, dev, dtype, 1 / 9),
            randn((128,), 32, dev, dtype, 0.1))


def k4_inputs(shape, dev, dtype, rising=False):
    """q, k, v of a K4 check, N(0, 1); with ``rising``, k's rows scaled
    from 1 to K4_RAMP along S, so the logits grow from key to key."""
    q, k, v = (randn(shape, 40 + i, dev, dtype) for i in range(3))
    if rising:
        ramp = torch.linspace(1.0, K4_RAMP, shape[1], device=dev)
        k = (k.float() * ramp[:, None]).to(dtype)
    return q, k, v


def k4_lse_check(got, ref):
    """(max |got - ref|, excess, text) of K4's logsumexp against its plain
    version: |got - ref| <= K4_LSE_TOL * (1 + |ref|)."""
    err, excess, ref_max, _ = compare(got, ref, K4_LSE_TOL)
    return err, excess, (f"lse max|ref|={ref_max!r} tol={K4_LSE_TOL}*(1+"
                         f"|ref|)")


def compare(got, ref, tol=0.0, rtol=None):
    """(max |got - ref|, max of |got - ref| - (tol + rtol * |ref|), max
    |ref|, ||got - ref|| / ||ref||), taken over 2^26-element slices so no
    full-size fp32 temporary exists; ``rtol`` defaults to ``tol``.  A
    non-finite output is an infinite error."""
    if not torch.isfinite(got).all():
        return (float("inf"),) * 4
    rtol = tol if rtol is None else rtol
    g, r = got.reshape(-1), ref.reshape(-1)
    err = excess = ref_max = d2 = r2 = 0.0
    for i in range(0, g.numel(), 1 << 26):
        a, b = g[i:i + (1 << 26)].double(), r[i:i + (1 << 26)].double()
        d = (a - b).abs()
        err = max(err, d.max().item())
        excess = max(excess, (d - tol - rtol * b.abs()).max().item())
        ref_max = max(ref_max, b.abs().max().item())
        d2 += d.square().sum().item()
        r2 += b.square().sum().item()
    return err, excess, ref_max, (d2 / r2) ** 0.5


def k1_check(got, x, w, b, hold_plain=True, **kw):
    """Hold ``got``, K1's output for (x, w, b, **kw), to its bounds:
    (max |got - ref|, excess, text); the check fails where excess > 0.

    fp32: |got - ref| <= 1e-5 * (1 + |ref|), ref the plain version.  bf16:
    where ``hold_plain``, |got - ref| <= 2e-2 * (1 + |ref|) and ||got -
    ref|| / ||ref|| <= K1_BF16_RMS; and always one rounding of the plain
    version's fp32 arithmetic on the same inputs, ref32: |got - ref32| <=
    K1_BF16_ROUNDING * |ref32| + K1_F32_SLACK * (1 + |ref32|).  The text
    also gives the plain version's bf16 arithmetic against ref32, by the
    elementwise bound and the RMS ratio."""
    from cvvae_tpu_torch.ops.kernels.groupnorm import group_norm_silu_plain

    tol = TOL[("K1", x.dtype)]
    ref = group_norm_silu_plain(x, w, b, **kw)
    err, excess, _, rms = compare(got, ref, tol)
    text = f"tol={tol!r}*(1+|ref|) rms={rms!r}"
    if x.dtype == torch.float32:
        return err, excess, text
    if hold_plain:
        excess = max(excess, rms - K1_BF16_RMS)
        text += f" (<= {K1_BF16_RMS})"
    else:
        excess = -math.inf
        text += " (not held)"
    ref32 = group_norm_silu_plain(x.float(), w, b, **kw)
    err32, excess32, _, rms32 = compare(got, ref32, K1_F32_SLACK,
                                        K1_BF16_ROUNDING + K1_F32_SLACK)
    _, p_excess, _, p_rms = compare(ref, ref32, tol)
    text += (f"; against fp32 arithmetic: max_abs_err={err32!r}, excess "
             f"over 2^-8*|ref32|+{K1_F32_SLACK}*(1+|ref32|) {excess32!r}, "
             f"rms={rms32!r}; the plain version's bf16 arithmetic against "
             f"it: excess over {tol}*(1+|ref32|) {p_excess!r}, "
             f"rms={p_rms!r}")
    return (err if hold_plain else err32), max(excess, excess32), text


def k3_check(got, x, w, b, spec):
    """(max |got - ref|, excess, text) of K3's output for (x, w, b, spec);
    the check fails where excess > 0.  Against the plain version in the
    same dtype, |d| <= TOL[K3] * (1 + |ref|); in bf16 also within one
    rounding of the plain version's fp32 arithmetic on the same values,
    |got - ref32| <= 2^-8 |ref32| + K3_F32_SLACK * (1 + |ref32|)."""
    from cvvae_tpu_torch.ops.kernels.stem import stem_conv3d_plain

    tol = TOL[("K3", x.dtype)]
    ref = stem_conv3d_plain(x, w, b, spec)
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return math.inf, math.inf, f"output {tuple(got.shape)} {got.dtype}"
    err, excess = compare(got, ref, tol)[:2]
    del ref
    text = f"excess over {tol!r}*(1+|ref|) {excess!r}"
    if x.dtype == torch.float32:
        return err, excess, text
    ref32 = stem_conv3d_plain(x.float(), w.float(),
                              None if b is None else b.float(), spec)
    err32, excess32 = compare(got, ref32, K3_F32_SLACK,
                              K1_BF16_ROUNDING + K3_F32_SLACK)[:2]
    text += (f"; against fp32 arithmetic: max_abs_err={err32!r}, excess "
             f"over 2^-8*|ref32|+{K3_F32_SLACK}*(1+|ref32|) {excess32!r}")
    return err, max(excess, excess32), text


def k4_check(got, ref):
    """(max |got - ref|, excess, text) of K4's output against its plain
    version; the check fails where excess > 0: max |d| <= K4_BF16_MAX *
    max |ref| and ||d|| / ||ref|| <= K4_BF16_RMS."""
    err, _, ref_max, rms = compare(got, ref)
    return (err, max(err - K4_BF16_MAX * ref_max, rms - K4_BF16_RMS),
            f"max|ref|={ref_max!r} rms={rms!r} tol={K4_BF16_MAX}*max|ref| "
            f"and rms {K4_BF16_RMS}")


def edge_check(got, ref, mag):
    """(max |got - ref|, excess, text) of an edge-pad decomposition's
    output ``got`` against the materialised pad's ``ref``; the check fails
    where excess > 0.  fp32: |d| <= EDGE_F32_TOL * (1 + |ref|).  bf16: |d|
    <= EDGE_BF16_ULP * |ref| + EDGE_BF16_MAG * ``mag``, ``mag`` the
    magnitude of each value's terms (sum |w| |x| + |bias|), and ||d|| /
    ||ref|| <= EDGE_BF16_RMS.  Taken over 2^26-element slices."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return math.inf, math.inf, f"output {tuple(got.shape)} {got.dtype}"
    if got.dtype == torch.float32:
        err, excess = compare(got, ref, EDGE_F32_TOL)[:2]
        return err, excess, f"tol={EDGE_F32_TOL!r}*(1+|ref|)"
    if not torch.isfinite(got).all():
        return math.inf, math.inf, "non-finite output"
    g, r, m = got.reshape(-1), ref.reshape(-1), mag.reshape(-1)
    err = excess = worst = d2 = r2 = 0.0
    for i in range(0, g.numel(), 1 << 26):
        a, b, c = (t[i:i + (1 << 26)].double() for t in (g, r, m))
        d = (a - b).abs()
        over = d - EDGE_BF16_ULP * b.abs()
        err = max(err, d.max().item())
        excess = max(excess, (over - EDGE_BF16_MAG * c).max().item())
        worst = max(worst, (over / c).max().item())
        d2 += d.square().sum().item()
        r2 += b.square().sum().item()
    rms = (d2 / r2) ** 0.5
    return err, max(excess, rms - EDGE_BF16_RMS), (
        f"tol=2^-7*|ref|+2^-8*(sum|w||x|+|bias|): largest (|d|-2^-7*|ref|)"
        f"/(sum|w||x|+|bias|) {worst!r}; rms={rms!r} (<= {EDGE_BF16_RMS})")


def edge_inputs(shape, cout, dev, dtype):
    """x, weight, bias of an edge-conv check: x ~ N(0, 1), a 3x3x3 weight
    (cout, C, 3, 3, 3) ~ N(0, 1/(81 C)) (outputs of variance 1/3) and a
    bias of scale 0.1."""
    c = shape[-1]
    return (randn(shape, 70, dev, dtype),
            randn((cout, c, 3, 3, 3), 71, dev, dtype, (3 * 27 * c) ** -0.5),
            randn((cout,), 72, dev, dtype, 0.1))


def edge_paths(spec, conv=None):
    """{path: fn(x, weight, bias)} of the conv ``spec`` (B,T,H,W,C) ->
    contiguous (B,T',H',W',O): the materialised pad, the time-axis
    decomposition where the reference takes it (edge time, zero space) and
    the all-axes one; ``conv`` is the module that holds them (by default
    ``cvvae_tpu_torch.ops.conv``)."""
    if conv is None:
        from cvvae_tpu_torch.ops import conv

    zero = [p if m == "zero" else (0, 0) for p, m in zip(spec.pads, spec.modes)]
    paths = {"materialised": lambda x, w, b: conv._window_conv(
        conv._edge_pad(x, spec.pads, spec.modes), w, zero, spec.stride,
        b).contiguous()}
    if spec.modes == ("edge", "zero", "zero"):
        paths["time_fast"] = lambda x, w, b: conv._conv3d_edge_time_fast(
            x, w, spec, bias=b).contiguous()
    paths["edge_fast"] = lambda x, w, b: conv._conv3d_edge_fast(
        x, w, spec, bias=b).contiguous()
    return paths


def edge_reference(x, w, b, spec, conv=None):
    """The materialised-pad conv of ``spec`` (``edge_paths``'s
    "materialised"), computed over overlapping time chunks of the padded
    input of at most EDGE_REF_CHUNK elements each: every output frame sums
    the same terms as the whole conv's.  The time axis must carry no zero
    pad (the edge time pads are materialised)."""
    if conv is None:
        from cvvae_tpu_torch.ops import conv

    zero = [p if m == "zero" else (0, 0) for p, m in zip(spec.pads, spec.modes)]
    if zero[0] != (0, 0):
        raise ValueError("edge_reference: a zero time pad")
    padded = conv._edge_pad(x, spec.pads, spec.modes)
    kt, st = spec.kernel[0], spec.stride[0]
    t_out = (padded.shape[1] - kt) // st + 1
    frame = padded[:, :1].numel()
    step = max(1, (EDGE_REF_CHUNK // frame - kt) // st + 1)
    out = [conv._window_conv(padded[:, a * st:(min(a + step, t_out) - 1) * st
                                    + kt], w, zero, spec.stride,
                             b).contiguous()
           for a in range(0, t_out, step)]
    del padded
    return torch.cat(out, dim=1)


def k4_max_raises(q, k, scale, block=512):
    """Tiles after the first on which the bf16 kernel raises a row's
    running max, a mean over the rows: csrc/attention.cu's rule (32-key
    tiles, logits in log2 units, raised where a tile's max exceeds the
    running one by more than K4_SLACK_LOG2) on these inputs' fp32
    logits.  Where it is 0, the kernel's rescale never runs."""
    b, s, _ = q.shape
    n = -(-s // 32)
    kf = k.float().transpose(1, 2)
    raises = torch.zeros((), device=q.device)
    for i in range(0, s, block):
        lg = torch.matmul(q[:, i:i + block].float(), kf)
        lg = torch.nn.functional.pad(lg * (scale * math.log2(math.e)),
                                     (0, n * 32 - s), value=-math.inf)
        tile_max = lg.reshape(b, lg.shape[1], n, 32).amax(-1)
        m = tile_max[..., 0]
        for j in range(1, n):
            up = tile_max[..., j] > m + K4_SLACK_LOG2
            raises += up.sum()
            m = torch.where(up, tile_max[..., j], m)
    return raises.item() / (b * s)


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of one call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


#: traces ``device_ms`` takes before it gives up on a trace that holds no
#: device record at all (the profiler lost every one of 40 calls' records
#: once on an H100)
DEVICE_MS_TRACES = 3


def device_ms(fn, reps: int = 20) -> float:
    """The device ms of one call of ``fn``: ``torch.profiler``'s device
    records over 2 ``reps`` calls; for each kernel the median duration of
    its later half (a trace can lose records near its start), times its
    launches a call (at least one), summed.  A trace with no device record
    is taken again, up to DEVICE_MS_TRACES traces."""
    from cvvae_tpu_torch.utils import profiling

    for _ in range(DEVICE_MS_TRACES):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in sorted(profiling.kernel_events(prof),
                        key=lambda e: e.time_range.start):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if by_name:
            return sum(statistics.median(t[len(t) // 2:])
                       * max(1, round(len(t) / (2 * reps)))
                       for t in by_name.values()) / 1e3
    raise SystemExit(f"device_ms: {DEVICE_MS_TRACES} traces of {2 * reps} "
                     f"calls held no device record")


def host_ms(fn, reps: int = 20) -> float:
    """The host's ms to issue one call of ``fn``: the wall time of ``reps``
    calls without a synchronise, each call's kernels queued behind the
    last's, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def turns(fns):
    """{name: median ms} of ``fns`` timed in turns, forward then back
    (a, b, c, c, b, a)."""
    names = list(fns) + list(fns)[::-1]
    times = {n: [] for n in fns}
    for n in names:
        times[n].append(time_ms(fns[n]))
    return {n: statistics.median(t) for n, t in times.items()}


def in_turns(plain, kernel, library=None):
    """plain, kernel, kernel, plain[, library, library] -> (kernel ms,
    plain ms, library ms or None)."""
    ms = turns({"plain": plain, "kernel": kernel})
    lib = (statistics.median([time_ms(library), time_ms(library)])
           if library else None)
    return ms["kernel"], ms["plain"], lib


def work(key, shape, dtype, n=2, silu=True, cout=128, kernel=None,
         stride=None, pads=None, per_frame=False):
    """(bytes, FLOP) of one call of kernel ``key`` at ``shape``: each
    input read once and each output written once; FLOP as the function
    needs them.

    K1 shape (B, T, H, W, C): x in, y out, fp32 weight and bias; 3 FLOP an
    element for the moments, 2 for the affine, 4 more with SiLU.  K1 split
    across ranks, on one rank's rows: K1.partial reads x and writes its
    (count, mean, M2) per (row, group) in double, a row a frame where
    ``per_frame``, 3 FLOP an element; K1.combine reads x and the ``n``
    ranks' moments and writes y, 2 FLOP an element and 4 more with SiLU.  K2
    shape: one of the four phases (B, T, H, W, n*c); where n > 1 the
    output drops the first of its n*T frames; one add an output element.  K3 shape (B, T,
    H, W, Cin) -> ``cout`` channels at the same extent; 2*27*Cin FLOP an
    output element.  K3.bwd shape x (B, T, H, W, Cin), dy at the same extent
    with ``cout`` channels: x and dy in, dW and dbias out; 2*27*Cin FLOP a
    dy element.  K4 shape (B, S, D): q, k, v in, out out; 4*B*S^2*D
    FLOP.  K4.bwd shape (B, S, D): q, k, v, o and dO in, dq, dk and dv
    out, and each row's fp32 logsumexp and D; 10*B*S^2*D FLOP (the logits,
    dO*V^T, dV, dK and dQ products).  K5 shape (B, T, H, W, Cin), a ``kernel`` at ``stride`` with
    ``pads`` to ``cout`` channels: x in and the output out in x's dtype,
    the int8 kernel, fp32 scales and bias; 2*taps*Cin int8 operations an
    output element.  K5.stage shape (B, T, H, W, Cin) with ``pads`` and
    the W ``stride``: x in, the staged int8 tensor out
    (``conv_int8.staged_shape``); one division an input value.  The
    int8-resident modes (``dtype`` their output's, or K6.requant's
    input's): K5.int8 as K5 with x int8; K1.int8 shape (B, T, H, W, C): x
    int8 in, y out, 12 fp32 operations an element (dequantize, two
    moments, the affine, SiLU, requantize); K6 (qadd): two int8 tensors in
    and one out, 4 operations an element; K6.requant: x in, int8 out, one
    division an element."""
    e = torch.tensor([], dtype=dtype).element_size()
    numel = math.prod(shape)
    if key == "K1":
        return 2 * numel * e + 2 * shape[-1] * 4, numel * (5 + 4 * silu)
    rows = shape[0] * (shape[1] if per_frame else 1)  # K1's batch rows
    if key == "K1.partial":  # x in, (count, mean, M2) per (row, group) out
        return numel * e + 3 * 8 * rows * 32, 3 * numel
    if key == "K1.combine":  # x, the moments, fp32 weight and bias in; y out
        return (2 * numel * e + n * 3 * 8 * rows * 32 + 2 * shape[-1] * 4,
                numel * (2 + 4 * silu))
    if key == "K2":  # the first frame is dropped where n > 1
        out = 4 * numel * (shape[1] * n - (n > 1)) // (shape[1] * n)
        return (4 * numel + out) * e + shape[-1] * e, out
    if key == "K1.bwd":  # x and dy in, dx out; the dz and dz*xh sums
        return 3 * numel * e + 4 * shape[-1] * 4, numel * (8 + 6 * silu)
    if key == "K2.bwd":  # dy in, the four phases out; the bias sums
        out = 4 * numel * (shape[1] * n - (n > 1)) // (shape[1] * n)
        return (4 * numel + out) * e + shape[-1] * 4, out
    if key == "K3":
        out = numel // shape[-1] * cout
        w = 27 * shape[-1] * cout + cout
        return (numel + out + w) * e, out * 2 * 27 * shape[-1]
    if key == "K3.bwd":  # x and dy in, dW and dbias out; same extents
        out = numel // shape[-1] * cout
        w = 27 * shape[-1] * cout + cout
        return (numel + out + w) * e, out * 2 * 27 * shape[-1]
    if key == "K4":
        b, s, d = shape
        return 4 * b * s * d * e, 4 * b * s * s * d
    if key == "K4.bwd":
        b, s, d = shape
        return 8 * b * s * d * e + 2 * b * s * 4, 10 * b * s * s * d
    if key == "K5":
        from cvvae_tpu_torch.ops.kernels.conv_int8 import out_extents
        out = math.prod(out_extents(shape, kernel, stride, pads)) \
            * shape[0] * cout
        taps = math.prod(kernel)
        return ((numel + out) * e + cout * shape[-1] * taps + 8 * cout,
                out * 2 * shape[-1] * taps)
    if key == "K5.stage":
        from cvvae_tpu_torch.ops.kernels.conv_int8 import staged_shape
        return (numel * e + math.prod(staged_shape(shape, pads, stride[2]))
                + 4, numel)
    if key == "K5.int8":  # int8 x in, the output in ``dtype``
        from cvvae_tpu_torch.ops.kernels.conv_int8 import out_extents
        out = math.prod(out_extents(shape, kernel, stride, pads)) \
            * shape[0] * cout
        taps = math.prod(kernel)
        return (numel + out * e + cout * shape[-1] * taps + 12 * cout,
                out * 2 * shape[-1] * taps)
    if key == "K1.int8":  # int8 x in, y out in ``dtype``; fp32 scales
        return numel + numel * e + 3 * shape[-1] * 4, 12 * numel
    if key == "K6":  # two int8 tensors in, int8 out; fp32 scales
        return 3 * numel + 3 * shape[-1] * 4, 4 * numel
    if key == "K6.requant":  # x in ``dtype``, int8 out
        return numel * e + numel + shape[-1] * 4, numel
    raise KeyError(key)


def bound(key, shape, dtype, **kw):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the FLOP over the peak for the inputs' type (K5's products
    are int8 whatever x's dtype; K5.stage's divisions fp32)."""
    nbytes, flop = work(key, shape, dtype, **kw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = PEAK_FLOPS[{"K5": torch.int8, "K5.int8": torch.int8}.get(
        key, torch.float32 if key in ("K5.stage", "K1.int8", "K6",
                                      "K6.requant") else dtype)]
    t_ops = flop / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _check_kernels(dev):
    from cvvae_tpu_torch.ops.conv import Conv3DSpec
    from cvvae_tpu_torch.ops.kernels import attention, groupnorm, shuffle, stem

    summary = {k: {"max_abs_err": 0.0, "timed": []} for k in KERNELS}

    def record(key, label, err, excess, tol_text, timing=None, extra=None):
        """Print one check; fail it where ``excess`` > 0.  ``timing`` is
        (shape, dtype, kernel ms, plain ms, library ms, work kwargs);
        ``extra`` more fields of the timed entry."""
        ok = excess <= 0.0
        line = f"[kernels] {key} {label}: max_abs_err={err!r} {tol_text}"
        if timing:
            shape, dtype, k_ms, p_ms, lib_ms, kw = timing
            b_ms, by = bound(key, shape, dtype, **kw)
            summary[key]["timed"].append(dict(
                shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                share=b_ms / k_ms, library_ms=lib_ms, **(extra or {})))
            line += (f" kernel_ms={k_ms!r} plain_ms={p_ms!r} "
                     f"library_ms={lib_ms!r} bound_ms={b_ms!r} ({by}) "
                     f"share={b_ms / k_ms!r}")
            line += "".join(f" {k}={v!r}" for k, v in (extra or {}).items())
        say(f"{line} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{key} {label}: disagrees with its plain "
                             f"version (max_abs_err {err}; {tol_text})")
        summary[key]["max_abs_err"] = max(summary[key]["max_abs_err"], err)

    # K1 at the shapes of K1_CASES; bf16 is timed at the first two
    for dtype in (torch.bfloat16, torch.float32):
        for shape, silu, per_frame, timed in K1_CASES:
            c = shape[-1]
            x, w, b = k1_inputs(shape, dev, dtype)
            kw = dict(num_groups=32, eps=1e-5, silu=silu, per_frame=per_frame)
            got = groupnorm.group_norm_silu(x, w, b, **kw)
            torch.cuda.synchronize()
            if got.shape != x.shape or got.dtype != dtype:
                raise SystemExit(f"K1 output {tuple(got.shape)} {got.dtype}")
            err, excess, tol_text = k1_check(got, x, w, b, **kw)
            if shape == K1_CASES[0][0]:
                same = torch.equal(got,
                                   groupnorm.group_norm_silu(x, w, b, **kw))
                tol_text += f" bit-identical across two calls: {same}"
                if not same:
                    excess = float("inf")
            del got
            timing = None
            if timed and dtype == torch.bfloat16:
                lib = None
                if per_frame and not silu:  # as (B*T, C, H*W)
                    xt = x.reshape(-1, math.prod(shape[2:-1]), c)
                    lib = functools.partial(
                        torch.nn.functional.group_norm,
                        xt.transpose(1, 2).contiguous(), 32, w.to(dtype),
                        b.to(dtype), 1e-5)
                k_ms, p_ms, l_ms = in_turns(
                    lambda: groupnorm.group_norm_silu_plain(x, w, b, **kw),
                    lambda: groupnorm.group_norm_silu(x, w, b, **kw), lib)
                timing = (shape, dtype, k_ms, p_ms, l_ms, dict(silu=silu))
                del lib
            record("K1", f"{tuple(shape)} {dtype} silu={silu} "
                   f"per_frame={per_frame}", err, excess, tol_text, timing)
            del x
            torch.cuda.empty_cache()
    # K1 at wide channel offsets, held to fp32 arithmetic alone
    shape, silu, per_frame, _ = K1_CASES[1]
    x, w, b = k1_inputs(shape, dev, torch.bfloat16, K1_WIDE_OFFSET)
    kw = dict(num_groups=32, eps=1e-5, silu=silu, per_frame=per_frame)
    got = groupnorm.group_norm_silu(x, w, b, **kw)
    torch.cuda.synchronize()
    err, excess, tol_text = k1_check(got, x, w, b, hold_plain=False, **kw)
    record("K1", f"{tuple(shape)} {torch.bfloat16} silu={silu} per_frame="
           f"{per_frame} channel means +-{K1_WIDE_OFFSET}", err, excess,
           tol_text)
    del x, got
    torch.cuda.empty_cache()

    # K2: the three upsample tails of one 720x672 decoder tile, each timed
    # in bf16; no one PyTorch call computes it (a permutation plus a bias
    # add)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, n in K2_CASES:
            if dtype == torch.float32 and shape == K2_CASES[-1][0]:
                continue  # the path runs bf16; fp32 is checked smaller
            phases = [randn(shape, 10 + j, dev, dtype) for j in range(4)]
            bias = randn(shape[-1:], 20, dev, dtype)
            got = shuffle.subpixel_interleave(phases, bias, n=n)
            ref = shuffle.subpixel_interleave_plain(phases, bias, n=n)
            torch.cuda.synchronize()
            exact = k2_exact(got, ref)
            err = (0.0 if exact else compare(got, ref)[0]
                   if got.shape == ref.shape else float("inf"))
            del got, ref
            timing = None
            if dtype == torch.bfloat16:
                k_ms, p_ms, _ = in_turns(
                    lambda: shuffle.subpixel_interleave_plain(phases, bias, n=n),
                    lambda: shuffle.subpixel_interleave(phases, bias, n=n))
                timing = (shape, dtype, k_ms, p_ms, None, dict(n=n))
            record("K2", f"{tuple(shape)} n={n} {dtype} bit-exact={exact}",
                   err, 0.0 if exact else 1.0, "tol=bit-exact", timing)
            del phases
            torch.cuda.empty_cache()

    # K3: the encoder's conv_in on a 17-frame 720p clip, timed in bf16 and
    # fp32; no one PyTorch call computes it (conv3d's padding cannot repeat
    # the first frame)
    spec = Conv3DSpec.v1_causal()
    shape = K3_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        x, w, b = k3_inputs(shape[:-1], shape[-1], dev, dtype)
        got = stem.stem_conv3d(x, w, b, spec)
        torch.cuda.synchronize()
        err, excess, tol_text = k3_check(got, x, w, b, spec)
        del got
        k_ms, p_ms, _ = in_turns(
            lambda: stem.stem_conv3d_plain(x, w, b, spec),
            lambda: stem.stem_conv3d(x, w, b, spec))
        record("K3", f"{shape} {dtype}", err, excess, tol_text,
               (shape, dtype, k_ms, p_ms, None, {}))
        del x
        torch.cuda.empty_cache()

    # K4 at K4_CASES, the serving launch and the one that also writes the
    # logsumexp; the timed ones also against SDPA, and the two launches in
    # turns
    dtype = torch.bfloat16
    for shape, timed, rising in K4_CASES:
        q, k, v = k4_inputs(shape, dev, dtype, rising)
        scale = shape[-1] ** -0.5
        got = attention.flash_attention(q, k, v, scale)
        with_lse, lse = attention._launch(q, k, v, scale, True)
        ref = attention.flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != dtype:
            raise SystemExit(f"K4 output {tuple(got.shape)} {got.dtype}")
        err, excess, tol_text = k4_check(got, ref)
        same = torch.equal(got, with_lse)
        lse_err, lse_excess, lse_text = k4_lse_check(
            lse, attention.flash_attention_lse_plain(q, k, scale))
        tol_text += (f"; output with the logsumexp written bit-equal {same}"
                     f"; {lse_text} max_abs_err {lse_err!r}")
        excess = max(excess, lse_excess, 0.0 if same else math.inf)
        del with_lse, lse
        # the rising inputs must make the kernel rescale its output
        raises = k4_max_raises(q, k, scale)
        tol_text += f"; max raised {raises!r} times a row after tile 0"
        if rising and raises < 1.0:
            excess = math.inf
        del got, ref
        timing = None
        if timed:  # SDPA as (B, 1 head, S, C)
            lib = functools.partial(
                torch.nn.functional.scaled_dot_product_attention,
                q[:, None], k[:, None], v[:, None], scale=scale)
            k_ms, p_ms, l_ms = in_turns(
                lambda: attention.flash_attention_plain(q, k, v, scale),
                lambda: attention.flash_attention(q, k, v, scale), lib)
            lse_ms = turns({
                "serving": lambda: attention.flash_attention(q, k, v, scale),
                "lse": lambda: attention._launch(q, k, v, scale, True)})
            timing = (shape, dtype, k_ms, p_ms, l_ms, {})
            extra = dict(serving_ms_in_turns=lse_ms["serving"],
                         with_lse_ms=lse_ms["lse"])
            del lib
        record("K4", f"{shape} {dtype}{' rising logits' if rising else ''}",
               err, excess, tol_text, timing, extra if timed else None)
        del q, k, v
        torch.cuda.empty_cache()

    _check_k5(dev, record)
    return summary


def _check_k5(dev, record):
    """K5 bit-equal to its plain version: at K5_CHECK_CASES, then at
    K5_PATH_SHAPES on their first and last output frames, bf16 and fp32;
    each path shape timed in bf16 (K5.stage then K5.gemm, the packed
    weight made beforehand as a module keeps it), in turns with the plain
    version (on the head frames) and the bf16 conv that int8 replaces
    (the port's float conv3d on the dequantized kernel, with its edge
    handling).  K5.stage alone bit-equal to its plain version at the path
    shapes in both dtypes, timed in bf16 in turns with it.  Then the
    upsample's four phase GEMMs from one staged tensor
    (:func:`_check_k5_phases`)."""
    from types import SimpleNamespace

    from cvvae_tpu_torch.ops import conv
    from cvvae_tpu_torch.ops.kernels import conv_int8

    for dtype in (torch.bfloat16, torch.float32):
        for i, half, (shape, cout, kernel, stride, pads, modes, with_bias) \
                in k5_check_cases():
            args = k5_inputs(shape, cout, kernel, dev, dtype, with_bias,
                             half_steps=half)
            got = conv_int8.conv3d_int8(*args, stride, pads, modes)
            ref = conv_int8.conv3d_int8_plain(*args, stride, pads, modes)
            torch.cuda.synchronize()
            exact = k2_exact(got, ref)
            err = (0.0 if exact else compare(got, ref)[0]
                   if got.shape == ref.shape else math.inf)
            record("K5", f"case {i}{' half steps' if half else ''} {shape}"
                   f"->{cout} k={kernel} s={stride} pads={pads} {modes} "
                   f"bias={with_bias} {dtype} bit-exact={exact}", err,
                   0.0 if exact else 1.0, "tol=bit-exact")
    for name, shape, cout, kernel, stride, pads, modes in K5_PATH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, wq, sw, sx, b = k5_inputs(shape, cout, kernel, dev, dtype)
            _check_k5_stage(record, name, x, sx, pads, modes, stride)
            wpk = conv_int8.pack_weight(wq)
            got = conv_int8.conv3d_int8(x, wq, sw, sx, b, stride, pads, modes,
                                        wpk)
            t_out = got.shape[1]
            exact, err = k5_ends_exact(got, x, wq, sw, sx, b, kernel, stride,
                                       pads, modes)
            del got
            torch.cuda.empty_cache()
            timing = extra = None
            if dtype == torch.bfloat16:
                xs, t_pads = k5_frames(x, kernel, stride, pads, modes, 0,
                                       K5_HEAD_FRAMES)
                float_conv = SimpleNamespace(
                    weight=(wq.float() * sw[:, None, None, None, None]).to(
                        dtype), bias=b.to(dtype))
                spec = conv.Conv3DSpec(kernel, stride, pads, modes)
                ms = turns({
                    "plain": lambda: conv_int8.conv3d_int8_plain(
                        xs, wq, sw, sx, b, stride,
                        (t_pads,) + tuple(pads[1:]), modes),
                    "kernel": lambda: conv_int8.conv3d_int8(
                        x, wq, sw, sx, b, stride, pads, modes, wpk),
                    "bf16_conv": lambda: conv.conv3d(x, float_conv, spec)})
                timing = (shape, dtype, ms["kernel"], ms["plain"], None,
                          dict(cout=cout, kernel=kernel, stride=stride,
                               pads=pads))
                extra = dict(name=name, plain_frames=K5_HEAD_FRAMES,
                             bf16_conv_ms=ms["bf16_conv"])
                del xs, float_conv
            record("K5", f"{name} {shape}->{cout} {dtype} output frames "
                   f"[0, {K5_HEAD_FRAMES}) and [{t_out - K5_TAIL_FRAMES}, "
                   f"{t_out}) bit-exact={exact}", err,
                   0.0 if exact else 1.0, "tol=bit-exact", timing, extra)
            del x, wq, sw, sx, b, wpk
            torch.cuda.empty_cache()
    _check_k5_phases(dev, record)


def k5_ends_exact(got, x, wq, sw, sx, b, kernel, stride, pads, modes):
    """(bit-equal, max|d|) of a K5 output ``got`` against the plain
    version on its first K5_HEAD_FRAMES and last K5_TAIL_FRAMES output
    frames."""
    from cvvae_tpu_torch.ops.kernels import conv_int8

    torch.cuda.synchronize()
    t_out = got.shape[1]
    exact, err = True, 0.0
    for first, last in ((0, K5_HEAD_FRAMES), (t_out - K5_TAIL_FRAMES, t_out)):
        xs, t_pads = k5_frames(x, kernel, stride, pads, modes, first, last)
        ref = conv_int8.conv3d_int8_plain(
            xs, wq, sw, sx, b, stride, (t_pads,) + tuple(pads[1:]), modes)
        part = got[:, first:last].contiguous()
        same = k2_exact(part, ref)
        exact &= same
        if not same:
            err = max(err, compare(part, ref)[0]
                      if part.shape == ref.shape else math.inf)
        del xs, ref, part
    return exact, err


def _check_k5_phases(dev, record):
    """The upsample's four phase GEMMs as ``upsample_conv._int8_phases``
    runs them, at the upsample_phase path shape: x staged once with (1,1)
    H and W pads, each phase's GEMM reading its (1,0)/(0,1) window of it
    (origin 0 or 1 in H and W), no bias; each bit-equal to the plain int8
    conv with the phase's own pads on its first and last output frames,
    bf16 and fp32."""
    from cvvae_tpu_torch.ops.kernels import conv_int8

    shape, cout, kernel, stride, pads, modes = next(
        c[1:] for c in K5_PATH_SHAPES if c[0] == "upsample_phase")
    for dtype in (torch.bfloat16, torch.float32):
        x, wq, sw, sx, _ = k5_inputs(shape, cout, kernel, dev, dtype,
                                     with_bias=False)
        wpk = conv_int8.pack_weight(wq)
        staged = conv_int8.stage(x, sx, (pads[0], (1, 1), (1, 1)), modes)
        for hp in ((1, 0), (0, 1)):
            for wp in ((1, 0), (0, 1)):
                phase = (pads[0], hp, wp)
                got = conv_int8.gemm(staged, wq, sw, sx, None, stride, phase,
                                     wpk)
                exact, err = k5_ends_exact(got, x, wq, sw, sx, None, kernel,
                                           stride, phase, modes)
                record("K5", f"upsample_phase one stage "
                       f"{tuple(staged.xq.shape)} {dtype}, GEMM window "
                       f"pads={phase} output frames [0, {K5_HEAD_FRAMES}) "
                       f"and the last {K5_TAIL_FRAMES} bit-exact={exact}",
                       err, 0.0 if exact else 1.0, "tol=bit-exact")
                del got
        del x, wq, sw, sx, wpk, staged
        torch.cuda.empty_cache()


def _check_k5_stage(record, name, x, sx, pads, modes, stride):
    """K5.stage at a path shape against its plain version, bit for bit;
    timed in bf16, in turns with it."""
    from cvvae_tpu_torch.ops.kernels import conv_int8

    got = conv_int8.stage(x, sx, pads, modes, stride[2]).xq
    ref = conv_int8.stage_plain(x, sx, pads, modes, stride[2])
    torch.cuda.synchronize()
    exact = got.shape == ref.shape and torch.equal(got, ref)
    err = (0.0 if exact else (got.float() - ref.float()).abs().max().item()
           if got.shape == ref.shape else math.inf)
    del got, ref
    torch.cuda.empty_cache()
    timing = None
    if x.dtype == torch.bfloat16:
        k_ms, p_ms, _ = in_turns(
            lambda: conv_int8.stage_plain(x, sx, pads, modes, stride[2]),
            lambda: conv_int8.stage(x, sx, pads, modes, stride[2]))
        timing = (tuple(x.shape), x.dtype, k_ms, p_ms, None,
                  dict(stride=stride, pads=pads))
        torch.cuda.empty_cache()
    record("K5.stage", f"{name} {tuple(x.shape)} {x.dtype} pads={pads} "
           f"{modes} bit-exact={exact}", err, 0.0 if exact else 1.0,
           "tol=bit-exact", timing, dict(name=name) if timing else None)


def _attention_fp32(dev, smi):
    """fp32 attention at the mid-block shapes: the exact path
    (``single_head_attention`` routes it there, launching K4 no time)
    timed in turns beside SDPA fp32 (TF32 off), as a record; bound: the
    FLOP over the fp32 FMA peak."""
    import torch.nn.functional as F

    from cvvae_tpu_torch.ops.attention import single_head_attention

    k4 = kernel_modules()["K4"]
    for shape in ATTN_FP32_SHAPES:
        q, k, v = k4_inputs(shape, dev, torch.float32)
        scale = shape[-1] ** -0.5
        before = k4.launches
        got = single_head_attention(q, k, v, scale=scale)
        sdpa = functools.partial(F.scaled_dot_product_attention, q[:, None],
                                 k[:, None], v[:, None], scale=scale)
        ref = sdpa()[:, 0]
        torch.cuda.synchronize()
        if k4.launches != before:
            raise SystemExit(f"fp32 attention {shape} launched K4")
        err = compare(got, ref)[0]
        if got.shape != q.shape or not math.isfinite(err):
            raise SystemExit(f"fp32 attention {shape}: output "
                             f"{tuple(got.shape)}, max|d| {err}")
        del got, ref
        ms = turns({"exact": lambda: single_head_attention(q, k, v,
                                                           scale=scale),
                    "sdpa": sdpa})
        b_ms, by = bound("K4", shape, torch.float32)
        say(f"[attention] fp32 {shape}: exact path ms={ms['exact']!r} "
            f"SDPA fp32 ms={ms['sdpa']!r} (TF32 off) bound_ms={b_ms!r} "
            f"({by}); max|exact - SDPA|={err!r}; K4 launches 0; card {smi}")
        del q, k, v, sdpa
        torch.cuda.empty_cache()


def _check_edge_convs(dev, smi):
    """The edge-pad decompositions against the materialised pad at
    EDGE_CASES (``edge_inputs``): fp32 (TF32 off; the pad's conv computed
    in time chunks, ``edge_reference``) and bf16, held by ``edge_check``;
    each path timed in bf16, in turns."""
    from cvvae_tpu_torch.ops import conv

    for name, shape, ctor, cout in EDGE_CASES:
        spec = getattr(conv.Conv3DSpec, ctor)()
        paths = edge_paths(spec)
        for dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            x, w, b = edge_inputs(shape, cout, dev, dtype)
            if dtype == torch.float32:
                ref, mag = edge_reference(x, w, b, spec), None
            else:
                ref = paths["materialised"](x, w, b)
                mag = paths["materialised"](x.abs(), w.abs(), b.abs())
            for path, fn in paths.items():
                if path == "materialised":
                    continue
                got = fn(x, w, b)
                torch.cuda.synchronize()
                err, excess, text = edge_check(got, ref, mag)
                ok = excess <= 0.0
                say(f"[edge] {name} {tuple(x.shape)}->{cout} {dtype} {path} "
                    f"against "
                    f"the materialised pad: max_abs_err={err!r} excess="
                    f"{excess!r} {text} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"edge conv {name} {path} {dtype}: "
                                     f"disagrees with the materialised pad")
                del got
            del ref, mag
            torch.cuda.empty_cache()
            say(f"[edge] {name} {dtype} checked in "
                f"{time.perf_counter() - t0:.1f}s")
            if dtype == torch.bfloat16:
                ms = turns({p: functools.partial(fn, x, w, b)
                            for p, fn in paths.items()})
                # a 3x3x3 conv to cout channels at the same extent, as K3's
                b_ms, by = bound("K3", shape, dtype, cout=cout)
                say(f"[edge] {name} {shape}->{cout} bf16 ms, in turns: "
                    + " ".join(f"{p}={t!r}" for p, t in ms.items())
                    + f"; bound_ms={b_ms!r} ({by}); card {smi}")
            del x, w, b
            torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 4: the whole slice, card against CPU
# --------------------------------------------------------------------------

def _check_slice(dev, family):
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    k4 = kernel_modules()["K4"]
    cfg = config_for_variant(family)
    clip = SLICE_CLIPS[family]
    x = np.random.RandomState(0).uniform(-1, 1, clip)
    x = torch.from_numpy(x.astype(np.float32))
    outs = {}
    for d in ("cpu", dev):
        vae = VideoVAE.from_config(cfg, seed=0, device=d)
        k4.launches = 0
        t0 = time.perf_counter()
        z = vae.encode(x.to(d)).mode()
        rec = vae.decode(z)
        if d != "cpu":
            torch.cuda.synchronize()
        say(f"[slice] {family} {d}: reconstruct {tuple(x.shape)} -> latent "
            f"{tuple(z.shape)}, frames {tuple(rec.shape)} in "
            f"{time.perf_counter() - t0:.2f}s; K4 launches {k4.launches}")
        outs[str(d)] = (z.cpu(), rec.cpu())
        del vae
    if k4.launches != 0:  # fp32 attention takes the exact path
        raise SystemExit(f"slice {family}: fp32 attention launched K4 "
                         f"{k4.launches} times on the card")
    (zc, rc), (zg, rg) = outs["cpu"], outs[str(dev)]
    b, t, h, w, _ = clip
    for name, ref, got, shape in (
            ("latent", zc, zg, (b, (t - 1) // 4 + 1, h // 8, w // 8,
                                cfg.latent_channels)),
            ("frames", rc, rg, clip)):
        if tuple(got.shape) != shape or not torch.isfinite(got).all():
            raise SystemExit(f"slice {family} {name}: shape "
                             f"{tuple(got.shape)} or non-finite values")
        err = (got - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        ok = err <= SLICE_TOL * scale
        say(f"[slice] {family} {name}: max_abs_err={err!r} "
            f"(max|ref|={scale!r}, tol={SLICE_TOL}*max(1,max|ref|)) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"slice {family} {name}: card and CPU disagree")


def _check_int8_slice(dev, family):
    """The family's full-width net quantized and calibrated once on the
    card, its state carried to the CPU; encode + decode of the same clip
    in fp32 activations (TF32 off) on the card (K5 at the convs of at
    least INT8_MIN_POSITIONS positions) against the CPU (plain versions),
    held by the frames' PSNR."""
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant
    from cvvae_tpu_torch.ops.quant import load_quantized_state

    k5 = kernel_modules()["K5"]
    cfg = config_for_variant(family)
    clip = INT8_SLICE_CLIPS[family]
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, clip)
                         .astype(np.float32))
    t0 = time.perf_counter()
    on_card = VideoVAE.from_config(cfg, seed=0, device=dev).quantize(
        calibration=x.to(dev))
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    state = {k: v.cpu() for k, v in on_card.state_dict().items()}
    outs = {}
    for d in ("cpu", dev):
        q = on_card if d != "cpu" else load_quantized_state(
            VideoVAE.from_config(cfg, seed=0, device="cpu").quantize(), state)
        k5.launches = 0
        t0 = time.perf_counter()
        rec = q.decode(q.encode(x.to(d)).mode())
        if d != "cpu":
            torch.cuda.synchronize()
        say(f"[slice] {family} int8 {d}: reconstruct {tuple(x.shape)} -> "
            f"{tuple(rec.shape)} in {time.perf_counter() - t0:.2f}s; K5 "
            f"launches {k5.launches}")
        outs[str(d)] = rec.cpu()
        del q
    del on_card
    n_q = sum(k.endswith("weight_q") for k in state)
    n_x = sum(k.endswith("scale_x") for k in state)
    if k5.launches == 0:
        raise SystemExit(f"int8 slice {family}: K5 not launched on the card")
    ref, got = outs["cpu"], outs[str(dev)]
    if tuple(got.shape) != clip or not torch.isfinite(got).all():
        raise SystemExit(f"int8 slice {family}: frames {tuple(got.shape)} "
                         f"or non-finite values")
    mse = float(((got.double() - ref.double()) ** 2).mean())
    peak = 2 * ref.abs().max().item()
    db = 10 * math.log10(peak ** 2 / mse) if mse > 0 else math.inf
    ok = db >= INT8_SLICE_PSNR
    say(f"[slice] {family} int8: {n_q} convs quantized, {n_x} calibrated "
        f"on the card in {t_cal:.1f}s; card against CPU frames PSNR {db!r} "
        f"dB over 2 max|ref| = {peak!r} (>= {INT8_SLICE_PSNR}; over 2: "
        f"{10 * math.log10(4.0 / mse) if mse > 0 else math.inf!r}), max_abs_err "
        f"{(got - ref).abs().max().item()!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"int8 slice {family}: card and CPU disagree")


# --------------------------------------------------------------------------
# phase 5: serving
# --------------------------------------------------------------------------

def _request(port, method, path, arr=None, timeout=900):
    body = None
    if arr is not None:
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        body = buf.getvalue()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    wall = time.perf_counter() - t0
    conn.close()
    if resp.status != 200:
        raise SystemExit(f"{method} {path}: HTTP {resp.status} {data[:300]!r}")
    return data, wall


def _serve(dev, smi, path):
    """Serve ``path`` (variant, dtype): the checks of phase 5.  Returns
    (launches in the served requests, launches in the /reconstruct alone,
    the /reconstruct frames)."""
    from cvvae_tpu_torch import serve

    t, h, w = SERVE_CLIP
    z_ch, needed = PATHS[path]
    variant = "-".join(path)
    args = serve.build_argparser().parse_args(
        ["--variant", path[0], "--dtype", path[1], "--height", str(h),
         "--width", str(w), "--warm_frames", str(t), "--device", str(dev),
         "--port", "0"])
    t0 = time.perf_counter()
    server = serve.prepare(args)
    say(f"[serve] {variant}: prepare (build + preset + quantize/calibrate "
        f"for int8 + warm-up) "
        f"{time.perf_counter() - t0:.2f}s; encoder tile "
        f"{server.worker.vae.config.encode_pixel_tile_size}, decoder tile "
        f"{server.worker.vae.config.pixel_tile_size}")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        clip = np.random.RandomState(0).randint(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        health, _ = _request(port, "GET", "/healthz")
        if json.loads(health) != {"ok": True}:
            raise SystemExit(f"/healthz: {health!r}")
        rec_b, t_rec = _request(port, "POST", "/reconstruct", clip)
        per_rec = launch_counts()
        z_b, t_enc = _request(port, "POST", "/encode", clip)
        z = np.load(io.BytesIO(z_b), allow_pickle=False)
        dec_b, t_dec = _request(port, "POST", "/decode", z)
        stats_b, _ = _request(port, "GET", "/stats")
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        # the /reconstruct's frames before the worker's uint8 cast, for
        # int8's agreement with bf16 as the reference measures it
        worker = server.worker
        with torch.inference_mode():
            x = torch.from_numpy(clip).to(worker.device)[None]
            x = x.to(worker.dtype) / 127.5 - 1.0
            frames = worker.vae.decode(worker.vae.encode(x).mode())[0]
            served = ((frames.float() + 1.0) * 127.5).clamp(0, 255).to(
                torch.uint8).cpu().numpy()
            frames = frames.float().cpu()
        del x
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
        # the worker thread lives on: drop its model so the next path
        # starts from a free card
        server.worker.vae = None
        del server
        gc.collect()
        torch.cuda.empty_cache()
    rec = np.load(io.BytesIO(rec_b), allow_pickle=False)
    dec = np.load(io.BytesIO(dec_b), allow_pickle=False)
    say(f"[serve] {variant}: latent {z.shape} {z.dtype}; frames {rec.shape} "
        f"{rec.dtype}")
    if z.shape != (1, (t - 1) // 4 + 1, h // 8, w // 8, z_ch) \
            or not np.isfinite(z).all():
        raise SystemExit(f"{variant} /encode: latent {z.shape}, finite="
                         f"{bool(np.isfinite(z).all())}")
    if rec.shape != (t, h, w, 3) or rec.dtype != np.uint8:
        raise SystemExit(f"{variant} /reconstruct: frames {rec.shape} "
                         f"{rec.dtype}")
    same = rec_b == dec_b
    say(f"[serve] {variant}: /reconstruct bytes == /decode(/encode) bytes: "
        f"{same}")
    if not same:
        raise SystemExit(f"{variant}: /reconstruct and /decode(/encode) "
                         f"differ")
    if not np.array_equal(served, rec):
        raise SystemExit(f"{variant}: the model's frames, cast as the worker "
                         f"casts them, are not the /reconstruct bytes")
    say(f"[serve] {variant}: stats {stats_b.decode()}")
    say(f"[serve] {variant}: request wall s (after warm-up): "
        f"reconstruct={t_rec!r} "
        f"encode={t_enc!r} decode={t_dec!r}; peak device memory "
        f"{peak / 2**30:.2f} GiB; card {smi}")
    say(f"[serve] {variant}: kernel launches in the served requests: "
        f"{launches}; in the /reconstruct alone: {per_rec}")
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{variant}: kernels not launched by the main "
                         f"path: {missing}")
    return launches, per_rec, (rec, frames)


# --------------------------------------------------------------------------
# phase 6: streaming at full width
# --------------------------------------------------------------------------

def _stream(dev, smi):
    """Phase 6: a 45-frame 720p clip through ``streaming.py`` with the
    served v1 int8 model (the serving preset, calibrated as ``serve``
    calibrates without --calibration_video).  The serial stream's bytes
    against the batch path's; prefetch 1 and 3 and the pipelined loop
    against the serial stream's; chunk_batch=2's latents against the serial
    latents.  Returns the serial stream's kernel launches."""
    from cvvae_tpu_torch import serve, streaming
    from cvvae_tpu_torch.cli import apply_serving_preset
    from cvvae_tpu_torch.data.video_io import to_uint8, to_unit
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    t, h, w = STREAM_CLIP
    variant, mode = STREAM_PATH
    dtype = torch.bfloat16
    args = serve.build_argparser().parse_args(
        ["--variant", variant, "--dtype", mode, "--height", str(h),
         "--width", str(w), "--device", str(dev)])
    t0 = time.perf_counter()
    vae = VideoVAE.from_config(config_for_variant(variant), dtype=dtype,
                               device=dev)
    apply_serving_preset(vae, h, w)
    vae = serve.quantized(vae, args, 17)
    torch.cuda.synchronize()
    model_bytes = torch.cuda.memory_allocated()
    say(f"[stream] {variant}-{mode}: model built, preset and calibrated in "
        f"{time.perf_counter() - t0:.2f}s ({model_bytes / 2**30:.2f} GiB)")
    clip = np.random.RandomState(1).randint(0, 256, (t, h, w, 3),
                                            dtype=np.uint8)

    def stream(frames, **kw):
        return np.concatenate(list(streaming.streaming_decode(
            vae, streaming.streaming_encode(vae, iter(frames), dtype=dtype),
            **kw)))

    def latents(**kw):
        return torch.cat(list(streaming.streaming_encode(
            vae, iter(clip), dtype=dtype, **kw)), dim=1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the batch path, as the server computes a clip (also the warm-up)
    with torch.inference_mode():
        x = to_unit(torch.from_numpy(clip).to(dev)[None], dtype)
        batch = to_uint8(vae.decode(vae.encode(x).mode())[0]).cpu().numpy()
        del x
    gc.collect()
    torch.cuda.empty_cache()
    # one 17-frame window's peak, then the whole stream's
    torch.cuda.reset_peak_memory_stats()
    timed(lambda: stream(clip[:17]))
    window_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    serial, wall = timed(lambda: stream(clip))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"[stream] {variant}-{mode} {t}x{h}x{w} (encode windows 17, 17, "
        f"13; decode windows 5, 5, 4): serial stream {wall!r} s, "
        f"{t / wall!r} fps; peak device memory {peak / 2**30!r} GiB, one "
        f"17-frame window's {window_peak / 2**30!r} GiB (model "
        f"{model_bytes / 2**30!r} GiB); card {smi}")
    say(f"[stream] kernel launches in the serial stream: {launches}")
    missing = [k for k in PATHS[STREAM_PATH][1] if launches[k] <= 0]
    if missing:
        raise SystemExit(f"stream: kernels not launched: {missing}")
    if serial.shape != (t, h, w, 3) or not np.array_equal(serial, batch):
        raise SystemExit(f"stream: frames {serial.shape} differ from the "
                         f"batch path's")
    say("[stream] serial stream bytes == batch path bytes: True")
    runs = {f"prefetch={p}": (lambda p=p: stream(clip, prefetch=p))
            for p in (1, 3)}

    def pipelined():
        blocks = []
        streaming.reconstruct_stream(vae, iter(clip), blocks.append,
                                     dtype=dtype, pipelined=True)
        return np.concatenate(blocks)

    runs["pipelined"] = pipelined
    for name, fn in runs.items():
        got, wall_k = timed(fn)
        same = np.array_equal(got, serial)
        say(f"[stream] {name}: {wall_k!r} s, {t / wall_k!r} fps; bytes == "
            f"serial stream bytes: {same}")
        if not same:
            raise SystemExit(f"stream {name}: bytes differ from serial")
    reset_launch_counts()
    z1 = latents()
    enc = launch_counts()
    say(f"[stream] kernel launches a window (three of each): encode "
        f"{ {k: n / 3 for k, n in enc.items()} }, decode "
        f"{ {k: (launches[k] - n) / 3 for k, n in enc.items()} }")
    z2, wall_b = timed(lambda: latents(chunk_batch=2))
    equal = torch.equal(z1, z2)
    say(f"[stream] chunk_batch=2 latents (windows 1-2 at B = 2, the 13-frame "
        f"tail alone) == serial latents: {equal}; max|d| "
        f"{(z2.float() - z1.float()).abs().max().item()!r}; encode "
        f"{wall_b!r} s")
    if not equal:
        raise SystemExit("stream chunk_batch=2: latents differ from serial")
    return launches


# --------------------------------------------------------------------------
# phase 7: reference checkpoints
# --------------------------------------------------------------------------

def reference_layout(state, conv2d=True, dense_conv=True):
    """The port's state dict -> the reference's checkpoint layout, the
    inverse of ``utils/convert.convert_state_dict``: the module paths the
    reference names otherwise (``downsample.conv``, ``to_out.0``, ...), a
    kT = 1 conv as a Conv2d (O, I, kH, kW) with ``conv2d`` (else a Conv3d),
    a dense layer as a 1x1 Conv2d (O, I, 1, 1) with ``dense_conv`` (else a
    Linear)."""
    import re

    from cvvae_tpu_torch.utils.convert import _DENSE_NAMES, _NORM_NAMES

    paths = [(re.compile(r"\b(downsample|upsample|(?:down|up)samplers\.\d+)$"),
              r"\1.conv"), (re.compile(r"\bto_out$"), "to_out.0")]
    out = {}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        name = next(p for p in reversed(module.split("."))
                    if not p.isdigit())
        if leaf == "weight" and name not in _NORM_NAMES:
            if name in _DENSE_NAMES:
                if dense_conv:
                    value = value[:, :, None, None]
            elif conv2d and value.ndim == 5 and value.shape[2] == 1:
                value = value[:, :, 0]
        for pat, rep in paths:
            module = pat.sub(rep, module)
        out[f"{module}.{leaf}"] = value.detach().cpu().clone()
    return out


def reference_config(config) -> dict:
    """A VideoVAEConfig -> the reference's config.json (the inverse of
    ``utils/convert._config_from_json``)."""
    net = config.net
    out = dict(
        scaling_factor=config.scaling_factor,
        en_de_n_frames_a_time=config.en_de_n_frames_a_time,
        time_n_compress=config.time_n_compress,
        spatial_n_compress=config.spatial_n_compress,
        tile_spatial_size=config.tile_spatial_size,
        tile_overlap_ratio=config.tile_overlap_ratio,
        num_video_frames=config.num_video_frames,
        in_channels=net.in_channels, double_z=net.double_z,
        half_3d=net.half_3d, causal_encoder=net.causal_encoder,
        causal_decoder=net.causal_decoder)
    if config.family == "sd3":
        return dict(out, _class_name="CVVAESD3Model",
                    out_channels=net.latent_channels,
                    block_out_channels=list(net.block_out_channels),
                    layers_per_block=net.layers_per_block,
                    norm_num_groups=net.norm_num_groups,
                    mid_block_add_attention=net.mid_block_add_attention)
    return dict(out, _class_name="CVVAEModel", z_channels=net.z_channels,
                out_ch=net.out_ch, ch=net.ch, ch_mult=list(net.ch_mult),
                num_res_blocks=net.num_res_blocks,
                attn_resolutions=list(net.attn_resolutions),
                resolution=net.resolution, use_3d_conv=net.use_3d_conv,
                dropout=net.dropout)


def write_reference_checkpoint(path, config, state, **layout):
    """An HF checkpoint directory as the reference ships one:
    ``config.json`` and ``model.safetensors`` in its layout
    (``reference_layout(state, **layout)``)."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(reference_config(config), f)
    save_file(reference_layout(state, **layout),
              os.path.join(path, "model.safetensors"))


def _reconstruct_served(dev, flags, clip):
    """Build a server with ``serve.prepare(flags)``, POST one /reconstruct
    of ``clip`` and stop it.  Returns (the response's frames, launches in
    the request)."""
    from cvvae_tpu_torch import serve

    t, h, w = clip.shape[:3]
    args = serve.build_argparser().parse_args(
        flags + ["--height", str(h), "--width", str(w), "--warm_frames",
                 str(t), "--device", str(dev), "--port", "0"])
    server = serve.prepare(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        reset_launch_counts()
        body, _ = _request(server.server_address[1], "POST", "/reconstruct",
                           clip)
        launches = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
        server.worker.vae = None
        del server
        gc.collect()
        torch.cuda.empty_cache()
    return np.load(io.BytesIO(body), allow_pickle=False), launches


def _checkpoints(dev, smi):
    """Phase 7: full-width random v1 and SD3 models written as reference
    HF directories and loaded with ``VideoVAE.from_pretrained`` on the card
    (weights and outputs bit-equal to the source model's on a 17x256x256
    clip); a Lightning .ckpt with a non-VAE key through
    ``load_torch_checkpoint_file``; one int8 /reconstruct served from
    --vae_path, byte-equal to the server built from the same seed."""
    import tempfile

    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant
    from cvvae_tpu_torch.utils.convert import load_torch_checkpoint_file

    dtype = torch.bfloat16
    t, h, w = CKPT_CLIP
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (1, t, h, w, 3)).astype(np.float32)).to(dev, dtype)
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ("v1", "sd3"):
            src = VideoVAE.from_config(config_for_variant(variant), seed=0,
                                       dtype=dtype, device=dev)
            path = os.path.join(tmp, variant)
            t0 = time.perf_counter()
            write_reference_checkpoint(path, src.config, src.state_dict())
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = VideoVAE.from_pretrained(path, dtype=dtype, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            same_state = all(torch.equal(v, got.state_dict()[k])
                             for k, v in src.state_dict().items())
            outs = []
            for vae in (src, got):
                z = vae.encode(x).mode()
                outs.append((z, vae.decode(z)))
            equal = (got.config == src.config and same_state
                     and all(torch.equal(a, b)
                             for a, b in zip(outs[0], outs[1])))
            size = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
            say(f"[ckpt] {variant}: wrote {size / 2**20:.1f} MiB in "
                f"{t_write:.2f}s; from_pretrained on the card in "
                f"{t_load:.2f}s; config, weights, latents {tuple(outs[1][0].shape)} "
                f"and frames {tuple(outs[1][1].shape)} bit-equal to the "
                f"source model's: {equal}")
            if not equal:
                raise SystemExit(f"checkpoint {variant}: from_pretrained "
                                 f"differs from the source model")
            if variant == "v1":
                ref = reference_layout(src.state_dict())
                ckpt = os.path.join(tmp, "last.ckpt")
                torch.save({"state_dict": dict(ref, **{
                    "loss.logvar": torch.zeros(())}), "global_step": 1}, ckpt)
                state, skipped = load_torch_checkpoint_file(ckpt, dtype=dtype)
                ok = skipped == ["loss.logvar"] and state.keys() == \
                    src.state_dict().keys() and all(
                        torch.equal(v.to(dev), src.state_dict()[k])
                        for k, v in state.items())
                say(f"[ckpt] Lightning .ckpt: skipped {skipped}; the VAE "
                    f"state equal to the source's: {ok}")
                if not ok:
                    raise SystemExit("checkpoint .ckpt: wrong state")
            del src, got, outs
            gc.collect()
            torch.cuda.empty_cache()
        clip = np.random.RandomState(3).randint(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)
        served, launches = _reconstruct_served(
            dev, ["--vae_path", os.path.join(tmp, "v1"), "--dtype", "int8"],
            clip)
        seeded, _ = _reconstruct_served(
            dev, ["--variant", "v1", "--dtype", "int8"], clip)
    same = served.shape == (t, h, w, 3) and np.array_equal(served, seeded)
    say(f"[ckpt] int8 /reconstruct {clip.shape} served from --vae_path: "
        f"frames {served.shape} {served.dtype}, == the server built from "
        f"seed 0: {same}; launches {launches}")
    if not same or launches["K5"] <= 0:
        raise SystemExit("checkpoint: the server from --vae_path differs")


def frames_psnr(got, ref, data_range) -> float:
    """PSNR of two clips (uint8 arrays or float tensors), in dB."""
    d = torch.as_tensor(got).double() - torch.as_tensor(ref).double()
    mse = float((d ** 2).mean())
    return 10 * math.log10(data_range ** 2 / mse) if mse > 0 else math.inf


# --------------------------------------------------------------------------
# phase 8: training
# --------------------------------------------------------------------------

#: K1.bwd's shapes on the SD3 latent-constraint training path at full width
#: on the shipped (1, 17, 256, 256) clip: (where, shape, groups, eps, silu,
#: per_frame)
K1_BWD_SHAPES = [
    ("sd3 level-0 resblock norm", (1, 17, 256, 256, 128), 32, 1e-6, True,
     False),
    ("sd3 mid-block attention norm, per frame", (1, 5, 32, 32, 512), 32, 1e-6,
     False, True),
    ("vae2d level-0 norm, per frame", (1, 5, 256, 256, 128), 32, 1e-6, True,
     True),
    ("disc3d block-0 norm", (1, 9, 128, 128, 64), 32, 1e-5, True, False),
]
#: K2.bwd's shapes there: the SD3 decoder's three upsample tails (phase
#: shape, n)
K2_BWD_SHAPES = [((1, 5, 32, 32, 1024), 2), ((1, 9, 64, 64, 512), 1),
                 ((1, 9, 128, 128, 512), 2)]
#: K3.bwd's shapes on the v1 training path: the encoder's conv_in (3 ->
#: 128, causal edge time) on the shipped clip and images, x (B, T, H, W)
K3_BWD_SHAPES = [("v1 conv_in on the clip", (1, 17, 256, 256)),
                 ("v1 conv_in on the images", (8, 1, 320, 320))]
#: K3.bwd's small checks (padding, (B, T, H, W)), Cin 3, held by
#: ``k3_bwd_check`` in the card tests and planted_faults.py: W ragged
#: against both tiles (64 pixels in fp32, 128 in bf16), the bf16 k-step
#: of 16 and against 3 (70, 130, 37), T = 1, every padding kind
K3_BWD_CHECK_SHAPES = [("edge", (1, 5, 9, 70)), ("edge", (2, 1, 7, 130)),
                       ("zero", (1, 4, 6, 66)), ("none", (1, 5, 6, 37))]
#: K1.bwd against its plain version on the same inputs and saved
#: statistics, ||d|| / ||ref|| of dx, dweight and dbias apart: fp32 (both
#: sum in fp32, in other orders; the merges in double), bf16 (both compute
#: in fp32 and round dx once to bf16; a few ulps apart where the sums
#: differ)
K1_BWD_RMS = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
#: K4.bwd's shapes on the bf16 training path (shape, rising logits): the
#: SD3 mid-blocks and the 2D constraint decoder's on the shipped clip's
#: 5 latent frames of 32x32, on the shipped images' 8 of 40x40, and a
#: ragged S on rising logits (the forward's running max raised)
K4_BWD_SHAPES = [((5, 1024, 512), False), ((8, 1600, 512), False),
                 ((1, 1100, 512), True)]
#: K4.bwd's small checks (shape, rising), held to the same bounds by the
#: card tests and by planted_faults.py: every head width, ragged S, a
#: scale of 0.125 at C = 64
K4_BWD_CHECK_SHAPES = [((2, 600, 64), False), ((1, 1100, 128), True),
                       ((1, 100, 256), False), ((3, 33, 512), True),
                       ((1, 1100, 512), True)]


def attention_module():
    from cvvae_tpu_torch.ops.kernels import attention
    return attention


def k4_bwd_inputs(shape, dev, rising=False):
    """q, k, v as ``k4_inputs`` makes them (bf16), K4's output and
    logsumexp on them (the plain versions' on the CPU), dO ~ N(0, 1), and
    the scale."""
    attention = attention_module()
    q, k, v = k4_inputs(shape, dev, torch.bfloat16, rising)
    scale = shape[-1] ** -0.5
    if q.device.type == "cpu":
        out = attention.flash_attention_plain(q, k, v, scale)
        lse = attention.flash_attention_lse_plain(q, k, scale)
    else:
        out, lse = attention._launch(q, k, v, scale, True)
    return q, k, v, out, randn(shape, 45, dev, torch.bfloat16), lse, scale


def k4_bwd_check(q, k, v, o, do, lse, scale):
    """K4.bwd against its plain version on the same inputs: (worst max
    |d|, excess over K4_BWD_MAX * max|ref| and K4_BWD_RMS, text, the
    kernel's (dq, dk, dv))."""
    attention = attention_module()
    got = attention.flash_attention_backward(q, k, v, o, do, lse, scale)
    ref = attention.flash_attention_backward_plain(q, k, v, o, do, lse,
                                                   scale)
    worst, excess, parts = 0.0, -math.inf, []
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        if g.shape != r.shape or g.dtype != torch.bfloat16:
            return math.inf, math.inf, f"{name} {tuple(g.shape)} {g.dtype}", got
        err, _, ref_max, rms = compare(g, r)
        worst = max(worst, err)
        excess = max(excess, err - K4_BWD_MAX * ref_max, rms - K4_BWD_RMS)
        parts.append(f"{name} max|d|/max|ref| {err / ref_max!r} rms {rms!r}")
    return worst, excess, ("; ".join(parts) + f" (<= {K4_BWD_MAX}, "
                           f"{K4_BWD_RMS})"), got


def library_attention_backward(q, k, v, do, scale):
    """A callable of SDPA's backward on K4.bwd's inputs viewed as (B, 1
    head, S, C) (the forward made here, untimed), and the name of the
    SDPA backend whose kernels ran it (from a profile of one call)."""
    leaves = [t[:, None].detach().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                           scale=scale)
    grad = do[:, None]

    def call():
        return torch.autograd.grad(out, leaves, grad, retain_graph=True)

    call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    backend = next((b for b, tag in (("flash", "flash"),
                                     ("efficient", "fmha"),
                                     ("efficient", "efficient"),
                                     ("cudnn", "cudnn")) if tag in names),
                   "math" if "gemm" in names or "sm90" in names else
                   f"unknown ({names[:120]})")
    return call, backend


def k1_bwd_inputs(shape, dev, dtype):
    """x, weight, bias as ``k1_inputs`` makes them, and dy ~ N(0, 1)."""
    x, w, b = k1_inputs(shape, dev, dtype)
    return x, randn(shape, 4, dev, dtype), w, b


def k1_bwd_check(x, dy, w, b, groups, eps, silu, per_frame):
    """K1.bwd against its plain version on K1's saved statistics:
    ({"dx", "dweight", "dbias"}: ||d|| / ||ref||, the kernel's (dx, dw,
    db), the kernel's statistics)."""
    from cvvae_tpu_torch.ops.kernels import groupnorm
    _, mean, inv = groupnorm._launch(x, w, b, groups, eps, silu, per_frame,
                                     True)
    kw = dict(silu=silu, per_frame=per_frame)
    got = groupnorm.group_norm_silu_backward(dy, x, w, b, mean, inv, **kw)
    ref = groupnorm.group_norm_silu_backward_plain(dy, x, w, b, mean, inv,
                                                   **kw)
    rel = {k: compare(g, r)[3] for k, g, r in
           zip(("dx", "dweight", "dbias"), got, ref)}
    return rel, got, (mean, inv)


def k2_bwd_check(dy, n, t, with_bias, drop_first=True):
    """K2.bwd against its plain version: (phases bit-equal, excess of
    d(bias) over its bound, kernel's (phases, dbias)).  d(bias) is held to
    the float64 sum within the bound of its fixed-order summation
    (``shuffle.bwd_plan``): each term passes through at most
    ``bias_adds`` fp32 roundings, bias_adds * 2^-24 * sum|dy| of the
    channel, then one rounding of the result."""
    from cvvae_tpu_torch.ops.kernels import shuffle
    phases, db = shuffle.subpixel_interleave_backward(
        dy, n=n, t=t, drop_first=drop_first, with_bias=with_bias)
    ref, _ = shuffle.subpixel_interleave_backward_plain(
        dy, n=n, t=t, drop_first=drop_first, with_bias=False)
    exact = all(torch.equal(a, r) for a, r in zip(phases, ref))
    excess = 0.0
    if with_bias:
        b, _, h2, w2, c = dy.shape
        plan = shuffle.bwd_plan(
            b, t, h2 // 2, w2 // 2, c, n, dy.element_size(),
            torch.cuda.get_device_properties(dy.device).multi_processor_count,
            all(p.data_ptr() % 16 == 0 for p in [dy] + phases))
        full = dy.double()
        if n > 1 and drop_first:
            full = torch.cat([full.new_zeros((b, 1) + tuple(dy.shape[2:])),
                              full], 1)
        full = full.reshape(b, t, n, h2, w2, c)
        want = full.sum(dim=(0, 1, 3, 4)).reshape(-1)
        mag = full.abs().sum(dim=(0, 1, 3, 4)).reshape(-1)
        tol = plan["bias_adds"] * 2.0 ** -24 * mag + 2.0 ** -24 * want.abs()
        excess = ((db.double() - want).abs() - tol).max().item()
    return exact, excess, (phases, db)


def k3_bwd_excess(dw, db, x, dy, spec, terms):
    """(largest |got - exact| / max|exact| of dW and dbias, excess over the
    bound) of K3.bwd's (dw, db) for (x, dy, spec) against the float64
    sums: |got - exact| <= terms * 2^-24 * sum|x * dy| + 2^-24 * |exact|
    (dbias: sum|dy|), ``terms`` from ``stem.bwd_plan``."""
    from cvvae_tpu_torch.ops.kernels.stem import stem_conv3d_backward_plain
    x64, dy64 = x.double(), dy.double()
    want = stem_conv3d_backward_plain(x64, dy64, spec)
    mag = stem_conv3d_backward_plain(x64.abs(), dy64.abs(), spec)
    del x64, dy64
    worst, excess = 0.0, -math.inf
    for got, ref, m in zip((dw, db), want, mag):
        if got.shape != ref.shape or not torch.isfinite(got).all():
            return math.inf, math.inf
        d = (got.double() - ref).abs()
        tol = terms * 2.0 ** -24 * m + 2.0 ** -24 * ref.abs()
        excess = max(excess, (d - tol).max().item())
        worst = max(worst, d.max().item() / ref.abs().max().item())
    return worst, excess


def k3_bwd_check(x, dy, spec):
    """K3.bwd against the float64 sums within its plan's bound
    (``k3_bwd_excess``): (worst relative error, excess, text, the
    kernel's (dw, db))."""
    from cvvae_tpu_torch.ops.kernels import stem
    dw, db = stem.stem_conv3d_backward(x, dy, spec)
    plan = stem.bwd_plan(*dy.shape[:4], torch.cuda.get_device_properties(
        x.device).multi_processor_count, x.dtype)
    worst, excess = k3_bwd_excess(dw, db, x, dy, spec, plan["terms"])
    return worst, excess, (f"max|d|/max|exact| {worst!r}, excess over "
                           f"{plan['terms']}*2^-24*sum|x dy|+2^-24*|exact| "
                           f"{excess!r}"), (dw, db)


def stem_backward_yardstick(x, dy, spec):
    """The yardstick of K3.bwd: the edge pad materialised (``F.pad``
    replicate) and ``torch.nn.grad.conv3d_weight`` on it, two calls;
    no one PyTorch call computes the function."""
    (t0, t1), (h0, h1), (w0, w1) = spec.pads
    xn = x.permute(0, 4, 1, 2, 3)
    dyn = dy.permute(0, 4, 1, 2, 3)
    shape = (dy.shape[-1], x.shape[-1], 3, 3, 3)
    mode = "replicate" if spec.modes[0] == "edge" else "constant"

    def call():
        xp = torch.nn.functional.pad(xn, (0, 0, 0, 0, t0, t1), mode=mode)
        return torch.nn.grad.conv3d_weight(xp, shape, dyn,
                                           padding=(0, h0, w0))
    return call


def library_group_norm_backward(dy, x, mean, inv, w, groups, per_frame):
    """A callable of one ``native_group_norm_backward`` on K1.bwd's
    inputs in its own (N, C, HxW) layout (made here, untimed): the library
    yardstick of K1.bwd without SiLU."""
    b = x.shape[0] * (x.shape[1] if per_frame else 1)
    c = x.shape[-1]
    xn = x.reshape(b, -1, c).transpose(1, 2).contiguous()
    dyn = dy.reshape(b, -1, c).transpose(1, 2).contiguous()
    m, r = mean.to(x.dtype).contiguous(), inv.to(x.dtype).contiguous()
    wn = w.to(x.dtype)
    return lambda: torch.ops.aten.native_group_norm_backward(
        dyn, xn, m, r, wn, b, c, xn.shape[2], groups, [True, True, True])


def _train_kernels(dev, summary):
    """K1.bwd and K2.bwd at the training path's shapes against their plain
    versions, fp32 and bf16; twice bit-identical; timed in both dtypes in
    turns (plain, kernel, kernel, plain, then the library call where there
    is one).  K3.bwd at K3_BWD_SHAPES the same way, held to the float64
    sums (``k3_bwd_check``), with the edge pad and ``conv3d_weight`` as its
    yardstick (``yardstick_ms``; its ``library_ms`` is null: no one call
    computes the function).  K4.bwd (bf16) at K4_BWD_SHAPES the same way, with SDPA's
    backward as its library call, then checked (not timed) at
    K4_BWD_CHECK_SHAPES."""
    from cvvae_tpu_torch.ops.kernels import attention, groupnorm, shuffle, stem

    def put(key, label, err, ok, text, timing=None, extra=None):
        summary[key]["max_abs_err"] = max(summary[key]["max_abs_err"], err)
        if timing:
            shape, dtype, k_ms, p_ms, l_ms, kw = timing
            b_ms, by = bound(key, shape, dtype, **kw)
            summary[key]["timed"].append(dict(
                shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                where=label.split(" float")[0].split(" bfloat")[0],
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                share=b_ms / k_ms, library_ms=l_ms, **(extra or {})))
            text += (f"; {k_ms:.3f} ms (plain {p_ms:.3f}, library "
                     f"{'none' if l_ms is None else f'{l_ms:.3f}'}, bound "
                     f"{b_ms:.3f} by {by}, {100 * b_ms / k_ms:.1f}%)")
        say(f"[train] {key} {label}: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{key} {label}: disagrees with its plain "
                             f"version")

    for where, shape, groups, eps, silu, per_frame in K1_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, dy, w, b = k1_bwd_inputs(shape, dev, dtype)
            rel, got, stats = k1_bwd_check(x, dy, w, b, groups, eps, silu,
                                           per_frame)
            kw = dict(silu=silu, per_frame=per_frame)
            again = groupnorm.group_norm_silu_backward(dy, x, w, b, *stats,
                                                       **kw)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            del got, again
            tol = K1_BWD_RMS[dtype]
            ok = same and all(v <= tol for v in rel.values())
            text = (f"||d||/||ref|| dx {rel['dx']!r} dweight "
                    f"{rel['dweight']!r} dbias {rel['dbias']!r} (<= {tol}); "
                    f"twice bit-identical {same}")
            lib = (None if silu else library_group_norm_backward(
                dy, x, *stats, w, groups, per_frame))
            k_ms, p_ms, l_ms = in_turns(
                lambda: groupnorm.group_norm_silu_backward_plain(
                    dy, x, w, b, *stats, **kw),
                lambda: groupnorm.group_norm_silu_backward(
                    dy, x, w, b, *stats, **kw), lib)
            timing = (shape, dtype, k_ms, p_ms, l_ms, dict(silu=silu))
            del lib
            put("K1.bwd", f"{where} {tuple(shape)} {dtype}", rel["dx"], ok,
                text, timing)
            del x, dy, stats
            torch.cuda.empty_cache()
    for shape, n in K2_BWD_SHAPES:
        b, t, h, w, nc = shape
        for dtype in (torch.float32, torch.bfloat16):
            dy = randn((b, n * t - (n > 1), 2 * h, 2 * w, nc // n), 9, dev,
                       dtype)
            exact, excess, (ph, db) = k2_bwd_check(dy, n, t, True)
            ph2, db2 = shuffle.subpixel_interleave_backward(dy, n=n, t=t)
            same = (all(torch.equal(a, c) for a, c in zip(ph, ph2))
                    and torch.equal(db, db2))
            del ph, ph2, db2
            ok = exact and excess <= 0.0 and same
            text = (f"phases bit-exact {exact}; dbias excess over its fp32 "
                    f"summation bound {excess!r}; twice bit-identical {same}")
            k_ms, p_ms, _ = in_turns(
                lambda: shuffle.subpixel_interleave_backward_plain(
                    dy, n=n, t=t),
                lambda: shuffle.subpixel_interleave_backward(dy, n=n, t=t))
            put("K2.bwd", f"upsample tail {tuple(shape)} n={n} {dtype}",
                0.0, ok, text, (shape, dtype, k_ms, p_ms, None, dict(n=n)))
            del dy
            torch.cuda.empty_cache()
    spec = k3_spec("edge")
    for where, shape in K3_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = k3_inputs(shape, 3, dev, dtype)[0]
            dy = randn(tuple(shape) + (stem.COUT,), 33, dev, dtype)
            worst, excess, text, got = k3_bwd_check(x, dy, spec)
            again = stem.stem_conv3d_backward(x, dy, spec)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            del got, again
            k_ms, p_ms, y_ms = in_turns(
                lambda: stem.stem_conv3d_backward_plain(x, dy, spec),
                lambda: stem.stem_conv3d_backward(x, dy, spec),
                stem_backward_yardstick(x, dy, spec))
            put("K3.bwd", f"{where} {tuple(shape)} {dtype}", worst,
                excess <= 0.0 and same,
                f"{text}; twice bit-identical {same}; yardstick (replicate "
                f"pad + conv3d_weight, two calls: no one call) {y_ms:.3f} ms",
                (tuple(shape) + (3,), dtype, k_ms, p_ms, None, {}),
                dict(yardstick_ms=y_ms))
            del x, dy
            torch.cuda.empty_cache()
    for shape, rising in K4_BWD_SHAPES:
        args = k4_bwd_inputs(shape, dev, rising)
        err, excess, text, got = k4_bwd_check(*args)
        again = attention.flash_attention_backward(*args)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        del got, again
        text += f"; twice bit-identical {same}"
        if rising:
            q, k = args[:2]
            text += (f"; the forward's max raised {k4_max_raises(q, k, args[-1])!r}"
                     f" times a row after tile 0")
        lib, backend = library_attention_backward(*args[:3], args[4], args[6])
        k_ms, p_ms, l_ms = in_turns(
            lambda: attention.flash_attention_backward_plain(*args),
            lambda: attention.flash_attention_backward(*args), lib)
        put("K4.bwd", f"{tuple(shape)} {torch.bfloat16}"
            f"{' rising logits' if rising else ''}", err,
            excess <= 0.0 and same,
            text + f"; library: SDPA's backward, backend {backend}",
            (shape, torch.bfloat16, k_ms, p_ms, l_ms, {}))
        del args, lib
        torch.cuda.empty_cache()
    for shape, rising in K4_BWD_CHECK_SHAPES:
        args = k4_bwd_inputs(shape, dev, rising)
        err, excess, text, got = k4_bwd_check(*args)
        again = attention.flash_attention_backward(*args)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        put("K4.bwd", f"check {tuple(shape)} {torch.bfloat16}"
            f"{' rising logits' if rising else ''}", err,
            excess <= 0.0 and same, f"{text}; twice bit-identical {same}")
        del args, got, again


#: phase 8's card-against-CPU training clip (B, T, H, W, 3)
TRAIN_CHECK_CLIP = (1, 5, 32, 32, 3)
#: card against CPU, fp32 with TF32 off: each metric to TRAIN_LOSS_RTOL *
#: (1 + |cpu|) (the kernel checks' form: loss/g and the logits are means
#: of O(1) patch logits that cancel to ~0.03, where a rounding-level
#: difference of 3.5e-6 is 1.1e-4 of the mean), the gradients' global
#: norms to TRAIN_LOSS_RTOL relative, the parameter updates elementwise to
#: TRAIN_UPDATE_TOL * lr -- the CPU test's (tests/torch_train_parity.py)
#: update bound, and, as there, from a state past its first steps: at an
#: optimizer's first step Adam's update is g / (|g| + eps), about sign(g)
#: * lr, which turns a rounding-level difference of a near-zero gradient
#: into a whole lr
TRAIN_LOSS_RTOL = 1e-4
TRAIN_UPDATE_TOL = 1e-2
SHIPPED_CONFIG = os.path.join(ROOT, "configs", "sd3_latent_constraint.yaml")


def shipped_engine_config(**optim):
    """The shipped SD3 latent-constraint recipe's EngineConfig, with the
    optimizer fields in ``optim`` replaced."""
    import dataclasses
    from cvvae_tpu_torch.utils.config import (instantiate_from_config,
                                              load_configs)
    cfg = instantiate_from_config(
        load_configs([SHIPPED_CONFIG])["model"]["engine"])
    return dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                              **optim))


def v1_engine_config(**optim):
    """The v1 family on the shipped recipe: its EngineConfig with
    ``family="v1"``, the full-width v1 net (``VAE1Config()``: ch 128,
    ch_mult (1, 2, 4, 4)) and the constraint decoder at its v1 default
    (SD2.1-named, 4 latent channels).  The reference ships no v1 training
    YAML."""
    import dataclasses
    from cvvae_tpu_torch.models.vae2d import VAE2DConfig
    from cvvae_tpu_torch.models.vae_v1 import VAE1Config
    return dataclasses.replace(
        shipped_engine_config(**optim), family="v1", net=VAE1Config(),
        constraint_decoder=VAE2DConfig(naming="sd21", latent_channels=4))


#: the kernels a family's fp32 G + D step must launch, and those it must
#: not (fp32 attention takes the exact path; SD3 has no pixel stem)
TRAIN_KERNELS = {"sd3": (("K1", "K1.bwd", "K2", "K2.bwd"),
                         ("K3", "K3.bwd", "K4", "K4.bwd", "K5", "K5.stage")),
                 "v1": (("K1", "K1.bwd", "K2", "K2.bwd", "K3", "K3.bwd"),
                        ("K4", "K4.bwd", "K5", "K5.stage"))}


def _cpu(state_dict):
    if isinstance(state_dict, torch.Tensor):
        return state_dict.detach().cpu().clone()
    if isinstance(state_dict, dict):
        return {k: _cpu(v) for k, v in state_dict.items()}
    return state_dict


def _to_cpu_state(st):
    """A copy of TrainState ``st`` on the CPU."""
    import copy
    out = copy.copy(st)
    out.params = copy.deepcopy(st.params).cpu()
    out.disc_params = copy.deepcopy(st.disc_params).cpu()
    return out


def _train_card_vs_cpu(dev, family="sd3"):
    """One G step then one D step of the full-width shipped recipe
    (random LPIPS and constraint decoder; ``family`` "v1":
    ``v1_engine_config``), each from one state with one set of draws, on
    the card and on the CPU.  The state is the card's
    after a G step (the gate closed) and a D step from the seeded init, so
    both optimizers hold moments; the D step starts from the CPU's state
    after its G step on both.  Returns the card's launches in the two
    compared steps, and (the card's engine, its state, the carried-over
    state dict, the clip, the draws) for the checks after it."""
    import warnings
    from cvvae_tpu_torch.training.engine import TrainingEngine, named_params

    cfg = (v1_engine_config if family == "v1" else shipped_engine_config)(
        num_warmup_steps=0)
    x = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, TRAIN_CHECK_CLIP).astype(np.float32))
    b, t, h, w, _ = TRAIN_CHECK_CLIP
    g = torch.Generator().manual_seed(6)
    shape = (b, (t - 1) // 4 + 1, h // 8, w // 8, cfg.latent_channels)
    draws = [{"noise": torch.randn(shape, generator=g),
              "offsets": torch.randint(1, 5, ((t - 1) // 4,), generator=g)},
             {"noise": torch.randn(shape, generator=g)}]
    t_setup = time.perf_counter()
    engines = {}
    for d in (dev, "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            engines[str(d)] = TrainingEngine(cfg, allow_random_lpips=True,
                                             seed=0, device=d)
        engines[str(d)].keep_grads = True
    eng = engines[str(dev)]
    st = eng.init_state(0)
    # the CPU's modules: a copy of the card's (their weights are loaded
    # from the carried-over state below), quicker than a seeded init
    states = {str(dev): st, "cpu": _to_cpu_state(st)}
    for i in range(2):  # a G step, then a D step: the carried-over state
        st, _ = eng.train_step(st, {"frames": x.to(dev)},
                               torch.Generator(dev).manual_seed(i))
    start = carried = _cpu(st.state_dict())
    say(f"[train] card-vs-cpu {family}: engines, states and the card's two "
        f"carried-over steps in {time.perf_counter() - t_setup:.2f}s")

    def params_of(st, prefix):
        return named_params(st.params if prefix == "g" else st.disc_params)

    failures, counts, lr = [], {}, {}
    for kind, step_draws in zip("gd", draws):
        out, grads = {}, {}
        for d in ("cpu", dev):
            e = engines[str(d)]
            st = states[str(d)].load_state_dict(start)
            step = st.step
            before = {k: v.detach().cpu().clone()
                      for k, v in params_of(st, kind).items()}
            if d != "cpu":
                torch.cuda.synchronize()
                reset_launch_counts()
            t0 = time.perf_counter()
            st, m = e.train_step(
                st, {"frames": x.to(d)},
                draws={k: v.to(d) for k, v in step_draws.items()})
            if d != "cpu":
                torch.cuda.synchronize()
                counts = {k: counts.get(k, 0) + v
                          for k, v in launch_counts().items()}
            seconds = time.perf_counter() - t0
            zero = [k for k, gr in e.last_grads.items()
                    if not bool((gr != 0).any())]
            delta = {k: v.detach().cpu() - before[k]
                     for k, v in params_of(st, kind).items()}
            grads[str(d)] = {k: v.detach().cpu() for k, v in
                             e.last_grads.items()}
            out[str(d)] = ({k: float(v) for k, v in m.items()},
                           float(e.last_grad_norm), zero, delta)
            if d == "cpu":
                after_cpu = _cpu(st.state_dict())
            lr[kind] = (e.lr_schedule_g if kind == "g"
                        else e.lr_schedule_d)(step)
            say(f"[train] card-vs-cpu {family} {d}: {kind.upper()} step "
                f"{step} of the full-width recipe on {TRAIN_CHECK_CLIP} in "
                f"{seconds:.2f}s")
        (mc, nc, _, dc), (mg, ng, zero, dg) = out["cpu"], out[str(dev)]
        worst, worst_k = max((abs(mg[k] - mc[k]) / (1 + abs(mc[k])), k)
                             for k in mc)
        upd = max((dg[k] - dc[k]).abs().max().item() for k in dg) / lr[kind]
        moved = max(v.abs().max().item() for v in dg.values()) / lr[kind]
        say(f"[train] {family} {kind.upper()} step: losses {json.dumps(mg)}; worst "
            f"|card - cpu| / (1 + |cpu|) {worst!r} ({worst_k}, <= "
            f"{TRAIN_LOSS_RTOL}); gradient global norm card {ng!r} cpu "
            f"{nc!r}; updates max |card - cpu| / lr {upd!r} (<= "
            f"{TRAIN_UPDATE_TOL}), largest update / lr {moved!r}; "
            f"parameters with an all-zero gradient {zero}")
        gc, gg = grads["cpu"], grads[str(dev)]
        gmax = max(v.abs().max().item() for v in gc.values())
        rows = []
        for k in dg:
            err = (dg[k] - dc[k]).abs() / lr[kind]
            n_over = int((err > TRAIN_UPDATE_TOL).sum())
            rows.append((err.max().item(), k, n_over, err.numel(),
                         gc[k].abs().max().item() / gmax,
                         (gg[k] - gc[k]).abs().max().item() / gmax))
        rows.sort(reverse=True)
        say(f"[train] {family} {kind.upper()} step: elements past {TRAIN_UPDATE_TOL} lr "
            f"{sum(r[2] for r in rows)} of {sum(r[3] for r in rows)}; worst "
            f"(update err / lr, param, elements past, numel, max|g| / "
            f"max|g| of all, max|g card - g cpu| / max|g| of all): "
            f"{rows[:6]}")
        if worst > TRAIN_LOSS_RTOL or abs(ng - nc) > TRAIN_LOSS_RTOL * nc:
            failures.append(f"{kind} losses or gradient norm")
        if upd > TRAIN_UPDATE_TOL or moved == 0.0:
            failures.append(f"{kind} parameter updates")
        if zero:
            failures.append(f"{kind} zero gradients {zero[:5]}")
        if not all(math.isfinite(v) for v in mg.values()):
            failures.append(f"{kind} non-finite losses")
        start = after_cpu
    say(f"[train] {family}: launches in the card's compared G + D steps: "
        f"{counts}")
    need, none = TRAIN_KERNELS[family]
    if any(counts.get(k, 0) == 0 for k in need) or any(
            counts.get(k, 0) for k in none):
        failures.append(f"launches {counts}")
    card_state = states[str(dev)]
    del engines, states, st
    if failures:
        raise SystemExit(f"{family} training card against CPU: {failures}")
    return counts, (eng, card_state, carried, x, draws)


def _train_repeat(dev, ctx):
    """The card's fp32 G step twice from the same state and draws, with
    cuDNN's default algorithms, then with
    ``torch.backends.cudnn.deterministic``, then with PyTorch's
    deterministic algorithms too (``use_deterministic_algorithms(True,
    warn_only=True)``, which names each operation that has no
    deterministic version): whether the card's step is bitwise
    reproducible (metrics, gradients, parameters after), and the largest
    differences where it is not."""
    import warnings
    from cvvae_tpu_torch.training.engine import named_params

    eng, st, start, x, draws = ctx
    out = {}
    for det in ("default", "cudnn", "all"):
        torch.backends.cudnn.deterministic = det != "default"
        torch.use_deterministic_algorithms(det == "all", warn_only=True)
        runs = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                st.load_state_dict(start)
                _, m = eng.train_step(st, {"frames": x.to(dev)},
                                      draws={k: v.to(dev)
                                             for k, v in draws[0].items()})
                runs.append(({k: float(v) for k, v in m.items()},
                             {k: g.detach().clone()
                              for k, g in eng.last_grads.items()},
                             {k: p.detach().clone() for k, p in
                              named_params(st.params).items()}))
        ops = sorted({str(w.message).split(" does not have")[0][:160]
                      for w in caught if "deterministic" in str(w.message)})
        (m0, g0, p0), (m1, g1, p1) = runs
        dm = max(abs(m0[k] - m1[k]) / (abs(m0[k]) + 1e-12) for k in m0)
        dg = max((g0[k] - g1[k]).abs().max().item() for k in g0)
        n_g = sum(not torch.equal(g0[k], g1[k]) for k in g0)
        n_p = sum(not torch.equal(p0[k], p1[k]) for k in p0)
        out[det] = (dm, n_g, n_p)
        say(f"[train] card G step twice from one state, deterministic "
            f"algorithms: {det}: metrics bit-equal {dm == 0.0} (largest "
            f"relative difference {dm!r}); gradients differ in {n_g} of "
            f"{len(g0)} tensors (largest |d| {dg!r}); parameters after "
            f"differ in {n_p}; operations without a deterministic version "
            f"{ops}")
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    return out


#: phase 8's bf16 steps: the shipped clip, from the fp32 check's carried-
#: over state (the optimizers hold moments)
TRAIN_BF16_CLIP = (1, 17, 256, 256, 3)
#: the bf16 G and D steps (K4, K4.bwd) against the same steps inside
#: ``no_flash_attention()`` (the exact path and autograd through it), same
#: state and draws: each metric within TRAIN_BF16_RTOL * |ref| (+1e-6), and
#: each parameter tensor's update in the direction of the reference's,
#: cos >= TRAIN_BF16_COS.  K4 and the exact path round the attention's
#: output to bf16 at other places, a few ulps, which the nets carry on
TRAIN_BF16_RTOL = 1e-2
TRAIN_BF16_COS = 0.99
#: bf16 against fp32 ``loss/rec`` from the same state and draws, relative
#: (the bound of the JAX package's own bf16 test)
TRAIN_BF16_REC = 0.1
#: K4 and K4.bwd launches a bf16 step at TRAIN_BF16_CLIP: a G step runs
#: the SD3 encoder's and decoder's mid-block attention and the 2D
#: constraint decoder's (each 5 frames of 32x32 = 1024 tokens, all three
#: needing a gradient: the decoder's is frozen, but z needs one); a D
#: step the SD3 two, without a gradient
TRAIN_BF16_LAUNCHES = {"g": {"K4": 3, "K4.bwd": 3},
                       "d": {"K4": 2, "K4.bwd": 0}}


def bf16_engine(eng):
    """A copy of the TrainingEngine ``eng`` computing in bf16 (its config
    with ``compute_dtype="bfloat16"``, its frozen nets copied on the card
    and cast as the engine casts them), so that no second full-width
    engine is built on the host."""
    import copy
    import dataclasses
    from cvvae_tpu_torch.training import engine
    bf = copy.copy(eng)
    bf.cfg = dataclasses.replace(eng.cfg, compute_dtype="bfloat16")
    bf.compute_dtype = torch.bfloat16
    bf.frozen = {k: None if n is None else copy.deepcopy(n)
                 for k, n in eng.frozen.items()}
    for n in bf.frozen.values():
        if n is not None:
            engine._cast_params_(n, torch.bfloat16)
    return bf


def _train_bf16(dev, ctx):
    """One bf16 G step then one D step of the full-width shipped recipe at
    TRAIN_BF16_CLIP, from the fp32 check's carried-over state, against the
    same steps inside ``no_flash_attention()``; K4 and K4.bwd launched as
    TRAIN_BF16_LAUNCHES says, none in the reference; the G step's
    ``loss/rec`` against fp32's.  Returns the launches of the two kernel
    steps."""
    import contextlib
    from cvvae_tpu_torch.ops.attention import no_flash_attention
    from cvvae_tpu_torch.training.engine import named_params

    eng32, st, start = ctx
    eng = bf16_engine(eng32)
    x = torch.from_numpy(np.random.RandomState(11).uniform(
        -1, 1, TRAIN_BF16_CLIP).astype(np.float32)).to(dev)
    b, t, h, w, _ = TRAIN_BF16_CLIP
    g = torch.Generator().manual_seed(12)
    shape = (b, (t - 1) // 4 + 1, h // 8, w // 8, eng.cfg.latent_channels)
    draws = {"g": {"noise": torch.randn(shape, generator=g).to(dev),
                   "offsets": torch.randint(1, 5, ((t - 1) // 4,),
                                            generator=g).to(dev)},
             "d": {"noise": torch.randn(shape, generator=g).to(dev)}}

    def run(e, kind, state, reference=False):
        st.load_state_dict(state)
        mod = st.params if kind == "g" else st.disc_params
        before = {k: v.detach().clone() for k, v in named_params(mod).items()}
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with no_flash_attention() if reference else contextlib.nullcontext():
            _, m = e.train_step(st, {"frames": x}, draws=draws[kind])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        delta = {k: (v.detach() - before[k]).float()
                 for k, v in named_params(mod).items()}
        return {k: float(v) for k, v in m.items()}, delta, counts, seconds

    failures, launches = [], {}
    state = start
    for kind in "gd":
        got, d_got, counts, s_got = run(eng, kind, state)
        after = _cpu(st.state_dict())  # the D step's start
        ref, d_ref, counts_ref, s_ref = run(eng, kind, state, True)
        worst, worst_k = max((abs(got[k] - ref[k]) / (abs(ref[k]) + 1e-6), k)
                             for k in ref)
        cos = []
        for k, dr in d_ref.items():
            dg = d_got[k]
            if not dr.any() and not dg.any():
                continue
            cos.append((float((dg * dr).sum() / (dg.norm() * dr.norm()
                                                  + 1e-30)), k))
        cos.sort()
        want = TRAIN_BF16_LAUNCHES[kind]
        mine = {k: counts[k] for k in want}
        say(f"[train] bf16 {kind.upper()} step {state['step']} at "
            f"{TRAIN_BF16_CLIP}: {s_got:.3f}s (exact-path reference "
            f"{s_ref:.3f}s); losses {json.dumps(got)}; worst |kernel - "
            f"reference| / |reference| {worst!r} ({worst_k}, <= "
            f"{TRAIN_BF16_RTOL}); updates' cos, lowest {cos[:4]} of "
            f"{len(cos)} tensors (>= {TRAIN_BF16_COS}); launches "
            f"{ {k: v for k, v in counts.items() if v} } (K4, K4.bwd "
            f"expected {want}; reference "
            f"{ {k: v for k, v in counts_ref.items() if v} })")
        if worst > TRAIN_BF16_RTOL or not cos or cos[0][0] < TRAIN_BF16_COS:
            failures.append(f"{kind} against the exact path")
        if mine != want or counts_ref["K4"] or counts_ref["K4.bwd"]:
            failures.append(f"{kind} launches {mine}, reference {counts_ref}")
        if not all(math.isfinite(v) for v in got.values()):
            failures.append(f"{kind} non-finite losses")
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        if kind == "g":
            f32, _, _, s32 = run(eng32, "g", state)
            rel = abs(got["loss/rec"] - f32["loss/rec"]) / abs(f32["loss/rec"])
            say(f"[train] bf16 G step loss/rec {got['loss/rec']!r} against "
                f"fp32's {f32['loss/rec']!r} ({s32:.3f}s): relative {rel!r} "
                f"(<= {TRAIN_BF16_REC})")
            if rel > TRAIN_BF16_REC:
                failures.append("bf16 loss/rec against fp32")
        state = after
    if failures:
        raise SystemExit(f"bf16 training: {failures}")
    return launches


#: phase 8's v1 bf16 steps: (name, batch) -- the shipped clip and the
#: shipped image batch, from the v1 fp32 check's carried-over state
TRAIN_V1_BATCHES = [("clip", (1, 17, 256, 256, 3)),
                    ("images", (8, 1, 320, 320, 3))]


def _train_v1(dev, smi):
    """v1 on the card: one G and one D step card against CPU
    (``_train_card_vs_cpu(dev, "v1")``, K3 and K3.bwd launched), then
    from the carried-over state a bf16 G and D step (``bf16_engine`` of
    the same engine) on each of TRAIN_V1_BATCHES, twice (the first pair of
    a batch shape pays cuDNN's algorithm search): wall s, peak memory,
    launches by kernel, finite losses, K3 and K3.bwd launched in each G
    step.  Returns the launches of the fp32 check and of the bf16 steps."""
    counts, (eng32, st, carried, _, _) = _train_card_vs_cpu(dev, "v1")
    eng = bf16_engine(eng32)
    failures, launches = [], {}
    for (name, shape), again in ((b, a) for b in TRAIN_V1_BATCHES
                                 for a in (False, True)):
        x = torch.from_numpy(np.random.RandomState(13).uniform(
            -1, 1, shape).astype(np.float32)).to(dev)
        state = carried
        for kind in "gd":
            st.load_state_dict(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            _, m = eng.train_step(st, {"frames": x},
                                  torch.Generator(dev).manual_seed(14))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            metrics = {k: float(v) for k, v in m.items()}
            say(f"[train] v1 bf16 {kind.upper()} step {state['step']} on the "
                f"{name} {shape}{', again' if again else ''}: "
                f"{seconds:.3f}s; peak memory {peak:.2f} "
                f"GiB; loss/total {metrics['loss/total']!r} loss/rec "
                f"{metrics['loss/rec']!r} loss/disc {metrics['loss/disc']!r}; "
                f"launches { {k: v for k, v in got.items() if v} }; card "
                f"{smi}")
            if not all(math.isfinite(v) for v in metrics.values()):
                failures.append(f"{name} {kind} non-finite losses")
            if kind == "g" and not (got["K3"] and got["K3.bwd"]):
                failures.append(f"{name} G step launches {got}")
            launches = {k: launches.get(k, 0) + v for k, v in got.items()}
            state = _cpu(st.state_dict())
        del x
    del eng, eng32, st, carried
    if failures:
        raise SystemExit(f"v1 bf16 training: {failures}")
    return counts, launches


def write_train_data(root, seed=0, n_images=16, image_hw=(360, 400),
                     n_videos=2, video_frames=24, video_hw=(288, 320)):
    """Seeded local data for the shipped YAML's two datasets: a tar of
    JPEG images (``image_webdata``, a webdataset shard) and a CSV of cv2
    mp4 clips (``webvid``).  Returns (tar dir, csv dir, video root)."""
    import cv2
    import tarfile

    rng = np.random.RandomState(seed)
    tar_dir, csv_dir, video_root = (os.path.join(root, d)
                                    for d in ("tars", "csv", "videos"))
    for d in (tar_dir, csv_dir, video_root):
        os.makedirs(d, exist_ok=True)
    with tarfile.open(os.path.join(tar_dir, "shard-000000.tar"), "w") as tf:
        for i in range(n_images):
            img = rng.randint(0, 256, image_hw + (3,), dtype=np.uint8)
            ok, buf = cv2.imencode(".jpg", img)
            assert ok
            for ext, data in (("jpg", buf.tobytes()),
                              ("txt", f"image {i}".encode())):
                info = tarfile.TarInfo(f"{i:06d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    rows = ["path,name"]
    for i in range(n_videos):
        path = os.path.join(video_root, f"clip{i}.mp4")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                              (video_hw[1], video_hw[0]))
        for _ in range(video_frames):
            out.write(rng.randint(0, 256, video_hw + (3,), dtype=np.uint8))
        out.release()
        rows.append(f"clip{i}.mp4,clip {i}")
    with open(os.path.join(csv_dir, "clips.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return tar_dir, csv_dir, video_root


#: phase 8's run of train.main on the shipped YAML
TRAIN_MAIN_STEPS = 6


def write_train_checkpoints(root, seed=17):
    """The two checkpoints phase 8's ``train.main`` starts from, written
    in the reference's layout (``reference_layout``) from the port's
    seeded random nets at the shipped recipe's full width: the frozen
    constraint decoder (``decoder.*``, .safetensors) and a warm start of
    the generator (``encoder.*``, ``decoder.*``, a Lightning .ckpt).
    Returns (decoder path, warm-start path, the decoder's state dict)."""
    from safetensors.torch import save_file

    from cvvae_tpu_torch.models.vae2d import Decoder2D
    from cvvae_tpu_torch.training.engine import VAEParams

    cfg = shipped_engine_config()
    g = torch.Generator().manual_seed(seed)
    dec = Decoder2D(cfg.constraint_decoder, g).state_dict()
    dec_path = os.path.join(root, "constraint_decoder.safetensors")
    save_file(reference_layout({f"decoder.{k}": v for k, v in dec.items()}),
              dec_path)
    warm = {k: v for k, v in VAEParams(cfg, g).state_dict().items()
            if k.startswith(("encoder.", "decoder."))}
    warm_path = os.path.join(root, "warm_start.ckpt")
    torch.save({"state_dict": reference_layout(warm)}, warm_path)
    return dec_path, warm_path, dec


class _Tee(io.TextIOBase):
    """Standard output that is also kept, line by line."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def k1_bwd_shape_ms(key, dev):
    """K1.bwd's CUDA-event ms at one (B', S, C, SiLU, dtype) of
    ``bwd_launches_by_shape``, on ``k1_bwd_inputs`` of shape (B', S, C)
    with gcd(32, C) groups and K1's statistics."""
    from cvvae_tpu_torch.ops.kernels import groupnorm
    b, s, c, silu, dtype = key
    x, dy, w, bias = k1_bwd_inputs((b, s, c), dev, getattr(torch, dtype))
    _, mean, inv = groupnorm._launch(x, w, bias, math.gcd(32, c), 1e-6, silu,
                                     False, True)
    return time_ms(lambda: groupnorm.group_norm_silu_backward(
        dy, x, w, bias, mean, inv, silu=silu))


def _k1_bwd_by_step(dev, compute, step_log, per_shape, smi):
    """For the first G and D step of each batch kind: K1.bwd's launches by
    (B', S, C, SiLU, dtype), and the sum over them of launches x the
    kernel's time at that shape (``k1_bwd_shape_ms``)."""
    seen, ms = set(), {}
    for e, shapes in zip(step_log, per_shape):
        if (e["kind"], e["shape"]) in seen:
            continue
        seen.add((e["kind"], e["shape"]))
        for key in shapes:
            if key not in ms:
                ms[key] = k1_bwd_shape_ms(key, dev)
        total = sum(n * ms[k] for k, n in shapes.items())
        rows = sorted(([list(k), n, ms[k]] for k, n in shapes.items()),
                      key=lambda r: -r[1] * r[2])
        say(f"[train] main {compute} {e['kind'].upper()} {e['shape']}: "
            f"K1.bwd {sum(shapes.values())} launches at {len(shapes)} "
            f"shapes, sum of launches x ms {total:.3f} ms of the step's "
            f"{1e3 * e['seconds']:.1f} ms; by [B', S, C, SiLU, dtype], "
            f"launches, ms: {json.dumps(rows)}; card {smi}")


def _train_main(dev, smi, compute="float32"):
    """``cvvae_tpu_torch.train.main`` on the shipped YAML at full width
    with the shipped batches, in ``compute`` ("float32" or "bfloat16",
    through the dotlist), on seeded local data, from a frozen constraint
    decoder and a warm start written here (``write_train_checkpoints``):
    the frozen decoder bit-equal to the written one (in the compute
    dtype), both warm-start subtrees loaded, per-step wall time by kind
    and batch shape, peak memory, finite losses, launches a step, and a
    checkpoint written and reloaded.  Returns the run's launches."""
    import contextlib
    import tempfile
    import warnings
    from cvvae_tpu_torch import train
    from cvvae_tpu_torch.training.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as tmp:
        tar_dir, csv_dir, video_root = write_train_data(tmp, seed=8)
        dec_path, warm_path, dec_state = write_train_checkpoints(tmp)
        logdir = os.path.join(tmp, "run")
        per_step, per_shape = [], []
        by_shape = kernel_modules()["K1"].bwd_launches_by_shape
        last = [launch_counts(), by_shape.copy()]

        def on_step(entry):
            now = launch_counts()
            per_step.append({k: now[k] - last[0][k] for k in now})
            per_shape.append(by_shape - last[1])
            last[0] = now
            last[1] = by_shape.copy()

        argv = ["--base", SHIPPED_CONFIG, "--train", "--max_steps",
                str(TRAIN_MAIN_STEPS), "--logdir", logdir,
                "model.allow_random_lpips=true",
                f"model.engine.params.compute_dtype={compute}",
                f"data.train.datasets.image_webdata.urls_or_dir={tar_dir}",
                f"data.train.datasets.webvid.urls_or_dir={csv_dir}",
                f"data.train.datasets.webvid.decoder.params.video_root="
                f"{video_root}",
                f"trainer.ckpt_every={TRAIN_MAIN_STEPS}",
                "trainer.image_every=0",
                f"model.frozen_ckpts.constraint_decoder={dec_path}",
                f"model.ckpt_path={warm_path}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        last[:] = [launch_counts(), by_shape.copy()]
        t0 = time.perf_counter()
        tee = _Tee(sys.stdout)
        with warnings.catch_warnings(), contextlib.redirect_stdout(tee):
            warnings.simplefilter("ignore")
            trainer, state = train.main(argv, step_callback=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        frozen = trainer.engine.frozen["constraint_decoder"].state_dict()
        dtype = getattr(torch, compute)
        frozen_same = set(frozen) == set(dec_state) and all(
            torch.equal(frozen[k].cpu(), v.to(dtype)) for k, v in
            dec_state.items())
        warm_line = "[train] warm-started 2 subtree(s) ['decoder', 'encoder']"
        warm = any(s.startswith(warm_line) for s in "".join(
            tee.text).splitlines())
        say(f"[train] main {compute}: the frozen constraint decoder bit-equal "
            f"to the checkpoint written ({compute}): {frozen_same}; both "
            f"warm-start subtrees loaded: {warm}")
        if not (frozen_same and warm):
            raise SystemExit("train.main: the frozen decoder or the warm "
                             "start is not the checkpoint's")
        _k1_bwd_by_step(dev, compute, trainer.step_log, per_shape, smi)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        by = {}
        for e in trainer.step_log:
            by.setdefault(f"{e['kind']} {e['shape']}", []).append(e["seconds"])
        finite = all(math.isfinite(v) for e in trainer.step_log
                     for v in e["metrics"].values())
        for e, launches in zip(trainer.step_log, per_step):
            say(f"[train] main {compute} step {e['step']} "
                f"{e['kind'].upper()} "
                f"{e['shape']}: {e['seconds']:.3f}s; loss/total "
                f"{e['metrics']['loss/total']!r} loss/rec "
                f"{e['metrics']['loss/rec']!r} loss/disc "
                f"{e['metrics']['loss/disc']!r}; launches "
                f"{ {k: v for k, v in launches.items() if v} }")
        later = {k: (v[1:] if len(v) > 1 else v) for k, v in by.items()}
        say(f"[train] main {compute}: {TRAIN_MAIN_STEPS} steps in "
            f"{wall:.2f}s; wall s "
            f"per step by kind and batch shape, after the first of each: "
            f"{json.dumps({k: statistics.mean(v) for k, v in later.items()})}"
            f" (all: {json.dumps(by)}); peak memory {peak:.2f} GiB; finite "
            f"losses {finite}; card {smi}")
        ckpt = CheckpointManager(logdir, rolling_every=TRAIN_MAIN_STEPS)
        step = ckpt.latest_step()
        fresh = _to_cpu_state(state)  # zeroed, then restored
        with torch.no_grad():
            for t in list(fresh.params.parameters()) + list(
                    fresh.disc_params.parameters()):
                t.zero_()
        fresh.step = 0
        ckpt.restore(fresh)
        same = fresh.step == state.step and all(
            torch.equal(a, b.cpu()) for a, b in zip(
                list(fresh.params.state_dict().values())
                + list(fresh.disc_params.state_dict().values()),
                list(state.params.state_dict().values())
                + list(state.disc_params.state_dict().values())))
        fp32 = all(t.dtype == torch.float32 for t in
                   list(fresh.params.parameters())
                   + list(fresh.disc_params.parameters()))
        say(f"[train] main {compute}: checkpoint at step {step} written and "
            f"reloaded bit-equal into a zeroed state: {same}; fp32 {fp32}")
        kinds = {e["kind"] for e in trainer.step_log}
        if not (finite and same and fp32 and step == TRAIN_MAIN_STEPS
                and kinds == {"g", "d"}):
            raise SystemExit("train.main: non-finite losses, a missing step "
                             "kind or a checkpoint that does not reload")
    need = ("K1", "K1.bwd", "K2", "K2.bwd") + (
        ("K4", "K4.bwd") if compute == "bfloat16" else ())
    if any(counts[k] == 0 for k in need):
        raise SystemExit(f"train.main: a training kernel never ran {counts}")
    return counts


# --------------------------------------------------------------------------
# phase 9: the latent-compat diffusion demo
# --------------------------------------------------------------------------

#: the demo: CFG 7.5, 50 DDIM steps at 512x512 (a 64x64 latent)
DEMO_STEPS, DEMO_GUIDANCE, DEMO_HW = 50, 7.5, (512, 512)
#: the bf16 sample held to the fp32 one on the card: this many steps, then
#: the decoded frames by PSNR over 2 max|fp32 frame| >= DEMO_BF16_PSNR.
#: bf16 rounds each product's operands by 2^-8 relative, CFG 7.5 scales
#: the two branches' difference by 7.5 and DDIM's x0 divides by sqrt(a_t)
#: (0.22 at t = 750); a wrong branch, step or scale moves the latents by
#: tens of percent, below 20 dB
DEMO_CHECK_STEPS = 4
DEMO_BF16_PSNR = 40.0
#: the fp32 UNet forward (TF32 off) on the card against the CPU, batch 1 on
#: a 32x32 latent: max |card - cpu| <= UNET_CARD_TOL * max |cpu|; fp32 sums
#: in other orders through 25 resnets and 16 transformers
UNET_CARD_LATENT = (32, 32)
UNET_CARD_TOL = 1e-4
#: the SD 2.1 UNet's parameters (tests/data/unet_sd21_keys.json)
SD21_UNET_PARAMS = 865910724
#: the SD 2.x tokenizer's start and end (which also pads) token ids
BOS, EOS = 49406, 49407
#: the kernels' launches in the demo's decode of a 64x64 latent with
#: num_frames=1 (the v1 decoder): K1 (shape, SiLU, per frame), K2 (one
#: phase's shape, n), K4 (B, S, C); ``tests/test_torch_latent_compat.py``
#: holds them to the decoder's launches
DECODE_K1_SHAPES = [((1, 1, 64, 64, 512), True, False),
                    ((1, 1, 64, 64, 512), False, True),
                    ((1, 1, 128, 128, 512), True, False),
                    ((1, 1, 256, 256, 512), True, False),
                    ((1, 1, 256, 256, 256), True, False),
                    ((1, 1, 512, 512, 256), True, False),
                    ((1, 1, 512, 512, 128), True, False)]
DECODE_K2_SHAPES = [((1, 1, 64, 64, 1024), 2), ((1, 1, 128, 128, 512), 1),
                    ((1, 1, 256, 256, 512), 2)]
DECODE_K4_SHAPES = [(1, 4096, 512)]


def unet_reference_layout(state):
    """The port's UNet state dict -> diffusers' UNet2DConditionModel names
    (the inverse of ``utils/convert.convert_unet_state_dict``)."""
    import re

    rules = [(re.compile(r"\b((?:down|up)samplers\.\d+)\."), r"\1.conv."),
             (re.compile(r"\bto_out\."), "to_out.0."),
             (re.compile(r"\bff_proj\."), "ff.net.0.proj."),
             (re.compile(r"\bff_out\."), "ff.net.2.")]
    out = {}
    for key, value in state.items():
        for pat, rep in rules:
            key = pat.sub(rep, key)
        out[key] = value.detach().cpu().contiguous()
    return out


def clip_reference_layout(state):
    """The port's CLIP state dict -> transformers' CLIPTextModel names (the
    inverse of ``utils/convert.convert_clip_text_state_dict``)."""
    from cvvae_tpu_torch.utils.convert import CLIP_MODULES, CLIP_TOP

    top = {v: k for k, v in CLIP_TOP.items()}
    mods = {v: k for k, v in CLIP_MODULES.items()}
    out = {}
    for key, value in state.items():
        if key not in top:
            _, i, rest = key.split(".", 2)
            mod, leaf = rest.rsplit(".", 1)
            key = f"text_model.encoder.layers.{i}.{mods[mod]}.{leaf}"
        else:
            key = top[key]
        out[key] = value.detach().cpu().contiguous()
    return out


def write_unet_checkpoint(path, unet):
    """A diffusers UNet dir: config.json (``attention_head_dim`` as SD 2.1
    publishes it, per-block head counts) and the safetensors."""
    from safetensors.torch import save_file

    cfg = unet.config
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(
            _class_name="UNet2DConditionModel",
            in_channels=cfg.in_channels, out_channels=cfg.out_channels,
            block_out_channels=list(cfg.block_out_channels),
            layers_per_block=cfg.layers_per_block,
            cross_attention_dim=cfg.cross_attention_dim,
            attention_head_dim=[c // cfg.attention_head_dim
                                for c in cfg.block_out_channels],
            norm_num_groups=cfg.norm_num_groups, use_linear_projection=True),
            f)
    save_file(unet_reference_layout(unet.state_dict()),
              os.path.join(path, "diffusion_pytorch_model.safetensors"))


def write_clip_checkpoint(path, model):
    """A transformers CLIPTextModel dir: config.json and model.safetensors."""
    import dataclasses

    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(architectures=["CLIPTextModel"],
                       model_type="clip_text_model", bos_token_id=BOS,
                       eos_token_id=EOS, **dataclasses.asdict(model.config)),
                  f)
    save_file(clip_reference_layout(model.state_dict()),
              os.path.join(path, "model.safetensors"))


def demo_token_ids():
    """(prompt, empty prompt) token ids (2, 77): BOS, 20 seeded tokens, EOS
    padded with EOS; and BOS, EOS padded with EOS."""
    g = torch.Generator().manual_seed(9)
    ids = torch.full((2, 77), EOS, dtype=torch.long)
    ids[:, 0] = BOS
    ids[0, 1:21] = torch.randint(0, BOS, (20,), generator=g)
    return ids


def _check_decode_kernels(dev, summary):
    """K1, K2 and K4 at every distinct launch of the demo's decode against
    their plain versions, as phase 3 holds them: K1 (``k1_check``, twice
    bit-identical) and K2 (bit-exact) in bf16 and fp32, K4 (``k4_check``
    and its logsumexp) in bf16 on N(0, 1) and rising logits; each timed in
    bf16 in turns with its plain version (K4 also beside SDPA)."""
    from cvvae_tpu_torch.ops.kernels import attention, groupnorm, shuffle

    def record(key, label, err, excess, text, timing=None):
        ok = excess <= 0.0
        summary[key]["max_abs_err"] = max(summary[key]["max_abs_err"], err)
        if timing:
            shape, dtype, k_ms, p_ms, l_ms, kw = timing
            b_ms, by = bound(key, shape, dtype, **kw)
            summary[key]["timed"].append(dict(
                shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                where="diffusion decode", ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=by, share=b_ms / k_ms,
                library_ms=l_ms))
            text += (f" kernel_ms={k_ms!r} plain_ms={p_ms!r} library_ms="
                     f"{l_ms!r} bound_ms={b_ms!r} ({by}) share={b_ms / k_ms!r}")
        say(f"[diffusion] {key} decode {label}: max_abs_err={err!r} {text} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{key} decode {label}: disagrees with its "
                             f"plain version")

    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        for shape, silu, per_frame in DECODE_K1_SHAPES:
            x, w, b = k1_inputs(shape, dev, dtype)
            kw = dict(num_groups=32, eps=1e-5, silu=silu, per_frame=per_frame)
            got = groupnorm.group_norm_silu(x, w, b, **kw)
            torch.cuda.synchronize()
            err, excess, text = k1_check(got, x, w, b, **kw)
            same = torch.equal(got, groupnorm.group_norm_silu(x, w, b, **kw))
            text += f" bit-identical across two calls: {same}"
            del got
            timing = None
            if timed:
                k_ms, p_ms, _ = in_turns(
                    lambda: groupnorm.group_norm_silu_plain(x, w, b, **kw),
                    lambda: groupnorm.group_norm_silu(x, w, b, **kw))
                timing = (shape, dtype, k_ms, p_ms, None, dict(silu=silu))
            record("K1", f"{shape} {dtype} silu={silu} per_frame={per_frame}",
                   err, excess if same else math.inf, text, timing)
            del x
        for shape, n in DECODE_K2_SHAPES:
            phases = [randn(shape, 10 + j, dev, dtype) for j in range(4)]
            bias = randn(shape[-1:], 20, dev, dtype)
            got = shuffle.subpixel_interleave(phases, bias, n=n)
            ref = shuffle.subpixel_interleave_plain(phases, bias, n=n)
            torch.cuda.synchronize()
            exact = k2_exact(got, ref)
            err = (0.0 if exact else compare(got, ref)[0]
                   if got.shape == ref.shape else math.inf)
            del got, ref
            timing = None
            if timed:
                k_ms, p_ms, _ = in_turns(
                    lambda: shuffle.subpixel_interleave_plain(phases, bias,
                                                              n=n),
                    lambda: shuffle.subpixel_interleave(phases, bias, n=n))
                timing = (shape, dtype, k_ms, p_ms, None, dict(n=n))
            record("K2", f"{shape} n={n} {dtype} bit-exact={exact}", err,
                   0.0 if exact else 1.0, "tol=bit-exact", timing)
            del phases
    for shape in DECODE_K4_SHAPES:
        for rising in (False, True):
            q, k, v = k4_inputs(shape, dev, torch.bfloat16, rising)
            scale = shape[-1] ** -0.5
            got = attention.flash_attention(q, k, v, scale)
            ref = attention.flash_attention_plain(q, k, v, scale)
            _, lse = attention._launch(q, k, v, scale, True)
            torch.cuda.synchronize()
            err, excess, text = k4_check(got, ref)
            lse_err, lse_excess, lse_text = k4_lse_check(
                lse, attention.flash_attention_lse_plain(q, k, scale))
            raises = k4_max_raises(q, k, scale)
            text += (f"; {lse_text} max_abs_err {lse_err!r}; max raised "
                     f"{raises!r} times a row after tile 0")
            excess = max(excess, lse_excess,
                         math.inf if rising and raises < 1.0 else 0.0)
            del got, ref, lse
            timing = None
            if not rising:  # SDPA as (B, 1 head, S, C)
                lib = functools.partial(
                    torch.nn.functional.scaled_dot_product_attention,
                    q[:, None], k[:, None], v[:, None], scale=scale)
                k_ms, p_ms, l_ms = in_turns(
                    lambda: attention.flash_attention_plain(q, k, v, scale),
                    lambda: attention.flash_attention(q, k, v, scale), lib)
                timing = (shape, torch.bfloat16, k_ms, p_ms, l_ms, {})
                del lib
            record("K4", f"{shape} bfloat16"
                   f"{' rising logits' if rising else ''}", err, excess,
                   text, timing)
            del q, k, v
    torch.cuda.empty_cache()


def _unet_card_vs_cpu(path, dev):
    """One fp32 UNet forward (TF32 off), batch 1 on a UNET_CARD_LATENT
    latent at t = 500, on the card and on the CPU from the checkpoint dir:
    (max |d|, max |cpu|)."""
    from cvvae_tpu_torch.utils.convert import load_unet_checkpoint

    g = torch.Generator().manual_seed(11)
    x = torch.randn((1,) + UNET_CARD_LATENT + (4,), generator=g)
    ctx = torch.randn((1, 77, 1024), generator=g)
    outs = []
    for device in (dev, torch.device("cpu")):
        unet = load_unet_checkpoint(path, dtype=torch.float32, device=device)
        with torch.inference_mode():
            outs.append(unet(x.to(device), 500, ctx.to(device)).cpu())
        del unet
        gc.collect()
        torch.cuda.empty_cache()
    card, cpu = outs
    return (card - cpu).abs().max().item(), cpu.abs().max().item()


def _sample(pipe, cond, uncond, steps):
    """The demo's latents from seed 0, fp32: (latents, synchronised wall
    s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = pipe(torch.Generator().manual_seed(0), cond=cond, uncond=uncond,
               height=DEMO_HW[0], width=DEMO_HW[1],
               num_inference_steps=steps, guidance_scale=DEMO_GUIDANCE,
               output_type="latent")
    torch.cuda.synchronize()
    return lat, time.perf_counter() - t0


def _diffusion(dev, smi, summary):
    """Phase 9: K1, K2 and K4 at the decode's launches against their plain
    versions; the SD 2.1 UNet, the 23-layer CLIP text tower and the v1 VAE
    from seeded random weights written as their publishers' checkpoint dirs
    and loaded back bit-equal; the fp32 UNet card against CPU; the bf16
    demo (CLIP, 50 DDIM steps with CFG 7.5 at 512x512, the decode) with
    its wall s, ms a UNet step, decode ms, peak memory and launches (none
    in the sample: the UNet is plain PyTorch, as the JAX UNet calls no
    Pallas kernel; K1, K2 and K4 in the decode); a 4-step bf16 sample
    against fp32 by PSNR; the port's script once.  Returns the launches of
    the demo's path."""
    import tempfile

    from cvvae_tpu_torch.models.clip_text import (CLIPText, CLIPTextConfig,
                                                  make_text_embedder)
    from cvvae_tpu_torch.models.unet2d import (UNet2D, UNet2DConfig,
                                               make_denoiser)
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant
    from cvvae_tpu_torch.pipelines.diffusion import LatentDiffusionPipeline
    from cvvae_tpu_torch.scripts import sd21_vae3d_inference
    from cvvae_tpu_torch.utils.convert import (load_clip_text_checkpoint,
                                               load_unet_checkpoint)

    t_start = time.perf_counter()
    _check_decode_kernels(dev, summary)
    t_kernels = time.perf_counter() - t_start

    bf16 = torch.bfloat16
    # name -> (the source model on the CPU, its writer, its loader)
    models = {
        "unet": (lambda: UNet2D.from_config(UNet2DConfig(), seed=0,
                                            dtype=bf16, device="cpu"),
                 write_unet_checkpoint,
                 lambda path, dtype: load_unet_checkpoint(path, dtype=dtype,
                                                          device=dev)),
        "clip": (lambda: CLIPText.from_config(CLIPTextConfig(), seed=1,
                                              dtype=bf16, device="cpu"),
                 write_clip_checkpoint,
                 lambda path, dtype: load_clip_text_checkpoint(
                     path, dtype=dtype, device=dev)),
        "vae": (lambda: VideoVAE.from_config(config_for_variant("v1"), seed=2,
                                             dtype=bf16, device="cpu"),
                lambda path, m: write_reference_checkpoint(
                    path, m.config, m.state_dict()),
                lambda path, dtype: VideoVAE.from_pretrained(
                    path, dtype=dtype, device=dev))}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, k) for k in models}

        def load(dtype):
            return [models[k][2](paths[k], dtype) for k in models]

        t0 = time.perf_counter()
        srcs = {}
        for name, (build, write, _) in models.items():
            srcs[name] = build()
            write(paths[name], srcs[name])
        unet, clip, vae = load(bf16)
        same = all(torch.equal(v, got.state_dict()[k].cpu())
                   for name, got in zip(models, (unet, clip, vae))
                   for k, v in srcs[name].state_dict().items())
        n_params = {k: sum(p.numel() for p in m.parameters())
                    for k, m in srcs.items()}
        del srcs
        gc.collect()
        ok = same and n_params["unet"] == SD21_UNET_PARAMS
        say(f"[diffusion] SD 2.1 UNet, 23-layer CLIP text tower and v1 VAE "
            f"({n_params} params) from seeded random weights written as "
            f"diffusers / transformers / CV-VAE dirs and loaded on the card "
            f"in bf16 in {time.perf_counter() - t0:.1f}s; weights bit-equal "
            f"to the sources': {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("diffusion: a loaded model differs from its "
                             "source")

        diff, ref_max = _unet_card_vs_cpu(paths["unet"], dev)
        ok = diff <= UNET_CARD_TOL * ref_max
        say(f"[diffusion] fp32 UNet forward (1,{UNET_CARD_LATENT[0]},"
            f"{UNET_CARD_LATENT[1]},4) card vs CPU: max|d|={diff!r} "
            f"max|cpu|={ref_max!r} (<= {UNET_CARD_TOL} * max|cpu|) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("diffusion: the fp32 UNet on the card differs "
                             "from the CPU's")

        # the demo in bf16: CLIP -> 50 DDIM steps with CFG -> decode
        ids = demo_token_ids()
        pipe = LatentDiffusionPipeline(vae, make_denoiser(unet, bf16))
        _sample(pipe, *make_text_embedder(clip)(ids).float().chunk(2), 2)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        cond, uncond = make_text_embedder(clip)(ids).float().chunk(2)
        lat, sample_s = _sample(pipe, cond, uncond, DEMO_STEPS)
        in_sample = {k: n for k, n in launch_counts().items() if n}
        t1 = time.perf_counter()
        with torch.inference_mode():
            frame = pipe.decode_latents(lat.to(bf16))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        decode_wall = time.perf_counter() - t1
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        denoise = make_denoiser(unet, bf16)
        step_ms = time_ms(functools.partial(
            denoise, torch.cat([lat, lat]), 500, torch.cat([uncond, cond])))
        with torch.inference_mode():
            decode_ms = time_ms(functools.partial(pipe.decode_latents,
                                                  lat.to(bf16)), 3)
        finite = bool(torch.isfinite(frame).all())
        ok = (frame.shape == (1,) + DEMO_HW + (3,) and finite
              and not in_sample
              and all(counts[k] > 0 for k in ("K1", "K2", "K4")))
        say(f"[diffusion] demo bf16 {DEMO_HW[0]}x{DEMO_HW[1]}, {DEMO_STEPS} "
            f"DDIM steps, CFG {DEMO_GUIDANCE}: frame {tuple(frame.shape)} "
            f"finite {finite}; wall s {wall!r} (prompts + sample "
            f"{sample_s!r} + decode {decode_wall!r}); ms a UNet step (CFG "
            f"batch 2, CUDA events) {step_ms!r}; sample s / steps "
            f"{sample_s / DEMO_STEPS!r}; VAE decode ms (CUDA events) "
            f"{decode_ms!r}; peak memory {peak!r} GiB; launches in the "
            f"sample {in_sample} (none: the UNet is plain PyTorch), in the "
            f"decode {counts}; card {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("diffusion: the demo's frame is wrong, or a "
                             "kernel of its decode never ran, or one ran "
                             "in the sample")

        # DEMO_CHECK_STEPS in bf16 against fp32, both on the card
        frames = []
        for dtype in (bf16, torch.float32):
            if dtype == torch.float32:
                del unet, clip, vae, pipe, denoise
                gc.collect()
                torch.cuda.empty_cache()
                unet, clip, vae = load(dtype)
                pipe = LatentDiffusionPipeline(vae, make_denoiser(unet))
            c, u = make_text_embedder(clip, dtype)(ids).float().chunk(2)
            lat, _ = _sample(pipe, c, u, DEMO_CHECK_STEPS)
            with torch.inference_mode():
                frames.append(pipe.decode_latents(lat.to(dtype)).float())
        peak_ref = 2 * frames[1].abs().max().item()
        db = frames_psnr(frames[0], frames[1], peak_ref)
        ok = db >= DEMO_BF16_PSNR
        say(f"[diffusion] {DEMO_CHECK_STEPS}-step bf16 sample against fp32 "
            f"on the card: PSNR {db!r} dB over 2 max|fp32 frame| = "
            f"{peak_ref!r} (>= {DEMO_BF16_PSNR}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"diffusion: bf16 is {db} dB from fp32")
        del unet, clip, vae, pipe, frames
        gc.collect()
        torch.cuda.empty_cache()

        out = os.path.join(tmp, "demo.png")
        t0 = time.perf_counter()
        sd21_vae3d_inference.main([
            "--unet_path", paths["unet"], "--vae3d_path", paths["vae"],
            "--steps", str(DEMO_CHECK_STEPS), "--device", str(dev),
            "--out", out])
        size = os.path.getsize(out) if os.path.exists(out) else 0
        ok = size > 0
        say(f"[diffusion] the port's script ({DEMO_CHECK_STEPS} steps, no "
            f"text encoder; the UNet and VAE in bf16 computing in the fp32 "
            f"latents' dtype, as the JAX script) wrote {out} ({size} bytes) "
            f"in {time.perf_counter() - t0:.1f}s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("diffusion: the script wrote no image")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[diffusion] phase 9 in {time.perf_counter() - t_start:.1f}s "
        f"(kernel checks {t_kernels:.1f}s)")
    return counts


# --------------------------------------------------------------------------
# phase 10: the profiling tools
# --------------------------------------------------------------------------

#: phase 10's training profile: one bf16 G and D step pair on the shipped
#: clip, steady pairs and profiled steps as ``profile_train_step`` runs them
TOOLS_TRAIN_ITERS = 1
#: phase 10's stage profile: v1 in bf16 at the 720 tile with 17 frames
TOOLS_STAGES = ["--dtype", "bf16", "--tile", "720", "--frames", "17",
                "--iters", "2"]
#: the JAX tool's stage names for the full-width v1 net
#: (``tools/profile_stages.py``)
TOOLS_STAGE_NAMES = {
    "encoder": ["conv_in", "enc_level0", "enc_level1", "enc_level2",
                "enc_level3", "enc_mid", "enc_out"],
    "decoder": ["conv_in", "dec_mid", "dec_blocks3", "dec_upsample3",
                "dec_blocks2", "dec_upsample2", "dec_blocks1",
                "dec_upsample1", "dec_blocks0", "dec_out"]}
#: the stage intervals' sum against the whole forward's interval
TOOLS_STAGE_TOL = 0.10
#: phase 10's served clip (T, H, W) for Timer and trace
TOOLS_SERVE_CLIP = (17, 256, 256)


def _tools_train(dev, smi):
    """``profile_train_step.profile_steps`` for bf16 steps on the shipped
    clip, SD3 (the tool's config) then v1 (``v1_engine_config``): each
    profiled step's launches by K group must equal this script's launch
    counters over the same step, and every kernel of ``csrc/`` the profile
    saw must fall in its own group."""
    import dataclasses

    from cvvae_tpu_torch.utils import profile_train_step as pts
    from cvvae_tpu_torch.utils import profiling

    csrc = profiling.csrc_kernels()
    clip = {k: v for k, v in pts.make_batches(device=dev).items()
            if k.startswith("video")}
    for family, cfg in (
            ("sd3", pts.engine_config(compute="bfloat16")),
            ("v1", dataclasses.replace(v1_engine_config(),
                                       compute_dtype="bfloat16"))):
        t0 = time.perf_counter()
        out = pts.profile_steps(
            cfg, clip, iters=TOOLS_TRAIN_ITERS, device=dev,
            allow_random_lpips=cfg.loss.perceptual_weight > 0,
            counts=launch_counts, stacks=False,
            log=lambda s, f=family: say(f"[tools] {f} {s}"))
        for name, r in out.items():
            for kind in ("G", "D"):
                p = r[kind]
                prof = {profiling.key_of(g): row["launches"]
                        for g, row in p["groups"].items()
                        if profiling.key_of(g)}
                bad = {k: (prof.get(k, 0), n) for k, n in p["counts"].items()
                       if prof.get(k, 0) != n}
                strays = [(k, profiling.group_of(k)) for k in p["kernels"]
                          for c, key in csrc.items()
                          if re.search(rf"\b{c}\b", k)
                          and profiling.key_of(profiling.group_of(k)) != key]
                ok = not bad and not strays and any(p["counts"].values())
                say(f"[tools] {family} {name} {kind}: profile launches "
                    f"{prof} == counters "
                    f"{ {k: n for k, n in p['counts'].items() if n} }; "
                    f"busy {100 * p['busy']:.1f}% of {p['wall_s']!r} s; "
                    f"{'ok' if ok else 'FAIL'}; card {smi}")
                if not ok:
                    raise SystemExit(f"tools: {family} {kind} step: profile "
                                     f"and counters differ {bad}, or kernels "
                                     f"outside their group {strays}")
        say(f"[tools] {family} training profile in "
            f"{time.perf_counter() - t0:.1f}s")
        del out
        gc.collect()
        torch.cuda.empty_cache()


def _tools_stages(dev, smi):
    """``profile_stages`` (v1, ``TOOLS_STAGES``): every JAX stage name, and
    the stage intervals' sum within TOOLS_STAGE_TOL of the forward's."""
    from cvvae_tpu_torch.models import vae_v1
    from cvvae_tpu_torch.utils import profile_stages as ps

    args = ps.build_argparser("").parse_args(TOOLS_STAGES
                                             + ["--device", str(dev.type)])
    cfg = vae_v1.VAE1Config()
    out = ps.run(args, vae_v1, cfg, cfg.z_channels, ps.encoder_stages,
                 ps.decoder_stages, log=lambda s: say(f"[tools] {s}"))
    for side, names in TOOLS_STAGE_NAMES.items():
        got = [k for k in out[side] if not k.startswith("cum/")]
        total = sum(out[side][n] for n in got)
        fwd = out["forward"][side]
        ok = got == names and abs(total - fwd) <= TOOLS_STAGE_TOL * fwd
        say(f"[tools] stages {side}: {len(got)} stages as the JAX tool's "
            f"{got == names}; their sum {total!r} s against the forward's "
            f"{fwd!r} s (within {TOOLS_STAGE_TOL:.0%}) "
            f"{'ok' if ok else 'FAIL'}; card {smi}")
        if not ok:
            raise SystemExit(f"tools: profile_stages {side}: stages {got}, "
                             f"sum {total} against {fwd}")
    gc.collect()
    torch.cuda.empty_cache()


def _tools_serve(dev, smi):
    """``Timer`` and ``trace`` around one served v1 bf16 /reconstruct: the
    trace file is written and not empty."""
    import tempfile

    from cvvae_tpu_torch import serve
    from cvvae_tpu_torch.utils import profiling

    t, h, w = TOOLS_SERVE_CLIP
    server = serve.prepare(serve.build_argparser().parse_args(
        ["--variant", "v1", "--dtype", "bf16", "--height", str(h),
         "--width", str(w), "--warm_frames", str(t), "--device", str(dev),
         "--port", "0"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    timer = profiling.Timer()
    clip = np.random.RandomState(0).randint(0, 256, (t, h, w, 3),
                                            dtype=np.uint8)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp):
                with timer("reconstruct"):
                    data, _ = _request(server.server_address[1], "POST",
                                       "/reconstruct", clip)
                    timer.sync(torch.from_numpy(
                        np.load(io.BytesIO(data), allow_pickle=False)))
            files = [os.path.join(tmp, f) for f in os.listdir(tmp)
                     if f.endswith(".pt.trace.json")]
            size = sum(os.path.getsize(f) for f in files)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
        server.worker.vae = None
        del server
        gc.collect()
        torch.cuda.empty_cache()
    ok = len(files) == 1 and size > 0
    say(f"[tools] Timer around one served v1 bf16 {t}x{h}x{w} /reconstruct: "
        f"{timer.report().strip()}; trace {len(files)} file, {size} bytes "
        f"{'ok' if ok else 'FAIL'}; card {smi}")
    if not ok:
        raise SystemExit("tools: trace wrote no file")


def _tools(dev, smi):
    """Phase 10 with its launch counts set to 0 just before."""
    t0 = time.perf_counter()
    reset_launch_counts()
    _tools_train(dev, smi)
    _tools_stages(dev, smi)
    _tools_serve(dev, smi)
    counts = launch_counts()
    say(f"[tools] phase 10 in {time.perf_counter() - t0:.1f}s; launches "
        f"{counts}")
    return counts


# --------------------------------------------------------------------------
# phase 11: multi-device inference, two ranks on the one card
# --------------------------------------------------------------------------

#: the mesh of phase 11: two ranks on cuda:0 over gloo (NCCL refuses two
#: ranks on one card: ``utils/probe_collectives.py``)
MESH_DEVICES = ["cuda:0", "cuda:0"]
#: (a) K1 split over two H halves against one K1 on the whole: (shape,
#: silu, per_frame) -- the v1 encoder's level-0 norm, the encoder's
#: mid-block per-frame norm and the decoder tiles' (each timed on one half)
K1_SPLIT_CASES = [((1, 17, 720, 1280, 128), True, False),
                  ((1, 5, 90, 160, 512), False, True),
                  ((1, 5, 90, 84, 512), False, True)]
#: K1 split's small checks (shape, groups, silu, per_frame, H runs, one a
#: rank), held by the card tests and planted_faults.py: 2 and 3 ranks on
#: unequal runs, per frame and not, a ragged last block, a run below one
#: block's rows, narrow loads (C / G = 3), the decoder tiles' shape
K1_SPLIT_CHECKS = [
    ((1, 5, 9, 7, 128), 32, False, True, (4, 5)),
    ((1, 5, 10, 14, 512), 32, False, True, (3, 3, 4)),
    ((2, 3, 10, 14, 64), 32, True, False, (6, 4)),
    ((1, 7, 11, 13, 512), 32, True, False, (2, 5, 4)),
    ((1, 4, 30, 41, 128), 32, True, False, (17, 13)),
    ((2, 3, 5, 7, 96), 32, True, False, (1, 4)),
    ((1, 1, 3, 3, 128), 32, True, False, (1, 2)),
    ((1, 5, 45, 84, 512), 32, False, True, (22, 23)),
]
#: (b) full-width bf16 encode and decode of the served 17x720x1280 clip,
#: H-split over the mesh, against the port unsharded: PSNR in dB over 2
#: max|ref| (PERF.md section 6 states the bound and its prediction)
MESH_BF16_PSNR = 35.0
#: (c) fp32 with TF32 off: (family, shard_dim, clip), held by max|d| <=
#: MESH_FP32_ATOL against the port unsharded (both sum the same terms; the
#: split GroupNorm and the convs on slabs in another order)
MESH_FP32_CASES = [("v1", "height", (1, 17, 256, 256, 3)),
                   ("sd3", "height", (1, 17, 256, 256, 3)),
                   ("v1", "time", (1, 16, 256, 256, 3))]
MESH_FP32_ATOL = 1e-3
#: (d) the served int8 v1 path over the mesh: its frames against the
#: unsharded int8 server's, PSNR over 2 max|ref| as in (b)
MESH_SERVE_PATH = ("v1", "int8")
#: the kernels the split served path launches on every rank (every norm of
#: an H-split net spans the split, so K1's unsplit entry launches none)
MESH_KERNELS = ("K1.partial", "K1.combine", "K2", "K3", "K4", "K5",
                "K5.stage")


def _k1_split(dev, smi, summary):
    """(a): K1 split over the two H halves of each K1_SPLIT_CASES shape,
    bf16 and fp32: every half's partial moments, their stack (as the
    all-gather gives it), each half's combination; joined, against one K1
    on the whole and held to K1's own bounds (``k1_check``); each entry
    against its two-launch form on the same plan, bit-equal (the moments,
    and each half's output and statistics on the same moments); each entry
    timed on one half beside its plain version and its bytes bound: CUDA
    events around the call (``time_ms``: the host's time before the launch
    included), the device's time (``device_ms``) and the host's time to
    issue it (``host_ms``); K1 on that half timed beside."""
    from cvvae_tpu_torch.ops.kernels import groupnorm as gn

    for key in ("K1.partial", "K1.combine"):
        summary[key] = {"max_abs_err": 0.0, "timed": []}
    for shape, silu, per_frame in K1_SPLIT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = k1_inputs(shape, dev, dtype)
            kw = dict(num_groups=32, eps=1e-6, silu=silu,
                      per_frame=per_frame)
            halves = [h.contiguous() for h in x.split(shape[2] // 2, dim=2)]
            moments = torch.stack([gn.partial_moments(h, 32, per_frame)
                                   for h in halves])
            got = torch.cat([gn.combine(h, w, b, moments, **kw)
                             for h in halves], dim=2)
            whole = gn.group_norm_silu(x, w, b, **kw)
            torch.cuda.synchronize()
            d_whole = (got.float() - whole.float()).abs().max().item()
            err, excess, text = k1_check(got, x, w, b, **kw)
            ok = excess <= 0.0
            say(f"[mesh] K1 split over two H halves {shape} {dtype} "
                f"silu={silu} per_frame={per_frame}: max|split - K1 whole|="
                f"{d_whole!r}; against the plain version max_abs_err={err!r}"
                f" excess={excess!r} {text} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K1 split {shape} {dtype}: fails K1's "
                                 f"bounds")
            del got, whole
            same = {"moments": torch.equal(torch.stack(
                [gn.partial_moments_pair(h, 32, per_frame) for h in halves]),
                moments)}
            for i, h in enumerate(halves):
                y, stats = gn.combine_stats(h, w, b, moments, **kw)
                y_ref, stats_ref = gn.combine_pair(h, w, b, moments, **kw)
                same[f"half {i}"] = (torch.equal(y, y_ref)
                                     and torch.equal(stats, stats_ref))
                del y, y_ref
            say(f"[mesh] K1 split {shape} {dtype}: the one-launch entries "
                f"bit-equal to their two-launch forms on the same plan "
                f"(gn_stats + gn_partial_fold; gn_combine_coef + gn_apply on "
                f"the same moments): {same}")
            if not all(same.values()):
                raise SystemExit(f"K1 split {shape} {dtype}: not bit-equal "
                                 f"to the two-launch forms: {same}")
            half = halves[0]
            hshape = tuple(half.shape)
            stack = moments
            plain_m = torch.stack([gn.partial_moments_plain(h, 32, per_frame)
                                   for h in halves])
            k1_half = time_ms(lambda: gn.group_norm_silu(half, w, b, **kw))
            plan = gn.split_plan(*gn._dims("plan", hshape, 32, per_frame),
                                 32, half.element_size())
            for key, kernel, plain in (
                    ("K1.partial",
                     lambda: gn.partial_moments(half, 32, per_frame),
                     lambda: gn.partial_moments_plain(half, 32, per_frame)),
                    ("K1.combine",
                     lambda: gn.combine(half, w, b, stack, **kw),
                     lambda: gn.combine_plain(half, w, b, plain_m, **kw))):
                ms, plain_ms, _ = in_turns(plain, kernel)
                dev_ms, h_ms = device_ms(kernel), host_ms(kernel)
                b_ms, by = bound(key, hshape, dtype, silu=silu,
                                 per_frame=per_frame)
                entry = dict(shape=list(hshape), dtype=str(dtype)[6:],
                             silu=silu, per_frame=per_frame, ms=ms,
                             device_ms=dev_ms, host_ms=h_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                             share=b_ms / ms, device_share=b_ms / dev_ms,
                             library_ms=None, k1_half_ms=k1_half,
                             max_abs_diff_whole=d_whole,
                             plan=dict(n_blocks=plan["n_blocks"],
                                       rows_per_block=plan["rows_per_block"]))
                summary[key]["timed"].append(entry)
                summary[key]["max_abs_err"] = max(
                    summary[key]["max_abs_err"], err)
                say(f"[mesh] {key} on one half {hshape} {dtype}: ms={ms!r} "
                    f"(CUDA events) device_ms={dev_ms!r} host_ms={h_ms!r} "
                    f"plain_ms={plain_ms!r} bound_ms={b_ms!r} ({by}) share="
                    f"{b_ms / ms!r} (events) {b_ms / dev_ms!r} (device); "
                    f"plan {entry['plan']}; K1 unsplit on the same half "
                    f"{k1_half!r} ms; card {smi}")
            del x, halves, half, moments, stack, plain_m
            torch.cuda.empty_cache()


def _rank_counts(mesh):
    return mesh.call("cvvae_tpu_torch.parallel.mesh:rank_counts")


def _reset_rank_counts(mesh):
    mesh.call("cvvae_tpu_torch.parallel.mesh:reset_rank_counts")


def _comm_text(counts):
    keys = ("exchanges", "sent", "received", "bytes", "staged", "slab_bytes",
            "all_gathers", "all_reduces", "seconds")
    return "; ".join(f"rank {r}: " + " ".join(f"{k}={c[k]!r}" for k in keys)
                     for r, c in enumerate(counts))


def _synced(fn):
    """(fn's result, host seconds to the device's end of it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _mesh_bf16(dev, smi, mesh):
    """(b): full-width v1 and SD3 in bf16 with the serving preset, the
    17x720x1280 clip encoded and its latent decoded unsharded and H-split
    over the mesh; PSNR over 2 max|ref| >= MESH_BF16_PSNR; the warm wall
    seconds of each and each rank's transport counts."""
    from cvvae_tpu_torch.cli import apply_serving_preset
    from cvvae_tpu_torch.data.video_io import to_unit
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    t, h, w = SERVE_CLIP
    clip = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (t, h, w, 3), dtype=np.uint8)).to(dev)[None]
    x = to_unit(clip, torch.bfloat16)
    for family in ("v1", "sd3"):
        vae = VideoVAE.from_config(config_for_variant(family),
                                   dtype=torch.bfloat16, device=dev)
        apply_serving_preset(vae, h, w)
        mv = vae.with_mesh(mesh)
        # each path once to warm it, then timed (the split decode on the
        # unsharded latent, so that the decoders see one input)
        for v in (vae, mv):
            v.decode(v.encode(x).mode())
        z, enc_s = _synced(lambda: vae.encode(x).mode())
        xr, dec_s = _synced(lambda: vae.decode(z))
        _reset_rank_counts(mesh)
        zm, enc_m = _synced(lambda: mv.encode(x).mode())
        xm, dec_m = _synced(lambda: mv.decode(z))
        counts = _rank_counts(mesh)
        z_db = frames_psnr(zm.float(), z.float(),
                           2 * z.float().abs().max().item())
        x_db = frames_psnr(xm.float(), xr.float(),
                           2 * xr.float().abs().max().item())
        ok = (min(z_db, x_db) >= MESH_BF16_PSNR and zm.shape == z.shape
              and xm.shape == xr.shape and torch.isfinite(xm).all().item())
        say(f"[mesh] {family} bf16 {t}x{h}x{w} H-split over {mesh.world} "
            f"ranks on one card against unsharded: latent PSNR {z_db!r} dB, "
            f"frames PSNR {x_db!r} dB (>= {MESH_BF16_PSNR}) "
            f"{'ok' if ok else 'FAIL'}; wall s unsharded encode={enc_s!r} "
            f"decode={dec_s!r}, split encode={enc_m!r} decode={dec_m!r} "
            f"(two ranks sharing one card: no scaling figure); card {smi}")
        say(f"[mesh] {family} bf16 transport: {_comm_text(counts)}")
        say(f"[mesh] {family} bf16 launches by rank: "
            f"{[{k: c[k] for k in COUNTERS} for c in counts]}")
        if not ok:
            raise SystemExit(f"mesh {family} bf16: the split model is "
                             f"{min(z_db, x_db)} dB from the unsharded one")
        del vae, mv, z, xr, zm, xm
        gc.collect()
        torch.cuda.empty_cache()


def _mesh_fp32(dev, smi, mesh):
    """(c): full-width fp32 (TF32 off) on 256x256 clips, H-split v1 and
    SD3 and T-split v1, against the port unsharded: max|d| <=
    MESH_FP32_ATOL on latents and frames."""
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    for family, shard_dim, shape in MESH_FP32_CASES:
        vae = VideoVAE.from_config(config_for_variant(family), device=dev)
        mv = vae.with_mesh(mesh, shard_dim=shard_dim)
        x = randn(shape, 7, dev, torch.float32).clamp(-1, 1)
        z = vae.encode(x).mode()
        xr = vae.decode(z)
        zm = mv.encode(x).mode()
        xm = mv.decode(z)
        dz = (zm - z).abs().max().item()
        dx = (xm - xr).abs().max().item()
        ok = (max(dz, dx) <= MESH_FP32_ATOL and xm.shape == xr.shape)
        say(f"[mesh] {family} fp32 {shape} split along {shard_dim} against "
            f"unsharded: max|d| latent={dz!r} (max|ref| "
            f"{z.abs().max().item()!r}) frames={dx!r} (max|ref| "
            f"{xr.abs().max().item()!r}), frames {tuple(xm.shape)} (<= "
            f"{MESH_FP32_ATOL}) {'ok' if ok else 'FAIL'}; card {smi}")
        if not ok:
            raise SystemExit(f"mesh {family} fp32 {shard_dim}: {dz}, {dx}")
        del vae, mv, x, z, xr, zm, xm
        gc.collect()
        torch.cuda.empty_cache()


def _mesh_serve(dev, smi, mesh):
    """(d), (e): the served v1 int8 path with its model split over the
    mesh (``build_server`` on ``with_mesh``, as ``serve --spatial_shards``
    builds it where there are cards enough) beside the same model served
    unsharded.  The split server's /reconstruct, /encode and /decode run
    with every rank's counts set to 0 just before and read just after
    (the main path): /reconstruct == /decode(/encode), its frames against
    the unsharded server's model by PSNR as in (b), every rank launching
    every kernel of the path the same number of times, K1's two split
    entries once each a norm, one all-gather a norm, every point-to-point
    message staged through host memory.  Returns (each rank's counts, the
    /reconstruct's alone)."""
    from cvvae_tpu_torch import serve
    from cvvae_tpu_torch.cli import apply_serving_preset
    from cvvae_tpu_torch.models.video_vae import VideoVAE, config_for_variant

    t, h, w = SERVE_CLIP
    variant, dtype = MESH_SERVE_PATH
    args = serve.build_argparser().parse_args(
        ["--variant", variant, "--dtype", dtype, "--height", str(h),
         "--width", str(w), "--warm_frames", str(t), "--device", str(dev)])
    vae = VideoVAE.from_config(config_for_variant(variant),
                               dtype=torch.bfloat16, device=dev)
    apply_serving_preset(vae, h, w)
    q = serve.quantized(vae, args, t)
    del vae
    mv = q.with_mesh(mesh)
    servers = [serve.build_server(v, port=0, act_dtype=torch.bfloat16,
                                  device=dev) for v in (q, mv)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for th in threads:
        th.start()
    ref_port, port = (s.server_address[1] for s in servers)
    clip = np.random.RandomState(0).randint(0, 256, (t, h, w, 3),
                                            dtype=np.uint8)
    try:
        warm = np.zeros_like(clip)
        for p in (ref_port, port):
            _request(p, "POST", "/reconstruct", warm)
        _, t_ref = _request(ref_port, "POST", "/reconstruct", clip)
        torch.cuda.synchronize()
        _reset_rank_counts(mesh)
        health, _ = _request(port, "GET", "/healthz")
        rec_b, t_rec = _request(port, "POST", "/reconstruct", clip)
        per_rec = _rank_counts(mesh)
        z_b, t_enc = _request(port, "POST", "/encode", clip)
        z = np.load(io.BytesIO(z_b), allow_pickle=False)
        dec_b, t_dec = _request(port, "POST", "/decode", z)
        counts = _rank_counts(mesh)
        with torch.inference_mode():
            x = torch.from_numpy(clip).to(dev)[None].to(torch.bfloat16) \
                / 127.5 - 1.0
            ref = q.decode(q.encode(x).mode())[0].float()
            got = mv.decode(mv.encode(x).mode())[0].float()
        db = frames_psnr(got, ref, 2 * ref.abs().max().item())
        ref_u8 = ((ref + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu()
        rec = np.load(io.BytesIO(rec_b), allow_pickle=False)
        u8_db = frames_psnr(torch.from_numpy(rec), ref_u8, 255.0)
        del ref, got
        held, busy = _mesh_profile(mv, x)
        del x
    finally:
        for s, th in zip(servers, threads):
            s.shutdown()
            s.server_close()
            th.join(60)
            s.worker.vae = None
        del servers, q, mv
        gc.collect()
        torch.cuda.empty_cache()
    tag = f"{variant}-{dtype} split over {mesh.world} ranks"
    say(f"[mesh] serve {tag}: /healthz {health!r}; /reconstruct bytes == "
        f"/decode(/encode) bytes: {rec_b == dec_b}; frames against the "
        f"unsharded int8 model: PSNR {db!r} dB over 2 max|ref| (>= "
        f"{MESH_BF16_PSNR}), of the uint8 bytes over 255 {u8_db!r} dB; "
        f"request wall s reconstruct={t_rec!r} encode={t_enc!r} decode="
        f"{t_dec!r}, unsharded reconstruct={t_ref!r} (two ranks sharing "
        f"one card: no scaling figure); card {smi}")
    say(f"[mesh] serve {tag} transport in the served requests: "
        f"{_comm_text(counts)}")
    say(f"[mesh] serve {tag} launches by rank in the served requests: "
        f"{[{k: c[k] for k in COUNTERS} for c in counts]}; in the "
        f"/reconstruct alone: {[{k: c[k] for k in COUNTERS} for c in per_rec]}"
        f"; K1's split entries by shape in the /reconstruct alone: "
        f"{[c['K1 split by shape'] for c in per_rec]}")
    if json.loads(health) != {"ok": True} or rec_b != dec_b \
            or db < MESH_BF16_PSNR or rec.shape != (t, h, w, 3):
        raise SystemExit(f"mesh serve: health {health!r}, /reconstruct == "
                         f"/decode(/encode) {rec_b == dec_b}, PSNR {db}")
    say(f"[mesh] serve {tag}: rank 0 profiled over one split encode + "
        f"decode: launches by K group (profile, counters) {held}; device "
        f"busy {busy!r} of the span; card {smi}")
    if any(a != b for a, b in held.values()):
        raise SystemExit(f"mesh serve: rank 0's profile and counters "
                         f"disagree: {held}")
    first = {k: counts[0][k] for k in COUNTERS}
    for r, c in enumerate(counts):
        missing = [k for k in MESH_KERNELS if c[k] <= 0]
        held = {
            "every kernel of the path launched": not missing,
            "the same launches as rank 0": {k: c[k] for k in COUNTERS}
            == first,
            "K1's unsplit entry not launched": c["K1"] == 0,
            "one partial, one combine and one all-gather a norm":
                c["K1.partial"] == c["K1.combine"] == c["all_gathers"],
            "every message staged through host memory":
                c["staged"] == c["sent"] + c["received"] > 0,
            "no dynamic scale (calibrated)": c["all_reduces"] == 0}
        bad = [k for k, v in held.items() if not v]
        say(f"[mesh] serve rank {r} counts held: "
            f"{'ok' if not bad else 'FAIL ' + str(bad)}")
        if bad:
            raise SystemExit(f"mesh serve rank {r}: {bad} (missing kernels "
                             f"{missing})")
    return counts, per_rec


#: the host-side range that marks a profile's measured call
MEASURED = "chip_smoke.measured"


def profile_measured(fn):
    """(the device events of ``fn``'s second call, {counter key: its
    launches in that call}), from one ``torch.profiler`` trace over two
    calls.  The first call absorbs what the profiler can lose of the
    kernels right after a trace starts (K3 and the first K1.partial of a
    split pass, the first kernels of an int8-res chain, on an H100, also
    in a cycle after a warm-up one); the second runs in a host-side range
    (``record_function``), and the device events that start after the
    range does are its.  A marker kernel between the calls can be lost
    with the device's records; the host range is not."""
    from cvvae_tpu_torch.utils import profiling

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
        before = profiling.launch_counts()
        with torch.profiler.record_function(MEASURED):
            fn()
            torch.cuda.synchronize()
        after = profiling.launch_counts()
    marks = [e.time_range.start for e in prof.events() if e.name == MEASURED
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not marks:
        raise SystemExit("profile: no host range marks the measured call")
    events = [e for e in profiling.kernel_events(prof)
              if e.name != MEASURED and e.time_range.start >= marks[0]]
    return events, {k: after[k] - before[k] for k in after}


def _mesh_profile(mv, x):
    """Rank 0 under ``torch.profiler`` over one split encode + decode of
    ``x`` (``profile_measured``, after a first pass): {kernel key:
    (launches of its ``profiling.GROUPS`` group, its counter's launches)}
    for every key either saw, each split K1 entry held to its own group as
    every kernel of csrc/ is (phase 10), and the device's busy share of
    the span."""
    from cvvae_tpu_torch.utils import profiling

    with torch.inference_mode():
        events, counted = profile_measured(
            lambda: mv.decode(mv.encode(x).mode()))
    seen = {profiling.key_of(g): row["launches"]
            for g, row in profiling.group_kernels(events).items()
            if profiling.key_of(g)}
    held = {k: (seen.get(k, 0), counted.get(k, 0))
            for k in set(seen) | {k for k, n in counted.items() if n}}
    line = profiling.device_timeline(events)
    return held, line["busy_us"] / max(line["span_us"], 1e-9)


def _mesh(dev, smi, summary):
    """Phase 11: (a) K1 split, then one mesh of two ranks on the card for
    (b)-(e); the mesh is closed (its follower process stopped) whatever
    happens.  Returns the served path's counts (each rank's, and the
    /reconstruct's alone)."""
    from cvvae_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    _k1_split(dev, smi, summary)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    mesh = make_mesh(len(MESH_DEVICES), devices=MESH_DEVICES, backend="gloo")
    say(f"[mesh] {mesh.world} ranks on {MESH_DEVICES} over "
        f"{mesh.backend} up in {time.perf_counter() - t1:.1f}s")
    try:
        _mesh_bf16(dev, smi, mesh)
        _mesh_fp32(dev, smi, mesh)
        out = _mesh_serve(dev, smi, mesh)
    finally:
        mesh.close()
    say(f"[mesh] phase 11 in {time.perf_counter() - t0:.1f}s")
    return out


# --------------------------------------------------------------------------
# phase 12: data-parallel training, two ranks on the one card
# --------------------------------------------------------------------------

#: the ranks of phase 12: two spawned processes on cuda:0 over gloo (NCCL
#: refuses two ranks on one card), each forming the group as torchrun's
#: ranks do and running the same steps on its own rows
DP_DEVICE = "cuda:0"
DP_WORLD = 2
#: (a) the fp32 check's global clip (TF32 off): a (1,17,256,256,3) clip a
#: rank; the data-parallel steps 0 (G, the gate closed), 1 (D) and 2 (G,
#: the adaptive weight open, ``disc_start`` 1) each against one process
#: on the card on the batch of two, from the state the step started from
#: and with the same generator: loss metrics within DP_LOSS_RTOL relative
#: (+1e-6), the other metrics within DP_LOSS_RTOL * (1 + |ref|) (phase 8's
#: form: logits and loss/g are means that cancel to ~0.03), parameters
#: within DP_PARAM_ATOL + DP_PARAM_RTOL * |ref| (``tests/test_parallel.py``'s
#: DP tolerances); the ranks' states bit-identical after every step
DP_CLIP = (2, 17, 256, 256, 3)
DP_LOSS_RTOL = 1e-4
DP_PARAM_ATOL, DP_PARAM_RTOL = 1e-5, 1e-4
#: (b), (c) the kernels each rank must launch: a bf16 SD3 G and D step on
#: its clip, then a bf16 v1 G step
DP_KERNELS = {"sd3": ("K1", "K1.bwd", "K2", "K2.bwd", "K4", "K4.bwd"),
              "v1": ("K1", "K1.bwd", "K2", "K2.bwd", "K3", "K3.bwd", "K4",
                     "K4.bwd")}
#: (d) train.main on the two ranks (bf16, the shipped YAML and batches)
DP_MAIN_STEPS = 3
#: seconds the ranks may take together
DP_TIMEOUT_S = 600


def _dp_clone(obj):
    """A copy of a state dict on its device."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _dp_clone(v) for k, v in obj.items()}
    return obj


def _dp_timed_step(step, st, batch, gen):
    """(state, metrics, wall s, peak GiB) of one step, synchronised."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, m = step(st, batch, gen)
    torch.cuda.synchronize()
    return (st, {k: float(v) for k, v in m.items()},
            time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30)


def _dp_against_one(eng, ref_st, start, x, k, got_m, got_st):
    """Step ``k`` in this process on the whole batch ``x`` from ``start``
    with the step's generator, against the data-parallel step's metrics
    and state: (failures, worst metric error, worst parameter error over
    its bound, largest |Δdp - Δone| / lr, seconds)."""
    from cvvae_tpu_torch.training.engine import named_params
    from cvvae_tpu_torch.training.trainer import step_generator
    ref_st.load_state_dict(start)
    _, ref_m, seconds, _ = _dp_timed_step(eng.train_step, ref_st,
                                          {"frames": x},
                                          step_generator(x.device, 0, k))
    failures, worst = [], (0.0, "")
    for name, r in ref_m.items():
        d = abs(got_m[name] - r)
        tol = (DP_LOSS_RTOL * abs(r) + 1e-6 if name.startswith("loss/")
               else DP_LOSS_RTOL * (1 + abs(r)))
        worst = max(worst, (d / tol, name))
        if d > tol:
            failures.append(f"step {k} {name} {got_m[name]!r} against "
                            f"{r!r}")
    lr = (eng.lr_schedule_g if eng.is_g_step(k) else eng.lr_schedule_d)(k)
    over, upd = 0.0, 0.0
    for which in ("params", "disc_params"):
        before = start[which]
        mine = named_params(getattr(got_st, which))
        for name, r in named_params(getattr(ref_st, which)).items():
            g, r = mine[name].detach(), r.detach()
            over = max(over, ((g - r).abs() / (DP_PARAM_ATOL + DP_PARAM_RTOL
                                               * r.abs())).max().item())
            upd = max(upd, ((g - before[name]) - (r - before[name])).abs()
                      .max().item() / lr)
    if over > 1:
        failures.append(f"step {k} parameters {over!r} times their bound")
    return failures, worst, over, upd, seconds


def _dp_launched(counts, family):
    return [k for k in DP_KERNELS[family] if not counts.get(k)]


def dp_main_argv(data_root):
    """(d)'s ``train.main`` command line: the shipped YAML in bf16 on
    ``write_train_data``'s data under ``data_root``."""
    tar_dir, csv_dir, video_root = (os.path.join(data_root, d)
                                    for d in ("tars", "csv", "videos"))
    return ["--base", SHIPPED_CONFIG, "--train", "--device", DP_DEVICE,
            "--max_steps", str(DP_MAIN_STEPS),
            "--logdir", os.path.join(data_root, "run"),
            "model.allow_random_lpips=true",
            "model.engine.params.compute_dtype=bfloat16",
            f"data.train.datasets.image_webdata.urls_or_dir={tar_dir}",
            f"data.train.datasets.webvid.urls_or_dir={csv_dir}",
            f"data.train.datasets.webvid.decoder.params.video_root="
            f"{video_root}",
            f"trainer.ckpt_every={DP_MAIN_STEPS}", "trainer.image_every=0"]


def _dp_rank_work(rank, world, data_root):
    """Everything one rank of phase 12 does; returns its findings."""
    import dataclasses
    import warnings
    from cvvae_tpu_torch import train
    from cvvae_tpu_torch.parallel import data as dp
    from cvvae_tpu_torch.training.engine import TrainingEngine
    from cvvae_tpu_torch.training.trainer import step_generator

    dev = torch.device(DP_DEVICE)
    mesh = dp.process_mesh(dev)
    out = {"rank": rank, "failures": [], "steps": []}
    # (a) fp32, TF32 off: G, D, G against one process on the batch of two
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = TrainingEngine(shipped_engine_config(num_warmup_steps=0),
                             allow_random_lpips=True, seed=0, device=dev)
    st = dp.put_replicated(eng.init_state(0), mesh)
    ref_st = eng.init_state(0) if rank == 0 else None
    x = torch.from_numpy(np.random.RandomState(21).uniform(
        -1, 1, DP_CLIP).astype(np.float32)).to(dev)
    batch = dp.put_batch({"frames": x}, mesh)
    step = dp.shard_parallel_step(eng, mesh)
    out["setup_s"] = time.perf_counter() - t0
    for k in range(3):
        start = _dp_clone(st.state_dict()) if rank == 0 else None
        st, m, seconds, peak = _dp_timed_step(step, st, batch,
                                              step_generator(dev, 0, k))
        entry = {"k": k, "kind": "g" if eng.is_g_step(k) else "d",
                 "dtype": "float32", "seconds": seconds, "peak": peak,
                 "metrics": m,
                 "reduce": dict(step.sync.counts),
                 "digest": dp.check_replicated(st, mesh)}
        if rank == 0:
            fails, worst, over, upd, one_s = _dp_against_one(
                eng, ref_st, start, x, k, m, st)
            out["failures"] += fails
            entry.update(worst=worst, over=over, update_lr=upd, one_s=one_s)
            del start
        # room for rank 0's one-process step, then for both ranks' next
        torch.cuda.empty_cache()
        torch.distributed.barrier()
        out["steps"].append(entry)
    del ref_st
    # (b) bf16 SD3: a D step (3) and a G step (4) from there
    bf = bf16_engine(eng)
    step = dp.shard_parallel_step(bf, mesh)
    reset_launch_counts()
    for k in (3, 4):
        st, m, seconds, peak = _dp_timed_step(step, st, batch,
                                              step_generator(dev, 0, k))
        out["steps"].append({"k": k, "kind": "g" if bf.is_g_step(k) else "d",
                             "dtype": "bfloat16", "seconds": seconds,
                             "peak": peak, "metrics": m,
                             "reduce": dict(step.sync.counts)})
    out["launches_sd3"] = launch_counts()
    out["digest_bf16"] = dp.check_replicated(st, mesh)
    del eng, bf, st, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    # (c) bf16 v1: one G step from its seeded init
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = TrainingEngine(dataclasses.replace(
            v1_engine_config(num_warmup_steps=0), compute_dtype="bfloat16"),
            allow_random_lpips=True, seed=0, device=dev)
    st = dp.put_replicated(eng.init_state(0), mesh)
    step = dp.shard_parallel_step(eng, mesh)
    batch = dp.put_batch({"frames": x}, mesh)
    reset_launch_counts()
    st, m, seconds, peak = _dp_timed_step(step, st, batch,
                                          step_generator(dev, 0, 0))
    out["launches_v1"] = launch_counts()
    out["steps"].append({"k": 0, "kind": "g", "dtype": "bfloat16 v1",
                         "seconds": seconds, "peak": peak, "metrics": m,
                         "reduce": dict(step.sync.counts)})
    out["digest_v1"] = dp.check_replicated(st, mesh)
    del eng, st, step, batch, x
    gc.collect()
    torch.cuda.empty_cache()
    # (d) train.main on both ranks
    reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer, state = train.main(dp_main_argv(data_root))
    torch.cuda.synchronize()
    out["main_s"] = time.perf_counter() - t0
    out["launches_main"] = launch_counts()
    out["main_log"] = [{k: e[k] for k in ("step", "kind", "shape", "seconds",
                                          "reduce")} for e in trainer.step_log]
    out["main_finite"] = all(math.isfinite(v) for e in trainer.step_log
                             for v in e["metrics"].values())
    out["main_writer"] = trainer.is_writer
    out["digest_main"] = dp.check_replicated(state, mesh)
    return out


def _dp_rank(results, init, rank, world, data_root):
    """A rank of phase 12: join the gloo group on the card, run
    ``_dp_rank_work``, put its findings (pickled) or its traceback."""
    import datetime
    import pickle
    import traceback
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank, timeout=datetime.timedelta(
                                    seconds=DP_TIMEOUT_S))
        results.put((rank, "ok", pickle.dumps(_dp_rank_work(rank, world,
                                                            data_root))))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dp_ranks(root):
    """The two ranks of phase 12, spawned; their findings in rank order."""
    import multiprocessing
    import pickle
    import queue
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        init = f"tcp://localhost:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_dp_rank, daemon=True,
                         args=(results, init, r, DP_WORLD, root))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + DP_TIMEOUT_S
    try:
        while len(got) < DP_WORLD:
            try:
                rank, kind, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise SystemExit(f"dp: no result from ranks "
                                     f"{sorted(set(range(DP_WORLD)) - set(got))}"
                                     f" in {DP_TIMEOUT_S}s")
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead and results.empty():
                    time.sleep(2.0)  # a last result may be in flight
                    if results.empty():
                        raise SystemExit(f"dp: ranks died with no result: "
                                         f"(rank, exit code) {dead}")
                continue
            if kind != "ok":
                raise SystemExit(f"dp: rank {rank} failed:\n{value}")
            got[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
                p.join(10)
    return [got[r] for r in range(DP_WORLD)]


def _dp(dev, smi):
    """Phase 12: data-parallel training on two ranks sharing the card
    (spawned processes in a gloo group): (a) fp32, TF32 off, the shipped
    SD3 recipe at full width (random LPIPS), steps G, D, G (the adaptive
    weight open) each against one process on the batch of two; (b) a bf16
    SD3 D and G step; (c) a bf16 v1 G step; (d) ``train.main`` for
    DP_MAIN_STEPS bf16 steps.  Each rank's wall s, its collectives'
    payload bytes and host s, the one process's step time; the ranks'
    states bit-identical after every step; each rank's launches (counts
    set to 0 on the rank just before (b), (c) and (d)).  Returns each
    rank's launches over (b)-(d)."""
    import tempfile
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        write_train_data(root, seed=9)
        outs = _dp_ranks(root)
        ckpt = os.path.join(root, "run", "rolling",
                            f"step_{DP_MAIN_STEPS:08d}.pt")
        written = os.path.exists(ckpt) and os.path.exists(
            os.path.join(root, "run", "metrics.csv"))
    failures = [f for o in outs for f in o["failures"]]
    say(f"[dp] {DP_WORLD} ranks on {DP_DEVICE} over gloo; engines, state "
        f"and replication {[round(o['setup_s'], 2) for o in outs]} s by "
        f"rank. Two ranks sharing one card are no scaling figure: each "
        f"rank's step takes the card's time of both; card {smi}")
    for i, e0 in enumerate(outs[0]["steps"]):
        es = [o["steps"][i] for o in outs]
        red = "; ".join(
            f"rank {r}: {e['seconds']:.3f}s, peak {e['peak']:.2f} GiB, "
            f"{e['reduce']['collectives']} "
            f"collectives of {e['reduce']['bytes']} B ({e['reduce']['grad_buckets']}"
            f" gradient buckets, {e['reduce']['grad_bytes']} B) in "
            f"{e['reduce']['seconds']:.3f} host s" for r, e in enumerate(es))
        text = (f"[dp] {e0['dtype']} {e0['kind'].upper()} step {e0['k']}: "
                f"{red}; loss/total {e0['metrics']['loss/total']!r} "
                f"loss/disc {e0['metrics']['loss/disc']!r} d_weight "
                f"{e0['metrics']['scalars/d_weight']!r}")
        if "one_s" in e0:
            same = len({e["digest"] for e in es}) == 1
            text += (f"; one process on the batch of {DP_CLIP[0]}: "
                     f"{e0['one_s']:.3f}s; worst metric error / its bound "
                     f"{e0['worst'][0]!r} ({e0['worst'][1]}), worst "
                     f"parameter error / its bound {e0['over']!r}, "
                     f"largest |update dp - update one| / lr "
                     f"{e0['update_lr']!r}; ranks bit-identical {same}")
            if not same:
                failures.append(f"step {e0['k']} ranks differ")
        say(text + f"; card {smi}")
    for key in ("digest_bf16", "digest_v1", "digest_main"):
        if len({o[key] for o in outs}) != 1:
            failures.append(f"{key}: ranks differ")
    for o in outs:
        r = o["rank"]
        for key, family in (("launches_sd3", "sd3"), ("launches_v1", "v1"),
                            ("launches_main", "sd3")):
            missing = _dp_launched(o[key], family)
            if missing:
                failures.append(f"rank {r} {key}: {missing} never launched")
        for e in o["main_log"]:
            say(f"[dp] train.main rank {r} step {e['step']} "
                f"{e['kind'].upper()} {e['shape']}: {e['seconds']:.3f}s, "
                f"{e['reduce']['grad_bytes']} gradient B in "
                f"{e['reduce']['seconds']:.3f} host s")
        say(f"[dp] rank {r} launches: bf16 SD3 D + G "
            f"{ {k: v for k, v in o['launches_sd3'].items() if v} }, v1 G "
            f"{ {k: v for k, v in o['launches_v1'].items() if v} }, "
            f"train.main {DP_MAIN_STEPS} steps in {o['main_s']:.2f}s "
            f"{ {k: v for k, v in o['launches_main'].items() if v} }")
    if not all(o["main_finite"] for o in outs) or not written or \
            [o["main_writer"] for o in outs] != [True, False]:
        failures.append(f"train.main: finite {[o['main_finite'] for o in outs]}"
                        f", rank 0's checkpoint and metrics written {written}, "
                        f"writers {[o['main_writer'] for o in outs]}")
    say(f"[dp] phase 12 in {time.perf_counter() - t0:.1f}s; ranks "
        f"bit-identical after every step: "
        f"{not any('differ' in f for f in failures)}")
    if failures:
        raise SystemExit(f"data-parallel training: {failures}")
    return [{k: o["launches_sd3"][k] + o["launches_v1"][k]
             + o["launches_main"][k] for k in COUNTERS} for o in outs]


# --------------------------------------------------------------------------
# phase 13: int8 activation residency (ops/qflow.py)
# --------------------------------------------------------------------------

#: phase 13's chains: the v1 decoder's two largest resblock stages at full
#: width, as ``tools/probe_residency.py`` times them (name, (B, T, H, W, C))
QFLOW_SHAPES = [("blocks0", (1, 17, 720, 672, 128)),
                ("blocks1", (1, 17, 360, 336, 256))]
#: resblocks a chain (GN+SiLU -> 3x3x3 conv -> GN+SiLU -> 1x3x3 conv ->
#: residual add), its GroupNorms' groups and eps
QFLOW_BLOCKS, QFLOW_GROUPS, QFLOW_EPS = 3, 32, 1e-5
#: the numerics clip (B, T, H, W) at each chain's width: each mode's
#: agreement with the fp32 chain, in dB, calibrated on the clip itself
QFLOW_NUMERICS = (1, 5, 96, 96)
#: the calibration slice (T, H, W) of a timed chain's input
QFLOW_CALIB = (3, 256, 256)
#: the card-vs-CPU chain's clip (B, T, H, W, C) and its bound: the card's
#: int8-res chain against the CPU's in K1.int8's order of moments, in dB
#: (against XLA's order the chain reads ~34 dB on the CPU alone: a last
#: bit of one moment flips codes that the next convs spread)
QFLOW_CHAIN_CLIP = (1, 3, 32, 32, 128)
QFLOW_CHAIN_DB = 40.0
#: K1's int8 mode against its plain version.  int8 output: codes within 1,
#: and at most QFLOW_K1_FLIPS of them off by one (the kernel's moments are
#: summed in another order than PyTorch's, and its SiLU's exp is not
#: torch's, so a value a few fp32 ulps from a .5 quotient rounds the other
#: way).  Float outputs: |got - ref| <= tol * (1 + |ref|): fp32 1e-5 (the
#: moments and exp in other orders), bf16 2^-7 more (one bf16 rounding of
#: values a few fp32 ulps apart lands at most one bf16 ulp apart)
QFLOW_K1_FLIPS = 1e-3
QFLOW_K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7 + 1e-5}
#: K1's int8 mode's small cases ((B, T, H, W, C), groups): groups of 8,
#: 4, 3, 2 and 1 channels; tables of 64-, 128- and 32-channel slices
#: (C 96: three 32-channel slices) and C 48, no multiple of 32, on the
#: arithmetic apply
QFLOW_K1_CASES = [((2, 3, 5, 7, 64), 8), ((1, 4, 9, 11, 128), 32),
                  ((1, 2, 6, 6, 96), 32), ((1, 3, 5, 5, 256), 32),
                  ((1, 2, 4, 4, 512), 32), ((1, 2, 4, 6, 64), 32),
                  ((1, 2, 4, 6, 32), 32), ((1, 3, 4, 6, 48), 16)]
#: K6's cases (N, ..., C): on the general add, channels off 16 (24, 7)
#: and a tail past the last 16 values; on the sliced add, C 128, 256 and
#: 512 on a grid of one partial block, and on the full grid (264 blocks)
#: with a ragged last pass (some threads take two groups, some one)
QFLOW_K6_CASES = [(2, 3, 5, 7, 24), (1, 3, 9, 11, 128), (1, 1, 3, 5, 7),
                  (1, 2, 3, 5, 256), (1, 1, 3, 7, 512),
                  (1, 5, 60, 61, 128), (2, 5, 30, 31, 256),
                  (1, 5, 30, 31, 512)]
#: the general add timed beside the sliced one: C 24 at the chain shapes'
#: value counts (QFLOW_SHAPES' W * C / 24)
QFLOW_K6_GENERAL = [("blocks0", (1, 17, 720, 3584, 24)),
                    ("blocks1", (1, 17, 360, 3584, 24))]
#: K5 from int8 to int8 through its staged epilogue (O a multiple of 16),
#: as K5_CHECK_CASES lists them: 256-pixel tiles ragged (W 130, 200) and
#: 128-pixel ones, O below one channel tile (48, 64), one and a part (144),
#: two (256), stride 2, no bias
K5_INT8_CASES = [
    ((1, 3, 6, 130, 64), 128, (3, 3, 3), (1, 1, 1),
     ((1, 1), (1, 1), (1, 1)), ("zero", "zero", "zero"), True),
    ((1, 2, 4, 200, 64), 64, (3, 3, 3), (1, 1, 1),
     ((1, 1), (1, 1), (1, 1)), ("zero", "zero", "zero"), True),
    ((1, 3, 5, 37, 96), 48, (1, 3, 3), (1, 1, 1),
     ((0, 0), (1, 1), (1, 1)), ("zero", "zero", "zero"), True),
    ((2, 3, 4, 9, 128), 144, (3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1)), ("edge", "zero", "zero"), False),
    ((1, 5, 9, 11, 32), 32, (3, 3, 3), (2, 2, 2),
     ((2, 0), (0, 1), (0, 1)), ("edge", "zero", "zero"), True),
    ((1, 2, 3, 300, 128), 256, (1, 3, 3), (1, 1, 1),
     ((0, 0), (1, 1), (1, 1)), ("zero", "zero", "zero"), True),
]
#: quant8's scales held exhaustively (every fp32 v with |v / s| <= 128,
#: through K6.requant): a power of two, an all-ones mantissa, and two a
#: calibration gives (max |x| / 127 of 1 and of 3.1), as fp32
QUANT8_SCALES = [2.0 ** -5, float(torch.tensor(0x3C7FFFFF, dtype=torch.int32)
                                  .view(torch.float32)),
                 float(torch.tensor(1.0) / 127), float(torch.tensor(3.1)
                                                      / 127)]
#: values a chunk of the exhaustive quant8 check
QUANT8_CHUNK = 1 << 27


def qflow_codes(shape, dev, seed, spread=30.0):
    """int8 codes round(N(0, 1) * spread + m_c), clipped to +-127, the
    channel means m_c running from -spread to +spread, so the groups'
    statistics differ."""
    c = shape[-1]
    shift = torch.linspace(-spread, spread, c, device=dev)
    x = randn(shape, seed, dev, torch.float32, spread) + shift
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def qflow_scale(c, dev, per_channel):
    """A dequantizing scale: 1/127, or one a channel from 0.5/127 to
    2/127."""
    if per_channel:
        return torch.linspace(0.5, 2.0, c, device=dev) / 127
    return torch.tensor(1.0 / 127, device=dev)


def k1_int8_inputs(shape, dev, per_channel, seed=70):
    """q, its scale, and K1's weight and bias for a check of its int8
    mode."""
    c = shape[-1]
    return (qflow_codes(shape, dev, seed), qflow_scale(c, dev, per_channel),
            torch.linspace(0.5, 1.5, c, device=dev),
            torch.linspace(-0.3, 0.3, c, device=dev))


def codes_check(got, ref, flips):
    """(max |d|, excess, text) of int8 codes against the plain version's:
    within 1, and at most ``flips`` of them off."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return math.inf, math.inf, f"{got.shape} {got.dtype} != {ref.shape}"
    worst, off = 0, 0
    g, r = got.reshape(-1), ref.reshape(-1)
    for i in range(0, g.numel(), 1 << 28):
        d = (g[i:i + (1 << 28)].int() - r[i:i + (1 << 28)].int()).abs_()
        worst = max(worst, d.max().item())
        off += (d > 0).sum().item()
    frac = off / g.numel()
    return (float(worst), max(worst - 1.0, frac - flips),
            f"int8 codes: max|d| {worst} (<= 1), {off} of {g.numel()} off "
            f"by one ({frac!r} <= {flips})")


def k1_int8_check(got, q, scale, w, b, groups, out_scale, out_dtype):
    """(max |d|, excess, text) of K1's int8 mode against its plain
    version: codes by ``codes_check``, float outputs by QFLOW_K1_TOL."""
    from cvvae_tpu_torch.ops.kernels.groupnorm import \
        group_norm_silu_int8_plain

    ref = group_norm_silu_int8_plain(
        q, scale, w, b, num_groups=groups, eps=QFLOW_EPS,
        out_scale=out_scale, out_dtype=out_dtype)
    if out_scale is not None:
        return codes_check(got, ref, QFLOW_K1_FLIPS)
    if got.dtype != ref.dtype:
        return math.inf, math.inf, f"{got.dtype} != {ref.dtype}"
    tol = QFLOW_K1_TOL[out_dtype]
    err, excess, _, rms = compare(got, ref, tol)
    return err, excess, f"tol={tol!r}*(1+|ref|) rms={rms!r}"


def k1_int8_table_check(q, scale, w, b, groups, out_scale, out_dtype,
                        lookup=True):
    """K1's int8 mode's per-code outputs against the plain table
    (``groupnorm.int8_table_plain``) built from the kernel's own folded
    affine: the kernel's table bit-equal to it, and (``lookup``) every
    output bit-equal to its entry.  Returns (bit-equal, text)."""
    from cvvae_tpu_torch.ops.kernels import groupnorm

    y, coef, words, plan = groupnorm._int8_launch(
        q, scale, w, b, groups, QFLOW_EPS, out_scale, out_dtype)
    ref = groupnorm.int8_table_plain(coef[:, 0], coef[:, 1], out_scale,
                                     out_dtype)
    same, text = True, f"cs={plan['cs']}"
    if words is not None:
        got = groupnorm.int8_table_entries(words, q.shape[-1], plan["cs"],
                                           y.dtype)
        off = (got.view(torch.uint8) != ref.view(torch.uint8)).sum().item()
        same &= off == 0
        text += f" table bytes off {off}"
    if lookup:
        off = (y.view(torch.uint8) != groupnorm.int8_lookup(ref, q).view(
            torch.uint8)).sum().item()
        same &= off == 0
        text += f" outputs off their entry {off}"
    return same, text


def k1_int8_coef_check(q, scale, w, b, groups):
    """K1.int8's folded affine (the kernel's coef) against the plain one
    in the kernel's order of moments (``groupnorm._int8_coef`` within
    ``int8_moment_order("kernel")``, on the CPU): (bit-equal, text)."""
    from cvvae_tpu_torch.ops.kernels import groupnorm

    _, coef, _, _ = groupnorm._int8_launch(q, scale, w, b, groups, QFLOW_EPS,
                                           torch.tensor(0.03, device=q.device),
                                           torch.int8)
    with groupnorm.int8_moment_order("kernel"):
        a, shift = groupnorm._int8_coef(q.cpu(), scale.cpu(), w.cpu(),
                                        b.cpu(), groups, QFLOW_EPS)
    got = coef.cpu()
    off = [int((got[:, i].view(torch.int32) != r.view(torch.int32)).sum())
           for i, r in ((0, a), (1, shift))]
    return off == [0, 0], f"coefficients off (a, b) {off} of {a.numel()} each"


def quant8_exhaustive(dev, scales=None):
    """quant8 through K6.requant on every fp32 v with |v / s| <= 128, for
    each of QUANT8_SCALES (a scalar scale), in chunks of QUANT8_CHUNK,
    against torch.round(v / s).clamp(-127, 127) on the card, bit-equal.
    Returns ([(scale, values, codes off)], seconds)."""
    from cvvae_tpu_torch.ops.kernels import qflow as k6

    t0 = time.perf_counter()
    out = []
    for sv in scales or QUANT8_SCALES:
        s = torch.tensor(sv, device=dev, dtype=torch.float32)
        top = int(torch.tensor(128 * sv, dtype=torch.float32).view(
            torch.int32))
        n = off = 0
        for sign in (0, -(1 << 31)):
            for lo in range(0, top + 1, QUANT8_CHUNK):
                bits = torch.arange(lo, min(top + 1, lo + QUANT8_CHUNK),
                                    device=dev, dtype=torch.int32) + sign
                v = bits.view(torch.float32)
                got = k6.requant(v, s)
                ref = torch.round(v / s).clamp_(-127, 127).to(torch.int8)
                off += (got != ref).sum().item()
                n += v.numel()
                del bits, v, got, ref
        out.append((sv, n, off))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def k5_int8_inputs(shape, cout, kernel, dev, with_bias=True, seed=80):
    """int8 codes x (``qflow_codes``), an int8 kernel, per-channel scales,
    scale_x, a bias (or None) and a per-channel out_scale that leaves some
    outputs clipped."""
    _, wq, sw, _, b = k5_inputs(shape, cout, kernel, dev, torch.float32,
                                with_bias, seed)
    xq = qflow_codes(shape, dev, seed + 3)
    sx = torch.tensor(1.0 / 127, device=dev)
    # about 3 sigma of the outputs (codes of sigma 30 against weights of
    # sigma 73 over Cin * taps products) at code 127 / linspace(0.5, 1.5)
    n = shape[-1] * math.prod(kernel)
    so = (torch.linspace(0.5, 1.5, cout, device=dev) * 3 * 30 * 73 * n ** 0.5
          * sx * sw / 127)
    return xq, wq, sw, sx, b, so


def k5_int8_check(xq, wq, sw, sx, b, kernel, stride, pads, modes, so,
                  out_dtype, frames=None, wpk=None):
    """K5 from an int8 input (K5.stage padding it, K5.gemm writing int8 at
    ``so`` or ``out_dtype``) against ``conv3d_int8_resident_plain``, bit
    for bit: (bit-equal, max|d|), on every output frame, or with
    ``frames`` on the first K5_HEAD_FRAMES and last K5_TAIL_FRAMES."""
    from cvvae_tpu_torch.ops.kernels import conv_int8

    kw = dict(out_scale=so) if out_dtype == torch.int8 else dict(
        out_dtype=out_dtype)
    got = conv_int8.conv3d_int8_resident(xq, wq, sw, sx, b, stride, pads,
                                         modes, wpk, **kw)
    torch.cuda.synchronize()
    t_out = got.shape[1]
    spans = (((0, K5_HEAD_FRAMES), (t_out - K5_TAIL_FRAMES, t_out))
             if frames else ((0, t_out),))
    exact, err = True, 0.0
    for first, last in spans:
        xs, t_pads = k5_frames(xq, kernel, stride, pads, modes, first, last)
        ref = conv_int8.conv3d_int8_resident_plain(
            xs, wq, sw, sx, b, stride, (t_pads,) + tuple(pads[1:]), modes,
            **kw)
        part = got[:, first:last].contiguous()
        same = k2_exact(part, ref) if part.dtype != torch.int8 else (
            part.shape == ref.shape and torch.equal(part, ref))
        exact &= same
        if not same:
            err = max(err, (part.float() - ref.float()).abs().max().item()
                      if part.shape == ref.shape else math.inf)
        del xs, ref, part
    del got
    return exact, err


def k6_cases(shape, dev, seed=90):
    """(requant's x, its per-channel scale, qadd's two code tensors) of a
    K6 check at ``shape``: x ~ N(0, 1) * 3 with every 7th value (k + 1/2)
    / 32, |k| < 100 (exact in bf16), a tie of the scalar scale 1/32."""
    c = shape[-1]
    x = randn(shape, seed, dev, torch.float32, 3.0)
    ties = x.view(-1)[::7]
    ties.copy_((torch.clamp(torch.round(ties * 32), -100, 99) + 0.5) / 32)
    s = qflow_scale(c, dev, True) * 3
    xq, hq = qflow_codes(shape, dev, seed + 1), qflow_codes(shape, dev,
                                                            seed + 2)
    return x, s, xq, hq


def k6_checks(shape, dev):
    """K6 bit-equal to its plain versions at ``shape``: requant of bf16
    and fp32 at a scalar and a per-channel scale; qadd (on the path
    ``qflow.add_plan`` takes) with a scalar or per-channel scale on each
    input and on the output.  Returns [(label, bit-equal)]."""
    from cvvae_tpu_torch.ops.kernels import qflow as k6

    x, s, xq, hq = k6_cases(shape, dev)
    c = shape[-1]
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for scale in (torch.tensor(1 / 32, device=dev), s):
            xd = x.to(dtype)
            same = torch.equal(k6.requant(xd, scale),
                               k6.requant_plain(xd, scale))
            out.append((f"K6.requant {tuple(shape)} {dtype} scale "
                        f"{tuple(scale.shape)}", same))
    # the last: (qx + qh) / 64 at 1/32, a tie wherever qx + qh is odd
    pow2 = [torch.tensor(v, device=dev) for v in (1 / 64, 1 / 64, 1 / 32)]
    path = k6.add_plan(xq.numel(), c)["path"]
    for sx, sh, so in ((qflow_scale(c, dev, False), qflow_scale(c, dev, True),
                        qflow_scale(c, dev, True) * 1.7),
                       (qflow_scale(c, dev, True), qflow_scale(c, dev, False),
                        torch.tensor(0.02, device=dev)),
                       (qflow_scale(c, dev, True) * 1.3,
                        qflow_scale(c, dev, True).flip(0),
                        qflow_scale(c, dev, True) * 2.1), pow2):
        same = torch.equal(k6.qadd(xq, sx, hq, sh, so),
                           k6.qadd_plain(xq, sx, hq, sh, so))
        out.append((f"K6 qadd {tuple(shape)} ({path} path) scales "
                    f"{tuple(sx.shape)} {tuple(sh.shape)} -> "
                    f"{tuple(so.shape)}", same))
    torch.cuda.synchronize()
    return out


def _qflow_small(record, dev):
    """Every new mode on small ragged cases: K5 from int8 on
    K5_CHECK_CASES (int8 out at per-channel scales by direct stores, bf16
    and fp32 out) and K5_INT8_CASES (int8 out, staged), K1's int8 mode on
    QFLOW_K1_CASES (scalar and per-channel scales; int8, bf16, fp32 out;
    its per-code outputs against the plain table), K6 on
    QFLOW_K6_CASES."""
    from cvvae_tpu_torch.ops.kernels import groupnorm

    cases = [(f"case {i}", c, dtypes) for i, c in enumerate(K5_CHECK_CASES)
             for dtypes in [(torch.int8, torch.bfloat16, torch.float32)]]
    cases += [(f"staged case {i}", c, (torch.int8,))
              for i, c in enumerate(K5_INT8_CASES)]
    for label, (shape, cout, kernel, stride, pads, modes, with_bias), \
            dtypes in cases:
        xq, wq, sw, sx, b, so = k5_int8_inputs(shape, cout, kernel, dev,
                                               with_bias)
        for out_dtype in dtypes:
            exact, err = k5_int8_check(xq, wq, sw, sx, b, kernel, stride,
                                       pads, modes, so, out_dtype)
            record("K5.int8", f"{label} {shape}->{cout} k={kernel} "
                   f"s={stride} pads={pads} {modes} bias={with_bias} out "
                   f"{out_dtype} bit-exact={exact}", err,
                   0.0 if exact else 1.0, "tol=bit-exact")
    for shape, groups in QFLOW_K1_CASES:
        for per_channel in (False, True):
            q, s, w, b = k1_int8_inputs(shape, dev, per_channel)
            for out_scale, out_dtype in ((torch.tensor(0.03, device=dev),
                                          torch.int8),
                                         (None, torch.bfloat16),
                                         (None, torch.float32)):
                got = groupnorm.group_norm_silu_int8(
                    q, s, w, b, num_groups=groups, eps=QFLOW_EPS,
                    out_scale=out_scale, out_dtype=out_dtype)
                err, excess, text = k1_int8_check(got, q, s, w, b, groups,
                                                  out_scale, out_dtype)
                record("K1.int8", f"{shape} G={groups} per_channel="
                       f"{per_channel} out {out_dtype}", err, excess, text)
                same, text = k1_int8_table_check(q, s, w, b, groups,
                                                 out_scale, out_dtype)
                record("K1.int8", f"{shape} G={groups} per_channel="
                       f"{per_channel} out {out_dtype}: the table and every "
                       f"output against the plain table", 0.0 if same else
                       1.0, 0.0 if same else 1.0,
                       f"tol=bit-exact {text}")
            same, text = k1_int8_coef_check(q, s, w, b, groups)
            record("K1.int8", f"{shape} G={groups} per_channel="
                   f"{per_channel}: the affine against the plain one in the "
                   f"kernel's order of moments", 0.0 if same else 1.0,
                   0.0 if same else 1.0, f"tol=bit-exact {text}")
    for shape in QFLOW_K6_CASES:
        for label, same in k6_checks(shape, dev):
            key = "K6.requant" if label.startswith("K6.requant") else "K6"
            record(key, f"{label} bit-exact={same}", 0.0 if same else 1.0,
                   0.0 if same else 1.0, "tol=bit-exact")


def qflow_master(c, dev, seed=0):
    """QFLOW_BLOCKS resblocks of width ``c`` in fp32 on ``dev``: each a
    dict of norm1, conv1 (3x3x3, zero pads: the decoder is non-causal),
    norm2, conv2 (1x3x3), with torch's conv init and norm weights and
    biases off 1 and 0."""
    from cvvae_tpu_torch.ops.conv import Conv, Conv3DSpec
    from cvvae_tpu_torch.ops.norm import norm_init

    g = torch.Generator().manual_seed(seed)
    blocks = []
    for _ in range(QFLOW_BLOCKS):
        blk = {}
        for i, spec in ((1, Conv3DSpec.v1_plain()), (2,
                                                     Conv3DSpec.spatial2d())):
            n = norm_init(c)
            with torch.no_grad():
                n.weight.uniform_(0.8, 1.2, generator=g)
                n.bias.uniform_(-0.1, 0.1, generator=g)
            blk[f"norm{i}"] = n.to(dev)
            blk[f"conv{i}"] = Conv(spec, c, c, g).to(dev)
        blocks.append(blk)
    return blocks


def qflow_run(blocks, h):
    """The float chain (K1, the port's conv3d: cuDNN, or K5 on quantized
    convs), the activations in h's dtype."""
    from cvvae_tpu_torch.ops.conv import conv3d
    from cvvae_tpu_torch.ops.norm import group_norm

    for blk in blocks:
        r = group_norm(h, blk["norm1"], num_groups=QFLOW_GROUPS,
                       eps=QFLOW_EPS, silu=True)
        r = conv3d(r, blk["conv1"], blk["conv1"].spec)
        r = group_norm(r, blk["norm2"], num_groups=QFLOW_GROUPS,
                       eps=QFLOW_EPS, silu=True)
        r = conv3d(r, blk["conv2"], blk["conv2"].spec)
        h = h + r
    return h


def qflow_modes(master, calib):
    """The three modes' blocks: bf16 (a bf16 copy), int8-conv (the convs
    quantized, ``quant.quantize_conv_params``, and calibrated on ``calib``
    in bf16, as ``serve --dtype int8`` calibrates) and int8-res (each
    conv's quantized tensors, packed kernel and ``scale_x``, and the
    residency scales of an fp32 pass over ``calib`` through the quantized
    blocks, ``tools/probe_residency.py``'s scheme: the entry's per-tensor
    max, each conv output's and each residual's per channel, over 127)."""
    import copy

    from cvvae_tpu_torch.ops import quant
    from cvvae_tpu_torch.ops.conv import conv3d
    from cvvae_tpu_torch.ops.kernels import conv_int8
    from cvvae_tpu_torch.ops.norm import group_norm

    bf16 = [{k: copy.deepcopy(m).to(torch.bfloat16) for k, m in b.items()}
            for b in master]
    int8 = [{k: copy.deepcopy(m) for k, m in b.items()} for b in master]
    for b in int8:
        for k in ("conv1", "conv2"):
            quant.quantize_conv_params(b[k], min_cin=64)
    with quant.calibration_scope() as rec:
        qflow_run(int8, calib.to(torch.bfloat16))
    quant.attach_activation_scales(rec)

    def chan(t):
        return t.float().abs().amax(dim=(0, 1, 2, 3)) / 127.0

    res, h = [], calib.float()
    for b in int8:
        blk = {k: dict(weight=b[k].weight, bias=b[k].bias)
               for k in ("norm1", "norm2")}
        blk["scale_entry"] = h.abs().amax() / 127.0
        r = h
        for i in (1, 2):
            conv = b[f"conv{i}"]
            r = group_norm(r, b[f"norm{i}"], num_groups=QFLOW_GROUPS,
                           eps=QFLOW_EPS, silu=True)
            r = conv3d(r, conv, conv.spec)
            blk[f"conv{i}"] = dict(
                weight_q=conv.weight_q, scale_w=conv.scale_w, bias=conv.bias,
                scale_x=conv.scale_x, scale_y=chan(r), spec=conv.spec,
                k5_wpk=conv_int8.pack_weight(conv.weight_q))
        h = h + r
        blk["scale_res"] = chan(h)
        res.append(blk)
    return bf16, int8, res


def qflow_residency(blocks, x):
    """The int8-resident chain (``ops/qflow.py``): x requantized once
    (K6), then each block's GN+SiLU (K1's int8 mode) writing int8 at the
    next conv's scale_x, the convs (K5 from int8) writing int8 at their
    per-channel scale_y, the residual add (K6) at scale_res; dequantized
    to bf16 at the end."""
    from cvvae_tpu_torch.ops import qflow

    h = qflow.requant(x, blocks[0]["scale_entry"])
    for blk in blocks:
        r = h
        for i in (1, 2):
            conv = blk[f"conv{i}"]
            r = qflow.qgroup_norm_silu(r, blk[f"norm{i}"],
                                       num_groups=QFLOW_GROUPS,
                                       eps=QFLOW_EPS,
                                       out_scale=conv["scale_x"])
            r = qflow.qconv3d(r, conv, conv["spec"],
                              out_scale=conv["scale_y"])
        h = qflow.qadd(h, r, blk["scale_res"])
    return qflow.dequant(h, torch.bfloat16)


def qflow_both_orders(blocks, x):
    """``qflow_residency`` of ``blocks`` and ``x`` on the CPU (the plain
    versions; a card's tensors are copied over, K5's packed weights left
    behind), with the int8 GroupNorm's moments in XLA's order and in
    K1.int8's (``groupnorm.int8_moment_order``): (xla, kernel)."""
    from cvvae_tpu_torch.ops.kernels import groupnorm

    cpu = [{k: ({n: v.cpu() if torch.is_tensor(v) else v
                 for n, v in d.items() if n != "k5_wpk"}
                if isinstance(d, dict) else d.cpu()) for k, d in b.items()}
           for b in blocks]
    x = x.cpu()
    xla = qflow_residency(cpu, x)
    with groupnorm.int8_moment_order("kernel"):
        return xla, qflow_residency(cpu, x)


def qflow_chain_card_vs_cpu(dev):
    """The chain at width 128 on a QFLOW_CHAIN_CLIP clip, built and
    calibrated on the card, run there (the kernels) and on the CPU in both
    moment orders (``qflow_both_orders``): (dB against the kernel's order,
    dB against XLA's, the card's output)."""
    master = qflow_master(128, dev)
    x = randn(QFLOW_CHAIN_CLIP, 4, dev, torch.float32)
    _, _, res = qflow_modes(master, x)
    got = qflow_residency(res, x.to(torch.bfloat16))
    xla, ker = qflow_both_orders(res, x.to(torch.bfloat16))
    g = got.cpu().float()
    return agreement_db(g, ker.float()), agreement_db(g, xla.float()), got


def agreement_db(a, b):
    """10 log10(mean b^2 / mean (a - b)^2), as tools/probe_residency.py
    reads each mode against the fp32 chain."""
    a, b = a.double(), b.double()
    mse = (a - b).square().mean().item()
    return 10 * math.log10(b.square().mean().item() / max(mse, 1e-12))


def _qflow_numerics(dev, c, smi):
    """Each mode against the fp32 chain (TF32 off) on a QFLOW_NUMERICS
    clip of width ``c``, calibrated on the clip: dB."""
    master = qflow_master(c, dev, seed=c)
    x = randn(QFLOW_NUMERICS + (c,), 5, dev, torch.float32)
    ref = qflow_run(master, x)
    bf16, int8, res = qflow_modes(master, x)
    got = {"bf16": qflow_run(bf16, x.to(torch.bfloat16)),
           "int8-conv": qflow_run(int8, x.to(torch.bfloat16)),
           "int8-res": qflow_residency(res, x.to(torch.bfloat16))}
    db = {k: agreement_db(v, ref) for k, v in got.items()}
    say(f"[qflow] numerics {QFLOW_NUMERICS + (c,)}: agreement with the fp32 "
        f"chain (dB) {json.dumps(db)}; card {smi}")
    if not all(math.isfinite(v) and v > 20.0 for v in db.values()):
        raise SystemExit(f"qflow numerics: a mode is off the fp32 chain {db}")
    return db


def device_ms_by_group(fn, tries=3):
    """({group: device ms}, {kernel key: (launches the profile holds, its
    counter's launches)}) of one call of ``fn`` (``profile_measured``):
    its kernels' device time summed by ``profiling.group_kernels``, the
    largest first.  A profile that lost a counted launch is taken again,
    up to ``tries`` in all; the last is returned, ``held`` showing what
    it lost."""
    from cvvae_tpu_torch.utils import profiling

    keys = {k for k, _ in profiling.KERNEL_GROUPS.values()}
    for _ in range(tries):
        events, counted = profile_measured(fn)
        groups = profiling.group_kernels(events)
        seen = {profiling.key_of(g): r["launches"]
                for g, r in groups.items() if profiling.key_of(g)}
        held = {k: (seen.get(k, 0), counted[k]) for k in keys
                if seen.get(k) or counted[k]}
        if all(a == b for a, b in held.values()):
            break
    return {g: r["us"] / 1e3 for g, r in sorted(
        groups.items(), key=lambda kv: -kv[1]["us"])}, held


def _qflow_shape(dev, name, shape, record, smi, count):
    """One chain shape: each new mode against its plain version and timed
    (K5 from int8 at conv1's and conv2's convs, K1's int8 mode, K6), then
    the three chains timed in turns, ms a block.  With ``count``, the
    launches of one int8-res chain (counts set to 0 just before)."""
    from cvvae_tpu_torch.ops.kernels import conv_int8, groupnorm
    from cvvae_tpu_torch.ops.kernels import qflow as k6

    c = shape[-1]
    master = qflow_master(c, dev)
    x = randn(shape, 3, dev, torch.bfloat16)
    calib = x[:, :QFLOW_CALIB[0], :QFLOW_CALIB[1], :QFLOW_CALIB[2]].float()
    bf16, int8, res = qflow_modes(master, calib)
    del master, calib
    # K5 from int8, both convs of block 0, int8 and bf16 out
    q = qflow_codes(shape, dev, 11)
    for i in (1, 2):
        conv = res[0][f"conv{i}"]
        spec = conv["spec"]
        args = (q, conv["weight_q"], conv["scale_w"], conv["scale_x"],
                conv["bias"], spec.kernel, spec.stride, spec.pads,
                spec.modes, conv["scale_y"])
        for out_dtype in (torch.int8, torch.bfloat16):
            exact, err = k5_int8_check(*args, out_dtype, frames=True,
                                       wpk=conv["k5_wpk"])
            # both convs timed: conv2 is half the chain's K5.int8 launches
            kw = (dict(out_scale=conv["scale_y"]) if out_dtype ==
                  torch.int8 else dict(out_dtype=out_dtype))
            xs, t_pads = k5_frames(q, spec.kernel, spec.stride,
                                   spec.pads, spec.modes, 0,
                                   K5_HEAD_FRAMES)
            ms = turns({
                "plain": lambda: conv_int8.conv3d_int8_resident_plain(
                    xs, *args[1:5], spec.stride,
                    (t_pads,) + tuple(spec.pads[1:]), spec.modes, **kw),
                "kernel": lambda: conv_int8.conv3d_int8_resident(
                    q, *args[1:5], spec.stride, spec.pads, spec.modes,
                    conv["k5_wpk"], **kw)})
            timing = (shape, out_dtype, ms["kernel"], ms["plain"], None,
                      dict(cout=c, kernel=spec.kernel, stride=spec.stride,
                           pads=spec.pads))
            extra = dict(name=f"{name} conv{i}",
                         plain_frames=K5_HEAD_FRAMES)
            del xs
            record("K5.int8", f"{name} conv{i} {shape} k={spec.kernel} out "
                   f"{out_dtype}, output frames [0, {K5_HEAD_FRAMES}) and "
                   f"the last {K5_TAIL_FRAMES} bit-exact={exact}", err,
                   0.0 if exact else 1.0, "tol=bit-exact", timing, extra)
            torch.cuda.empty_cache()
    # K1's int8 mode: a residual's per-channel scale to int8, a conv
    # output's scalar scale to bf16
    for per_channel, out_scale, out_dtype in (
            (True, torch.tensor(0.03, device=dev), torch.int8),
            (False, None, torch.bfloat16)):
        q1, s, w, b = k1_int8_inputs(shape, dev, per_channel)
        kw = dict(num_groups=QFLOW_GROUPS, eps=QFLOW_EPS, out_scale=out_scale,
                  out_dtype=out_dtype)
        got = groupnorm.group_norm_silu_int8(q1, s, w, b, **kw)
        torch.cuda.synchronize()
        err, excess, text = k1_int8_check(got, q1, s, w, b, QFLOW_GROUPS,
                                          out_scale, out_dtype)
        del got
        torch.cuda.empty_cache()
        k_ms, p_ms, _ = in_turns(
            lambda: groupnorm.group_norm_silu_int8_plain(q1, s, w, b, **kw),
            lambda: groupnorm.group_norm_silu_int8(q1, s, w, b, **kw))
        record("K1.int8", f"{name} {shape} per_channel={per_channel} out "
               f"{out_dtype}", err, excess, text,
               (shape, out_dtype, k_ms, p_ms, None, {}), dict(name=name))
        same, text = k1_int8_table_check(q1, s, w, b, QFLOW_GROUPS,
                                         out_scale, out_dtype, lookup=False)
        record("K1.int8", f"{name} {shape} per_channel={per_channel} out "
               f"{out_dtype}: the table against the plain table",
               0.0 if same else 1.0, 0.0 if same else 1.0,
               f"tol=bit-exact {text}")
        del q1
        torch.cuda.empty_cache()
    # K6
    for label, same in k6_checks(shape, dev):
        key = "K6.requant" if label.startswith("K6.requant") else "K6"
        record(key, f"{name} {label} bit-exact={same}", 0.0 if same else 1.0,
               0.0 if same else 1.0, "tol=bit-exact")
    # K6's add at the chain's shape (the sliced path) and the general path
    # at as many values (C 24), per-channel scales
    general = dict(QFLOW_K6_GENERAL)[name]
    for where in (shape, general):
        cw = where[-1]
        xq, hq = qflow_codes(where, dev, 21), qflow_codes(where, dev, 22)
        sx, so = qflow_scale(cw, dev, True), qflow_scale(cw, dev, True) * 1.7
        path = k6.add_plan(xq.numel(), cw)["path"]
        k_ms, p_ms, _ = in_turns(lambda: k6.qadd_plain(xq, sx, hq, sx, so),
                                 lambda: k6.qadd(xq, sx, hq, sx, so))
        same = torch.equal(k6.qadd(xq, sx, hq, sx, so),
                           k6.qadd_plain(xq, sx, hq, sx, so))
        record("K6", f"{name} qadd {where} ({path} path) timed, bit-exact="
               f"{same}", 0.0 if same else 1.0, 0.0 if same else 1.0,
               "tol=bit-exact", (where, torch.int8, k_ms, p_ms, None, {}),
               dict(name=name, path=path))
        del xq, hq
        torch.cuda.empty_cache()
    # K6.requant, and a yardstick beside it: torch.quantize_per_tensor of
    # the same values (qint8, zero point 0; in fp32 where it refuses bf16),
    # which clips at -128 and multiplies by a reciprocal: not the same
    # function, so no library_ms
    entry = res[0]["scale_entry"]
    k_ms, p_ms, _ = in_turns(lambda: k6.requant_plain(x, entry),
                             lambda: k6.requant(x, entry))
    yard_in = x
    try:
        torch.quantize_per_tensor(x[:, :1], float(entry), 0, torch.qint8)
    except RuntimeError:
        yard_in = x.float()
    yard_ms = time_ms(lambda: torch.quantize_per_tensor(
        yard_in, float(entry), 0, torch.qint8))
    yard_dtype = str(yard_in.dtype).replace("torch.", "")
    del yard_in
    record("K6.requant", f"{name} requant {shape} bf16 timed (yardstick "
           f"torch.quantize_per_tensor in {yard_dtype}: {yard_ms!r} ms)", 0.0,
           0.0, "tol=bit-exact", (shape, torch.bfloat16, k_ms, p_ms, None,
                                  {}),
           dict(name=name, yardstick_ms=yard_ms,
                yardstick="torch.quantize_per_tensor, qint8, in "
                          + yard_dtype))
    torch.cuda.empty_cache()
    # the three chains
    counts = None
    if count:
        torch.cuda.synchronize()
        reset_launch_counts()
        out = qflow_residency(res, x)
        torch.cuda.synchronize()
        counts = launch_counts()
        if out.shape != x.shape or not torch.isfinite(out).all():
            raise SystemExit(f"qflow: the int8-res chain's output "
                             f"{tuple(out.shape)} is not finite")
        del out
    ms = turns({"bf16": lambda: qflow_run(bf16, x),
                "int8-conv": lambda: qflow_run(int8, x),
                "int8-res": lambda: qflow_residency(res, x)})
    per_block = {k: v / QFLOW_BLOCKS for k, v in ms.items()}
    say(f"[qflow] {name} {shape}: ms a block (of {QFLOW_BLOCKS}, CUDA "
        f"events, median of turns) {json.dumps(per_block)}; card {smi}")
    # where one int8-res chain's device time goes, by kernel group
    groups, held = device_ms_by_group(lambda: qflow_residency(res, x))
    if not groups:
        raise SystemExit("qflow: the int8-res chain's profile holds no "
                         "device event")
    say(f"[qflow] {name} {shape}: one int8-res chain's device ms by "
        f"group {json.dumps(groups)}, in all {sum(groups.values())!r}; "
        f"launches (profiled, counted) {json.dumps(held)}"
        + ("" if all(a == b for a, b in held.values()) else
           " (the profile lost launches: its ms fall short)"))
    del x, bf16, int8, res
    gc.collect()
    torch.cuda.empty_cache()
    return per_block, counts


def _qflow(dev, smi, summary):
    """Phase 13: int8 activation residency on the card.  Each new kernel
    mode against its plain version on small cases and at both chain
    shapes (int8 and bf16 outputs), timed there; the three chains (bf16,
    int8-conv, int8-res) timed, ms a block; each mode's agreement with
    the fp32 chain.  Returns the int8-res chain's launches (counts set to
    0 just before one chain at the first shape)."""
    t0 = time.perf_counter()

    def record(key, label, err, excess, tol_text, timing=None, extra=None):
        """Print one check, as phase 3's ``record``; fail it where
        ``excess`` > 0."""
        ok = excess <= 0.0
        line = f"[qflow] {key} {label}: max_abs_err={err!r} {tol_text}"
        if timing:
            shape, dtype, k_ms, p_ms, lib_ms, kw = timing
            b_ms, by = bound(key, shape, dtype, **kw)
            summary[key]["timed"].append(dict(
                shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                share=b_ms / k_ms, library_ms=lib_ms, **(extra or {})))
            line += (f" kernel_ms={k_ms!r} plain_ms={p_ms!r} "
                     f"bound_ms={b_ms!r} ({by}) share={b_ms / k_ms!r}; "
                     f"card {smi}")
        say(f"{line} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{key} {label}: disagrees with its plain "
                             f"version (max_abs_err {err}; {tol_text})")
        summary[key]["max_abs_err"] = max(summary[key]["max_abs_err"], err)

    with torch.no_grad():  # int8 is inference-only
        _qflow_small(record, dev)
        held, secs = quant8_exhaustive(dev)
        for sv, n, off in held:
            record("K6.requant", f"quant8 exhaustive at scale {sv!r}: {n} "
                   f"fp32 values (|v / s| <= 128), {off} codes off "
                   f"torch.round(v / s).clamp(-127, 127)", float(off),
                   float(off), "tol=bit-exact")
        say(f"[qflow] quant8 exhaustive: {sum(n for _, n, _ in held)} "
            f"values at {len(held)} scales in {secs:.2f}s")
        db, db_xla, got = qflow_chain_card_vs_cpu(dev)
        ok = (db >= QFLOW_CHAIN_DB and got.shape == QFLOW_CHAIN_CLIP
              and bool(torch.isfinite(got).all()))
        say(f"[qflow] the int8-res chain {QFLOW_CHAIN_CLIP}, card against "
            f"the CPU in K1.int8's order of moments: {db!r} dB (>= "
            f"{QFLOW_CHAIN_DB}); against the CPU in XLA's order (a reading): "
            f"{db_xla!r} dB {'ok' if ok else 'FAIL'}; card {smi}")
        if not ok:
            raise SystemExit(f"qflow: the int8-res chain on the card is "
                             f"{db} dB from the CPU's in the kernel's order")
        del got
        dbs = {c: _qflow_numerics(dev, c, smi)
               for c in sorted({s[-1] for _, s in QFLOW_SHAPES})}
        chains, launches = {}, None
        for i, (name, shape) in enumerate(QFLOW_SHAPES):
            chains[name], counts = _qflow_shape(dev, name, shape, record,
                                                smi, count=i == 0)
            launches = launches or counts
    need = ("K5", "K5.stage", "K5.int8", "K1.int8", "K6", "K6.requant")
    say(f"[qflow] phase 13 in {time.perf_counter() - t0:.1f}s; one int8-res "
        f"chain's launches {json.dumps({k: v for k, v in launches.items() if v})}"
        f"; ms a block {json.dumps(chains)}; dB against fp32 "
        f"{json.dumps(dbs)}; card {smi}")
    if any(launches[k] == 0 for k in need) or any(
            launches[k] for k in ("K1", "K4", "K2", "K3")):
        raise SystemExit(f"qflow: the int8-res chain launched {launches}")
    return launches


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "false); this script runs only on a GPU machine")
        return 1
    sys.path.insert(0, ROOT)
    from cvvae_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    # fp32 references in full fp32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    say(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"cuDNN {torch.backends.cudnn.version()}, python "
        f"{sys.version.split()[0]}")
    say(f"[device] {smi}")
    t_start = time.perf_counter()
    # wall seconds of each phase, printed at the end
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 2)
        return out

    # phase 2: build
    t0 = time.perf_counter()
    _build.library()
    phase_s["build"] = round(time.perf_counter() - t0, 2)
    say(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_build.last_build_seconds:.2f}s)"
        f" into {_build.build_dir()}")
    log = _build.build_dir() / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                say(f"[build] {line.strip()}")

    # phase 3: kernels against their plain versions, fp32 attention's exact
    # path, the edge-pad convs
    summary = timed("kernels", _check_kernels, dev)
    timed("attention_fp32", _attention_fp32, dev, smi)
    timed("edge_convs", _check_edge_convs, dev, smi)
    # phase 4: the slice, card against CPU, in float and in int8
    for family in SLICE_CLIPS:
        timed(f"slice_{family}", _check_slice, dev, family)
    for family in INT8_SLICE_CLIPS:
        timed(f"int8_slice_{family}", _check_int8_slice, dev, family)
    # phase 5: serving, each path with its own counts; int8's frames
    # against bf16's
    by_path = {}
    for path in PATHS:
        by_path["-".join(path)] = timed("serve_" + "-".join(path), _serve,
                                        dev, smi, path)
    for variant, dtype in PATHS:
        if dtype == "int8":
            (q_u8, q_f), (b_u8, b_f) = (by_path[f"{variant}-{d}"][2]
                                        for d in ("int8", "bf16"))
            peak = 2 * b_f.abs().max().item()
            db = frames_psnr(q_f, b_f, peak)
            ok = db >= INT8_SERVE_PSNR
            say(f"[serve] {variant}: int8 /reconstruct against bf16's: "
                f"PSNR {db!r} dB over 2 max|bf16 frames| = {peak!r}, as "
                f"bench.py measures it (>= {INT8_SERVE_PSNR}); of the uint8 "
                f"bytes, over 255: {frames_psnr(q_u8, b_u8, 255.0)!r} dB "
                f"{'ok' if ok else 'FAIL'}; card {smi}")
            if not ok:
                raise SystemExit(f"{variant}: int8 serving is {db} dB from "
                                 f"bf16")

    # phase 6: streaming at full width, its own counts; phase 7: reference
    # checkpoints
    stream = timed("stream", _stream, dev, smi)
    timed("checkpoints", _checkpoints, dev, smi)
    # phase 8: training -- the backward kernels at the path's shapes, one G
    # and one D step card against CPU, then train.main on the shipped YAML
    # (its launches counted from 0 just before)
    t8 = time.perf_counter()
    timed("train_kernels", _train_kernels, dev, summary)
    train_check, ctx = timed("train_card_vs_cpu", _train_card_vs_cpu, dev)
    timed("train_repeat", _train_repeat, dev, ctx)
    bf16_check = timed("train_bf16", _train_bf16, dev, ctx[:3])
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    v1_check, v1_bf16 = timed("train_v1", _train_v1, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    train_main = timed("train_main", _train_main, dev, smi)
    train_bf16 = timed("train_main_bf16", _train_main, dev, smi, "bfloat16")
    say(f"[train] phase 8 in {time.perf_counter() - t8:.1f}s; launches in "
        f"the card's G + D check {train_check}, in the bf16 G + D check "
        f"{bf16_check}, in v1's G + D check {v1_check}, in v1's bf16 steps "
        f"{v1_bf16}")
    # phase 9: the latent-compat diffusion demo (its launches counted from
    # 0 just before the demo)
    diffusion = timed("diffusion", _diffusion, dev, smi, summary)
    # phase 10: the profiling tools (their launches counted from 0 just
    # before)
    tools = timed("tools", _tools, dev, smi)
    # phase 11: multi-device inference, two ranks on the card (each rank's
    # launches counted from 0 just before the served requests)
    mesh_counts, mesh_per_rec = timed("mesh", _mesh, dev, smi, summary)
    mesh_path = "mesh-" + "-".join(MESH_SERVE_PATH)
    mesh_launches = {k: sum(c[k] for c in mesh_counts) for k in COUNTERS}
    # phase 12: data-parallel training, two ranks on the card (each rank's
    # launches counted from 0 on the rank just before each of its paths)
    dp_counts = timed("dp", _dp, dev, smi)
    dp_launches = {k: sum(c[k] for c in dp_counts) for k in COUNTERS}
    # phase 13: int8 activation residency (the int8-res chain's launches
    # counted from 0 just before one chain)
    qflow_launches = timed("qflow", _qflow, dev, smi, summary)

    kernels = []
    for k in KERNELS:
        # the top-level numbers are those of the kernel's bf16 shape with
        # the largest bound (its largest shape on a path); the backward
        # kernels are timed in both dtypes since the training path runs both
        timed_k = summary[k]["timed"]
        main_dtype = MAIN_DTYPES.get(k, "bfloat16")
        main_shape = max([e for e in timed_k if e["dtype"] == main_dtype]
                         or timed_k, key=lambda e: e["bound_ms"])
        kernels.append(dict(
            KERNELS[k],
            launches=(sum(n[k] for n, _, _ in by_path.values()) + stream[k]
                      + train_main[k] + train_bf16[k] + v1_check[k]
                      + v1_bf16[k] + diffusion[k] + tools[k]
                      + mesh_launches[k] + dp_launches[k]
                      + qflow_launches[k]),
            launches_by_path=dict(
                {p: n[k] for p, (n, _, _) in by_path.items()},
                **{"stream-" + "-".join(STREAM_PATH): stream[k],
                   "train": train_main[k], "train-bf16": train_bf16[k],
                   "train-v1": v1_check[k], "train-v1-bf16": v1_bf16[k],
                   "diffusion": diffusion[k], "tools": tools[k],
                   mesh_path: mesh_launches[k], "dp": dp_launches[k],
                   "qflow-int8-res": qflow_launches[k]}),
            launches_by_rank={mesh_path: [c[k] for c in mesh_counts],
                              "dp": [c[k] for c in dp_counts]},
            launches_per_reconstruct=dict(
                {p: r[k] for p, (_, r, _) in by_path.items()},
                **{mesh_path: [c[k] for c in mesh_per_rec]}),
            max_abs_err=summary[k]["max_abs_err"],
            **{f: main_shape[f] for f in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "share",
                                          "library_ms")},
            timed=summary[k]["timed"]))
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s; "
        f"wall s by phase: {json.dumps(phase_s)}")
    say(f"[card] {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
