"""Where K4.bwd's dkv kernel spends its time, read inside the kernel.

    python -m cvvae_tpu_torch.utils.trace_k4_bwd [--shape B S D ...]

Copies ``cvvae_tpu_torch/csrc/`` into a temporary directory, inserts
``%globaltimer`` stamps into ``attention_bwd.cu`` (``STAMPS``) and builds
it (``kernel_variants._build_variant``):

- thread 0 of block (0, 0) stamps each phase of every steady-state walk
  tile of dkv's loop: the cluster barrier, the update's and the next
  partials' issue, the exchange (the other ranks' partials loaded, P and
  dS formed), the update's retire and the stage's release, the stores,
  the partials' retire and publication;
- thread 0 of every dkv CTA records its start, its end and its SM.

Runs K4.bwd at each shape (default ``chip_smoke.K4_BWD_SHAPES``; the
third call is read) and prints, for each: the clusters the card holds at
once (``cudaOccupancyMaxActiveClusters``), the CTAs resident at once and
the SMs used, dkv's span, the CTAs' median duration, and the median ns of
each phase over the loop's tiles.  The stamps cost a few ns each; the
instrumented kernel is not the committed one's timing, only its split.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

#: the loop of dkv's steady state as the source has it, and stamped
LOOP = """      cluster_sync();
      update(i - 1);
      partials(i + 1);
      exchange(i);
      wgmma_wait<1>();  // tile i-1's update
      release(i - 1);
      store(i);
      wgmma_wait<0>();
      publish(i + 1);
"""
STAMPED_LOOP = """      stamp();
      cluster_sync();
      stamp();
      update(i - 1);
      partials(i + 1);
      stamp();
      exchange(i);
      stamp();
      wgmma_wait<1>();  // tile i-1's update
      release(i - 1);
      stamp();
      store(i);
      stamp();
      wgmma_wait<0>();
      publish(i + 1);
      stamp();
"""
#: the intervals between a tile's stamps (the last: to the next tile's)
PHASES = ("cluster barrier", "update + next partials issued", "exchange",
          "update retired, stage released", "stores", "partials retired, "
          "published", "loop")
#: words of the trace buffer: 4 per CTA from 0, the stamps from STAMP0
STAMP0, N_WORDS = 60000, 65536

#: (text of csrc/attention_bwd.cu, its replacement)
STAMPS = [
    ("typedef __nv_bfloat16 bf16;\n",
     "typedef __nv_bfloat16 bf16;\n"
     f"__device__ unsigned long long g_trace[{N_WORDS}];\n"),
    ("  const int rank = (int)cluster_rank();\n",
     "  const int rank = (int)cluster_rank();\n"
     "  const uint64_t t_start = now_ns();\n"
     "  const bool tr = blockIdx.x == 0 && blockIdx.y == 0 && "
     "threadIdx.x == 0;\n"
     "  int tp = 0;\n"
     "  auto stamp = [&]() {\n"
     f"    if (tr && tp < {N_WORDS - STAMP0}) "
     f"g_trace[{STAMP0} + tp++] = now_ns();\n"
     "  };\n"),
    (LOOP, STAMPED_LOOP),
    ("  // no CTA touches another's shared memory after the last barrier\n",
     "  if (threadIdx.x == 0) {\n"
     "    const int cta = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     f"    if (4 * cta + 3 < {STAMP0}) {{\n"
     "      g_trace[4 * cta] = t_start;\n"
     "      g_trace[4 * cta + 1] = now_ns();\n"
     "      g_trace[4 * cta + 2] = sm;\n"
     "    }\n"
     "  }\n"),
    ("}  // namespace\n",
     "}  // namespace\n"
     "CVVAE_EXPORT int cvvae_k4_bwd_trace(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n"
     "}\n"
     "CVVAE_EXPORT int cvvae_k4_bwd_clusters() {\n"
     "  cudaLaunchConfig_t cfg = {};\n"
     "  cfg.gridDim = dim3(4, 1);\n"
     "  cfg.blockDim = dim3(kThreads);\n"
     "  cfg.dynamicSmemBytes = Layout<kSliceCols>::bytes;\n"
     "  cudaFuncSetAttribute(flash_bwd_dkv<kSliceCols, 4>,\n"
     "                       cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     "                       Layout<kSliceCols>::bytes);\n"
     "  int n = -1;\n"
     "  return cudaOccupancyMaxActiveClusters(\n"
     "             &n, (void*)flash_bwd_dkv<kSliceCols, 4>, &cfg) ==\n"
     "                 cudaSuccess ? n : -1;\n"
     "}\n"),
]


def phases_ns(stamps: np.ndarray) -> dict:
    """{phase: median ns} over the loop's tiles from one CTA's stamps
    (``len(PHASES)`` a tile); the last tile, which has no successor, is
    dropped."""
    per = len(PHASES)
    tiles = stamps[:len(stamps) // per * per].reshape(-1, per)
    nxt = np.concatenate([tiles[1:, :1], tiles[-1:, -1:]])
    rel = np.diff(np.concatenate([tiles, nxt], axis=1), axis=1)[:-1]
    return {p: float(np.median(rel[:, j])) for j, p in enumerate(PHASES)}


def residency(ctas: np.ndarray) -> dict:
    """CTAs resident at once, SMs used, span and median duration (µs) of
    (start ns, end ns, SM) rows."""
    start, end = ctas[:, 0] - ctas[:, 0].min(), ctas[:, 1] - ctas[:, 0].min()
    events = sorted([(t, 1) for t in start] + [(t, -1) for t in end])
    now = most = 0
    for _, step in events:
        now += step
        most = max(most, now)
    return {"resident": most, "sms": len(set(ctas[:, 2].tolist())),
            "span_us": float(end.max()) / 1e3,
            "cta_median_us": float(np.median(end - start)) / 1e3}


def main(argv=None) -> int:
    import chip_smoke
    from cvvae_tpu_torch.ops.kernels import _build, attention
    from cvvae_tpu_torch.utils.kernel_variants import _build_variant

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", nargs=3, type=int, action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_k4_bwd: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    shapes = ([(tuple(s), False) for s in args.shape] if args.shape
              else chip_smoke.K4_BWD_SHAPES)
    print(f"[card] {chip_smoke.nvidia_smi_line()}")
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build_variant(Path(tmp), 0, STAMPS, "attention_bwd.cu")
        _build.library(lib)
        cdll = _build._load(lib)
        print(f"[k4.bwd trace] clusters of 4 the card holds at once: "
              f"{cdll.cvvae_k4_bwd_clusters()}")
        for shape, rising in shapes:
            fn_args = chip_smoke.k4_bwd_inputs(shape, dev, rising)
            for _ in range(3):
                attention.flash_attention_backward(*fn_args)
            torch.cuda.synchronize()
            buf = np.zeros(N_WORDS, np.uint64)
            if cdll.cvvae_k4_bwd_trace(ctypes.c_void_p(buf.ctypes.data)):
                print("trace_k4_bwd: the trace could not be read")
                return 1
            p = attention.backward_plan(*shape)
            n = min(p["grid"][0] * p["grid"][1], STAMP0 // 4)
            ctas = buf[:4 * n].reshape(n, 4).astype(np.int64)
            stamps = buf[STAMP0:].astype(np.int64)
            stamps = stamps[stamps > 0]
            split = (phases_ns(stamps) if len(stamps) > 2 * len(PHASES)
                     else {})
            print(f"[k4.bwd trace] {shape}: dkv {residency(ctas)}; "
                  f"ns a walk tile {split}", flush=True)
            del fn_args
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
