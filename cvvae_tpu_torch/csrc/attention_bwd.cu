// K4.bwd: the gradient of single-head flash attention (K4, attention.cu):
// dq, dk, dv of softmax(q·kᵀ·scale)·v from q, k, v, the forward's output o,
// its gradient do and each row's logsumexp lse (natural log of the scaled
// logits' exp-sum, which K4 writes when an input needs a gradient), on
// contiguous (B, S, D) bf16 tensors, D in {64, 128, 256, 512}.
//
// Replaces the backward of the stock Pallas TPU flash attention that
// cvvae_tpu/ops/attention.py:82 calls, its custom_vjp
// (jax/experimental/pallas/ops/tpu/flash_attention.py:204, defvjp :318):
// _flash_attention_bwd_dkv (:941, pallas_call :1121) and
// _flash_attention_bwd_dq (:1287, pallas_call :1456), with D = rowsum(do∘o)
// left to XLA (:273-275).  Bound: 10·B·S²·D FLOP (the logits, do·vᵀ, dv, dk
// and dq products; 0.027 ms at (5, 1024, 512) at 989 TFLOP/s bf16), well
// above the bytes (q, k, v, o, do in, dq, dk, dv out, 12.5 us there).
//
// Three launches: rowdot (D = rowsum(do∘o) in fp32, one warp a row, a
// fixed shuffle tree), dkv, then dq.  Unlike the reference, dq does not
// recompute P and dP: dkv leaves dSᵀ in bf16 in the caller's scratch
// (B x S' x S', S' = S rounded up to 64, zero where masked), and dq is the
// product dS·k over it, so 10·B·S²·D FLOP are executed, no atomics.
//
// dkv.  Head dim 512 shapes it.  wgmma takes 64 rows a warpgroup, and a
// 64-key tile's dk and dv at D = 512 are 2 x 64 x 512 fp32, 256 KB: an
// SM's whole register file.  So D is split over a thread-block cluster:
// each CTA owns a slice of kSliceCols head-dim columns (64 at D = 64), a
// cluster has D / slice CTAs (4 at D = 512, 2 at 256, 1 at 128 or 64), and
// each CTA loads by TMA only its slice of every operand (the forward's
// 64-column, 128-byte-swizzled boxes of a (B, S, D) tensor seen as
// (64, S, D/64, B); rows >= S read as zeros).  One cluster per 64-key tile
// of a batch row walks the 64-query tiles:
//   - each CTA forms its slice's partials Sᵀ = k·qᵀ and dPᵀ = v·doᵀ, two
//     64x64 SS wgmma products over the slice, one a warpgroup;
//   - the exchange (reduce-scatter): the fp32 partials go to the CTA's
//     exchange buffer; after a cluster barrier rank r reads rows
//     [64r/C, 64(r+1)/C) of every rank's partials through distributed
//     shared memory (every load issued before the first sum: one round
//     trip), sums them in rank order (so every CTA uses the same bits),
//     forms P = exp2(s·scale·log2e − lse·log2e) and dS = P∘(dP − D) in
//     fp32, rounds them to bf16, and stores them into every CTA's
//     128-byte-swizzled operand tiles (and its dSᵀ rows into the scratch;
//     16-byte stores after a transpose within each quad hit one bank group
//     four times, so a thread stores its 4-byte pairs).  kReduceScatter
//     false: every CTA reads all rows and stores only its own, an
//     all-gather;
//   - the update: warpgroup 0 adds Pᵀ·do into dv, 1 dSᵀ·q into dk, over
//     the slice (64 x 128 fp32, 64 registers a thread), SS wgmma with the
//     walk tile MN-major.
// The exchange buffers are doubled and the update runs a tile behind, so
// one cluster barrier a tile suffices: it publishes tile i's partials and
// tile i-1's P and dS; tile i-1's update and tile i+1's partials then run
// on the tensor cores while tile i is exchanged.  A walk tile is in use
// from its partials to its update two tiles later, so the ring holds
// kStages = 3 tiles, and tile i+2 is loaded as soon as tile i-1's update
// retires.  Thread 0 issues the TMA loads; the two warpgroups release a
// stage through an mbarrier.  Shared memory at D = 512: own tiles 32 KB +
// the walk ring 3 x 32 KB + the exchange 2 x 32 KB + bf16 P and dS 2 x 16
// KB = 224 KB, one CTA an SM.  What bounds it on the card: the exchange's
// latency, not the tensor cores (PERF.md §6).
//
// dq.  One CTA per 64-query tile and kDqCols head-dim columns (2 at
// D = 512) walks the key tiles: TMA brings dSᵀ's (64 keys x 64 queries)
// tile and k's columns into a kDqStages ring, and each warpgroup adds
// dS·k over half the columns (SS wgmma, dSᵀ read MN-major as A).
//
// Keys and queries >= S get P = 0 (the lse of a zero-filled query row is
// not -inf, so the mask is needed); rows >= S are not written.  dk and dq
// are multiplied by the scale once.  No atomics: each output element is
// summed by one thread in a fixed order, so two calls give the same bits.
#include "common.cuh"
#include "hopper.cuh"
#include <math.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;         // rows a tile (wgmma's M), keys or queries
constexpr int kSliceCols = 128;   // dkv: head-dim columns a CTA owns
constexpr int kStages = 3;        // dkv: walk tiles in flight
constexpr int kDqCols = 256;      // dq: head-dim columns a CTA owns
constexpr int kDqStages = 4;      // dq: key tiles in flight
constexpr int kThreads = 256;     // two warpgroups; thread 0 also loads
constexpr int kBox = 64;          // columns a TMA group: 128 swizzled bytes
// Rank r forms rows [64r/C, 64(r+1)/C) of P and dS for every CTA (false:
// each CTA forms all of them for itself, an all-gather; a variant of
// utils/kernel_variants.py --kernel K4.bwd, measured in PERF.md §6).
constexpr bool kReduceScatter = true;

// tile i+1's partials are issued before tile i-1's update retires, so
// three walk tiles are in use at once
static_assert(kStages >= 3, "the partials run a tile ahead of the update");

typedef __nv_bfloat16 bf16;

// dkv's shared memory (bytes from a 1024-aligned base).  An operand tile
// is the slice of 64 rows: (64 x 64)-column groups of 128-byte swizzled
// rows, group after group.
template <int SL>
struct Layout {
  static constexpr int tile_bytes = kTile * SL * 2;
  // the own tile's two operands: k, v
  static constexpr int own_off = 0;
  // the walk ring: two operands a stage, q and do
  __host__ __device__ static constexpr int stage_off(int st) {
    return (2 + 2 * st) * tile_bytes;
  }
  // two exchange buffers of fp32 partials of S and dP (xoff)
  static constexpr int xch_off = (2 + 2 * kStages) * tile_bytes;
  static constexpr int xch_bytes = 2 * kTile * kTile * 4;
  // two buffers of the bf16 operand tiles P, then dS, [key][query]
  static constexpr int pds_off = xch_off + 2 * xch_bytes;
  static constexpr int pds_bytes = 2 * kTile * kTile * 2;
  static constexpr int bytes = pds_off + 2 * pds_bytes + 1024;
};
static_assert(Layout<kSliceCols>::bytes <= 232448,
              "more shared memory than a block may have");

// dq's: a ring of (dSᵀ tile, k's 64 x CW columns) stages
template <int CW>
struct DqLayout {
  static constexpr int ds_bytes = kTile * kTile * 2;
  static constexpr int stage_bytes = ds_bytes + kTile * CW * 2;
  static constexpr int bytes = kDqStages * stage_bytes + 1024;
};
static_assert(DqLayout<kDqCols>::bytes <= 232448,
              "more shared memory than a block may have");

// byte offset of slice column c in a (64-row x slice) operand tile
__host__ __device__ constexpr int col_offset(int c) {
  return (c / kBox) * kTile * 128 + (c % kBox) * 2;
}

// the scratch: D (B x S fp32), then dSᵀ (B x S' x S' bf16) from this byte
__host__ __device__ constexpr int64_t ds_offset(int B, int S) {
  return ((int64_t)B * S * 4 + 1023) / 1024 * 1024;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one box of a (D, S, B) tensor seen as (64, S, D/64, B): 64 rows from
// ``row`` of the 64-column groups from ``group``, batch row ``batch``,
// group after group
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int group,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(group), "r"(batch)
      : "memory");
}

// one (64 queries x 64 keys) box of the scratch's dSᵀ, (S', S', B)
__device__ __forceinline__ void tma_load_ds(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int query, int key,
                                            int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(query),
      "r"(key), "r"(batch)
      : "memory");
}

// the same shared address in block ``cta`` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(cta));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// order generic-proxy accesses of this CTA's shared memory before wgmma's
// (async-proxy) reads of it: after a thread's stores, and after the
// cluster barrier that made other CTAs' stores visible.  (The form without
// a state space also orders global memory, and costs time: a variant of
// utils/kernel_variants.py.)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving accesses of wgmma's registers across its
// issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64x64] (+)= A[64x16] B[16x64], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x32] (+)= A[64x16] B[16x32] from shared memory, B MN-major,
// A K-major (TA 0) or MN-major (TA 1)
template <int TA>
__device__ __forceinline__ void wgmma_ss_n32_t(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// D[64x64] (+)= A[64x16] B[16x64] from shared memory, B MN-major,
// A K-major (TA 0) or MN-major (TA 1)
template <int TA>
__device__ __forceinline__ void wgmma_ss_n64_t(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// D[64x128] (+)= A[64x16] B[16x128] from shared memory, B MN-major,
// A K-major (TA 0) or MN-major (TA 1)
template <int TA>
__device__ __forceinline__ void wgmma_ss_n128_t(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}


template <int N, int TA>
__device__ __forceinline__ void wgmma_update(float (&d)[N / 2], uint64_t da,
                                             uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32_t<TA>(d, da, db, 1);
  if constexpr (N == 64) wgmma_ss_n64_t<TA>(d, da, db, 1);
  if constexpr (N == 128) wgmma_ss_n128_t<TA>(d, da, db, 1);
}

// part[64 x 64] = A·Bᵀ over the slice: A (own rows) and B (walk rows) are
// operand tiles at shared addresses a and b, both K-major (a descriptor's
// address field is the byte address / 16, so a column step is a constant
// added to it)
template <int SL>
__device__ __forceinline__ void issue_partial(float (&part)[32], uint32_t a,
                                              uint32_t b) {
  uint64_t da = sw128_desc(a, 16, 1024), db = sw128_desc(b, 16, 1024);
  // opaque to the compiler, which otherwise holds every step's descriptor
  // in registers
  asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
  for (int kk = 0; kk < SL / 16; ++kk)
    wgmma_ss_n64(part, da + (col_offset(16 * kk) >> 4),
                 db + (col_offset(16 * kk) >> 4), kk > 0);
}

// acc[64 x N] += A·B over 64 rows: A a bf16 64x64 tile at a, K-major
// (TA 0: P or dS [key][query]) or MN-major (TA 1: dSᵀ read as dS), B an
// operand tile from column n0 (at b), MN-major
template <int N, int TA>
__device__ __forceinline__ void issue_update(float (&acc)[N / 2], uint32_t a,
                                             uint32_t b) {
  uint64_t da = TA ? sw128_desc(a, kTile * 128, 1024) : sw128_desc(a, 16, 1024);
  uint64_t db = sw128_desc(b, kTile * 128, 1024);
  asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_update<N, TA>(acc, da + ((TA ? 16 * 128 * kk : 32 * kk) >> 4),
                        db + ((16 * 128 * kk) >> 4));
}

// One of the float4s of the exchange a thread forms: the accumulator
// registers 4i..4i+3 of lane ``lane`` of warp ``w`` of a warpgroup, i.e.
// rows 16w + lane/4 (+ 8) and columns 8i + 2(lane%4) (+ 1) of the tile.
// Item u of thread t is the (u·256 + t)-th of the W warps' float4s from
// warp ``first``.
struct Item {
  int w, i, lane;
};
template <int W>
__device__ __forceinline__ Item item(int u, int t, int first) {
  const int l = u * kThreads + t;
  return {first + (l / 32) % W, l / (32 * W), l % 32};
}

template <int C>
struct Exchange {
  // accumulator warps whose rows this CTA forms, and their float4s a thread
  static constexpr int W = kReduceScatter ? 4 / C : 4;
};

// byte offset in an exchange buffer of the float4 of partial ``tensor``
// (0: S, 1: dP) that lane ``lane`` of warp w holds in registers 4j..4j+3
__device__ constexpr int xoff(int tensor, int w, int j, int lane) {
  return (((tensor * 4 + w) * 8 + j) * 32 + lane) * 16;
}

// the logsumexp (log2 units) and D of the queries of this thread's
// exchange items in the query tile from w0
template <int C>
__device__ __forceinline__ void item_rows(float (&lse2)[Exchange<C>::W][2],
                                          float (&dv)[Exchange<C>::W][2],
                                          const float* lse, const float* dvec,
                                          int w0, int S, int first) {
  constexpr int W = Exchange<C>::W;
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const Item it = item<W>(u, threadIdx.x, first);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int query = w0 + 8 * it.i + 2 * (it.lane % 4) + h;
      const bool ok = query < S;
      lse2[u][h] = ok ? __ldg(lse + query) * kLog2e : 0.f;
      dv[u][h] = ok ? __ldg(dvec + query) : 0.f;
    }
  }
}

// Every rank's partials of this CTA's items from ``xch``: all the loads
// issued at once (one round trip, waited for where the values are first
// used)
template <int C>
struct Partials {
  float4 s[Exchange<C>::W][C], dp[Exchange<C>::W][C];
};
template <int C>
__device__ __forceinline__ void load_partials(Partials<C>& x, uint32_t xch,
                                              int first) {
  constexpr int W = Exchange<C>::W;
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const Item it = item<W>(u, threadIdx.x, first);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const uint32_t at = xch + xoff(0, it.w, it.i, it.lane);
      x.s[u][q] = ld_cluster(cluster_addr(at, q));
      x.dp[u][q] = ld_cluster(cluster_addr(at + xoff(1, 0, 0, 0), q));
    }
  }
}

// This CTA's share of one tile's exchange, in registers: for each item,
// the bf16 pairs of P and of dS in rows r and r + 8
template <int C>
struct Formed {
  uint32_t p[Exchange<C>::W][2], ds[Exchange<C>::W][2];
};

// The loaded partials summed in rank order; P = exp2(s·scale·log2e −
// lse·log2e), 0 for a key or query >= S, and dS = P∘(dP − D) in fp32,
// rounded to bf16.
template <int C>
__device__ __forceinline__ void form(Formed<C>& f, const Partials<C>& x,
                                     const float (&lse2)[Exchange<C>::W][2],
                                     const float (&dv)[Exchange<C>::W][2],
                                     int r0, int w0, int S, float scale_log2,
                                     int first) {
  constexpr int W = Exchange<C>::W;
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const Item it = item<W>(u, threadIdx.x, first);
    const float4 s0 = x.s[u][0], d0 = x.dp[u][0];
    float sv[4] = {s0.x, s0.y, s0.z, s0.w};
    float dpv[4] = {d0.x, d0.y, d0.z, d0.w};
#pragma unroll
    for (int q = 1; q < C; ++q) {
      sv[0] += x.s[u][q].x; sv[1] += x.s[u][q].y;
      sv[2] += x.s[u][q].z; sv[3] += x.s[u][q].w;
      dpv[0] += x.dp[u][q].x; dpv[1] += x.dp[u][q].y;
      dpv[2] += x.dp[u][q].z; dpv[3] += x.dp[u][q].w;
    }
    const int row = 16 * it.w + it.lane / 4, col = 8 * it.i + 2 * (it.lane % 4);
    float pv[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e >> 1), c = col + (e & 1);
      const bool ok = r0 + r < S && w0 + c < S;
      pv[e] = ok ? exp2f(sv[e] * scale_log2 - lse2[u][e & 1]) : 0.f;
      ds[e] = pv[e] * (dpv[e] - dv[u][e & 1]);
    }
    f.p[u][0] = pack_bf16(pv[0], pv[1]);
    f.p[u][1] = pack_bf16(pv[2], pv[3]);
    f.ds[u][0] = pack_bf16(ds[0], ds[1]);
    f.ds[u][1] = pack_bf16(ds[2], ds[3]);
  }
}

// The formed pairs into the ``pds`` tiles of every CTA of the cluster
// (all-gather: of this one) at their byte offset in the 128-byte-swizzled
// operand tiles (16-byte chunk k of row r at k ^ (r % 8); rows r and r + 8
// share the pattern, and a warp's 32 pairs fall on 32 banks), and dS into
// the scratch's dSᵀ (all-gather: by rank 0), whose row r0 of this batch
// row starts at element ``ds_row``, rows S' = ``sp`` long.
template <int C>
__device__ __forceinline__ void scatter(const Formed<C>& f, uint32_t pds,
                                        bf16* ds_t, int64_t ds_row, int sp,
                                        int w0, int rank, int first) {
  constexpr int W = Exchange<C>::W;
  constexpr int kOp = kTile * kTile * 2;  // one bf16 operand tile, bytes
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const Item it = item<W>(u, threadIdx.x, first);
    const int row = 16 * it.w + it.lane / 4, col = 8 * it.i + 2 * (it.lane % 4);
#pragma unroll
    for (int q = 0; q < (kReduceScatter ? C : 1); ++q) {
      const uint32_t cta = kReduceScatter ? q : rank;
      const uint32_t at =
          pds + row * 128 + ((it.i ^ (row & 7)) << 4) + 4 * (it.lane % 4);
      st_cluster(cluster_addr(at, cta), f.p[u][0]);
      st_cluster(cluster_addr(at + 8 * 128, cta), f.p[u][1]);
      st_cluster(cluster_addr(at + kOp, cta), f.ds[u][0]);
      st_cluster(cluster_addr(at + kOp + 8 * 128, cta), f.ds[u][1]);
    }
    if (kReduceScatter || rank == 0) {
      bf16* d = ds_t + ds_row + (int64_t)row * sp + w0 + col;
      *reinterpret_cast<uint32_t*>(d) = f.ds[u][0];
      *reinterpret_cast<uint32_t*>(d + 8 * sp) = f.ds[u][1];
    }
  }
}

// dk and dv of one 64-key tile (cluster x / C) of batch row y over slice
// ``rank`` of the head dim, and the tile's rows of dSᵀ into the scratch
template <int SL, int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(kThreads, 1)
    flash_bwd_dkv(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ dvec, bf16* __restrict__ ds_t,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                  float scale, float scale_log2) {
  using L = Layout<SL>;
  constexpr int D = SL * C;
  constexpr int W = Exchange<C>::W;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_own, full[kStages], empty[kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const int rank = (int)cluster_rank();
  const int r0 = (blockIdx.x / C) * kTile, b = blockIdx.y;
  const int group = rank * SL / kBox;
  const int n_tiles = (S + kTile - 1) / kTile, sp = n_tiles * kTile;
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int first = kReduceScatter ? rank * W : 0;
  const float* lse_b = lse + (int64_t)b * S;
  const float* dvec_b = dvec + (int64_t)b * S;
  const int64_t ds_row = ((int64_t)b * sp + r0) * sp;

  if (threadIdx.x == 0) {
    mbar_init(&bar_own, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the barriers exist, and every CTA of the cluster runs, before any load
  // or access of another CTA's shared memory
  cluster_sync();
  // walk tile j into stage j % kStages (thread 0)
  auto load_walk = [&](int j) {
    const int st = j % kStages;
    mbar_expect_tx(&full[st], 2 * L::tile_bytes);
    tma_load(base + L::stage_off(st), &map_q, &full[st], j * kTile, group, b);
    tma_load(base + L::stage_off(st) + L::tile_bytes, &map_do, &full[st],
             j * kTile, group, b);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    prefetch_map(&map_q);
    prefetch_map(&map_do);
    mbar_expect_tx(&bar_own, 2 * L::tile_bytes);
    tma_load(base + L::own_off, &map_k, &bar_own, r0, group, b);
    tma_load(base + L::own_off + L::tile_bytes, &map_v, &bar_own, r0, group,
             b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_walk(j);
  }
  __syncwarp();

  float acc[SL / 2];
#pragma unroll
  for (int i = 0; i < SL / 2; ++i) acc[i] = 0.f;
  float part[32], lse2[W][2], dvq[W][2];
  Partials<C> x;
  Formed<C> f;
  // warpgroup wg forms the partial of own operand wg (k, v) against walk
  // operand wg (q, do)
  const uint32_t own = base + L::own_off + wg * L::tile_bytes;
  auto xch = [&](int i) { return base + L::xch_off + (i & 1) * L::xch_bytes; };
  auto pds = [&](int i) { return base + L::pds_off + (i & 1) * L::pds_bytes; };
  // tile i's partials, issued
  auto partials = [&](int i) {
    const int st = i % kStages;
#pragma unroll
    for (int e = 0; e < 32; ++e) part[e] = 0.f;
    mbar_wait(&full[st], (i / kStages) & 1);
    fence_regs(part);
    wgmma_fence();
    issue_partial<SL>(part, own, base + L::stage_off(st) + wg * L::tile_bytes);
    wgmma_commit();
  };
  // tile i's partials, retired, into exchange buffer i % 2; the statistics
  // of its exchange requested
  auto publish = [&](int i) {
    fence_regs(part);
    unsigned char* x = smem + L::xch_off + (i & 1) * L::xch_bytes;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(x + xoff(wg, t128 / 32, j, t128 % 32)) =
          make_float4(part[4 * j], part[4 * j + 1], part[4 * j + 2],
                      part[4 * j + 3]);
    item_rows<C>(lse2, dvq, lse_b, dvec_b, i * kTile, S, first);
  };
  // tile i's exchange: every rank's partials loaded, P and dS formed
  auto exchange = [&](int i) {
    load_partials<C>(x, xch(i), first);
    form<C>(f, x, lse2, dvq, r0, i * kTile, S, scale_log2, first);
  };
  auto store = [&](int i) {
    scatter<C>(f, pds(i), ds_t, ds_row, sp, i * kTile, rank, first);
    fence_async();
  };
  // tile i's update, issued, once its P and dS are in: warpgroup 0 Pᵀ·do
  // into dv, 1 dSᵀ·q into dk
  auto update = [&](int i) {
    const uint32_t walk = base + L::stage_off(i % kStages);
    fence_async();
    fence_regs(acc);
    wgmma_fence();
    issue_update<SL, 0>(acc, pds(i) + wg * (L::pds_bytes / 2),
                        walk + (1 - wg) * L::tile_bytes);
    wgmma_commit();
  };
  // tile i's update retired: its walk stage takes tile i + kStages
  auto release = [&](int i) {
    fence_regs(acc);
    const int st = i % kStages;
    if (t128 == 0) mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && i + kStages < n_tiles) {
      mbar_wait(&empty[st], (i / kStages) & 1);
      load_walk(i + kStages);
    }
    __syncwarp();
  };

  // Each cluster barrier publishes tile i's partials and tile i-1's P and
  // dS.  Then tile i-1's update and tile i+1's partials run on the tensor
  // cores while tile i is exchanged.  (Each wgmma's issue and wait lie in
  // one straight run of code: ptxas serialises wgmma where a path could
  // skip the wait.)
  mbar_wait(&bar_own, 0);
  partials(0);
  wgmma_wait<0>();
  publish(0);
  if (n_tiles == 1) {
    cluster_sync();
    exchange(0);
    store(0);
    cluster_sync();
    update(0);
    wgmma_wait<0>();
    fence_regs(acc);
  } else {
    cluster_sync();
    partials(1);
    exchange(0);
    store(0);
    wgmma_wait<0>();
    publish(1);
    for (int i = 1; i + 1 < n_tiles; ++i) {
      cluster_sync();
      update(i - 1);
      partials(i + 1);
      exchange(i);
      wgmma_wait<1>();  // tile i-1's update
      release(i - 1);
      store(i);
      wgmma_wait<0>();
      publish(i + 1);
    }
    cluster_sync();
    update(n_tiles - 2);
    exchange(n_tiles - 1);
    store(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    cluster_sync();
    update(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
  }
  // no CTA touches another's shared memory after the last barrier

  // keys < S; warpgroup 0 holds dv, 1 dk (times the scale)
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  bf16* out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= S) continue;
    bf16* p = out + ((int64_t)b * S + row) * D + rank * SL + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < SL / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// dq of one 64-query tile (block x / (D / CW)) over CW head-dim columns
// (part x % (D / CW)) of batch row y: dS·k over the key tiles from the
// scratch's dSᵀ, warpgroup w on columns [w·CW/2, (w+1)·CW/2)
template <int CW>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap map_ds,
                 const __grid_constant__ CUtensorMap map_k,
                 bf16* __restrict__ dq, int S, int D, float scale) {
  using L = DqLayout<CW>;
  constexpr int NW = CW / 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kDqStages], empty[kDqStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const int parts = D / CW, part = blockIdx.x % parts;
  const int q0 = (blockIdx.x / parts) * kTile, b = blockIdx.y;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // key tile j into stage j % kDqStages (thread 0)
  auto load = [&](int j) {
    const int st = j % kDqStages;
    const uint32_t at = base + st * L::stage_bytes;
    mbar_expect_tx(&full[st], L::stage_bytes);
    tma_load_ds(at, &map_ds, &full[st], q0, j * kTile, b);
    tma_load(at + L::ds_bytes, &map_k, &full[st], j * kTile, part * CW / kBox,
             b);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&map_ds);
    prefetch_map(&map_k);
    for (int j = 0; j < kDqStages && j < n_tiles; ++j) load(j);
  }
  __syncwarp();
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  // one product in flight while the next is issued; a stage is released
  // once its product has retired
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kDqStages;
    const uint32_t at = base + st * L::stage_bytes;
    mbar_wait(&full[st], (j / kDqStages) & 1);
    wgmma_fence();
    issue_update<NW, 1>(acc, at, at + L::ds_bytes + col_offset(wg * NW));
    wgmma_commit();
    wgmma_wait<1>();
    if (j > 0) {
      const int pst = (j - 1) % kDqStages;
      if (t128 == 0) mbar_arrive(&empty[pst]);
      if (threadIdx.x == 0 && j - 1 + kDqStages < n_tiles) {
        mbar_wait(&empty[pst], ((j - 1) / kDqStages) & 1);
        load(j - 1 + kDqStages);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = t128 / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= S) continue;
    bf16* p = dq + ((int64_t)b * S + row) * D + part * CW + wg * NW +
              2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// D = rowsum(do∘o) in fp32: one warp a row, each lane two columns at a
// time, then a fixed shuffle tree
__global__ void __launch_bounds__(kThreads)
    rowdot(const bf16* __restrict__ a, const bf16* __restrict__ b,
           float* __restrict__ out, int64_t rows, int D) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* pa = a + row * D;
  const bf16* pb = b + row * D;
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(pa + c));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(pb + c));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[row] = acc;
}

// a (B, S, D) bf16 tensor seen as (64, S, D/64, B), innermost first, read
// in boxes of (64, kTile, groups, 1): one load brings ``groups`` 64-column
// groups of kTile rows, each swizzled in 128-byte rows, group after group;
// rows past S read as zeros
bool make_map(CUtensorMap* map, const void* base, int B, int S, int D,
              int groups) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kBox, (cuuint64_t)S,
                              (cuuint64_t)D / kBox, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)kBox * 2,
                                 (cuuint64_t)S * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, (cuuint32_t)kTile,
                             (cuuint32_t)groups, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the scratch's dSᵀ, (S' queries, S' keys, B) innermost first, in
// (64, 64, 1) boxes swizzled in 128-byte rows
bool make_ds_map(CUtensorMap* map, const void* base, int B, int sp) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)sp, (cuuint64_t)sp, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)sp * 2,
                                 (cuuint64_t)sp * sp * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kTile, (cuuint32_t)kTile, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dkv with SL head-dim columns a CTA, C CTAs a cluster (D = SL·C), dq
// with CW columns a CTA
template <int SL, int C, int CW>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, void* scratch, bf16* dq,
           bf16* dk, bf16* dv, int B, int S, float scale, cudaStream_t s) {
  using L = Layout<SL>;
  using LQ = DqLayout<CW>;
  constexpr int D = SL * C;
  const int n_tiles = (S + kTile - 1) / kTile, sp = n_tiles * kTile;
  float* dvec = static_cast<float*>(scratch);
  bf16* ds_t = reinterpret_cast<bf16*>(static_cast<char*>(scratch) +
                                       ds_offset(B, S));
  CUtensorMap mq, mk, mv, mdo, mds, mkq;
  if (!make_map(&mq, q, B, S, D, SL / kBox) ||
      !make_map(&mk, k, B, S, D, SL / kBox) ||
      !make_map(&mv, v, B, S, D, SL / kBox) ||
      !make_map(&mdo, dout, B, S, D, SL / kBox) ||
      !make_map(&mkq, k, B, S, D, CW / kBox) ||
      !make_ds_map(&mds, ds_t, B, sp))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv<SL, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq<CW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LQ::bytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)B * S;
  constexpr int warps = kThreads / 32;
  rowdot<<<(unsigned)((rows + warps - 1) / warps), kThreads, 0, s>>>(
      dout, o, dvec, rows, D);
  flash_bwd_dkv<SL, C><<<dim3(C * n_tiles, B), kThreads, L::bytes, s>>>(
      mk, mv, mq, mdo, lse, dvec, ds_t, dk, dv, S, scale, scale * kLog2e);
  flash_bwd_dq<CW><<<dim3(D / CW * n_tiles, B), kThreads, LQ::bytes, s>>>(
      mds, mkq, dq, S, D, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_width(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                 const bf16* dout, const float* lse, void* scratch, bf16* dq,
                 bf16* dk, bf16* dv, int B, int S, float scale,
                 cudaStream_t s) {
  constexpr int SL = D < kSliceCols ? D : kSliceCols;
  constexpr int CW = D < kDqCols ? D : kDqCols;
  return launch<SL, D / SL, CW>(q, k, v, o, dout, lse, scratch, dq, dk, dv,
                                B, S, scale, s);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, S, D) contiguous, 16-byte aligned, bf16;
// lse: (B, S) fp32, K4's logsumexp; scratch: 1024-byte aligned, D's
// B x S fp32, then from byte ceil(4·B·S / 1024)·1024 dSᵀ's B x S' x S'
// bf16, S' = S rounded up to a multiple of 64.
CVVAE_EXPORT int cvvae_flash_attention_bwd(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const void* lse,
                                           void* scratch, void* dq, void* dk,
                                           void* dv, int B, int S, int D,
                                           float scale, int dtype, int device,
                                           void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || dtype != CVVAE_BF16)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
#define CVVAE_K4_BWD(W)                                                      \
  case W:                                                                    \
    return launch_width<W>((const bf16*)q, (const bf16*)k, (const bf16*)v,  \
                           (const bf16*)o, (const bf16*)dout,               \
                           (const float*)lse, scratch, (bf16*)dq,           \
                           (bf16*)dk, (bf16*)dv, B, S, scale, s);
  switch (D) {
    CVVAE_K4_BWD(64)
    CVVAE_K4_BWD(128)
    CVVAE_K4_BWD(256)
    CVVAE_K4_BWD(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CVVAE_K4_BWD
}
