// K4: single-head flash attention forward, softmax(q·kᵀ·scale)·v, on
// contiguous (B, S, D) tensors, D in {64, 128, 256, 512}.
//
// Replaces cvvae_tpu/ops/attention.py:60 _flash_attention (the stock
// Pallas TPU flash attention), which pads S to a multiple of 512 behind
// segment ids; here the ragged tail is masked in the kernel instead.
//
// A block walks every key/value tile of its query tile with an online
// softmax: a running row max and row sum in fp32, the output rescaled per
// tile and normalised once at the end, so the (S, S) logits never reach
// device memory.  Bound: 4·B·S²·D FLOP (2.12 TFLOP at (5, 14400, 512),
// 2.15 ms at the card's 989 TFLOP/s bf16); q, k, v and out are 0.3 GB.
//
// bf16 (the serving path): Hopper's wgmma, TMA and clusters, one block of
// two warpgroups (256 threads) per 64-row query tile, one block an SM.
//   - Head dim 512 shapes the split: the 64x512 fp32 output is 128 KB,
//     more than one warpgroup's registers, so each warpgroup owns half of
//     D (64x256, 128 floats a thread).  Each computes its half of the
//     logits, Q[:, half]·K[:, half]ᵀ, with wgmma m64n32k16, Q's fragments
//     read once from shared memory into registers (64 a thread) so that
//     the products read only K there; the halves are summed through
//     shared memory (the same sum, bit for bit, in both), so no product
//     is computed twice, and both run the same online softmax.
//   - No producer warp: a third warpgroup would cap every thread at 168
//     registers (65536 / 384), and ptxas then spills the output and
//     serialises every wgmma (setmaxnreg did not lift the cap).  Thread 0
//     issues the TMA loads of K and thread 128 those of V, each into a
//     two-stage ring of its own, on a fixed schedule while both products
//     run (mbarriers: full per stage, counting TMA bytes; empty per
//     stage, counting the consumer warps of the cluster).
//   - Every block reads all of K and V, 64 KB a 32-key tile for 4.2
//     MFLOP: at the tensor cores' rate some 15 TB/s of L2 reads over the
//     card.  Blocks of neighbouring query tiles pair up in a cluster;
//     each loads half of each tile's 64-column groups in one 4-D TMA box
//     and multicasts it to both, so L2 sends each tile once a pair.
//   - As in FlashAttention-3, tile kt+1's logits run on the tensor cores
//     while the output is rescaled, then tile kt's P·V while tile kt+1's
//     logits are summed and turned into probabilities.  A row's running
//     max is raised only when a tile exceeds it by 2^8, so the output's
//     rescale is skipped on most tiles.
//   - P stays in registers: the logits' accumulator layout is the A
//     fragment layout of P·V, rounded to bf16 unnormalised, and P·V is
//     wgmma m64nDHk16 with A in registers and V (MN-major) in shared.
//   - TMA zero-fills rows >= S of the (D, S, B) tensor; keys >= S get
//     logit -inf; query rows >= S are computed on zeros and not stored.
//   Shared memory at D = 512: Q 64 KB + K 2 x 32 KB + V 2 x 32 KB + the
//   logit exchange 32 KB (two tiles in flight) = 224 KB.
//   - For a gradient (K4.bwd, attention_bwd.cu) each valid row's
//     logsumexp of its scaled logits is written too, natural log, fp32:
//     (m + log2 l) ln 2 with m the running max that l was summed against
//     (not the row's true max, which the lazy raise may leave up to 2^8
//     above m).  The serving launch passes no buffer and writes nothing.
// bf16 only, as the reference's flash is: fp32 attention takes the
// exact path (cvvae_tpu_torch/ops/attention.py).
#include "common.cuh"
#include "hopper.cuh"
#include <math.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------ bf16: wgmma and TMA --

namespace wg {

constexpr int kBM = 64;             // query rows a block
constexpr int kBK = 32;             // keys a tile
constexpr int kStages = 2;          // K and V rings
// two warpgroups; thread 0 also issues the loads.  (A producer warpgroup
// of its own would cap every thread at 168 registers, 65536 / 384: ptxas
// then spills the 64x256 output and serialises every wgmma.)
constexpr int kThreads = 256;
constexpr int kBox = 64;            // columns a group: 128 swizzled bytes
// blocks of neighbouring query tiles that share each K/V tile: each loads
// 1/kCluster of its 64-column groups and multicasts them to all, so L2
// sends each tile once a cluster
constexpr int kCluster = 2;
// a row's running max is raised only when a tile exceeds it by more than
// this (log2 units), so the unnormalised probabilities stay below 2^8 and
// the output's rescale is skipped on most tiles
constexpr float kSlack = 8.f;

// Shared memory (bytes from a 1024-aligned base; every operand tile is
// made of (rows x 64) groups of 128-byte swizzled rows, group after
// group).
template <int D>
struct Layout {
  static constexpr int DH = D / 2;  // head-dim columns a consumer owns
  // 64-column groups of a K or V tile each block of a cluster loads
  static constexpr int groups = D / kBox / kCluster > 0 ? D / kBox / kCluster
                                                         : 1;
  static constexpr int q_bytes = kBM * D * 2;
  static constexpr int kv_bytes = kBK * D * 2;  // one K or V tile
  __host__ __device__ static constexpr int k_off(int st) {
    return q_bytes + st * kv_bytes;
  }
  __host__ __device__ static constexpr int v_off(int st) {
    return q_bytes + (kStages + st) * kv_bytes;
  }
  // logit halves: [tile parity][warpgroup][64 x kBK] fp32
  static constexpr int x_off = q_bytes + 2 * kStages * kv_bytes;
  static constexpr int bytes = x_off + 4 * kBM * kBK * 4 + 1024;
};

// one box of a (D, S, B) tensor seen as (64, S, D/64, B) (make_map): rows
// [row, row + box rows) of 64-column groups [group, group + box groups)
// of batch row ``batch``, group after group
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

// the same box into the same offset of every block in ``mask``, each
// block's barrier at ``bar``'s offset counting its bytes
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int row,
                                                   int group, int batch,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(group), "r"(batch), "h"(mask)
      : "memory");
}

// keep the compiler from moving accesses of wgmma's registers across
// its issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[2][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

// D[64x32] (+)= A[64x16] B[16x32], A in registers, B K-major in shared
__device__ __forceinline__ void wgmma_rs_n32_kmajor(float (&d)[16],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64x32] += A[64x16] B[16x32], A in registers, B MN-major in shared
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64x64] += A[64x16] B[16x64], A in registers, B MN-major in shared
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64x128] += A[64x16] B[16x128], A in registers, B MN-major in shared
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64x256] += A[64x16] B[16x256], A in registers, B MN-major in shared
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (DH == 32) wgmma_rs_n32(d, a, desc_b);
  if constexpr (DH == 64) wgmma_rs_n64(d, a, desc_b);
  if constexpr (DH == 128) wgmma_rs_n128(d, a, desc_b);
  if constexpr (DH == 256) wgmma_rs_n256(d, a, desc_b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of head-dim column c in a (rows x D) tile of 64-column boxes
__host__ __device__ constexpr int col_offset(int c, int rows) {
  return (c / kBox) * rows * 128 + (c % kBox) * 2;
}

// this thread's A fragments of Q[:, half] (warpgroup wg's head-dim
// columns), read once from the swizzled Q tile: k16 step kk holds rows g
// and g + 8 of the warp's 16, columns 16kk + 2*t4 (+1) and + 8
template <int DH>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DH / 16][4],
                                       const unsigned char* tile, int wg,
                                       int warp, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * warp + g + 8 * (i & 1);
      const int col = wg * DH + 16 * kk + 8 * (i >> 1) + 2 * t4;
      const int byte = (col % kBox) * 2;  // in the row's 128 bytes
      // 128-byte swizzle: 16-byte chunk c of row r sits at c ^ (r % 8)
      const int off = (col / kBox) * kBM * 128 + row * 128 +
                      ((((byte >> 4) ^ (row & 7))) << 4) + (byte & 15);
      qa[kk][i] = *reinterpret_cast<const uint32_t*>(tile + off);
    }
}

// Q[:, half] K[:, half]^T into s: DH/16 wgmma m64n32k16, Q in registers
// and K K-major in shared memory; dk describes the half's first column
// (a descriptor's address field is the byte address / 16, so a column
// step is a constant added to it)
template <int DH>
__device__ __forceinline__ void issue_logits(float (&s)[16],
                                             const uint32_t (&qa)[DH / 16][4],
                                             uint64_t dk) {
  // opaque to the compiler, which otherwise holds every step's
  // descriptor in registers across the loop
  asm volatile("" : "+l"(dk));
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_rs_n32_kmajor(s, qa[kk], dk + (col_offset(kk * 16, kBK) >> 4),
                        kk > 0);
}

// O[:, half] += P V[:, half]: P in registers, V MN-major in shared memory;
// dv describes the half's first column
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&pa)[2][4],
                                         uint64_t dv) {
  asm volatile("" : "+l"(dv));
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_pv<DH>(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
}

// one arrival of this warp on ``bar`` in every block of the cluster: the
// stage it guards is free once every block's consumers are done with it
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if (lane == 0)
    for (uint32_t r = 0; r < kCluster; ++r) mbar_arrive_cluster(bar, r);
}

// sum the two warpgroups' halves of the logits through shared memory:
// both hold the same (row, key) elements in the same registers, and both
// add in the same order, so both get the same bits
__device__ __forceinline__ void sum_halves(float (&s)[16], float* xch,
                                           int kt, int wg, int t128) {
  float4* mine =
      reinterpret_cast<float4*>(xch + ((kt & 1) * 2 + wg) * (kBM * kBK));
  const float4* theirs = reinterpret_cast<const float4*>(
      xch + ((kt & 1) * 2 + (1 - wg)) * (kBM * kBK));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    mine[i * 128 + t128] =
        make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = theirs[i * 128 + t128];
    s[4 * i] = v.x + s[4 * i];
    s[4 * i + 1] = v.y + s[4 * i + 1];
    s[4 * i + 2] = v.z + s[4 * i + 2];
    s[4 * i + 3] = v.w + s[4 * i + 3];
  }
}

// Online softmax of one tile in log2 units.  s[4j + e] is (row g + 8*(e/2),
// key k0 + 8j + 2*t4 + e%2) of this thread's warp; m holds the rows'
// running max, l this thread's share of their running sums (its keys).
// Leaves P = exp2(s - m), unnormalised, in s, and each row's rescale
// factor of the output so far in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[16], int k0, int S,
                                             float scale_log2, int t4,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  const bool tail = k0 + kBK > S;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * j + e] * scale_log2;
      if (tail && k0 + 8 * j + 2 * t4 + (e & 1) >= S) v = -INFINITY;
      s[4 * j + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = 1.f;
    if (mx[h] > m[h] + kSlack) {  // the first tile always: m is -inf
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

// P in bf16 as the A fragments of P V's two k16 steps
__device__ __forceinline__ void to_fragments(const float (&s)[16],
                                             uint32_t (&pa)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// The TMA loads of K (issued by thread 0) or of V (thread 128), each
// into a two-stage ring of its own.  Tile j goes into stage j % 2 once
// every consumer warp of the cluster has released tile j - 2 there; each
// block loads its share of the 64-column groups and multicasts them to
// every block of the cluster.  The kernel issues each tile on a fixed
// schedule, where the stage's releases are done or nearly so, and never
// polls: every probe of a barrier stalls the issuing warp, and with it
// its warpgroup's next wgmma.
template <int D>
struct Loader {
  using L = Layout<D>;
  const CUtensorMap* map;
  uint64_t* full;   // [kStages]
  uint64_t* empty;  // [kStages]
  uint32_t ring;    // shared address of stage 0
  int b, rank, n_tiles;

  __device__ void issue(int j) const {
    if (j >= n_tiles) return;
    const int st = j % kStages, use = j / kStages;
    if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
    mbar_expect_tx(&full[st], L::kv_bytes);
    const int group = rank * L::groups;
    if (group < D / kBox)
      tma_load_multicast(ring + st * L::kv_bytes + group * kBK * 128, map,
                         &full[st], j * kBK, group, b, (1u << kCluster) - 1);
  }
  // the other blocks' consumers arrive on this block's barriers: wait for
  // each stage's last release before the block may exit
  __device__ void drain() const {
    for (int st = 0; st < kStages; ++st) {
      const int uses = (n_tiles - st + kStages - 1) / kStages;
      if (uses > 0) mbar_wait(&empty[st], (uses - 1) & 1);
    }
  }
};

template <int D>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
        flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int S, float scale_log2) {
  using L = Layout<D>;
  constexpr int DH = L::DH;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full_k[kStages], full_v[kStages],
      empty_k[kStages], empty_v[kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const int q0 = blockIdx.x * kBM, b = blockIdx.y;
  const int n_tiles = (S + kBK - 1) / kBK;
  const bool loads_k = threadIdx.x == 0, loads_v = threadIdx.x == 128;

  if (loads_k) {
    mbar_init(&bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_k[st], kCluster * kThreads / 32);
      mbar_init(&empty_v[st], kCluster * kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers exist before any block loads or arrives there
  cluster_sync();

  const Loader<D> ld{loads_v ? &map_v : &map_k,
                     loads_v ? full_v : full_k,
                     loads_v ? empty_v : empty_k,
                     base + (loads_v ? L::v_off(0) : L::k_off(0)),
                     b,
                     (int)cluster_rank(),
                     n_tiles};
  if (loads_k) {
    // a query tile past S (a cluster's spare) reads rows from 0; none of
    // its rows is stored
    prefetch_map(&map_q);
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    mbar_expect_tx(&bar_q, L::q_bytes);
    tma_load(base, &map_q, &bar_q, q0 < S ? q0 : 0, 0, b);
  }
  if (loads_k || loads_v) {  // both stages are free
    ld.issue(0);
    ld.issue(1);
  }

  // warpgroup wg owns head-dim columns [wg*DH, wg*DH+DH)
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float* xch = reinterpret_cast<float*>(smem + L::x_off);
  // descriptors of this warpgroup's first column of K and V in stage 0
  // (stage 1 is kv_bytes further)
  const uint64_t dk =
      sw128_desc(base + L::k_off(0) + col_offset(wg * DH, kBK), 16, 1024);
  const uint64_t dv = sw128_desc(
      base + L::v_off(0) + col_offset(wg * DH, kBK), kBK * 128, 1024);
  constexpr uint64_t kStage = L::kv_bytes >> 4;
  // this thread's rows of the tile: 16*warp + g and 16*warp + g + 8
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[2][4];
  uint32_t qa[DH / 16][4];
  mbar_wait(&bar_q, 0);
  load_q<DH>(qa, smem, wg, warp, lane);
  {  // the first tile's probabilities
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    mbar_wait(&full_k[0], 0);
    fence_regs(s);
    wgmma_fence();
    issue_logits<DH>(s, qa, dk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(&empty_k[0], lane);
    sum_halves(s, xch, 0, wg, t128);
    softmax_tile(s, 0, S, scale_log2, t4, m, l, alpha);
    to_fragments(s, pa);
  }
  // As in FlashAttention-3: tile kt+1's logits are issued, O is rescaled
  // to tile kt's max while they run, tile kt's P V is issued, and tile
  // kt+1's softmax runs while P V does.  P is packed only once its P V
  // has retired: no register that a wgmma in flight reads is written.
  for (int kt = 0; kt + 1 < n_tiles; ++kt) {
    const int st = kt % kStages, nt = kt + 1, nst = nt % kStages;
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    mbar_wait(&full_k[nst], (nt / kStages) & 1);
    fence_regs(s);
    wgmma_fence();
    issue_logits<DH>(s, qa, dk + nst * kStage);
    wgmma_commit();
    rescale(o, alpha);
    mbar_wait(&full_v[st], (kt / kStages) & 1);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv<DH>(o, pa, dv + st * kStage);
    wgmma_commit();
    // while both products run: K tile kt+2 into the stage every warp of
    // this block released in the last tile's exchange, and V tile kt+1
    // into the one released as the last tile ended (tiles 0 and 1 of
    // each went in first)
    if (loads_k) ld.issue(kt + 2);
    if (loads_v && kt > 0) ld.issue(kt + 1);
    wgmma_wait<1>();
    fence_regs(s);
    release(&empty_k[nst], lane);
    sum_halves(s, xch, nt, wg, t128);
    softmax_tile(s, nt * kBK, S, scale_log2, t4, m, l, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(&empty_v[st], lane);
    to_fragments(s, pa);
  }
  {  // the last tile's P V
    const int kt = n_tiles - 1, st = kt % kStages;
    rescale(o, alpha);
    mbar_wait(&full_v[st], (kt / kStages) & 1);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv<DH>(o, pa, dv + st * kStage);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    release(&empty_v[st], lane);
  }

  // out = O / l, rows < S only; l summed over the row's four threads; the
  // logsumexp against the max l was summed with, where asked for
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= S) continue;
    if (lse != nullptr && wg == 0 && t4 == 0)
      lse[(int64_t)b * S + row] = (m[h] + log2f(l[h])) * kLn2;
    const float inv = 1.f / l[h];
    __nv_bfloat16* orow = out + ((int64_t)b * S + row) * D + wg * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
  if (loads_k || loads_v) ld.drain();
}

// a (B, S, D) bf16 tensor seen as (64, S, D/64, B), innermost first, and
// read in boxes of (64, rows, groups, 1): one load brings ``groups``
// 64-column groups of ``rows`` rows, each (rows x 128 bytes) swizzled in
// 128-byte rows, group after group; rows past S read as zeros
bool make_map(CUtensorMap* map, const void* base, int B, int S, int D,
              int rows, int groups) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kBox, (cuuint64_t)S,
                              (cuuint64_t)D / kBox, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)kBox * 2,
                                 (cuuint64_t)S * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, (cuuint32_t)rows,
                             (cuuint32_t)groups, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, float scale_log2, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, D, kBM, D / kBox) ||
      !make_map(&mk, k, B, S, D, kBK, L::groups) ||
      !make_map(&mv, v, B, S, D, kBK, L::groups))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::bytes);
  if (e != cudaSuccess) return (int)e;
  // whole clusters: a spare query tile past S computes and stores nothing
  const int tiles = (S + kBM - 1) / kBM;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, B);
  flash_fwd_wgmma<D><<<grid, kThreads, L::bytes, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, lse, S, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace wg

int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int D, float scale_log2,
             cudaStream_t s) {
  switch (D) {
    case 64:
      return wg::launch<64>(q, k, v, out, lse, B, S, scale_log2, s);
    case 128:
      return wg::launch<128>(q, k, v, out, lse, B, S, scale_log2, s);
    case 256:
      return wg::launch<256>(q, k, v, out, lse, B, S, scale_log2, s);
    case 512:
      return wg::launch<512>(q, k, v, out, lse, B, S, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (B, S, D) contiguous, 16-byte aligned, dtype bf16; lse:
// (B, S) fp32 for the rows' logsumexp, or NULL.
CVVAE_EXPORT int cvvae_flash_attention(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int S, int D, float scale,
                                       int dtype, int device, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = scale * kLog2e;
  if (dtype != CVVAE_BF16) return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, out, (float*)lse, B, S, D, scale_log2, s);
}
