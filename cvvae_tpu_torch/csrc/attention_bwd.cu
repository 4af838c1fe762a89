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
// Simple and right first: bf16 mma.sync m16n8k16 with fp32 accumulators,
// cp.async double buffering, three launches as the reference has:
//   1. rowdot: D = rowsum(do∘o) in fp32, one warp a row (a fixed
//      shuffle tree);
//   2. dkv: one block of 8 warps per 32-key tile walks every 32-query tile:
//      each warp recomputes one 16x8 block of the 32x32 tile's logits q·kᵀ
//      and of do·vᵀ (the whole head width), P = exp2(s·log2e·q·kᵀ −
//      lse·log2e) and dS = P∘(dP − D) in fp32, rounded to bf16 into shared
//      memory transposed; then every warp adds Pᵀ·do into dv and dSᵀ·q into
//      dk over its own D/8 columns (fp32 registers; dk times s at the end);
//   3. dq: one block per 32-query tile walks every 32-key tile the same
//      way and adds dS·k into dq over each warp's columns (times s).
// The head width splits the accumulators by columns, as K4's forward does
// over two warpgroups: at D = 512 each warp holds 2 x 32 x 64 fp32 of dk
// and dv.  Shared rows are padded by 16 bytes, so the fragment loads and
// ldmatrix reads hit 32 distinct banks.  Rows >= S are zero-filled on
// load, and their P (query or key >= S) is set to 0, so they add nothing;
// they are not written.  No atomics: each output element is summed by one
// thread in a fixed order, so two calls give the same bits.
#include "common.cuh"
#include "hopper.cuh"
#include <math.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kT = 32;               // queries or keys a tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;              // bf16 a shared row is padded by
constexpr int kLdP = kT + kPad;      // row stride of a 32x32 P or dS tile

typedef __nv_bfloat16 bf16;

template <int D>
struct Tile {
  static constexpr int ld = D + kPad;      // row stride, elements
  static constexpr int elems = kT * ld;    // one 32-row tile
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (16x16) of a row-major shared tile at ``p`` (row 0, the
// k-step's first column) with row stride ld
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* p,
                                       int ld, int lane) {
  const bf16* r = p + (lane / 4) * ld + 2 * (lane % 4);
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * ld);
  a[2] = ld32(r + 8);
  a[3] = ld32(r + 8 * ld + 8);
}

// B fragments (16x8) of a row-major [k][n] shared tile: rows k0..k0+15 from
// ``p``, columns n0..n0+7, transposed by ldmatrix
__device__ __forceinline__ void frag_b_trans(uint32_t& b0, uint32_t& b1,
                                             const bf16* p, int ld, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(p + (lane & 15) * ld))
      : "memory");
}

// rows [r0, r0 + kT) of a (S, D) bf16 matrix into a shared tile; rows >= S
// read as zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kT * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < S;
    const bf16* g = src + (int64_t)(ok ? r0 + r : 0) * D + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * Tile<D>::ld + c)),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the tile's rows' lse (in log2 units) and D; 0 past S
__device__ __forceinline__ void load_rows(float* lse2_s, float* d_s,
                                          const float* lse, const float* dvec,
                                          int r0, int S) {
  if (threadIdx.x < kT) {
    const int r = r0 + threadIdx.x;
    lse2_s[threadIdx.x] = r < S ? lse[r] * kLog2e : 0.f;
    d_s[threadIdx.x] = r < S ? dvec[r] : 0.f;
  }
}

// This warp's 16x8 block of a 32x32 tile of P and dS: query rows
// m0 + g and m0 + g + 8 of the tile (m0 = 16 * (warp / 4)), keys n0 +
// 2*t4 and + 1 (n0 = 8 * (warp % 4)), in mma's accumulator order.  The
// logits q·kᵀ and dP = do·vᵀ over the whole head width from the shared
// tiles (query rows of qs and dos, key rows of ks and vs), then P =
// exp2(s·log2e·q·kᵀ − lse·log2e) and dS = P∘(dP − D) in fp32; P is 0 for a
// query or key past S.
template <int D>
__device__ __forceinline__ void probs_and_grads(
    float (&p)[4], float (&ds)[4], const bf16* qs, const bf16* dos,
    const bf16* ks, const bf16* vs, const float* lse2_s, const float* d_s,
    int q0, int k0, int S, float scale_log2, int warp, int lane) {
  constexpr int ld = Tile<D>::ld;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = 16 * (warp / 4), n0 = 8 * (warp % 4);
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  const bf16* kb = ks + (n0 + g) * ld + 2 * t4;
  const bf16* vb = vs + (n0 + g) * ld + 2 * t4;
#pragma unroll 4
  for (int c = 0; c < D; c += 16) {
    uint32_t a[4];
    frag_a(a, qs + m0 * ld + c, ld, lane);
    mma(s, a, ld32(kb + c), ld32(kb + c + 8));
    frag_a(a, dos + m0 * ld + c, ld, lane);
    mma(dp, a, ld32(vb + c), ld32(vb + c + 8));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = m0 + g + 8 * (e >> 1), key = k0 + n0 + 2 * t4 + (e & 1);
    p[e] = (q0 + r < S && key < S) ? exp2f(s[e] * scale_log2 - lse2_s[r])
                                   : 0.f;
    ds[e] = p[e] * (dp[e] - d_s[r]);
  }
}

// D = rowsum(do∘o) in fp32: one warp a row, each lane two columns at a
// time, then a fixed shuffle tree
__global__ void __launch_bounds__(kThreads)
    rowdot(const bf16* __restrict__ a, const bf16* __restrict__ b,
           float* __restrict__ out, int64_t rows, int D) {
  const int64_t row =
      (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
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

// dk and dv of one 32-key tile (block x) of batch row y
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dvec, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int S, float scale,
                  float scale_log2) {
  constexpr int ld = Tile<D>::ld, elems = Tile<D>::elems;
  constexpr int CW = D / kWarps, NT = CW / 8;  // a warp's columns, n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + elems;
  bf16* qs = vs + elems;       // two stages
  bf16* dos = qs + 2 * elems;  // two stages
  bf16* pt = dos + 2 * elems;  // P of the tile, [key][query]
  bf16* dst = pt + kT * kLdP;  // dS of the tile, [key][query]
  float* lse2_s = reinterpret_cast<float*>(dst + kT * kLdP);  // two stages
  float* d_s = lse2_s + 2 * kT;                               // two stages
  const int b = blockIdx.y, k0 = blockIdx.x * kT;
  const int64_t off = (int64_t)b * S * D;
  const float* lse_b = lse + (int64_t)b * S;
  const float* dvec_b = dvec + (int64_t)b * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_query_tiles = (S + kT - 1) / kT;

  load_tile<D>(ks, k + off, k0, S);
  load_tile<D>(vs, v + off, k0, S);
  load_tile<D>(qs, q + off, 0, S);
  load_tile<D>(dos, dout + off, 0, S);
  load_rows(lse2_s, d_s, lse_b, dvec_b, 0, S);
  cp_commit();

  float acc_v[2][NT][4], acc_k[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_v[mt][nt][e] = acc_k[mt][nt][e] = 0.f;

  for (int it = 0; it < n_query_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_query_tiles) {  // the next query tile into the other stage
      const int r0 = (it + 1) * kT;
      load_tile<D>(qs + (st ^ 1) * elems, q + off, r0, S);
      load_tile<D>(dos + (st ^ 1) * elems, dout + off, r0, S);
      load_rows(lse2_s + (st ^ 1) * kT, d_s + (st ^ 1) * kT, lse_b, dvec_b,
                r0, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * elems;
    const bf16* dot = dos + st * elems;
    float p[4], ds[4];
    probs_and_grads<D>(p, ds, qt, dot, ks, vs, lse2_s + st * kT,
                       d_s + st * kT, it * kT, k0, S, scale_log2, warp, lane);
    {  // transposed into shared memory, [key][query]
      const int m0 = 16 * (warp / 4), n0 = 8 * (warp % 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + g + 8 * (e >> 1), key = n0 + 2 * t4 + (e & 1);
        pt[key * kLdP + r] = __float2bfloat16_rn(p[e]);
        dst[key * kLdP + r] = __float2bfloat16_rn(ds[e]);
      }
    }
    __syncthreads();
    // dv += Pᵀ·do and dk += dSᵀ·q over this warp's columns
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ap[2][4], as[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        frag_a(ap[mt], pt + mt * 16 * kLdP + kk * 16, kLdP, lane);
        frag_a(as[mt], dst + mt * 16 * kLdP + kk * 16, kLdP, lane);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp * CW + nt * 8;
        uint32_t b0, b1;
        frag_b_trans(b0, b1, dot + kk * 16 * ld + col, ld, lane);
        mma(acc_v[0][nt], ap[0], b0, b1);
        mma(acc_v[1][nt], ap[1], b0, b1);
        frag_b_trans(b0, b1, qt + kk * 16 * ld + col, ld, lane);
        mma(acc_k[0][nt], as[0], b0, b1);
        mma(acc_k[1][nt], as[1], b0, b1);
      }
    }
    __syncthreads();  // the stage and P / dS are free for the next tile
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + mt * 16 + g + 8 * h;
      if (key >= S) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int64_t at = off + (int64_t)key * D + warp * CW + nt * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack_bf16(acc_v[mt][nt][2 * h], acc_v[mt][nt][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack_bf16(acc_k[mt][nt][2 * h] * scale,
                      acc_k[mt][nt][2 * h + 1] * scale);
      }
    }
}

// dq of one 32-query tile (block x) of batch row y
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 bf16* __restrict__ dq, int S, float scale,
                 float scale_log2) {
  constexpr int ld = Tile<D>::ld, elems = Tile<D>::elems;
  constexpr int CW = D / kWarps, NT = CW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + elems;
  bf16* ks = dos + elems;      // two stages
  bf16* vs = ks + 2 * elems;   // two stages
  bf16* dss = vs + 2 * elems;  // dS of the tile, [query][key]
  float* lse2_s = reinterpret_cast<float*>(dss + kT * kLdP);
  float* d_s = lse2_s + kT;
  const int b = blockIdx.y, q0 = blockIdx.x * kT;
  const int64_t off = (int64_t)b * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_key_tiles = (S + kT - 1) / kT;

  load_tile<D>(qs, q + off, q0, S);
  load_tile<D>(dos, dout + off, q0, S);
  load_rows(lse2_s, d_s, lse + (int64_t)b * S, dvec + (int64_t)b * S, q0, S);
  load_tile<D>(ks, k + off, 0, S);
  load_tile<D>(vs, v + off, 0, S);
  cp_commit();

  float acc_q[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_q[mt][nt][e] = 0.f;

  for (int kt = 0; kt < n_key_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_key_tiles) {  // the next key tile into the other stage
      load_tile<D>(ks + (st ^ 1) * elems, k + off, (kt + 1) * kT, S);
      load_tile<D>(vs + (st ^ 1) * elems, v + off, (kt + 1) * kT, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = ks + st * elems;
    float p[4], ds[4];
    probs_and_grads<D>(p, ds, qs, dos, kt_s, vs + st * elems, lse2_s, d_s,
                       q0, kt * kT, S, scale_log2, warp, lane);
    {  // into shared memory, [query][key]
      const int m0 = 16 * (warp / 4), n0 = 8 * (warp % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(dss + (m0 + g + 8 * h) * kLdP + n0 +
                                     2 * t4) =
            pack_bf16(ds[2 * h], ds[2 * h + 1]);
    }
    __syncthreads();
    // dq += dS·k over this warp's columns
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        frag_a(a[mt], dss + mt * 16 * kLdP + kk * 16, kLdP, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        frag_b_trans(b0, b1, kt_s + kk * 16 * ld + warp * CW + nt * 8, ld,
                     lane);
        mma(acc_q[0][nt], a[0], b0, b1);
        mma(acc_q[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();  // the stage and dS are free for the next tile
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + mt * 16 + g + 8 * h;
      if (row >= S) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(dq + off + (int64_t)row * D + warp * CW +
                                     nt * 8 + 2 * t4) =
            pack_bf16(acc_q[mt][nt][2 * h] * scale,
                      acc_q[mt][nt][2 * h + 1] * scale);
    }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* dvec, bf16* dq,
           bf16* dk, bf16* dv, int B, int S, float scale, cudaStream_t s) {
  constexpr int tiles_bytes = 6 * Tile<D>::elems * 2;
  constexpr int dkv_bytes = tiles_bytes + 2 * kT * kLdP * 2 + 4 * kT * 4;
  constexpr int dq_bytes = tiles_bytes + kT * kLdP * 2 + 2 * kT * 4;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)B * S;
  rowdot<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      dout, o, dvec, rows, D);
  const float scale_log2 = scale * kLog2e;
  const dim3 grid((S + kT - 1) / kT, B);
  flash_bwd_dkv<D><<<grid, kThreads, dkv_bytes, s>>>(
      q, k, v, dout, lse, dvec, dk, dv, S, scale, scale_log2);
  flash_bwd_dq<D><<<grid, kThreads, dq_bytes, s>>>(q, k, v, dout, lse, dvec,
                                                   dq, S, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, S, D) contiguous, 16-byte aligned, bf16;
// lse: (B, S) fp32, K4's logsumexp; dvec: (B, S) fp32 scratch for D.
CVVAE_EXPORT int cvvae_flash_attention_bwd(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const void* lse,
                                           void* dvec, void* dq, void* dk,
                                           void* dv, int B, int S, int D,
                                           float scale, int dtype, int device,
                                           void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || dtype != CVVAE_BF16)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
#define CVVAE_K4_BWD(W)                                                      \
  case W:                                                                    \
    return launch<W>((const bf16*)q, (const bf16*)k, (const bf16*)v,        \
                     (const bf16*)o, (const bf16*)dout, (const float*)lse,  \
                     (float*)dvec, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, S,   \
                     scale, s);
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
