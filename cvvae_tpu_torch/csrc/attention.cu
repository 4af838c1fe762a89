// K4: single-head flash attention forward, softmax(q·kᵀ·scale)·v, on
// contiguous (B, S, D) tensors, D in {64, 128, 256, 512}.
//
// Replaces cvvae_tpu/ops/attention.py:60 _flash_attention (the stock
// Pallas TPU flash attention), which pads S to a multiple of 512 behind
// segment ids; here the ragged tail is masked in the kernel instead.
//
// One block of 256 threads (8 warps) per (32-query tile, batch row) walks
// every key/value tile with an online softmax: a running row max and row
// sum in fp32, the output rescaled per tile and normalised once at the
// end, so the (S, S) logits never reach device memory.
//
// Head dim 512 is what shapes the design.  The output accumulator of a
// 32-row tile is 32x512 fp32 = 64 KB: it lives in registers, split by
// columns over the 8 warps (64 floats a thread).  Q (32 rows) stays in
// shared memory for the whole loop; one K/V buffer holds the K tile for
// the logits and is then refilled with the V tile (cp.async, overlapping
// the softmax).  bf16: 114 KB of shared memory, two blocks an SM.
//   bf16: logits and P·V on the tensor cores (mma.sync m16n8k16, bf16 in,
//         fp32 accumulate); P is rounded to bf16 unnormalised.
//   fp32: the same tiling with fp32 FMAs, no TF32.
// Bound: every query tile re-reads all of K and V (2·S·D·2 bytes, 29.5 MB
// a frame at S = 14400 bf16) from L2, so a tile of 32 queries does 32
// FLOP per byte it loads; 4·B·S²·D FLOP in all (2.12 TFLOP at
// (5, 14400, 512)).  Key rows >= S are zero-filled and get logit -inf;
// query rows >= S are computed on zeros and not stored.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kBQ = 32;  // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct TileCfg;
template <>
struct TileCfg<__nv_bfloat16> {
  static constexpr int kBK = 64;   // keys per tile
  static constexpr int kPad = 8;   // row padding (elements): no bank conflicts
};
template <>
struct TileCfg<float> {
  static constexpr int kBK = 32;
  static constexpr int kPad = 4;
};

// Shared memory layout (bytes); every region starts 16-byte aligned.
template <typename T, int D>
struct Smem {
  static constexpr int BK = TileCfg<T>::kBK;
  static constexpr int LDQ = D + TileCfg<T>::kPad;   // Q and K/V rows
  static constexpr int LDS = BK + 8;                 // fp32 logits rows
  static constexpr int LDP = BK + TileCfg<T>::kPad;  // P rows
  static constexpr size_t q_off = 0;
  static constexpr size_t kv_off = q_off + sizeof(T) * kBQ * LDQ;
  static constexpr size_t s_off = kv_off + sizeof(T) * BK * LDQ;
  static constexpr size_t p_off = s_off + sizeof(float) * kBQ * LDS;
  static constexpr size_t stat_off = p_off + sizeof(T) * kBQ * LDP;
  static constexpr size_t bytes = stat_off + sizeof(float) * 3 * kBQ;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: no read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) of a (S, D) matrix into shared rows of stride
// ld; rows >= S become zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* g, int row0,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const bool valid = row0 + r < S;
    const T* src = valid ? g + (int64_t)(row0 + r) * D + c : g;
    cp_async16(s + r * ld + c, src, valid);
  }
}

// Online softmax over one logits tile (already scaled to log2 units):
// 8 threads a row.  Writes P = exp2(s - m_new) (unnormalised) and the
// row's correction alpha = exp2(m_old - m_new); updates m and l.
template <typename T, int BK>
__device__ __forceinline__ void online_softmax(const float* sS, int lds,
                                               T* sP, int ldp, float* sM,
                                               float* sL, float* sAlpha) {
  constexpr int kPer = BK / 8;
  const int r = threadIdx.x >> 3, j = threadIdx.x & 7;
  float v[kPer];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = sS[r * lds + j + 8 * i];
    mx = fmaxf(mx, v[i]);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_old = sM[r];
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float p = exp2f(v[i] - m_new);
    sum += p;
    sP[r * ldp + j + 8 * i] = from_f32<T>(p);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  __syncwarp();
  if (j == 0) {
    const float alpha = exp2f(m_old - m_new);
    sAlpha[r] = alpha;
    sM[r] = m_new;
    sL[r] = sL[r] * alpha + sum;
  }
}

// ---------------------------------------------------------------- bf16 --

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layout of m16n8k16 (PTX ISA): lane = 4*g + t4.  A (16x16,
// row): a0 (g, 2t4..+1), a1 (g+8, 2t4..), a2 (g, 2t4+8..), a3 (g+8,
// 2t4+8..).  B (16x8, col): b0 (k 2t4..+1, n g), b1 (k 2t4+8.., n g).
// C (16x8): c0,c1 (g, 2t4..+1), c2,c3 (g+8, 2t4..+1).
template <int D>
struct AccBf16 {
  using T = __nv_bfloat16;
  using L = Smem<T, D>;
  static constexpr int kNT = D / 64;  // n8 tiles of output columns a warp
  float o[2][kNT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[m][n][i] = 0.f;
  }

  // sS[32 x BK] = (Q Kᵀ) * scale_log2, -inf past S; warp w computes rows
  // 16*(w/4).., keys 16*(w%4)..
  static __device__ __forceinline__ void logits(const T* sQ, const T* sK,
                                                float* sS, int k0, int S,
                                                float scale_log2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int mrow = (warp >> 2) * 16, ncol = (warp & 3) * 16;
    float acc[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      const T* qa = sQ + (mrow + g) * L::LDQ + kk + 2 * t4;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * L::LDQ), ld32(qa + 8),
                             ld32(qa + 8 * L::LDQ + 8)};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const T* kb = sK + (ncol + nt * 8 + g) * L::LDQ + kk + 2 * t4;
        const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
        mma_bf16(acc[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int key = ncol + nt * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mrow + g + (i >> 1) * 8, kc = key + (i & 1);
        sS[row * L::LDS + kc] =
            k0 + kc < S ? acc[nt][i] * scale_log2 : -INFINITY;
      }
    }
  }

  // O = O * alpha + P V over this warp's D/8 output columns
  __device__ __forceinline__ void update(const T* sP, const T* sV,
                                         const float* sAlpha) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int dcol = warp * (D / 8);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float a0 = sAlpha[m * 16 + g], a1 = sAlpha[m * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[m][n][0] *= a0;
        o[m][n][1] *= a0;
        o[m][n][2] *= a1;
        o[m][n][3] *= a1;
      }
    }
    const unsigned short* v16 = reinterpret_cast<const unsigned short*>(sV);
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const T* pa = sP + (m * 16 + g) * L::LDP + kk + 2 * t4;
        a[m][0] = ld32(pa);
        a[m][1] = ld32(pa + 8 * L::LDP);
        a[m][2] = ld32(pa + 8);
        a[m][3] = ld32(pa + 8 * L::LDP + 8);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const unsigned short* vb =
            v16 + (kk + 2 * t4) * L::LDQ + dcol + n * 8 + g;
        const uint32_t b[2] = {
            (uint32_t)vb[0] | ((uint32_t)vb[L::LDQ] << 16),
            (uint32_t)vb[8 * L::LDQ] | ((uint32_t)vb[9 * L::LDQ] << 16)};
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_bf16(o[m][n], a[m], b);
      }
    }
  }

  __device__ __forceinline__ void store(T* out, const float* sL, int q0,
                                        int S) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int dcol = warp * (D / 8);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m * 16 + g + 8 * h;
        if (q0 + row >= S) continue;
        const float inv = 1.f / sL[row];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          __nv_bfloat162 pair;
          pair.x = from_f32<T>(o[m][n][2 * h] * inv);
          pair.y = from_f32<T>(o[m][n][2 * h + 1] * inv);
          *reinterpret_cast<__nv_bfloat162*>(
              out + (int64_t)(q0 + row) * D + dcol + n * 8 + 2 * t4) = pair;
        }
      }
  }
};

// ---------------------------------------------------------------- fp32 --

// Thread t owns query row t/8.  Logits: keys t%8 + 8i.  Output: columns
// 4*(t%8) + 32*j .. +3.
template <int D>
struct AccF32 {
  using T = float;
  using L = Smem<T, D>;
  static constexpr int kNJ = D / 32;
  float4 o[kNJ];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  static __device__ __forceinline__ void logits(const T* sQ, const T* sK,
                                                float* sS, int k0, int S,
                                                float scale_log2) {
    constexpr int kPer = L::BK / 8;
    const int r = threadIdx.x >> 3, j = threadIdx.x & 7;
    float acc[kPer] = {};
    const float* qr = sQ + r * L::LDQ;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sK + (j + 8 * i) * L::LDQ + d);
        acc[i] = fmaf(qv.x, kv.x, acc[i]);
        acc[i] = fmaf(qv.y, kv.y, acc[i]);
        acc[i] = fmaf(qv.z, kv.z, acc[i]);
        acc[i] = fmaf(qv.w, kv.w, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kc = j + 8 * i;
      sS[r * L::LDS + kc] = k0 + kc < S ? acc[i] * scale_log2 : -INFINITY;
    }
  }

  __device__ __forceinline__ void update(const T* sP, const T* sV,
                                         const float* sAlpha) {
    const int r = threadIdx.x >> 3, c = 4 * (threadIdx.x & 7);
    const float alpha = sAlpha[r];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      o[j].x *= alpha;
      o[j].y *= alpha;
      o[j].z *= alpha;
      o[j].w *= alpha;
    }
#pragma unroll 4
    for (int k = 0; k < L::BK; ++k) {
      const float p = sP[r * L::LDP + k];
      const float* vr = sV + k * L::LDQ + c;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 32 * j);
        o[j].x = fmaf(p, vv.x, o[j].x);
        o[j].y = fmaf(p, vv.y, o[j].y);
        o[j].z = fmaf(p, vv.z, o[j].z);
        o[j].w = fmaf(p, vv.w, o[j].w);
      }
    }
  }

  __device__ __forceinline__ void store(T* out, const float* sL, int q0,
                                        int S) const {
    const int r = threadIdx.x >> 3, c = 4 * (threadIdx.x & 7);
    if (q0 + r >= S) return;
    const float l = sL[r];
    float* orow = out + (int64_t)(q0 + r) * D + c;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      *reinterpret_cast<float4*>(orow + 32 * j) =
          make_float4(o[j].x / l, o[j].y / l, o[j].z / l, o[j].w / l);
  }
};

template <typename T, int D>
struct Acc;
template <int D>
struct Acc<__nv_bfloat16, D> : AccBf16<D> {};
template <int D>
struct Acc<float, D> : AccF32<D> {};

// ---------------------------------------------------------------- kernel --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int S,
              float scale_log2) {
  using L = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sKV = reinterpret_cast<T*>(smem + L::kv_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  float* sM = reinterpret_cast<float*>(smem + L::stat_off);
  float* sL = sM + kBQ;
  float* sAlpha = sL + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int64_t base = (int64_t)blockIdx.y * S * D;
  q += base;
  k += base;
  v += base;
  out += base;

  load_tile<T, D, kBQ>(sQ, L::LDQ, q, q0, S);
  cp_async_commit();
  if (threadIdx.x < kBQ) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.f;
  }
  Acc<T, D> acc;
  acc.zero();

  const int n_tiles = (S + L::BK - 1) / L::BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * L::BK;
    __syncthreads();  // the previous tile's P·V is done with sKV and sP
    load_tile<T, D, L::BK>(sKV, L::LDQ, k, k0, S);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    Acc<T, D>::logits(sQ, sKV, sS, k0, S, scale_log2);
    __syncthreads();  // K is read: refill the buffer with V
    load_tile<T, D, L::BK>(sKV, L::LDQ, v, k0, S);
    cp_async_commit();
    online_softmax<T, L::BK>(sS, L::LDS, sP, L::LDP, sM, sL, sAlpha);
    cp_async_wait_all();
    __syncthreads();
    acc.update(sP, sKV, sAlpha);
  }
  acc.store(out, sL, q0, S);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, float scale_log2, cudaStream_t stream) {
  using L = Smem<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kBQ - 1) / kBQ, B);
  flash_fwd<T, D><<<grid, kThreads, L::bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int D, float scale_log2, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, out, B, S, scale_log2, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, scale_log2, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, scale_log2, s);
    case 512: return launch<T, 512>(q, k, v, out, B, S, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (B, S, D) contiguous, 16-byte aligned, dtype f32 or bf16.
CVVAE_EXPORT int cvvae_flash_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int S,
                                       int D, float scale, int dtype,
                                       int device, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = scale * kLog2e;
  if (dtype == CVVAE_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, D, scale_log2, s);
  if (dtype == CVVAE_F32)
    return dispatch<float>(q, k, v, out, B, S, D, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}
