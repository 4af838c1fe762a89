// K1: GroupNorm (+ optional SiLU) over a contiguous (B, S, C) view.
//
// Replaces cvvae_tpu/ops/pallas/groupnorm.py::group_norm_silu_pallas.
// The TPU kernel carries its statistics across a sequential grid; blocks
// here run in parallel in no order, so the reduction is three launches,
// deterministic and without atomics:
//   1. gn_stats: a grid of about 8 blocks an SM (the plan, made by the
//      wrapper: ``n_blocks`` blocks per batch row, each a contiguous run
//      of ``rows_per_block`` rows) reads x once in 16-byte loads, four in
//      flight per thread, neighbouring threads on neighbouring addresses.
//      Thread (tx, ty) owns one V-channel vector of every ty-th row, so
//      its channels, and the groups they fold into, never change.  It
//      sums x - K and (x - K)^2 in fp32 over each batch of loads and adds
//      the batch to double accumulators; K is one value of the group
//      (its first element in row 0), the same in every block, so the
//      moments of all blocks add.  The block folds its threads' moments
//      per group in a fixed order and writes them, in double.
//   2. gn_merge: one warp per (batch row, group) sums the blocks' moments
//      in a fixed order (lane-strided, then a fixed shuffle tree), takes
//      mean and variance in double about K, and folds mean, 1/std, scale
//      and bias into a per-channel affine a, b.
//   3. gn_apply: the same plan and thread layout; each thread keeps its
//      V channels' (a, b) in registers and writes y = fma(x, a, b) (fp32,
//      one rounding), then SiLU, in 16-byte stores.
// Bound: device memory.  One read and one write of x is the least
// traffic (8.02 GB at (1,17,720,1280,128) bf16: 2.39 ms at 3.35 TB/s);
// this design reads x twice (the statistics must be complete before the
// first output), so 12.0 GB, 3.59 ms at the card's peak.
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // loads in flight per thread

// V elements of T in one aligned load
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the launch plan, made by ops/kernels/groupnorm.py::launch_plan
struct Plan {
  int64_t S;
  int C, G, cg;
  int nvc;              // C / V: vector columns per row (threads across C)
  int rows_per_iter;    // threads / nvc: rows a block reads at once
  int64_t rows_per_block;
  int n_blocks;         // blocks per batch row
};

// threads a block may have: 256, or up to 1024 where V <= 2 and C / V >
// 256 (every thread owns one vector column)
template <int V>
constexpr int max_threads() {
  return V > 2 ? 256 : 1024;
}

// Moments: thread slot s holds channels whose group is the s-th of the
// NS groups its vector touches (NS = V / cg when a vector spans several
// groups, else 1).
template <typename T, int V, int NS>
__global__ void __launch_bounds__(max_threads<V>())
    gn_stats(const T* __restrict__ x, double* __restrict__ part, Plan p) {
  extern __shared__ double sh[];  // [rows_per_iter][nvc * NS][2]
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  const int b = blockIdx.y, blk = blockIdx.x;
  const T* xb = x + (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;

  float shift[NS];
  double s1[NS], s2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    shift[s] = to_f32(xb[((c0 + s * (V / NS)) / p.cg) * p.cg]);
    s1[s] = 0.0;
    s2[s] = 0.0;
  }
  if (ty < p.rows_per_iter) {
    for (int64_t r = r0 + ty; r < r1; r += step) {
      Pack<T, V> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row = r + (int64_t)u * p.rows_per_iter;
        if (row < r1)
          v[u] = *reinterpret_cast<const Pack<T, V>*>(xb + row * p.C + c0);
      }
      float f1[NS], f2[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) f1[s] = f2[s] = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + (int64_t)u * p.rows_per_iter < r1) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int s = j / (V / NS);
            const float d = to_f32(v[u].v[j]) - shift[s];
            f1[s] += d;
            f2[s] = fmaf(d, d, f2[s]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        s1[s] += (double)f1[s];
        s2[s] += (double)f2[s];
      }
    }
    const int w = p.nvc * NS;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sh[(ty * w + tx * NS + s) * 2] = s1[s];
      sh[(ty * w + tx * NS + s) * 2 + 1] = s2[s];
    }
  }
  __syncthreads();
  // slot k of a row holds group k (NS > 1) or group k / (cg / V) (NS ==
  // 1): a group's slots are [g * per, (g + 1) * per)
  const int w = p.nvc * NS;
  const int per = NS > 1 ? 1 : p.cg / V;
  for (int g = threadIdx.x; g < p.G; g += blockDim.x) {
    double a1 = 0.0, a2 = 0.0;
    for (int y = 0; y < p.rows_per_iter; ++y)
      for (int k = g * per; k < (g + 1) * per; ++k) {
        a1 += sh[(y * w + k) * 2];
        a2 += sh[(y * w + k) * 2 + 1];
      }
    double* out = part + (((int64_t)b * p.n_blocks + blk) * p.G + g) * 2;
    out[0] = a1;
    out[1] = a2;
  }
}

// one warp per (batch row, group)
template <typename T>
__global__ void gn_merge(const T* __restrict__ x,
                         const double* __restrict__ part,
                         const float* __restrict__ weight,
                         const float* __restrict__ bias,
                         float* __restrict__ coef, int B, Plan p, float eps) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  double a1 = 0.0, a2 = 0.0;
  for (int k = lane; k < p.n_blocks; k += 32) {
    const double* q = part + (((int64_t)b * p.n_blocks + k) * p.G + g) * 2;
    a1 += q[0];
    a2 += q[1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
  }
  const double n = (double)p.S * p.cg;
  const double m = a1 / n;  // mean of x - K
  const double var = fmax(a2 / n - m * m, 0.0);
  const float mean =
      (float)((double)to_f32(x[(int64_t)b * p.S * p.C + g * p.cg]) + m);
  const float inv = rsqrtf((float)var + eps);
  for (int c = g * p.cg + lane; c < (g + 1) * p.cg; c += 32) {
    const float a = inv * weight[c];
    coef[(int64_t)b * 2 * p.C + c] = a;
    coef[(int64_t)b * 2 * p.C + p.C + c] = bias[c] - mean * a;
  }
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(max_threads<V>())
    gn_apply(const T* __restrict__ x, T* __restrict__ y,
             const float* __restrict__ coef, Plan p) {
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  if (ty >= p.rows_per_iter) return;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int64_t off = (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  float a[V], bb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = coef[(int64_t)b * 2 * p.C + c0 + j];
    bb[j] = coef[(int64_t)b * 2 * p.C + p.C + c0 + j];
  }
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;
  for (int64_t r = r0 + ty; r < r1; r += step) {
    Pack<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + (int64_t)u * p.rows_per_iter;
      if (row < r1)
        v[u] = *reinterpret_cast<const Pack<T, V>*>(x + off + row * p.C + c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + (int64_t)u * p.rows_per_iter;
      if (row < r1) {
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float t = fmaf(to_f32(v[u].v[j]), a[j], bb[j]);
          if (kSilu) t = t / (1.f + __expf(-t));
          o.v[j] = from_f32<T>(t);
        }
        *reinterpret_cast<Pack<T, V>*>(y + off + row * p.C + c0) = o;
      }
    }
  }
}

template <typename T, int V, int NS>
int launch(const void* x, void* y, const float* weight, const float* bias,
           double* part, float* coef, int B, const Plan& p, int threads,
           float eps, int silu, cudaStream_t stream) {
  const dim3 grid(p.n_blocks, B);
  const size_t smem = sizeof(double) * 2 * p.rows_per_iter * p.nvc * NS;
  gn_stats<T, V, NS><<<grid, threads, smem, stream>>>((const T*)x, part, p);
  const int warps = B * p.G;
  gn_merge<T><<<(warps + 7) / 8, 256, 0, stream>>>(
      (const T*)x, part, weight, bias, coef, B, p, eps);
  if (silu)
    gn_apply<T, V, true><<<grid, threads, 0, stream>>>((const T*)x, (T*)y,
                                                        coef, p);
  else
    gn_apply<T, V, false><<<grid, threads, 0, stream>>>((const T*)x, (T*)y,
                                                         coef, p);
  return (int)cudaGetLastError();
}

// the (V, NS) pairs the plan may choose: V the widest of {16 bytes, 2, 1}
// elements that divides C and is a divisor or a multiple of C / G
template <typename T>
int dispatch(int V, int NS, const void* x, void* y, const float* w,
             const float* bi, double* part, float* coef, int B,
             const Plan& p, int threads, float eps, int silu,
             cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
#define CVVAE_GN(v, ns)                                                   \
  if (V == v && NS == ns)                                                 \
    return launch<T, v, ns>(x, y, w, bi, part, coef, B, p, threads, eps, \
                            silu, s);
  CVVAE_GN(kV, 1)
  CVVAE_GN(kV, 2)
  CVVAE_GN(kV, 4)
  if constexpr (kV == 8) {
    CVVAE_GN(8, 8)
  }
  CVVAE_GN(2, 1)
  CVVAE_GN(2, 2)
  CVVAE_GN(1, 1)
#undef CVVAE_GN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: (B, S, C) contiguous, 16-byte aligned, dtype f32 or bf16.
// weight, bias: (C,) f32.  part: (B, n_blocks, G, 2) f64 scratch.  coef:
// (B, 2, C) f32 scratch.  The plan (V, NS, threads, rows_per_block,
// n_blocks) comes from ops/kernels/groupnorm.py::launch_plan and is
// checked here.
CVVAE_EXPORT int cvvae_group_norm(const void* x, void* y, const void* weight,
                                  const void* bias, void* part, void* coef,
                                  int B, int64_t S, int C, int G, float eps,
                                  int silu, int dtype, int V, int NS,
                                  int threads, int64_t rows_per_block,
                                  int n_blocks, int device, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || G <= 0 || C % G != 0 || C > 1024 ||
      V <= 0 || C % V != 0 || NS <= 0 || V % NS != 0 || threads % 32 != 0 ||
      threads > (V > 2 ? 256 : 1024) || C / V > threads || rows_per_block <= 0 ||
      n_blocks <= 0 || (int64_t)n_blocks * rows_per_block < S)
    return (int)cudaErrorInvalidValue;
  const int cg = C / G;
  if (NS > 1 ? V / NS != cg : cg % V != 0) return (int)cudaErrorInvalidValue;
  Plan p{S, C, G, cg, C / V, threads / (C / V), rows_per_block, n_blocks};
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    return dispatch<__nv_bfloat16>(V, NS, x, y, (const float*)weight,
                                   (const float*)bias, (double*)part,
                                   (float*)coef, B, p, threads, eps, silu, s);
  if (dtype == CVVAE_F32)
    return dispatch<float>(V, NS, x, y, (const float*)weight,
                           (const float*)bias, (double*)part, (float*)coef,
                           B, p, threads, eps, silu, s);
  return (int)cudaErrorInvalidValue;
}
