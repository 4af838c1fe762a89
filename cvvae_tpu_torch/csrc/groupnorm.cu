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
// Split across ranks (a tensor sharded along its rows over a mesh,
// ops/kernels/groupnorm.py::group_norm_silu_sharded), the same three steps
// become two entries around one collective:
//   cvvae_group_norm_partial: gn_stats, then gn_partial, which sums the
//      blocks as gn_merge does and writes each (batch row, group)'s count,
//      mean and M2 (the sum of squared deviations from that mean) in
//      double.  Every rank shifts by its own K, so the moments about K do
//      not add across ranks; (count, mean, M2) do, by Chan's formula.
//   (the wrapper all-gathers every rank's (B, G, 3) in rank order)
//   cvvae_group_norm_combine: gn_combine, one warp per (batch row, group),
//      folds the ranks' (count, mean, M2) in rank order by Chan's formula
//      in double (deterministic, independent of timing) and the affine as
//      gn_merge does; then gn_apply, unchanged.
// The int8 mode (cvvae_group_norm_int8), for an int8-resident activation
// (cvvae_tpu/ops/qflow.py:138-172, qgroup_norm_silu), computes the JAX
// package's function, not K1's own statistics:
//   gnq_stats: the same plan over int8 x (16 values a load); each value is
//      dequantized in registers, xf = q * s[c] (s a scalar or per channel),
//      and xf and xf * xf (each rounded to fp32) are summed, no shift, in
//      fp32 over a thread's batch of loads and then in double; the block's
//      per-group sums written as gn_stats writes them.
//   gnq_merge: one warp per (batch row, group) adds the blocks' sums in a
//      fixed order and takes JAX's one-pass moments: the fp32 mean and
//      mean of squares, var = E[x^2] - mean^2 in fp32 (not clamped: it
//      can go slightly negative, as JAX's can), inv = rsqrt(var + eps)
//      correctly rounded, then the folded affine a = inv * w[c] * s[c], b
//      = bias[c] - mean * inv * w[c], each product rounded as JAX writes it.
//   gnq_apply: h = q * a + b (two roundings, as the reference's), SiLU in
//      fp32 (h * 1 / (1 + exp(-h))), written as int8 requantized at the
//      consumer's scalar out_scale (quant8, common.cuh), or bf16 / fp32.
//   Its statistics run over every axis but the batch and the channels
//   (T, H, W, C/G); 2 bytes an element of traffic with an int8 output.
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

// the blocks' moments of (batch row b, group g), summed by one warp in a
// fixed order (lane-strided, then a fixed shuffle tree): every lane ends
// with the same sums
__device__ __forceinline__ void block_moments(const double* __restrict__ part,
                                              int b, int g, int lane,
                                              const Plan& p, double* s1,
                                              double* s2) {
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
  *s1 = a1;
  *s2 = a2;
}

// one warp per (batch row, group)
template <typename T>
__global__ void gn_merge(const T* __restrict__ x,
                         const double* __restrict__ part,
                         const float* __restrict__ weight,
                         const float* __restrict__ bias,
                         float* __restrict__ coef, float* __restrict__ stats,
                         int B, Plan p, float eps) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  double a1, a2;
  block_moments(part, b, g, lane, p, &a1, &a2);
  const double n = (double)p.S * p.cg;
  const double m = a1 / n;  // mean of x - K
  const double var = fmax(a2 / n - m * m, 0.0);
  const float mean =
      (float)((double)to_f32(x[(int64_t)b * p.S * p.C + g * p.cg]) + m);
  const float inv = rsqrtf((float)var + eps);
  // saved for K1.bwd (csrc/groupnorm_bwd.cu) when a gradient is needed
  if (stats != nullptr && lane == 0) {
    stats[((int64_t)b * p.G + g) * 2] = mean;
    stats[((int64_t)b * p.G + g) * 2 + 1] = inv;
  }
  for (int c = g * p.cg + lane; c < (g + 1) * p.cg; c += 32) {
    const float a = inv * weight[c];
    coef[(int64_t)b * 2 * p.C + c] = a;
    coef[(int64_t)b * 2 * p.C + p.C + c] = bias[c] - mean * a;
  }
}

// one warp per (batch row, group): the blocks' moments summed as gn_merge
// sums them, written as (count, mean, M2) in double for the cross-rank
// combination
template <typename T>
__global__ void gn_partial(const T* __restrict__ x,
                           const double* __restrict__ part,
                           double* __restrict__ moments, int B, Plan p) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  double a1, a2;
  block_moments(part, b, g, lane, p, &a1, &a2);
  if (lane == 0) {
    const double n = (double)p.S * p.cg;
    const double m = a1 / n;  // mean of x - K
    double* out = moments + ((int64_t)b * p.G + g) * 3;
    out[0] = n;
    out[1] = (double)to_f32(x[(int64_t)b * p.S * p.C + g * p.cg]) + m;
    out[2] = fmax(a2 - a1 * m, 0.0);  // sum of (x - mean)^2
  }
}

// one warp per (batch row, group): the R ranks' (count, mean, M2), laid
// out (R, B, G, 3), combined in rank order by Chan's formula in double
// (every lane alike), then the affine folded as gn_merge folds it
__global__ void gn_combine(const double* __restrict__ moments, int R,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias,
                           float* __restrict__ coef, float* __restrict__ stats,
                           int B, Plan p, float eps) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int r = 0; r < R; ++r) {
    const double* q = moments + (((int64_t)r * B + b) * p.G + g) * 3;
    const double nb = q[0];
    if (nb <= 0.0) continue;
    const double nab = n + nb, d = q[1] - mean;
    mean += d * (nb / nab);
    m2 += q[2] + d * d * (n * nb / nab);
    n = nab;
  }
  const double var = fmax(m2 / n, 0.0);
  const float meanf = (float)mean;
  const float inv = rsqrtf((float)var + eps);
  if (stats != nullptr && lane == 0) {
    stats[((int64_t)b * p.G + g) * 2] = meanf;
    stats[((int64_t)b * p.G + g) * 2 + 1] = inv;
  }
  for (int c = g * p.cg + lane; c < (g + 1) * p.cg; c += 32) {
    const float a = inv * weight[c];
    coef[(int64_t)b * 2 * p.C + c] = a;
    coef[(int64_t)b * 2 * p.C + p.C + c] = bias[c] - meanf * a;
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

// ---------------------------------------------------------------- int8 --

// the int8 mode's dequantizing scales: channel c's is s[c * per_channel]
struct QScale {
  const float* s;
  int per_channel;
};

// gn_stats over int8 x: the sums of xf = q * s[c] and of xf * xf about 0
template <int V, int NS>
__global__ void __launch_bounds__(max_threads<V>())
    gnq_stats(const int8_t* __restrict__ x, QScale qs,
              double* __restrict__ part, Plan p) {
  extern __shared__ double sh[];  // [rows_per_iter][nvc * NS][2]
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int8_t* xb = x + (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;
  float sc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sc[j] = qs.s[(c0 + j) * qs.per_channel];
  double s1[NS], s2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) s1[s] = s2[s] = 0.0;
  if (ty < p.rows_per_iter) {
    for (int64_t r = r0 + ty; r < r1; r += step) {
      Pack<int8_t, V> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row = r + (int64_t)u * p.rows_per_iter;
        if (row < r1)
          v[u] = *reinterpret_cast<const Pack<int8_t, V>*>(xb + row * p.C +
                                                           c0);
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
            const float xf = __fmul_rn((float)v[u].v[j], sc[j]);
            f1[s] = __fadd_rn(f1[s], xf);
            f2[s] = __fadd_rn(f2[s], __fmul_rn(xf, xf));
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

// one warp per (batch row, group): JAX's one-pass moments and the folded
// affine of the int8 mode
__global__ void gnq_merge(const double* __restrict__ part, QScale qs,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias,
                          float* __restrict__ coef, int B, Plan p,
                          float eps) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  double a1, a2;
  block_moments(part, b, g, lane, p, &a1, &a2);
  const double n = (double)p.S * p.cg;
  const float mean = (float)(a1 / n), msq = (float)(a2 / n);
  const float var = __fsub_rn(msq, __fmul_rn(mean, mean));
  const float inv = __frsqrt_rn(__fadd_rn(var, eps));
  const float mi = __fmul_rn(mean, inv);
  for (int c = g * p.cg + lane; c < (g + 1) * p.cg; c += 32) {
    const float s = qs.s[c * qs.per_channel];
    coef[(int64_t)b * 2 * p.C + c] = __fmul_rn(__fmul_rn(inv, weight[c]), s);
    coef[(int64_t)b * 2 * p.C + p.C + c] =
        __fsub_rn(bias[c], __fmul_rn(mi, weight[c]));
  }
}

// int8 x -> SiLU(q * a + b) as O: int8 requantized at *out_scale, or bf16
// or fp32
template <typename O, int V>
__global__ void __launch_bounds__(max_threads<V>())
    gnq_apply(const int8_t* __restrict__ x, O* __restrict__ y,
              const float* __restrict__ coef,
              const float* __restrict__ out_scale, Plan p) {
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
  const float os = sizeof(O) == 1 ? *out_scale : 1.f, ro = __frcp_rn(os);
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;
  for (int64_t r = r0 + ty; r < r1; r += step) {
    Pack<int8_t, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + (int64_t)u * p.rows_per_iter;
      if (row < r1)
        v[u] = *reinterpret_cast<const Pack<int8_t, V>*>(x + off + row * p.C +
                                                         c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + (int64_t)u * p.rows_per_iter;
      if (row < r1) {
        Pack<O, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float h = __fadd_rn(__fmul_rn((float)v[u].v[j], a[j]), bb[j]);
          const float t = __fmul_rn(h, 1.f / (1.f + expf(-h)));
          if constexpr (sizeof(O) == 1)
            o.v[j] = (int8_t)quant8(t, os, ro);
          else
            o.v[j] = from_f32<O>(t);
        }
        *reinterpret_cast<Pack<O, V>*>(y + off + row * p.C + c0) = o;
      }
    }
  }
}

template <int V, int NS>
int launch_int8(const int8_t* x, QScale qs, void* y, const float* weight,
                const float* bias, double* part, float* coef,
                const float* out_scale, int out_dtype, int B, int threads,
                float eps, const Plan& p, cudaStream_t stream) {
  const dim3 grid(p.n_blocks, B);
  const size_t smem = sizeof(double) * 2 * p.rows_per_iter * p.nvc * NS;
  gnq_stats<V, NS><<<grid, threads, smem, stream>>>(x, qs, part, p);
  const int warps = B * p.G;
  gnq_merge<<<(warps + 7) / 8, 256, 0, stream>>>(part, qs, weight, bias,
                                                  coef, B, p, eps);
  if (out_dtype == CVVAE_I8)
    gnq_apply<int8_t, V><<<grid, threads, 0, stream>>>(x, (int8_t*)y, coef,
                                                        out_scale, p);
  else if (out_dtype == CVVAE_BF16)
    gnq_apply<__nv_bfloat16, V><<<grid, threads, 0, stream>>>(
        x, (__nv_bfloat16*)y, coef, out_scale, p);
  else
    gnq_apply<float, V><<<grid, threads, 0, stream>>>(x, (float*)y, coef,
                                                       out_scale, p);
  return (int)cudaGetLastError();
}

// what one entry launches: the whole norm (gn_stats, gn_merge, gn_apply),
// one rank's partial moments (gn_stats, gn_partial), or the cross-rank
// combination and the apply (gn_combine, gn_apply)
enum Mode { kWhole = 0, kPartial = 1, kCombine = 2 };

struct Args {
  const void* x;
  void* y;
  const float* weight;
  const float* bias;
  double* part;
  float* coef;
  float* stats;
  double* moments;  // (B, G, 3) for kPartial, (R, B, G, 3) for kCombine
  int R;
  int B;
  int threads;
  float eps;
  int silu;
};

template <typename T, int V, int NS>
int launch(Mode mode, const Args& a, const Plan& p, cudaStream_t stream) {
  const dim3 grid(p.n_blocks, a.B);
  const int warps = a.B * p.G;
  if (mode != kCombine) {
    const size_t smem = sizeof(double) * 2 * p.rows_per_iter * p.nvc * NS;
    gn_stats<T, V, NS><<<grid, a.threads, smem, stream>>>((const T*)a.x,
                                                           a.part, p);
  }
  if (mode == kPartial) {
    gn_partial<T><<<(warps + 7) / 8, 256, 0, stream>>>((const T*)a.x, a.part,
                                                        a.moments, a.B, p);
    return (int)cudaGetLastError();
  }
  if (mode == kWhole)
    gn_merge<T><<<(warps + 7) / 8, 256, 0, stream>>>(
        (const T*)a.x, a.part, a.weight, a.bias, a.coef, a.stats, a.B, p,
        a.eps);
  else
    gn_combine<<<(warps + 7) / 8, 256, 0, stream>>>(
        a.moments, a.R, a.weight, a.bias, a.coef, a.stats, a.B, p, a.eps);
  if (a.silu)
    gn_apply<T, V, true><<<grid, a.threads, 0, stream>>>((const T*)a.x,
                                                          (T*)a.y, a.coef, p);
  else
    gn_apply<T, V, false><<<grid, a.threads, 0, stream>>>((const T*)a.x,
                                                           (T*)a.y, a.coef, p);
  return (int)cudaGetLastError();
}

// the (V, NS) pairs the plan may choose: V the widest of {16 bytes, 2, 1}
// elements that divides C and is a divisor or a multiple of C / G
template <typename T>
int dispatch(int V, int NS, Mode mode, const Args& a, const Plan& p,
             cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
#define CVVAE_GN(v, ns) \
  if (V == v && NS == ns) return launch<T, v, ns>(mode, a, p, s);
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

// the plan's checks, shared by the three entries; 0 or an error code
int make_plan(int B, int64_t S, int C, int G, int V, int NS, int threads,
              int64_t rows_per_block, int n_blocks, Plan* p) {
  if (B <= 0 || B > 65535 || S <= 0 || G <= 0 || C % G != 0 || C > 1024 ||
      V <= 0 || C % V != 0 || NS <= 0 || V % NS != 0 || threads % 32 != 0 ||
      threads > (V > 2 ? 256 : 1024) || C / V > threads ||
      rows_per_block <= 0 || n_blocks <= 0 ||
      (int64_t)n_blocks * rows_per_block < S)
    return (int)cudaErrorInvalidValue;
  const int cg = C / G;
  if (NS > 1 ? V / NS != cg : cg % V != 0) return (int)cudaErrorInvalidValue;
  *p = Plan{S, C, G, cg, C / V, threads / (C / V), rows_per_block, n_blocks};
  return 0;
}

int run(Mode mode, const Args& a, int64_t S, int C, int G, int dtype, int V,
        int NS, int64_t rows_per_block, int n_blocks, int device,
        void* stream) {
  Plan p;
  const int rc = make_plan(a.B, S, C, G, V, NS, a.threads, rows_per_block,
                           n_blocks, &p);
  if (rc != 0) return rc;
  if (mode == kCombine && (a.R <= 0 || a.moments == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    return dispatch<__nv_bfloat16>(V, NS, mode, a, p, s);
  if (dtype == CVVAE_F32) return dispatch<float>(V, NS, mode, a, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: (B, S, C) contiguous, 16-byte aligned, dtype f32 or bf16.
// weight, bias: (C,) f32.  part: (B, n_blocks, G, 2) f64 scratch.  coef:
// (B, 2, C) f32 scratch.  stats: NULL, or (B, G, 2) f32 that receives each
// (batch row, group)'s mean and 1/std for the backward pass.  The plan (V,
// NS, threads, rows_per_block, n_blocks) comes from
// ops/kernels/groupnorm.py::launch_plan and is checked here.
CVVAE_EXPORT int cvvae_group_norm(const void* x, void* y, const void* weight,
                                  const void* bias, void* part, void* coef,
                                  void* stats, int B, int64_t S, int C, int G,
                                  float eps,
                                  int silu, int dtype, int V, int NS,
                                  int threads, int64_t rows_per_block,
                                  int n_blocks, int device, void* stream) {
  const Args a{x, y, (const float*)weight, (const float*)bias, (double*)part,
               (float*)coef, (float*)stats, nullptr, 0, B, threads, eps,
               silu};
  return run(kWhole, a, S, C, G, dtype, V, NS, rows_per_block, n_blocks,
             device, stream);
}

// One rank's share of a norm split across ranks: x as above (this rank's
// rows), part as above, moments: (B, G, 3) f64 that receives each (batch
// row, group)'s count, mean and M2 over this rank's rows.
CVVAE_EXPORT int cvvae_group_norm_partial(const void* x, void* part,
                                          void* moments, int B, int64_t S,
                                          int C, int G, int dtype, int V,
                                          int NS, int threads,
                                          int64_t rows_per_block,
                                          int n_blocks, int device,
                                          void* stream) {
  const Args a{x, nullptr, nullptr, nullptr, (double*)part, nullptr,
               nullptr, (double*)moments, 0, B, threads, 0.f, 0};
  return run(kPartial, a, S, C, G, dtype, V, NS, rows_per_block, n_blocks,
             device, stream);
}

// The rest of it: moments: (R, B, G, 3) f64, every rank's partial in rank
// order; x, y, weight, bias, coef, stats and the plan as cvvae_group_norm's.
CVVAE_EXPORT int cvvae_group_norm_combine(const void* x, void* y,
                                          const void* weight,
                                          const void* bias,
                                          const void* moments, int R,
                                          void* coef, void* stats, int B,
                                          int64_t S, int C, int G, float eps,
                                          int silu, int dtype, int V, int NS,
                                          int threads,
                                          int64_t rows_per_block,
                                          int n_blocks, int device,
                                          void* stream) {
  const Args a{x, y, (const float*)weight, (const float*)bias, nullptr,
               (float*)coef, (float*)stats, (double*)moments, R, B, threads,
               eps, silu};
  return run(kCombine, a, S, C, G, dtype, V, NS, rows_per_block, n_blocks,
             device, stream);
}

// The int8 mode: x (B, S, C) int8 contiguous, 16-byte aligned; scale: a
// device fp32 scalar (per_channel 0) or (C,) (per_channel 1); y (B, S, C)
// in out_dtype (CVVAE_I8, requantized at the device fp32 scalar
// out_scale, or CVVAE_BF16 / CVVAE_F32); weight, bias (C,) fp32; part and
// coef scratch as cvvae_group_norm's.  SiLU always (qgroup_norm_silu).  The
// plan comes from ops/kernels/groupnorm.py::launch_plan with 1-byte
// elements.
CVVAE_EXPORT int cvvae_group_norm_int8(const void* x, const void* scale,
                                       int per_channel, void* y,
                                       const void* weight, const void* bias,
                                       void* part, void* coef,
                                       const void* out_scale, int B,
                                       int64_t S, int C, int G, float eps,
                                       int out_dtype, int V, int NS,
                                       int threads, int64_t rows_per_block,
                                       int n_blocks, int device,
                                       void* stream) {
  Plan p;
  const int rc = make_plan(B, S, C, G, V, NS, threads, rows_per_block,
                           n_blocks, &p);
  if (rc != 0) return rc;
  if ((out_dtype == CVVAE_I8) != (out_scale != nullptr) ||
      (out_dtype != CVVAE_I8 && out_dtype != CVVAE_BF16 &&
       out_dtype != CVVAE_F32) ||
      (per_channel != 0 && per_channel != 1))
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const QScale qs{(const float*)scale, per_channel};
  const auto* xi = (const int8_t*)x;
#define CVVAE_GNQ(v, ns)                                                   \
  if (V == v && NS == ns)                                                  \
    return launch_int8<v, ns>(xi, qs, y, (const float*)weight,             \
                              (const float*)bias, (double*)part,           \
                              (float*)coef, (const float*)out_scale,       \
                              out_dtype, B, threads, eps, p, s);
  CVVAE_GNQ(16, 1)
  CVVAE_GNQ(16, 2)
  CVVAE_GNQ(16, 4)
  CVVAE_GNQ(16, 8)
  CVVAE_GNQ(2, 1)
  CVVAE_GNQ(2, 2)
  CVVAE_GNQ(1, 1)
#undef CVVAE_GNQ
  return (int)cudaErrorInvalidValue;
}
