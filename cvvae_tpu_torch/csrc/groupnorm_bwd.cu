// K1.bwd: the gradient of GroupNorm (+ optional SiLU) over a contiguous
// (B, S, C) view, given the forward's saved (mean, 1/std) of each (batch
// row, group).
//
// The TPU package differentiates group_norm + silu with XLA's autodiff;
// this is the hand-written counterpart of K1 (csrc/groupnorm.cu).  With
// xh = (x - mean) / std, z = xh * gamma + beta and dz = dy * silu'(z) (dz
// = dy without SiLU):
//   dbeta_c  = sum dz,  dgamma_c = sum dz * xh          (over rows and S)
//   A = sum dz * gamma, B = sum dz * gamma * xh          (per row, group)
//   dx = (1/std) * (dz * gamma - (A + xh * B) / N),  N = S * C / G.
// A and B are per-group sums of gamma times the per-channel sums, so one
// read of x and dy gives everything but dx.  Four launches on K1's plan
// (ops/kernels/groupnorm.py::launch_plan), deterministic, no atomics:
//   1. gn_bwd_partial: the forward's grid; thread (tx, ty) owns one
//      V-channel vector of every ty-th row of its block's run of rows and
//      sums dz and dz * xh for its channels in fp32; the block folds its
//      rows in a fixed order through shared memory and writes one (sum dz,
//      sum dz * xh) per channel.
//   2. gn_bwd_merge: one warp per (batch row, group) adds the blocks' sums
//      of each channel in a fixed order, in double; keeps them per (row,
//      channel) for dgamma and dbeta; folds A and B and writes each
//      channel's apply coefficients: a = gamma / std, b = beta - mean * a
//      (z = x * a + b, as the forward computes it), q = -B / (std^2 N),
//      the mean, and r = -A / (std N), so dx = a * dz + q * (x - mean) + r.
//   3. gn_bwd_params: one thread per channel adds the rows' sums in order.
//   4. gn_bwd_apply: the forward's grid again; reads x and dy, writes dx.
// Bound: device memory.  Each of x and dy is read once and dx written once
// at the least (3 tensors); this design reads x and dy twice (the sums must
// be complete before the first dx), 5 tensors' worth of traffic.
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // loads of x and of dy in flight per thread

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// K1's plan (ops/kernels/groupnorm.py::launch_plan)
struct Plan {
  int64_t S;
  int C, G, cg;
  int nvc;              // C / V
  int rows_per_iter;    // threads / nvc
  int64_t rows_per_block;
  int n_blocks;
};

template <int V>
constexpr int max_threads() {
  return V > 2 ? 256 : 1024;
}

__device__ __forceinline__ float dsilu(float d, float z) {
  const float s = 1.f / (1.f + __expf(-z));
  return d * s * (1.f + z * (1.f - s));
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(max_threads<V>())
    gn_bwd_partial(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ stats,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ part,
                   Plan p) {
  extern __shared__ float sh[];  // [rows_per_iter][C][2]
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int64_t off = (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  float mean[V], inv[V], a[V], bb[V], s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int g = (c0 + j) / p.cg;
    mean[j] = stats[((int64_t)b * p.G + g) * 2];
    inv[j] = stats[((int64_t)b * p.G + g) * 2 + 1];
    a[j] = inv[j] * weight[c0 + j];
    bb[j] = bias[c0 + j] - mean[j] * a[j];
    s1[j] = 0.f;
    s2[j] = 0.f;
  }
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;
  if (ty < p.rows_per_iter) {
    for (int64_t r = r0 + ty; r < r1; r += step) {
      Pack<T, V> xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row = r + (int64_t)u * p.rows_per_iter;
        if (row < r1) {
          xv[u] = *reinterpret_cast<const Pack<T, V>*>(x + off + row * p.C + c0);
          gv[u] = *reinterpret_cast<const Pack<T, V>*>(dy + off + row * p.C + c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + (int64_t)u * p.rows_per_iter < r1) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xf = to_f32(xv[u].v[j]);
            float dz = to_f32(gv[u].v[j]);
            if (kSilu) dz = dsilu(dz, fmaf(xf, a[j], bb[j]));
            s1[j] += dz;
            s2[j] = fmaf(dz, (xf - mean[j]) * inv[j], s2[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sh[((int64_t)ty * p.C + c0 + j) * 2] = s1[j];
      sh[((int64_t)ty * p.C + c0 + j) * 2 + 1] = s2[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int y = 0; y < p.rows_per_iter; ++y) {
      t1 += sh[((int64_t)y * p.C + c) * 2];
      t2 += sh[((int64_t)y * p.C + c) * 2 + 1];
    }
    float* out = part + (((int64_t)b * p.n_blocks + blk) * p.C + c) * 2;
    out[0] = t1;
    out[1] = t2;
  }
}

// one warp per (batch row, group)
__global__ void gn_bwd_merge(const float* __restrict__ part,
                             const float* __restrict__ stats,
                             const float* __restrict__ weight,
                             const float* __restrict__ bias,
                             double* __restrict__ rowsum,
                             float* __restrict__ coef, int B, Plan p) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  double A = 0.0, Bs = 0.0;
  for (int c = g * p.cg; c < (g + 1) * p.cg; ++c) {
    double t1 = 0.0, t2 = 0.0;
    for (int k = lane; k < p.n_blocks; k += 32) {
      const float* q = part + (((int64_t)b * p.n_blocks + k) * p.C + c) * 2;
      t1 += (double)q[0];
      t2 += (double)q[1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, o);
      t2 += __shfl_xor_sync(0xffffffffu, t2, o);
    }
    if (lane == 0) {
      rowsum[((int64_t)b * p.C + c) * 2] = t1;
      rowsum[((int64_t)b * p.C + c) * 2 + 1] = t2;
    }
    A += (double)weight[c] * t1;
    Bs += (double)weight[c] * t2;
  }
  const float mean = stats[((int64_t)b * p.G + g) * 2];
  const float inv = stats[((int64_t)b * p.G + g) * 2 + 1];
  const double n = (double)p.S * p.cg;
  const float q = (float)(-Bs * inv * inv / n);
  const float r = (float)(-A * inv / n);
  float* cb = coef + (int64_t)b * 5 * p.C;
  for (int c = g * p.cg + lane; c < (g + 1) * p.cg; c += 32) {
    const float a = inv * weight[c];
    cb[c] = a;
    cb[p.C + c] = bias[c] - mean * a;
    cb[2 * p.C + c] = q;
    cb[3 * p.C + c] = mean;
    cb[4 * p.C + c] = r;
  }
}

__global__ void gn_bwd_params(const double* __restrict__ rowsum,
                              float* __restrict__ dweight,
                              float* __restrict__ dbias, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double t1 = 0.0, t2 = 0.0;
  for (int b = 0; b < B; ++b) {
    t1 += rowsum[((int64_t)b * C + c) * 2];
    t2 += rowsum[((int64_t)b * C + c) * 2 + 1];
  }
  dbias[c] = (float)t1;
  dweight[c] = (float)t2;
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(max_threads<V>())
    gn_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ coef, T* __restrict__ dx, Plan p) {
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  if (ty >= p.rows_per_iter) return;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int64_t off = (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  const float* cb = coef + (int64_t)b * 5 * p.C;
  float a[V], bb[V], q[V], m[V], r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = cb[c0 + j];
    bb[j] = cb[p.C + c0 + j];
    q[j] = cb[2 * p.C + c0 + j];
    m[j] = cb[3 * p.C + c0 + j];
    r[j] = cb[4 * p.C + c0 + j];
  }
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;
  for (int64_t row0 = r0 + ty; row0 < r1; row0 += step) {
    Pack<T, V> xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = row0 + (int64_t)u * p.rows_per_iter;
      if (row < r1) {
        xv[u] = *reinterpret_cast<const Pack<T, V>*>(x + off + row * p.C + c0);
        gv[u] = *reinterpret_cast<const Pack<T, V>*>(dy + off + row * p.C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = row0 + (int64_t)u * p.rows_per_iter;
      if (row < r1) {
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xf = to_f32(xv[u].v[j]);
          float dz = to_f32(gv[u].v[j]);
          if (kSilu) dz = dsilu(dz, fmaf(xf, a[j], bb[j]));
          o.v[j] = from_f32<T>(fmaf(a[j], dz, fmaf(q[j], xf - m[j], r[j])));
        }
        *reinterpret_cast<Pack<T, V>*>(dx + off + row * p.C + c0) = o;
      }
    }
  }
}

template <typename T, int V>
int launch(const void* x, const void* dy, const float* stats,
           const float* weight, const float* bias, void* dx, float* dweight,
           float* dbias, float* part, double* rowsum, float* coef, int B,
           const Plan& p, int threads, int silu, cudaStream_t s) {
  const dim3 grid(p.n_blocks, B);
  const size_t smem = sizeof(float) * 2 * p.rows_per_iter * p.C;
  if (silu)
    gn_bwd_partial<T, V, true><<<grid, threads, smem, s>>>(
        (const T*)x, (const T*)dy, stats, weight, bias, part, p);
  else
    gn_bwd_partial<T, V, false><<<grid, threads, smem, s>>>(
        (const T*)x, (const T*)dy, stats, weight, bias, part, p);
  const int warps = B * p.G;
  gn_bwd_merge<<<(warps + 7) / 8, 256, 0, s>>>(part, stats, weight, bias,
                                              rowsum, coef, B, p);
  gn_bwd_params<<<(p.C + 255) / 256, 256, 0, s>>>(rowsum, dweight, dbias, B,
                                                  p.C);
  if (silu)
    gn_bwd_apply<T, V, true><<<grid, threads, 0, s>>>(
        (const T*)x, (const T*)dy, coef, (T*)dx, p);
  else
    gn_bwd_apply<T, V, false><<<grid, threads, 0, s>>>(
        (const T*)x, (const T*)dy, coef, (T*)dx, p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int V, const void* x, const void* dy, const float* stats,
             const float* w, const float* bi, void* dx, float* dw, float* db,
             float* part, double* rowsum, float* coef, int B, const Plan& p,
             int threads, int silu, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (V == kV)
    return launch<T, kV>(x, dy, stats, w, bi, dx, dw, db, part, rowsum, coef,
                         B, p, threads, silu, s);
  if (V == 2)
    return launch<T, 2>(x, dy, stats, w, bi, dx, dw, db, part, rowsum, coef,
                        B, p, threads, silu, s);
  if (V == 1)
    return launch<T, 1>(x, dy, stats, w, bi, dx, dw, db, part, rowsum, coef,
                        B, p, threads, silu, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx: (B, S, C) contiguous, aligned to V elements, dtype f32 or
// bf16.  stats: (B, G, 2) f32 from cvvae_group_norm.  weight, bias: (C,)
// f32.  dweight, dbias: (C,) f32 out.  part: (B, n_blocks, C, 2) f32,
// rowsum: (B, C, 2) f64, coef: (B, 5, C) f32 scratch.  The plan is K1's
// (ops/kernels/groupnorm.py::launch_plan).
CVVAE_EXPORT int cvvae_group_norm_bwd(
    const void* x, const void* dy, const void* stats, const void* weight,
    const void* bias, void* dx, void* dweight, void* dbias, void* part,
    void* rowsum, void* coef, int B, int64_t S, int C, int G, int silu,
    int dtype, int V, int threads, int64_t rows_per_block, int n_blocks,
    int device, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || G <= 0 || C % G != 0 || C > 1024 ||
      V <= 0 || C % V != 0 || threads % 32 != 0 ||
      threads > (V > 2 ? 256 : 1024) || C / V > threads ||
      rows_per_block <= 0 || n_blocks <= 0 ||
      (int64_t)n_blocks * rows_per_block < S)
    return (int)cudaErrorInvalidValue;
  Plan p{S, C, G, C / G, C / V, threads / (C / V), rows_per_block, n_blocks};
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    return dispatch<__nv_bfloat16>(
        V, x, dy, (const float*)stats, (const float*)weight,
        (const float*)bias, dx, (float*)dweight, (float*)dbias, (float*)part,
        (double*)rowsum, (float*)coef, B, p, threads, silu, s);
  if (dtype == CVVAE_F32)
    return dispatch<float>(
        V, x, dy, (const float*)stats, (const float*)weight,
        (const float*)bias, dx, (float*)dweight, (float*)dbias, (float*)part,
        (double*)rowsum, (float*)coef, B, p, threads, silu, s);
  return (int)cudaErrorInvalidValue;
}
