// K1: GroupNorm (+ optional SiLU) over a contiguous (B, S, C) view.
//
// Replaces cvvae_tpu/ops/pallas/groupnorm.py::group_norm_silu_pallas.
// The TPU kernel carries its statistics across a sequential grid; blocks
// here run in parallel in no order, so the reduction is three launches,
// deterministic and without atomics:
//   1. gn_partial: one block per (batch, S-chunk) reads whole C rows and
//      writes each group's chunk mean and M2 (sums of a shifted value, so
//      a large mean does not cancel the variance);
//   2. gn_finalize: one block per batch merges the chunks in a fixed order
//      with Chan's pairwise formula (in double) and folds mean, inv, scale
//      and bias into a per-channel affine a, b;
//   3. gn_apply: y = x * a + b (fp32, one rounding), then SiLU.
// Bound: device memory, 2 reads + 1 write of x; no tensor cores.
#include "common.cuh"

namespace {

constexpr int kTX = 64;       // threads across channels
constexpr int kTY = 4;        // threads across rows
constexpr int kMaxCols = 16;  // channels per thread -> C <= 1024

template <typename T>
__global__ void __launch_bounds__(kTX* kTY)
    gn_partial(const T* __restrict__ x, float* __restrict__ part, int64_t S,
               int C, int G, int64_t rows_per_chunk, int n_chunks) {
  __shared__ float ssum[kTY * 1024];
  __shared__ float ssq[kTY * 1024];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int cg = C / G;
  const int64_t r0 = (int64_t)chunk * rows_per_chunk;
  const int64_t r1 = min_i64(S, r0 + rows_per_chunk);
  const T* xb = x + (int64_t)b * S * C;

  float shift[kMaxCols], s[kMaxCols], q[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = tx + k * kTX;
    shift[k] = c < C ? to_f32(xb[r0 * C + (c / cg) * cg]) : 0.f;
    s[k] = 0.f;
    q[k] = 0.f;
  }
  for (int64_t r = r0 + ty; r < r1; r += kTY) {
    const T* row = xb + r * C;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int c = tx + k * kTX;
      if (c < C) {
        const float v = to_f32(row[c]) - shift[k];
        s[k] += v;
        q[k] += v * v;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = tx + k * kTX;
    if (c < C) {
      ssum[ty * C + c] = s[k];
      ssq[ty * C + c] = q[k];
    }
  }
  __syncthreads();
  const int tid = ty * kTX + tx;
  for (int g = tid; g < G; g += kTX * kTY) {
    float gs = 0.f, gq = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c)
      for (int y = 0; y < kTY; ++y) {
        gs += ssum[y * C + c];
        gq += ssq[y * C + c];
      }
    const float n = (float)((r1 - r0) * cg);
    const float mean_shifted = gs / n;
    float* out = part + (((int64_t)b * n_chunks + chunk) * G + g) * 2;
    out[0] = to_f32(xb[r0 * C + g * cg]) + mean_shifted;
    out[1] = fmaxf(gq - gs * mean_shifted, 0.f);
  }
}

__global__ void gn_finalize(const float* __restrict__ part,
                            const float* __restrict__ weight,
                            const float* __restrict__ bias,
                            float* __restrict__ coef, int64_t S, int C, int G,
                            int64_t rows_per_chunk, int n_chunks, float eps) {
  __shared__ float stat[2 * 1024];  // mean[G], inv[G]
  const int b = blockIdx.x;
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    double n_a = 0.0, mean = 0.0, m2 = 0.0;
    for (int k = 0; k < n_chunks; ++k) {
      const float* p = part + (((int64_t)b * n_chunks + k) * G + g) * 2;
      const int64_t rows = min_i64(rows_per_chunk, S - (int64_t)k * rows_per_chunk);
      const double n_b = (double)(rows * cg);
      const double n = n_a + n_b;
      const double delta = (double)p[0] - mean;
      mean += delta * (n_b / n);
      m2 += (double)p[1] + delta * delta * (n_a * n_b / n);
      n_a = n;
    }
    stat[g] = (float)mean;
    stat[G + g] = rsqrtf((float)(m2 / n_a) + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float a = stat[G + g] * weight[c];
    coef[(int64_t)b * 2 * C + c] = a;
    coef[(int64_t)b * 2 * C + C + c] = bias[c] - stat[g] * a;
  }
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kTX* kTY)
    gn_apply(const T* __restrict__ x, T* __restrict__ y,
             const float* __restrict__ coef, int64_t S, int C,
             int64_t n_rows) {
  for (int64_t r = (int64_t)blockIdx.x * kTY + threadIdx.y; r < n_rows;
       r += (int64_t)gridDim.x * kTY) {
    const int64_t b = r / S;
    const float* a = coef + b * 2 * C;
    const float* bb = a + C;
    const T* xr = x + r * C;
    T* yr = y + r * C;
    for (int c = threadIdx.x; c < C; c += kTX) {
      float v = to_f32(xr[c]) * a[c] + bb[c];
      if (kSilu) v = v / (1.f + __expf(-v));
      yr[c] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, const float* weight, const float* bias,
           float* part, float* coef, int64_t B, int64_t S, int C, int G,
           float eps, int silu, int64_t rows_per_chunk, int n_chunks,
           cudaStream_t stream) {
  const dim3 block(kTX, kTY);
  gn_partial<T><<<dim3(n_chunks, B), block, 0, stream>>>(
      (const T*)x, part, S, C, G, rows_per_chunk, n_chunks);
  gn_finalize<<<B, 256, 0, stream>>>(part, weight, bias, coef, S, C, G,
                                     rows_per_chunk, n_chunks, eps);
  const int64_t n_rows = B * S;
  const int64_t want = (n_rows + kTY - 1) / kTY;
  const int grid = (int)min_i64(want, 132 * 64);
  if (silu)
    gn_apply<T, true><<<grid, block, 0, stream>>>((const T*)x, (T*)y, coef,
                                                   S, C, n_rows);
  else
    gn_apply<T, false><<<grid, block, 0, stream>>>((const T*)x, (T*)y, coef,
                                                    S, C, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, S, C) contiguous, dtype f32 or bf16.  weight, bias: (C,) f32.
// part: (B, n_chunks, G, 2) f32 scratch.  coef: (B, 2, C) f32 scratch.
CVVAE_EXPORT int cvvae_group_norm(const void* x, void* y, const void* weight,
                                  const void* bias, void* part, void* coef,
                                  int64_t B, int64_t S, int C, int G,
                                  float eps, int silu, int dtype,
                                  int64_t rows_per_chunk, int n_chunks,
                                  int device, void* stream) {
  if (C % G != 0 || C > kTX * kMaxCols || G > 1024) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    return launch<__nv_bfloat16>(x, y, (const float*)weight,
                                 (const float*)bias, (float*)part,
                                 (float*)coef, B, S, C, G, eps, silu,
                                 rows_per_chunk, n_chunks, s);
  if (dtype == CVVAE_F32)
    return launch<float>(x, y, (const float*)weight, (const float*)bias,
                         (float*)part, (float*)coef, B, S, C, G, eps, silu,
                         rows_per_chunk, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}
