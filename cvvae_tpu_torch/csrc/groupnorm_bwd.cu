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
// read of x and dy gives everything but dx.
//
// Bound: device memory.  Each of x and dy is read once and dx written
// once at the least (3 tensors); the sums must be complete before the
// first dx, so x and dy are read twice.  Where x and dy fit in the 50 MB
// L2 the second read comes from there; where they do not, the apply pass
// walks each block's rows backwards, so it starts on the rows the first
// pass read last, which L2 still holds.
//
// One cooperative launch (cudaLaunchCooperativeKernel) of a persistent
// grid that the plan (ops/kernels/groupnorm.py::backward_plan) sizes to
// what the card holds at once, with two grid-wide barriers:
//   1. partial sums: a tile is a chunk of rows of one batch row (at least
//      kMinRows rows where S allows, so the partial sums stay a small
//      fraction of x); the block walks its tiles.  Thread (tx, ty) owns
//      one V-channel vector of every ty-th row of the tile and sums dz
//      and dz * (x - mean) in fp32; the block folds its rows in a fixed
//      order through shared memory and writes one pair per channel.
//   2. merge, after the first barrier: one warp per (batch row, channel)
//      adds the tile's chunks lane-strided, then by a fixed shuffle tree,
//      in double; lane 0 keeps (sum dz, sum dz * xh) of the row.
//   3. after the second barrier: the first blocks add the rows' sums of
//      each channel in row order into dgamma and dbeta; every block folds
//      A and B of its batch row's groups (one warp a group, fixed order)
//      into the apply coefficients z = x * a + b (as the forward computes
//      it), dx = a * dz + q * x + r, q = -B / (std^2 N), r = -A / (std N)
//      - q * mean, and writes dx.
// Deterministic: no atomics on any sum; every order is fixed by the plan.
// The SiLU derivative takes one transcendental an element a pass: in bf16
// sigma(z) = (1 + tanh(z/2)) / 2 on tanh.approx, in fp32 one rounded
// reciprocal of 1 + exp(-z).
#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

namespace coop = cooperative_groups;

namespace {

// loads of x and of dy in flight per thread: 4 of 16 bytes, 2 where V is
// 8 (bf16), whose 8 channels' constants and sums fill the registers
constexpr int kUnroll = 4;
constexpr int kUnrollBf16 = 2;
// threads of this kernel an SM holds at once: the plan counts SMs * max(1,
// kResidentThreads / threads) resident blocks, and __launch_bounds__ keeps
// the registers within that
constexpr int kResidentThreads = 512;
// rows a tile at the least, where S has them (ops/kernels/groupnorm.py)
constexpr int kMinRows = 32;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the plan, made by ops/kernels/groupnorm.py::backward_plan and passed by
// value (_build.GroupNormBwdPlan mirrors it)
struct Plan {
  int64_t S;               // rows of a batch row
  int64_t rows_per_chunk;  // rows of a tile
  int B, C, G;
  int V, threads;
  int n_chunks;     // tiles of a batch row: tile t is (t / n_chunks, t % n_chunks)
  int grid;         // blocks, all resident
  int silu;
  int dtype, wdtype;  // x, dy, dx; weight, bias, dweight, dbias
  int stat_stride;    // elements from one (row, group)'s mean to the next's
  int device;
};

template <typename W>
struct Args {
  const void* x;
  const void* dy;
  const float* mean;  // (B, G) at stat_stride; 1/std likewise
  const float* inv;
  const W* weight;
  const W* bias;
  void* dx;
  W* dparams;      // (2, C): dweight, then dbias
  float* part;     // (B, C, n_chunks, 2): each tile's sum dz, sum dz*(x-mean)
  double* rowsum;  // (B, C, 2): sum dz, sum dz*xh of each row
  Plan p;
};

template <int V>
__host__ __device__ constexpr int unroll() {
  return V == 8 ? kUnrollBf16 : kUnroll;
}

template <int V>
constexpr int max_threads() {
  return V > 2 ? 256 : 1024;
}

template <int V>
constexpr int min_blocks() {
  return kResidentThreads / max_threads<V>() > 0
             ? kResidentThreads / max_threads<V>()
             : 1;
}

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// dy * silu'(z) = dy * s * (1 + z (1 - s)), s = sigmoid(z)
template <typename T>
__device__ __forceinline__ float dsilu(float d, float z) {
  if constexpr (std::is_same<T, float>::value) {
    const float s = __frcp_rn(1.f + __expf(-z));
    return d * s * (1.f + z * (1.f - s));
  } else {
    // s = (1 + t) / 2 and z (1 - s) = h (1 - t), t = tanh(h), h = z / 2
    const float h = 0.5f * z;
    const float t = tanh_approx(h);
    return d * fmaf(0.5f, t, 0.5f) * fmaf(h, 1.f - t, 1.f);
  }
}

// z's affine (a, b) and the mean of each of the thread's V channels in
// batch row b
template <typename W, int V>
__device__ __forceinline__ void load_affine(const Args<W>& A, int b, int c0,
                                            float (&a)[V], float (&bb)[V],
                                            float (&m)[V]) {
  const int cg = A.p.C / A.p.G;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j;
    const int64_t si = ((int64_t)b * A.p.G + c / cg) * A.p.stat_stride;
    m[j] = A.mean[si];
    a[j] = A.inv[si] * to_f32(A.weight[c]);
    bb[j] = to_f32(A.bias[c]) - m[j] * a[j];
  }
}

// fn(xv, gv, row) over the thread's rows of [r0, r1), unroll<V>() loads
// of each of x and dy in flight; backwards where kReverse
template <typename T, int V, bool kReverse, typename Fn>
__device__ __forceinline__ void for_rows(const T* x, const T* dy, int64_t r0,
                                         int64_t r1, int ty,
                                         int rows_per_iter, int64_t C, int c0,
                                         Fn&& fn) {
  constexpr int U = unroll<V>();
  const int64_t step = (int64_t)rows_per_iter * U;
  const int64_t n_steps = (r1 - r0 + step - 1) / step;
  for (int64_t i = 0; i < n_steps; ++i) {
    const int64_t row0 = r0 + (kReverse ? n_steps - 1 - i : i) * step + ty;
    Pack<T, V> xv[U], gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t row = row0 + (int64_t)u * rows_per_iter;
      if (row < r1) {
        xv[u] = *reinterpret_cast<const Pack<T, V>*>(x + row * C + c0);
        gv[u] = *reinterpret_cast<const Pack<T, V>*>(dy + row * C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t row = row0 + (int64_t)u * rows_per_iter;
      if (row < r1) fn(xv[u], gv[u], row);
    }
  }
}

template <typename T, typename W, int V, bool kSilu>
__global__ void __launch_bounds__(max_threads<V>(), min_blocks<V>())
    gn_bwd(const Args<W> A) {
  extern __shared__ float sh[];  // [rows_per_iter][C][2]; later [G][2]
  const Plan& p = A.p;
  const T* x = static_cast<const T*>(A.x);
  const T* dy = static_cast<const T*>(A.dy);
  const int nvc = p.C / V;
  const int rows_per_iter = p.threads / nvc;
  const int tx = threadIdx.x % nvc, ty = threadIdx.x / nvc;
  const bool active = ty < rows_per_iter;
  const int c0 = tx * V;
  const int cg = p.C / p.G;
  const int n_tiles = p.B * p.n_chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  coop::grid_group grid = coop::this_grid();

  // 1. each tile's partial sums
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / p.n_chunks, k = t % p.n_chunks;
    const int64_t r0 = (int64_t)k * p.rows_per_chunk;
    const int64_t r1 = min_i64(p.S, r0 + p.rows_per_chunk);
    const int64_t off = (int64_t)b * p.S * p.C;
    if (active) {
      float a[V], bb[V], m[V], s1[V], s2[V];
      load_affine<W, V>(A, b, c0, a, bb, m);
#pragma unroll
      for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
      for_rows<T, V, false>(
          x + off, dy + off, r0, r1, ty, rows_per_iter, p.C, c0,
          [&](const Pack<T, V>& xv, const Pack<T, V>& gv, int64_t) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const float xf = to_f32(xv.v[j]);
              float dz = to_f32(gv.v[j]);
              if (kSilu) dz = dsilu<T>(dz, fmaf(xf, a[j], bb[j]));
              s1[j] += dz;
              s2[j] = fmaf(dz, xf - m[j], s2[j]);
            }
          });
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sh[((int64_t)ty * p.C + c0 + j) * 2] = s1[j];
        sh[((int64_t)ty * p.C + c0 + j) * 2 + 1] = s2[j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
      float t1 = 0.f, t2 = 0.f;
      for (int y = 0; y < rows_per_iter; ++y) {
        t1 += sh[((int64_t)y * p.C + c) * 2];
        t2 += sh[((int64_t)y * p.C + c) * 2 + 1];
      }
      float* out = A.part + (((int64_t)b * p.C + c) * p.n_chunks + k) * 2;
      out[0] = t1;
      out[1] = t2;
    }
    __syncthreads();
  }
  grid.sync();  // every tile's partial sums are written

  // 2. merge: one warp per (batch row, channel), chunks in a fixed order
  for (int item = blockIdx.x * warps + warp; item < p.B * p.C;
       item += gridDim.x * warps) {
    const float* q = A.part + (int64_t)item * p.n_chunks * 2;
    double t1 = 0.0, t2 = 0.0;
    for (int k = lane; k < p.n_chunks; k += 32) {
      t1 += (double)q[2 * k];
      t2 += (double)q[2 * k + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, o);
      t2 += __shfl_xor_sync(0xffffffffu, t2, o);
    }
    if (lane == 0) {
      const int b = item / p.C, c = item % p.C;
      const double inv =
          A.inv[((int64_t)b * p.G + c / cg) * p.stat_stride];
      A.rowsum[(int64_t)item * 2] = t1;
      A.rowsum[(int64_t)item * 2 + 1] = t2 * inv;
    }
  }
  grid.sync();  // the rows' sums are complete

  // 3a. dweight and dbias: the rows' sums in row order
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < p.C;
       c += gridDim.x * blockDim.x) {
    double t1 = 0.0, t2 = 0.0;
    for (int b = 0; b < p.B; ++b) {
      t1 += A.rowsum[((int64_t)b * p.C + c) * 2];
      t2 += A.rowsum[((int64_t)b * p.C + c) * 2 + 1];
    }
    A.dparams[c] = from_f32<W>((float)t2);
    A.dparams[p.C + c] = from_f32<W>((float)t1);
  }

  // 3b. dx, the block's tiles in reverse order
  float* qr = sh;  // [G][2]: q, r of the batch row in hand
  const double n = (double)p.S * cg;
  int have = -1;
  const int last = blockIdx.x + (n_tiles - 1 - blockIdx.x) / gridDim.x *
                                    gridDim.x;
  for (int t = last; t >= 0; t -= gridDim.x) {
    const int b = t / p.n_chunks, k = t % p.n_chunks;
    if (b != have) {
      __syncthreads();  // the last row's q, r are read
      for (int g = warp; g < p.G; g += warps) {
        double sa = 0.0, sb = 0.0;
        for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
          const double w = to_f32(A.weight[c]);
          sa += w * A.rowsum[((int64_t)b * p.C + c) * 2];
          sb += w * A.rowsum[((int64_t)b * p.C + c) * 2 + 1];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, o);
          sb += __shfl_xor_sync(0xffffffffu, sb, o);
        }
        if (lane == 0) {
          const double inv = A.inv[((int64_t)b * p.G + g) * p.stat_stride];
          qr[2 * g] = (float)(-sb * inv * inv / n);
          qr[2 * g + 1] = (float)(-sa * inv / n);
        }
      }
      __syncthreads();
      have = b;
    }
    if (!active) continue;
    // dx = a * dz + q * x + r, r = r_g - q * mean
    float a[V], bb[V], q[V], r[V];
    load_affine<W, V>(A, b, c0, a, bb, r);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      q[j] = qr[2 * ((c0 + j) / cg)];
      r[j] = fmaf(-q[j], r[j], qr[2 * ((c0 + j) / cg) + 1]);
    }
    const int64_t r0 = (int64_t)k * p.rows_per_chunk;
    const int64_t r1 = min_i64(p.S, r0 + p.rows_per_chunk);
    const int64_t off = (int64_t)b * p.S * p.C;
    T* out = static_cast<T*>(A.dx) + off;
    for_rows<T, V, true>(
        x + off, dy + off, r0, r1, ty, rows_per_iter, p.C, c0,
        [&](const Pack<T, V>& xv, const Pack<T, V>& gv, int64_t row) {
          Pack<T, V> o;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xf = to_f32(xv.v[j]);
            float dz = to_f32(gv.v[j]);
            if (kSilu) dz = dsilu<T>(dz, fmaf(xf, a[j], bb[j]));
            o.v[j] = from_f32<T>(fmaf(a[j], dz, fmaf(q[j], xf, r[j])));
          }
          *reinterpret_cast<Pack<T, V>*>(out + row * p.C + c0) = o;
        });
  }
}

template <typename T, typename W, int V, bool kSilu>
int launch(const Args<W>& a, cudaStream_t s) {
  const Plan& p = a.p;
  const size_t fold = (size_t)(p.threads / (p.C / V)) * p.C * 2;
  const size_t smem = sizeof(float) * (fold > 2u * p.G ? fold : 2u * p.G);
  void* params[] = {const_cast<Args<W>*>(&a)};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&gn_bwd<T, W, V, kSilu>), dim3(p.grid),
      dim3(p.threads), params, smem, s);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

template <typename T, typename W, int V>
int launch_silu(const Args<W>& a, cudaStream_t s) {
  return a.p.silu ? launch<T, W, V, true>(a, s) : launch<T, W, V, false>(a, s);
}

template <typename T, typename W>
int dispatch(const void* x, const void* dy, const float* mean,
             const float* inv, const void* weight, const void* bias,
             void* dx, void* dparams, float* part, double* rowsum,
             const Plan& p, cudaStream_t s) {
  const Args<W> a{x,  dy, mean, inv, (const W*)weight, (const W*)bias,
                  dx, (W*)dparams, part, rowsum, p};
  constexpr int kV = 16 / sizeof(T);
  if (p.V == kV) return launch_silu<T, W, kV>(a, s);
  if (p.V == 2) return launch_silu<T, W, 2>(a, s);
  if (p.V == 1) return launch_silu<T, W, 1>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_w(const void* x, const void* dy, const float* mean,
               const float* inv, const void* weight, const void* bias,
               void* dx, void* dparams, float* part, double* rowsum,
               const Plan& p, cudaStream_t s) {
  if (p.wdtype == CVVAE_BF16)
    return dispatch<T, __nv_bfloat16>(x, dy, mean, inv, weight, bias, dx,
                                      dparams, part, rowsum, p, s);
  if (p.wdtype == CVVAE_F32)
    return dispatch<T, float>(x, dy, mean, inv, weight, bias, dx, dparams,
                              part, rowsum, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx: (B, S, C) contiguous, aligned to V elements, dtype f32 or
// bf16 (plan.dtype).  mean, inv: (B, G) f32 at plan.stat_stride (the
// forward's (B, G, 2) statistics as they are: stride 2).  weight, bias:
// (C,) of plan.wdtype; dparams: (2, C) of plan.wdtype out (dweight, then
// dbias).  scratch: f32, (B * n_chunks * C * 2) for the tiles' sums, then
// (B, C, 2) f64 for the rows'.  The plan is
// ops/kernels/groupnorm.py::backward_plan's: tiles of kMinRows rows at the
// least where S has them, and a grid resident at once (the cooperative
// launch refuses it otherwise).
CVVAE_EXPORT int cvvae_group_norm_bwd(const void* x, const void* dy,
                                      const void* mean, const void* inv,
                                      const void* weight, const void* bias,
                                      void* dx, void* dparams, void* scratch,
                                      Plan p, void* stream) {
  const int max_t = p.V > 2 ? 256 : 1024;
  if (p.B <= 0 || p.S <= 0 || p.G <= 0 || p.C <= 0 || p.C % p.G != 0 ||
      p.C > 1024 || p.V <= 0 || p.C % p.V != 0 || p.threads % 32 != 0 ||
      p.threads > max_t || p.C / p.V > p.threads || p.n_chunks <= 0 ||
      p.rows_per_chunk <= 0 || (int64_t)p.n_chunks * p.rows_per_chunk < p.S ||
      (p.S >= kMinRows && p.rows_per_chunk < kMinRows) || p.grid <= 0 ||
      (int64_t)p.grid > (int64_t)p.B * p.n_chunks || p.stat_stride <= 0)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(p.device);
  float* part = static_cast<float*>(scratch);
  double* rowsum = reinterpret_cast<double*>(
      part + (int64_t)p.B * p.n_chunks * p.C * 2);
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  if (p.dtype == CVVAE_BF16)
    return dispatch_w<__nv_bfloat16>(x, dy, m, iv, weight, bias, dx, dparams,
                                     part, rowsum, p, s);
  if (p.dtype == CVVAE_F32)
    return dispatch_w<float>(x, dy, m, iv, weight, bias, dx, dparams, part,
                             rowsum, p, s);
  return (int)cudaErrorInvalidValue;
}
