// K2.bwd: the gradient of the subpixel + channel->time interleave (K2,
// csrc/shuffle.cu).
//
// The TPU package differentiates its interleave (the reshape/transpose of
// cvvae_tpu/ops/upsample_conv.py) with XLA's autodiff.  The forward is a
// permutation plus a bias add, so its gradient is the inverse permutation
// of dy (B, n*T - drop, 2H, 2W, c) into the four phase gradients
// (B, T, H, W, n*c), exact, with zeros where a frame was dropped, and
// d(bias) (n*c,), the sum of dy over every output position of each bias
// channel.
//
// The design mirrors K2's: the same plan (ops/kernels/shuffle.py::
// launch_plan), a block of (c/vec, pixels) threads, 16-byte vectors where c
// and the pointers allow, kUnroll loads in flight, a persistent grid, here
// over the rows (b, tau, y) of the undropped (B, n*T, 2H, 2W, c) output:
// a dropped row (tau < drop) writes zeros, any other copies its dy row into
// the phases.  With a bias, each thread also sums what it copies in fp32,
// one accumulator a channel group, and writes its sums to its own slot of
// a scratch (grid, blockDim.y, n*c); a second launch adds the slots of each
// channel in a fixed order, in double, so d(bias) is deterministic without
// atomics.  Bound: device memory, one read of dy and one write of the
// phases.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block at most (K2's kThreads)
constexpr int kUnroll = 4;     // loads a thread issues before their stores

struct Phases {
  void* p[4];  // (h_even,w_even), (h_even,w_odd), (h_odd,w_even), (h_odd,w_odd)
};

template <typename T, typename V, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    subpixel_unshuffle(const T* __restrict__ dy, Phases ph,
                       float* __restrict__ part, int64_t n_rows, int T_in,
                       int H, int W, int cv, int n, int drop, int T_out) {
  constexpr int E = sizeof(V) / sizeof(T);
  const int W2 = 2 * W, H2 = 2 * H, TT = n * T_in;
  const int step = blockDim.y * kUnroll;
  V zero;
  {
    T* ze = reinterpret_cast<T*>(&zero);
#pragma unroll
    for (int e = 0; e < E; ++e) ze[e] = from_f32<T>(0.f);
  }
  for (int ci = threadIdx.x; ci < cv; ci += blockDim.x) {
    float acc[2][E];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
    for (int64_t r = blockIdx.x; r < n_rows; r += gridDim.x) {
      // r indexes (b, tau, y) of the undropped (B, n*T, 2H, 2W, c) output
      const int y = (int)(r % H2);
      const int64_t bt = r / H2;
      const int tau = (int)(bt % TT);
      const int64_t b = bt / TT;
      const int ts = tau / n, j = tau % n;
      const int64_t dst_row =
          ((b * T_in + ts) * H + (y >> 1)) * (int64_t)W * (n * cv) +
          (int64_t)j * cv + ci;
      V* pe = (V*)ph.p[(y & 1) * 2] + dst_row;
      V* po = (V*)ph.p[(y & 1) * 2 + 1] + dst_row;
      if (tau < drop) {
        for (int x = threadIdx.y; x < W2; x += blockDim.y)
          ((x & 1) ? po : pe)[(int64_t)(x >> 1) * (n * cv)] = zero;
        continue;
      }
      const V* src =
          (const V*)dy + ((b * T_out + (tau - drop)) * H2 + y) * (int64_t)W2 * cv +
          ci;
      for (int x0 = threadIdx.y; x0 < W2; x0 += step) {
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = x0 + u * blockDim.y;
          if (x < W2) v[u] = src[(int64_t)x * cv];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = x0 + u * blockDim.y;
          if (x >= W2) break;
          ((x & 1) ? po : pe)[(int64_t)(x >> 1) * (n * cv)] = v[u];
          if constexpr (BIAS) {
            const T* ve = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[j][e] += to_f32(ve[e]);
          }
        }
      }
    }
    if constexpr (BIAS) {
      // slot (block, threadIdx.y) of the (grid, blockDim.y, n * c) scratch
      float* out = part + ((int64_t)blockIdx.x * blockDim.y + threadIdx.y) *
                              n * cv * E;
      for (int j = 0; j < n; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          out[(int64_t)j * cv * E + (int64_t)ci * E + e] = acc[j][e];
    }
  }
}

// one thread per bias channel: the slots in order
__global__ void bias_grad(const float* __restrict__ part,
                          float* __restrict__ dbias, int64_t slots, int nc) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nc) return;
  double t = 0.0;
  for (int64_t s = 0; s < slots; ++s) t += (double)part[s * nc + k];
  dbias[k] = (float)t;
}

template <typename T, typename V>
int launch(const void* dy, Phases ph, float* part, float* dbias,
           int64_t n_rows, int T_in, int H, int W, int cv, int n, int drop,
           int T_out, int bx, int by, int grid, cudaStream_t s) {
  const dim3 block(bx, by);
  if (dbias) {
    subpixel_unshuffle<T, V, true><<<grid, block, 0, s>>>(
        (const T*)dy, ph, part, n_rows, T_in, H, W, cv, n, drop, T_out);
    const int nc = n * cv * (int)(sizeof(V) / sizeof(T));
    bias_grad<<<(nc + 255) / 256, 256, 0, s>>>(part, dbias,
                                               (int64_t)grid * by, nc);
  } else {
    subpixel_unshuffle<T, V, false><<<grid, block, 0, s>>>(
        (const T*)dy, ph, nullptr, n_rows, T_in, H, W, cv, n, drop, T_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dy: (B, n*T_in - drop, 2H, 2W, c) contiguous; p00..p11: four (B, T_in, H,
// W, n*c) contiguous outputs; part: (grid, by, n*c) f32 scratch and dbias
// (n*c,) f32 out, or both NULL without a bias.  vec, bx, by, grid: K2's
// plan over the B * n*T_in * 2H undropped rows.
CVVAE_EXPORT int cvvae_subpixel_interleave_bwd(
    const void* dy, void* p00, void* p01, void* p10, void* p11, void* part,
    void* dbias, int64_t B, int T_in, int H, int W, int c, int n, int drop,
    int vec, int bx, int by, int grid, int dtype, int device, void* stream) {
  if (n < 1 || n > 2 || drop < 0 || drop >= n * T_in || vec < 1 || c % vec ||
      bx < 1 || by < 1 || bx * by > kThreads || grid < 1 ||
      (part == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const int T_out = n * T_in - drop;
  const int64_t n_rows = B * (int64_t)(n * T_in) * 2 * H;
  const int cv = c / vec;
  Phases ph = {{p00, p01, p10, p11}};
  float* pt = (float*)part;
  float* db = (float*)dbias;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16 && vec == 8)
    return launch<__nv_bfloat16, uint4>(dy, ph, pt, db, n_rows, T_in, H, W, cv,
                                        n, drop, T_out, bx, by, grid, s);
  if (dtype == CVVAE_BF16 && vec == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(dy, ph, pt, db, n_rows, T_in,
                                                H, W, cv, n, drop, T_out, bx,
                                                by, grid, s);
  if (dtype == CVVAE_F32 && vec == 4)
    return launch<float, uint4>(dy, ph, pt, db, n_rows, T_in, H, W, cv, n,
                                drop, T_out, bx, by, grid, s);
  if (dtype == CVVAE_F32 && vec == 1)
    return launch<float, float>(dy, ph, pt, db, n_rows, T_in, H, W, cv, n,
                                drop, T_out, bx, by, grid, s);
  return (int)cudaErrorInvalidValue;
}
