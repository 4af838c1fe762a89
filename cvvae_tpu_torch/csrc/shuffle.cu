// K2: subpixel + channel->time interleave of the four upsample phase convs.
//
// Replaces cvvae_tpu/ops/pallas/shuffle.py::subpixel_interleave.  It is a
// pure permutation plus a bias add, so what bounds it on an H100 is
// device memory: one read of the four phases and one write of the output
// (8.7 GB, 2.6 ms at 3.35 TB/s, at the last upsample of a 720x672 decoder
// tile in bf16).  The design aims at a copy near HBM's rate:
//
// - 16-byte vectors.  Where c is a multiple of 16 bytes' elements and every
//   pointer is 16-byte aligned (the wrapper checks both; every shape of the
//   serving paths has c in {256, 512}), a thread moves uint4 vectors; any
//   other c or a misaligned view takes the scalar instance of the same
//   kernel (a "vector" of one element), which is as bit-exact.
// - No division per element.  A block is (cv', ppi) threads: threadIdx.x is
//   a fixed vector of the pixel's cv = c / vec (cv' = min(cv, 256)) and
//   threadIdx.y one of ppi pixels; a thread keeps its channel offset and
//   its bias vector in registers for a whole output row, so the inner loop
//   only steps the output column x (phase x & 1, source pixel x >> 1).
// - Enough in flight.  Each thread issues kUnroll independent loads before
//   their stores, and the grid is persistent over output rows (about 8
//   blocks an SM), each row decoded once: row (b, t_out, y) reads frame
//   tau = t_out + drop as (tau / n, channel group tau % n) of phases
//   (y & 1) * 2 + {0, 1} at source row y >> 1.
// - The bias add is one fp32 add rounded to the dtype, which is what
//   torch's own add does, so the result is bit-identical to the plain
//   stack/transpose/reshape; with no bias the kernel copies bits (adding 0
//   would turn -0 into +0).
//
// kThreads and kUnroll are read by ops/kernels/shuffle.py (launch_plan and
// its tests) from this file.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block at most
constexpr int kUnroll = 4;     // loads a thread issues before their stores

struct Phases {
  const void* p[4];  // (h_even,w_even), (h_even,w_odd), (h_odd,w_even), (h_odd,w_odd)
};

// V: the moved unit (uint4, or T itself on the scalar path), E elements
template <typename T, typename V, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    subpixel_shuffle(Phases ph, const T* __restrict__ bias, T* __restrict__ out,
                     int64_t n_rows, int T_in, int H, int W, int cv, int n,
                     int drop, int T_out) {
  constexpr int E = sizeof(V) / sizeof(T);
  const int W2 = 2 * W, H2 = 2 * H;
  const int step = blockDim.y * kUnroll;
  for (int64_t r = blockIdx.x; r < n_rows; r += gridDim.x) {
    // r indexes (b, t_out, y) of the (B, T_out, 2H, 2W, c) output
    const int y = (int)(r % H2);
    const int64_t bt = r / H2;
    const int to = (int)(bt % T_out);
    const int64_t b = bt / T_out;
    const int tau = to + drop;
    const int ts = tau / n, j = tau % n;
    const int64_t src_row =
        ((b * T_in + ts) * H + (y >> 1)) * (int64_t)W * (n * cv) + (int64_t)j * cv;
    const V* p_even = (const V*)ph.p[(y & 1) * 2];
    const V* p_odd = (const V*)ph.p[(y & 1) * 2 + 1];
    V* o = (V*)out + r * W2 * (int64_t)cv;
    for (int ci = threadIdx.x; ci < cv; ci += blockDim.x) {
      float bf[E];
      if constexpr (BIAS) {
        const V bvec = reinterpret_cast<const V*>(bias)[j * cv + ci];
        const T* be = reinterpret_cast<const T*>(&bvec);
#pragma unroll
        for (int e = 0; e < E; ++e) bf[e] = to_f32(be[e]);
      }
      const V* pe = p_even + src_row + ci;
      const V* po = p_odd + src_row + ci;
      for (int x0 = threadIdx.y; x0 < W2; x0 += step) {
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = x0 + u * blockDim.y;
          if (x < W2) v[u] = ((x & 1) ? po : pe)[(int64_t)(x >> 1) * (n * cv)];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = x0 + u * blockDim.y;
          if (x >= W2) break;
          if constexpr (BIAS) {
            T* ve = reinterpret_cast<T*>(&v[u]);
#pragma unroll
            for (int e = 0; e < E; ++e) ve[e] = from_f32<T>(to_f32(ve[e]) + bf[e]);
          }
          o[(int64_t)x * cv + ci] = v[u];
        }
      }
    }
  }
}

template <typename T, typename V>
int launch(Phases ph, const void* bias, void* out, int64_t n_rows, int T_in,
           int H, int W, int cv, int n, int drop, int T_out, int bx, int by,
           int grid, cudaStream_t s) {
  const dim3 block(bx, by);
  if (bias)
    subpixel_shuffle<T, V, true><<<grid, block, 0, s>>>(
        ph, (const T*)bias, (T*)out, n_rows, T_in, H, W, cv, n, drop, T_out);
  else
    subpixel_shuffle<T, V, false><<<grid, block, 0, s>>>(
        ph, nullptr, (T*)out, n_rows, T_in, H, W, cv, n, drop, T_out);
  return (int)cudaGetLastError();
}

}  // namespace

// phases: four (B, T_in, H, W, n*c) contiguous tensors; bias (n*c,) in the
// same dtype or NULL; out: (B, n*T_in - drop, 2H, 2W, c) contiguous.  vec:
// elements a moved unit (16 bytes' worth, or 1 for the scalar path; c %
// vec == 0 and every pointer aligned to vec elements); a block is (bx, by)
// threads, the grid `grid` blocks (ops/kernels/shuffle.py::launch_plan).
CVVAE_EXPORT int cvvae_subpixel_interleave(
    const void* p00, const void* p01, const void* p10, const void* p11,
    const void* bias, void* out, int64_t B, int T_in, int H, int W, int c,
    int n, int drop, int vec, int bx, int by, int grid, int dtype,
    int device, void* stream) {
  if (n < 1 || drop < 0 || drop >= n * T_in || vec < 1 || c % vec ||
      bx < 1 || by < 1 || bx * by > kThreads || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const int T_out = n * T_in - drop;
  const int64_t n_rows = B * T_out * 2 * (int64_t)H;
  const int cv = c / vec;
  Phases ph = {{p00, p01, p10, p11}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16 && vec == 8)
    return launch<__nv_bfloat16, uint4>(ph, bias, out, n_rows, T_in, H, W, cv,
                                        n, drop, T_out, bx, by, grid, s);
  if (dtype == CVVAE_BF16 && vec == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(ph, bias, out, n_rows, T_in, H,
                                                W, cv, n, drop, T_out, bx, by,
                                                grid, s);
  if (dtype == CVVAE_F32 && vec == 4)
    return launch<float, uint4>(ph, bias, out, n_rows, T_in, H, W, cv, n, drop,
                                T_out, bx, by, grid, s);
  if (dtype == CVVAE_F32 && vec == 1)
    return launch<float, float>(ph, bias, out, n_rows, T_in, H, W, cv, n, drop,
                                T_out, bx, by, grid, s);
  return (int)cudaErrorInvalidValue;
}
