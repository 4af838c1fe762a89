// K2: subpixel + channel->time interleave of the four upsample phase convs.
//
// Replaces cvvae_tpu/ops/pallas/shuffle.py::subpixel_interleave.  The TPU
// kernel tiles (H band, W band) blocks through VMEM and interleaves them
// with sublane shuffles; here every output element reads exactly one
// source element, so a block walks whole output rows: neighbouring threads
// write neighbouring channels of one output pixel and read neighbouring
// channels of one source pixel (both coalesced).  The bias add is one fp32
// add rounded to the dtype, as torch's own bf16 add, so the result is
// bit-identical to the plain stack/transpose/reshape.
// Bound: device memory, one read and one write of the output's bytes.
#include "common.cuh"

namespace {

struct Phases {
  const void* p[4];  // (h_even,w_even), (h_even,w_odd), (h_odd,w_even), (h_odd,w_odd)
};

template <typename T>
__global__ void __launch_bounds__(256)
    subpixel_shuffle(Phases ph, const T* __restrict__ bias, T* __restrict__ out,
                     int64_t n_rows, int T_in, int H, int W, int c, int n,
                     int drop, int T_out) {
  const int H2 = 2 * H;
  const int row_len = 2 * W * c;
  for (int64_t r = blockIdx.x; r < n_rows; r += gridDim.x) {
    // r indexes (b, t_out, y) of the (B, T_out, 2H, 2W, c) output
    const int y = (int)(r % H2);
    const int64_t bt = r / H2;
    const int to = (int)(bt % T_out);
    const int64_t b = bt / T_out;
    const int tau = to + drop;
    const int ts = tau / n, j = tau % n;
    const int64_t src_row =
        ((b * T_in + ts) * H + (y >> 1)) * (int64_t)W * (n * c) + (int64_t)j * c;
    const T* p_even = (const T*)ph.p[(y & 1) * 2];
    const T* p_odd = (const T*)ph.p[(y & 1) * 2 + 1];
    T* o = out + r * row_len;
    for (int e = threadIdx.x; e < row_len; e += blockDim.x) {
      const int xo = e / c;
      const int ch = e - xo * c;
      const T* src = (xo & 1) ? p_odd : p_even;
      const T v = src[src_row + (int64_t)(xo >> 1) * (n * c) + ch];
      // no bias: a pure copy (adding 0 would turn -0 into +0)
      o[e] = bias ? from_f32<T>(to_f32(v) + to_f32(bias[j * c + ch])) : v;
    }
  }
}

}  // namespace

// phases: four (B, T_in, H, W, n*c) contiguous tensors; bias (n*c,) in the
// same dtype or NULL; out: (B, n*T_in - drop, 2H, 2W, c) contiguous.
CVVAE_EXPORT int cvvae_subpixel_interleave(
    const void* p00, const void* p01, const void* p10, const void* p11,
    const void* bias, void* out, int64_t B, int T_in, int H, int W, int c,
    int n, int drop, int dtype, int device, void* stream) {
  if (n < 1 || drop < 0 || drop >= n * T_in) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const int T_out = n * T_in - drop;
  const int64_t n_rows = B * T_out * 2 * (int64_t)H;
  const int grid = (int)min_i64(n_rows, 132 * 32);
  Phases ph = {{p00, p01, p10, p11}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    subpixel_shuffle<__nv_bfloat16><<<grid, 256, 0, s>>>(
        ph, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, n_rows, T_in, H,
        W, c, n, drop, T_out);
  else if (dtype == CVVAE_F32)
    subpixel_shuffle<float><<<grid, 256, 0, s>>>(
        ph, (const float*)bias, (float*)out, n_rows, T_in, H, W, c, n, drop,
        T_out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
