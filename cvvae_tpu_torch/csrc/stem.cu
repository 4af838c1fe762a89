// K3: 3x3x3 stride-1 conv with few input channels (Cin <= 4) to 128
// output channels: the encoder's conv_in at full pixel resolution.
//
// Replaces cvvae_tpu/ops/pallas/stem.py::stem_conv3d.  The TPU kernel
// deinterleaves the input and runs one 27-deep MXU dot; a Cin of 3 gives a
// tensor-core tile nothing to contract over, so here the conv is plain fp32
// FMAs.  Each block computes a 4 x 32 pixel tile of one output frame for
// all 128 channels.  It stages the (3 frames x 6 rows x 34 cols x Cin)
// input patch and the 27*Cin x 128 weights in shared memory; padding is
// folded into the patch load (time index clamped in edge mode, H/W and
// zero-mode time masked), so no padded copy of the input exists.
// Each thread owns 4 channels x 16 pixels (64 fp32 accumulators): per tap
// it reads one float4 of weights and 16 broadcast input values.
// Bound: the output write (128 channels per input pixel) and the FMA rate;
// the input read is 3/128 of the output's size.
#include "common.cuh"

namespace {

constexpr int kCout = 128;
constexpr int kTH = 4, kTW = 32;
constexpr int kPH = kTH + 2, kPW = kTW + 2;

template <typename T, int CIN>
__global__ void __launch_bounds__(256)
    stem_conv(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ y, int T_in,
              int H, int W, int T_out, int H_out, int W_out, int pt0, int ph0,
              int pw0, int t_edge) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // (27*CIN, 128)
  float* sx = sw + 27 * CIN * kCout;            // (3, kPH, kPW, CIN)
  const int bt = blockIdx.z;
  const int b = bt / T_out, to = bt % T_out;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;

  for (int i = threadIdx.x; i < 27 * CIN * kCout / 4; i += blockDim.x)
    smem4[i] = reinterpret_cast<const float4*>(w)[i];
  for (int i = threadIdx.x; i < 3 * kPH * kPW * CIN; i += blockDim.x) {
    const int ci = i % CIN;
    int rest = i / CIN;
    const int pw = rest % kPW;
    rest /= kPW;
    const int ph = rest % kPH;
    const int dt = rest / kPH;
    int ti = to + dt - pt0;
    const int hi = h0 + ph - ph0, wi = w0 + pw - pw0;
    bool ok = hi >= 0 && hi < H && wi >= 0 && wi < W;
    if (t_edge)
      ti = min(max(ti, 0), T_in - 1);
    else
      ok = ok && ti >= 0 && ti < T_in;
    sx[i] = ok ? to_f32(x[((((int64_t)b * T_in + ti) * H + hi) * W + wi) * CIN + ci])
               : 0.f;
  }
  __syncthreads();

  const int cq = threadIdx.x % 32;  // channels 4*cq .. 4*cq+3
  const int pg = threadIdx.x / 32;  // pixel group: one row, 16 columns
  const int row = pg / 2, col0 = (pg % 2) * 16;
  float acc[16][4];
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[p][k] = 0.f;

  for (int dt = 0; dt < 3; ++dt)
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int dw = 0; dw < 3; ++dw)
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          const float4 wv =
              smem4[(((dt * 3 + dh) * 3 + dw) * CIN + ci) * (kCout / 4) + cq];
          const float* xr = sx + ((dt * kPH + row + dh) * kPW + col0 + dw) * CIN + ci;
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            const float xv = xr[p * CIN];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }

  const int ho = h0 + row;
  if (ho >= H_out) return;
  const float4 bv = reinterpret_cast<const float4*>(bias)[cq];
  T* yrow = y + (((int64_t)b * T_out + to) * H_out + ho) * (int64_t)W_out * kCout;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int wo = w0 + col0 + p;
    if (wo < W_out) {
      T* o = yrow + (int64_t)wo * kCout + cq * 4;
      o[0] = from_f32<T>(acc[p][0] + bv.x);
      o[1] = from_f32<T>(acc[p][1] + bv.y);
      o[2] = from_f32<T>(acc[p][2] + bv.z);
      o[3] = from_f32<T>(acc[p][3] + bv.w);
    }
  }
}

template <typename T, int CIN>
int launch(const void* x, const float* w, const float* bias, void* y,
           int64_t B, int T_in, int H, int W, int T_out, int H_out, int W_out,
           int pt0, int ph0, int pw0, int t_edge, cudaStream_t s) {
  const size_t smem = (27 * CIN * kCout + 3 * kPH * kPW * CIN) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      stem_conv<T, CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W_out + kTW - 1) / kTW, (H_out + kTH - 1) / kTH,
                  (unsigned)(B * T_out));
  stem_conv<T, CIN><<<grid, 256, smem, s>>>((const T*)x, w, bias, (T*)y, T_in,
                                            H, W, T_out, H_out, W_out, pt0,
                                            ph0, pw0, t_edge);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_cin(int cin, const void* x, const float* w, const float* bias,
                 void* y, int64_t B, int T_in, int H, int W, int T_out,
                 int H_out, int W_out, int pt0, int ph0, int pw0, int t_edge,
                 cudaStream_t s) {
  switch (cin) {
    case 1: return launch<T, 1>(x, w, bias, y, B, T_in, H, W, T_out, H_out, W_out, pt0, ph0, pw0, t_edge, s);
    case 2: return launch<T, 2>(x, w, bias, y, B, T_in, H, W, T_out, H_out, W_out, pt0, ph0, pw0, t_edge, s);
    case 3: return launch<T, 3>(x, w, bias, y, B, T_in, H, W, T_out, H_out, W_out, pt0, ph0, pw0, t_edge, s);
    case 4: return launch<T, 4>(x, w, bias, y, B, T_in, H, W, T_out, H_out, W_out, pt0, ph0, pw0, t_edge, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (B, T_in, H, W, cin) contiguous; w: (3, 3, 3, cin, 128) f32
// contiguous; bias: (128,) f32; y: (B, T_out, H_out, W_out, 128).
// Pads: time (pt0, .) in edge (t_edge=1) or zero mode, H/W zero.
CVVAE_EXPORT int cvvae_stem_conv3d(const void* x, const void* w,
                                   const void* bias, void* y, int64_t B,
                                   int T_in, int H, int W, int cin, int T_out,
                                   int H_out, int W_out, int pt0, int ph0,
                                   int pw0, int t_edge, int dtype, int device,
                                   void* stream) {
  if (B * T_out > 65535) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    return dispatch_cin<__nv_bfloat16>(cin, x, (const float*)w,
                                       (const float*)bias, y, B, T_in, H, W,
                                       T_out, H_out, W_out, pt0, ph0, pw0,
                                       t_edge, s);
  if (dtype == CVVAE_F32)
    return dispatch_cin<float>(cin, x, (const float*)w, (const float*)bias, y,
                               B, T_in, H, W, T_out, H_out, W_out, pt0, ph0,
                               pw0, t_edge, s);
  return (int)cudaErrorInvalidValue;
}
