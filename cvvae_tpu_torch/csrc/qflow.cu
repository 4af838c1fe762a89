// K6: the int8-resident activations' elementwise boundaries
// (cvvae_tpu/ops/qflow.py, which XLA fuses into its producers; no Pallas
// kernel), as two entries:
//   qflow_requant: ``requant`` (qflow.py:69-76) of a bf16 or fp32 tensor at
//      a scalar or per-channel scale: round-half-even(fl(x / s[c]))
//      clipped to +-127.
//   qflow_add: ``qadd`` (qflow.py:175-179), the residual add of two int8
//      tensors each with its scalar or per-channel scale: fl(fl(qx *
//      sx[c]) + fl(qh * sh[c])), requantized at out_scale[c] (scalar or
//      per channel).
// Every step is one IEEE-rounded fp32 operation, and quant8 (common.cuh)
// gives the correctly rounded quotient's code, so both are bit-equal to
// their plain versions (ops/kernels/qflow.py).
//
// A thread takes 16 consecutive elements of the (N, C) tensor: one 16-byte
// int8 load or store, and two (bf16) or four (fp32) 16-byte float loads;
// the channel of its first element is taken once (one 64-bit remainder)
// and stepped with a wrap.  Bound: device memory (requant: 2 or 4 bytes
// in and 1 out an element; qadd: 3 bytes an element).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// a value's int8 code at scale s, as the reference's requant rounds it
__device__ __forceinline__ uint32_t code(float v, float s) {
  return (uint32_t)(quant8(v, s, __frcp_rn(s)) & 0xff);
}

// the scales of one entry: channel c's is s[c * per_channel]
struct Scale {
  const float* s;
  int per_channel;
  __device__ __forceinline__ float at(int c) const {
    return __ldg(s + c * per_channel);
  }
};

// value i (0..15) of 16 consecutive T from p, fp32
template <typename T>
__device__ __forceinline__ void load16(const T* p, bool vec, float* out) {
  if (vec) {
    constexpr int kWords = 16 * (int)sizeof(T) / 16;
    uint4 w[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      w[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
    const T* v = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = to_f32(v[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = to_f32(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    qflow_requant(const T* __restrict__ x, Scale sx, int8_t* __restrict__ y,
                  int64_t n, int C, int vec) {
  const int64_t groups = n / 16;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    float v[16];
    load16(x + g * 16, vec != 0, v);
    int c = (int)((g * 16) % C);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      w[i / 4] |= code(v[i], sx.at(c)) << (8 * (i % 4));
      if (++c == C) c = 0;
    }
    reinterpret_cast<uint4*>(y)[g] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // the last n % 16 elements, one a thread of the first block
  if (blockIdx.x == 0 && threadIdx.x < n % 16) {
    const int64_t i = groups * 16 + threadIdx.x;
    y[i] = (int8_t)code(to_f32(x[i]), sx.at((int)(i % C)));
  }
}

__global__ void __launch_bounds__(kThreads)
    qflow_add(const int8_t* __restrict__ xq, Scale sx,
              const int8_t* __restrict__ hq, Scale sh, Scale so,
              int8_t* __restrict__ y, int64_t n, int C) {
  const int64_t groups = n / 16;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(xq) + g);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(hq) + g);
    const int8_t* qa = reinterpret_cast<const int8_t*>(&a);
    const int8_t* qb = reinterpret_cast<const int8_t*>(&b);
    int c = (int)((g * 16) % C);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float v = __fadd_rn(__fmul_rn((float)qa[i], sx.at(c)),
                                __fmul_rn((float)qb[i], sh.at(c)));
      w[i / 4] |= code(v, so.at(c)) << (8 * (i % 4));
      if (++c == C) c = 0;
    }
    reinterpret_cast<uint4*>(y)[g] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 16) {
    const int64_t i = groups * 16 + threadIdx.x;
    const int c = (int)(i % C);
    const float v = __fadd_rn(__fmul_rn((float)xq[i], sx.at(c)),
                              __fmul_rn((float)hq[i], sh.at(c)));
    y[i] = (int8_t)code(v, so.at(c));
  }
}

// blocks for n elements: one 16-element group a thread, at most 8 blocks
// an SM's worth (the grid strides past that)
unsigned blocks_for(int64_t n) {
  const int64_t groups = n / 16;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

bool bad_scale(int per_channel) {
  return per_channel != 0 && per_channel != 1;
}

}  // namespace

// requant: x (N, C) bf16|fp32 contiguous (n = N * C elements), scale a
// device fp32 scalar (per_channel 0) or (C,) (per_channel 1); y (N, C)
// int8.  vec: x is 16-byte aligned, so 16 elements load as whole vectors.
CVVAE_EXPORT int cvvae_qflow_requant(const void* x, const void* scale,
                                     int per_channel, void* y, int64_t n,
                                     int C, int dtype, int vec, int device,
                                     void* stream) {
  if (n < 1 || C < 1 || bad_scale(per_channel) ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const Scale sx{(const float*)scale, per_channel};
  if (dtype == CVVAE_BF16)
    qflow_requant<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, sx, (int8_t*)y, n, C, vec);
  else if (dtype == CVVAE_F32)
    qflow_requant<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)x, sx, (int8_t*)y, n, C, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// qadd: xq, hq, y (N, C) int8 contiguous, 16-byte aligned; each of sx, sh,
// out_scale a device fp32 scalar (its per_channel flag 0) or (C,) (1).
CVVAE_EXPORT int cvvae_qflow_add(const void* xq, const void* sx, int sx_pc,
                                 const void* hq, const void* sh, int sh_pc,
                                 const void* out_scale, int out_pc, void* y,
                                 int64_t n, int C, int device, void* stream) {
  if (n < 1 || C < 1 || bad_scale(sx_pc) || bad_scale(sh_pc) ||
      bad_scale(out_pc) ||
      (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(hq) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  qflow_add<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, Scale{(const float*)sx, sx_pc}, (const int8_t*)hq,
      Scale{(const float*)sh, sh_pc}, Scale{(const float*)out_scale, out_pc},
      (int8_t*)y, n, C);
  return (int)cudaGetLastError();
}
