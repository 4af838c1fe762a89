// Shared helpers for the hand-written Hopper kernels of cvvae_tpu_torch.
//
// Every kernel is exported through a plain C function (no PyTorch headers)
// that the Python wrappers load with ctypes: pointers and the CUDA stream
// arrive as void*, the function returns cudaGetLastError() after its
// launches so a refused launch surfaces in the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, mirrored by cvvae_tpu_torch/ops/kernels/_build.py
// (DTYPE_CODES, INT8_CODE); int8 only where an entry says so
enum { CVVAE_F32 = 0, CVVAE_BF16 = 1, CVVAE_I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round-to-nearest-even, as torch and XLA round fp32 -> bf16
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round-half-even(fl(v / s)) clipped to +-127, bit for bit as the
// reference's requantization (jnp.round of a divided value, which rounds
// once): r is __frcp_rn(s).  The correctly rounded quotient costs an IEEE
// division (__fdiv_rn: a reciprocal, its refinement and a range check).
// So the product t = v * fl(1/s) is taken first: t is within 2^-23 |v/s|
// of v/s (two roundings), and fl(v/s) within 2^-24 |v/s|, so below |t| =
// 128 the two differ by less than 2^-15.  Where t lies farther than 2^-13
// from every half-integer, fl(v/s) lies in the same open interval between
// half-integers, so both round to rint(t); where |t| >= 128, |fl(v/s)| >
// 127.5 and both clip.  Only the values within 2^-13 of a half-integer
// (about 1 in 2^12) take the division.
__device__ __forceinline__ int quant8(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  if (fabsf(t) >= 128.f) return t > 0.f ? 127 : -127;
  const float n = rintf(t);
  if (0.5f - fabsf(t - n) > 0x1p-13f) return max(-127, min(127, (int)n));
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}

// 64-bit min for host and device code (no reliance on overloads of min)
__host__ __device__ __forceinline__ int64_t min_i64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

#define CVVAE_EXPORT extern "C" __attribute__((visibility("default")))
