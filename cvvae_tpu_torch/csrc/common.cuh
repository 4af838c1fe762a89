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
enum { CVVAE_F32 = 0, CVVAE_BF16 = 1 };

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

// 64-bit min for host and device code (no reliance on overloads of min)
__host__ __device__ __forceinline__ int64_t min_i64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

#define CVVAE_EXPORT extern "C" __attribute__((visibility("default")))
