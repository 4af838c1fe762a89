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

// quant8: round-half-even(fl(v / s)) clipped to +-127, bit for bit as the
// reference's requantization (jnp.round of a divided value, which rounds
// once), for a scale s > 0 with 2^-100 <= s <= 2^100; r is __frcp_rn(s).
// No division, no conversion instruction and no branch on the common path.
//
// The fast path (quant8_fast, given rq = fl(r * fl(1/254))): u =
// fl(v * rq + 1/2) saturated to [0, 1] (one fma.sat), then m = fl(254 u +
// 1.5 * 2^23 - 127) (one fma): that sum's exact value is rounded once to an
// integer, so m = 1.5 * 2^23 + rint(254 u - 127) (away from ties) and the
// code is m's low byte; t = 254 u - 127 lies in [-127, 127], so the clip
// comes with the saturation.  Where u does not saturate, t lies within
// 2^-15 of v/s: rq is within 2^-23 + 2^-24 of r/254 relatively, r within
// 2^-24 of 1/s, so 254 v rq within 1.5 * 2^-16 of v/s below |v/s| = 128,
// and the fma's rounding of u moves t by at most 254 * 2^-25 < 2^-17;
// fl(v/s) lies within 2^-17 of v/s.  So where t lies farther than 2^-13
// from every half-integer, fl(v/s) lies in the same open interval between
// half-integers and both round alike.  Where u saturates, |v/s| > 127 -
// 2^-15 and both give +-127.  d = 254 u - rint(254 u) = fma(u, 254, (1.5
// * 2^23 - 127) - m) (the difference of two integers of one binade,
// exact); |d| >= 1/2 - 2^-13 flags the value rare (t within 2^-13 of a
// half-integer, about 1 value in 2^12).
//
// The rare path (quant8_tie) decides, without dividing, whether fl(v/s)
// lies below the half-integer h next to t = fl(v r), on it, or above it.
// e = fma(-h, s, v) is v - h s exactly: there |v/s - h| < 2^-13 + 2^-15, so
// |e| < 1.25 * 2^-13 * s < 1.25 * 2^(es-12), s in [2^es, 2^(es+1)); v is a
// multiple of ulp(v) >= 2^(es-25) (|v| > s/2 - |e|) and h s of ulp(s)/2 =
// 2^(es-24), so e is a multiple of 2^(es-25) below 2^24 of them, a float,
// and the fma's one rounding leaves it exact.  With a = |h| and d = |v| -
// a s (e with h's sign taken off), fl(|v/s|) = a exactly when -lo s <= d
// <= hi s, hi and lo half an ulp of a above and below it (2^(ea-24); lo
// half that at a = 0.5, a power of two): a's last mantissa bit is 0, so a
// quotient halfway to either neighbour rounds to a.  hi s and lo s are
// powers of two times s, so exact, and the comparisons exact.  Above: the
// code is a + 1/2; below: a - 1/2; on a: rint(a), the even of the two
// (the reference's tie); clipped to 127.
constexpr float kRound = 12582912.f - 127.f;  // 1.5 * 2^23 - 127
constexpr float kTieBand = 0.5f - 0x1p-13f;

// rq of a scale's reciprocal r, as quant8_fast takes it
__device__ __forceinline__ float quant8_rq(float r) {
  return __fmul_rn(r, 1.f / 254.f);
}

// quant8's fast path: a word whose low byte is the code; ``rare`` is or-ed
// with whether the value needs quant8_tie
__device__ __forceinline__ uint32_t quant8_fast(float v, float rq,
                                                bool& rare) {
  float u;
  asm("fma.rn.sat.f32 %0, %1, %2, 0f3F000000;" : "=f"(u) : "f"(v), "f"(rq));
  const float m = __fmaf_rn(u, 254.f, kRound);
  rare |= fabsf(__fmaf_rn(u, 254.f, __fsub_rn(kRound, m))) >= kTieBand;
  return __float_as_uint(m);
}

// the code's byte of a rare value (quant8_fast flagged it)
__device__ __forceinline__ uint32_t quant8_tie(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  const float n = rintf(t);
  const float h = __fadd_rn(n, copysignf(0.5f, __fsub_rn(t, n)));
  const float e = fmaf(-h, s, v);  // v - h s, exact
  const float a = fabsf(h), d = h < 0.f ? -e : e;
  const float hi = __fmul_rn(
      __uint_as_float((__float_as_uint(a) & 0x7f800000u) - (24u << 23)), s);
  const float lo = a == 0.5f ? 0.5f * hi : hi;
  const float code = fminf(d > hi ? a + 0.5f : d < -lo ? a - 0.5f : rintf(a),
                           127.f);
  return (uint32_t)(h < 0.f ? -(int)code : (int)code) & 0xffu;
}

// quant8_tie as a call, so that no caller pays its instructions on the
// common path
static __device__ __noinline__ uint32_t quant8_tie_call(float v, float s,
                                                        float r) {
  return quant8_tie(v, s, r);
}

// one value's code (the K5 epilogue, which holds many values in
// registers, takes quant8_fast for them all and quant8_tie where a vote
// of the warp finds a rare one)
__device__ __forceinline__ int quant8(float v, float s, float r) {
  bool rare = false;
  uint32_t c = quant8_fast(v, quant8_rq(r), rare);
  if (rare) c = quant8_tie_call(v, s, r);
  return (int)(int8_t)(c & 0xffu);
}

// 64-bit min for host and device code (no reliance on overloads of min)
__host__ __device__ __forceinline__ int64_t min_i64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

#define CVVAE_EXPORT extern "C" __attribute__((visibility("default")))
