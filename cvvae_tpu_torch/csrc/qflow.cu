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
// int8 load or store, and two (bf16) or four (fp32) 16-byte float loads.
// Bound: device memory (requant: 2 or 4 bytes in and 1 out an element;
// qadd: 3 bytes an element).
//
// The add has two paths, chosen on the host (ops/kernels/qflow.py::
// add_plan).  The sliced path (qflow_add_sliced), where C is a multiple of
// 16 and the grid's stride of 16 * kThreads * blocks values a multiple of
// C: a thread's 16 channels are then the same on every iteration, so it
// loads their three scales and makes each out scale's quant8 factor once,
// before its loop, and holds them in registers (48 of them); the loop
// makes no scale load, no reciprocal and no remainder.  Its int8 values
// become floats without a conversion instruction (biased_to_f32: a byte
// permute and a subtraction, both full rate), and it keeps kAddGroups
// 16-byte groups of each input in flight.  quant8's rare case takes its
// scale and reciprocal on the spot.  The general path (qflow_add), for any
// C: each value's channel stepped with a wrap from one 64-bit remainder,
// each value's scales loaded and its reciprocal made.
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

// the sliced add's blocks an SM (its launch bound, which caps a thread at
// 65536 / (kThreads * kAddBlocks) registers: at 2, 128, and the sliced add
// takes ~120 without a spill; at 3 it spills) and 16-byte groups of each
// input a thread has in flight
constexpr int kAddBlocks = 2;
constexpr int kAddGroups = 2;
// the sliced add's design choices, each undone by a variant of
// utils/kernel_variants.py (--kernel K6): its scales loaded once (not per
// value), its out scales' quant8 factors made once (not per value), its
// int8 values converted by a byte permute (not I2F), and the entry
// launching it where the host asks (not the general add everywhere)
constexpr bool kHoldScales = true;
constexpr bool kHoldFactors = true;
constexpr bool kPermConvert = true;
constexpr bool kSlicedAdd = true;

// byte j of the word w ^ 0x80808080 as the float of its int8 value: the
// biased byte u = q + 128 into the mantissa of 2^23 (bits 0x4B0000uu, the
// float 2^23 + u), less 2^23 + 128; exact for all 256 codes
__device__ __forceinline__ float biased_to_f32(uint32_t biased, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u,
                                               0x7540 + j)),
                   8388736.f);
}

// the int8 value of byte i (0..15) of a 16-byte group, as a float
__device__ __forceinline__ float value_of(const uint32_t* w, const
                                          uint32_t* biased, int i) {
  if (kPermConvert) return biased_to_f32(biased[i / 4], i % 4);
  return (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}

// the low bytes of four words m0..m3 as one word
__device__ __forceinline__ uint32_t pack4(const uint32_t* m) {
  return __byte_perm(__byte_perm(m[0], m[1], 0x0040),
                     __byte_perm(m[2], m[3], 0x0040), 0x5410);
}

// one 16-byte group by the general add's arithmetic, value by value:
// channel cb + i for value i, its scales loaded, its code by quant8 (with
// its tie path); the sliced add's group where its fast path flagged a
// value (about one group in 2^8), out of line so that the common path
// holds no more registers for it
static __device__ __noinline__ uint4 add_exact(uint4 a, uint4 b, Scale sx,
                                               Scale sh, Scale so, int cb) {
  const int8_t* qa = reinterpret_cast<const int8_t*>(&a);
  const int8_t* qb = reinterpret_cast<const int8_t*>(&b);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float v = __fadd_rn(__fmul_rn((float)qa[i], sx.at(cb + i)),
                              __fmul_rn((float)qb[i], sh.at(cb + i)));
    w[i / 4] |= code(v, so.at(cb + i)) << (8 * (i % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// one 16-byte group of the sliced add: channel cb + i for value i; fx, fh
// the held input scales and fo the held quant8 factors (where kHoldScales;
// without kHoldFactors, fo holds the out scales themselves).  quant8's
// fast path on every value, its codes packed as they come; a flagged
// value sends the group to add_exact
__device__ __forceinline__ uint4 add_group(uint4 a, uint4 b, const float* fx,
                                           const float* fh, const float* fo,
                                           Scale sx, Scale sh, Scale so,
                                           int cb) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  uint32_t ba[4], bb[4], w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ba[k] = wa[k] ^ 0x80808080u;
    bb[k] = wb[k] ^ 0x80808080u;
  }
  bool rare = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * k + j;
      const float xs = kHoldScales ? fx[i] : sx.at(cb + i);
      const float hs = kHoldScales ? fh[i] : sh.at(cb + i);
      const float rq =
          kHoldScales && kHoldFactors
              ? fo[i]
              : quant8_rq(__frcp_rn(kHoldScales ? fo[i] : so.at(cb + i)));
      const float v = __fadd_rn(__fmul_rn(value_of(wa, ba, i), xs),
                                __fmul_rn(value_of(wb, bb, i), hs));
      m[j] = quant8_fast(v, rq, rare);
    }
    w[k] = pack4(m);
  }
  if (rare) return add_exact(a, b, sx, sh, so, cb);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the sliced add over groups = n / 16 groups of 16 values, on a grid whose
// stride of gridDim.x * kThreads groups is a multiple of C / 16: thread
// t's groups t + k * stride all start at channel cb = 16 t mod C
__global__ void __launch_bounds__(kThreads, kAddBlocks)
    qflow_add_sliced(const int8_t* __restrict__ xq, Scale sx,
                     const int8_t* __restrict__ hq, Scale sh, Scale so,
                     int8_t* __restrict__ y, int64_t groups, int C) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int cb = (int)(((int64_t)t * 16) % C);
  float fx[16], fh[16], fo[16];
  if (kHoldScales) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fx[i] = sx.at(cb + i);
      fh[i] = sh.at(cb + i);
      fo[i] = kHoldFactors ? quant8_rq(__frcp_rn(so.at(cb + i)))
                           : so.at(cb + i);
    }
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const uint4* a = reinterpret_cast<const uint4*>(xq) + t;
  const uint4* b = reinterpret_cast<const uint4*>(hq) + t;
  uint4* out = reinterpret_cast<uint4*>(y) + t;
  for (int64_t g = t; g < groups; g += kAddGroups * stride) {
    uint4 va[kAddGroups], vb[kAddGroups];
#pragma unroll
    for (int k = 0; k < kAddGroups; ++k) {
      if (k == 0 || g + k * stride < groups) {
        va[k] = __ldg(a + k * stride);
        vb[k] = __ldg(b + k * stride);
      }
    }
#pragma unroll
    for (int k = 0; k < kAddGroups; ++k) {
      if (k == 0 || g + k * stride < groups)
        out[k * stride] = add_group(va[k], vb[k], fx, fh, fo, sx, sh, so, cb);
    }
    a += kAddGroups * stride;
    b += kAddGroups * stride;
    out += kAddGroups * stride;
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
// blocks > 0: the sliced add on that many blocks (C a multiple of 16 that
// divides 16 * kThreads * blocks); 0: the general add.
CVVAE_EXPORT int cvvae_qflow_add(const void* xq, const void* sx, int sx_pc,
                                 const void* hq, const void* sh, int sh_pc,
                                 const void* out_scale, int out_pc, void* y,
                                 int64_t n, int C, int blocks, int device,
                                 void* stream) {
  if (n < 1 || C < 1 || blocks < 0 || bad_scale(sx_pc) || bad_scale(sh_pc) ||
      bad_scale(out_pc) ||
      (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(hq) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  if (blocks > 0 &&
      (C % 16 || n % C || (16 * (int64_t)kThreads * blocks) % C ||
       (int64_t)kThreads * blocks > 0x7fffffff))
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const Scale s1{(const float*)sx, sx_pc}, s2{(const float*)sh, sh_pc},
      s3{(const float*)out_scale, out_pc};
  if (blocks > 0 && kSlicedAdd)
    qflow_add_sliced<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)xq, s1, (const int8_t*)hq, s2, s3, (int8_t*)y, n / 16,
        C);
  else
    qflow_add<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)xq, s1, (const int8_t*)hq, s2, s3, (int8_t*)y, n, C);
  return (int)cudaGetLastError();
}
