// K5: int8 implicit-GEMM 3-D convolution with the dequantising epilogue.
//
// Computes what cvvae_tpu/ops/quant.py:256-269 (and conv_int8, :148-159)
// computes with XLA's int8 conv, which is no Pallas kernel: a conv of
// channels-last (B,T,H,W,Cin) x in bf16 or fp32, quantized on load to
// round-half-even(x / scale_x) clipped to +-127, with an int8 kernel
// (O,I,kT,kH,kW); s8*s8 summed in s32 (at most 27*512*127^2 < 2^31); then
// float(acc) * (scale_x*scale_w[o]) + bias[o], rounded to x's dtype.
//
// Bound on an H100: the v1 encoder's level-0 causal conv (17x720x1280,
// 128 -> 128, 27 taps) is 13.9 TOP, 7.0 ms at 1,979 TOP/s int8, against
// 2.4 ms of bytes: compute-bound.
//
// Design, simple first (mma.sync, no TMA, no warp specialisation):
// * two 256-thread blocks an SM; a block computes kBM consecutive output
//   pixels of one output row
//   (b, t', h') times kBN output channels; 8 warps, 2 along M x 4 along N,
//   each a 64x32 tile of m16n8k32 s8 mma.sync;
// * K runs over slabs (dt, dh, 32 input channels): a slab's A is the
//   input row segment that all kW taps of the block read, (kBM-1)*sW + kW
//   pixels x 32 channels, quantized on load into shared memory once and
//   read by the kW taps as shifted rows; its B is the kW taps' kBN x 32
//   int8 weights;
// * the next slab's A is loaded into registers before the current slab's
//   mma and quantized into the other shared buffer after them; the mma
//   fragments are read with ldmatrix;
// * padding lives in the addressing: an edge-mode axis clamps the input
//   coordinate to [0, n-1] (the reference's pad materialised on the int8
//   tensor), a zero-mode axis reads 0; ragged M, N and Cin are masked;
// * offsets are 64-bit (the v1 level-0 input holds 2^31+ elements);
// * x / scale_x is rounded as one division rounds it (quant8: a product
//   with the reciprocal where that provably rounds alike, __fdiv_rn
//   where it might not) and the epilogue is __fmul_rn then __fadd_rn, so
//   no FMA contraction changes a rounding: the result is bit-equal to the
//   plain version;
// * the B slab (int8 weights) is copied with cp.async straight into the
//   other shared buffer, so only A passes through registers.
#include "common.cuh"

constexpr int kBM = 128;        // output pixels a block (along W')
constexpr int kBN = 128;        // output channels a block
constexpr int kBK = 32;         // input channels a slab (one mma k)
constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kRow = 48;        // shared bytes a row: 32 int8 + 16 of pad
constexpr int kMaxSlabRows = 384;  // (kBM-1)*sW + kW the A slab may hold
constexpr int kMaxKW = 3;
constexpr int kAIters = 2 * kMaxSlabRows / kThreads;   // 16-channel groups
constexpr int kBIters = 2 * kMaxKW * kBN / kThreads;   // 16-byte groups

struct ConvArgs {
  int B, T, H, W, Cin, Cin_pad, O;
  int kT, kH, kW, sT, sH, sW, lT, lH, lW;
  int edgeT, edgeH, edgeW;
  int To, Ho, Wo, n_wt, rows, vec;
};

// uint4 words holding 16 values of T
template <typename T>
struct Group {
  static constexpr int kWords = 16 * (int)sizeof(T) / 16;
  uint4 v[kWords];
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// value i (0..15) of a group, as fp32 (bf16 -> fp32 is exact)
template <typename T>
__device__ __forceinline__ float value(const Group<T>& g, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(g.v[i / 4], i % 4));
  } else {
    const uint32_t w = word(g.v[i / 8], (i % 8) / 2);
    return __uint_as_float(i % 2 ? (w & 0xffff0000u) : (w << 16));
  }
}

// round-half-even(fl(v / s)) clipped to +-127, bit for bit as
// quantize_act_static (which divides, rounding once).  The correctly
// rounded quotient costs an IEEE division (__fdiv_rn: a reciprocal, its
// refinement and a range check), which took 45 of 121 ms at the v1
// level-0 shape.  So the product t = v * fl(1/s) is taken first: t is
// within 2^-23 |v/s| of v/s (two roundings), and fl(v/s) within 2^-24
// |v/s|, so below |t| = 128 the two differ by less than 2^-15.  Where t lies
// farther than 2^-13 from every half-integer, fl(v/s) lies in the same
// open interval between half-integers, so both round to rint(t); where
// |t| >= 128, |fl(v/s)| > 127.5 and both clip.  Only the values within
// 2^-13 of a half-integer (about 1 in 2^12) take the division.
__device__ __forceinline__ int quant8(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  if (fabsf(t) >= 128.f) return t > 0.f ? 127 : -127;
  const float n = rintf(t);
  if (0.5f - fabsf(t - n) > 0x1p-13f) return max(-127, min(127, (int)n));
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}

template <typename T>
__device__ __forceinline__ void zero_group(Group<T>& g) {
#pragma unroll
  for (int k = 0; k < Group<T>::kWords; ++k) g.v[k] = make_uint4(0, 0, 0, 0);
}

// 16 channels from p, of which the first n are valid (the rest read 0)
template <typename T>
__device__ __forceinline__ void load_group(const T* p, int n, bool vec,
                                           Group<T>& g) {
  if (vec && n >= 16) {
#pragma unroll
    for (int k = 0; k < Group<T>::kWords; ++k)
      g.v[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
    return;
  }
  uint32_t w[4 * Group<T>::kWords];
  if constexpr (sizeof(T) == 4) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = i < n ? q[i] : 0u;
  } else {
    const uint16_t* q = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t lo = 2 * i < n ? q[2 * i] : 0u;
      const uint32_t hi = 2 * i + 1 < n ? q[2 * i + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
  }
#pragma unroll
  for (int k = 0; k < Group<T>::kWords; ++k)
    g.v[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

template <typename T>
__device__ __forceinline__ uint4 quant_group(const Group<T>& g, float s,
                                             float r) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      packed |= (uint32_t)(quant8(value(g, 4 * k + j), s, r) & 0xff)
                << (8 * j);
    w[k] = packed;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the input coordinate of output o's tap d on an axis, or -1 when it
// reads a zero pad; edge mode clamps
__device__ __forceinline__ int coord(int o, int s, int lo, int d, int n,
                                     int edge) {
  int i = o * s - lo + d;
  if (i < 0 || i >= n) {
    if (!edge) return -1;
    i = i < 0 ? 0 : n - 1;
  }
  return i;
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const unsigned char* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two blocks an SM (128 registers a thread, a few of them spilled): a
// block's load -> quantize -> sync -> mma steps run one after another, and
// only another block hides their latency (one block of 165 registers
// took 1.7x as long at the v1 level-0 shape, PERF.md §6)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3d_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ wpk,
                   const float* __restrict__ scale_x,
                   const float* __restrict__ scale_w,
                   const float* __restrict__ bias, T* __restrict__ y,
                   const ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_scale[kBN], s_bias[kBN];
  const int a_bytes = a.rows * kRow, b_bytes = a.kW * kBN * kRow;
  unsigned char* sa[2] = {smem, smem + a_bytes + b_bytes};
  unsigned char* sb[2] = {smem + a_bytes, smem + 2 * a_bytes + b_bytes};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps

  int blk = blockIdx.x;
  const int wt = blk % a.n_wt;
  blk /= a.n_wt;
  const int ho = blk % a.Ho;
  blk /= a.Ho;
  const int to = blk % a.To;
  const int b = blk / a.To;
  const int wo0 = wt * kBM, n0 = blockIdx.y * kBN;
  const int wbase = wo0 * a.sW - a.lW;

  const float sx = *scale_x, rx = __frcp_rn(sx);
  for (int n = tid; n < kBN; n += kThreads) {
    const int o = n0 + n;
    s_scale[n] = o < a.O ? __fmul_rn(sx, scale_w[o]) : 0.f;
    s_bias[n] = (bias != nullptr && o < a.O) ? bias[o] : 0.f;
  }

  const int n_cc = a.Cin_pad / kBK;
  const int n_slabs = a.kT * a.kH * n_cc;
  const int taps = a.kT * a.kH * a.kW;

  Group<T> ra[kAIters];

  // slab s: its A groups global -> registers (quantized by store), its B
  // bytes global -> shared buffer st with cp.async
  auto load = [&](int s, int st) {
    const int cc = s % n_cc, r = s / n_cc;
    const int dh = r % a.kH, dt = r / a.kH;
    const int ti = coord(to, a.sT, a.lT, dt, a.T, a.edgeT);
    const int hi = coord(ho, a.sH, a.lH, dh, a.H, a.edgeH);
#pragma unroll
    for (int k = 0; k < kAIters; ++k) {
      const int i = tid + k * kThreads;
      const int row = i >> 1, c = cc * kBK + (i & 1) * 16;
      zero_group(ra[k]);
      if (row >= a.rows || ti < 0 || hi < 0 || c >= a.Cin) continue;
      int wi = wbase + row;
      if (wi < 0 || wi >= a.W) {
        if (!a.edgeW) continue;
        wi = wi < 0 ? 0 : a.W - 1;
      }
      const int64_t off =
          (((int64_t)b * a.T + ti) * a.H + hi) * (int64_t)a.W + wi;
      load_group(x + off * a.Cin + c, a.Cin - c, a.vec != 0, ra[k]);
    }
#pragma unroll
    for (int k = 0; k < kBIters; ++k) {
      const int j = tid + k * kThreads;
      if (j >= a.kW * kBN * 2) continue;
      const int dw = j / (2 * kBN), rem = j % (2 * kBN);
      const int n = rem >> 1, half = rem & 1;
      const int tap = (dt * a.kH + dh) * a.kW + dw;
      const int64_t off = ((int64_t)(n0 + n) * taps + tap) * a.Cin_pad +
                          cc * kBK + half * 16;
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
          sb[st] + (j >> 1) * kRow + half * 16);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(wpk + off));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // registers -> shared buffer st, A quantized on the way
  auto store = [&](int st) {
#pragma unroll
    for (int k = 0; k < kAIters; ++k) {
      const int i = tid + k * kThreads;
      if ((i >> 1) < a.rows)
        *reinterpret_cast<uint4*>(sa[st] + (i >> 1) * kRow + (i & 1) * 16) =
            quant_group(ra[k], sx, rx);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  load(0, 0);
  store(0);
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    const int st = s & 1;
    if (s + 1 < n_slabs) load(s + 1, st ^ 1);
    for (int dw = 0; dw < a.kW; ++dw) {
      // fragments by ldmatrix: A's four 8x16-byte quarters of a 16x32
      // tile (rows +0/+8, bytes +0/+16) are a0..a3; B's two n-tiles'
      // halves are b[ni][0..1], b[ni+1][0..1]
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm * 64 + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(fa[mi],
                    sa[st] + (m * a.sW + dw) * kRow + 16 * (lane >> 4));
      }
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        const int n = wn * 32 + ni * 8 + (lane & 7) + 8 * (lane >> 4);
        uint32_t r[4];
        ldmatrix_x4(r, sb[st] + (dw * kBN + n) * kRow +
                           16 * ((lane >> 3) & 1));
        fb[ni][0] = r[0];
        fb[ni][1] = r[1];
        fb[ni + 1][0] = r[2];
        fb[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], fa[mi], fb[ni]);
    }
    if (s + 1 < n_slabs) store(st ^ 1);
    __syncthreads();
  }

  // epilogue: float(acc) * (scale_x*scale_w[o]), then + bias[o], rounded
  // once each (no FMA), then to T
  const int64_t row_base = (((int64_t)b * a.To + to) * a.Ho + ho) * a.Wo;
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wo = wo0 + wm * 64 + mi * 16 + g + half * 8;
      if (wo >= a.Wo) continue;
      T* out = y + (row_base + wo) * a.O;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wn * 32 + ni * 8 + tig * 2 + e;
          if (n0 + n >= a.O) continue;
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]),
                              s_scale[n]);
          if (has_bias) v = __fadd_rn(v, s_bias[n]);
          out[n0 + n] = from_f32<T>(v);
        }
      }
    }
  }
}

template <typename T>
static int launch(const void* x, const void* wpk, const void* scale_x,
                  const void* scale_w, const void* bias, void* y,
                  const ConvArgs& a, int64_t n_blocks, int n_tiles,
                  cudaStream_t s) {
  const int smem = 2 * (a.rows + a.kW * kBN) * kRow;
  cudaError_t e = cudaFuncSetAttribute(
      conv3d_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  conv3d_int8_kernel<T><<<dim3((unsigned)n_blocks, n_tiles), kThreads, smem,
                          s>>>(
      (const T*)x, (const int8_t*)wpk, (const float*)scale_x,
      (const float*)scale_w, (const float*)bias, (T*)y, a);
  return (int)cudaGetLastError();
}

// x (B,T,H,W,Cin) bf16|fp32; wpk (ceil(O/kBN)*kBN, kT*kH*kW, Cin_pad) int8
// with Cin_pad a multiple of kBK and zeros past O and Cin; scale_x a
// device fp32 scalar, scale_w (O,) fp32, bias (O,) fp32 or null; y
// (B,To,Ho,Wo,O) in x's dtype.  lo pads per axis (the hi pads are in the
// output extents); edge_* 1 for a clamped axis, 0 for zeros.  vec: x's
// rows may be read as 16-byte vectors.
CVVAE_EXPORT int cvvae_conv3d_int8(
    const void* x, const void* wpk, const void* scale_x, const void* scale_w,
    const void* bias, void* y, int B, int T, int H, int W, int cin,
    int cin_pad, int O, int kT, int kH, int kW, int sT, int sH, int sW,
    int lT, int lH, int lW, int edge_t, int edge_h, int edge_w, int To,
    int Ho, int Wo, int vec, int dtype, int device, void* stream) {
  const int rows = (kBM - 1) * sW + kW;
  if (rows > kMaxSlabRows || kW > kMaxKW || kW < 1 || cin_pad % kBK ||
      cin_pad < cin || B < 1 || To < 1 || Ho < 1 || Wo < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  const int n_wt = (Wo + kBM - 1) / kBM;
  const int64_t n_blocks = (int64_t)B * To * Ho * n_wt;
  const int n_tiles = (O + kBN - 1) / kBN;
  if (n_blocks > INT32_MAX || n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const ConvArgs a = {B,  T,  H,  W,  cin,    cin_pad, O,      kT,
                      kH, kW, sT, sH, sW,     lT,      lH,     lW,
                      edge_t, edge_h, edge_w, To,      Ho,     Wo,
                      n_wt,   rows,   vec};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    return launch<__nv_bfloat16>(x, wpk, scale_x, scale_w, bias, y, a,
                                 n_blocks, n_tiles, s);
  if (dtype == CVVAE_F32)
    return launch<float>(x, wpk, scale_x, scale_w, bias, y, a, n_blocks,
                         n_tiles, s);
  return (int)cudaErrorInvalidValue;
}
