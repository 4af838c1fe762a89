// K5: int8 3-D convolution with the dequantising epilogue, as two
// kernels: a quantize-and-pad staging pass (K5.stage, int8_stage) and an
// s8 implicit GEMM over the staged tensor (K5.gemm, int8_gemm).
//
// Computes what cvvae_tpu/ops/quant.py:256-269 (and conv_int8, :148-159)
// computes with XLA's int8 conv, which is no Pallas kernel: a conv of
// channels-last (B,T,H,W,Cin) x in bf16 or fp32, quantized to
// round-half-even(x / scale_x) clipped to +-127, with an int8 kernel
// (O,I,kT,kH,kW); s8*s8 summed in s32 (at most 27*512*127^2 < 2^31); then
// float(acc) * (scale_x*scale_w[o]) + bias[o], rounded to x's dtype.
// The sum is exact integer arithmetic, so any order gives the same bits.
//
// Bound on an H100: the v1 encoder's level-0 causal conv (17x720x1280,
// 128 -> 128, 27 taps) is 13.9 TOP, 7.0 ms at 1,979 TOP/s int8, against
// 2.4 ms of bytes: compute-bound.  The staging pass alone reads 4.0 GB of
// bf16 and writes 2.25 GB of int8: bytes-bound, 1.9 ms.
//
// The design follows the reference's three steps (quantize; materialise
// the edge pads on the int8 tensor; a zero-window int8 conv):
//
// K5.stage: one elementwise pass.  It writes xq (B, T+pT, H+pH, W', Cp)
//   int8 with every pad materialised: edge-mode axes replicate, zero-mode
//   axes, channels past Cin (Cp is Cin rounded up to the 128-channel K
//   chunk) and the columns past W + pW (W' is rounded up to a multiple of
//   the W stride) are 0.  Each value is rounded by quant8 (common.cuh),
//   once.  An int8 input (an int8-resident activation,
//   cvvae_tpu/ops/qflow.py:90-92) is only padded: 16 bytes copied a
//   thread, no quantization.
//
// K5.gemm: a pure s8 implicit GEMM over xq, with no quantization, pad
//   logic or input dtype in its inner loop; only the epilogue's output
//   type is templated.
//   * A tile is BM output pixels along one output row (b, t', h') x kBN
//     output channels; BM = 256, or 128 where that leaves fewer pixels of
//     a ragged row idle.  K runs over (dt, dh, 128-channel chunk, dw).
//   * Two consumer warpgroups, each 64 of the tile's channels x its BM
//     pixels: wgmma m64n256k32 (or m64n128k32) s32.s8.s8 with the weights
//     as its A and the pixels as its B (the other way round from the
//     implicit GEMM's A = pixels, B = weights, the names used for the
//     rings and loads below), both K-major in shared memory with the
//     128-byte swizzle (a 128-channel int8 row is one swizzle row), s32
//     accumulators in registers.  Both operands come from shared memory,
//     whose reads bound the products at these tiles: a k-step of the
//     block reads 2 x (2 + 8) KB for 2 M operations (two m64n128 tiles
//     of pixels as A would read 4 x (2 + 4) KB).
//   * One producer warp issues TMA loads into two mbarrier rings: A strips
//     and B taps.  At W stride 1 an A strip is the input row segment that
//     all kW taps of a (dt, dh, chunk) read, BM + kW - 1 pixels, loaded
//     once; tap dw's descriptor starts dw rows into it (the wgmma swizzle
//     is a function of the shared address, as TMA's is, so a start off
//     the 1024-byte pattern needs no base offset).  At W stride 2 the
//     tensor map splits W into (parity, W'/2), so each tap reads a
//     contiguous run of one parity: one A load a tap.
//   * B is the int8 kernel packed once per module as (O_pad, taps, Cp)
//     (ops/kernels/conv_int8.py::pack_weight), read as 128 x 128-byte
//     tiles.
//   * Persistent: about one block an SM walks tiles with neighbouring
//     indices (output channels inside W inside rows), so the blocks in
//     flight share their input rows in L2, and the producer loads the next
//     tile while the consumers write this one out.
//   * Epilogue: __fmul_rn(float(acc), __fmul_rn(scale_x, scale_w[o])),
//     then __fadd_rn of the bias, cast to the output dtype (x's, or the
//     one the caller names), or with an int8 output requantized by
//     quant8 at out_scale[o] (qflow.py:97-103: the int8-resident mode);
//     the ragged W' and O tails are masked.
//
// kBN, kKC, kMaxKW and kMaxSW are read by ops/kernels/conv_int8.py (and
// its CPU tests) from this file.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBN = 128;        // output channels a tile
constexpr int kKC = 128;        // input channels (bytes) a K chunk
constexpr int kMaxKW = 3;       // widest kernel along W
constexpr int kMaxSW = 2;       // largest stride along W
constexpr int kBox = 128;       // A rows a TMA box
constexpr int kTail = 8;        // rows of a strip's tail box (kW - 1 <= 8)
constexpr int kAStages = 3;     // A strips in the ring
constexpr int kBStages = 6;     // B taps in the ring
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
// one A strip a (dt, dh, chunk), read by its kW taps (W stride 1)
constexpr bool kReuseA = true;

// ------------------------------------------------------------ K5.stage --

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

// the source index of staged index i on an axis of n values with lo
// leading pads, or -1 where it is a zero pad; edge mode clamps
__device__ __forceinline__ int source(int i, int lo, int n, int edge) {
  i -= lo;
  if (i < 0 || i >= n) {
    if (!edge) return -1;
    i = i < 0 ? 0 : n - 1;
  }
  return i;
}

// 16 int8 values from p, of which the first n are valid (the rest read 0)
__device__ __forceinline__ uint4 load_int8(const int8_t* p, int n,
                                           bool vec) {
  if (vec && n >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) w[i / 4] |= (uint32_t)(uint8_t)p[i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct StageArgs {
  int T, H, W, Cin, Cp;
  int Tp, Hp, Wp, Wv;  // staged extents; columns from Wv on are zeros
  int lT, lH, lW, edgeT, edgeH, edgeW, vec;
};

// one block a staged row (b, t', h'), its threads walking the row's
// 16-channel groups: 16 values in, one 16-byte store out, neighbouring
// threads on neighbouring bytes; the row's source and a zero row are
// worked out once a block, so the loop has no 64-bit division
template <typename T>
__global__ void __launch_bounds__(256)
int8_stage(const T* __restrict__ x, const float* __restrict__ scale_x,
           uint4* __restrict__ xq, const StageArgs a) {
  const int groups = a.Cp / 16;
  const int n = a.Wp * groups;  // groups a staged row
  const int64_t row = blockIdx.x;
  const int h = (int)(row % a.Hp);
  const int t = (int)(row / a.Hp % a.Tp);
  const int64_t b = row / a.Hp / a.Tp;
  uint4* out = xq + row * n;
  const int ti = source(t, a.lT, a.T, a.edgeT);
  const int hi = source(h, a.lH, a.H, a.edgeH);
  if (ti < 0 || hi < 0) {  // a zero pad row
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      out[j] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  // an int8 input is copied as it is (scale_x is not read)
  const float sx = sizeof(T) == 1 ? 1.f : *scale_x, rx = __frcp_rn(sx);
  const T* src = x + ((b * a.T + ti) * a.H + hi) * (int64_t)a.W * a.Cin;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int w = j / groups, c = (j - w * groups) * 16;
    const int wi = w < a.Wv ? source(w, a.lW, a.W, a.edgeW) : -1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (wi >= 0 && c < a.Cin) {
      if constexpr (sizeof(T) == 1) {
        v = load_int8(src + (int64_t)wi * a.Cin + c, a.Cin - c, a.vec != 0);
      } else {
        Group<T> g;
        load_group(src + (int64_t)wi * a.Cin + c, a.Cin - c, a.vec != 0, g);
        v = quant_group(g, sx, rx);
      }
    }
    out[j] = v;
  }
}

// ------------------------------------------------------------- K5.gemm --

// shared memory of a block, from a 1024-byte-aligned base: the A ring
// (strips of BM + kTail rows of 128 bytes), the B ring (kBN rows of 128
// bytes a tap), then the barriers
template <int NP>
struct Smem {
  static constexpr int kBM = NP;
  static constexpr int kABytes = (kBM + kTail) * 128;
  static constexpr int kBBytes = kBN * 128;
  static constexpr int kBOff = kAStages * kABytes;
  static constexpr int kBarOff = kBOff + kBStages * kBBytes;
  static constexpr int kBytes = kBarOff + 2 * (kAStages + kBStages) * 8 + 1024;
};

struct GemmArgs {
  int Tp, Hp, O;
  int kT, kH, kW, sT, sH, sW;
  int oT, oH, oW;  // the conv window's origin in the staged tensor
  int To, Ho, Wo;
  int n_wt, n_nt, n_cc, n_tiles;
  int reuse;       // one A strip a (dt, dh, chunk)
};

struct Tile {
  int b, to, ho, wo0, nt;
};

// tile index -> its output row, first pixel and channel tile: channel
// tiles inside W tiles inside rows, so neighbouring tiles share input rows
__device__ __forceinline__ Tile decode(int idx, const GemmArgs& a, int bm) {
  Tile t;
  t.nt = idx % a.n_nt;
  idx /= a.n_nt;
  t.wo0 = (idx % a.n_wt) * bm;
  idx /= a.n_wt;
  t.ho = idx % a.Ho;
  idx /= a.Ho;
  t.to = idx % a.To;
  t.b = idx / a.To;
  return t;
}

// (dt, dh) rows of taps a tile's K loop runs over
__device__ __forceinline__ int tap_rows(const GemmArgs& a) {
  return a.kT * a.kH;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one box of the staged tensor, seen as (Cp, sW, W'/sW, Hp, B*Tp)
__device__ __forceinline__ void tma_load_a(uint32_t dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int c, int parity,
                                           int q, int h, int bt) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(parity), "r"(q), "r"(h), "r"(bt)
      : "memory");
}

// one tap's kBN x 128 channels of the packed kernel (Cp, taps, O_pad)
__device__ __forceinline__ void tma_load_b(uint32_t dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int c, int tap,
                                           int o) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(tap), "r"(o)
      : "memory");
}

// keep the compiler from moving accesses of wgmma's registers across its
// issue and its wait
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64xNP] (+)= A[64x32] B[32xNP], s8 operands K-major in shared, s32
// accumulators; scale_d 0: D = A B, D not read
#define CVVAE_D64(c, o)                                                       \
  c(d[o + 0]), c(d[o + 1]), c(d[o + 2]), c(d[o + 3]), c(d[o + 4]),             \
      c(d[o + 5]), c(d[o + 6]), c(d[o + 7]), c(d[o + 8]), c(d[o + 9]),         \
      c(d[o + 10]), c(d[o + 11]), c(d[o + 12]), c(d[o + 13]), c(d[o + 14]),    \
      c(d[o + 15]), c(d[o + 16]), c(d[o + 17]), c(d[o + 18]), c(d[o + 19]),    \
      c(d[o + 20]), c(d[o + 21]), c(d[o + 22]), c(d[o + 23]), c(d[o + 24]),    \
      c(d[o + 25]), c(d[o + 26]), c(d[o + 27]), c(d[o + 28]), c(d[o + 29]),    \
      c(d[o + 30]), c(d[o + 31]), c(d[o + 32]), c(d[o + 33]), c(d[o + 34]),    \
      c(d[o + 35]), c(d[o + 36]), c(d[o + 37]), c(d[o + 38]), c(d[o + 39]),    \
      c(d[o + 40]), c(d[o + 41]), c(d[o + 42]), c(d[o + 43]), c(d[o + 44]),    \
      c(d[o + 45]), c(d[o + 46]), c(d[o + 47]), c(d[o + 48]), c(d[o + 49]),    \
      c(d[o + 50]), c(d[o + 51]), c(d[o + 52]), c(d[o + 53]), c(d[o + 54]),    \
      c(d[o + 55]), c(d[o + 56]), c(d[o + 57]), c(d[o + 58]), c(d[o + 59]),    \
      c(d[o + 60]), c(d[o + 61]), c(d[o + 62]), c(d[o + 63])
#define CVVAE_RW(x) "+r"(x)
template <int NP>
__device__ __forceinline__ void wgmma_s8(int (&d)[NP / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (NP == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : CVVAE_D64(CVVAE_RW, 0), CVVAE_D64(CVVAE_RW, 64)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    static_assert(NP == 128, "64 x 128 or 64 x 256 tiles");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : CVVAE_D64(CVVAE_RW, 0)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}
#undef CVVAE_D64
#undef CVVAE_RW

__device__ __forceinline__ void advance(int& stage, int& phase, int n) {
  if (++stage == n) {
    stage = 0;
    phase ^= 1;
  }
}

// two adjacent output channels; ``pair``: one aligned store takes both
template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1, bool two,
                                       bool pair) {
  if constexpr (sizeof(T) == 1) {  // v0, v1 are int8 codes
    if (pair) {
      *reinterpret_cast<char2*>(p) = make_char2((signed char)v0,
                                                (signed char)v1);
      return;
    }
    p[0] = (T)v0;
    if (two) p[1] = (T)v1;
  } else {
    if (pair) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(v0, v1);
      }
      return;
    }
    p[0] = from_f32<T>(v0);
    if (two) p[1] = from_f32<T>(v1);
  }
}

// Warps 0-7: two consumer warpgroups, warpgroup wg computing the tile's
// 64 channels [64 wg, + 64) x its NP pixels, each k-step one wgmma with
// the weights as A and the pixels as B (both warpgroups read the same
// pixel rows); warp 8: the producer (its lane 0 issues every load).  The
// consumers release a stage after the next tap's products are issued and
// the previous ones have completed (wgmma_wait<1>), so one tap's products
// are always queued behind the running ones.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm(const __grid_constant__ CUtensorMap map_a,
          const __grid_constant__ CUtensorMap map_tail,
          const __grid_constant__ CUtensorMap map_b,
          const float* __restrict__ scale_x,
          const float* __restrict__ scale_w, const float* __restrict__ bias,
          const float* __restrict__ out_scale, T* __restrict__ y,
          const GemmArgs a) {
  using S = Smem<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + (base - raw) +
                                               S::kBarOff);
  uint64_t* a_full = bars;
  uint64_t* a_empty = bars + kAStages;
  uint64_t* b_full = bars + 2 * kAStages;
  uint64_t* b_empty = b_full + kBStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kAStages; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], 4 * kConsumers);
    }
    for (int i = 0; i < kBStages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer
    if (lane != 0) return;
    prefetch_map(&map_a);
    prefetch_map(&map_tail);
    prefetch_map(&map_b);
    int as = 0, ap = 0, bs = 0, bp = 0;
    for (int idx = blockIdx.x; idx < a.n_tiles; idx += gridDim.x) {
      const Tile t = decode(idx, a, S::kBM);
      for (int r = 0; r < tap_rows(a); ++r) {
        const int dt = r / a.kH, dh = r % a.kH;
        const int bt = t.b * a.Tp + a.oT + t.to * a.sT + dt;
        const int h = a.oH + t.ho * a.sH + dh;
        for (int cc = 0; cc < a.n_cc; ++cc) {
          if (a.reuse) {  // rows [oW + wo0, + BM + kTail) of the row
            mbar_wait(&a_empty[as], ap ^ 1);
            mbar_expect_tx(&a_full[as], S::kABytes);
            const uint32_t dst = base + as * S::kABytes;
            const int q = a.oW + t.wo0;
#pragma unroll
            for (int i = 0; i < S::kBM / kBox; ++i)
              tma_load_a(dst + i * kBox * 128, &map_a, &a_full[as], cc * kKC,
                         0, q + i * kBox, h, bt);
            tma_load_a(dst + S::kBM * 128, &map_tail, &a_full[as], cc * kKC,
                       0, q + S::kBM, h, bt);
            advance(as, ap, kAStages);
          }
          for (int dw = 0; dw < a.kW; ++dw) {
            if (!a.reuse) {  // tap dw's BM pixels, one parity of W
              mbar_wait(&a_empty[as], ap ^ 1);
              mbar_expect_tx(&a_full[as], S::kBM * 128);
              const uint32_t dst = base + as * S::kABytes;
              const int par = (a.oW + dw) % a.sW;
              const int q = (a.oW + dw) / a.sW + t.wo0;
#pragma unroll
              for (int i = 0; i < S::kBM / kBox; ++i)
                tma_load_a(dst + i * kBox * 128, &map_a, &a_full[as],
                           cc * kKC, par, q + i * kBox, h, bt);
              advance(as, ap, kAStages);
            }
            mbar_wait(&b_empty[bs], bp ^ 1);
            mbar_expect_tx(&b_full[bs], S::kBBytes);
            tma_load_b(base + S::kBOff + bs * S::kBBytes, &map_b, &b_full[bs],
                       cc * kKC, r * a.kW + dw, t.nt * kBN);
            advance(bs, bp, kBStages);
          }
        }
      }
    }
    return;
  }

  // the consumers
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q4 = lane & 3;
  const float sx = __ldg(scale_x);
  // channel c's dequantising scale, rounded as the plain version rounds it
  auto scale = [&](int c) { return __fmul_rn(sx, __ldg(scale_w + c)); };
  const bool pair = (a.O & 1) == 0;
  int as = 0, ap = 0, bs = 0, bp = 0;
  int acc[NP / 2];
  for (int idx = blockIdx.x; idx < a.n_tiles; idx += gridDim.x) {
    const Tile t = decode(idx, a, S::kBM);
    int rel_a = -1, rel_b = -1;  // the last tap's stages, to release
    bool first = true;
    for (int r = 0; r < tap_rows(a); ++r) {
      for (int cc = 0; cc < a.n_cc; ++cc) {
        int strip = as;
        if (a.reuse) {
          mbar_wait(&a_full[as], ap);
          advance(as, ap, kAStages);
        }
        for (int dw = 0; dw < a.kW; ++dw) {
          int row0 = dw;
          if (!a.reuse) {
            strip = as;
            row0 = 0;
            mbar_wait(&a_full[as], ap);
            advance(as, ap, kAStages);
          }
          mbar_wait(&b_full[bs], bp);
          const uint32_t px = base + strip * S::kABytes + row0 * 128;
          const uint32_t wt = base + S::kBOff + bs * S::kBBytes + wg * 64 * 128;
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < kKC / 32; ++k)
            wgmma_s8<NP>(acc, sw128_desc(wt + k * 32, 16, 1024),
                         sw128_desc(px + k * 32, 16, 1024), !first || k > 0);
          wgmma_commit();
          wgmma_wait<1>();
          if (lane == 0) {
            if (rel_b >= 0) mbar_arrive(&b_empty[rel_b]);
            if (rel_a >= 0) mbar_arrive(&a_empty[rel_a]);
          }
          rel_b = bs;
          rel_a = (!a.reuse || dw == a.kW - 1) ? strip : -1;
          advance(bs, bp, kBStages);
          first = false;
        }
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) {
      if (rel_b >= 0) mbar_arrive(&b_empty[rel_b]);
      if (rel_a >= 0) mbar_arrive(&a_empty[rel_a]);
    }

    // epilogue: accumulator 4j + 2h + e of (warp wq, lane (g, q4)) is
    // channel 64 wg + 16 wq + g + 8h, pixel 8j + 2 q4 + e.  Lanes g and
    // g ^ 1 swap a value, so that each holds two adjacent channels of one
    // pixel (g even: pixel 8j + 2 q4, g odd: the next) for one store.
    const int64_t row =
        (((int64_t)t.b * a.To + t.to) * a.Ho + t.ho) * (int64_t)a.Wo;
    const bool even = (g & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = t.nt * kBN + wg * 64 + 16 * wq + g + 8 * h;
      const int c0 = even ? c : c - 1;  // the pair's first channel
      const float sc = c < a.O ? scale(c) : 0.f;
      const float bc = bias != nullptr && c < a.O ? __ldg(bias + c) : 0.f;
      // an int8 output: channel c's requantizing scale and its reciprocal
      const float os = sizeof(T) == 1 && c < a.O ? __ldg(out_scale + c) : 1.f;
      const float ro = __frcp_rn(os);
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sc);
        float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sc);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, bc);
          v1 = __fadd_rn(v1, bc);
        }
        if constexpr (sizeof(T) == 1) {  // requantized in channel c
          v0 = (float)quant8(v0, os, ro);
          v1 = (float)quant8(v1, os, ro);
        }
        const float other = __shfl_xor_sync(0xffffffffu, even ? v1 : v0, 4);
        const int wo = t.wo0 + 8 * j + 2 * q4 + (even ? 0 : 1);
        if (wo < a.Wo && c0 < a.O)
          store2(y + (row + wo) * a.O + c0, even ? v0 : other,
                 even ? other : v1, c0 + 1 < a.O, pair);
      }
    }
  }
}

// an int8 tensor of ``rank`` dims (innermost first) read in ``box``es of
// 128-byte-swizzled rows; reads past an edge give zeros
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the device's SM count, asked once a device
int num_sms(int device) {
  static int known[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (known[device] == 0 &&
      cudaDeviceGetAttribute(&known[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    known[device] = 0;
  return known[device];
}

template <typename T, int NP>
int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mt,
                const CUtensorMap& mb, const void* scale_x,
                const void* scale_w, const void* bias, const void* out_scale,
                void* y, const GemmArgs& a, int n_sms, cudaStream_t s) {
  using S = Smem<NP>;
  const cudaError_t e = cudaFuncSetAttribute(
      int8_gemm<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (e != cudaSuccess) return (int)e;
  // about one block an SM, each walking tiles
  const int grid = a.n_tiles > n_sms ? n_sms : a.n_tiles;
  int8_gemm<T, NP><<<grid, kThreads, S::kBytes, s>>>(
      ma, mt, mb, (const float*)scale_x, (const float*)scale_w,
      (const float*)bias, (const float*)out_scale, (T*)y, a);
  return (int)cudaGetLastError();
}

}  // namespace

// K5.stage.  x (B,T,H,W,cin) bf16|fp32 contiguous, or int8 (padded
// only); scale_x a device fp32 scalar (not read for int8, may be null);
// xq (B,tp,hp,wp,cp) int8 with tp = T + both T pads, hp likewise,
// wv = W + both W pads <= wp, cp a multiple of 16 >= cin.  lo pads per
// axis; edge_* 1 for a replicated axis, 0 for zeros.  vec: x's rows may be
// read as 16-byte vectors.
CVVAE_EXPORT int cvvae_int8_stage(const void* x, const void* scale_x,
                                  void* xq, int B, int T, int H, int W,
                                  int cin, int cp, int tp, int hp, int wp,
                                  int wv, int lT, int lH, int lW, int edge_t,
                                  int edge_h, int edge_w, int vec, int dtype,
                                  int device, void* stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || cin < 1 || cp % 16 || cp < cin ||
      wv > wp || lT < 0 || lH < 0 || lW < 0 || tp < T + lT || hp < H + lH ||
      wv < W + lW)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const StageArgs a = {T,  H,  W,      cin,    cp,     tp,  hp, wp, wv,
                       lT, lH, lW,     edge_t, edge_h, edge_w, vec};
  const int64_t rows = (int64_t)B * tp * hp;
  if (rows > INT32_MAX || (int64_t)wp * (cp / 16) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    int8_stage<__nv_bfloat16><<<(unsigned)rows, 256, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)scale_x, (uint4*)xq, a);
  else if (dtype == CVVAE_F32)
    int8_stage<float><<<(unsigned)rows, 256, 0, s>>>(
        (const float*)x, (const float*)scale_x, (uint4*)xq, a);
  else if (dtype == CVVAE_I8)
    int8_stage<int8_t><<<(unsigned)rows, 256, 0, s>>>(
        (const int8_t*)x, (const float*)scale_x, (uint4*)xq, a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K5.gemm.  xq (B,tp,hp,wp,cp) int8 from K5.stage, wp a multiple of sW,
// cp of kKC; wpk (o_pad, kT*kH*kW, cp) int8, o_pad a multiple of kBN,
// zeros past O and past the input channels; scale_x a device fp32 scalar,
// scale_w (O,) fp32, bias (O,) fp32 or null; y (B,To,Ho,Wo,O) in
// ``dtype``: bf16, fp32, or int8 requantized by out_scale (O,) fp32 (read
// only for an int8 output).  Output pixel (t, h, w) tap (dt, dh, dw) reads xq at
// (oT + t*sT + dt, oH + h*sH + dh, oW + w*sW + dw), inside the tensor.
CVVAE_EXPORT int cvvae_int8_gemm(const void* xq, const void* wpk,
                                 const void* scale_x, const void* scale_w,
                                 const void* bias, const void* out_scale,
                                 void* y, int B, int tp,
                                 int hp, int wp, int cp, int O, int o_pad,
                                 int kT, int kH, int kW, int sT, int sH,
                                 int sW, int oT, int oH, int oW, int To,
                                 int Ho, int Wo, int dtype, int device,
                                 void* stream) {
  if (B < 1 || O < 1 || cp < kKC || cp % kKC || o_pad < O || o_pad % kBN ||
      kT < 1 || kH < 1 || kW < 1 || kW > kMaxKW || sT < 1 || sH < 1 ||
      sW < 1 || sW > kMaxSW || wp % sW || oT < 0 || oH < 0 || oW < 0 ||
      To < 1 || Ho < 1 || Wo < 1 || oT + (To - 1) * sT + kT > tp ||
      oH + (Ho - 1) * sH + kH > hp || oW + (Wo - 1) * sW + kW > wp ||
      (int64_t)B * tp >= INT32_MAX ||
      (dtype == CVVAE_I8 && out_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const int n_sms = num_sms(device);
  if (n_sms < 1) return (int)cudaErrorInvalidValue;
  // BM 256 unless 128 leaves fewer pixels of the row idle
  const int waste256 = (Wo + 255) / 256 * 256 - Wo;
  const int waste128 = (Wo + 127) / 128 * 128 - Wo;
  const bool wide = waste256 <= waste128;
  const int bm = wide ? 256 : 128;
  GemmArgs a;
  a.Tp = tp;
  a.Hp = hp;
  a.O = O;
  a.kT = kT;
  a.kH = kH;
  a.kW = kW;
  a.sT = sT;
  a.sH = sH;
  a.sW = sW;
  a.oT = oT;
  a.oH = oH;
  a.oW = oW;
  a.To = To;
  a.Ho = Ho;
  a.Wo = Wo;
  a.n_wt = (Wo + bm - 1) / bm;
  a.n_nt = o_pad / kBN;
  a.n_cc = cp / kKC;
  a.reuse = kReuseA && sW == 1;
  const int64_t n_tiles = (int64_t)B * To * Ho * a.n_wt * a.n_nt;
  if (n_tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)n_tiles;

  // A: (cp, sW, wp / sW, hp, B * tp), boxes of 128 channels x kBox (or
  // kTail) pixels; B: (cp, taps, o_pad), boxes of 128 channels x kBN
  CUtensorMap ma, mt, mb;
  const cuuint64_t a_dims[5] = {(cuuint64_t)cp, (cuuint64_t)sW,
                                (cuuint64_t)(wp / sW), (cuuint64_t)hp,
                                (cuuint64_t)B * tp};
  const cuuint64_t a_strides[4] = {(cuuint64_t)cp, (cuuint64_t)sW * cp,
                                   (cuuint64_t)wp * cp,
                                   (cuuint64_t)hp * wp * cp};
  const cuuint32_t a_box[5] = {kKC, 1, kBox, 1, 1};
  const cuuint32_t t_box[5] = {kKC, 1, kTail, 1, 1};
  const int taps = kT * kH * kW;
  const cuuint64_t b_dims[3] = {(cuuint64_t)cp, (cuuint64_t)taps,
                                (cuuint64_t)o_pad};
  const cuuint64_t b_strides[2] = {(cuuint64_t)cp, (cuuint64_t)taps * cp};
  const cuuint32_t b_box[3] = {kKC, 1, kBN};
  if (!make_map(&ma, xq, 5, a_dims, a_strides, a_box) ||
      !make_map(&mt, xq, 5, a_dims, a_strides, t_box) ||
      !make_map(&mb, wpk, 3, b_dims, b_strides, b_box))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    return wide ? launch_gemm<__nv_bfloat16, 256>(ma, mt, mb, scale_x, scale_w,
                                                bias, out_scale, y, a, n_sms,
                                                s)
                : launch_gemm<__nv_bfloat16, 128>(ma, mt, mb, scale_x, scale_w,
                                                bias, out_scale, y, a, n_sms,
                                                s);
  if (dtype == CVVAE_F32)
    return wide ? launch_gemm<float, 256>(ma, mt, mb, scale_x, scale_w, bias,
                                        out_scale, y, a, n_sms, s)
                : launch_gemm<float, 128>(ma, mt, mb, scale_x, scale_w, bias,
                                        out_scale, y, a, n_sms, s);
  if (dtype == CVVAE_I8)
    return wide ? launch_gemm<int8_t, 256>(ma, mt, mb, scale_x, scale_w, bias,
                                         out_scale, y, a, n_sms, s)
                : launch_gemm<int8_t, 128>(ma, mt, mb, scale_x, scale_w, bias,
                                         out_scale, y, a, n_sms, s);
  return (int)cudaErrorInvalidValue;
}
