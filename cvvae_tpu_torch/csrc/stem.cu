// K3: 3x3x3 stride-1 conv with few input channels (Cin <= 4) to 128
// output channels: the encoder's conv_in at full pixel resolution.
//
// Replaces cvvae_tpu/ops/pallas/stem.py::stem_conv3d, which contracts on
// the TPU's matrix unit (one 27-deep dot a row, operands in the input
// dtype, fp32 accumulation).  The conv is a GEMM here too: M = output
// pixels, N = 128 channels, K = the 27 taps x Cin.  What bounds it on an
// H100 is the output write, 128 channels per input pixel (4.0 GB in bf16
// for a 17-frame 720p clip, 1.2 ms at 3.35 TB/s).  In bf16 the products
// (325 GFLOP) take a third of that on the tensor cores; in fp32, on exact
// FMAs at 67 TFLOP/s, they bound the kernel instead (4.9 ms).
//
// Both kernels are persistent: one block an SM, each of its warpgroups a
// worker that walks its own tiles (the schedule of ops/kernels/stem.py::
// tile_plan) and syncs on its own named barrier, so the workers of an SM
// overlap one's products with another's loads and stores.  A tile is one
// row segment of kTW output pixels x 128 channels, a contiguous span of
// the output.  Its input patch (3 frames x 3 rows x (kTW + 2) pixels) is
// copied with cp.async two tiles ahead (Loader), then laid out in shared
// memory; the padding is folded into that (time clamped in edge mode, H,
// W and zero-mode time masked), so no padded copy of the input exists.
// Tiles run frames inside rows, so the tiles in flight share input rows in
// L2.  The weights are loaded once a block.
//
// bf16 (stem_conv_mma): wgmma m64n128k16, A (the patch) in registers, B
// (the weights, 128-byte swizzled) in shared memory, fp32 accumulators.
// K runs over (dt, dh, dw, ci) with the pixel padded to 4 channels, so each
// lane's A pair of a k-step is one aligned 8-byte load of a patch pixel;
// 27 taps x 4 = 108, padded to 112 (7 k-steps) by a 28th tap whose patch
// row is (1, 0, 0, 0) at every pixel and whose weights are the bias, so
// the bias is added in the fp32 accumulation and each value rounded once.
// The wrapper packs the weights once a call as (128, 112) bf16.  Patch rows
// are 148 words apart (20 mod 32 banks), so a load spanning two rows hits
// distinct banks.  GEMM columns are permuted so a lane's accumulators of a
// pixel are runs of 8 channels: 16-byte stores into a shared stage buffer
// (two a worker), written out by one cp.async.bulk store a tile, which
// overlaps the next tile's products.
//
// fp32 (stem_conv_fma): exact fp32 FMAs (no TF32).  Each warp owns 16
// pixels and each lane 4 channels of the tile; per patch row and channel
// it reads the warp's 18 inputs as 5 broadcast float4 and, per tap, one
// float4 of the weights, and it writes each pixel's 128 channels as one
// 512-byte coalesced row of 16-byte stores.
//
// kCout, kTW, kK, kMmaWorkers and kFmaWorkers are read by ops/kernels/
// stem.py (tile_plan, pack_weight and their tests) from this file.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kCout = 128;
constexpr int kTW = 64;                 // output pixels a tile
constexpr int kPW = kTW + 2;            // patch pixels a row
constexpr int kRows = 9;                // (dt, dh) patch rows
constexpr int kWG = 128;                // threads a worker (a warpgroup)
constexpr int kMmaWorkers = 3;          // bf16: workers a block
constexpr int kFmaWorkers = 2;          // fp32: workers a block
// bf16: 4 channels (2 words) a patch pixel, rows kRowWords apart (20 mod
// 32 banks); row kRows is the bias tap's row, each pixel (1, 0, 0, 0)
constexpr int kRowWords = 148;
constexpr int kPatchWords = (kRows + 1) * kRowWords;
constexpr int kK = 112;                 // packed weight row: 28 taps x 4
constexpr int kKSteps = kK / 16;
constexpr int kBBytes = 2 * kCout * 128;            // B: two 64-column boxes
constexpr int kStageBytes = kTW * kCout * 2;        // one bf16 tile
constexpr int kStages = 2;                          // stage buffers a worker
constexpr int kRegion = kStages * kStageBytes + kPatchWords * 4;  // a worker's
// fp32: one patch row a (dt, dh, ci), kPWF floats (16-byte rows)
constexpr int kPWF = 68;

struct Tile {
  int64_t b;
  int to, ho, w0, np;
};

// tile index -> (b, t_out, h_out, first output column, pixels), frames
// inner to rows so the tiles in flight share their input rows in L2; the
// same decode as ops/kernels/stem.py::tile_origin
__device__ __forceinline__ Tile decode(int idx, int n_wt, int T_out,
                                       int H_out, int W_out) {
  Tile t;
  const int wt = idx % n_wt;
  int rest = idx / n_wt;
  t.to = rest % T_out;
  rest /= T_out;
  t.ho = rest % H_out;
  t.b = rest / H_out;
  t.w0 = wt * kTW;
  t.np = min(kTW, W_out - t.w0);
  return t;
}

struct Geom {
  int64_t B;
  int T_in, H, W, pt0, ph0, pw0, t_edge;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The input patch of a tile, row r = dt*3 + dh: its kPW pixels (input
// columns w0 - pw0 ...) start at input element elem0 of row (b, ti, hi),
// in the tensor unless the row is padding.  The padding is folded in
// here: time is clamped in edge mode and masked in zero mode, H masked;
// W is masked per pixel in `relayout`.
__device__ __forceinline__ int64_t patch_row(const Tile& t, const Geom& g,
                                             int r, int cin, bool& ok) {
  int ti = t.to + r / 3 - g.pt0;
  const int hi = t.ho + r % 3 - g.ph0;
  ok = hi >= 0 && hi < g.H;
  if (g.t_edge)
    ti = min(max(ti, 0), g.T_in - 1);
  else
    ok = ok && ti >= 0 && ti < g.T_in;
  return (((t.b * g.T_in + ti) * g.H + hi) * (int64_t)g.W + t.w0 - g.pw0) * cin;
}

// A worker's patch in two steps.  `issue`: the 16-byte granules that hold
// each patch row's elements, copied with cp.async.cg (L2 to shared memory,
// no registers) into a raw buffer, rows kNC granules apart; a granule
// wholly outside the tensor, or of a padding row, is zero-filled.  A
// granule is aligned in memory, so one that holds any of the tensor's
// bytes lies in its allocation.  The buffer's head holds each row's first
// byte within its first granule, or -1 for a padding row.  `relayout`,
// after the copies have landed: each pixel's CIN values from the raw
// buffer into the kernel's patch layout, zero where the column is W
// padding.
template <typename T, int CIN>
struct Loader {
  // granules a row span: its bytes, and up to 15 before them
  static constexpr int kNC = (kPW * CIN * (int)sizeof(T) + 15 + 15) / 16;
  static constexpr int kSlots = (kRows * kNC + kWG - 1) / kWG;
  static constexpr int kPixSlots = (kRows * kPW + kWG - 1) / kWG;
  static constexpr int kHead = 16;  // kRows row offsets, int8
  static constexpr int kRawBytes = kHead + kRows * kNC * 16;

  const uint8_t* xa;  // x rounded down to 16 bytes
  int off0;           // x - xa
  int64_t n_bytes;

  __device__ __forceinline__ Loader(const T* x, const Geom& g)
      : xa(reinterpret_cast<const uint8_t*>((uintptr_t)x & ~(uintptr_t)15)),
        off0((int)((uintptr_t)x & 15)),
        n_bytes(g.B * g.T_in * g.H * (int64_t)g.W * CIN * (int64_t)sizeof(T)) {}

  // one commit group a call, empty where !live (no tile)
  __device__ __forceinline__ void issue(const Tile& tl, const Geom& g,
                                        uint8_t* raw, int t, bool live) const {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = t + s * kWG;
      if (live && e < kRows * kNC) {
        const int r = e / kNC, j = e - r * kNC;
        bool ok;
        // the row's first byte from xa (negative before the tensor)
        const int64_t b0 = off0 + patch_row(tl, g, r, CIN, ok) * (int64_t)sizeof(T);
        if (j == 0) raw[r] = ok ? (int8_t)(b0 & 15) : (int8_t)-1;
        const int64_t gr = (b0 >> 4) + j;  // granule
        ok = ok && 16 * gr + 16 > off0 && 16 * gr < off0 + n_bytes;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_u32(raw + kHead + 16 * e)),
                     "l"(xa + (ok ? 16 * gr : 0)), "r"(ok ? 16 : 0)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // `store(r, p, v)` writes pixel (r, p)'s CIN values v
  template <typename Store>
  __device__ __forceinline__ void relayout(const Tile& tl, const Geom& g,
                                           const uint8_t* raw, int t,
                                           Store store) const {
#pragma unroll 1
    for (int s = 0; s < kPixSlots; ++s) {
      const int e = t + s * kWG;
      if (e < kRows * kPW) {
        const int r = e / kPW, p = e - r * kPW;
        const int8_t b0 = (int8_t)raw[r];
        const int wi = tl.w0 + p - g.pw0;
        const bool ok = b0 >= 0 && wi >= 0 && wi < g.W;
        const T* re = reinterpret_cast<const T*>(raw + kHead + r * kNC * 16 + b0 +
                                                 p * CIN * (int)sizeof(T));
        T v[CIN];
#pragma unroll
        for (int c = 0; c < CIN; ++c) v[c] = ok ? re[c] : T(0.f);
        store(r, p, v);
      }
    }
  }
};

// the worker's own barrier: warpgroup wg's 128 threads
__device__ __forceinline__ void worker_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kWG) : "memory");
}

// ---------------------------------------------------------------- bf16 --

// wgmma operand descriptor of a 128-byte-swizzled K-major tile: start
// address, leading and stride byte offsets (PTX ISA, "matrix descriptor")
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kKSteps][4]) {
#pragma unroll
  for (int i = 0; i < 4 * kKSteps; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

// D[64x128] (+)= A[64x16] B[16x128], A in registers, B K-major in shared;
// ACC false: D = A B, D not read (so it is dead before the tile's first)
#define CVVAE_D64(c)                                                          \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),      \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),      \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),    \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),    \
      c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),    \
      c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),    \
      c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),    \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),    \
      c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define CVVAE_RW(x) "+f"(x)
#define CVVAE_WO(x) "=f"(x)
#define CVVAE_WGMMA_N128(scale)                                               \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, " scale           \
  ", 1, 1, 0;\n"
template <bool ACC>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (ACC)
    asm volatile(CVVAE_WGMMA_N128("1")
                 : CVVAE_D64(CVVAE_RW)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
  else
    asm volatile(CVVAE_WGMMA_N128("0")
                 : CVVAE_D64(CVVAE_WO)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}
#undef CVVAE_D64
#undef CVVAE_RW
#undef CVVAE_WO
#undef CVVAE_WGMMA_N128

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The GEMM's K and N orders (ops/kernels/stem.py::pack_weight): k-step s
// gives lane q (= lane % 4) tap 4s + q, its channels 0-1 in A register 0
// (row g) and 2-3 in register 2, so one 8-byte load of a patch pixel is a
// lane's pair; GEMM column 32u + 8j + 2q + c is channel 32u + 8q + 2j + c,
// so lane q's accumulators of a pixel are 4 runs of 8 channels.
template <int CIN>
__global__ void __launch_bounds__(kMmaWorkers * kWG, 1)
    stem_conv_mma(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ wp,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                  Geom g, int T_out, int H_out, int W_out, int n_wt,
                  int n_tiles) {
  extern __shared__ __align__(1024) uint8_t smem[];
  using L = Loader<__nv_bfloat16, CIN>;
  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int lane = tid & 31, w = t >> 5, gq = lane >> 2, q = lane & 3;
  uint8_t* stage = smem + kBBytes + wg * (kRegion + 2 * L::kRawBytes);  // 2 tiles
  uint32_t* patch = reinterpret_cast<uint32_t*>(stage + kStages * kStageBytes);
  uint8_t* raw = stage + kRegion;  // 2 tiles' copies
  const L ld(x, g);
  auto put = [&](const Tile& tl, const uint8_t* src) {
    ld.relayout(tl, g, src, t, [&](int r, int p, const __nv_bfloat16* v) {
      uint16_t h[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < CIN; ++c) h[c] = __bfloat16_as_ushort(v[c]);
      *reinterpret_cast<uint2*>(patch + r * kRowWords + 2 * p) =
          make_uint2(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16);
    });
  };

  // worker wg of block k walks tiles 3k + wg, + 3 * gridDim.x, ...; the
  // copies of a tile are issued two tiles ahead
  const int n_workers = kMmaWorkers * gridDim.x;
  int idx = kMmaWorkers * blockIdx.x + wg;
  Tile cur = decode(idx, n_wt, T_out, H_out, W_out);
  Tile nt = decode(idx + n_workers, n_wt, T_out, H_out, W_out);
  ld.issue(cur, g, raw, t, idx < n_tiles);
  ld.issue(nt, g, raw + L::kRawBytes, t, idx + n_workers < n_tiles);

  // B, once a block: row n (GEMM column) of 128 bytes a 64-column box,
  // 16-byte chunk c of row n at chunk c ^ (n % 8) (128-byte swizzle);
  // columns 112-127 zero
  for (int i = tid; i < kCout * 16; i += kMmaWorkers * kWG) {
    const int n = i >> 4, c = i & 15;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < kK / 8) v = *reinterpret_cast<const uint4*>(wp + n * kK + c * 8);
    *reinterpret_cast<uint4*>(smem + (c >> 3) * (kCout * 128) + n * 128 +
                              (((c & 7) ^ (n & 7)) << 4)) = v;
  }
  for (int i = t; i < kRowWords; i += kWG)  // the bias tap's row
    patch[kRows * kRowWords + i] = i % 2 ? 0u : 0x3F80u;  // bf16 1.0, ch 0
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B
  __syncthreads();
  if (idx < n_tiles) put(cur, raw);
  worker_sync(wg);

  // warp w's rows are the tile's pixels 16w .. 16w + 15; lane (gq, q)
  // reads pixel 16w + gq (+8) at tap 4s + q: patch row t / 3, offset t % 3
  int aoff[kKSteps];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const int tap = 4 * s + q;
    aoff[s] = (w * 16 + gq) * 2 + (tap / 3) * kRowWords + (tap % 3) * 2;
  }
  const uint64_t desc = sw128_desc(smem_u32(smem));

  for (int it = 0; idx < n_tiles; ++it) {
    const int next = idx + n_workers, next2 = next + n_workers;
    const Tile nt2 = decode(next2, n_wt, T_out, H_out, W_out);
    ld.issue(nt2, g, raw + (it & 1) * L::kRawBytes, t, next2 < n_tiles);

    uint32_t a[kKSteps][4];
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      const uint2 lo = *reinterpret_cast<const uint2*>(patch + aoff[s]);
      const uint2 hi = *reinterpret_cast<const uint2*>(patch + aoff[s] + 16);
      a[s][0] = lo.x;
      a[s][1] = hi.x;
      a[s][2] = lo.y;
      a[s][3] = hi.y;
    }
    float acc[64];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_n128<false>(acc, a[0], desc);
#pragma unroll
    for (int s = 1; s < kKSteps; ++s)
      wgmma_n128<true>(acc, a[s], desc + (((s >> 2) * (kCout * 128) + (s & 3) * 32) >> 4));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    fence_regs(a);

    // rounded once into this tile's stage buffer (its store two tiles ago
    // has been read: the wait before the last barrier)
    uint8_t* st = stage + (it % kStages) * kStageBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* d = acc + 16 * u + 2 * h;  // columns 32u + 8j + 2q + c
        const uint4 row = make_uint4(pack2(d[0], d[1]), pack2(d[4], d[5]),
                                     pack2(d[8], d[9]), pack2(d[12], d[13]));
        const int m = w * 16 + h * 8 + gq;
        *reinterpret_cast<uint4*>(st + m * (kCout * 2) + (32 * u + 8 * q) * 2) = row;
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    worker_sync(wg);  // the stage written, the patch read, next's copies in
    if (t == 0) {
      __nv_bfloat16* dst =
          y + (((cur.b * T_out + cur.to) * H_out + cur.ho) * (int64_t)W_out + cur.w0) * kCout;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n" ::"l"(dst),
          "r"(smem_u32(st)), "r"(cur.np * kCout * 2)
          : "memory");
    }
    if (next < n_tiles) put(nt, raw + ((it + 1) & 1) * L::kRawBytes);
    if (t == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kStages - 1) : "memory");
    worker_sync(wg);  // tile next's patch written, the next stage free
    cur = nt;
    nt = nt2;
    idx = next;
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- fp32 --

template <int CIN>
__global__ void __launch_bounds__(kFmaWorkers * kWG, 1)
    stem_conv_fma(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y, Geom g,
                  int T_out, int H_out, int W_out, int n_wt, int n_tiles) {
  constexpr int kPatchF = kRows * CIN * kPWF;
  extern __shared__ __align__(1024) uint8_t smem[];
  using L = Loader<float, CIN>;
  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int lane = tid & 31, warp = t >> 5;
  float4* sw = reinterpret_cast<float4*>(smem);           // (27*CIN, 128)
  float* patch = reinterpret_cast<float*>(smem) + 27 * CIN * kCout + wg * 2 * kPatchF;
  uint8_t* raw = smem + (27 * CIN * kCout + 4 * kPatchF) * 4 + wg * L::kRawBytes;
  const L ld(x, g);
  // patch row (dt*3 + dh)*CIN + ci holds one channel's kPW pixels
  auto put = [&](const Tile& tl, float* buf) {
    ld.relayout(tl, g, raw, t, [&](int r, int p, const float* v) {
#pragma unroll
      for (int c = 0; c < CIN; ++c) buf[(r * CIN + c) * kPWF + p] = v[c];
    });
  };

  const int n_workers = kFmaWorkers * gridDim.x;
  int idx = kFmaWorkers * blockIdx.x + wg;
  Tile cur = decode(idx, n_wt, T_out, H_out, W_out);
  ld.issue(cur, g, raw, t, idx < n_tiles);
  for (int i = tid; i < 27 * CIN * kCout / 4; i += kFmaWorkers * kWG)
    sw[i] = reinterpret_cast<const float4*>(w)[i];
  const float4 bv = reinterpret_cast<const float4*>(bias)[lane];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (idx < n_tiles) put(cur, patch);
  worker_sync(wg);

  for (int it = 0; idx < n_tiles; ++it) {
    const int next = idx + n_workers;
    const Tile nt = decode(next, n_wt, T_out, H_out, W_out);
    ld.issue(nt, g, raw, t, next < n_tiles);

    // warp `warp` owns the tile's pixels 16*warp .. +15, lane 4 channels
    const float* pb = patch + (it & 1) * kPatchF + warp * 16;
    float acc[16][4];
#pragma unroll
    for (int p = 0; p < 16; ++p)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[p][k] = 0.f;
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        // the warp's 16 pixels and the two after them, 5 broadcast loads
        float xv[20];
#pragma unroll
        for (int v = 0; v < 5; ++v)
          *reinterpret_cast<float4*>(xv + 4 * v) =
              reinterpret_cast<const float4*>(pb + (r * CIN + ci) * kPWF)[v];
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float4 wv = sw[((r * 3 + dw) * CIN + ci) * (kCout / 4) + lane];
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            acc[p][0] = fmaf(xv[p + dw], wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv[p + dw], wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv[p + dw], wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv[p + dw], wv.w, acc[p][3]);
          }
        }
      }
    float* yrow =
        y + (((cur.b * T_out + cur.to) * H_out + cur.ho) * (int64_t)W_out + cur.w0) * kCout;
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if (warp * 16 + p < cur.np)
        reinterpret_cast<float4*>(yrow + (warp * 16 + p) * kCout)[lane] =
            make_float4(acc[p][0] + bv.x, acc[p][1] + bv.y, acc[p][2] + bv.z,
                        acc[p][3] + bv.w);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    worker_sync(wg);
    if (next < n_tiles) put(nt, patch + ((it + 1) & 1) * kPatchF);
    worker_sync(wg);
    cur = nt;
    idx = next;
  }
}

template <typename T, int CIN>
int launch(const void* x, const void* w, const float* bias, void* y, Geom g,
           int T_out, int H_out, int W_out, int n_wt, int n_tiles,
           int grid, cudaStream_t s) {
  void (*fn)(const T*, const T*, const float*, T*, Geom, int, int, int, int,
             int);
  int smem, workers;
  if constexpr (std::is_same<T, float>::value) {
    fn = stem_conv_fma<CIN>;
    workers = kFmaWorkers;
    smem = (27 * CIN * kCout + 2 * workers * kRows * CIN * kPWF) * (int)sizeof(float) +
           workers * Loader<float, CIN>::kRawBytes;
  } else {
    fn = stem_conv_mma<CIN>;
    workers = kMmaWorkers;
    smem = kBBytes + workers * (kRegion + 2 * Loader<__nv_bfloat16, CIN>::kRawBytes);
  }
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<grid, workers * kWG, smem, s>>>((const T*)x, (const T*)w, bias, (T*)y, g,
                                  T_out, H_out, W_out, n_wt, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_cin(int cin, const void* x, const void* w, const float* bias,
                 void* y, Geom g, int T_out, int H_out, int W_out, int n_wt,
                 int n_tiles, int grid, cudaStream_t s) {
  switch (cin) {
    case 1: return launch<T, 1>(x, w, bias, y, g, T_out, H_out, W_out, n_wt, n_tiles, grid, s);
    case 2: return launch<T, 2>(x, w, bias, y, g, T_out, H_out, W_out, n_wt, n_tiles, grid, s);
    case 3: return launch<T, 3>(x, w, bias, y, g, T_out, H_out, W_out, n_wt, n_tiles, grid, s);
    case 4: return launch<T, 4>(x, w, bias, y, g, T_out, H_out, W_out, n_wt, n_tiles, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (B, T_in, H, W, cin) contiguous; w: bf16 (128, 112) from
// ops/kernels/stem.py::pack_weight (the bias in it), or f32 (3, 3, 3, cin,
// 128) contiguous; bias: (128,) f32 for the fp32 kernel (NULL for bf16);
// y: (B, T_out, H_out, W_out, 128).  Pads: time (pt0, .) in edge (t_edge=1)
// or zero mode, H/W zero.  `grid` blocks walk the B * H_out * T_out * n_wt
// tiles of tile_w (= kTW) columns.
CVVAE_EXPORT int cvvae_stem_conv3d(const void* x, const void* w,
                                   const void* bias, void* y, int64_t B,
                                   int T_in, int H, int W, int cin, int T_out,
                                   int H_out, int W_out, int pt0, int ph0,
                                   int pw0, int t_edge, int tile_w, int grid,
                                   int dtype, int device, void* stream) {
  if (tile_w != kTW || grid < 1) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const Geom g = {B, T_in, H, W, pt0, ph0, pw0, t_edge};
  const int n_wt = (W_out + kTW - 1) / kTW;
  const int64_t n_tiles = B * T_out * (int64_t)H_out * n_wt;
  // tile indices (and the one past each worker's last) are 32-bit
  if (n_tiles + kMmaWorkers * (int64_t)grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (dtype == CVVAE_BF16)
    return dispatch_cin<__nv_bfloat16>(cin, x, w, (const float*)bias, y, g,
                                       T_out, H_out, W_out, n_wt, n_tiles,
                                       grid, s);
  if (dtype == CVVAE_F32)
    return dispatch_cin<float>(cin, x, w, (const float*)bias, y, g, T_out,
                               H_out, W_out, n_wt, n_tiles, grid, s);
  return (int)cudaErrorInvalidValue;
}
