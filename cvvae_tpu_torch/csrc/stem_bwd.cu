// K3.bwd: the gradient of the stem conv (K3, csrc/stem.cu) in its weights
// and bias: for a 3x3x3 stride-1 conv of x (B, T, H, W, Cin <= 4) to 128
// channels, with time padded by repeating the edge frame or by zeros and
// H/W by zeros,
//   dW[o, ci, dt, dh, dw] = sum over (b, t, h, w) of
//                           xpad[b, t+dt, h+dh, w+dw, ci] * dy[b, t, h, w, o]
//   dbias[o] = sum of dy[..., o].
// There is no dx: the stem's input is the pixels.  The TPU package has no
// kernel for it: its gradient is XLA's autodiff of cvvae_tpu/ops/conv.py::
// _conv3d_stacked_stem.
//
// What bounds it on an H100.  bf16: one read of dy (128 channels a
// position, 285 MB on a 17x256x256 clip: 0.085 ms at 3.35 TB/s); its 23.1
// GFLOP (2 * 27 * Cin * 128 an output position) take a quarter of that on
// the tensor cores.  fp32: the products on exact fp32 FMAs (0.345 ms at 67
// TFLOP/s on the clip), with dy's read (0.17 ms) beside them.
//
// Common to both dtypes:
// - A persistent grid; block k owns a fixed, contiguous range of `per`
//   tiles, a tile kTW (bf16) or kFmaTW (fp32) output pixels of one output
//   row (b, t, h) (ops/kernels/stem.py::bwd_plan), so a block's dy is one
//   span of memory, and steps its tiles' coordinates (advance: no division
//   a tile).  bf16 runs kBlocksPerSm block an SM; fp32's grid holds
//   kFmaBlocksPerSm blocks an SM, run in two waves, so that a slot sums
//   half as many terms.
// - The padding is folded in as K3 folds it (row_of: time clamped in edge
//   mode; H, W and zero-mode time masked); pixels past a tile's last are
//   zero in both operands.
// - Each block's sums go to its slots of a (slots, 27 * Cin + 1, 128) fp32
//   scratch; stem_bwd_merge adds the slots in double, kMergeSplit
//   contiguous ranges apart and then the ranges in order, and writes dW
//   (128, Cin, 3, 3, 3) and dbias.  No atomics: the result is the same
//   bits on every run.
//
// bf16 (stem_bwd_mma): the weight gradient as one GEMM over the pixels,
//   dW^T (128 x N) = dy^T (128 x P) * im2col(x) (P x N), N = 27 * Cin + 1:
//   column n = tap * Cin + ci (tap = (dt * 3 + dh) * 3 + dw), and a column
//   of ones (zero past the tile's pixels) for dbias.  mma.sync m16n8k16,
//   bf16 operands, fp32 accumulators: a bf16 product is exact in fp32.
//   - Warp-specialised, one __syncthreads a tile: kMmaWarps warps multiply
//     (32 channels x all of N each) tile i while kProdWarps warps copy tile
//     i + kStages - 1 into a ring of kStages stages and build tile i + 1's
//     im2col.
//   - dy's tile arrives by TMA as two boxes of kHalf channels x kTW pixels,
//     128-byte swizzled (16-byte unit j of pixel row k at j ^ (k & 7), so
//     ldmatrix.trans's 8 rows hit 8 bank groups); pixels past the row's
//     last arrive as zeros.  x's 9 patch rows come by cp.async as 16-byte
//     granules.  Both complete on the stage's mbarrier.
//   - A = dy^T is read straight from the stage by ldmatrix.trans; B is the
//     im2col tile, pixel-contiguous, rows padded by 16 bytes (the dw shift
//     of a patch row costs no misaligned operand).  build_cols makes a
//     lane's pixel pair of a patch row's 3 * Cin im2col rows from one pass
//     over 4 input columns.
//   - A tile's products start from zero and are then added to the warp's
//     fp32 totals (one round-to-nearest add a tile), so the tensor core's
//     truncating accumulation runs over kTW / kK k-steps at most
//     (stem.bwd_plan states the bound).
// fp32 (stem_bwd_fma): exact fp32 FMAs, no TF32.  dy streams through a
//   ring of kFmaStages stages by 16-byte cp.async, the rows past the tile's
//   pixels zero-filled by the copy; the next tile's patch is loaded into
//   registers during the products (kPrefetchX).  A thread owns kRows patch
//   rows (dt, dh) x kCh channels, so each dy value it reads from shared
//   memory feeds kRows * 9 * Cin FMAs (three times the one-row design's);
//   9 / kRows row groups x 128 / (32 * kCh) channel slices x kPhases runs
//   of the tile's pixels make twelve warps (three to a scheduler, within
//   its register file); a run is summed in order, the patch columns of a
//   pixel in a sliding window of registers.  Slot (block, run): kPhases
//   slots a block.
//
// kTW, kFmaTW, kK, kBlocksPerSm, kFmaBlocksPerSm, kPX and kPhases are read
// by ops/kernels/stem.py (use_bwd_source, bwd_plan and its tests) from
// this file; utils/kernel_variants.py --kernel K3.bwd undoes the choices
// above one at a time.
#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int kCout = 128;
constexpr int kTW = 128;         // output pixels a tile, bf16
constexpr int kFmaTW = 64;       // and fp32
constexpr int kBlocksPerSm = 1;  // bf16's grid: one resident block an SM
// fp32's grid: two blocks an SM, run as two waves (one fits an SM at a
// time), so that a slot sums half as many terms
constexpr int kFmaBlocksPerSm = 2;
constexpr int kMergeSplit = 8;   // slot ranges an output value
// bf16
constexpr int kK = 16;           // pixels a k-step of mma.sync m16n8k16
constexpr int kStages = 4;       // dy's and x's ring
constexpr int kMmaWarps = 4;     // products: 32 channels x all of N each
constexpr int kProdWarps = 4;    // the copies and the im2col
constexpr int kProdThreads = 32 * kProdWarps;
constexpr int kMmaThreads = 32 * (kMmaWarps + kProdWarps);
constexpr int kHalf = 64;        // channels a TMA box of dy (128 bytes)
constexpr int kBK = kTW + 8;     // bf16 an im2col row in shared memory
// fp32
constexpr int kFmaStages = 3;
constexpr bool kPrefetchX = true;  // next tile's x in flight during products
constexpr int kRows = 3;         // patch rows (dt, dh) a thread
constexpr int kCh = 2;           // channels a lane
constexpr int kPhases = 2;       // runs of a tile's pixels
constexpr int kPX = 66;          // dy rows a stage (the tile, zero-filled)
constexpr int kRun = kPX / kPhases;  // pixels a run, a multiple of 3
constexpr int kPC = kPX + 3;     // patch columns (the window reads kRun + 2)
constexpr int kGroups = 9 / kRows;
constexpr int kSlices = kCout / (32 * kCh);
constexpr int kFmaThreads = 32 * kGroups * kSlices * kPhases;
constexpr int kPIters = (9 * kPC + kFmaThreads - 1) / kFmaThreads;
static_assert(kRun % 3 == 0 && kPX >= kFmaTW, "runs of whole windows");
static_assert(kStages >= 2, "a tile in flight beside the one in use");
static_assert(kTW % 64 == 0, "a warp builds 64 pixels of an im2col row a pass");

struct Geom {
  int64_t B, n_bytes;  // x's bytes
  int T_in, H, W, T_out, H_out, W_out, pt0, ph0, pw0, t_edge, n_wt;
  int off0;            // x's address mod 16
};

struct Tile {
  int orow, b, to, ho;  // output row (b, t, h): its batch, frame and row
  int w0, np;           // first column, pixels
};

// tile idx (TW pixels a tile) -> output row and columns: tiles run along
// the rows, so a block's range is one span of dy (32-bit: idx < 2^31)
template <int TW>
__device__ __forceinline__ Tile tile_of(int idx, const Geom& g) {
  Tile t;
  t.orow = idx / g.n_wt;
  t.w0 = (idx - t.orow * g.n_wt) * TW;
  t.np = min(TW, g.W_out - t.w0);
  const int r = t.orow / g.H_out;
  t.ho = t.orow - r * g.H_out;
  t.b = r / g.T_out;
  t.to = r - t.b * g.T_out;
  return t;
}

// the tile after t
template <int TW>
__device__ __forceinline__ void advance(Tile& t, const Geom& g) {
  t.w0 += TW;
  if (t.w0 >= g.W_out) {
    t.w0 = 0;
    ++t.orow;
    if (++t.ho == g.H_out) {
      t.ho = 0;
      if (++t.to == g.T_out) {
        t.to = 0;
        ++t.b;
      }
    }
  }
  t.np = min(TW, g.W_out - t.w0);
}

// pixel k of tile t holds an output position (past it: zero operands)
__device__ __forceinline__ bool live(int k, const Tile& t) {
  return k < t.np;
}

// x's row (b, ti, hi), as a row index of (B, T_in, H), for patch row
// (dt, dh) of output row (b, to, ho), the padding folded in: time clamped
// in edge mode; H and zero-mode time masked (ok)
__device__ __forceinline__ int64_t row_of(const Geom& g, const Tile& t,
                                          int dt, int dh, bool& ok) {
  int ti = t.to + dt - g.pt0;
  const int hi = t.ho + dh - g.ph0;
  ok = hi >= 0 && hi < g.H;
  if (g.t_edge)
    ti = min(max(ti, 0), g.T_in - 1);
  else
    ok = ok && ti >= 0 && ti < g.T_in;
  return ((int64_t)t.b * g.T_in + ti) * g.H + hi;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- bf16

template <int CIN>
struct MmaShape {
  static constexpr int kN = 27 * CIN + 1;             // dW's rows, dbias
  static constexpr int kNT = (kN + 7) / 8;            // n8 tiles
  static constexpr int kNTW = (kNT + 1) / 2 * 2;     // even, for x4 loads
  static constexpr int kRowsB = kNTW * 8;             // im2col rows
  // granules of x a patch row: its kTW + 2 pixels, up to 15 bytes before
  static constexpr int kNC = ((kTW + 2) * CIN * 2 + 30) / 16;
  static constexpr int kDyBytes = kTW * kCout * 2;   // two swizzled boxes
  // dy, then x; a stage 1024-byte aligned, as the swizzle needs
  static constexpr int kStage = (kDyBytes + 9 * kNC * 16 + 1023) / 1024 * 1024;
  static constexpr int kCols = kStages * kStage;      // the im2col's offset
  static constexpr int kBars = kCols + 2 * kRowsB * kBK * 2;
  // a barrier a stage; 1024 bytes to align the start
  static constexpr int kSmem = kBars + kStages * 8 + 1024;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// c = a * b + c, or a * b where FIRST (a tile's first k-step)
template <bool FIRST>
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if (FIRST)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte of x's element (row, column c0, channel 0) from x rounded down to
// 16 bytes (negative before the tensor)
__device__ __forceinline__ int64_t row_byte(const Geom& g, int64_t row,
                                            int c0, int cin) {
  return g.off0 + 2 * ((row * g.W + c0) * cin);
}

// dy's box (kHalf channels from c, kTW pixels from w, output row `row`)
// into `dst`, 128-byte rows swizzled (16-byte unit j of row k at j ^ (k &
// 7)); pixels past the row's last read as zeros
__device__ __forceinline__ void tma_dy(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c, int w, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(row)
      : "memory");
}

// byte of dy's (pixel k, channel m) in a stage's two swizzled boxes
__device__ __forceinline__ int dy_at(int k, int m) {
  return (m / kHalf) * (kTW * kHalf * 2) + k * (kHalf * 2) +
         ((((m % kHalf) >> 3) ^ (k & 7)) << 4);
}

// tile t's copies into a stage, all completing on the stage's barrier
// `bar` (kProdThreads + 1 arrivals a phase): dy's tile as two TMA boxes
// (by producer thread 0, with the bytes it expects; pixels past the row's
// last arrive as zeros), and x's 9 patch rows by cp.async, row r as its
// granules (16 bytes each, aligned in memory) that hold input columns w0
// - pw0 .. w0 - pw0 + kTW + 1, kNC of them; a granule of a padding row, or
// wholly outside the tensor, is zero-filled (a granule that holds any of
// the tensor's bytes lies in its allocation).  Each producer thread's
// copies arrive on `bar` when they land.
template <int CIN>
__device__ __forceinline__ void issue_tile(uint8_t* stage, uint64_t* bar,
                                           const CUtensorMap* dy_map,
                                           const uint8_t* xa, const Tile& t,
                                           const Geom& g, int pt) {
  constexpr int kNC = MmaShape<CIN>::kNC;
  if (pt == 0) {
    mbar_expect_tx(bar, MmaShape<CIN>::kDyBytes);
#pragma unroll
    for (int h = 0; h < kCout / kHalf; ++h)
      tma_dy(stage + h * kTW * kHalf * 2, dy_map, bar, h * kHalf, t.w0,
             t.orow);
  }
  uint8_t* raw = stage + MmaShape<CIN>::kDyBytes;
#pragma unroll
  for (int u = 0; u < (9 * kNC + kProdThreads - 1) / kProdThreads; ++u) {
    const int e = pt + u * kProdThreads;
    if (e >= 9 * kNC) break;
    const int r = e / kNC, j = e - r * kNC;
    bool ok;
    const int64_t row = row_of(g, t, r / 3, r % 3, ok);
    const int64_t gr = (row_byte(g, row, t.w0 - g.pw0, CIN) >> 4) + j;
    ok = ok && 16 * gr + 16 > g.off0 && 16 * gr < g.off0 + g.n_bytes;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(raw + 16 * e)),
                 "l"(xa + (ok ? 16 * gr : 0)), "r"(ok ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// tile t's im2col from its x rows in a stage: row n = (r * 3 + dw) * CIN
// + ci, pixel k = column k; zero past the tile's pixels and in the
// padding; row 27 * CIN dbias's ones.  Producer warp w takes patch rows
// r = 3 - w, 7 - w, ... (the copying warp 0 the fewest) and warp 1 the
// ones; for each 64 pixels of the tile, lane l reads input columns c0 + k
// .. c0 + k + 3 (k = 2l), every channel, once and writes pixels (k, k + 1)
// of the row's 3 * CIN im2col rows, two bf16 a word.  A tile whose
// pixels and columns all lie inside the row skips the masks.
template <int CIN>
__device__ __forceinline__ void build_cols(uint32_t* buf, const uint8_t* raw,
                                           const Tile& t, const Geom& g,
                                           int w, int lane) {
  constexpr int kNC = MmaShape<CIN>::kNC;
  const int c0 = t.w0 - g.pw0;
  const bool inside = t.np == kTW && c0 >= 0 && c0 + kTW + 2 <= g.W;
#pragma unroll
  for (int u = 0; u < (9 + kProdWarps - 1) / kProdWarps; ++u) {
    const int r = kProdWarps - 1 - w + u * kProdWarps;
    if (r >= 9) break;
    bool ok;
    const int64_t row = row_of(g, t, r / 3, r % 3, ok);
    const unsigned short* src = reinterpret_cast<const unsigned short*>(
        raw + r * kNC * 16 + (row_byte(g, row, c0, CIN) & 15));
#pragma unroll
    for (int h = 0; h < kTW / 64; ++h) {
      const int k = 64 * h + 2 * lane;
      const bool live0 = live(k, t), live1 = live(k + 1, t);
      uint32_t v[4][CIN];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in =
            ok && (inside || (c0 + k + e >= 0 && c0 + k + e < g.W));
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci)
          v[e][ci] = in ? src[(k + e) * CIN + ci] : 0u;
      }
#pragma unroll
      for (int dw = 0; dw < 3; ++dw)
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci)
          buf[((r * 3 + dw) * CIN + ci) * (kBK / 2) + k / 2] =
              inside ? v[dw][ci] | (v[dw + 1][ci] << 16)
                     : (live0 ? v[dw][ci] : 0u) |
                           ((live1 ? v[dw + 1][ci] : 0u) << 16);
    }
  }
  if (w == 1)  // dbias's column of ones
#pragma unroll
    for (int h = 0; h < kTW / 64; ++h) {
      const int k = 64 * h + 2 * lane;
      const bool one0 = live(k, t), one1 = live(k + 1, t);
      buf[27 * CIN * (kBK / 2) + k / 2] =
          (one0 ? 0x3F80u : 0u) | ((one1 ? 0x3F80u : 0u) << 16);
    }
}

// k-step ks of a tile: this warp's 2 x kNT mma tiles
template <int CIN, bool FIRST>
__device__ __forceinline__ void mma_step(
    float (&acc)[2][MmaShape<CIN>::kNTW][4], const uint8_t* A,
    const __nv_bfloat16* B, int ks, int mb, int lane) {
  using S = MmaShape<CIN>;
  uint32_t a[2][4];
#pragma unroll
  for (int im = 0; im < 2; ++im)  // A = dy^T: rows k, 8 channels each
    ldsm_x4_trans(a[im], A + dy_at(ks * kK + (lane & 7) + ((lane >> 4) << 3),
                                   mb * 32 + im * 16 + (((lane >> 3) & 1) << 3)));
#pragma unroll
  for (int jp = 0; jp < S::kNTW / 2; ++jp) {
    uint32_t b[4];  // two n8 tiles: rows n, 8 pixels each
    ldsm_x4(b, B + (2 * jp * 8 + (lane & 7) + ((lane >> 4) << 3)) * kBK +
                   ks * kK + (((lane >> 3) & 1) << 3));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (2 * jp + h < S::kNT)
#pragma unroll
        for (int im = 0; im < 2; ++im)
          mma_bf16<FIRST>(acc[im][2 * jp + h], a[im], b[2 * h], b[2 * h + 1]);
  }
}

template <int CIN>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSm)
    stem_bwd_mma(const __nv_bfloat16* __restrict__ x,
                 const __grid_constant__ CUtensorMap dy_map,
                 float* __restrict__ part, Geom g, int n_tiles, int per) {
  using S = MmaShape<CIN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // from a 1024-byte boundary: kStages x (dy [kCout / kHalf][kTW][kHalf]
  // bf16 swizzled, x [9][kNC] granules), the im2col [2][kRowsB][kBK] bf16
  // (as words), a barrier a stage
  uint32_t* cols = reinterpret_cast<uint32_t*>(smem + S::kCols);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  const uint8_t* xa = reinterpret_cast<const uint8_t*>(x) - g.off0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warps 0 .. kMmaWarps - 1: the products of channels 32 warp ..; the
  // others (producers): tile i + kStages - 1's copies (the first of them)
  // and tile i + 1's im2col while the products of tile i run
  const bool producer = warp >= kMmaWarps;
  const int pw = warp - kMmaWarps, pt = threadIdx.x - 32 * kMmaWarps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], kProdThreads + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&dy_map);
  }
  __syncthreads();
  const int first = blockIdx.x * per;
  const int count = min(n_tiles, first + per) - first;

  float acc[2][S::kNTW][4], tot[2][S::kNTW][4];
#pragma unroll
  for (int im = 0; im < 2; ++im)
#pragma unroll
    for (int j = 0; j < S::kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[im][j][e] = 0.f;

  Tile ahead = tile_of<kTW>(first, g);  // the next tile to copy
  Tile cur = ahead;
  if (producer) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < count)
        issue_tile<CIN>(smem + s * S::kStage, &bars[s], &dy_map, xa, ahead,
                        g, pt);
      advance<kTW>(ahead, g);
    }
    mbar_wait(&bars[0], 0);
    build_cols<CIN>(cols, smem + S::kDyBytes, cur, g, pw, lane);
  }

  for (int i = 0; i < count; ++i) {
    __syncthreads();  // tile i's im2col is built, tile i - 1's products done
    const int np = cur.np;
    advance<kTW>(cur, g);  // now tile i + 1
    if (producer) {
      const int ahead_i = i + kStages - 1;
      if (ahead_i < count)
        issue_tile<CIN>(smem + ahead_i % kStages * S::kStage,
                        &bars[ahead_i % kStages], &dy_map, xa, ahead, g, pt);
      advance<kTW>(ahead, g);
      if (i + 1 < count) {
        mbar_wait(&bars[(i + 1) % kStages], ((i + 1) / kStages) & 1);
        build_cols<CIN>(cols + ((i + 1) & 1) * S::kRowsB * (kBK / 2),
                        smem + (i + 1) % kStages * S::kStage + S::kDyBytes,
                        cur, g, pw, lane);
      }
      continue;
    }
    mbar_wait(&bars[i % kStages], (i / kStages) & 1);  // tile i's dy
    const uint8_t* A = smem + i % kStages * S::kStage;
    const __nv_bfloat16* B = reinterpret_cast<const __nv_bfloat16*>(
        cols + (i & 1) * S::kRowsB * (kBK / 2));
    const int nks = (np + kK - 1) / kK;
    mma_step<CIN, true>(acc, A, B, 0, warp, lane);
    for (int ks = 1; ks < nks; ++ks)
      mma_step<CIN, false>(acc, A, B, ks, warp, lane);
#pragma unroll
    for (int im = 0; im < 2; ++im)
#pragma unroll
      for (int j = 0; j < S::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[im][j][e] += acc[im][j][e];
  }
  if (producer) return;

  // slot blockIdx.x: row n of N (dW's (tap, ci), then dbias), channel o
  float* out = part + (int64_t)blockIdx.x * S::kN * kCout;
#pragma unroll
  for (int im = 0; im < 2; ++im)
#pragma unroll
    for (int j = 0; j < S::kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = j * 8 + 2 * (lane & 3) + (e & 1);
        const int o = warp * 32 + im * 16 + (lane >> 2) + (e >> 1) * 8;
        if (j < S::kNT && n < S::kN) out[n * kCout + o] = tot[im][j][e];
      }
}

// ---------------------------------------------------------------- fp32

// fp32: dy's tile into a stage, pixel p's 128 channels at row p, kPX
// rows, those past the tile's pixels zero-filled by the copy (no bytes
// read), 16 bytes a cp.async
__device__ __forceinline__ void copy_dy(float* stage, const float* dy,
                                        const Tile& t, const Geom& g,
                                        int tid) {
  constexpr int kChunks = kCout / 4;  // 16 bytes a chunk
  constexpr int kUnits = (kPX * kChunks + kFmaThreads - 1) / kFmaThreads;
  const float* src = dy + ((int64_t)t.orow * g.W_out + t.w0) * kCout;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int i = tid + u * kFmaThreads;
    if (i >= kPX * kChunks) break;
    const int p = i / kChunks, c = i - p * kChunks;
    const bool on = live(p, t);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(stage + p * kCout + c * 4)),
                 "l"(src + (on ? p * kCout + c * 4 : 0)), "r"(on ? 16 : 0)
                 : "memory");
  }
}

// this thread's patch entries of tile t: entry tid + j * kFmaThreads is
// patch row r = dt * 3 + dh, column c (input column w0 + c - pw0)
template <int CIN>
__device__ __forceinline__ void gather_patch(float (&v)[kPIters][CIN],
                                             const float* x, const Geom& g,
                                             const Tile& t, int tid) {
#pragma unroll
  for (int j = 0; j < kPIters; ++j) {
    const int i = tid + j * kFmaThreads;
    const int r = i / kPC, c = i - r * kPC;
    bool ok;
    const float* row = x + row_of(g, t, r / 3, r % 3, ok) * g.W * CIN;
    const int wi = t.w0 + c - g.pw0;
    ok = ok && i < 9 * kPC && wi >= 0 && wi < g.W;
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci)
      v[j][ci] = ok ? __ldg(row + (int64_t)wi * CIN + ci) : 0.f;
  }
}

template <int CIN>
__device__ __forceinline__ void store_patch(float4* patch,
                                            const float (&v)[kPIters][CIN],
                                            int tid) {
#pragma unroll
  for (int j = 0; j < kPIters; ++j) {
    const int i = tid + j * kFmaThreads;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) c[ci] = v[j][ci];
    if (i < 9 * kPC) patch[i] = make_float4(c[0], c[1], c[2], c[3]);
  }
}

// kCh channels of dy from shared memory
using Chans = std::conditional<kCh == 4, float4, float2>::type;
struct DyV {
  float v[kCh];
};
__device__ __forceinline__ DyV load_dy(const float* p) {
  const Chans u = *reinterpret_cast<const Chans*>(p);
  const float* f = reinterpret_cast<const float*>(&u);
  DyV d;
#pragma unroll
  for (int c = 0; c < kCh; ++c) d.v[c] = f[c];
  return d;
}

__device__ __forceinline__ float comp(const float4& v, int ci) {
  return ci == 0 ? v.x : ci == 1 ? v.y : ci == 2 ? v.z : v.w;
}

// acc[dw][ci][c] += col_dw[ci] * d[c] for the pixel whose patch columns
// are (c0, c1, c2)
template <int CIN>
__device__ __forceinline__ void pixel(float (&acc)[3][CIN][kCh], const DyV& d,
                                      const float4& c0, const float4& c1,
                                      const float4& c2) {
  const float4 cols[3] = {c0, c1, c2};
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
      for (int c = 0; c < kCh; ++c)
        acc[dw][ci][c] = fmaf(comp(cols[dw], ci), d.v[c], acc[dw][ci][c]);
}

template <int CIN>
__global__ void __launch_bounds__(kFmaThreads, 1)
    stem_bwd_fma(const float* __restrict__ x, const float* __restrict__ dy,
                 float* __restrict__ part, Geom g, int n_tiles, int per) {
  extern __shared__ __align__(16) uint8_t smem[];
  // [kFmaStages][kPX][kCout] fp32, then [2][9][kPC] float4
  float* dys = reinterpret_cast<float*>(smem);
  float4* patch =
      reinterpret_cast<float4*>(smem + kFmaStages * kPX * kCout * 4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warp = (run q, channel slice sl, row group grp)
  const int grp = warp % kGroups, sl = warp / kGroups % kSlices;
  const int q = warp / (kGroups * kSlices);
  const int ch0 = (sl * 32 + lane) * kCh;  // this lane's first channel
  const int first = blockIdx.x * per;
  const int count = min(n_tiles, first + per) - first;

  float acc[kRows][3][CIN][kCh];
  float bacc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) bacc[c] = 0.f;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int dw = 0; dw < 3; ++dw)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
        for (int c = 0; c < kCh; ++c) acc[j][dw][ci][c] = 0.f;

  Tile ahead = tile_of<kFmaTW>(first, g);
  Tile cur = ahead;
#pragma unroll
  for (int s = 0; s < kFmaStages - 1; ++s) {
    if (s < count)
      copy_dy(dys + s * kPX * kCout, dy, ahead, g, tid);
    cp_commit();
    advance<kFmaTW>(ahead, g);
  }
  float v[kPIters][CIN];
  gather_patch<CIN>(v, x, g, cur, tid);
  store_patch<CIN>(patch, v, tid);

  for (int i = 0; i < count; ++i) {
    cp_wait<kFmaStages - 2>();
    __syncthreads();
    if (i + kFmaStages - 1 < count)
      copy_dy(dys + (i + kFmaStages - 1) % kFmaStages * kPX * kCout, dy,
              ahead, g, tid);
    cp_commit();
    advance<kFmaTW>(ahead, g);
    const int np = cur.np;
    advance<kFmaTW>(cur, g);  // now the next tile
    const bool next = i + 1 < count;
    if (kPrefetchX && next) gather_patch<CIN>(v, x, g, cur, tid);

    // run q of the tile: pixels p0 .. p0 + kRun - 1 up to the tile's
    // last, in windows of 3 (the rows past it are zeros)
    const float* dv = dys + i % kFmaStages * kPX * kCout + ch0;
    const float4* prow = patch + (i & 1) * 9 * kPC + grp * kRows * kPC;
    const int p0 = q * kRun, pend = min(p0 + kRun, np);
    if (p0 < pend) {
      float4 A[kRows], B[kRows], C[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        A[j] = prow[j * kPC + p0];
        B[j] = prow[j * kPC + p0 + 1];
        C[j] = prow[j * kPC + p0 + 2];
      }
      for (int p = p0; p < pend; p += 3) {
        const DyV d0 = load_dy(dv + (p + 0) * kCout);
        const DyV d1 = load_dy(dv + (p + 1) * kCout);
        const DyV d2 = load_dy(dv + (p + 2) * kCout);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          pixel<CIN>(acc[j], d0, A[j], B[j], C[j]);
          A[j] = prow[j * kPC + p + 3];
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          pixel<CIN>(acc[j], d1, B[j], C[j], A[j]);
          B[j] = prow[j * kPC + p + 4];
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          pixel<CIN>(acc[j], d2, C[j], A[j], B[j]);
          C[j] = prow[j * kPC + p + 5];
        }
        if (grp == 0)
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            bacc[c] += d0.v[c];
            bacc[c] += d1.v[c];
            bacc[c] += d2.v[c];
          }
      }
    }
    if (!kPrefetchX && next) gather_patch<CIN>(v, x, g, cur, tid);
    if (next) store_patch<CIN>(patch + ((i + 1) & 1) * 9 * kPC, v, tid);
  }

  // slot (block, run): row (dt, dh, dw, ci) of dW, row 27 * CIN of dbias
  float* out = part + ((int64_t)blockIdx.x * kPhases + q) * (27 * CIN + 1) * kCout + ch0;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int dw = 0; dw < 3; ++dw)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
        for (int c = 0; c < kCh; ++c)
          out[(((grp * kRows + j) * 3 + dw) * CIN + ci) * kCout + c] =
              acc[j][dw][ci][c];
  if (grp == 0)
#pragma unroll
    for (int c = 0; c < kCh; ++c) out[27 * CIN * kCout + c] = bacc[c];
}

// ---------------------------------------------------------------- merge

// 32 output values (row k of 27 * cin + 1, channel o) a block, each
// summed over kMergeSplit contiguous ranges of slots by kMergeSplit warps
// in double, then the ranges' sums in order
__global__ void __launch_bounds__(32 * kMergeSplit)
    stem_bwd_merge(const float* __restrict__ part, float* __restrict__ dw,
                   float* __restrict__ dbias, int slots, int cin) {
  __shared__ double sums[kMergeSplit][32];
  const int rows = 27 * cin + 1, l = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + l;
  const int per = (slots + kMergeSplit - 1) / kMergeSplit;
  const int s1 = min(slots, (r + 1) * per);
  double t = 0.0;
  if (i < rows * kCout)
#pragma unroll 4
    for (int s = r * per; s < s1; ++s) t += (double)part[(int64_t)s * rows * kCout + i];
  sums[r][l] = t;
  __syncthreads();
  if (r != 0 || i >= rows * kCout) return;
  for (int q = 1; q < kMergeSplit; ++q) t += sums[q][l];
  const int k = i / kCout, o = i % kCout;
  if (k == 27 * cin) {
    dbias[o] = (float)t;
  } else {
    // k = (tap, ci), tap = (dt * 3 + dh) * 3 + dw; dW is (O, Cin, 3, 3, 3)
    const int tap = k / cin, ci = k % cin;
    dw[(o * cin + ci) * 27 + tap] = (float)t;
  }
}

template <int CIN>
int launch(int dtype, const void* x, const void* dy, float* part, float* dw,
           float* db, const Geom& g, int n_tiles, int grid, int per,
           cudaStream_t s) {
  int slots;
  if (dtype == CVVAE_BF16) {
    // dy as (128 channels, W_out, B * T_out * H_out), boxes of kHalf
    // channels x kTW pixels x 1 row; reads past W_out give zeros
    const EncodeTiled enc = encoder();
    if (!enc) return (int)cudaErrorInvalidValue;
    CUtensorMap map;
    const cuuint64_t dims[3] = {(cuuint64_t)kCout, (cuuint64_t)g.W_out,
                                (cuuint64_t)(g.B * g.T_out * g.H_out)};
    const cuuint64_t strides[2] = {(cuuint64_t)kCout * 2,
                                   (cuuint64_t)g.W_out * kCout * 2};
    const cuuint32_t box[3] = {kHalf, kTW, 1}, step[3] = {1, 1, 1};
    if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(dy),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    auto fn = stem_bwd_mma<CIN>;
    const int smem = MmaShape<CIN>::kSmem;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    fn<<<grid, kMmaThreads, smem, s>>>((const __nv_bfloat16*)x, map, part, g,
                                       n_tiles, per);
    slots = grid;
  } else {
    auto fn = stem_bwd_fma<CIN>;
    const int smem = kFmaStages * kPX * kCout * 4 + 2 * 9 * kPC * 16;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    fn<<<grid, kFmaThreads, smem, s>>>((const float*)x, (const float*)dy,
                                       part, g, n_tiles, per);
    slots = grid * kPhases;
  }
  const int outs = (27 * CIN + 1) * kCout;
  stem_bwd_merge<<<(outs + 31) / 32, 32 * kMergeSplit, 0, s>>>(part, dw, db,
                                                              slots, CIN);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, T_in, H, W, cin) contiguous; dy: (B, T_out, H_out, W_out, 128)
// contiguous and 16-byte aligned, x's dtype; part: (slots, 27 * cin + 1,
// 128) f32 scratch, slots = grid in bf16 and grid * kPhases in fp32; dw:
// (128, cin, 3, 3, 3) f32 out; dbias: (128,) f32 out.  Pads: time (pt0, .)
// in edge (t_edge=1) or zero mode, H/W zero.  Block k takes tiles
// [k * per, (k + 1) * per) of the B * T_out * H_out * ceil(W_out / tile_w)
// tiles (tile_w = kTW in bf16, kFmaTW in fp32), (ops/kernels/stem.py::
// bwd_plan).
CVVAE_EXPORT int cvvae_stem_conv3d_bwd(
    const void* x, const void* dy, void* part, void* dw, void* dbias,
    int64_t B, int T_in, int H, int W, int cin, int T_out, int H_out,
    int W_out, int pt0, int ph0, int pw0, int t_edge, int tile_w, int grid,
    int per, int dtype, int device, void* stream) {
  const int tw = dtype == CVVAE_BF16 ? kTW : kFmaTW;
  const int n_wt = (W_out + tw - 1) / tw;
  const int64_t n_tiles = B * T_out * (int64_t)H_out * n_wt;
  if (tile_w != tw || grid < 1 || per < 1 || cin < 1 || cin > 4 ||
      (int64_t)grid * per < n_tiles || n_tiles + (int64_t)per > INT32_MAX ||
      (dtype != CVVAE_BF16 && dtype != CVVAE_F32))
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const int es = dtype == CVVAE_BF16 ? 2 : 4;
  const Geom g = {B, B * T_in * H * (int64_t)W * cin * es, T_in, H, W, T_out,
                  H_out, W_out, pt0, ph0, pw0, t_edge, n_wt,
                  (int)((uintptr_t)x & 15)};
  float* pt = (float*)part;
  switch (cin) {
    case 1: return launch<1>(dtype, x, dy, pt, (float*)dw, (float*)dbias, g, (int)n_tiles, grid, per, s);
    case 2: return launch<2>(dtype, x, dy, pt, (float*)dw, (float*)dbias, g, (int)n_tiles, grid, per, s);
    case 3: return launch<3>(dtype, x, dy, pt, (float*)dw, (float*)dbias, g, (int)n_tiles, grid, per, s);
    case 4: return launch<4>(dtype, x, dy, pt, (float*)dw, (float*)dbias, g, (int)n_tiles, grid, per, s);
  }
  return (int)cudaErrorInvalidValue;
}
