// K3.bwd: the gradient of the stem conv (K3, csrc/stem.cu) in its weights
// and bias: for a 3x3x3 stride-1 conv of x (B, T, H, W, Cin <= 4) to 128
// channels, with time padded by repeating the edge frame or by zeros and
// H/W by zeros,
//   dW[o, ci, dt, dh, dw] = sum over (b, t, h, w) of
//                           xpad[b, t+dt, h+dh, w+dw, ci] * dy[b, t, h, w, o]
//   dbias[o] = sum of dy[..., o].
// There is no dx: the stem's input is the pixels.  The TPU package has no
// kernel for it: its gradient is XLA's autodiff of cvvae_tpu/ops/conv.py::
// _conv3d_stacked_stem.  What bounds it on an H100: 2 * 27 * Cin * 128
// operations an output position (23.1 GFLOP at Cin 3 on a 17x256x256 clip,
// 0.345 ms on fp32 FMAs), and one read of dy (0.174 ms in fp32, 0.087 in
// bf16) beside it.
//
// The design, simple first: exact fp32 FMAs for bf16 and fp32 inputs
// alike, deterministic without atomics.
// - A persistent grid of kBlocksPerSm blocks an SM; block k owns a fixed,
//   contiguous range of `per` tiles, a tile kTW output pixels of one output
//   row (b, t, h) (ops/kernels/stem.py::bwd_plan).
// - For each tile the block stages in shared memory dy's tile in fp32 (its
//   pixels x 128 channels, one contiguous span; fp32 copied by 16-byte
//   cp.async, bf16 widened on the way), zeros in the rows past the tile's
//   pixels up to a multiple of 3; and the input patch in fp32 (9 rows
//   (dt, dh) x kPC pixels x 4 channels, the padding folded in as K3 folds
//   it: time clamped in edge mode, H, W and zero-mode time masked).  Every
//   copy and load of a thread is issued before it waits on one
//   (utils/kernel_variants.py --kernel K3.bwd times the alternatives); a
//   second dy stage, so that the next tile's copy overlaps this tile's
//   products, gained nothing: the products are the limit (PERF.md).
// - Warp r owns patch row r = dt * 3 + dh; lane l owns channels 4l..4l+3.
//   A thread keeps its 3 (dw) x Cin x 4 sums in registers and walks the
//   tile's pixels in order, three at a time, with the three patch columns
//   of its pixel in a sliding window of registers (one new column a
//   pixel, a broadcast load); warp 0 also sums dy for dbias.
// - Each block writes its sums to its slot of a (grid, 27 * Cin + 1, 128)
//   scratch; stem_bwd_merge, one thread an output value, adds the slots
//   in order in double and writes dW (128, Cin, 3, 3, 3) and dbias in
//   fp32.
//
// kTW and kBlocksPerSm are read by ops/kernels/stem.py (bwd_plan and its
// tests) from this file.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kCout = 128;
constexpr int kTW = 64;                  // output pixels a tile
constexpr int kWarps = 9;                // one a patch row (dt, dh)
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 2;
constexpr int kPX = kTW + 2;             // pixels a tile rounded up to 3
constexpr int kPC = kPX + 6;             // patch columns (the window reads kPX + 2)
constexpr int kMergeThreads = 256;

struct Geom {
  int64_t B;
  int T_in, H, W, T_out, H_out, W_out, pt0, ph0, pw0, t_edge, n_wt;
};

// 8 bf16 values as two float4
__device__ __forceinline__ void widen(const uint4& u, float4& lo, float4& hi) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  lo = make_float4(__low2float(h[0]), __high2float(h[0]), __low2float(h[1]),
                   __high2float(h[1]));
  hi = make_float4(__low2float(h[2]), __high2float(h[2]), __low2float(h[3]),
                   __high2float(h[3]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

struct Tile {
  int64_t orow;  // (b, t, h) of the output
  int w0, np;    // first column, pixels
};

// tile idx -> output row and columns: tiles run along the rows, so a
// block's range is one span of dy
__device__ __forceinline__ Tile tile_of(int idx, const Geom& g) {
  Tile t;
  t.orow = idx / g.n_wt;
  t.w0 = (idx % g.n_wt) * kTW;
  t.np = min(kTW, g.W_out - t.w0);
  return t;
}

// acc[dw][ci] += col_dw[ci] * d for the pixel whose patch columns are
// (c0, c1, c2)
template <int CIN>
__device__ __forceinline__ void pixel(float4 (&acc)[3][CIN], const float4& d,
                                      const float4& c0, const float4& c1,
                                      const float4& c2) {
  const float4 cols[3] = {c0, c1, c2};
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) {
      const float xv = ci == 0 ? cols[dw].x : ci == 1 ? cols[dw].y
                     : ci == 2 ? cols[dw].z : cols[dw].w;
      acc[dw][ci].x = fmaf(xv, d.x, acc[dw][ci].x);
      acc[dw][ci].y = fmaf(xv, d.y, acc[dw][ci].y);
      acc[dw][ci].z = fmaf(xv, d.z, acc[dw][ci].z);
      acc[dw][ci].w = fmaf(xv, d.w, acc[dw][ci].w);
    }
}

__device__ __forceinline__ void add4(float4& a, const float4& d) {
  a.x += d.x;
  a.y += d.y;
  a.z += d.z;
  a.w += d.w;
}

template <typename T, int CIN>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    stem_bwd_partial(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ part, Geom g, int n_tiles, int per) {
  __shared__ __align__(16) float4 patch[9 * kPC];   // [row][column]
  __shared__ __align__(16) float dys[kPX * kCout];   // [pixel][channel]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float4 acc[3][CIN];
  float4 bacc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) acc[dw][ci] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int first = blockIdx.x * per;
  const int last = min(n_tiles, first + per);
  for (int idx = first; idx < last; ++idx) {
    const Tile t = tile_of(idx, g);
    const int ho = (int)(t.orow % g.H_out);
    const int to = (int)((t.orow / g.H_out) % g.T_out);
    const int64_t b = t.orow / ((int64_t)g.H_out * g.T_out);
    const int np3 = (t.np + 2) / 3 * 3;
    __syncthreads();  // the last tile's reads are done
    // dy's tile, its np pixels, one contiguous span, in fp32: fp32 by
    // 16-byte cp.async; bf16 loaded 8 values a unit, every load before
    // the first store, then widened (once a tile, not once a warp)
    const uint4* src = reinterpret_cast<const uint4*>(
        dy + (t.orow * g.W_out + t.w0) * kCout);
    const int n16 = t.np * kCout * (int)sizeof(T) / 16;
    if constexpr (std::is_same<T, float>::value) {
      uint8_t* dst = reinterpret_cast<uint8_t*>(dys);
      for (int i = tid; i < n16; i += kThreads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(dst + 16 * i)), "l"(src + i)
                     : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      constexpr int kUnits = (kTW * kCout / 8 + kThreads - 1) / kThreads;
      uint4 u[kUnits];
#pragma unroll
      for (int j = 0; j < kUnits; ++j)
        if (tid + j * kThreads < n16) u[j] = src[tid + j * kThreads];
#pragma unroll
      for (int j = 0; j < kUnits; ++j)
        if (tid + j * kThreads < n16) {
          float4* d = reinterpret_cast<float4*>(dys) + 2 * (tid + j * kThreads);
          widen(u[j], d[0], d[1]);
        }
    }
    // the patch: row r = (dt, dh), column p is input column w0 + p - pw0;
    // every load issued before the first store
    constexpr int kIters = (9 * kPC + kThreads - 1) / kThreads;
    float v[kIters][4];
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kPC, p = i - r * kPC;
      int ti = to + r / 3 - g.pt0;
      const int hi = ho + r % 3 - g.ph0, wi = t.w0 + p - g.pw0;
      bool ok = i < 9 * kPC && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
      if (g.t_edge)
        ti = min(max(ti, 0), g.T_in - 1);
      else
        ok = ok && ti >= 0 && ti < g.T_in;
      const T* src = x + (((b * g.T_in + ti) * g.H + hi) * (int64_t)g.W + wi) * CIN;
#pragma unroll
      for (int ci = 0; ci < 4; ++ci)
        v[j][ci] = ok && ci < CIN ? to_f32(src[ci]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = tid + j * kThreads;
      if (i < 9 * kPC) patch[i] = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
    }
    // dy's rows np .. np3 - 1 are zeros (the copy writes rows 0 .. np - 1)
    for (int i = tid; i < (np3 - t.np) * kCout / 4; i += kThreads)
      reinterpret_cast<float4*>(dys + t.np * kCout)[i] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    const float4* prow = patch + warp * kPC;
    const float4* dv = reinterpret_cast<const float4*>(dys) + lane;
    float4 A = prow[0], B = prow[1], C = prow[2];
    for (int p0 = 0; p0 < np3; p0 += 3) {
      const float4 d0 = dv[(p0 + 0) * (kCout / 4)];
      const float4 d1 = dv[(p0 + 1) * (kCout / 4)];
      const float4 d2 = dv[(p0 + 2) * (kCout / 4)];
      pixel<CIN>(acc, d0, A, B, C);
      A = prow[p0 + 3];
      pixel<CIN>(acc, d1, B, C, A);
      B = prow[p0 + 4];
      pixel<CIN>(acc, d2, C, A, B);
      C = prow[p0 + 5];
      if (warp == 0) {
        add4(bacc, d0);
        add4(bacc, d1);
        add4(bacc, d2);
      }
    }
  }

  // slot blockIdx.x: row (dt, dh, dw, ci) of dW, row 27 * CIN of dbias
  float4* out = reinterpret_cast<float4*>(part + (int64_t)blockIdx.x *
                                                     (27 * CIN + 1) * kCout);
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci)
      out[((warp * 3 + dw) * CIN + ci) * (kCout / 4) + lane] = acc[dw][ci];
  if (warp == 0) out[27 * CIN * (kCout / 4) + lane] = bacc;
}

// one thread an output value (row k of 27 * cin + 1, channel o): the
// slots in order, in double
__global__ void __launch_bounds__(kMergeThreads)
    stem_bwd_merge(const float* __restrict__ part, float* __restrict__ dw,
                   float* __restrict__ dbias, int slots, int cin) {
  const int rows = 27 * cin + 1;
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= rows * kCout) return;
  const int k = i / kCout, o = i % kCout;
  double t = 0.0;
#pragma unroll 8
  for (int s = 0; s < slots; ++s) t += (double)part[(int64_t)s * rows * kCout + i];
  if (k == 27 * cin) {
    dbias[o] = (float)t;
  } else {
    // k = (tap, ci), tap = (dt * 3 + dh) * 3 + dw; dW is (O, Cin, 3, 3, 3)
    const int tap = k / cin, ci = k % cin;
    dw[(o * cin + ci) * 27 + tap] = (float)t;
  }
}

template <typename T, int CIN>
int launch(const void* x, const void* dy, float* part, float* dw, float* db,
           const Geom& g, int n_tiles, int grid, int per, cudaStream_t s) {
  stem_bwd_partial<T, CIN><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const T*)dy, part, g, n_tiles, per);
  const int outs = (27 * CIN + 1) * kCout;
  stem_bwd_merge<<<(outs + kMergeThreads - 1) / kMergeThreads, kMergeThreads,
                   0, s>>>(part, dw, db, grid, CIN);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_cin(int cin, const void* x, const void* dy, float* part,
                 float* dw, float* db, const Geom& g, int n_tiles, int grid,
                 int per, cudaStream_t s) {
  switch (cin) {
    case 1: return launch<T, 1>(x, dy, part, dw, db, g, n_tiles, grid, per, s);
    case 2: return launch<T, 2>(x, dy, part, dw, db, g, n_tiles, grid, per, s);
    case 3: return launch<T, 3>(x, dy, part, dw, db, g, n_tiles, grid, per, s);
    case 4: return launch<T, 4>(x, dy, part, dw, db, g, n_tiles, grid, per, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (B, T_in, H, W, cin) contiguous; dy: (B, T_out, H_out, W_out, 128)
// contiguous and 16-byte aligned, x's dtype; part: (grid, 27 * cin + 1,
// 128) f32 scratch; dw: (128, cin, 3, 3, 3) f32 out; dbias: (128,) f32
// out.  Pads: time (pt0, .) in edge (t_edge=1) or zero mode, H/W zero.
// Block k takes tiles [k * per, (k + 1) * per) of the B * T_out * H_out *
// ceil(W_out / tile_w) tiles (tile_w = kTW), (ops/kernels/stem.py::
// bwd_plan).
CVVAE_EXPORT int cvvae_stem_conv3d_bwd(
    const void* x, const void* dy, void* part, void* dw, void* dbias,
    int64_t B, int T_in, int H, int W, int cin, int T_out, int H_out,
    int W_out, int pt0, int ph0, int pw0, int t_edge, int tile_w, int grid,
    int per, int dtype, int device, void* stream) {
  const int n_wt = (W_out + kTW - 1) / kTW;
  const int64_t n_tiles = B * T_out * (int64_t)H_out * n_wt;
  if (tile_w != kTW || grid < 1 || per < 1 || cin < 1 || cin > 4 ||
      (int64_t)grid * per < n_tiles || n_tiles + (int64_t)per > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const Geom g = {B, T_in, H, W, T_out, H_out, W_out, pt0, ph0, pw0, t_edge,
                  n_wt};
  float* pt = (float*)part;
  if (dtype == CVVAE_BF16)
    return dispatch_cin<__nv_bfloat16>(cin, x, dy, pt, (float*)dw,
                                       (float*)dbias, g, (int)n_tiles, grid,
                                       per, s);
  if (dtype == CVVAE_F32)
    return dispatch_cin<float>(cin, x, dy, pt, (float*)dw, (float*)dbias, g,
                               (int)n_tiles, grid, per, s);
  return (int)cudaErrorInvalidValue;
}
