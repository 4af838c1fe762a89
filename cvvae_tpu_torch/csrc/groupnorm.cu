// K1: GroupNorm (+ optional SiLU) over a contiguous (B, S, C) view.
//
// Replaces cvvae_tpu/ops/pallas/groupnorm.py::group_norm_silu_pallas.
// The TPU kernel carries its statistics across a sequential grid; blocks
// here run in parallel in no order, so the reduction is three launches,
// deterministic and without atomics:
//   1. gn_stats: a grid of about 8 blocks an SM (the plan, made by the
//      wrapper: ``n_blocks`` blocks per batch row, each a contiguous run
//      of ``rows_per_block`` rows) reads x once in 16-byte loads, four in
//      flight per thread, neighbouring threads on neighbouring addresses.
//      Thread (tx, ty) owns one V-channel vector of every ty-th row, so
//      its channels, and the groups they fold into, never change.  It
//      sums x - K and (x - K)^2 in fp32 over each batch of loads and adds
//      the batch to double accumulators; K is one value of the group
//      (its first element in row 0), the same in every block, so the
//      moments of all blocks add.  The block folds its threads' moments
//      per group in a fixed order and writes them, in double.
//   2. gn_merge: one warp per (batch row, group) sums the blocks' moments
//      in a fixed order (lane-strided, then a fixed shuffle tree), takes
//      mean and variance in double about K, and folds mean, 1/std, scale
//      and bias into a per-channel affine a, b.
//   3. gn_apply: the same plan and thread layout; each thread keeps its
//      V channels' (a, b) in registers and writes y = fma(x, a, b) (fp32,
//      one rounding), then SiLU, in 16-byte stores.
// Split across ranks (a tensor sharded along its rows over a mesh,
// ops/kernels/groupnorm.py::group_norm_silu_sharded), the same three steps
// become two entries around one collective, one launch each:
//   cvvae_group_norm_partial: gn_partial, on the split plan
//      (ops/kernels/groupnorm.py::split_plan: K1's vector width and
//      threads, about kSplitBlocksPerSm blocks an SM over all batch rows,
//      at least kSplitMinRows rows a block).  Each block runs gn_stats'
//      pass (block_stats) and writes its moments, fences them, and takes a
//      ticket from its batch row's counter (in the wrapper's scratch, zero
//      between launches).  The block that takes the row's last ticket folds
//      the row's block moments in block-index order, whichever block
//      finished last (fold_row: the order of gn_merge's block_moments,
//      its loads batched), writes each (batch row, group)'s count, mean and
//      M2 (the sum of squared deviations from that mean) in double, and
//      sets the counter back to zero.  Every rank shifts by its own K, so
//      the moments about K do not add across ranks; (count, mean, M2) do,
//      by Chan's formula.
//   (the wrapper all-gathers every rank's (B, G, 3) in rank order)
//   cvvae_group_norm_combine: gn_combine, on the split plan: each thread
//      folds the ranks' (count, mean, M2) of its own channels' groups in
//      rank order by Chan's formula in double (chan_moments:
//      deterministic, independent of timing), makes its channels' affine
//      (channel_affine) and applies it as gn_apply does (apply_rows).  No
//      coefficient leaves the thread.
// Their earlier two-launch forms stay as references for the card's checks
// and for utils/kernel_variants.py, on no path: the pair entries
// (gn_stats + gn_partial_fold; gn_combine_coef + gn_apply), the same
// arithmetic in the same order.
// The int8 mode (cvvae_group_norm_int8), for an int8-resident activation
// (cvvae_tpu/ops/qflow.py:138-172, qgroup_norm_silu), computes the JAX
// package's function, not K1's own statistics.  Its output is a function
// of (batch row, channel, code) only, 256 codes, so it is applied as a
// lookup:
//   gnq_stats: one block an SM over int8 x (4 codes a load); exact
//      per-channel int32 sums of q and q^2 in a thread's registers (no
//      conversion, no float product), added over the block's threads and
//      written per channel; the plan keeps a block's rows below
//      kMaxBlockRows, where q^2's sum still fits.
//   gnq_merge: one block per (group, batch row): s[c] * sum q and s[c]^2 *
//      sum q^2 (s the dequantizing scale, a scalar or per channel) added
//      in double in a fixed order, then JAX's one-pass moments: the fp32
//      mean and mean of squares, var = E[x^2] - mean^2 in fp32 (not
//      clamped: it can go slightly negative, as JAX's can), inv = rsqrt(var
//      + eps) correctly rounded, the folded affine a = inv * w[c] * s[c], b
//      = bias[c] - mean * inv * w[c], each product rounded as JAX writes
//      it; then the table: for each channel and each of the 256 codes, h =
//      q * a + b (two roundings, as the reference's), SiLU in fp32 (h * 1 /
//      (1 + exp(-h))), as int8 at the consumer's scalar out_scale (quant8,
//      common.cuh) or bf16 / fp32 bits, in a 32-bit entry.
//   gnq_apply: y = table[code]: a 4-byte load, 4 shared-memory lookups
//      that no two lanes of a warp make in one bank, one 4-, 8- or 16-byte
//      store (the layout is at the kernel).  Where C is no multiple of 32
//      the plan gives no table and gnq_apply_arith computes the same
//      arithmetic per element from a and b.
//   Its statistics run over every axis but the batch and the channels
//   (T, H, W, C/G); 2 bytes an element of traffic with an int8 output, x
//   read twice: 1.5 * 2 bytes, 0.943 ms at (1,17,720,672,128).
// Bound: device memory.  One read and one write of x is the least
// traffic (8.02 GB at (1,17,720,1280,128) bf16: 2.39 ms at 3.35 TB/s);
// this design reads x twice (the statistics must be complete before the
// first output), so 12.0 GB, 3.59 ms at the card's peak.
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // loads in flight per thread

// V elements of T in one aligned load
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the launch plan, made by ops/kernels/groupnorm.py::launch_plan
struct Plan {
  int64_t S;
  int C, G, cg;
  int nvc;              // C / V: vector columns per row (threads across C)
  int rows_per_iter;    // threads / nvc: rows a block reads at once
  int64_t rows_per_block;
  int n_blocks;         // blocks per batch row
};

// threads a block may have: 256, or up to 1024 where V <= 2 and C / V >
// 256 (every thread owns one vector column)
template <int V>
constexpr int max_threads() {
  return V > 2 ? 256 : 1024;
}

// the split entries' plan (ops/kernels/groupnorm.py::split_plan): blocks
// an SM it aims at over all batch rows (K1's 256 threads a block where V >
// 2, so at most 8 fit an SM), and rows a block at the least where S has
// them: 128 rows keeps K1's partition wherever it gives a block as many
// (the 720p level-0 half: 7,419 rows a block) and gives the per-frame
// halves a few long blocks an SM (57 a frame at (5, 7200, 512), 30 at
// (5, 3780, 512)), whose loads fill the card and whose block moments the
// fold reads in 2 and 1 loads a lane
constexpr int kSplitBlocksPerSm = 8;
constexpr int kSplitMinRows = 128;
static_assert(kSplitBlocksPerSm * 256 <= 2048 && kSplitMinRows >= 1,
              "the plan's blocks fit an SM and have rows");
// gn_partial's fold: groups a warp takes at once, block moments a lane
// loads for each of them at once (few registers: the fold must not cost
// the stats pass its loads in flight)
constexpr int kFoldGroups = 4;
constexpr int kFoldLoads = 1;

// Moments of block (blockIdx.x, batch row blockIdx.y) into part, every
// thread of the block taking part (gn_stats, gn_partial): thread slot s
// holds channels whose group is the s-th of the NS groups its vector
// touches (NS = V / cg when a vector spans several groups, else 1).
template <typename T, int V, int NS>
__device__ __forceinline__ void block_stats(const T* __restrict__ x,
                                            double* __restrict__ part,
                                            const Plan& p, double* sh) {
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  const int b = blockIdx.y, blk = blockIdx.x;
  const T* xb = x + (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;

  float shift[NS];
  double s1[NS], s2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    shift[s] = to_f32(xb[((c0 + s * (V / NS)) / p.cg) * p.cg]);
    s1[s] = 0.0;
    s2[s] = 0.0;
  }
  if (ty < p.rows_per_iter) {
    for (int64_t r = r0 + ty; r < r1; r += step) {
      Pack<T, V> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row = r + (int64_t)u * p.rows_per_iter;
        if (row < r1)
          v[u] = *reinterpret_cast<const Pack<T, V>*>(xb + row * p.C + c0);
      }
      float f1[NS], f2[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) f1[s] = f2[s] = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + (int64_t)u * p.rows_per_iter < r1) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int s = j / (V / NS);
            const float d = to_f32(v[u].v[j]) - shift[s];
            f1[s] += d;
            f2[s] = fmaf(d, d, f2[s]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        s1[s] += (double)f1[s];
        s2[s] += (double)f2[s];
      }
    }
    const int w = p.nvc * NS;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sh[(ty * w + tx * NS + s) * 2] = s1[s];
      sh[(ty * w + tx * NS + s) * 2 + 1] = s2[s];
    }
  }
  __syncthreads();
  // slot k of a row holds group k (NS > 1) or group k / (cg / V) (NS ==
  // 1): a group's slots are [g * per, (g + 1) * per)
  const int w = p.nvc * NS;
  const int per = NS > 1 ? 1 : p.cg / V;
  for (int g = threadIdx.x; g < p.G; g += blockDim.x) {
    double a1 = 0.0, a2 = 0.0;
    for (int y = 0; y < p.rows_per_iter; ++y)
      for (int k = g * per; k < (g + 1) * per; ++k) {
        a1 += sh[(y * w + k) * 2];
        a2 += sh[(y * w + k) * 2 + 1];
      }
    double* out = part + (((int64_t)b * p.n_blocks + blk) * p.G + g) * 2;
    out[0] = a1;
    out[1] = a2;
  }
}

template <typename T, int V, int NS>
__global__ void __launch_bounds__(max_threads<V>())
    gn_stats(const T* __restrict__ x, double* __restrict__ part, Plan p) {
  extern __shared__ double sh[];  // [rows_per_iter][nvc * NS][2]
  block_stats<T, V, NS>(x, part, p, sh);
}

// the blocks' moments of (batch row b, group g), summed by one warp in a
// fixed order (lane-strided, then a fixed shuffle tree): every lane ends
// with the same sums
__device__ __forceinline__ void block_moments(const double* __restrict__ part,
                                              int b, int g, int lane,
                                              const Plan& p, double* s1,
                                              double* s2) {
  double a1 = 0.0, a2 = 0.0;
  for (int k = lane; k < p.n_blocks; k += 32) {
    const double* q = part + (((int64_t)b * p.n_blocks + k) * p.G + g) * 2;
    a1 += q[0];
    a2 += q[1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
  }
  *s1 = a1;
  *s2 = a2;
}

// one warp per (batch row, group)
template <typename T>
__global__ void gn_merge(const T* __restrict__ x,
                         const double* __restrict__ part,
                         const float* __restrict__ weight,
                         const float* __restrict__ bias,
                         float* __restrict__ coef, float* __restrict__ stats,
                         int B, Plan p, float eps) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  double a1, a2;
  block_moments(part, b, g, lane, p, &a1, &a2);
  const double n = (double)p.S * p.cg;
  const double m = a1 / n;  // mean of x - K
  const double var = fmax(a2 / n - m * m, 0.0);
  const float mean =
      (float)((double)to_f32(x[(int64_t)b * p.S * p.C + g * p.cg]) + m);
  const float inv = rsqrtf((float)var + eps);
  // saved for K1.bwd (csrc/groupnorm_bwd.cu) when a gradient is needed
  if (stats != nullptr && lane == 0) {
    stats[((int64_t)b * p.G + g) * 2] = mean;
    stats[((int64_t)b * p.G + g) * 2 + 1] = inv;
  }
  for (int c = g * p.cg + lane; c < (g + 1) * p.cg; c += 32) {
    const float a = inv * weight[c];
    coef[(int64_t)b * 2 * p.C + c] = a;
    coef[(int64_t)b * 2 * p.C + p.C + c] = bias[c] - mean * a;
  }
}

// (count, mean, M2) of (batch row b, group g) in double from the sums a1,
// a2 of x - k over its rows, k the group's first element
__device__ __forceinline__ void write_moments(double k, double a1, double a2,
                                              int b, int g, const Plan& p,
                                              double* __restrict__ moments) {
  const double n = (double)p.S * p.cg;
  const double m = a1 / n;  // mean of x - K
  double* out = moments + ((int64_t)b * p.G + g) * 3;
  out[0] = n;
  out[1] = k + m;
  out[2] = fmax(a2 - a1 * m, 0.0);  // sum of (x - mean)^2
}

// one warp per (batch row, group): the blocks' moments summed as gn_merge
// sums them, written as (count, mean, M2) in double for the cross-rank
// combination (the fold's own launch: the pair entry's, on no path)
template <typename T>
__global__ void gn_partial_fold(const T* __restrict__ x,
                                const double* __restrict__ part,
                                double* __restrict__ moments, int B, Plan p) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  double a1, a2;
  block_moments(part, b, g, lane, p, &a1, &a2);
  if (lane == 0)
    write_moments(to_f32(x[(int64_t)b * p.S * p.C + g * p.cg]), a1, a2, b, g,
                  p, moments);
}

// The fold of batch row b by one block (gn_partial's last): warp w takes
// groups w, w + warps, ..., kFoldGroups of them at once, each lane loading
// its blocks' moments of all of them (kFoldLoads blocks a group at a time,
// through L2: other blocks wrote them) before it adds any.  Each group's
// sums in block_moments' order: lane l adds blocks l, l + 32, ... in turn,
// then the same shuffle tree.
template <typename T>
__device__ __forceinline__ void fold_row(const T* __restrict__ x,
                                         const double* __restrict__ part,
                                         double* __restrict__ moments, int b,
                                         const Plan& p) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const double2* q =
      reinterpret_cast<const double2*>(part) + (int64_t)b * p.n_blocks * p.G;
  const int n = p.n_blocks;
  // not unrolled: an unrolled copy of either loop would hold more loads,
  // and the kernel's registers are the stats pass's occupancy
#pragma unroll 1
  for (int g0 = threadIdx.x >> 5; g0 < p.G; g0 += warps * kFoldGroups) {
    double a1[kFoldGroups], a2[kFoldGroups];
    float k[kFoldGroups];
#pragma unroll
    for (int i = 0; i < kFoldGroups; ++i) {
      const int g = g0 + i * warps;
      a1[i] = a2[i] = 0.0;
      k[i] = g < p.G ? to_f32(x[(int64_t)b * p.S * p.C + g * p.cg]) : 0.f;
    }
#pragma unroll 1
    for (int k0 = lane; k0 < n; k0 += 32 * kFoldLoads) {
      double2 v[kFoldGroups][kFoldLoads];
#pragma unroll
      for (int i = 0; i < kFoldGroups; ++i)
#pragma unroll
        for (int u = 0; u < kFoldLoads; ++u)
          if (g0 + i * warps < p.G && k0 + 32 * u < n)
            v[i][u] = __ldcg(q + (int64_t)(k0 + 32 * u) * p.G + g0 + i * warps);
#pragma unroll
      for (int i = 0; i < kFoldGroups; ++i)
#pragma unroll
        for (int u = 0; u < kFoldLoads; ++u)
          if (g0 + i * warps < p.G && k0 + 32 * u < n) {
            a1[i] += v[i][u].x;
            a2[i] += v[i][u].y;
          }
    }
#pragma unroll
    for (int i = 0; i < kFoldGroups; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a1[i] += __shfl_xor_sync(0xffffffffu, a1[i], o);
        a2[i] += __shfl_xor_sync(0xffffffffu, a2[i], o);
      }
      if (lane == 0 && g0 + i * warps < p.G)
        write_moments(k[i], a1[i], a2[i], b, g0 + i * warps, p, moments);
    }
  }
}

// gn_partial's blocks an SM at the least: 4 of 256 threads (at most 64
// registers a thread, what gn_stats' pass takes there) where a thread's
// vector spans at most 2 groups, so the fold's registers cost the pass no
// loads in flight; elsewhere as the pass needs
template <int V, int NS>
constexpr int partial_min_blocks() {
  return V > 2 && NS <= 2 ? 4 : 1;
}

// K1.partial in one launch: block (blockIdx.x, batch row blockIdx.y) writes
// its moments as gn_stats does; the block that takes its row's last ticket
// folds the row's blocks in block-index order (fold_row) and writes
// (count, mean, M2) for every group, then sets the row's counter back to
// zero for the next launch on this stream
template <typename T, int V, int NS>
__global__ void __launch_bounds__(max_threads<V>(), partial_min_blocks<V, NS>())
    gn_partial(const T* __restrict__ x, double* __restrict__ part,
               unsigned* __restrict__ tickets, double* __restrict__ moments,
               Plan p) {
  extern __shared__ double sh[];  // [rows_per_iter][nvc * NS][2]
  __shared__ bool last;
  block_stats<T, V, NS>(x, part, p, sh);
  if (threadIdx.x < p.G) __threadfence();  // its moments before the ticket
  __syncthreads();
  const int b = blockIdx.y;
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + b, 1u) == (unsigned)(p.n_blocks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();  // every block's moments are read after its ticket
  fold_row(x, part, moments, b, p);
  if (threadIdx.x == 0) tickets[b] = 0u;
}

// the R ranks' (count, mean, M2) of (batch row b, group g), laid out (R,
// B, G, 3), combined in rank order by Chan's formula in double; its mean
// and 1/std in fp32
__device__ __forceinline__ void chan_moments(const double* __restrict__ moments,
                                             int R, int B, int b, int g,
                                             const Plan& p, float eps,
                                             float* meanf, float* inv) {
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int r = 0; r < R; ++r) {
    const double* q = moments + (((int64_t)r * B + b) * p.G + g) * 3;
    const double nb = q[0];
    if (nb <= 0.0) continue;
    const double nab = n + nb, d = q[1] - mean;
    mean += d * (nb / nab);
    m2 += q[2] + d * d * (n * nb / nab);
    n = nab;
  }
  const double var = fmax(m2 / n, 0.0);
  *meanf = (float)mean;
  *inv = rsqrtf((float)var + eps);
}

// channel c's affine y = x * a + b from its group's mean and 1/std, folded
// as gn_merge folds it
__device__ __forceinline__ void channel_affine(float meanf, float inv,
                                               float w, float bias, float* a,
                                               float* b) {
  *a = inv * w;
  *b = bias - meanf * *a;
}

// one warp per (batch row, group): chan_moments, then the affine into coef
// (the combination's own launch: the pair entry's, on no path)
__global__ void gn_combine_coef(const double* __restrict__ moments, int R,
                                const float* __restrict__ weight,
                                const float* __restrict__ bias,
                                float* __restrict__ coef,
                                float* __restrict__ stats, int B, Plan p,
                                float eps) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (wid >= B * p.G) return;
  const int b = wid / p.G, g = wid % p.G;
  float meanf, inv;
  chan_moments(moments, R, B, b, g, p, eps, &meanf, &inv);
  if (stats != nullptr && lane == 0) {
    stats[((int64_t)b * p.G + g) * 2] = meanf;
    stats[((int64_t)b * p.G + g) * 2 + 1] = inv;
  }
  for (int c = g * p.cg + lane; c < (g + 1) * p.cg; c += 32)
    channel_affine(meanf, inv, weight[c], bias[c],
                   coef + (int64_t)b * 2 * p.C + c,
                   coef + (int64_t)b * 2 * p.C + p.C + c);
}

// y = fma(x, a, b) in fp32, one rounding, then SiLU, over thread (tx, ty)'s
// rows of block (blk, batch row b), 16-byte loads and stores (gn_apply,
// gn_combine)
template <typename T, int V, bool kSilu>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x,
                                           T* __restrict__ y,
                                           const float (&a)[V],
                                           const float (&bb)[V],
                                           const Plan& p, int b, int blk,
                                           int tx, int ty) {
  const int64_t off = (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;
  for (int64_t r = r0 + ty; r < r1; r += step) {
    Pack<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + (int64_t)u * p.rows_per_iter;
      if (row < r1)
        v[u] = *reinterpret_cast<const Pack<T, V>*>(x + off + row * p.C + c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + (int64_t)u * p.rows_per_iter;
      if (row < r1) {
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float t = fmaf(to_f32(v[u].v[j]), a[j], bb[j]);
          if (kSilu) t = t / (1.f + __expf(-t));
          o.v[j] = from_f32<T>(t);
        }
        *reinterpret_cast<Pack<T, V>*>(y + off + row * p.C + c0) = o;
      }
    }
  }
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(max_threads<V>())
    gn_apply(const T* __restrict__ x, T* __restrict__ y,
             const float* __restrict__ coef, Plan p) {
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  if (ty >= p.rows_per_iter) return;
  const int b = blockIdx.y;
  const int c0 = tx * V;
  float a[V], bb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = coef[(int64_t)b * 2 * p.C + c0 + j];
    bb[j] = coef[(int64_t)b * 2 * p.C + p.C + c0 + j];
  }
  apply_rows<T, V, kSilu>(x, y, a, bb, p, b, blockIdx.x, tx, ty);
}

// K1.combine in one launch: every thread of block (blockIdx.x, batch row
// blockIdx.y) folds the ranks' moments of its own channels' groups
// (chan_moments: a few double operations a rank, so no barrier and no
// shared memory), makes its channels' affine and applies it; its first
// rows are requested into L2 before the fold, whose loads of the moments
// would otherwise stand before the first of them.  The row's first block
// also writes each group's mean and 1/std to stats, where asked.
template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(max_threads<V>())
    gn_combine(const T* __restrict__ x, T* __restrict__ y,
               const float* __restrict__ weight,
               const float* __restrict__ bias,
               const double* __restrict__ moments, int R, int B,
               float* __restrict__ stats, Plan p, float eps) {
  const int b = blockIdx.y;
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  const int c0 = tx * V;
  const int64_t r0 = (int64_t)blockIdx.x * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  if (ty < p.rows_per_iter) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r0 + ty + (int64_t)u * p.rows_per_iter;
      if (row < r1)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            x + ((int64_t)b * p.S + row) * p.C + c0));
    }
  }
  if (stats != nullptr && blockIdx.x == 0)
    for (int g = threadIdx.x; g < p.G; g += blockDim.x) {
      float meanf, inv;
      chan_moments(moments, R, B, b, g, p, eps, &meanf, &inv);
      stats[((int64_t)b * p.G + g) * 2] = meanf;
      stats[((int64_t)b * p.G + g) * 2 + 1] = inv;
    }
  if (ty >= p.rows_per_iter) return;
  float a[V], bb[V];
  float meanf = 0.f, inv = 0.f;
  int have = -1;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int g = (c0 + j) / p.cg;
    if (g != have) {
      chan_moments(moments, R, B, b, g, p, eps, &meanf, &inv);
      have = g;
    }
    channel_affine(meanf, inv, weight[c0 + j], bias[c0 + j], &a[j], &bb[j]);
  }
  apply_rows<T, V, kSilu>(x, y, a, bb, p, b, blockIdx.x, tx, ty);
}

// ---------------------------------------------------------------- int8 --

// the int8 mode's dequantizing scales: channel c's is s[c * per_channel]
struct QScale {
  const float* s;
  int per_channel;
};

// rows a stats block may take: its per-channel sums of q^2 (q^2 <= 127^2)
// stay below 2^31 in int32
constexpr int kMaxBlockRows = 133000;
// the stats pass: codes a load (where C allows), loads in flight a thread
// and threads a block at most (one block an SM)
constexpr int kStatsV = 4;
constexpr int kStatsUnroll = 16;
constexpr int kStatsThreads = 1024;
// threads of a merge block, one block a (group, batch row)
constexpr int kMergeThreads = 256;
// the table apply: threads of its block (one an SM), rows in flight a
// thread, and the table's layout: 64 channels a half (a code's row of 64
// words, 256 bytes, so 64 KB a half), two halves at most (128 channels)
constexpr int kApplyThreads = 1024;
constexpr int kApplyUnroll = 16;
constexpr int kHalfChannels = 64;
constexpr int kHalfBytes = 256 * kHalfChannels * 4;
// the apply reads the per-channel table (false: the arithmetic apply)
constexpr bool kTableApply = true;

// gnq_stats: exact per-channel integer sums of q and q^2 over a block's
// rows (the dequantizing scales are applied once, in gnq_merge): a
// thread's V channels (4 codes, one 32-bit load; a warp one 128-byte row
// at 128 channels) in int32 registers, kStatsUnroll loads in flight, one
// block of up to kStatsThreads an SM, so 64 KB in flight an SM; then the
// block's rows_per_iter threads of each channel added through shared
// memory and written as int32 (B, n_blocks, C, 2)
template <int V>
__global__ void __launch_bounds__(kStatsThreads, 1)
    gnq_stats(const int8_t* __restrict__ x, int* __restrict__ part, Plan p) {
  extern __shared__ int shq[];  // [rows_per_iter][C][2]
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int8_t* xb = x + (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  int s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0;
  auto add = [&](const Pack<int8_t, V>& v) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int q = v.v[j];
      s1[j] += q;
      s2[j] += q * q;
    }
  };
  if (ty < p.rows_per_iter) {
    // this thread's rows r0 + ty + i * rows_per_iter, i < n: kStatsUnroll
    // loads at once, by a pointer stepped a stride of rows_per_iter rows
    const int64_t n = (r1 - r0 - ty + p.rows_per_iter - 1) / p.rows_per_iter;
    const int stride = p.rows_per_iter * p.C;
    const int8_t* ptr = xb + (r0 + ty) * p.C + c0;
    int64_t i = 0;
    for (; i + kStatsUnroll <= n; i += kStatsUnroll) {
      Pack<int8_t, V> v[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        v[u] = *reinterpret_cast<const Pack<int8_t, V>*>(ptr + u * stride);
      ptr += (int64_t)kStatsUnroll * stride;
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) add(v[u]);
    }
    for (; i < n; ++i, ptr += stride)
      add(*reinterpret_cast<const Pack<int8_t, V>*>(ptr));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      shq[(ty * p.C + c0 + j) * 2] = s1[j];
      shq[(ty * p.C + c0 + j) * 2 + 1] = s2[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
    int a1 = 0, a2 = 0;
    for (int y = 0; y < p.rows_per_iter; ++y) {
      a1 += shq[(y * p.C + c) * 2];
      a2 += shq[(y * p.C + c) * 2 + 1];
    }
    int* out = part + (((int64_t)b * p.n_blocks + blk) * p.C + c) * 2;
    out[0] = a1;
    out[1] = a2;
  }
}

// SiLU(q * a + b) for code q, with the arithmetic (and roundings) of
// cvvae_tpu/ops/qflow.py:166-172: h = fl(fl(q a) + b), then h * 1 / (1 +
// exp(-h)), each operation rounded
__device__ __forceinline__ float qsilu(int q, float a, float b) {
  const float h = __fadd_rn(__fmul_rn((float)q, a), b);
  return __fmul_rn(h, 1.f / (1.f + expf(-h)));
}

// a table entry: the int8 code at out_scale (quant8), or the bf16 or fp32
// bits, in a 32-bit word
template <typename O>
__device__ __forceinline__ uint32_t entry(float t, float os, float ro) {
  if constexpr (sizeof(O) == 1)
    return (uint32_t)quant8(t, os, ro) & 0xffu;
  else if constexpr (sizeof(O) == 2)
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(t));
  else
    return __float_as_uint(t);
}

// gnq_merge: one block per (group, batch row).  The moments: each thread
// adds s[c] * sum q and s[c]^2 * sum q^2 (double) over a fixed stride of
// the (block, channel) pairs, then a fixed tree over the threads; JAX's
// one-pass fp32 moments from them and the folded affine a[c] = inv * w[c]
// * s[c], b[c] = bias[c] - mean * inv * w[c] (each product rounded as JAX
// writes it) into coef.  With a table, the group's entries for every code
// u of every channel: table[b][c / cs][u][c % cs] = entry(SiLU(q a[c] +
// b[c])), q the int8 value of the byte u.
template <typename O>
__global__ void __launch_bounds__(kMergeThreads)
    gnq_merge(const int* __restrict__ part, QScale qs,
              const float* __restrict__ weight,
              const float* __restrict__ bias, float* __restrict__ coef,
              const float* __restrict__ out_scale,
              uint32_t* __restrict__ table, int cs, Plan p, float eps) {
  __shared__ double red[2][kMergeThreads];
  __shared__ float fold[2];
  const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  auto scale = [&](int c) { return qs.s[c * qs.per_channel]; };
  double a1 = 0.0, a2 = 0.0;
  for (int i = t; i < p.n_blocks * p.cg; i += kMergeThreads) {
    const int k = i / p.cg, c = g * p.cg + i % p.cg;
    const int* q = part + (((int64_t)b * p.n_blocks + k) * p.C + c) * 2;
    const double s = scale(c);
    a1 += s * (double)q[0];
    a2 += s * s * (double)q[1];
  }
  red[0][t] = a1;
  red[1][t] = a2;
  __syncthreads();
  for (int o = kMergeThreads / 2; o > 0; o >>= 1) {
    if (t < o) {
      red[0][t] += red[0][t + o];
      red[1][t] += red[1][t + o];
    }
    __syncthreads();
  }
  if (t == 0) {
    const double n = (double)p.S * p.cg;
    const float mean = (float)(red[0][0] / n), msq = (float)(red[1][0] / n);
    const float var = __fsub_rn(msq, __fmul_rn(mean, mean));
    const float inv = __frsqrt_rn(__fadd_rn(var, eps));
    fold[0] = inv;
    fold[1] = __fmul_rn(mean, inv);
  }
  __syncthreads();
  const float inv = fold[0], mi = fold[1];
  auto coef_a = [&](int c) {
    return __fmul_rn(__fmul_rn(inv, weight[c]), scale(c));
  };
  auto coef_b = [&](int c) {
    return __fsub_rn(bias[c], __fmul_rn(mi, weight[c]));
  };
  for (int c = g * p.cg + t; c < (g + 1) * p.cg; c += kMergeThreads) {
    coef[(int64_t)b * 2 * p.C + c] = coef_a(c);
    coef[(int64_t)b * 2 * p.C + p.C + c] = coef_b(c);
  }
  if (table == nullptr) return;
  const float os = sizeof(O) == 1 ? *out_scale : 1.f, ro = __frcp_rn(os);
  for (int e = t; e < p.cg * 256; e += kMergeThreads) {
    const int c = g * p.cg + (e >> 8), u = e & 255;
    const float y = qsilu((int)(int8_t)u, coef_a(c), coef_b(c));
    table[(((int64_t)b * (p.C / cs) + c / cs) * 256 + u) * cs + c % cs] =
        entry<O>(y, os, ro);
  }
}

// the table apply's plan (ops/kernels/groupnorm.py::int8_plan): channel
// slices of cs (128, 64 or 32), n_blocks blocks a (batch row, slice), each
// a run of rows_per_block rows
struct ApplyPlan {
  int64_t S;
  int C, cs, n_slices;
  int64_t rows_per_block;
  int n_blocks;
};

// gnq_apply: y = table[code] for every int8 x.  One block of kApplyThreads
// an SM takes one (batch row, channel slice) and a run of rows: it copies
// the slice's table (256 codes x cs channels, 32-bit entries) into shared
// memory, channel c of a code u at byte (c / 64) * 64 KB + u * 256 + (c %
// 64) * 4, so an entry's bank is c mod 32 whatever the code.  A thread
// owns 4 channels (one 32-bit word of x) of every rows_per_iter-th row, a
// warp one 128-byte row at 128 channels (whole lines): it loads the word,
// and for each of the 4 codes makes the entry's byte address in one byte
// permute (the code into byte 1 of the channel's own offset, whose bytes
// 0 and 2 hold (c % 64) * 4 and c / 64), reads the entry, and packs the 4
// entries into one 4-byte (int8), 8-byte (bf16) or 16-byte (fp32) store.
// Lanes l and l + 8k sit on the same 4 channels mod 32 (4 (l mod 8) + k):
// each lane starts its 4 channels at (l / 8) mod 4, so the 32 lanes of a
// warp read 32 distinct banks at every step, conflict-free whatever the
// codes, and the stores put the entries back in channel order.
template <typename O>
__global__ void __launch_bounds__(kApplyThreads, 1)
    gnq_apply(const int8_t* __restrict__ x, O* __restrict__ y,
              const uint32_t* __restrict__ table, ApplyPlan p) {
  extern __shared__ uint32_t tab[];  // [cs / 64 halves][256][64]
  const int slice = blockIdx.y % p.n_slices, b = blockIdx.y / p.n_slices;
  const int lanes = p.cs / 4;  // threads across a row's slice
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        table + ((int64_t)b * p.n_slices + slice) * 256 * p.cs);
    for (int i = threadIdx.x; i < 64 * p.cs; i += kApplyThreads) {
      const int u = i / lanes, c = (i - u * lanes) * 4;
      reinterpret_cast<uint4*>(tab + (c / kHalfChannels) * (kHalfBytes / 4) +
                               u * kHalfChannels + c % kHalfChannels)[0] =
          __ldg(src + i);
    }
  }
  __syncthreads();
  const int sx = threadIdx.x % lanes, ry = threadIdx.x / lanes;
  const int rows_per_iter = kApplyThreads / lanes;
  const int rot = (threadIdx.x >> 3) & 3;
  // step j: channel 4 sx + k, k = (j + rot) mod 4: its byte's selector
  // and its offset (bytes 0 and 2); back in channel order, channel k's
  // entry is step (k - rot) mod 4's
  uint32_t sel[4], col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = (j + rot) & 3, c = 4 * sx + k;
    sel[j] = 0x7604u | (uint32_t)(k << 4);
    col[j] = (uint32_t)(c % kHalfChannels) * 4 |
             (uint32_t)(c / kHalfChannels) << 16;
  }
  uint32_t back = 0, back_hi = 0;  // int8: one selector; bf16: two
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = (k - rot) & 3;
    if constexpr (sizeof(O) == 1) {
      back |= (uint32_t)(j < 2 ? j : j + 2) << (4 * k);
    } else if constexpr (sizeof(O) == 2) {
      const uint32_t pair = (uint32_t)(2 * j) | (uint32_t)(2 * j + 1) << 4;
      if (k < 2)
        back |= pair << (8 * k);
      else
        back_hi |= pair << (8 * (k - 2));
    }
  }
  const char* tb = reinterpret_cast<const char*>(tab);
  const int64_t off = (int64_t)b * p.S * p.C + slice * p.cs + 4 * sx;
  const int64_t r0 = (int64_t)blockIdx.x * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)rows_per_iter * kApplyUnroll;
  for (int64_t r = r0 + ry; r < r1; r += step) {
    uint32_t w[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int64_t row = r + (int64_t)u * rows_per_iter;
      if (row < r1)
        w[u] = __ldg(reinterpret_cast<const uint32_t*>(x + off + row * p.C));
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int64_t row = r + (int64_t)u * rows_per_iter;
      if (row >= r1) continue;
      uint32_t e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = *reinterpret_cast<const uint32_t*>(
            tb + __byte_perm(w[u], col[j], sel[j]));
      O* dst = y + off + row * p.C;
      if constexpr (sizeof(O) == 1) {
        *reinterpret_cast<uint32_t*>(dst) =
            __byte_perm(__byte_perm(e[0], e[1], 0x0040),
                        __byte_perm(e[2], e[3], 0x0040), back);
      } else if constexpr (sizeof(O) == 2) {
        const uint32_t lo = __byte_perm(e[0], e[1], 0x5410);
        const uint32_t hi = __byte_perm(e[2], e[3], 0x5410);
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(__byte_perm(lo, hi, back), __byte_perm(lo, hi, back_hi));
      } else {
        // channel k's entry is e[(k - rot) mod 4]: rotate by rot's bits
        const bool r1b = rot & 1, r2b = rot & 2;
        const uint32_t g0 = r1b ? e[3] : e[0], g1 = r1b ? e[0] : e[1];
        const uint32_t g2 = r1b ? e[1] : e[2], g3 = r1b ? e[2] : e[3];
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(r2b ? g2 : g0, r2b ? g3 : g1, r2b ? g0 : g2,
                       r2b ? g1 : g3);
      }
    }
  }
}

// gnq_apply_arith: the apply computed per element (qsilu, then quant8 or
// the cast) from coef, on the stats pass's plan: the apply where C is no
// multiple of 32 (no table slice fits it), and the variant that measures
// what the table gains (kTableApply false)
template <typename O, int V>
__global__ void __launch_bounds__(kStatsThreads)
    gnq_apply_arith(const int8_t* __restrict__ x, O* __restrict__ y,
                    const float* __restrict__ coef,
                    const float* __restrict__ out_scale, Plan p) {
  const int tx = threadIdx.x % p.nvc, ty = threadIdx.x / p.nvc;
  if (ty >= p.rows_per_iter) return;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int64_t off = (int64_t)b * p.S * p.C;
  const int c0 = tx * V;
  float a[V], bb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = coef[(int64_t)b * 2 * p.C + c0 + j];
    bb[j] = coef[(int64_t)b * 2 * p.C + p.C + c0 + j];
  }
  const float os = sizeof(O) == 1 ? *out_scale : 1.f, ro = __frcp_rn(os);
  const int64_t r0 = (int64_t)blk * p.rows_per_block;
  const int64_t r1 = min_i64(p.S, r0 + p.rows_per_block);
  const int64_t step = (int64_t)p.rows_per_iter * kUnroll;
  for (int64_t r = r0 + ty; r < r1; r += step) {
    Pack<int8_t, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + (int64_t)u * p.rows_per_iter;
      if (row < r1)
        v[u] = *reinterpret_cast<const Pack<int8_t, V>*>(x + off + row * p.C +
                                                         c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + (int64_t)u * p.rows_per_iter;
      if (row < r1) {
        Pack<O, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = qsilu(v[u].v[j], a[j], bb[j]);
          if constexpr (sizeof(O) == 1)
            o.v[j] = (int8_t)quant8(t, os, ro);
          else
            o.v[j] = from_f32<O>(t);
        }
        *reinterpret_cast<Pack<O, V>*>(y + off + row * p.C + c0) = o;
      }
    }
  }
}

struct Int8Args {
  const int8_t* x;
  QScale qs;
  void* y;
  const float* weight;
  const float* bias;
  int* part;
  float* coef;
  uint32_t* table;
  const float* out_scale;
  int B;
  int threads;
  float eps;
};

template <typename O, int V>
int launch_int8(const Int8Args& a, const Plan& p, const ApplyPlan& ap,
                cudaStream_t stream) {
  const dim3 grid(p.n_blocks, a.B);
  const size_t smem = sizeof(int) * 2 * p.rows_per_iter * p.C;
  gnq_stats<V><<<grid, a.threads, smem, stream>>>(a.x, a.part, p);
  const bool table = kTableApply && ap.cs > 0;
  gnq_merge<O><<<dim3(p.G, a.B), kMergeThreads, 0, stream>>>(
      a.part, a.qs, a.weight, a.bias, a.coef, a.out_scale,
      table ? a.table : nullptr, ap.cs, p, a.eps);
  if (table) {
    const int bytes = kHalfBytes * (ap.cs > kHalfChannels ? 2 : 1);
    const cudaError_t e = cudaFuncSetAttribute(
        gnq_apply<O>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    gnq_apply<O><<<dim3(ap.n_blocks, a.B * ap.n_slices), kApplyThreads,
                   bytes, stream>>>(a.x, (O*)a.y, a.table, ap);
  } else {
    gnq_apply_arith<O, V><<<grid, a.threads, 0, stream>>>(
        a.x, (O*)a.y, a.coef, a.out_scale, p);
  }
  return (int)cudaGetLastError();
}

template <int V>
int dispatch_int8(int out_dtype, const Int8Args& a, const Plan& p,
                  const ApplyPlan& ap, cudaStream_t s) {
  if (out_dtype == CVVAE_I8) return launch_int8<int8_t, V>(a, p, ap, s);
  if (out_dtype == CVVAE_BF16)
    return launch_int8<__nv_bfloat16, V>(a, p, ap, s);
  return launch_int8<float, V>(a, p, ap, s);
}

// what one entry launches: the whole norm (gn_stats, gn_merge, gn_apply);
// one rank's partial moments (gn_partial); the cross-rank combination and
// the apply (gn_combine); or the last two in their two-launch forms
// (gn_stats, gn_partial_fold; gn_combine_coef, gn_apply)
enum Mode { kWhole, kPartial, kCombine, kPartialPair, kCombinePair };

struct Args {
  const void* x;
  void* y;
  const float* weight;
  const float* bias;
  double* part;
  unsigned* tickets;  // kPartial: a counter a batch row, zero between launches
  float* coef;
  float* stats;
  double* moments;  // (B, G, 3) for the partial, (R, B, G, 3) to combine
  int R;
  int B;
  int threads;
  float eps;
  int silu;
};

template <typename T, int V, int NS>
int launch(Mode mode, const Args& a, const Plan& p, cudaStream_t stream) {
  const dim3 grid(p.n_blocks, a.B);
  const int warps = a.B * p.G;
  const size_t smem = sizeof(double) * 2 * p.rows_per_iter * p.nvc * NS;
  if (mode == kPartial) {
    gn_partial<T, V, NS><<<grid, a.threads, smem, stream>>>(
        (const T*)a.x, a.part, a.tickets, a.moments, p);
    return (int)cudaGetLastError();
  }
  if (mode == kCombine) {
    if (a.silu)
      gn_combine<T, V, true><<<grid, a.threads, 0, stream>>>(
          (const T*)a.x, (T*)a.y, a.weight, a.bias, a.moments, a.R, a.B,
          a.stats, p, a.eps);
    else
      gn_combine<T, V, false><<<grid, a.threads, 0, stream>>>(
          (const T*)a.x, (T*)a.y, a.weight, a.bias, a.moments, a.R, a.B,
          a.stats, p, a.eps);
    return (int)cudaGetLastError();
  }
  if (mode != kCombinePair)
    gn_stats<T, V, NS><<<grid, a.threads, smem, stream>>>((const T*)a.x,
                                                           a.part, p);
  if (mode == kPartialPair) {
    gn_partial_fold<T><<<(warps + 7) / 8, 256, 0, stream>>>(
        (const T*)a.x, a.part, a.moments, a.B, p);
    return (int)cudaGetLastError();
  }
  if (mode == kWhole)
    gn_merge<T><<<(warps + 7) / 8, 256, 0, stream>>>(
        (const T*)a.x, a.part, a.weight, a.bias, a.coef, a.stats, a.B, p,
        a.eps);
  else
    gn_combine_coef<<<(warps + 7) / 8, 256, 0, stream>>>(
        a.moments, a.R, a.weight, a.bias, a.coef, a.stats, a.B, p, a.eps);
  if (a.silu)
    gn_apply<T, V, true><<<grid, a.threads, 0, stream>>>((const T*)a.x,
                                                          (T*)a.y, a.coef, p);
  else
    gn_apply<T, V, false><<<grid, a.threads, 0, stream>>>((const T*)a.x,
                                                           (T*)a.y, a.coef, p);
  return (int)cudaGetLastError();
}

// the (V, NS) pairs the plan may choose: V the widest of {16 bytes, 2, 1}
// elements that divides C and is a divisor or a multiple of C / G
template <typename T>
int dispatch(int V, int NS, Mode mode, const Args& a, const Plan& p,
             cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
#define CVVAE_GN(v, ns) \
  if (V == v && NS == ns) return launch<T, v, ns>(mode, a, p, s);
  CVVAE_GN(kV, 1)
  CVVAE_GN(kV, 2)
  CVVAE_GN(kV, 4)
  if constexpr (kV == 8) {
    CVVAE_GN(8, 8)
  }
  CVVAE_GN(2, 1)
  CVVAE_GN(2, 2)
  CVVAE_GN(1, 1)
#undef CVVAE_GN
  return (int)cudaErrorInvalidValue;
}

// the plan's checks, shared by the entries; 0 or an error code
int make_plan(int B, int64_t S, int C, int G, int V, int NS, int threads,
              int64_t rows_per_block, int n_blocks, Plan* p) {
  if (B <= 0 || B > 65535 || S <= 0 || G <= 0 || C % G != 0 || C > 1024 ||
      V <= 0 || C % V != 0 || NS <= 0 || V % NS != 0 || threads % 32 != 0 ||
      threads > (V > 2 ? 256 : 1024) || C / V > threads ||
      rows_per_block <= 0 || n_blocks <= 0 ||
      (int64_t)n_blocks * rows_per_block < S)
    return (int)cudaErrorInvalidValue;
  const int cg = C / G;
  if (NS > 1 ? V / NS != cg : cg % V != 0) return (int)cudaErrorInvalidValue;
  *p = Plan{S, C, G, cg, C / V, threads / (C / V), rows_per_block, n_blocks};
  return 0;
}

int run(Mode mode, const Args& a, int64_t S, int C, int G, int dtype, int V,
        int NS, int64_t rows_per_block, int n_blocks, int device,
        void* stream) {
  Plan p;
  const int rc = make_plan(a.B, S, C, G, V, NS, a.threads, rows_per_block,
                           n_blocks, &p);
  if (rc != 0) return rc;
  const bool combine = mode == kCombine || mode == kCombinePair;
  if ((combine && (a.R <= 0 || a.moments == nullptr)) ||
      (mode == kPartial && a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device)
    cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == CVVAE_BF16)
    return dispatch<__nv_bfloat16>(V, NS, mode, a, p, s);
  if (dtype == CVVAE_F32) return dispatch<float>(V, NS, mode, a, p, s);
  return (int)cudaErrorInvalidValue;
}

// a split entry's plan and shapes (ops/kernels/groupnorm.py::split_plan),
// passed by value; _build.GroupNormSplitPlan mirrors it
struct SplitPlan {
  int64_t S, rows_per_block;
  int B, C, G, V, NS, threads, n_blocks, dtype, device;
};

int run_split(Mode mode, const Args& a, const SplitPlan& sp, void* stream) {
  return run(mode, a, sp.S, sp.C, sp.G, sp.dtype, sp.V, sp.NS,
             sp.rows_per_block, sp.n_blocks, sp.device, stream);
}

// ticket counters in a partial's scratch: one a batch row, B <= 65535
constexpr int kTickets = 65536;

}  // namespace

// x, y: (B, S, C) contiguous, 16-byte aligned, dtype f32 or bf16.
// weight, bias: (C,) f32.  part: (B, n_blocks, G, 2) f64 scratch.  coef:
// (B, 2, C) f32 scratch.  stats: NULL, or (B, G, 2) f32 that receives each
// (batch row, group)'s mean and 1/std for the backward pass.  The plan (V,
// NS, threads, rows_per_block, n_blocks) comes from
// ops/kernels/groupnorm.py::launch_plan and is checked here.
CVVAE_EXPORT int cvvae_group_norm(const void* x, void* y, const void* weight,
                                  const void* bias, void* part, void* coef,
                                  void* stats, int B, int64_t S, int C, int G,
                                  float eps,
                                  int silu, int dtype, int V, int NS,
                                  int threads, int64_t rows_per_block,
                                  int n_blocks, int device, void* stream) {
  const Args a{x,       y,       (const float*)weight, (const float*)bias,
               (double*)part, nullptr, (float*)coef, (float*)stats, nullptr,
               0,       B,       threads, eps,       silu};
  return run(kWhole, a, S, C, G, dtype, V, NS, rows_per_block, n_blocks,
             device, stream);
}

// One rank's share of a norm split across ranks, one launch: x as above
// (this rank's rows, the plan's B, S, C); scratch: kTickets uint32 ticket
// counters, zero before the launch (it leaves them zero), then (B,
// n_blocks, G, 2) f64 block moments; moments: (B, G, 3) f64 that receives
// each (batch row, group)'s count, mean and M2 over this rank's rows.  The
// plan (ops/kernels/groupnorm.py::split_plan) may leave no block empty.
CVVAE_EXPORT int cvvae_group_norm_partial(const void* x, void* scratch,
                                          void* moments, SplitPlan sp,
                                          void* stream) {
  unsigned* tickets = static_cast<unsigned*>(scratch);
  Args a{};
  a.x = x;
  a.tickets = tickets;
  a.part = scratch == nullptr ? nullptr
                              : reinterpret_cast<double*>(tickets + kTickets);
  a.moments = (double*)moments;
  a.B = sp.B;
  a.threads = sp.threads;
  return run_split(kPartial, a, sp, stream);
}

// The rest of it, one launch: moments (R, B, G, 3) f64, every rank's
// partial in rank order; x, y, weight, bias and stats as cvvae_group_norm's;
// the plan as the partial's.
CVVAE_EXPORT int cvvae_group_norm_combine(const void* x, void* y,
                                          const void* weight,
                                          const void* bias,
                                          const void* moments, int R,
                                          void* stats, SplitPlan sp,
                                          float eps, int silu,
                                          void* stream) {
  const Args a{x, y, (const float*)weight, (const float*)bias, nullptr,
               nullptr, nullptr, (float*)stats, (double*)moments, R, sp.B,
               sp.threads, eps, silu};
  return run_split(kCombine, a, sp, stream);
}

// The two entries in their two-launch forms, on no path (the card's checks
// and utils/kernel_variants.py): the partial's stats pass and its fold each
// a launch, part the (B, n_blocks, G, 2) f64 block moments; the
// combination's affine written to coef (B, 2, C) f32 by one launch and
// applied by another.  The same arithmetic in the same order.
CVVAE_EXPORT int cvvae_group_norm_partial_pair(const void* x, void* part,
                                               void* moments, SplitPlan sp,
                                               void* stream) {
  Args a{};
  a.x = x;
  a.part = (double*)part;
  a.moments = (double*)moments;
  a.B = sp.B;
  a.threads = sp.threads;
  return run_split(kPartialPair, a, sp, stream);
}

CVVAE_EXPORT int cvvae_group_norm_combine_pair(
    const void* x, void* y, const void* weight, const void* bias,
    const void* moments, int R, void* coef, void* stats, SplitPlan sp,
    float eps, int silu, void* stream) {
  const Args a{x, y, (const float*)weight, (const float*)bias, nullptr,
               nullptr, (float*)coef, (float*)stats, (double*)moments, R,
               sp.B, sp.threads, eps, silu};
  return run_split(kCombinePair, a, sp, stream);
}

// The int8 mode: x (B, S, C) int8 contiguous, 16-byte aligned; scale: a
// device fp32 scalar (per_channel 0) or (C,) (per_channel 1); y (B, S, C)
// in out_dtype (CVVAE_I8, requantized at the device fp32 scalar
// out_scale, or CVVAE_BF16 / CVVAE_F32); weight, bias (C,) fp32.  Scratch:
// part (B, n_blocks, C, 2) int32, coef (B, 2, C) fp32, table (B, C / cs,
// 256, cs) 32-bit words (unused where cs is 0).  SiLU always
// (qgroup_norm_silu).  The plan comes from
// ops/kernels/groupnorm.py::int8_plan: the stats pass's V, threads and
// rows (also the arithmetic apply's), the apply's channel slice cs (128,
// 64, 32, or 0 for the arithmetic apply) and its blocks a (batch row,
// slice).
CVVAE_EXPORT int cvvae_group_norm_int8(
    const void* x, const void* scale, int per_channel, void* y,
    const void* weight, const void* bias, void* part, void* coef,
    void* table, const void* out_scale, int B, int64_t S, int C, int G,
    float eps, int out_dtype, int V, int threads, int64_t rows_per_block,
    int n_blocks, int cs, int64_t apply_rows_per_block, int apply_blocks,
    int device, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || G <= 0 || C % G != 0 || C > 1024 ||
      (V != 4 && V != 2 && V != 1) || C % V != 0 || threads % 32 != 0 ||
      threads > kStatsThreads || C / V > threads ||
      rows_per_block <= 0 || rows_per_block > kMaxBlockRows ||
      n_blocks <= 0 || (int64_t)n_blocks * rows_per_block < S ||
      (cs != 0 && cs != 32 && cs != 64 && cs != 128) ||
      (cs != 0 && C % cs != 0) ||
      (cs != 0 && (table == nullptr || apply_rows_per_block <= 0 ||
                   apply_blocks <= 0 || (int64_t)B * (C / cs) > 65535 ||
                   (int64_t)apply_blocks * apply_rows_per_block < S)) ||
      (out_dtype == CVVAE_I8) != (out_scale != nullptr) ||
      (out_dtype != CVVAE_I8 && out_dtype != CVVAE_BF16 &&
       out_dtype != CVVAE_F32) ||
      (per_channel != 0 && per_channel != 1))
    return (int)cudaErrorInvalidValue;
  const Plan p{S,       C,       G, C / G, C / V, threads / (C / V),
               rows_per_block, n_blocks};
  const ApplyPlan ap{S, C, cs, cs ? C / cs : 0, apply_rows_per_block,
                     apply_blocks};
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const Int8Args a{(const int8_t*)x, QScale{(const float*)scale, per_channel},
                   y, (const float*)weight, (const float*)bias, (int*)part,
                   (float*)coef, (uint32_t*)table, (const float*)out_scale,
                   B, threads, eps};
  if (V == 4) return dispatch_int8<4>(out_dtype, a, p, ap, s);
  if (V == 2) return dispatch_int8<2>(out_dtype, a, p, ap, s);
  return dispatch_int8<1>(out_dtype, a, p, ap, s);
}
