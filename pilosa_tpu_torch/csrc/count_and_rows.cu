// Per-(row, slice) popcount(row & filter): out[r, s] = popcount(rows[r][s, :]
// & filt[s, :]) for R candidate operands of [S, W] 32-bit words each and one
// filter of [S, W].
//
// Replaces, in pilosa_tpu:
//   - the Pallas kernel count_and_rows (ops/pallas_kernels.py:173,
//     pallas_call at :179): per-row popcount(m & filt) for m[R, W] and one
//     filter row filt[W] — here the fragment form, S = 1 and row r at
//     m + r * row_stride (TopN with a Src bitmap, storage/fragment.py:2977,
//     and its Tanimoto numerators through ops/topn.py:62), ONE launch for
//     any R: 500,000 molecule rows of a 128-word window at the
//     chemical-similarity shape;
//   - the XLA fusions of batched TopN (executor.py _batched_topn_fn
//     :4365-4371 and _batched_topn_tanimoto_fn :4393-4397), which count
//     |candidate ∩ src| per slice for R candidate stacks [S, W] against a
//     Src stack [S, W] — here the stacked form, out int32[R, S].
//
// Bound: device memory. Every candidate word and every filter word is read
// once and one int32 is written per (row, slice): (R + 1) * S * W * 4 bytes.
// At the main-path shape (R = 8 candidates, S = 9537 slices, W = 32768)
// that is 11.25 GB, 3.36 ms at 3.35 TB/s; R separate two-operand counts
// would read the filter R times (20.0 GB, 5.97 ms). The integer work (and,
// popc, add per candidate word) is ~30x below the card's 32-bit ALU rate.
// At the chemical-similarity shape ([524,288 x 128] & [128]: 268 MB,
// 0.08 ms) the bound is still bytes, but the work is many tiny rows; at a
// serial launch ([8 or 11, 32768] & [32768], S = 1: 1.2-1.6 MB, under
// 0.5 us) it is a few long rows, and a launch's own cost dominates.
//
// In both forms the filter is read once for many rows, each row's count is
// a register sum reduced without atomics and stored once, so counts are
// deterministic and exact. A row not 16-byte aligned relative to the
// filter, and every row's unaligned head and ragged tail, take a scalar
// path, so any width and any storage offset work without padding. In the
// stacked form the R row pointers travel by value in a kernel-parameter
// table (MAX_ROWS of them, 2 KiB of the 4 KiB parameter space), so the
// candidates need no stacking copy and no device pointer array; the wrapper
// launches again for more rows. In the strided form (row_stride != 0) row
// r sits at ptr[0] + r * row_stride, so a fragment matrix of any row count
// is one launch. The launch function picks one decomposition per regime
// from (rows, slices, width) alone:
//   1. narrow (W <= NARROW_MAX_WORDS, at least NARROW_MIN_ROWS (row,
//      slice) counts for each vector a lane loads per row): a group of G lanes, G the power of two <= 32 that
//      covers a row's 16-byte vectors, takes an item of (slice, up to
//      NARROW_CHUNK rows, fewer where that leaves warps of the card
//      idle). It loads the slice's filter
//      vectors ONCE into registers (FV <= 4 a lane) and walks the item's
//      rows a few at a time (NARROW_ROWS), each lane keeping those rows'
//      loads in flight, with a __shfl_xor_sync reduction inside the group:
//      no shared memory, no __syncthreads. Warps walk the items with a grid
//      stride. (A 256-thread block per (slice, 8 rows) left 224 threads
//      idle at 128 words and reloaded the filter every 8 rows: 65,536
//      blocks of 4 KB at the chemical-similarity shape.)
//   2. split (rows over SPLIT_MIN_WORDS, fewer than SPLIT_ITEMS (slice,
//      8-row) items): a
//      cluster of SPLIT blocks serves an item, each block a SPLIT-th of
//      the width with the full regime's body; each block's 8 row partials
//      go into the leading block's shared memory (distributed shared
//      memory) and after cluster.sync() the leader adds them in rank order
//      and stores the item's rows. One launch, no scratch, no second pass.
//      (The fragment form at R = 8 or 11 over 32,768 words was one or two
//      blocks on a card of 132 SMs.)
//   3. full (every other shape): one block per (slice, chunk of up
//      to RB candidate rows). Each thread loads a 16-byte vector of the
//      filter ONCE, ANDs it with the same vector of each of the chunk's
//      rows and keeps RB register accumulators, so the filter is read once
//      per chunk instead of once per candidate. Then a warp-shuffle
//      reduction per row, a shared-memory reduction across the block's
//      warps and one plain store per (r, s). Blocks walk a 1-D space of
//      (slice, chunk) pairs, a slice's chunks adjacent so that they meet
//      its filter in L2, and the grid strides over it: no grid dimension
//      limits R or S. This body, tuned for full-width rows at 96% of the
//      bound, is unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <stdint.h>

namespace cg = cooperative_groups;

// Regime codes reported to the caller (ops/kernels.py REGIMES).
enum { REGIME_FULL = 0, REGIME_NARROW = 1, REGIME_SPLIT = 2 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 8;              // candidate rows per block (full, split)
constexpr int MAX_ROWS = 256;      // row pointers per launch
constexpr long long MAX_GRID = 1 << 20;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The thresholds below were set from pilosa_tpu_torch/tools/kernel_ab.py,
// which times builds forced into each regime at the same shapes on one
// card (PERF.md §6, H100 SXM at 700 W).
//
// Rows up to this many words take the narrow regime: a 32-lane group then
// holds at most 4 filter vectors a lane in registers.
constexpr long long NARROW_MAX_WORDS = 512;
// ... given this many (row, slice) counts at least for each vector a lane
// loads per row (ceil(width / 128)). With fewer, blocks of (slice, 8 rows)
// fit in a few waves, each row one load a thread, and they beat lane
// groups that load a row's vectors one after another: in the fragment
// form the full body was 1.2x faster at [1024, 128] and 1.1x at [9537,
// 512] (4.3x at [11, 512] with 32-row items), narrow 1.1x faster at
// [4096, 128], 1.2x at [9537, 256] and [65536, 512].
constexpr long long NARROW_MIN_ROWS = 4096;
// Rows a narrow group walks a step, each lane keeping their loads in
// flight: NARROW_ROWS while a lane holds one filter vector, half as many
// (each then FV loads) with more.
constexpr int NARROW_ROWS = 4;
// Rows a narrow group walks with one load of its filter: enough items to
// fill the card at the chemical-similarity shape (16,384 of them), the
// filter re-read from L2 once per 32 rows. With fewer rows an item takes
// fewer, so that the items still cover CARD_WARPS warps: 32-row items of
// a [9537, 256] fragment matrix left all but 38 blocks of the card idle
// (3x slower than the full body).
constexpr int NARROW_CHUNK = 32;
// The warps an H100 SXM holds at once: 132 SMs of 64.
constexpr long long CARD_WARPS = 132 * 64;
// Blocks of a split item: the portable cluster size.
constexpr int SPLIT = 8;
// With fewer (slice, 8-row) items than this, under one per SM, the full
// regime leaves SMs idle while each block loops over its rows' width, so
// rows over SPLIT_MIN_WORDS split: split was 1.2x faster at 63 and 64
// items of 32,768 words, even at 96 and 5% slower at 127, and 1.2-4.5x
// faster from 2,052 words at 8 rows, even at 2,048, 1.2x slower at 1,024.
constexpr long long SPLIT_ITEMS = 96;
constexpr long long SPLIT_MIN_WORDS = 2048;

struct RowTable {
  const uint32_t* ptr[MAX_ROWS];
};

__device__ __forceinline__ int popc_and4(const uint4& a, const uint4& f) {
  return __popc(a.x & f.x) + __popc(a.y & f.y) + __popc(a.z & f.z) +
         __popc(a.w & f.w);
}

// Row r's slice s.
__device__ __forceinline__ const uint32_t* row_at(const RowTable& rows,
                                                  long long row_stride,
                                                  long long r, long long s,
                                                  long long width) {
  return (row_stride ? rows.ptr[0] + r * row_stride : rows.ptr[r]) +
         s * width;
}

// The full and split regimes' body: the block counts popcount(rs[k][i] &
// fs[i]) over i < width for the chunk's nr (<= RB) rows and returns row
// threadIdx.x's total to threads below nr. Ends with warp_sums read: a
// caller that reuses it passes a __syncthreads first.
__device__ __forceinline__ int and_rows_block(const uint32_t* const* rs,
                                              int nr,
                                              const uint32_t* fs,
                                              long long width,
                                              int (*warp_sums)[RB]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bool aligned = true;
#pragma unroll
  for (int k = 0; k < RB; ++k)
    aligned &= ((reinterpret_cast<uintptr_t>(rs[k]) ^
                 reinterpret_cast<uintptr_t>(fs)) & 15) == 0;
  int acc[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) acc[k] = 0;

  long long head =
      (long long)(((16 - (reinterpret_cast<uintptr_t>(fs) & 15)) & 15) / 4);
  if (!aligned || head > width) head = width;
  for (long long i = threadIdx.x; i < head; i += THREADS) {
    const uint32_t f = fs[i];
#pragma unroll
    for (int k = 0; k < RB; ++k)
      if (k < nr) acc[k] += __popc(rs[k][i] & f);
  }

  const long long nvec = (width - head) / 4;
  const uint4* __restrict__ fv = reinterpret_cast<const uint4*>(fs + head);
  for (long long v = threadIdx.x; v < nvec; v += THREADS) {
    const uint4 f = fv[v];
    uint4 x[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k)
      if (k < nr) x[k] = reinterpret_cast<const uint4*>(rs[k] + head)[v];
#pragma unroll
    for (int k = 0; k < RB; ++k)
      if (k < nr) acc[k] += popc_and4(x[k], f);
  }

  for (long long t = head + nvec * 4 + threadIdx.x; t < width;
       t += THREADS) {
    const uint32_t f = fs[t];
#pragma unroll
    for (int k = 0; k < RB; ++k)
      if (k < nr) acc[k] += __popc(rs[k][t] & f);
  }

#pragma unroll
  for (int k = 0; k < RB; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(FULL_MASK, acc[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < RB; ++k) warp_sums[warp][k] = acc[k];
  }
  __syncthreads();
  int total = 0;
  if (threadIdx.x < nr) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_sums[w][threadIdx.x];
  }
  return total;
}

// The chunk's row pointers at slice s, offset by `lo` words; rows past nr
// point at the filter (never read, and aligned with it).
__device__ __forceinline__ void chunk_rows(const RowTable& rows,
                                           long long row_stride,
                                           long long r0, int nr,
                                           const uint32_t* fs, long long s,
                                           long long width, long long lo,
                                           const uint32_t** rs) {
#pragma unroll
  for (int k = 0; k < RB; ++k)
    rs[k] = k < nr ? row_at(rows, row_stride, r0 + k, s, width) + lo : fs;
}

// Regime 3, full: one block per (slice, chunk of RB rows), grid-strided.
__global__ void __launch_bounds__(THREADS)
count_and_rows_kernel(const __grid_constant__ RowTable rows,
                      long long row_stride, long long nrows,
                      const uint32_t* __restrict__ filt, long long slices,
                      long long width, int32_t* __restrict__ out,
                      long long out_stride) {
  __shared__ int warp_sums[WARPS][RB];
  const long long chunks = (nrows + RB - 1) / RB;

  for (long long b = blockIdx.x; b < slices * chunks; b += gridDim.x) {
    const long long s = b / chunks;
    const long long r0 = (b % chunks) * RB;
    const int nr = (int)min((long long)RB, nrows - r0);
    const uint32_t* fs = filt + s * width;
    const uint32_t* rs[RB];
    chunk_rows(rows, row_stride, r0, nr, fs, s, width, 0, rs);
    const int total = and_rows_block(rs, nr, fs, width, warp_sums);
    if (threadIdx.x < nr)
      out[(long long)(r0 + threadIdx.x) * out_stride + s] = total;
    __syncthreads();  // warp_sums is reused by the next (slice, chunk)
  }
}

// Regime 2, split: a cluster of SPLIT blocks per (slice, chunk of RB rows)
// (gridDim.x = items * SPLIT), block rank c counting words [c * part,
// (c + 1) * part) with part a multiple of 4 words, so each part keeps the
// rows' alignment relative to the filter.
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS)
count_and_rows_split_kernel(const __grid_constant__ RowTable rows,
                            long long row_stride, long long nrows,
                            const uint32_t* __restrict__ filt,
                            long long width, int32_t* __restrict__ out,
                            long long out_stride) {
  __shared__ int warp_sums[WARPS][RB];
  __shared__ int parts[SPLIT][RB];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long chunks = (nrows + RB - 1) / RB;
  const long long b = blockIdx.x / SPLIT;
  const long long s = b / chunks;
  const long long r0 = (b % chunks) * RB;
  const int nr = (int)min((long long)RB, nrows - r0);
  const long long part = ((width + SPLIT - 1) / SPLIT + 3) & ~3LL;
  const long long lo = min(width, rank * part);
  const long long hi = min(width, lo + part);
  const uint32_t* fs = filt + s * width;
  const uint32_t* rs[RB];
  chunk_rows(rows, row_stride, r0, nr, fs + lo, s, width, lo, rs);
  const int total = and_rows_block(rs, nr, fs + lo, hi - lo, warp_sums);
  if (threadIdx.x < nr) cluster.map_shared_rank(&parts[0][0], 0)
                            [rank * RB + threadIdx.x] = total;
  cluster.sync();
  if (rank == 0 && threadIdx.x < nr) {
    int sum = 0;
#pragma unroll
    for (int c = 0; c < SPLIT; ++c) sum += parts[c][threadIdx.x];
    out[(long long)(r0 + threadIdx.x) * out_stride + s] = sum;
  }
}

// Regime 1, narrow: `group` lanes an item of (slice, `chunk` rows), the
// filter's FV vectors a lane held in registers for the item's rows, U
// rows a step. A warp's groups take items base .. base + 32 / group - 1;
// the loops over items and over an item's rows are uniform across the
// warp, so every shuffle has all 32 lanes.
template <int FV>
__global__ void __launch_bounds__(THREADS)
count_and_rows_narrow_kernel(const __grid_constant__ RowTable rows,
                             long long row_stride, long long nrows,
                             const uint32_t* __restrict__ filt,
                             long long slices, int width, int group,
                             int chunk, int32_t* __restrict__ out,
                             long long out_stride) {
  constexpr int U = FV == 1 ? NARROW_ROWS : NARROW_ROWS / 2;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (group - 1);
  const int rpw = 32 / group;
  const long long chunks = (nrows + chunk - 1) / chunk;
  const long long items = slices * chunks;
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * WARPS * rpw;
  for (long long base = warp * rpw; base < items; base += step) {
    const long long item = base + lane / group;
    const bool live = item < items;
    const long long s = live ? item / chunks : 0;
    const long long r0 = live ? (item % chunks) * chunk : nrows;
    const uint32_t* fs = filt + s * width;
    const uintptr_t fp = reinterpret_cast<uintptr_t>(fs);
    int fhead = (int)(((16 - (fp & 15)) & 15) / 4);
    if (fhead > width) fhead = width;
    const int fnvec = (width - fhead) / 4;
    uint4 f[FV];
#pragma unroll
    for (int j = 0; j < FV; ++j) {
      const int v = gl + j * group;
      f[j] = (live && v < fnvec)
                 ? reinterpret_cast<const uint4*>(fs + fhead)[v]
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int k = 0; k < chunk; k += U) {
      const uint32_t* rp[U];
      bool ok[U], vec[U];
      int acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long r = r0 + k + u;
        ok[u] = k + u < chunk && r < nrows;
        rp[u] = ok[u] ? row_at(rows, row_stride, r, s, width) : fs;
        vec[u] = ok[u] && ((reinterpret_cast<uintptr_t>(rp[u]) ^ fp) & 15) == 0;
        acc[u] = 0;
      }
#pragma unroll
      for (int j = 0; j < FV; ++j) {
        const int v = gl + j * group;
        if (v < fnvec) {
          uint4 x[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            x[u] = vec[u] ? reinterpret_cast<const uint4*>(rp[u] + fhead)[v]
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int u = 0; u < U; ++u) acc[u] += popc_and4(x[u], f[j]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (vec[u]) {  // the filter's unaligned head and ragged tail
          for (int i = gl; i < fhead; i += group)
            acc[u] += __popc(rp[u][i] & fs[i]);
          for (int t = fhead + fnvec * 4 + gl; t < width; t += group)
            acc[u] += __popc(rp[u][t] & fs[t]);
        } else if (ok[u]) {  // misaligned against the filter: every word
          for (int t = gl; t < width; t += group)
            acc[u] += __popc(rp[u][t] & fs[t]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        for (int off = group >> 1; off > 0; off >>= 1)
          acc[u] += __shfl_xor_sync(FULL_MASK, acc[u], off);
        if (gl == 0 && ok[u]) out[(r0 + k + u) * out_stride + s] = acc[u];
      }
    }
  }
}

// ---------------------------------------------------------------------
// count_and_rows_multi, the filter-table form: out[k, r, s] =
// popcount(rows_r[s, :] & filt_k[s, :]) for R shared row stacks and K
// filter stacks of [S, W] words each.
//
// Replaces, in pilosa_tpu, _co_sum_fn (executor.py:3520): the fused
// Sum group's XLA fusion that ANDs the field's plane stack with each of K
// members' filters (exists & filter tree) and popcounts per (member,
// plane, slice).
//
// Bound: device memory. Every row word and every filter word is read
// once, one int32 per (k, r, s) written: (R + K) * S * W * 4 bytes. At the
// BSI phase's field (R = depth 10 + the not-null row) with K = 8 members
// over [9537, 32768] that is 19 * 1.25 GB = 23.7 GB, 7.1 ms at 3.35 TB/s;
// K launches of the one-filter form would read K * (R + 1) stacks. The
// R * K popcounts per word are close behind: at 16 per SM and clock they
// alone take 6.6 ms at that shape, so the kernel nears its bound only
// where loads and popcounts overlap almost fully.
//
// Design: one block per (slice, chunk of MRB rows x chunk of MKB
// filters); each thread loads the chunk's MRB + MKB 16-byte vectors once
// and keeps an MRB x MKB register tile of counts, so a word loaded once
// serves MKB (or MRB) products. A slice's chunks are adjacent in the 1-D
// block space, so its (R + K) * W words meet in L2 and leave device
// memory about once. Rows and filters share one kernel-parameter table
// (rows first); the wrapper chunks past MAX_ROWS entries. Unaligned
// operands take the scalar path, as above.
constexpr int MRB = 4;  // row stacks per block
constexpr int MKB = 4;  // filter stacks per block

__global__ void __launch_bounds__(THREADS)
count_and_rows_multi_kernel(const __grid_constant__ RowTable table,
                            int nrows, int nfilt, long long slices,
                            long long width, int32_t* __restrict__ out,
                            long long out_k_stride,
                            long long out_r_stride) {
  __shared__ int warp_sums[WARPS][MRB * MKB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rchunks = (nrows + MRB - 1) / MRB;
  const int kchunks = (nfilt + MKB - 1) / MKB;
  const long long chunks = (long long)rchunks * kchunks;

  for (long long b = blockIdx.x; b < slices * chunks; b += gridDim.x) {
    const long long s = b / chunks;
    const int c = (int)(b % chunks);
    const int r0 = (c / kchunks) * MRB;
    const int k0 = (c % kchunks) * MKB;
    const int nr = min(MRB, nrows - r0);
    const int nk = min(MKB, nfilt - k0);
    const uint32_t* fs[MKB];
    const uint32_t* rs[MRB];
    const uint32_t* f0 = table.ptr[nrows + k0] + s * width;
#pragma unroll
    for (int j = 0; j < MKB; ++j)
      fs[j] = j < nk ? table.ptr[nrows + k0 + j] + s * width : f0;
#pragma unroll
    for (int i = 0; i < MRB; ++i)
      rs[i] = i < nr ? table.ptr[r0 + i] + s * width : f0;
    bool aligned = true;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(f0) & 15;
#pragma unroll
    for (int j = 0; j < MKB; ++j)
      aligned &= (reinterpret_cast<uintptr_t>(fs[j]) & 15) == a0;
#pragma unroll
    for (int i = 0; i < MRB; ++i)
      aligned &= (reinterpret_cast<uintptr_t>(rs[i]) & 15) == a0;
    int acc[MRB][MKB];
#pragma unroll
    for (int i = 0; i < MRB; ++i)
#pragma unroll
      for (int j = 0; j < MKB; ++j) acc[i][j] = 0;

    long long head = (long long)(((16 - a0) & 15) / 4);
    if (!aligned || head > width) head = width;
    for (long long t = threadIdx.x; t < head; t += THREADS) {
      uint32_t f[MKB];
#pragma unroll
      for (int j = 0; j < MKB; ++j) f[j] = j < nk ? fs[j][t] : 0u;
#pragma unroll
      for (int i = 0; i < MRB; ++i) {
        const uint32_t r = i < nr ? rs[i][t] : 0u;
#pragma unroll
        for (int j = 0; j < MKB; ++j) acc[i][j] += __popc(r & f[j]);
      }
    }

    const long long nvec = (width - head) / 4;
    for (long long v = threadIdx.x; v < nvec; v += THREADS) {
      uint4 f[MKB], x[MRB];
#pragma unroll
      for (int j = 0; j < MKB; ++j)
        f[j] = j < nk ? reinterpret_cast<const uint4*>(fs[j] + head)[v]
                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < MRB; ++i)
        x[i] = i < nr ? reinterpret_cast<const uint4*>(rs[i] + head)[v]
                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < MRB; ++i)
#pragma unroll
        for (int j = 0; j < MKB; ++j) acc[i][j] += popc_and4(x[i], f[j]);
    }

    for (long long t = head + nvec * 4 + threadIdx.x; t < width;
         t += THREADS) {
      uint32_t f[MKB];
#pragma unroll
      for (int j = 0; j < MKB; ++j) f[j] = j < nk ? fs[j][t] : 0u;
#pragma unroll
      for (int i = 0; i < MRB; ++i) {
        const uint32_t r = i < nr ? rs[i][t] : 0u;
#pragma unroll
        for (int j = 0; j < MKB; ++j) acc[i][j] += __popc(r & f[j]);
      }
    }

#pragma unroll
    for (int i = 0; i < MRB; ++i)
#pragma unroll
      for (int j = 0; j < MKB; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[i][j] += __shfl_down_sync(0xffffffffu, acc[i][j], off);
      }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < MRB; ++i)
#pragma unroll
        for (int j = 0; j < MKB; ++j) warp_sums[warp][i * MKB + j] = acc[i][j];
    }
    __syncthreads();
    if (threadIdx.x < MRB * MKB) {
      const int i = threadIdx.x / MKB;
      const int j = threadIdx.x % MKB;
      if (i < nr && j < nk) {
        int total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) total += warp_sums[w][threadIdx.x];
        out[(long long)(k0 + j) * out_k_stride +
            (long long)(r0 + i) * out_r_stride + s] = total;
      }
    }
    __syncthreads();  // warp_sums is reused by the next block index
  }
}

// Message for a CUDA error code, for the wrapper's exception text.
extern "C" const char* pilosa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The regime of count_and_rows over nrows rows of [slices, width].
static int and_rows_regime(long long nrows, long long slices,
                           long long width) {
  if (width <= NARROW_MAX_WORDS)
    return nrows * slices >= NARROW_MIN_ROWS * ((width + 127) / 128)
               ? REGIME_NARROW
               : REGIME_FULL;
  return width > SPLIT_MIN_WORDS &&
                 slices * ((nrows + RB - 1) / RB) < SPLIT_ITEMS
             ? REGIME_SPLIT
             : REGIME_FULL;
}

// The thresholds above, for callers that build shapes at their edges
// (tests, chip_smoke.py): out[0..5] = NARROW_MAX_WORDS, SPLIT_ITEMS, RB,
// NARROW_CHUNK, NARROW_MIN_ROWS, SPLIT_MIN_WORDS.
extern "C" void pilosa_count_and_rows_thresholds(long long* out) {
  out[0] = NARROW_MAX_WORDS;
  out[1] = SPLIT_ITEMS;
  out[2] = RB;
  out[3] = NARROW_CHUNK;
  out[4] = NARROW_MIN_ROWS;
  out[5] = SPLIT_MIN_WORDS;
}

// The regime (REGIME_*) of one launch over nrows (<= MAX_ROWS in the
// stacked form) rows of [slices, width].
extern "C" int pilosa_count_and_rows_regime(long long nrows, long long slices,
                                            long long width) {
  return and_rows_regime(nrows, slices, width);
}

static int launch(const RowTable& table, long long row_stride,
                  long long nrows, const void* filt, long long slices,
                  long long width, void* out, long long out_stride,
                  void* stream, int* regime) {
  const int r = and_rows_regime(nrows, slices, width);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* f = static_cast<const uint32_t*>(filt);
  int32_t* o = static_cast<int32_t*>(out);
  const long long items = slices * ((nrows + RB - 1) / RB);
  if (r == REGIME_NARROW) {
    int group = 1;
    while (group < 32 && group * 4 < width) group <<= 1;
    const long long vecs = (width + 3) / 4;
    int fv = 1;
    while ((long long)fv * group < vecs) fv <<= 1;
    // Rows an item: NARROW_CHUNK, fewer where the items would not cover
    // the card's warps.
    const long long fill = nrows * slices / (CARD_WARPS * (32 / group));
    const int chunk = (int)std::max(
        1LL, std::min(fill, std::min(nrows, (long long)NARROW_CHUNK)));
    const long long n = slices * ((nrows + chunk - 1) / chunk);
    const long long per_block = (long long)WARPS * (32 / group);
    long long blocks = (n + per_block - 1) / per_block;
    const unsigned grid = (unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID);
    const int w = (int)width;
    switch (fv) {
      case 1:
        count_and_rows_narrow_kernel<1><<<grid, THREADS, 0, st>>>(
            table, row_stride, nrows, f, slices, w, group, chunk, o,
            out_stride);
        break;
      case 2:
        count_and_rows_narrow_kernel<2><<<grid, THREADS, 0, st>>>(
            table, row_stride, nrows, f, slices, w, group, chunk, o,
            out_stride);
        break;
      default:  // fv == 4: NARROW_MAX_WORDS / 4 vectors over 32 lanes
        count_and_rows_narrow_kernel<4><<<grid, THREADS, 0, st>>>(
            table, row_stride, nrows, f, slices, w, group, chunk, o,
            out_stride);
    }
  } else if (r == REGIME_SPLIT) {
    count_and_rows_split_kernel<<<(unsigned)(items * SPLIT), THREADS, 0,
                                  st>>>(table, row_stride, nrows, f, width,
                                        o, out_stride);
  } else {
    count_and_rows_kernel<<<(unsigned)(items < MAX_GRID ? items : MAX_GRID),
                            THREADS, 0, st>>>(
        table, row_stride, nrows, f, slices, width, o, out_stride);
  }
  if (regime) *regime = r;
  return (int)cudaGetLastError();
}

// C interface, bound with ctypes. `row_ptrs` is a HOST array of `nrows`
// (1..MAX_ROWS) device addresses, row r's slice s starting at
// row_ptrs[r] + s * width words; `filt` and `out` are device pointers, out
// holding row r's slice s at out[r * out_stride + s]; `stream` is a
// cudaStream_t; `regime`, a host int, receives the decomposition taken
// (REGIME_*). Returns the launch's cudaGetLastError() (0 = cudaSuccess);
// the kernel itself runs asynchronously on `stream`.
extern "C" int pilosa_count_and_rows(const unsigned long long* row_ptrs,
                                     int nrows, const void* filt,
                                     long long slices, long long width,
                                     void* out, long long out_stride,
                                     void* stream, int* regime) {
  if (nrows <= 0 || slices <= 0) return (int)cudaSuccess;
  if (nrows > MAX_ROWS || width < 0 || width >= (1LL << 26))
    return (int)cudaErrorInvalidValue;
  RowTable table;
  for (int r = 0; r < MAX_ROWS; ++r)
    table.ptr[r] = r < nrows
                       ? reinterpret_cast<const uint32_t*>(row_ptrs[r])
                       : nullptr;
  return launch(table, 0, nrows, filt, slices, width, out, out_stride,
                stream, regime);
}

// The strided form: row r's slice s starts at base + r * row_stride +
// s * width words (row_stride > 0), for any `nrows`; otherwise as above.
extern "C" int pilosa_count_and_rows_strided(const void* base,
                                             long long row_stride,
                                             long long nrows,
                                             const void* filt,
                                             long long slices,
                                             long long width, void* out,
                                             long long out_stride,
                                             void* stream, int* regime) {
  if (nrows <= 0 || slices <= 0) return (int)cudaSuccess;
  if (row_stride <= 0 || width < 0 || width >= (1LL << 26))
    return (int)cudaErrorInvalidValue;
  RowTable table = {};
  table.ptr[0] = static_cast<const uint32_t*>(base);
  return launch(table, row_stride, nrows, filt, slices, width, out,
                out_stride, stream, regime);
}

// The filter-table form. `ptrs` is a HOST array of nrows + nfilt device
// addresses (nrows row stacks, then nfilt filter stacks; 1..MAX_ROWS in
// all), each [slices, width] words; out holds (row r, filter k, slice s)
// at out[k * out_k_stride + r * out_r_stride + s].
extern "C" int pilosa_count_and_rows_multi(const unsigned long long* ptrs,
                                           int nrows, int nfilt,
                                           long long slices,
                                           long long width, void* out,
                                           long long out_k_stride,
                                           long long out_r_stride,
                                           void* stream) {
  if (nrows <= 0 || nfilt <= 0 || slices <= 0) return (int)cudaSuccess;
  if (nrows + nfilt > MAX_ROWS || width < 0)
    return (int)cudaErrorInvalidValue;
  RowTable table;
  for (int r = 0; r < MAX_ROWS; ++r)
    table.ptr[r] = r < nrows + nfilt
                       ? reinterpret_cast<const uint32_t*>(ptrs[r])
                       : nullptr;
  const long long blocks = slices * ((nrows + MRB - 1) / MRB) *
                           ((nfilt + MKB - 1) / MKB);
  count_and_rows_multi_kernel<<<
      (unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID), THREADS, 0,
      reinterpret_cast<cudaStream_t>(stream)>>>(
      table, nrows, nfilt, slices, width, static_cast<int32_t*>(out),
      out_k_stride, out_r_stride);
  return (int)cudaGetLastError();
}
