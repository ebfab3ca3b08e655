// Per-row popcount of (a OP b) over [rows, width] stacks of 32-bit words.
//
// Replaces the Pallas kernels in pilosa_tpu/ops/pallas_kernels.py:
//   - count_and (:126, pallas_call at :135) — popcount(a & b) summed,
//     never materialising a & b; here OP is a template parameter, so the
//     same body serves and / or / xor / andnot and returns the per-row
//     counts (the scalar is a host int64 sum of them);
//   - count_rows (:195, through count_and_rows' pallas_call at :179 with
//     an all-ones filter) — the OP_NONE instance, which reads only `a`
//     and skips the filter read the Pallas version pays.
// It also replaces the XLA fusions that serve the same functions on the
// TPU main path: bitops._count_and_impl / _count_or_impl / ... (ops/
// bitops.py:281-315), _count_rows_impl (:267-278), and the per-slice
// population_count sum of the batched tree program (executor.py
// _batched_fn :4911-4930) — the batched path fuses the tree's root op
// into this kernel.
//
// Bound: device memory. Each input word is read once and nothing but one
// int32 per row is written. At the main-path shape [9537, 32768] a
// two-operand count reads 2.50 GB (0.75 ms at 3.35 TB/s) and count_rows
// 1.25 GB (0.37 ms). The integer work (one logic op, one popc, one add
// per word) is ~50x below the card's ALU rate. At a narrow column window
// ([9537, 128]: 9.8 MB, 2.9 us) or a serial one-row launch ([1, 32768]:
// 256 KB, 0.08 us) the bound is below a launch's own cost, and what
// counts is that the work spreads over the 132 SMs in one round of loads.
//
// Design: one decomposition per regime, chosen by the launch function
// from (rows, width) alone. Every regime uses 16-byte vector loads, __popc
// on each word and plain stores of int32 counts: no atomics, so counts are
// deterministic and bit-exact. Each row's ragged edge (words before
// 16-byte alignment, the tail after the last full vector, or a whole row
// whose two operands are misaligned relative to each other) is counted by
// a scalar loop, so any width and any storage offset work without padding.
//   1. narrow (width <= NARROW_MAX_WORDS, at least NARROW_MIN_ROWS rows
//      for each vector a lane loads per row):
//      a group of G lanes serves one row, G the power of two <= 32 that
//      covers the row's 16-byte vectors, so a warp holds 32 / G rows and
//      a block many. Each lane keeps
//      NARROW_ROWS rows' loads in flight, the warps walk the rows with a
//      grid stride, and a row's sum is reduced by __shfl_xor_sync inside
//      its group: no shared memory, no __syncthreads. (One 256-thread
//      block per 128-word row left 224 of its threads idle and paid two
//      barriers and a shared-memory reduction per row.)
//   2. split (rows over SPLIT_MIN_WORDS, fewer than SPLIT_ROWS of them): a
//      cluster of SPLIT blocks serves one row, each a SPLIT-th of its width.
//      Each block reduces its partial as the full regime does and writes
//      it into the leading block's shared memory (distributed shared
//      memory); after cluster.sync() the leader adds the SPLIT partials
//      in rank order and stores the row. One launch, no scratch buffer,
//      no second pass. (One block per row put a serial path's one-row
//      launch on one SM of 132, looping 16 times over a 256 KB read.)
//   3. full (every other shape): one block per row (grid-stride when rows
//      exceed the grid), four loads per operand in flight per thread, a
//      warp-shuffle then a shared-memory reduction, one store per row. This
//      is the body tuned for 32,768-word rows at 95% of the bound,
//      unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

enum { OP_NONE = 0, OP_AND = 1, OP_OR = 2, OP_XOR = 3, OP_ANDNOT = 4 };
// Regime codes reported to the caller (ops/kernels.py REGIMES).
enum { REGIME_FULL = 0, REGIME_NARROW = 1, REGIME_SPLIT = 2 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr long long MAX_GRID = 1 << 20;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The thresholds below were set from pilosa_tpu_torch/tools/kernel_ab.py,
// which times builds forced into each regime at the same shapes on one
// card (PERF.md §6, H100 SXM at 700 W).
//
// Rows up to this many words take the narrow regime: a 32-lane group then
// loads at most 4 vectors a lane per row. Narrow was 1.3x faster than the
// block-per-row body at [9537, 512 and 516] and even with it at 1,024.
constexpr long long NARROW_MAX_WORDS = 512;
// ... given this many rows at least for each vector a lane loads per row
// (ceil(width / 128)). With fewer, one block a row puts the rows in a few
// waves of 256-thread blocks, each row one load a thread, while a lane
// group loads a row's vectors one after another: the full body was 1.2x
// faster at [256, 128] and 1.5x at [1024, 512], narrow 1.2x faster at
// [1024, 128] and 1.1x at [4096, 512].
constexpr long long NARROW_MIN_ROWS = 1024;
// Rows a narrow group keeps in flight: with 2 x 2 vector loads a lane and
// the warps an SM holds, more than the ~20 KB an SM needs in flight to
// cover the device memory's latency at its share of 3.35 TB/s, while
// fewer rows a warp spread a window's rows over more warps and SMs.
constexpr int NARROW_ROWS = 2;
// Blocks of a split row: the portable cluster size. At 32,768 words each
// block reads 4,096 words an operand, one pass of its 256 threads' four
// vector loads.
constexpr int SPLIT = 8;
// A row splits when it is longer than this and the rows are fewer than
// SPLIT_ROWS. At one row split was even with one block a row up to 8,196
// words (count_rows 9% slower there, 4% at 16,384), count_op_rows 1.5x
// faster at 16,384 and 2.7x at 32,768; at 8 rows 1.3x faster from 8,192
// words for count_op_rows and from 16,384 for count_rows; at 32,768
// words 1.3x faster at 63 rows, even at 96 and 5% slower at 127, where
// the blocks fill the card anyway.
constexpr long long SPLIT_MIN_WORDS = 8192;
constexpr long long SPLIT_ROWS = 64;

template <int OP>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  if (OP == OP_AND) return a & b;
  if (OP == OP_OR) return a | b;
  if (OP == OP_XOR) return a ^ b;
  if (OP == OP_ANDNOT) return a & ~b;
  return a;
}

template <int OP>
__device__ __forceinline__ int popc4(const uint4& a, const uint4& b) {
  return __popc(combine<OP>(a.x, b.x)) + __popc(combine<OP>(a.y, b.y)) +
         __popc(combine<OP>(a.z, b.z)) + __popc(combine<OP>(a.w, b.w));
}

template <int OP>
__device__ int row_partial(const uint32_t* __restrict__ ra,
                           const uint32_t* __restrict__ rb, long long width) {
  int sum = 0;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(ra);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(rb);
  long long head = (long long)(((16 - (pa & 15)) & 15) / 4);
  if (((pa ^ pb) & 15) != 0 || head > width) head = width;
  for (long long i = threadIdx.x; i < head; i += THREADS)
    sum += __popc(combine<OP>(ra[i], rb[i]));

  const long long nvec = (width - head) / 4;
  const uint4* __restrict__ va = reinterpret_cast<const uint4*>(ra + head);
  const uint4* __restrict__ vb = reinterpret_cast<const uint4*>(rb + head);
  long long i = threadIdx.x;
  for (; i + (UNROLL - 1) * THREADS < nvec; i += UNROLL * THREADS) {
    uint4 x[UNROLL], y[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = va[i + u * THREADS];
      y[u] = (OP == OP_NONE) ? x[u] : vb[i + u * THREADS];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) sum += popc4<OP>(x[u], y[u]);
  }
  for (; i < nvec; i += THREADS) {
    const uint4 x = va[i];
    sum += popc4<OP>(x, (OP == OP_NONE) ? x : vb[i]);
  }

  for (long long t = head + nvec * 4 + threadIdx.x; t < width; t += THREADS)
    sum += __popc(combine<OP>(ra[t], rb[t]));
  return sum;
}

// The block's sum of `sum`, in thread 0 (the other threads' values are
// partial). Leaves warp_sums written: a caller that reuses it for another
// row passes a __syncthreads first.
__device__ __forceinline__ int block_sum(int sum, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(FULL_MASK, sum, off);
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    sum = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(FULL_MASK, sum, off);
  }
  return sum;
}

// Regime 3, full: one block per row.
template <int OP>
__global__ void __launch_bounds__(THREADS)
count_op_rows_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, long long rows,
                     long long width, int32_t* __restrict__ out) {
  __shared__ int warp_sums[WARPS];
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint32_t* ra = a + row * width;
    const uint32_t* rb = (OP == OP_NONE) ? ra : b + row * width;
    const int sum = block_sum(row_partial<OP>(ra, rb, width), warp_sums);
    if (threadIdx.x == 0) out[row] = sum;
    __syncthreads();  // warp_sums is reused by the next row
  }
}

// Regime 1, narrow: `group` lanes a row, NARROW_ROWS rows a group at a
// time. A warp's step covers rows base .. base + NARROW_ROWS * (32 /
// group) - 1, row u * (32 / group) + (lane / group) of it to each lane's
// group, so the loop bound and every shuffle are uniform across the warp
// and a warp's loads of one u are contiguous.
template <int OP>
__global__ void __launch_bounds__(THREADS)
count_op_rows_narrow_kernel(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b, long long rows,
                            int width, int group,
                            int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (group - 1);
  const int rpw = 32 / group;
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long per_warp = (long long)rpw * NARROW_ROWS;
  const long long step = (long long)gridDim.x * WARPS * per_warp;
  // Row r of a and of b start r * width words past a and b, so the two
  // keep one relative alignment: if it is off, every row is scalar.
  const bool paired =
      OP == OP_NONE || ((reinterpret_cast<uintptr_t>(a) ^
                         reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  for (long long base = warp * per_warp; base < rows; base += step) {
    long long row[NARROW_ROWS];
    int head[NARROW_ROWS], nvec[NARROW_ROWS], lim[NARROW_ROWS];
    int sum[NARROW_ROWS];
    int vmax = 0;
#pragma unroll
    for (int u = 0; u < NARROW_ROWS; ++u) {
      row[u] = base + u * rpw + lane / group;
      lim[u] = row[u] < rows ? width : 0;
      const uintptr_t p = reinterpret_cast<uintptr_t>(a + row[u] * width);
      int h = paired ? (int)(((16 - (p & 15)) & 15) / 4) : lim[u];
      head[u] = h < lim[u] ? h : lim[u];
      nvec[u] = (lim[u] - head[u]) / 4;
      vmax = nvec[u] > vmax ? nvec[u] : vmax;
      sum[u] = 0;
    }
#pragma unroll
    for (int u = 0; u < NARROW_ROWS; ++u) {
      const uint32_t* ra = a + row[u] * width;
      const uint32_t* rb = (OP == OP_NONE) ? ra : b + row[u] * width;
      for (int i = gl; i < head[u]; i += group)
        sum[u] += __popc(combine<OP>(ra[i], rb[i]));
      for (int t = head[u] + nvec[u] * 4 + gl; t < lim[u]; t += group)
        sum[u] += __popc(combine<OP>(ra[t], rb[t]));
    }
    for (int v = gl; v < vmax; v += group) {
      uint4 x[NARROW_ROWS], y[NARROW_ROWS];
#pragma unroll
      for (int u = 0; u < NARROW_ROWS; ++u) {
        x[u] = y[u] = make_uint4(0u, 0u, 0u, 0u);
        if (v < nvec[u]) {
          const long long at = row[u] * width + head[u];
          x[u] = reinterpret_cast<const uint4*>(a + at)[v];
          y[u] = (OP == OP_NONE) ? x[u]
                                 : reinterpret_cast<const uint4*>(b + at)[v];
        }
      }
#pragma unroll
      for (int u = 0; u < NARROW_ROWS; ++u) sum[u] += popc4<OP>(x[u], y[u]);
    }
#pragma unroll
    for (int u = 0; u < NARROW_ROWS; ++u) {
      for (int off = group >> 1; off > 0; off >>= 1)
        sum[u] += __shfl_xor_sync(FULL_MASK, sum[u], off);
      if (gl == 0 && row[u] < rows) out[row[u]] = sum[u];
    }
  }
}

// Regime 2, split: a cluster of SPLIT blocks a row (gridDim.x = rows *
// SPLIT), block rank c counting words [c * chunk, (c + 1) * chunk) with
// chunk a multiple of 4 words, so each part keeps the row's alignment.
template <int OP>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS)
count_op_rows_split_kernel(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b, long long width,
                           int32_t* __restrict__ out) {
  __shared__ int warp_sums[WARPS];
  __shared__ int parts[SPLIT];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long row = blockIdx.x / SPLIT;
  const long long chunk = ((width + SPLIT - 1) / SPLIT + 3) & ~3LL;
  const long long lo = min(width, rank * chunk);
  const long long hi = min(width, lo + chunk);
  const uint32_t* ra = a + row * width + lo;
  const uint32_t* rb = (OP == OP_NONE) ? ra : b + row * width + lo;
  const int sum = block_sum(row_partial<OP>(ra, rb, hi - lo), warp_sums);
  if (threadIdx.x == 0) cluster.map_shared_rank(parts, 0)[rank] = sum;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int c = 0; c < SPLIT; ++c) total += parts[c];
    out[row] = total;
  }
}

// ---------------------------------------------------------------------
// count_op_pairs: out[k, s] = popcount(a_k[s, :] OP b_k[s, :]) for K pairs
// of [S, W] stacks, each its own allocation.
//
// Replaces, in pilosa_tpu, the XLA fusions of the coalescer's fused
// groups: _co_fused_fn (executor.py:3552), a vmapped tree plus
// population_count over a [K, S, W] query-axis stack, and the occupancy
// sums of the fused Min/Max descent _co_minmax_fn (:3467). The port
// builds no [K, S, W] stack (at K = 8 over two leaves of 9,537 slices
// that copy alone is 20 GB): each member folds its non-root nodes with
// torch ops, and the group's root counts go out in one launch.
//
// Bound: device memory, as count_op_rows: every word of the 2K operands
// is read once, one int32 per (k, s) written. At K = 8 distinct pairs of
// [9537, 32768] that is 20.0 GB, 5.97 ms at 3.35 TB/s.
//
// Design: count_op_rows's full-regime row body over a 1-D space of K * S
// rows (pair k's slice s is row k * S + s), one block per row and a grid
// stride. The K pairs of device addresses travel by value in a
// kernel-parameter table (as count_and_rows.cu's RowTable), so neither a
// stacking copy nor a device pointer array is needed; the wrapper
// launches again past MAX_PAIRS pairs. 256 pairs take 4 KiB of
// parameters, which CUDA 12.1 and later allow on sm_70 and newer; an
// older toolkit builds a table of 128. Its narrow-window shape keeps the
// one launch shape (ROADMAP Queue B).
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
constexpr int MAX_PAIRS = 256;
#else
constexpr int MAX_PAIRS = 128;
#endif

struct PairTable {
  const uint32_t* a[MAX_PAIRS];
  const uint32_t* b[MAX_PAIRS];
};

template <int OP>
__global__ void __launch_bounds__(THREADS)
count_op_pairs_kernel(const __grid_constant__ PairTable table, int npairs,
                      long long slices, long long width,
                      int32_t* __restrict__ out) {
  __shared__ int warp_sums[WARPS];
  const long long rows = (long long)npairs * slices;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int k = (int)(row / slices);
    const long long s = row - (long long)k * slices;
    const uint32_t* ra = table.a[k] + s * width;
    const uint32_t* rb = (OP == OP_NONE) ? ra : table.b[k] + s * width;
    const int sum = block_sum(row_partial<OP>(ra, rb, width), warp_sums);
    if (threadIdx.x == 0) out[row] = sum;
    __syncthreads();  // warp_sums is reused by the next row
  }
}

// The table's capacity, for the wrapper's chunking.
extern "C" int pilosa_count_op_pairs_max() { return MAX_PAIRS; }

// C interface, bound with ctypes. `a_ptrs` and `b_ptrs` are HOST arrays of
// `npairs` (1..MAX_PAIRS) device addresses of [slices, width] stacks
// (b_ptrs is ignored for OP_NONE); `out` is a device int32[npairs, slices];
// `stream` is a cudaStream_t. Returns the launch's cudaGetLastError().
extern "C" int pilosa_count_op_pairs(const unsigned long long* a_ptrs,
                                     const unsigned long long* b_ptrs,
                                     int npairs, long long slices,
                                     long long width, int op, void* out,
                                     void* stream) {
  if (npairs <= 0 || slices <= 0) return (int)cudaSuccess;
  if (npairs > MAX_PAIRS || width < 0) return (int)cudaErrorInvalidValue;
  PairTable table;
  for (int k = 0; k < MAX_PAIRS; ++k) {
    table.a[k] = k < npairs ? reinterpret_cast<const uint32_t*>(a_ptrs[k])
                            : nullptr;
    table.b[k] = (k < npairs && op != OP_NONE)
                     ? reinterpret_cast<const uint32_t*>(b_ptrs[k])
                     : nullptr;
  }
  const long long rows = (long long)npairs * slices;
  const unsigned grid = (unsigned)(rows < MAX_GRID ? rows : MAX_GRID);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int32_t* po = static_cast<int32_t*>(out);
  switch (op) {
    case OP_NONE:
      count_op_pairs_kernel<OP_NONE><<<grid, THREADS, 0, s>>>(
          table, npairs, slices, width, po);
      break;
    case OP_AND:
      count_op_pairs_kernel<OP_AND><<<grid, THREADS, 0, s>>>(
          table, npairs, slices, width, po);
      break;
    case OP_OR:
      count_op_pairs_kernel<OP_OR><<<grid, THREADS, 0, s>>>(
          table, npairs, slices, width, po);
      break;
    case OP_XOR:
      count_op_pairs_kernel<OP_XOR><<<grid, THREADS, 0, s>>>(
          table, npairs, slices, width, po);
      break;
    case OP_ANDNOT:
      count_op_pairs_kernel<OP_ANDNOT><<<grid, THREADS, 0, s>>>(
          table, npairs, slices, width, po);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Message for a CUDA error code, for the wrapper's exception text.
extern "C" const char* pilosa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// An empty kernel: the floor a launch costs, for timing beside the count
// kernels at shapes whose bytes bound is below it.
__global__ void empty_kernel() {}

extern "C" int pilosa_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// The regime pilosa_count_op_rows takes for [rows, width] (rows > 0).
static int op_rows_regime(long long rows, long long width) {
  if (width <= NARROW_MAX_WORDS)
    return rows >= NARROW_MIN_ROWS * ((width + 127) / 128) ? REGIME_NARROW
                                                            : REGIME_FULL;
  return rows < SPLIT_ROWS && width > SPLIT_MIN_WORDS ? REGIME_SPLIT
                                                      : REGIME_FULL;
}

// The thresholds above, for callers that build shapes at their edges
// (tests, chip_smoke.py): out[0..3] = NARROW_MAX_WORDS, SPLIT_MIN_WORDS,
// SPLIT_ROWS, NARROW_MIN_ROWS.
extern "C" void pilosa_count_op_rows_thresholds(long long* out) {
  out[0] = NARROW_MAX_WORDS;
  out[1] = SPLIT_MIN_WORDS;
  out[2] = SPLIT_ROWS;
  out[3] = NARROW_MIN_ROWS;
}

// The regime (REGIME_*) pilosa_count_op_rows takes for [rows, width].
extern "C" int pilosa_count_op_rows_regime(long long rows, long long width) {
  return op_rows_regime(rows, width);
}

template <int OP>
static void launch_op_rows(int regime, const uint32_t* a, const uint32_t* b,
                           long long rows, long long width, int32_t* out,
                           cudaStream_t s) {
  if (regime == REGIME_NARROW) {
    int group = 1;
    while (group < 32 && group * 4 < width) group <<= 1;
    const long long per_block = (long long)WARPS * (32 / group) * NARROW_ROWS;
    const long long blocks = (rows + per_block - 1) / per_block;
    count_op_rows_narrow_kernel<OP>
        <<<(unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID), THREADS, 0, s>>>(
            a, b, rows, (int)width, group, out);
  } else if (regime == REGIME_SPLIT) {
    count_op_rows_split_kernel<OP>
        <<<(unsigned)(rows * SPLIT), THREADS, 0, s>>>(a, b, width, out);
  } else {
    count_op_rows_kernel<OP>
        <<<(unsigned)(rows < MAX_GRID ? rows : MAX_GRID), THREADS, 0, s>>>(
            a, b, rows, width, out);
  }
}

// C interface, bound with ctypes. `a`, `b` and `out` are device pointers
// (b is ignored for OP_NONE); `stream` is a cudaStream_t; `regime`, a
// host int, receives the decomposition taken (REGIME_*). Returns the
// launch's cudaGetLastError() (0 = cudaSuccess); the kernel itself runs
// asynchronously on `stream`.
extern "C" int pilosa_count_op_rows(const void* a, const void* b,
                                    long long rows, long long width, int op,
                                    void* out, void* stream, int* regime) {
  if (rows <= 0) return (int)cudaSuccess;
  if (width < 0 || width >= (1LL << 26)) return (int)cudaErrorInvalidValue;
  const int r = op_rows_regime(rows, width);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  switch (op) {
    case OP_NONE: launch_op_rows<OP_NONE>(r, pa, pa, rows, width, po, s); break;
    case OP_AND: launch_op_rows<OP_AND>(r, pa, pb, rows, width, po, s); break;
    case OP_OR: launch_op_rows<OP_OR>(r, pa, pb, rows, width, po, s); break;
    case OP_XOR: launch_op_rows<OP_XOR>(r, pa, pb, rows, width, po, s); break;
    case OP_ANDNOT:
      launch_op_rows<OP_ANDNOT>(r, pa, pb, rows, width, po, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (regime) *regime = r;
  return (int)cudaGetLastError();
}
