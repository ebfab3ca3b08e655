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
// per word) is ~50x below the card's ALU rate.
//
// Design for that bound: one block per row (grid-stride when rows exceed
// the grid), 16-byte vector loads with four loads per operand in flight
// per thread, __popc on each word, a warp-shuffle reduction, then a
// shared-memory reduction across the block's warps and one plain store
// per row. No atomics: counts are deterministic and bit-exact. Each row's
// ragged edge (words before 16-byte alignment, the tail after the last
// full vector, or a whole row whose two operands are misaligned
// relative to each other) is counted by a scalar loop, so any width and
// any storage offset work without padding.
#include <cuda_runtime.h>
#include <stdint.h>

enum { OP_NONE = 0, OP_AND = 1, OP_OR = 2, OP_XOR = 3, OP_ANDNOT = 4 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr long long MAX_GRID = 1 << 20;

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

template <int OP>
__global__ void __launch_bounds__(THREADS)
count_op_rows_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, long long rows,
                     long long width, int32_t* __restrict__ out) {
  __shared__ int warp_sums[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint32_t* ra = a + row * width;
    const uint32_t* rb = (OP == OP_NONE) ? ra : b + row * width;
    int sum = row_partial<OP>(ra, rb, width);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) warp_sums[warp] = sum;
    __syncthreads();
    if (warp == 0) {
      sum = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_down_sync(0xffffffffu, sum, off);
      if (lane == 0) out[row] = sum;
    }
    __syncthreads();  // warp_sums is reused by the next row
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
// Design: count_op_rows's row body over a 1-D space of K * S rows (pair
// k's slice s is row k * S + s), one block per row and a grid stride.
// The K pairs of device addresses travel by value in a kernel-parameter
// table (as count_and_rows.cu's RowTable), so neither a stacking copy nor
// a device pointer array is needed; the wrapper launches again past
// MAX_PAIRS pairs. 256 pairs take 4 KiB of parameters, which CUDA 12.1
// and later allow on sm_70 and newer; an older toolkit builds a table of
// 128.
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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rows = (long long)npairs * slices;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int k = (int)(row / slices);
    const long long s = row - (long long)k * slices;
    const uint32_t* ra = table.a[k] + s * width;
    const uint32_t* rb = (OP == OP_NONE) ? ra : table.b[k] + s * width;
    int sum = row_partial<OP>(ra, rb, width);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) warp_sums[warp] = sum;
    __syncthreads();
    if (warp == 0) {
      sum = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_down_sync(0xffffffffu, sum, off);
      if (lane == 0) out[row] = sum;
    }
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

// C interface, bound with ctypes. `a`, `b` and `out` are device pointers
// (b is ignored for OP_NONE); `stream` is a cudaStream_t. Returns the
// launch's cudaGetLastError() (0 = cudaSuccess); the kernel itself runs
// asynchronously on `stream`.
extern "C" int pilosa_count_op_rows(const void* a, const void* b,
                                    long long rows, long long width, int op,
                                    void* out, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (width < 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(rows < MAX_GRID ? rows : MAX_GRID);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  switch (op) {
    case OP_NONE:
      count_op_rows_kernel<OP_NONE><<<grid, THREADS, 0, s>>>(pa, pa, rows,
                                                            width, po);
      break;
    case OP_AND:
      count_op_rows_kernel<OP_AND><<<grid, THREADS, 0, s>>>(pa, pb, rows,
                                                           width, po);
      break;
    case OP_OR:
      count_op_rows_kernel<OP_OR><<<grid, THREADS, 0, s>>>(pa, pb, rows,
                                                          width, po);
      break;
    case OP_XOR:
      count_op_rows_kernel<OP_XOR><<<grid, THREADS, 0, s>>>(pa, pb, rows,
                                                           width, po);
      break;
    case OP_ANDNOT:
      count_op_rows_kernel<OP_ANDNOT><<<grid, THREADS, 0, s>>>(pa, pb, rows,
                                                              width, po);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
