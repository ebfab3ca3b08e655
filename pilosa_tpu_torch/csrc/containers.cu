// Per-member |a ∩ b| of compressed row blocks (roaring array, run and dense
// containers), N members in one launch.
//
// Replaces, in pilosa_tpu, the XLA fusions of the compressed container tier
// (ops/containers.py; not TPU kernels):
//   - the serial count cells count_array_dense, count_array_array,
//     count_array_run and count_run_dense (:395-505), one per slice on the
//     serial compressed path (a serial call here is a launch of one member);
//   - their vmapped lane twins fused_count_array_* / fused_count_run_dense
//     (:603-656), one per format cell of a coalesced group.
// The or / xor / andnot counts stay host identities over |a|, |b| and this
// intersection, as in the reference; run x run stays on the host and dense
// x dense goes to count_op_rows.
//
// Inputs are packed, not padded: each side's payloads of the N members are
// concatenated, with int32 offsets[N + 1] giving member m's items
// [offs[m], offs[m + 1]). (The reference pads every member to a power of
// two with sentinels because XLA needs static shapes.)
//   - array side: sorted int32 bit positions in [0, 32 * width);
//   - run side: int32 starts and ends of sorted disjoint half-open runs;
//   - dense side: member m's row of `width` int32 words, at b_base +
//     m * width, or at the address b_table[m] (a device table of row
//     pointers, so rows need not be stacked).
// Cells: ARRAY_ARRAY (binary search of each a position in b's positions),
// ARRAY_RUN (binary search of the last b run start <= the position),
// ARRAY_DENSE (gather one word, test one bit), RUN_DENSE (popcount of the
// words each a run covers, its edge words masked).
//
// Bound: device memory. Each payload byte is read once, and ARRAY_DENSE
// touches one 32-byte sector of the row per position; out is N int32. At
// the serial shapes (one member of at most 4,096 positions or 2,048 runs:
// at most ~16 KB) the bound is far below a launch's own cost.
//
// Design (simple first): a grid of (N, G) blocks of 256 threads, G blocks
// per member (more when N is small, so a lone serial member spreads over
// several SMs). Array cells: a thread per position, grid-strided over the
// member's positions. RUN_DENSE: a warp per run, its lanes on consecutive
// words (coalesced). Each warp sums its hits with shuffles and adds them to
// out[m] with one atomicAdd; integer adds commute, so the counts are exact
// and deterministic. out is zeroed by the caller.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Cell { ARRAY_ARRAY = 0, ARRAY_RUN = 1, ARRAY_DENSE = 2, RUN_DENSE = 3 };

// First index in [lo, hi) whose value is >= x (hi when none).
__device__ __forceinline__ int lower_bound(const int* v, int lo, int hi,
                                           int x) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (v[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First index in [lo, hi) whose value is > x (hi when none).
__device__ __forceinline__ int upper_bound(const int* v, int lo, int hi,
                                           int x) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (v[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ const unsigned* dense_row(
    const unsigned* b_base, const unsigned long long* b_table,
    long long width, long long m) {
  return b_table != nullptr
             ? reinterpret_cast<const unsigned*>(b_table[m])
             : b_base + m * width;
}

template <int CELL>
__global__ void __launch_bounds__(THREADS)
container_and_counts_kernel(const int* __restrict__ a_vals,
                            const int* __restrict__ a_ends,
                            const int* __restrict__ a_offs,
                            const int* __restrict__ b_vals,
                            const int* __restrict__ b_ends,
                            const int* __restrict__ b_offs,
                            const unsigned* __restrict__ b_base,
                            const unsigned long long* __restrict__ b_table,
                            long long width, int* __restrict__ out) {
  const long long m = blockIdx.x;
  const int a_lo = a_offs[m];
  const int a_hi = a_offs[m + 1];
  const long long limit = width * 32;  // bits of a dense row
  unsigned hits = 0;
  if (CELL == RUN_DENSE) {
    const unsigned* row = dense_row(b_base, b_table, width, m);
    const int lane = threadIdx.x & 31;
    const int stride = gridDim.y * WARPS;
    for (int r = a_lo + blockIdx.y * WARPS + (threadIdx.x >> 5); r < a_hi;
         r += stride) {
      long long s = a_vals[r];
      long long e = a_ends[r];
      if (s < 0) s = 0;
      if (e > limit) e = limit;
      if (s >= e) continue;
      const long long first = s >> 5;
      const long long last = (e - 1) >> 5;
      for (long long w = first + lane; w <= last; w += 32) {
        unsigned mask = FULL_MASK;
        if (w == first) mask &= FULL_MASK << (unsigned)(s & 31);
        if (w == last) mask &= FULL_MASK >> (31u - (unsigned)((e - 1) & 31));
        hits += __popc(__ldg(row + w) & mask);
      }
    }
  } else {
    int b_lo = 0, b_hi = 0;
    const unsigned* row = nullptr;
    if (CELL == ARRAY_DENSE) {
      row = dense_row(b_base, b_table, width, m);
    } else {
      b_lo = b_offs[m];
      b_hi = b_offs[m + 1];
    }
    const int stride = gridDim.y * THREADS;
    for (int i = a_lo + blockIdx.y * THREADS + threadIdx.x; i < a_hi;
         i += stride) {
      const int x = a_vals[i];
      if (CELL == ARRAY_ARRAY) {
        const int j = lower_bound(b_vals, b_lo, b_hi, x);
        hits += (j < b_hi && b_vals[j] == x) ? 1u : 0u;
      } else if (CELL == ARRAY_RUN) {
        const int j = upper_bound(b_vals, b_lo, b_hi, x) - 1;
        hits += (j >= b_lo && x < b_ends[j]) ? 1u : 0u;
      } else {  // ARRAY_DENSE
        if (x >= 0 && x < limit) {
          hits += (__ldg(row + (x >> 5)) >> (unsigned)(x & 31)) & 1u;
        }
      }
    }
  }
  // Every thread reaches the reduction: the loops above only skip work.
  for (int off = 16; off > 0; off >>= 1) {
    hits += __shfl_down_sync(FULL_MASK, hits, off);
  }
  if ((threadIdx.x & 31) == 0 && hits != 0) {
    atomicAdd(out + m, static_cast<int>(hits));
  }
}

}  // namespace

extern "C" const char* pilosa_containers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Queue one launch of `cell` over n >= 1 members with `blocks_per_member`
// blocks each, on `stream`. Returns cudaGetLastError() after the launch (0
// when it was queued).
extern "C" int pilosa_container_and_counts(
    int cell, long long n, const int* a_vals, const int* a_ends,
    const int* a_offs, const int* b_vals, const int* b_ends,
    const int* b_offs, const void* b_base,
    const unsigned long long* b_table, long long width,
    int blocks_per_member, int* out, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || blocks_per_member < 1 ||
      blocks_per_member > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(blocks_per_member));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* base = static_cast<const unsigned*>(b_base);
  switch (cell) {
    case ARRAY_ARRAY:
      container_and_counts_kernel<ARRAY_ARRAY><<<grid, THREADS, 0, s>>>(
          a_vals, a_ends, a_offs, b_vals, b_ends, b_offs, base, b_table,
          width, out);
      break;
    case ARRAY_RUN:
      container_and_counts_kernel<ARRAY_RUN><<<grid, THREADS, 0, s>>>(
          a_vals, a_ends, a_offs, b_vals, b_ends, b_offs, base, b_table,
          width, out);
      break;
    case ARRAY_DENSE:
      container_and_counts_kernel<ARRAY_DENSE><<<grid, THREADS, 0, s>>>(
          a_vals, a_ends, a_offs, b_vals, b_ends, b_offs, base, b_table,
          width, out);
      break;
    case RUN_DENSE:
      container_and_counts_kernel<RUN_DENSE><<<grid, THREADS, 0, s>>>(
          a_vals, a_ends, a_offs, b_vals, b_ends, b_offs, base, b_table,
          width, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
