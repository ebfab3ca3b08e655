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
//
// Design for that bound: one block per (slice, chunk of up to RB candidate
// rows). Each thread loads a 16-byte vector of the filter ONCE, ANDs it
// with the same vector of each of the chunk's rows and keeps RB register
// accumulators, so the filter is read once per chunk instead of once per
// candidate. Then a warp-shuffle reduction per row, a shared-memory
// reduction across the block's warps and one plain store per (r, s): no
// atomics, so counts are deterministic and exact. In the stacked form the R
// row pointers travel by value in a kernel-parameter table (MAX_ROWS of
// them, 2 KiB of the 4 KiB parameter space), so the candidates need no
// stacking copy and no device pointer array; the wrapper launches again
// for more rows. In the strided form (row_stride != 0) row r sits at
// ptr[0] + r * row_stride, so a fragment matrix of any row count is one
// launch. Blocks walk a 1-D space of (slice, chunk) pairs, a slice's
// chunks adjacent so that they meet its filter in L2, and the grid strides
// over it: no grid dimension limits R or S. A chunk whose rows are not all
// 16-byte aligned relative to the filter, and every row's unaligned head
// and ragged tail, take the scalar path, so any width and any storage
// offset work without padding. At a narrow window (W = 128 words, 32
// vectors) most of a block's 256 threads idle: the launch shape is tuned
// for full-width rows.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 8;              // candidate rows per block
constexpr int MAX_ROWS = 256;      // row pointers per launch
constexpr long long MAX_GRID = 1 << 20;

struct RowTable {
  const uint32_t* ptr[MAX_ROWS];
};

__device__ __forceinline__ int popc_and4(const uint4& a, const uint4& f) {
  return __popc(a.x & f.x) + __popc(a.y & f.y) + __popc(a.z & f.z) +
         __popc(a.w & f.w);
}

__global__ void __launch_bounds__(THREADS)
count_and_rows_kernel(const __grid_constant__ RowTable rows,
                      long long row_stride, long long nrows,
                      const uint32_t* __restrict__ filt, long long slices,
                      long long width, int32_t* __restrict__ out,
                      long long out_stride) {
  __shared__ int warp_sums[WARPS][RB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long chunks = (nrows + RB - 1) / RB;

  for (long long b = blockIdx.x; b < slices * chunks; b += gridDim.x) {
    const long long s = b / chunks;
    const long long r0 = (b % chunks) * RB;
    const int nr = (int)min((long long)RB, nrows - r0);
    const uint32_t* fs = filt + s * width;
    const uint32_t* rs[RB];
    bool aligned = true;
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const uint32_t* row =
          k >= nr ? nullptr
          : row_stride ? rows.ptr[0] + (r0 + k) * row_stride
                       : rows.ptr[r0 + k];
      rs[k] = k < nr ? row + s * width : fs;
      aligned &= ((reinterpret_cast<uintptr_t>(rs[k]) ^
                   reinterpret_cast<uintptr_t>(fs)) & 15) == 0;
    }
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
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < RB; ++k) warp_sums[warp][k] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x < nr) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) total += warp_sums[w][threadIdx.x];
      out[(long long)(r0 + threadIdx.x) * out_stride + s] = total;
    }
    __syncthreads();  // warp_sums is reused by the next (slice, chunk)
  }
}

// Message for a CUDA error code, for the wrapper's exception text.
extern "C" const char* pilosa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static int launch(const RowTable& table, long long row_stride,
                  long long nrows, const void* filt, long long slices,
                  long long width, void* out, long long out_stride,
                  void* stream) {
  const long long blocks = slices * ((nrows + RB - 1) / RB);
  count_and_rows_kernel<<<(unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID),
                          THREADS, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      table, row_stride, nrows, static_cast<const uint32_t*>(filt), slices,
      width, static_cast<int32_t*>(out), out_stride);
  return (int)cudaGetLastError();
}

// C interface, bound with ctypes. `row_ptrs` is a HOST array of `nrows`
// (1..MAX_ROWS) device addresses, row r's slice s starting at
// row_ptrs[r] + s * width words; `filt` and `out` are device pointers, out
// holding row r's slice s at out[r * out_stride + s]; `stream` is a
// cudaStream_t. Returns the launch's cudaGetLastError() (0 = cudaSuccess);
// the kernel itself runs asynchronously on `stream`.
extern "C" int pilosa_count_and_rows(const unsigned long long* row_ptrs,
                                     int nrows, const void* filt,
                                     long long slices, long long width,
                                     void* out, long long out_stride,
                                     void* stream) {
  if (nrows <= 0 || slices <= 0) return (int)cudaSuccess;
  if (nrows > MAX_ROWS || width < 0) return (int)cudaErrorInvalidValue;
  RowTable table;
  for (int r = 0; r < MAX_ROWS; ++r)
    table.ptr[r] = r < nrows
                       ? reinterpret_cast<const uint32_t*>(row_ptrs[r])
                       : nullptr;
  return launch(table, 0, nrows, filt, slices, width, out, out_stride,
                stream);
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
                                             void* stream) {
  if (nrows <= 0 || slices <= 0) return (int)cudaSuccess;
  if (row_stride <= 0 || width < 0) return (int)cudaErrorInvalidValue;
  RowTable table = {};
  table.ptr[0] = static_cast<const uint32_t*>(base);
  return launch(table, row_stride, nrows, filt, slices, width, out,
                out_stride, stream);
}
