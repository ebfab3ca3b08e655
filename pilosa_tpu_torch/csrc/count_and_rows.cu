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
