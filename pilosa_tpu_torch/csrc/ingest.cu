// Per-row cardinality and run starts of a sorted position stream: the
// classify pass of the bulk-ingest pipeline.
//
// Replaces, in pilosa_tpu, the XLA fusion _classify_stats_impl
// (ops/ingest.py:136-158), which the reference's ingest pipeline takes on
// accelerators (_classify_auto, :261-274). It is not a TPU (Pallas) kernel:
// no Pallas kernel is on the ingest path.
//
// Input: one (view, slice) batch sorted by (row, position) and
// deduplicated, as int32 rowidx[nnz] in 0..n_rows-1 and int32
// positions[nnz] in 0..2^20-1. Output: int32 counts[n_rows] (each row's
// cardinality) and int32 runs[n_rows] (each row's run starts: an entry
// starts a run when it is the first of its row or its position is not the
// previous position plus one). Both outputs arrive zeroed; the kernel adds
// into them. From the two, the roaring thresholds pick ARRAY, RUN or DENSE
// for every row of the batch on the host.
//
// Bound: device memory. Each input entry is read once (8 bytes) and each
// output written once (8 bytes a row): 8 * nnz + 8 * n_rows bytes. At
// phase 11's shapes (about 1,000,000 entries over 1,024 rows, and
// 8,000,000 in one slice) that is 8 MB (2.4 us at 3.35 TB/s, under a
// launch's own 5.3 us) and 64 MB (19 us).
//
// Design: a grid-stride walk over tiles of TILE entries. A block stages a
// tile's rows and positions in shared memory with coalesced loads, with
// the entry before the tile at slot 0, so every entry's predecessor is
// the slot before it. Each thread then walks CHUNK consecutive entries
// (CHUNK is odd, so the 32 lanes' strided reads of shared memory fall in
// 32 distinct banks), keeping a running count and run count for the row
// it is in; it adds them into the outputs with one atomicAdd pair each
// time its chunk crosses a row boundary. The pair of its chunk's last row
// is first summed over the warp's lanes that end in the same row
// (__match_any_sync, __reduce_add_sync), and the lowest of them adds it:
// rows are thousands of entries long, so that cuts the atomics on one
// address by the lanes a row spans. Atomics number about rows + warps,
// not nnz. Integer adds are exact in any order: the result is
// deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int CHUNK = 23;                 // entries a thread; odd
constexpr int TILE = THREADS * CHUNK;     // 5,888 entries, 47 KB staged
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_GRID = 132 * 8;

__device__ __forceinline__ void flush(int row, int cnt, int runs,
                                      int n_rows, int* counts,
                                      int* run_starts) {
  if (row < 0 || row >= n_rows || cnt == 0) return;
  atomicAdd(counts + row, cnt);
  if (runs) atomicAdd(run_starts + row, runs);
}

__global__ void __launch_bounds__(THREADS)
ingest_classify_kernel(const int* __restrict__ rowidx,
                       const int* __restrict__ pos, long long nnz,
                       int n_rows, int* __restrict__ counts,
                       int* __restrict__ run_starts) {
  // Slot 0: the entry before the tile (row -1 before the stream's first).
  __shared__ int s_row[TILE + 1];
  __shared__ int s_pos[TILE + 1];
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (nnz + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * TILE;
    const int n = (int)min((long long)TILE, nnz - base);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      s_row[i + 1] = __ldg(rowidx + base + i);
      s_pos[i + 1] = __ldg(pos + base + i);
    }
    if (threadIdx.x == 0) {
      s_row[0] = base ? __ldg(rowidx + base - 1) : -1;
      s_pos[0] = base ? __ldg(pos + base - 1) : 0;
    }
    __syncthreads();
    const int lo = threadIdx.x * CHUNK;
    const int hi = min(lo + CHUNK, n);
    int cur = -1, cnt = 0, runs = 0;
    if (lo < hi) {
      int prev_row = s_row[lo], prev_pos = s_pos[lo];
      cur = s_row[lo + 1];
      for (int i = lo; i < hi; ++i) {
        const int r = s_row[i + 1], p = s_pos[i + 1];
        if (r != cur) {
          flush(cur, cnt, runs, n_rows, counts, run_starts);
          cur = r;
          cnt = 0;
          runs = 0;
        }
        ++cnt;
        runs += !(r == prev_row && p == prev_pos + 1);
        prev_row = r;
        prev_pos = p;
      }
    }
    // The chunk's last row: summed over the warp's lanes ending in it.
    const unsigned peers = __match_any_sync(FULL_MASK, cur);
    const int cnt_sum = (int)__reduce_add_sync(peers, (unsigned)cnt);
    const int runs_sum = (int)__reduce_add_sync(peers, (unsigned)runs);
    if (lane == __ffs(peers) - 1)
      flush(cur, cnt_sum, runs_sum, n_rows, counts, run_starts);
    __syncthreads();  // the tile's slots are reloaded next
  }
}

extern "C" const char* pilosa_ingest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Queue one classify pass on `stream`; counts and run_starts must be
// zeroed int32[n_rows]. Returns the launch's CUDA error code (0: queued).
extern "C" int pilosa_ingest_classify(const int* rowidx, const int* pos,
                                      long long nnz, int n_rows, int* counts,
                                      int* run_starts, void* stream) {
  if (nnz <= 0 || n_rows <= 0) return 0;
  const long long tiles = (nnz + TILE - 1) / TILE;
  const int grid = (int)(tiles < MAX_GRID ? tiles : MAX_GRID);
  ingest_classify_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rowidx, pos, nnz, n_rows, counts, run_starts);
  return (int)cudaGetLastError();
}
