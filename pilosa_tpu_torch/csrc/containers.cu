// Per-member |a ∩ b| of compressed row blocks (roaring array, run and dense
// containers), N members in one launch, read in place through a lane table.
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
// Inputs. A launch takes the distinct packed SIDES it reads, by value in a
// kernel-parameter table (at most MAX_SIDES a side; the wrapper launches
// again past that), and an int32 MEMBER TABLE on the card: member k is
// (a side, a member, b side, b member). A packed side holds its members'
// sorted int32 payloads concatenated, with int32 offsets[M + 1] giving
// member m's items [offs[m], offs[m + 1]) (the reference pads every member
// to a power of two because XLA needs static shapes):
//   - array side: bit positions in [0, 32 * width);
//   - run side: starts and ends of disjoint half-open runs;
//   - dense side: member m's row of `width` int32 words at base + m * width,
//     or at the address rows[m] (a device table of row pointers).
// So the lanes read a row's packed blocks where its RowLane keeps them: a
// subset of a row's slices is a set of member indices, never a repack. A
// null member table is the identity: member k is member k of side 0 on
// both sides (the serial cells, one member).
//
// Bound: device memory. Each payload byte and each offset is read once,
// an array x dense member touches one 32-byte sector of the row a position,
// a run x dense member the words its runs cover; out is N int32. At the
// serial shapes (one member of at most 4,096 positions or 2,048 runs) the
// bound is far below a launch's own cost.
//
// Design. A persistent grid (every resident block of 256 threads, three a
// multiprocessor) walks the members in rounds. Warp w of block b is the
// grid's warp w * grid + b and takes the members w * grid + b, + warps,
// ..., 32 a round, a lane loading each one's table row and offsets; so
// member k falls to block k mod grid. The kernel sorts a round's members
// into two kinds by their staged ints (positions, plus run starts and
// ends):
//   - LIGHT members, at most BLOCK_MIN_INTS, take their warp;
//   - HEAVY members, more, go to the block's queue; once the round's light
//     members are done, the whole block takes each in turn, warp 0 loading
//     the next 32 at once.
// A launch of at most BLOCK_ALL_MAX_N members has a block a member instead.
// Each warp (or block) stages its member's payloads in shared memory with
// cp.async, 16-byte copies of the aligned groups that cover each range,
// double-buffered: the next member's copies are issued before the current
// member is intersected, so the load latency overlaps the work. A light
// member over one buffer takes both of its warp's, staged once the warp's
// other copies have landed; a member over every buffer is read from global
// memory in place (same code, generic pointers). Then:
//   - array x array and array x run: a merge path: each of the G threads
//     takes an equal share of the |a| + |b| steps of merging a's positions
//     with b's positions (or run starts), finds its start with one binary
//     search, then walks, branch-free; a position counts when the last b
//     item merged before it is equal to it (array) or a run that covers it.
//   - array x dense: a thread per position gathers one word of the row.
//   - run x dense: a warp per run, its lanes on consecutive words.
// Counts are written once, without atomics: a warp's by its lane 0 after a
// shuffle reduction, a block's by thread 0 after adding its warps' sums in
// a fixed order. Integer adds: exact and deterministic. out needs no
// zeroing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Cell { ARRAY_ARRAY = 0, ARRAY_RUN = 1, ARRAY_DENSE = 2, RUN_DENSE = 3 };

// Ints of one warp's staging buffer. Two a warp, 16 a block: 67,584 bytes
// of shared memory, so MIN_BLOCKS = 3 blocks (24 warps) fit a
// multiprocessor's 228 KB. A block's heavy member gets half of them
// (8,448 ints: the largest valid member, 4,096 positions against 2,048
// runs, is 8,192).
constexpr int WARP_STAGE_INTS = 1056;
constexpr int MIN_BLOCKS = 3;
constexpr int STAGE_INTS = 2 * WARPS * WARP_STAGE_INTS;
constexpr int HEAVY_STAGE_INTS = STAGE_INTS / 2;
constexpr int STAGE_BYTES = STAGE_INTS * 4;

// The thresholds below were set from pilosa_tpu_torch/tools/kernel_ab.py,
// which rewrites them to force each side (PERF.md §6).
//
// A member of more staged ints than this is heavy: a whole block
// intersects it. A warp's two buffers hold 2,048 items with their
// alignment pads; past them a warp reads in place at 4-6% of the bound, a
// block at 39-60%.
constexpr long long BLOCK_MIN_INTS = 2048;
// A launch of at most this many members gives each a block: up to about
// one wave of blocks, a block a member finishes sooner than the warps
// (500 x 300 positions: 0.0028-0.0040 ms against 0.0037-0.0049 at N =
// 2-256, 0.0055 against 0.0051 at 512), and a lone serial member is not
// left to one warp.
constexpr long long BLOCK_ALL_MAX_N = 256;

// Distinct sides a launch reads, per side of the cell: 64 x 3 pointers x 2
// sides is 3 KiB of kernel parameters, within every toolkit's 4 KiB. The
// serial cells take the table of one.
constexpr int MAX_SIDES = 64;

template <int NS>
struct Sides {
  const int* v[NS];     // positions / run starts / dense base
  const int* e[NS];     // run ends / dense row-pointer table (or null)
  const int* offs[NS];  // member offsets (null for a dense side)
};

// Where a member's items lie, and how many.
struct Member {
  long long k;        // its row of the table (its out index)
  const int* a;       // a's positions or run starts
  const int* a2;      // a's run ends (RUN_DENSE)
  const int* b;       // b's positions or run starts
  const int* b2;      // b's run ends (ARRAY_RUN)
  const unsigned* row;  // b's dense row
  int na, nb;
};

__device__ __forceinline__ bool dense_cell(int cell) {
  return cell == ARRAY_DENSE || cell == RUN_DENSE;
}

// Member k's items, read through the table (or the identity).
template <int CELL, int NS>
__device__ __forceinline__ Member load_member(const Sides<NS>& A,
                                              const Sides<NS>& B,
                                              const int4* table, long long k,
                                              long long width) {
  int as = 0, am = (int)k, bs = 0, bm = (int)k;
  if (table != nullptr) {
    const int4 t = __ldg(table + k);
    as = t.x;
    am = t.y;
    bs = t.z;
    bm = t.w;
  }
  Member m;
  m.k = k;
  const int* ao = A.offs[as];
  const int alo = __ldg(ao + am);
  m.na = __ldg(ao + am + 1) - alo;
  m.a = A.v[as] + alo;
  m.a2 = (CELL == RUN_DENSE) ? A.e[as] + alo : nullptr;
  m.b = m.b2 = nullptr;
  m.row = nullptr;
  m.nb = 0;
  if (dense_cell(CELL)) {
    const unsigned long long* rows =
        reinterpret_cast<const unsigned long long*>(B.e[bs]);
    m.row = rows != nullptr
                ? reinterpret_cast<const unsigned*>(__ldg(rows + bm))
                : reinterpret_cast<const unsigned*>(B.v[bs]) + bm * width;
  } else {
    const int* bo = B.offs[bs];
    const int blo = __ldg(bo + bm);
    m.nb = __ldg(bo + bm + 1) - blo;
    m.b = B.v[bs] + blo;
    m.b2 = (CELL == ARRAY_RUN) ? B.e[bs] + blo : nullptr;
  }
  return m;
}

// Member `src`'s fields from lane `from` of the warp.
__device__ __forceinline__ Member shfl_member(const Member& src, int from) {
  Member m;
  m.k = __shfl_sync(FULL_MASK, src.k, from);
  m.a = reinterpret_cast<const int*>(__shfl_sync(
      FULL_MASK, reinterpret_cast<unsigned long long>(src.a), from));
  m.a2 = reinterpret_cast<const int*>(__shfl_sync(
      FULL_MASK, reinterpret_cast<unsigned long long>(src.a2), from));
  m.b = reinterpret_cast<const int*>(__shfl_sync(
      FULL_MASK, reinterpret_cast<unsigned long long>(src.b), from));
  m.b2 = reinterpret_cast<const int*>(__shfl_sync(
      FULL_MASK, reinterpret_cast<unsigned long long>(src.b2), from));
  m.row = reinterpret_cast<const unsigned*>(__shfl_sync(
      FULL_MASK, reinterpret_cast<unsigned long long>(src.row), from));
  m.na = __shfl_sync(FULL_MASK, src.na, from);
  m.nb = __shfl_sync(FULL_MASK, src.nb, from);
  return m;
}

// ------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Ints of src's place in a 16-byte group.
__device__ __forceinline__ int head_of(const int* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Shared ints that staging n ints from src takes: the 16-byte groups
// covering them.
__device__ __forceinline__ int footprint(const int* src, int n) {
  return n > 0 ? (head_of(src) + n + 3) & ~3 : 0;
}

// Queue the copies of src[0, n) into dst (16-byte aligned, keeping src's
// place in its group) by the G threads of a group, thread r, as 16-byte
// copies of the groups that cover it; returns where src[0] lands. A
// group's bytes outside [src, src + n) are copied and never read; an
// aligned 16-byte group never crosses a page, so they are mapped.
template <int G>
__device__ __forceinline__ const int* stage(int* dst, const int* src, int n,
                                            int r) {
  const int h = head_of(src);
  const int* g = src - h;  // 16-byte aligned
  const int groups = (h + n + 3) >> 2;
  for (int q = r; q < groups; q += G) cp_async16(dst + 4 * q, g + 4 * q);
  return dst + h;
}

// Shared ints that staging the member's payloads takes.
template <int CELL>
__device__ __forceinline__ int member_footprint(const Member& m) {
  int f = footprint(m.a, m.na);
  if (CELL == RUN_DENSE) f += footprint(m.a2, m.na);
  if (!dense_cell(CELL)) f += footprint(m.b, m.nb);
  if (CELL == ARRAY_RUN) f += footprint(m.b2, m.nb);
  return f;
}

// Stage the member's payloads into buf (cap ints) when they fit, pointing
// the member at the copies; else leave it reading global memory.
template <int CELL, int G>
__device__ __forceinline__ void stage_member(Member& m, int* buf, int cap,
                                             int r) {
  if (member_footprint<CELL>(m) > cap) return;
  int* p = buf;
  if (m.na > 0) m.a = stage<G>(p, m.a, m.na, r);
  p += footprint(m.a, m.na);
  if (CELL == RUN_DENSE) {
    if (m.na > 0) m.a2 = stage<G>(p, m.a2, m.na, r);
    p += footprint(m.a2, m.na);
  }
  if (!dense_cell(CELL)) {
    if (m.nb > 0) m.b = stage<G>(p, m.b, m.nb, r);
    p += footprint(m.b, m.nb);
    if (CELL == ARRAY_RUN && m.nb > 0) m.b2 = stage<G>(p, m.b2, m.nb, r);
  }
}

// ------------------------------------------------------- intersections

// Positions a[0, na) found in b: an array b (RUN false) holds them as
// items s[j]; a run b covers them, s[j] <= x < e[j]. Merge path over the
// G threads: the merge takes b's item first on a tie, so when position x
// is merged, the last b item merged before it is the last one <= x.
template <int G, bool RUN>
__device__ __forceinline__ unsigned merge_hits(const int* a, int na,
                                               const int* s, const int* e,
                                               int nb, int r) {
  if (na == 0 || nb == 0) return 0u;
  const long long total = (long long)na + nb;
  const long long per = (total + G - 1) / G;
  const int d0 = (int)min(total, r * per);
  const int d1 = (int)min(total, d0 + per);
  if (d0 >= d1) return 0u;
  // The split of the first d0 merged items: the most positions i whose
  // last, a[i - 1], merges before b's item s[d0 - i].
  int lo = max(0, d0 - nb), hi = min(d0, na);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a[mid - 1] < s[d0 - mid]) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  int i = lo, j = d0 - lo;
  // Branch-free steps (lanes take b's item or a's position in any mix):
  // both heads are reloaded each step, clamped in range.
  const int ia = na - 1, jb = nb - 1;
  int av = a[min(i, ia)];
  int sv = s[min(j, jb)];
  int ev = RUN ? e[min(j, jb)] : 0;
  bool have = j > 0;  // a b item merged before this share
  int last = have ? (RUN ? e[j - 1] : s[j - 1]) : 0;
  unsigned hits = 0;
  for (int d = d0; d < d1; ++d) {
    const bool tb = (j < nb) & ((i >= na) | (sv <= av));
    hits += (!tb & have & (RUN ? av < last : av == last)) ? 1u : 0u;
    last = tb ? (RUN ? ev : sv) : last;
    have |= tb;
    i += tb ? 0 : 1;
    j += tb ? 1 : 0;
    av = a[min(i, ia)];
    sv = s[min(j, jb)];
    if (RUN) ev = e[min(j, jb)];
  }
  return hits;
}

// This thread's share of the member's count, thread r of a group of G.
template <int CELL, int G>
__device__ __forceinline__ unsigned member_hits(const Member& m,
                                                long long limit, int r) {
  unsigned hits = 0;
  if (CELL == ARRAY_ARRAY || CELL == ARRAY_RUN) {
    constexpr bool RUN = CELL == ARRAY_RUN;
    hits = merge_hits<G, RUN>(m.a, m.na, m.b, m.b2, m.nb, r);
  } else if (CELL == ARRAY_DENSE) {
#pragma unroll 4
    for (int i = r; i < m.na; i += G) {
      const int x = m.a[i];
      if (x >= 0 && x < limit) {
        hits += (__ldg(m.row + (x >> 5)) >> (unsigned)(x & 31)) & 1u;
      }
    }
  } else {  // RUN_DENSE: a warp a run, its lanes on consecutive words
    const int lane = r & 31;
    for (int k = r >> 5; k < m.na; k += G / 32) {
      long long s = m.a[k];
      long long e = m.a2[k];
      if (s < 0) s = 0;
      if (e > limit) e = limit;
      if (s >= e) continue;
      const long long first = s >> 5;
      const long long last = (e - 1) >> 5;
      for (long long w = first + lane; w <= last; w += 32) {
        unsigned mask = FULL_MASK;
        if (w == first) mask &= FULL_MASK << (unsigned)(s & 31);
        if (w == last) mask &= FULL_MASK >> (31u - (unsigned)((e - 1) & 31));
        hits += __popc(__ldg(m.row + w) & mask);
      }
    }
  }
  return hits;
}

// Ints a member stages: its positions, or its run starts and ends, on each
// side read from a list (a dense row is read in place).
template <int CELL>
__device__ __forceinline__ long long staged_ints(const Member& m) {
  long long s = CELL == RUN_DENSE ? 2LL * m.na : m.na;
  if (CELL == ARRAY_ARRAY) s += m.nb;
  if (CELL == ARRAY_RUN) s += 2LL * m.nb;
  return s;
}

// ------------------------------------------------------------------ walks

// The block intersects q >= 1 members, the i-th at table row row(i), each
// with all its threads, double-buffered over the halves of the stage; warp
// 0 loads the next 32 members at once, a lane each.
template <int CELL, int NS, typename Row>
__device__ __forceinline__ void block_walk(const Sides<NS>& A,
                                           const Sides<NS>& B,
                                           const int4* table, long long width,
                                           int* out, int* smem,
                                           unsigned* warp_sums, Member* batch,
                                           long long q, Row row) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long limit = width * 32;
  long long at = 0;
  auto next_batch = [&]() -> int {
    const int size = (int)min(32LL, q - at);
    __syncthreads();  // the last batch is read
    if (warp == 0 && lane < size) {
      batch[lane] = load_member<CELL, NS>(A, B, table, row(at + lane), width);
    }
    at += size;
    __syncthreads();
    return size;
  };
  int size = next_batch(), bi = 1, buf = 0;
  Member cur = batch[0];
  stage_member<CELL, THREADS>(cur, smem, HEAVY_STAGE_INTS, tid);
  cp_commit();
  for (;;) {
    if (bi >= size) {
      size = next_batch();
      bi = 0;
    }
    const bool more = bi < size;
    Member nxt;
    if (more) {
      nxt = batch[bi++];
      stage_member<CELL, THREADS>(nxt, smem + (buf ^ 1) * HEAVY_STAGE_INTS,
                                  HEAVY_STAGE_INTS, tid);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // every thread's copies of cur have landed
    const unsigned hits = __reduce_add_sync(
        FULL_MASK, member_hits<CELL, THREADS>(cur, limit, tid));
    if (lane == 0) warp_sums[warp] = hits;
    __syncthreads();  // the sums are in; cur's buffer is free
    if (tid == 0) {
      unsigned sum = 0;
      for (int w = 0; w < WARPS; ++w) sum += warp_sums[w];
      out[cur.k] = static_cast<int>(sum);
    }
    if (!more) break;
    cur = nxt;
    buf ^= 1;
  }
  cp_wait<0>();
  __syncthreads();  // the stage is free
}

// The warp intersects the members of its lanes in `mask` (lane l holds
// `mine`), each with its 32 lanes, double-buffered over its two buffers at
// wbuf; a member over one buffer but within both takes both, single-
// buffered: it is staged once the warp's other copies have landed.
template <int CELL>
__device__ __forceinline__ void warp_walk(const Member& mine, unsigned mask,
                                          int* wbuf, long long limit,
                                          int* out) {
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  auto take = [&]() {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    return shfl_member(mine, src);
  };
  auto is_wide = [](const Member& m) {
    const int f = member_footprint<CELL>(m);
    return f > WARP_STAGE_INTS && f <= 2 * WARP_STAGE_INTS;
  };
  Member cur = take();
  bool wide = is_wide(cur);
  int buf = 0;
  if (!wide) stage_member<CELL, 32>(cur, wbuf, WARP_STAGE_INTS, lane);
  cp_commit();
  for (;;) {
    const bool more = mask != 0;
    Member nxt;
    bool nxt_wide = false;
    if (wide) {
      cp_wait<0>();
      __syncwarp();  // both buffers are free
      stage_member<CELL, 32>(cur, wbuf, 2 * WARP_STAGE_INTS, lane);
      cp_commit();
    }
    if (more) {
      nxt = take();
      nxt_wide = is_wide(nxt);
      if (!nxt_wide && !wide) {
        stage_member<CELL, 32>(nxt, wbuf + (buf ^ 1) * WARP_STAGE_INTS,
                               WARP_STAGE_INTS, lane);
      }
    }
    cp_commit();
    if (wide) {
      cp_wait<0>();
    } else {
      cp_wait<1>();
    }
    __syncwarp();  // every lane's copies of cur have landed
    const unsigned hits = __reduce_add_sync(
        FULL_MASK, member_hits<CELL, 32>(cur, limit, lane));
    if (lane == 0) out[cur.k] = static_cast<int>(hits);
    __syncwarp();  // cur's buffer is free for the member after nxt
    if (!more) break;
    if (wide && !nxt_wide) {  // nxt was not prefetched
      stage_member<CELL, 32>(nxt, wbuf, WARP_STAGE_INTS, lane);
      cp_commit();
      buf = 1;
    }
    cur = nxt;
    wide = nxt_wide;
    buf ^= 1;
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------- kernel

template <int CELL, int NS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
container_and_counts_kernel(const __grid_constant__ Sides<NS> A,
                            const __grid_constant__ Sides<NS> B,
                            const int4* __restrict__ table, long long n,
                            long long width, int* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ unsigned warp_sums[WARPS];
  __shared__ Member batch[32];
  __shared__ int queue[THREADS];  // the round's heavy members' table rows
  __shared__ int queued;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long grid = gridDim.x;
  const long long b = blockIdx.x;

  if (n <= BLOCK_ALL_MAX_N) {  // a block a member
    const long long q = b < n ? (n - b + grid - 1) / grid : 0;
    if (q > 0) {
      block_walk<CELL, NS>(A, B, table, width, out, smem, warp_sums, batch,
                           q, [&](long long i) { return b + i * grid; });
    }
    return;
  }
  const long long nw = grid * WARPS;
  int* wbuf = smem + warp * 2 * WARP_STAGE_INTS;
  if (tid == 0) queued = 0;
  for (long long first = warp * grid + b;; first += 32 * nw) {
    const int size =
        first < n ? (int)min(32LL, (n - first + nw - 1) / nw) : 0;
    if (!__syncthreads_or(size > 0)) break;  // the queue is empty
    Member mine = {};
    bool heavy = false;
    if (lane < size) {
      mine = load_member<CELL, NS>(A, B, table, first + lane * nw, width);
      heavy = staged_ints<CELL>(mine) > BLOCK_MIN_INTS;
      if (heavy) queue[atomicAdd(&queued, 1)] = static_cast<int>(mine.k);
    }
    warp_walk<CELL>(mine, __ballot_sync(FULL_MASK, lane < size && !heavy),
                    wbuf, width * 32, out);
    __syncthreads();  // the queue is whole; the warps' buffers are free
    const int q = queued;
    if (q > 0) {
      block_walk<CELL, NS>(A, B, table, width, out, smem, warp_sums, batch,
                           q, [&](long long i) { return (long long)queue[i]; });
    }
    __syncthreads();  // every thread has read queued
    if (tid == 0) queued = 0;
  }
}

// Resident blocks of one instantiation on this device (shared memory
// opted in once).
template <int CELL, int NS>
int resident_blocks(cudaError_t* err) {
  static int blocks = 0;
  if (blocks == 0) {
    auto fn = container_and_counts_kernel<CELL, NS>;
    *err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                STAGE_BYTES);
    if (*err != cudaSuccess) return 0;
    *err = cudaFuncSetAttribute(fn,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    if (*err != cudaSuccess) return 0;
    int dev = 0, sms = 0, per = 0;
    if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
    if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess)
      return 0;
    if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, fn, THREADS, STAGE_BYTES)) != cudaSuccess)
      return 0;
    blocks = sms * (per > 0 ? per : 1);
  }
  *err = cudaSuccess;
  return blocks;
}

template <int CELL, int NS>
int launch(const unsigned long long* a_sides, int n_a,
           const unsigned long long* b_sides, int n_b, const int* members,
           long long n, long long width, int* out, cudaStream_t stream) {
  Sides<NS> A, B;
  for (int i = 0; i < NS; ++i) {
    for (int p = 0; p < 3; ++p) {
      const int* ap = i < n_a ? reinterpret_cast<const int*>(a_sides[3 * i + p])
                              : nullptr;
      const int* bp = i < n_b ? reinterpret_cast<const int*>(b_sides[3 * i + p])
                              : nullptr;
      (p == 0 ? A.v : p == 1 ? A.e : A.offs)[i] = ap;
      (p == 0 ? B.v : p == 1 ? B.e : B.offs)[i] = bp;
    }
  }
  cudaError_t err;
  const long long resident = resident_blocks<CELL, NS>(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A block a member up to BLOCK_ALL_MAX_N and up to every resident
  // block, so that a few heavy members each find a block of their own.
  const long long grid = n < resident ? n : resident;
  container_and_counts_kernel<CELL, NS>
      <<<static_cast<unsigned>(grid), THREADS, STAGE_BYTES, stream>>>(
          A, B, reinterpret_cast<const int4*>(members), n, width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* pilosa_containers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The thresholds above, for callers that build shapes at their edges:
// BLOCK_MIN_INTS, BLOCK_ALL_MAX_N, MAX_SIDES.
extern "C" void pilosa_containers_thresholds(long long* out) {
  out[0] = BLOCK_MIN_INTS;
  out[1] = BLOCK_ALL_MAX_N;
  out[2] = MAX_SIDES;
}

// Queue one launch of `cell` over n >= 1 members on `stream`. `a_sides`
// and `b_sides` are HOST arrays of 3 device addresses a side (positions or
// starts, ends or a dense row-pointer table or 0, offsets or 0), n_a and
// n_b (1..MAX_SIDES) of them; `members` is a device int32[n, 4] member
// table, 16-byte aligned, or null for the identity (then one side each).
// `out` is a device int32[n]. Returns cudaGetLastError() after the launch
// (0 when it was queued).
extern "C" int pilosa_container_and_counts(
    int cell, long long n, const unsigned long long* a_sides, int n_a,
    const unsigned long long* b_sides, int n_b, const int* members,
    long long width, int* out, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || n_a < 1 || n_b < 1 ||
      n_a > MAX_SIDES || n_b > MAX_SIDES ||
      (members == nullptr && (n_a != 1 || n_b != 1)) ||
      (reinterpret_cast<uintptr_t>(members) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = n_a == 1 && n_b == 1;
#define PILOSA_CONT_LAUNCH(C)                                               \
  return one ? launch<C, 1>(a_sides, n_a, b_sides, n_b, members, n, width,  \
                            out, s)                                         \
             : launch<C, MAX_SIDES>(a_sides, n_a, b_sides, n_b, members, n, \
                                    width, out, s)
  switch (cell) {
    case ARRAY_ARRAY:
      PILOSA_CONT_LAUNCH(ARRAY_ARRAY);
    case ARRAY_RUN:
      PILOSA_CONT_LAUNCH(ARRAY_RUN);
    case ARRAY_DENSE:
      PILOSA_CONT_LAUNCH(ARRAY_DENSE);
    case RUN_DENSE:
      PILOSA_CONT_LAUNCH(RUN_DENSE);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PILOSA_CONT_LAUNCH
}
