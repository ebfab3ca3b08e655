#!/usr/bin/env python3
"""Smoke run of pilosa_tpu_torch's main path on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py [--slices N]``.

Phases, each of which fails the run (exit code != 0, no result line):

1. device — the card's name and ``nvidia-smi`` name/power limit;
2. build — compile every CUDA source under pilosa_tpu_torch/csrc;
3. kernels — each kernel against its plain PyTorch version on the same
   device tensors, exactly, at the main-path shape [slices, 32768], at
   every column-window width bucket the batched plans use ([slices, W]
   for W = 128, 512, 2048, 8192, 32768, each kernel timed against its
   bound), at ``count_and_rows``'s strided fragment form [524,288 × 128]
   (one launch), and at ragged/edge shapes; ``count_op_rows``,
   ``count_rows`` and ``count_and_rows`` in each regime of their launch
   shapes (narrow, split, full) at its edges — widths 1 … 2,049 and
   32,768, 1 … 262,144 rows, both sides of every threshold, one operand
   off 16-byte alignment, bit-31 and all-ones words, the stacked form
   past 256 rows — each case in the regime the source names for its
   shape (the thresholds and the choice are read from the built
   libraries); an empty kernel's launch as the floor; the buckets timed
   a call from the host and a launch from a CUDA graph on cold inputs,
   and the serial path's shapes ([1, 32768] and [1, 128] rows, the
   fragment form at 8 and 11 rows of 32,768) also as one launch alone on
   cold inputs and as a call and synchronize (pilosa_tpu_torch/tools/
   kernel_ab.py times another build beside these, and two regimes at one
   shape); time, bytes, bound and plain-version time at the main-path
   shape; the coalescer's group kernels ``count_op_pairs`` at 8
   distinct pairs of the main shape (and every bucket) and
   ``count_and_rows_multi`` at 11 rows × 8 filters of it; the container
   tier's lane kernel ``container_and_counts`` in each cell (array ×
   array, array × run, array × dense, run × dense) at its boundary
   cases — 0, 1, 4,096 and bit-31 positions, 2,048 runs, a whole-row
   run, an empty member among full ones, 4,097-bit, all-ones and bit-31
   dense rows — with N = 1, 7 and 76,296 members, in the identity form
   and through member tables (repeated sides, shuffled subsets), members
   on both sides of the warp/block size threshold, a launch past
   the kernel's table of sides and rows of mixed formats through the
   lanes; then timed at the serial shapes (one member of phase 10's
   rows) and at a lane of each cell over GROUP_PAIRS row pairs of 9,537
   slices (76,296 members of 500 × 300 positions, 500 positions × a
   2,000-bit run; × dense rows and a run × dense rows as off-path
   probes, the main path's dense cells being serial), each with its
   bound; the ingest classify kernel ``ingest_classify`` on the empty
   stream, one entry, bits 31/32 and 2^20-1, a whole-row run of 2^20
   entries, rows of 4,096 and 4,097 bits, 1, 3 and 1,024 rows and rows
   ending on and inside its chunks, then timed at phase 11's shapes (a
   slice group of (a), ~1,000,000 entries over 1,024 rows, and an
   8,000,000-entry batch in one slice) with its bound, its plain
   version, the stream's copy to the card and the whole classify cell;
4. main path, Count and bitmap results — a data directory of N slices
   (default 9,537 = 10.0B columns; one index, one frame, three dense
   rows of bit density 0.5, 0.5 and 0.25 and a sparse row 3 of density
   2^-10 from ``--seed``) written in parallel through
   ``Fragment.read_from``, reopened by a GPU ``Holder``, and queried
   through ``Executor.execute``: Count over Bitmap/Intersect/Union/
   Difference/Xor trees on the batched and the serial path, then
   SetBit/ClearBit and recounts; then Pilosa's Getting Started reads,
   top-level ``Bitmap(frame="f", rowID=3)`` and sparse Intersect,
   Difference and Xor results compared id by id, SetRowAttrs and the
   attrs a Bitmap carries (with ``exclude_attrs``/``exclude_bits``),
   and SetColumnAttrs. Every answer must equal a numpy oracle on the
   same words; both count kernels must have launched during this
   phase. Then the directory is reopened with a host-memory budget
   (``Holder(host_bytes=256 MiB)``, below its fragments' host bytes):
   Count(Intersect) and TopN batched over the first 2,048 slices, a
   serial TopN and the bitmap result of row 3 over the first 512 answer as
   before, the governor's resident bytes stay within the budget after
   each query, and it must have evicted and faulted fragments in;
5. main path, TopN — a second frame ``t`` (ranked cache) of eight rows
   at every slice (densities 1/2 … 1/32, two identical rows), its
   fragment files and ``.cache`` sidecars written in parallel by the
   port's codec, the directory reopened, and Pilosa's Getting Started
   query shape ``TopN(Bitmap(frame="f", rowID=0), frame="t", n=5)`` and
   its variants (no Src, an Intersect Src with a threshold, a Tanimoto
   threshold, explicit ids) answered on both paths, before and after a
   SetBit and a ClearBit, and with an attribute filter (``field=
   "category", filters=["a", "b"]``) after a bulk SetRowAttrs. Every
   answer must equal a numpy oracle of the two-phase rule;
   ``count_and_rows`` must have launched;
6. main path, BSI — python-pilosa's documented integer field ``stars``
   (``type int``, ``min 0``, ``max 1000``: bit depth 10) on frame ``t``
   (range-enabled), a value in one column of two at every slice,
   heavy-tailed like GitHub stars, its 11 rows per slice written in
   parallel by the port's codec; then Sum, Average, filtered Sum,
   Count(Range(…)) with >, ><, >= inside an Intersect and the
   reference's shortcuts, Min, Max and filtered Max on both paths,
   before and after two ``SetFieldValue`` writes. Every answer must
   equal a numpy oracle on the values; ``count_and_rows``,
   ``count_op_rows`` and ``count_rows`` must all have launched;
7. main path, time windows — Pilosa's event-analytics example
   (``docs/examples.md:61-70``): a data directory of its own with index
   ``events`` and frame ``clicks`` (``timeQuantum="YMD"``), four rows
   over 128 slices (reduced from 9,537: EVENT_SLICES), each (row,
   column) clicked with probability 1/64
   on one day of 2017-06-01 … 14, so 17 views (``standard``,
   ``standard_2017``, ``standard_201706``, one per day) written in
   parallel by the port's codec; Count(Range(…)) over 14, 4, 1 (month,
   year), 2 (of 4, two absent) and 0 views and an Intersect of two
   Ranges on both paths, the top-level Ranges compared id by id, then a
   timestamped SetBit into a day view that does not exist yet and a
   ClearBit with a timestamp, with recounts. ``count_op_rows`` and
   ``count_rows`` must have launched;
8. the HTTP server and the CLI — run after phase 6, on its data
   directory, before phase 7. (a) ``Server(datadir, bind=
   "127.0.0.1:0")`` on the card, driven over one keep-alive
   ``http.client`` connection: ``/status`` and ``/schema`` list frames f
   and t with their views; Count(Intersect(row 0, row 1)) in JSON and in
   protobuf, then warm over HTTP (n=100) beside phase 4's in-process
   p50, and again with tracing off, on and ``?profile=true`` (report
   only; the answers with tracing on byte-equal to those with it off, the
   profile's tree from ``query`` to ``call:Count`` down to
   ``kernel:count_op_rows`` with its ``deviceMs`` within
   TRACE_DEVICE_TOL of phase 3's time); ``TopN(Bitmap(frame="f", rowID=0), frame="f", n=4)`` over frame
   f's cached rows; Sum and Count(Range(stars > 30)) after phase 6's
   writes; the batched Intersect(row 3, row 0)'s ~4.9M ids in the JSON
   body id by id, its HTTP p50 (n=5) beside the query, ``columns()`` and
   JSON-encoding times in process; SetBit and the recount; a protobuf
   ``/import`` of 100,000 bits of a new row over 8 slices, one past the
   last, its Count and ``/slices/max``; a protobuf ``/import-value`` of
   1,000 values into those slices and Sum; ``/export`` of the new slice against numpy.
   All three kernels must have launched. (b) ``python -m
   pilosa_tpu_torch.cli server`` as a subprocess (the GPU by default):
   Pilosa's Quick Start, ``cli import`` of a generated 10,000-line CSV
   and recounts against numpy, then SIGTERM and exit 0. (c), inside
   (a)'s server before its writes: concurrent clients in processes that
   import no torch, each on one keep-alive connection — the count mix
   (Count(Intersect(row a, row b)) of frame f, (a, b) drawn per request)
   and pilosa_tpu's mixed mix (~80% those, ~15% ``TopN(Bitmap(frame=
   "f", rowID=0), frame="t", n=5)``, ~5% SetBit of row 9, which no query
   reads) at 1, 8 and 32 clients, and 32 with the coalescer off, each
   1 s of warm-up and 2 s measured: q/s, p50, p99, the coalescer's
   rounds, fused queries and largest group, launches per query; then
   eight differently filtered Sums and eight Maxes, each released by a
   Barrier into one group, against the same served one after another;
   then warm repeats with the result memos and the response cache on.
   Every answer against phases 4-6's oracles; ``count_op_pairs`` and
   ``count_and_rows_multi`` must have launched;
9. the chemical-similarity shape (the reference's showcase, pilosa_tpu
   storage/fragment.py:87-90): index ``chem``, frame ``fingerprint``
   with a ranked cache holding every row (cacheSize 500,000): 500,000
   molecule rows × 4,096 fingerprint columns in slice 0, ~48 bits per
   molecule in families of 100 near-duplicates, from ``--seed``; the
   fragment's window must be (0, 128) words and its device bytes at most
   twice its host window; TopN with a Src and ``tanimotoThreshold=70``
   for four molecules, a Src-less TopN and Count(Intersect) of two
   molecules on both paths against a numpy oracle; the TopN p50 and the
   ``count_and_rows`` launches per TopN;
10. the sparse index — benchmarks/count100b.py's shape in a data
   directory of its own: index ``ns``, frame ``f``, rows 1 and 2 of 500
   and 300 bits spread over each slice (array containers), row 3 one
   2,000-bit run a slice (a run container), row 0 at density 0.5
   (dense), over 4,096 slices (``--sparse-slices``), opened lazily:
   (a) Count of Intersect(1, 2), Intersect(1, 3), Union(1, 2),
   Difference(1, 3) and Xor(2, 3), each alone through the container
   lanes (one launch a format cell over every slice), first-query
   seconds and p50 (n=5), the p50 again with the pair's member tables
   built cold each time, then pinned serial (a launch a slice); (b)
   Intersect(1, 0) and Intersect(3, 0) pinned serial (the array × dense
   and run × dense cells); (c) a group of 8 concurrent Count(Intersect(a,
   b)) over rows 1-3, released by a Barrier, through the coalescer's
   container lanes (3 rounds) against the 8 served one after another,
   with the lane launches and a round's host ms (the rows' cached
   RowLanes, the cells' member tables from the pairs' kept ones, and
   from tables built cold) against its kernel ms, and a row's cold
   RowLane build; (d) ``Holder.memory_stats()``'s container rollup, the
   array and run payload at least 10× under its dense equivalent, and
   ``torch.cuda.max_memory_allocated()``; (e) the first query again with
   the container tier off (``containers.set_enabled(False)``: the dense
   batched route). Every answer against numpy;
   ``container_and_counts`` must have launched;
11. bulk ingest (``ingest_path``) — ``POST /index/{i}/ingest`` of a
   ``Server`` on the card under a 6 GiB host budget, in a data
   directory of its own: (a) benchmarks/ingest.py's wide shape, 1,024
   rows, 4 binary requests of 8,000,000 bits with columns uniform over
   32 slices (array containers), bits/s alone and with 2 of them
   (reduced from 4) under a closed-loop Count(Intersect) client (report
   only), a JSON request, the seeded
   containers and no conversion, Counts, Count(Intersect), TopN and a
   pinned serial Count; (b) count100b's sparse shape over 1,024 slices
   in one request, first query's seconds and route; (c) 1,000 BSI
   values a slice over 256 slices (reduced from 1,024), Sum and Max;
   (d) 1,000,000
   timestamped bits into a YMD frame, Count(Range) over 14 days and 1;
   (e) 100,000 keyed pairs through JSON ``/import`` and ``cli import
   -k`` of 10,000 lines, the same ids after a reopen; (f)
   docs/input-definition.md's definition and 10,000 records through
   ``/input``. Every answer against numpy; every classify pass launches
   ``ingest_classify``, and the host bytes end within the budget;
12. the static cluster (``cluster_path``) — three nodes on the card in
   one process, replicas 2, each ``Server(cluster_hosts=…)`` over a
   directory of its own holding the slices placement gives it (frame f
   as phase 4 writes it, 512 slices: CLUSTER_SLICES), membership
   rounds driven by the phase (the first one's heartbeats carry each
   node's max slice to its peers): the Counts of phase 4's queries
   through every node as coordinator, TopN with and without a Src, row
   3's bitmap with its attributes id by id, SetBit and ClearBit through
   a node that holds no copy of the slice read back through every node,
   DDL through node 2 seen by all; each node's local leg alone (its
   primary slices as a ``remote=true`` subquery) must launch
   ``count_op_rows``, ``count_rows`` and ``count_and_rows``. Failover:
   node 3 closes, the Counts through nodes 1 and 2 stay exact, a round
   holds it DOWN, a write to one of its slices is hinted, and after it
   reopens the next round replays the write into its copy. Then node 3
   runs as a ``cli server`` process on the card: a write through it to
   a slice node 1 holds no copy of is counted through node 1, its memos
   and response cache on, within one epoch probe ttl
   (CLUSTER_EPOCH_TTL, 0.5 s for the phase). Before the failover, with
   the three nodes in process: (b) a profiled Count(Intersect) and TopN
   through node 1 with every node tracing, each trace stitched from the
   nodes' ``/debug/traces``: one ``remote.<host>`` span a peer leg with
   that peer's ``query.remote`` under it, the merged ``slices`` and
   ``fanoutCalls`` checked, each leg's ms printed; (g) node 1's memos
   and response cache on (validated on the epoch vector): warm
   Count(Intersect) repeats over HTTP replay (hit p50, hits), a SetBit
   and a ClearBit through node 1 to a slice it holds no copy of are read
   by its very next query; (h)
   8 and 32 closed-loop clients (8c's count mix, processes without
   torch) through node 1 for 2 s each, memos off, the remote batch
   lanes on and then off (q/s, p50, p99, rounds, batched calls; report
   only); (i) benchmarks/ingest.py's wide shape, 2 requests of
   8,000,000 bits over 32 slices, through node 2 into a new frame:
   bits/s, fan-out posts, each node's classify passes and
   ``ingest_classify``'s launches, Counts through every node and on
   each owner's own slices, (c) ``TopN(frame="w", n=1,024)`` through
   node 1 right after the ingest, profiled and stitched, equal to numpy
   with no leg failed over within CLUSTER_TOPN_MAX_S (the sampled stacks
   of the process's threads printed when it is slow), a ``?slice=`` leg
   to a non-owner answering 412; (j) 100,000 keyed pairs by JSON ``/import`` through a node that
   is not the key authority, every translated row's Count through every
   node. Steps (g)-(j) must launch ``count_op_rows``, ``count_rows``,
   ``count_and_rows`` and ``ingest_classify``. Report only:
   first-query seconds and the warm Count(Intersect) p50/p90 over HTTP
   through node 1 against one node holding every slice, the failover
   and rejoin seconds. Every answer against numpy.

The result memos and the response cache are off
(``PILOSA_TPU_RESULT_MEMO=0``) but in phase 8c's warm repeats, so the
phases time execution; the coalescer is on (the card's default) and a
lone query passes its tick alone. The container tier is on (its
default): a Count whose every row leaf is sparse (at most 4,096 bits)
on every slice of fragments not faulted in stages no dense stack when
it is a bare leaf or a two-operand node: it takes the container lanes.
A deeper tree stays batched (from the tier it would run a launch a slice
a node). Phase 7 prints the route of its windows and times the 14-view
Count with the tier off too, phase 8c the route of its
Count(Intersect(row 3, row 3)).

Every open is lazy (no fragment file is read until a query touches
it); each phase prints its open and first-query seconds. The serial
path of phases 4-7 runs over the first 128 slices (the batched path
and the top-level bare ``Bitmap`` over all of them), so that the script
stays inside its 1,200 s limit (PERF.md §5 has the measured total).
``--event-slices`` and ``--sparse-slices`` set phase 7's and phase
10's slice counts and ``--only`` runs a subset of phases 4-12 (no phase
3 and no result lines): all are for measurements, and the contract run
takes none.

Each of phases 4-12 prints its launches per kernel and, for
``count_op_rows``, ``count_rows`` and ``count_and_rows``, per regime; a
line after them sums the regimes over the phases. The second-to-last
line is a JSON object describing every kernel; the last is ``{"ok":
true, "device": {...}}``. The script exits non-zero
without a GPU, and where the pilosa_tpu_torch package is not beside it.
"""
import argparse
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tarfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_SLICES = 9537          # 10.0B columns at 2^20 columns per slice
WORDS32 = 32768             # int32 words per slice row
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
# Integer rates of one H100 SXM: 132 SMs at 1.98 GHz (the clock behind
# its 67 TFLOP/s fp32 figure), each SM issuing per clock 64 32-bit logic
# ops or adds and 16 population counts (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0).
INT_OPS_PER_S = 132 * 64 * 1.98e9    # and/or/xor/andnot/add
POPC_PER_S = 132 * 16 * 1.98e9       # popcount
OPS = ("and", "or", "xor", "andnot")
DEVICE = "cuda"
TOPN_CANDIDATES = 8         # rows of frame t, the candidates of every TopN
# Slices of the serial loops of phases 4-7. reduced: 128, not 1,024 (nor
# every slice): at 512 the script with phase 11 took 1,162.7 s of its
# 1,200 s limit on a slower H100 host, and at 256 with phase 12 1,090.4 s
# on another (PERF.md §4).
SERIAL_SLICES = 128
WINDOW_BUCKETS = (128, 512, 2048, 8192, 32768)  # batched stack widths
GOVERNOR_BYTES = 256 << 20  # phase 4's host budget on its reopen
GOVERNED_SLICES = 512       # slices of its serial TopN and bitmap read
GOVERNED_BATCH = 2048       # slices of its batched Count and TopN
# Slices of phase 7. reduced: at 9,537 slices (17 views, 162,129
# fragment files) the phase alone took 600.4 s on an H100 machine
# (writes 191.2 s, the first 14-view Count 240.4 s), and at 4,096 slices
# it carried the whole script past its 1,200 s limit on a slower host,
# and at 1,024 slices (107.4 s of the phase) the script with phase 11
# took 1,162.7 s on a slower host, and at 512 (52.0 s) the script with
# phase 12 1,090.4 s on another, and at 256 (26.6 s) the script 1,084.7 s
# before phase 12's steps (g)-(j) added ~50 s, so the event-analytics
# example runs at 128 slices (0.13B columns; PERF.md §4).
EVENT_SLICES = 128
# Slices of phase 10. reduced: count100b's shape is 95,368 slices (100B
# columns); at 9,537 the phase took 82.4 s and the whole script 942.7 s
# on a slower H100 host (PERF.md §4), too near the 1,200 s limit.
SPARSE_SLICES = 4096
CHEM_ROWS = 500_000         # phase 9's molecules
CHEM_FAMILY = 100           # molecules per scaffold
FRAG_FORM_ROWS = 524_288    # count_and_rows's fragment form in phase 3
GROUP_PAIRS = 8             # members of a fused group (phases 3 and 8c)
# The kernels a single query launches; the coalescer's groups (8c) add
# count_op_pairs and count_and_rows_multi.
QUERY_KERNELS = ("count_op_rows", "count_rows", "count_and_rows")
# Boundary widths and row counts of phase 3's regime checks; the widths
# and row counts on both sides of each regime threshold of the CUDA
# sources (kernels.thresholds()) join them at run time.
EDGE_WIDTHS = (1, 3, 4, 5, 127, 128, 129, 2047, 2048, 2049, WORDS32)
EDGE_ROWS = (1, 2, 7, 8, 9, 11, 262_144)
# Device time is taken over inputs that exceed the L2 cache this many
# times over (copies cycled through by a CUDA graph), so that each launch
# reads device memory, as a query after other work does; at most
# COLD_MAX_COPIES copies, so a graph of one-row launches stays small.
L2_BYTES = 50 << 20
COLD_FACTOR = 4
COLD_MAX_COPIES = 256


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def reset_peak():
    import torch

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes():
    import torch

    return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0


def timed_ms(fn, reps, warm=2):
    """Mean ms per call by CUDA events over ``reps`` warm calls from the
    host: where a call's host work outlasts its kernel, the host's."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _captured(fn):
    """A CUDA graph of one call of ``fn()``, after a first call on a side
    stream (as capture needs)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def graph_ms(fn, reps=20, replays=5):
    """Mean device ms per call by CUDA events over ``replays`` replays of
    a CUDA graph of ``reps`` calls: the launches back to back, with no
    host work between them."""
    import torch

    graph = _captured(lambda: [fn() for _ in range(reps)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def cold_ms(fn, *args, reps=20):
    """Device ms per launch of ``fn(*args)`` (args: tensors or lists of
    them) by graph_ms over ``args`` and clones of it, cycled, enough
    that their bytes exceed COLD_FACTOR times the L2 cache, up to
    COLD_MAX_COPIES copies: below ~800 KB a call the copies fit in L2,
    and the time is that of launches back to back on warm inputs
    (one_ms times a lone launch on cold ones)."""
    import itertools
    import math

    flat = [t for a in args for t in (a if isinstance(a, list) else [a])]
    nbytes = sum(t.numel() * t.element_size() for t in flat)
    copies = min(COLD_MAX_COPIES,
                 max(1, math.ceil(COLD_FACTOR * L2_BYTES / nbytes)))
    sets = [args] + [tuple([t.clone() for t in a] if isinstance(a, list)
                           else a.clone() for a in args)
                     for _ in range(copies - 1)]
    cycle = itertools.cycle(sets)
    return graph_ms(lambda: fn(*next(cycle)),
                    reps=copies * math.ceil(reps / copies), replays=3)


def one_ms(fn, *args, reps=50):
    """Device ms of one launch of ``fn(*args)`` alone on an idle stream,
    its inputs first evicted from L2 by a write of twice the cache's
    bytes: CUDA events around the replay of a one-call CUDA graph, the
    median over ``reps``. A serial caller's wait on the device a launch,
    its host work aside."""
    import torch

    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32, device=DEVICE)
    graph = _captured(lambda: fn(*args))
    pairs = []
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del graph, flush
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def sync_ms(fn, reps=200, warm=5):
    """Host ms per call of ``fn()`` followed by torch.cuda.synchronize(),
    warm inputs: what a serial caller pays a launch, the wrapper's host
    work, the launch and the wait included."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def ops_ms(popcounts, alu_ops):
    """Least time for ``popcounts`` population counts and ``alu_ops``
    32-bit logic ops and adds, each at its own peak rate."""
    return max(popcounts / POPC_PER_S, alu_ops / INT_OPS_PER_S) * 1e3


def bound_ms(rows, width, operands):
    """Least time for a count over [rows, width] words: each input word
    read once and one int32 per row written, against one logic op (none
    for a single operand), one popcount and one add per word."""
    nbytes = operands * rows * width * 4 + rows * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(rows * width, operands * rows * width)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def and_rows_bound_ms(rows, slices, width):
    """Least time for count_and_rows over ``rows`` candidate stacks of
    [slices, width] words against one filter stack: each candidate and
    filter word read once, one int32 per (row, slice) written, against
    an and, a popcount and an add per candidate word."""
    nbytes = (rows + 1) * slices * width * 4 + rows * slices * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(rows * slices * width, 2 * rows * slices * width)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def multi_bound_ms(rows, filts, slices, width):
    """Least time for count_and_rows_multi over ``rows`` row stacks and
    ``filts`` filter stacks of [slices, width] words: each stack read
    once, one int32 per (filter, row, slice) written, against an and, a
    popcount and an add per (filter, row) word pair."""
    nbytes = (rows + filts) * slices * width * 4 + filts * rows * slices * 4
    words = filts * rows * slices * width
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(words, 2 * words)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def launch_counts():
    """The launches since the last reset: per kernel, and under
    ``"regimes"`` those of count_op_rows, count_rows and count_and_rows
    per regime."""
    from pilosa_tpu_torch.ops import kernels

    counts = dict(kernels.launches)
    counts["regimes"] = {name: dict(split) for name, split
                         in kernels.regime_launches.items()}
    counts["container_forms"] = dict(kernels.container_forms)
    return counts


def add_counts(x, y):
    """Two launch_counts() added."""
    total = {k: x[k] + y[k] for k in x
             if k not in ("regimes", "container_forms")}
    total["container_forms"] = {f: n + y["container_forms"][f] for f, n
                                in x["container_forms"].items()}
    total["regimes"] = {name: {r: n + y["regimes"][name][r]
                               for r, n in split.items()}
                        for name, split in x["regimes"].items()}
    return total


def in_processes(worker, frag_dir, seed, slices):
    """``worker(frag_dir, seed, lo, hi)`` over 64 runs of slices in up
    to 8 spawned processes; returns (processes, results in slice
    order)."""
    procs = max(1, min(8, os.cpu_count() or 1))
    edges = np.linspace(0, slices, procs * 8 + 1).astype(int)
    jobs = [(frag_dir, seed, int(lo), int(hi))
            for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        return procs, pool.starmap(worker, jobs)


# ------------------------------------------------------------ phase 3

def regime_checks(rand, note):
    """count_op_rows/count_rows and count_and_rows against their plain
    versions in every regime of their CUDA sources, each case in the
    regime the source names for its shape (kernels.regime): every width
    of EDGE_WIDTHS and both sides of each width threshold at every row
    count of EDGE_ROWS and both sides of the row threshold (the serial
    path's 1-D rows too), both sides of count_and_rows's own thresholds,
    one operand off 16-byte alignment, bit-31 and all-ones words (counts
    of 32·W), and the stacked form past one parameter table of 256 rows.
    Returns the number of cases."""
    import math

    import torch

    from pilosa_tpu_torch.ops import kernels

    th = kernels.thresholds()
    op_t, car_t = th["count_op_rows"], th["count_and_rows"]
    nm, sm = op_t["narrow_max_words"], op_t["split_min_words"]
    cn, ci = car_t["narrow_max_words"], car_t["split_items"]
    cm, csm = car_t["narrow_min_rows"], car_t["split_min_words"]
    rb = car_t["rows_per_item"]
    widths = sorted(set(EDGE_WIDTHS) | {nm - 1, nm, nm + 1, cn - 1, cn,
                                        cn + 1, sm, sm + 1, csm, csm + 1})
    row_counts = sorted(set(EDGE_ROWS) | {
        op_t["split_rows"] - 1, op_t["split_rows"],
        op_t["narrow_min_rows"] - 1, op_t["narrow_min_rows"], cm - 1, cm})
    hit = {name: set() for name in kernels.regime_launches}

    def took(name, want, fn, what):
        before = dict(kernels.regime_launches[name])
        got = fn()
        new = {r for r, n in kernels.regime_launches[name].items()
               if n > before[r]}
        check(new == want, f"{name} at {what} took regimes {sorted(new)}, "
              f"not {sorted(want)}")
        hit[name] |= new
        return got

    def op_case(a, b, what):
        want = {kernels.regime("count_op_rows", math.prod(a.shape[:-1]),
                               a.shape[-1])}
        for op in OPS:
            note("count_op_rows", took(
                "count_op_rows", want,
                lambda: kernels.count_op_rows(a, b, op), what),
                kernels.count_op_rows_plain(a, b, op), f"{what} op {op}")
        note("count_rows", took("count_rows", want,
                                lambda: kernels.count_rows(a), what),
             kernels.count_rows_plain(a), what)

    def frag_case(m, f, what):
        want = {kernels.regime("count_and_rows", m.shape[0], m.shape[1])}
        note("count_and_rows", took("count_and_rows", want,
                                    lambda: kernels.count_and_rows(m, f),
                                    what),
             kernels.count_and_rows_plain(m, f), what)

    def stack_case(rows, f, what):
        want = {kernels.regime("count_and_rows",
                               min(kernels.CAR_MAX_ROWS, len(rows) - r0),
                               f.shape[1], f.shape[0])
                for r0 in range(0, len(rows), kernels.CAR_MAX_ROWS)}
        note("count_and_rows", took(
            "count_and_rows", want,
            lambda: kernels.count_and_rows_stacks(rows, f), what),
            kernels.count_and_rows_stacks_plain(rows, f), what)

    def off(r, w, k=1):
        """[r, w] words starting k words past a 16-byte boundary."""
        return rand(r * w + k)[k:].view(r, w)

    cases = 0
    for w in widths:
        op_case(rand(w), rand(w), f"[{w}] (1-D)")
        cases += 1
        for r in row_counts:
            if r * w > 600_000_000:  # [262144, 32768]: 34 GB an operand
                continue
            a, b = rand(r, w), rand(r, w)
            op_case(a, b, f"[{r}, {w}]")
            frag_case(a, b[0], f"[{r}, {w}] & [{w}]")
            cases += 2
    del a, b
    # count_and_rows's own thresholds: the split width on both sides, and
    # rows of one slice at one item under and at the split threshold,
    # just past the split width; both sides of the narrow (row, slice)
    # minimum; the narrow items' chunk of rows, cut to fill the card and
    # whole.
    for r, w in ((rb * (ci - 1), csm + 1), (rb * (ci - 1) + 1, csm + 1),
                 (rb, csm), (rb, csm + 1), (cm - 1, 128), (cm, 128),
                 (9537, 256), (2105, 2 * cn + 1)):
        frag_case(rand(r, w), rand(w), f"[{r}, {w}] & [{w}]")
        cases += 1
    for r, sl, w in ((rb, ci - 1, 2 * csm), (rb, ci, 2 * csm),
                     (300, 3, 128), (300, 1, WORDS32), (300, 30, 2 * csm),
                     (9, 2000, cn), (9, 2000, cn + 1), (11, 1, WORDS32),
                     (1, ci - 1, csm + 1), (1, ci, csm + 1),
                     (1, cm - 1, 128), (1, cm, 128)):
        stack_case([rand(sl, w) for _ in range(r)], rand(sl, w),
                   f"{r} stacks x [{sl}, {w}]")
        cases += 1
    # One operand off 16-byte alignment, in each regime.
    for r, w in ((9, 128), (7, 130), (9000, 130), (1, WORDS32),
                 (300, 4096), (2105, 1025)):
        op_case(off(r, w), rand(r, w), f"[{r}, {w}], a 1 word off")
        op_case(rand(r, w), off(r, w, 2), f"[{r}, {w}], b 2 words off")
        frag_case(off(r, w), rand(w), f"[{r}, {w}] 1 word off & [{w}]")
        frag_case(rand(r, w), rand(w + 3)[3:], f"[{r}, {w}] & [{w}] 3 off")
        cases += 4
    for sl, w in ((37, 128), (500, 128), (7, 4096), (64, 4096)):
        stack_case([off(sl, w, k % 4) for k in range(9)], rand(sl, w),
                   f"9 stacks x [{sl}, {w}], k words off")
        cases += 1
    # Bit 31 and all-ones words, in each regime: an all-ones row against
    # an all-ones filter counts 32·W.
    for fill in (-2**31, -1):
        for r, w in ((9, 128), (5000, 128), (1, WORDS32), (300, 4096),
                     (2105, 1025), (11, WORDS32)):
            m = torch.full((r, w), fill, dtype=torch.int32, device=DEVICE)
            ones = torch.full((w,), -1, dtype=torch.int32, device=DEVICE)
            op_case(m, rand(r, w), f"[{r}, {w}] fill {fill}")
            frag_case(m, ones, f"[{r}, {w}] fill {fill} & all-ones")
            stack_case([m, m], ones.expand(r, w).contiguous(),
                       f"2 stacks [{r}, {w}] fill {fill} & all-ones")
            if fill == -1:
                check(bool((kernels.count_rows(m) == 32 * w).all()),
                      f"count_rows [{r}, {w}] all-ones != {32 * w}")
                check(bool((kernels.count_and_rows(m, ones)
                            == 32 * w).all()),
                      f"count_and_rows [{r}, {w}] all-ones != {32 * w}")
            cases += 3
    del m, ones
    for name, regimes in hit.items():
        check(regimes == set(kernels.REGIMES),
              f"{name}: the boundary cases took regimes {sorted(regimes)} "
              f"only")
    return cases


def kernel_checks(slices, card):
    """Each kernel equal to its plain version; timings at the main
    shape. Returns {kernel name: stats}."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    gen = torch.Generator(device=DEVICE).manual_seed(1234)

    def rand(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             device=DEVICE, generator=gen)

    max_err = {"count_op_rows": 0, "count_rows": 0, "count_and_rows": 0,
               "count_op_pairs": 0, "count_and_rows_multi": 0}

    def note(name, got, want, what):
        check(torch.equal(got, want), f"{name} != plain at {what}")
        if got.numel():
            max_err[name] = max(max_err[name], int(
                (got.long() - want.long()).abs().max()))

    def compare(a, b):
        for op in OPS:
            note("count_op_rows", kernels.count_op_rows(a, b, op),
                 kernels.count_op_rows_plain(a, b, op),
                 f"{tuple(a.shape)} op {op}")
        note("count_rows", kernels.count_rows(a), kernels.count_rows_plain(a),
             tuple(a.shape))

    cases = 0
    for s in (1, 7):
        for w in (1, 3, 192, 32767):
            compare(rand(s, w), rand(s, w))
            cases += 1
    for fill in (0, -1, -2**31):  # all-zero, all-one, bit-31 rows
        m = torch.full((7, WORDS32), fill, dtype=torch.int32, device=DEVICE)
        compare(m, rand(7, WORDS32))
        cases += 1
    compare(rand(WORDS32), rand(WORDS32))                # 1-D row
    base = rand(7 * 100 + 3)                             # misaligned
    compare(base[1:701].view(7, 100), base[3:703].view(7, 100))
    cases += 2

    # count_and_rows, fragment form: R rows of W words against one row.
    for r in (1, 7, 8, 1000):
        for w in (1, 3, 192, 32767, WORDS32):
            m, f = rand(r, w), rand(w)
            note("count_and_rows", kernels.count_and_rows(m, f),
                 kernels.count_and_rows_plain(m, f), f"[{r}, {w}]")
            cases += 1
    for fill in (0, -1, -2**31):  # all-zero, all-one, bit-31 rows
        m = torch.full((9, WORDS32), fill, dtype=torch.int32, device=DEVICE)
        f = rand(WORDS32)
        note("count_and_rows", kernels.count_and_rows(m, f),
             kernels.count_and_rows_plain(m, f), f"fill {fill}")
        note("count_and_rows", kernels.count_and_rows(f[None].repeat(3, 1),
                                                      m[0]),
             kernels.count_and_rows_plain(f[None].repeat(3, 1), m[0]),
             f"filter fill {fill}")
        cases += 2
    base = rand(4009)                                     # one word off
    m, f = base[1:3001].view(3, 1000), base[3002:4002]
    note("count_and_rows", kernels.count_and_rows(m, f),
         kernels.count_and_rows_plain(m, f), "misaligned rows")
    stk = [base[1:2001].view(2, 1000), base[4:2004].view(2, 1000)]
    note("count_and_rows", kernels.count_and_rows_stacks(stk, base[2005:4005]
                                                         .view(2, 1000)),
         kernels.count_and_rows_stacks_plain(stk, base[2005:4005]
                                             .view(2, 1000)),
         "misaligned stacks")
    f = rand(1, WORDS32)                                 # R = 0, S = 1
    note("count_and_rows", kernels.count_and_rows_stacks([], f),
         kernels.count_and_rows_stacks_plain([], f), "R = 0")
    stk = [rand(1, WORDS32) for _ in range(300)]         # 2 launches
    note("count_and_rows", kernels.count_and_rows_stacks(stk, f),
         kernels.count_and_rows_stacks_plain(stk, f), "S = 1, R = 300")
    cases += 4
    del m, f, base, stk

    # The group kernels at the edges: K = 1 and 257 (two launches),
    # every op and none, rows and filters off 16-byte alignment.
    for k in (1, 257):
        pa = [rand(3, 77) for _ in range(k)]
        pb = [rand(3, 77) for _ in range(k)]
        for op in (None,) + OPS:
            note("count_op_pairs", kernels.count_op_pairs(pa, pb, op),
                 kernels.count_op_pairs_plain(pa, pb, op),
                 f"K = {k} x [3, 77] op {op}")
        note("count_and_rows_multi", kernels.count_and_rows_multi(pa[:11],
                                                                  pb),
             kernels.count_and_rows_multi_plain(pa[:11], pb),
             f"R = {min(k, 11)}, K = {k} x [3, 77]")
        cases += 2
    base = rand(6 * 2 * 999 + 8)
    stk = [base[i * 1998 + i:(i + 1) * 1998 + i].view(2, 999)
           for i in range(6)]
    note("count_op_pairs", kernels.count_op_pairs(stk[:3], stk[3:], "xor"),
         kernels.count_op_pairs_plain(stk[:3], stk[3:], "xor"),
         "misaligned pairs")
    note("count_and_rows_multi", kernels.count_and_rows_multi(stk[:4],
                                                              stk[4:]),
         kernels.count_and_rows_multi_plain(stk[:4], stk[4:]),
         "misaligned rows and filters")
    for fill in (0, -1, -2**31):
        m = torch.full((5, 4097), fill, dtype=torch.int32, device=DEVICE)
        r = rand(5, 4097)
        note("count_op_pairs", kernels.count_op_pairs([m, r], [r, m], "or"),
             kernels.count_op_pairs_plain([m, r], [r, m], "or"),
             f"fill {fill}")
        note("count_and_rows_multi",
             kernels.count_and_rows_multi([m, r], [r, m]),
             kernels.count_and_rows_multi_plain([m, r], [r, m]),
             f"fill {fill}")
    cases += 8
    del pa, pb, base, stk, m, r
    n = regime_checks(rand, note)
    cases += n
    sync()
    print(f"regimes: {n} boundary cases exact, each in the regime its "
          f"thresholds name, all three regimes of each kernel taken; "
          f"max_abs_err {max_err} {card}")

    # The launch floor: an empty kernel, timed as the count kernels are,
    # from the host (each call's Python and ctypes work included) and
    # replayed from a CUDA graph (the device's time alone).
    import ctypes

    from pilosa_tpu_torch.ops import loader

    empty_fn = loader.library("popcount").pilosa_empty_launch
    empty_fn.argtypes = [ctypes.c_void_p]
    empty_fn.restype = ctypes.c_int

    def empty():
        check(empty_fn(torch.cuda.current_stream().cuda_stream) == 0,
              "empty launch failed")

    floor = (timed_ms(empty, reps=200), graph_ms(empty, reps=200),
             one_ms(empty), sync_ms(empty))
    print(f"launch floor: empty kernel {floor[0]:.4f} ms a call from the "
          f"host, {floor[1]:.4f} ms a launch from a CUDA graph, "
          f"{floor[2]:.4f} ms a lone launch, {floor[3]:.4f} ms a call and "
          f"synchronize {card}")

    def regime_of(name, fn):
        before = dict(kernels.regime_launches[name])
        fn()
        return "+".join(r for r, c in kernels.regime_launches[name].items()
                        if c > before[r])

    def and_rows_op(x, y):
        return kernels.count_op_rows(x, y, "and")

    def and_pairs(x, y):
        return kernels.count_op_pairs(x, y, "and")

    # The column-window buckets of the batched plans: every kernel at
    # [slices, W] for each width W, timed against its bound, a call from
    # the host (warm inputs, host work included) and a launch on cold
    # inputs from a CUDA graph (the device's time); count_op_pairs over
    # GROUP_PAIRS distinct pairs.
    buckets = []
    for w in WINDOW_BUCKETS:
        a, b = rand(slices, w), rand(slices, w)
        compare(a, b)
        cands = [rand(slices, w) for _ in range(TOPN_CANDIDATES)]
        others = [rand(slices, w) for _ in range(GROUP_PAIRS)]
        note("count_and_rows", kernels.count_and_rows_stacks(cands, a),
             kernels.count_and_rows_stacks_plain(cands, a),
             f"{TOPN_CANDIDATES} x [{slices}, {w}]")
        note("count_op_pairs", kernels.count_op_pairs(cands, others, "and"),
             kernels.count_op_pairs_plain(cands, others, "and"),
             f"{GROUP_PAIRS} pairs x [{slices}, {w}]")
        cases += 3
        row = {"width": w, "regime": {}}
        for name, fn, args, bound in (
                ("count_op_rows", and_rows_op, (a, b),
                 bound_ms(slices, w, 2)),
                ("count_rows", kernels.count_rows, (a,),
                 bound_ms(slices, w, 1)),
                ("count_and_rows", kernels.count_and_rows_stacks, (cands, a),
                 and_rows_bound_ms(TOPN_CANDIDATES, slices, w)),
                ("count_op_pairs", and_pairs, (cands, others),
                 bound_ms(GROUP_PAIRS * slices, w, 2))):
            if name in kernels.regime_launches:
                row["regime"][name] = regime_of(name, lambda: fn(*args))
            row[name] = (timed_ms(lambda: fn(*args), reps=20),
                         cold_ms(fn, *args), bound[0])
        buckets.append(row)
        del a, b, cands, others
    for row in buckets:
        print(f"window bucket [{slices}, {row['width']}]: " + "; ".join(
            f"{n} ({row['regime'].get(n, 'full')}) {row[n][0]:.4f} ms a "
            f"call, {row[n][1]:.4f} ms device (bound {row[n][2]:.4f}, "
            f"{row[n][2] / row[n][1]:.1%} of it device)"
            for n in ("count_op_rows", "count_rows", "count_and_rows",
                      "count_op_pairs"))
            + f" (count_and_rows: {TOPN_CANDIDATES} stacks; count_op_pairs:"
              f" {GROUP_PAIRS} pairs; launch floor {floor[0]:.4f} ms a "
              f"call, {floor[1]:.4f} device) {card}")

    # count_and_rows's fragment form: one strided launch for every row
    # of a narrow fragment matrix (the chemical-similarity TopN's shape).
    m, f = rand(FRAG_FORM_ROWS, 128), rand(128)
    before = kernels.launches["count_and_rows"]
    got = kernels.count_and_rows(m, f)
    check(kernels.launches["count_and_rows"] - before == 1,
          f"count_and_rows fragment form at [{FRAG_FORM_ROWS}, 128]: "
          f"{kernels.launches['count_and_rows'] - before} launches, not 1")
    note("count_and_rows", got, kernels.count_and_rows_plain(m, f),
         f"fragment form [{FRAG_FORM_ROWS}, 128]")
    cases += 1
    frag_ms = timed_ms(lambda: kernels.count_and_rows(m, f), reps=20)
    frag_dev = cold_ms(kernels.count_and_rows, m, f)
    frag_plain = timed_ms(lambda: kernels.count_and_rows_plain(m, f),
                          reps=5, warm=1)
    frag_bound, by, nbytes = and_rows_bound_ms(FRAG_FORM_ROWS, 1, 128)
    print(f"count_and_rows fragment form [{FRAG_FORM_ROWS}, 128] & [128] "
          f"({regime_of('count_and_rows', lambda: kernels.count_and_rows(m, f))}"
          f"): 1 launch, {frag_ms:.4f} ms a call, {frag_dev:.4f} ms device, "
          f"plain version {frag_plain:.4f} ms, bytes {nbytes}, bound "
          f"{frag_bound:.4f} ms ({by}), {frag_bound / frag_dev:.1%} of "
          f"bound device; launch floor {floor[1]:.4f} ms device {card}")
    del m, f, got

    # The serial path's shapes: one launch a slice on a 1-D row (Count's
    # Bitmap.op_count), and the fragment form at S = 1 with 8 rows (TopN
    # with a Src) or 11 (Sum's planes and not-null row). Each timed as
    # the buckets are, as a lone launch on cold inputs (one_ms, what the
    # serial path waits for on the device) and as a call and synchronize
    # (what it pays a slice).
    a1, b1 = rand(WORDS32), rand(WORDS32)
    a128, b128 = rand(128), rand(128)
    m8, m11, f1 = rand(8, WORDS32), rand(11, WORDS32), rand(WORDS32)
    plain = {"count_op_rows": lambda x, y: kernels.count_op_rows_plain(
                 x, y, "and"),
             "count_rows": kernels.count_rows_plain,
             "count_and_rows": kernels.count_and_rows_plain}
    for label, name, fn, args, bound in (
            (f"count_op_rows[and] [1, {WORDS32}]", "count_op_rows",
             and_rows_op, (a1, b1), bound_ms(1, WORDS32, 2)[0]),
            (f"count_rows [1, {WORDS32}]", "count_rows", kernels.count_rows,
             (a1,), bound_ms(1, WORDS32, 1)[0]),
            ("count_op_rows[and] [1, 128]", "count_op_rows", and_rows_op,
             (a128, b128), bound_ms(1, 128, 2)[0]),
            ("count_rows [1, 128]", "count_rows", kernels.count_rows,
             (a128,), bound_ms(1, 128, 1)[0]),
            (f"count_and_rows [8, {WORDS32}] & [{WORDS32}]", "count_and_rows",
             kernels.count_and_rows, (m8, f1),
             and_rows_bound_ms(8, 1, WORDS32)[0]),
            (f"count_and_rows [11, {WORDS32}] & [{WORDS32}]",
             "count_and_rows", kernels.count_and_rows, (m11, f1),
             and_rows_bound_ms(11, 1, WORDS32)[0])):
        note(name, fn(*args), plain[name](*args), label)
        cases += 1
        call = timed_ms(lambda: fn(*args), reps=200)
        dev = cold_ms(fn, *args, reps=100)
        lone = one_ms(fn, *args)
        waited = sync_ms(lambda: fn(*args))
        print(f"serial shape {label} ({regime_of(name, lambda: fn(*args))}):"
              f" {lone:.4f} ms a lone launch on cold inputs, {waited:.4f} "
              f"ms a call and synchronize, {dev:.4f} ms a launch back to "
              f"back, {call:.4f} ms a call; bound {bound:.4f} ms; launch "
              f"floor {floor[2]:.4f} ms lone, {floor[3]:.4f} call and "
              f"synchronize; lone / (floor + bound) "
              f"{lone / (floor[2] + bound):.2f} {card}")
    del a1, b1, a128, b128, m8, m11, f1

    a, b = rand(slices, WORDS32), rand(slices, WORDS32)
    compare(a, b)
    cands = [rand(slices, WORDS32) for _ in range(TOPN_CANDIDATES)]
    note("count_and_rows", kernels.count_and_rows_stacks(cands, a),
         kernels.count_and_rows_stacks_plain(cands, a),
         f"{TOPN_CANDIDATES} x [{slices}, {WORDS32}]")
    # The BSI shapes: 10 plane stacks, and the batched Sum's 11 (the
    # planes and the not-null row), against one filter stack.
    bsi_rows = cands + [b, rand(slices, WORDS32), rand(slices, WORDS32)]
    for r in (STARS_DEPTH, STARS_DEPTH + 1):
        note("count_and_rows", kernels.count_and_rows_stacks(bsi_rows[:r], a),
             kernels.count_and_rows_stacks_plain(bsi_rows[:r], a),
             f"{r} x [{slices}, {WORDS32}]")
    cases += 4
    sync()
    print(f"kernels: {cases} shapes exact against the plain versions "
          f"(incl. [{slices}, {WORDS32}] and {TOPN_CANDIDATES}, "
          f"{STARS_DEPTH} and {STARS_DEPTH + 1} stacks of it, every window "
          f"bucket {WINDOW_BUCKETS} and the fragment form); max_abs_err "
          f"{max_err} {card}")

    stats = {}
    for op in OPS:
        ms = timed_ms(lambda: kernels.count_op_rows(a, b, op), reps=20)
        bms, _, nbytes = bound_ms(slices, WORDS32, 2)
        print(f"count_op_rows[{op}] [{slices}, {WORDS32}]: {ms:.4f} ms, "
              f"reads {nbytes / 1e9:.3f} GB, bound {bms:.4f} ms, "
              f"{bms / ms:.1%} of bound {card}")
        if op == "and":
            stats["count_op_rows"] = {"ms": ms}
    stats["count_op_rows"]["plain_ms"] = timed_ms(
        lambda: kernels.count_op_rows_plain(a, b, "and"), reps=3, warm=1)
    stats["count_rows"] = {
        "ms": timed_ms(lambda: kernels.count_rows(a), reps=20),
        "plain_ms": timed_ms(lambda: kernels.count_rows_plain(a), reps=3,
                             warm=1)}
    stats["count_and_rows"] = {
        "ms": timed_ms(lambda: kernels.count_and_rows_stacks(cands, a),
                       reps=20),
        "plain_ms": timed_ms(
            lambda: kernels.count_and_rows_stacks_plain(cands, a), reps=2,
            warm=1)}
    per_op_ms = timed_ms(lambda: [kernels.count_op_rows(c, a, "and")
                                  for c in cands], reps=10)
    for name, operands in (("count_op_rows", 2), ("count_rows", 1),
                           ("count_and_rows", None)):
        st = stats[name]
        shape = f"[{slices}, {WORDS32}]"
        if operands is None:
            st["bound_ms"], st["bound_by"], st["bytes"] = and_rows_bound_ms(
                TOPN_CANDIDATES, slices, WORDS32)
            shape = f"{TOPN_CANDIDATES} stacks x {shape} & {shape}"
        else:
            st["bound_ms"], st["bound_by"], st["bytes"] = bound_ms(
                slices, WORDS32, operands)
        st["max_abs_err"] = max_err[name]
        print(f"{name} {shape}: kernel {st['ms']:.4f} ms, "
              f"plain version {st['plain_ms']:.4f} ms, bytes "
              f"{st['bytes']}, bound {st['bound_ms']:.4f} ms "
              f"({st['bound_by']}), {st['bound_ms'] / st['ms']:.1%} of "
              f"bound; library call: none: no single PyTorch call (torch "
              f"has no popcount op) {card}")
    car_ms = stats["count_and_rows"]["ms"]
    print(f"count_and_rows vs {TOPN_CANDIDATES} count_op_rows[and] "
          f"launches on the same data: {car_ms:.4f} ms vs {per_op_ms:.4f} "
          f"ms ({per_op_ms / car_ms:.2f}x) {card}")
    sum_rows = bsi_rows[:STARS_DEPTH + 1]
    sum_ms = timed_ms(lambda: kernels.count_and_rows_stacks(sum_rows, a),
                      reps=10)
    sum_bound, by, nbytes = and_rows_bound_ms(len(sum_rows), slices, WORDS32)
    print(f"count_and_rows at the batched Sum's shape, {len(sum_rows)} "
          f"stacks x [{slices}, {WORDS32}] & [{slices}, {WORDS32}]: "
          f"{sum_ms:.4f} ms, bytes {nbytes}, bound {sum_bound:.4f} ms "
          f"({by}), {sum_bound / sum_ms:.1%} of bound {card}")
    del a, b, cands, bsi_rows, sum_rows
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # The coalescer's group kernels at the main shape: count_op_pairs over
    # GROUP_PAIRS distinct pairs (a fused Count group), then
    # count_and_rows_multi with the BSI field's STARS_DEPTH + 1 stacks
    # (its planes and its not-null row) as rows against GROUP_PAIRS
    # filters (a fused Sum group).
    left = [rand(slices, WORDS32) for _ in range(GROUP_PAIRS)]
    right = [rand(slices, WORDS32) for _ in range(GROUP_PAIRS)]
    note("count_op_pairs", kernels.count_op_pairs(left, right, "and"),
         kernels.count_op_pairs_plain(left, right, "and"),
         f"{GROUP_PAIRS} pairs x [{slices}, {WORDS32}]")
    st = stats["count_op_pairs"] = {
        "ms": timed_ms(lambda: kernels.count_op_pairs(left, right, "and"),
                       reps=10),
        "plain_ms": timed_ms(lambda: kernels.count_op_pairs_plain(
            left, right, "and"), reps=1, warm=1)}
    st["bound_ms"], st["bound_by"], st["bytes"] = bound_ms(
        GROUP_PAIRS * slices, WORDS32, 2)
    st["popc_ms"] = GROUP_PAIRS * slices * WORDS32 / POPC_PER_S * 1e3
    singles_ms = timed_ms(lambda: [kernels.count_op_rows(x, y, "and")
                                   for x, y in zip(left, right)], reps=5)
    extra = STARS_DEPTH + 1 - GROUP_PAIRS
    rows = left + right[:extra]
    filts = right[extra:] + [rand(slices, WORDS32) for _ in range(extra)]
    note("count_and_rows_multi", kernels.count_and_rows_multi(rows, filts),
         kernels.count_and_rows_multi_plain(rows, filts),
         f"R = {len(rows)}, K = {len(filts)} x [{slices}, {WORDS32}]")
    st = stats["count_and_rows_multi"] = {
        "ms": timed_ms(lambda: kernels.count_and_rows_multi(rows, filts),
                       reps=10),
        "plain_ms": timed_ms(lambda: kernels.count_and_rows_multi_plain(
            rows, filts), reps=1, warm=0)}
    st["bound_ms"], st["bound_by"], st["bytes"] = multi_bound_ms(
        len(rows), len(filts), slices, WORDS32)
    st["popc_ms"] = (len(rows) * len(filts) * slices * WORDS32
                     / POPC_PER_S * 1e3)
    per_filter_ms = timed_ms(lambda: [kernels.count_and_rows_stacks(rows, f)
                                      for f in filts], reps=3)
    cases += 2
    for name, shape in (
            ("count_op_pairs", f"{GROUP_PAIRS} pairs of [{slices}, "
                               f"{WORDS32}]"),
            ("count_and_rows_multi", f"R = {len(rows)} stacks, K = "
                                     f"{len(filts)} filters of [{slices}, "
                                     f"{WORDS32}]")):
        st = stats[name]
        st["max_abs_err"] = max_err[name]
        print(f"{name} {shape}: kernel {st['ms']:.4f} ms, plain version "
              f"{st['plain_ms']:.4f} ms, bytes {st['bytes']}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}), "
              f"{st['bound_ms'] / st['ms']:.1%} of bound (popcounts alone "
              f"{st['popc_ms']:.4f} ms); library call: none {card}")
    print(f"count_op_pairs vs {GROUP_PAIRS} count_op_rows[and] launches on "
          f"the same pairs: {stats['count_op_pairs']['ms']:.4f} ms vs "
          f"{singles_ms:.4f} ms; count_and_rows_multi vs {len(filts)} "
          f"count_and_rows launches (one per filter): "
          f"{stats['count_and_rows_multi']['ms']:.4f} ms vs "
          f"{per_filter_ms:.4f} ms {card}")
    print(f"kernels: {cases} shapes exact in all; max_abs_err {max_err}")
    print("kernels: " + json.dumps(
        [{"name": n, "launches": c} for n, c in kernels.launches.items()]))
    del left, right, rows, filts
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return stats


# The container tier's lane kernel: its cells, a big lane (GROUP_PAIRS
# distinct array x array row pairs over every slice of MAIN_SLICES) and
# the boundary cases of each side.
CONT_CELLS = ("array_array", "array_run", "array_dense", "run_dense")
CONT_LANE_MEMBERS = GROUP_PAIRS * MAIN_SLICES   # 76,296
SECTOR_BYTES = 32   # one gathered word costs the sector it lies in


def cont_side(fmt, n, seed, big=False):
    """n members of one side of container_and_counts at full slice width,
    cycling through the boundary cases of ``fmt`` (a big lane among 64
    rows of 500 spread bits, phase 10's shape): arrays of 0, 1 (bit 31;
    the last bit), 700, 4,096 positions and 4,096 bit-31 positions; runs
    of 2,048 runs, one over the whole row, one across words, none, 2,000
    bits (phase 10's row 3); dense rows of 4,097 bits (a 4,097-bit row
    builds dense), all ones, bit 31 of every word, random, zeros. Members
    share their case's payload. Returns (containers, packed side)."""
    import torch

    from pilosa_tpu_torch.ops import containers as C

    rng = np.random.default_rng(seed)
    limit, w32 = SLICE_COLS, WORDS32

    def spread(k):
        return np.sort(rng.choice(limit, k, replace=False)).astype(np.int32)

    if fmt == "array":
        cases = [np.zeros(0, np.int32), np.array([31], np.int32),
                 np.array([limit - 1], np.int32), spread(700), spread(4096),
                 np.arange(31, limit, 32, dtype=np.int32)[:4096]]
        if big:
            cases += [spread(500) for _ in range(64)]
        conts = [C.Container("array", w32, len(p), positions=p,
                             device=DEVICE)
                 for p in (cases[i % len(cases)] for i in range(n))]
        return conts, C.stack_positions(conts)
    if fmt == "run":
        start = int(rng.integers(0, limit - 3000))
        cases = [np.stack([np.arange(2048) * 6, np.arange(2048) * 6 + 3],
                          axis=1), np.array([[0, limit]]),
                 np.array([[30, 70]]), np.zeros((0, 2)),
                 np.array([[start, start + 2000]])]
        cases = [c.astype(np.int32) for c in cases]
        pick = [cases[i % len(cases)] if not big or i < len(cases)
                else cases[4] for i in range(n)]
        conts = [C.Container("run", w32, int((r[:, 1] - r[:, 0]).sum()),
                             runs=r, device=DEVICE) for r in pick]
        return conts, C.stack_runs(conts)
    bits = np.zeros(limit, np.uint8)
    bits[rng.choice(limit, 4097, replace=False)] = 1
    rows = [np.packbits(bits, bitorder="little").view(np.uint64),
            np.full(limit // 64, np.uint64(2**64 - 1)),
            np.full(limit // 64, np.uint64(0x8000000080000000)),
            rng.integers(0, 2**64, limit // 64, dtype=np.uint64),
            np.zeros(limit // 64, np.uint64)]
    rows = [torch.from_numpy(r.view(np.int32).copy()).to(DEVICE)
            for r in rows]
    conts = [C.dense_container(rows[i % len(rows)], w32, 0)
             for i in range(n)]
    return conts, [c.dense_words() for c in conts]


def cont_bound_ms(cell, a_conts, b_conts, row_of=None):
    """Least time for container_and_counts over these members: each
    payload byte and offset read once and one int32 a member written; a
    dense side costs the 32-byte sectors of its rows that the positions
    touch (array x dense) or the words its runs cover (run x dense), each
    once, where ``row_of`` gives each member's row among shared ones
    (default: a row a member). Bytes bind: a merge step is a compare or
    two, far under the card's integer rate."""
    n = len(a_conts)
    fa, fb = cell.split("_")
    nbytes = n * 4 + (n + 1) * 4
    if fa == "array":
        nbytes += sum(c.count for c in a_conts) * 4
    else:
        nbytes += sum(len(c.runs) for c in a_conts) * 8
    if fb == "array":
        nbytes += sum(c.count for c in b_conts) * 4 + (n + 1) * 4
    elif fb == "run":
        nbytes += sum(len(c.runs) for c in b_conts) * 8 + (n + 1) * 4
    else:
        rows = np.arange(n) if row_of is None else np.asarray(row_of)
        unit = SECTOR_BYTES * 8 if fa == "array" else 32  # bits a unit
        units = -(-WORDS32 * 32 // unit)
        keys = []
        for r, c in zip(rows, a_conts):
            if fa == "array":
                at = c.positions.astype(np.int64) // unit
            else:
                runs = c.runs.astype(np.int64)
                if not len(runs):
                    continue
                lo, hi = runs[:, 0] // unit, (runs[:, 1] - 1) // unit + 1
                at = np.repeat(lo - np.cumsum(hi - lo) + (hi - lo),
                               hi - lo) + np.arange(int((hi - lo).sum()))
            keys.append(at + int(r) * units)
        touched = len(np.unique(np.concatenate(keys))) if keys else 0
        nbytes += touched * (unit // 8)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def cont_table_case(n, seed):
    """A member table over two identity sides of n members each that
    names every side twice (repeated sides) and a shuffled subset of the
    members (three in four). Returns (int32 [K, 4] table, the members'
    indices in table order)."""
    rng = np.random.default_rng(seed)
    pick = rng.permutation(n)[:max(1, (3 * n) // 4)]
    k = np.arange(len(pick))
    table = np.stack([k % 2, pick, (k // 2) % 2, pick], axis=1).astype(
        np.int32)
    return table, pick


def container_checks(card):
    """Phase 3's container_and_counts: every cell against its plain
    version at the boundary cases, with N = 1, 7 and CONT_LANE_MEMBERS
    members, exactly, in the identity form and through member tables
    (repeated sides, shuffled subsets); the size
    threshold's edges, a launch past the kernel's table of sides and
    rows of mixed formats through the lanes; then timed at the serial
    path's shapes (one member of phase 10's rows) and at a lane of each
    cell (CONT_LANE_MEMBERS members of phase 10's 500 and 300 positions,
    its 2,000-bit run and dense rows). Returns the array × array lane's
    stats."""
    import torch

    from pilosa_tpu_torch.ops import containers as C
    from pilosa_tpu_torch.ops import kernels

    def count(cell, a, b, *table):
        return kernels.container_and_counts(cell, a, b, *table)

    t_start = time.perf_counter()
    th = kernels.container_thresholds()
    block_min = th["block_min_ints"]
    err, cases = 0, 0
    for cell in CONT_CELLS:
        fa, fb = cell.split("_")
        for n in (1, 7, CONT_LANE_MEMBERS):
            big = n > 1000
            _, a = cont_side(fa, n, 1, big)
            _, b = cont_side(fb, n, 2, big)
            got = count(cell, a, b)
            want = kernels.container_and_counts_plain(cell, a, b)
            check(torch.equal(got, want),
                  f"container_and_counts {cell} N = {n} != plain")
            err = max(err, int((got.long() - want.long()).abs().max()))
            cases += 1
            if fb == "dense":  # the same rows as one [N, W] stack
                rows = torch.stack(list(b)) if n < 1000 else None
                if rows is not None:
                    check(torch.equal(count(cell, a, rows), want),
                          f"container_and_counts {cell} stacked rows")
                    cases += 1
            table, pick = cont_table_case(n, n)
            tdev = torch.from_numpy(table).to(DEVICE)
            got = count(cell, [a, a], [b, b], tdev)
            check(torch.equal(got, want[torch.from_numpy(pick).to(DEVICE)]),
                  f"container_and_counts {cell} N = {n} table != plain")
            cases += 1
            del a, b
    # The size threshold's edges: members of block_min - 1, block_min and
    # block_min + 1 staged ints among lane members, in no order.
    rng = np.random.default_rng(6)
    edge = []
    for k in range(3000):
        tot = block_min - 1 + k % 3 if k % 2 else 800
        edge.append((tot // 2, tot - tot // 2))
    edge = [edge[i] for i in rng.permutation(len(edge))]
    conts = [[C.Container("array", WORDS32, k, positions=np.sort(
        rng.choice(SLICE_COLS, k, replace=False)).astype(np.int32),
        device=DEVICE) for k in side] for side in zip(*edge)]
    a, b = C.stack_positions(conts[0]), C.stack_positions(conts[1])
    ident = np.arange(len(edge), dtype=np.int32)
    table = np.stack([0 * ident, ident, 0 * ident, ident], axis=1)
    got = count("array_array", [a], [b], table)
    check(torch.equal(got, kernels.container_and_counts_plain(
        "array_array", a, b)), "container_and_counts threshold edges")
    cases += 1
    # Past the kernel's table: 3 * max_sides + 1 left sides, 70 right.
    sides_a = [C.stack_positions(conts[0][i::200][:5])
               for i in range(3 * th["max_sides"] + 1)]
    sides_b = [C.stack_runs([C.Container("run", WORDS32, 2000, runs=np.array(
        [[s0, s0 + 2000]], np.int32), device=DEVICE) for s0 in
        rng.integers(0, SLICE_COLS - 3000, 5)]) for _ in range(70)]
    table = np.stack([np.repeat(np.arange(len(sides_a)), 5),
                      np.tile(np.arange(5), len(sides_a)),
                      rng.integers(0, len(sides_b), 5 * len(sides_a)),
                      rng.integers(0, 5, 5 * len(sides_a))],
                     axis=1).astype(np.int32)
    before = kernels.launches["container_and_counts"]
    got = count("array_run", sides_a, sides_b, table)
    split = kernels.launches["container_and_counts"] - before
    check((split > 1 or DEVICE != "cuda") and torch.equal(
        got, kernels.container_and_counts_plain(
            "array_run", sides_a, sides_b, table)),
        f"container_and_counts past {th['max_sides']} sides ({split} "
        "launches)")
    cases += 1
    # Rows of mixed formats through the lanes: subsets of packed rows.
    kinds = [("array", "array"), ("array", "run"), ("run", "array"),
             ("run", "run"), (None, "array"), ("array", "dense"),
             ("array4096", "array4096")] * 300
    state = rng.bit_generator.state
    totals = {}
    for dev in ("cpu", DEVICE):
        rng.bit_generator.state = state
        blocks = [(cont_block(x, dev, rng), cont_block(y, dev, rng))
                  for x, y in kinds]
        la = C.RowLane([x for x, _ in blocks])
        lb = C.RowLane([y for _, y in blocks])
        totals[dev] = C.lane_and_counts([(la, lb), (lb, la)])[0].tolist()
    check(totals["cpu"] == totals[DEVICE],
          f"mixed-format lanes {totals[DEVICE]} != {totals['cpu']}")
    cases += 1
    print(f"container_and_counts: {cases} cases exact (cells {CONT_CELLS}, "
          f"N = 1, 7, {CONT_LANE_MEMBERS} in the identity form and through "
          f"member tables of repeated sides and shuffled subsets; 0, 1, "
          f"4,096 and bit-31 positions, 2,048 runs, a whole-row run, empty "
          f"members among 4,096-position ones, 4,097-bit, all-ones and "
          f"bit-31 dense rows; members of {block_min - 1} to "
          f"{block_min + 1} staged ints; {len(sides_a)} sides in {split} "
          f"launches; rows of mixed formats through the lanes); max_abs_err "
          f"{err}; thresholds {th}")
    del conts, a, b, sides_a, sides_b

    # The serial shapes: one member of phase 10's rows (500 and 300
    # spread positions, a 2,000-bit run, a dense row), a launch a slice.
    rng = np.random.default_rng(5)

    def one(fmt):
        if fmt == "array":
            p = np.sort(rng.choice(SLICE_COLS, 500, replace=False))
            return [C.Container("array", WORDS32, 500,
                                positions=p.astype(np.int32), device=DEVICE)]
        if fmt == "array300":
            p = np.sort(rng.choice(SLICE_COLS, 300, replace=False))
            return [C.Container("array", WORDS32, 300,
                                positions=p.astype(np.int32), device=DEVICE)]
        if fmt == "run":
            s0 = int(rng.integers(0, SLICE_COLS - 3000))
            return [C.Container("run", WORDS32, 2000, runs=np.array(
                [[s0, s0 + 2000]], np.int32), device=DEVICE)]
        return [C.dense_container(torch.randint(
            -2**31, 2**31 - 1, (WORDS32,), dtype=torch.int32,
            device=DEVICE), WORDS32, 0)]

    stats = {}
    for cell, fa, fb in (("array_array", "array", "array300"),
                         ("array_run", "array", "run"),
                         ("array_dense", "array", "dense"),
                         ("run_dense", "run", "dense")):
        ca, cb = one(fa), one(fb)
        pa = (C.stack_positions(ca) if fa == "array" else C.stack_runs(ca))
        pb = (C.stack_positions(cb) if fb.startswith("array")
              else C.stack_runs(cb) if fb == "run"
              else [c.dense_words() for c in cb])
        pa, pb = list(pa), list(pb)
        bound, by, nbytes = cont_bound_ms(cell, ca, cb)
        st = stats[cell] = {
            "dev_ms": cold_ms(lambda x, y: count(cell, x, y), pa, pb),
            "lone_ms": one_ms(lambda: count(cell, pa, pb)),
            "call_ms": sync_ms(lambda: count(cell, pa, pb)),
            "bound_ms": bound, "bytes": nbytes}
        print(f"container_and_counts serial {cell} (1 member, {fa} x {fb}):"
              f" dev {st['dev_ms']:.4f} ms, lone {st['lone_ms']:.4f} ms, "
              f"call and synchronize {st['call_ms']:.4f} ms; {nbytes} bytes,"
              f" bound {bound:.6f} ms ({by}) {card}")

    # A lane of each cell: GROUP_PAIRS row pairs over MAIN_SLICES slices
    # are CONT_LANE_MEMBERS members of phase 10's rows: 500 and 300
    # spread positions, one 2,000-bit run, a dense row (2,048 distinct
    # rows, one [2048, W] stack read through the member table).
    n = CONT_LANE_MEMBERS
    pool_a = [np.sort(rng.choice(SLICE_COLS, 500, replace=False)).astype(
        np.int32) for _ in range(256)]
    pool_b = [np.sort(rng.choice(SLICE_COLS, 300, replace=False)).astype(
        np.int32) for _ in range(256)]
    ca = [C.Container("array", WORDS32, 500, positions=pool_a[i % 256],
                      device=DEVICE) for i in range(n)]
    cb = [C.Container("array", WORDS32, 300, positions=pool_b[i % 251],
                      device=DEVICE) for i in range(n)]
    cr = [C.Container("run", WORDS32, SPARSE_RUN, runs=np.array(
        [[s0, s0 + SPARSE_RUN]], np.int32), device=DEVICE)
        for s0 in rng.integers(0, SLICE_COLS - 3000, n)]
    t0 = time.perf_counter()
    pa, pb = C.stack_positions(ca), C.stack_positions(cb)
    sync()
    pack_ms = (time.perf_counter() - t0) * 1e3
    pr = C.stack_runs(cr)
    rows = torch.randint(-2**31, 2**31 - 1, (2048, WORDS32),
                         dtype=torch.int32, device=DEVICE)
    ident = np.arange(n, dtype=np.int32)
    dense_table = torch.from_numpy(np.stack(
        [0 * ident, ident, 0 * ident, ident % 2048], axis=1)).to(DEVICE)
    lanes = {}
    for cell, a, b, conts in (
            ("array_array", pa, pb, (ca, cb)),
            ("array_run", pa, pr, (ca, cr)),
            ("array_dense", pa, rows, (ca, None)),
            ("run_dense", pr, rows, (cr, None))):
        a, b = list(a), (b if torch.is_tensor(b) else list(b))
        if cell.endswith("dense"):
            def fn(x, y, t, cell=cell):
                return count(cell, [x], [y], t)
            args = (a, b, dense_table)
            call = (lambda cell=cell, a=a, b=b:
                    count(cell, [a], [b], dense_table))
            want = kernels.container_and_counts_plain(
                cell, [a], [b], dense_table)
            plain = (lambda cell=cell, a=a, b=b:
                     kernels.container_and_counts_plain(
                         cell, [a], [b], dense_table))
        else:
            def fn(x, y, cell=cell):
                return count(cell, x, y)
            args = (a, b)
            call = lambda cell=cell, a=a, b=b: count(cell, a, b)
            want = kernels.container_and_counts_plain(cell, a, b)
            plain = (lambda cell=cell, a=a, b=b:
                     kernels.container_and_counts_plain(cell, a, b))
        check(torch.equal(call(), want),
              f"container_and_counts lane {cell} != plain")
        dense = cell.endswith("dense")
        bound, by, nbytes = cont_bound_ms(
            cell, conts[0], conts[1] or [], ident % 2048 if dense else None)
        lane = lanes[cell] = {
            "ms": timed_ms(call, reps=10),
            "dev_ms": cold_ms(fn, *args),
            "lone_ms": one_ms(call),
            "plain_ms": timed_ms(plain, reps=1, warm=1),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes}
        what = ("an off-path probe: the main path launches dense cells "
                "serially, a member a slice; 2,048 rows shared"
                if dense else "phase 10's lane shape")
        print(f"container_and_counts lane {cell} ({GROUP_PAIRS} row pairs: "
              f"{n} members; {what}): call {lane['ms']:.4f} ms, dev "
              f"{lane['dev_ms']:.4f} ms, lone {lane['lone_ms']:.4f} ms, "
              f"plain version {lane['plain_ms']:.4f} ms; {nbytes} bytes, "
              f"bound {bound:.4f} ms ({by}), {bound / lane['dev_ms']:.1%} of "
              f"bound {card}")
        del want
    lane = dict(lanes["array_array"], max_abs_err=err, pack_ms=pack_ms,
                serial=stats, lanes=lanes)
    print(f"container_and_counts lane array_array: packing the lane on the "
          f"host {pack_ms:.2f} ms; library call: none (no PyTorch call "
          f"counts a sorted-list intersection); checks and timings "
          f"{time.perf_counter() - t_start:.1f} s {card}")
    del ca, cb, cr, pa, pb, pr, rows
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return lane


# The ingest classify kernel: phase 3's streams (tests/test_torch_cuda.py
# has the same), sorted by (row, position) and deduplicated.
CLASSIFY_CASES = ("empty", "one", "edges", "whole_row", "4096_4097",
                  "rows_1", "rows_3", "rows_1024", "chunk_edges")


def classify_stream(lengths, rng, run_share=0.5):
    """(rowidx, positions, n_rows) of rows of the given lengths, each a
    run of ``run_share`` of its bits and spread bits."""
    rows, pos = [], []
    for r, k in enumerate(lengths):
        run = int(k * run_share)
        start = int(rng.integers(0, SLICE_COLS - run))
        p = set(range(start, start + run))
        while len(p) < k:
            p.update(rng.integers(0, SLICE_COLS, k - len(p)).tolist())
        pos.append(np.sort(np.fromiter(p, np.int64, len(p))[:k]))
        rows.append(np.full(k, r))
    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(pos).astype(np.int32), len(lengths))


def classify_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 3
    if name == "one":
        return np.zeros(1, np.int32), np.array([5], np.int32), 1
    if name == "edges":  # bits 31/32 of a word, the slice's last bit
        return (np.array([0, 0, 0, 0, 0, 1, 1], np.int32),
                np.array([0, 31, 32, 33, SLICE_COLS - 1, 31, 32], np.int32),
                2)
    if name == "whole_row":
        return (np.zeros(SLICE_COLS, np.int32),
                np.arange(SLICE_COLS, dtype=np.int32), 1)
    if name == "4096_4097":
        return classify_stream([4096, 4097], rng, run_share=0.0)
    if name.startswith("rows_"):
        n = int(name[5:])
        return classify_stream(rng.integers(1, 3000, n).tolist(), rng)
    if name == "chunk_edges":  # rows ending on and inside 23-entry chunks
        return classify_stream([23, 22, 24, 46, 5888, 5889, 1, 23 * 256],
                               rng, run_share=0.9)
    raise KeyError(name)


def classify_shape(nnz, n_rows, seed):
    """A sorted, deduplicated stream of about ``nnz`` uniform entries
    over ``n_rows`` rows of one slice (phase 11's shapes)."""
    rng = np.random.default_rng(seed)
    key = np.unique((rng.integers(0, n_rows, nnz, dtype=np.int64) << 20)
                    | rng.integers(0, SLICE_COLS, nnz, dtype=np.int64))
    return ((key >> 20).astype(np.int32),
            (key & (SLICE_COLS - 1)).astype(np.int32))


def classify_bound_ms(nnz, n_rows):
    """Least time of a classify pass: each entry's row and position read
    once, each row's two counts written once (the compares and adds,
    about 8 integer operations an entry, are far under the bytes)."""
    nbytes = 8 * nnz + 8 * n_rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(0, 8 * nnz)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def ingest_checks(card):
    """Phase 3's ingest_classify: against its plain version on the same
    device tensors at CLASSIFY_CASES, exactly; then timed at phase 11's
    shapes (a slice group of its wide batches, INGEST_GROUP_BITS entries
    over INGEST_ROWS rows, and a whole INGEST_BATCH in one slice): the
    kernel on cold inputs (dev) and as a call, its plain version, the
    host-to-device copy of the stream and the whole classify cell as the
    pipeline calls it (upload, kernel, download). Returns the slice
    group's stats."""
    import torch

    from pilosa_tpu_torch.ops import ingest, kernels

    t_start = time.perf_counter()
    err = 0
    for name in CLASSIFY_CASES:
        rowidx, pos, n_rows = classify_case(name)
        r = torch.from_numpy(rowidx).to(DEVICE)
        p = torch.from_numpy(pos).to(DEVICE)
        got = kernels.ingest_classify(r, p, n_rows)
        want = kernels.ingest_classify_plain(r, p, n_rows)
        for g, w in zip(got, want):
            check(g.device == r.device and torch.equal(g, w),
                  f"ingest_classify {name} != plain")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
    stats = {}
    for label, nnz in (("slice group of (a)", INGEST_GROUP_BITS),
                       ("a whole batch in one slice", INGEST_BATCH)):
        rowidx, pos = classify_shape(nnz, INGEST_ROWS, nnz)
        n = len(rowidx)
        r = torch.from_numpy(rowidx).to(DEVICE)
        p = torch.from_numpy(pos).to(DEVICE)
        got = kernels.ingest_classify(r, p, INGEST_ROWS)
        want = kernels.ingest_classify_plain(r, p, INGEST_ROWS)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"ingest_classify at {n} entries != plain")

        def upload(rowidx=rowidx, pos=pos):
            return (torch.from_numpy(rowidx).to(DEVICE),
                    torch.from_numpy(pos).to(DEVICE))

        bound, by, nbytes = classify_bound_ms(n, INGEST_ROWS)
        st = stats[label] = {
            "ms": timed_ms(lambda: kernels.ingest_classify(
                r, p, INGEST_ROWS), reps=20),
            "dev_ms": cold_ms(lambda x, y: kernels.ingest_classify(
                x, y, INGEST_ROWS), r, p),
            "plain_ms": timed_ms(lambda: kernels.ingest_classify_plain(
                r, p, INGEST_ROWS), reps=3),
            "h2d_ms": p50_ms(upload, 5)[0],
            "cell_ms": p50_ms(lambda: ingest.classify_stats_device(
                rowidx, pos, INGEST_ROWS, device=DEVICE), 5)[0],
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "max_abs_err": err}
        print(f"ingest_classify, {label} ({n} entries over {INGEST_ROWS} "
              f"rows): call {st['ms']:.4f} ms, dev {st['dev_ms']:.4f} ms, "
              f"plain version {st['plain_ms']:.4f} ms; the stream's copy "
              f"to the card {st['h2d_ms']:.3f} ms, the classify cell "
              f"(copy, kernel, counts back) {st['cell_ms']:.3f} ms; "
              f"{nbytes} bytes, bound {bound:.4f} ms ({by}), "
              f"{bound / st['dev_ms']:.1%} of bound; library call: none "
              f"(no one PyTorch call gives both counts and run starts) "
              f"{card}")
        del r, p, got, want
    print(f"ingest_classify: {len(CLASSIFY_CASES)} cases exact "
          f"({', '.join(CLASSIFY_CASES)}); max_abs_err {err}; "
          f"{time.perf_counter() - t_start:.1f} s")
    return stats["slice group of (a)"]


def cont_block(kind, device, rng):
    """One block of a mixed-format row: None, 500 spread positions,
    4,096 positions, a 2,000-bit run or a random dense row."""
    from pilosa_tpu_torch.ops import containers as C

    import torch

    if kind is None:
        return None
    if kind == "run":
        s0 = int(rng.integers(0, SLICE_COLS - 3000))
        return C.Container("run", WORDS32, SPARSE_RUN, runs=np.array(
            [[s0, s0 + SPARSE_RUN]], np.int32), device=device)
    if kind == "dense":
        w = rng.integers(-2**31, 2**31, WORDS32, dtype=np.int64).astype(
            np.int32)
        return C.dense_container(torch.from_numpy(w).to(device), WORDS32,
                                 int(np.bitwise_count(w.view(np.uint32))
                                     .sum()))
    k = 4096 if kind == "array4096" else 500
    p = np.sort(rng.choice(SLICE_COLS, k, replace=False)).astype(np.int32)
    return C.Container("array", WORDS32, k, positions=p, device=device)


def count_route(ex, index, pql, slices):
    """The route of a Count: "lanes" for a bare leaf or a two-operand
    node whose every row leaf is compressed on every slice (the batched
    path declines it), else "batched" (a deeper tree stays batched
    however sparse), or "serial" for a tree the batched path cannot
    plan."""
    from pilosa_tpu_torch.pql import parse

    leaves = []
    plan = ex._batched_plan(index, parse(pql).calls[0].children[0], leaves)
    if plan is None:
        return "serial"
    if ex._lane_plan_shape(plan) is None:
        return "batched"
    fm = ex._leaf_frags(index, leaves, slices)
    return "lanes" if ex._compressed_plan(leaves, fm) else "batched"


# ------------------------------------------------------------ phase 4

ROW = 'Bitmap(frame="f", rowID={})'
R0, R1, R2, R3 = ROW.format(0), ROW.format(1), ROW.format(2), ROW.format(3)
QUERIES = [  # (PQL, numpy oracle over (r0, r1, r2, r3) words)
    (f"Count({R0})", lambda w: w[0]),
    (f"Count({R2})", lambda w: w[2]),
    (f"Count(Intersect({R0}, {R1}))", lambda w: w[0] & w[1]),
    (f"Count(Union({R0}, {R1}))", lambda w: w[0] | w[1]),
    (f"Count(Difference({R0}, {R1}))", lambda w: w[0] & ~w[1]),
    (f"Count(Xor({R0}, {R1}))", lambda w: w[0] ^ w[1]),
    (f"Count(Intersect({R0}, {R1}, {R2}))", lambda w: w[0] & w[1] & w[2]),
    (f"Count(Difference(Union({R0}, {R2}), Intersect({R1}, {R2})))",
     lambda w: (w[0] | w[2]) & ~(w[1] & w[2])),
]
# Getting Started's bitmap reads on the sparse row 3 (a stargazer's
# repositories): (PQL, numpy oracle). Every result is sparse (5-10M ids
# over 10.0B columns); a dense one would be 40 GB of ids on the host.
BITMAP_QUERIES = [
    (R3, lambda w: w[3]),
    (f"Intersect({R3}, {R0})", lambda w: w[3] & w[0]),
    (f"Difference({R3}, {R1})", lambda w: w[3] & ~w[1]),
    (f"Xor({R3}, Intersect({R3}, {R0}))", lambda w: w[3] ^ (w[3] & w[0])),
]


def slice_words(seed, s):
    """uint64[4, 16384]: rows 0 and 1 at bit density 0.5, row 2 at 0.25,
    row 3 at 2^-10 (its own stream, so rows 0-2 do not depend on it)."""
    rng = np.random.default_rng([seed, s])
    w = rng.integers(0, 1 << 64, size=(4, 16384), dtype=np.uint64)
    r3 = np.random.default_rng([seed, s, 3]).integers(
        0, 1 << 64, size=(10, 16384), dtype=np.uint64)
    return np.stack([w[0], w[1], w[2] & w[3],
                     np.bitwise_and.reduce(r3, axis=0)])


def slice_counts(words):
    return [int(np.bitwise_count(fn(words)).sum()) for _, fn in QUERIES]


def positions(words):
    """Ascending bit positions of uint64 words, as uint64."""
    return np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little")).astype(np.uint64)


def backup_tar(words):
    """A fragment backup archive (data + cache members) of four rows,
    made by the port's codec."""
    from pilosa_tpu_torch.roaring import codec

    keys = np.arange(4 * 16, dtype=np.uint64)  # rows 0-3 × 16 containers
    data = codec.serialize_arrays(keys, words.reshape(64, 1024))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name, payload in (("data", data), ("cache", b"[0, 1, 2, 3]")):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    buf.seek(0)
    return buf


def _write_f_slices(frag_dir, seed, lo, hi):
    """Worker: frame f's fragments of slices [lo, hi), each restored by
    ``Fragment.read_from`` from a backup archive of the port's codec;
    returns their per-query oracle counts, per bitmap query the
    ascending column ids of its result, |row r & row 0| per row and
    slice (phase 8's TopN over frame f), and |row a & row b| for every
    pair of rows 0-3 summed over its slices (phase 8c's Counts). The
    workers write disjoint
    fragments of a closed holder's tree: ``holder_locked`` spares them
    the transient probe of ``.holder.lock``, which they would contend
    for."""
    from pilosa_tpu_torch.storage.fragment import Fragment

    counts = np.zeros((len(QUERIES), hi - lo), dtype=np.int64)
    ids = [[] for _ in BITMAP_QUERIES]
    and_f0 = np.zeros((4, hi - lo), dtype=np.int64)
    pairs = np.zeros((4, 4), dtype=np.int64)
    for i, s in enumerate(range(lo, hi)):
        words = slice_words(seed, s)
        counts[:, i] = slice_counts(words)
        and_f0[:, i] = np.bitwise_count(words & words[0]).sum(axis=1)
        pairs += np.bitwise_count(words[:, None] & words[None]).sum(
            axis=-1, dtype=np.int64)
        for k, (_, fn) in enumerate(BITMAP_QUERIES):
            ids[k].append(positions(fn(words)) + np.uint64(s * SLICE_COLS))
        frag = Fragment(os.path.join(frag_dir, str(s)), "i", "f",
                        "standard", s, holder_locked=True).open()
        frag.read_from(backup_tar(words))
        frag.close()
    return lo, counts, [np.concatenate(x) for x in ids], and_f0, pairs


def p50_ms(fn, reps):
    """(p50 ms of ``fn`` over ``reps`` calls, host clock to
    ``torch.cuda.synchronize()``, the last result)."""
    out, ms = None, []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.percentile(ms, 50)), out


def bitmap_reads(ex, slices, oracle_ids, card):
    """Phase 4's bitmap results and attributes. ``oracle_ids`` holds,
    per BITMAP_QUERIES entry, the ascending ids over every slice."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import ExecOptions

    n_ser = min(SERIAL_SLICES, slices)
    for path in ("batched", "serial"):
        ex._force_path = path
        span = range(slices) if path == "batched" else range(n_ser)
        for (q, _), ids in zip(BITMAP_QUERIES, oracle_ids):
            want = ids[:np.searchsorted(ids, np.uint64(n_ser * SLICE_WIDTH))
                       ] if path == "serial" else ids
            t = time.perf_counter()
            bm = ex.execute("i", q, slices=span)[0]
            got = bm.columns()
            dt = (time.perf_counter() - t) * 1e3
            check(bm.count() == len(want) and np.array_equal(got, want),
                  f"{path} {q}: {bm.count()} ids ({len(got)} listed) != "
                  f"oracle {len(want)}")
            print(f"  bitmap {path:7s} {dt:9.2f} ms  {len(got):>10d} ids  "
                  f"over {len(span)} slices  {q}")
    ex._force_path = None

    # A bare Bitmap takes the serial path; a compound one the batched.
    leaf_ms, _ = p50_ms(lambda: ex.execute("i", R3)[0].columns(), 10)
    q_and = BITMAP_QUERIES[1][0]
    exec_ms, bm = p50_ms(lambda: ex.execute("i", q_and)[0], 10)
    cols_ms, got = p50_ms(bm.columns, 10)
    check(np.array_equal(got, oracle_ids[1]), "warm Intersect ids changed")
    print(f"bitmap {card}: {R3} over {slices} slices (serial) p50 "
          f"{leaf_ms:.3f} ms; {q_and} batched p50 {exec_ms + cols_ms:.3f} "
          f"ms = fold and count_rows {exec_ms:.3f} ms + columns() "
          f"{cols_ms:.3f} ms (extraction {cols_ms / (exec_ms + cols_ms):.1%}"
          f"; n=10 each, host clock to torch.cuda.synchronize()); "
          f"{len(got)} ids")

    # Attributes: a row's attrs ride its Bitmap; the options strip them
    # or the bits; a column's attrs land in the index's store.
    res = ex.execute("i", 'SetRowAttrs(frame="f", rowID=3, name="stargazer", '
                          'active=true)')
    check(res == [None], f"SetRowAttrs returned {res}")
    attrs = {"name": "stargazer", "active": True}
    part = range(min(8, slices))
    n_part = int(np.searchsorted(oracle_ids[0],
                                 np.uint64(len(part) * SLICE_WIDTH)))
    for opt, want_attrs, want_n in (
            (None, attrs, n_part),
            (ExecOptions(exclude_attrs=True), {}, n_part),
            (ExecOptions(exclude_bits=True), attrs, 0)):
        bm = ex.execute("i", R3, slices=part, opt=opt)[0]
        check(bm.attrs == want_attrs and len(bm.columns()) == want_n
              and bm.count() == want_n,
              f"{R3} attrs {bm.attrs} and {bm.count()} ids != "
              f"{want_attrs} and {want_n}")
    res = ex.execute("i", 'SetColumnAttrs(columnID=100, category="x")')
    check(res == [None], f"SetColumnAttrs returned {res}")
    got = ex.holder.index("i").column_attr_store.attrs(100)
    check(got == {"category": "x"}, f"column 100 attrs {got}")
    print(f"  attrs: {R3} carries {attrs}; exclude_attrs and exclude_bits "
          f"hold; column 100 carries {got}")


def main_path(slices, seed, datadir, card, oracle):
    """Phase 4; leaves in ``oracle`` what phase 8 checks its answers
    against."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage.holder import Holder

    need = slices * 4 * 16384 * 8 * 1.1
    free = shutil.disk_usage(os.path.dirname(datadir)).free
    check(free > need, f"{free / 1e9:.1f} GB free on disk, the data "
          f"directory needs {need / 1e9:.1f} GB")

    t0 = time.perf_counter()
    per_slice = np.zeros((len(QUERIES), slices), dtype=np.int64)
    holder = Holder(datadir, device=DEVICE).open()
    view = holder.create_index("i").create_frame("f") \
        .create_view_if_not_exists("standard")
    frag_dir = os.path.join(view.path, "fragments")
    holder.close()
    procs, parts = in_processes(_write_f_slices, frag_dir, seed, slices)
    for lo, c, *_ in parts:
        per_slice[:, lo:lo + c.shape[1]] = c
    oracle_ids = [np.concatenate([p[2][k] for p in parts])
                  for k in range(len(BITMAP_QUERIES))]
    and_f0_slices = np.concatenate([p[3] for p in parts], axis=1)
    and_f0 = and_f0_slices.sum(axis=1)
    pair_counts = sum(p[4] for p in parts)
    del parts
    write_s = time.perf_counter() - t0
    print(f"main path: wrote {slices} slices ({slices * SLICE_WIDTH / 1e9:.2f}"
          f"B columns, {slices * 4 * 16384 * 8 / 1e9:.2f} GB of rows) "
          f"through Fragment.read_from in {procs} processes in "
          f"{write_s:.1f} s")

    reset_peak()
    kernels.reset_launches()
    t0 = time.perf_counter()
    holder = Holder(datadir, device=DEVICE).open()
    open_s = time.perf_counter() - t0
    check(holder.index("i").max_slice() == slices - 1, "max_slice")
    ex = Executor(holder)
    q_and = QUERIES[2][0]
    t0 = time.perf_counter()
    got = ex.execute("i", q_and)[0]
    sync()
    first_s = time.perf_counter() - t0
    want = [int(c) for c in per_slice.sum(axis=1)]
    check(got == want[2], f"{q_and}: {got} != oracle {want[2]}")
    n_ser = min(SERIAL_SLICES, slices)
    serial_ms = []

    def run_all(tag):
        want_ser = per_slice[:, :n_ser].sum(axis=1)
        for path in ("batched", "serial"):
            ex._force_path = path
            span = range(slices) if path == "batched" else range(n_ser)
            for (q, _), w, ws in zip(QUERIES, want, want_ser):
                w = w if path == "batched" else int(ws)
                t = time.perf_counter()
                got = ex.execute("i", q, slices=span)[0]
                dt = time.perf_counter() - t
                check(got == w, f"{tag} {path} {q}: {got} != oracle {w}")
                if path == "serial":
                    serial_ms.append(dt * 1e3)
                print(f"  {tag} {path:7s} {dt * 1e3:9.2f} ms  {got:>13d}  "
                      f"{q} over {len(span)} slices")
        ex._force_path = None

    run_all("query")

    lat = []
    for _ in range(100):
        t = time.perf_counter()
        got = ex.execute("i", q_and)[0]
        sync()
        lat.append(time.perf_counter() - t)
        check(got == want[2], "warm Count(Intersect) changed")
    lat_ms = np.asarray(lat) * 1e3

    # SetBit/ClearBit on one slice of the serial span, each followed by
    # a recount.
    s = n_ser // 2
    words = slice_words(seed, s)
    bit = int(np.flatnonzero(np.unpackbits(
        (~words[0]).view(np.uint8), bitorder="little"))[0])
    col = s * SLICE_WIDTH + bit
    for verb, value in (("SetBit", True), ("ClearBit", False)):
        res = ex.execute("i", f'{verb}(frame="f", rowID=0, columnID={col})')
        check(res == [True], f"{verb} at column {col} returned {res}")
        words[0][bit // 64] ^= np.uint64(1 << (bit % 64))
        per_slice[:, s] = slice_counts(words)
        want = [int(c) for c in per_slice.sum(axis=1)]
        run_all(verb.lower())
    bitmap_reads(ex, slices, oracle_ids, card)
    launches = launch_counts()
    peak = peak_bytes()
    holder.close()
    check(launches["count_op_rows"] and launches["count_rows"],
          f"a count kernel never launched on the Count path: {launches}")

    from pilosa_tpu_torch.storage.fragment import reader_cap

    print(f"main path {card}: open {open_s:.2f} s (reader cap "
          f"{reader_cap()}), first Count(Intersect) "
          f"{first_s:.2f} s (stacks built), warm Count(Intersect) over "
          f"{slices} slices: p50 {np.percentile(lat_ms, 50):.3f} ms, p90 "
          f"{np.percentile(lat_ms, 90):.3f} ms, max {lat_ms.max():.3f} ms "
          f"(n=100, host clock to torch.cuda.synchronize()); serial path "
          f"over {n_ser} slices {np.mean(serial_ms):.1f} ms per query (mean "
          f"of {len(serial_ms)}, {min(serial_ms):.1f}-{max(serial_ms):.1f}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"launches {launches}")
    oracle.update(count_and=want[2], and_ids=oracle_ids[1],
                  and_slices=per_slice[2].copy(),
                  r3_ids=oracle_ids[0], and_f0_slices=and_f0_slices,
                  pair_counts=pair_counts,
                  count_p50_ms=float(np.percentile(lat_ms, 50)),
                  topn_f0=topn_pairs(and_f0))
    return launches


def topn_pairs(totals):
    """(row, count) pairs of non-zero totals by (-count, row)."""
    return sorted(((r, int(c)) for r, c in enumerate(totals) if c),
                  key=lambda rc: (-rc[1], rc[0]))


def governor_path(slices, datadir, card, oracle):
    """Phase 4, reopened with a host-memory budget below its fragments'
    host bytes: Count and TopN batched over every slice, a serial TopN
    (it counts on each fragment's matrix, so it faults fragments in) and
    the bitmap result of row 3 over the first slices, each answer against
    phase 4's oracle and the governor's resident bytes within the budget
    after each; it must have evicted and faulted in."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage.holder import Holder

    kernels.reset_launches()
    t0 = time.perf_counter()
    holder = Holder(datadir, device=DEVICE,
                    host_bytes=GOVERNOR_BYTES).open()
    open_s = time.perf_counter() - t0
    gov = holder.governor
    ex = Executor(holder)
    n_ser = min(GOVERNED_SLICES, slices)
    q_top = f'TopN({R0}, frame="f", n=4)'
    ids = oracle["r3_ids"]
    ids = ids[:np.searchsorted(ids, np.uint64(n_ser * SLICE_WIDTH))]
    n_bat = min(GOVERNED_BATCH, slices)
    f0 = oracle["and_f0_slices"]
    steps = [
        ("batched", QUERIES[2][0], range(n_bat),
         int(oracle["and_slices"][:n_bat].sum())),
        ("batched", q_top, range(n_bat), topn_pairs(f0[:, :n_bat].sum(1))),
        ("serial", q_top, range(n_ser), topn_pairs(f0[:, :n_ser].sum(1))),
        ("serial", R3, range(n_ser), ids),
    ]
    worst = 0
    for path, q, span, want in steps:
        ex._force_path = path
        t = time.perf_counter()
        got = ex.execute("i", q, slices=span)[0]
        if q == R3:
            got = got.columns()
            ok = np.array_equal(got, want)
            got = f"{len(got)} ids"
        else:
            ok = got == want
        sync()
        dt = (time.perf_counter() - t) * 1e3
        rb = gov.resident_bytes()
        worst = max(worst, rb)
        check(ok, f"governed {path} {q}: {got} != oracle")
        check(rb <= GOVERNOR_BYTES, f"governed {path} {q}: resident {rb} "
              f"bytes > budget {GOVERNOR_BYTES}")
        print(f"  governed {path:7s} {dt:10.2f} ms  over {len(span)} slices "
              f"{q} -> {got}; resident {rb} bytes, evictions "
              f"{gov.evictions}, faults {gov.faults}")
    ex._force_path = None
    launches = launch_counts()
    snap = gov.snapshot()
    holder.close()
    check(snap["evictions"] > 0 and snap["faults"] > 0,
          f"the governor neither evicted nor faulted in: {snap}")
    print(f"governor {card}: budget {GOVERNOR_BYTES} bytes, open "
          f"{open_s:.2f} s; governor.evictions {snap['evictions']}, "
          f"governor.faults {snap['faults']}, resident bytes at most {worst} "
          f"after each query; launches {launches}")
    return launches


# ------------------------------------------------------------ phase 5

T_ROWS = tuple(range(10, 10 + TOPN_CANDIDATES))  # frame t's row ids
SRC = 'Bitmap(frame="f", rowID={})'
TOPN_QUERIES = [  # (label, PQL, oracle over the per-slice count arrays)
    ("a", f'TopN({SRC.format(0)}, frame="t", n=5)',
     lambda o: topn_oracle(o["f0"], n=5)),
    ("b", 'TopN(frame="t", n=5)', lambda o: topn_oracle(o["rows"], n=5)),
    ("c", f'TopN(Intersect({SRC.format(0)}, {SRC.format(2)}), frame="t", '
          'n=8, threshold=5000)',
     lambda o: topn_oracle(o["f0f2"], n=8, threshold=5000)),
    ("d", f'TopN({SRC.format(1)}, frame="t", tanimotoThreshold=30)',
     lambda o: topn_oracle(o["f1_tanimoto30"])),
    ("e", f'TopN({SRC.format(0)}, frame="t", ids=[12, 14, 17])',
     lambda o: topn_oracle(o["f0"], ids=[12, 14, 17])),
    ("f", f'TopN({SRC.format(0)}, frame="t", n=5, field="category", '
          'filters=["a", "b"])',
     lambda o: topn_oracle(o["f0_ab"], n=5)),
]
# Frame t's rows by attribute: filters=["a", "b"] drops rows 12 and 15.
CATEGORY = dict(zip(T_ROWS, "abcabcab"))


def t_slice_words(seed, s):
    """uint64[8, 16384]: frame t's rows 10-17 at bit densities 1/2, 1/2
    (independent), 3/8, 1/4, 1/4 (row 14 identical to row 13), 1/8,
    1/16 and 1/32 (~2048 bits per container: array containers)."""
    rng = np.random.default_rng([seed, s, 1])
    u = rng.integers(0, 1 << 64, size=(7, 16384), dtype=np.uint64)
    r13 = u[2] & u[3]
    r15 = r13 & u[4]
    r16 = r15 & u[5]
    return np.stack([u[0], u[1], u[2] & (u[3] | u[4]), r13, r13, r15, r16,
                     r16 & u[6]])


def topn_slice_counts(t, f):
    """One slice's oracle counts: int64[4, 8] of |row|, |row ∩ f0|,
    |row ∩ f0 ∩ f2| and |row ∩ f1| for frame t's rows, and |f1|."""
    per = [np.bitwise_count(t & m).sum(axis=1) if m is not None
           else np.bitwise_count(t).sum(axis=1)
           for m in (None, f[0], f[0] & f[2], f[1])]
    return np.stack(per).astype(np.int64), int(np.bitwise_count(f[1]).sum())


def _write_t_slices(frag_dir, seed, lo, hi):
    """Worker: frame t's fragment files and ``.cache`` sidecars for
    slices [lo, hi), written by the port's codec (the bytes
    ``Fragment.read_from`` would write); returns their oracle counts."""
    from pilosa_tpu_torch.roaring import codec

    keys = (np.asarray(T_ROWS, np.uint64)[:, None] * np.uint64(16)
            + np.arange(16, dtype=np.uint64)).ravel()
    counts = np.zeros((hi - lo, 4, TOPN_CANDIDATES), np.int64)
    f1_n = np.zeros(hi - lo, np.int64)
    for i, s in enumerate(range(lo, hi)):
        t = t_slice_words(seed, s)
        counts[i], f1_n[i] = topn_slice_counts(t, slice_words(seed, s))
        path = os.path.join(frag_dir, str(s))
        with open(path, "wb") as fh:
            fh.write(codec.serialize_arrays(keys, t.reshape(-1, 1024)))
        with open(path + ".cache", "w") as fh:
            json.dump(list(T_ROWS), fh)
    return lo, counts, f1_n


def topn_oracle(counts, n=0, threshold=0, ids=None):
    """Two-phase TopN over int64[S, 8] per-(slice, row) counts (every
    non-empty row is in its slice's cache): per-slice threshold and top
    n by (-count, id), merge, exact phase 2 over the merged ids, trim
    to n. ``ids`` is phase 2 alone, never trimmed."""
    rows = np.asarray(T_ROWS)
    c = np.where(counts >= max(threshold, 1), counts, 0)

    def merged(cc, keep):
        tot = np.where(np.isin(rows, keep)[None, :], cc, 0).sum(axis=0)
        return sorted(((int(rows[j]), int(v)) for j, v in enumerate(tot)
                       if v > 0), key=lambda rc: (-rc[1], rc[0]))

    if ids is not None:
        return merged(c, sorted(set(ids)))
    first = c
    if n:
        rank = np.argsort(np.argsort(-c, axis=1, kind="stable"), axis=1)
        first = np.where(rank < n, c, 0)
    phase1 = merged(first, rows)
    if not phase1:
        return []
    out = merged(c, [r for r, _ in phase1])
    return out[:n] if n else out


def topn_counts(counts, f1_n):
    """The oracle's count arrays by name, the Tanimoto gate of (d) in
    float32 as the port and pilosa_tpu compute it."""
    rows, f0, f0f2, f1 = (counts[:, k] for k in range(4))
    denom = rows + f1_n[:, None] - f1
    with np.errstate(divide="ignore", invalid="ignore"):
        score = (np.float32(100.0) * f1.astype(np.float32)
                 / denom.astype(np.float32))
    keep = (denom > 0) & (np.ceil(score) > 30)
    allowed = np.asarray([CATEGORY[r] in ("a", "b") for r in T_ROWS])
    return {"rows": rows, "f0": f0, "f0f2": f0f2,
            "f1_tanimoto30": np.where(keep, f1, 0),
            "f0_ab": np.where(allowed[None, :], f0, 0)}


def topn_path(slices, seed, datadir, card):
    """Phase 5: frame t beside phase 4's frame f, TopN on both paths
    against the numpy oracle, before and after writes."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage.frame import Frame
    from pilosa_tpu_torch.storage.holder import Holder

    frame_dir = os.path.join(datadir, "i", "t")
    frag_dir = os.path.join(frame_dir, "views", "standard", "fragments")
    os.makedirs(frag_dir)
    Frame(frame_dir, "i", "t").save_meta()  # ranked cache, default size
    t0 = time.perf_counter()
    counts = np.zeros((slices, 4, TOPN_CANDIDATES), np.int64)
    f1_n = np.zeros(slices, np.int64)
    procs, parts = in_processes(_write_t_slices, frag_dir, seed, slices)
    for lo, c, f in parts:
        counts[lo:lo + len(c)], f1_n[lo:lo + len(c)] = c, f
    write_s = time.perf_counter() - t0
    print(f"topn: wrote frame t, {TOPN_CANDIDATES} rows x {slices} slices "
          f"({slices * TOPN_CANDIDATES * 16384 * 8 / 1e9:.2f} GB of rows), "
          f"in {procs} processes in {write_s:.1f} s")

    reset_peak()
    kernels.reset_launches()
    t0 = time.perf_counter()
    holder = Holder(datadir, device=DEVICE).open()
    open_s = time.perf_counter() - t0
    ex = Executor(holder)
    # Phase 4's attributes persist across the reopen.
    got = (holder.index("i").frame("f").row_attr_store.attrs(3),
           holder.index("i").column_attr_store.attrs(100))
    check(got == ({"name": "stargazer", "active": True},
                  {"category": "x"}), f"attributes after reopen: {got}")
    res = ex.execute("i", " ".join(
        f'SetRowAttrs(frame="t", rowID={r}, category="{c}")'
        for r, c in CATEGORY.items()))
    check(res == [None] * len(CATEGORY), f"bulk SetRowAttrs returned {res}")
    n_ser = min(SERIAL_SLICES, slices)

    def answers():
        return ({label: fn(topn_counts(counts, f1_n))
                 for label, q, fn in TOPN_QUERIES},
                {label: fn(topn_counts(counts[:n_ser], f1_n[:n_ser]))
                 for label, q, fn in TOPN_QUERIES})

    want, want_ser = answers()
    check(want["f"] != want["a"] and not {12, 15} & set(dict(want["f"])),
          f"data: the filter should drop rows 12 and 15, {want['f']}")
    check(sorted(r for r, _ in want["d"]) == [10, 11],
          f"data: Tanimoto 30 should keep rows 10 and 11, {want['d']}")
    check(17 not in dict(want["c"]), f"data: threshold keeps 17 {want['c']}")
    tie = dict(want["b"])
    check(13 in tie and tie.get(13) == tie.get(14),
          f"data: rows 13 and 14 should tie, {want['b']}")
    q_a = TOPN_QUERIES[0][1]
    t0 = time.perf_counter()
    got = ex.execute("i", q_a)[0]
    sync()
    first_s = time.perf_counter() - t0
    check(got == want["a"], f"{q_a}: {got} != oracle {want['a']}")

    serial_ms = []

    def run(tag, labels):
        for path in ("batched", "serial"):
            ex._force_path = path
            span = range(slices) if path == "batched" else range(n_ser)
            for label, q, _ in TOPN_QUERIES:
                if label not in labels:
                    continue
                w = (want if path == "batched" else want_ser)[label]
                t = time.perf_counter()
                got = ex.execute("i", q, slices=span)[0]
                dt = (time.perf_counter() - t) * 1e3
                check(got == w, f"{tag} {path} {q}: {got} != oracle {w}")
                if path == "serial":
                    serial_ms.append(dt)
                print(f"  {tag} {path:7s} {dt:10.2f} ms  ({label}) {q} over "
                      f"{len(span)} slices -> {got}")
        ex._force_path = None

    run("query", "abcdef")
    lat = []
    for _ in range(50):
        t = time.perf_counter()
        got = ex.execute("i", q_a)[0]
        sync()
        lat.append(time.perf_counter() - t)
        check(got == want["a"], "warm TopN (a) changed")
    lat_ms = np.asarray(lat) * 1e3

    # SetBit, then ClearBit, of row 17 on one slice of the serial span at
    # a column of the Src row f0 (so the answer of (e) moves), each
    # followed by (a), (b), (e) and (f) again.
    s = n_ser // 2
    words = t_slice_words(seed, s)
    bit = int(np.flatnonzero(np.unpackbits(
        (~words[7] & slice_words(seed, s)[0]).view(np.uint8),
        bitorder="little"))[0])
    col = s * SLICE_WIDTH + bit
    for verb in ("SetBit", "ClearBit"):
        res = ex.execute("i", f'{verb}(frame="t", rowID=17, columnID={col})')
        check(res == [True], f"{verb} at column {col} returned {res}")
        words[7][bit // 64] ^= np.uint64(1 << (bit % 64))
        counts[s], f1_n[s] = topn_slice_counts(words, slice_words(seed, s))
        want, want_ser = answers()
        run(verb.lower(), "abef")
    launches = launch_counts()
    peak = peak_bytes()
    holder.close()
    check(launches["count_and_rows"] > 0,
          f"count_and_rows never launched on the TopN path: {launches}")
    print(f"topn {card}: open {open_s:.2f} s, first TopN (a) {first_s:.2f}"
          f" s (stacks built), warm TopN (a) over {slices} slices: p50 "
          f"{np.percentile(lat_ms, 50):.3f} ms, p90 "
          f"{np.percentile(lat_ms, 90):.3f} ms, max {lat_ms.max():.3f} ms "
          f"(n=50, host clock to torch.cuda.synchronize()); serial path "
          f"over {n_ser} slices {np.mean(serial_ms):.1f} ms per query (mean "
          f"of {len(serial_ms)}, {min(serial_ms):.1f}-{max(serial_ms):.1f}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches}")
    return launches


# ------------------------------------------------------------ phase 6

SLICE_COLS = 1 << 20
STARS_MIN, STARS_MAX = 0, 1000   # python-pilosa's example field
STARS_DEPTH = 10                 # bit depth of max - min = 1000
# floor(10 · Lomax(shape 1.2)) clipped to [0, 1000], by inverse
# transform at the midpoints of 2^16 equal-probability cells: about 11%
# of the values are 0 and 0.4% are 1000, so both extremes tie.
STARS_TABLE = np.minimum(np.floor(10 * (np.power(
    1 - (np.arange(1 << 16) + 0.5) / (1 << 16), -1 / 1.2) - 1)),
    STARS_MAX).astype(np.int16)
_STARS = 'frame="t", field="stars"'
# Phase 8c's BSI groups: Sum and Max filtered by Union(row a, row b) of
# frame f, eight filters of one structure.
GROUP_FILTERS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (0, 0),
                 (1, 1))
_RANGE = 'Count(Range(frame="t", stars {}))'
BSI_QUERIES = [  # (label, PQL)
    ("a_sum", f"Sum({_STARS})"),
    ("a_avg", f"Average({_STARS})"),
    ("b", f"Sum({SRC.format(0)}, {_STARS})"),
    ("c", _RANGE.format("> 30")),
    ("d", _RANGE.format(">< [10, 60]")),
    ("e", f'Count(Intersect({SRC.format(0)}, Range(frame="t", '
          'stars >= 500)))'),
    ("f_min", f"Min({_STARS})"),
    ("f_max", f"Max({_STARS})"),
    ("f_max_f1", f"Max({SRC.format(1)}, {_STARS})"),
    ("g_eq0", _RANGE.format("== 0")),
    ("g_neq7", _RANGE.format("!= 7")),
    ("g_lt5000", _RANGE.format("< 5000")),
    ("g_gt5000", _RANGE.format("> 5000")),
    ("g_notnull", _RANGE.format("!= null")),
]


def stars_values(seed, s):
    """int16[2^20] values and uint64[16384] not-null words of slice s:
    one column in two holds a value, heavy-tailed like GitHub stars
    (STARS_TABLE)."""
    rng = np.random.default_rng([seed, s, 2])
    v = STARS_TABLE[rng.integers(0, 1 << 16, SLICE_COLS, dtype=np.uint16)]
    return v, rng.integers(0, 1 << 64, SLICE_COLS // 64, dtype=np.uint64)


def _bits(words):
    return np.unpackbits(words.view(np.uint8), bitorder="little").astype(
        bool)


def stars_rows(v, nn):
    """uint64[11, 16384]: the 10 bit planes of the values and the
    not-null row, as the field view stores them."""
    planes = np.stack([np.packbits((v >> i).astype(np.uint8) & 1,
                                   bitorder="little")
                       for i in range(STARS_DEPTH)]).view(np.uint64)
    return np.concatenate([planes & nn, nn[None]])


def bsi_slice_hist(v, nn, f):
    """(int32[3, 1001], int64[len(GROUP_FILTERS), 4]): one slice's
    histograms of the values of every column with a value, of those in
    frame f's row 0, and of those in row 1 — every BSI answer of the
    oracle derives from them — and per filter of GROUP_FILTERS (Union of
    rows a and b) the sum, the count, the largest value and its count of
    the values in it (phase 8c's groups). One bincount over each
    column's membership pattern in rows 0-3 serves them all."""
    has = _bits(nn)
    code = np.zeros(SLICE_COLS, np.uint8)
    for r in range(4):
        code |= _bits(f[r]).view(np.uint8) << r
    h16 = np.bincount((code[has].astype(np.int32) << 10) | v[has],
                      minlength=16 << 10).reshape(16, 1024)[:, :STARS_MAX + 1]
    pat = np.arange(16)
    hist = np.stack([h16.sum(axis=0), h16[(pat & 1) > 0].sum(axis=0),
                     h16[(pat & 2) > 0].sum(axis=0)]).astype(np.int32)
    k = np.arange(STARS_MAX + 1)
    stats = np.zeros((len(GROUP_FILTERS), 4), np.int64)
    for j, (a, b) in enumerate(GROUP_FILTERS):
        h = h16[((pat >> a) & 1) | ((pat >> b) & 1) > 0].sum(axis=0)
        have = np.flatnonzero(h)
        top = int(have[-1]) if len(have) else 0
        stats[j] = ((k * h).sum(), h.sum(), top, h[top] if len(have) else 0)
    return hist, stats


def _write_stars_slices(frag_dir, seed, lo, hi):
    """Worker: the ``field_stars`` fragment files of slices [lo, hi) —
    rows 0-9 the value bits, row 10 the not-null row — written by the
    port's codec; returns their oracle histograms."""
    from pilosa_tpu_torch.roaring import codec

    keys = np.arange((STARS_DEPTH + 1) * 16, dtype=np.uint64)
    hist = np.zeros((hi - lo, 3, STARS_MAX + 1), np.int32)
    gstats = np.zeros((hi - lo, len(GROUP_FILTERS), 4), np.int64)
    for i, s in enumerate(range(lo, hi)):
        v, nn = stars_values(seed, s)
        with open(os.path.join(frag_dir, str(s)), "wb") as fh:
            fh.write(codec.serialize_arrays(
                keys, stars_rows(v, nn).reshape(-1, 1024)))
        hist[i], gstats[i] = bsi_slice_hist(v, nn, slice_words(seed, s))
    return lo, hist, gstats


def group_answers(gstats):
    """{PQL: answer} of the Sum and Max over every GROUP_FILTERS filter
    from the stacked per-slice stats of ``bsi_slice_hist``."""
    from pilosa_tpu_torch.executor import SumCount

    out = {}
    for j, (a, b) in enumerate(GROUP_FILTERS):
        g = gstats[:, j]
        flt = f"Union({SRC.format(a)}, {SRC.format(b)})"
        count = int(g[:, 1].sum())
        out[f"Sum({flt}, {_STARS})"] = SumCount(
            int(g[:, 0].sum()) + count * STARS_MIN, count)
        have = g[g[:, 1] > 0]
        top = int(have[:, 2].max()) if len(have) else 0
        out[f"Max({flt}, {_STARS})"] = (
            SumCount(top + STARS_MIN, int(have[have[:, 2] == top, 3].sum()))
            if len(have) else SumCount(0, 0))
    return out


def bsi_answers(hist):
    """Every BSI_QUERIES answer over the slices of ``hist`` (stacked
    bsi_slice_hist), as the executor returns it."""
    from pilosa_tpu_torch.executor import SumCount

    h_all, h_f0, h_f1 = hist.sum(axis=0, dtype=np.int64)
    k = np.arange(STARS_MAX + 1)

    def total(h):
        return SumCount(int((k * h).sum()), int(h.sum()))

    def extreme(h, find_max):
        have = np.flatnonzero(h)
        if not len(have):
            return SumCount(0, 0)
        x = int(have[-1] if find_max else have[0])
        return SumCount(x, int(h[x]))

    n = int(h_all.sum())
    return {
        "a_sum": total(h_all), "a_avg": total(h_all), "b": total(h_f0),
        "c": int(h_all[31:].sum()), "d": int(h_all[10:61].sum()),
        "e": int(h_f0[500:].sum()),
        "f_min": extreme(h_all, False), "f_max": extreme(h_all, True),
        "f_max_f1": extreme(h_f1, True),
        "g_eq0": int(h_all[0]), "g_neq7": n - int(h_all[7]),
        "g_lt5000": n, "g_gt5000": 0, "g_notnull": n,
    }


def bsi_path(slices, seed, datadir, card, oracle):
    """Phase 6: the BSI field ``stars`` on frame t, every BSI query on
    both paths against the numpy oracle, before and after
    SetFieldValue; leaves the answers after the writes in ``oracle``."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import bsi as bsi_ops
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage.frame import Field, Frame
    from pilosa_tpu_torch.storage.holder import Holder
    from pilosa_tpu_torch.storage.view import view_field_name

    # Frame t keeps only the field: phase 5's rows are dropped, so the
    # open reads f and the field and the card holds their mirrors alone.
    # A range-enabled frame has no TopN cache (Index.create_frame).
    frame_dir = os.path.join(datadir, "i", "t")
    shutil.rmtree(os.path.join(frame_dir, "views", "standard"))
    frame = Frame(frame_dir, "i", "t")
    frame.load_meta()
    frame.range_enabled = True
    frame.cache_type = "none"
    frame.create_field(Field("stars", min=STARS_MIN, max=STARS_MAX))
    check(frame.field("stars").bit_depth() == STARS_DEPTH, "bit depth")
    frag_dir = os.path.join(frame_dir, "views", view_field_name("stars"),
                            "fragments")
    os.makedirs(frag_dir)
    t0 = time.perf_counter()
    hist = np.zeros((slices, 3, STARS_MAX + 1), np.int32)
    gstats = np.zeros((slices, len(GROUP_FILTERS), 4), np.int64)
    procs, parts = in_processes(_write_stars_slices, frag_dir, seed, slices)
    for lo, h, g in parts:
        hist[lo:lo + len(h)] = h
        gstats[lo:lo + len(g)] = g
    write_s = time.perf_counter() - t0
    print(f"bsi: wrote field stars (min {STARS_MIN}, max {STARS_MAX}, "
          f"depth {STARS_DEPTH}) on frame t, {STARS_DEPTH + 1} rows x "
          f"{slices} slices ({slices * (STARS_DEPTH + 1) * 16384 * 8 / 1e9:.2f}"
          f" GB of rows), {int(hist[:, 0].sum())} values, in {procs} "
          f"processes in {write_s:.1f} s")

    reset_peak()
    kernels.reset_launches()
    t0 = time.perf_counter()
    holder = Holder(datadir, device=DEVICE).open()
    open_s = time.perf_counter() - t0
    check(holder.index("i").max_slice() == slices - 1, "max_slice")
    ex = Executor(holder)
    want = bsi_answers(hist)
    for label in ("f_min", "f_max", "f_max_f1"):
        check(want[label].count > 1, f"data: {label} has no tie, "
              f"{want[label]}")
    check(want["f_min"].sum == STARS_MIN and want["f_max"].sum == STARS_MAX,
          f"data: extremes {want['f_min']} {want['f_max']}")
    queries = dict(BSI_QUERIES)
    t0 = time.perf_counter()
    got = ex.execute("i", queries["a_sum"])[0]
    sync()
    first_s = time.perf_counter() - t0
    check(got == want["a_sum"], f"{queries['a_sum']}: {got} != oracle "
          f"{want['a_sum']}")

    serial_ms = {}
    n_ser = min(SERIAL_SLICES, slices)
    want_ser = bsi_answers(hist[:n_ser])

    def run(tag, labels):
        for path in ("batched", "serial"):
            ex._force_path = path
            span = range(slices) if path == "batched" else range(n_ser)
            for label in labels:
                q = queries[label]
                w = (want if path == "batched" else want_ser)[label]
                t = time.perf_counter()
                got = ex.execute("i", q, slices=span)[0]
                dt = (time.perf_counter() - t) * 1e3
                check(got == w, f"{tag} {path} {q}: {got} != oracle {w}")
                if path == "serial":
                    serial_ms.setdefault(label, []).append(dt / n_ser)
                print(f"  {tag} {path:7s} {dt:10.2f} ms  ({label}) {q} -> "
                      f"{got}")
        ex._force_path = None

    run("query", [label for label, _ in BSI_QUERIES])
    lat = {}
    for label in ("a_sum", "b", "c", "f_max"):
        ms = []
        for _ in range(50):
            t = time.perf_counter()
            got = ex.execute("i", queries[label])[0]
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            check(got == want[label], f"warm ({label}) changed")
        lat[label] = np.asarray(ms)

    # The descent of (c) alone, on the cached stacks.
    view = view_field_name("stars")
    bsi_stacks = [ex._leaf_stack("i", ("t", view, i), range(slices))
                  for i in range(STARS_DEPTH + 1)]
    bits = bsi_ops.value_to_bits(30, STARS_DEPTH)
    descent_ms = timed_ms(lambda: bsi_ops.bsi_gt(bsi_stacks[:-1],
                                                 bsi_stacks[-1], bits),
                          reps=10)
    del bsi_stacks

    # SetFieldValue: a column without a value gets 1000, a column with a
    # value in [100, 999] gets half of it; (a), (c) and Max move.
    s = n_ser // 2
    v, nn = stars_values(seed, s)
    has = _bits(nn)
    empty_col = int(np.flatnonzero(~has)[0])
    low_col = int(np.flatnonzero(has & (v >= 100) & (v < STARS_MAX))[0])
    for col, value in ((empty_col, STARS_MAX),
                       (low_col, int(v[low_col]) // 2)):
        res = ex.execute("i", f'SetFieldValue(frame="t", '
                              f'columnID={s * SLICE_WIDTH + col}, '
                              f'stars={value})')
        check(res == [None], f"SetFieldValue returned {res}")
        v[col] = value
        nn[col // 64] |= np.uint64(1 << (col % 64))
    hist[s], gstats[s] = bsi_slice_hist(v, nn, slice_words(seed, s))
    want, want_ser = bsi_answers(hist), bsi_answers(hist[:n_ser])
    run("setfieldvalue", ["a_sum", "c", "f_max"])
    launches = launch_counts()
    peak = peak_bytes()
    holder.close()
    check(all(launches[k] for k in QUERY_KERNELS),
          f"a kernel never launched on the BSI path: {launches}")

    def pct(label):
        a = lat[label]
        return (f"({label}) p50 {np.percentile(a, 50):.3f} ms, p90 "
                f"{np.percentile(a, 90):.3f} ms, max {a.max():.3f} ms")

    oracle.update(stars_sum=want["a_sum"], stars_gt30=want["c"],
                  stars_written=s, group_bsi=group_answers(gstats))
    print(f"bsi {card}: open {open_s:.2f} s, first Sum {first_s:.2f} s "
          f"(stacks built from the files); warm batched over {slices} slices "
          f"(n=50 each, host clock to torch.cuda.synchronize()): "
          f"{'; '.join(pct(lb) for lb in lat)}; descent of (c) alone "
          f"{descent_ms:.4f} ms (CUDA events, 10 reps); serial path over "
          f"{n_ser} slices, ms per slice: " + ", ".join(
              f"{lb} {np.mean(v):.3f}" for lb, v in serial_ms.items())
          + f"; max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches}")
    return launches


# ------------------------------------------------------------ phase 8

NEW_ROW = 100                   # the row phase 8 imports into frame f
IMPORT_PER_SLICE = 12500        # its bits per slice, over 8 slices
CLI_LINES = 10000               # lines of the CSV that 8b imports


def http_request(conn, method, path, body=b"", headers=None):
    """(status, content type, body) of one request on a keep-alive
    ``http.client`` connection."""
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, resp.getheader("Content-Type"), resp.read()


def raw_post(sock, reader, host, path, body):
    """POST ``body`` on a keep-alive socket and read the response by its
    Content-Length; -> the response body."""
    sock.sendall(b"POST %s HTTP/1.1\r\nHost: %s\r\nContent-Length: %d"
                 b"\r\n\r\n%s" % (path.encode(), host.encode(), len(body),
                                    body))
    n = None
    while True:
        line = reader.readline()
        check(line, "raw_post: connection closed")
        if line == b"\r\n":
            break
        if line.lower().startswith(b"content-length:"):
            n = int(line.split(b":", 1)[1])
    return reader.read(n)


def http_json(conn, method, path, body=b"", headers=None):
    status, ctype, data = http_request(conn, method, path, body, headers)
    check(status == 200 and ctype == "application/json",
          f"{method} {path}: {status} {ctype} {data[:200]!r}")
    return json.loads(data)


def http_query(conn, pql):
    """The results of one PQL query, JSON over HTTP."""
    return http_json(conn, "POST", "/index/i/query", pql.encode())["results"]


TRACE_WARM = 100   # (a)'s warm Count(Intersect)s a mode
# Kernel times of phase 3 (ms), beside which the spans' deviceMs is
# printed and held, within TRACE_DEVICE_TOL of it (a full run only).
KERNEL_MS = {}
TRACE_DEVICE_TOL = 0.05


def span_find(node, name):
    """The spans named ``name`` in the tree under ``node``, itself
    included, depth first."""
    out = [node] if node["name"] == name else []
    for c in node["children"]:
        out.extend(span_find(c, name))
    return out


def span_lines(node, depth=0, out=None, limit=40):
    """A span tree as indented "name ms tags" lines, ``limit`` at most."""
    out = [] if out is None else out
    if len(out) < limit:
        out.append(f"{'  ' * depth}{node['name']} {node['durationMs']} ms "
                   f"{json.dumps(node['tags'])}")
        for c in node["children"]:
            span_lines(c, depth + 1, out, limit)
    return out


def trace_overhead(server, conn, q_and, want, slices, card):
    """Phase 8a (a): warm Count(Intersect) over HTTP with tracing off, on
    (a Tracer on the server's handler, as ``Server(trace_enabled=True)``
    builds it) and with ``?profile=true`` on the server with tracing off,
    TRACE_WARM queries each, p50 and p90 on the host clock. The answers
    with tracing on are the bytes of those with it off, and every
    profile's results equal numpy's; the profile's tree runs from
    ``query`` to ``parse`` and ``call:Count`` down to
    ``kernel:count_op_rows`` with ``deviceMs``, whose p50 is printed
    beside the kernel's time in phase 3's table and held within
    TRACE_DEVICE_TOL of it. The latencies are report only."""
    from pilosa_tpu_torch import tracing

    handler = server.handler
    path = "/index/i/query"
    want_body = json.dumps({"results": [want]}).encode()
    out, dev_ms, prof = {}, [], None
    try:
        for mode in ("off", "on", "profile", "off2"):
            handler.tracer = (tracing.Tracer() if mode == "on"
                              else tracing.NOP)
            url = path + ("?profile=true" if mode == "profile" else "")
            lat = []
            for _ in range(TRACE_WARM):
                t = time.perf_counter()
                status, ctype, body = http_request(conn, "POST", url,
                                                   q_and.encode())
                lat.append((time.perf_counter() - t) * 1e3)
                check(status == 200 and ctype == "application/json",
                      f"(a) {mode}: {status} {ctype} {body[:200]!r}")
                if mode == "profile":
                    doc = json.loads(body)
                    check(doc["results"] == [want],
                          f"(a) profiled Count: {doc['results']} != {want}")
                    prof = doc["profile"]
                    dev_ms.extend(k["tags"].get("deviceMs") for k in
                                  span_find(prof["roots"][0],
                                            "kernel:count_op_rows"))
                else:
                    check(body == want_body, f"(a) tracing {mode}: "
                          f"{body[:200]!r} != {want_body!r}")
            out[mode] = (np.percentile(lat, 50), np.percentile(lat, 90))
            if mode == "on":
                got = handler.tracer.summary()["traces"]
                check(got == TRACE_WARM, f"(a) {got} traces kept of "
                      f"{TRACE_WARM}")
    finally:
        handler.tracer = server.tracer
    (root,) = prof["roots"]
    names = [c["name"] for c in root["children"]]
    calls = [c for c in root["children"] if c["name"] == "call:Count"]
    check(root["name"] == "query" and names[:1] == ["parse"] and calls,
          f"(a) profile tree: {root['name']} -> {names}")
    kern = span_find(calls[0], "kernel:count_op_rows")
    check(kern and (DEVICE != "cuda" or all(
        k["tags"].get("deviceMs", 0) > 0 for k in kern)),
          f"(a) no kernel:count_op_rows span with deviceMs under "
          f"call:Count: {span_lines(root)}")
    check(prof["resources"]["slices"] == slices,
          f"(a) profile slices {prof['resources']['slices']} != {slices}")
    dev_ms = np.asarray([d for d in dev_ms if d is not None] or [np.nan])
    table = KERNEL_MS.get("count_op_rows")
    if table and DEVICE == "cuda":
        check(abs(np.median(dev_ms) - table) <= TRACE_DEVICE_TOL * table,
              f"(a) kernel:count_op_rows deviceMs p50 "
              f"{np.median(dev_ms):.4f} ms is not within "
              f"{TRACE_DEVICE_TOL:.0%} of phase 3's {table:.4f} ms")
    print(f"trace (a) {card}: warm Count(Intersect) over {slices} slices "
          f"over HTTP (n={TRACE_WARM} each, host clock): tracing off p50 "
          f"{out['off'][0]:.3f} ms, p90 {out['off'][1]:.3f}; on p50 "
          f"{out['on'][0]:.3f}, p90 {out['on'][1]:.3f}; ?profile=true p50 "
          f"{out['profile'][0]:.3f}, p90 {out['profile'][1]:.3f}; off again "
          f"p50 {out['off2'][0]:.3f}, p90 {out['off2'][1]:.3f}; "
          f"kernel:count_op_rows deviceMs p50 {np.median(dev_ms):.4f} ms "
          f"(min {dev_ms.min():.4f}, n={len(dev_ms)}) beside phase 3's "
          f"{'%.4f ms' % table if table else 'table time (not run)'}; "
          f"answers with tracing on byte-equal to off and to numpy")
    print("trace (a) profile tree:\n  " + "\n  ".join(span_lines(root)))


def server_path(slices, seed, datadir, card, oracle):
    """Phase 8a: the in-process ``Server`` on the card over phases 4-6's
    data directory, driven over one keep-alive connection; every answer
    against the oracles of phases 4 and 6 and the numpy oracle of its
    own writes. Returns the launches of the run."""
    import http.client
    import socket

    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server import wireproto
    from pilosa_tpu_torch.server.handler import result_to_json
    from pilosa_tpu_torch.server.server import Server

    t0 = time.perf_counter()
    server = Server(datadir, bind="127.0.0.1:0", device=DEVICE).open()
    open_s = time.perf_counter() - t0
    host, port = server.host.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    reset_peak()
    kernels.reset_launches()
    try:
        schema = [{"name": "i", "frames": [
            {"name": "f", "views": [{"name": "standard"}]},
            {"name": "t", "views": [{"name": "field_stars"}]}]}]
        got = http_json(conn, "GET", "/status")
        check(got == {"status": {"state": "NORMAL", "nodes": [],
                                 "indexes": schema}}, f"/status {got}")
        got = http_json(conn, "GET", "/schema")
        check(got == {"indexes": schema}, f"/schema {got}")

        # Count(Intersect), JSON and protobuf, then warm over HTTP.
        q_and = QUERIES[2][0]
        want = oracle["count_and"]
        t = time.perf_counter()
        got = http_query(conn, q_and)
        first_s = time.perf_counter() - t
        check(got == [want], f"HTTP {q_and}: {got} != oracle {want}")
        status, ctype, data = http_request(
            conn, "POST", "/index/i/query",
            wireproto.encode_query_request(q_and),
            {"Content-Type": "application/x-protobuf"})
        got = wireproto.decode_query_response(data)
        check(status == 200 and ctype == "application/x-protobuf"
              and got == {"error": None, "results": [want]},
              f"protobuf {q_and}: {status} {ctype} {got}")
        lat = []
        for _ in range(100):
            t = time.perf_counter()
            got = http_query(conn, q_and)
            lat.append((time.perf_counter() - t) * 1e3)
            check(got == [want], "warm HTTP Count(Intersect) changed")
        lat = np.asarray(lat)
        p50, p90 = np.percentile(lat, 50), np.percentile(lat, 90)
        # The handler alone, in this thread: parse, execute and JSON
        # without the HTTP transport.
        want_body = json.dumps({"results": [want]}).encode()
        disp_ms, got = p50_ms(lambda: server.handler.dispatch(
            "POST", "/index/i/query", {}, q_and.encode(), {}), 100)
        check(got == (200, "application/json", want_body),
              f"Handler.dispatch {q_and}: {got}")
        # The same request from a raw socket: the server's transport
        # without http.client's request and response handling.
        sock = socket.create_connection((host, int(port)), timeout=60)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with sock, sock.makefile("rb") as reader:
            raw_ms, got = p50_ms(lambda: raw_post(
                sock, reader, server.host, "/index/i/query",
                q_and.encode()), 100)
        check(got == want_body, f"raw-socket {q_and}: {got}")
        print(f"server {card}: open {open_s:.2f} s, first Count(Intersect) "
              f"{first_s:.2f} s; warm Count(Intersect) over {slices} slices "
              f"over HTTP (JSON, one keep-alive connection, n=100, host "
              f"clock): p50 {p50:.3f} ms, p90 {p90:.3f} ms, max "
              f"{lat.max():.3f} ms; in process (phase 4) p50 "
              f"{oracle['count_p50_ms']:.3f} ms; HTTP and JSON "
              f"{p50 - oracle['count_p50_ms']:.3f} ms; Handler.dispatch "
              f"alone p50 {disp_ms:.3f} ms; from a raw keep-alive socket "
              f"p50 {raw_ms:.3f} ms (n=100 each)")
        trace_overhead(server, conn, q_and, want, slices, card)

        # TopN over frame f (its .cache sidecars hold rows 0-3).
        q = f'TopN({R0}, frame="f", n=4)'
        got = http_query(conn, q)
        want = [[{"id": r, "count": c} for r, c in oracle["topn_f0"]]]
        check(got == want, f"HTTP {q}: {got} != oracle {want}")
        print(f"  {q} -> {got[0]}")

        # BSI after phase 6's writes.
        q_sum = 'Sum(frame="t", field="stars")'
        q_gt = 'Count(Range(frame="t", stars > 30))'
        s_want = oracle["stars_sum"]
        got = http_query(conn, f"{q_sum} {q_gt}")
        check(got == [{"sum": s_want.sum, "count": s_want.count},
                      oracle["stars_gt30"]],
              f"HTTP {q_sum} {q_gt}: {got} != oracle "
              f"{s_want} {oracle['stars_gt30']}")
        print(f"  {q_sum} {q_gt} -> {got}")

        # The batched Intersect's ids, id by id, then its time split
        # into the query, the ids' extraction and the JSON encoding.
        q_ids = BITMAP_QUERIES[1][0]
        status, ctype, body = http_request(conn, "POST", "/index/i/query",
                                           q_ids.encode())
        check(status == 200 and ctype == "application/json",
              f"HTTP {q_ids}: {status} {ctype}")
        bits = json.loads(body)["results"][0]["bits"]
        check(np.array_equal(np.asarray(bits, dtype=np.uint64),
                             oracle["and_ids"]),
              f"HTTP {q_ids}: {len(bits)} ids != oracle "
              f"{len(oracle['and_ids'])}")
        del bits
        http_ms = []
        for _ in range(5):
            t = time.perf_counter()
            got = http_request(conn, "POST", "/index/i/query",
                               q_ids.encode())
            http_ms.append((time.perf_counter() - t) * 1e3)
            check(got == (status, ctype, body), "HTTP Intersect changed")
        ex = server.executor
        query_ms, bm = p50_ms(lambda: ex.execute("i", q_ids)[0], 5)
        cols_ms, cols = p50_ms(bm.columns, 5)
        json_ms, _ = p50_ms(lambda: json.dumps({"results": [
            {"attrs": bm.attrs, "bits": cols.tolist()}]}).encode(), 5)
        check(json.dumps({"results": [result_to_json(bm)]}).encode()
              == body, "in-process JSON != HTTP body")
        h50 = np.percentile(http_ms, 50)
        print(f"server {card}: {q_ids} over HTTP (JSON, n=5, host clock) "
              f"p50 {h50:.1f} ms for {len(cols)} ids, {len(body)} bytes of "
              f"body; in process p50: query {query_ms:.3f} ms, columns() "
              f"{cols_ms:.3f} ms, JSON encoding {json_ms:.1f} ms "
              f"({json_ms / h50:.1%} of the HTTP p50)")
        del body, cols, bm

        launches_a = launch_counts()
        launches_c = concurrency_path(server, slices, seed, oracle, card)
        kernels.reset_launches()

        # SetBit over HTTP where row 0 has the bit and row 1 does not.
        s = min(SERIAL_SLICES, slices) // 2 + 1
        words = slice_words(seed, s)
        bit = int(np.flatnonzero(np.unpackbits(
            (words[0] & ~words[1]).view(np.uint8), bitorder="little"))[0])
        col = s * SLICE_WIDTH + bit
        got = http_query(conn, f'SetBit(frame="f", rowID=1, columnID={col})')
        check(got == [True], f"HTTP SetBit at {col}: {got}")
        want_and = oracle["count_and"] + 1
        got = http_query(conn, q_and)
        check(got == [want_and], f"HTTP {q_and} after SetBit: {got} != "
              f"{want_and}")

        # Protobuf import of a new row over 8 slices, one past the last.
        rng = np.random.default_rng([seed, 8])
        imp_slices = sorted(set(np.linspace(0, slices - 1, 7).astype(
            int).tolist()) | {slices})
        new_cols = {}
        t = time.perf_counter()
        for sl in imp_slices:
            c = np.sort(rng.choice(SLICE_COLS, IMPORT_PER_SLICE,
                                   replace=False)) + sl * SLICE_WIDTH
            new_cols[sl] = c
            status, _, data = http_request(
                conn, "POST", "/import", wireproto.encode_import_request(
                    "i", "f", sl, np.full(len(c), NEW_ROW), c),
                {"Content-Type": "application/x-protobuf"})
            check((status, data) == (200, b"{}"),
                  f"POST /import slice {sl}: {status} {data[:200]!r}")
        import_s = time.perf_counter() - t
        n_new = sum(len(c) for c in new_cols.values())
        got = http_query(conn, f'Count({ROW.format(NEW_ROW)})')
        check(got == [n_new], f"Count of the imported row: {got} != {n_new}")
        got = http_json(conn, "GET", "/slices/max")
        check(got == {"maxSlices": {"i": slices}}, f"/slices/max {got}")
        got = http_query(conn, q_and)
        check(got == [want_and], f"{q_and} after the import: {got}")

        # Protobuf import-value of 1,000 values into empty columns.
        s = slices - 1 if slices - 1 != oracle["stars_written"] else 0
        v, nn = stars_values(seed, s)
        empty = np.flatnonzero(~_bits(nn))
        vcols = np.sort(rng.choice(empty, 1000, replace=False))
        vals = rng.integers(STARS_MIN, STARS_MAX + 1, 1000)
        status, _, data = http_request(
            conn, "POST", "/import-value",
            wireproto.encode_import_value_request(
                "i", "t", s, "stars", vcols + s * SLICE_WIDTH, vals),
            {"Content-Type": "application/x-protobuf"})
        check((status, data) == (200, b"{}"),
              f"POST /import-value: {status} {data[:200]!r}")
        want = [{"sum": s_want.sum + int(vals.sum()),
                 "count": s_want.count + len(vals)},
                oracle["stars_gt30"] + int((vals > 30).sum())]
        got = http_query(conn, f"{q_sum} {q_gt}")
        check(got == want, f"{q_sum} {q_gt} after import-value: {got} != "
              f"{want}")

        # Export of the slice past the last: the new row alone.
        status, ctype, data = http_request(
            conn, "GET", f"/export?index=i&frame=f&slice={slices}")
        want = "".join(f"{NEW_ROW},{c}\n" for c in new_cols[slices].tolist())
        check((status, ctype) == (200, "text/csv")
              and data == want.encode(),
              f"GET /export slice {slices}: {status} {ctype}, "
              f"{len(data)} bytes != {len(want)}")
        print(f"  SetBit and recount ({want_and}); POST /import of {n_new} "
              f"bits of row {NEW_ROW} over slices {imp_slices} in "
              f"{import_s:.2f} s, its Count and /slices/max; POST "
              f"/import-value of 1000 stars and Sum; GET /export of slice "
              f"{slices} ({len(data)} bytes) equal to numpy {card}")
        launches = add_counts(launches_a, launch_counts())
        peak = peak_bytes()
    finally:
        conn.close()
        server.close()
    check(all(launches[k] for k in QUERY_KERNELS),
          f"a kernel never launched on the server path: {launches}")
    print(f"server {card}: max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"launches {launches} (8c's apart)")
    return [launches, launches_c]


# ----------------------------------------------------------- phase 8c

CONC_CLIENTS = (1, 8, 32)     # concurrent clients per point
# Each point's warm-up and measured window. reduced: 0.5 s and 2 s, not
# 5 s (3 s, with 2 s of warm-up, until the script took 1,090.4 s of its
# 1,200 s limit on a slower host; 1 s of warm-up until phase 12's steps
# (g)-(j) added ~50 s to 1,084.7 s; PERF.md §4).
CONC_WARM_S = 0.5
CONC_MEASURE_S = 2.0
CONC_GROUP_REPS = 3           # timed rounds of each BSI group
CONC_PROCS = 8                # client processes (threads share them)
CONC_ROW = 9                  # the row the mixed mix writes; none reads it
CONC_TOPN = f'TopN({SRC.format(0)}, frame="t", n=5)'


def _conc_client(host, port, mode, tids, seed, pair_counts, slices,
                 start_ts, warm_s, measure_s):
    """Client process (it imports no torch): one thread per client id
    in ``tids``, each on one keep-alive ``http.client`` connection,
    from ``start_ts`` (a cross-process start barrier on the wall clock)
    for ``warm_s`` + ``measure_s``. The count mix asks
    Count(Intersect(row a, row b)) of frame f, (a, b) drawn from rows
    0-3 per request by the client's seed; the mixed mix replaces ~15% by
    CONC_TOPN and ~5% by a SetBit of row CONC_ROW at a column spread
    per request. Every answer is checked: a Count against
    ``pair_counts``, the TopN against [] (phase 6 dropped frame t's
    rows), a SetBit's against a bool. Returns (requests in the window,
    their latencies in ms by kind, the first mismatch or error)."""
    import http.client
    import socket
    import threading

    out = {"n": 0, "lat": {"count": [], "topn": [], "setbit": []},
           "bad": None}
    mu = threading.Lock()
    t_meas, t_end = start_ts + warm_s, start_ts + warm_s + measure_s

    def client(tid):
        rng = np.random.default_rng([seed, 8, tid])
        conn = http.client.HTTPConnection(host, port, timeout=600)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        lat = {"count": [], "topn": [], "setbit": []}
        n = k = 0
        while time.time() < start_ts:
            time.sleep(0.002)
        try:
            while True:
                now = time.time()
                if now >= t_end:
                    break
                k += 1
                r = rng.random() if mode == "mixed" else 1.0
                if r < 0.05:
                    kind = "setbit"
                    col = ((tid * 104729 + k) * 7919) % (slices << 20)
                    q = (f'SetBit(frame="f", rowID={CONC_ROW}, '
                         f'columnID={col})')
                elif r < 0.20:
                    kind, q = "topn", CONC_TOPN
                else:
                    kind = "count"
                    a, b = (int(x) for x in rng.integers(0, 4, 2))
                    q = f"Count(Intersect({SRC.format(a)}, {SRC.format(b)}))"
                t = time.perf_counter()
                conn.request("POST", "/index/i/query", body=q.encode())
                resp = conn.getresponse()
                body = resp.read()
                dt = (time.perf_counter() - t) * 1e3
                got = (json.loads(body)["results"][0]
                       if resp.status == 200 else None)
                ok = (got == [] if kind == "topn"
                      else isinstance(got, bool) if kind == "setbit"
                      else got == int(pair_counts[a][b]))
                if not ok:
                    raise ValueError(f"{q}: {resp.status} {body[:200]!r}")
                if now >= t_meas:
                    n += 1
                    lat[kind].append(dt)
        except Exception as exc:  # noqa: BLE001 — reported to the phase
            with mu:
                out["bad"] = out["bad"] or f"client {tid}: {exc}"
        finally:
            conn.close()
        with mu:
            out["n"] += n
            for kd, v in lat.items():
                out["lat"][kd].extend(v)

    threads = [threading.Thread(target=client, args=(t,)) for t in tids]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def concurrency_path(server, slices, seed, oracle, card):
    """Phase 8c, inside 8a's server over phase 6's directory: clients in
    processes of their own at 1, 8 and 32 for the count and the mixed
    mix, then 32 with the coalescer off; the BSI groups in process; the
    result memos' warm repeats. Result memos and the response cache are
    off for the points (PILOSA_TPU_RESULT_MEMO=0), as pilosa_tpu's
    benchmarks/concurrency.py measures. Returns the launches of the
    phase; fails on any mismatch against phases 4-6's oracles."""
    import threading

    from pilosa_tpu_torch.ops import kernels

    ex = server.executor
    host, port = server.host.rsplit(":", 1)
    pair_counts = oracle["pair_counts"].tolist()
    # The count mix's Count(Intersect(row 3, row 3)) (a pair in 16) is
    # all-compressed and takes the container lanes: its first run builds
    # row 3's containers on every slice and packs them, here (timed)
    # rather than inside a measured window.
    q33 = f"Count(Intersect({SRC.format(3)}, {SRC.format(3)}))"
    route = count_route(ex, "i", q33, range(slices))
    t = time.perf_counter()
    got = ex.execute("i", q33)[0]
    first33 = time.perf_counter() - t
    check(got == pair_counts[3][3], f"{q33}: {got} != {pair_counts[3][3]}")
    p50_33, got = p50_ms(lambda: ex.execute("i", q33)[0], 3)
    check(got == pair_counts[3][3], f"warm {q33} changed")
    print(f"  {q33}: route {route}, first {first33:.2f} s, p50 "
          f"{p50_33:.1f} ms (n=3) {card}")
    kernels.reset_launches()
    t_phase = time.perf_counter()
    points = [(m, c, True) for m in ("count", "mixed") for c in CONC_CLIENTS]
    points += [("count", 32, False), ("mixed", 32, False)]
    rows = []
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(CONC_PROCS) as pool:
        pool.map(time.sleep, [0] * CONC_PROCS)   # workers up and imported
        for mode, n_clients, coalesce in points:
            ex._co_enabled_memo = coalesce
            procs = min(n_clients, CONC_PROCS)
            jobs = [list(range(p, n_clients, procs)) for p in range(procs)]
            start_ts = time.time() + 0.5
            res = pool.starmap_async(_conc_client, [
                (host, int(port), mode, tids, seed, pair_counts, slices,
                 start_ts, CONC_WARM_S, CONC_MEASURE_S) for tids in jobs])
            time.sleep(max(0.0, start_ts + CONC_WARM_S - time.time()))
            l0 = dict(kernels.launches)
            st0 = dict(ex._co_stats)
            ex._co_stats["max_group"] = 0
            time.sleep(max(0.0, start_ts + CONC_WARM_S + CONC_MEASURE_S
                           - time.time()))
            l1 = dict(kernels.launches)
            st1 = dict(ex._co_stats)
            outs = res.get(timeout=600)
            bad = [o["bad"] for o in outs if o["bad"]]
            check(not bad, f"8c {mode} x {n_clients}: {bad[:3]}")
            n = sum(o["n"] for o in outs)
            lat = np.asarray([x for o in outs for v in o["lat"].values()
                              for x in v])
            cnt = np.asarray([x for o in outs for x in o["lat"]["count"]])
            check(n > 0, f"8c {mode} x {n_clients}: no request in the window")
            launched = sum(l1[k] - l0[k] for k in l1)
            row = {"mode": mode, "clients": n_clients, "coalesce": coalesce,
                   "qps": n / CONC_MEASURE_S,
                   "p50": float(np.percentile(lat, 50)),
                   "p99": float(np.percentile(lat, 99)),
                   "count_p50": float(np.percentile(cnt, 50)),
                   "rounds": st1["rounds"] - st0["rounds"],
                   "fused": st1["fused_queries"] - st0["fused_queries"],
                   "max_group": st1["max_group"],
                   "launches_per_query": launched / n,
                   "pairs": l1["count_op_pairs"] - l0["count_op_pairs"]}
            rows.append(row)
            print(f"8c {mode:5s} x {n_clients:2d} clients, coalescer "
                  f"{'on ' if coalesce else 'off'}: {row['qps']:.1f} q/s, "
                  f"p50 {row['p50']:.3f} ms, p99 {row['p99']:.3f} ms "
                  f"(Count p50 {row['count_p50']:.3f}), rounds "
                  f"{row['rounds']}, fused_queries {row['fused']}, max_group "
                  f"{row['max_group']}, launches/query "
                  f"{row['launches_per_query']:.3f} (count_op_pairs "
                  f"{row['pairs']}) over {CONC_MEASURE_S:.0f} s after "
                  f"{CONC_WARM_S:g} s of warm-up {card}")
    ex._co_enabled_memo = True
    top = [r for r in rows if r["mode"] == "count" and r["clients"] == 32
           and r["coalesce"]][0]
    check(top["fused"] > 0 and top["max_group"] > 1,
          f"8c: 32 clients on the count mix formed no group: {top}")

    # BSI groups in process: GROUP_FILTERS-filtered Sums, then Maxes,
    # released together by a Barrier, against the same queries served
    # one after another with the coalescer off; after a sequential pass
    # that revalidates the stacks 8c's writes left behind, alternating,
    # CONC_GROUP_REPS of each.
    bsi = oracle["group_bsi"]

    def group_round(queries):
        ex._co_enabled_memo = True
        ex.set_coalesce_config(max_wait_us=5_000_000,
                               max_group=len(queries))
        out = [None] * len(queries)
        barrier = threading.Barrier(len(queries) + 1)

        def run(i, q):
            barrier.wait(timeout=60)
            out[i] = ex.execute("i", q)[0]

        threads = [threading.Thread(target=run, args=(i, q))
                   for i, q in enumerate(queries)]
        for th in threads:
            th.start()
        sync()
        fused0 = ex._co_stats["fused_queries"]
        barrier.wait(timeout=60)
        t = time.perf_counter()
        for th in threads:
            th.join()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        ex.set_coalesce_config(max_wait_us=0, max_group=64)
        check(ex._co_stats["fused_queries"] - fused0 == len(queries),
              f"8c: {queries[0]}... formed no one group")
        return ms, out

    def sequential(queries):
        ex._co_enabled_memo = False
        t = time.perf_counter()
        out = [ex.execute("i", q)[0] for q in queries]
        sync()
        ms = (time.perf_counter() - t) * 1e3
        ex._co_enabled_memo = True
        return ms, out

    for verb in ("Sum", "Max"):
        queries = [q for q in bsi if q.startswith(verb)]
        want = [bsi[q] for q in queries]
        check(sequential(queries)[1] == want, f"8c {verb}: != oracle {want}")
        k0 = dict(kernels.launches)
        g_ms, s_ms = [], []
        for _ in range(CONC_GROUP_REPS):
            ms, out = group_round(queries)
            check(out == want, f"8c {verb} group: {out} != oracle {want}")
            g_ms.append(ms)
            ms, out = sequential(queries)
            check(out == want, f"8c {verb} sequential: {out}")
            s_ms.append(ms)
        k1 = dict(kernels.launches)
        print(f"8c {verb} group of {len(queries)} (Union filters), median of "
              f"{CONC_GROUP_REPS}: {np.median(g_ms):.3f} ms in one group "
              f"({', '.join(f'{x:.3f}' for x in g_ms)}) vs "
              f"{np.median(s_ms):.3f} ms served one after another "
              f"({', '.join(f'{x:.3f}' for x in s_ms)}; host clock to "
              f"torch.cuda.synchronize()); per group count_op_pairs "
              f"{(k1['count_op_pairs'] - k0['count_op_pairs']) / CONC_GROUP_REPS:g}"
              f" launches, count_and_rows_multi "
              f"{(k1['count_and_rows_multi'] - k0['count_and_rows_multi']) / CONC_GROUP_REPS:g}"
              f" {card}")

    # Warm repeats with the result memos (and the response cache) on.
    q = f"Count(Intersect({SRC.format(0)}, {SRC.format(1)}))"
    want = int(pair_counts[0][1])
    ex._result_memo_off = False
    try:
        check(ex.execute("i", q)[0] == want, "8c memo: first answer")
        memo_ms, got = p50_ms(lambda: ex.execute("i", q)[0], 100)
        check(got == want, "8c memo: in-process repeat changed")
        import http.client

        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        http_query(conn, q)
        http_ms, got = p50_ms(lambda: http_query(conn, q), 100)
        conn.close()
        check(got == [want], "8c memo: HTTP repeat changed")
        stats = server.handler._resp_cache.stats()
        check(stats["hits"] >= 100, f"8c memo: response cache {stats}")
    finally:
        ex._result_memo_off = True
    launches = launch_counts()
    check(launches["count_op_pairs"] and launches["count_and_rows_multi"],
          f"8c: a group kernel never launched: {launches}")
    print(f"8c memos on: warm repeat of {q} p50 {memo_ms:.4f} ms in process, "
          f"{http_ms:.3f} ms over HTTP (response cache {stats}; n=100 each, "
          f"host clock) {card}")
    print(f"phase 8c: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}; coalescer {ex.coalesce_snapshot()} {card}")
    return launches


def _listening_line(proc, timeout):
    """The server's ``listening as`` line among its first lines of
    output, or a failure after ``timeout`` seconds."""
    import select

    deadline = time.monotonic() + timeout
    seen = []
    while True:
        left = deadline - time.monotonic()
        ready = select.select([proc.stdout], [], [], max(left, 0))[0]
        line = proc.stdout.readline().decode() if ready else ""
        if line.startswith("pilosa-tpu listening as "):
            return line
        seen.append(line)
        check(ready and line and left > 0,
              f"the server did not listen in {timeout} s: {''.join(seen)}")


def cli_path(seed, datadir, card):
    """Phase 8b: ``python -m pilosa_tpu_torch.cli server`` on the card
    as a subprocess, Pilosa's Quick Start against it, ``cli import`` of a
    generated CSV, recounts against numpy, then SIGTERM."""
    import http.client
    import signal

    from pilosa_tpu_torch import SLICE_WIDTH

    os.makedirs(datadir)
    rng = np.random.default_rng([seed, 9])
    rows = rng.integers(0, 5, CLI_LINES)
    cols = rng.integers(0, 4 * SLICE_WIDTH, CLI_LINES)
    csv_path = os.path.join(datadir, "import.csv")
    with open(csv_path, "w") as fh:
        fh.write("".join(f"{r},{c}\n" for r, c in zip(rows, cols)))
    t0 = time.perf_counter()
    # The entry point's own default device is the GPU.
    device = [] if DEVICE == "cuda" else ["--device", DEVICE]
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d",
         os.path.join(datadir, "data"), "-b", "127.0.0.1:0", *device],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        line = _listening_line(proc, 180)
        check(line.startswith("pilosa-tpu listening as http://127.0.0.1:"),
              f"server said {line!r}")
        start_s = time.perf_counter() - t0
        host = line.split("http://")[1].strip()
        conn = http.client.HTTPConnection(host, timeout=120)
        try:
            got = [http_json(conn, "POST", "/index/i", b"{}"),
                   http_json(conn, "POST", "/index/i/frame/f", b"{}"),
                   http_query(conn, 'SetBit(frame="f", rowID=1, '
                                    'columnID=2)'),
                   http_query(conn, 'Count(Bitmap(frame="f", rowID=1))')]
            check(got == [{}, {}, [True], [1]], f"Quick Start: {got}")
            t = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "pilosa_tpu_torch.cli", "import",
                 "--host", host, "-i", "i", "-f", "f", csv_path], cwd=HERE,
                capture_output=True, text=True, timeout=300)
            import_s = time.perf_counter() - t
            check(out.returncode == 0
                  and out.stdout.strip() == f"imported {CLI_LINES} bits",
                  f"cli import: {out.returncode} {out.stdout} {out.stderr}")
            pairs = set(zip(rows.tolist(), cols.tolist())) | {(1, 2)}
            want = [sum(1 for r, _ in pairs if r == k) for k in range(5)]
            got = [http_query(conn, f'Count({ROW.format(k)})')[0]
                   for k in range(5)]
            check(got == want, f"counts after cli import: {got} != {want}")
        finally:
            conn.close()
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        stop_s = time.perf_counter() - t
        rest = proc.stdout.read().decode()
        check(rc == 0 and "pilosa-tpu closed" in rest,
              f"server exit {rc}: {rest[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    print(f"cli {card}: server up in {start_s:.2f} s; the Quick Start's "
          f"four requests answered {{}}, {{}}, [true], [1]; cli import of "
          f"{CLI_LINES} lines in {import_s:.2f} s, counts per row {want} "
          f"equal to numpy; SIGTERM -> exit 0 in {stop_s:.2f} s")


# ------------------------------------------------------------ phase 7

CLICK_ROWS = 4
CLICK_DAYS = 14                 # 2017-06-01 … 2017-06-14
CLICK_CELLS = 64 * CLICK_DAYS   # clicked with probability 1/64
TIME_VIEWS = (["standard", "standard_2017", "standard_201706"]
              + [f"standard_201706{d:02d}" for d in range(1, CLICK_DAYS + 1)])
ALL_DAYS = frozenset(range(1, CLICK_DAYS + 1))
# (label, start, end, days of June the window covers); row 3 unless said.
WINDOWS = [
    ("14 days", "2017-06-01T00:00", "2017-06-15T00:00", ALL_DAYS),
    ("June 5-9", "2017-06-05T00:00", "2017-06-09T00:00",
     frozenset(range(5, 9))),
    ("month", "2017-06-01T00:00", "2017-07-01T00:00", ALL_DAYS),
    ("year", "2017-01-01T00:00", "2018-01-01T00:00", ALL_DAYS),
    ("May 30 - June 3", "2017-05-30T00:00", "2017-06-03T00:00",
     frozenset({1, 2})),
    ("5 hours", "2017-06-10T00:00", "2017-06-10T05:00", frozenset()),
    ("June 15-25", "2017-06-15T00:00", "2017-06-25T00:00", frozenset()),
]


def time_range(row, start, end):
    return (f'Range(frame="clicks", rowID={row}, start="{start}", '
            f'end="{end}")')


# Count(Intersect(row 3 over 14 days, row 1 over June 5-9)).
INTERSECT_Q = (f"Count(Intersect({time_range(3, *WINDOWS[0][1:3])}, "
               f"{time_range(1, *WINDOWS[1][1:3])}))")


def click_rows(seed, s):
    """(row, position, day) of every click of slice s: each (row,
    column) is clicked with probability 1/64 on one day of 14."""
    x = np.random.default_rng([seed, s, 7]).integers(
        0, CLICK_CELLS, size=(CLICK_ROWS, SLICE_COLS), dtype=np.uint16)
    rows, pos = np.nonzero(x < CLICK_DAYS)
    return rows, pos, x[rows, pos].astype(np.int64) + 1


def click_words(rows, pos, days):
    """uint64[15, 4, 16384]: per day 1-14 (index d) and all days (index
    0) the rows' words."""
    out = np.zeros((CLICK_DAYS + 1, CLICK_ROWS, 16384), np.uint64)
    np.bitwise_or.at(out, (days, rows, pos >> 6),
                     np.uint64(1) << (pos & 63).astype(np.uint64))
    out[0] = np.bitwise_or.reduce(out[1:], axis=0)
    return out


def _write_click_slices(views_dir, seed, lo, hi):
    """Worker: the 17 fragment files of each slice in [lo, hi), written
    by the port's codec; returns per-slice oracle counts (one per
    WINDOWS entry for row 3, then the Intersect) and row 3's clicks as
    (ascending absolute column ids, days)."""
    from pilosa_tpu_torch.roaring import codec

    keys = (np.arange(CLICK_ROWS, dtype=np.uint64)[:, None] * np.uint64(16)
            + np.arange(16, dtype=np.uint64)).ravel()
    counts = np.zeros((len(WINDOWS) + 1, hi - lo), np.int64)
    cols3, days3 = [], []
    for i, s in enumerate(range(lo, hi)):
        rows, pos, days = click_rows(seed, s)
        words = click_words(rows, pos, days)
        for v, name in enumerate(TIME_VIEWS):
            w = words[max(0, v - 2)]  # standard, year and month: all days
            with open(os.path.join(views_dir, name, "fragments", str(s)),
                      "wb") as fh:
                fh.write(codec.serialize_arrays(keys, w.reshape(-1, 1024)))
        r3, d3 = pos[rows == 3], days[rows == 3]
        for k, (_, _, _, want_days) in enumerate(WINDOWS):
            counts[k, i] = int(np.isin(d3, list(want_days)).sum())
        r1 = pos[(rows == 1) & (days >= 5) & (days < 9)]
        counts[-1, i] = len(np.intersect1d(r3, r1))
        cols3.append(r3.astype(np.uint64) + np.uint64(s * SLICE_COLS))
        days3.append(d3.astype(np.uint8))
    return lo, counts, np.concatenate(cols3), np.concatenate(days3)


def events_path(slices, seed, datadir, card):
    """Phase 7: the event-analytics example over its own data directory,
    every answer against the numpy oracle on both paths, before and
    after timestamped writes."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import bitops, containers, kernels
    from pilosa_tpu_torch.storage.frame import FrameOptions
    from pilosa_tpu_torch.storage.holder import Holder

    holder = Holder(datadir, device=DEVICE).open()
    frame = holder.create_index("events").create_frame(
        "clicks", FrameOptions(time_quantum="YMD"))
    views_dir = os.path.join(frame.path, "views")
    holder.close()
    for name in TIME_VIEWS:
        os.makedirs(os.path.join(views_dir, name, "fragments"))
    t0 = time.perf_counter()
    procs, parts = in_processes(_write_click_slices, views_dir, seed, slices)
    counts = np.concatenate([c for _, c, _, _ in parts], axis=1)
    cols3 = np.concatenate([c for _, _, c, _ in parts])
    days3 = np.concatenate([d for _, _, _, d in parts])
    del parts
    write_s = time.perf_counter() - t0
    n_frag = len(TIME_VIEWS) * slices
    print(f"events: wrote frame clicks (timeQuantum YMD), {CLICK_ROWS} rows "
          f"x {slices} slices x {len(TIME_VIEWS)} views = {n_frag} fragments "
          f"({n_frag * CLICK_ROWS * 16384 * 8 / 2**30:.2f} GiB of rows), "
          f"{len(cols3)} clicks of row 3, in {procs} processes in "
          f"{write_s:.1f} s")

    reset_peak()
    kernels.reset_launches()
    t0 = time.perf_counter()
    holder = Holder(datadir, device=DEVICE).open()
    open_s = time.perf_counter() - t0
    check(holder.index("events").max_slice() == slices - 1, "max_slice")
    ex = Executor(holder)
    n_ser = min(SERIAL_SLICES, slices)
    want = [int(c) for c in counts.sum(axis=1)]
    want_ser = [int(c) for c in counts[:, :n_ser].sum(axis=1)]
    check(want[0] == want[2] == want[3] == len(cols3) and want[5] == 0
          and 0 < want[4] < want[1] < want[0],
          f"data: window counts {want}")
    q14 = f"Count({time_range(3, *WINDOWS[0][1:3])})"
    t0 = time.perf_counter()
    got = ex.execute("events", q14)[0]
    sync()
    first_s = time.perf_counter() - t0
    check(got == want[0], f"{q14}: {got} != oracle {want[0]}")
    # With the container tier on, a window of one sparse day view (and
    # fragments not faulted in) would take the lanes; a window of several
    # views stays batched.
    routes = {label: count_route(ex, "events",
                                 f"Count({time_range(3, a, b)})",
                                 range(slices))
              for label, a, b, _ in WINDOWS[:5]}
    print(f"  routes: {routes}")

    def run(tag, labels):
        for path in ("batched", "serial"):
            ex._force_path = path
            span = range(slices) if path == "batched" else range(n_ser)
            w_path = want if path == "batched" else want_ser
            for k, (label, a, b, _) in enumerate(WINDOWS):
                if label not in labels:
                    continue
                q = f"Count({time_range(3, a, b)})"
                t = time.perf_counter()
                got = ex.execute("events", q, slices=span)[0]
                dt = (time.perf_counter() - t) * 1e3
                check(got == w_path[k], f"{tag} {path} {q}: {got} != oracle "
                      f"{w_path[k]}")
                print(f"  {tag} {path:7s} {dt:9.2f} ms  {got:>10d}  "
                      f"({label}) {q} over {len(span)} slices")
            if "intersect" in labels:
                got = ex.execute("events", INTERSECT_Q, slices=span)[0]
                check(got == w_path[-1], f"{tag} {path} {INTERSECT_Q}: "
                      f"{got} != oracle {w_path[-1]}")
                print(f"  {tag} {path:7s} {got:>20d}  {INTERSECT_Q}")
        ex._force_path = None

    run("query", [w[0] for w in WINDOWS] + ["intersect"])

    # The top-level Ranges (a bare Range runs serially), id by id, over
    # the serial loops' slices.
    in_ser = cols3 < np.uint64(n_ser * SLICE_WIDTH)
    for label, a, b, days in WINDOWS[:6]:
        q = time_range(3, a, b)
        t = time.perf_counter()
        bm = ex.execute("events", q, slices=range(n_ser))[0]
        got = bm.columns()
        dt = (time.perf_counter() - t) * 1e3
        ids = cols3[np.isin(days3, list(days)) & in_ser]
        check(bm.count() == len(ids) and np.array_equal(got, ids),
              f"{q}: {bm.count()} ids != oracle {len(ids)}")
        print(f"  range   {dt:9.2f} ms  {len(got):>10d} ids  ({label}) {q}")

    # The warm 14-view Count: n=50 on the batched route, n=3 on any
    # other, then n=10 with the tier off (the dense batched route) for
    # the contrast.
    lat = []
    n_warm = 50 if routes["14 days"] == "batched" else 3
    for _ in range(n_warm):
        t = time.perf_counter()
        got = ex.execute("events", q14)[0]
        sync()
        lat.append((time.perf_counter() - t) * 1e3)
        check(got == want[0], "warm 14-view Count changed")
    lat = np.asarray(lat)
    containers.set_enabled(False)
    try:
        off_ms, got = p50_ms(lambda: ex.execute("events", q14)[0], 10)
    finally:
        containers.set_enabled(True)
    check(got == want[0], "14-view Count with the tier off")
    stacks = [ex._leaf_stack("events", ("clicks", f"standard_201706{d:02d}",
                                        3), range(slices))
              for d in range(1, CLICK_DAYS + 1)]
    fold = ("Union", [("leaf", i) for i in range(CLICK_DAYS - 1)])
    fold_ms = timed_ms(lambda: Executor._eval_node(fold, stacks), reps=10)
    acc = Executor._eval_node(fold, stacks)
    kernel_ms = timed_ms(lambda: bitops.count_op_rows(acc, stacks[-1], "or"),
                         reps=10)
    del stacks, acc

    # A click on 2017-06-20, a day view that does not exist yet, at a
    # column row 3 never clicked; the month and June 15-25 see it, and
    # a ClearBit with the timestamp takes it back.
    s = n_ser // 2
    clicked = set((cols3[(cols3 >= s * SLICE_WIDTH)
                         & (cols3 < (s + 1) * SLICE_WIDTH)]
                   - np.uint64(s * SLICE_WIDTH)).tolist())
    col = s * SLICE_WIDTH + min(set(range(len(clicked) + 1)) - clicked)
    check("standard_20170620" not in holder.index("events").frame(
        "clicks").views, "data: the day view 2017-06-20 exists")
    for verb, delta in (("SetBit", 1), ("ClearBit", 0)):
        res = ex.execute("events", f'{verb}(frame="clicks", rowID=3, '
                                   f'columnID={col}, '
                                   'timestamp="2017-06-20T08:00")')
        check(res == [True], f"timestamped {verb} returned {res}")
        for w, n in ((want, len(cols3)), (want_ser, int(in_ser.sum()))):
            w[2] = w[3] = n + delta   # the month and the year
            w[6] = delta              # June 15-25
        run(verb.lower(), ["month", "June 15-25", "14 days"])
    launches = launch_counts()
    peak = peak_bytes()
    holder.close()
    check(launches["count_op_rows"] and launches["count_rows"],
          f"a count kernel never launched on the time path: {launches}")
    print(f"events {card}: open {open_s:.2f} s ({n_frag} fragments), first "
          f"14-view Count {first_s:.2f} s (route {routes['14 days']}); warm "
          f"14-view Count over {slices} slices p50 "
          f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f}"
          f" ms, max {lat.max():.3f} ms (n={n_warm}, host clock to "
          f"torch.cuda.synchronize()); with the container tier off (dense "
          f"batched) p50 {off_ms:.3f} ms (n=10); its fold of 13 views "
          f"{fold_ms:.4f} ms "
          f"and count_op_rows {kernel_ms:.4f} ms (CUDA events, 10 reps); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches}")
    return launches


# ------------------------------------------------------------ phase 9

CHEM_COLS = 4096               # fingerprint bits per molecule
CHEM_SCAFFOLD_BITS = 48        # bits of a family's scaffold
CHEM_KEEP = 0.95               # share of its scaffold's bits a molecule keeps
CHEM_EXTRA = 3                 # bits a molecule adds of its own
CHEM_TANIMOTO = 70
CHEM_QUERIES = (0, 12345, 250_001, CHEM_ROWS - 1)  # Src molecules


def chem_words(seed, n_rows):
    """uint64[n_rows, 64]: molecule m keeps each bit of its family's
    scaffold (family m // CHEM_FAMILY) with probability CHEM_KEEP and adds
    CHEM_EXTRA random bits, ~48 bits in all, so family members score
    ~80 in Tanimoto against each other and ~1 against the rest."""
    rng = np.random.default_rng([seed, 9])
    n_fam = (n_rows + CHEM_FAMILY - 1) // CHEM_FAMILY
    scaffold = rng.integers(0, CHEM_COLS, (n_fam, CHEM_SCAFFOLD_BITS))
    cols = scaffold[np.arange(n_rows) // CHEM_FAMILY]
    cols = np.where(rng.random(cols.shape) < CHEM_KEEP, cols, -1)
    cols = np.concatenate(
        [cols, rng.integers(0, CHEM_COLS, (n_rows, CHEM_EXTRA))], axis=1)
    r, k = np.nonzero(cols >= 0)
    c = cols[r, k]
    words = np.zeros((n_rows, CHEM_COLS // 64), np.uint64)
    np.bitwise_or.at(words.reshape(-1), r * (CHEM_COLS // 64) + (c >> 6),
                     np.left_shift(np.uint64(1), (c & 63).astype(np.uint64)))
    return words


def chem_oracle(words, counts, q, n):
    """TopN(Bitmap(q), n, tanimotoThreshold) of one slice whose cache
    holds every row: |row ∩ q| of the rows whose float32 Tanimoto score
    ×100 has a ceiling above the threshold, by (-count, id), top n."""
    inter = np.bitwise_count(words & words[q]).sum(axis=1, dtype=np.int64)
    denom = counts + counts[q] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        score = (np.float32(100.0) * inter.astype(np.float32)
                 / denom.astype(np.float32))
    keep = (denom > 0) & (np.ceil(score) > CHEM_TANIMOTO) & (inter > 0)
    rows = np.flatnonzero(keep)
    order = np.lexsort((rows, -inter[rows]))[:n]
    return [(int(r), int(inter[r])) for r in rows[order]]


def chem_path(seed, datadir, card):
    """Phase 9: the chemical-similarity shape — 500,000 molecule rows of
    4,096 fingerprint columns in one fragment, held in a 128-word column
    window — TopN with a Src and a Tanimoto threshold, a Src-less TopN
    and Count(Intersect) on both paths against the numpy oracle."""
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.roaring import codec
    from pilosa_tpu_torch.storage.frame import FrameOptions
    from pilosa_tpu_torch.storage.holder import Holder

    holder = Holder(datadir, device=DEVICE).open()
    frame = holder.create_index("chem").create_frame(
        "fingerprint", FrameOptions(cache_size=CHEM_ROWS))
    frag_dir = os.path.join(frame.path, "views", "standard", "fragments")
    holder.close()
    t0 = time.perf_counter()
    words = chem_words(seed, CHEM_ROWS)
    counts = np.bitwise_count(words).sum(axis=1, dtype=np.int64)
    keys = np.arange(CHEM_ROWS, dtype=np.uint64) * np.uint64(16)
    os.makedirs(frag_dir)
    path = os.path.join(frag_dir, "0")
    with open(path, "wb") as fh:
        fh.write(codec.serialize_arrays(keys, words))
    with open(path + ".cache", "w") as fh:
        json.dump(np.flatnonzero(counts).tolist(), fh)
    write_s = time.perf_counter() - t0
    print(f"chem: wrote {CHEM_ROWS} molecules x {CHEM_COLS} fingerprint "
          f"columns ({int(counts.sum())} bits, {counts.mean():.1f} per "
          f"molecule; {os.path.getsize(path)} file bytes) in {write_s:.1f} s")

    reset_peak()
    kernels.reset_launches()
    t0 = time.perf_counter()
    holder = Holder(datadir, device=DEVICE).open()
    open_s = time.perf_counter() - t0
    ex = Executor(holder)
    frag = holder.fragment("chem", "fingerprint", "standard", 0)
    lazy_win = frag.win32()
    check(lazy_win == (0, 128) and not frag._resident,
          f"chem window before the fault-in {lazy_win}")
    q1, q2 = CHEM_QUERIES[1], CHEM_QUERIES[1] + 1  # two of one family
    q_and = (f'Count(Intersect(Bitmap(frame="fingerprint", rowID={q1}), '
             f'Bitmap(frame="fingerprint", rowID={q2})))')
    want_and = int(np.bitwise_count(words[q1] & words[q2]).sum())
    t0 = time.perf_counter()
    got = ex.execute("chem", q_and)[0]
    sync()
    first_s = time.perf_counter() - t0
    check(got == want_and, f"{q_and}: {got} != oracle {want_and}")

    def topn(q):
        return (f'TopN(Bitmap(frame="fingerprint", rowID={q}), '
                f'frame="fingerprint", n=10, tanimotoThreshold='
                f'{CHEM_TANIMOTO})')

    q_bare = 'TopN(frame="fingerprint", n=10)'
    order = np.lexsort((np.arange(CHEM_ROWS), -counts))[:10]
    cases = [(topn(q), chem_oracle(words, counts, q, 10))
             for q in CHEM_QUERIES]
    cases += [(q_bare, [(int(r), int(counts[r])) for r in order]),
              (q_and, want_and)]
    check(all(len(w) > 1 for _, w in cases[:len(CHEM_QUERIES)]),
          "data: a Src molecule without similar molecules")
    first_topn_s = None
    for path in ("batched", "serial"):
        ex._force_path = path
        for q, w in cases:
            t = time.perf_counter()
            got = ex.execute("chem", q)[0]
            dt = time.perf_counter() - t
            first_topn_s = first_topn_s or dt
            check(got == w, f"chem {path} {q}: {got} != oracle {w}")
            print(f"  chem {path:7s} {dt * 1e3:10.2f} ms  {q} -> {got}")
    ex._force_path = None
    win = frag.win32()
    check(win == (0, 128) and frag._resident, f"chem window {win}")
    mem = frag.memory_stats()
    host_window = frag._matrix.nbytes
    full_width = CHEM_ROWS * WORDS32 * 4
    check(mem["deviceBytes"] <= 2 * host_window,
          f"chem device bytes {mem['deviceBytes']} > 2x the host window "
          f"{host_window}")

    q0 = topn(CHEM_QUERIES[0])
    before = kernels.launches["count_and_rows"]
    ex.execute("chem", q0)
    per_topn = kernels.launches["count_and_rows"] - before
    lat_ms, got = p50_ms(lambda: ex.execute("chem", q0)[0], 20)
    check(got == cases[0][1], "warm chem TopN changed")
    launches = launch_counts()
    peak = peak_bytes()
    holder.close()
    check(all(launches[k] for k in QUERY_KERNELS),
          f"a kernel never launched on the chem path: {launches}")
    print(f"chem {card}: open {open_s:.2f} s, first Count(Intersect) "
          f"{first_s:.2f} s (no fault-in), first TopN {first_topn_s:.2f} s "
          f"(fault-in and mirror); win32 {lazy_win} before the fault-in and "
          f"{win} after; host matrix {host_window} bytes, device "
          f"{mem['deviceBytes']} bytes, full width would be {full_width} "
          f"bytes ({full_width / host_window:.0f}x); warm TopN p50 "
          f"{lat_ms:.3f} ms (n=20, host clock to torch.cuda.synchronize()),"
          f" {per_topn} count_and_rows launches per TopN; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches}")
    return launches


# ----------------------------------------------------------- phase 10

# benchmarks/count100b.py:70-101's shape, at MAIN_SLICES slices: rows 1
# and 2 of 500 and 300 bits spread over each slice (array containers),
# row 3 one 2,000-bit run a slice (a run container); row 0 at density
# 0.5 (dense) for the array x dense and run x dense cells.
SPARSE_RUN = 2000
SPARSE_ROW = 'Bitmap(frame="f", rowID={})'.format
SPARSE_QUERIES = [  # (label, PQL, numpy over (r0, r1, r2, r3) words)
    ("Intersect(1, 2)", 1, 2, np.bitwise_and, "Intersect"),
    ("Intersect(1, 3)", 1, 3, np.bitwise_and, "Intersect"),
    ("Union(1, 2)", 1, 2, np.bitwise_or, "Union"),
    ("Difference(1, 3)", 1, 3, lambda a, b: a & ~b, "Difference"),
    ("Xor(2, 3)", 2, 3, np.bitwise_xor, "Xor"),
    ("Intersect(1, 0)", 1, 0, np.bitwise_and, "Intersect"),
    ("Intersect(3, 0)", 3, 0, np.bitwise_and, "Intersect"),
]
SPARSE_GROUP = ((1, 2), (1, 3), (2, 3), (2, 1), (3, 1), (3, 2), (1, 2),
                (2, 3))  # a group of GROUP_PAIRS Count(Intersect(a, b))


def sparse_pql(a, b, op="Intersect"):
    return f"Count({op}({SPARSE_ROW(a)}, {SPARSE_ROW(b)}))"


def sparse_words(seed, s):
    """uint64[4, 16384] words of slice s: row 0 at density 0.5, rows 1
    and 2 of 500 and 300 spread bits, row 3 one 2,000-bit run."""
    rng = np.random.default_rng([seed, s, 10])
    w = np.zeros((4, 16384), np.uint64)
    w[0] = rng.integers(0, 2**64, 16384, dtype=np.uint64)
    for r, n in ((1, 500), (2, 300)):
        c = rng.choice(SLICE_COLS, n, replace=False)
        np.bitwise_or.at(w[r], c >> 6, np.uint64(1) << (c & 63).astype(
            np.uint64))
    start = int(rng.integers(0, SLICE_COLS - 3000))
    bits = np.zeros(SLICE_COLS, np.uint8)
    bits[start:start + SPARSE_RUN] = 1
    w[3] = np.packbits(bits, bitorder="little").view(np.uint64)
    return w


def _write_sparse_slices(frag_dir, seed, lo, hi):
    """Worker: the fragment file of each slice in [lo, hi) by the port's
    codec; returns per query of SPARSE_QUERIES and per SPARSE_GROUP pair
    the slice's counts."""
    from pilosa_tpu_torch.roaring import codec

    keys = (np.arange(4, dtype=np.uint64)[:, None] * np.uint64(16)
            + np.arange(16, dtype=np.uint64)).ravel()
    counts = np.zeros((len(SPARSE_QUERIES) + len(SPARSE_GROUP), hi - lo),
                      np.int64)
    for i, s in enumerate(range(lo, hi)):
        w = sparse_words(seed, s)
        for k, (_, a, b, fn, _) in enumerate(SPARSE_QUERIES):
            counts[k, i] = int(np.bitwise_count(fn(w[a], w[b])).sum())
        for k, (a, b) in enumerate(SPARSE_GROUP):
            counts[len(SPARSE_QUERIES) + k, i] = int(
                np.bitwise_count(w[a] & w[b]).sum())
        with open(os.path.join(frag_dir, str(s)), "wb") as fh:
            fh.write(codec.serialize_arrays(keys, w.reshape(-1, 1024)))
    return lo, counts


def forget_pair_tables(pairs):
    """Drop the member tables the rows of these RowLane pairs keep for
    their partners, so that the next lane round builds them cold."""
    for row, _ in pairs:
        row._pairs.clear()


def sparse_path(slices, seed, datadir, card):
    """Phase 10: the sparse index of count100b's shape served from the
    compressed container tier — single Counts through the lanes and
    pinned serial, the dense cells pinned serial, a coalesced group of
    GROUP_PAIRS through the container lanes against the same served one
    after another, the container rollup of Holder.memory_stats(), and the
    first query again with the tier off; every answer against numpy."""
    import threading

    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import containers, kernels
    from pilosa_tpu_torch.storage.holder import Holder

    holder = Holder(datadir, device=DEVICE).open()
    view = holder.create_index("ns").create_frame("f") \
        .create_view_if_not_exists("standard")
    frag_dir = os.path.join(view.path, "fragments")
    holder.close()
    t0 = time.perf_counter()
    procs, parts = in_processes(_write_sparse_slices, frag_dir, seed,
                                slices)
    counts = np.concatenate([c for _, c in parts], axis=1)
    want = [int(c) for c in counts.sum(axis=1)]
    print(f"sparse: wrote index ns, frame f, 4 rows x {slices} slices "
          f"({slices * SLICE_WIDTH / 1e9:.2f}B columns; rows 1-2 500 and "
          f"300 spread bits, row 3 one {SPARSE_RUN}-bit run, row 0 density "
          f"0.5 a slice) in {procs} processes in "
          f"{time.perf_counter() - t0:.1f} s")

    reset_peak()
    kernels.reset_launches()
    holder = Holder(datadir, device=DEVICE).open()
    ex = Executor(holder)
    span = range(slices)
    # (a) single Counts over the sparse rows: the container lanes, then
    # the same pinned serial (one launch a slice) for the contrast.
    for k, (label, a, b, _, op) in enumerate(SPARSE_QUERIES[:5]):
        q = sparse_pql(a, b, op)
        before = kernels.launches["container_and_counts"]
        t = time.perf_counter()
        got = ex.execute("ns", q)[0]
        sync()
        first_s = time.perf_counter() - t
        check(got == want[k], f"sparse {q}: {got} != oracle {want[k]}")
        route = count_route(ex, "ns", q, span)
        check(route == "lanes", f"sparse {q} route {route}")
        launched = kernels.launches["container_and_counts"] - before
        p50, got = p50_ms(lambda: ex.execute("ns", q)[0], 5)
        check(got == want[k], f"warm sparse {q} changed")

        def cold_tables(q=q):
            forget_pair_tables([(r, r) for _, r in ex._lane_cache.values()])
            return ex.execute("ns", q)[0]
        cold_p50, got = p50_ms(cold_tables, 5)
        check(got == want[k], f"sparse {q} with cold member tables changed")
        ex._force_path = "serial"
        t = time.perf_counter()
        got = ex.execute("ns", q)[0]
        sync()
        serial_ms = (time.perf_counter() - t) * 1e3
        ex._force_path = None
        check(got == want[k], f"sparse serial {q}: {got} != {want[k]}")
        print(f"  sparse {label:16s} route {route}: first {first_s:.2f} s "
              f"({launched} container_and_counts launches), p50 "
              f"{p50:.3f} ms (n=5), with the pair's member tables built "
              f"cold {cold_p50:.3f} ms; pinned serial {serial_ms:.1f} ms  "
              f"{got}")
    # (b) the dense cells, pinned serial.
    ex._force_path = "serial"
    for k, (label, a, b, _, op) in enumerate(SPARSE_QUERIES[5:], 5):
        q = sparse_pql(a, b, op)
        t = time.perf_counter()
        got = ex.execute("ns", q)[0]
        sync()
        first_s = time.perf_counter() - t
        cell = "run x dense" if a == 3 else "array x dense"
        print(f"  sparse {label:16s} pinned serial ({cell}; the dense row of "
              f"a fragment not faulted in uploads at every query): "
              f"{first_s:.2f} s  {got}")
    ex._force_path = None

    # (c) a group of GROUP_PAIRS concurrent Counts through the lanes,
    # against the same served one after another.
    group = [sparse_pql(a, b) for a, b in SPARSE_GROUP]
    gwant = want[len(SPARSE_QUERIES):]
    ex.set_coalesce_config(max_wait_us=10_000_000, max_group=len(group))

    def run_group():
        out = [None] * len(group)
        barrier = threading.Barrier(len(group))

        def one(i):
            barrier.wait(timeout=60)
            out[i] = ex.execute("ns", group[i])[0]

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(group))]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        sync()
        return (time.perf_counter() - t) * 1e3, out

    lane_before = kernels.launches["container_and_counts"]
    snap0 = ex.coalesce_snapshot()
    group_ms = []
    for _ in range(3):
        ms, out = run_group()
        check(out == gwant, f"sparse group {out} != oracle {gwant}")
        group_ms.append(ms)
    snap = ex.coalesce_snapshot()
    check(snap["compressedFusedQueries"] - snap0["compressedFusedQueries"]
          == 3 * len(group) and snap["max_group"] == len(group),
          f"sparse group did not fuse as lanes: {snap}")
    lanes = snap["laneLaunches"] - snap0["laneLaunches"]
    lane_kernel = kernels.launches["container_and_counts"] - lane_before
    ex.set_coalesce_config(max_wait_us=0, max_group=64)
    seq_t = time.perf_counter()
    for q, w in zip(group, gwant):
        check(ex.execute("ns", q)[0] == w, f"sparse sequential {q}")
    sync()
    seq_ms = (time.perf_counter() - seq_t) * 1e3
    # A round's lanes step by step: the rows' RowLanes (cached by the
    # rounds above), the cells packed for the launch, the kernel calls;
    # then one row's RowLane built cold from its fragments' containers.
    distinct = list(dict.fromkeys(SPARSE_GROUP))
    t0 = time.perf_counter()
    pairs = [tuple(ex._lane_row("ns", ("f", "standard", r), span)
                   for r in pair) for pair in distinct]
    t1 = time.perf_counter()
    cells = containers.lane_cells(pairs)[0]
    sync()
    t2 = time.perf_counter()
    forget_pair_tables(pairs)
    t_cold = time.perf_counter()
    containers.lane_cells(pairs)  # the pairs' member tables built cold
    sync()
    cold_tables_ms = (time.perf_counter() - t_cold) * 1e3
    timing_before = kernels.launches["container_and_counts"]
    kernel_ms = sum(timed_ms(lambda c=c: kernels.container_and_counts(
        c.cell, c.a_sides, c.b_sides, c.members), reps=5) for c in cells)
    timing = kernels.launches["container_and_counts"] - timing_before
    frags = holder.fragments("ns", "f", "standard", list(span))
    t3 = time.perf_counter()
    containers.RowLane([f.row_container(1) for f in frags])
    sync()
    cold_ms = (time.perf_counter() - t3) * 1e3
    g50 = float(np.percentile(group_ms, 50))
    rounds = ", ".join(f"{m:.1f}" for m in group_ms)
    sizes = {c.cell: c.n for c in cells}
    print(f"sparse group {card}: {len(group)} concurrent Counts over "
          f"{slices} slices in one group, ms per round {rounds} (p50 "
          f"{g50:.1f}) against {seq_ms:.1f} ms served one after another "
          f"({seq_ms / g50:.1f}x); {lanes} lane launches in 3 rounds "
          f"({lane_kernel} container_and_counts launches); a round's "
          f"lanes: {len(distinct)} distinct pairs, members by cell {sizes},"
          f" host {(t1 - t0) * 1e3:.3f} ms for the cached rows + "
          f"{(t2 - t1) * 1e3:.3f} ms building the cells' member tables "
          f"from the pairs' kept ones ({cold_tables_ms:.3f} ms with the "
          f"pairs' tables built cold and uploaded; no payload copied) "
          f"against "
          f"{kernel_ms:.3f} ms of kernel calls (CUDA events); row 1's "
          f"RowLane cold from its memoized containers {cold_ms:.1f} ms")
    del pairs, cells

    # (d) the container rollup.
    mem = holder.memory_stats()["totals"]["containers"]
    fmts = mem["formats"]
    compressed = fmts["array"]["bytes"] + fmts["run"]["bytes"]
    equiv = mem["denseEquivBytes"]
    equiv_compressed = equiv - fmts["dense"]["bytes"]
    check(compressed * 10 <= equiv_compressed,
          f"compressed payload {compressed} not 10x under its dense "
          f"equivalent {equiv_compressed}")
    peak = peak_bytes()
    blocks = {f: v["blocks"] for f, v in fmts.items()}
    print(f"sparse rollup {card}: blocks {blocks}, "
          f"array + run payload {compressed} bytes against their dense "
          f"equivalent {equiv_compressed} ({equiv_compressed / compressed:.0f}"
          f"x) and denseEquivBytes {equiv} with row 0 "
          f"({equiv / compressed:.0f}x); conversions {mem['conversions']};"
          f" max_memory_allocated {peak / 2**30:.2f} GiB")

    # (e) the first query again with the tier off: the dense batched
    # route, its stacks built from the files.
    q = sparse_pql(1, 2)
    containers.set_enabled(False)
    try:
        route = count_route(ex, "ns", q, span)
        t = time.perf_counter()
        got = ex.execute("ns", q)[0]
        sync()
        first_s = time.perf_counter() - t
        check(got == want[0], f"tier off {q}: {got} != {want[0]}")
        p50, got = p50_ms(lambda: ex.execute("ns", q)[0], 5)
        check(got == want[0], f"tier off warm {q} changed")
        off_peak = peak_bytes()
    finally:
        containers.set_enabled(True)
    launches = launch_counts()
    launches["container_and_counts"] -= timing  # the timed calls above
    launches["container_forms"]["lane"] -= timing
    holder.close()
    check(launches["container_and_counts"] > 0,
          f"container_and_counts never launched in phase 10: {launches}")
    print(f"sparse tier off {card}: {q} route {route}, first {first_s:.2f} s"
          f", p50 {p50:.3f} ms (n=5), max_memory_allocated "
          f"{off_peak / 2**30:.2f} GiB; launches {launches}")
    return launches


# ------------------------------------------------------------ phase 11

INGEST_CT = "application/x-pilosa-ingest"
INGEST_ROWS = 1024            # benchmarks/ingest.py's wide shape
INGEST_SLICES = 32            # columns uniform over 32 slices (not its 2)
INGEST_BATCH = 8_000_000      # bits a request: [ingest] max-batch-bits
INGEST_REQUESTS = 4           # 32,000,000 bits, 8 slices a request
INGEST_GROUP_BITS = INGEST_BATCH * INGEST_REQUESTS // INGEST_SLICES
INGEST_SEED_BITS = 30_000     # the benchmark's seed before its loaded run
# reduced: requests of (a) under the Count client, 2 (16M bits), not 4.
INGEST_LOAD_REQUESTS = 2
INGEST_SPARSE_SLICES = 1024   # (b)
# reduced: (c)'s slices, 256, not 1,024 (its values took 22.05 s there).
INGEST_VALUE_SLICES = 256
INGEST_VALUES = 1000          # (c): values a slice
INGEST_TIME_BITS = 1_000_000  # (d): over 14 days of June 2017
INGEST_TIME_SLICES = 32
KEYED_PAIRS = 100_000         # (e): JSON /import
KEYED_ROWS = 200              # (e): row keys ("term-<i>")
KEYED_COLS = 50_000           # (e): column keys ("user-<j>")
KEYED_CLI_LINES = 10_000
INPUT_RECORDS = 10_000        # (f)
INGEST_HOST_BYTES = 6 << 30   # the server's host-memory budget
TS_JUNE = 1496275200          # 2017-06-01T00:00 UTC
# docs/input-definition.md's definition, its frame options in the
# FrameOptions keyword names both packages read (its camelCase example
# answers 500 in pilosa_tpu and in the port alike).
INPUT_DEF = {
    "frames": [{"name": "event", "options": {"cache_type": "ranked"}}],
    "fields": [
        {"name": "user_id", "primaryKey": True, "actions": []},
        {"name": "kind", "actions": [
            {"frame": "event", "valueDestination": "mapping",
             "valueMap": {"click": 0, "view": 1, "buy": 2}}]},
        {"name": "active", "actions": [
            {"frame": "event", "valueDestination": "single-row-boolean",
             "rowID": 10}]},
        {"name": "score", "actions": [
            {"frame": "event", "valueDestination": "value-to-row"}]},
    ],
}


def wide_batch(seed, k, n):
    """Request k of (a): n (row, column) bits, rows uniform over
    INGEST_ROWS, columns uniform over its run of slices."""
    per = INGEST_SLICES // INGEST_REQUESTS * SLICE_COLS
    rng = np.random.default_rng([seed, 11, k])
    return (rng.integers(0, INGEST_ROWS, n, dtype=np.uint64),
            rng.integers(k * per, (k + 1) * per, n, dtype=np.uint64))


def topn_two_phase(c, n):
    """Two-phase TopN over int64[S, R] per-(slice, row) counts of rows
    0..R-1 (every non-empty row in its slice's cache): per-slice top n by
    (-count, id), merge, exact totals of the merged rows, trim to n."""
    c = np.where(c >= 1, c, 0)
    rank = np.argsort(np.argsort(-c, axis=1, kind="stable"), axis=1)
    cand = np.flatnonzero(np.where(rank < n, c, 0).sum(axis=0))
    tot = c.sum(axis=0)
    return sorted(((int(r), int(tot[r])) for r in cand if tot[r]),
                  key=lambda rc: (-rc[1], rc[0]))[:n]


def wide_oracle_part(seed, k, n):
    """Worker: request k's (a request's own slices) per-row counts,
    |row 1 ∩ row 2| and per-(row, slice) |row ∩ row 0|."""
    r, c = wide_batch(seed, k, n)
    keys = np.unique((r << np.uint64(25)) | c)
    row = (keys >> np.uint64(25)).astype(np.int64)
    col = (keys & np.uint64((1 << 25) - 1)).astype(np.int64)
    of = {k: col[row == k] for k in (0, 1, 2)}
    m = np.isin(col, of[0])
    return (np.bincount(row, minlength=INGEST_ROWS),
            len(np.intersect1d(of[1], of[2], assume_unique=True)),
            np.bincount(row[m] * INGEST_SLICES + (col[m] >> 20),
                        minlength=INGEST_ROWS * INGEST_SLICES))


def wide_oracle(parts):
    """(a)'s per-row counts, |row 1 ∩ row 2| and TopN(Bitmap(rowID=0),
    n=10) from the parts of its requests (their slices are disjoint)."""
    per_slice = sum(p[2] for p in parts)
    return {"rows": sum(p[0] for p in parts),
            "and12": sum(p[1] for p in parts),
            "topn": topn_two_phase(
                per_slice.reshape(INGEST_ROWS, INGEST_SLICES).T, 10)}


def post_ingest(conn, index, body, ctype=INGEST_CT):
    status, _, data = http_request(conn, "POST", f"/index/{index}/ingest",
                                   body, {"Content-Type": ctype})
    check(status == 200, f"ingest into {index}: {status} {data[:300]!r}")
    return json.loads(data)


def index_query(conn, index, pql):
    return http_json(conn, "POST", f"/index/{index}/query",
                     pql.encode())["results"]


def count_loop(host, port, index, stop, out):
    """Closed-loop Count(Intersect(row 1, row 2)) client on one keep-alive
    connection until ``stop``; appends its answered count (or error)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    q = f"Count(Intersect({R1}, {R2}))".encode()
    n = 0
    try:
        while not stop.is_set():
            status, _, data = http_request(
                conn, "POST", f"/index/{index}/query", q)
            if status != 200:
                out.append(f"{status} {data[:200]!r}")
                return
            n += 1
        out.append(n)
    finally:
        conn.close()


def wide_ingest(conn, index, batches):
    """(a)'s requests in order; -> (seconds, the summaries)."""
    http_json(conn, "POST", f"/index/{index}", b"{}")
    http_json(conn, "POST", f"/index/{index}/frame/f", b"{}")
    from pilosa_tpu_torch.ingest import codec

    bodies = [codec.encode_bits("f", r, c) for r, c in batches]
    t = time.perf_counter()
    outs = [post_ingest(conn, index, b) for b in bodies]
    return time.perf_counter() - t, outs


def ingest_path(seed, datadir, card):
    """Phase 11: bulk ingest through ``POST /index/{i}/ingest`` of a
    ``Server`` on the card (host budget INGEST_HOST_BYTES), over one
    keep-alive connection, then keyed import and an input definition;
    every answer against numpy. (a) benchmarks/ingest.py's wide shape:
    INGEST_REQUESTS binary requests of INGEST_BATCH bits over INGEST_ROWS
    rows, columns uniform over INGEST_SLICES slices (about 977 bits a row
    a slice: array containers), bits/s alone and, into a second index
    seeded with INGEST_SEED_BITS bits, INGEST_LOAD_REQUESTS of them under
    a closed-loop Count client, as the benchmark runs it; one JSON
    request; containersSeeded, the
    conversions (0), Counts, Count(Intersect) and TopN, and a pinned
    serial Count over the seeded containers. (b) count100b's sparse shape
    over INGEST_SPARSE_SLICES slices in one request: rows 1 and 2 of 500
    and 300 spread bits a slice, row 3 one 2,000-bit run; the first
    query's seconds and route, Intersect(1, 2) and Intersect(1, 3). (c) a
    BSI values batch, INGEST_VALUES a slice over INGEST_VALUE_SLICES
    slices, into field v (0..1,000): Sum and Max. (d) INGEST_TIME_BITS timestamped
    bits into a YMD frame over 14 days and INGEST_TIME_SLICES slices:
    Count(Range) over 14 days and over 1. (e) KEYED_PAIRS keyed pairs
    through JSON /import, ``cli import -k`` of KEYED_CLI_LINES lines,
    counts by translated ids, and the same ids after the server reopens
    the directory. (f) docs/input-definition.md's definition and
    INPUT_RECORDS records through /input. Every classify pass launches
    ingest_classify on the card; the fragments' host bytes end within
    the budget. Returns the launches of the run.

    reduced: (a) under the Count client, 2 requests (16M bits), not 4;
    (c), 256 slices, not 1,024: the whole script took 1,162.7 s of its
    1,200 s limit on a slower H100 host with both uncut (PERF.md §4)."""
    import http.client
    import threading
    from datetime import datetime

    from pilosa_tpu_torch.ingest import codec
    from pilosa_tpu_torch.ops import containers, kernels
    from pilosa_tpu_torch.server.server import Server

    t_phase = time.perf_counter()
    server = Server(datadir, bind="127.0.0.1:0", device=DEVICE,
                    host_bytes=INGEST_HOST_BYTES).open()
    host, port = server.host.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    kernels.reset_launches()
    conv0 = containers.conversions_total()

    # (a) the wide shape, alone.
    # The oracle runs in worker processes while the server ingests.
    pool = multiprocessing.get_context("spawn").Pool(INGEST_REQUESTS)
    try:
        parts = pool.starmap_async(wide_oracle_part, [
            (seed, k, INGEST_BATCH) for k in range(INGEST_REQUESTS)])
        t = time.perf_counter()
        batches = [wide_batch(seed, k, INGEST_BATCH)
                   for k in range(INGEST_REQUESTS)]
        gen_s = time.perf_counter() - t
        n_bits = INGEST_BATCH * INGEST_REQUESTS
        alone_s, outs = wide_ingest(conn, "wa", batches)
        t = time.perf_counter()
        parts = parts.get(timeout=600)
        want = wide_oracle(parts)
        oracle_s = time.perf_counter() - t
    finally:
        pool.terminate()
        pool.join()
    check(all(o == {"accepted": INGEST_BATCH,
                    "slices": INGEST_SLICES // INGEST_REQUESTS}
              for o in outs), f"(a) ingest summaries {outs}")
    jrow, jcol = 5, [7, 8, 2**21]  # one JSON request, row 5 (new bits)
    got = post_ingest(conn, "wa", json.dumps(
        {"frame": "f", "rows": [jrow] * 3, "columns": jcol}).encode(),
        "application/json")
    check(got == {"accepted": 3, "slices": 2}, f"(a) JSON ingest {got}")
    added = len({c for c in jcol} - set(
        batches[0][1][batches[0][0] == jrow].tolist()))
    want["rows"][jrow] += added
    vars_ = http_json(conn, "GET", "/debug/vars")["ingest"]
    t = time.perf_counter()
    rows_q = [0, 1, 2, jrow, INGEST_ROWS - 1]
    got = index_query(conn, "wa", " ".join(
        f"Count({ROW.format(r)})" for r in rows_q))
    first_s = time.perf_counter() - t
    check(got == [int(want["rows"][r]) for r in rows_q],
          f"(a) counts {got} != {[int(want['rows'][r]) for r in rows_q]}")
    q12 = f"Count(Intersect({R1}, {R2}))"
    route = count_route(server.executor, "wa", q12, range(INGEST_SLICES))
    got = index_query(conn, "wa", q12)[0]
    check(got == want["and12"], f"(a) {q12}: {got} != {want['and12']}")
    t = time.perf_counter()
    got = index_query(conn, "wa", f'TopN({R0}, frame="f", n=10)')[0]
    topn_s = time.perf_counter() - t
    got = [(p["id"], p["count"]) for p in got]
    check(got == want["topn"], f"(a) TopN {got} != {want['topn']}")
    server.executor._force_path = "serial"
    try:
        t = time.perf_counter()
        got = server.executor.execute("wa", q12)[0]
        serial_ms = (time.perf_counter() - t) * 1e3
    finally:
        server.executor._force_path = None
    check(got == want["and12"], f"(a) serial {q12}: {got}")
    conv = containers.conversions_total() - conv0
    check(conv == 0, f"(a) {conv} container conversions after ingest")
    check(vars_["containersSeeded"]["array"] >= INGEST_ROWS * INGEST_SLICES,
          f"(a) seeded {vars_['containersSeeded']}")
    print(f"ingest (a) {card}: {n_bits} bits ({INGEST_REQUESTS} binary "
          f"requests of {INGEST_BATCH}, {INGEST_ROWS} rows x "
          f"{INGEST_SLICES} slices) in {alone_s:.2f} s alone: "
          f"{n_bits / alone_s:.0f} bits/s (report only; made in "
          f"{gen_s:.1f} s; the oracle's workers done {oracle_s:.1f} s "
          f"after it); containersSeeded "
          f"{vars_['containersSeeded']}, conversions {conv}; first Counts "
          f"{first_s:.2f} s; {q12} route {route}; TopN n=10 {topn_s:.2f} s;"
          f" pinned serial {q12} over the seeded containers "
          f"{serial_ms:.1f} ms; every answer equal to numpy")

    # (a) under a closed-loop Count client on the index being written.
    http_json(conn, "POST", "/index/wl", b"{}")
    http_json(conn, "POST", "/index/wl/frame/f", b"{}")
    r0, c0 = batches[0]
    post_ingest(conn, "wl", codec.encode_bits(
        "f", r0[:INGEST_SEED_BITS], c0[:INGEST_SEED_BITS]))
    stop, done = threading.Event(), []
    client = threading.Thread(target=count_loop, args=(
        host, int(port), "wl", stop, done), daemon=True)
    bodies = [codec.encode_bits("f", r, c)
              for r, c in batches[:INGEST_LOAD_REQUESTS]]
    client.start()
    t = time.perf_counter()
    for body in bodies:
        post_ingest(conn, "wl", body)
    load_s = time.perf_counter() - t
    stop.set()
    client.join(timeout=600)
    check(len(done) == 1 and isinstance(done[0], int),
          f"(a) the Count client: {done}")
    del bodies
    got = index_query(conn, "wl", q12)[0]
    w = wide_oracle(parts[:INGEST_LOAD_REQUESTS])["and12"]
    check(got == w, f"(a) under load {q12}: {got} != {w}")
    n_load = INGEST_BATCH * INGEST_LOAD_REQUESTS
    print(f"ingest (a) under load {card}: {n_load} bits in {load_s:.2f} s: "
          f"{n_load / load_s:.0f} bits/s against {done[0] / load_s:.1f} "
          f"Count(Intersect) q/s of one closed-loop client (report only); "
          f"{q12} after it equal to numpy")
    del batches

    # (b) count100b's sparse shape in one request.
    t = time.perf_counter()
    s_n = INGEST_SPARSE_SLICES
    rng = np.random.default_rng([seed, 12])
    base = (np.arange(s_n, dtype=np.int64) * SLICE_COLS)[:, None]
    sparse = {1: (base + rng.integers(0, SLICE_COLS, (s_n, 500))).ravel(),
              2: (base + rng.integers(0, SLICE_COLS, (s_n, 300))).ravel(),
              3: (base + rng.integers(0, SLICE_COLS - 2000, (s_n, 1))
                  + np.arange(2000)).ravel()}
    rows = np.concatenate([np.full(len(c), r) for r, c in sparse.items()])
    cols = np.concatenate(list(sparse.values()))
    uniq = {r: np.unique(c) for r, c in sparse.items()}
    http_json(conn, "POST", "/index/sp", b"{}")
    http_json(conn, "POST", "/index/sp/frame/f", b"{}")
    t_in = time.perf_counter()
    got = post_ingest(conn, "sp", codec.encode_bits("f", rows, cols))
    in_s = time.perf_counter() - t_in
    check(got == {"accepted": len(rows), "slices": s_n}, f"(b) {got}")
    answers = []
    for a, b in ((1, 2), (1, 3)):
        q = f"Count(Intersect({ROW.format(a)}, {ROW.format(b)}))"
        route_b = count_route(server.executor, "sp", q, range(s_n))
        tq = time.perf_counter()
        got = index_query(conn, "sp", q)[0]
        answers.append((q, route_b, time.perf_counter() - tq))
        w = len(np.intersect1d(uniq[a], uniq[b], assume_unique=True))
        check(got == w, f"(b) {q}: {got} != {w}")
    print(f"ingest (b) {card}: {len(rows)} bits over {s_n} slices in one "
          f"request in {in_s:.2f} s ({len(rows) / in_s:.0f} bits/s); "
          + "; ".join(f"{q} route {r}, first {s:.2f} s"
                      for q, r, s in answers)
          + f"; equal to numpy; (b) {time.perf_counter() - t:.1f} s")

    # (c) a BSI values batch.
    t = time.perf_counter()
    s_n = INGEST_VALUE_SLICES
    vcols = (base[:s_n] + np.arange(INGEST_VALUES) * 1031
             + rng.integers(0, 1031, (s_n, INGEST_VALUES))).ravel()
    vals = rng.integers(0, 1001, len(vcols))
    http_json(conn, "POST", "/index/sp/frame/b", json.dumps(
        {"options": {"rangeEnabled": True, "fields": [
            {"name": "v", "type": "int", "min": 0, "max": 1000}]}}).encode())
    got = post_ingest(conn, "sp", codec.encode_values("b", "v", vcols,
                                                      vals))
    in_s = time.perf_counter() - t
    check(got == {"accepted": len(vcols), "slices": s_n}, f"(c) {got}")
    tq = time.perf_counter()
    got = index_query(conn, "sp", 'Sum(frame="b", field="v") '
                                  'Max(frame="b", field="v")')
    sum_s = time.perf_counter() - tq
    top = int(vals.max())
    w = [{"sum": int(vals.sum()), "count": len(vals)},
         {"sum": top, "count": int((vals == top).sum())}]
    check(got == w, f"(c) Sum, Max {got} != {w}")
    print(f"ingest (c) {card}: {len(vcols)} values over {s_n} slices in "
          f"{in_s:.2f} s; first Sum and Max {sum_s:.2f} s; equal to numpy")

    # (d) timestamped bits into a YMD frame.
    t = time.perf_counter()
    rng = np.random.default_rng([seed, 13])
    n = INGEST_TIME_BITS
    trow = rng.integers(0, 4, n)
    tcol = rng.integers(0, INGEST_TIME_SLICES * SLICE_COLS, n)
    hours = rng.integers(0, 14 * 24, n)
    ts = TS_JUNE + hours * 3600
    # The server names a bit's views by its local time, as here.
    uh, inv = np.unique(hours, return_inverse=True)
    local = [datetime.fromtimestamp(TS_JUNE + int(h) * 3600) for h in uh]
    june = np.array([d.year == 2017 and d.month == 6 for d in local])[inv]
    day = np.array([d.day for d in local])[inv]
    http_json(conn, "POST", "/index/ev", b"{}")
    http_json(conn, "POST", "/index/ev/frame/clicks", json.dumps(
        {"options": {"timeQuantum": "YMD"}}).encode())
    got = post_ingest(conn, "ev", codec.encode_bits("clicks", trow, tcol,
                                                    ts))
    in_s = time.perf_counter() - t
    check(got["accepted"] == n, f"(d) {got}")
    for label, lo, hi in (("14 days", 1, 15), ("1 day", 5, 6)):
        start, end = f"2017-06-{lo:02d}T00:00", f"2017-06-{hi:02d}T00:00"
        for r in (0, 3):
            keep = (trow == r) & june & (day >= lo) & (day < hi)
            w = len(np.unique(tcol[keep]))
            got = index_query(conn, "ev", (
                f'Count(Range(frame="clicks", rowID={r}, start="{start}", '
                f'end="{end}"))'))[0]
            check(got == w, f"(d) {label} row {r}: {got} != {w}")
    print(f"ingest (d) {card}: {n} timestamped bits (YMD, 14 days, "
          f"{INGEST_TIME_SLICES} slices) in {in_s:.2f} s; Count(Range) over "
          f"14 days and 1 day equal to numpy; "
          f"{time.perf_counter() - t:.1f} s")
    vars_ = http_json(conn, "GET", "/debug/vars")["ingest"]
    launched = kernels.launches["ingest_classify"]
    check(DEVICE != "cuda" or launched == vars_["packPassesTotal"] > 0,
          f"ingest_classify launched {launched} times for "
          f"{vars_['packPassesTotal']} classify passes")
    resident = server.holder.governor.resident_bytes()
    check(resident <= INGEST_HOST_BYTES,
          f"resident host bytes {resident} over {INGEST_HOST_BYTES}")

    # (e) keyed import: JSON /import, then cli import -k.
    t = time.perf_counter()
    rng = np.random.default_rng([seed, 14])
    rk = [f"term-{i}" for i in rng.integers(0, KEYED_ROWS, KEYED_PAIRS)]
    ck = [f"user-{j}" for j in rng.integers(0, KEYED_COLS, KEYED_PAIRS)]
    http_json(conn, "POST", "/index/keyed", b"{}")
    http_json(conn, "POST", "/index/keyed/frame/k", b"{}")
    http_json(conn, "POST", "/import", json.dumps(
        {"index": "keyed", "frame": "k", "rowKeys": rk,
         "columnKeys": ck}).encode())
    json_s = time.perf_counter() - t
    crk = [f"term-{i}" for i in rng.integers(0, KEYED_ROWS + 20,
                                              KEYED_CLI_LINES)]
    cck = [f"user-{j}" for j in rng.integers(0, 2 * KEYED_COLS,
                                              KEYED_CLI_LINES)]
    csv_path = os.path.join(datadir, ".keyed.csv")  # not an index
    with open(csv_path, "w") as fh:
        fh.write("".join(f"{a},{b}\n" for a, b in zip(crk, cck)))
    t_cli = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "import", "--host",
         server.host, "-i", "keyed", "-f", "k", "-k", csv_path], cwd=HERE,
        capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t_cli
    check(out.returncode == 0 and out.stdout.strip()
          == f"imported {KEYED_CLI_LINES} keyed bits",
          f"cli import -k: {out.returncode} {out.stdout} {out.stderr}")
    row_id = {k: i for i, k in enumerate(dict.fromkeys(rk + crk))}
    col_id = {k: i for i, k in enumerate(dict.fromkeys(ck + cck))}
    bits = {(row_id[a], col_id[b]) for a, b in zip(rk + crk, ck + cck)}
    per_row = np.bincount([r for r, _ in bits], minlength=len(row_id))
    counts_q = " ".join(f'Count(Bitmap(frame="k", rowID={i}))'
                        for i in range(len(row_id)))
    got = index_query(conn, "keyed", counts_q)
    check(got == per_row.tolist(), "(e) keyed counts != numpy")
    # The directory reopened: the same keys are the same ids.
    vars_b = http_json(conn, "GET", "/debug/vars")["ingest"]
    conn.close()
    server.close()
    t_re = time.perf_counter()
    server = Server(datadir, bind="127.0.0.1:0", device=DEVICE,
                    host_bytes=INGEST_HOST_BYTES).open()
    reopen_s = time.perf_counter() - t_re
    host, port = server.host.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    late_r = [f"term-{i}" for i in range(10)]
    late_c = [f"late-{i}" for i in range(10)]
    http_json(conn, "POST", "/import", json.dumps(
        {"index": "keyed", "frame": "k", "rowKeys": late_r,
         "columnKeys": late_c}).encode())
    for k in late_r:
        per_row[row_id[k]] += 1
    got = index_query(conn, "keyed", counts_q)
    check(got == per_row.tolist(), "(e) keyed counts after reopen")
    print(f"ingest (e) {card}: {KEYED_PAIRS} keyed pairs by JSON /import "
          f"in {json_s:.2f} s; cli import -k of {KEYED_CLI_LINES} lines "
          f"{cli_s:.2f} s; {len(row_id)} rows' counts by translated ids "
          f"equal to numpy, again after a reopen ({reopen_s:.2f} s) and a "
          f"keyed import of known row keys")

    # (f) docs/input-definition.md's definition and INPUT_RECORDS records.
    t = time.perf_counter()
    rng = np.random.default_rng([seed, 15])
    kinds = ("click", "view", "buy")
    users = rng.integers(0, 4 * SLICE_COLS, INPUT_RECORDS)
    kind = rng.integers(0, 3, INPUT_RECORDS)
    active = rng.integers(0, 2, INPUT_RECORDS).astype(bool)
    score = rng.integers(20, 40, INPUT_RECORDS)
    records = [{"user_id": int(u), "kind": kinds[k], "active": bool(a),
                "score": int(s)}
               for u, k, a, s in zip(users, kind, active, score)]
    http_json(conn, "POST", "/index/users", json.dumps(
        {"options": {"columnLabel": "user_id"}}).encode())
    http_json(conn, "POST", "/index/users/input-definition/events",
              json.dumps(INPUT_DEF).encode())
    got = http_json(conn, "GET", "/index/users/input-definition/events")
    check(got["frames"] == INPUT_DEF["frames"], f"(f) definition {got}")
    http_json(conn, "POST", "/index/users/input/events",
              json.dumps(records).encode())
    want_rows = {r: set() for r in (0, 1, 2, 10, *range(20, 40))}
    for u, k, a, s in zip(users.tolist(), kind.tolist(), active.tolist(),
                          score.tolist()):
        want_rows[k].add(u)
        want_rows[s].add(u)
        if a:
            want_rows[10].add(u)
    got = index_query(conn, "users", " ".join(
        f'Count(Bitmap(frame="event", rowID={r}))' for r in want_rows))
    check(got == [len(v) for v in want_rows.values()],
          f"(f) counts {got}")
    print(f"ingest (f) {card}: {INPUT_RECORDS} records through "
          f"docs/input-definition.md's definition in "
          f"{time.perf_counter() - t:.2f} s; {len(want_rows)} rows' counts "
          f"equal to numpy")
    resident = server.holder.governor.resident_bytes()
    check(resident <= INGEST_HOST_BYTES,
          f"resident host bytes {resident} over {INGEST_HOST_BYTES}")
    conn.close()
    server.close()
    launches = launch_counts()
    check(DEVICE != "cuda" or launches["ingest_classify"] > 0,
          f"ingest_classify never launched in phase 11: {launches}")
    print(f"ingest {card}: /debug/vars ingest {json.dumps(vars_b)}; "
          f"ingest_classify launches {launches['ingest_classify']}; host "
          f"bytes {resident} within {INGEST_HOST_BYTES}; phase 11 "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ phase 12

# Phase 12's cluster: three nodes, replicas 2 (pilosa_tpu's own test
# topology, tests/test_server.py:199-205, and docs/administration.md's
# documented three-host shape), in one process on the card. reduced:
# 512 slices, not 9,537 (nor 1,024: at 1,024 the phase took 40.5-51.6 s
# and the script 1,090.4 s of its 1,200 s limit on a slower host; PERF.md
# §4); the data is written twice (once a slice per owner) plus once more
# for the one-node comparison.
CLUSTER_SLICES = 512
CLUSTER_NODES = 3
CLUSTER_REPLICAS = 2
# Each in-process node's device stack budget: a share of the card's
# 80 GB with room for the comparison node's default budget.
CLUSTER_STACK_BYTES = 12 << 30
CLUSTER_FRAGS = os.path.join("i", "f", "views", "standard", "fragments")
CLUSTER_WARM = 50           # warm Count(Intersect)s timed through HTTP
# The nodes' epoch probe ttl for the phase: (g)'s staleness bound.
CLUSTER_EPOCH_TTL = 0.5
CLUSTER_CLIENTS = (8, 32)   # (h)'s closed-loop clients through node 1
CLUSTER_CONC_S = 2.0        # (h)'s window a point, after 0.5 s of warm-up
CLUSTER_INGEST_REQUESTS = 2  # (i): 8,000,000 bits each over 32 slices
CLUSTER_INGEST_ROWS = (0, 1, 2, 3, 511, 512, 1022, 1023)  # (i)'s Counts
CLUSTER_INGEST_OWNER_ROWS = 16  # (i): rows counted on each owner's slices


def _write_cluster_slices(root, seed, lo, hi):
    """Worker: frame f's fragment files of slices [lo, hi) and their
    ``.cache`` sidecars, phase 4's rows written by the port's codec (the
    bytes ``Fragment.read_from`` would write), into the directory of
    each owner that placement gives the slice (``root/n<k>``) and into
    ``root/all``; returns the per-query counts, each row's count and
    |row r & row 0| per slice, row 3's ascending column ids and
    |row a & row b| over the run."""
    from pilosa_tpu_torch.cluster.cluster import Cluster, Node
    from pilosa_tpu_torch.roaring import codec

    cl = Cluster(nodes=[Node(f"n{k}") for k in range(CLUSTER_NODES)],
                 replica_n=CLUSTER_REPLICAS)
    keys = np.arange(4 * 16, dtype=np.uint64)  # rows 0-3 × 16 containers
    counts = np.zeros((len(QUERIES), hi - lo), dtype=np.int64)
    rows = np.zeros((4, hi - lo), dtype=np.int64)
    and_f0 = np.zeros((4, hi - lo), dtype=np.int64)
    pairs = np.zeros((4, 4), dtype=np.int64)
    r3 = []
    for i, s in enumerate(range(lo, hi)):
        words = slice_words(seed, s)
        counts[:, i] = slice_counts(words)
        rows[:, i] = np.bitwise_count(words).sum(axis=1)
        and_f0[:, i] = np.bitwise_count(words & words[0]).sum(axis=1)
        for a in range(4):
            pairs[a] += np.bitwise_count(words & words[a]).sum(
                axis=1, dtype=np.int64)
        r3.append(positions(words[3]) + np.uint64(s * SLICE_COLS))
        data = codec.serialize_arrays(keys, words.reshape(64, 1024))
        for d in [n.host for n in cl.fragment_nodes("i", s)] + ["all"]:
            path = os.path.join(root, d, CLUSTER_FRAGS, str(s))
            with open(path, "wb") as fh:
                fh.write(data)
            with open(path + ".cache", "w") as fh:
                fh.write("[0, 1, 2, 3]")
    return lo, counts, rows, and_f0, np.concatenate(r3), pairs


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _first_zero(seed, s, row):
    """The column of the first bit of ``row`` not set in slice ``s``."""
    return s * SLICE_COLS + int(np.flatnonzero(np.unpackbits(
        (~slice_words(seed, s)[row]).view(np.uint8),
        bitorder="little"))[0])


def cluster_warm_tiers(servers, conns, slices, want, n3, seed, card):
    """Phase 12 (g): node 1's result memos and response cache on (the
    other nodes' off). Warm Count(Intersect)s over HTTP through node 1
    replay; a SetBit and a ClearBit through node 1 to a slice it holds
    no copy of are read by the very next query through it, the owners'
    moved counters coming back in the writes' own answers."""
    node = servers[0]
    ex, cache = node.executor, node.handler._resp_cache
    q_and, r3 = QUERIES[2][0], 'Bitmap(frame="f", rowID=3)'
    cl = node.cluster
    s_g = next(s for s in reversed(range(slices)) if node.host not in
               [n.host for n in cl.fragment_nodes("i", s)])
    col = _first_zero(seed, s_g, 3)
    t0 = time.perf_counter()
    ex._result_memo_off = False
    try:
        # The first query's answers bring the peers' counters up to date,
        # so the second one computes and keeps its answer again.
        for _ in range(2):
            check(http_query(conns[0], q_and) == [want[2]],
                  "(g) first Count")
        h0 = cache.stats()["hits"]
        hit_ms, got = p50_ms(lambda: http_query(conns[0], q_and),
                             CLUSTER_WARM)
        check(got == [want[2]], f"(g) warm Count: {got} != {want[2]}")
        hits = cache.stats()["hits"] - h0
        check(hits == CLUSTER_WARM,
              f"(g) {hits} response-cache hits of {CLUSTER_WARM} repeats")
        for _ in range(2):
            got = http_query(conns[0], f"Count({r3})")
            check(got == [n3], f"(g) Count({r3}): {got} != {n3}")
        h1 = cache.stats()["hits"]
        for verb, n in (("SetBit", n3 + 1), ("ClearBit", n3)):
            got = http_query(conns[0], f'{verb}(frame="f", rowID=3, '
                                       f'columnID={col})')
            check(got == [True], f"(g) {verb} through node 1: {got}")
            for _ in range(2):
                got = http_query(conns[0], f"Count({r3})")
                check(got == [n], f"(g) node 1 right after its {verb}: "
                      f"{got} != {n}")
        ryw_hits = cache.stats()["hits"] - h1
    finally:
        ex._result_memo_off = True
    ep = node.epochs.snapshot()["counters"]
    print(f"cluster (g) {card}: {time.perf_counter() - t0:.1f} s; warm "
          f"Count(Intersect) through node 1 with its memos on: hit p50 {hit_ms:.4f} ms over HTTP (n="
          f"{CLUSTER_WARM}, host clock; {hits} response-cache hits); "
          f"SetBit and ClearBit through node 1 to slice {s_g} (not its "
          f"own) read by its next query, {ryw_hits} hits around them; "
          f"node 1's epoch probes {ep['probes']} (failed "
          f"{ep['probe_failures']}), cold tokens {ep['cold']} of "
          f"{ep['tokens']}")


def cluster_batch_lanes(node, slices, seed, pair_counts, card):
    """Phase 12 (h): CLUSTER_CLIENTS closed-loop clients (8c's count mix,
    in processes without torch) through node 1 for CLUSTER_CONC_S each,
    memos off, node 1's remote batch lanes on, then off. Report only."""
    ex = node.executor
    host, port = node.host.rsplit(":", 1)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(CONC_PROCS) as pool:
        pool.map(time.sleep, [0] * CONC_PROCS)   # workers up and imported
        for batching in (True, False):
            ex._rb_enabled = batching
            for n_clients in CLUSTER_CLIENTS:
                procs = min(n_clients, CONC_PROCS)
                jobs = [list(range(p, n_clients, procs))
                        for p in range(procs)]
                start_ts = time.time() + 0.5
                res = pool.starmap_async(_conc_client, [
                    (host, int(port), "count", tids, seed, pair_counts,
                     slices, start_ts, 0.5, CLUSTER_CONC_S)
                    for tids in jobs])
                time.sleep(max(0.0, start_ts + 0.5 - time.time()))
                rb0 = ex.remote_batch_snapshot()
                time.sleep(max(0.0, start_ts + 0.5 + CLUSTER_CONC_S
                               - time.time()))
                rb1 = ex.remote_batch_snapshot()
                outs = res.get(timeout=600)
                bad = [o["bad"] for o in outs if o["bad"]]
                check(not bad, f"(h) {n_clients} clients: {bad[:3]}")
                n = sum(o["n"] for o in outs)
                lat = np.asarray([x for o in outs for x in o["lat"]["count"]])
                check(n > 0, f"(h) {n_clients} clients: no request")
                print(f"cluster (h) {card}: {n_clients} clients through node "
                      f"1, batch lanes {'on ' if batching else 'off'}: "
                      f"{n / CLUSTER_CONC_S:.1f} q/s, p50 "
                      f"{np.percentile(lat, 50):.3f} ms, p99 "
                      f"{np.percentile(lat, 99):.3f} ms; rounds "
                      f"{rb1['rounds'] - rb0['rounds']}, batched_calls "
                      f"{rb1['batched_calls'] - rb0['batched_calls']} over "
                      f"{CLUSTER_CONC_S:.0f} s")
    ex._rb_enabled = True
    print(f"cluster (h) {card}: {time.perf_counter() - t0:.1f} s")


def set_tracing(servers, on):
    """A Tracer on every in-process node's handler (``on``), or each
    node's own (tracing off)."""
    from pilosa_tpu_torch import tracing

    for srv in servers:
        srv.handler.tracer = tracing.Tracer() if on else srv.tracer


def stitched_profile(conns, pql):
    """POST ``pql`` with ``?profile=true`` through ``conns[0]``; -> (its
    results, its profile, the trace stitched from every node's
    ``/debug/traces?traceId=``, seconds)."""
    from pilosa_tpu_torch import tracing

    t = time.perf_counter()
    status, ctype, body = http_request(conns[0], "POST",
                                       "/index/i/query?profile=true",
                                       pql.encode())
    secs = time.perf_counter() - t
    check(status == 200 and ctype == "application/json",
          f"profiled {pql[:60]}: {status} {body[:300]!r}")
    doc = json.loads(body)
    tid = doc["profile"]["traceId"]
    pieces = []
    for c in conns:
        pieces.extend(http_json(c, "GET", f"/debug/traces?traceId={tid}")[
            "traces"])
    return doc["results"], doc["profile"], tracing.stitch(pieces), secs


def fanout_legs(stitched, coordinator):
    """The peer legs of a stitched cluster trace: (host, leg ms, the
    peer's query.remote ms) for each ``remote.<host>`` span, checked to
    hold its peer's ``query.remote``; and the coordinator's
    ``node.local`` ms."""
    spans = stitched["spans"]
    by_id = {sp["spanId"]: sp for sp in spans}
    kids = {}
    for sp in spans:
        kids.setdefault(sp["parentId"], []).append(sp)

    def under(sp, name):
        out = []
        for c in kids.get(sp["spanId"], ()):
            if c["name"] == name:
                out.append(c)
            out.extend(under(c, name))
        return out

    legs = []
    for sp in spans:
        if not sp["name"].startswith("remote.") or \
                sp["name"] == "remote.round":
            continue
        host = sp["tags"]["host"]
        check(host != coordinator and sp["name"] == f"remote.{host}",
              f"a leg span {sp['name']} to {host}")
        remote = under(sp, "query.remote")
        check(len(remote) == 1 and remote[0]["tags"]["host"] == host,
              f"leg to {host}: {len(remote)} query.remote spans under it")
        legs.append((host, sp["durationMs"], remote[0]["durationMs"]))
    local = [sp["durationMs"] for sp in spans if sp["name"] == "node.local"]
    check(all(by_id.get(sp["parentId"]) is not None for sp in spans
              if sp["name"] == "query.remote"),
          "a peer's query.remote has no parent in the stitched trace")
    return legs, local


def cluster_traces(servers, conns, slices, want_and, topn_src, card):
    """Phase 12 (b): a profiled Count(Intersect) and a profiled TopN
    through node 1 with every node tracing, each trace stitched from the
    nodes' ``/debug/traces``: one ``remote.<host>`` span a peer leg with
    that peer's ``query.remote`` under it, the merged ``slices`` the
    query's slice count (a TopN's two phases each count every slice),
    ``fanoutCalls`` the number of peer legs; each leg's ms printed."""
    t0 = time.perf_counter()
    set_tracing(servers, True)
    try:
        for label, pql, want, phases in (
                ("Count(Intersect)", QUERIES[2][0], [want_and], 1),
                ("TopN", 'TopN(Bitmap(frame="f", rowID=0), frame="f", n=4)',
                 [[{"id": r, "count": c} for r, c in topn_src]], 2)):
            got, prof, stitched, secs = stitched_profile(conns, pql)
            check(got == want, f"(b) profiled {label}: {got} != {want}")
            res = prof["resources"]
            legs, local = fanout_legs(stitched, servers[0].host)
            check(res["slices"] == phases * slices,
                  f"(b) {label}: merged slices {res['slices']} != "
                  f"{phases} x {slices}")
            check(res["fanoutCalls"] == len(legs) > 0,
                  f"(b) {label}: fanoutCalls {res['fanoutCalls']}, "
                  f"{len(legs)} legs")
            print(f"cluster (b) {card}: profiled {label} through node 1 in "
                  f"{secs * 1e3:.3f} ms (host clock), trace "
                  f"{prof['durationMs']} ms; legs (peer, leg ms, the peer's "
                  f"query.remote ms): {legs}; node 1's own leg(s) "
                  f"{local} ms; slices {res['slices']}, fanoutCalls "
                  f"{res['fanoutCalls']}, fanoutRetries "
                  f"{res['fanoutRetries']}, servedBy {res['servedBy']}")
    finally:
        set_tracing(servers, False)
    print(f"cluster (b) {card}: {time.perf_counter() - t0:.1f} s")


def _cluster_ingest_batch(seed, k, n):
    """(i)'s request k: n bits, rows uniform over INGEST_ROWS, columns
    over INGEST_SLICES slices."""
    rng = np.random.default_rng([seed, 12, k])
    return (rng.integers(0, INGEST_ROWS, n, dtype=np.uint64),
            rng.integers(0, INGEST_SLICES * SLICE_COLS, n, dtype=np.uint64))


def _cluster_ingest_oracle(seed, n, requests, lo, hi):
    """Worker: the distinct bits of (i)'s requests in slices [lo, hi):
    per-(row, slice) counts and |row 1 ∩ row 2|."""
    keys = []
    for k in range(requests):
        r, c = _cluster_ingest_batch(seed, k, n)
        s = c >> np.uint64(20)
        m = (s >= np.uint64(lo)) & (s < np.uint64(hi))
        keys.append((r[m] << np.uint64(25)) | c[m])
    keys = np.unique(np.concatenate(keys))
    row = (keys >> np.uint64(25)).astype(np.int64)
    cols = (keys & np.uint64((1 << 25) - 1)).astype(np.int64)
    per_slice = np.bincount(row * INGEST_SLICES + (cols >> 20),
                            minlength=INGEST_ROWS * INGEST_SLICES)
    return (per_slice.reshape(INGEST_ROWS, INGEST_SLICES), len(keys),
            len(np.intersect1d(cols[row == 1], cols[row == 2],
                               assume_unique=True)))


def cluster_ingest(servers, conns, seed, card):
    """Phase 12 (i): benchmarks/ingest.py's wide shape through node 2,
    CLUSTER_INGEST_REQUESTS requests of INGEST_BATCH bits, rows uniform
    over INGEST_ROWS and columns over INGEST_SLICES slices, into frame w:
    node 2 sends each slice's part to its owners, whose legs classify on
    the card. Counts through each node and on each owner's own slices
    against numpy (computed in processes of their own while the requests
    run); a ``?slice=`` leg to a node that does not own the slice answers
    412."""
    from pilosa_tpu_torch.executor import ExecOptions
    from pilosa_tpu_torch.ingest import codec
    from pilosa_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    http_json(conns[1], "POST", "/index/i/frame/w", b"{}")
    # The numpy oracle in processes of its own while the requests run.
    edges = np.linspace(0, INGEST_SLICES, CONC_PROCS + 1).astype(int)
    pool = multiprocessing.get_context("spawn").Pool(CONC_PROCS)
    try:
        oracle = pool.starmap_async(_cluster_ingest_oracle, [
            (seed, INGEST_BATCH, CLUSTER_INGEST_REQUESTS, int(lo), int(hi))
            for lo, hi in zip(edges[:-1], edges[1:])])
        bodies = [codec.encode_bits("w", *_cluster_ingest_batch(
            seed, k, INGEST_BATCH)) for k in range(CLUSTER_INGEST_REQUESTS)]
        split = {"make": time.perf_counter() - t0}
        vars0 = [http_json(c, "GET", "/debug/vars")["ingest"]
                 for c in conns]
        l0 = kernels.launches["ingest_classify"]
        t = time.perf_counter()
        outs = [post_ingest(conns[1], "i", b) for b in bodies]
        secs = time.perf_counter() - t
        classify = kernels.launches["ingest_classify"] - l0
        check(outs == [{"accepted": INGEST_BATCH, "slices": INGEST_SLICES}]
              * len(bodies), f"(i) answers {outs}")
        vars1 = [http_json(c, "GET", "/debug/vars")["ingest"]
                 for c in conns]
        t = time.perf_counter()
        parts = oracle.get(timeout=600)
    finally:
        pool.terminate()
    per_slice = sum(p[0] for p in parts)   # the parts' slices are disjoint
    n_keys = sum(p[1] for p in parts)
    and12 = sum(p[2] for p in parts)
    # Through each node, rows across every slice; on each owner, rows'
    # counts over the slices it holds (a count over a freshly ingested
    # frame builds its stacks from the rows' containers: every row of
    # every owner would take seconds).
    rows_q = CLUSTER_INGEST_ROWS
    counts_q = " ".join(f'Count(Bitmap(frame="w", rowID={r}))'
                        for r in rows_q) + (
        ' Count(Intersect(Bitmap(frame="w", rowID=1), '
        'Bitmap(frame="w", rowID=2)))')
    want = [int(per_slice[r].sum()) for r in rows_q] + [and12]
    split["numpy"] = time.perf_counter() - t
    t = time.perf_counter()
    for k, c in enumerate(conns):
        got = http_query(c, counts_q)
        check(got == want, f"(i) Counts through node {k + 1}: {got} != "
              f"{want}")
    split["counts"] = time.perf_counter() - t
    t = time.perf_counter()
    cl = servers[0].cluster
    own_q = " ".join(f'Count(Bitmap(frame="w", rowID={r}))'
                     for r in range(CLUSTER_INGEST_OWNER_ROWS))
    for k, srv in enumerate(servers):
        mine = [s for s in range(INGEST_SLICES)
                if cl.owns_fragment(srv.host, "i", s)]
        got = srv.executor.execute("i", own_q, slices=mine,
                                   opt=ExecOptions(remote=True))
        check(got == per_slice[:CLUSTER_INGEST_OWNER_ROWS, mine].sum(
            axis=1).tolist(), f"(i) node {k + 1}'s copy of its slices")
    split["owners"] = time.perf_counter() - t
    topn_ingested(servers, conns, per_slice, card)
    s_n, k_n = next((s, k) for s in range(INGEST_SLICES)
                    for k in range(len(servers))
                    if not cl.owns_fragment(servers[k].host, "i", s))
    status, _, data = http_request(
        conns[k_n], "POST", f"/index/i/ingest?slice={s_n}",
        codec.encode_bits("w", [1], [s_n * SLICE_COLS + 1]),
        {"Content-Type": INGEST_CT})
    check((status, data) == (412, b'{"error": "host does not own slice"}'),
          f"(i) a leg to a non-owner: {status} {data[:200]!r}")
    passes = [b["packPassesTotal"] - a["packPassesTotal"]
              for a, b in zip(vars0, vars1)]
    check(sum(passes) == classify or DEVICE != "cuda",
          f"(i) classify passes {passes} != launches {classify}")
    n_bits = INGEST_BATCH * len(bodies)
    print(f"cluster (i) {card}: {time.perf_counter() - t0:.1f} s (data "
          f"{split['make']:.1f}, the numpy oracle's wait "
          f"{split['numpy']:.1f}, Counts "
          f"through the nodes {split['counts']:.1f}, on the owners "
          f"{split['owners']:.1f}); {len(bodies)} requests of {INGEST_BATCH} "
          f"bits over {INGEST_SLICES} slices through node 2 in {secs:.2f} "
          f"s: {n_bits / secs:.0f} bits/s; fanout_posts "
          f"{vars1[1]['fanoutPostsTotal'] - vars0[1]['fanoutPostsTotal']};"
          f" classify passes by node {passes}, ingest_classify launches "
          f"{classify}; {n_keys} distinct bits; Counts of "
          f"{len(rows_q)} rows and an Intersect over every slice through "
          f"each node, and of {CLUSTER_INGEST_OWNER_ROWS} rows on each "
          f"owner's own slices, equal to numpy; a ?slice={s_n} leg to "
          f"node {k_n + 1} answered 412")


CLUSTER_TOPN_MAX_S = 10.0   # (c): the TopN's bound, a third of a leg's


def topn_ingested(servers, conns, per_slice, card):
    """Phase 12 (c): TopN(frame="w", n=1,024) through node 1 right after
    (i)'s ingest, every node tracing and the query profiled, equal to
    numpy's two-phase answer, no leg failed over (``fanoutRetries`` 0),
    within CLUSTER_TOPN_MAX_S (the client's timeout is 30 s a leg). Its
    stitched trace's slowest spans are printed, and each leg's time."""
    pql = f'TopN(frame="w", n={INGEST_ROWS})'
    want = [[{"id": r, "count": c}
             for r, c in topn_pairs(per_slice.sum(axis=1))]]
    set_tracing(servers, True)
    failure = None
    try:
        try:
            got, prof, stitched, secs = stitched_profile(conns, pql)
        except SmokeFailure as e:
            failure = e
        if failure is not None:
            # Each node's last traces: where its legs spent their time,
            # and the error each span ended with.
            for k, c in enumerate(conns):
                for tr in http_json(c, "GET", "/debug/traces?n=4")[
                        "traces"]:
                    bad = [f"{sp['name']} {sp['durationMs']} ms "
                           f"{sp['tags'].get('error')}"
                           for sp in tr["spans"] if "error" in sp["tags"]]
                    top = sorted(tr["spans"], key=lambda sp: -(
                        sp["durationMs"] or 0))[:4]
                    print(f"cluster (c) {card}: node {k + 1} trace "
                          f"{tr['durationMs']} ms: slowest " + "; ".join(
                              f"{sp['name']} {sp['durationMs']} ms"
                              for sp in top) + f"; errors {bad}")
            raise failure
    finally:
        set_tracing(servers, False)
    slow = sorted(stitched["spans"], key=lambda sp: -(sp["durationMs"]
                                                      or 0))[:8]
    print(f"cluster (c) {card}: {pql} through node 1 right after the "
          f"ingest in {secs:.3f} s (host clock); slowest spans: " + "; ".join(
              f"{sp['name']} {sp['durationMs']} ms "
              f"{json.dumps(sp['tags'])}" for sp in slow))
    legs, local = fanout_legs(stitched, servers[0].host)
    print(f"cluster (c) {card}: legs (peer, leg ms, query.remote ms) "
          f"{legs}; node 1's own {local} ms; resources "
          f"{json.dumps(prof['resources'])}")
    check(got == want, f"(c) {pql}: {str(got)[:300]} != numpy "
          f"{str(want)[:300]}")
    check(prof["resources"]["fanoutRetries"] == 0,
          f"(c) {pql}: a leg failed over ({prof['resources']})")
    check(secs <= CLUSTER_TOPN_MAX_S,
          f"(c) {pql} took {secs:.1f} s > {CLUSTER_TOPN_MAX_S} s")


def cluster_keyed(servers, conns, seed, card):
    """Phase 12 (j): KEYED_PAIRS keyed pairs (phase 11 (e)'s shape) by
    JSON ``/import`` through a node that is not the key authority (the
    lowest host); the Counts of every translated row through each node
    against numpy."""
    hosts = [s.host for s in servers]
    auth = min(range(len(hosts)), key=lambda k: hosts[k])
    via = next(k for k in range(len(hosts)) if k != auth)
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 15])
    rk = [f"term-{i}" for i in rng.integers(0, KEYED_ROWS, KEYED_PAIRS)]
    ck = [f"user-{j}" for j in rng.integers(0, KEYED_COLS, KEYED_PAIRS)]
    http_json(conns[0], "POST", "/index/i/frame/k", b"{}")
    t = time.perf_counter()
    http_json(conns[via], "POST", "/import", json.dumps(
        {"index": "i", "frame": "k", "rowKeys": rk,
         "columnKeys": ck}).encode())
    secs = time.perf_counter() - t
    row_id = {k: i for i, k in enumerate(dict.fromkeys(rk))}
    col_id = {k: i for i, k in enumerate(dict.fromkeys(ck))}
    bits = {(row_id[a], col_id[b]) for a, b in zip(rk, ck)}
    per_row = np.bincount([r for r, _ in bits], minlength=len(row_id))
    counts_q = " ".join(f'Count(Bitmap(frame="k", rowID={i}))'
                        for i in range(len(row_id)))
    for k, c in enumerate(conns):
        got = http_query(c, counts_q)
        check(got == per_row.tolist(),
              f"(j) keyed counts through node {k + 1} != numpy")
    print(f"cluster (j) {card}: {time.perf_counter() - t0:.1f} s; "
          f"{KEYED_PAIRS} keyed pairs by JSON /import "
          f"through node {via + 1} (the key authority is node {auth + 1}) "
          f"in {secs:.2f} s; {len(row_id)} rows' Counts through each node "
          f"equal to numpy")


def cluster_path(seed, datadir, card):
    """Phase 12: three nodes of a static cluster (replicas 2) on the card
    in one process, each over its own directory of the slices placement
    gives it, plus one ``cli server`` process as a node; see the module
    docstring."""
    import http.client
    import signal

    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.cluster.client import InternalClient
    from pilosa_tpu_torch.executor import ExecOptions
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.storage.holder import Holder

    slices = CLUSTER_SLICES
    root = os.path.join(datadir, "cluster")
    names = [f"n{k}" for k in range(CLUSTER_NODES)]
    for d in names + ["all"]:
        h = Holder(os.path.join(root, d), device=DEVICE).open()
        h.create_index("i").create_frame("f").create_view_if_not_exists(
            "standard")
        h.close()
    t0 = time.perf_counter()
    procs, parts = in_processes(_write_cluster_slices, root, seed, slices)
    per_slice = np.concatenate([p[1] for p in parts], axis=1)
    row_n = np.concatenate([p[2] for p in parts], axis=1)
    and_f0 = np.concatenate([p[3] for p in parts], axis=1).sum(axis=1)
    r3_ids = np.concatenate([p[4] for p in parts])
    pair_counts = sum(p[5] for p in parts).tolist()
    del parts
    want = [int(c) for c in per_slice.sum(axis=1)]
    print(f"cluster: wrote {slices} slices to their {CLUSTER_REPLICAS} "
          f"owners of {CLUSTER_NODES} nodes and to one node holding all, "
          f"in {procs} processes in {time.perf_counter() - t0:.1f} s")

    def conn_of(host):
        h, p = host.rsplit(":", 1)
        return http.client.HTTPConnection(h, int(p), timeout=300)

    def counts_through(conn, tag):
        for (q, _), w in zip(QUERIES, want):
            got = http_query(conn, q)
            check(got == [w], f"{tag} {q}: {got} != oracle {w}")

    def warm_ms(conn, q, n):
        lat = []
        for _ in range(n):
            t = time.perf_counter()
            http_query(conn, q)
            lat.append((time.perf_counter() - t) * 1e3)
        return np.percentile(lat, 50), np.percentile(lat, 90)

    q_and = QUERIES[2][0]
    # The same query on one node holding every slice (memos off, as in
    # every phase that times execution).
    one = Server(os.path.join(root, "all"), bind="127.0.0.1:0",
                 device=DEVICE).open()
    try:
        conn = conn_of(one.host)
        t = time.perf_counter()
        check(http_query(conn, q_and) == [want[2]], "one node: Count")
        one_first_s = time.perf_counter() - t
        one_p50, one_p90 = warm_ms(conn, q_and, CLUSTER_WARM)
        conn.close()
    finally:
        one.close()

    hosts = [f"127.0.0.1:{p}" for p in _free_ports(CLUSTER_NODES)]
    memo_env = os.environ.pop("PILOSA_TPU_RESULT_MEMO", None)
    servers = [None] * CLUSTER_NODES

    def open_node(k):
        # The membership rounds are driven by this phase; the memos (and
        # the response cache) are off so that the steps time execution,
        # but in (g) and the process node's step.
        s = Server(os.path.join(root, names[k]), bind=hosts[k],
                   cluster_hosts=hosts, replica_n=CLUSTER_REPLICAS,
                   polling_interval=0, device=DEVICE,
                   stack_bytes=CLUSTER_STACK_BYTES,
                   epoch_probe_ttl=CLUSTER_EPOCH_TTL).open()
        s.cluster.node_set.close()
        s.executor._result_memo_off = True
        servers[k] = s
        return s

    proc = None
    client = InternalClient()
    reset_peak()
    kernels.reset_launches()
    try:
        t = time.perf_counter()
        for k in range(CLUSTER_NODES):
            open_node(k)
        for s in servers:
            s.cluster.node_set.probe_once()  # heartbeats: peers' maxima
        open_s = time.perf_counter() - t
        conns = [conn_of(h) for h in hosts]
        for k, c in enumerate(conns):
            got = http_json(c, "GET", "/slices/max")
            check(got == {"maxSlices": {"i": slices - 1}},
                  f"node {k} /slices/max {got}")
        t = time.perf_counter()
        check(http_query(conns[0], q_and) == [want[2]], "first Count")
        first_s = time.perf_counter() - t
        for k, c in enumerate(conns):
            counts_through(c, f"node {k}")
        p50, p90 = warm_ms(conns[0], q_and, CLUSTER_WARM)
        # Where a fanned-out Count's time goes: node 3's leg alone as the
        # coordinator sends it (protobuf over HTTP), and node 1's own leg
        # in process.
        cl = servers[0].cluster
        prim = [[s for s in range(slices)
                 if cl.fragment_nodes("i", s)[0].host == h] for h in hosts]
        leg_ms, _ = p50_ms(lambda: client.execute_query(
            hosts[2], "i", q_and, slices=prim[2], remote=True),
            CLUSTER_WARM)
        local_ms, _ = p50_ms(lambda: servers[0].executor.execute(
            "i", q_and, slices=prim[0], opt=ExecOptions(remote=True)),
            CLUSTER_WARM)

        # TopN with and without a Src, and a bitmap with attributes,
        # through every node.
        topn_src = topn_pairs(and_f0)
        topn_all = topn_pairs(row_n.sum(axis=1))
        r3 = 'Bitmap(frame="f", rowID=3)'
        got = http_query(conns[0], 'SetRowAttrs(frame="f", rowID=3, '
                                   'name="stargazer")')
        check(got == [None], f"SetRowAttrs {got}")
        for k, c in enumerate(conns):
            for q, w in (('TopN(Bitmap(frame="f", rowID=0), frame="f", '
                          'n=4)', topn_src), ('TopN(frame="f", n=4)',
                                              topn_all)):
                got = [(p["id"], p["count"]) for p in http_query(c, q)[0]]
                check(got == w, f"node {k} {q}: {got} != oracle {w}")
            got = http_query(c, r3)[0]
            check(got["attrs"] == {"name": "stargazer"}
                  and np.array_equal(np.asarray(got["bits"], np.uint64),
                                     r3_ids),
                  f"node {k} {r3}: attrs {got['attrs']}, "
                  f"{len(got['bits'])} ids != {len(r3_ids)}")

        cluster_traces(servers, conns, slices, want[2], topn_src, card)

        # SetBit and ClearBit through a node that owns no copy of the
        # slice, each read from every node.
        s_w = next(s for s in range(slices)
                   if hosts[0] not in [n.host for n in
                                       cl.fragment_nodes("i", s)])
        col = s_w * SLICE_WIDTH + int(np.flatnonzero(
            np.unpackbits((~slice_words(seed, s_w)[3]).view(np.uint8),
                          bitorder="little"))[0])
        n3 = len(r3_ids)
        for verb, n in (("SetBit", n3 + 1), ("ClearBit", n3)):
            got = http_query(conns[0],
                             f'{verb}(frame="f", rowID=3, columnID={col})')
            check(got == [True], f"{verb} through a non-owner: {got}")
            for k, c in enumerate(conns):
                got = http_query(c, f"Count({r3})")
                check(got == [n], f"node {k} after {verb}: {got} != {n}")
        # DDL through node 2 reaches every node.
        http_json(conns[1], "POST", "/index/i/frame/g", b"{}")
        for k, c in enumerate(conns):
            got = [f["name"] for f in http_json(c, "GET", "/schema")[
                "indexes"][0]["frames"]]
            check(got == ["f", "g"], f"node {k} frames {got}")
        t_gj = time.perf_counter()
        l_gj = launch_counts()
        cluster_warm_tiers(servers, conns, slices, want, n3, seed, card)
        cluster_batch_lanes(servers[0], slices, seed, pair_counts, card)
        cluster_ingest(servers, conns, seed, card)
        cluster_keyed(servers, conns, seed, card)
        l_gj = {k: v - l_gj[k] for k, v in launch_counts().items()
                if k not in ("regimes", "container_forms")}
        print(f"cluster (g)-(j) {card}: {time.perf_counter() - t_gj:.1f} s; "
              f"launches {json.dumps({k: l_gj[k] for k in QUERY_KERNELS + ('ingest_classify',)})}")
        check(DEVICE != "cuda" or all(l_gj[k] for k in (
            "count_op_rows", "count_rows", "ingest_classify")),
              f"(g)-(j): a kernel never launched: {l_gj}")
        launches = launch_counts()

        # Each node's local leg alone: the three kernels, per node.
        per_node = {}
        for k in range(CLUSTER_NODES):
            kernels.reset_launches()
            for q in (q_and, QUERIES[0][0], 'TopN(Bitmap(frame="f", '
                                            'rowID=0), frame="f", n=4)'):
                client.execute_query(hosts[k], "i", q, slices=prim[k],
                                     remote=True)
            per_node[names[k]] = {n: kernels.launches[n]
                                  for n in QUERY_KERNELS}
            check(DEVICE != "cuda" or all(per_node[names[k]].values()),
                  f"node {k}'s local leg launched {per_node[names[k]]}")
        kernels.reset_launches()

        # Failover: node 3 closes; Counts through nodes 1 and 2 stay exact
        # (its legs fail and remap to replicas), then a membership round
        # holds it DOWN and a write to one of its slices is hinted.
        servers[2].close()
        servers[2] = None
        t = time.perf_counter()
        counts_through(conns[0], "failover node 0")
        failover_s = time.perf_counter() - t
        counts_through(conns[1], "failover node 1")
        for s in servers[:2]:
            s.cluster.node_set.suspect_after = 1
            s.cluster.node_set.probe_once()
            check(s.cluster.node_set.is_down(hosts[2]), "node 3 not DOWN")
        s_h = next(s for s in range(slices)
                   if hosts[2] in [n.host for n in cl.fragment_nodes("i", s)])
        col = s_h * SLICE_WIDTH + int(np.flatnonzero(
            np.unpackbits((~slice_words(seed, s_h)[3]).view(np.uint8),
                          bitorder="little"))[0])
        got = http_query(conns[0], f'SetBit(frame="f", rowID=3, '
                                   f'columnID={col})')
        check(got == [True], f"SetBit with node 3 DOWN: {got}")
        check(servers[0].executor.pending_hint_hosts() == [hosts[2]],
              "no write hinted for node 3")
        for k in (0, 1):
            got = http_query(conns[k], f"Count({r3})")
            check(got == [n3 + 1], f"node {k} with node 3 DOWN: {got}")
        # Rejoin: a round sees node 3 again, pushes the schema and
        # replays the hinted write.
        t = time.perf_counter()
        open_node(2)
        for s in servers[:2]:
            s.cluster.node_set.probe_once()
            check(not s.cluster.node_set.is_down(hosts[2]),
                  "node 3 still DOWN")
        rejoin_s = time.perf_counter() - t
        check(not servers[0].executor.pending_hint_hosts(),
              "hints left after the rejoin")
        conns[2].close()
        conns[2] = conn_of(hosts[2])
        got = client.execute_query(hosts[2], "i", f"Count({r3})",
                                   slices=[s_h], remote=True)
        w = int(np.count_nonzero(r3_ids // SLICE_WIDTH == s_h)) + 1
        check(got == [w], f"node 3's copy of slice {s_h}: {got} != {w}")
        for k, c in enumerate(conns):
            got = http_query(c, f"Count({r3})")
            check(got == [n3 + 1], f"node {k} after the rejoin: {got}")
        launches = add_counts(launches, launch_counts())

        # Node 3 as a process of its own on the card: a write through it
        # to a slice node 1 holds no copy of, read through node 1 with
        # memos and the response cache in their default state.
        servers[2].close()
        servers[2] = None
        env = {k: v for k, v in os.environ.items()
               if k not in ("PILOSA_TPU_RESULT_MEMO",
                            "PILOSA_TPU_RESPONSE_CACHE")}
        env["PILOSA_EPOCH_PROBE_TTL"] = str(CLUSTER_EPOCH_TTL)
        device = [] if DEVICE == "cuda" else ["--device", DEVICE]
        t = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d",
             os.path.join(root, names[2]), "-b", hosts[2], *device,
             "--cluster-hosts", ",".join(hosts), "--replicas",
             str(CLUSTER_REPLICAS)], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        _listening_line(proc, 180)
        proc_s = time.perf_counter() - t
        # (g), the other process: node 1's memos and response cache on
        # (their default), a write through the process node to a slice
        # node 1 holds no copy of read through node 1 within one ttl.
        reader = servers[0]
        reader.executor._result_memo_off = False
        check(not reader.executor.memos_off(),
              "node 1's memos are not on for the process node's write")
        s_p = next(s for s in range(slices) if hosts[0] not in
                   [n.host for n in cl.fragment_nodes("i", s)])
        col = s_p * SLICE_WIDTH + int(np.flatnonzero(
            np.unpackbits((~slice_words(seed, s_p)[2]).view(np.uint8),
                          bitorder="little"))[0])
        q2 = QUERIES[1][0]
        for _ in range(2):
            check(http_query(conns[0], q2) == [want[1]], "before the write")
        hits0 = reader.handler._resp_cache.stats()["hits"]
        pconn = conn_of(hosts[2])
        got = http_query(pconn, f'SetBit(frame="f", rowID=2, '
                                f'columnID={col})')
        t_ack = time.perf_counter()
        check(got == [True], f"SetBit through the process node: {got}")
        pconn.close()
        while True:
            t_read = time.perf_counter()
            got = http_query(conns[0], q2)
            if got == [want[1] + 1]:
                break
            check(t_read - t_ack <= CLUSTER_EPOCH_TTL,
                  f"node 1 after the process node's write: {got} != "
                  f"{want[1] + 1} {t_read - t_ack:.3f} s after its ack")
        stale_s = t_read - t_ack
        got = http_query(conns[0], q2)
        check(got == [want[1] + 1], f"node 1's repeat after the process "
              f"node's write: {got}")
        ep = reader.epochs.snapshot()["counters"]
        print(f"cluster (g) {card}: a write through the process node read "
              f"through node 1 {stale_s:.3f} s after its ack (ttl "
              f"{CLUSTER_EPOCH_TTL} s), response-cache hits "
              f"{reader.handler._resp_cache.stats()['hits'] - hits0}; node "
              f"1's epoch probes {ep['probes']} (failed "
              f"{ep['probe_failures']}), cold tokens {ep['cold']}, "
              f"observations {ep['observations']}")
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=60) == 0, "the process node's exit code")
        proc = None
        for c in conns:
            c.close()
    finally:
        if memo_env is not None:
            os.environ["PILOSA_TPU_RESULT_MEMO"] = memo_env
        if proc is not None:
            proc.kill()
            proc.wait()
        client.close()
        for s in servers:
            if s is not None:
                s.close()
    peak = peak_bytes()
    check(DEVICE != "cuda" or all(launches[n] for n in QUERY_KERNELS),
          f"a kernel never launched in the cluster phase: {launches}")
    print(f"cluster {card}: {CLUSTER_NODES} nodes, replicas "
          f"{CLUSTER_REPLICAS}, {slices} slices, one process: open and "
          f"first round {open_s:.2f} s; first Count(Intersect) through "
          f"node 1 {first_s:.2f} s (one node holding every slice: "
          f"{one_first_s:.2f} s); warm Count(Intersect) over HTTP through "
          f"node 1 p50 {p50:.3f} ms, p90 {p90:.3f} ms (one node: p50 "
          f"{one_p50:.3f} ms, p90 {one_p90:.3f} ms; n={CLUSTER_WARM} each, "
          f"host clock); of it, node 3's leg alone (protobuf over HTTP, "
          f"{len(prim[2])} slices) p50 {leg_ms:.3f} ms and node 1's own "
          f"leg in process ({len(prim[0])} slices) p50 {local_ms:.3f} ms "
          f"(host clock to torch.cuda.synchronize()); failover: the first 8 Counts after node 3 closed "
          f"{failover_s:.2f} s; rejoin (open, round, schema push, replay) "
          f"{rejoin_s:.2f} s; process node listening in {proc_s:.1f} s; "
          f"local-leg launches by node {json.dumps(per_node)}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slices", type=int, default=MAIN_SLICES,
                    help="slices of 2^20 columns (default 9537 = 10.0B)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--event-slices", type=int, default=EVENT_SLICES,
                    help="phase 7's slices (a measurement option)")
    ap.add_argument("--sparse-slices", type=int, default=SPARSE_SLICES,
                    help="phase 10's slices (a measurement option)")
    ap.add_argument("--only", default="",
                    help="comma-separated phases of 4, 4g, 5, 6, 8a, 8b, "
                         "7, 9, 10, 11 and 12 to run, without phase 3 and "
                         "the result lines (a measurement option)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    t_start = time.perf_counter()
    # The phases time execution, not memo lookups: the result memos (and
    # with them the response cache) are off until phase 8c turns them on
    # for its warm repeats.
    os.environ["PILOSA_TPU_RESULT_MEMO"] = "0"
    # Each line reaches a redirected log as it is printed.
    sys.stdout.reconfigure(line_buffering=True)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pilosa_tpu_torch.ops import loader

    # Phase 1: device.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}")

    # Phase 2: build.
    t0 = time.perf_counter()
    log = loader.build()
    parts = [f"{n} ({v['seconds']:.2f} s)" for n, v in log.items()]
    print(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(parts)}")
    for name, v in log.items():
        regs = [ln.strip() for ln in v["output"].splitlines()
                if "registers" in ln]
        print(f"  {name}: {'; '.join(regs) or 'cached'}")

    # Phase 3: kernels against their plain versions.
    stats = None if only else kernel_checks(args.slices, card)
    if stats is not None:
        stats["container_and_counts"] = container_checks(card)
        stats["ingest_classify"] = ingest_checks(card)
        KERNEL_MS.update({n: v["ms"] for n, v in stats.items()})

    # Phases 4-12: the main path, Count and bitmap results (then under a
    # host budget), TopN, BSI, the HTTP server over their data directory
    # and the CLI, then time windows, the chemical-similarity shape, the
    # sparse index, bulk ingest and the cluster, each read with the
    # launch counts reset just before it. Phases 7, 9, 10, 11 and 12
    # have data directories of their own.
    datadir = os.path.join(HERE, ".smoke_data")
    shutil.rmtree(datadir, ignore_errors=True)
    oracle = {}
    phase_launches = []

    def phase(key, name, fn, *a):
        if only and key not in only:
            return
        t = time.perf_counter()
        out = fn(*a)
        outs = out if isinstance(out, list) else [out]
        phase_launches.extend(outs)
        for part, counts in zip(("", "c"), outs):
            print(f"phase {name}{part} launches by regime: "
                  f"{json.dumps(counts['regimes'])}; container_and_counts "
                  f"{counts['container_and_counts']} "
                  f"{json.dumps(counts['container_forms'])}")
        print(f"phase {name}: {time.perf_counter() - t:.1f} s {card}")

    try:
        for key, name, fn, a in (
                ("4", "4", main_path, (args.slices, args.seed, datadir,
                                       card, oracle)),
                ("4g", "4 governed", governor_path, (args.slices, datadir,
                                                     card, oracle)),
                ("5", "5", topn_path, (args.slices, args.seed, datadir,
                                       card)),
                ("6", "6", bsi_path, (args.slices, args.seed, datadir,
                                      card, oracle)),
                ("8a", "8a", server_path, (args.slices, args.seed, datadir,
                                           card, oracle))):
            phase(key, name, fn, *a)
        if not only or "8b" in only:  # its launches are another process's
            t = time.perf_counter()
            cli_path(args.seed, os.path.join(datadir, ".cli"), card)
            print(f"phase 8b: {time.perf_counter() - t:.1f} s {card}")
        shutil.rmtree(datadir, ignore_errors=True)
        phase("7", "7", events_path, min(args.event_slices, args.slices),
              args.seed, datadir, card)
        shutil.rmtree(datadir, ignore_errors=True)
        phase("9", "9", chem_path, args.seed, datadir, card)
        shutil.rmtree(datadir, ignore_errors=True)
        phase("10", "10", sparse_path, min(args.sparse_slices, args.slices),
              args.seed, datadir, card)
        shutil.rmtree(datadir, ignore_errors=True)
        phase("11", "11", ingest_path, args.seed, datadir, card)
        shutil.rmtree(datadir, ignore_errors=True)
        phase("12", "12", cluster_path, args.seed, datadir, card)
    finally:
        shutil.rmtree(datadir, ignore_errors=True)
    if phase_launches:
        total = phase_launches[0]
        for counts in phase_launches[1:]:
            total = add_counts(total, counts)
        print(f"launches by regime, phases {sorted(only) if only else '4-12'}"
              f" (8b's subprocess not counted): "
              f"{json.dumps(total['regimes'])}; container_and_counts by "
              f"form {json.dumps(total['container_forms'])} {card}")
    if only:
        print(f"chip_smoke: phases {sorted(only)} in "
              f"{time.perf_counter() - t_start:.1f} s {card}; a partial "
              f"run prints no result")
        return 0

    sources = {"count_op_rows": "pilosa_tpu_torch/csrc/popcount.cu",
               "count_rows": "pilosa_tpu_torch/csrc/popcount.cu",
               "count_and_rows": "pilosa_tpu_torch/csrc/count_and_rows.cu",
               "count_op_pairs": "pilosa_tpu_torch/csrc/popcount.cu",
               "count_and_rows_multi":
                   "pilosa_tpu_torch/csrc/count_and_rows.cu",
               "container_and_counts": "pilosa_tpu_torch/csrc/containers.cu",
               "ingest_classify": "pilosa_tpu_torch/csrc/ingest.cu"}
    replaces = {"count_op_rows": "pilosa_tpu/ops/pallas_kernels.py:126",
                "count_rows": "pilosa_tpu/ops/pallas_kernels.py:195",
                "count_and_rows": "pilosa_tpu/ops/pallas_kernels.py:173",
                # XLA fusions of the coalescer's fused groups
                "count_op_pairs": "pilosa_tpu/executor.py:3552",
                "count_and_rows_multi": "pilosa_tpu/executor.py:3520",
                # XLA count cells of the container tier and their lanes
                "container_and_counts": "pilosa_tpu/ops/containers.py:395",
                # the XLA classify fusion of the bulk-ingest pipeline
                "ingest_classify": "pilosa_tpu/ops/ingest.py:136"}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all {card}")
    print(f"gpu: {smi}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name],
         "launches": sum(pl[name] for pl in phase_launches),
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"], "library_ms": None}
        for name in sources]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
