"""Query executor — PQL's read surface and writes on one node (ref:
executor.go; counterpart of pilosa_tpu/executor.py).

``Executor.execute(index, pql)`` answers ``Count`` and top-level bitmap
calls (a ``Bitmap`` with its row or column attributes) over trees of
``Bitmap``/``Intersect``/``Union``/``Difference``/``Xor``, BSI
``Range(frame=…, field <op> value)`` conditions and time
``Range(frame=…, rowID=…, start=…, end=…)`` windows; ``TopN`` (with or
without a Src tree, ``ids``, ``threshold``, ``tanimotoThreshold``,
``inverse``, attribute ``field``/``filters``); ``Sum``/``Average``/
``Min``/``Max`` over a BSI integer field (with or without a filter
tree); and the writes ``SetBit``/``ClearBit`` (with a ``timestamp``,
into the frame's time views), ``SetFieldValue``, ``SetRowAttrs`` and
``SetColumnAttrs``. A read maps over the index's slices by one of two
paths:

- **batched** (the default): each Bitmap leaf becomes one
  ``int32[n_slices, W]`` device stack (cached until a fragment
  changes), the tree folds with PyTorch bitwise ops, and its ROOT op is
  fused into the ``count_op_rows`` kernel — a two-leaf Count reads each
  stack once and materialises nothing. A single leaf counts with
  ``count_rows``. Per-slice counts are int32; their total is an int64
  sum, so a 10B-column count cannot wrap.
- **serial**: slice by slice through ``Bitmap`` algebra, two-operand
  nodes through the count kernels without materialising.

A time Range is the Union of the leaves of its view cover
(``time_quantum.views_by_time_range``), so ``Count(Range(…))`` folds
n-1 view stacks and meets the last inside ``count_op_rows``. A compound
top-level bitmap call folds into one ``int32[S, W]`` stack whose
per-slice counts come from ``count_rows``; the ``Bitmap`` result defers
the stack (``Bitmap.defer_stack``), so a count never splits it and
``columns()`` finds the set bits on the device. A bare top-level
``Bitmap``/``Range`` runs serially, as in the reference.

Column windows (ref: pilosa_tpu executor.py:3743-3830). Every stack of
one batched plan spans the plan's window: the union of the windows of
the fragments it reads (``Fragment.win32``), widened to a power-of-four
width bucket — 128, 512, 2048, 8192 or 32768 words — with its base
aligned to the width, so device bytes stay within 2× the host windows
and the kernels see five widths. A stack is assembled on the host from
each fragment's words in the window (decoded container by container
from a fragment that is not resident, so a cold read faults nothing
in) and uploaded once. ``PILOSA_TPU_FULL_WIN=1`` pins every plan to the
full slice.

A BSI field's plane i is row i of the view ``field_<name>`` and its
not-null row is row ``depth``, so the batched path reads them as
ordinary cached leaf stacks. A ``Range`` condition plans as a ``"bsi"``
node — the comparison descent of ``ops/bsi.py`` over the plane stacks —
with the reference's shortcuts folded in at plan time (out of range:
``"empty"``; a condition every value meets: the not-null leaf). Batched
``Sum`` is one ``count_and_rows`` launch over the depth+1 BSI stacks
against the filter; batched ``Min``/``Max`` one global descent over all
slices with one count launch and one host sync per plane. Serially,
each slice's fragment answers through ``Fragment.field_*``.

TopN runs in two phases (ref: executeTopN executor.go:369-406): phase 1
ranks each slice's cached rows and keeps its top n, the merged ids are
re-counted exactly over every slice in phase 2, and the result is
trimmed to n. Batched, a phase counts every (candidate, slice) pair at
once: against a Src stack in ONE ``count_and_rows`` launch, without a
Src with ``count_rows`` per candidate stack; the cache masks, the
thresholds and the selection by (-count, id) run on the host. Phase 1
without a Src has no device work (it reads host row counts) and runs
per slice. A candidate set over the stack budget halves its slice
window.

``_force_path`` ("serial"/"batched") pins one path; otherwise a tree the
batched planner does not cover (errors, unsupported leaves) goes serial,
where the reference's error messages are raised.

Memos and the coalescer (ref: pilosa_tpu executor.py, in its order):
``execute`` → result memo → coalescer tick → fused group or single
batched serve.

- **Result memos**: Count, Sum/Average, Min/Max and full TopN answers,
  and TopN's per-(candidate, slice) count matrices, replay from a
  byte-budgeted host memo while the index's mutation epoch stands
  (every write, import, attribute write and schema change under the
  index moves it; a governor eviction does not). Off under
  ``PILOSA_TPU_RESULT_MEMO=0`` and under a pinned ``_force_path``.
- **Plan cache** (``plancache.py``): the slice universe, plan windows
  and prelude memos — the stack-cache keys of a plan's leaf stacks, not
  the stacks, so the stack budget still binds — validated by the epoch.
  The src-less TopN discovery walk is memoized alike.
- **Coalescer**: concurrent Count, Sum and Min/Max queries of one
  structure over one slice list form a group per tick (group commit: a
  leader serves the batch while the others park). A dense Count group
  folds each member's non-root nodes with torch ops and counts every
  member's root in ONE ``count_op_pairs`` launch (or one
  ``count_and_rows`` launch when every member shares a leaf of an
  Intersect); a Sum group reads the field's planes once for all
  members' filters through ``count_and_rows_multi``; a Min/Max group
  runs its K descents with one ``count_op_pairs`` launch and one host
  sync per plane. Declines (budget, structure) serve singly; a kernel
  failure raises in every member of its group. On for a ``cuda``
  holder, off for ``cpu``; ``PILOSA_TPU_COALESCE`` overrides.

The compressed container tier (``ops/containers.py``; ref: pilosa_tpu
executor.py:1530-1536, 2809-3309, 3703-3741). With it on (its default;
``PILOSA_CONTAINER_FORMATS=0`` turns it off) a serial leaf reads the
row's ``Fragment.row_container`` — sorted positions, runs or the dense
row — and Bitmap's algebra dispatches on the format, so a two-operand
Count is one ``container_and_counts`` launch a slice. A bitmap plan, or
a Count of a bare leaf or of a two-operand node, whose every row leaf is
compressed on every slice (fragments not faulted in, rows of at most
4,096 bits) is not staged into dense stacks: the bitmap plan runs
serially from the tier, the Count from the container lanes, alone or in
a coalesced group: a bare leaf from host-known counts, a two-operand
node by one launch per format cell over its rows' blocks on every
slice, packed once per (row, slice list) and cached while the index's
epoch stands (``_lane_row``). A deeper Count tree stays batched alone
and, in a coalesced group, fuses densely within the group's densify
budget (``CO_DENSIFY_BYTES``); ``CO_COMPRESSED = False`` serves
all-compressed groups singly.
"""
import itertools
import os
import threading
import time
from collections import namedtuple
from datetime import datetime

import numpy as np
import torch

from pilosa_tpu_torch import SLICE_WIDTH, WORDS_PER_SLICE
from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch import time_quantum as tq
from pilosa_tpu_torch.bitmap import Bitmap
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import containers as containers_mod
from pilosa_tpu_torch.ops import topn as topn_ops
from pilosa_tpu_torch.plancache import RANGE_MARK, PlanCache, slice_key
from pilosa_tpu_torch.pql import Condition, parse
from pilosa_tpu_torch.storage.fragment import TopOptions, residency_generation
from pilosa_tpu_torch.storage.view import (
    VIEW_FIELD_PREFIX,
    VIEW_INVERSE,
    VIEW_STANDARD,
    view_field_name,
)

DEFAULT_FRAME = "general"        # ref: executor.go:31
MIN_THRESHOLD = 1                # ref: executor.go:33-35
TIME_FORMAT = "%Y-%m-%dT%H:%M"   # ref: TimeFormat "2006-01-02T15:04"
MAX_WRITES_PER_REQUEST = 5000   # ref: server.go MaxWritesPerRequest

SumCount = namedtuple("SumCount", ["sum", "count"])

KNOWN_CALLS = frozenset({
    "SetBit", "ClearBit", "SetFieldValue", "SetRowAttrs", "SetColumnAttrs",
    "Count", "TopN", "Sum", "Average", "Min", "Max",
    "Bitmap", "Union", "Intersect", "Difference", "Xor", "Range",
})
WRITE_CALLS = ("SetBit", "ClearBit", "SetRowAttrs", "SetColumnAttrs",
               "SetFieldValue")
_BATCH_OPS = ("Union", "Intersect", "Difference", "Xor")
_COUNT_OPS = {"Intersect": "and", "Union": "or", "Difference": "andnot",
              "Xor": "xor"}

# A batch function's answer when its stacks would exceed the stack
# budget: the windowed wrapper then halves the slice list.
BATCH_OVER_BUDGET = object()

# The coalescer admits by QoS priority class, lower first (pilosa_tpu
# qos.PRIO_*); every request is interactive until the QoS port fills the
# class (and a deadline) in per request.
PRIO_INTERACTIVE = 1


class ExecOptions:
    """Per-request options (ref: ExecOptions executor.go): a bitmap
    result without its attributes or without its bits."""

    def __init__(self, exclude_attrs=False, exclude_bits=False):
        self.exclude_attrs = exclude_attrs
        self.exclude_bits = exclude_bits


def _condition_target(field, cond):
    """What a BSI condition reads, decided from the field, the op and the
    value alone, never from a slice (ref: executeFieldRangeSlice
    executor.go:682-819): ``("empty",)`` when no value can match,
    ``("not_null",)`` when every value does, else ``(op, base value(s))``
    for the descent. Raises the reference's ValueErrors."""
    if cond.op == "!=" and cond.value is None:
        return ("not_null",)
    if cond.op == "><":
        predicates = cond.int_slice_value()
        if len(predicates) != 2:
            raise ValueError("Range(): BETWEEN condition requires exactly "
                             "two integer values")
        lo, hi, out_of_range = field.base_value_between(*predicates)
        if out_of_range:
            return ("empty",)
        if predicates[0] <= field.min and predicates[1] >= field.max:
            return ("not_null",)
        return ("><", lo, hi)
    value = cond.value
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError("Range(): conditions only support integer values")
    base, out_of_range = field.base_value(cond.op, value)
    if out_of_range and cond.op != "!=":
        return ("empty",)
    if ((cond.op == "<" and value > field.max)
            or (cond.op == "<=" and value >= field.max)
            or (cond.op == ">" and value < field.min)
            or (cond.op == ">=" and value <= field.min)
            or (cond.op == "!=" and out_of_range)):
        return ("not_null",)
    return (cond.op, base)


def _fold_empty(op, kids):
    """A plan node with its statically empty operands folded away, so
    ``"empty"`` stands only at a plan's root: Intersect with one, or
    Difference with one on the left, is empty; Union, Xor and the right
    of a Difference drop them."""
    if ((op == "Intersect" and any(k[0] == "empty" for k in kids))
            or (op == "Difference" and kids[0][0] == "empty")):
        return ("empty",)
    kids = [k for k in kids if k[0] != "empty"]
    return (op, kids) if kids else ("empty",)


def _leaf_pos(leaves, spec):
    """Position of the leaf ``spec`` in a plan's leaf list, appended
    when new."""
    if spec not in leaves:
        leaves.append(spec)
    return leaves.index(spec)


def _plan_sig(plan):
    """A plan's structure — its ops and arity — without leaf positions
    or BSI conditions: the coalescer's grouping key, so Counts over
    different rows (or Ranges over different conditions) of one shape
    share a group. Each member still evaluates its own plan."""
    if plan is None or plan[0] in ("leaf", "empty", "bsi"):
        return None if plan is None else plan[0]
    return (plan[0], tuple(_plan_sig(k) for k in plan[1]))


def pairs_add(a, b):
    """Merge pair lists, summing counts per id (ref: Pairs.Add
    cache.go:302-427); ordered by (-count, id)."""
    counts = {}
    for rid, cnt in (a or []):
        counts[rid] = counts.get(rid, 0) + cnt
    for rid, cnt in (b or []):
        counts[rid] = counts.get(rid, 0) + cnt
    return sorted(counts.items(), key=lambda rc: (-rc[1], rc[0]))


class Executor:
    # Device bytes the leaf-stack cache may hold (a full-width stack is
    # n_slices × 128 KiB; 9,537 slices = 1.25 GB, and a 14-day time
    # window reads 14 of them besides its month and year views).
    STACK_CACHE_BYTES = 32 << 30
    # The narrowest stack window, in 32-bit words: twice the fragment's
    # 64-word minimum (ref: pilosa_tpu executor.py MIN_WIN32).
    MIN_WIN32 = 128
    # Candidate rows a batched TopN counts at once (ref: pilosa_tpu
    # executor.py's r_pad limit); more go serial, one fragment-form
    # count_and_rows launch per slice.
    MAX_TOPN_CANDIDATES = 1024
    # Host bytes of the result memo and of its largest entry (ref:
    # pilosa_tpu executor.py:4137-4138).
    RESULT_MEMO_BYTES = 64 << 20
    RESULT_MEMO_ENTRY_MAX = 4 << 20
    # Src-less TopN discovery memo entries (ref: executor.py
    # TOPN_DISCOVERY_MEMO_MAX).
    TOPN_DISCOVERY_MEMO_MAX = 4

    _CO_PENDING = object()   # a coalescer request not served yet

    def __init__(self, holder):
        self.holder = holder
        self.device = holder.device
        # Operator opt-out of the window economy (one fixed width).
        self._fixed_full_window = os.environ.get(
            "PILOSA_TPU_FULL_WIN", "").lower() in ("1", "true", "yes")
        self._force_path = None  # "serial" | "batched" | None
        self._stack_cache = {}   # key -> (epoch, tokens, stack)
        self._stack_bytes = 0
        self._cache_mu = threading.Lock()
        # The slice universes, plan windows and prelude memos, validated
        # by each index's mutation epoch.
        self.plans = PlanCache(epoch_of=self._epoch)
        holder.on_index_drop = self._drop_index_state
        # Whole results and TopN count matrices (host values), kill
        # switch PILOSA_TPU_RESULT_MEMO=0.
        self._result_memo_off = os.environ.get(
            "PILOSA_TPU_RESULT_MEMO", "").lower() in ("0", "false", "no")
        self._result_memo = {}   # key -> (epoch, value, charged bytes)
        self._result_memo_bytes = 0
        self._topn_disc_memo = {}
        # The coalescer: requests parked for the next tick, the leader
        # flag, and counters for coalesce_snapshot.
        self._co_mu = threading.Lock()
        self._co_cv = threading.Condition(self._co_mu)
        self._co_pending = []
        self._co_leader = False
        self._co_tick_waiting = False
        self._co_stats = {"rounds": 0, "fused_queries": 0, "max_group": 0,
                          "table_entries": 0, "compressed_fused": 0,
                          "lane_launches": 0, "densified_blocks": 0,
                          "declined": {}}
        # Packed rows of the container lanes: key -> (epoch, RowLane),
        # byte-bounded LRU (LANE_CACHE_BYTES).
        self._lane_cache = {}
        self._lane_bytes = 0
        # Deadline expiries while parked: written by parked threads, so
        # guarded by _co_mu (the leader alone writes _co_stats).
        self._co_expired = 0

    def execute(self, index, query, slices=None, opt=None):
        """(ref: Executor.Execute executor.go:62-151) → one result per
        call. ``slices`` pins the slice list of every read; ``opt`` is an
        ``ExecOptions``."""
        if isinstance(query, str):
            query = parse(query)
        opt = opt or ExecOptions()
        idx = self.holder.index(index)
        if idx is None:
            raise perr.ErrIndexNotFound()
        if query.write_call_n() > MAX_WRITES_PER_REQUEST:
            raise perr.ErrTooManyWrites()
        if (len(query.calls) > 1
                and all(c.name == "SetRowAttrs" for c in query.calls)):
            # One attribute-store transaction per frame (ref:
            # hasOnlySetRowAttrs executor.go:117-120).
            return self._execute_bulk_set_row_attrs(index, query.calls)
        results = []
        for c in query.calls:
            call_slices = slices
            if call_slices is None and c.name not in WRITE_CALLS:
                call_slices = self._slices_for_call(index, idx, c)
            results.append(self._execute_call(index, c, call_slices, opt))
        return results

    def _slices_for_call(self, index, idx, call):
        """Inverse-view calls — TopN(inverse=true), a top-level
        Bitmap(columnID=…) — span the inverse view's slices, the rest
        the standard ones (ref: Executor.Execute executor.go:86-98): the
        index's slice universes, memoized on its epoch."""
        frame = idx.frame(call.args.get("frame") or DEFAULT_FRAME)
        row_label = frame.row_label if frame else "rowID"
        std, inv = self.plans.slice_universe(index, idx)
        return inv if call.is_inverse(row_label, idx.column_label) else std

    def _epoch(self, index):
        """The index's mutation epoch, or None when it does not exist."""
        idx = self.holder.index(index)
        return None if idx is None else idx.epoch.value

    def _drop_index_state(self, index):
        """Forget a deleted index's plan, memo and discovery entries."""
        self.plans.drop_index(index)
        with self._cache_mu:
            for memo in (self._result_memo, self._topn_disc_memo):
                for key in [k for k in memo if k[1] == index]:
                    ent = memo.pop(key)
                    if memo is self._result_memo:
                        self._result_memo_bytes -= ent[2]
            for key in [k for k in self._lane_cache if k[0] == index]:
                self._lane_bytes -= self._lane_cache.pop(key)[1].nbytes

    def _execute_call(self, index, call, slices, opt):
        name = call.name
        if name not in KNOWN_CALLS:
            raise ValueError(f"unknown call: {name}")
        if name == "SetBit":
            return self._execute_set_bit(index, call, set_value=True)
        if name == "ClearBit":
            return self._execute_set_bit(index, call, set_value=False)
        if name == "SetFieldValue":
            return self._execute_set_field_value(index, call)
        if name == "SetRowAttrs":
            return self._execute_set_row_attrs(index, call)
        if name == "SetColumnAttrs":
            return self._execute_set_column_attrs(index, call)
        if name == "Count":
            return self._execute_count(index, call, slices)
        if name == "TopN":
            return self._execute_topn(index, call, slices)
        if name in ("Sum", "Average"):
            return self._execute_sum(index, call, slices)
        if name in ("Min", "Max"):
            return self._execute_min_max(index, call, slices,
                                         find_max=name == "Max")
        # every remaining KNOWN_CALLS member returns a bitmap
        return self._execute_bitmap_call(index, call, slices, opt)

    # ------------------------------------------------------ map/reduce

    def _map_reduce(self, slices, map_fn, reduce_fn, batch_fn):
        """Single-node map/reduce (ref: mapReduce executor.go:1444-1535):
        the batched path unless pinned serial, absent or ineligible
        (None)."""
        if self._force_path != "serial" and batch_fn is not None:
            out = batch_fn(slices)
            if out is not None:
                return out
        result = None
        for s in slices:
            result = reduce_fn(result, map_fn(s))
        return result

    @staticmethod
    def _windowed_batch(batch_fn, reduce_fn):
        """Wrap a read-path batch_fn so a slice list whose stacks exceed
        the budget streams through halved windows (ref: executor.py
        _windowed_batch); below 8 slices it goes serial (None)."""
        def fn(ns):
            out = batch_fn(ns)
            if out is not BATCH_OVER_BUDGET:
                return out
            if len(ns) < 8:
                return None
            half = len(ns) // 2
            left = fn(ns[:half])
            if left is None:
                return None
            right = fn(ns[half:])
            if right is None:
                return None
            return reduce_fn(reduce_fn(None, left), right)
        return fn

    # ------------------------------------------------------------ Count

    def _execute_count(self, index, call, slices):
        """(ref: executeCount executor.go:859-889): the result memo, then
        the coalescer's tick, then the batched or serial path."""
        if len(call.children) != 1:
            raise ValueError("Count() only accepts a single bitmap input")
        child = call.children[0]

        def reduce_fn(prev, v):
            return (prev or 0) + v

        def compute():
            return self._map_reduce(
                slices,
                lambda s: self._count_call_slice(index, child, s),
                reduce_fn,
                self._windowed_batch(
                    lambda ns: self._coalesced_count(index, child, ns),
                    reduce_fn),
            ) or 0

        return self._scalar_result_memo(
            "count_res", index, call, slices, compute,
            enc=lambda v: np.asarray([v], dtype=np.int64),
            dec=lambda a: int(a[0]))

    def _count_call_slice(self, index, call, slice_num):
        """Count-only per-slice evaluation: a two-operand boolean node
        reduces through ``Bitmap.op_count`` without materialising;
        anything else materialises and counts."""
        op = _COUNT_OPS.get(call.name)
        if op is not None and len(call.children) == 2:
            a = self._bitmap_call_slice(index, call.children[0], slice_num)
            b = self._bitmap_call_slice(index, call.children[1], slice_num)
            return a.op_count(op, b)
        return self._bitmap_call_slice(index, call, slice_num).count()

    def _bitmap_call_slice(self, index, call, slice_num):
        """(ref: executeBitmapCallSlice executor.go:308-326)."""
        name = call.name
        if name == "Bitmap":
            return self._bitmap_slice(index, call, slice_num)
        if name in _BATCH_OPS:
            if not call.children:
                raise ValueError(
                    f"empty {name} query is currently not supported")
            out = None
            for child in call.children:
                bm = self._bitmap_call_slice(index, child, slice_num)
                if out is None:
                    out = bm
                elif name == "Intersect":
                    out = out.intersect(bm)
                elif name == "Union":
                    out = out.union(bm)
                elif name == "Difference":
                    out = out.difference(bm)
                else:
                    out = out.xor(bm)
            return out
        if name == "Range":
            if call.has_condition_arg():
                return self._execute_field_range_slice(index, call,
                                                       slice_num)
            return self._execute_time_range_slice(index, call, slice_num)
        raise ValueError(f"unknown call: {name}")

    # ------------------------------------------------------ bitmap results

    def _execute_bitmap_call(self, index, call, slices, opt):
        """A top-level bitmap call (ref: executeBitmapCall
        executor.go:241-306): the per-slice bitmaps merged, a compound
        tree batched into one deferred stack; a ``Bitmap`` carries its
        row's (or column's) attributes."""
        def reduce_fn(prev, v):
            return (Bitmap() if prev is None else prev).merge(v)

        batch_fn = None
        if call.children:
            batch_fn = self._windowed_batch(
                lambda ns: self._batched_bitmap(index, call, ns), reduce_fn)
        bm = self._map_reduce(
            slices, lambda s: self._bitmap_call_slice(index, call, s),
            reduce_fn, batch_fn)
        if bm is None:
            bm = Bitmap()
        if call.name == "Bitmap":
            bm.attrs = ({} if opt.exclude_attrs
                        else self._bitmap_attrs(index, call))
        if opt.exclude_bits:
            bm.segments = {}
        return bm

    def _bitmap_attrs(self, index, call):
        """The attributes a top-level Bitmap carries: its column's when
        it names a column, else its row's (ref: executeBitmapCall
        executor.go:241-306)."""
        idx = self.holder.index(index)
        col_id, col_ok = call.uint_arg(idx.column_label)
        if col_ok:
            return idx.column_attr_store.attrs(col_id)
        frame = idx.frame(call.args.get("frame") or DEFAULT_FRAME)
        if frame is not None:
            row_id, row_ok = call.uint_arg(frame.row_label)
            if row_ok:
                return frame.row_attr_store.attrs(row_id)
        return {}

    def _batched_bitmap(self, index, call, slices):
        """A compound tree over the slice list folded into ONE
        ``int32[S, W]`` stack at the plan's window, its per-slice counts from
        ``count_rows``; the result defers the stack unsplit. None when
        ineligible; BATCH_OVER_BUDGET when the leaf stacks and the
        result would not fit the stack budget together."""
        if len(slices) == 0:
            return None
        leaves = []
        plan = self._batched_plan(index, call, leaves)
        if plan is None:
            return None
        if plan[0] == "empty":
            return Bitmap()
        pre = self._plan_stacks(index, leaves, slices, extra=1,
                                decline_compressed=True)
        if pre is None or pre is BATCH_OVER_BUDGET:
            return pre
        win, stacks = pre
        result = self._eval_node(plan, stacks)
        counts = bitops.count_rows(result).cpu().numpy()
        bm = Bitmap()
        bm.defer_stack(result, slices, counts, word_base=win[0])
        bm._count = int(counts.sum(dtype=np.int64))
        return bm

    # ------------------------------------------------------ time ranges

    def _time_range_spec(self, index, call):
        """(frame, view, row or column id, start, end) of a time Range,
        with the reference's argument errors (ref: executeRangeSlice
        executor.go:593-664)."""
        idx = self.holder.index(index)
        frame = idx.frame(call.args.get("frame") or DEFAULT_FRAME)
        if frame is None:
            raise perr.ErrFrameNotFound()
        col_id, col_ok = call.uint_arg(idx.column_label)
        row_id, row_ok = call.uint_arg(frame.row_label)
        if col_ok and row_ok:
            raise ValueError(
                f'Range() cannot contain both "{idx.column_label}" and '
                f'"{frame.row_label}"')
        if not col_ok and not row_ok:
            raise ValueError(
                f'Range() must specify either "{idx.column_label}" or '
                f'"{frame.row_label}"')
        view, id_ = ((VIEW_INVERSE, col_id) if col_ok
                     else (VIEW_STANDARD, row_id))
        start = call.args.get("start")
        if not isinstance(start, str):
            raise ValueError("Range() start time required")
        end = call.args.get("end")
        if not isinstance(end, str):
            raise ValueError("Range() end time required")
        try:
            start_t = datetime.strptime(start, TIME_FORMAT)
        except ValueError:
            raise ValueError("cannot parse Range() start time")
        try:
            end_t = datetime.strptime(end, TIME_FORMAT)
        except ValueError:
            raise ValueError("cannot parse Range() end time")
        return frame, view, id_, start_t, end_t

    def _execute_time_range_slice(self, index, call, slice_num):
        """The union of the row over the views that cover [start, end)
        (ref: executeRangeSlice executor.go:665-680); empty when the
        frame has no time quantum."""
        frame, view, id_, start_t, end_t = self._time_range_spec(index,
                                                                 call)
        bm = Bitmap()
        if not frame.time_quantum:
            return bm
        for v in tq.views_by_time_range(view, start_t, end_t,
                                        frame.time_quantum):
            frag = self.holder.fragment(index, frame.name, v, slice_num)
            if frag is not None:
                bm = bm.union(Bitmap.from_device(slice_num,
                                                 self._serial_row(frag, id_)))
        return bm

    def _range_condition(self, index, call):
        """(frame name, field, ``_condition_target``) of a BSI Range
        call, with the reference's argument errors."""
        frame_name = call.args.get("frame") or DEFAULT_FRAME
        frame = self.holder.index(index).frame(frame_name)
        if frame is None:
            raise perr.ErrFrameNotFound()
        args = {k: v for k, v in call.args.items() if k != "frame"}
        if not args:
            raise ValueError("Range(): condition required")
        if len(args) > 1:
            raise ValueError("Range(): too many arguments")
        field_name, cond = next(iter(args.items()))
        if not isinstance(cond, Condition):
            raise ValueError(
                f'Range(): "{field_name}": expected condition argument, '
                f"got {cond}")
        field = frame.field(field_name)
        return frame_name, field, _condition_target(field, cond)

    def _execute_field_range_slice(self, index, call, slice_num):
        """BSI condition on one slice (ref: executeFieldRangeSlice
        executor.go:682-819)."""
        frame_name, field, target = self._range_condition(index, call)
        depth = field.bit_depth()
        frag = self.holder.fragment(index, frame_name,
                                    view_field_name(field.name), slice_num)
        if frag is None or target[0] == "empty":
            return Bitmap()
        if target[0] == "not_null":
            words = frag.field_not_null(depth)
        elif target[0] == "><":
            words = frag.field_range_between(depth, *target[1:])
        else:
            words = frag.field_range(target[0], depth, target[1])
        return Bitmap.from_device(slice_num, words)

    def _leaf_spec(self, index, call):
        """(frame, view, row id) a Bitmap call reads, with the
        reference's argument errors (ref: executeBitmapSlice
        executor.go:523-568)."""
        idx = self.holder.index(index)
        frame_name = call.args.get("frame") or DEFAULT_FRAME
        frame = idx.frame(frame_name)
        if frame is None:
            raise perr.ErrFrameNotFound()
        row_id, row_ok = call.uint_arg(frame.row_label)
        col_id, col_ok = call.uint_arg(idx.column_label)
        if row_ok and col_ok:
            raise ValueError(
                f"Bitmap() cannot specify both {frame.row_label} and "
                f"{idx.column_label} values")
        if not row_ok and not col_ok:
            raise ValueError(
                f"Bitmap() must specify either {frame.row_label} or "
                f"{idx.column_label} values")
        if col_ok:
            if not frame.inverse_enabled:
                raise ValueError("Bitmap() cannot retrieve columns unless "
                                 "inverse storage enabled")
            return frame_name, VIEW_INVERSE, col_id
        return frame_name, VIEW_STANDARD, row_id

    def _bitmap_slice(self, index, call, slice_num):
        frame_name, view, row_id = self._leaf_spec(index, call)
        frag = self.holder.fragment(index, frame_name, view, slice_num)
        if frag is None:
            return Bitmap()
        return Bitmap.from_device(slice_num, self._serial_row(frag, row_id))

    @staticmethod
    def _serial_row(frag, row_id):
        """One row of a serial leaf: with the container tier on, the
        fragment picks its format (``row_container``) and Bitmap's algebra
        dispatches on it; off, the dense device row (ref: pilosa_tpu
        executor.py:1530-1536)."""
        if containers_mod.enabled():
            return frag.row_container(row_id)
        return frag.device_row(row_id)

    # ------------------------------------------------------- batched path

    def _batched_plan(self, index, call, leaves):
        """AST → nested op tuples over leaf indices, or None when the
        tree holds a shape the batched path does not cover (the serial
        path then raises the proper error)."""
        if call.name == "Bitmap":
            try:
                spec = self._leaf_spec(index, call)
            except (ValueError, perr.PilosaError):
                return None
            return ("leaf", _leaf_pos(leaves, spec))
        if call.name == "Range" and call.has_condition_arg():
            return self._plan_bsi_range(index, call, leaves)
        if call.name == "Range":
            return self._plan_time_range(index, call, leaves)
        if call.name in _BATCH_OPS and call.children:
            kids = []
            for c in call.children:
                node = self._batched_plan(index, c, leaves)
                if node is None:
                    return None
                kids.append(node)
            return _fold_empty(call.name, kids)
        return None

    def _plan_bsi_range(self, index, call, leaves):
        """BSI condition -> a ``"bsi"`` node over the field view's rows
        (``("bsi", plane leaf positions, not-null leaf position, op,
        predicate bits per value)``, the bits host ints), ``("empty",)``,
        or the not-null leaf — the serial path's shortcuts, which depend
        on field, op and value only, decided once at plan time. None
        when the call is malformed: the serial path then raises the
        reference's error."""
        try:
            frame_name, field, target = self._range_condition(index, call)
        except (TypeError, ValueError, perr.PilosaError):
            return None
        depth = field.bit_depth()
        view = view_field_name(field.name)

        def leaf(row):
            return _leaf_pos(leaves, (frame_name, view, row))

        if target[0] == "empty":
            return target
        if target[0] == "not_null":
            return ("leaf", leaf(depth))
        return ("bsi", tuple(leaf(i) for i in range(depth)), leaf(depth),
                target[0], tuple(bsi_ops.value_to_bits(v, depth)
                                 for v in target[1:]))

    def _plan_time_range(self, index, call, leaves):
        """A time Range -> ``("Union", [leaf per cover view])`` (ref:
        pilosa_tpu executor.py:1978-2008); a view absent from the index stacks zero
        rows. None when the serial path answers: a malformed call (it
        raises the reference's error), a frame without a time quantum, a
        column (inverse) Range, an empty cover."""
        try:
            frame, view, id_, start_t, end_t = self._time_range_spec(
                index, call)
        except (ValueError, perr.PilosaError):
            return None
        if not frame.time_quantum or view != VIEW_STANDARD:
            return None
        views = tq.views_by_time_range(view, start_t, end_t,
                                       frame.time_quantum)
        if not views:
            return None
        return ("Union", [("leaf", _leaf_pos(leaves, (frame.name, v, id_)))
                          for v in views])

    def _over_budget(self, n_stacks, slices, width32):
        """True when ``n_stacks`` leaf stacks over the slice list at
        ``width32`` words would not fit the stack budget together."""
        return (n_stacks * len(slices) * width32 * 4
                > self.STACK_CACHE_BYTES)

    def _leaf_frags(self, index, leaves, slices, shared=None):
        """{(frame, view): fragments over the slice list}, one holder
        lookup per (frame, view) of the leaf specs: the lists shared by
        the window negotiation and the stack builds. ``shared`` carries
        the lists across the members of a coalesced group."""
        shared = {} if shared is None else shared
        frag_map = {}
        for frame_name, view, _ in leaves:
            key = (frame_name, view)
            if key not in frag_map:
                if key not in shared:
                    shared[key] = self.holder.fragments(index, frame_name,
                                                        view, slices)
                frag_map[key] = shared[key]
        return frag_map

    def _compressed_plan(self, leaves, frag_map, probe=None):
        """True when every row leaf of a plan serves from a compressed
        container on every slice (``Fragment.row_compressed``), so that
        staging dense stacks would densify the tier back onto the device
        (ref: pilosa_tpu executor.py:3703-3741). A BSI plane leaf (a
        field view's row) never counts as compressed: planes are dense by
        design. Slices are checked in order, every leaf at each, so the
        first fragment that serves dense ends the walk. ``probe``
        memoizes the checks across a coalesced group."""
        if not containers_mod.enabled() or not leaves:
            return False
        if any(view.startswith(VIEW_FIELD_PREFIX) for _, view, _ in leaves):
            return False
        lists = [frag_map.get((fname, view), ()) for fname, view, _ in leaves]
        for frags in itertools.zip_longest(*lists):
            for (_, _, rid), frag in zip(leaves, frags):
                if frag is None:
                    continue
                if probe is None:
                    hit = frag.row_compressed(rid)
                else:
                    pkey = (id(frag), rid)
                    hit = probe.get(pkey)
                    if hit is None:
                        hit = probe[pkey] = frag.row_compressed(rid)
                if not hit:
                    return False
        return True

    def _compressed_verdict(self, index, leaves, slices, shared=None,
                            probe=None):
        """``_compressed_plan`` of a plan over the slice list, memoized
        in the plan cache while the index's epoch and the fragments'
        residency (``fragment.residency_generation``) stand, so that a
        warm plan walks no fragment. ``shared`` and ``probe`` share a
        cold walk across a group."""
        if not containers_mod.enabled():
            return False
        token = (self._epoch(index), residency_generation())
        key = ("compressed", index, slice_key(slices), tuple(leaves))
        verdict = self.plans.get(key, token, record=False)
        if verdict is None:
            frag_map = self._leaf_frags(index, leaves, slices, shared=shared)
            verdict = self._compressed_plan(leaves, frag_map, probe=probe)
            self.plans.put(key, token, verdict)
        return verdict

    def _union_window(self, frag_map):
        """(base, width) in 32-bit words of the window covering every
        fragment of ``frag_map`` (ref: pilosa_tpu executor.py:3770-3830):
        the union of their windows, its width bucketed to a power of
        four from MIN_WIN32 (128, 512, 2048, 8192, 32768) with the base
        aligned to it — host windows are powers of two, so a stack's
        device bytes stay within 2× its fragments' host windows. The
        full slice when the data spans it, or under PILOSA_TPU_FULL_WIN."""
        if self._fixed_full_window:
            return 0, WORDS_PER_SLICE
        lo = hi = None
        for frags in frag_map.values():
            for f in frags:
                win = f.win32() if f is not None else None
                if win is None:
                    continue
                b, w = win
                lo = b if lo is None else min(lo, b)
                hi = b + w if hi is None else max(hi, b + w)
        if lo is None:
            return 0, self.MIN_WIN32
        w = self.MIN_WIN32
        while True:
            b = lo // w * w
            if hi <= b + w or w >= WORDS_PER_SLICE:
                break
            w *= 4
        if w >= WORDS_PER_SLICE:
            return 0, WORDS_PER_SLICE
        return b, w

    def _plan_window(self, index, leaves, slices, shared=None):
        """(window, fragment map or None) of the fragments a plan's
        leaves read, the window memoized in the plan cache on the
        index's epoch: a warm plan walks no fragment. ``shared`` holds
        fragment lists a caller walked already."""
        epoch = self._epoch(index)
        wkey = ("win", index, frozenset(spec[:2] for spec in leaves),
                slice_key(slices))
        win = self.plans.get(wkey, epoch)
        if win is not None:
            return win, None
        frag_map = self._leaf_frags(index, leaves, slices, shared=shared)
        win = self._union_window(frag_map)
        self.plans.put(wkey, epoch, win)
        return win, frag_map

    def _plan_stacks(self, index, leaves, slices, extra=0, kind="plan",
                     win=None, decline_compressed=False):
        """(window, leaf stacks) of a batched plan at the window of every
        fragment its leaves read (or at ``win``), or BATCH_OVER_BUDGET
        when the leaf stacks and ``extra`` stacks of the same shape would
        not fit the stack budget together. Prelude-memoized (ref:
        pilosa_tpu executor.py:3842-3960): a warm plan resolves its
        stacks from the stack cache by key, without a fragment walk or a
        token check; ``kind`` names the entry ("plan", "bsi", "topnp").
        With ``decline_compressed``, a memo miss whose every row leaf is
        compressed on every slice returns None: the container tier serves
        it (ref: executor.py:3941-3944)."""
        epoch = self._epoch(index)  # before building: a racing write
        # makes the memo stale on arrival, never wrong
        pkey = (kind, index, slice_key(slices), tuple(leaves), win)
        memo = self._prelude_memo_get(pkey)
        if memo is not None:
            (mwin,), stacks, _ = memo
            if self._over_budget(len(leaves) + extra, slices, mwin[1]):
                return BATCH_OVER_BUDGET
            return mwin, stacks
        shared = {}  # one fragment walk for the verdict and the window
        if decline_compressed and self._compressed_verdict(
                index, leaves, slices, shared):
            return None
        frag_map = None
        if win is None:
            win, frag_map = self._plan_window(index, leaves, slices, shared)
        if self._over_budget(len(leaves) + extra, slices, win[1]):
            return BATCH_OVER_BUDGET
        stacks = self._leaf_stacks(index, leaves, slices, win, frag_map)
        self._prelude_memo_put(
            pkey, (win,), self._prelude_specs(index, leaves, slices, win),
            None, epoch)
        return win, stacks

    def _prelude_memo_get(self, pkey):
        """A prelude memo hit -> (head, stacks, tail), its stacks
        resolved FROM the stack cache (the memo holds keys, not tensors,
        so the stack budget still binds), each refreshed in the cache's
        eviction order; None on a miss, a stale epoch, or a stack that
        was evicted or rebuilt at another epoch since (the full path then
        puts the memo anew)."""
        token = self._epoch(pkey[1])
        hit = self.plans.get(pkey, token, record=False)
        if hit is None:
            self.plans.record(pkey[1], False)
            return None
        head, specs, tail = hit
        stacks = []
        with self._cache_mu:
            for key in specs:
                ent = self._stack_cache.get(key)
                if ent is None or ent[0] != token:
                    stacks = None
                    break
                self._stack_cache[key] = self._stack_cache.pop(key)
                stacks.append(ent[2])
        self.plans.record(pkey[1], stacks is not None)
        return None if stacks is None else (head, stacks, tail)

    def _prelude_memo_put(self, pkey, head, specs, tail, epoch):
        self.plans.put(pkey, epoch, (head, specs, tail))

    @staticmethod
    def _prelude_specs(index, leaves, slices, win):
        """The stack-cache key of each leaf's stack: the one layout
        ``_leaf_stacks`` stores under."""
        skey = slice_key(slices)
        return [(index, *spec, skey, win[0], win[1]) for spec in leaves]

    @staticmethod
    def _merge_windows(wins):
        """The power-of-four bucket covering every window of ``wins``
        (each already a bucket with its base aligned to its width): a
        coalesced group's one window."""
        lo = min(b for b, _ in wins)
        hi = max(b + w for b, w in wins)
        w = min(w for _, w in wins)
        while True:
            b = lo // w * w
            if hi <= b + w or w >= WORDS_PER_SLICE:
                break
            w *= 4
        return (0, WORDS_PER_SLICE) if w >= WORDS_PER_SLICE else (b, w)

    def _batched_count(self, index, child, slices):
        """Count over the slice list with one device stack per leaf: the
        tree folds with PyTorch bitwise ops and its root op runs fused
        in the count kernel, which yields int32 per-slice counts.
        BATCH_OVER_BUDGET when the leaf stacks would not fit the stack
        budget together."""
        if len(slices) == 0:
            return None
        leaves = []
        plan = self._batched_plan(index, child, leaves)
        if plan is None:
            return None
        if plan[0] == "empty":
            return 0
        # Only a lane shape declines for the container tier: a deeper
        # all-compressed tree stays batched, since serially from the tier
        # it costs a launch a slice a node (a 14-view Count over 1,024
        # slices: 3.2-5.0 s against 2.3-2.8 ms batched on an H100).
        lane = self._lane_plan_shape(plan) is not None
        pre = self._plan_stacks(index, leaves, slices,
                                decline_compressed=lane)
        if pre is None and lane:
            # Every row leaf is compressed on every slice: the lanes.
            return self._lane_counts(index, slices, [(plan, leaves)])[0][0]
        if pre is None or pre is BATCH_OVER_BUDGET:
            return pre
        return int(self._count_node(plan, pre[1]).sum(dtype=torch.int64))

    @staticmethod
    def _eval_node(node, stacks):
        """Left-fold tree evaluation on stacks — the serial fold's
        pairwise order."""
        if node[0] == "leaf":
            return stacks[node[1]]
        if node[0] == "bsi":
            _, plane_pos, exists_pos, op, bits = node
            return bsi_ops.COMPARE[op]([stacks[p] for p in plane_pos],
                                       stacks[exists_pos], *bits)
        out = None
        for kid in node[1]:
            v = Executor._eval_node(kid, stacks)
            if out is None:
                out = v
            elif node[0] == "Intersect":
                out = bitops.bitmap_and(out, v)
            elif node[0] == "Union":
                out = bitops.bitmap_or(out, v)
            elif node[0] == "Difference":
                out = bitops.bitmap_andnot(out, v)
            else:
                out = bitops.bitmap_xor(out, v)
        return out

    @staticmethod
    def _count_node(node, stacks):
        """int32 per-slice counts of ``node``: its first n-1 operands
        fold, the last one meets them inside ``count_op_rows``."""
        if node[0] in ("leaf", "bsi") or len(node[1]) == 1:
            return bitops.count_rows(Executor._eval_node(node, stacks))
        acc = Executor._eval_node((node[0], node[1][:-1]), stacks)
        last = Executor._eval_node(node[1][-1], stacks)
        return bitops.count_op_rows(acc, last, _COUNT_OPS[node[0]])

    def _leaf_stack(self, index, spec, slices, win=(0, WORDS_PER_SLICE)):
        """``int32[len(slices), width32]`` device stack of one row across
        the slice list in the window ``win`` = (base32, width32), the
        full slice by default (see ``_leaf_stacks``)."""
        return self._leaf_stacks(index, [spec], slices, win)[0]

    def _leaf_stacks(self, index, specs, slices, win, frag_map=None):
        """Device stacks ``int32[len(slices), width32]`` of the rows
        ``specs`` = [(frame, view, row)] across the slice list in the
        window ``win`` = (base32, width32); absent fragments stack zero
        rows. Each is cached until a fragment of the index changes: the
        index's mutation epoch is the O(1) check, per-fragment (uid,
        version) tokens the exact one (an eviction by the host-memory
        governor keeps the version, so it keeps the stack). A stack
        whose tokens moved at some slices is patched there, out of
        place (a write or a fault-in touches few fragments; re-reading
        every cold fragment would cost a file read each), and the stack
        of ``range(n)`` grows from that of ``range(n - 1)`` when a new
        slice appears; any other is assembled on the host and uploaded
        once. Every fragment is visited once for all of its rows, last
        slice first, so the readers the window walk just opened are
        reused before the reader cap closes them."""
        base32, width32 = win
        skey = slice_key(slices)
        epoch = self._epoch(index)
        frag_map = dict(frag_map or {})
        out, build = {}, {}
        for spec in dict.fromkeys(specs):
            key = (index, *spec, skey, base32, width32)
            with self._cache_mu:
                hit = self._stack_cache.get(key)
            if hit is not None and hit[0] == epoch:
                out[spec] = hit[2]
                continue
            view = spec[:2]
            if frag_map.get(view) is None:
                frag_map[view] = self.holder.fragments(index, *view, slices)
            tokens = tuple((f._uid, f._version) if f is not None else None
                           for f in frag_map[view])
            if hit is None and skey == (RANGE_MARK, 0, len(tokens) - 1) \
                    and len(tokens) > 1:
                # The universe grew by a slice: start from the stack of
                # the universe before it.
                with self._cache_mu:
                    hit = self._stack_cache.get(
                        (index, *spec, (RANGE_MARK, 0, len(tokens) - 2),
                         base32, width32))
            base = [] if hit is None else hit[1]
            changed = [i for i, t in enumerate(tokens)
                       if i >= len(base) or base[i] != t]
            if not changed:
                with self._cache_mu:
                    self._stack_cache[key] = (epoch, tokens, hit[2])
                out[spec] = hit[2]
                continue
            build.setdefault(view, []).append(
                (spec, key, tokens, hit, changed))
        # Views in the reverse of the window walk's order too: its
        # last-opened readers are reused first.
        for view, todo in reversed(list(build.items())):
            frags = frag_map[view]
            hosts = [np.zeros((len(changed), width32 // 2), np.uint64)
                     for _, _, _, _, changed in todo]
            at = {}  # slice position -> [(row, host row)]
            for (spec, _, _, _, changed), host in zip(todo, hosts):
                for j, i in enumerate(changed):
                    at.setdefault(i, []).append((spec[2], host[j]))
            for i in sorted(at, reverse=True):
                if frags[i] is not None:
                    frags[i].host_rows_win(at[i], base32, width32)
            for (spec, key, tokens, hit, changed), host in zip(todo, hosts):
                rows = torch.from_numpy(host.view(np.int32)).to(self.device)
                if hit is None:
                    stack = rows
                else:
                    stack = hit[2]
                    if len(tokens) > stack.shape[0]:  # a new last slice
                        stack = torch.cat([stack, rows[-1:]])
                    stack = stack.index_copy(
                        0, torch.tensor(changed, device=self.device), rows)
                self._cache_put(key, (epoch, tokens, stack))
                out[spec] = stack
        return [out[spec] for spec in specs]

    def _cache_put(self, key, entry):
        nbytes = entry[2].numel() * entry[2].element_size()
        with self._cache_mu:
            old = self._stack_cache.pop(key, None)
            if old is not None:
                self._stack_bytes -= old[2].numel() * old[2].element_size()
            while self._stack_cache and (self._stack_bytes + nbytes
                                         > self.STACK_CACHE_BYTES):
                ev = self._stack_cache.pop(next(iter(self._stack_cache)))
                self._stack_bytes -= ev[2].numel() * ev[2].element_size()
            self._stack_cache[key] = entry
            self._stack_bytes += nbytes

    # ----------------------------------------------------- result memos

    def _scalar_result_memo(self, kind, index, call, slices, compute,
                            enc, dec):
        """Whole-result memo of Count, Sum/Average, Min/Max and full TopN
        (ref: pilosa_tpu executor.py:1655-1708, its single-node branch):
        a repeated query replays a host value while its index's epoch
        stands. ``enc`` turns a result into a host array, ``dec`` back.
        The epoch is read before computing, so a write landing mid-query
        makes the entry stale on arrival, never wrong. Bypassed (read and
        write) under PILOSA_TPU_RESULT_MEMO=0 and a pinned _force_path,
        so that measurements time execution, not dict lookups."""
        if self._result_memo_off or self._force_path is not None:
            return compute()
        pkey = (kind, index, str(call), slice_key(slices))
        hit = self._result_memo_get(pkey)
        if hit is not None:
            return dec(hit)
        epoch = self._epoch(index)
        out = compute()
        if epoch is not None:
            self._topn_counts_memoize(pkey, enc(out), epoch)
        return out

    def _result_memo_get(self, key):
        """The memoized array of ``key`` (key[1] is its index) while the
        index's epoch equals the stored one, else None; a stale entry is
        dropped when found (epochs never return). The one kill switch of
        the whole-result and TopN count memos."""
        if self._result_memo_off or self._force_path is not None:
            return None
        with self._cache_mu:
            hit = self._result_memo.get(key)
        if hit is None:
            return None
        if hit[0] != self._epoch(key[1]):
            with self._cache_mu:
                if self._result_memo.get(key) is hit:
                    self._result_memo.pop(key)
                    self._result_memo_bytes -= hit[2]
            return None
        with self._cache_mu:
            if key in self._result_memo:
                self._result_memo[key] = self._result_memo.pop(key)
        return hit[1]

    @staticmethod
    def _memo_key_cost(key):
        """Rough host bytes a memo key pins beside its value (a slice
        tuple of a ragged list can outweigh a scalar result)."""
        cost = 64
        for part in key:
            if isinstance(part, tuple):
                cost += 16 + 32 * len(part)
            elif isinstance(part, str):
                cost += 49 + len(part)
            else:
                cost += 28
        return cost

    def _topn_counts_memoize(self, key, counts, epoch):
        """Keep a host result array under ``key`` at ``epoch`` (ref:
        pilosa_tpu executor.py:4213), least recently used first out of
        RESULT_MEMO_BYTES; an entry over RESULT_MEMO_ENTRY_MAX is not
        kept. Callers treat the kept array as immutable. Returns it."""
        if self._result_memo_off or self._force_path is not None:
            return counts
        cost = counts.nbytes + self._memo_key_cost(key)
        if cost > self.RESULT_MEMO_ENTRY_MAX:
            return counts
        with self._cache_mu:
            old = self._result_memo.pop(key, None)
            if old is not None:
                self._result_memo_bytes -= old[2]
            while (self._result_memo
                   and self._result_memo_bytes + cost
                   > self.RESULT_MEMO_BYTES):
                k = next(iter(self._result_memo))
                self._result_memo_bytes -= self._result_memo.pop(k)[2]
            self._result_memo[key] = (epoch, counts, cost)
            self._result_memo_bytes += cost
        return counts

    # ------------------------------------------------- Sum / Min / Max

    def _bsi_field(self, index, call):
        """(frame name, field) of a BSI aggregate, or None when the frame
        or the field does not exist."""
        frame_name = call.args.get("frame") or ""
        frame = self.holder.index(index).frame(frame_name)
        if frame is None:
            return None
        try:
            return frame_name, frame.field(call.args.get("field") or "")
        except perr.ErrFieldNotFound:
            return None

    def _filter_words(self, index, call, slice_num):
        """The slice's words of a BSI aggregate's filter tree, or None
        without one."""
        if len(call.children) != 1:
            return None
        bm = self._bitmap_call_slice(index, call.children[0], slice_num)
        return bm.device_words(slice_num, self.device)

    def _execute_sum(self, index, call, slices):
        """Sum and Average (ref: executeSum executor.go:328-366): the
        SumCount of the field's values, ∩ the filter tree when given."""
        if call.args.get("field") is None:
            raise ValueError("Sum(): field required")

        def reduce_fn(prev, v):
            if prev is None:
                return v
            return SumCount(prev.sum + v.sum, prev.count + v.count)

        def compute():
            return self._map_reduce(
                slices,
                lambda s: self._execute_sum_count_slice(index, call, s),
                reduce_fn,
                self._windowed_batch(
                    lambda ns: self._coalesced_sum(index, call, ns),
                    reduce_fn),
            ) or SumCount(0, 0)

        return self._scalar_result_memo(
            "sum_res", index, call, slices, compute,
            enc=lambda v: np.asarray([v.sum, v.count], dtype=np.int64),
            dec=lambda a: SumCount(int(a[0]), int(a[1])))

    def _execute_sum_count_slice(self, index, call, slice_num):
        filt = self._filter_words(index, call, slice_num)
        resolved = self._bsi_field(index, call)
        if resolved is None:
            return SumCount(0, 0)
        frame_name, field = resolved
        frag = self.holder.fragment(index, frame_name,
                                    view_field_name(field.name), slice_num)
        if frag is None:
            return SumCount(0, 0)
        vsum, vcount = frag.field_sum(filt, field.bit_depth())
        return SumCount(vsum + vcount * field.min, vcount)

    def _execute_min_max(self, index, call, slices, find_max):
        """Min/Max over a BSI field (ref: executeMinMax): per-slice
        extrema reduced on the host, empty partials skipped, or one
        global descent on the batched path."""
        frame_name = call.args.get("frame") or ""
        frame = self.holder.index(index).frame(frame_name)
        if frame is None:
            return SumCount(0, 0)
        field = frame.field(call.args.get("field") or "")
        depth = field.bit_depth()

        def map_fn(s):
            filt = self._filter_words(index, call, s)
            frag = self.holder.fragment(index, frame_name,
                                        view_field_name(field.name), s)
            if frag is None:
                return None
            value, count = frag.field_min_max(filt, depth, find_max)
            if count == 0:
                return None
            return SumCount(value + field.min, count)

        def reduce_fn(prev, v):
            # A partial without values must not compete as an extremum
            # of 0 (ref: executeMinMax reduce skips Count == 0).
            if v is None or v.count == 0:
                return prev
            if prev is None:
                return v
            if v.sum == prev.sum:
                return SumCount(prev.sum, prev.count + v.count)
            better = v.sum > prev.sum if find_max else v.sum < prev.sum
            return v if better else prev

        def compute():
            return self._map_reduce(
                slices, map_fn, reduce_fn,
                self._windowed_batch(
                    lambda ns: self._coalesced_min_max(index, call, ns,
                                                       find_max),
                    reduce_fn),
            ) or SumCount(0, 0)

        return self._scalar_result_memo(
            "max_res" if find_max else "min_res", index, call, slices,
            compute,
            enc=lambda v: np.asarray([v.sum, v.count], dtype=np.int64),
            dec=lambda a: SumCount(int(a[0]), int(a[1])))

    def _bsi_batch_prelude(self, index, call, slices):
        """(field, the depth+1 BSI stacks, filter stack) of a batched
        BSI aggregate: plane i and the not-null row ``depth`` are leaf
        stacks of the field view, the filter is the not-null stack ∩
        the filter tree. None when ineligible (missing frame or field,
        an unbatchable filter tree); BATCH_OVER_BUDGET when the stacks
        would not fit the stack budget together; SumCount(0, 0), the
        answer, when the filter tree is statically empty."""
        if len(slices) == 0:
            return None
        resolved = self._bsi_field(index, call)
        if resolved is None:
            return None
        frame_name, field = resolved
        leaves = []
        plan = None
        if len(call.children) == 1:
            plan = self._batched_plan(index, call.children[0], leaves)
            if plan is None:
                return None
        elif call.children:
            return None
        if plan is not None and plan[0] == "empty":
            return SumCount(0, 0)
        depth = field.bit_depth()
        view = view_field_name(field.name)
        planes = [(frame_name, view, i) for i in range(depth + 1)]
        pre = self._plan_stacks(index, planes + leaves, slices, kind="bsi")
        if pre is BATCH_OVER_BUDGET:
            return pre
        stacks = pre[1]
        bsi_stacks, filt = stacks[:depth + 1], stacks[depth]
        if plan is not None:
            filt = filt & self._eval_node(plan, stacks[depth + 1:])
        return field, bsi_stacks, filt

    def _batched_sum(self, index, call, slices):
        """Sum over the slice list in ONE ``count_and_rows`` launch: the
        depth planes and the not-null row against the filter, the filter
        read once per chunk of rows. The not-null row's count is the
        filter's (the filter lies inside it); Σ 2^i·c_i and the min
        offset are Python ints, so no sum can wrap."""
        pre = self._bsi_batch_prelude(index, call, slices)
        if (pre is None or pre is BATCH_OVER_BUDGET
                or isinstance(pre, SumCount)):
            return pre
        field, bsi_stacks, filt = pre
        counts = bitops.count_and_rows_stacks(bsi_stacks, filt).sum(
            dim=1, dtype=torch.int64).tolist()
        count = counts[-1]
        total = sum((1 << i) * c for i, c in enumerate(counts[:-1]))
        return SumCount(total + count * field.min, count)

    def _batched_min_max(self, index, call, slices, find_max):
        """Min/Max over the slice list as ONE global bit-descent (ref:
        pilosa_tpu executor.py _batched_min_max / _minmax_descent): each
        plane's choice tests occupancy across every slice (one count
        launch, one host sync per plane). A slice whose own extremum
        loses holds no column at the global one, so this equals the
        serial reduce. SumCount(0, 0) when no value matches."""
        pre = self._bsi_batch_prelude(index, call, slices)
        if (pre is None or pre is BATCH_OVER_BUDGET
                or isinstance(pre, SumCount)):
            return pre
        field, bsi_stacks, filt = pre
        ind, remaining = bsi_ops.bsi_extrema_indicators(
            bsi_stacks[:-1], filt, find_max)
        count = int(bitops.count(remaining))
        if count == 0:
            return SumCount(0, 0)
        value = sum((1 << i) * b for i, b in enumerate(ind.tolist()))
        return SumCount(value + field.min, count)

    # --------------------------------------------- cross-query coalescer

    def _co_enabled(self):
        """Coalescing pays where device launches and host syncs dominate
        and the device is a resource of its own: on for a ``cuda``
        holder, off for ``cpu``, where a fused group would compete with
        the serving threads for the same cores. PILOSA_TPU_COALESCE=1/0
        overrides either way (ref: pilosa_tpu executor.py:2182)."""
        cached = getattr(self, "_co_enabled_memo", None)
        if cached is None:
            env = os.environ.get("PILOSA_TPU_COALESCE")
            if env is not None:
                cached = env.lower() not in ("0", "false", "no")
            else:
                cached = self.device.type == "cuda"
            self._co_enabled_memo = cached
        return cached

    # Whether all-compressed members of a Count group fuse from the
    # container tier (else the group serves singly), and the bytes of
    # compressed rows one group may stage densely for deep all-compressed
    # trees (each staged block counts a conversion): 64 MiB, ~512
    # full-width rows (ref: executor.py:2559-2564).
    CO_COMPRESSED = True
    CO_DENSIFY_BYTES = 64 << 20

    def _co_config(self):
        """(max_wait_s, max_group) of the tick: PILOSA_COALESCE_MAX_WAIT_US
        (default 0: a lone query never waits) and
        PILOSA_COALESCE_MAX_GROUP (default 64), or set_coalesce_config's
        values; a malformed number keeps the default (ref:
        executor.py:2566-2598)."""
        cached = getattr(self, "_co_config_memo", None)
        if cached is None:
            def num(name, default):
                try:
                    return int(os.environ.get(name) or default)
                except ValueError:
                    return default

            cached = (max(0, num("PILOSA_COALESCE_MAX_WAIT_US", 0)) / 1e6,
                      max(1, num("PILOSA_COALESCE_MAX_GROUP", 64)))
            self._co_config_memo = cached
        return cached

    def set_coalesce_config(self, max_wait_us=None, max_group=None):
        """Set the tick's knobs; None keeps a knob's current value."""
        wait_s, group = self._co_config()
        if max_wait_us is not None:
            wait_s = max(0, int(max_wait_us)) / 1e6
        if max_group is not None:
            group = max(1, int(max_group))
        self._co_config_memo = (wait_s, group)

    def coalesce_snapshot(self):
        """The coalescer's knobs and counters (ref: executor.py:
        1224-1256): ticks, queries served by a fused group and by
        compressed lanes among them, lane launches, blocks densified by
        deep compressed groups, the largest group, kernel table entries
        launched (members with equal plans share one), declines by
        reason, deadline expiries."""
        wait_s, group = self._co_config()
        st = self._co_stats
        return {
            "enabled": self._co_enabled(),
            "maxWaitUs": int(wait_s * 1e6),
            "maxGroup": group,
            "compressed": self.CO_COMPRESSED,
            "densifyBudgetBytes": self.CO_DENSIFY_BYTES,
            "rounds": st["rounds"],
            "fused_queries": st["fused_queries"],
            "compressedFusedQueries": st["compressed_fused"],
            "laneLaunches": st["lane_launches"],
            "densifiedBlocks": st["densified_blocks"],
            "max_group": st["max_group"],
            "tableEntries": st["table_entries"],
            "expiredWaits": self._co_expired,
            "declined": dict(st["declined"]),
        }

    def _co_note_decline(self, reason):
        """One group declined fusion for ``reason``; it serves singly."""
        d = self._co_stats["declined"]
        d[reason] = d.get(reason, 0) + 1

    def _co_note_fused(self, k):
        self._co_stats["fused_queries"] += k
        self._co_stats["max_group"] = max(self._co_stats["max_group"], k)

    def _co_submit(self, req):
        """Queue one request through the tick: lead (admit and serve a
        priority-ordered batch) or park until a leader served it (ref:
        executor.py:2665). Requests carry their own ``single`` serve and
        group ``fuse`` function and group by ``key``. A parked wait ends
        at the request's deadline: an unclaimed expired request leaves
        the queue and raises DeadlineExceeded without touching the rest
        of its group; a claimed one is its leader's to deliver."""
        req.setdefault("prio", PRIO_INTERACTIVE)
        req.setdefault("deadline", None)
        expired = False
        with self._co_mu:
            self._co_pending.append(req)
            if self._co_tick_waiting:
                self._co_cv.notify_all()
            while req["out"] is self._CO_PENDING and self._co_leader:
                dl = req["deadline"]
                remaining = None if dl is None else dl - time.monotonic()
                if remaining is None or remaining > 0:
                    self._co_cv.wait(remaining)
                    continue
                for i, r in enumerate(self._co_pending):
                    if r is req:
                        del self._co_pending[i]
                        expired = True
                        break
                if expired:
                    self._co_expired += 1
                    break
                self._co_cv.wait()
            if not expired:
                if req["out"] is not self._CO_PENDING:
                    out = req["out"]
                    if isinstance(out, BaseException):
                        raise out
                    return out
                self._co_leader = True
                batch = self._co_admit_locked(req)
        if expired:
            raise perr.DeadlineExceeded()
        try:
            self._co_run(batch)
        finally:
            with self._co_mu:
                self._co_leader = False
                self._co_cv.notify_all()
        out = req["out"]
        if isinstance(out, BaseException):
            raise out
        return out

    def _co_admit_locked(self, req):
        """Tick admission (the caller holds _co_mu and leads): hold the
        window open up to max_wait (cut to the smallest deadline among
        the waiters) or until max_group requests wait, then admit up to
        max_group in priority order, FIFO within a class; the leader's
        own request always admits, leftovers lead the next tick (ref:
        executor.py:2736)."""
        max_wait, max_group = self._co_config()
        if max_wait > 0 and len(self._co_pending) < max_group:
            limit = time.monotonic() + max_wait
            self._co_tick_waiting = True
            try:
                while len(self._co_pending) < max_group:
                    bound = limit
                    for r in self._co_pending:
                        if r["deadline"] is not None:
                            bound = min(bound, r["deadline"])
                    remaining = bound - time.monotonic()
                    if remaining <= 0:
                        break
                    self._co_cv.wait(remaining)
            finally:
                self._co_tick_waiting = False
        pending = self._co_pending
        order = sorted((i for i, r in enumerate(pending) if r is not req),
                       key=lambda i: (pending[i]["prio"], i))
        take = order[:max_group - 1]
        batch = [req] + [pending[i] for i in take]
        batch.sort(key=lambda r: r["prio"])  # stable: FIFO per class
        taken = set(take)
        self._co_pending = [r for i, r in enumerate(pending)
                            if i not in taken and r is not req]
        return batch

    def _co_run(self, batch):
        """Serve one tick's batch (ref: executor.py:2779): a member whose
        deadline passed gets DeadlineExceeded before its group runs; each
        group of one key fuses, and a group of one, or one its fuse
        declined, serves singly. An exception — a kernel that failed to
        build or launch among them — lands in every member still
        unserved; it never turns into a single serve."""
        now = time.monotonic()
        groups = {}
        expired = 0
        for req in batch:
            if req.get("deadline") is not None and now > req["deadline"]:
                req["out"] = perr.DeadlineExceeded()
                expired += 1
                continue
            groups.setdefault(req["key"], []).append(req)
        if expired:
            with self._co_mu:
                self._co_expired += expired
        self._co_stats["rounds"] += 1
        for reqs in groups.values():
            try:
                if len(reqs) == 1 or not reqs[0]["fuse"](reqs):
                    for req in reqs:
                        if req["out"] is self._CO_PENDING:
                            req["out"] = req["single"]()
            except BaseException as exc:  # noqa: BLE001 — delivered
                for req in reqs:
                    if req["out"] is self._CO_PENDING:
                        req["out"] = exc

    def _co_dedupe(self, reqs):
        """Members grouped by (plan, leaf specs): equal members share one
        kernel table entry and one answer."""
        entries = {}
        for req in reqs:
            entries.setdefault((str(req["plan"]), tuple(req["leaves"])),
                               []).append(req)
        return list(entries.values())

    def _co_window(self, index, leaf_lists, slices):
        """The group's one window: every member's memoized plan window
        merged into one bucket, so one launch covers the group."""
        return self._merge_windows([
            self._plan_window(index, leaves, slices)[0]
            for leaves in leaf_lists])

    # ------------------------------------------------ coalesced Count

    def _coalesced_count(self, index, child, slices):
        """Count through the tick (ref: executor.py:2523): a request
        becomes the leader and serves every pending one, or parks until
        a leader serves it; while a group runs, new arrivals accumulate
        for the next tick, so groups grow with load and a lone query
        waits for nothing. Same contract as _batched_count."""
        if not self._co_enabled():
            return self._batched_count(index, child, slices)
        leaves = []
        plan = self._batched_plan(index, child, leaves)
        if plan is None:
            return None
        return self._co_submit({
            "key": ("count", index, slice_key(slices), _plan_sig(plan)),
            "index": index, "slices": slices, "plan": plan,
            "leaves": leaves, "out": self._CO_PENDING,
            "single": lambda: self._batched_count(index, child, slices),
            "fuse": self._co_run_fused,
        })

    def _co_run_fused(self, reqs):
        """K same-structure Counts in as few launches as their formats
        allow (ref: executor.py:2809-2902). A member whose every row leaf
        is compressed on every slice is served from the container tier:
        a bare leaf or a two-operand node through the lanes
        (``_co_fuse_lanes``), a deeper tree densely within the group's
        densify budget; the rest fuse densely (``_co_fuse_dense``).
        False when a member was left unserved (it then serves singly)."""
        index, slices = reqs[0]["index"], reqs[0]["slices"]
        if (not slices or not reqs[0]["leaves"]
                or reqs[0]["plan"][0] == "empty"):
            self._co_note_decline("structural")
            return False
        shared, probe = {}, {}
        comp = [self._compressed_verdict(index, req["leaves"], slices,
                                         shared, probe) for req in reqs]
        dense = [req for req, c in zip(reqs, comp) if not c]
        ok = True
        densify_blocks = 0
        if len(dense) < len(reqs):
            if not self.CO_COMPRESSED:
                # The group serves singly, from the container tier.
                self._co_note_decline("compressed_off")
                return False
            lanes, deep = [], []
            for req, c in zip(reqs, comp):
                if c:
                    (lanes if self._lane_plan_shape(req["plan"]) is not None
                     else deep).append(req)
            if deep:
                # No count identity serves a deep tree: stage it densely
                # when its blocks fit the budget, else serve it singly
                # (alone it stays batched, one member at a time).
                merged = {}
                for req in deep:
                    merged.update(self._leaf_frags(index, req["leaves"],
                                                   slices, shared=shared))
                win = self._union_window(merged)
                blocks = sum(len(req["leaves"]) for req in deep) * len(
                    slices)
                if blocks * win[1] * 4 <= self.CO_DENSIFY_BYTES:
                    densify_blocks = blocks
                    dense.extend(deep)
                else:
                    self._co_note_decline("densify_budget")
                    ok = False
            if lanes:
                self._co_fuse_lanes(lanes)
        if dense:
            served = self._co_fuse_dense(dense)
            if served and densify_blocks:
                # Counted once the blocks were staged: a declined group
                # serves singly through the serial cells, which densify
                # nothing.
                self._co_stats["densified_blocks"] += densify_blocks
                containers_mod.note_conversion(densify_blocks)
            ok = served and ok
        return ok

    def _co_fuse_dense(self, reqs):
        """K dense-served Counts in one launch (ref: the dense branch of
        executor.py:2818-2980). Each distinct member folds its non-root
        nodes with torch ops at the group's window; the roots go out in
        ONE ``count_op_pairs`` launch. No [K, S, W] query-axis stack is
        built. False (the members then serve singly) for a group whose
        stacks would not fit the stack budget together. The operands'
        references live until the counts reach the host."""
        index, slices = reqs[0]["index"], reqs[0]["slices"]
        entries = self._co_dedupe(reqs)
        win = self._co_window(
            index, [e[0]["leaves"] for e in entries], slices)
        distinct = {sp for e in entries for sp in e[0]["leaves"]}
        if self._over_budget(len(distinct) + len(entries), slices, win[1]):
            self._co_note_decline("budget")
            return False
        stacks = []
        for e in entries:
            pre = self._plan_stacks(index, e[0]["leaves"], slices, win=win)
            if pre is BATCH_OVER_BUDGET:
                self._co_note_decline("budget")
                return False
            stacks.append(pre[1])
        left, right, op = [], [], None
        for e, st in zip(entries, stacks):
            a, b, op = self._root_operands(e[0]["plan"], st)
            left.append(a)
            right.append(b)
        counts = bitops.count_op_pairs(left, right, op)
        totals = counts.sum(dim=1, dtype=torch.int64).tolist()
        for e, total in zip(entries, totals):
            for req in e:
                req["out"] = int(total)
        self._co_stats["table_entries"] += len(entries)
        self._co_note_fused(len(reqs))
        return True

    @staticmethod
    def _root_operands(node, stacks):
        """(a, b, op) of a plan's root count, as _count_node splits it:
        a leaf, a BSI descent or a one-operand node counts alone (b and
        op None); otherwise the first n-1 operands fold and the last
        meets them in the count."""
        if node[0] in ("leaf", "bsi") or len(node[1]) == 1:
            return Executor._eval_node(node, stacks), None, None
        acc = Executor._eval_node((node[0], node[1][:-1]), stacks)
        last = Executor._eval_node(node[1][-1], stacks)
        return acc, last, _COUNT_OPS[node[0]]

    # ------------------------------------------ compressed Count lanes

    @staticmethod
    def _lane_plan_shape(plan):
        """("count", leaf) for a bare row leaf (served from host-known
        cardinalities, no device work), (op, leaf_a, leaf_b) for a
        two-operand node over row leaves (one intersection lane per
        format cell and the count identities), None otherwise (ref:
        executor.py:2980-2996)."""
        if plan[0] == "leaf":
            return ("count", plan[1])
        op = _COUNT_OPS.get(plan[0])
        if (op is not None and len(plan[1]) == 2
                and plan[1][0][0] == "leaf" and plan[1][1][0] == "leaf"):
            return (op, plan[1][0][1], plan[1][1][1])
        return None

    def _co_fuse_lanes(self, reqs):
        """Serve K all-compressed same-structure Counts from the container
        lanes (ref: executor.py:3004-3131): equal members share one entry
        (``_co_dedupe``) and every distinct two-operand member's rows
        count in one launch of ``container_and_counts`` per format cell
        for the whole group (``_lane_counts``); nothing densifies."""
        entries = self._co_dedupe(reqs)
        totals, launches = self._lane_counts(
            reqs[0]["index"], reqs[0]["slices"],
            [(e[0]["plan"], e[0]["leaves"]) for e in entries])
        for e, total in zip(entries, totals):
            for req in e:
                req["out"] = total
        self._co_stats["lane_launches"] += launches
        self._co_stats["compressed_fused"] += len(reqs)
        self._co_note_fused(len(reqs))
        return True

    def _lane_counts(self, index, slices, members):
        """([count], kernel launches) of all-compressed Counts over one
        slice list, each member a (plan, leaves) of a lane shape: a bare
        leaf sums its host-known counts, a two-operand node is |a ∩ b|
        of its rows' RowLanes, all pairs in one
        ``containers.lane_and_counts`` call, and the op's identity over
        the rows' counts."""
        out, pairs, ops = [None] * len(members), [], []
        for i, (plan, leaves) in enumerate(members):
            shape = self._lane_plan_shape(plan)
            specs = [leaves[j] for j in shape[1:]]
            if shape[0] == "count":
                spec = specs[0]
                out[i] = sum(f.row_count(spec[2]) for f in
                             self.holder.fragments(index, *spec[:2], slices)
                             if f is not None)
                continue
            pairs.append(tuple(self._lane_row(index, spec, slices)
                               for spec in specs))
            ops.append((i, shape[0]))
        inter, launches = containers_mod.lane_and_counts(pairs)
        for (i, op), (la, lb), x in zip(ops, pairs, inter.tolist()):
            out[i] = int(containers_mod.count_identity(op, x, la.count,
                                                       lb.count))
        return out, launches

    # Bytes of the lanes' packed rows kept between queries.
    LANE_CACHE_BYTES = 256 << 20

    def _lane_row(self, index, spec, slices):
        """The RowLane of one row leaf over the slice list: its blocks
        (``Fragment.row_container``) packed for the lanes, cached until
        the index's epoch moves (a write), byte-bounded LRU (ref: the
        tick-shared container memo of executor.py:3035-3050, kept here
        across queries)."""
        key = (index, *spec, slice_key(slices))
        epoch = self._epoch(index)  # before building: a racing write
        # makes the entry stale on arrival, never wrong
        with self._cache_mu:
            hit = self._lane_cache.get(key)
            if hit is not None and hit[0] == epoch:
                self._lane_cache[key] = self._lane_cache.pop(key)
                return hit[1]
        frags = self.holder.fragments(index, spec[0], spec[1], slices)
        lane = containers_mod.RowLane([
            f.row_container(spec[2]) if f is not None else None
            for f in frags])
        with self._cache_mu:
            old = self._lane_cache.pop(key, None)
            if old is not None:
                self._lane_bytes -= old[1].nbytes
            while self._lane_cache and (self._lane_bytes + lane.nbytes
                                        > self.LANE_CACHE_BYTES):
                ev = self._lane_cache.pop(next(iter(self._lane_cache)))
                self._lane_bytes -= ev[1].nbytes
            if lane.nbytes <= self.LANE_CACHE_BYTES:
                self._lane_cache[key] = (epoch, lane)
                self._lane_bytes += lane.nbytes
        return lane

    # ------------------------------------------ coalesced Sum, Min/Max

    def _co_bsi_resolve(self, index, call):
        """(frame name, field, plan, leaves) of a coalescable BSI
        aggregate, or None when the batched path would decline it (ref:
        executor.py:3285)."""
        resolved = self._bsi_field(index, call)
        if resolved is None or len(call.children) > 1:
            return None
        frame_name, field = resolved
        leaves = []
        plan = None
        if call.children:
            plan = self._batched_plan(index, call.children[0], leaves)
            if plan is None:
                return None
        return frame_name, field, plan, leaves

    def _co_bsi_submit(self, kind, index, call, slices, single, fuse,
                       **extra):
        resolved = self._co_bsi_resolve(index, call)
        if resolved is None:
            return None
        frame_name, field, plan, leaves = resolved
        return self._co_submit({
            "key": (kind, index, slice_key(slices), frame_name, field.name,
                    field.bit_depth(), field.min, _plan_sig(plan)),
            "index": index, "slices": slices, "plan": plan,
            "leaves": leaves, "field": field, "frame_name": frame_name,
            "out": self._CO_PENDING, "single": single, "fuse": fuse,
            **extra})

    def _coalesced_sum(self, index, call, slices):
        """Sum through the tick (ref: executor.py:3263); the contract of
        _batched_sum."""
        single = lambda: self._batched_sum(index, call, slices)  # noqa
        if not self._co_enabled():
            return single()
        return self._co_bsi_submit("sum", index, call, slices, single,
                                   self._co_run_fused_sum)

    def _coalesced_min_max(self, index, call, slices, find_max):
        """Min/Max through the tick (ref: executor.py:3341); the contract
        of _batched_min_max."""
        single = lambda: self._batched_min_max(  # noqa: E731
            index, call, slices, find_max)
        if not self._co_enabled():
            return single()
        return self._co_bsi_submit(
            "max" if find_max else "min", index, call, slices, single,
            self._co_run_fused_minmax, find_max=find_max)

    def _co_bsi_group_prelude(self, reqs):
        """Shared setup of a BSI group (ref: executor.py:3394): True when
        the group was served (filterless members are all one query:
        computed once, shared), False when it declines, else (field,
        the depth+1 plane stacks at the group's window, entries, one
        filter stack exists ∩ tree per entry)."""
        index, slices = reqs[0]["index"], reqs[0]["slices"]
        plan = reqs[0]["plan"]
        if not slices or (plan is not None and plan[0] == "empty"):
            self._co_note_decline("structural")
            return False
        if plan is None:
            out = reqs[0]["single"]()
            for req in reqs:
                req["out"] = out
            self._co_note_fused(len(reqs))
            return True
        field = reqs[0]["field"]
        depth = field.bit_depth()
        view = view_field_name(field.name)
        planes = [(reqs[0]["frame_name"], view, i) for i in range(depth + 1)]
        entries = self._co_dedupe(reqs)
        win = self._co_window(
            index, [planes + e[0]["leaves"] for e in entries], slices)
        distinct = set(planes) | {sp for e in entries
                                  for sp in e[0]["leaves"]}
        if self._over_budget(len(distinct) + len(entries), slices, win[1]):
            self._co_note_decline("budget")
            return False
        pre = self._plan_stacks(index, planes, slices, kind="bsi", win=win)
        if pre is BATCH_OVER_BUDGET:
            self._co_note_decline("budget")
            return False
        plane_stacks = pre[1]
        filts = []
        for e in entries:
            pre = self._plan_stacks(index, e[0]["leaves"], slices, win=win)
            if pre is BATCH_OVER_BUDGET:
                self._co_note_decline("budget")
                return False
            filts.append(plane_stacks[depth]
                         & self._eval_node(e[0]["plan"], pre[1]))
        return field, plane_stacks, entries, filts

    def _co_run_fused_sum(self, reqs):
        """K filtered Sums in one ``count_and_rows_multi`` launch: the
        field's depth planes and not-null row read once for every
        member's filter (ref: executor.py:3310). The not-null row's count
        is the filter's; Σ 2^i·c_i in Python ints."""
        pre = self._co_bsi_group_prelude(reqs)
        if pre is True or pre is False:
            return pre
        field, planes, entries, filts = pre
        depth = field.bit_depth()
        counts = bitops.count_and_rows_multi(planes, filts).sum(
            dim=2, dtype=torch.int64).tolist()
        for e, c in zip(entries, counts):
            total = sum((1 << i) * v for i, v in enumerate(c[:depth]))
            out = SumCount(total + c[depth] * field.min, c[depth])
            for req in e:
                req["out"] = out
        self._co_stats["table_entries"] += len(entries)
        self._co_note_fused(len(reqs))
        return True

    def _co_run_fused_minmax(self, reqs):
        """K filtered Min/Max descents together (ref: executor.py:3364):
        each plane's occupancy test for every member is ONE
        ``count_op_pairs`` launch and ONE host sync for the group, where
        K single descents pay one of each per member; the members' keep/
        exclude steps are torch ops, as in ``bsi_extrema_indicators``."""
        pre = self._co_bsi_group_prelude(reqs)
        if pre is True or pre is False:
            return pre
        field, planes, entries, ms = pre
        find_max = reqs[0]["find_max"]
        op = "and" if find_max else "andnot"
        depth = field.bit_depth()
        k = len(ms)
        values = [0] * k
        for i in range(depth - 1, -1, -1):
            occ = bitops.count_op_pairs(ms, [planes[i]] * k, op).sum(
                dim=1, dtype=torch.int64)
            for j, has_pref in enumerate((occ > 0).tolist()):
                took_one = has_pref == find_max
                ms[j] = (ms[j] & planes[i] if took_one
                         else bsi_ops.andnot(ms[j], planes[i]))
                values[j] |= int(took_one) << i
        counts = bitops.count_op_pairs(ms, None, None).sum(
            dim=1, dtype=torch.int64).tolist()
        for e, value, count in zip(entries, values, counts):
            out = (SumCount(value + field.min, count) if count
                   else SumCount(0, 0))
            for req in e:
                req["out"] = out
        self._co_stats["table_entries"] += len(entries)
        self._co_note_fused(len(reqs))
        return True

    # ------------------------------------------------------------- TopN

    def _execute_topn(self, index, call, slices):
        """Two-phase TopN (ref: executeTopN executor.go:369-406):
        approximate per-slice candidates, then an exact re-query of the
        merged ids, trimmed to n. A call with ``ids`` is phase 2 alone
        and is never trimmed."""
        _, has_ids = call.uint_slice_arg("ids")
        n, _ = call.uint_arg("n")

        def compute():
            pairs = self._topn_map_reduce(index, call, slices, has_ids)
            if not pairs or has_ids:
                return pairs
            other = call.clone()
            other.args["ids"] = sorted(rid for rid, _ in pairs)
            trimmed = self._topn_map_reduce(index, other, slices, True)
            return trimmed[:n] if n else trimmed

        if has_ids:
            return compute()
        # Pairs round-trip through a uint64 array: row ids span uint64.
        return self._scalar_result_memo(
            "topn_res", index, call, slices, compute,
            enc=lambda pairs: np.asarray(pairs, dtype=np.uint64).reshape(
                -1, 2),
            dec=lambda a: [(int(r), int(c)) for r, c in a])

    def _topn_map_reduce(self, index, call, slices, has_ids):
        if (not has_ids and not call.children
                and self._force_path is None):
            return self._topn_discovery_memoized(index, call, slices)
        return self._topn_map_reduce_exec(index, call, slices, has_ids)

    def _topn_discovery_memoized(self, index, call, slices):
        """Src-less discovery (phase 1 without a Src reads host cache
        metadata fragment by fragment, ~25 µs a fragment) memoized on
        the index's epoch (ref: pilosa_tpu executor.py:5153). Not a
        result memo: phase 2's exact re-count still runs per query. The
        epoch is read before the walk, so a racing write makes the entry
        stale on arrival, never wrong; more than 100,000 pairs are not
        kept."""
        key = ("topn1", index, str(call), slice_key(slices))
        epoch = self._epoch(index)
        with self._cache_mu:
            hit = self._topn_disc_memo.get(key)
        if hit is not None and hit[0] == epoch:
            return list(hit[1])
        out = self._topn_map_reduce_exec(index, call, slices, False)
        if len(out) <= 100_000:
            with self._cache_mu:
                while (key not in self._topn_disc_memo
                       and len(self._topn_disc_memo)
                       >= self.TOPN_DISCOVERY_MEMO_MAX):
                    self._topn_disc_memo.pop(next(iter(
                        self._topn_disc_memo)))
                self._topn_disc_memo[key] = (epoch, tuple(out))
        return out

    def _topn_map_reduce_exec(self, index, call, slices, has_ids):
        frame_name = call.args.get("frame") or DEFAULT_FRAME
        allowed = self._topn_attr_allowed(index, call, frame_name)

        def batch_fn(ns):
            if has_ids:
                return self._batched_topn_ids(index, call, ns, allowed)
            return self._batched_topn_phase1(index, call, ns, allowed)

        return self._map_reduce(
            slices,
            lambda s: self._execute_topn_slice(index, call, s, allowed),
            pairs_add, self._windowed_batch(batch_fn, pairs_add)) or []

    def _topn_attr_allowed(self, index, call, frame_name):
        """Row ids whose attribute ``field`` is one of ``filters``, read
        from the frame's row attribute store once per call, or None when
        the call has no filter (ref: executeTopNSlice
        executor.go:433-500)."""
        attr_name = call.args.get("field") or ""
        filters = call.args.get("filters")
        if not attr_name or filters is None:
            return None
        frame = self.holder.index(index).frame(frame_name)
        if frame is None:
            return frozenset()
        store = frame.row_attr_store
        return frozenset(rid for rid in store.ids()
                         if store.attrs(rid).get(attr_name) in filters)

    def _topn_call_params(self, call):
        """Shared TopN argument parsing and validation: (frame, view, n,
        min_threshold, tanimoto)."""
        tanimoto, _ = call.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            raise ValueError("Tanimoto Threshold is from 1 to 100 only")
        if len(call.children) > 1:
            raise ValueError("TopN() can only have one input bitmap")
        frame_name = call.args.get("frame") or DEFAULT_FRAME
        view = (VIEW_INVERSE if call.args.get("inverse") is True
                else VIEW_STANDARD)
        n, _ = call.uint_arg("n")
        min_threshold, _ = call.uint_arg("threshold")
        return (frame_name, view, int(n),
                max(int(min_threshold), MIN_THRESHOLD), int(tanimoto))

    def _execute_topn_slice(self, index, call, slice_num, allowed):
        """(ref: executeTopNSlice executor.go:433-500): the slice's Src
        words stay on the device and go straight to ``Fragment.top``;
        ``allowed`` is the attribute filter's row ids, or None."""
        frame_name, view, n, min_threshold, tanimoto = (
            self._topn_call_params(call))
        row_ids, has_ids = call.uint_slice_arg("ids")
        src = None
        if call.children:
            bm = self._bitmap_call_slice(index, call.children[0], slice_num)
            src = bm.device_words(slice_num, self.device)
        frag = self.holder.fragment(index, frame_name, view, slice_num)
        if frag is None:
            return []
        return frag.top(TopOptions(
            n=n, src=src, row_ids=row_ids if has_ids else None,
            filter_row_ids=allowed, min_threshold=min_threshold,
            tanimoto_threshold=tanimoto))

    @staticmethod
    def _topn_pairs(row_ids, counts):
        """Sum the per-(candidate, slice) counts and order the pairs as
        pairs_add does: (-count, id)."""
        totals = counts.sum(axis=1, dtype=np.int64)
        pairs = [(int(rid), int(t))
                 for rid, t in zip(row_ids, totals) if t > 0]
        pairs.sort(key=lambda rc: (-rc[1], rc[0]))
        return pairs

    def _batched_topn_ids(self, index, call, slices, allowed):
        """Exact TopN re-query (phase 2) over the slice list: per-slice
        threshold, then the sum — the serial path's semantics; only the
        ids the attribute filter ``allowed`` (None: all). None when
        ineligible (no ids, an unbatchable Src tree)."""
        row_ids, has_ids = call.uint_slice_arg("ids")
        if not slices or not has_ids or not row_ids:
            return None
        frame_name, view, _, min_threshold, tanimoto = (
            self._topn_call_params(call))
        # The serial walk tests membership in the id set, so duplicate
        # ids yield one pair each.
        row_ids = sorted(set(row_ids))
        leaves = []
        plan = None
        if call.children:
            plan = self._batched_plan(index, call.children[0], leaves)
            if plan is None:
                return None
        if allowed is not None:
            row_ids = [rid for rid in row_ids if rid in allowed]
            if not row_ids:
                return []
        if len(row_ids) > self.MAX_TOPN_CANDIDATES:
            return None
        counts = self._topn_candidate_counts(
            index, frame_name, view, row_ids, slices, tanimoto, plan,
            leaves)
        if counts is BATCH_OVER_BUDGET:
            return counts
        counts = np.where(counts >= min_threshold, counts, 0)
        return self._topn_pairs(row_ids, counts)

    def _batched_topn_phase1(self, index, call, slices, allowed):
        """TopN phase 1 (candidate discovery) with a Src tree, bit-equal
        to the serial per-fragment walk: exact |row ∩ src| for every
        (candidate, slice) over the union of the slices' cache entries,
        masked back to each slice's own cache membership (ref:
        topBitmapPairs fragment.go:965), thresholded, cut to each
        slice's top n by (-count, id), then merged; the attribute filter
        ``allowed`` (None: all) narrows each slice's entries. None
        without a Src (the serial walk reads host row counts; no device
        work)."""
        if not slices:
            return None
        frame_name, view, n, min_threshold, tanimoto = (
            self._topn_call_params(call))
        if not call.children:
            return None
        leaves = []
        plan = self._batched_plan(index, call.children[0], leaves)
        if plan is None:
            return None
        ent_sets = [
            frag.cache_entry_ids() if frag is not None else frozenset()
            for frag in self.holder.fragments(index, frame_name, view,
                                              slices)]
        if allowed is not None:
            ent_sets = [es & allowed for es in ent_sets]
        union_ids = set().union(*ent_sets)
        if not union_ids:
            return []
        if len(union_ids) > self.MAX_TOPN_CANDIDATES:
            return BATCH_OVER_BUDGET  # fewer in a smaller slice window
        union_ids = sorted(union_ids)
        counts = self._topn_candidate_counts(
            index, frame_name, view, union_ids, slices, tanimoto, plan,
            leaves)
        if counts is BATCH_OVER_BUDGET:
            return counts
        pos = {rid: i for i, rid in enumerate(union_ids)}
        member_rows = [pos[rid] for es in ent_sets for rid in es]
        member_cols = np.repeat(np.arange(len(ent_sets)),
                                [len(es) for es in ent_sets])
        mask = np.zeros(counts.shape, dtype=bool)
        mask[member_rows, member_cols] = True
        counts = np.where(mask & (counts >= min_threshold), counts, 0)
        if n and counts.shape[0] > n:
            # Per-slice top n by (-count, id): a stable sort of -count
            # keeps ascending ids (union_ids is sorted) within a count.
            order = np.argsort(-counts, axis=0, kind="stable")
            rank = np.empty_like(order)
            np.put_along_axis(rank, order,
                              np.arange(counts.shape[0])[:, None], axis=0)
            counts[rank >= n] = 0
        return self._topn_pairs(union_ids, counts)

    def _topn_candidate_counts(self, index, frame_name, view, row_ids,
                               slices, tanimoto, plan, leaves):
        """Host int64[len(row_ids), len(slices)] counts per (candidate,
        slice): |row ∩ src| from one ``count_and_rows`` launch against
        the Src stack (zeroed by the Tanimoto ceil gate when asked), or
        |row| from ``count_rows`` without a Src. Candidate rows and Src
        leaves come from the cached leaf stacks, at the window of every
        fragment involved; BATCH_OVER_BUDGET when they would not fit the
        stack budget together. A statically empty Src counts zero
        everywhere."""
        if plan is not None and plan[0] == "empty":
            return np.zeros((len(row_ids), len(slices)), np.int64)
        # The count matrix is a function of fragment state alone: a hot
        # TopN re-counts the same candidates (ref: pilosa_tpu
        # executor.py:4036-4046, the "topnc" memo).
        mkey = ("topnc", index, frame_name, view, tuple(row_ids),
                slice_key(slices), tanimoto, str(plan), tuple(leaves))
        memo = self._result_memo_get(mkey)
        if memo is not None:
            return memo
        epoch = self._epoch(index)
        cands = [(frame_name, view, rid) for rid in row_ids]
        pre = self._plan_stacks(index, cands + leaves, slices, kind="topnp")
        if pre is BATCH_OVER_BUDGET:
            return pre
        stacks, leaf_stacks = pre[1][:len(cands)], pre[1][len(cands):]
        if plan is None:
            counts = torch.stack([bitops.count_rows(st) for st in stacks])
            out = counts.cpu().numpy().astype(np.int64)
        else:
            src = self._eval_node(plan, leaf_stacks)
            inter = bitops.count_and_rows_stacks(stacks, src)
            if not tanimoto:
                out = inter.cpu().numpy().astype(np.int64)
            else:
                # Score on the device with the serial path's formula; the
                # ceil gate on the host (ref: executor.py:4113-4126).
                row_n = torch.stack([bitops.count_rows(st) for st in stacks])
                src_n = bitops.count_rows(src)
                scores = topn_ops.tanimoto_score_counts(inter, row_n,
                                                        src_n[None, :])
                inter = inter.cpu().numpy().astype(np.int64)
                out = np.where(topn_ops.tanimoto_keep(
                    scores.cpu().numpy(), tanimoto), inter, 0)
        return self._topn_counts_memoize(mkey, out, epoch)

    # ---------------------------------------------------- SetBit/ClearBit

    def _execute_set_bit(self, index, call, set_value):
        """(ref: executeSetBit executor.go:985-1056, executeClearBit :891):
        the standard view, plus the inverse view of inverse-enabled
        frames; with a ``timestamp``, each view's time views too."""
        verb = "SetBit" if set_value else "ClearBit"
        view = call.args.get("view") or ""
        frame_name = call.args.get("frame")
        if not isinstance(frame_name, str):
            raise ValueError(f"{verb}() field required: frame")
        idx = self.holder.index(index)
        frame = idx.frame(frame_name)
        if frame is None:
            raise perr.ErrFrameNotFound()
        row_id, ok = call.uint_arg(frame.row_label)
        if not ok:
            raise ValueError(f"{verb}() row field '{frame.row_label}' required")
        col_id, ok = call.uint_arg(idx.column_label)
        if not ok:
            raise ValueError(
                f"{verb}() column field '{idx.column_label}' required")
        timestamp = None
        ts = call.args.get("timestamp")
        if isinstance(ts, str):
            try:
                timestamp = datetime.strptime(ts, TIME_FORMAT)
            except ValueError:
                raise ValueError(f"invalid date: {ts}")
        if view == VIEW_STANDARD:
            views = [(VIEW_STANDARD, col_id, row_id)]
        elif view == VIEW_INVERSE:
            views = [(VIEW_INVERSE, row_id, col_id)]
        elif view == "":
            views = [(VIEW_STANDARD, col_id, row_id)]
            if frame.inverse_enabled:
                views.append((VIEW_INVERSE, row_id, col_id))
        else:
            raise perr.ErrInvalidView()
        changed = False
        for view_name, c, r in views:
            if set_value:
                changed |= frame.set_bit(view_name, r, c, timestamp)
            else:
                changed |= frame.clear_bit(view_name, r, c, timestamp)
        return changed

    # ------------------------------------------------------ SetFieldValue

    def _execute_set_field_value(self, index, call):
        """(ref: executeSetFieldValue executor.go:1091-1161), one node:
        each ``field=value`` argument is written; the result is None."""
        frame_name = call.args.get("frame")
        if not isinstance(frame_name, str):
            raise ValueError("SetFieldValue() field required: frame")
        idx = self.holder.index(index)
        frame = idx.frame(frame_name)
        if frame is None:
            raise perr.ErrFrameNotFound()
        col_id, ok = call.uint_arg(idx.column_label)
        if not ok:
            raise ValueError(
                f"SetFieldValue() column field '{idx.column_label}' required")
        fields = {k: v for k, v in call.args.items()
                  if k not in ("frame", idx.column_label)}
        if not fields:
            raise ValueError("SetFieldValue() at least one field "
                             "value is required")
        for fname, value in fields.items():
            if isinstance(value, bool) or not isinstance(value, int):
                raise perr.ErrInvalidFieldValueType()
            frame.set_field_value(col_id, fname, value)
        return None

    # ------------------------------------------------------ attributes

    @staticmethod
    def _attrs_from_args(call, exclude):
        """The call's arguments but ``exclude``, as attributes."""
        attrs = {}
        for k, v in call.args.items():
            if k in exclude:
                continue
            if isinstance(v, Condition):
                raise ValueError("attribute value cannot be a condition")
            attrs[k] = v
        return attrs

    def _row_attrs_call(self, idx, call):
        """(frame, row id, attrs) of a SetRowAttrs call, with the
        reference's argument errors."""
        frame_name = call.args.get("frame")
        if not isinstance(frame_name, str):
            raise ValueError("SetRowAttrs() field required: frame")
        frame = idx.frame(frame_name)
        if frame is None:
            raise perr.ErrFrameNotFound()
        row_id, ok = call.uint_arg(frame.row_label)
        if not ok:
            raise ValueError(
                f"SetRowAttrs() row field '{frame.row_label}' required")
        return frame, row_id, self._attrs_from_args(
            call, ("frame", frame.row_label))

    def _execute_set_row_attrs(self, index, call):
        """(ref: executeSetRowAttrs executor.go:1164-1220), one node."""
        frame, row_id, attrs = self._row_attrs_call(
            self.holder.index(index), call)
        frame.row_attr_store.set_attrs(row_id, attrs)
        return None

    def _execute_bulk_set_row_attrs(self, index, calls):
        """SetRowAttrs calls grouped into one ``set_bulk_attrs`` per
        frame (ref: executeBulkSetRowAttrs executor.go:1222-1308)."""
        idx = self.holder.index(index)
        by_frame = {}
        for call in calls:
            frame, row_id, attrs = self._row_attrs_call(idx, call)
            by_frame.setdefault(frame.name, {}).setdefault(
                row_id, {}).update(attrs)
        for frame_name, attr_map in by_frame.items():
            idx.frame(frame_name).row_attr_store.set_bulk_attrs(attr_map)
        return [None] * len(calls)

    def _execute_set_column_attrs(self, index, call):
        """(ref: executeSetColumnAttrs executor.go), one node."""
        idx = self.holder.index(index)
        col_id, ok = call.uint_arg(idx.column_label)
        if not ok:
            raise ValueError(
                f"SetColumnAttrs() column field '{idx.column_label}' "
                "required")
        attrs = self._attrs_from_args(call, (idx.column_label, "frame"))
        idx.column_attr_store.set_attrs(col_id, attrs)
        return None
