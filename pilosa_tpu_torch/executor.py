"""Query executor — the Count path (ref: executor.go; counterpart of
pilosa_tpu/executor.py).

``Executor.execute(index, pql)`` runs ``Count`` over trees of
``Bitmap``/``Intersect``/``Union``/``Difference``/``Xor``, and
``SetBit``/``ClearBit``, on one node. A Count maps over the index's
slices by one of two paths:

- **batched** (the default): each Bitmap leaf becomes one
  ``int32[n_slices, 32768]`` device stack (cached until a fragment
  changes), the tree folds with PyTorch bitwise ops, and its ROOT op is
  fused into the ``count_op_rows`` kernel — a two-leaf Count reads each
  stack once and materialises nothing. A single leaf counts with
  ``count_rows``. Per-slice counts are int32; their total is an int64
  sum, so a 10B-column count cannot wrap.
- **serial**: slice by slice through ``Bitmap`` algebra, two-operand
  nodes through the count kernels without materialising.

``_force_path`` ("serial"/"batched") pins one path; otherwise a tree the
batched planner does not cover (errors, unsupported leaves) goes serial,
where the reference's error messages are raised.
"""
import threading
from datetime import datetime

import torch

from pilosa_tpu_torch import WORDS_PER_SLICE
from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch.bitmap import Bitmap
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.storage.view import VIEW_INVERSE, VIEW_STANDARD

DEFAULT_FRAME = "general"        # ref: executor.go:31
TIME_FORMAT = "%Y-%m-%dT%H:%M"   # ref: TimeFormat "2006-01-02T15:04"

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


class Executor:
    # Device bytes the leaf-stack cache may hold (each stack is
    # n_slices × 128 KiB; 9,537 slices = 1.25 GB).
    STACK_CACHE_BYTES = 16 << 30

    def __init__(self, holder):
        self.holder = holder
        self.device = holder.device
        self._force_path = None  # "serial" | "batched" | None
        self._stack_cache = {}   # key -> (epoch, tokens, stack)
        self._stack_bytes = 0
        self._cache_mu = threading.Lock()

    def execute(self, index, query, slices=None):
        """(ref: Executor.Execute executor.go:62-151) → one result per
        call."""
        if isinstance(query, str):
            query = parse(query)
        idx = self.holder.index(index)
        if idx is None:
            raise perr.ErrIndexNotFound()
        if slices is None:
            needed = any(c.name not in WRITE_CALLS for c in query.calls)
            slices = range(idx.max_slice() + 1) if needed else range(0)
        return [self._execute_call(index, c, slices) for c in query.calls]

    def _execute_call(self, index, call, slices):
        name = call.name
        if name not in KNOWN_CALLS:
            raise ValueError(f"unknown call: {name}")
        if name == "SetBit":
            return self._execute_set_bit(index, call, set_value=True)
        if name == "ClearBit":
            return self._execute_set_bit(index, call, set_value=False)
        if name == "Count":
            return self._execute_count(index, call, slices)
        raise NotImplementedError(
            f"{name}() is not ported to pilosa_tpu_torch yet")

    # ------------------------------------------------------ map/reduce

    def _map_reduce(self, slices, map_fn, reduce_fn, batch_fn):
        """Single-node map/reduce (ref: mapReduce executor.go:1444-1535):
        the batched path unless pinned serial or ineligible (None)."""
        if self._force_path != "serial":
            out = batch_fn(slices)
            if out is not None:
                return out
        result = None
        for s in slices:
            result = reduce_fn(result, map_fn(s))
        return result

    # ------------------------------------------------------------ Count

    def _execute_count(self, index, call, slices):
        """(ref: executeCount executor.go:859-889)."""
        if len(call.children) != 1:
            raise ValueError("Count() only accepts a single bitmap input")
        child = call.children[0]
        return self._map_reduce(
            slices,
            lambda s: self._count_call_slice(index, child, s),
            lambda prev, v: (prev or 0) + v,
            lambda ns: self._batched_count(index, child, ns)) or 0

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
            raise NotImplementedError(
                "Range() is not ported to pilosa_tpu_torch yet")
        raise ValueError(f"unknown call: {name}")

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
        return Bitmap.from_device(slice_num, frag.device_row(row_id))

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
            if spec not in leaves:
                leaves.append(spec)
            return ("leaf", leaves.index(spec))
        if call.name in _BATCH_OPS and call.children:
            kids = []
            for c in call.children:
                node = self._batched_plan(index, c, leaves)
                if node is None:
                    return None
                kids.append(node)
            return (call.name, kids)
        return None

    def _batched_count(self, index, child, slices):
        """Count over the slice list with one device stack per leaf: the
        tree folds with PyTorch bitwise ops and its root op runs fused
        in the count kernel, which yields int32 per-slice counts."""
        if len(slices) == 0:
            return None
        leaves = []
        plan = self._batched_plan(index, child, leaves)
        if plan is None:
            return None
        stacks = [self._leaf_stack(index, spec, slices) for spec in leaves]
        counts = self._count_node(plan, stacks)
        return int(counts.sum(dtype=torch.int64))

    @staticmethod
    def _eval_node(node, stacks):
        """Left-fold tree evaluation on stacks — the serial fold's
        pairwise order."""
        if node[0] == "leaf":
            return stacks[node[1]]
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
        if node[0] == "leaf" or len(node[1]) == 1:
            return bitops.count_rows(Executor._eval_node(node, stacks))
        acc = Executor._eval_node((node[0], node[1][:-1]), stacks)
        last = Executor._eval_node(node[1][-1], stacks)
        return bitops.count_op_rows(acc, last, _COUNT_OPS[node[0]])

    def _leaf_stack(self, index, spec, slices):
        """``int32[len(slices), 32768]`` device stack of one row across
        the slice list; absent fragments stack zero rows. Cached until a
        fragment of the index changes: the index's mutation epoch is the
        O(1) check, per-fragment (uid, version) tokens the exact one."""
        frame_name, view, row_id = spec
        skey = (("range", slices.start, slices.stop, slices.step)
                if isinstance(slices, range) else tuple(slices))
        key = (index, frame_name, view, row_id, skey)
        epoch = self.holder.index(index).epoch.value
        with self._cache_mu:
            hit = self._stack_cache.get(key)
        if hit is not None and hit[0] == epoch:
            return hit[2]
        frags = self.holder.fragments(index, frame_name, view, slices)
        tokens = tuple((f._uid, f._version) if f is not None else None
                       for f in frags)
        if hit is not None and hit[1] == tokens:
            with self._cache_mu:
                self._stack_cache[key] = (epoch, tokens, hit[2])
            return hit[2]
        zero = torch.zeros(WORDS_PER_SLICE, dtype=torch.int32,
                           device=self.device)
        stack = torch.stack([f.device_row(row_id) if f is not None else zero
                             for f in frags])
        self._cache_put(key, (epoch, tokens, stack))
        return stack

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

    # ---------------------------------------------------- SetBit/ClearBit

    def _execute_set_bit(self, index, call, set_value):
        """(ref: executeSetBit executor.go:985-1056, executeClearBit :891):
        the standard view, plus the inverse view of inverse-enabled
        frames."""
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
        ts = call.args.get("timestamp")
        if isinstance(ts, str):
            try:
                datetime.strptime(ts, TIME_FORMAT)
            except ValueError:
                raise ValueError(f"invalid date: {ts}")
            raise NotImplementedError(
                f"{verb}() with a timestamp writes time views, which are "
                "not ported to pilosa_tpu_torch yet")
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
                changed |= frame.set_bit(view_name, r, c)
            else:
                changed |= frame.clear_bit(view_name, r, c)
        return changed

