"""Packed-bitmap algebra on int32 word tensors (counterpart of
pilosa_tpu/ops/bitops.py, dense part).

A bitmap row is an ``int32[n_words]`` tensor holding the 32-bit device
words; binary ops are single PyTorch bitwise ops, and every count goes
through the hand-written kernels in :mod:`pilosa_tpu_torch.ops.kernels`
(the plain versions on the CPU). Counts never materialise the combined
bitmap (the reference's count-only fast paths, roaring.go:1811-1923).

Per-row counts are ``int32`` (a slice holds at most 2^20 bits); the
scalar counts are the int64 sum of the per-row counts, so totals over
many slices never wrap.
"""
import torch

from pilosa_tpu_torch.ops import kernels

# ---------------------------------------------------------------------------
# Binary algebra (materialising). Ref semantics: roaring.go Intersect :1925,
# Union :2123, Difference :2415, Xor :2732.
# ---------------------------------------------------------------------------


def bitmap_and(a, b):
    return a & b


def bitmap_or(a, b):
    return a | b


def bitmap_xor(a, b):
    return a ^ b


def bitmap_andnot(a, b):
    """a \\ b (ref: Difference, roaring.go:2415)."""
    return a & ~b


PAIR_OPS = {"and": bitmap_and, "or": bitmap_or, "xor": bitmap_xor,
            "andnot": bitmap_andnot}

# ---------------------------------------------------------------------------
# Population counts. Ref: popcount* roaring.go:3242-3283 and the count-only
# fast paths :1811-1923.
# ---------------------------------------------------------------------------


def count_rows(m):
    """Per-row set bits over the trailing axis: int32[..., W] -> int32[...]."""
    return kernels.count_rows(m)


def count_op_rows(a, b, op):
    """Per-row |a OP b|: int32[..., W] × 2 -> int32[...]."""
    return kernels.count_op_rows(a, b, op)


def count_and_rows(m, filt):
    """Per-row |m ∩ filt| against one filter row: int32[R, W], int32[W]
    -> int32[R] (TopN's Src intersection, fragment.go:886-906)."""
    return kernels.count_and_rows(m, filt)


def count_and_rows_stacks(rows, filt):
    """Per-(row, slice) |rows[r][s] ∩ filt[s]|: R tensors int32[S, W]
    and int32[S, W] -> int32[R, S], the filter read once for all rows
    (batched TopN with a Src tree)."""
    return kernels.count_and_rows_stacks(rows, filt)


def count_op_pairs(a, b, op):
    """Per-(pair, slice) |a[k][s] OP b[k][s]| for K pairs of int32[S, W]
    stacks in one launch -> int32[K, S]; ``op`` None counts a[k] alone
    (the coalescer's fused Count groups and Min/Max occupancy tests)."""
    return kernels.count_op_pairs(a, b, op)


def count_and_rows_multi(rows, filts):
    """Per-(filter, row, slice) |rows[r][s] ∩ filts[k][s]| for R and K
    int32[S, W] stacks -> int32[K, R, S], each stack read once (the
    coalescer's fused Sum groups)."""
    return kernels.count_and_rows_multi(rows, filts)


def count(a):
    """Total set bits, as a 0-d int64 tensor (ref: Bitmap.Count
    roaring.go:185)."""
    return kernels.count_rows(a).sum(dtype=torch.int64)


def count_op(op, a, b):
    """|a OP b| without materialising, as a 0-d int64 tensor."""
    return kernels.count_op_rows(a, b, op).sum(dtype=torch.int64)


def count_and(a, b):
    """|a ∩ b| (ref: intersectionCount* roaring.go:1811-1923)."""
    return count_op("and", a, b)


def count_or(a, b):
    return count_op("or", a, b)


def count_xor(a, b):
    return count_op("xor", a, b)


def count_andnot(a, b):
    return count_op("andnot", a, b)


# ---------------------------------------------------------------------------
# Format-polymorphic dispatch (ref: pilosa_tpu ops/bitops.py:405-500, the
# registry shape of the reference's container matrix, roaring.go:1811-3283).
# An operand carries a format descriptor (``fmt``; raw word tensors are
# dense), a table maps (op, fmt_a, fmt_b) to a count cell, and a pair with no
# cell densifies both sides. ops/containers.py registers its cells at import.
# ---------------------------------------------------------------------------

FMT_DENSE = "dense"
FMT_ARRAY = "array"
FMT_RUN = "run"

_COUNT_KERNELS = {}  # (op, fmt_a, fmt_b) -> count cell
_DENSE_COUNT = {"and": count_and, "or": count_or, "xor": count_xor,
                "andnot": count_andnot}


def operand_format(x):
    """An operand's format: its ``fmt``, or dense for a raw tensor."""
    return getattr(x, "fmt", FMT_DENSE)


def register_count_kernel(op, fmt_a, fmt_b, fn):
    """Install the count cell of one (op, format, format); the last
    registration wins."""
    _COUNT_KERNELS[(op, fmt_a, fmt_b)] = fn


def densify(x):
    """Dense int32 words of any operand: a raw tensor passes through, a
    container gives ``dense_words()``."""
    fn = getattr(x, "dense_words", None)
    return x if fn is None else fn()


def dispatch_count(op, a, b):
    """|a OP b| by the operands' formats: dense×dense is the dense count
    (``count_op_rows``), a registered cell runs its kernel, any other
    pair densifies both sides."""
    fa, fb = operand_format(a), operand_format(b)
    if fa != FMT_DENSE or fb != FMT_DENSE:
        fn = _COUNT_KERNELS.get((op, fa, fb))
        if fn is not None:
            return fn(a, b)
    return _DENSE_COUNT[op](densify(a), densify(b))


def dispatch_pair(op, a, b):
    """a OP b as dense words: compressed operands densify first (results
    feed dense Bitmap segments)."""
    return PAIR_OPS[op](densify(a), densify(b))


# ---------------------------------------------------------------------------
# Ingest registry (ref: pilosa_tpu ops/bitops.py:528-540): the bulk-ingest
# pipeline (ingest/pipeline.py) resolves its classify pass and its
# per-format container builders through named cells, and ops/ingest.py
# registers them at import: ``classify`` (with ``classify.host`` and
# ``classify.device``), ``pack_classify`` and ``build.<fmt>``.
# ---------------------------------------------------------------------------

_INGEST_KERNELS = {}


def register_ingest_kernel(name, fn):
    """Install one ingest cell; the last registration wins (tests swap in
    probes)."""
    _INGEST_KERNELS[name] = fn


def ingest_kernel(name):
    """The registered ingest cell, or None."""
    return _INGEST_KERNELS.get(name)
