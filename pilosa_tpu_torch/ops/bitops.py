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
