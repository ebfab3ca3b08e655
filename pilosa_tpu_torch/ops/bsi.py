"""Bit-sliced index (BSI) operations for integer fields (counterpart of
pilosa_tpu/ops/bsi.py).

An integer field stores each value's bits in rows 0..depth-1 plus a
not-null row at ``depth`` (fragment.go:493-528), and answers:

- ``FieldSum``   (fragment.go:590)  sum = Σ 2^i · |plane_i ∩ filter|
- ``FieldRange`` (fragment.go:621)  EQ :636 / NEQ :655 / LT(E) :671 /
  GT(E) :719 / BETWEEN :760 — MSB→LSB descents with keep/exclude
  accumulators
- Min/Max — an MSB→LSB descent that keeps the preferred half of the
  candidates whenever it is not empty.

``planes`` is anything indexable by plane number whose items are int32
word tensors of one shape: an ``int32[depth, W]`` fragment matrix (each
plane a row ``[W]``) or a list of ``int32[S, W]`` stacks (each plane one
row across S slices). Every op works over the last axis, so one function
serves both. ``exists`` is the not-null row (or stack) of that shape.

The predicate is a per-plane bit sequence of host ints (``value_to_bits``)
— a Python int may exceed 32 bits and never goes to the device. The
descent branches on each bit in Python; pilosa_tpu computes both sides
and ``select``s, which gives the same words. Operations never write into
their inputs: ``exists`` and the planes are usually cached stacks.

The descents are PyTorch bitwise ops (pilosa_tpu jits them as XLA
fusions, not Pallas kernels); every count goes through the hand-written
kernels of :mod:`pilosa_tpu_torch.ops.kernels`.
"""
import torch

from pilosa_tpu_torch.ops import kernels


def value_to_bits(value, depth):
    """Host helper: Python int -> tuple of ``depth`` bits, LSB first."""
    return tuple((value >> i) & 1 for i in range(depth))


def plane_counts(planes, filt):
    """int32[depth] of |plane_i ∩ filt| for an ``int32[depth, W]``
    plane matrix and an ``int32[W]`` filter, by ``count_and_rows`` — the
    host computes Σ 2^i·c_i in Python ints (ref: FieldSum
    fragment.go:590)."""
    return kernels.count_and_rows(planes, filt)


def andnot(m, p):
    """m & ~p, as m ^ (m & p)."""
    return m ^ (m & p)


def _or(acc, v):
    return v if acc is None else acc | v


def _zeros_or(acc, like):
    return torch.zeros_like(like) if acc is None else acc


def bsi_eq(planes, exists, pred_bits):
    m = exists
    for i in range(len(pred_bits) - 1, -1, -1):
        m = m & planes[i] if pred_bits[i] else andnot(m, planes[i])
    return m


def bsi_neq(planes, exists, pred_bits):
    """exists \\ EQ (ref: fragment.go:655)."""
    return exists & ~bsi_eq(planes, exists, pred_bits)


def _lt_descent(planes, exists, pred_bits):
    """MSB→LSB descent; returns (matched or None, undecided-equal)."""
    m = exists
    matched = None
    for i in range(len(pred_bits) - 1, -1, -1):
        if pred_bits[i]:
            # Rows with 0 here are strictly less; rows with 1 continue.
            ones = m & planes[i]
            matched = _or(matched, m ^ ones)
            m = ones
        else:
            # Rows with 1 here are strictly greater: drop them.
            m = andnot(m, planes[i])
    return matched, m


def bsi_lt(planes, exists, pred_bits):
    matched, _ = _lt_descent(planes, exists, pred_bits)
    return _zeros_or(matched, exists)


def bsi_lte(planes, exists, pred_bits):
    matched, eq = _lt_descent(planes, exists, pred_bits)
    return _or(matched, eq)


def _gt_descent(planes, exists, pred_bits):
    m = exists
    matched = None
    for i in range(len(pred_bits) - 1, -1, -1):
        if pred_bits[i]:
            # Rows with 0 here are strictly less: drop them.
            m = m & planes[i]
        else:
            # Rows with 1 here are strictly greater; rows with 0 continue.
            ones = m & planes[i]
            matched = _or(matched, ones)
            m = m ^ ones
    return matched, m


def bsi_gt(planes, exists, pred_bits):
    matched, _ = _gt_descent(planes, exists, pred_bits)
    return _zeros_or(matched, exists)


def bsi_gte(planes, exists, pred_bits):
    matched, eq = _gt_descent(planes, exists, pred_bits)
    return _or(matched, eq)


def bsi_between(planes, exists, lo_bits, hi_bits):
    """lo ≤ v ≤ hi (ref: FieldRangeBetween fragment.go:760)."""
    return (bsi_gte(planes, exists, lo_bits)
            & bsi_lte(planes, exists, hi_bits))


# The descent that answers each Range condition operator.
COMPARE = {"==": bsi_eq, "!=": bsi_neq, "<": bsi_lt, "<=": bsi_lte,
           ">": bsi_gt, ">=": bsi_gte, "><": bsi_between}


def bsi_extrema_indicators(planes, filt, find_max):
    """Bit-descent for Min/Max over ``filt`` (exists ∩ filter).

    Returns ``(indicators, remaining)``: ``indicators`` is a CPU
    ``int32[depth]`` tensor whose entry i is the bit chosen at plane i,
    ``remaining`` the words of the columns that attain the extremum. Each
    plane's occupancy test — is the preferred half empty? — is one
    count launch (``count_op_rows`` with ``and`` for Max, ``andnot`` for
    Min, over every row of ``filt``) and one host sync: ``depth`` syncs
    per call."""
    depth = len(planes)
    op = "and" if find_max else "andnot"
    m = filt
    indicators = [0] * depth
    for i in range(depth - 1, -1, -1):
        has_pref = bool(kernels.count_op_rows(m, planes[i], op).sum(
            dtype=torch.int64) > 0)
        took_one = has_pref == find_max
        m = m & planes[i] if took_one else andnot(m, planes[i])
        indicators[i] = int(took_one)
    return torch.tensor(indicators, dtype=torch.int32), m
