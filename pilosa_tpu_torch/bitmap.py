"""Cross-slice result bitmap (ref: bitmap.go:28-155; counterpart of
pilosa_tpu/bitmap.py).

A segment is one slice's words as an ``int32[32768]`` tensor on the
holder's device, so algebra between result bitmaps stays on the device
and counts run through the count kernels.
"""
import torch

from pilosa_tpu_torch import WORDS_PER_SLICE
from pilosa_tpu_torch.ops import bitops


def _seg_count(seg):
    return int(bitops.count(seg))


class Bitmap:
    def __init__(self, attrs=None):
        self.segments = {}  # slice -> int32[WORDS_PER_SLICE] tensor
        self.attrs = attrs or {}
        self._count = None  # cached count (ref: bitmap.go:205-238)

    @classmethod
    def from_device(cls, slice_num, words32):
        bm = cls()
        bm.segments[slice_num] = words32
        return bm

    # ------------------------------------------------------------- algebra
    # Aligned segment-wise ops (ref: mergeSegmentIterator bitmap.go:426-461);
    # a missing segment is all-zeros.

    def intersect(self, other):
        out = Bitmap()
        for k in self.segments.keys() & other.segments.keys():
            out.segments[k] = bitops.bitmap_and(self.segments[k],
                                                other.segments[k])
        return out

    def union(self, other):
        return self._either(other, bitops.bitmap_or)

    def xor(self, other):
        return self._either(other, bitops.bitmap_xor)

    def _either(self, other, fn):
        out = Bitmap()
        for k in self.segments.keys() | other.segments.keys():
            a, b = self.segments.get(k), other.segments.get(k)
            out.segments[k] = (b if a is None else a if b is None
                               else fn(a, b))
        return out

    def difference(self, other):
        out = Bitmap()
        for k, a in self.segments.items():
            b = other.segments.get(k)
            out.segments[k] = a if b is None else bitops.bitmap_andnot(a, b)
        return out

    def op_count(self, op, other):
        """|self OP other| without materialising the result: per-slice
        count kernels, with absent segments resolved by the op's
        identity (missing = all-zeros): ``and`` skips them, ``or``/``xor``
        count the present side, ``andnot`` counts an unopposed left
        side (ref: bitmap.go:139 IntersectionCount)."""
        total = 0
        mine, theirs = self.segments, other.segments
        if op == "and":
            for k in mine.keys() & theirs.keys():
                total += int(bitops.count_op("and", mine[k], theirs[k]))
            return total
        if op == "andnot":
            for k, a in mine.items():
                b = theirs.get(k)
                total += (_seg_count(a) if b is None
                          else int(bitops.count_op("andnot", a, b)))
            return total
        for k in mine.keys() | theirs.keys():  # or / xor
            a, b = mine.get(k), theirs.get(k)
            if a is None:
                total += _seg_count(b)
            elif b is None:
                total += _seg_count(a)
            else:
                total += int(bitops.count_op(op, a, b))
        return total

    # ------------------------------------------------------------- readers

    def device_words(self, slice_num, device):
        """int32[32768] words of one slice on ``device`` (zeros when the
        segment is absent) — the device counterpart of pilosa_tpu's
        ``host_words``: a Src row reaches the TopN kernel without a
        round trip through the host."""
        seg = self.segments.get(slice_num)
        if seg is None:
            return torch.zeros(WORDS_PER_SLICE, dtype=torch.int32,
                               device=device)
        return seg

    def count(self):
        if self._count is None:
            self._count = sum(_seg_count(w) for w in self.segments.values())
        return self._count
