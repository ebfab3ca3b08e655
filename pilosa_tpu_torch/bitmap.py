"""Cross-slice result bitmap (ref: bitmap.go:28-155; counterpart of
pilosa_tpu/bitmap.py).

A segment is one slice's words as an ``int32[32768]`` tensor on the
holder's device, so algebra between result bitmaps stays on the device
and counts run through the count kernels.

A batched result arrives as ONE ``int32[S, W]`` device stack with its
per-slice counts and its column window's first word (``defer_stack``):
``count()`` reads the counts, ``columns()`` finds the set bits in the
stack on the device, offset by the window, and only a caller that
touches ``segments`` splits it into per-slice rows (views of a
full-width stack, rebased copies of a narrower one; rows with zero
count are dropped).

A segment may also be a compressed ``ops.containers.Container`` (array,
run or dense, with its host-known count) served by the fragment's
container tier (ref: pilosa_tpu bitmap.py:1-18). Algebra goes through
``bitops.dispatch_pair`` and counts through ``bitops.dispatch_count``, so
compressed operands take their registered cells and any other pair
densifies; ``columns()``, ``host_words``, ``device_words`` and merging
densify with ``bitops.densify``.
"""
import numpy as np
import torch

from pilosa_tpu_torch import SLICE_WIDTH, WORD_BITS, WORDS_PER_SLICE
from pilosa_tpu_torch.ops import bitops

# Set bits per pass of ``columns()``: a pass's int32[n, 32] bit matrix
# has one row per nonzero word, and a pass holds at most this many bits
# plus one row's, so the matrix stays near 1 GiB.
_BITS_PER_PASS = 1 << 23
# Segments stacked at a time when a result is held as per-slice segments.
_SEGMENTS_PER_GROUP = 1024


def _seg_count(seg):
    """A segment's cardinality: host-known for a container, a device
    popcount for raw words."""
    if getattr(seg, "fmt", None) is not None:
        return seg.count
    return int(bitops.count(seg))


def _stack_columns(stack, slice_ids, counts, word_base=0):
    """Absolute column ids of the set bits of ``int32[R, W]`` rows, row i
    being slice ``slice_ids[i]`` with ``counts[i]`` set bits and word 0
    of each row the slice's word ``word_base``, as host ``uint64``;
    ascending when ``slice_ids`` is. Found on the stack's
    device, in passes of consecutive rows cut by their bit counts:
    ``nonzero`` lists a pass's nonzero words in row-major order, their
    32 bits expand to a [n, 32] matrix (``(w >> j) & 1`` reads bit j of
    an int32 word, bit 31 too, since the arithmetic shift only fills
    above it), and a second ``nonzero`` lists the set bits in order;
    only the ids cross to the host."""
    dev = stack.device
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=dev)
    counts = np.asarray(counts, dtype=np.int64)
    start = np.cumsum(counts) - counts
    edges = np.flatnonzero(np.diff(start // _BITS_PER_PASS)) + 1
    bounds = [0, *edges.tolist(), len(counts)]
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if not counts[lo:hi].any():
            continue
        part = stack[lo:hi]
        rw = torch.nonzero(part)
        words = part[rw[:, 0], rw[:, 1]]
        k, j = torch.nonzero((words[:, None] >> shifts) & 1, as_tuple=True)
        base = (torch.tensor(slice_ids[lo:hi], dtype=torch.int64,
                             device=dev) * SLICE_WIDTH + word_base * WORD_BITS)
        cols = base[rw[k, 0]] + rw[k, 1] * WORD_BITS + j
        out.append(cols.cpu().numpy().view(np.uint64))
    if not out:
        return np.empty(0, dtype=np.uint64)
    return np.concatenate(out)


class Bitmap:
    def __init__(self, attrs=None):
        self._segments = {}  # slice -> int32[WORDS_PER_SLICE] tensor
        self.attrs = attrs or {}
        self._count = None   # cached count (ref: bitmap.go:205-238)
        self._stack = None   # deferred (stack, slices, counts, word base)

    @property
    def segments(self):
        """slice -> words map; splits a deferred stack first."""
        if self._stack is not None:
            stack, slice_list, counts, word_base = self._stack
            self._stack = None
            width = stack.shape[-1]
            for i in np.flatnonzero(counts).tolist():
                s, seg = slice_list[i], stack[i]
                if width < WORDS_PER_SLICE:
                    # A window's row, rebased to the full slice so that
                    # segment algebra stays aligned.
                    full = torch.zeros(WORDS_PER_SLICE, dtype=seg.dtype,
                                       device=seg.device)
                    full[word_base:word_base + width] = seg
                    seg = full
                mine = self._segments.get(s)
                self._segments[s] = (seg if mine is None
                                     else bitops.dispatch_pair("or", mine,
                                                               seg))
        return self._segments

    @segments.setter
    def segments(self, value):
        self._segments = value
        self._stack = None
        self.invalidate_count()

    def defer_stack(self, stack, slice_list, counts, word_base=0):
        """Adopt a batched ``int32[S, W]`` result stack and its host
        per-slice counts without splitting it (rows with zero counts are
        dropped when it is split); ``word_base`` is the slice word of
        the stack's word 0 when it is narrower than the slice (ref:
        pilosa_tpu bitmap.py:56-93). Existing content is split first,
        and the new rows merge into it."""
        if self._stack is not None or self._segments:
            _ = self.segments
        self._stack = (stack, list(slice_list), np.asarray(counts),
                       int(word_base))
        self.invalidate_count()

    # ------------------------------------------------------ construction

    @classmethod
    def from_device(cls, slice_num, words32):
        bm = cls()
        bm.segments[slice_num] = words32
        return bm

    @classmethod
    def from_columns(cls, columns, device="cuda"):
        """Build from absolute column ids (wire format: uint64 list,
        internal/public.proto Bitmap.Bits), segments on ``device``."""
        bm = cls()
        columns = np.asarray(columns, dtype=np.uint64)
        slices = columns // np.uint64(SLICE_WIDTH)
        for s in np.unique(slices).tolist():
            cols = (columns[slices == s] % np.uint64(SLICE_WIDTH)).astype(
                np.int64)
            bits = np.zeros(SLICE_WIDTH, dtype=np.uint8)
            bits[cols] = 1
            words = np.packbits(bits, bitorder="little").view(np.int32)
            bm.segments[int(s)] = torch.from_numpy(words).to(device)
        return bm

    # ------------------------------------------------------------- algebra
    # Aligned segment-wise ops (ref: mergeSegmentIterator bitmap.go:426-461);
    # a missing segment is all-zeros.

    def intersect(self, other):
        out = Bitmap()
        for k in self.segments.keys() & other.segments.keys():
            out.segments[k] = bitops.dispatch_pair("and", self.segments[k],
                                                   other.segments[k])
        return out

    def union(self, other):
        return self._either(other, "or")

    def xor(self, other):
        return self._either(other, "xor")

    def _either(self, other, op):
        out = Bitmap()
        for k in self.segments.keys() | other.segments.keys():
            a, b = self.segments.get(k), other.segments.get(k)
            out.segments[k] = (b if a is None else a if b is None
                               else bitops.dispatch_pair(op, a, b))
        return out

    def difference(self, other):
        out = Bitmap()
        for k, a in self.segments.items():
            b = other.segments.get(k)
            out.segments[k] = (a if b is None
                               else bitops.dispatch_pair("andnot", a, b))
        return out

    def op_count(self, op, other):
        """|self OP other| without materialising the result: per-slice
        count kernels, with absent segments resolved by the op's
        identity (missing = all-zeros): ``and`` skips them, ``or``/``xor``
        count the present side, ``andnot`` counts an unopposed left
        side (ref: bitmap.go:139 IntersectionCount). Compressed segments
        take their registered count cells (``bitops.dispatch_count``)."""
        total = 0
        mine, theirs = self.segments, other.segments
        if op == "and":
            for k in mine.keys() & theirs.keys():
                total += int(bitops.dispatch_count("and", mine[k],
                                                   theirs[k]))
            return total
        if op == "andnot":
            for k, a in mine.items():
                b = theirs.get(k)
                total += (_seg_count(a) if b is None
                          else int(bitops.dispatch_count("andnot", a, b)))
            return total
        for k in mine.keys() | theirs.keys():  # or / xor
            a, b = mine.get(k), theirs.get(k)
            if a is None:
                total += _seg_count(b)
            elif b is None:
                total += _seg_count(a)
            else:
                total += int(bitops.dispatch_count(op, a, b))
        return total

    def merge(self, other):
        """Disjoint-slice merge for map/reduce (ref: Bitmap.Merge);
        ``other`` is left intact. An empty target adopts the other's
        deferred stack unsplit — shared, so each stays splittable."""
        if (not self._segments and self._stack is None
                and other._stack is not None):
            self._stack = other._stack
            eager = other._segments
        else:
            eager = other.segments
        for k, words in eager.items():
            mine = self.segments.get(k)
            self.segments[k] = (words if mine is None
                                else bitops.dispatch_pair("or", mine, words))
        self.invalidate_count()
        return self

    # ------------------------------------------------------------- readers

    def device_words(self, slice_num, device):
        """int32[32768] words of one slice on ``device`` (zeros when the
        segment is absent) — the device counterpart of ``host_words``: a
        Src row reaches the TopN kernel without a round trip through the
        host."""
        seg = self.segments.get(slice_num)
        if seg is None:
            return torch.zeros(WORDS_PER_SLICE, dtype=torch.int32,
                               device=device)
        return bitops.densify(seg)

    def host_words(self, slice_num):
        """uint64[16384] host copy of one segment (zeros when absent)."""
        seg = self.segments.get(slice_num)
        if seg is None:
            return np.zeros(SLICE_WIDTH // 64, dtype=np.uint64)
        return bitops.densify(seg).cpu().numpy().copy().view(np.uint64)

    def count(self):
        if self._count is None:
            if self._stack is not None and not self._segments:
                self._count = int(self._stack[2].sum(dtype=np.int64))
            else:
                self._count = sum(_seg_count(w)
                                  for w in self.segments.values())
        return self._count

    def invalidate_count(self):
        self._count = None

    def columns(self):
        """Absolute column ids, ascending, as ``uint64`` (wire
        serialization), found on the device: a deferred stack is
        searched whole with its counts, segments in stacked groups
        counted by ``count_rows``."""
        if self._stack is not None and not self._segments:
            stack, slice_list, counts, word_base = self._stack
            if all(a < b for a, b in zip(slice_list, slice_list[1:])):
                return _stack_columns(stack, slice_list, counts, word_base)
        segs = self.segments
        keys = sorted(segs)
        out = []
        for lo in range(0, len(keys), _SEGMENTS_PER_GROUP):
            group = keys[lo:lo + _SEGMENTS_PER_GROUP]
            stack = torch.stack([bitops.densify(segs[k]) for k in group])
            out.append(_stack_columns(
                stack, group, bitops.count_rows(stack).cpu().numpy()))
        if not out:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(out)

    def __eq__(self, other):
        if not isinstance(other, Bitmap):
            return NotImplemented
        return np.array_equal(self.columns(), other.columns())
