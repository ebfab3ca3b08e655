"""Compressed row blocks — the roaring container tier (counterpart of
pilosa_tpu/ops/containers.py).

The reference never materialises a sparse bitmap densely: a block with at
most 4,096 set bits is a sorted position ARRAY, long runs collapse to
(start, end) RUN pairs, and only dense data pays the bitmap
(roaring.go:1011-1024). Here a block is one row of one slice:

- **array** — sorted ``int32`` bit positions. Its count is its length.
- **run** — sorted disjoint half-open (start, end) bit ranges. Its count is
  the summed lengths.
- **dense** — the ``int32`` word row a fragment already mirrors on its
  device, wrapped with its host-known count. Dense × dense is the existing
  ``count_op_rows`` path.

Every (op, format, format) count reduces to one intersection and host
integers: |a ∪ b| = |a| + |b| − |a ∩ b|, |a ⊕ b| = |a| + |b| − 2|a ∩ b|,
|a \\ b| = |a| − |a ∩ b| (the reference's count-only paths,
roaring.go:1811-1923). The intersections run in one hand-written kernel,
``kernels.container_and_counts`` (``csrc/containers.cu``), whose input is
packed: each side's members concatenated with int32 offsets. A serial
count is a launch of one member; the lanes launch once per format cell
over whole rows (``RowLane``, each row packed once), for a lone
two-operand Count as for a coalesced group, reading the rows' packed
sides in place through a table of member indices. Run × run stays on the
host, as in the reference.
Tensors on the CPU take the kernel's plain version, so a ``cpu`` holder
runs the card's lane code.

``PILOSA_CONTAINER_FORMATS`` (read at import; default on) turns the tier
off: every block is then served dense, as before the tier.
"""
import os
import threading
import typing
import weakref

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitops, kernels

# Roaring thresholds (roaring.go:40-42): a block of at most 4,096 set bits
# is cheaper as positions than as a bitmap; a block of few runs, as runs.
ARRAY_MAX_BITS = 4096
RUN_MAX_RUNS = 2048


def parse_enabled(value):
    """The truthiness rule of PILOSA_CONTAINER_FORMATS-style strings."""
    return str(value).lower() not in ("0", "false", "no", "off")


_ENABLED = parse_enabled(os.environ.get("PILOSA_CONTAINER_FORMATS", ""))

# Process-wide conversions (a block served in another format than at its
# previous version, or densified by a coalesced group).
_conv_mu = threading.Lock()
_conversions_total = 0


def set_enabled(on):
    global _ENABLED
    _ENABLED = bool(on)


def enabled():
    return _ENABLED


def note_conversion(n=1):
    global _conversions_total
    with _conv_mu:
        _conversions_total += n


def conversions_total():
    return _conversions_total


class Container:
    """One row block in one format. ``count`` is host-known at
    construction, so a cardinality costs no device work in any format.
    ``device`` is where its device tensors live (the fragment's)."""

    __slots__ = ("fmt", "width32", "count", "words", "positions", "runs",
                 "device", "_pos_dev", "_runs_dev", "_offs_dev")

    def __init__(self, fmt, width32, count, words=None, positions=None,
                 runs=None, device="cuda"):
        self.fmt = fmt
        self.width32 = int(width32)
        self.count = int(count)
        self.words = words          # dense: int32[width32] on the device
        self.positions = positions  # array: np.int32[count] sorted, host
        self.runs = runs            # run: np.int32[n_runs, 2], host
        self.device = torch.device(words.device if words is not None
                                   else device)
        self._pos_dev = None
        self._runs_dev = None
        self._offs_dev = None

    # ------------------------------------------------------------ payload

    def nbytes(self):
        """Payload bytes in this format (the host payload; its device
        copy is what serves)."""
        if self.fmt == bitops.FMT_ARRAY:
            return int(self.positions.nbytes)
        if self.fmt == bitops.FMT_RUN:
            return int(self.runs.nbytes)
        return int(self.words.numel() * 4 if self.words is not None
                   else self.width32 * 4)

    def dense_equiv_bytes(self):
        """What the dense tier would hold for this block."""
        return self.width32 * 4

    def device_positions(self):
        """Sorted int32 positions on the device, padded to a power of two
        with the sentinel ``limit`` (pad_positions); memoized. The kernel
        reads only the first ``count``."""
        if self._pos_dev is None:
            self._pos_dev = torch.from_numpy(pad_positions(
                self.positions, self.width32 * 32)).to(self.device)
        return self._pos_dev

    def device_runs(self):
        """(starts, ends) int32 on the device, padded to a power of two
        with empty [limit, limit) runs (pad_runs); memoized."""
        if self._runs_dev is None:
            s, e = pad_runs(self.runs, self.width32 * 32)
            both = torch.from_numpy(np.concatenate([s, e])).to(self.device)
            self._runs_dev = (both[:len(s)], both[len(s):])
        return self._runs_dev

    def device_offs(self):
        """int32 [0, n] on the device: this block as one packed member
        (n positions or runs)."""
        if self._offs_dev is None:
            n = self.count if self.fmt == bitops.FMT_ARRAY else len(self.runs)
            self._offs_dev = torch.tensor([0, n], dtype=torch.int32,
                                          device=self.device)
        return self._offs_dev

    def dense_words(self):
        """Dense int32[width32] words on the device (bitops.densify).
        Not memoized: a dense copy per compressed block would pin the
        dense tier's bytes this tier removes (ref: pilosa_tpu
        containers.py:165-178)."""
        if self.fmt == bitops.FMT_DENSE:
            return self.words
        if self.fmt == bitops.FMT_ARRAY:
            return _array_to_dense(self.device_positions(), self.width32)
        s, e = self.device_runs()
        return run_mask(s, e, self.width32)

    def device_bytes(self):
        """Device bytes of the memoized payload tensors; a dense block's
        words are its fragment's mirror, charged there."""
        if self.fmt == bitops.FMT_DENSE:
            return 0
        total = 0
        for buf in (self._pos_dev, self._offs_dev):
            if buf is not None:
                total += buf.numel() * 4
        if self._runs_dev is not None:
            total += 4 * (self._runs_dev[0].numel()
                          + self._runs_dev[1].numel())
        return total

    def host_words64(self):
        """Host uint64[width32 // 2] words (tests and tools)."""
        if self.fmt == bitops.FMT_DENSE:
            return self.words.cpu().numpy().view(np.uint64)
        out = np.zeros(self.width32, dtype=np.uint32)
        if self.fmt == bitops.FMT_ARRAY:
            p = self.positions.astype(np.int64)
            np.bitwise_or.at(out, p >> 5,
                             np.uint32(1) << (p & 31).astype(np.uint32))
            return out.view(np.uint64)
        bits = np.zeros(self.width32 * 32, dtype=np.uint8)
        for s, e in self.runs.tolist():
            bits[s:e] = 1
        return np.packbits(bits, bitorder="little").view(np.uint64)


# --------------------------------------------------------- construction

def _run_starts(x):
    """The bits of uint64 words ``x`` that start a run (set, with the
    previous bit clear; carries cross word boundaries)."""
    prev_carry = np.zeros_like(x)
    prev_carry[1:] = x[:-1] >> np.uint64(63)
    return x & ~((x << np.uint64(1)) | prev_carry)


def run_bounds(words64):
    """(starts, ends) int32 of the set runs of host uint64 words, one
    vectorized pass."""
    x = np.ascontiguousarray(words64, dtype=np.uint64)
    if not len(x):
        return (np.zeros(0, np.int32),) * 2
    start_mask = _run_starts(x)
    next_carry = np.zeros_like(x)
    next_carry[:-1] = (x[1:] & np.uint64(1)) << np.uint64(63)
    end_mask = x & ~((x >> np.uint64(1)) | next_carry)
    starts = extract_positions(start_mask)
    ends = extract_positions(end_mask) + 1
    return starts.astype(np.int32), ends.astype(np.int32)


def extract_positions(words64):
    """Sorted set-bit positions (int64) of host uint64 words; only the
    nonzero words are unpacked."""
    x = np.ascontiguousarray(words64, dtype=np.uint64)
    nz = np.flatnonzero(x)
    if not len(nz):
        return np.zeros(0, np.int64)
    bits = np.unpackbits(x[nz].view(np.uint8), bitorder="little")
    k = np.flatnonzero(bits)
    return nz[k >> 6].astype(np.int64) * 64 + (k & 63)


def choose_format(count, n_runs):
    """The roaring rule: run when two ints a run undercut both the
    positions and the words; else array at <= 4,096 bits; else dense."""
    if count == 0:
        return bitops.FMT_ARRAY
    if n_runs <= RUN_MAX_RUNS and 2 * n_runs < min(count,
                                                   ARRAY_MAX_BITS + 1):
        return bitops.FMT_RUN
    if count <= ARRAY_MAX_BITS:
        return bitops.FMT_ARRAY
    return bitops.FMT_DENSE


def build_container(words64, width32, dense_words=None, count=None,
                    offset=0, dense_fn=None, device="cuda"):
    """Classify and build one row block from host uint64 words.
    ``words64`` may be a window of the block: ``offset`` rebases
    positions and runs to block bits; ``count`` and ``dense_fn`` (or an
    existing ``dense_words`` row) let the fragment supply its known
    cardinality and device row instead of deriving them."""
    words64 = np.ascontiguousarray(words64, dtype=np.uint64)
    if count is None:
        count = int(np.bitwise_count(words64).sum())
    cnt = int(count)
    if cnt == 0:
        return empty_container(width32, device)
    # The format needs only the number of runs; their bounds are
    # extracted for a run container alone.
    n_runs = (int(np.bitwise_count(_run_starts(words64)).sum())
              if len(words64) else 0)
    fmt = choose_format(cnt, n_runs)
    if fmt == bitops.FMT_RUN:
        runs = np.stack(run_bounds(words64), axis=1)
        if offset:
            runs = runs + np.int32(offset)
        return Container(bitops.FMT_RUN, width32, cnt, runs=runs,
                         device=device)
    if fmt == bitops.FMT_ARRAY:
        pos = (extract_positions(words64) + offset).astype(np.int32)
        return Container(bitops.FMT_ARRAY, width32, cnt, positions=pos,
                         device=device)
    if dense_fn is not None:
        return dense_container(dense_fn(), width32, cnt)
    if dense_words is None:
        dense_words = torch.from_numpy(words64.view(np.int32).copy()).to(
            device)
    return Container(bitops.FMT_DENSE, width32, cnt, words=dense_words)


def dense_container(words32, width32, count):
    """Wrap an existing dense device row with its known count."""
    return Container(bitops.FMT_DENSE, width32, count, words=words32)


def as_container(x, need_count=True):
    """Any operand as a Container: a raw dense tensor wraps with a
    device popcount for the identities that need |x| (not for ``and``)."""
    if isinstance(x, Container):
        return x
    cnt = int(bitops.count(x)) if need_count else 0
    return Container(bitops.FMT_DENSE, int(x.shape[-1]), cnt, words=x)


def empty_container(width32, device="cuda"):
    return Container(bitops.FMT_ARRAY, width32, 0,
                     positions=np.zeros(0, np.int32), device=device)


def _pad_pow2(n, floor=16):
    p = floor
    while p < n:
        p *= 2
    return p


def pad_positions(positions, limit):
    """Positions padded to a power of two with ``limit`` (every real
    position is below it, so order holds)."""
    n = len(positions)
    out = np.full(_pad_pow2(max(n, 1)), limit, dtype=np.int32)
    out[:n] = positions
    return out


def pad_runs(runs, limit):
    """(starts, ends) padded to a power of two with empty [limit, limit)
    runs, sorted after every real start and covering no bit."""
    n = len(runs)
    p = _pad_pow2(max(n, 1))
    starts = np.full(p, limit, dtype=np.int32)
    ends = np.full(p, limit, dtype=np.int32)
    if n:
        starts[:n] = runs[:, 0]
        ends[:n] = runs[:, 1]
    return starts, ends


# ---------------------------------------------------------- serial cells
# One member each, through the lane kernel: ``offs`` is the member's
# int32 [0, n] on the device (n positions or runs). Positions and runs may
# carry the pad_* sentinels past n; the kernel reads the first n items.

def _one(cell, a, b):
    return int(kernels.container_and_counts(cell, a, b)[0])


def count_array_dense(pos, offs, words):
    """|array ∩ dense|: one gathered word and one bit test a position
    (ref: intersectArrayBitmap, roaring.go:1862-1878)."""
    return _one("array_dense", (pos, offs), [words])


def count_array_array(pos_a, offs_a, pos_b, offs_b):
    """|array ∩ array|: each position of a searched in b (ref:
    intersectArrayArray, roaring.go:1811-1830)."""
    return _one("array_array", (pos_a, offs_a), (pos_b, offs_b))


def count_array_run(pos, offs, starts, ends, run_offs):
    """|array ∩ run|: the last run starting at or before each position
    covers it or none does (ref: intersectArrayRun, roaring.go:1832-1860)."""
    return _one("array_run", (pos, offs), (starts, ends, run_offs))


def count_run_dense(starts, ends, run_offs, words):
    """|run ∩ dense|: the popcount of the words each run covers, its edge
    words masked (ref: intersectBitmapRun, roaring.go:1880-1904)."""
    return _one("run_dense", (starts, ends, run_offs), [words])


def run_mask(starts, ends, n_words):
    """int32[n_words] words covering every run of sorted disjoint runs
    (padding runs are empty): each bit's membership by one boundary
    search, packed 32 bits a word."""
    dev = starts.device
    pos = torch.arange(n_words * 32, dtype=torch.int32, device=dev)
    idx = (torch.searchsorted(starts, pos, right=True) - 1).clamp(
        0, max(starts.shape[0] - 1, 0))
    inside = (pos >= starts[idx]) & (pos < ends[idx])
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    words = (inside.view(n_words, 32).to(torch.int64) * weights).sum(dim=1)
    return _fold32(words)


def _fold32(words):
    """int64 values in [0, 2^32) as the int32 words of the same bits."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(
        torch.int32)


def _array_to_dense(pos, width32):
    """Sorted positions scattered into int32[width32] words. Positions are
    distinct, so per-word adds of their bits equal ORs; the int64 sums
    fold to 32-bit words (bit 31 included). Sentinels (>= the limit) add
    nothing."""
    valid = pos < width32 * 32
    p = pos.to(torch.int64)
    word = torch.where(valid, p >> 5, torch.zeros_like(p))
    bit = torch.where(valid, torch.ones_like(p) << (p & 31),
                      torch.zeros_like(p))
    acc = torch.zeros(width32, dtype=torch.int64, device=pos.device)
    acc.index_add_(0, word, bit)
    return _fold32(acc)


def count_run_run(runs_a, runs_b):
    """|run ∩ run| on the host: for a run [s, e) of a, the b runs that
    overlap it are a contiguous window whose first run may stick out left
    of s and last right of e, so the overlap is the window's summed length
    less the two edge clips (ref: intersectRunRun, roaring.go:1906-1923)."""
    if not len(runs_a) or not len(runs_b):
        return 0
    a_s = runs_a[:, 0].astype(np.int64)
    a_e = runs_a[:, 1].astype(np.int64)
    b_s = runs_b[:, 0].astype(np.int64)
    b_e = runs_b[:, 1].astype(np.int64)
    pref = np.concatenate(([0], np.cumsum(b_e - b_s)))
    lo = np.searchsorted(b_e, a_s, side="right")
    hi = np.searchsorted(b_s, a_e, side="left")
    has = lo < hi
    if not has.any():
        return 0
    lo_h, hi_h = lo[has], hi[has]
    inner = pref[hi_h] - pref[lo_h]
    inner -= np.maximum(0, a_s[has] - b_s[lo_h])
    inner -= np.maximum(0, b_e[hi_h - 1] - a_e[has])
    return int(inner.sum())


# ------------------------------------------------------------ the lanes
# A row's blocks over a slice list are packed once by format (a RowLane);
# a set of (row, row) pairs then counts in one kernel launch per format
# cell, which reads the rows' packed sides where they lie through a table
# of member indices (ref: the
# vmapped lanes of pilosa_tpu containers.py:568-656, which pad every
# member to a power of two for XLA's static shapes and are fed member by
# member).

def _pack(parts, device):
    """(payload, offsets) int32 tensors on ``device`` for the members'
    host arrays ``parts``, views of one uploaded buffer."""
    n = len(parts)
    sizes = np.fromiter((len(p) for p in parts), dtype=np.int64, count=n)
    buf = np.empty(n + 1 + int(sizes.sum()), dtype=np.int32)
    buf[0] = 0
    if n:
        np.cumsum(sizes, out=buf[1:n + 1])
        np.concatenate(parts, out=buf[n + 1:], casting="unsafe")
    t = torch.from_numpy(buf).to(device)
    return t[n + 1:], t[:n + 1]


def stack_positions(conts):
    """The ARRAY members' positions packed: (int32 positions, int32
    offsets[N + 1]) on their device."""
    return _pack([c.positions for c in conts], conts[0].device)


def stack_runs(conts):
    """The RUN members' runs packed: (int32 starts, int32 ends, int32
    offsets[N + 1]) on their device, starts and ends from one upload."""
    n = len(conts)
    runs = [c.runs for c in conts]
    sizes = np.fromiter((len(r) for r in runs), dtype=np.int64, count=n)
    total = int(sizes.sum())
    buf = np.empty(n + 1 + 2 * total, dtype=np.int32)
    buf[0] = 0
    if n:
        np.cumsum(sizes, out=buf[1:n + 1])
    if total:
        both = np.concatenate(runs)
        buf[n + 1:n + 1 + total] = both[:, 0]
        buf[n + 1 + total:] = both[:, 1]
    t = torch.from_numpy(buf).to(conts[0].device)
    return t[n + 1:n + 1 + total], t[n + 1 + total:], t[:n + 1]


# A RowLane's per-slice block codes (0: no fragment, or an empty block).
LANE_ARRAY, LANE_RUN, LANE_DENSE = 1, 2, 3
_LANE_CODES = {bitops.FMT_ARRAY: LANE_ARRAY, bitops.FMT_RUN: LANE_RUN,
               bitops.FMT_DENSE: LANE_DENSE}
_LANE_PACK = {LANE_ARRAY: stack_positions, LANE_RUN: stack_runs}


class RowLane:
    """One row's blocks over a slice list, ready for the lanes: each
    slice's block code (``codes``), the row's count, and its array and
    run blocks packed on their device in slice order, once. ``member``
    gives each slice's index in its format's packed side (-1: none), so
    a lane names a subset of the row's slices by member indices and
    never repacks it. ``conts`` holds the blocks (None for an absent
    fragment); ``nbytes`` their payload plus the packed copies. Pairs
    keep their member tables on the left row (``pair_rows``)."""

    # Partners whose member tables a row keeps; past them it forgets all.
    MAX_PAIRS = 64

    def __init__(self, conts):
        self.conts = conts
        codes = np.zeros(len(conts), np.int8)
        for i, c in enumerate(conts):
            if c is not None and c.count:
                codes[i] = _LANE_CODES[c.fmt]
        self.codes = codes
        self.member = np.full(len(conts), -1, np.int32)
        self.count = sum(c.count for c in conts if c is not None)
        self.packed = {}
        self.nbytes = sum(c.nbytes() for c in conts if c is not None)
        for code, pack in _LANE_PACK.items():
            at = np.flatnonzero(codes == code)
            if len(at):
                self.member[at] = np.arange(len(at), dtype=np.int32)
                side = self.packed[code] = pack([conts[i] for i in at])
                self.nbytes += sum(t.nbytes for t in side)
        self._pairs = weakref.WeakKeyDictionary()
        self._pairs_mu = threading.Lock()

    def pair_rows(self, other):
        """This row's lanes against ``other``: ``([(cell, swap, table)],
        rest)`` — for each kernel cell its member table on the rows'
        device (int32 [n, 4] of views of one upload; side columns 0, so
        it is the table of a launch over this pair alone; ``swap``:
        ``other`` is the cell's left side), and the intersections of the
        slices no cell takes (run × run on the host, a dense block
        through its serial cell). Both rows are immutable, so the answer
        is kept while ``other`` lives."""
        with self._pairs_mu:
            hit = self._pairs.get(other)
        if hit is not None:
            return hit
        cells, parts, dev = [], [], None
        taken = np.zeros(len(self.codes), bool)
        for cell, ca, cb, swap in _LANE_CELLS:
            x, y = (other, self) if swap else (self, other)
            both = (x.codes == ca) & (y.codes == cb)
            at = np.flatnonzero(both)
            if len(at):
                rows = np.zeros((len(at), 4), np.int32)
                rows[:, 1] = x.member[at]
                rows[:, 3] = y.member[at]
                cells.append((cell, swap))
                parts.append(rows)
                taken |= both
                dev = x.packed[ca][0].device
        rest = 0
        for i in np.flatnonzero((self.codes > 0) & (other.codes > 0)
                                & ~taken):
            rest += int(bitops.dispatch_count("and", self.conts[i],
                                              other.conts[i]))
        tables = []
        if parts:
            up = torch.from_numpy(np.concatenate(parts)).to(dev)
            tables = torch.split(up, [len(r) for r in parts])
        out = ([(cell, swap, t) for (cell, swap), t in zip(cells, tables)],
               rest)
        with self._pairs_mu:
            if len(self._pairs) >= self.MAX_PAIRS:
                self._pairs.clear()
            self._pairs[other] = out
        return out


# The kernel's cells over two rows' block codes: (cell, code of the
# kernel's left side, of its right side, whether the pair's right row is
# the left side).
_LANE_CELLS = (("array_array", LANE_ARRAY, LANE_ARRAY, False),
               ("array_run", LANE_ARRAY, LANE_RUN, False),
               ("array_run", LANE_ARRAY, LANE_RUN, True))
_CELL_CODES = {cell: (ca, cb) for cell, ca, cb, _ in _LANE_CELLS}


class LaneCell(typing.NamedTuple):
    """One launch of a lane round: the cell, its distinct sides (the
    RowLanes' packed sides themselves), the member table on the sides'
    device, and whose members they are: the position of the one pair
    (an int), or each member's pair (an int64 tensor on the device)."""
    cell: str
    a_sides: list
    b_sides: list
    members: torch.Tensor
    owners: typing.Union[int, torch.Tensor]

    @property
    def n(self):
        return len(self.members)


def lane_cells(pairs):
    """The lanes of (RowLane, RowLane) pairs over one slice list:
    ``([LaneCell], rest)`` — a launch per kernel cell for all the pairs,
    reading each row's packed sides where they lie through a member
    table, and np.int64[len(pairs)] intersections of the members no
    kernel cell takes. When each cell holds one pair's kept table
    (``pair_rows``; a lone Count) it is launched as it is; else every
    cell's kept tables are joined on the device in one ``torch.cat``,
    each pair's side indices and position set from one upload of a row
    a table. No payload is copied."""
    rest = np.zeros(len(pairs), np.int64)
    by_cell = {}
    for p, (la, lb) in enumerate(pairs):
        cells, rest[p] = la.pair_rows(lb)
        for cell, swap, table in cells:
            x, y = (lb, la) if swap else (la, lb)
            ca, cb = _CELL_CODES[cell]
            sides_a, sides_b, cols, parts = by_cell.setdefault(
                cell, ({}, {}, [], []))
            sa, sb = x.packed[ca], y.packed[cb]
            cols.append((sides_a.setdefault(id(sa), (len(sides_a), sa))[0],
                         sides_b.setdefault(id(sb), (len(sides_b), sb))[0],
                         p, len(table)))
            parts.append(table)
    groups = list(by_cell.items())
    sides = [([s for _, s in sa.values()], [s for _, s in sb.values()])
             for _, (sa, sb, _, _) in groups]
    if all(len(g[3]) == 1 for _, g in groups):
        return [LaneCell(cell, a, b, g[3][0], g[2][0][2])
                for (cell, g), (a, b) in zip(groups, sides)], rest
    parts = [t for _, g in groups for t in g[3]]
    col = torch.from_numpy(np.asarray(
        [c for _, g in groups for c in g[2]], np.int64)).to(parts[0].device)
    members = torch.cat(parts)
    each = torch.repeat_interleave(col[:, :3], col[:, 3], dim=0,
                                   output_size=len(members))
    members[:, 0::2] = each[:, :2]
    out, at = [], 0
    for (cell, g), (a, b) in zip(groups, sides):
        n = sum(len(t) for t in g[3])
        out.append(LaneCell(cell, a, b, members[at:at + n],
                            each[at:at + n, 2]))
        at += n
    return out, rest


def lane_and_counts(pairs):
    """(np.int64[len(pairs)] of Σ|a ∩ b| over the slices of each
    (RowLane, RowLane) pair, kernel launches): one launch of
    ``container_and_counts`` per format cell for all the pairs, the
    members summed by pair on their device (int64), one copy of the
    sums to the host."""
    cells, inter = lane_cells(pairs)
    if not cells:
        return inter, 0
    ones, sums = [], []
    for c in cells:
        got = kernels.container_and_counts(c.cell, c.a_sides, c.b_sides,
                                           c.members)
        if isinstance(c.owners, int):
            ones.append(c.owners)
            sums.append(got.sum(dtype=torch.int64).reshape(1))
        else:
            sums.append(torch.zeros(len(pairs), dtype=torch.int64,
                                    device=got.device).index_add_(
                0, c.owners, got.to(torch.int64)))
    host = (sums[0] if len(sums) == 1 else torch.cat(sums)).cpu().numpy()
    np.add.at(inter, ones, host[:len(ones)])
    inter += host[len(ones):].reshape(-1, len(pairs)).sum(axis=0)
    return inter, len(cells)


def count_identity(op, inter, ca, cb):
    """|a OP b| from |a ∩ b| and the cardinalities (exact for two
    operands)."""
    if op == "and":
        return inter
    if op == "or":
        return ca + cb - inter
    if op == "xor":
        return ca + cb - 2 * inter
    return ca - inter  # andnot


# ---------------------------------------------------- dispatch registry
# or / xor / andnot derive from |a ∩ b| and the host-known cardinalities,
# so one intersection cell per format pair covers the op row. Dense ×
# dense serial is not registered: bitops keeps the dense count.

def _and_count(a, b):
    """|a ∩ b| of two containers: one launch of one member over their
    memoized device payloads."""
    fa, fb = a.fmt, b.fmt
    A, R, D = bitops.FMT_ARRAY, bitops.FMT_RUN, bitops.FMT_DENSE
    if fa == D and fb != D or fa == R and fb == A:
        return _and_count(b, a)
    if fa == A and not a.count or fb == A and not b.count:
        return 0
    if fa == A and fb == A:
        return count_array_array(a.device_positions(), a.device_offs(),
                                 b.device_positions(), b.device_offs())
    if fa == A and fb == R:
        return count_array_run(a.device_positions(), a.device_offs(),
                               *b.device_runs(), b.device_offs())
    if fa == A and fb == D:
        return count_array_dense(a.device_positions(), a.device_offs(),
                                 b.dense_words())
    if fa == R and fb == D:
        return count_run_dense(*a.device_runs(), a.device_offs(),
                               b.dense_words())
    if fa == R and fb == R:
        return count_run_run(a.runs, b.runs)
    raise TypeError(f"no and-count cell for {fa}x{fb}")


def _count_cell(op):
    def cell(a, b):
        need = op != "and"  # |a ∩ b| alone needs no cardinality
        a, b = as_container(a, need), as_container(b, need)
        return count_identity(op, _and_count(a, b), a.count, b.count)
    return cell


def _register():
    fmts = (bitops.FMT_ARRAY, bitops.FMT_RUN, bitops.FMT_DENSE)
    for op in ("and", "or", "xor", "andnot"):
        cell = _count_cell(op)
        for fa in fmts:
            for fb in fmts:
                if fa != bitops.FMT_DENSE or fb != bitops.FMT_DENSE:
                    bitops.register_count_kernel(op, fa, fb, cell)


_register()
