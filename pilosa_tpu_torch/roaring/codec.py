"""Reference-compatible roaring bitmap file codec over dense blocks
(numpy only; the same format ``pilosa_tpu.roaring.codec`` reads and
writes, byte for byte).

File layout (roaring/roaring.go:560-738):

- cookie  u32 LE  = magic 12348 | version(0) << 16
- count   u32 LE  = number of non-empty containers
- per container, 12 bytes: key u64, type u16, cardinality-1 u16
- per container, offset u32 into the file
- container blocks:
    array  : n × u16 LE sorted low-bits
    bitmap : 1024 × u64 LE (65,536 bits)
    run    : runCount u16 + runCount × (start u16, last u16)
- trailing op log: 13-byte records {typ u8, value u64 LE,
  fnv1a-32 checksum of first 9 bytes} applied on load (:2826-2890)

In-memory unit is a dense block: ``np.uint64[1024]`` per container key
(key = bit-position >> 16). Container types exist only in the file.
"""
import struct

import numpy as np

MAGIC = 12348
STORAGE_VERSION = 0
COOKIE = MAGIC | (STORAGE_VERSION << 16)

ARRAY_MAX_SIZE = 4096   # ref: roaring.go:1000
RUN_MAX_SIZE = 2048     # ref: roaring.go:1003
BITMAP_N = 1024         # u64 words per container
_CONTAINERS_PER_ROW = 16  # a row is one 2^20-column slice: key = row·16 + sub

TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

OP_ADD = 0
OP_REMOVE = 1
OP_SIZE = 13

_BLOCK_BYTES = BITMAP_N * 8
_META_DT = np.dtype([("key", "<u8"), ("ctype", "<u2"), ("n1", "<u2")])


def _fnv32a(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def op_record(typ: int, value: int) -> bytes:
    """Encode one op-log record (ref: op.WriteTo roaring.go:2852-2867)."""
    body = struct.pack("<BQ", typ, value)
    return body + struct.pack("<I", _fnv32a(body))


def op_records(typs, values) -> bytes:
    """Batch-encode op-log records: the FNV-1a fold runs as 9
    vectorized rounds across all records (uint32 multiply wraps mod
    2^32, matching _fnv32a)."""
    typs = np.asarray(typs, dtype=np.uint8)
    values = np.asarray(values, dtype="<u8")
    n = len(typs)
    rec = np.empty((n, OP_SIZE), dtype=np.uint8)
    rec[:, 0] = typs
    rec[:, 1:9] = values.view(np.uint8).reshape(n, 8)
    h = np.full(n, 2166136261, dtype=np.uint32)
    for i in range(9):
        h = (h ^ rec[:, i]) * np.uint32(16777619)
    rec[:, 9:13] = h.astype("<u4").view(np.uint8).reshape(n, 4)
    return rec.tobytes()


def read_ops(buf: bytes, strict: bool = True):
    """Yield (typ, value) from an op-log byte region, verifying checksums
    (ref: op.UnmarshalBinary roaring.go:2870-2887). With ``strict=False``
    a torn tail (partial record or checksum mismatch from a crash
    mid-append) stops iteration instead of raising."""
    off = 0
    while off < len(buf):
        if len(buf) - off < OP_SIZE:
            if strict:
                raise ValueError("op data out of bounds")
            return
        body = buf[off : off + 9]
        (chk,) = struct.unpack_from("<I", buf, off + 9)
        if chk != _fnv32a(body):
            if strict:
                raise ValueError("op checksum mismatch")
            return
        typ, value = struct.unpack("<BQ", body)
        if typ not in (OP_ADD, OP_REMOVE):
            if strict:
                raise ValueError(f"invalid op type: {typ}")
            return
        yield typ, value
        off += OP_SIZE


def parse_ops(buf):
    """Vectorized op-region parse: (typs uint8[n], values uint64[n],
    torn bool) — the same records ``read_ops(buf, strict=False)``
    yields, in one numpy pass."""
    n = len(buf) // OP_SIZE
    if n == 0:
        return (np.empty(0, np.uint8), np.empty(0, np.uint64),
                len(buf) != 0)
    rec = np.frombuffer(buf, dtype=np.uint8,
                        count=n * OP_SIZE).reshape(n, OP_SIZE)
    typs = rec[:, 0]
    values = np.ascontiguousarray(rec[:, 1:9]).view("<u8").ravel()
    chks = np.ascontiguousarray(rec[:, 9:13]).view("<u4").ravel()
    h = np.full(n, 2166136261, dtype=np.uint32)
    for i in range(9):
        h = (h ^ rec[:, i]) * np.uint32(16777619)
    valid = (chks == h) & ((typs == OP_ADD) | (typs == OP_REMOVE))
    torn = n * OP_SIZE != len(buf)
    bad = np.flatnonzero(~valid)
    if bad.size:
        k = int(bad[0])
        typs, values = typs[:k], values[:k]
        torn = True
    return typs.astype(np.uint8, copy=True), values.astype(np.uint64), torn


def group_sorted(keys):
    """Stable group-by for int arrays: (order, starts, ends, uniq)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.flatnonzero(np.concatenate(([True], ks[1:] != ks[:-1])))
    ends = np.append(starts[1:], len(ks))
    return order, starts, ends, ks[starts]


def final_ops(typs, values):
    """Collapse an ordered op sequence to its net effect (the LAST op
    on each bit wins): (add_values, remove_values), disjoint."""
    if len(values) == 0:
        e = np.empty(0, np.uint64)
        return e, e
    uvals, first_rev = np.unique(values[::-1], return_index=True)
    last_typ = typs[len(values) - 1 - first_rev]
    return uvals[last_typ == OP_ADD], uvals[last_typ == OP_REMOVE]


def popcount64(words):
    """Per-word set bits of a uint64 array (np.bitwise_count where numpy
    has it, else a byte table)."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words)
    table = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    return table[words.view(np.uint8)].reshape(
        words.shape + (8,)).sum(axis=-1, dtype=np.uint8)


def _positions_to_block(pos: np.ndarray) -> np.ndarray:
    if len(pos) < BITMAP_N:  # sparse: scatter into the words directly
        block = np.zeros(BITMAP_N, dtype=np.uint64)
        p = pos.astype(np.int64)
        np.bitwise_or.at(block, p >> 6,
                         np.left_shift(np.uint64(1),
                                       (p & 63).astype(np.uint64)))
        return block
    bits = np.zeros(BITMAP_N * 64, dtype=np.uint8)
    bits[pos] = 1
    return np.packbits(bits, bitorder="little").view(np.uint64)


def _u16_at(buf, idx):
    """Little-endian u16 values at byte offsets ``idx`` of a uint8 view
    (offsets need not be even)."""
    return buf[idx].astype(np.uint16) | (buf[idx + 1].astype(np.uint16) << 8)


# Bytes of unpacked bits handled per pass of the vectorized encoder and
# decoder: bounds their temporaries whatever the container count.
_PASS_BYTES = 1 << 26


def serialize_arrays(keys, blocks) -> bytes:
    """Encode (uint64[n] sorted keys, uint64[n, w] dense blocks, w <=
    1024) -> roaring file bytes. A NARROW block (w < 1024, the words of
    a container-aligned column window) holds the container's first w
    words, the rest zero. Empty blocks are dropped. The container type
    follows ``Optimize()`` (roaring.go:1311-1355): the smallest of run
    (at most 2048 runs), array (at most 4096 values) and bitmap, ties
    preferring run, then array. Cardinalities, run counts, types and
    the array and run payloads come from vectorized passes over all
    blocks, so a fragment of 500,000 small rows encodes without a
    per-container Python step."""
    keys = np.asarray(keys, dtype=np.uint64)
    blocks = np.ascontiguousarray(blocks, dtype=np.uint64)
    if blocks.ndim == 1 or not len(keys):
        blocks = blocks.reshape(len(keys), BITMAP_N)
    w = blocks.shape[1]
    if w > BITMAP_N:
        raise ValueError(f"block width {w} exceeds {BITMAP_N} words")
    cards = popcount64(blocks).sum(axis=1, dtype=np.int64)
    keep = np.flatnonzero(cards)
    keys, blocks, cards = keys[keep], blocks[keep], cards[keep]
    carry = np.zeros_like(blocks)
    carry[:, 1:] = blocks[:, :-1] >> np.uint64(63)
    starts = blocks & ~((blocks << np.uint64(1)) | carry)
    runs = popcount64(starts).sum(axis=1, dtype=np.int64)
    del carry, starts

    big = np.int64(1 << 40)
    run_size = np.where(runs <= RUN_MAX_SIZE, 2 + 4 * runs, big)
    array_size = np.where(cards <= ARRAY_MAX_SIZE, 2 * cards, big)
    is_run = run_size <= np.minimum(array_size, _BLOCK_BYTES)
    is_array = ~is_run & (array_size <= _BLOCK_BYTES)
    n = len(keys)
    ctypes_ = np.full(n, TYPE_BITMAP, dtype=np.uint16)
    ctypes_[is_run] = TYPE_RUN
    ctypes_[is_array] = TYPE_ARRAY
    sizes = np.where(is_run, run_size,
                     np.where(is_array, array_size, _BLOCK_BYTES))

    meta = np.empty(n, dtype=_META_DT)
    meta["key"] = keys
    meta["ctype"] = ctypes_
    meta["n1"] = (cards - 1).astype(np.uint16)
    head = 8 + 16 * n
    offsets = head + np.cumsum(sizes) - sizes
    out = np.zeros(head + int(sizes.sum()), dtype=np.uint8)
    out[:8] = np.frombuffer(struct.pack("<II", COOKIE, n), np.uint8)
    out[8:8 + 12 * n] = meta.view(np.uint8)
    out[8 + 12 * n:head] = offsets.astype("<u4").view(np.uint8)
    out16 = out.view("<u2")  # every offset and size is even
    for i in np.flatnonzero(~is_run & ~is_array).tolist():
        o = int(offsets[i])
        out[o:o + 8 * w] = blocks[i].view(np.uint8)
    # Array payloads: only the nonzero words' bits are unpacked, in
    # (block, word, bit) order, so each block's positions ascend.
    idx = np.flatnonzero(is_array)
    step = max(1, _PASS_BYTES // (8 * w))
    for lo in range(0, len(idx), step):
        part = idx[lo:lo + step]
        r, wi = np.nonzero(blocks[part])
        bits = np.unpackbits(blocks[part][r, wi].view(np.uint8).reshape(
            -1, 8), axis=1, bitorder="little")
        k, b = np.nonzero(bits)
        rr = r[k]
        first = np.cumsum(cards[part]) - cards[part]
        out16[offsets[part][rr] // 2 + (np.arange(len(k)) - first[rr])] = (
            wi[k] * 64 + b)
    idx = np.flatnonzero(is_run)
    step = max(1, _PASS_BYTES // (64 * w))
    for lo in range(0, len(idx), step):
        part = idx[lo:lo + step]
        bits = np.unpackbits(blocks[part].view(np.uint8), axis=1,
                             bitorder="little")
        o16 = offsets[part] // 2
        edge = np.diff(bits.astype(np.int8), axis=1, prepend=0, append=0)
        rs, ps = np.nonzero(edge == 1)    # run starts
        _, pe = np.nonzero(edge == -1)    # one past each run's last
        first = np.cumsum(runs[part]) - runs[part]
        k = np.arange(len(rs)) - first[rs]
        out16[o16] = runs[part]
        out16[o16[rs] + 1 + 2 * k] = ps
        out16[o16[rs] + 2 + 2 * k] = pe - 1
    return out.tobytes()


def serialize(blocks: dict) -> bytes:
    """Encode {key: uint64[1024] dense block} -> roaring file bytes."""
    keys = sorted(blocks)
    if not keys:
        return struct.pack("<II", COOKIE, 0)
    stacked = np.stack([np.ascontiguousarray(blocks[k], dtype=np.uint64)
                        for k in keys])
    return serialize_arrays(np.asarray(keys, dtype=np.uint64), stacked)


def _decode_container(data, ctype, n, coff):
    """Decode one container payload -> (uint64[1024] dense block,
    payload end offset)."""
    if ctype == TYPE_ARRAY:
        pos = np.frombuffer(data, dtype="<u2", count=n, offset=coff)
        return _positions_to_block(pos), coff + 2 * n
    if ctype == TYPE_BITMAP:
        block = np.frombuffer(data, dtype="<u8", count=BITMAP_N,
                              offset=coff).copy()
        return block, coff + _BLOCK_BYTES
    if ctype == TYPE_RUN:
        (run_n,) = struct.unpack_from("<H", data, coff)
        runs = np.frombuffer(data, dtype="<u2", count=run_n * 2,
                             offset=coff + 2).reshape(run_n, 2)
        bits = np.zeros(BITMAP_N * 64, dtype=np.uint8)
        for start, last in runs.tolist():
            bits[start : last + 1] = 1
        block = np.packbits(bits, bitorder="little").view(np.uint64)
        return block, coff + 2 + 4 * run_n
    raise ValueError(f"unknown container type {ctype}")


# ------------------------------------------------- header-level decoding


def parse_header(data):
    """Vectorized header parse of roaring file bytes (``bytes`` or an
    mmap): (keys uint64[n], ctypes uint16[n], ns int64[n] values per
    container, offs int64[n] payload offsets, data_end = the op log's
    first byte). Raises ValueError on a bad cookie, an offset past the
    end or an unknown container type."""
    size = len(data)
    if size < 8:
        raise ValueError("data too small")
    magic, version, key_n = struct.unpack_from("<HHI", data, 0)
    if magic != MAGIC:
        raise ValueError(f"invalid roaring file, magic number {magic}")
    if version != STORAGE_VERSION:
        raise ValueError(f"wrong roaring version: v{version}")
    data_end = 8 + 16 * key_n
    meta = np.frombuffer(data, dtype=_META_DT, count=key_n, offset=8)
    offs = np.frombuffer(data, dtype="<u4", count=key_n,
                         offset=8 + 12 * key_n).astype(np.int64)
    ctypes_ = meta["ctype"].copy()
    ns = meta["n1"].astype(np.int64) + 1
    if not key_n:
        return meta["key"].copy(), ctypes_, ns, offs, data_end
    if int(offs.max()) >= size:
        raise ValueError(f"offset out of bounds: off={int(offs.max())}")
    bad = (ctypes_ < TYPE_ARRAY) | (ctypes_ > TYPE_RUN)
    if bad.any():
        raise ValueError(f"unknown container type {int(ctypes_[bad][0])}")
    # Payload ends, per type as _decode_container reads them.
    ends = np.where(ctypes_ == TYPE_ARRAY, offs + 2 * ns,
                    offs + _BLOCK_BYTES)
    run = ctypes_ == TYPE_RUN
    if run.any():
        run_n = _u16_at(np.frombuffer(data, np.uint8),
                        offs[run]).astype(np.int64)
        ends[run] = offs[run] + 2 + 4 * run_n
    return (meta["key"].copy(), ctypes_, ns, offs,
            max(data_end, int(ends.max())))


def container_spans(data, header, scan=True):
    """Inclusive in-container 64-bit word span (lo, hi) of each
    container's payload, int64[n] each (-1 where it holds no bit):
    array and run payloads are sorted, so their first and last values
    bound them; bitmap payloads are scanned (left -1 without ``scan``)."""
    keys, ctypes_, ns, offs, _ = header
    buf = np.frombuffer(data, np.uint8)
    lo = np.full(len(keys), -1, np.int64)
    hi = np.full(len(keys), -1, np.int64)
    arr = np.flatnonzero(ctypes_ == TYPE_ARRAY)
    if len(arr):
        lo[arr] = _u16_at(buf, offs[arr]) >> 6
        hi[arr] = _u16_at(buf, offs[arr] + 2 * (ns[arr] - 1)) >> 6
    run = np.flatnonzero(ctypes_ == TYPE_RUN)
    if len(run):
        run_n = _u16_at(buf, offs[run]).astype(np.int64)
        have = run_n > 0
        r, rn = run[have], run_n[have]
        lo[r] = _u16_at(buf, offs[r] + 2) >> 6
        hi[r] = _u16_at(buf, offs[r] + 4 * rn) >> 6
    for i in np.flatnonzero(ctypes_ == TYPE_BITMAP).tolist() if scan \
            else ():
        nz = np.flatnonzero(np.frombuffer(data, "<u8", BITMAP_N,
                                          int(offs[i])))
        if len(nz):
            lo[i], hi[i] = nz[0], nz[-1]
    return lo, hi


def fill_window(data, header, phys, matrix, base):
    """OR every container of roaring ``data`` into ``matrix`` (uint64
    [rows, w], the column window of words [base, base + w)): container i
    lands in row ``phys[i]``. Bitmap and run containers copy their
    overlap with the window; array containers scatter in vectorized
    passes — keys ascend and values ascend within a container, so the
    flat target words ascend and one ``reduceat`` folds each word's
    bits. Bits outside the window are dropped."""
    keys, ctypes_, ns, offs, _ = header
    w = matrix.shape[1]
    cbase = (keys % np.uint64(_CONTAINERS_PER_ROW)).astype(np.int64) \
        * BITMAP_N - base
    # Bitmap payloads that follow each other in the file and in a row
    # (the encoder writes a dense row's containers in order) copy as one
    # span.
    bmp = np.flatnonzero(ctypes_ == TYPE_BITMAP)
    if len(bmp):
        cuts = np.flatnonzero((np.diff(offs[bmp]) != _BLOCK_BYTES)
                              | (np.diff(cbase[bmp]) != BITMAP_N)
                              | (np.diff(phys[bmp]) != 0)) + 1
        for group in np.split(bmp, cuts):
            i, n = int(group[0]), len(group)
            c0 = int(cbase[i])
            lo, hi = max(c0, 0), min(c0 + n * BITMAP_N, w)
            if lo < hi:
                words = np.frombuffer(data, "<u8", n * BITMAP_N, int(offs[i]))
                matrix[phys[i], lo:hi] |= words[lo - c0:hi - c0]
    for i in np.flatnonzero(ctypes_ == TYPE_RUN).tolist():
        block, _ = _decode_container(data, TYPE_RUN, int(ns[i]),
                                     int(offs[i]))
        c0 = int(cbase[i])
        lo, hi = max(c0, 0), min(c0 + BITMAP_N, w)
        if lo < hi:
            matrix[phys[i], lo:hi] |= block[lo - c0:hi - c0]
    arr = np.flatnonzero(ctypes_ == TYPE_ARRAY)
    if not len(arr):
        return
    buf = np.frombuffer(data, np.uint8)
    flat = matrix.reshape(-1)
    ends = np.cumsum(ns[arr])
    step = _PASS_BYTES // 32
    lo = 0
    while lo < len(arr):
        hi = int(np.searchsorted(ends, ends[lo] - ns[arr[lo]] + step,
                                 side="right"))
        part = arr[lo:max(hi, lo + 1)]
        lo += len(part)
        counts = ns[part]
        first = np.cumsum(counts) - counts
        k = np.arange(int(counts.sum())) - np.repeat(first, counts)
        pos = _u16_at(buf, np.repeat(offs[part], counts) + 2 * k).astype(
            np.int64)
        col = np.repeat(cbase[part], counts) + (pos >> 6)
        target = np.repeat(phys[part].astype(np.int64) * w, counts) + col
        masks = np.left_shift(np.uint64(1), (pos & 63).astype(np.uint64))
        inside = (col >= 0) & (col < w)
        if not inside.all():  # a window narrower than the containers
            target, masks = target[inside], masks[inside]
        if len(target) > 1 and (np.diff(target) < 0).any():
            np.bitwise_or.at(flat, target, masks)
            continue
        starts = np.flatnonzero(np.concatenate(
            ([True], target[1:] != target[:-1])))
        flat[target[starts]] |= np.bitwise_or.reduceat(masks, starts)


# ------------------------------------------------ container-level reads


_SPAN_UNSET = object()


class LazyReader:
    """Container-granular roaring file reader (mmap-backed; ref:
    pilosa_tpu roaring/codec.py LazyReader).

    Opening a fragment by mmap, the reference faults 4 KB pages on
    demand (fragment.go:190-247, roaring.go:698-716); a query touching
    one row pays O(that row's pages). This reader parses ONLY the header
    (keys, types, cardinalities, offsets) and the trailing op log, then
    decodes single containers on request, so the OS pages in just the
    touched byte ranges.

    Op-log records for a key apply when that key's container is
    decoded; the cardinality of an op-touched key comes from decoding
    just that container. A torn op tail is tolerated (parsing stops, as
    at a full load); the next full load rewrites it. ``decoded`` counts
    container decodes."""

    def __init__(self, path):
        import mmap as _mmap
        import os as _os

        fd = _os.open(path, _os.O_RDONLY)
        try:
            # mmap sizes the file itself (no second stat: a metadata
            # call can cost a network round trip) and refuses an empty
            # one.
            self._mm = _mmap.mmap(fd, 0, access=_mmap.ACCESS_READ)
        except ValueError:
            self._mm = b""
        finally:
            # The mapping outlives the fd: holding the file open would
            # cost one more descriptor per evicted fragment.
            _os.close(fd)
        size = len(self._mm)
        self.decoded = 0
        self.metas = {}          # key -> (ctype, n, payload offset)
        self._ops = {}           # key -> (typs uint8[n], bits uint64[n])
        self._card_cache = {}
        self._span_cache = {}
        self._header = None
        self._row_table = None
        self.op_n = 0
        self.op_index_bytes = 0  # host bytes the op index holds
        if size < 8:
            return
        self._header = header = parse_header(self._mm)
        keys, ctypes_, ns, offs, data_end = header
        self.metas = dict(zip(keys.tolist(), zip(
            ctypes_.tolist(), ns.tolist(), offs.tolist())))
        # One parse pass, then one stable sort groups the records by
        # container key (order within a key is kept: add/remove
        # sequences on one bit depend on it).
        typs, values, _ = parse_ops(bytes(self._mm[data_end:]))
        self.op_n = len(typs)
        if self.op_n:
            okeys = (values >> np.uint64(16)).astype(np.int64)
            bits = values & np.uint64(0xFFFF)
            order, starts, ends, uniq = group_sorted(okeys)
            for s, e, k in zip(starts.tolist(), ends.tolist(),
                               uniq.tolist()):
                grp_typs, grp_bits = typs[order[s:e]], bits[order[s:e]]
                self._ops[k] = (grp_typs, grp_bits)
                self.op_index_bytes += (grp_typs.nbytes
                                        + grp_bits.nbytes + 64)

    def keys(self):
        """All keys that may hold bits (file containers ∪ op-created)."""
        return sorted(set(self.metas) | set(self._ops))

    def container(self, key):
        """uint64[1024] dense block for one key, op log applied; None
        when the key holds no container and no ops."""
        meta = self.metas.get(key)
        ops = self._ops.get(key)
        if meta is None and ops is None:
            return None
        if meta is None:
            block = np.zeros(BITMAP_N, dtype=np.uint64)
        else:
            ctype, n, coff = meta
            self.decoded += 1
            block, _ = _decode_container(self._mm, ctype, n, coff)
        if ops is not None:
            typs, bits = ops
            adds, removes = final_ops(typs, bits)
            for vals, is_add in ((adds, True), (removes, False)):
                if len(vals) == 0:
                    continue
                words = (vals >> np.uint64(6)).astype(np.int64)
                masks = np.uint64(1) << (vals & np.uint64(63))
                if is_add:
                    np.bitwise_or.at(block, words, masks)
                else:
                    np.bitwise_and.at(block, words, ~masks)
        return block

    def fill_row(self, row_id, b64, w64, out):
        """OR one row's words [b64, b64 + w64) into ``out`` (uint64[w64]),
        op log applied: the row's untouched containers in one
        ``fill_window`` pass, op-touched ones through ``container``."""
        first = row_id * _CONTAINERS_PER_ROW
        k_lo = first + b64 // BITMAP_N
        k_hi = first + (b64 + w64 - 1) // BITMAP_N
        if self._header is not None:
            keys = self._header[0]
            i0, i1 = np.searchsorted(keys, np.array([k_lo, k_hi + 1],
                                                    dtype=np.uint64))
            sel = np.arange(i0, i1)
            if self._ops:
                sel = sel[[int(keys[i]) not in self._ops for i in sel]]
            if len(sel):
                self.decoded += len(sel)
                part = tuple(a[sel] for a in self._header[:4]) + (0,)
                fill_window(self._mm, part, np.zeros(len(sel), np.int64),
                            out[None, :], b64)
        for key in range(k_lo, k_hi + 1):
            if key in self._ops:
                block = self.container(key)
                cbase = (key - first) * BITMAP_N
                lo, hi = max(cbase, b64), min(cbase + BITMAP_N, b64 + w64)
                out[lo - b64:hi - b64] |= block[lo - cbase:hi - cbase]

    def word_span(self, key):
        """Inclusive (lo, hi) 64-bit-word span WITHIN the container that
        the key's bits can occupy, or None when net-empty: sorted array
        and run payloads are bounded by a 4-byte peek at their ends,
        bitmap payloads scanned once (memoized); ADD ops widen the
        bound (an upper bound may over-cover, so REMOVE ops are
        ignored)."""
        cached = self._span_cache.get(key, _SPAN_UNSET)
        if cached is not _SPAN_UNSET:
            return cached
        lo = hi = None
        meta = self.metas.get(key)
        if meta is not None:
            ctype, n, coff = meta
            if ctype == TYPE_ARRAY:
                first = struct.unpack_from("<H", self._mm, coff)[0]
                last = struct.unpack_from("<H", self._mm,
                                          coff + 2 * (n - 1))[0]
                lo, hi = first >> 6, last >> 6
            elif ctype == TYPE_RUN:
                (run_n,) = struct.unpack_from("<H", self._mm, coff)
                if run_n:
                    first = struct.unpack_from("<H", self._mm, coff + 2)[0]
                    last = struct.unpack_from(
                        "<H", self._mm, coff + 2 + 4 * (run_n - 1) + 2)[0]
                    lo, hi = first >> 6, last >> 6
            else:
                nz = np.flatnonzero(np.frombuffer(
                    self._mm, dtype="<u8", count=BITMAP_N, offset=coff))
                if len(nz):
                    lo, hi = int(nz[0]), int(nz[-1])
        ops = self._ops.get(key)
        if ops is not None:
            typs, bits = ops
            adds = bits[typs == OP_ADD]
            if len(adds):
                w = (adds >> np.uint64(6)).astype(np.int64)
                olo, ohi = int(w.min()), int(w.max())
                lo = olo if lo is None else min(lo, olo)
                hi = ohi if hi is None else max(hi, ohi)
        span = None if lo is None else (lo, hi)
        self._span_cache[key] = span
        return span

    def slice_span(self):
        """Inclusive (lo, hi) slice-global 64-bit word span over every
        key — the min and max of ``sub * 1024 + word_span(key)`` — or
        None when no key holds a bit; one vectorized pass over the
        header instead of a ``word_span`` call per key."""
        spans = []  # (lo words, hi words) arrays
        if self._header is not None:
            keys, ctypes_ = self._header[:2]
            lo, hi = container_spans(self._mm, self._header, scan=False)
            sub = (keys % np.uint64(_CONTAINERS_PER_ROW)).astype(np.int64)
            have = lo >= 0
            spans.append((sub[have] * BITMAP_N + lo[have],
                          sub[have] * BITMAP_N + hi[have]))
            # A bitmap payload holds bits (its count is over 4,096), so
            # only those in the lowest and the highest sub can hold an
            # edge: the rest are not scanned.
            bmp = np.flatnonzero(ctypes_ == TYPE_BITMAP)
            for edge in {int(sub[bmp].min()), int(sub[bmp].max())} \
                    if len(bmp) else ():
                for i in bmp[sub[bmp] == edge].tolist():
                    span = self.word_span(int(keys[i]))
                    w = np.array(span, np.int64) + edge * BITMAP_N
                    spans.append((w[:1], w[1:]))
        for key, (typs, bits) in self._ops.items():
            adds = bits[typs == OP_ADD]
            w = (key % _CONTAINERS_PER_ROW) * BITMAP_N + (
                adds >> np.uint64(6)).astype(np.int64)
            spans.append((w, w))
        spans = [(lo, hi) for lo, hi in spans if len(lo)]
        if not spans:
            return None
        return (int(min(lo.min() for lo, _ in spans)),
                int(max(hi.max() for _, hi in spans)))

    def cardinality(self, key):
        """Exact bit count of one key: the header's count when no op
        touches the key, else a decode of just that container."""
        if key not in self._ops:
            meta = self.metas.get(key)
            return meta[1] if meta is not None else 0
        cached = self._card_cache.get(key)
        if cached is None:
            block = self.container(key)
            cached = (int(popcount64(block).sum())
                      if block is not None else 0)
            self._card_cache[key] = cached
        return cached

    def row_count(self, row_id):
        """Exact bit count of one row: a per-row table of the header's
        counts, summed in one vectorized pass on first use, plus the
        op-touched keys' cardinalities."""
        if self._row_table is None:
            rows, counts = np.zeros(0, np.uint64), np.zeros(0, np.int64)
            if self._header is not None:
                keys, _, ns, _, _ = self._header
                clean = ~np.isin(keys.astype(np.int64),
                                 np.fromiter(self._ops, np.int64,
                                             len(self._ops)))
                rows, inv = np.unique(
                    keys[clean] // np.uint64(_CONTAINERS_PER_ROW),
                    return_inverse=True)
                counts = np.zeros(len(rows), np.int64)
                np.add.at(counts, inv, ns[clean])
            dirty = {}
            for key in self._ops:
                r = key // _CONTAINERS_PER_ROW
                dirty.setdefault(r, []).append(key)
            self._row_table = (rows, counts, dirty)
        rows, counts, dirty = self._row_table
        i = int(np.searchsorted(rows, np.uint64(row_id)))
        n = int(counts[i]) if i < len(rows) and rows[i] == row_id else 0
        return n + sum(self.cardinality(k) for k in dirty.get(row_id, ()))

    def close(self):
        try:
            if self._mm:
                self._mm.close()
        except (BufferError, OSError):
            pass
