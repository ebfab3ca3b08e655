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


def _block_to_positions(block: np.ndarray) -> np.ndarray:
    """uint64[1024] -> sorted uint16 in-container bit positions."""
    bits = np.unpackbits(block.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint16)


def _positions_to_block(pos: np.ndarray) -> np.ndarray:
    bits = np.zeros(BITMAP_N * 64, dtype=np.uint8)
    bits[pos] = 1
    return np.packbits(bits, bitorder="little").view(np.uint64)


def _runs_of(pos: np.ndarray):
    """Sorted positions -> list of (start, last) inclusive runs."""
    if len(pos) == 0:
        return []
    breaks = np.flatnonzero(np.diff(pos.astype(np.int32)) != 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [len(pos) - 1]))
    return list(zip(pos[starts].tolist(), pos[ends].tolist()))


def _compact_payload(block):
    """(ctype, payload) for a block that is NOT a bitmap container:
    the smaller of run and array (ties prefer run), as ``Optimize()``
    picks (roaring.go:1311-1355)."""
    pos = _block_to_positions(block)
    runs = _runs_of(pos)
    run_size = 2 + 4 * len(runs) if len(runs) <= RUN_MAX_SIZE else None
    array_size = 2 * len(pos) if len(pos) <= ARRAY_MAX_SIZE else None
    sizes = [(s, t) for s, t in
             ((run_size, TYPE_RUN), (array_size, TYPE_ARRAY),
              (_BLOCK_BYTES, TYPE_BITMAP)) if s is not None]
    _, ctype = min(sizes, key=lambda st: st[0])
    if ctype == TYPE_RUN:
        return ctype, struct.pack("<H", len(runs)) + np.asarray(
            runs, dtype=np.uint16).tobytes()
    if ctype == TYPE_ARRAY:
        return ctype, pos.tobytes()
    return ctype, block.tobytes()


def serialize_arrays(keys, blocks) -> bytes:
    """Encode (uint64[n] sorted keys, uint64[n, 1024] dense blocks) ->
    roaring file bytes. Cardinalities and run counts come from one
    vectorized pass over all blocks; a block with more than 4096 bits
    and at least 2048 runs is a bitmap container whatever else holds,
    so dense data never pays the per-block position scan. Empty blocks
    are dropped."""
    keys = np.asarray(keys, dtype=np.uint64)
    blocks = np.ascontiguousarray(blocks, dtype=np.uint64).reshape(
        len(keys), BITMAP_N)
    cards = popcount64(blocks).sum(axis=1, dtype=np.int64)
    keep = np.flatnonzero(cards)
    keys, blocks, cards = keys[keep], blocks[keep], cards[keep]
    carry = np.zeros_like(blocks)
    carry[:, 1:] = blocks[:, :-1] >> np.uint64(63)
    starts = blocks & ~((blocks << np.uint64(1)) | carry)
    runs = popcount64(starts).sum(axis=1, dtype=np.int64)
    is_bitmap = (cards > ARRAY_MAX_SIZE) & (runs >= RUN_MAX_SIZE)

    n = len(keys)
    ctypes_ = np.full(n, TYPE_BITMAP, dtype=np.uint16)
    payloads = [None] * n
    for i in np.flatnonzero(~is_bitmap).tolist():
        ctypes_[i], payloads[i] = _compact_payload(blocks[i])
    sizes = np.full(n, _BLOCK_BYTES, dtype=np.int64)
    for i in np.flatnonzero(~is_bitmap).tolist():
        sizes[i] = len(payloads[i])

    meta = np.empty(n, dtype=_META_DT)
    meta["key"] = keys
    meta["ctype"] = ctypes_
    meta["n1"] = (cards - 1).astype(np.uint16)
    head = 8 + 16 * n
    offsets = (head + np.cumsum(sizes) - sizes).astype("<u4")
    parts = [struct.pack("<II", COOKIE, n), meta.tobytes(),
             offsets.tobytes()]
    for i in range(n):
        parts.append(blocks[i].tobytes() if payloads[i] is None
                     else payloads[i])
    return b"".join(parts)


def serialize(blocks: dict) -> bytes:
    """Encode {key: uint64[1024] dense block} -> roaring file bytes."""
    keys = sorted(blocks)
    if not keys:
        return struct.pack("<II", COOKIE, 0)
    stacked = np.stack([np.ascontiguousarray(blocks[k], dtype=np.uint64)
                        for k in keys])
    return serialize_arrays(np.asarray(keys, dtype=np.uint64), stacked)


def deserialize(data: bytes, apply_oplog: bool = True):
    """Decode roaring file bytes -> ({key: uint64[1024]}, op_count,
    torn) (ref: UnmarshalBinary roaring.go:629-738): header, containers
    by type, then replay of the trailing op log."""
    if len(data) < 8:
        raise ValueError("data too small")
    magic, version, key_n = struct.unpack_from("<HHI", data, 0)
    if magic != MAGIC:
        raise ValueError(f"invalid roaring file, magic number {magic}")
    if version != STORAGE_VERSION:
        raise ValueError(f"wrong roaring version: v{version}")
    meta = np.frombuffer(data, dtype=_META_DT, count=key_n, offset=8)
    offs = np.frombuffer(data, dtype="<u4", count=key_n,
                         offset=8 + 12 * key_n)
    blocks = {}
    data_end = 8 + 16 * key_n
    for key, ctype, n1, coff in zip(meta["key"].tolist(),
                                    meta["ctype"].tolist(),
                                    meta["n1"].tolist(), offs.tolist()):
        if coff >= len(data):
            raise ValueError(f"offset out of bounds: off={coff}")
        blocks[key], payload_end = _decode_container(data, ctype, n1 + 1,
                                                     coff)
        data_end = max(data_end, payload_end)
    return _apply_oplog(blocks, data[data_end:], apply_oplog)


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


def _apply_oplog(blocks, op_region, apply_oplog):
    """Apply an op-log region to a key→block dict: parse all records,
    collapse to the net effect per bit (last op wins), then scatter
    adds/removes. Containers referenced only by ops are created (empty
    for a net remove). Returns (blocks, op_count, torn)."""
    if not apply_oplog:
        return blocks, 0, False
    typs, values, torn = parse_ops(op_region)
    op_n = len(typs)
    if op_n == 0:
        return blocks, op_n, torn
    for key in np.unique(values >> np.uint64(16)).tolist():
        if key not in blocks:
            blocks[key] = np.zeros(BITMAP_N, dtype=np.uint64)
    adds, removes = final_ops(typs, values)
    for vals, is_add in ((adds, True), (removes, False)):
        if len(vals) == 0:
            continue
        keys = (vals >> np.uint64(16)).astype(np.int64)
        bits = vals & np.uint64(0xFFFF)
        words = (bits >> np.uint64(6)).astype(np.int64)
        masks = np.uint64(1) << (bits & np.uint64(63))
        kw = keys * np.int64(BITMAP_N) + words
        order, starts, _, _ = group_sorted(kw)
        kw = kw[order][starts]  # unique (key, word) pairs
        ored = np.bitwise_or.reduceat(masks[order], starts)
        _, kstarts, kends, ukeys = group_sorted(kw // BITMAP_N)
        for s, e, key in zip(kstarts.tolist(), kends.tolist(),
                             ukeys.tolist()):
            wsel = kw[s:e] % BITMAP_N
            blk = blocks[key]
            if is_add:
                blk[wsel] |= ored[s:e]
            else:
                blk[wsel] &= ~ored[s:e]
    return blocks, op_n, torn
