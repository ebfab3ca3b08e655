"""Columnar binary wire format for the bulk-ingest route (counterpart of
pilosa_tpu/ingest/codec.py: the same frames, the same error messages).

``POST /index/<index>/ingest`` accepts two representations: a JSON
body (the debugging/interop twin) and this binary columnar frame
(``Content-Type: application/x-pilosa-ingest``) — raw little-endian
u64/i64 vectors that numpy decodes with zero per-bit Python work,
which is what lets one HTTP request carry millions of bits at memcpy
cost (the legacy /import path re-parses JSON numbers or protobuf
varints per bit).

Layout (all integers little-endian)::

    magic   5 bytes  b"PTIN1"
    kind    u8       0 = bits (row, column[, timestamp])
                     1 = BSI field values (column, value)
    flags   u8       bit 0: timestamps present (bits kind only)
    frame   u16 len + utf-8 bytes
    field   u16 len + utf-8 bytes (values kind; len 0 otherwise)
    n       u64      entry count
    rows    n * u64  (bits kind only)
    columns n * u64
    ts      n * i64  unix seconds, 0 = none  (when flags bit 0)
    values  n * i64  (values kind only)
"""
import struct

import numpy as np

MAGIC = b"PTIN1"
CONTENT_TYPE = "application/x-pilosa-ingest"

KIND_BITS = 0
KIND_VALUES = 1

_HEAD = struct.Struct("<5sBB")


class CodecError(ValueError):
    """Malformed ingest frame — the caller's 400."""


def encode_bits(frame, rows, columns, timestamps=None):
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    columns = np.ascontiguousarray(columns, dtype=np.uint64)
    if len(rows) != len(columns):
        raise CodecError("row/column length mismatch")
    flags = 0
    parts = []
    if timestamps is not None:
        ts = np.ascontiguousarray(timestamps, dtype=np.int64)
        if len(ts) != len(rows):
            raise CodecError("timestamp length mismatch")
        flags |= 1
        parts.append(ts)
    fb = frame.encode()
    out = [_HEAD.pack(MAGIC, KIND_BITS, flags),
           struct.pack("<H", len(fb)), fb,
           struct.pack("<H", 0),
           struct.pack("<Q", len(rows)),
           rows.tobytes(), columns.tobytes()]
    out.extend(p.tobytes() for p in parts)
    return b"".join(out)


def encode_values(frame, field, columns, values):
    columns = np.ascontiguousarray(columns, dtype=np.uint64)
    values = np.ascontiguousarray(values, dtype=np.int64)
    if len(columns) != len(values):
        raise CodecError("column/value length mismatch")
    fb = frame.encode()
    kb = field.encode()
    return b"".join([
        _HEAD.pack(MAGIC, KIND_VALUES, 0),
        struct.pack("<H", len(fb)), fb,
        struct.pack("<H", len(kb)), kb,
        struct.pack("<Q", len(columns)),
        columns.tobytes(), values.tobytes()])


def _take(body, off, n, what):
    if off + n > len(body):
        raise CodecError(f"truncated ingest frame ({what})")
    return body[off:off + n], off + n


def decode(body):
    """-> dict mirroring the JSON request shape: ``{"frame", "rows",
    "columns", "timestamps"}`` (bits) or ``{"frame", "field",
    "columns", "values"}`` (BSI), with numpy vectors for the columns.
    Raises CodecError on any malformed frame."""
    head, off = _take(body, 0, _HEAD.size, "header")
    magic, kind, flags = _HEAD.unpack(head)
    if magic != MAGIC:
        raise CodecError("bad ingest magic")
    if kind not in (KIND_BITS, KIND_VALUES):
        raise CodecError(f"unknown ingest kind: {kind}")
    raw, off = _take(body, off, 2, "frame length")
    flen = struct.unpack("<H", raw)[0]
    raw, off = _take(body, off, flen, "frame name")
    frame = raw.decode()
    raw, off = _take(body, off, 2, "field length")
    klen = struct.unpack("<H", raw)[0]
    raw, off = _take(body, off, klen, "field name")
    field = raw.decode()
    raw, off = _take(body, off, 8, "entry count")
    n = struct.unpack("<Q", raw)[0]
    vec = 8 * n

    def column(off, dtype, what):
        raw, off2 = _take(body, off, vec, what)
        return np.frombuffer(raw, dtype=dtype), off2

    if kind == KIND_BITS:
        rows, off = column(off, np.uint64, "rows")
        cols, off = column(off, np.uint64, "columns")
        ts = None
        if flags & 1:
            ts, off = column(off, np.int64, "timestamps")
        if off != len(body):
            raise CodecError("trailing bytes after ingest frame")
        return {"frame": frame, "rows": rows, "columns": cols,
                "timestamps": ts}
    cols, off = column(off, np.uint64, "columns")
    vals, off = column(off, np.int64, "values")
    if off != len(body):
        raise CodecError("trailing bytes after ingest frame")
    return {"frame": frame, "field": field, "columns": cols,
            "values": vals}
