"""Hand-written proto3 wire codec for the public messages of Pilosa
(counterpart of the subset of pilosa_tpu/server/wireproto.py that the
public HTTP routes use; the bytes are the same).

Field numbers and types follow internal/public.proto exactly (Bitmap:1-3,
Pair, SumCount, Attr:1-6, QueryRequest:1-7, QueryResponse:1-3,
QueryResult:1-6, ImportRequest:1-8, ImportValueRequest:1-7) so existing
pilosa protobuf clients interoperate. Implemented from the proto3 wire
spec (varint / 64-bit / length-delimited); no generated code. The
cluster messages of private.proto — the broadcast envelope with its
schema and input-definition meta, max slices and node status — are
pilosa_tpu's bytes too.
"""
import struct

import numpy as np

from pilosa_tpu_torch.bitmap import Bitmap
from pilosa_tpu_torch.executor import SumCount

# The Content-Type (and Accept) of a protobuf body.
CONTENT_TYPE = "application/x-protobuf"

# Attr.Type values (ref: attr.go:38-41)
ATTR_STRING, ATTR_INT, ATTR_BOOL, ATTR_FLOAT = 1, 2, 3, 4

# QueryResult.Type values (ref: handler.go:1652-1658)
RESULT_NIL, RESULT_BITMAP, RESULT_PAIRS = 0, 1, 2
RESULT_SUMCOUNT, RESULT_UINT64, RESULT_BOOL = 3, 4, 5

_WIRE_VARINT, _WIRE_64, _WIRE_LEN, _WIRE_32 = 0, 1, 2, 5


# --------------------------------------------------------------- primitives

def _varint(n):
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, i):
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _key(field, wire):
    return _varint((field << 3) | wire)


def _tag_varint(field, value):
    if value is None:
        return b""
    return _key(field, _WIRE_VARINT) + _varint(int(value))


def _tag_bytes(field, data):
    return _key(field, _WIRE_LEN) + _varint(len(data)) + data


def _tag_string(field, s):
    return _tag_bytes(field, s.encode()) if s else b""


def _pack_varints_np(values):
    """Packed-varint payload built with NumPy: 7-bit chunks of every
    value computed as one [n, 10] matrix, then masked flat in order.
    ~40× the scalar loop on bulk-import payloads."""
    # Two's-complement mask like the scalar _varint (BSI values may be
    # negative; np.asarray(dtype=uint64) would raise on those).
    a = np.asarray(values)
    if a.dtype.kind == "i":
        v = a.astype(np.int64, copy=False).view(np.uint64)
    elif a.dtype.kind == "u":
        v = a.astype(np.uint64, copy=False)
    else:  # object dtype: ints outside [0, 2^64) — mask elementwise
        v = np.asarray([int(x) & ((1 << 64) - 1) for x in values],
                       dtype=np.uint64)
    if v.size == 0:
        return b""
    # Width = bytes the largest value needs (≤10); the chunk matrix is
    # the dominant cost and most payloads are small ids.
    width = max(1, (int(v.max()).bit_length() + 6) // 7)
    shifts = np.uint64(7) * np.arange(width, dtype=np.uint64)
    chunks = (v[:, None] >> shifts[None, :]) & np.uint64(0x7F)
    nonzero = chunks != 0
    nbytes = width - np.argmax(nonzero[:, ::-1], axis=1)
    nbytes = np.where(nonzero.any(axis=1), nbytes, 1)
    pos = np.arange(width)[None, :]
    keep = pos < nbytes[:, None]
    cont = pos < (nbytes - 1)[:, None]
    out = chunks.astype(np.uint8) | (cont.astype(np.uint8) << 7)
    return out[keep].tobytes()


def _unpack_varints_np(buf):
    """Decode a packed-varint payload with NumPy (inverse of
    _pack_varints_np). Returns a uint64 array, or None to request the
    scalar fallback (10-byte varints, i.e. values ≥ 2^63)."""
    b = np.frombuffer(buf, dtype=np.uint8)
    if b.size == 0:
        return np.zeros(0, dtype=np.uint64)
    ends = (b & 0x80) == 0
    if not ends[-1]:
        raise ValueError("truncated varint")
    idx = np.nonzero(ends)[0]
    starts = np.empty_like(idx)
    starts[0] = 0
    starts[1:] = idx[:-1] + 1
    if int((idx - starts).max()) > 8:
        return None  # ≥10-byte varint: 7*9=63-bit shifts would overflow
    group_start = np.repeat(starts, idx - starts + 1)
    k = (np.arange(b.size) - group_start).astype(np.uint64)
    contrib = (b.astype(np.uint64) & np.uint64(0x7F)) << (np.uint64(7) * k)
    return np.add.reduceat(contrib, starts)


def _tag_packed_varints(field, values):
    if values is None or (hasattr(values, "__len__") and len(values) == 0):
        return b""
    if len(values) >= 64:
        payload = _pack_varints_np(values)
    else:
        payload = b"".join(_varint(int(v)) for v in values)
    return _tag_bytes(field, payload)


def _tag_double(field, value):
    return _key(field, _WIRE_64) + struct.pack("<d", value)


def _signed(v):
    """proto3 int64 decode: values > 2^63 are negative."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _walk(data):
    """Yield (field, wire, value) triples; value is int or bytes."""
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, i = _read_varint(data, i)
        elif wire == _WIRE_64:
            val = data[i : i + 8]
            i += 8
        elif wire == _WIRE_LEN:
            ln, i = _read_varint(data, i)
            val = data[i : i + ln]
            i += ln
        elif wire == _WIRE_32:
            val = data[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _repeated_uint64(fields, field_no):
    """Handle both packed and unpacked repeated uint64."""
    out = []
    for field, wire, val in fields:
        if field != field_no:
            continue
        if wire == _WIRE_VARINT:
            out.append(val)
        else:
            vals = _unpack_varints_np(val) if len(val) >= 64 else None
            if vals is not None:
                out.extend(vals.tolist())
            else:
                i = 0
                while i < len(val):
                    v, i = _read_varint(val, i)
                    out.append(v)
    return out


# -------------------------------------------------------------------- Attr

def encode_attr(key, value):
    # Zero/false/empty payloads are ELIDED (proto3 canonical form — the
    # Type field still identifies the kind, and decoders default the
    # missing value field to zero).
    out = _tag_string(1, key)
    if isinstance(value, bool):
        out += _tag_varint(2, ATTR_BOOL) + (_tag_varint(5, 1) if value
                                            else b"")
    elif isinstance(value, int):
        out += _tag_varint(2, ATTR_INT) + _tag_varint(4, value or None)
    elif isinstance(value, float):
        # Only POSITIVE zero is the proto3 default; -0.0 has a distinct
        # bit pattern and the official runtime serializes it.
        is_default = struct.pack("<d", value) == b"\x00" * 8
        out += _tag_varint(2, ATTR_FLOAT) + (b"" if is_default
                                             else _tag_double(6, value))
    else:
        out += _tag_varint(2, ATTR_STRING) + _tag_string(3, str(value))
    return out


def decode_attr(data):
    key, typ, sval, ival, bval, fval = "", 0, "", 0, False, 0.0
    for field, wire, val in _walk(data):
        if field == 1:
            key = val.decode()
        elif field == 2:
            typ = val
        elif field == 3:
            sval = val.decode()
        elif field == 4:
            ival = _signed(val)
        elif field == 5:
            bval = bool(val)
        elif field == 6:
            fval = struct.unpack("<d", val)[0]
    if typ == ATTR_BOOL:
        return key, bval
    if typ == ATTR_INT:
        return key, ival
    if typ == ATTR_FLOAT:
        return key, fval
    return key, sval


def _encode_attrs(attrs):
    return b"".join(_tag_bytes(2, encode_attr(k, v))
                    for k, v in sorted(attrs.items()))


def _decode_attrs(fields, field_no=2):
    out = {}
    for field, _, val in fields:
        if field == field_no:
            k, v = decode_attr(val)
            out[k] = v
    return out


# ---------------------------------------------------------------- messages

def encode_bitmap(columns, attrs=None):
    return _tag_packed_varints(1, columns) + _encode_attrs(attrs or {})


def decode_bitmap(data):
    fields = list(_walk(data))
    return {"bits": _repeated_uint64(fields, 1),
            "attrs": _decode_attrs(fields)}


def encode_pair(row_id, count):
    return _tag_varint(1, row_id or None) + _tag_varint(2, count or None)


def decode_pair(data):
    rid = cnt = 0
    for field, _, val in _walk(data):
        if field == 1:
            rid = val
        elif field == 2:
            cnt = val
    return rid, cnt


def encode_sum_count(s, c):
    return _tag_varint(1, s or None) + _tag_varint(2, c or None)


def decode_sum_count(data):
    s = c = 0
    for field, _, val in _walk(data):
        if field == 1:
            s = _signed(val)
        elif field == 2:
            c = _signed(val)
    return s, c


def encode_query_request(query, slices=None, column_attrs=False, remote=False,
                         exclude_attrs=False, exclude_bits=False):
    out = _tag_string(1, query)
    out += _tag_packed_varints(2, slices or [])
    if column_attrs:
        out += _tag_varint(3, 1)
    if remote:
        out += _tag_varint(5, 1)
    if exclude_attrs:
        out += _tag_varint(6, 1)
    if exclude_bits:
        out += _tag_varint(7, 1)
    return out


def decode_query_request(data):
    fields = list(_walk(data))
    req = {"query": "", "slices": [], "column_attrs": False, "remote": False,
           "exclude_attrs": False, "exclude_bits": False}
    for field, wire, val in fields:
        if field == 1:
            req["query"] = val.decode()
        elif field == 3:
            req["column_attrs"] = bool(val)
        elif field == 5:
            req["remote"] = bool(val)
        elif field == 6:
            req["exclude_attrs"] = bool(val)
        elif field == 7:
            req["exclude_bits"] = bool(val)
    req["slices"] = _repeated_uint64(fields, 2)
    return req


def encode_query_result(result):
    # Canonical proto3 byte layout (matches the official runtime, which
    # serializes in FIELD-NUMBER order): the payload field — Bitmap:1,
    # N:2, Pairs:3, Changed:4, SumCount:5 — precedes Type:6, and
    # default values (Type 0 for nil, false, 0) are elided entirely.
    # A bitmap's ids go to the packer as their uint64 array: the same
    # bytes as from a list, without boxing millions of Python ints.
    if isinstance(result, Bitmap):
        return (_tag_bytes(1, encode_bitmap(result.columns(),
                                            result.attrs))
                + _tag_varint(6, RESULT_BITMAP))
    if isinstance(result, SumCount):
        return (_tag_bytes(5, encode_sum_count(result.sum, result.count))
                + _tag_varint(6, RESULT_SUMCOUNT))
    if isinstance(result, bool):
        return ((_tag_varint(4, 1) if result else b"")
                + _tag_varint(6, RESULT_BOOL))
    if isinstance(result, int):
        return _tag_varint(2, result or None) + _tag_varint(6, RESULT_UINT64)
    if isinstance(result, list):
        return (b"".join(_tag_bytes(3, encode_pair(r, c)) for r, c in result)
                + _tag_varint(6, RESULT_PAIRS))
    return b""  # nil: Type 0 elided → empty message


def decode_query_result(data):
    typ = RESULT_NIL
    bitmap = None
    n = 0
    pairs = []
    sumcount = (0, 0)
    changed = False
    for field, wire, val in _walk(data):
        if field == 6:
            typ = val
        elif field == 1:
            bitmap = decode_bitmap(val)
        elif field == 2:
            n = val
        elif field == 3:
            pairs.append(decode_pair(val))
        elif field == 5:
            sumcount = decode_sum_count(val)
        elif field == 4:
            changed = bool(val)
    if typ == RESULT_BITMAP:
        return bitmap or {"bits": [], "attrs": {}}
    if typ == RESULT_PAIRS:
        return pairs
    if typ == RESULT_SUMCOUNT:
        return SumCount(*sumcount)
    if typ == RESULT_UINT64:
        return n
    if typ == RESULT_BOOL:
        return changed
    return None


def encode_query_response(results, error=None):
    out = _tag_string(1, error or "")
    for r in results:
        out += _tag_bytes(2, encode_query_result(r))
    return out


def decode_query_response(data):
    err = ""
    results = []
    for field, wire, val in _walk(data):
        if field == 1:
            err = val.decode()
        elif field == 2:
            results.append(decode_query_result(val))
    return {"error": err or None, "results": results}


def encode_import_request(index, frame, slice_num, row_ids, column_ids,
                          timestamps=None, row_keys=None, column_keys=None):
    """ImportRequest (public.proto:70-80); RowKeys/ColumnKeys (fields
    7/8) carry a keyed import's string keys, paired by position."""
    out = _tag_string(1, index) + _tag_string(2, frame)
    out += _tag_varint(3, slice_num or None)
    out += _tag_packed_varints(4, row_ids)
    out += _tag_packed_varints(5, column_ids)
    out += _tag_packed_varints(6, timestamps or [])
    # Each key is written, empty ones too: _tag_string would drop an
    # empty string and misalign every pair after it.
    for key in row_keys or []:
        out += _tag_bytes(7, key.encode())
    for key in column_keys or []:
        out += _tag_bytes(8, key.encode())
    return out


def decode_import_request(data):
    fields = list(_walk(data))
    req = {"index": "", "frame": "", "slice": 0,
           "rowKeys": [], "columnKeys": []}
    for field, wire, val in fields:
        if field == 1:
            req["index"] = val.decode()
        elif field == 2:
            req["frame"] = val.decode()
        elif field == 3:
            req["slice"] = val
        elif field == 7:
            req["rowKeys"].append(val.decode())
        elif field == 8:
            req["columnKeys"].append(val.decode())
    req["rowIDs"] = _repeated_uint64(fields, 4)
    req["columnIDs"] = _repeated_uint64(fields, 5)
    req["timestamps"] = [_signed(t) for t in _repeated_uint64(fields, 6)]
    return req


def encode_import_value_request(index, frame, slice_num, field_name,
                                column_ids, values):
    out = _tag_string(1, index) + _tag_string(2, frame)
    out += _tag_varint(3, slice_num or None) + _tag_string(4, field_name)
    out += _tag_packed_varints(5, column_ids)
    out += _tag_packed_varints(6, values)
    return out


def decode_import_value_request(data):
    fields = list(_walk(data))
    req = {"index": "", "frame": "", "slice": 0, "field": ""}
    for field, wire, val in fields:
        if field == 1:
            req["index"] = val.decode()
        elif field == 2:
            req["frame"] = val.decode()
        elif field == 3:
            req["slice"] = val
        elif field == 4:
            req["field"] = val.decode()
    req["columnIDs"] = _repeated_uint64(fields, 5)
    req["values"] = [_signed(v) for v in _repeated_uint64(fields, 6)]
    return req



# ----------------------------------------------- private.proto messages
# (internal/private.proto:5-153, as pilosa_tpu/server/wireproto.py
# encodes them: the broadcast envelope, max slices and node status.)

# Broadcast envelope message types (ref: broadcast.go:126-137).
MSG_CREATE_SLICE = 1
MSG_CREATE_INDEX = 2
MSG_DELETE_INDEX = 3
MSG_CREATE_FRAME = 4
MSG_DELETE_FRAME = 5
MSG_CREATE_INPUT_DEFINITION = 6
MSG_DELETE_INPUT_DEFINITION = 7
MSG_DELETE_VIEW = 8
MSG_CREATE_FIELD = 9
MSG_DELETE_FIELD = 10


def _encode_index_meta(opts):
    """IndexMeta{ColumnLabel:1, TimeQuantum:2}."""
    return (_tag_string(1, opts.get("columnLabel", ""))
            + _tag_string(2, opts.get("timeQuantum", "")))


def _decode_index_meta(data):
    out = {"columnLabel": "", "timeQuantum": ""}
    for field, _, val in _walk(data):
        if field == 1:
            out["columnLabel"] = val.decode()
        elif field == 2:
            out["timeQuantum"] = val.decode()
    return out


def _encode_schema_field(fd):
    """Field{Name:1, Type:2, Min:3, Max:4} (private.proto:142-147)."""
    return (_tag_string(1, fd.get("name", ""))
            + _tag_string(2, fd.get("type", ""))
            + _tag_varint(3, fd.get("min", 0) or None)
            + _tag_varint(4, fd.get("max", 0) or None))


def _decode_schema_field(data):
    out = {"name": "", "type": "", "min": 0, "max": 0}
    for field, _, val in _walk(data):
        if field == 1:
            out["name"] = val.decode()
        elif field == 2:
            out["type"] = val.decode()
        elif field == 3:
            out["min"] = _signed(val)
        elif field == 4:
            out["max"] = _signed(val)
    return out


def _encode_frame_meta(opts):
    """FrameMeta{RowLabel:1, InverseEnabled:2, CacheType:3,
    CacheSize:4, TimeQuantum:5, RangeEnabled:6, Fields:7}."""
    out = _tag_string(1, opts.get("rowLabel", ""))
    if opts.get("inverseEnabled"):
        out += _tag_varint(2, 1)
    out += _tag_string(3, opts.get("cacheType", ""))
    out += _tag_varint(4, opts.get("cacheSize", 0) or None)
    out += _tag_string(5, opts.get("timeQuantum", ""))
    if opts.get("rangeEnabled"):
        out += _tag_varint(6, 1)
    for fd in opts.get("fields", []) or []:
        out += _tag_bytes(7, _encode_schema_field(fd))
    return out


def _decode_frame_meta(data):
    out = {"rowLabel": "", "inverseEnabled": False, "cacheType": "",
           "cacheSize": 0, "timeQuantum": "", "rangeEnabled": False,
           "fields": []}
    for field, _, val in _walk(data):
        if field == 1:
            out["rowLabel"] = val.decode()
        elif field == 2:
            out["inverseEnabled"] = bool(val)
        elif field == 3:
            out["cacheType"] = val.decode()
        elif field == 4:
            out["cacheSize"] = val
        elif field == 5:
            out["timeQuantum"] = val.decode()
        elif field == 6:
            out["rangeEnabled"] = bool(val)
        elif field == 7:
            out["fields"].append(_decode_schema_field(val))
    return out


def _encode_str_u64_map(field_no, mapping):
    """map<string, uint64> — one length-delimited entry per key, keys
    sorted for deterministic bytes (Go map order is random; sorting is
    wire-compatible and testable)."""
    out = b""
    for k in sorted(mapping):
        out += _tag_bytes(field_no,
                          _tag_string(1, k) + _tag_varint(2, mapping[k]))
    return out


def _decode_str_u64_map(fields, field_no):
    out = {}
    for field, _, val in fields:
        if field != field_no:
            continue
        k, v = "", 0
        for f2, _, v2 in _walk(val):
            if f2 == 1:
                k = v2.decode()
            elif f2 == 2:
                v = v2
        out[k] = v
    return out


def _encode_input_action(a):
    """InputDefinitionAction{Frame:1, ValueDestination:2, ValueMap:3,
    RowID:4}."""
    out = _tag_string(1, a.get("frame", ""))
    out += _tag_string(2, a.get("valueDestination", ""))
    out += _encode_str_u64_map(3, a.get("valueMap", {}) or {})
    if a.get("rowID") is not None:
        out += _tag_varint(4, a["rowID"])
    return out


def _decode_input_action(data):
    fields = list(_walk(data))
    out = {"frame": "", "valueDestination": ""}
    for field, _, val in fields:
        if field == 1:
            out["frame"] = val.decode()
        elif field == 2:
            out["valueDestination"] = val.decode()
        elif field == 4:
            out["rowID"] = val
    vm = _decode_str_u64_map(fields, 3)
    if vm:
        out["valueMap"] = vm
    return out


def _encode_input_field(f):
    """InputDefinitionField{Name:1, PrimaryKey:2, Actions:3}."""
    out = _tag_string(1, f.get("name", ""))
    if f.get("primaryKey"):
        out += _tag_varint(2, 1)
    for a in f.get("actions", []) or []:
        out += _tag_bytes(3, _encode_input_action(a))
    return out


def _decode_input_field(data):
    out = {"name": "", "primaryKey": False, "actions": []}
    for field, _, val in _walk(data):
        if field == 1:
            out["name"] = val.decode()
        elif field == 2:
            out["primaryKey"] = bool(val)
        elif field == 3:
            out["actions"].append(_decode_input_action(val))
    return out


def _encode_schema_frame(fr):
    """Frame{Name:1, Meta:2}."""
    out = _tag_string(1, fr.get("name", ""))
    meta = fr.get("options") or fr.get("meta")
    if meta:
        out += _tag_bytes(2, _encode_frame_meta(meta))
    return out


def _decode_schema_frame(data):
    out = {"name": ""}
    for field, _, val in _walk(data):
        if field == 1:
            out["name"] = val.decode()
        elif field == 2:
            out["options"] = _decode_frame_meta(val)
    return out


def _encode_input_definition(name, d):
    """InputDefinition{Name:1, Frames:2, Fields:3}."""
    out = _tag_string(1, name)
    for fr in d.get("frames", []) or []:
        out += _tag_bytes(2, _encode_schema_frame(fr))
    for f in d.get("fields", []) or []:
        out += _tag_bytes(3, _encode_input_field(f))
    return out


def _decode_input_definition(data):
    name = ""
    d = {"frames": [], "fields": []}
    for field, _, val in _walk(data):
        if field == 1:
            name = val.decode()
        elif field == 2:
            d["frames"].append(_decode_schema_frame(val))
        elif field == 3:
            d["fields"].append(_decode_input_field(val))
    return name, d


def encode_cluster_message(msg):
    """JSON-shaped broadcast dict → reference envelope (1 type byte +
    protobuf; ref: MarshalMessage broadcast.go:139-173)."""
    t = msg.get("type")
    if t == "create-slice":
        body = (_tag_string(1, msg["index"]) + _tag_varint(2, msg["slice"])
                + (_tag_varint(3, 1) if msg.get("inverse") else b""))
        typ = MSG_CREATE_SLICE
    elif t == "create-index":
        body = _tag_string(1, msg["index"])
        meta = _encode_index_meta(msg.get("options", {}) or {})
        if meta:
            body += _tag_bytes(2, meta)
        typ = MSG_CREATE_INDEX
    elif t == "delete-index":
        body = _tag_string(1, msg["index"])
        typ = MSG_DELETE_INDEX
    elif t == "create-frame":
        body = _tag_string(1, msg["index"]) + _tag_string(2, msg["frame"])
        meta = _encode_frame_meta(msg.get("options", {}) or {})
        if meta:
            body += _tag_bytes(3, meta)
        typ = MSG_CREATE_FRAME
    elif t == "delete-frame":
        body = _tag_string(1, msg["index"]) + _tag_string(2, msg["frame"])
        typ = MSG_DELETE_FRAME
    elif t == "create-field":
        body = (_tag_string(1, msg["index"]) + _tag_string(2, msg["frame"])
                + _tag_bytes(3, _encode_schema_field(msg["field"])))
        typ = MSG_CREATE_FIELD
    elif t == "delete-field":
        body = (_tag_string(1, msg["index"]) + _tag_string(2, msg["frame"])
                + _tag_string(3, msg["field"]))
        typ = MSG_DELETE_FIELD
    elif t == "delete-view":
        body = (_tag_string(1, msg["index"]) + _tag_string(2, msg["frame"])
                + _tag_string(3, msg["view"]))
        typ = MSG_DELETE_VIEW
    elif t == "create-input-definition":
        body = _tag_string(1, msg["index"]) + _tag_bytes(
            3, _encode_input_definition(msg["name"],
                                        msg.get("definition", {})))
        typ = MSG_CREATE_INPUT_DEFINITION
    elif t == "delete-input-definition":
        body = _tag_string(1, msg["index"]) + _tag_string(2, msg["name"])
        typ = MSG_DELETE_INPUT_DEFINITION
    else:
        raise ValueError(f"message type not implemented: {t}")
    return bytes([typ]) + body


def decode_cluster_message(data):
    """Reference envelope → the JSON-shaped dict receive_message eats
    (ref: UnmarshalMessage broadcast.go:175-196)."""
    if not data:
        raise ValueError("empty cluster message")
    typ, body = data[0], data[1:]
    fields = list(_walk(body))

    def s(field_no):
        for f, _, v in fields:
            if f == field_no:
                return v.decode()
        return ""

    def u(field_no):
        for f, _, v in fields:
            if f == field_no:
                return v
        return 0

    def sub(field_no):
        for f, _, v in fields:
            if f == field_no:
                return v
        return b""

    if typ == MSG_CREATE_SLICE:
        return {"type": "create-slice", "index": s(1), "slice": u(2),
                "inverse": bool(u(3))}
    if typ == MSG_CREATE_INDEX:
        return {"type": "create-index", "index": s(1),
                "options": _decode_index_meta(sub(2))}
    if typ == MSG_DELETE_INDEX:
        return {"type": "delete-index", "index": s(1)}
    if typ == MSG_CREATE_FRAME:
        return {"type": "create-frame", "index": s(1), "frame": s(2),
                "options": _decode_frame_meta(sub(3))}
    if typ == MSG_DELETE_FRAME:
        return {"type": "delete-frame", "index": s(1), "frame": s(2)}
    if typ == MSG_CREATE_FIELD:
        return {"type": "create-field", "index": s(1), "frame": s(2),
                "field": _decode_schema_field(sub(3))}
    if typ == MSG_DELETE_FIELD:
        return {"type": "delete-field", "index": s(1), "frame": s(2),
                "field": s(3)}
    if typ == MSG_DELETE_VIEW:
        return {"type": "delete-view", "index": s(1), "frame": s(2),
                "view": s(3)}
    if typ == MSG_CREATE_INPUT_DEFINITION:
        name, d = _decode_input_definition(sub(3))
        return {"type": "create-input-definition", "index": s(1),
                "name": name, "definition": d}
    if typ == MSG_DELETE_INPUT_DEFINITION:
        return {"type": "delete-input-definition", "index": s(1),
                "name": s(2)}
    raise ValueError(f"unknown cluster message type {typ}")


def encode_max_slices_response(max_slices):
    """MaxSlicesResponse{MaxSlices:1 map<string,uint64>}."""
    return _encode_str_u64_map(1, max_slices)


def decode_max_slices_response(data):
    return _decode_str_u64_map(list(_walk(data)), 1)


# NodeStatus / ClusterStatus (private.proto:127-136) — the gossip
# state-exchange payload; ours rides the same bytes over HTTP.

def encode_schema_index(idx):
    """Index{Name:1, Meta:2, MaxSlice:3, Frames:4, Slices:5,
    InputDefinitions:6}."""
    out = _tag_string(1, idx.get("name", ""))
    meta = idx.get("options") or idx.get("meta")
    if meta:
        out += _tag_bytes(2, _encode_index_meta(meta))
    out += _tag_varint(3, idx.get("maxSlice", 0) or None)
    for fr in idx.get("frames", []) or []:
        out += _tag_bytes(4, _encode_schema_frame(fr))
    out += _tag_packed_varints(5, idx.get("slices", []) or [])
    for name, d in sorted((idx.get("inputDefinitions") or {}).items()):
        out += _tag_bytes(6, _encode_input_definition(name, d))
    return out


def decode_schema_index(data):
    fields = list(_walk(data))
    out = {"name": "", "frames": [], "inputDefinitions": {}}
    for field, _, val in fields:
        if field == 1:
            out["name"] = val.decode()
        elif field == 2:
            out["options"] = _decode_index_meta(val)
        elif field == 3:
            out["maxSlice"] = val
        elif field == 4:
            out["frames"].append(_decode_schema_frame(val))
        elif field == 6:
            name, d = _decode_input_definition(val)
            out["inputDefinitions"][name] = d
    slices = _repeated_uint64(fields, 5)
    if slices:
        out["slices"] = slices
    return out


def encode_node_status(status):
    """NodeStatus{Host:1, State:2, Indexes:3, Scheme:4}."""
    out = _tag_string(1, status.get("host", ""))
    out += _tag_string(2, status.get("state", ""))
    for idx in status.get("indexes", []) or []:
        out += _tag_bytes(3, encode_schema_index(idx))
    out += _tag_string(4, status.get("scheme", ""))
    return out


def decode_node_status(data):
    out = {"host": "", "state": "", "scheme": "", "indexes": []}
    for field, _, val in _walk(data):
        if field == 1:
            out["host"] = val.decode()
        elif field == 2:
            out["state"] = val.decode()
        elif field == 3:
            out["indexes"].append(decode_schema_index(val))
        elif field == 4:
            out["scheme"] = val.decode()
    return out


def encode_cluster_status(nodes):
    """ClusterStatus{Nodes:1}."""
    return b"".join(_tag_bytes(1, encode_node_status(n)) for n in nodes)


def decode_cluster_status(data):
    return [decode_node_status(val) for field, _, val in _walk(data)
            if field == 1]
