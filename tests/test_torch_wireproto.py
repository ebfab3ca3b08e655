"""The port's wire codec against pilosa_tpu.server.wireproto: every
encoder of the subset gives the same bytes on seeded inputs, and each
package decodes the other's bytes. Ids 0, 2^31, 2^32+5, 2^40 and 2^63+,
empty lists, attributes of every type, negative values, timestamps of 0
and not; truncated and garbage bodies raise in both decoders and answer
400 (query) through both handlers. Tolerance: none, every byte equal."""
import numpy as np
import pytest

from pilosa_tpu.bitmap import Bitmap as JBitmap
from pilosa_tpu.executor import SumCount as JSumCount
from pilosa_tpu.server import wireproto as jwp
from pilosa_tpu.server.handler import Handler as JHandler
from pilosa_tpu_torch.bitmap import Bitmap as TBitmap
from pilosa_tpu_torch.executor import SumCount as TSumCount
from pilosa_tpu_torch.server import wireproto as twp
from pilosa_tpu_torch.server.handler import Handler as THandler

EDGE_IDS = [0, 1, 127, 128, 2**31, 2**32 + 5, 2**33 + 1, 2**40]
ATTRS = [
    {}, {"s": "stargazer"}, {"s": ""}, {"i": 7}, {"i": -3}, {"i": 0},
    {"b": True}, {"b": False}, {"f": 1.5}, {"f": -0.25}, {"f": 0.0},
    {"f": -0.0}, {"name": "x", "active": True, "n": 2**40, "r": 0.125,
                  "neg": -2**40},
]


def _ids(seed, n, hi):
    return np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint64)


ID_LISTS = [[], [0], EDGE_IDS, sorted(set(_ids(1, 63, 2**34).tolist())),
            sorted(set(_ids(2, 64, 2**34).tolist())),
            sorted(set(_ids(3, 5000, 2**44).tolist())),
            [2**63, 2**64 - 1] + list(range(70))]


@pytest.mark.parametrize("ids", ID_LISTS)
def test_packed_varints_round_trip(ids):
    for pkg in (jwp, twp):
        out = pkg._tag_packed_varints(4, ids)
        assert out == jwp._tag_packed_varints(4, ids)
    payload = jwp._tag_packed_varints(4, ids)
    for pkg in (jwp, twp):
        assert pkg._repeated_uint64(list(pkg._walk(payload)), 4) == ids
    if len(ids) >= 64:
        arr = np.asarray(ids, dtype=np.uint64)
        assert twp._pack_varints_np(arr) == jwp._pack_varints_np(ids)


@pytest.mark.parametrize("attrs", ATTRS)
def test_attrs(attrs):
    for k, v in attrs.items():
        got = twp.encode_attr(k, v)
        assert got == jwp.encode_attr(k, v)
        for pkg in (jwp, twp):
            key, val = pkg.decode_attr(got)
            assert key == k and val == v and type(val) is type(v)
    enc = jwp.encode_bitmap([], attrs)
    assert twp.encode_bitmap([], attrs) == enc
    assert twp.decode_bitmap(enc) == jwp.decode_bitmap(enc) == {
        "bits": [], "attrs": attrs}


@pytest.mark.parametrize("ids", ID_LISTS[:6])
def test_bitmap_messages(ids):
    attrs = {"name": "stargazer", "n": -1}
    enc = jwp.encode_bitmap(ids, attrs)
    assert twp.encode_bitmap(ids, attrs) == enc
    assert twp.encode_bitmap(np.asarray(ids, np.uint64), attrs) == enc
    assert twp.decode_bitmap(enc) == jwp.decode_bitmap(enc) == {
        "bits": ids, "attrs": attrs}


@pytest.mark.parametrize("rid,cnt", [(0, 0), (0, 5), (7, 0), (2**40, 2**33),
                                     (12, 1)])
def test_pairs_and_sum_counts(rid, cnt):
    assert twp.encode_pair(rid, cnt) == jwp.encode_pair(rid, cnt)
    assert twp.decode_pair(jwp.encode_pair(rid, cnt)) == (rid, cnt)
    assert jwp.decode_pair(twp.encode_pair(rid, cnt)) == (rid, cnt)
    for s in (rid, -rid - 1):
        enc = jwp.encode_sum_count(s, cnt)
        assert twp.encode_sum_count(s, cnt) == enc
        assert twp.decode_sum_count(enc) == jwp.decode_sum_count(enc) == (
            s, cnt)


@pytest.mark.parametrize("kw", [
    {}, {"slices": [0, 2, 9]}, {"slices": list(range(100))},
    {"column_attrs": True}, {"remote": True}, {"exclude_attrs": True},
    {"exclude_bits": True},
    {"slices": [5], "exclude_attrs": True, "exclude_bits": True},
])
@pytest.mark.parametrize("query", ['Count(Bitmap(frame="f", rowID=1))',
                                   "", 'TopN(frame="ü", n=2)'])
def test_query_requests(query, kw):
    enc = jwp.encode_query_request(query, **kw)
    assert twp.encode_query_request(query, **kw) == enc
    assert twp.decode_query_request(enc) == jwp.decode_query_request(enc)
    assert jwp.decode_query_request(twp.encode_query_request(query, **kw)) \
        == jwp.decode_query_request(enc)


def _results():
    """(pilosa_tpu results, the port's) of every QueryResult type."""
    cols = EDGE_IDS + sorted(set(_ids(4, 300, 2**22).tolist()))
    jbm, tbm = JBitmap.from_columns(cols), TBitmap.from_columns(cols, "cpu")
    jbm.attrs = tbm.attrs = {"name": "x", "on": False, "w": 2.5}
    return ([jbm, JBitmap(), 0, 5, 2**40, True, False, None, [],
             [(3, 10), (1, 10), (2**33, 1)], JSumCount(-5, 3),
             JSumCount(0, 0)],
            [tbm, TBitmap(), 0, 5, 2**40, True, False, None, [],
             [(3, 10), (1, 10), (2**33, 1)], TSumCount(-5, 3),
             TSumCount(0, 0)])


def test_query_results_and_responses():
    jres, tres = _results()
    for j, t in zip(jres, tres):
        enc = jwp.encode_query_result(j)
        assert twp.encode_query_result(t) == enc, j
        assert twp.decode_query_result(enc) == jwp.decode_query_result(enc)
    enc = jwp.encode_query_response(jres)
    assert twp.encode_query_response(tres) == enc
    assert twp.decode_query_response(enc) == jwp.decode_query_response(enc)
    err = jwp.encode_query_response([], error="frame not found")
    assert twp.encode_query_response([], error="frame not found") == err
    assert twp.decode_query_response(err) == {"error": "frame not found",
                                              "results": []}


@pytest.mark.parametrize("ts", [None, "zeros", "mixed"])
@pytest.mark.parametrize("n", [0, 3, 64, 3000])
def test_import_requests(n, ts):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 2**20, n).tolist()
    cols = rng.integers(0, 2**42, n).tolist()
    stamps = {None: None, "zeros": [0] * n,
              "mixed": [0 if k % 2 else 1496275200 + k for k in range(n)]
              }[ts]
    enc = jwp.encode_import_request("i", "f", 9537, rows, cols, stamps)
    assert twp.encode_import_request("i", "f", 9537, rows, cols,
                                     stamps) == enc
    want = jwp.decode_import_request(enc)
    assert twp.decode_import_request(enc) == want
    assert want["rowIDs"] == rows and want["columnIDs"] == cols
    assert want["timestamps"] == (stamps or [])
    vals = rng.integers(-1000, 1000, n).tolist()
    enc = jwp.encode_import_value_request("i", "b", 0, "stars", cols, vals)
    assert twp.encode_import_value_request("i", "b", 0, "stars", cols,
                                           vals) == enc
    got = twp.decode_import_value_request(enc)
    assert got == jwp.decode_import_value_request(enc)
    assert got["values"] == vals and got["columnIDs"] == cols


def test_keyed_import_request_decodes_its_keys():
    """The port refuses keyed imports, so it must see their keys."""
    enc = jwp.encode_import_request("i", "f", 0, [], [], None,
                                    row_keys=["a", ""], column_keys=["b", "c"])
    got = twp.decode_import_request(enc)
    assert got == jwp.decode_import_request(enc)
    assert got["rowKeys"] == ["a", ""] and got["columnKeys"] == ["b", "c"]


GARBAGE = [b"\x0a", b"\x0a\x05\xff\xfe\xfd\xfc\xfb", b"\x0b\x01",
           b"\x08", b"\x12\x02\x80", b"\xff" * 12]


@pytest.mark.parametrize("body", GARBAGE)
def test_garbage_raises_in_both_decoders(body):
    """A truncated or garbage body raises in both decoders (the same
    exception type) and answers 400 ``unmarshal body error`` through
    both handlers' query route."""
    errs = []
    for pkg in (jwp, twp):
        with pytest.raises(Exception) as e:
            pkg.decode_query_request(body)
        errs.append(type(e.value))
    assert errs[0] is errs[1]
    want = (400, "application/json", b'{"error": "unmarshal body error"}')
    for handler_cls in (JHandler, THandler):
        h = handler_cls(None, None)
        got = h.dispatch("POST", "/index/i/query", {}, body,
                         {"Content-Type": "application/x-protobuf"})
        assert tuple(got[:3]) == want
