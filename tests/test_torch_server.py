"""The port's HTTP server against pilosa_tpu's.

One script of requests — DDL, JSON and protobuf imports with timestamps,
PQL writes, every read of the port's surface in JSON and in protobuf
(with ``slices=``, ``excludeAttrs``, ``excludeBits``), error cases and
deletes — is dispatched to ``pilosa_tpu.server.handler.Handler`` over a
JAX holder in directory A and to the port's ``Handler`` over
``Holder(B, device="cpu")``. Every response (status, content type, body
bytes) must be equal, apart from ``/version`` and ``/id``. Then A is
opened by the port and B by pilosa_tpu, and the reads must still agree.

Over sockets: the port's ``Server`` driven by urllib, ``http.client``
keep-alive and pilosa_tpu's client library (Getting Started's documented
answers); eight threads of mixed reads and writes against the same
requests run one after another; the 413 gate; no GPU, no server.
Tolerance: none, every byte equal.
"""
import http.client
import json
import os
import socket
import threading
import urllib.error
import urllib.request
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.client import Client as JClient
from pilosa_tpu.client import Schema as JSchema
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.server import wireproto as jwp
from pilosa_tpu.server.handler import Handler as JHandler
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.server.handler import Handler as THandler
from pilosa_tpu_torch.server.server import Server
from pilosa_tpu_torch.storage.holder import Holder as THolder

HOST = "localhost:10101"
PB = "application/x-protobuf"
N_SLICES = 3
TS_A = 1496275200   # 2017-06-01T00:00 UTC
TS_B = 1499040000   # 2017-07-03T00:00 UTC


def _r(method, path, body=b"", ctype=None, accept=None):
    """(method, path with query string, body bytes, headers)."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    headers = {}
    if ctype:
        headers["Content-Type"] = ctype
    if accept:
        headers["Accept"] = accept
    return method, path, body, headers


def _q(pql, qs="", proto=None):
    """A query of index i: PQL text, or a protobuf QueryRequest when
    ``proto`` holds its options (slices, exclude_attrs, exclude_bits)."""
    if proto is None:
        return _r("POST", f"/index/i/query{qs}", pql)
    return _r("POST", "/index/i/query", jwp.encode_query_request(
        pql, **proto), ctype=PB)


def _bits(seed, n, slices=N_SLICES):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 6, n)
    cols = rng.integers(0, slices * SLICE_WIDTH, n)
    return rows, cols


def _import_json(frame, seed, n, ts=None):
    rows, cols = _bits(seed, n)
    req = {"index": "i", "frame": frame, "slice": 0,
           "rowIDs": rows.tolist(), "columnIDs": cols.tolist()}
    if ts is not None:
        req["timestamps"] = ts(n)
    return _r("POST", "/import", req)


def _import_pb(frame, seed, n, ts=None):
    rows, cols = _bits(seed, n)
    return _r("POST", "/import", jwp.encode_import_request(
        "i", frame, 0, rows.tolist(), cols.tolist(),
        ts(n) if ts is not None else None), ctype=PB)


def _stamps(n):
    """Epoch seconds per bit: none (0), a June day and a July day."""
    return [(0, TS_A + 86400 * (k % 5), TS_B)[k % 3] for k in range(n)]


def _values(field, seed, n, lo, hi, proto=False):
    rng = np.random.default_rng(seed)
    cols = rng.choice(N_SLICES * SLICE_WIDTH, n, replace=False)
    vals = rng.integers(lo, hi + 1, n)
    if proto:
        return _r("POST", "/import-value", jwp.encode_import_value_request(
            "i", "b", 0, field, cols.tolist(), vals.tolist()), ctype=PB)
    return _r("POST", "/import-value", {
        "index": "i", "frame": "b", "field": field,
        "columnIDs": cols.tolist(), "values": vals.tolist()})


DDL = [
    _r("POST", "/index/i", {"options": {"timeQuantum": "YMD"}}),
    _r("POST", "/index/i", {}),                                   # 409
    _r("POST", "/index/Bad", {}),                                 # 400
    _r("POST", "/index/j", {"options": {"columnLabel": "user"}}),
    _r("GET", "/index/i"),
    _r("GET", "/index/j"),
    _r("GET", "/index/nope"),                                     # 404
    _r("POST", "/index/i/frame/f", {"options": {"cacheType": "ranked",
                                                "cacheSize": 100}}),
    _r("POST", "/index/i/frame/f", {}),                           # 409
    _r("POST", "/index/i/frame/b", {"options": {
        "rangeEnabled": True,
        "fields": [{"name": "v", "type": "int", "min": -10, "max": 100}]}}),
    _r("POST", "/index/i/frame/b/field/w", {"type": "int", "min": 0,
                                            "max": 1000}),
    _r("POST", "/index/i/frame/b/field/w", {"type": "int", "max": 5}),
    _r("POST", "/index/i/frame/b/field/z", {"min": 9, "max": 1}),
    _r("POST", "/index/i/frame/f/field/x", {"max": 10}),           # 400
    _r("POST", "/index/i/frame/inv", {"options": {"inverseEnabled": True}}),
    _r("POST", "/index/i/frame/t", {}),      # inherits the index's YMD
    _r("POST", "/index/i/frame/lru", {"options": {"cacheType": "lru"}}),
    _r("POST", "/index/i/frame/bad", {"options": {"cacheType": "x"}}),
    _r("POST", "/index/nope/frame/f", {}),                        # 404
    _r("PATCH", "/index/j/time-quantum", {"timeQuantum": "YM"}),
    _r("PATCH", "/index/j/time-quantum", {"timeQuantum": "XY"}),   # 400
    _r("POST", "/index/j/frame/g", {}),
    _r("PATCH", "/index/j/frame/g/time-quantum", {"timeQuantum": "YMDH"}),
    _r("PATCH", "/index/j/frame/nope/time-quantum", {}),          # 404
    _r("POST", "/index/i/frame/f/views/extra"),
    _r("GET", "/index/i/frame/f/views"),
    _r("GET", "/index/i/frame/b/fields"),
    _r("GET", "/index/i/frame/nope/fields"),                      # 404
    _r("POST", "/index/i", b"{not json"),                          # 400
]

WRITES = [
    _import_json("f", 1, 3000),
    _import_pb("f", 2, 3000),
    _import_json("t", 3, 600, ts=_stamps),
    _import_pb("t", 4, 600, ts=_stamps),
    _import_pb("inv", 5, 500),
    _values("v", 6, 400, -10, 100),
    _values("w", 7, 400, 0, 1000, proto=True),
    _values("v", 8, 3, 0, 101),                  # 101 > max: 400
    _r("POST", "/import", {"index": "i", "frame": "nope", "rowIDs": [],
                           "columnIDs": []}),                     # 404
    _r("POST", "/import", {"index": "i", "frame": "f"}),           # 400
    _r("POST", "/import", {"index": "i"}),                         # 400
    _r("POST", "/import", b"\x0a\x05ab", ctype=PB),  # short: index "ab"
    _r("POST", "/import", b"\x0a\x02\xff\xfe", ctype=PB),        # 400
    _r("POST", "/import", b"\x08\xff", ctype=PB),    # torn varint: 500
    _q('SetBit(frame="f", rowID=1, columnID=7)'),
    _q('SetBit(frame="f", rowID=1, columnID=7)'),                  # false
    _q('ClearBit(frame="f", rowID=1, columnID=7)'),
    _q('SetBit(frame="t", rowID=2, columnID=9, '
       'timestamp="2017-06-02T10:00")'),
    _q('SetBit(frame="f", rowID=2, columnID=100) '
       'SetBit(frame="f", rowID=3, columnID=1048577)'),
    _q('SetFieldValue(frame="b", columnID=11, v=-7, w=900)'),
    _q('SetFieldValue(frame="b", columnID=12, v=1000)'),           # 400
    _q('SetRowAttrs(frame="f", rowID=1, name="one", n=7, ok=true, '
       'x=1.5)'),
    _q('SetRowAttrs(frame="f", rowID=2, name="two", ok=false) '
       'SetRowAttrs(frame="f", rowID=3, name="three", n=-3)'),
    _q('SetColumnAttrs(columnID=7, city="b", pop=9)'),
    _q('SetColumnAttrs(columnID=100, city="a")'),
    _q('SetBit(frame="nope", rowID=1, columnID=1)'),               # 400
    _q(" ".join(f'SetBit(frame="f", rowID=9, columnID={k})'
                for k in range(5001))),                            # 400
]


def _row(r, frame="f"):
    return f'Bitmap(frame="{frame}", rowID={r})'


READ_PQL = [
    _row(1), _row(3), f"Intersect({_row(1)}, {_row(2)})",
    f"Union({_row(0)}, {_row(4)}, {_row(5)})",
    f"Difference({_row(1)}, {_row(2)})", f"Xor({_row(3)}, {_row(4)})",
    f"Count({_row(2)})", f"Count(Intersect({_row(0)}, {_row(1)}))",
    f"Count(Union({_row(0)}, {_row(1)}, {_row(2)}))",
    'Bitmap(frame="inv", columnID=3)',
    'TopN(frame="f", n=3)', f'TopN({_row(0)}, frame="f", n=4)',
    'TopN(frame="f", ids=[1, 2, 5])', 'TopN(frame="f", threshold=50)',
    f'TopN({_row(1)}, frame="f", tanimotoThreshold=10)',
    'TopN(frame="f", n=5, field="name", filters=["one", "three"])',
    'TopN(frame="inv", inverse=true, n=2)',
    'Sum(frame="b", field="v")', 'Average(frame="b", field="w")',
    f'Sum({_row(0)}, frame="b", field="w")',
    'Min(frame="b", field="v")', 'Max(frame="b", field="w")',
    'Count(Range(frame="b", v > 30))', 'Range(frame="b", w >< [10, 400])',
    'Count(Range(frame="b", v != null))',
    'Range(frame="t", rowID=2, start="2017-06-01T00:00", '
    'end="2017-06-03T00:00")',
    'Count(Range(frame="t", rowID=1, start="2017-01-01T00:00", '
    'end="2018-01-01T00:00"))',
    f'Count({_row(1)}) TopN(frame="f", n=2) Sum(frame="b", field="v")',
    'Bitmap(frame="nope", rowID=1)',                               # 400
    'Count(Bitmap(frame="f", rowID=1)',                            # parse
    'Sum(frame="b", field="nope")',
    'Range(frame="b", v > "x")',
]

READS = (
    [_q(q) for q in READ_PQL]
    + [_q(q, proto={}) for q in READ_PQL]
    + [_r("POST", "/index/i/query", q, accept=PB) for q in READ_PQL[:6]]
    + [_q(_row(1), "?slices=0,2"), _q(_row(1), "?excludeAttrs=true"),
       _q(_row(2), "?excludeBits=true"),
       _q(f'Count({_row(0)})', "?slices=1"),
       _q(_row(1), proto={"slices": [0, 2]}),
       _q(_row(1), proto={"exclude_attrs": True}),
       _q(_row(2), proto={"exclude_bits": True}),
       _q(_row(1), proto={"column_attrs": True}),
       _q(""),                                                     # 400
       _r("POST", "/index/nope/query", _row(1)),                   # 400
       _r("POST", "/index/nope/query", _row(1), accept=PB),
       _r("POST", "/index/i/query", b"\xff\xfe", ctype=PB),        # bad pb
       _r("POST", "/index/i/query", b"\x0a\x09ab", ctype=PB),      # short
       _r("GET", "/index/i/query"),                                # 405
       _r("GET", "/nope"),                                         # 404
       _r("PUT", "/index/i"),                                      # 404
       _r("GET", "/schema"), _r("GET", "/index"), _r("GET", "/status"),
       _r("GET", "/hosts"), _r("GET", "/slices/max"),
       _r("GET", "/slices/max?inverse=true"),
       _r("GET", "/fragment/nodes?index=i&slice=1"),
       _r("GET", "/index/i/frame/t/views"),
       _r("GET", "/export?index=i&frame=f&slice=0"),
       _r("GET", "/export?index=i&frame=f&slice=2"),
       _r("GET", "/export?index=i&frame=inv&view=inverse&slice=0"),
       _r("GET", "/export?index=i&frame=t&view=standard_201706&slice=1"),
       _r("GET", "/export?index=i&frame=f&slice=9"),
       _r("GET", "/version"), _r("GET", "/id")]
)

DELETES = [
    _r("DELETE", "/index/i/frame/f/view/extra"),
    _r("DELETE", "/index/i/frame/f/view/never"),
    _r("DELETE", "/index/i/frame/b/field/w"),
    _r("DELETE", "/index/i/frame/b/field/w"),                      # 400
    _r("DELETE", "/index/i/frame/inv"),
    _r("DELETE", "/index/i/frame/inv"),                            # no-op
    _r("DELETE", "/index/nope/frame/f"),                           # 404
    _r("DELETE", "/index/j"),
    _r("DELETE", "/index/j"),                                      # 400
    _r("POST", "/recalculate-caches"),
]

SCRIPT = DDL + WRITES + READS + DELETES + READS
UNEQUAL = {"/version", "/id"}


def _dispatch(handler, req):
    method, path, body, headers = req
    u = urlparse(path)
    return tuple(handler.dispatch(method, u.path, parse_qs(u.query), body,
                                  dict(headers))[:3])


def _pair(a, b):
    ja = JHolder(a).open()
    tb = THolder(b, device="cpu").open()
    return (ja, tb, JHandler(ja, JExecutor(ja), local_host=HOST),
            THandler(tb, TExecutor(tb), local_host=HOST))


def _assert_same(jh, th, script):
    """Dispatch each request to both handlers; -> the set of (status,
    content type) answered."""
    seen = set()
    for req in script:
        got_j, got_t = _dispatch(jh, req), _dispatch(th, req)
        seen.add(got_t[:2])
        if urlparse(req[1]).path in UNEQUAL:
            assert got_t[:2] == got_j[:2], req[:2]
            continue
        assert got_t == got_j, (req[0], req[1], req[2][:200])
    return seen


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    """Directories A and B after the whole script, byte-compared request
    by request as it runs, and the outcomes it reached."""
    root = tmp_path_factory.mktemp("server")
    a, b = str(root / "a"), str(root / "b")
    ja, tb, jh, th = _pair(a, b)
    try:
        seen = _assert_same(jh, th, SCRIPT)
    finally:
        ja.close()
        tb.close()
    return a, b, seen


def test_script_is_byte_identical(scripted):
    a, b, _ = scripted
    assert os.path.isdir(os.path.join(a, "i", "f"))
    assert not os.path.exists(os.path.join(b, "j"))
    assert not os.path.exists(os.path.join(b, "i", "inv"))


def test_script_covers_statuses_and_encodings(scripted):
    """The script reaches every outcome it claims: 200, 204, 400, 404,
    405, 409 and 500 in JSON, 200 and 400 in protobuf, and CSV."""
    seen = scripted[2]
    for status in (200, 204, 400, 404, 405, 409, 500):
        assert (status, "application/json") in seen
    assert {(200, PB), (400, PB), (200, "text/csv"),
            (200, "text/plain")} <= seen


@pytest.mark.parametrize("swap", [False, True])
def test_reads_agree_after_each_package_reopens_the_other(scripted, swap):
    """A (written by pilosa_tpu) opened by the port and B (written by
    the port) opened by pilosa_tpu, or each by its own package again:
    the reads, deletes included, still answer byte for byte."""
    a, b, _ = scripted
    if swap:
        a, b = b, a
    ja = JHolder(a).open()
    tb = THolder(b, device="cpu").open()
    try:
        _assert_same(JHandler(ja, JExecutor(ja), local_host=HOST),
                     THandler(tb, TExecutor(tb), local_host=HOST), READS)
    finally:
        ja.close()
        tb.close()


def test_keyed_import_is_refused(tmp_path):
    """A keyed import whose row and column keys differ in number is
    refused (400) and writes nothing; once they pair up, the keys are
    translated as pilosa_tpu translates them (tests/test_torch_keys.py
    holds keyed imports against pilosa_tpu at length)."""
    ja, tb, jh, th = _pair(str(tmp_path / "a"), str(tmp_path / "b"))
    try:
        for h in (jh, th):
            _dispatch(h, _r("POST", "/index/i", {}))
            _dispatch(h, _r("POST", "/index/i/frame/f", {}))
        bad = jwp.encode_import_request("i", "f", 0, [], [],
                                        row_keys=["a", "c"],
                                        column_keys=["b"])
        got = _dispatch(th, _r("POST", "/import", bad, ctype=PB))
        assert got == _dispatch(jh, _r("POST", "/import", bad, ctype=PB))
        assert got == (400, "application/json",
                       b'{"error": "row/column key length mismatch"}')
        assert tb.index("i").frame("f").views == {}
        good = jwp.encode_import_request("i", "f", 0, [], [],
                                         row_keys=["a"], column_keys=["b"])
        got = _dispatch(th, _r("POST", "/import", good, ctype=PB))
        assert got == _dispatch(jh, _r("POST", "/import", good, ctype=PB))
        assert got[0] == 200
        assert tb.index("i").frame("f").row_key_store.translate(["a"]) == [0]
    finally:
        ja.close()
        tb.close()


def test_deleted_index_is_gone_for_both_packages(tmp_path):
    """An index and a frame deleted by the port are gone after either
    package reopens the directory; a new index under the old name
    starts empty."""
    path = str(tmp_path / "d")
    h = THolder(path, device="cpu").open()
    th = THandler(h, TExecutor(h))
    for req in [_r("POST", "/index/x", {}), _r("POST", "/index/x/frame/f"),
                _r("POST", "/index/x/frame/g"),
                _r("POST", "/index/x/query",
                   'SetBit(frame="f", rowID=1, columnID=5) '
                   'SetBit(frame="g", rowID=1, columnID=5)'),
                _r("POST", "/index/x/query", 'Count(Bitmap(frame="f", '
                   'rowID=1))'),
                _r("DELETE", "/index/x/frame/g"), _r("DELETE", "/index/x"),
                _r("POST", "/index/x", {}), _r("POST", "/index/x/frame/f")]:
        assert _dispatch(th, req)[0] == 200
    got = _dispatch(th, _r("POST", "/index/x/query",
                           'Count(Bitmap(frame="f", rowID=1))'))
    assert json.loads(got[2]) == {"results": [0]}
    _dispatch(th, _r("DELETE", "/index/x"))
    h.close()
    for holder in (THolder(path, device="cpu"), JHolder(path)):
        holder.open()
        try:
            assert holder.index("x") is None
        finally:
            holder.close()


# ------------------------------------------------------------- sockets

def _recv_all(conn):
    out = b""
    while True:
        data = conn.recv(65536)
        if not data:
            return out
        out += data


def _http(base, method, path, body=None, ctype="application/json"):
    req = urllib.request.Request(base + path, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture
def server(tmp_path):
    s = Server(str(tmp_path / "data"), bind="localhost:0",
               device="cpu").open()
    yield s
    s.close()


def test_getting_started_over_urllib(server):
    """docs/getting-started.md against the port's server, with the
    answers the document shows."""
    b = f"http://{server.host}"
    assert server.host.startswith("localhost:") and \
        not server.host.endswith(":0")
    assert _http(b, "POST", "/index/repository", b"{}")[0] == 200
    assert _http(b, "POST", "/index/repository/frame/stargazer",
                 b"{}")[0] == 200
    q = "/index/repository/query"
    assert json.loads(_http(b, "POST", q, b'SetBit(frame="stargazer", '
                            b'rowID=14, columnID=100)')[2]) == \
        {"results": [True]}
    _http(b, "POST", q, b'SetBit(frame="stargazer", rowID=14, '
          b'columnID=200)\nSetBit(frame="stargazer", rowID=19, '
          b'columnID=200)')
    status, ctype, body = _http(b, "POST", q,
                                b'Bitmap(frame="stargazer", rowID=14)')
    assert (status, ctype) == (200, "application/json")
    assert body == b'{"results": [{"attrs": {}, "bits": [100, 200]}]}'
    assert json.loads(_http(b, "POST", q, b'Count(Intersect(Bitmap(frame='
                            b'"stargazer", rowID=14), Bitmap(frame='
                            b'"stargazer", rowID=19)))')[2]) == \
        {"results": [1]}
    assert json.loads(_http(b, "POST", q, b'TopN(frame="stargazer", '
                            b'n=2)')[2]) == \
        {"results": [[{"id": 14, "count": 2}, {"id": 19, "count": 1}]]}
    status, _, body = _http(b, "GET", "/status")
    assert status == 200 and json.loads(body)["status"]["state"] == "NORMAL"
    assert json.loads(_http(b, "GET", "/hosts")[2]) == [
        {"host": server.host}]
    status, ctype, body = _http(b, "GET", "/id")
    assert (status, ctype) == (200, "text/plain")
    assert body.decode() == server.holder.local_id and len(body) == 36


def test_python_client_library(server):
    """pilosa_tpu's python-pilosa-shaped client (docs/client-libraries.md)
    against the port's server."""
    client = JClient(f"http://{server.host}")
    schema = JSchema()
    repository = schema.index("repository")
    stargazer = repository.frame("stargazer")
    language = repository.frame("language", range_enabled=True)
    client.sync_schema(schema)
    client.query(repository.batch_query(
        stargazer.setbit(14, 100), stargazer.setbit(14, 200),
        stargazer.setbit(19, 200)))
    assert client.query(stargazer.bitmap(14)).result.bitmap.bits == [100,
                                                                     200]
    q = repository.count(repository.intersect(stargazer.bitmap(14),
                                              stargazer.bitmap(19)))
    assert client.query(q).result.count == 1
    items = client.query(stargazer.topn(5)).result.count_items
    assert [(i.id, i.count) for i in items] == [(14, 2), (19, 1)]
    client._json("POST", "/index/repository/frame/language/field/stars",
                  {"type": "int", "min": 0, "max": 1000})
    client.query(language.set_field_value(100, "stars", 50))
    client.query(language.set_field_value(200, "stars", 20))
    assert client.query(language.sum(field="stars")).result.sum == 70
    assert client.query(language.field("stars") > 30) \
        .result.bitmap.bits == [100]
    with pytest.raises(Exception, match="index already exists"):
        client.create_index(repository)
    assert [i for i in client.schema().indexes()] == ["repository"]


def test_keep_alive_fifty_requests_on_one_connection(server):
    host, port = server.host.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/index/k", b"{}")
        assert conn.getresponse().read() == b"{}"
        conn.request("POST", "/index/k/frame/f", b"{}")
        conn.getresponse().read()
        sock = conn.sock
        for k in range(48):
            body = (f'SetBit(frame="f", rowID=1, columnID={k})' if k % 2
                    else 'Count(Bitmap(frame="f", rowID=1))')
            conn.request("POST", "/index/k/query", body.encode())
            resp = conn.getresponse()
            got = json.loads(resp.read())["results"][0]
            assert got == (True if k % 2 else k // 2)
            assert conn.sock is sock  # the same TCP connection
    finally:
        conn.close()


def _mixed(k):
    """Thread k's requests: writes to its own row, reads of its own row
    and of the shared rows, which no thread writes."""
    row = 100 + k
    out = []
    for j in range(12):
        out.append(_q(f'SetBit(frame="f", rowID={row}, '
                      f'columnID={j * 7919 + k})'))
        out.append(_q(f'Count({_row(row)})'))
        out.append(_q(f'Count(Intersect({_row(0)}, {_row(1)}))'))
        out.append(_q(_row(row)))
        out.append(_q(f'TopN({_row(0)}, frame="f", ids=[0, 1, 2])',
                      proto={}))
    return out


def _send(base, req):
    method, path, body, headers = req
    r = urllib.request.Request(base + path, data=body, method=method,
                               headers=headers)
    with urllib.request.urlopen(r, timeout=60) as resp:
        return resp.status, resp.read()


def _seed(base):
    for req in [_r("POST", "/index/i", {}), _r("POST", "/index/i/frame/f"),
                _import_json("f", 11, 5000)]:
        assert _send(base, req)[0] == 200


def test_eight_threads_equal_serial(tmp_path):
    """Eight clients of mixed reads and writes at once get the answers
    that the same requests get one after another."""
    answers = {}
    for mode in ("serial", "threads"):
        s = Server(str(tmp_path / mode), bind="localhost:0",
                   device="cpu").open()
        base = f"http://{s.host}"
        try:
            _seed(base)
            got = {}
            if mode == "serial":
                for k in range(8):
                    got[k] = [_send(base, r) for r in _mixed(k)]
            else:
                errors = []

                def run(k):
                    try:
                        got[k] = [_send(base, r) for r in _mixed(k)]
                    except Exception as e:  # noqa: BLE001 — re-raised
                        errors.append(e)

                ts = [threading.Thread(target=run, args=(k,))
                      for k in range(8)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in ts)
                assert errors == []
            answers[mode] = got
        finally:
            s.close()
    assert answers["threads"] == answers["serial"]
    assert all(st == 200 for v in answers["serial"].values() for st, _ in v)


def test_body_over_the_limit_gets_413_before_it_is_read(tmp_path):
    s = Server(str(tmp_path / "d"), bind="localhost:0", device="cpu",
               max_body_size=1000).open()
    host, port = s.host.rsplit(":", 1)
    try:
        # Declares 10 MB and sends none of it: the answer comes anyway.
        with socket.create_connection((host, int(port)), timeout=10) as c:
            c.sendall(b"POST /index/i/query HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 10000000\r\n\r\n")
            head = _recv_all(c)
        assert head.startswith(b"HTTP/1.1 413")
        assert head.endswith(b'{"error": "request body too large"}')
        # Expect: 100-continue is refused the same way.
        with socket.create_connection((host, int(port)), timeout=10) as c:
            c.sendall(b"POST /index/i/query HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 5000\r\nExpect: 100-continue\r\n\r\n")
            assert c.recv(4096).startswith(b"HTTP/1.1 413")
        # A chunked body is counted as it arrives: the answer comes when
        # the second chunk's size line crosses the limit, before its data.
        with socket.create_connection((host, int(port)), timeout=10) as c:
            c.sendall(b"POST /index/i/query HTTP/1.1\r\nHost: x\r\n"
                      b"Transfer-Encoding: chunked\r\n\r\n"
                      + b"%x\r\n%s\r\n" % (800, b"x" * 800) + b"320\r\n")
            assert _recv_all(c).startswith(b"HTTP/1.1 413")
        # Under the limit, chunked or not, the request is served.
        status, _, body = _http(f"http://{s.host}", "POST", "/index/i",
                                b"{}")
        assert (status, body) == (200, b"{}")
        with socket.create_connection((host, int(port)), timeout=10) as c:
            c.sendall(b"POST /index/j HTTP/1.1\r\nHost: x\r\n"
                      b"Transfer-Encoding: chunked\r\n\r\n"
                      b"1\r\n{\r\n1\r\n}\r\n0\r\n\r\n")
            assert c.recv(4096).startswith(b"HTTP/1.1 200")
    finally:
        s.close()
    h = THolder(s.data_dir, device="cpu").open()
    assert sorted(h.indexes) == ["i", "j"]
    h.close()


def test_server_without_gpu_raises(tmp_path):
    """The default device is the GPU: without one the server refuses to
    start rather than serve from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(str(tmp_path / "d"))
    assert not os.path.exists(tmp_path / "d")
