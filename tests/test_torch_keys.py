"""Port parity for key stores and input definitions (pilosa_tpu's
storage/translate.py, storage/inputdef.py, the key stores of Frame and
Index, keyed ``/import``, ``cli import -k`` and the
``/index/{i}/input-definition/{def}`` and ``/index/{i}/input/{def}``
routes).

- ``TranslateStore``: the same ids for the same keys, dense from 0 in
  first-seen order, past sqlite's parameter chunk; a ``.keys`` file
  written by one package is read by the other, and either extends it.
- The keyed ImportRequest's protobuf bytes.
- Keyed ``/import`` (JSON and protobuf, with timestamps) through each
  package's handler: status and body byte-equal, the same ids in the
  key stores, the same fragment files; 400 on mismatched lengths.
- Input definitions: create, get, delete and ``/input`` give the same
  statuses and bodies (the error catalog too, and the reference's 500
  for camelCase frame options), the same stored JSON and the same bits;
  a reopened directory keeps its definitions.
- ``cli import -k`` of one CSV by each package's CLI into its own server:
  the same keyed ids and counts.

Tolerance: none, every byte equal.
"""
import json
import os
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest

from pilosa_tpu.cli.__main__ import main as jcli
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.server import wireproto as jwp
from pilosa_tpu.server.handler import Handler as JHandler
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu.storage.translate import TranslateStore as JStore
from pilosa_tpu_torch.cli.__main__ import main as tcli
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.server import wireproto as twp
from pilosa_tpu_torch.server.handler import Handler as THandler
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.storage.holder import Holder as THolder
from pilosa_tpu_torch.storage.translate import TranslateStore as TStore

TS0 = 1496275200  # 2017-06-01T00:00 UTC
PB = "application/x-protobuf"


def _keys(seed, n, n_rows=30, n_cols=5000):
    rng = np.random.default_rng(seed)
    return ([f"row-{k}" for k in rng.integers(0, n_rows, n)],
            [f"user-{k}" for k in rng.integers(0, n_cols, n)])


# -------------------------------------------------------------- the store

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_keys_file_is_shared(tmp_path, writer):
    """Either package writes the .keys file; the other reads the same ids
    and allocates the next ones as the writer would."""
    a, b = (JStore, TStore) if writer == "jax" else (TStore, JStore)
    path = str(tmp_path / ".keys")
    keys = [f"k{i % 1500}" for i in range(2500)] + ["", "é"]
    first = a(path).open()
    ids = first.translate(keys)
    first.close()
    assert ids[:1500] == list(range(1500)) and ids[-2:] == [1500, 1501]
    other = b(path).open()
    assert other.translate(keys) == ids
    assert other.key_of(7) == "k7" and other.key_of(99999) is None
    assert other.translate(["new", "k3"]) == [1502, 3]
    other.close()
    again = a(path).open()
    assert again.translate(["new"]) == [1502]
    again.close()


# --------------------------------------------------------- keyed import

def _dispatch(handler, method, path, body=b"", ctype=None):
    u = urlparse(path)
    headers = {"Content-Type": ctype} if ctype else {}
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    return tuple(handler.dispatch(method, u.path, parse_qs(u.query), body,
                                  headers)[:3])


def _pair(tmp_path):
    j = JHolder(str(tmp_path / "j")).open()
    t = THolder(str(tmp_path / "t"), device="cpu").open()
    return j, t, JHandler(j, JExecutor(j)), THandler(t, TExecutor(t))


def _fragment_files(root):
    out = {}
    for d, _, files in os.walk(root):
        if os.path.basename(d) == "fragments" or \
                os.path.basename(d) == ".input-definitions":
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = \
                        fh.read()
    return out


def _keyed_script():
    rk, ck = _keys(1, 4000)
    rk2, ck2 = _keys(2, 300)
    ts = [TS0 + 86400 * (k % 4) if k % 3 else 0 for k in range(300)]
    q = "/index/i/query"
    return [
        ("POST", "/index/i", {"options": {"timeQuantum": "YMD"}}),
        ("POST", "/index/i/frame/f", {}),
        ("POST", "/index/i/frame/t", {}),
        ("POST", "/import", {"index": "i", "frame": "f", "rowKeys": rk,
                             "columnKeys": ck}),
        ("POST", "/import", twp.encode_import_request(
            "i", "t", 0, [], [], ts, row_keys=rk2, column_keys=ck2), PB),
        ("POST", "/import", {"index": "i", "frame": "f",
                             "rowKeys": ["a", "b"], "columnKeys": ["c"]}),
        ("POST", "/import", {"index": "i", "frame": "f", "rowKeys": ["a"],
                             "columnKeys": ["c"], "timestamps": [1, 2]}),
        ("POST", "/import", {"index": "i", "frame": "nope",
                             "rowKeys": ["a"], "columnKeys": ["c"]}),
        ("POST", "/import", {"index": "i", "frame": "f",
                             "rowKeys": [""], "columnKeys": ["x", "y"]}),
        ("POST", q, 'Count(Bitmap(frame="f", rowID=0))'),
        ("POST", q, 'TopN(frame="f", n=5)'),
        ("POST", q, 'Bitmap(frame="f", rowID=3)'),
        ("POST", q, 'Count(Range(frame="t", rowID=1, '
                    'start="2017-06-01T00:00", end="2017-06-03T00:00"))'),
    ]


def test_keyed_import_request_bytes_match():
    """ImportRequest with RowKeys/ColumnKeys (empty keys kept in place)
    encodes to pilosa_tpu's bytes and decodes back."""
    args = ("i", "f", 0, [], [], [TS0, 0, 5])
    kw = {"row_keys": ["a", "", "é"], "column_keys": ["x", "y", ""]}
    body = twp.encode_import_request(*args, **kw)
    assert body == jwp.encode_import_request(*args, **kw)
    got = twp.decode_import_request(body)
    assert (got["rowKeys"], got["columnKeys"]) == (kw["row_keys"],
                                                   kw["column_keys"])
    assert twp.encode_import_request("i", "f", 3, [1], [2]) == \
        jwp.encode_import_request("i", "f", 3, [1], [2])


def test_keyed_import_matches_reference(tmp_path):
    j, t, jh, th = _pair(tmp_path)
    for method, path, *rest in _keyed_script():
        body = rest[0] if rest else b""
        ctype = rest[1] if len(rest) > 1 else None
        got = _dispatch(th, method, path, body, ctype)
        assert got == _dispatch(jh, method, path, body, ctype), path
    rk, ck = _keys(1, 4000)
    for h in (j, t):
        idx = h.index("i")
        assert idx.frame("f").row_key_store.translate(rk[:50]) == \
            j.index("i").frame("f").row_key_store.translate(rk[:50])
        assert idx.column_key_store.translate(ck[:50]) == \
            j.index("i").column_key_store.translate(ck[:50])
    want = dict.fromkeys(rk)  # first-seen order, dense from 0
    assert t.index("i").frame("f").row_key_store.translate(list(want)) == \
        list(range(len(want)))
    j.close()
    t.close()
    assert _fragment_files(t.path) == _fragment_files(j.path)


def test_reopened_key_stores_agree(tmp_path):
    """The stores a package wrote, read by the other after a reopen."""
    j, t, jh, th = _pair(tmp_path)
    rk, ck = _keys(3, 2000)
    for h in (jh, th):
        _dispatch(h, "POST", "/index/i", {})
        _dispatch(h, "POST", "/index/i/frame/f", {})
        _dispatch(h, "POST", "/import", {"index": "i", "frame": "f",
                                         "rowKeys": rk, "columnKeys": ck})
    j.close()
    t.close()
    ids = {}
    for name, H, kw, path in (("t_reads_j", THolder, {"device": "cpu"},
                               j.path),
                              ("j_reads_t", JHolder, {}, t.path)):
        h = H(path, **kw).open()
        idx = h.index("i")
        ids[name] = (idx.frame("f").row_key_store.translate(rk),
                     idx.column_key_store.translate(ck))
        h.close()
    assert ids["t_reads_j"] == ids["j_reads_t"]


# ---------------------------------------------------- input definitions

DEF = {
    "frames": [{"name": "event", "options": {"cache_type": "ranked"}}],
    "fields": [
        {"name": "user_id", "primaryKey": True, "actions": []},
        {"name": "kind", "actions": [
            {"frame": "event", "valueDestination": "mapping",
             "valueMap": {"click": 0, "view": 1, "buy": 2}}]},
        {"name": "active", "actions": [
            {"frame": "event", "valueDestination": "single-row-boolean",
             "rowID": 10}]},
        {"name": "score", "actions": [
            {"frame": "event", "valueDestination": "value-to-row"}]},
        {"name": "when", "actions": [
            {"frame": "event", "valueDestination": "set-timestamp"}]},
    ],
}


def _records(seed, n):
    rng = np.random.default_rng(seed)
    kinds = ("click", "view", "buy")
    return [{"user_id": int(u), "kind": kinds[k], "active": bool(a),
             "score": int(s)}
            for u, k, a, s in zip(rng.integers(0, 50_000, n),
                                  rng.integers(0, 3, n),
                                  rng.integers(0, 2, n),
                                  rng.integers(20, 40, n))]


def _def_script():
    base = "/index/users/input-definition"
    bad = json.loads(json.dumps(DEF))
    bad["frames"][0]["options"] = {"cacheType": "ranked"}
    two = json.loads(json.dumps(DEF))
    two["fields"][1]["primaryKey"] = True
    nokey = json.loads(json.dumps(DEF))
    nokey["fields"][0]["name"] = "uid"
    nomap = json.loads(json.dumps(DEF))
    del nomap["fields"][1]["actions"][0]["valueMap"]
    q = "/index/users/query"
    return [
        ("POST", "/index/users", {"options": {"columnLabel": "user_id"}}),
        ("POST", f"{base}/camel", bad),                              # 500
        ("POST", f"{base}/events", DEF),
        ("POST", f"{base}/events", DEF),                             # 400
        ("POST", f"{base}/two", two),
        ("POST", f"{base}/nokey", nokey),
        ("POST", f"{base}/nomap", nomap),
        ("POST", f"{base}/empty", {"frames": [], "fields": []}),
        ("POST", f"{base}/noname", {"frames": [{}], "fields": []}),
        ("POST", "/index/nope/input-definition/x", DEF),             # 404
        ("GET", f"{base}/events"),
        ("GET", f"{base}/nope"),
        ("POST", "/index/users/input/events", _records(4, 300)),
        ("POST", "/index/users/input/events",
         [{"user_id": 3, "kind": "buy", "when": TS0}]),
        ("POST", "/index/users/input/events", [{"kind": "buy"}]),
        ("POST", "/index/users/input/events",
         [{"user_id": 1, "kind": "sell"}]),
        ("POST", "/index/users/input/events",
         [{"user_id": 1, "active": "yes"}]),
        ("POST", "/index/users/input/nope", []),
        ("POST", q, 'TopN(frame="event", n=20)'),
        ("POST", q, 'Count(Bitmap(frame="event", rowID=10))'),
        ("POST", q, 'Bitmap(frame="event", rowID=2)'),
        ("DELETE", f"{base}/two"),
        ("DELETE", f"{base}/two"),                                   # 400
        ("GET", "/schema"),
    ]


def test_input_definitions_match_reference(tmp_path):
    j, t, jh, th = _pair(tmp_path)
    seen = set()
    for method, path, *rest in _def_script():
        body = rest[0] if rest else b""
        got = _dispatch(th, method, path, body)
        assert got == _dispatch(jh, method, path, body), (method, path)
        seen.add(got[0])
    assert {200, 400, 404, 500} <= seen
    j.close()
    t.close()
    files = _fragment_files(t.path)
    assert "users/.input-definitions/events" in files
    assert files == _fragment_files(j.path)
    # Reopened by the other package: the definitions load as stored.
    stored = []
    for H, kw, path in ((THolder, {"device": "cpu"}, j.path),
                        (JHolder, {}, t.path)):
        h = H(path, **kw).open()
        idx = h.index("users")
        stored.append((sorted(idx.input_definitions),
                       idx.input_definition("events").to_dict()))
        h.close()
    assert stored[0] == stored[1] and stored[0][0] == ["events"]
    assert stored[0][1]["frames"] == DEF["frames"]


# ------------------------------------------------------------ cli -k

def test_cli_import_keys_matches_reference(tmp_path):
    rk, ck = _keys(5, 10_000, n_rows=12, n_cols=3000)
    path = tmp_path / "keys.csv"
    lines = [f"{r},{c}" + (f",{TS0 + 3600 * (k % 30)}" if k % 4 == 0
                           else "")
             for k, (r, c) in enumerate(zip(rk, ck))]
    lines[7] = f"{rk[7]},{ck[7]},2017-06-02T10:00"
    path.write_text("\n".join(lines) + "\n")
    answers = {}
    for name, S, cli, kw in (("jax", JServer, jcli, {}),
                             ("torch", TServer, tcli, {"device": "cpu"})):
        s = S(str(tmp_path / name), bind="localhost:0", **kw).open()
        try:
            req = {"options": {"timeQuantum": "YMD"}}
            _dispatch(s.handler, "POST", "/index/i", req)
            _dispatch(s.handler, "POST", "/index/i/frame/f", req)
            assert cli(["import", "--host", s.host, "-i", "i", "-f", "f",
                        "-k", "--buffer-size", "40000", str(path)]) in (
                0, None)
            assert cli(["import", "--host", s.host, "-i", "i", "-f", "f",
                        "-k", "-e", "v", str(path)]) == 1
            idx = s.holder.index("i")
            answers[name] = [
                idx.frame("f").row_key_store.translate(rk[:100]),
                idx.column_key_store.translate(ck[:100])] + [
                _dispatch(s.handler, "POST", "/index/i/query", q)
                for q in ('TopN(frame="f", n=12)',
                          'Count(Bitmap(frame="f", rowID=4))',
                          'Count(Range(frame="f", rowID=1, '
                          'start="2017-06-01T00:00", '
                          'end="2017-06-02T00:00"))')]
        finally:
            s.close()
    assert answers["torch"] == answers["jax"]
    assert json.loads(answers["torch"][3][2])["results"][0] > 0
