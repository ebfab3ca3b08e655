"""pilosa_tpu_torch.querystats against pilosa_tpu.querystats, and the
profiled query surface of both servers, on the CPU.

- The accumulator: the same adds, tier stamps, fallback hops and hedge
  legs, from a numpy seed, encode to the same footer bytes; ``merge`` of
  the same footers (skewed types included), ``served_by`` precedence,
  ``mark``/``served_since``/``falls_since``, the caps of 32 fallbacks and
  64 hedge legs, ``decode`` of bad headers and the scopes behave alike.
- One data directory served in turn by both packages' handlers: a
  ``?profile=true`` Count(Intersect), TopN, Sum and bitmap query answer
  the same ``results`` bytes, the same span-name skeleton down to
  ``call:<name>`` (the port's ``kernel:*`` spans have no counterpart:
  the reference does not trace its batched programs there) and equal
  ``slices``, ``fanoutCalls`` and ``fanoutRetries``.
- The same on a 3-node cluster (replicas 2) of each package, through
  node 1, the trace gathered from every node's ``/debug/traces?traceId=``
  and stitched: one ``remote.<host>`` span a peer leg, that peer's
  ``query.remote`` under it, the merged ``slices`` the query's slice
  count (a TopN's two phases twice). There the reference's TopN misses
  its phase 1 fan-out in ``slices`` and ``fanoutCalls`` (its pool thread
  does not adopt the accumulator); the port's values are pinned.
- ``/debug/traces``: the same keys and the same 400 for a bad ``n``.
- With tracing off and no profile asked, no span and no QueryStats.

Keys that differ because the two packages run different paths are
pinned to the port's own values (``PORT_PINS``): ``blocks`` (the port's
batched stacks read each leaf row of each slice from the host, one block
a row; the reference's BSI planes stage without a row read),
``bytesPopcounted`` (the port charges the
first operand of every count kernel it launches, the reference only its
per-slice popcount dispatches, not its batched programs), ``cacheHits``/
``cacheMisses`` (the reference also counts its lazy row-block memo),
``deviceTransfers``/``deviceTransferBytes`` (the port counts each
upload of staged stacks, one a view's build; the reference its fragment
mirrors' uploads) and ``planMs`` (a time). Tolerance: none.
"""
import json
import threading
from urllib.parse import parse_qs

import numpy as np
import pytest

from pilosa_tpu import querystats as jqs
from pilosa_tpu import tracing as jtr
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.server.handler import Handler as JHandler
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu_torch import querystats as tqs
from pilosa_tpu_torch import tracing as ttr
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.server.handler import Handler as THandler
from pilosa_tpu_torch.storage.holder import Holder as THolder
from test_torch_cluster import SW, Pair, _http

HOST = "localhost:10101"
TIERS = list(jqs.TIER_ORDER) + ["other", "zeta"]


# ---------------------------------------------------------- accumulator

def _ops(seed, n=120):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            key = jqs.KEYS[int(rng.integers(0, len(jqs.KEYS)))]
            ops.append(("add", key, int(rng.integers(0, 1000))))
        elif kind == 1:
            ops.append(("note_tier", TIERS[int(rng.integers(0, len(TIERS)))]))
        elif kind == 2:
            ops.append(("note_fallback", TIERS[int(rng.integers(0, 3))],
                        f"r{int(rng.integers(0, 40))}"))
        else:
            ops.append(("note_hedge", {"host": f"h{int(rng.integers(0, 3))}",
                                       "slices": int(rng.integers(0, 9))}))
    return ops


def _apply(mod, ops):
    qs = mod.QueryStats()
    for op in ops:
        getattr(qs, op[0])(*op[1:])
    return qs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_encode_is_byte_identical(seed):
    ops = _ops(seed)
    j, t = _apply(jqs, ops), _apply(tqs, ops)
    assert tqs.encode(t.to_dict()) == jqs.encode(j.to_dict())
    assert t.served_by() == j.served_by()
    assert tqs.decode(tqs.encode(t.to_dict())) == t.to_dict()


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_matches_reference(seed):
    rng = np.random.default_rng(seed)
    footers = [_apply(jqs, _ops(seed * 10 + k, 30)).to_dict()
               for k in range(4)]
    footers.append({"slices": True, "blocks": "7", "planMs": 1.5,
                    "newKey": 3, jqs.SERVED_KEY: {"memo": 2, "x": True,
                                                  "y": "1"},
                    jqs.FALLBACK_KEY: ["a:b", 3, "a:b", "c:d"],
                    jqs.HEDGE_KEY: [{"host": "h"}, "bad"]})
    footers.append(None)
    footers.append({jqs.SERVED_KEY: [1], jqs.FALLBACK_KEY: "x"})
    base = _ops(int(rng.integers(0, 99)), 20)
    j, t = _apply(jqs, base), _apply(tqs, base)
    for f in footers:
        j.merge(f)
        t.merge(f)
    assert t.to_dict() == j.to_dict()
    assert tqs.encode(t.to_dict()) == jqs.encode(j.to_dict())


def test_served_by_precedence_and_marks():
    rng = np.random.default_rng(7)
    for _ in range(50):
        picks = rng.choice(len(TIERS), int(rng.integers(0, 5)))
        j, t = jqs.QueryStats(), tqs.QueryStats()
        for qs in (j, t):
            for i in picks:
                qs.note_tier(TIERS[i])
        assert t.served_by() == j.served_by()
        mj, mt = j.mark(), t.mark()
        for qs in (j, t):
            qs.note_tier("serial")
            qs.note_fallback("batched", "budget")
        assert t.served_since(mt) == j.served_since(mj) == "serial"
        assert t.falls_since(mt) == j.falls_since(mj)


def test_caps_and_collapsed_hops():
    for mod in (jqs, tqs):
        qs = mod.QueryStats()
        qs.note_fallback("batched", "budget")
        qs.note_fallback("batched", "budget")  # consecutive: one hop
        for i in range(40):
            qs.note_fallback("coalesce", f"r{i}")
        for i in range(70):
            qs.note_hedge({"i": i})
        d = qs.to_dict()
        assert len(d[mod.FALLBACK_KEY]) == mod.MAX_FALLBACKS == 32
        assert d[mod.FALLBACK_KEY][:2] == ["batched:budget", "coalesce:r0"]
        assert len(d[mod.HEDGE_KEY]) == mod.MAX_HEDGE_LEGS == 64
    assert tqs.MAX_FALLBACKS == jqs.MAX_FALLBACKS
    assert tqs.MAX_HEDGE_LEGS == jqs.MAX_HEDGE_LEGS


def test_constants_and_decode_match_reference():
    for name in ("KEYS", "TIER_ORDER", "MAX_FALLBACKS", "MAX_HEDGE_LEGS",
                 "COLLECT_HEADER", "STATS_HEADER", "SERVED_KEY",
                 "FALLBACK_KEY", "HEDGE_KEY"):
        assert getattr(tqs, name) == getattr(jqs, name), name
    for bad in (None, "", "not json", "[1, 2]", "3", '{"a": 1'):
        assert tqs.decode(bad) == jqs.decode(bad)
    assert tqs.decode('{"slices": 2}') == {"slices": 2}


def test_scopes_match_reference():
    for mod in (jqs, tqs):
        assert mod.active() is None
        mod.add("slices", 3)  # nothing active: nothing happens
        outer, inner = mod.QueryStats(), mod.QueryStats()
        with mod.scope(outer):
            assert mod.active() is outer
            mod.add("slices", 2)
            mod.note_tier("batched")
            mod.note_fallback("batched", "plan")
            mod.note_hedge({"h": 1})
            with mod.scope(None):  # the shared no-op keeps outer
                assert mod.active() is outer
            with mod.exclusive_scope(None):  # nobody's
                assert mod.active() is None
                mod.add("slices", 100)
            with mod.exclusive_scope(inner):
                mod.add("blocks", 1)
            seen = []
            th = threading.Thread(target=lambda: seen.append(mod.active()))
            th.start()
            th.join()
            assert seen == [None]  # thread-locals do not cross threads
        assert mod.active() is None
        assert outer.to_dict()["slices"] == 2
        assert inner.to_dict()["blocks"] == 1
    d = [(jqs, jqs.QueryStats()), (tqs, tqs.QueryStats())]
    assert d[0][1].to_dict() == d[1][1].to_dict()


# ------------------------------------------------------------- one node

QUERIES = [
    'Count(Intersect(Bitmap(frame="f", rowID=1), Bitmap(frame="f", '
    'rowID=2)))',
    'TopN(frame="f", n=2)',
    'Sum(frame="b", field="v")',
    'Bitmap(frame="f", rowID=3)',
]
N_SLICES = 3
# The port's own values of the keys whose paths differ, per query (see
# the module docstring); W is a full slice of 32,768 words.
W_BYTES = 32768 * 4
PORT_PINS = {
    # Lanes: rows 1 and 2 of each slice from the container tier (array
    # blocks), the lane kernel charged the pairs' payloads.
    QUERIES[0]: {"blocks": 6, "bytesPopcounted": 1000, "cacheHits": 0,
                 "cacheMisses": 1, "planCacheHit": 0, "deviceTransfers": 0,
                 "deviceTransferBytes": 0},
    # Phase 1 reads host cache counts; phase 2 stacks its 2 candidates
    # (a block each a slice, one upload) and counts each with count_rows.
    QUERIES[1]: {"blocks": 6, "bytesPopcounted": 2 * N_SLICES * W_BYTES,
                 "cacheHits": 0, "cacheMisses": 2, "planCacheHit": 0,
                 "deviceTransfers": 1,
                 "deviceTransferBytes": 2 * N_SLICES * W_BYTES},
    # 7 planes and the not-null row of field v, a block each a slice, one
    # upload, one count_and_rows over the 8 stacks.
    QUERIES[2]: {"blocks": 8 * N_SLICES,
                 "bytesPopcounted": 8 * N_SLICES * W_BYTES,
                 "cacheHits": 0, "cacheMisses": 1, "planCacheHit": 0,
                 "deviceTransfers": 1,
                 "deviceTransferBytes": 8 * N_SLICES * W_BYTES},
    # A serial leaf a slice, then count_rows over the result's stack.
    QUERIES[3]: {"blocks": 3, "bytesPopcounted": N_SLICES * W_BYTES,
                 "cacheHits": 0, "cacheMisses": 0, "planCacheHit": 0,
                 "deviceTransfers": 0, "deviceTransferBytes": 0},
}
SAME_KEYS = ("slices", "fanoutCalls", "fanoutRetries",
             "containerBlocksDense", "containerBlocksArray",
             "containerBlocksRun")


def _q(handler, pql, qs="profile=true", headers=None):
    return handler.dispatch("POST", "/index/i/query", parse_qs(qs),
                            pql.encode(), dict(headers or {}))


def _skeleton(nodes):
    """Span names as a tree, cut below ``call:*`` and without the port's
    ``kernel:*`` and ``fragment.*`` spans."""
    out = []
    for n in nodes:
        if n["name"].startswith(("kernel:", "fragment.")):
            continue
        kids = ([] if n["name"].startswith("call:")
                else _skeleton(n["children"]))
        out.append((n["name"], kids))
    return out


@pytest.fixture(scope="module")
def one_dir(tmp_path_factory):
    """Frames f (rows 1-3 over 3 slices) and b (field v) written through
    the port's handler."""
    d = str(tmp_path_factory.mktemp("qs") / "d")
    h = THolder(d, device="cpu").open()
    hd = THandler(h, TExecutor(h), local_host=HOST)
    try:
        for path, body in (("/index/i", {}), ("/index/i/frame/f", {}),
                           ("/index/i/frame/b", {"options": {
                               "rangeEnabled": True, "fields": [
                                   {"name": "v", "type": "int", "min": 0,
                                    "max": 100}]}})):
            hd.dispatch("POST", path, {}, json.dumps(body).encode(), {})
        rng = np.random.default_rng(0)
        for r, c in zip(rng.integers(1, 4, 200),
                        rng.integers(0, N_SLICES * SW, 200)):
            _q(hd, f'SetBit(frame="f", rowID={r}, columnID={c})', "")
        for c in range(0, N_SLICES * SW, 100003):
            _q(hd, f'SetFieldValue(frame="b", columnID={c}, v={c % 97})',
               "")
    finally:
        h.close()
    return d


def _profiled(pkg, d):
    """Each query's (results bytes, skeleton, resources) through a fresh
    handler of package ``pkg`` over directory ``d``."""
    if pkg == "j":
        h = JHolder(d).open()
        hd = JHandler(h, JExecutor(h), local_host=HOST)
    else:
        h = THolder(d, device="cpu").open()
        hd = THandler(h, TExecutor(h), local_host=HOST)
    try:
        out = []
        for pql in QUERIES:
            status, ctype, payload, extra = _q(hd, pql)
            assert (status, ctype) == (200, "application/json")
            doc = json.loads(payload)
            prof = doc["profile"]
            assert extra["X-Pilosa-Trace-Id"] == prof["traceId"]
            out.append((json.dumps(doc["results"]).encode(),
                        _skeleton(prof["roots"]), prof["resources"]))
        return out
    finally:
        h.close()


def test_profiled_queries_match_reference(one_dir):
    want = _profiled("j", one_dir)
    got = _profiled("t", one_dir)
    for pql, (rj, sj, resj), (rt, st, rest) in zip(QUERIES, want, got):
        assert rt == rj, pql
        assert st == sj, pql
        assert st == [("query", [("parse", []),
                                 (f"call:{pql.split('(')[0]}", [])])]
        for k in SAME_KEYS:
            assert rest[k] == resj[k], (pql, k)
        for k, v in PORT_PINS[pql].items():
            assert rest[k] == v, (pql, k, rest[k])
        assert rest["planMs"] >= 0
        assert set(rest) == set(resj)
    assert [r[2]["slices"] for r in got] == [3, 6, 3, 3]


def test_profile_answers_equal_unprofiled(one_dir):
    h = THolder(one_dir, device="cpu").open()
    hd = THandler(h, TExecutor(h), local_host=HOST)
    try:
        for pql in QUERIES:
            plain = _q(hd, pql, "")
            prof = _q(hd, pql)
            doc = json.loads(prof[2])
            assert plain[:2] == prof[:2]
            assert json.loads(plain[2]) == {"results": doc["results"]}
            # The collect header alone: plain bytes and a footer.
            coll = _q(hd, pql, "", {tqs.COLLECT_HEADER: "1"})
            assert coll[:3] == plain[:3]
            footer = tqs.decode(coll[3][tqs.STATS_HEADER])
            assert set(tqs.KEYS) <= set(footer) and footer[tqs.SERVED_KEY]
        # Tracing on: the same bytes, and every trace kept.
        hd.tracer = ttr.Tracer()
        for pql in QUERIES:
            assert _q(hd, pql, "")[:3] == _q(hd, pql, "", None)[:3]
        assert hd.tracer.summary()["traces"] == 2 * len(QUERIES)
    finally:
        h.close()


def test_no_span_and_no_stats_with_tracing_off(one_dir, monkeypatch):
    made = []
    real = tqs.QueryStats

    def counting():
        made.append(1)
        return real()

    monkeypatch.setattr(tqs, "QueryStats", counting)
    spans = []
    real_span = ttr.Span.__init__

    def span_init(self, *a, **kw):
        spans.append(a[1] if len(a) > 1 else kw.get("name"))
        real_span(self, *a, **kw)

    monkeypatch.setattr(ttr.Span, "__init__", span_init)
    h = THolder(one_dir, device="cpu").open()
    hd = THandler(h, TExecutor(h), local_host=HOST)
    try:
        for pql in QUERIES:
            assert _q(hd, pql, "")[0] == 200
        assert made == [] and spans == []
        assert _q(hd, QUERIES[0])[0] == 200
        assert made == [1] and spans[0] == "query"
    finally:
        h.close()


def test_debug_traces_match_reference(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ja, tb = JHolder(a).open(), THolder(b, device="cpu").open()
    try:
        pairs = [(JHandler(ja, JExecutor(ja), local_host=HOST),
                  THandler(tb, TExecutor(tb), local_host=HOST))]
        for mod, hd in ((jtr, pairs[0][0]), (ttr, pairs[0][1])):
            hd.dispatch("POST", "/index/i", {}, b"{}", {})
            hd.dispatch("POST", "/index/i/frame/f", {}, b"{}", {})
        for qp in ("", "n=abc", "n=0", "n=9999", "slow=true",
                   "traceId=nope", "n=2.5"):
            got = [hd.dispatch("GET", "/debug/traces", parse_qs(qp), b"",
                               {})[:3] for hd in pairs[0]]
            assert got[1] == got[0], qp
        # Tracing on in both: the same keys and masked trees.
        jt, tt = jtr.Tracer(stats=None, slow_threshold=0), ttr.Tracer(
            slow_threshold=0)
        pairs[0][0].tracer, pairs[0][1].tracer = jt, tt
        for hd in pairs[0]:
            _q(hd, 'SetBit(frame="f", rowID=1, columnID=3)', "")
            _q(hd, 'Count(Bitmap(frame="f", rowID=1))', "")
        docs = [json.loads(hd.dispatch("GET", "/debug/traces",
                                       parse_qs("n=1&slow=true"), b"",
                                       {})[2]) for hd in pairs[0]]
        assert set(docs[1]) == set(docs[0])
        assert docs[1]["enabled"] is docs[0]["enabled"] is True
        assert docs[1]["slowThresholdMs"] == docs[0]["slowThresholdMs"]
        assert set(docs[1]["summary"]) == set(docs[0]["summary"])
        tj, tt_ = docs[0]["traces"][0], docs[1]["traces"][0]
        # The reference's slow trace may carry its sampling profiler's
        # stacks ("profile"), which the port has not ported.
        assert set(tt_) == set(tj) - {"profile"}
        assert _skeleton(tt_["roots"]) == _skeleton(tj["roots"])
    finally:
        ja.close()
        tb.close()


# -------------------------------------------------------------- cluster

CLUSTER_QUERIES = QUERIES[:2] + [QUERIES[3]]


def _gather(hosts, trace_id):
    traces = []
    for h in hosts:
        doc = json.loads(_http(h, "GET",
                               f"/debug/traces?traceId={trace_id}")[2])
        traces.extend(doc["traces"])
    return traces


@pytest.fixture(scope="module")
def traced_pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("PILOSA_TRACE_ENABLED", "1")
    p = Pair(tmp_path_factory.mktemp("traced"), 3, 2)
    mp.undo()
    try:
        p.same(0, "POST", "/index/i", {})
        p.same(0, "POST", "/index/i/frame/f", {})
        rng = np.random.default_rng(3)
        rows = rng.integers(1, 4, 600)
        cols = rng.integers(0, 6 * SW, 600)
        p.import_bits("f", rows, cols)
        for s in p.j + p.t:
            s.cluster.node_set.probe_once()
            s.executor._result_memo_off = True  # every query fans out
        yield p
    finally:
        p.close_all()


@pytest.mark.parametrize("pql", CLUSTER_QUERIES)
def test_stitched_cluster_profile_matches_reference(traced_pair, pql):
    p = traced_pair
    out = {}
    for pkg, hosts, mod in (("j", p.jh, jtr), ("t", p.th, ttr)):
        st, _, body = _http(hosts[0], "POST",
                            "/index/i/query?profile=true", pql)
        assert st == 200
        doc = json.loads(body)
        prof = doc["profile"]
        stitched = mod.stitch(_gather(hosts, prof["traceId"]))
        out[pkg] = (json.dumps(doc["results"]), prof, stitched)
    (rj, pj, _), (rt, pt, st_) = out["j"], out["t"]
    assert rt == rj
    assert _skeleton(pt["roots"]) == _skeleton(pj["roots"])
    assert pt["resources"]["fanoutRetries"] == pj["resources"][
        "fanoutRetries"] == 0
    if pql.startswith("TopN"):
        # Phase 1 and phase 2 each count every slice once. The reference
        # runs phase 1's remote part on a pool thread that does not adopt
        # the query's accumulator, so its counts miss that part: pinned.
        assert pt["resources"]["slices"] == 2 * 6
        assert pj["resources"]["slices"] < pt["resources"]["slices"]
        assert pj["resources"]["fanoutCalls"] < pt["resources"][
            "fanoutCalls"]
    else:
        for k in ("slices", "fanoutCalls"):
            assert pt["resources"][k] == pj["resources"][k], k
        assert pt["resources"]["slices"] == 6
    # The stitched tree: one remote.<host> span a peer leg, that peer's
    # query.remote under it, and fanoutCalls the number of peer legs.
    spans = st_["spans"]
    legs = [s for s in spans if s["name"].startswith("remote.")
            and s["name"] != "remote.round"]
    peers = {s["tags"]["host"] for s in legs}
    assert p.th[0] not in peers and peers <= set(p.th[1:])
    assert len(legs) == pt["resources"]["fanoutCalls"]
    by_id = {s["spanId"]: s for s in spans}
    remote_roots = [s for s in spans if s["name"] == "query.remote"]
    assert len(remote_roots) == len(legs)
    for r in remote_roots:
        up = by_id[r["parentId"]]
        while not up["name"].startswith("remote.") or \
                up["name"] == "remote.round":
            up = by_id[up["parentId"]]
        assert up["tags"]["host"] in peers
        assert r["tags"]["host"] == up["tags"]["host"]
    assert len(st_["roots"]) == 1 and st_["roots"][0]["name"] == "query"
