"""Bulk ingest and keyed imports through the port's static cluster
against pilosa_tpu's, on the CPU.

- ``POST /index/{i}/ingest`` through every node of in-process clusters
  of 2 nodes (replicas 1 and 2) and 3 nodes (replicas 2) of each
  package, binary and JSON bodies of bits (with timestamps, and into an
  inverse-enabled frame) and of values: the same response bytes, then the
  same bytes of Count, TopN, Sum, Max, time Range and bitmap reads through
  every node, the Counts equal to numpy, each owner of each slice holding
  its bits, and the same ingest counters (``fanoutPostsTotal``) on every
  node.
- A ``?slice=`` leg to a node that does not own the slice: 412 in both.
- An owner that is closed, then held DOWN by membership, fails the
  request in both (500); nothing is hinted.
- A keyed ``/import`` (JSON and protobuf) through a node that is not the
  key authority: the same response bytes, the same key→id maps on the
  authority, the same query bytes through every node.

Tolerance: none, every byte equal.
"""
import json

import numpy as np
import pytest

from pilosa_tpu.ingest import codec as jcodec
from pilosa_tpu.server import wireproto as jwp
from pilosa_tpu_torch.executor import ExecOptions
from test_torch_cluster import CONFIGS, PB, SW, Pair, _http

CT = jcodec.CONTENT_TYPE
N_SLICES = 5
TS0 = 1496275200  # 2017-06-01T00:00 UTC


def _bm(r, frame="f"):
    return f'Bitmap(frame="{frame}", rowID={r})'


QUERIES = [
    f"Count({_bm(1)})",
    f"Count(Intersect({_bm(1)}, {_bm(2)}))",
    'TopN(frame="f", n=4)',
    'TopN(frame="inv", n=3)',
    f"Count({_bm(2, 'inv')})",
    'Count(Range(frame="t", rowID=3, start="2017-06-01T00:00", '
    'end="2017-06-03T00:00"))',
    'Range(frame="t", rowID=3, start="2017-06-02T00:00", '
    'end="2017-06-04T00:00")',
    'Sum(frame="b", field="v")',
    'Max(frame="b", field="v")',
    'Count(Range(frame="b", v > 500))',
    _bm(4),
]


def _schema(p):
    p.same(0, "POST", "/index/i", {})
    p.same(0, "POST", "/index/i/frame/f", {})
    p.same(p.n - 1, "POST", "/index/i/frame/inv",
           {"options": {"inverseEnabled": True}})
    p.same(0, "POST", "/index/i/frame/t",
           {"options": {"timeQuantum": "YMD"}})
    p.same(p.n - 1, "POST", "/index/i/frame/b", {"options": {
        "rangeEnabled": True,
        "fields": [{"name": "v", "type": "int", "min": -5, "max": 1000}]}})
    p.same(0, "POST", "/index/i/frame/k", {})


@pytest.fixture(scope="module", params=list(CONFIGS))
def ingest_pair(request, tmp_path_factory):
    n, r = CONFIGS[request.param]
    p = Pair(tmp_path_factory.mktemp(request.param), n, r)
    try:
        _schema(p)
        yield p
    finally:
        p.close_all()


def _owners(p, s):
    """Node numbers owning slice ``s`` (the same in both packages)."""
    cl = p.t[0].cluster
    return [p.th.index(n.host) for n in cl.fragment_nodes("i", s)]


def test_ingest_through_every_node_matches_reference(ingest_pair):
    p = ingest_pair
    rng = np.random.default_rng(p.n * 10 + p.replicas)
    truth = {r: set() for r in range(1, 7)}
    inv_truth = {}
    vals = {}
    for k in range(p.n):
        rows = rng.integers(1, 7, 3000)
        cols = rng.integers(0, N_SLICES * SW, 3000)
        for r, c in zip(rows.tolist(), cols.tolist()):
            truth[r].add(c)
        half = 1500
        st = p.same(k, "POST", "/index/i/ingest", {
            "frame": "f", "rows": rows[:half].tolist(),
            "columns": cols[:half].tolist()})
        assert st[0] == 200, st
        assert json.loads(st[2])["accepted"] == half
        assert p.same(k, "POST", "/index/i/ingest", jcodec.encode_bits(
            "f", rows[half:], cols[half:]), CT)[0] == 200
        ts = rng.integers(TS0, TS0 + 5 * 86400, 400)
        ts[::3] = 0
        tcols = rng.integers(0, N_SLICES * SW, 400)
        assert p.same(k, "POST", "/index/i/ingest", jcodec.encode_bits(
            "t", np.full(400, 3), tcols, ts), CT)[0] == 200
        assert p.same(k, "POST", "/index/i/ingest", {
            "frame": "t", "rows": [3, 3], "columns": [k, SW + k],
            "timestamps": [TS0 + 86400, None]})[0] == 200
        irows = rng.integers(1, 4, 300)
        icols = rng.integers(0, N_SLICES * SW, 300)
        for r, c in zip(irows.tolist(), icols.tolist()):
            inv_truth.setdefault(r, set()).add(c)
        assert p.same(k, "POST", "/index/i/ingest", jcodec.encode_bits(
            "inv", irows, icols), CT)[0] == 200
        vcols = rng.choice(N_SLICES * SW, 200, replace=False)
        vv = rng.integers(-5, 1001, 200)
        vals.update(zip(vcols.tolist(), vv.tolist()))
        assert p.same(k, "POST", "/index/i/ingest", jcodec.encode_values(
            "b", "v", vcols[:100], vv[:100]), CT)[0] == 200
        assert p.same(k, "POST", "/index/i/ingest", {
            "frame": "b", "field": "v", "columns": vcols[100:].tolist(),
            "values": vv[100:].tolist()})[0] == 200
        # Caller faults answer as pilosa_tpu's.
        for body, ctype in (({"frame": "nope", "rows": [1],
                              "columns": [1]}, None),
                            ({"frame": "f", "rows": [1, 2],
                              "columns": [1]}, None),
                            (b"\x00garbage", CT)):
            jr, tr = p.both(k, "POST", "/index/i/ingest", body, ctype)
            assert tr == jr and tr[0] >= 400
    for s in p.j + p.t:
        s.cluster.node_set.probe_once()
    for k in range(p.n):
        for q in QUERIES:
            st = p.same(k, "POST", "/index/i/query", q)
            assert st[0] == 200, (q, st)
        p.same(k, "POST", "/index/i/query",
               jwp.encode_query_request(QUERIES[1]), PB, PB)
        got = json.loads(_http(p.th[k], "POST", "/index/i/query",
                               QUERIES[1])[2])
        assert got == {"results": [len(truth[1] & truth[2])]}
        got = json.loads(_http(p.th[k], "POST", "/index/i/query",
                               QUERIES[4])[2])
        assert got == {"results": [len(inv_truth.get(2, ()))]}
        got = json.loads(_http(p.th[k], "POST", "/index/i/query",
                               QUERIES[7])[2])
        assert got == {"results": [{"sum": sum(vals.values()),
                                    "count": len(vals)}]}
        jd = json.loads(_http(p.jh[k], "GET", "/debug/vars")[2])["ingest"]
        td = json.loads(_http(p.th[k], "GET", "/debug/vars")[2])["ingest"]
        assert td == jd
    assert sum(json.loads(_http(h, "GET", "/debug/vars")[2])["ingest"][
        "fanoutPostsTotal"] for h in p.th) > 0
    # Every owner of every slice holds the slice's bits.
    for s in range(N_SLICES):
        want = len([c for c in truth[1] if c // SW == s])
        for k in _owners(p, s):
            got = p.t[k].executor.execute(
                "i", f"Count({_bm(1)})", slices=[s],
                opt=ExecOptions(remote=True))
            assert got == [want], (s, k)


def test_slice_leg_to_a_non_owner_answers_412(ingest_pair):
    p = ingest_pair
    body = jcodec.encode_bits("f", [9, 9], [3 * SW + 1, 3 * SW + 2])
    owners = _owners(p, 3)
    for k in range(p.n):
        jr, tr = p.both(k, "POST", "/index/i/ingest?slice=3", body, CT)
        assert tr == jr
        if k in owners:
            assert tr[0] == 200
        else:
            assert tr == (412, "application/json",
                          b'{"error": "host does not own slice"}')
    jr, tr = p.both(0, "POST", "/index/i/ingest?slice=x", body, CT)
    assert tr == jr and tr[0] == 400


def test_keyed_import_goes_through_the_authority(ingest_pair):
    p = ingest_pair
    rng = np.random.default_rng(7)
    rkeys = [f"term-{int(i)}" for i in rng.integers(0, 40, 3000)]
    ckeys = [f"user-{int(i)}" for i in rng.integers(0, 2500, 3000)]
    auth = {pkg: min(range(p.n), key=lambda k: hosts[k])
            for pkg, hosts in (("j", p.jh), ("t", p.th))}
    sent = []
    for pkg, hosts in (("j", p.jh), ("t", p.th)):
        via = [k for k in range(p.n) if k != auth[pkg]]
        body = {"index": "i", "frame": "k", "rowKeys": rkeys[:2000],
                "columnKeys": ckeys[:2000]}
        st = _http(hosts[via[0]], "POST", "/import", body)
        pb = jwp.encode_import_request(
            "i", "k", 0, [], [], None, row_keys=rkeys[2000:],
            column_keys=ckeys[2000:])
        st2 = _http(hosts[via[-1]], "POST", "/import", pb, PB)
        # Through the authority itself.
        st3 = _http(hosts[auth[pkg]], "POST", "/import", {
            "index": "i", "frame": "k", "rowKeys": ["term-new"],
            "columnKeys": ["user-new"]})
        sent.append((st, st2, st3))
    assert sent[0] == sent[1]
    assert sent[1][0] == (200, "application/json", b"{}")

    def maps(holder):
        idx = holder.index("i")
        rk = sorted(set(rkeys)) + ["term-new"]
        ck = sorted(set(ckeys)) + ["user-new"]
        return (dict(zip(rk, idx.frame("k").row_key_store.translate(rk))),
                dict(zip(ck, idx.column_key_store.translate(ck))))

    tmaps = maps(p.t[auth["t"]].holder)
    assert tmaps == maps(p.j[auth["j"]].holder)
    rid, cid = tmaps
    for k in range(p.n):
        for q in ('TopN(frame="k", n=5)', f'Count({_bm(rid["term-3"], "k")})',
                  _bm(rid["term-new"], "k")):
            assert p.same(k, "POST", "/index/i/query", q)[0] == 200
        term = rkeys[0]
        want = len({cid[c] for r, c in zip(rkeys, ckeys) if r == term})
        got = json.loads(_http(p.th[k], "POST", "/index/i/query",
                               f'Count({_bm(rid[term], "k")})')[2])
        assert got == {"results": [want]}


def test_down_owner_fails_the_ingest(tmp_path):
    p = Pair(tmp_path, 2, 1)
    try:
        _schema(p)
        rng = np.random.default_rng(3)
        body = jcodec.encode_bits("f", rng.integers(1, 4, 500),
                                  rng.integers(0, N_SLICES * SW, 500))
        assert p.same(0, "POST", "/index/i/ingest", body, CT)[0] == 200
        p.close(1)
        jr, tr = p.both(0, "POST", "/index/i/ingest", body, CT)
        assert (tr[0], tr[1]) == (jr[0], jr[1]) == (500, "application/json")
        for s in (p.j[0], p.t[0]):
            s.cluster.node_set.suspect_after = 1
            s.cluster.node_set.probe_once()
            assert s.cluster.node_set.is_down(s.cluster.nodes[1].host)
        jr, tr = p.both(0, "POST", "/index/i/ingest", body, CT)
        assert (tr[0], tr[1]) == (jr[0], jr[1]) == (500, "application/json")
        jr, tr = p.both(0, "POST", "/index/i/ingest", {
            "frame": "b", "field": "v", "columns": [1, 4 * SW + 1],
            "values": [3, 4]})
        assert (tr[0], tr[1]) == (jr[0], jr[1]) == (500, "application/json")
        assert not p.t[0].executor.pending_hint_hosts()
        snap = json.loads(_http(p.th[0], "GET", "/debug/vars")[2])["ingest"]
        assert snap["errorsTotal"] == 3
    finally:
        p.close_all()


def test_topn_after_ingest_stages_held_slices_in_one_upload(tmp_path):
    """A cluster TopN over every row of a frame right after an ingest
    (chip_smoke phase 12 (c)'s shape, small): the same bytes as the
    reference's and equal to numpy. The index spans 41 slices (frame f
    holds a bit in the last), frame w only the first N_SLICES: each node
    stages its phase-2 candidates on the slices where w has a fragment
    alone, and uploads them in ONE transfer, not one a candidate
    (``deviceTransfers``/``deviceTransferBytes`` in the profile, merged
    over the nodes). On an H100, staging 1,024 candidates over every
    slice of a 512-slice index moved 34.5 GB and took the TopN 18.7 s;
    over the 32 slices that hold the frame, 4.3 GB and 2.6 s."""
    p = Pair(tmp_path, 3, 2)
    try:
        p.same(0, "POST", "/index/i", {})
        p.same(0, "POST", "/index/i/frame/w", {})
        p.same(0, "POST", "/index/i/frame/f", {})
        last = 40
        assert p.same(0, "POST", "/index/i/query",
                      f'SetBit(frame="f", rowID=1, columnID={last * SW + 1})'
                      )[0] == 200
        n_rows = 64
        rng = np.random.default_rng(21)
        rows = rng.integers(0, n_rows, 20000)
        cols = rng.integers(0, N_SLICES * SW, 20000)
        assert p.same(1, "POST", "/index/i/ingest", jcodec.encode_bits(
            "w", rows, cols), CT)[0] == 200
        for s in p.j + p.t:
            s.cluster.node_set.probe_once()
            s.executor._result_memo_off = True  # every TopN fans out
        pql = f'TopN(frame="w", n={n_rows})'
        st, _, body = _http(p.th[0], "POST", "/index/i/query?profile=true",
                            pql)
        assert st == 200
        doc = json.loads(body)
        bits = {(int(r), int(c)) for r, c in zip(rows, cols)}
        per_row = np.bincount([r for r, _ in bits], minlength=n_rows)
        want = sorted(((r, int(c)) for r, c in enumerate(per_row) if c),
                      key=lambda rc: (-rc[1], rc[0]))
        assert [(x["id"], x["count"]) for x in doc["results"][0]] == want
        # Phase 2 stages every row on each node's primary slices that
        # hold frame w, one upload a node; phase 1 reads host counts.
        cl = p.t[0].cluster
        primaries = {cl.fragment_nodes("i", s)[0].host
                     for s in range(N_SLICES)}
        res = doc["profile"]["resources"]
        assert res["slices"] == 2 * (last + 1)
        assert res["deviceTransfers"] == len(primaries)
        assert res["deviceTransferBytes"] == n_rows * N_SLICES * SW // 8
        assert res["fanoutRetries"] == 0
        # Warm: the stacks are cached, nothing is uploaded again.
        doc = json.loads(_http(p.th[0], "POST",
                               "/index/i/query?profile=true", pql)[2])
        assert doc["profile"]["resources"]["deviceTransfers"] == 0
        assert p.same(0, "POST", "/index/i/query", pql)[0] == 200
    finally:
        p.close_all()
