"""The port's static cluster against pilosa_tpu's, on the CPU.

- Placement: ``fragment_nodes``, ``partition`` and ``owns_slices`` of
  the port's ``Cluster`` equal pilosa_tpu's for 1-5 hosts, replicas 1-3,
  the jump and the modulo hasher, over 1,000 seeded (index, slice) pairs.
- Wire: every cluster message, the max-slices map, a schema index, a
  node status and a cluster status encode to pilosa_tpu's bytes and
  decode back.
- Serving: in-process clusters of 2 nodes (replicas 1 and 2) and 3 nodes
  (replicas 2) of each package get the same DDL, PQL writes through every
  node, protobuf imports to each slice's owners and attribute writes;
  every query is then sent through every node of both, and the response
  status, content type and body bytes must be equal (Count trees, TopN
  with and without ``ids`` and attribute filters, Sum/Average/Min/Max
  with a node that holds no value, Count(Range), bitmaps with attributes,
  a time Range), and the Counts equal numpy.
- Failover: a node of the 3-node clusters closed mid-stream (still
  believed live: its legs fail and remap to replicas), then declared DOWN
  by a membership round (writes to it are hinted), then restarted and
  seen again (the schema push and the hinted writes replayed): the same
  bytes through every live node at each stage. With replicas 1 and a node
  down, both answer 500.
- A port node in its own process (``cli server --cluster-hosts
  --replicas 2``) beside two in-process nodes: a write through it to
  slices the reading node does not own is read back through an
  in-process node, with memos and the response cache in their default
  state, and equals numpy.

Every cluster here stops its background membership loop; the tests run
its rounds (``probe_once``) themselves. Tolerance: none, every byte
equal.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cluster import broadcast as jbroadcast
from pilosa_tpu.cluster import cluster as jcluster
from pilosa_tpu.cluster import membership as jmembership
from pilosa_tpu.server import wireproto as jwp
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu.testing import free_ports
from pilosa_tpu_torch.cluster import broadcast as tbroadcast
from pilosa_tpu_torch.cluster import cluster as tcluster
from pilosa_tpu_torch.cluster import membership as tmembership
from pilosa_tpu_torch.executor import ExecOptions
from pilosa_tpu_torch.server import wireproto as twp
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.utils import fanpool

SW = 1 << 20
N_SLICES = 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = "application/x-protobuf"

# ------------------------------------------------------------ placement


@pytest.mark.parametrize("hasher", ["jump", "mod"])
@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4, 5])
def test_placement_matches_reference(n_hosts, replicas, hasher):
    hosts = [f"h{i}:{10101 + i}" for i in range(n_hosts)]
    j = jcluster.Cluster(
        nodes=[jcluster.Node(h) for h in hosts], replica_n=replicas,
        hasher=jcluster.JmpHasher() if hasher == "jump"
        else jcluster.ModHasher())
    t = tcluster.Cluster(
        nodes=[tcluster.Node(h) for h in hosts], replica_n=replicas,
        hasher=tcluster.JmpHasher() if hasher == "jump"
        else tcluster.ModHasher())
    rng = np.random.default_rng(n_hosts * 10 + replicas)
    names = ["i", "events", "stargazer", "count100b"]
    for _ in range(1000):
        index = names[int(rng.integers(len(names)))]
        s = int(rng.integers(0, 1 << 20))
        assert t.partition(index, s) == j.partition(index, s)
        assert ([n.host for n in t.fragment_nodes(index, s)]
                == [n.host for n in j.fragment_nodes(index, s)])
        assert t.owns_fragment(hosts[0], index, s) == j.owns_fragment(
            hosts[0], index, s)
    for h in hosts:
        assert t.owns_slices("i", 300, h) == j.owns_slices("i", 300, h)
    # Static membership: every configured node UP; with no breaker tier
    # every node is healthy.
    j.node_set = jbroadcast.StaticNodeSet(j.nodes)
    t.node_set = tbroadcast.StaticNodeSet(t.nodes)
    assert t.node_states() == j.node_states()
    assert t.status() == j.status()
    assert t.healthy_nodes() == t.nodes
    assert [n.host for n in t.healthy_nodes(t.nodes[:1], hosts[0])] == \
        [n.host for n in j.healthy_nodes(j.nodes[:1], hosts[0])]
    assert tcluster.fnv64a(b"pilosa") == jcluster.fnv64a(b"pilosa")
    tc, jc = tcluster.new_test_cluster(3), jcluster.new_test_cluster(3)
    assert ([n.host for n in tc.fragment_nodes("i", 7)]
            == [n.host for n in jc.fragment_nodes("i", 7)])


# ----------------------------------------------------------------- wire

FIELD = {"name": "v", "type": "int", "min": -10, "max": 1000}
FRAME_OPTS = {"rowLabel": "row", "inverseEnabled": True, "cacheType": "lru",
              "cacheSize": 500, "timeQuantum": "YMD", "rangeEnabled": False,
              "fields": [FIELD]}
INPUT_DEF = {"frames": [{"name": "event", "options": {
                 "rowLabel": "rowID", "timeQuantum": "YM"}}],
             "fields": [{"name": "columnID", "primaryKey": True},
                        {"name": "color", "actions": [
                            {"frame": "event",
                             "valueDestination": "mapping",
                             "valueMap": {"red": 1, "blue": 2}}]},
                        {"name": "n", "actions": [
                            {"frame": "event",
                             "valueDestination": "single-row-boolean",
                             "rowID": 7}]}]}
MESSAGES = [
    {"type": "create-slice", "index": "i", "slice": 9537, "inverse": False},
    {"type": "create-slice", "index": "i", "slice": 3, "inverse": True},
    {"type": "create-index", "index": "i",
     "options": {"columnLabel": "col", "timeQuantum": "YMDH"}},
    {"type": "delete-index", "index": "i"},
    {"type": "create-frame", "index": "i", "frame": "f",
     "options": FRAME_OPTS},
    {"type": "create-frame", "index": "i", "frame": "g", "options": {}},
    {"type": "delete-frame", "index": "i", "frame": "f"},
    {"type": "create-field", "index": "i", "frame": "f", "field": FIELD},
    {"type": "delete-field", "index": "i", "frame": "f", "field": "v"},
    {"type": "delete-view", "index": "i", "frame": "f",
     "view": "standard_2017"},
    {"type": "create-input-definition", "index": "i", "name": "d1",
     "definition": INPUT_DEF},
    {"type": "delete-input-definition", "index": "i", "name": "d1"},
]


@pytest.mark.parametrize("msg", MESSAGES,
                         ids=[f"{m['type']}-{k}" for k, m in
                              enumerate(MESSAGES)])
def test_cluster_message_bytes_match_reference(msg):
    data = twp.encode_cluster_message(msg)
    assert data == jwp.encode_cluster_message(msg)
    assert twp.decode_cluster_message(data) == jwp.decode_cluster_message(
        data)


def test_status_encodings_match_reference():
    maxes = {"i": 9536, "events": 511, "a": 0}
    assert twp.encode_max_slices_response(maxes) == \
        jwp.encode_max_slices_response(maxes)
    data = jwp.encode_max_slices_response(maxes)
    assert twp.decode_max_slices_response(data) == \
        jwp.decode_max_slices_response(data)
    idx = {"name": "i", "options": {"columnLabel": "columnID",
                                    "timeQuantum": ""},
           "maxSlice": 77, "slices": [0, 3, 77],
           "frames": [{"name": "f", "options": FRAME_OPTS},
                      {"name": "g"}],
           "inputDefinitions": {"d1": INPUT_DEF}}
    assert twp.encode_schema_index(idx) == jwp.encode_schema_index(idx)
    data = jwp.encode_schema_index(idx)
    assert twp.decode_schema_index(data) == jwp.decode_schema_index(data)
    nodes = [{"host": "a:1", "state": "NORMAL", "scheme": "http",
              "indexes": [idx]},
             {"host": "b:2", "state": "DOWN", "scheme": "http",
              "indexes": []}]
    assert twp.encode_node_status(nodes[0]) == jwp.encode_node_status(
        nodes[0])
    data = jwp.encode_cluster_status(nodes)
    assert twp.encode_cluster_status(nodes) == data
    assert twp.decode_cluster_status(data) == jwp.decode_cluster_status(data)
    with pytest.raises(ValueError):
        twp.decode_cluster_message(b"")


# -------------------------------------------------------------- clusters


def _http(host, method, path, body=b"", ctype=None, accept=None):
    """(status, content type, body bytes)."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    req = urllib.request.Request(f"http://{host}{path}", method=method,
                                 data=body if method != "GET" else None)
    if ctype:
        req.add_header("Content-Type", ctype)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


class Pair:
    """The same cluster shape in both packages: ``j[k]``/``t[k]`` is
    node k's server, ``jh``/``th`` the host lists."""

    def __init__(self, root, n, replicas):
        self.root, self.n, self.replicas = root, n, replicas
        self.jh = [f"localhost:{p}" for p in free_ports(n)]
        self.th = [f"localhost:{p}" for p in free_ports(n)]
        self.j = [self._jopen(k) for k in range(n)]
        self.t = [self._topen(k) for k in range(n)]

    def _jopen(self, k):
        s = JServer(str(self.root / f"j{k}"), bind=self.jh[k],
                    cluster_hosts=self.jh, replica_n=self.replicas,
                    anti_entropy_interval=0, polling_interval=0).open()
        s.cluster.node_set.close()  # the tests run membership rounds
        return s

    def _topen(self, k):
        s = TServer(str(self.root / f"t{k}"), bind=self.th[k],
                    cluster_hosts=self.th, replica_n=self.replicas,
                    polling_interval=0, device="cpu").open()
        s.cluster.node_set.close()
        return s

    def restart(self, k):
        self.j[k] = self._jopen(k)
        self.t[k] = self._topen(k)

    def close(self, k):
        for s in (self.j[k], self.t[k]):
            if s is not None:
                s.close()
        self.j[k] = self.t[k] = None

    def close_all(self):
        for k in range(self.n):
            self.close(k)

    def both(self, k, method, path, body=b"", ctype=None, accept=None):
        """The request through node k of each; -> (j response, t)."""
        return (_http(self.jh[k], method, path, body, ctype, accept),
                _http(self.th[k], method, path, body, ctype, accept))

    def same(self, k, method, path, body=b"", ctype=None, accept=None):
        jr, tr = self.both(k, method, path, body, ctype, accept)
        assert tr == jr, (k, path, body)
        return tr

    def import_bits(self, frame, rows, cols, ts=None):
        """Protobuf imports, one per slice, to every owner the node-0
        ``/fragment/nodes`` names, in each package."""
        slices = cols // SW
        for s in np.unique(slices):
            m = slices == s
            body = jwp.encode_import_request(
                "i", frame, int(s), rows[m].tolist(), cols[m].tolist(),
                ts[m].tolist() if ts is not None else None)
            for hosts in (self.jh, self.th):
                owners = json.loads(_http(
                    hosts[0], "GET",
                    f"/fragment/nodes?index=i&slice={int(s)}")[2])
                for o in owners:
                    st = _http(o["host"], "POST", "/import", body, PB)
                    assert st[0] == 200, st

    def import_values(self, frame, field, cols, vals):
        slices = cols // SW
        for s in np.unique(slices):
            m = slices == s
            body = jwp.encode_import_value_request(
                "i", frame, int(s), field, cols[m].tolist(),
                vals[m].tolist())
            for hosts in (self.jh, self.th):
                owners = json.loads(_http(
                    hosts[0], "GET",
                    f"/fragment/nodes?index=i&slice={int(s)}")[2])
                for o in owners:
                    st = _http(o["host"], "POST", "/import-value", body, PB)
                    assert st[0] == 200, st


def _bm(r, frame="f"):
    return f'Bitmap(frame="{frame}", rowID={r})'


RANGE_T = 'Range(frame="t", rowID=1, start="2017-01-01T00:00", ' \
          'end="2017-07-01T00:00")'
QUERIES = [
    f"Count({_bm(1)})",
    f"Count(Intersect({_bm(1)}, {_bm(2)}))",
    f"Count(Union({_bm(1)}, {_bm(2)}))",
    f"Count(Difference({_bm(1)}, {_bm(2)}))",
    f"Count(Xor({_bm(1)}, {_bm(2)}))",
    f"Count(Union(Intersect({_bm(1)}, {_bm(2)}), Difference({_bm(3)}, "
    f"{_bm(4)}), {_bm(5)}))",
    f"Count({_bm(1)})Count({_bm(4)})",
    'TopN(frame="f", n=3)',
    'TopN(frame="f", n=2, ids=[1, 3, 5])',
    f'TopN({_bm(1)}, frame="f", n=4)',
    'TopN(frame="f", n=5, field="color", filters=["red"])',
    'Sum(frame="b", field="v")',
    f'Sum({_bm(2)}, frame="b", field="v")',
    'Average(frame="b", field="v")',
    'Min(frame="b", field="v")',
    'Max(frame="b", field="v")',
    'Min(frame="e", field="w")',
    'Max(frame="e", field="w")',
    'Count(Range(frame="b", v > 100))',
    'Count(Range(frame="b", v >< [0, 500]))',
    _bm(1),
    f"Intersect({_bm(1)}, {_bm(3)})",
    f"Union({_bm(5)}, {_bm(6)})",
    RANGE_T,
    f"Count({RANGE_T})",
    'Bitmap(frame="f", rowID=1)TopN(frame="f", n=1)',
]


def _write_script(p, rng):
    """DDL through node 1 (node 0 when alone), then writes through every
    node; every response equal. -> {row: set of columns} of frame f."""
    ddl = p.n - 1
    p.same(ddl, "POST", "/index/i", {})
    p.same(ddl, "POST", "/index/i/frame/f", {})
    p.same(0, "POST", "/index/i/frame/t",
           {"options": {"timeQuantum": "YMD"}})
    p.same(ddl, "POST", "/index/i/frame/b", {"options": {
        "rangeEnabled": True, "fields": [FIELD]}})
    p.same(0, "POST", "/index/i/frame/e", {"options": {
        "rangeEnabled": True}})
    p.same(ddl, "POST", "/index/i/frame/e/field/w",
           {"type": "int", "min": 0, "max": 100})
    for k in range(p.n):
        assert _http(p.th[k], "GET", "/schema") == _http(
            p.jh[k], "GET", "/schema")
    rows = rng.integers(1, 7, 3000)
    cols = rng.integers(0, N_SLICES * SW, 3000)
    p.import_bits("f", rows, cols)
    truth = {r: set(cols[rows == r].tolist()) for r in range(1, 7)}
    for k in range(12):
        r, c = int(rng.integers(1, 7)), int(rng.integers(0, (N_SLICES + 1)
                                                         * SW))
        p.same(k % p.n, "POST", "/index/i/query",
               f'SetBit(frame="f", rowID={r}, columnID={c})')
        truth[r].add(c)
    c = min(truth[2])
    p.same(0, "POST", "/index/i/query",
           f'ClearBit(frame="f", rowID=2, columnID={c})')
    truth[2].discard(c)
    # Write bursts: grouped by owner on a cluster (duplicates change
    # once), every "changed" equal.
    brows = rng.integers(1, 7, 300)
    bcols = rng.integers(0, N_SLICES * SW, 300)
    pairs = list(zip(brows.tolist(), bcols.tolist()))
    burst = "\n".join(f'SetBit(frame="f", rowID={r}, columnID={c})'
                      for r, c in pairs + pairs[:20])
    p.same(p.n - 1, "POST", "/index/i/query", burst)
    for r, c in pairs:
        truth[r].add(c)
    p.same(0, "POST", "/index/i/query", "\n".join(
        f'ClearBit(frame="f", rowID={r}, columnID={c})'
        for r, c in pairs[:10]))
    for r, c in pairs[:10]:
        truth[r].discard(c)
    tcols = rng.integers(0, N_SLICES * SW, 200)
    ts = rng.integers(1483228800, 1514764800, 200)  # 2017
    p.import_bits("t", np.ones(200, np.int64), tcols, ts)
    p.same(1 % p.n, "POST", "/index/i/query",
           'SetBit(frame="t", rowID=1, columnID=7, '
           'timestamp="2017-03-02T10:00")')
    vcols = rng.choice(N_SLICES * SW, 300, replace=False)
    p.import_values("b", "v", vcols, rng.integers(-10, 1001, 300))
    for k in range(p.n):
        p.same(k, "POST", "/index/i/query",
               f'SetFieldValue(frame="b", columnID={k * SW + 11}, '
               f'v={100 * k + 3})')
    p.same(p.n - 1, "POST", "/index/i/query", "\n".join(
        f'SetFieldValue(frame="b", columnID={c}, v={v})'
        for c, v in zip(rng.integers(0, N_SLICES * SW, 60).tolist(),
                        rng.integers(-10, 1001, 60).tolist())))
    # Field w of frame e holds values in slice 0 alone.
    p.same(0, "POST", "/index/i/query",
           "SetFieldValue(frame=\"e\", columnID=1, w=5)"
           "SetFieldValue(frame=\"e\", columnID=2, w=7)")
    p.same(p.n - 1, "POST", "/index/i/query",
           'SetRowAttrs(frame="f", rowID=1, color="red", n=3)'
           'SetRowAttrs(frame="f", rowID=4, color="red")')
    p.same(0, "POST", "/index/i/query",
           'SetRowAttrs(frame="f", rowID=2, color="blue")')
    p.same(1 % p.n, "POST", "/index/i/query",
           'SetColumnAttrs(columnID=9, tag="x")')
    return truth


# The queries of each failover stage: a Count tree, TopN with ids (its
# phase 2), Min over a field one slice holds, a bitmap with attributes,
# a time Range.
STAGE_QUERIES = [QUERIES[k] for k in (5, 8, 16, 20, 24)]


def _check_reads(p, nodes, truth=None):
    for k in nodes:
        for q in STAGE_QUERIES:
            p.same(k, "POST", "/index/i/query", q)
        p.same(k, "POST", "/index/i/query",
               jwp.encode_query_request(QUERIES[20]), PB, PB)
        p.same(k, "GET", "/slices/max")
        if truth is not None:
            got = json.loads(_http(p.th[k], "POST", "/index/i/query",
                                   f"Count({_bm(1)})")[2])
            assert got == {"results": [len(truth[1])]}


CONFIGS = {"2n-r1": (2, 1), "2n-r2": (2, 2), "3n-r2": (3, 2)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def cluster_pair(request, tmp_path_factory):
    n, r = CONFIGS[request.param]
    p = Pair(tmp_path_factory.mktemp(request.param), n, r)
    try:
        truth = _write_script(p, np.random.default_rng(n * 7 + r))
        yield p, truth
    finally:
        p.close_all()


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_reads_match_reference_through_every_node(cluster_pair, q):
    p, truth = cluster_pair
    for k in range(p.n):
        st = p.same(k, "POST", "/index/i/query", QUERIES[q])
        assert st[0] == 200, st
    if q == 0:
        assert json.loads(st[2]) == {"results": [len(truth[1])]}
    if q == 1:
        assert json.loads(st[2]) == {"results": [len(truth[1] & truth[2])]}


def test_cluster_routes_match_reference(cluster_pair):
    p, truth = cluster_pair
    for k in range(p.n):
        p.same(k, "GET", "/schema")
        p.same(k, "GET", "/slices/max")
        p.same(k, "GET", "/slices/max?inverse=true")
        p.same(k, "POST", "/index/i/query",
               jwp.encode_query_request(QUERIES[2]), PB, PB)
        jr, tr = p.both(k, "GET", "/fragment/nodes?index=i&slice=4")
        norm = {h: f"n{i}" for i, h in enumerate(p.jh)}
        norm.update({h: f"n{i}" for i, h in enumerate(p.th)})
        assert ([norm[o["host"]] for o in json.loads(tr[2])]
                == [norm[o["host"]] for o in json.loads(jr[2])])
        jr, tr = p.both(k, "GET", "/status")
        js, ts_ = json.loads(jr[2])["status"], json.loads(tr[2])["status"]
        assert [norm[x["host"]] for x in ts_["nodes"]] == \
            [norm[x["host"]] for x in js["nodes"]]
        assert ts_["indexes"] == js["indexes"]
        assert sorted(ts_["nodeStates"].values()) == sorted(
            js["nodeStates"].values())
        assert len(json.loads(p.both(k, "GET", "/hosts")[1][2])) == p.n
        jr, tr = p.both(k, "GET", "/status", accept=PB)
        assert tr[:2] == jr[:2] == (200, PB)
        js, ts_ = jwp.decode_node_status(jr[2]), jwp.decode_node_status(
            tr[2])
        assert (norm[ts_.pop("host")], ts_) == (norm[js.pop("host")], js)
    # A write burst through a coordinator is grouped by owner.
    seen = []
    ex = p.t[0].executor
    orig = ex._burst_fanout
    ex._burst_fanout = lambda *a: seen.append(orig(*a)) or seen[-1]
    try:
        p.same(0, "POST", "/index/i/query",
               'SetBit(frame="f", rowID=9, columnID=1)'
               f'SetBit(frame="f", rowID=9, columnID={4 * SW + 1})')
    finally:
        ex._burst_fanout = orig
    assert seen == [[True, True]]
    # A query error: the port answers it through every node as one node
    # does. pilosa_tpu's fan-out treats it as a failed node (ROADMAP
    # Queue C 5), so it is not asked here.
    for k in range(p.n):
        assert _http(p.th[k], "POST", "/index/i/query",
                     'Count(Bitmap(frame="nope", rowID=1))') == (
            400, "application/json", b'{"error": "frame not found"}')
    # /import of a slice the node does not own: 412 in both.
    owners = {o["host"] for o in json.loads(_http(
        p.th[0], "GET", "/fragment/nodes?index=i&slice=5")[2])}
    if len(owners) < p.n:
        k = next(i for i, h in enumerate(p.th) if h not in owners)
        body = jwp.encode_import_request("i", "f", 5, [1], [5 * SW + 1])
        assert p.same(k, "POST", "/import", body, PB)[0] == 412


def test_failover_hints_and_rejoin_match_reference(tmp_path):
    p = Pair(tmp_path, 3, 2)
    try:
        truth = _write_script(p, np.random.default_rng(99))
        # Node 2 closes; membership still holds it live, so each
        # query's leg to it fails and its slices remap to replicas.
        p.close(2)
        _check_reads(p, range(2), truth)
        for s in (p.j[0], p.j[1], p.t[0], p.t[1]):
            s.cluster.node_set.suspect_after = 1
            s.cluster.node_set.probe_once()
            assert s.cluster.node_set.is_down(s.cluster.nodes[2].host)
        # Writes while node 2 is DOWN: hinted for it.
        for k, c in enumerate((3, SW + 3, 2 * SW + 3, 4 * SW + 3,
                               5 * SW + 3, 6 * SW + 3)):
            p.same(k % 2, "POST", "/index/i/query",
                   f'SetBit(frame="f", rowID=1, columnID={c})')
            truth[1].add(c)
        p.same(1, "POST", "/index/i/query",
               'SetRowAttrs(frame="f", rowID=3, color="red")')
        p.same(0, "POST", "/index/i/query",
               'SetFieldValue(frame="b", columnID=7, v=999)')
        assert any(p.t[0].executor._hints.values()) or any(
            p.t[1].executor._hints.values())
        _check_reads(p, range(2), truth)
        # Node 2 back: the next round sees it, pushes the schema and
        # replays its hinted writes.
        p.restart(2)
        for s in (p.j[0], p.j[1], p.t[0], p.t[1]):
            s.cluster.node_set.probe_once()
            assert not s.cluster.node_set.is_down(s.cluster.nodes[2].host)
            assert not any(s.executor._hints.values())
        _check_reads(p, range(3), truth)
        # Node 2's own copies hold the hinted writes: row 1 of every
        # slice it owns, counted here alone.
        cl = p.t[2].cluster
        mine = [s for s in range(N_SLICES + 1)
                if cl.owns_fragment(p.th[2], "i", s)]
        own = p.t[2].executor.execute("i", f"Count({_bm(1)})", slices=mine,
                                      opt=ExecOptions(remote=True))
        assert own[0] == len([c for c in truth[1] if c // SW in mine])
    finally:
        p.close_all()


def test_replicas_one_node_down_answers_reference_status(tmp_path):
    p = Pair(tmp_path, 2, 1)
    try:
        _write_script(p, np.random.default_rng(5))
        p.close(1)
        jr, tr = p.both(0, "POST", "/index/i/query", f"Count({_bm(1)})")
        assert (tr[0], tr[1]) == (jr[0], jr[1]) == (500, "application/json")
        for s in (p.j[0], p.t[0]):
            s.cluster.node_set.suspect_after = 1
            s.cluster.node_set.probe_once()
        # Known DOWN: no live owner for its slices, no partial answer.
        assert p.same(0, "POST", "/index/i/query",
                      f"Count({_bm(1)})") == (500, "application/json",
                                              b'{"error": ""}')
        # A write to one of its slices hints it and succeeds.
        p.same(0, "POST", "/index/i/query",
               'SetBit(frame="f", rowID=9, columnID=1)')
    finally:
        p.close_all()


def test_node_in_its_own_process(tmp_path):
    """Two in-process port nodes and one ``cli server`` process,
    replicas 2: a write through the process node to slices the reading
    node does not own moves no epoch of the reader's holder; the reader,
    with its memos and response cache on (their default), still answers
    the write."""
    hosts = [f"localhost:{p}" for p in free_ports(3)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PILOSA_TPU_RESULT_MEMO", None)
    env.pop("PILOSA_TPU_RESPONSE_CACHE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
         "-d", str(tmp_path / "p2"), "-b", hosts[2], "--device", "cpu",
         "--cluster-hosts", ",".join(hosts), "--replicas", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    servers = []
    try:
        servers = [TServer(str(tmp_path / f"n{k}"), bind=hosts[k],
                           cluster_hosts=hosts, replica_n=2,
                           polling_interval=0, device="cpu").open()
                   for k in range(2)]
        line = proc.stdout.readline()
        assert "listening" in line, line
        reader = servers[0]
        assert not reader.executor._result_memo_off
        # A cluster: the warm tiers validate on the epoch vector.
        assert not reader.executor.memos_off()
        assert _http(hosts[2], "POST", "/index/i", {})[0] == 200
        assert _http(hosts[2], "POST", "/index/i/frame/f", {})[0] == 200
        not_reader = [s for s in range(64)
                      if hosts[0] not in [n.host for n in reader.cluster
                                          .fragment_nodes("i", s)]]
        assert not_reader
        cols = np.asarray([s * SW + 17 for s in not_reader[:8]])
        q = f"Count({_bm(1)})"
        expect = []
        for k, c in enumerate(cols):
            assert _http(hosts[2], "POST", "/index/i/query",
                         f'SetBit(frame="f", rowID=1, columnID={int(c)})'
                         )[0] == 200
            expect.append(int(c))
            for _ in range(2):  # the second read would replay a memo
                got = json.loads(_http(hosts[0], "POST", "/index/i/query",
                                       q)[2])
                assert got == {"results": [len(expect)]}, (k, got)
        got = json.loads(_http(hosts[0], "POST", "/index/i/query",
                               _bm(1))[2])
        assert got["results"][0]["bits"] == np.sort(cols).tolist()
        assert reader.executor.execute(
            "i", q, slices=[int(c) // SW for c in cols],
            opt=ExecOptions(remote=True))[0] == 0  # none held here
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
            for s in servers:
                s.close()


# ------------------------------------------- membership, broadcast, pool


PACKAGES = {"reference": (jcluster, jmembership, jbroadcast),
            "port": (tcluster, tmembership, tbroadcast)}


class FakeClient:
    """Indirect probes and message sends by script (pilosa_tpu's
    tests/test_membership.py shape)."""

    def __init__(self):
        self.indirect_results = {}
        self.indirect_calls = []
        self.sent = []
        self.fail_hosts = set()

    def indirect_probe(self, helper, target):
        self.indirect_calls.append((helper.host, target.host))
        return self.indirect_results.get(target.host, False)

    def send_message(self, node, msg, timeout=None):
        if node.host in self.fail_hosts:
            raise OSError("unreachable")
        self.sent.append((node.host, msg.get("type"), msg.get("slice")))


def _nodeset(pkg, n_peers, probe_subset=3, client=None):
    cl_mod, mem_mod, _ = PACKAGES[pkg]
    hosts = [f"h{i}:1" for i in range(n_peers + 1)]
    cluster = cl_mod.Cluster(nodes=[cl_mod.Node(h) for h in hosts])
    ns = mem_mod.HTTPNodeSet(cluster, hosts[0], client or FakeClient(),
                             interval=0.01, suspect_after=3,
                             probe_subset=probe_subset)
    cluster.node_set = ns
    probed, alive = [], set(hosts)

    def fake_probe(node):
        probed.append(node.host)
        return node.host in alive

    ns._probe = fake_probe
    return ns, cluster, probed, alive


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_probe_subsets_cover_every_peer(pkg):
    ns, _, probed, _ = _nodeset(pkg, 9)
    ns.probe_once()
    assert len(probed) == 3
    for _ in range(2):
        ns.probe_once()
    assert set(probed) == {f"h{i}:1" for i in range(1, 10)}


@pytest.mark.parametrize("indirect_ok", [True, False])
def test_suspicion_down_and_rejoin_match_reference(indirect_ok):
    """The same probe script against both packages' node sets: DOWN
    states, live lists, node states and rejoin calls round by round."""
    traces = {}
    for pkg in PACKAGES:
        client = FakeClient()
        ns, cluster, _, alive = _nodeset(pkg, 3, client=client)
        rejoined = []
        ns.on_rejoin = lambda node, r=rejoined: r.append(node.host)
        client.indirect_results["h1:1"] = indirect_ok
        trace = []
        for step in range(30):
            if step == 1:
                alive.discard("h1:1")
            if step == 15:
                alive.add("h1:1")
            if step == 20:
                alive.discard("h1:1")
            ns.probe_once()
            trace.append((ns.is_down("h1:1"),
                          tuple(n.host for n in ns.nodes()),
                          tuple(sorted(cluster.node_states().items())),
                          tuple(rejoined)))
        assert all(h in ("h2:1", "h3:1") for h, _ in client.indirect_calls)
        traces[pkg] = trace
    assert traces["port"] == traces["reference"]
    assert any(t[0] for t in traces["port"]) is not indirect_ok


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_broadcast_retry_queue(pkg):
    cl_mod, _, bc_mod = PACKAGES[pkg]
    client = FakeClient()
    cluster = cl_mod.Cluster(nodes=[cl_mod.Node(h)
                                    for h in ("a:1", "b:1", "c:1")])
    bc = bc_mod.HTTPBroadcaster(client, cluster, "a:1")
    client.fail_hosts.add("b:1")
    bc.send_async({"type": "create-slice", "index": "i", "slice": 3})
    assert ("c:1", "create-slice", 3) in client.sent
    assert bc.pending_retries() == 1
    for s in range(2000):  # a flapping peer's retries coalesce: max slice
        bc._enqueue("b:1", {"type": "create-slice", "index": "i",
                            "slice": s})
    bc._enqueue("c:1", {"type": "delete-frame", "index": "i", "frame": "f"})
    assert bc.pending_retries() == 2
    bc._drain_once()  # b still unreachable: requeued; c delivered
    assert bc.pending_retries() == 1
    client.fail_hosts.clear()
    bc._drain_once()
    assert bc.pending_retries() == 0
    assert ("b:1", "create-slice", 1999) in client.sent
    client.fail_hosts.add("b:1")
    bc._enqueue("b:1", {"type": "create-slice", "index": "i", "slice": 1})
    for _ in range(bc.RETRY_MAX + 2):
        bc._drain_once()
    assert bc.pending_retries() == 0  # given up, not spinning
    with pytest.raises(RuntimeError, match="broadcast errors"):
        bc.send_sync({"type": "delete-index", "index": "i"})
    bc.close()


def test_fanpool_runs_spills_and_waits():
    pool = fanpool.FanoutPool(max_idle=2)
    out, gate = [], __import__("threading").Event()
    waits = [pool.run(lambda k=k: (gate.wait(5), out.append(k)))
             for k in range(5)]
    assert pool.stats()["spilled"] == 3  # two parked, three one-shot
    assert not fanpool.wait_all(waits, deadline=time.monotonic() + 0.05)
    gate.set()
    assert fanpool.wait_all(waits, deadline=time.monotonic() + 5)
    assert sorted(out) == list(range(5))
    w = pool.run(lambda: 1 / 0)  # a raising task never wedges its joiner
    assert w.wait(5)
    pool.close()
    assert pool.run(lambda: out.append(9)).wait(5) and out[-1] == 9


def test_hints_replay_in_batches_and_retry_one_by_one(tmp_path):
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql import parse
    from pilosa_tpu_torch.storage.holder import Holder

    h = Holder(str(tmp_path / "d"), device="cpu").open()
    try:
        ex = Executor(h)
        ex.HINTS_MAX_PER_PEER = 5
        node = tcluster.Node("b:1")
        calls = [parse(f'SetBit(frame="f", rowID=1, columnID={c})').calls[0]
                 for c in range(7)]
        for c in calls:
            ex._hint(node, "i", c)
        assert ex._hints_dropped == 2 and ex.pending_hint_hosts() == ["b:1"]

        class Replay:
            def __init__(self):
                self.queries = []

            def execute_query(self, node, index, query, remote=False):
                self.queries.append(str(query))
                if "\n" in str(query) or "columnID=4" in str(query):
                    raise OSError("refused")
                return [True]

        rc = Replay()
        ex.replay_hints(node, rc)
        # One batch of the 5 kept calls, then each alone; the one that
        # fails again stays hinted.
        assert rc.queries[0].count("SetBit") == 5
        assert rc.queries[1:] == [str(c) for c in calls[2:]]
        assert [str(c) for _, c in ex._hints["b:1"]] == [str(calls[4])]
    finally:
        h.close()


def test_cli_import_reaches_each_slices_owners(tmp_path, capsys):
    """``cli import`` through one node of a 3-node cluster (replicas 2)
    posts each slice's bits to its owners: every node then counts them
    all, each owner holds its slices' bits and no other node any."""
    from pilosa_tpu_torch.cli.__main__ import main as tcli

    hosts = [f"localhost:{p}" for p in free_ports(3)]
    servers = [TServer(str(tmp_path / f"n{k}"), bind=hosts[k],
                       cluster_hosts=hosts, replica_n=2, polling_interval=0,
                       device="cpu").open() for k in range(3)]
    try:
        for s in servers:
            s.cluster.node_set.close()
        rng = np.random.default_rng(3)
        rows = rng.integers(0, 3, 500)
        cols = rng.integers(0, 6 * SW, 500)
        csv = tmp_path / "bits.csv"
        csv.write_text("".join(f"{r},{c}\n" for r, c in zip(rows, cols)))
        assert tcli(["import", "--host", hosts[1], "-i", "i", "-f", "f",
                     str(csv)]) == 0
        assert "imported 500 bits" in capsys.readouterr().out
        want = len(set(cols[rows == 1].tolist()))
        for h in hosts:
            got = json.loads(_http(h, "POST", "/index/i/query",
                                   f"Count({_bm(1)})")[2])
            assert got == {"results": [want]}, h
        cl = servers[0].cluster
        for k, s in enumerate(servers):
            mine = [sl for sl in range(6) if cl.owns_fragment(hosts[k], "i",
                                                              sl)]
            local = s.executor.execute("i", f"Count({_bm(1)})",
                                       slices=list(range(6)),
                                       opt=ExecOptions(remote=True))[0]
            assert local == len({c for r, c in zip(rows, cols)
                                 if r == 1 and c // SW in mine})
    finally:
        for s in servers:
            s.close()
