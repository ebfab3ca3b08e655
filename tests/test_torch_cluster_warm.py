"""The port's epoch vector and remote batch lanes against pilosa_tpu's,
on the CPU.

- Wire: ``encode_epochs`` gives pilosa_tpu's bytes for seeded counter
  maps, and ``decode_epochs`` reads them back as pilosa_tpu's does.
- Registry: a token over a restarted peer (a new incarnation) no longer
  validates; an unknown peer, or one observed longer ago than the ttl
  that a failed probe cannot refresh, gives no token, and a cluster node
  then neither replays nor stores (the result memos and the response
  cache).
- ``GET /internal/epochs`` and ``GET /debug/epochs`` have pilosa_tpu's
  body shape once the hosts are normalised.
- Warm tiers on in-process clusters of 2 nodes (replicas 1 and 2) and 3
  nodes (replicas 2) of each package: repeats replay (response-cache
  hits), a write through any node is read at once through the node that
  relayed it and through every other node after one membership round,
  every response equal to pilosa_tpu's and every Count to numpy. The
  nodes of one process share its counters, in both packages; a node in
  a process of its own shows the protocol itself: a write relayed by
  another node reaches its caches within one probe ttl.
- Remote batch lanes: 8 concurrent Counts through node 1 while a peer's
  first round is held in flight reach that peer in 2 requests and answer
  what pilosa_tpu's cluster answers; a round that fails on a closed peer
  sends each parked call again alone, each query remaps to replicas and
  answers the same; against a peer that hangs, those lone calls go out
  together, so the queries remap after one more timeout, not one a call.

Tolerance: none, every byte equal.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.cluster import epochs as jepochs
from pilosa_tpu.server import wireproto as jwp
from pilosa_tpu.testing import free_ports
from pilosa_tpu_torch.cluster import epochs as tepochs
from pilosa_tpu_torch.cluster.client import ClientError
from pilosa_tpu_torch.server.server import Server as TServer
from test_torch_cluster import CONFIGS, PB, SW, Pair, _http

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLICES = 6
ROWS = range(1, 7)


def _bm(r):
    return f'Bitmap(frame="f", rowID={r})'


QUERIES = [
    f"Count({_bm(1)})",
    f"Count(Intersect({_bm(1)}, {_bm(2)}))",
    f"Count(Union({_bm(3)}, {_bm(4)}))",
    'TopN(frame="f", n=3)',
    'Sum(frame="b", field="v")',
    'Max(frame="b", field="v")',
]

# ------------------------------------------------------------------ wire


@pytest.mark.parametrize("seed", range(6))
def test_epoch_header_bytes_match_reference(seed):
    rng = np.random.default_rng(seed)
    names = ["i", "events", "idx-a", "stargazer_9", "count100b",
             "weird name;x=1,y"]
    eps = {names[int(k)]: int(rng.integers(0, 1 << 40))
           for k in rng.choice(len(names), int(rng.integers(0, 6)),
                               replace=False)}
    eps["*"] = int(rng.integers(0, 1 << 50))
    eps["!"] = int(rng.integers(0, 1 << 63))
    host = f"10.0.0.{seed}:{10101 + seed}"
    val = tepochs.encode_epochs(host, eps)
    assert val == jepochs.encode_epochs(host, eps)
    assert tepochs.decode_epochs(val) == jepochs.decode_epochs(val) == (
        host, eps)
    for bad in (";i=1", "host;i", "host;i=xyz"):
        with pytest.raises(ValueError):
            tepochs.decode_epochs(bad)
        with pytest.raises(ValueError):
            jepochs.decode_epochs(bad)
    assert (tepochs.EPOCH_HEADER, tepochs.TOTAL_KEY,
            tepochs.INCARNATION_KEY, tepochs.DEFAULT_PROBE_TTL) == (
        jepochs.EPOCH_HEADER, jepochs.TOTAL_KEY, jepochs.INCARNATION_KEY,
        jepochs.DEFAULT_PROBE_TTL)


# -------------------------------------------------------------- registry


class _Holder:
    def __init__(self, *names):
        self.indexes = dict.fromkeys(names)


class _Cluster:
    def __init__(self, *hosts):
        from pilosa_tpu_torch.cluster.cluster import Node

        self.nodes = [Node(h) for h in hosts]

    def node_by_host(self, host):
        return next((n for n in self.nodes if n.host == host), None)


class _ProbeClient:
    """``epochs_fetch`` by script: a dict answers, None fails."""

    def __init__(self):
        self.answers = {}
        self.calls = []

    def epochs_fetch(self, node, timeout=None):
        self.calls.append(node.host)
        out = self.answers.get(node.host)
        if out is None:
            raise ClientError("refused")
        return {"host": node.host, "epochs": out}


def test_token_and_validate_across_a_restart():
    reg = tepochs.ClusterEpochs("a:1", _Holder("i"), ttl=60)
    reg.observe("b:2", {"i": 5, "*": 9, "!": 111})
    tok = reg.token("i", ["a:1", "b:2"])
    assert tok is not None and ("b:2", 111, 5) in tok
    assert reg.validate("i", tok) == tok
    # Another index of the peer reads its total.
    assert ("b:2", 111, 9) in reg.token("other", ["b:2"])
    # A restart: counters from 0 again under a new nonce; even when the
    # counter climbs back to the stored value, the token differs.
    reg.observe("b:2", {"i": 5, "*": 9, "!": 222})
    assert reg.validate("i", tok) != tok
    # A write of this process moves the local part.
    tok2 = reg.token("i", ["a:1", "b:2"])
    from pilosa_tpu_torch.storage.fragment import MutationEpoch

    MutationEpoch("i").bump()
    assert reg.token("i", ["a:1", "b:2"]) != tok2
    assert reg.metrics()["peers_known"] == 1
    snap = reg.snapshot()
    assert snap["peers"]["b:2"]["fresh"] and snap["version"] == 2


def test_unknown_or_stale_peer_is_cold():
    client = _ProbeClient()
    reg = tepochs.ClusterEpochs("a:1", _Holder("i"),
                                cluster=_Cluster("a:1", "b:2", "c:3"),
                                client=client, ttl=1.0)
    # Unknown: no token; a failed probe leaves it cold.
    assert reg.token("i", ["a:1", "b:2"]) is None
    assert reg.ensure_fresh("i", ["a:1", "b:2"]) is None
    assert client.calls == ["b:2"]
    # Backed off for one ttl: no probe per request.
    assert reg.ensure_fresh("i", ["a:1", "b:2"]) is None
    assert client.calls == ["b:2"]
    # Known and fresh, then older than the ttl.
    reg.observe("b:2", {"i": 1, "!": 7})
    assert reg.token("i", ["b:2"]) is not None
    time.sleep(1.05)
    assert reg.token("i", ["b:2"]) is None
    assert not reg.peer_fresh("b:2") and reg.peer_fresh("a:1")
    # A probe that answers refreshes it; two stale peers probe at once.
    client.answers = {"b:2": {"i": 2, "!": 7}, "c:3": {"i": 4, "!": 8}}
    tok = reg.ensure_fresh("i", ["b:2", "c:3"])
    assert ("b:2", 7, 2) in tok and ("c:3", 8, 4) in tok
    assert sorted(client.calls[1:]) == ["b:2", "c:3"]
    c = reg.snapshot()["counters"]
    assert c["probes"] == 3 and c["probe_failures"] == 1 and c["cold"] >= 3
    reg.close()


def _port_cluster(tmp_path, n, replicas, ttl=None):
    hosts = [f"localhost:{p}" for p in free_ports(n)]
    servers = []
    for k in range(n):
        s = TServer(str(tmp_path / f"t{k}"), bind=hosts[k],
                    cluster_hosts=hosts, replica_n=replicas,
                    polling_interval=0, device="cpu",
                    epoch_probe_ttl=ttl).open()
        s.cluster.node_set.close()
        servers.append(s)
    return hosts, servers


def test_stale_peer_neither_replays_nor_stores(tmp_path):
    hosts, servers = _port_cluster(tmp_path, 2, 1, ttl=1.0)
    try:
        a = servers[0]
        assert _http(hosts[0], "POST", "/index/i", {})[0] == 200
        assert _http(hosts[0], "POST", "/index/i/frame/f", {})[0] == 200
        for c in (1, SW + 1, 2 * SW + 1, 3 * SW + 1):
            assert _http(hosts[0], "POST", "/index/i/query",
                         f'SetBit(frame="f", rowID=1, columnID={c})')[0] \
                == 200
        q = f"Count({_bm(1)})"
        sent = []
        orig = a.client.execute_query
        a.client.execute_query = lambda *x, **kw: (
            sent.append(x[0]) or orig(*x, **kw))

        def fail(node, timeout=None):
            raise ClientError("probe refused")

        a.client.epochs_fetch = fail
        cache = a.handler._resp_cache
        time.sleep(1.1)  # the write responses' observations age out
        memo0, st0 = len(a.executor._result_memo), cache.stats()
        assert json.loads(_http(hosts[0], "POST", "/index/i/query",
                                q)[2]) == {"results": [4]}
        assert len(a.executor._result_memo) == memo0
        st = cache.stats()
        assert (st["entries"], st["hits"]) == (st0["entries"], st0["hits"])
        assert sent  # computed through the fan-out
        assert a.epochs.snapshot()["counters"]["probe_failures"] >= 1
        # The fan-out's answer refreshed the peer: the next one is kept,
        # and its repeat replays without a request to the peer.
        assert json.loads(_http(hosts[0], "POST", "/index/i/query",
                                q)[2]) == {"results": [4]}
        assert len(a.executor._result_memo) == memo0 + 1
        n = len(sent)
        assert json.loads(_http(hosts[0], "POST", "/index/i/query",
                                q)[2]) == {"results": [4]}
        assert len(sent) == n and cache.stats()["hits"] == st["hits"] + 1
        # Stale again, and the probe fails: no replay, no store.
        time.sleep(1.1)
        memo1 = dict(a.executor._result_memo)
        assert a.executor.execute("i", q) == [4]
        assert len(sent) > n
        assert a.executor._result_memo.keys() == memo1.keys()
    finally:
        for s in servers:
            s.close()


# ----------------------------------------------------------------- routes


def test_epoch_routes_match_reference_shape(tmp_path):
    p = Pair(tmp_path, 2, 2)
    try:
        p.same(0, "POST", "/index/i", {})
        p.same(0, "POST", "/index/i/frame/f", {})
        p.same(1, "POST", "/index/i/query",
               'SetBit(frame="f", rowID=1, columnID=3)')
        for s in p.j + p.t:
            s.cluster.node_set.probe_once()
        for k in range(p.n):
            jr, tr = p.both(k, "GET", "/internal/epochs")
            assert tr[:2] == jr[:2] == (200, "application/json")
            jb, tb = json.loads(jr[2]), json.loads(tr[2])
            assert (tb["host"], jb["host"]) == (p.th[k], p.jh[k])
            assert sorted(tb["epochs"]) == sorted(jb["epochs"]) == [
                "!", "*", "i"]
            assert all(type(v) is int for v in tb["epochs"].values())
            jr, tr = p.both(k, "GET", "/debug/epochs")
            jb, tb = json.loads(jr[2]), json.loads(tr[2])
            assert sorted(tb) == sorted(jb)
            assert sorted(tb["counters"]) == sorted(jb["counters"])
            assert sorted(tb["local"]) == sorted(jb["local"])
            peer = p.th[1 - k]
            jpeer = p.jh[1 - k]
            assert sorted(tb["peers"]) == [peer]
            assert sorted(tb["peers"][peer]) == sorted(jb["peers"][jpeer])
            assert tb["peers"][peer]["fresh"] is True
            # The header on every response of a cluster node.
            host, eps = tepochs.decode_epochs(
                p.t[k].epochs.header_value())
            assert host == p.th[k] and sorted(eps) == ["!", "*", "i"]
        alone = TServer(str(tmp_path / "alone"), bind="localhost:0",
                        device="cpu").open()
        try:
            st, _, body = _http(alone.host, "GET", "/debug/epochs")
            assert (st, json.loads(body)) == (200, {"enabled": False})
            st, _, body = _http(alone.host, "GET", "/internal/epochs")
            assert st == 200 and json.loads(body)["host"] == alone.host
        finally:
            alone.close()
    finally:
        p.close_all()


# ------------------------------------------------------------- warm tiers


def _load(p, rng):
    """Schema through node 0, bits of frame f and values of field v to
    every owner; -> ({row: set of columns}, {column: value})."""
    p.same(0, "POST", "/index/i", {})
    p.same(0, "POST", "/index/i/frame/f", {})
    p.same(p.n - 1, "POST", "/index/i/frame/b", {"options": {
        "rangeEnabled": True,
        "fields": [{"name": "v", "type": "int", "min": -10,
                    "max": 1000}]}})
    rows = rng.integers(1, 7, 2000)
    cols = rng.integers(0, N_SLICES * SW, 2000)
    p.import_bits("f", rows, cols)
    vcols = rng.choice(N_SLICES * SW, 200, replace=False)
    vals = rng.integers(-10, 1001, 200)
    p.import_values("b", "v", vcols, vals)
    for s in p.j + p.t:
        s.cluster.node_set.probe_once()  # peers' maxima and epochs
    truth = {r: set(cols[rows == r].tolist()) for r in ROWS}
    return truth, dict(zip(vcols.tolist(), vals.tolist()))


def _read_all(p, k, truth):
    for q in QUERIES:
        st = p.same(k, "POST", "/index/i/query", q)
        assert st[0] == 200, (q, st)
    p.same(k, "POST", "/index/i/query",
           jwp.encode_query_request(QUERIES[1]), PB, PB)
    got = json.loads(_http(p.th[k], "POST", "/index/i/query",
                           QUERIES[0])[2])
    assert got == {"results": [len(truth[1])]}
    got = json.loads(_http(p.th[k], "POST", "/index/i/query",
                           QUERIES[1])[2])
    assert got == {"results": [len(truth[1] & truth[2])]}


@pytest.fixture(scope="module", params=list(CONFIGS))
def warm_pair(request, tmp_path_factory):
    n, r = CONFIGS[request.param]
    p = Pair(tmp_path_factory.mktemp(request.param), n, r)
    try:
        truth, vals = _load(p, np.random.default_rng(n * 5 + r))
        yield p, truth, vals
    finally:
        p.close_all()


def test_repeats_replay_on_a_cluster(warm_pair):
    p, truth, _ = warm_pair
    for k in range(p.n):
        t = p.t[k]
        assert not t.executor.memos_off() and t.handler._resp_cache
        _read_all(p, k, truth)
        hits = t.handler._resp_cache.stats()["hits"]
        _read_all(p, k, truth)
        assert t.handler._resp_cache.stats()["hits"] >= hits + len(QUERIES)
        # The executor's memo replays too (the response cache aside).
        ex = t.executor
        assert ex.execute("i", QUERIES[1]) == [len(truth[1] & truth[2])]
        n_keys = len(ex._result_memo)
        assert n_keys and ex.execute("i", QUERIES[1]) == [
            len(truth[1] & truth[2])]
        assert len(ex._result_memo) == n_keys


@pytest.mark.parametrize("writer", range(3))
def test_write_through_any_node_is_read_everywhere(warm_pair, writer):
    p, truth, vals = warm_pair
    w = writer % p.n
    rng = np.random.default_rng(100 + writer)
    for k in range(p.n):  # every node's caches warm
        _read_all(p, k, truth)
    for c in rng.integers(0, (N_SLICES + 1) * SW, 3).tolist():
        p.same(w, "POST", "/index/i/query",
               f'SetBit(frame="f", rowID=1, columnID={c})')
        truth[1].add(c)
        _read_all(p, w, truth)  # at once through the relaying node
    c = min(truth[2])
    p.same(w, "POST", "/index/i/query",
           f'ClearBit(frame="f", rowID=2, columnID={c})')
    truth[2].discard(c)
    col = int(rng.integers(0, N_SLICES * SW))
    p.same(w, "POST", "/index/i/query",
           f'SetFieldValue(frame="b", columnID={col}, v=999)')
    vals[col] = 999
    _read_all(p, w, truth)
    for s in p.j + p.t:
        s.cluster.node_set.probe_once()  # one membership round
    for k in range(p.n):
        _read_all(p, k, truth)
    got = json.loads(_http(p.th[0], "POST", "/index/i/query",
                           QUERIES[4])[2])["results"][0]
    assert got == {"sum": sum(vals.values()), "count": len(vals)}


def test_relayed_write_reaches_another_process_within_the_ttl(tmp_path):
    """Nodes A and B in this process, P a ``cli server`` process,
    replicas 1: a write through B to a slice P alone holds is read at
    once through B (the write's answer carries P's counter) and through
    A once A's observation of P is older than the ttl (a probe)."""
    hosts = [f"localhost:{p}" for p in free_ports(3)]
    env = dict(os.environ, PYTHONPATH=ROOT, PILOSA_EPOCH_PROBE_TTL="0.5")
    env.pop("PILOSA_TPU_RESULT_MEMO", None)
    env.pop("PILOSA_TPU_RESPONSE_CACHE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
         "-d", str(tmp_path / "p"), "-b", hosts[2], "--device", "cpu",
         "--cluster-hosts", ",".join(hosts)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    servers = []
    try:
        servers = [TServer(str(tmp_path / f"n{k}"), bind=hosts[k],
                           cluster_hosts=hosts, polling_interval=0,
                           device="cpu", epoch_probe_ttl=0.5).open()
                   for k in range(2)]
        for s in servers:
            s.cluster.node_set.close()
        line = proc.stdout.readline()
        assert "listening" in line, line
        a, b = servers
        assert _http(hosts[0], "POST", "/index/i", {})[0] == 200
        assert _http(hosts[0], "POST", "/index/i/frame/f", {})[0] == 200
        cl = a.cluster
        p_only = [s for s in range(64)
                  if cl.fragment_nodes("i", s)[0].host == hosts[2]]
        q = f"Count({_bm(1)})"
        expect = {s * SW + 5 for s in p_only[:3]}
        for c in sorted(expect):  # the slices exist everywhere after it
            assert _http(hosts[0], "POST", "/index/i/query",
                         f'SetBit(frame="f", rowID=1, columnID={c})'
                         )[0] == 200
        for k, s in enumerate(p_only[:3]):
            c = s * SW + 6
            assert _http(hosts[1], "POST", "/index/i/query",
                         f'SetBit(frame="f", rowID=1, columnID={c})'
                         )[0] == 200
            expect.add(c)
            # B relayed it: the very next query through B reads it.
            for _ in range(2):
                got = json.loads(_http(hosts[1], "POST", "/index/i/query",
                                       q)[2])
                assert got == {"results": [len(expect)]}, (k, got)
            # A reads it within one ttl: once its observation of P ages
            # out, the next query probes P.
            deadline = time.monotonic() + 0.5 + 2.0
            while True:
                got = json.loads(_http(hosts[0], "POST", "/index/i/query",
                                       q)[2])
                if got == {"results": [len(expect)]}:
                    break
                assert time.monotonic() < deadline, (k, got)
                time.sleep(0.05)
            assert json.loads(_http(hosts[0], "POST", "/index/i/query",
                                    q)[2]) == {"results": [len(expect)]}
        assert a.epochs.snapshot()["counters"]["probes"] >= 1
        assert (a.handler._resp_cache.stats()["hits"]
                + b.handler._resp_cache.stats()["hits"]) >= 1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
            for s in servers:
                s.close()


# ------------------------------------------------------------ batch lanes

BATCH_N = 8


def _batch_queries():
    return [f"Count({_bm(r)})" if k % 2 else
            f"Count(Intersect({_bm(r)}, {_bm(r % 6 + 1)}))"
            for k, r in enumerate(list(ROWS) + [1, 2])][:BATCH_N]


def _run_threads(ex, queries):
    out = [None] * len(queries)

    def run(i):
        try:
            out[i] = ex.execute("i", queries[i])[0]
        except Exception as e:  # noqa: BLE001 — compared below
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    return threads, out


def _lane_pending(ex, host):
    with ex._rb_lanes_mu:
        return sum(len(ln["pending"]) for k, ln in ex._rb_lanes.items()
                   if k[0] == host)


def _wait_for(cond, what, timeout=30):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_concurrent_subcalls_share_a_round(tmp_path):
    p = Pair(tmp_path, 3, 2)
    try:
        truth, _ = _load(p, np.random.default_rng(11))
        queries = _batch_queries()
        want = [json.loads(_http(p.jh[0], "POST", "/index/i/query", q)[2])
                ["results"][0] for q in queries]
        ex = p.t[0].executor
        ex._result_memo_off = True  # every query fans out
        peer = p.t[1]
        held, release = [], threading.Event()
        seen = []
        orig = peer.handler.dispatch

        def dispatch(method, path, qp, body, headers):
            if path == "/index/i/query" and headers.get(
                    "Content-Type") == PB:
                seen.append(body)
                if not held:
                    held.append(1)
                    release.wait(30)
            return orig(method, path, qp, body, headers)

        peer.handler.dispatch = dispatch
        threads, out = _run_threads(ex, queries)
        _wait_for(lambda: _lane_pending(ex, p.th[1]) == BATCH_N - 1,
                  "the calls never parked")
        release.set()
        for t in threads:
            t.join(60)
        assert out == want
        assert out[0] == len(truth[1] & truth[2])
        assert len(seen) == 2 < BATCH_N
        rb = ex.remote_batch_snapshot()
        assert rb["batched_calls"] >= BATCH_N - 1
        assert rb["max_batch"] >= BATCH_N - 1
        doc = json.loads(_http(p.th[0], "GET", "/debug/vars")[2])
        assert doc["remoteBatcher"]["rounds"] >= 2
        # Batching off: each call alone.
        peer.handler.dispatch = orig
        ex._rb_enabled = False
        rounds = ex.remote_batch_snapshot()["rounds"]
        assert [ex.execute("i", q)[0] for q in queries] == want
        assert ex.remote_batch_snapshot()["rounds"] == rounds
        # A query error fails only its own call of a shared round.
        ex._rb_enabled = True
        release.clear()
        held.clear()
        peer.handler.dispatch = dispatch
        bad = queries[:3] + ['Count(Bitmap(frame="nope", rowID=1))']
        threads, out = _run_threads(ex, bad)
        _wait_for(lambda: _lane_pending(ex, p.th[1]) == len(bad) - 1,
                  "the calls never parked")
        release.set()
        for t in threads:
            t.join(60)
        assert out[:3] == want[:3]
        assert str(out[3]) == "frame not found"
    finally:
        p.close_all()


def test_failed_round_remaps_every_parked_call(tmp_path):
    p = Pair(tmp_path, 3, 2)
    try:
        truth, _ = _load(p, np.random.default_rng(12))
        queries = _batch_queries()
        ex = p.t[0].executor
        ex._result_memo_off = True
        client = p.t[0].client
        orig = client.execute_query
        go, first = threading.Event(), []
        calls = []

        def execute_query(node, *a, **kw):
            calls.append(node.host)
            if node.host == p.th[1] and not first:
                first.append(1)
                go.wait(30)
            return orig(node, *a, **kw)

        client.execute_query = execute_query
        threads, out = _run_threads(ex, queries)
        _wait_for(lambda: _lane_pending(ex, p.th[1]) == BATCH_N - 1,
                  "the calls never parked")
        p.close(1)  # both packages' node 1, while its round is held
        go.set()
        for t in threads:
            t.join(60)
        want = [json.loads(_http(p.jh[0], "POST", "/index/i/query", q)[2])
                ["results"][0] for q in queries]
        assert out == want
        assert out[1] == len(truth[2])
        rb = ex.remote_batch_snapshot()
        assert rb["max_batch"] == BATCH_N - 1
        # Two rounds to node 1 (the held one and the batch) failed, each
        # of the batch's calls was sent again alone and failed, and the
        # replicas answered for its slices.
        assert calls.count(p.th[1]) == 2 + BATCH_N - 1
    finally:
        p.close_all()


HANG_S = 1.0  # each call to the hung peer times out after this


def test_hung_peer_costs_one_more_timeout(tmp_path):
    """A peer that hangs, each call to it timing out after HANG_S, under a
    lane round of BATCH_N - 1 parked calls: the round times out, its
    calls are sent again alone all at once and time out together, and
    every query remaps to the replicas and answers what pilosa_tpu's
    cluster answers. From the held round's release that is three
    timeouts (the held call, the round, the lone calls); one lone call
    after another would be BATCH_N + 1."""
    p = Pair(tmp_path, 3, 2)
    try:
        truth, _ = _load(p, np.random.default_rng(14))
        queries = _batch_queries()
        want = [json.loads(_http(p.jh[0], "POST", "/index/i/query", q)[2])
                ["results"][0] for q in queries]
        ex = p.t[0].executor
        ex._result_memo_off = True
        client = ex.client
        orig = client.execute_query
        go, calls = threading.Event(), []

        def execute_query(node, *a, **kw):
            if node.host != p.th[1]:
                return orig(node, *a, **kw)
            calls.append(node.host)
            if len(calls) == 1:
                go.wait(30)  # the others park behind this call
            time.sleep(HANG_S)
            raise ClientError(f"POST {node}: timed out", timed_out=True)

        client.execute_query = execute_query
        first, out0 = _run_threads(ex, queries[:1])
        _wait_for(lambda: calls, "the first call never started")
        rest, out = _run_threads(ex, queries[1:])
        _wait_for(lambda: _lane_pending(ex, p.th[1]) == BATCH_N - 1,
                  "the calls never parked")
        t = time.monotonic()
        go.set()
        for th in first + rest:
            th.join(60)
        secs = time.monotonic() - t
        assert out0 + out == want
        assert out[0] == len(truth[2])
        assert len(calls) == 2 + BATCH_N - 1
        assert ex.remote_batch_snapshot()["max_batch"] == BATCH_N - 1
        assert 3 * HANG_S <= secs < 6 * HANG_S, secs
    finally:
        p.close_all()


# A round of several calls that fails sends each call again alone, in
# both packages (pilosa_tpu executor.py:2476-2521): at replicas 1 every
# sibling of a timed-out round, or of a round that one poisoned call
# makes the peer answer 500, gets its own answer.
POISON_ROW = 666


def _lane_round_outs(p, failure):
    """The answers of BATCH_N concurrent queries through node 0 of each
    package, their subcalls to node 1 held in one lane round, which then
    fails once: -> {package: [answer or exception]}."""
    queries = _batch_queries()
    if failure == "poisoned_500":
        queries[3] = f"Count({_bm(POISON_ROW)})"
    outs = {}
    for pkg, servers, hosts in (("j", p.j, p.jh), ("t", p.t, p.th)):
        ex = servers[0].executor
        ex._result_memo_off = True  # every query fans out
        client = ex.client
        orig = client.execute_query
        go, held = threading.Event(), threading.Event()
        state = {"failed": False}

        def execute_query(node, index, query, *a, _orig=orig, _go=go,
                          _held=held, _state=state, _peer=hosts[1],
                          _pkg=pkg, **kw):
            if getattr(node, "host", node) == _peer:
                if not _held.is_set():
                    _held.set()
                    _go.wait(30)  # the others park behind this round
                elif (len(query.calls) > 1 and failure == "timeout"
                      and not _state["failed"]):
                    _state["failed"] = True
                    raise _timeout(_pkg, node)
            return _orig(node, index, query, *a, **kw)

        client.execute_query = execute_query
        if failure == "poisoned_500":
            peer_ex = servers[1].executor
            real = peer_ex.execute

            def execute(index, query, *a, _real=real, **kw):
                if f"rowID={POISON_ROW}" in str(query):
                    raise RuntimeError("poisoned call")
                return _real(index, query, *a, **kw)

            peer_ex.execute = execute
        try:
            first, out0 = _run_threads(ex, queries[:1])
            _wait_for(held.is_set, "the first round never started")
            rest, out = _run_threads(ex, queries[1:])
            _wait_for(lambda: _lane_pending(ex, hosts[1]) == BATCH_N - 1,
                      "the calls never parked")
            go.set()
            for t in first + rest:
                t.join(60)
            outs[pkg] = out0 + out
        finally:
            client.execute_query = orig
            if failure == "poisoned_500":
                del peer_ex.execute
    return queries, outs


def _timeout(pkg, node):
    """The ClientError each package's client raises on a socket
    timeout."""
    if pkg == "j":
        from pilosa_tpu.cluster.client import ClientError as JClientError

        return JClientError(f"POST {node}: timed out", timed_out=True)
    return ClientError(f"POST {node}: timed out", timed_out=True)


@pytest.mark.parametrize("failure", ["timeout", "poisoned_500"])
def test_failed_lane_round_answers_each_call_alone(tmp_path, failure):
    p = Pair(tmp_path, 2, 1)
    try:
        truth, _ = _load(p, np.random.default_rng(13))
        queries, outs = _lane_round_outs(p, failure)
        for q, j, t in zip(queries, outs["j"], outs["t"]):
            if isinstance(j, Exception):
                # Only the poisoned call fails, in both.
                assert failure == "poisoned_500" and str(POISON_ROW) in q
                assert isinstance(t, Exception), (q, t)
                continue
            assert t == j, (q, t, j)
        assert sum(isinstance(o, Exception) for o in outs["t"]) == (
            1 if failure == "poisoned_500" else 0)
        assert outs["t"][1] == len(truth[2])
        rb = p.t[0].executor.remote_batch_snapshot()
        assert rb["max_batch"] == BATCH_N - 1
    finally:
        p.close_all()
