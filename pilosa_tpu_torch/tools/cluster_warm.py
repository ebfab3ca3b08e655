#!/usr/bin/env python3
"""Warm Count(Intersect) through a static cluster on one card: its nodes
in one process, then each a process of its own, against one node
holding every slice.

    python3 pilosa_tpu_torch/tools/cluster_warm.py [--slices 1024]
        [--nodes 3] [--replicas 2] [--reps 200] [--memos on|off]
        [--remote-batch on|off] [--out FILE]

Frame f's rows 0 and 1 (bit density 0.5 from ``--seed``) are written
into one directory per node, the slices placement gives it, and one
directory holding every slice, under ``--data`` (default
``.cluster_warm`` in the current directory; removed at the end). Then,
one after another: a ``Server`` over every slice; ``--nodes`` in-process
``Server``s as a cluster; ``--nodes`` ``cli server`` processes as a
cluster. Each answers the query once (checked against numpy; its
seconds are the first query's) and ``--reps`` times more over one
keep-alive connection to node 1, host clock. In the one-process cluster
node 1's legs are timed too: the median offsets from the query's
arrival at node 1's executor to each leg's start and end (its own leg
and each peer's). ``--memos off`` (the default) turns the result memos
and the response cache off (``PILOSA_TPU_RESULT_MEMO=0``), so every
query executes; ``on`` leaves them in their default state, so warm
repeats replay while the epoch vector stands. ``--remote-batch off``
sends every remote subcall alone (``PILOSA_TPU_REMOTE_BATCH=0``; on, the
default, concurrent subcalls to one peer share a round).
``--switch-interval S`` sets this process's interpreter switch interval
(``sys.setswitchinterval``) for the one-process cluster. Prints one JSON
line with the card's name and power limit.
"""
import argparse
import http.client
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

QUERY = ('Count(Intersect(Bitmap(frame="f", rowID=0), '
         'Bitmap(frame="f", rowID=1)))')
FRAGS = os.path.join("i", "f", "views", "standard", "fragments")


def write_data(root, slices, nodes, replicas, seed):
    """The fragment files of every directory; -> the numpy answer."""
    from pilosa_tpu_torch.cluster.cluster import Cluster, Node
    from pilosa_tpu_torch.roaring import codec
    from pilosa_tpu_torch.storage.holder import Holder

    names = [f"n{k}" for k in range(nodes)]
    for d in names + ["all"]:
        h = Holder(os.path.join(root, d), device="cpu").open()
        h.create_index("i").create_frame("f").create_view_if_not_exists(
            "standard")
        h.close()
    cl = Cluster(nodes=[Node(n) for n in names], replica_n=replicas)
    keys = np.arange(32, dtype=np.uint64)  # rows 0-1 × 16 containers
    want = 0
    for s in range(slices):
        w = np.random.default_rng([seed, s]).integers(
            0, 1 << 64, size=(2, 16384), dtype=np.uint64)
        want += int(np.bitwise_count(w[0] & w[1]).sum())
        data = codec.serialize_arrays(keys, w.reshape(32, 1024))
        for d in [n.host for n in cl.fragment_nodes("i", s)] + ["all"]:
            with open(os.path.join(root, d, FRAGS, str(s)), "wb") as f:
                f.write(data)
    return want


def free_hosts(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    hosts = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    return hosts


def request(conn, method, path, body=b""):
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise RuntimeError(f"{method} {path}: {resp.status} {data[:200]!r}")
    return json.loads(data)


def measure(host, want, slices, reps, wait_s=0.0):
    """First-query seconds and warm p50/p90 ms through ``host``, after
    waiting up to ``wait_s`` for its max slice to reach the last one
    (peers' heartbeats carry it)."""
    h, p = host.rsplit(":", 1)
    conn = http.client.HTTPConnection(h, int(p), timeout=300)
    deadline = time.monotonic() + wait_s
    while request(conn, "GET", "/slices/max")["maxSlices"].get(
            "i", 0) < slices - 1:
        if time.monotonic() > deadline:
            raise RuntimeError(f"{host} never learned the last slice")
        time.sleep(0.2)
    t = time.perf_counter()
    got = request(conn, "POST", "/index/i/query", QUERY.encode())
    first_s = time.perf_counter() - t
    if got != {"results": [want]}:
        raise RuntimeError(f"{host}: {got} != {want}")
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        got = request(conn, "POST", "/index/i/query", QUERY.encode())
        ms.append((time.perf_counter() - t) * 1e3)
        if got != {"results": [want]}:
            raise RuntimeError(f"{host}: {got} != {want}")
    conn.close()
    return {"first_s": first_s, "p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90))}


def time_legs(ex):
    """Wrap ``ex``'s execute and leg functions to record, per query, each
    leg's (start, end) offsets in ms from the query's arrival; -> the
    list the records go to."""
    import threading

    records, now = [], {}
    lock = threading.Lock()
    execute, local, remote = ex.execute, ex._local_exec, ex._remote_execute

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            with lock:
                now["legs"].append((name, t, time.perf_counter()))
            return out
        return run

    def ex_run(*a, **kw):
        now["legs"] = []
        t0 = time.perf_counter()
        out = execute(*a, **kw)
        records.append({name: ((t - t0) * 1e3, (e - t0) * 1e3)
                        for name, t, e in now["legs"]})
        return out

    ex.execute = ex_run
    ex._local_exec = timed("local", local)
    ex._remote_execute = lambda node, *a: timed(
        f"peer {node.host}", remote)(node, *a)
    return records


def leg_medians(records):
    names = sorted({k for r in records for k in r})
    return {n: {"start_ms": float(np.median([r[n][0] for r in records
                                             if n in r])),
                "end_ms": float(np.median([r[n][1] for r in records
                                           if n in r]))}
            for n in names}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slices", type=int, default=1024)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default=".cluster_warm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--switch-interval", type=float, default=None)
    ap.add_argument("--memos", choices=("on", "off"), default="off")
    ap.add_argument("--remote-batch", choices=("on", "off"), default="on")
    args = ap.parse_args()
    if args.switch_interval:
        sys.setswitchinterval(args.switch_interval)
    # The nodes' processes inherit both switches.
    if args.memos == "off":
        os.environ["PILOSA_TPU_RESULT_MEMO"] = "0"
    else:
        os.environ.pop("PILOSA_TPU_RESULT_MEMO", None)
    os.environ["PILOSA_TPU_REMOTE_BATCH"] = (
        "1" if args.remote_batch == "on" else "0")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from pilosa_tpu_torch.server.server import Server

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if args.device == "cuda" else "cpu"
    root = os.path.abspath(args.data)
    shutil.rmtree(root, ignore_errors=True)
    out = {"card": smi, "slices": args.slices, "nodes": args.nodes,
           "replicas": args.replicas, "reps": args.reps,
           "switch_interval_s": sys.getswitchinterval(),
           "memos": args.memos, "remote_batch": args.remote_batch,
           "coalesce": os.environ.get("PILOSA_TPU_COALESCE")}
    procs, servers = [], []
    try:
        want = write_data(root, args.slices, args.nodes, args.replicas,
                          args.seed)
        one = Server(os.path.join(root, "all"), bind="127.0.0.1:0",
                     device=args.device).open()
        try:
            out["one_node"] = measure(one.host, want, args.slices,
                                      args.reps)
        finally:
            one.close()

        hosts = free_hosts(args.nodes)
        servers = [Server(os.path.join(root, f"n{k}"), bind=hosts[k],
                          cluster_hosts=hosts, replica_n=args.replicas,
                          polling_interval=0, device=args.device).open()
                   for k in range(args.nodes)]
        for s in servers:
            s.cluster.node_set.probe_once()  # peers' max slices
        records = time_legs(servers[0].executor)
        out["one_process"] = measure(hosts[0], want, args.slices,
                                     args.reps)
        out["one_process"]["legs"] = leg_medians(records[1:])
        for s in servers:
            s.close()
        servers = []

        hosts = free_hosts(args.nodes)
        device = [] if args.device == "cuda" else ["--device", args.device]
        for k in range(args.nodes):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
                 "-d", os.path.join(root, f"n{k}"), "-b", hosts[k],
                 *device, "--cluster-hosts", ",".join(hosts),
                 "--replicas", str(args.replicas)], cwd=here,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for p in procs:
            line = p.stdout.readline()
            if "listening" not in line:
                raise RuntimeError(f"a node said {line!r}")
        out["processes"] = measure(hosts[0], want, args.slices, args.reps,
                                   wait_s=30)
    finally:
        for s in servers:
            s.close()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
