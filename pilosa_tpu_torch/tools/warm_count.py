#!/usr/bin/env python3
"""Warm Count(Intersect) latency, in process and over HTTP, of the
pilosa_tpu_torch package found under ``--root`` (another checkout's, to
compare two versions on one card).

    python3 pilosa_tpu_torch/tools/warm_count.py --root DIR [--slices N]

The data directory (``--data``, default ``.warm_data`` in the current
directory) holds index ``i``, frame ``f``, rows 0 and 1 of bit density
0.5 at every slice from ``--seed``; it is written on the first run, by
the package under ``--root``, and read as it is by later runs (both
versions read and write the same file format). Each run opens a
``Holder`` on the card, answers the query once (checked against numpy),
then times it ``--reps`` times through ``Executor.execute`` and through
``Server`` over one keep-alive ``http.client`` connection, host clock to
``torch.cuda.synchronize()``. Prints one JSON line.
"""
import argparse
import http.client
import json
import os
import subprocess
import sys
import time

import numpy as np

QUERY = ('Count(Intersect(Bitmap(frame="f", rowID=0), '
         'Bitmap(frame="f", rowID=1)))')


def write_data(path, slices, seed):
    """Frame f's fragment files and the numpy answer of QUERY."""
    from pilosa_tpu_torch.roaring import codec
    from pilosa_tpu_torch.storage.holder import Holder

    holder = Holder(path, device="cpu").open()
    view = holder.create_index("i").create_frame("f") \
        .create_view_if_not_exists("standard")
    frag_dir = os.path.join(view.path, "fragments")
    holder.close()
    keys = np.arange(32, dtype=np.uint64)  # rows 0-1 × 16 containers
    want = 0
    for s in range(slices):
        w = np.random.default_rng([seed, s]).integers(
            0, 1 << 64, size=(2, 16384), dtype=np.uint64)
        want += int(np.bitwise_count(w[0] & w[1]).sum())
        with open(os.path.join(frag_dir, str(s)), "wb") as f:
            f.write(codec.serialize_arrays(keys, w.reshape(32, 1024)))
    with open(os.path.join(path, "answer.json"), "w") as f:
        json.dump({"slices": slices, "seed": seed, "answer": want}, f)


def percentiles(ms):
    return {"p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="directory holding the pilosa_tpu_torch to time")
    ap.add_argument("--slices", type=int, default=9537)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--data", default=".warm_data")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    data = os.path.abspath(args.data)
    sys.path.insert(0, root)

    import torch

    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import loader
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.storage.holder import Holder

    if not torch.cuda.is_available():
        print("warm_count: no CUDA device", file=sys.stderr)
        return 2
    answer = os.path.join(data, "answer.json")
    if not os.path.exists(answer):
        t = time.perf_counter()
        write_data(data, args.slices, args.seed)
        print(f"warm_count: wrote {args.slices} slices in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    with open(answer) as f:
        meta = json.load(f)
    if (meta["slices"], meta["seed"]) != (args.slices, args.seed):
        raise SystemExit(f"{data} holds {meta}, not --slices {args.slices} "
                         f"--seed {args.seed}")
    want = meta["answer"]
    loader.build()

    out = {"root": root, "slices": args.slices, "reps": args.reps}
    t = time.perf_counter()
    holder = Holder(data).open()
    out["open_s"] = time.perf_counter() - t
    ex = Executor(holder)
    t = time.perf_counter()
    got = ex.execute("i", QUERY)[0]
    torch.cuda.synchronize()
    out["first_s"] = time.perf_counter() - t
    if got != want:
        raise SystemExit(f"{QUERY} = {got}, numpy {want}")
    ms = []
    for _ in range(args.reps):
        t = time.perf_counter()
        got = ex.execute("i", QUERY)[0]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        if got != want:
            raise SystemExit(f"warm {QUERY} = {got}, numpy {want}")
    out["in_process_ms"] = percentiles(ms)
    holder.close()

    server = Server(data, bind="127.0.0.1:0").open()
    try:
        host, port = server.host.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=600)
        ms = []
        for i in range(args.reps + 1):
            t = time.perf_counter()
            conn.request("POST", "/index/i/query", QUERY.encode())
            resp = conn.getresponse()
            body = resp.read()
            dt = (time.perf_counter() - t) * 1e3
            if resp.status != 200 or json.loads(body) != {"results": [want]}:
                raise SystemExit(f"HTTP {QUERY}: {resp.status} {body[:200]}")
            if i:  # the first request builds the server's stacks
                ms.append(dt)
        conn.close()
    finally:
        server.close()
    out["http_ms"] = percentiles(ms)
    out["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
