"""CLI command implementations (ref: ctl/; counterpart of
pilosa_tpu/cli/commands.py for ``server``, ``import`` (with ``-k``) and
``export``).

Each command takes an argv list and writes to stdout, so tests drive it
directly.
"""
import argparse
import csv
import os
import signal
import sys
import threading

import numpy as np

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.cluster.client import InternalClient

DEFAULT_HOST = "localhost:10101"


# ------------------------------------------------------------------ server

def cmd_server(args):
    """Serve a data directory until SIGTERM or Ctrl-C (ref:
    ctl/server.go). The GPU unless ``--device cpu``; the host memory of
    resident fragments is bounded by ``PILOSA_TPU_HOST_BYTES`` when set
    (the holder reads it)."""
    p = argparse.ArgumentParser(prog="server")
    p.add_argument("-d", "--data-dir", default="~/.pilosa")
    p.add_argument("-b", "--bind", default=DEFAULT_HOST)
    p.add_argument("--device", default="cuda",
                   help="torch device of the holder (default cuda)")
    p.add_argument("--cluster-hosts", default=None,
                   help="every node's host:port, comma-separated, this "
                        "node's bind among them")
    p.add_argument("--replicas", type=int, default=1,
                   help="owners of each slice (default 1)")
    opts = p.parse_args(args)

    from pilosa_tpu_torch.server.server import Server

    hosts = [h for h in (opts.cluster_hosts or "").split(",") if h]
    server = Server(os.path.expanduser(opts.data_dir), bind=opts.bind,
                    device=opts.device, cluster_hosts=hosts or None,
                    replica_n=opts.replicas).open()
    print(f"pilosa-tpu listening as {server.scheme}://{server.host}",
          flush=True)
    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread (embedded/test invocation)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    server.close()
    print("pilosa-tpu closed", flush=True)
    return 0


# ------------------------------------------------------------------ import

def _read_csv(path):
    """int64[n, 3] records of ``a,b[,c]`` lines, a missing field 0 and
    blank lines skipped; ``-`` is standard input."""
    fh = sys.stdin if path == "-" else open(path, newline="")
    try:
        recs = []
        for rec in csv.reader(fh):
            if not rec:
                continue
            vals = [int(x) for x in rec[:3]]
            recs.append(vals + [0] * (3 - len(vals)))
    finally:
        if fh is not sys.stdin:
            fh.close()
    return np.asarray(recs, dtype=np.int64).reshape(-1, 3)


def _parse_ts(raw):
    """A keyed line's timestamp: epoch seconds or the PQL time format
    (%Y-%m-%dT%H:%M; ref: pilosa_tpu cli/commands.py _parse_ts)."""
    try:
        return int(raw)
    except ValueError:
        from datetime import datetime

        try:
            return int(datetime.strptime(raw, "%Y-%m-%dT%H:%M").timestamp())
        except ValueError:
            raise SystemExit(
                f"error: bad timestamp {raw!r}: expected epoch seconds "
                "or YYYY-MM-DDTHH:MM") from None


def _import_keyed(client, opts):
    """``rowKey,columnKey[,timestamp]`` lines, posted in batches of about
    ``--buffer-size`` bytes (40 a line) to one node, which translates the
    keys (ref: pilosa_tpu cli/commands.py:164-206)."""
    batch = max(1, opts.buffer_size // 40)
    n = 0
    row_keys, col_keys, tss = [], [], []

    def flush():
        nonlocal n
        if row_keys:
            client.import_k(opts.host, opts.index, opts.frame, row_keys,
                            col_keys, tss if any(tss) else None)
            n += len(row_keys)
            row_keys.clear()
            col_keys.clear()
            tss.clear()

    for path in opts.paths:
        fh = sys.stdin if path == "-" else open(path, newline="")
        try:
            for rec in csv.reader(fh):
                if len(rec) >= 2:
                    row_keys.append(rec[0])
                    col_keys.append(rec[1])
                    tss.append(_parse_ts(rec[2])
                               if len(rec) >= 3 and rec[2] else 0)
                    if len(row_keys) >= batch:
                        flush()
        finally:
            if fh is not sys.stdin:
                fh.close()
    flush()
    return n


def cmd_import(args):
    """CSV import: ``row,col[,timestamp]`` lines (epoch seconds), or
    ``col,value`` lines into the BSI field ``--field``, posted one slice
    per request to each owner of the slice that ``--host`` names (GET
    /fragment/nodes; ref: ctl/import.go:33-252, client.go:278-428);
    with ``-k``, ``rowKey,columnKey[,timestamp]`` lines of string keys
    to ``--host``."""
    p = argparse.ArgumentParser(prog="import")
    p.add_argument("--host", default=DEFAULT_HOST)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--frame", required=True)
    p.add_argument("-e", "--field", default=None,
                   help="import into a BSI field (col,value rows)")
    p.add_argument("-k", "--keys", action="store_true",
                   help="rows of rowKey,columnKey strings, translated to "
                        "ids by the server")
    p.add_argument("--buffer-size", type=int, default=10_000_000)
    p.add_argument("paths", nargs="+")
    opts = p.parse_args(args)

    client = InternalClient()
    try:
        client.ensure_index(opts.host, opts.index)
        client.ensure_frame(opts.host, opts.index, opts.frame,
                            {"rangeEnabled": True} if opts.field else {})
        if opts.keys:
            if opts.field:
                print("error: -k and -e are mutually exclusive "
                      "(keyed BSI import is not supported)", file=sys.stderr)
                return 1
            print(f"imported {_import_keyed(client, opts)} keyed bits")
            return 0
        rows = np.concatenate([_read_csv(path) for path in opts.paths])

        # One stable argsort on the owning slice, then a request per run.
        col_field = 0 if opts.field else 1
        slices = rows[:, col_field] // SLICE_WIDTH
        order = np.argsort(slices, kind="stable")
        rows, slices = rows[order], slices[order]
        groups = np.split(np.arange(len(rows)),
                          np.flatnonzero(np.diff(slices)) + 1)
        n = 0
        cluster = len(client.hosts(opts.host)) > 1

        def owners(slice_num):
            if not cluster:
                return [opts.host]
            return [f"{o['scheme']}://{o['host']}" for o in
                    client.fragment_nodes(opts.host, opts.index, slice_num)]

        if opts.field and len(rows):
            # The field is created if absent, sized to the values.
            vals = rows[:, 1]
            client.ensure_field(opts.host, opts.index, opts.frame,
                                opts.field, min(int(vals.min()), 0),
                                int(vals.max()))
        for g in groups:
            if not len(g):
                continue
            slice_num = int(slices[g[0]])
            for node in owners(slice_num):
                if opts.field:
                    client.import_values(node, opts.index, opts.frame,
                                         slice_num, opts.field,
                                         rows[g, 0].tolist(),
                                         rows[g, 1].tolist())
                else:
                    tss = rows[g, 2]
                    client.import_bits(node, opts.index, opts.frame,
                                       slice_num, rows[g, 0].tolist(),
                                       rows[g, 1].tolist(),
                                       tss.tolist() if tss.any() else None)
            n += len(g)
    finally:
        client.close()
    print(f"imported {n} bits")
    return 0


# ------------------------------------------------------------------ export

def cmd_export(args):
    """A frame's view as ``row,column`` CSV, slice by slice (ref:
    ctl/export.go:27-117)."""
    p = argparse.ArgumentParser(prog="export")
    p.add_argument("--host", default=DEFAULT_HOST)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--frame", required=True)
    p.add_argument("--view", default="standard")
    p.add_argument("-o", "--output", default=None)
    opts = p.parse_args(args)

    client = InternalClient()
    out = open(opts.output, "w") if opts.output else sys.stdout
    try:
        for slice_num in range(client.max_slices(opts.host)
                               .get(opts.index, 0) + 1):
            out.write(client.export_csv(opts.host, opts.index, opts.frame,
                                        opts.view, slice_num))
    finally:
        client.close()
        if opts.output:
            out.close()
    return 0
