"""The port's CLI against pilosa_tpu's: ``import`` of one seeded CSV
(``row,col`` and ``row,col,timestamp`` lines over four slices, one of
them past the others) and of ``col,value`` lines with ``--field``, by
each package's CLI into its own server; the counts, the schema and the
``export`` CSV of the standard, a time and a field view must be equal,
the CSV byte for byte. ``server`` runs as a subprocess on the CPU, prints
its address, serves, and exits 0 on SIGTERM; without ``--device cpu``
and without a GPU it refuses to start."""
import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.cli.__main__ import main as jcli
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.cli.__main__ import main as tcli
from pilosa_tpu_torch.server.server import Server as TServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS_JUNE = 1496275200   # 2017-06-01T00:00 UTC
SLICES = (0, 1, 2, 7)


def _post(host, path, body):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


def _get(host, path):
    with urllib.request.urlopen(f"http://{host}{path}", timeout=30) as resp:
        return resp.read()


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """bits.csv (row,col with a timestamp on one line in three, and a
    blank line) and values.csv (col,value, negative values included)."""
    d = tmp_path_factory.mktemp("csv")
    rng = np.random.default_rng(17)
    n = 4000
    rows = rng.integers(0, 8, n)
    cols = (rng.choice(SLICES, n) * SLICE_WIDTH
            + rng.integers(0, SLICE_WIDTH, n))
    lines = []
    for k, (r, c) in enumerate(zip(rows, cols)):
        if k % 3 == 0:
            lines.append(f"{r},{c},{TS_JUNE + 86400 * (k % 4)}")
        else:
            lines.append(f"{r},{c}")
        if k == n // 2:
            lines.append("")
    (d / "bits.csv").write_text("\n".join(lines) + "\n")
    vcols = rng.choice(3 * SLICE_WIDTH, 500, replace=False)
    vals = rng.integers(-20, 300, 500)
    (d / "values.csv").write_text("".join(
        f"{c},{v}\n" for c, v in zip(vcols, vals)))
    return d / "bits.csv", d / "values.csv"


@pytest.fixture(scope="module")
def imported(csvs, tmp_path_factory):
    """Each package's CLI has imported the CSVs into its own server; ->
    {"jax" | "torch": the server's answers}."""
    bits, values = csvs
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for name, server_cls, cli, kw in (
            ("jax", JServer, jcli, {}),
            ("torch", TServer, tcli, {"device": "cpu"})):
        s = server_cls(str(root / name), bind="localhost:0", **kw).open()
        try:
            host = s.host
            _post(host, "/index/i", b"{}")
            _post(host, "/index/i/frame/t",
                  b'{"options": {"timeQuantum": "YMD"}}')
            assert cli(["import", "--host", host, "-i", "i", "-f", "t",
                        str(bits)]) in (0, None)
            assert cli(["import", "--host", host, "-i", "i", "-f", "f",
                        str(bits)]) in (0, None)
            assert cli(["import", "--host", host, "-i", "i", "-f", "b",
                        "-e", "v", str(values)]) in (0, None)
            got = {"schema": _get(host, "/schema"),
                   "fields": _get(host, "/index/i/frame/b/fields"),
                   "maxSlices": _get(host, "/slices/max")}
            for q in ['Count(Bitmap(frame="f", rowID=3))',
                      'TopN(frame="f", n=8)', 'TopN(frame="t", n=8)',
                      'Count(Range(frame="t", rowID=2, '
                      'start="2017-06-02T00:00", end="2017-06-04T00:00"))',
                      'Sum(frame="b", field="v")',
                      'Count(Range(frame="b", v < 0))']:
                got[q] = _post(host, "/index/i/query", q.encode())
            for frame, view in (("f", "standard"), ("t", "standard_201706"),
                                ("t", "standard_20170603"),
                                ("b", "field_v")):
                path = root / f"{name}_{frame}_{view}.csv"
                assert cli(["export", "--host", host, "-i", "i", "-f",
                            frame, "--view", view, "-o", str(path)]) in (
                                0, None)
                got[f"export {frame} {view}"] = path.read_bytes()
            out[name] = got
        finally:
            s.close()
    return out


def test_import_answers_equal_pilosa_tpu(imported):
    j, t = imported["jax"], imported["torch"]
    assert set(j) == set(t)
    for key in j:
        assert t[key] == j[key], key
    assert json.loads(t['Count(Bitmap(frame="f", rowID=3))'])[
        "results"][0] > 0
    assert json.loads(t["maxSlices"]) == {"maxSlices": {"i": 7}}


def test_export_is_the_imported_csv(imported, csvs):
    """The standard view's export holds every distinct imported bit, in
    (slice, row, column) order."""
    recs = np.loadtxt(csvs[0], delimiter=",", usecols=(0, 1),
                      dtype=np.int64)
    want = sorted(set(map(tuple, recs.tolist())),
                  key=lambda rc: (rc[1] // SLICE_WIDTH, rc[0], rc[1]))
    got = imported["torch"]["export f standard"].decode()
    assert got == "".join(f"{r},{c}\n" for r, c in want)
    assert imported["torch"]["export t standard_20170603"]


def _start_server(data_dir, *extra):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d",
         data_dir, "-b", "127.0.0.1:0", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc


def test_server_subprocess_stops_on_sigterm(tmp_path):
    proc = _start_server(str(tmp_path / "d"), "--device", "cpu")
    try:
        line = proc.stdout.readline()
        assert line.startswith("pilosa-tpu listening as http://127.0.0.1:")
        host = line.split("http://")[1].strip()
        assert _post(host, "/index/i", b"{}") == b"{}"
        _post(host, "/index/i/frame/f", b"{}")
        _post(host, "/index/i/query",
              b'SetBit(frame="f", rowID=1, columnID=5)')
        assert json.loads(_post(host, "/index/i/query",
                                b'Count(Bitmap(frame="f", rowID=1))')) == {
            "results": [1]}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert proc.stdout.read().strip() == "pilosa-tpu closed"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_server_defaults_to_the_gpu(tmp_path):
    """``cli server`` without ``--device`` needs a GPU: without one it
    raises before it listens."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli(["server", "-d", str(tmp_path / "d"), "-b", "127.0.0.1:0"])
