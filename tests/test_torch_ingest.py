"""Port parity for bulk ingest (pilosa_tpu's ingest/codec.py,
ops/ingest.py, ingest/pipeline.py, Fragment.install_batch and the
``POST /index/{i}/ingest`` route).

- The ``PTIN1`` codec: encoded bytes equal both ways, each package
  decoding the other's frames, and every malformed frame's CodecError
  message.
- The classify cells: the port's ``classify`` (the plain version of the
  hand kernel ``ingest_classify`` on the CPU) against pilosa_tpu's
  ``classify_stats_host`` and its ``classify_stats_device`` jitted on
  JAX's CPU backend, on chip_smoke's phase-3 streams (the empty stream,
  one entry, bits 31/32 and 2^20-1, a whole-row run, rows of 4,096 and
  4,097 bits, 1, 3 and 1,024 rows, rows ending on and inside the
  kernel's chunks).
- ``pack_classify`` (words as uint32 bytes, counts, runs) with bit 31
  set and runs across words; ``classify_formats`` and the build cells at
  the 4,096/4,097-bit and 2,048/2,049-run thresholds.
- The pipeline: one batch into a port ``cpu`` Holder and a pilosa_tpu
  Holder gives equal row counts and ``snapshot()`` dicts, and, after
  ``close()``, fragment files and ``.cache`` sidecars equal byte for
  byte: standard, inverse and time-quantum views, values, duplicate
  bits, rows that held bits before, the container tier off, the op log
  past its bound (a snapshot), a lazily reopened directory under a
  host-memory budget, and ``install_batch`` on unsorted input; 413 on
  ``max_batch_bits``; a raising classify cell leaves nothing installed;
  seeded rows serve their containers with no conversion; a Count after
  an ingest sees it through the memos and the response cache.
- The route: status and body byte-equal to pilosa_tpu's handler for
  binary, JSON and values bodies and for 400, 404, 413 and 501; over a
  socket, a chunked body and a body over 8 MiB are accepted on the
  ingest route, and the same size is refused on ``/import``.

Tolerance: none, every byte and count equal.
"""
import http.client
import json
import os
import socket
import struct
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.ingest import codec as jcodec
from pilosa_tpu.ingest.pipeline import IngestError as JIngestError
from pilosa_tpu.ingest.pipeline import IngestPipeline as JPipe
from pilosa_tpu.ops import bitops as jbitops
from pilosa_tpu.ops import containers as jcont
from pilosa_tpu.ops import ingest as jingest
from pilosa_tpu.server.handler import Handler as JHandler
from pilosa_tpu.storage import fragment as jfragment
from pilosa_tpu.storage.frame import Field as JField
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu.storage.index import FrameOptions as JFO
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.ingest import codec as tcodec
from pilosa_tpu_torch.ingest.pipeline import IngestError as TIngestError
from pilosa_tpu_torch.ingest.pipeline import IngestPipeline as TPipe
from pilosa_tpu_torch.ops import bitops as tbitops
from pilosa_tpu_torch.ops import containers as tcont
from pilosa_tpu_torch.ops import ingest as tingest
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.server.handler import Handler as THandler
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.storage import fragment as tfragment
from pilosa_tpu_torch.storage.frame import Field as TField
from pilosa_tpu_torch.storage.frame import FrameOptions as TFO
from pilosa_tpu_torch.storage.holder import Holder as THolder

TS0 = 1496275200  # 2017-06-01T00:00 UTC
CT = tcodec.CONTENT_TYPE


@pytest.fixture(autouse=True)
def tier_on():
    """Both packages' container tiers on (their default), restored."""
    prev = (tcont.enabled(), jcont.enabled())
    tcont.set_enabled(True)
    jcont.set_enabled(True)
    yield
    tcont.set_enabled(prev[0])
    jcont.set_enabled(prev[1])


# ------------------------------------------------------------------ codec

CODEC_CASES = {
    "bits": ("encode_bits", ("f", [1, 2, 2**40], [5, 2**20 + 3, 2**63])),
    "bits_ts": ("encode_bits", ("frame-é", [0, 9], [1, 2], [TS0, 0])),
    "empty": ("encode_bits", ("f", [], [])),
    "values": ("encode_values", ("b", "v", [3, 2**20], [-7, 2**62])),
}


def _same_decoded(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
        else:
            assert got[k] == v


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_bytes_and_decode_both_ways(case):
    name, args = CODEC_CASES[case]
    ref = getattr(jcodec, name)(*args)
    port = getattr(tcodec, name)(*args)
    assert port == ref
    _same_decoded(tcodec.decode(ref), jcodec.decode(ref))
    _same_decoded(jcodec.decode(port), tcodec.decode(port))


_GOOD = jcodec.encode_bits("f", [1, 2], [3, 4], [TS0, TS0])
_GOOD_V = jcodec.encode_values("b", "v", [1], [2])
MALFORMED = {
    "short_header": b"PTIN",
    "magic": b"XXXXX" + _GOOD[5:],
    "kind": _GOOD[:5] + b"\x07" + _GOOD[6:],
    "frame_length": _GOOD[:8],
    "frame_name": _GOOD[:9],
    "field_length": _GOOD[:10],
    "field_name": _GOOD[:10] + struct.pack("<H", 9),
    "entry_count": _GOOD[:15],
    "rows": _GOOD[:20],
    "columns": _GOOD[:45],
    "timestamps": _GOOD[:-1],
    "trailing_bits": _GOOD + b"\x00",
    "values": _GOOD_V[:-3],
    "trailing_values": _GOOD_V + b"\x01",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_codec_errors_match(case):
    body = MALFORMED[case]
    with pytest.raises(jcodec.CodecError) as want:
        jcodec.decode(body)
    with pytest.raises(tcodec.CodecError) as got:
        tcodec.decode(body)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", [
    ("bits", ("f", [1], [1, 2])), ("bits", ("f", [1], [1], [1, 2])),
    ("values", ("b", "v", [1], [1, 2]))])
def test_codec_encode_errors_match(call):
    kind, args = call
    name = "encode_bits" if kind == "bits" else "encode_values"
    with pytest.raises(jcodec.CodecError) as want:
        getattr(jcodec, name)(*args)
    with pytest.raises(tcodec.CodecError) as got:
        getattr(tcodec, name)(*args)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- classify cells
# chip_smoke.py phase 3's streams (tests/test_torch_cuda.py has the same):
# sorted, deduplicated (rowidx, positions, n_rows).

def _classify_stream(lengths, rng, run_share=0.5):
    rows, pos = [], []
    for r, k in enumerate(lengths):
        run = int(k * run_share)
        start = int(rng.integers(0, SLICE_WIDTH - run))
        p = set(range(start, start + run))
        while len(p) < k:
            p.update(rng.integers(0, SLICE_WIDTH, k - len(p)).tolist())
        pos.append(np.sort(np.fromiter(p, np.int64, len(p))[:k]))
        rows.append(np.full(k, r))
    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(pos).astype(np.int32), len(lengths))


def _classify_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 3
    if name == "one":
        return np.zeros(1, np.int32), np.array([5], np.int32), 1
    if name == "edges":
        return (np.array([0, 0, 0, 0, 0, 1, 1], np.int32),
                np.array([0, 31, 32, 33, SLICE_WIDTH - 1, 31, 32], np.int32),
                2)
    if name == "whole_row":
        return (np.zeros(SLICE_WIDTH, np.int32),
                np.arange(SLICE_WIDTH, dtype=np.int32), 1)
    if name == "4096_4097":
        return _classify_stream([4096, 4097], rng, run_share=0.0)
    if name.startswith("rows_"):
        n = int(name[5:])
        return _classify_stream(rng.integers(1, 3000, n).tolist(), rng)
    if name == "chunk_edges":
        return _classify_stream([23, 22, 24, 46, 5888, 5889, 1, 23 * 256],
                                rng, run_share=0.9)
    raise KeyError(name)


CLASSIFY_CASES = ("empty", "one", "edges", "whole_row", "4096_4097",
                  "rows_1", "rows_3", "rows_1024", "chunk_edges")


@pytest.mark.parametrize("case", CLASSIFY_CASES)
def test_classify_cells_match_reference(case):
    rowidx, pos, n_rows = _classify_case(case)
    want_host = jingest.classify_stats_host(rowidx, pos, n_rows)
    want_dev = jingest.classify_stats_device(rowidx, pos, n_rows)
    kernels.reset_launches()
    for got in (tbitops.ingest_kernel("classify")(rowidx, pos, n_rows,
                                                  device="cpu"),
                tbitops.ingest_kernel("classify.host")(rowidx, pos, n_rows),
                tbitops.ingest_kernel("classify.device")(
                    rowidx, pos, n_rows, device="cpu")):
        for g, wh, wd in zip(got, want_host, want_dev):
            assert g.dtype == np.int32 and g.shape == (n_rows,)
            assert np.array_equal(g, wh) and np.array_equal(g, wd)
    assert kernels.launches["ingest_classify"] == 0  # CPU: the plain one


def test_classify_kernel_refuses_bad_input():
    r = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.ingest_classify(r.long(), r, 1)
    with pytest.raises(ValueError):
        kernels.ingest_classify(r, r[:2], 1)
    with pytest.raises(ValueError):
        kernels.ingest_classify(r, r, -1)


def test_registry_names_match_reference():
    names = ("classify", "classify.host", "classify.device",
             "pack_classify", "build.array", "build.run", "build.dense")
    for name in names:
        assert jbitops.ingest_kernel(name) is not None
        assert tbitops.ingest_kernel(name) is not None
    assert tbitops.ingest_kernel("nope") is None


# ------------------------------------------------------------------ pack

def _pack_case(name):
    if name == "bit31":
        return (np.array([0, 0, 1, 1, 2], np.int32),
                np.array([31, 63, 31, 32, 95], np.int32), 3, 4)
    if name == "cross_word_runs":
        pos = np.concatenate([np.arange(28, 70), np.arange(95, 97),
                              np.arange(120, 128)])
        return (np.zeros(len(pos), np.int32), pos.astype(np.int32), 1, 4)
    if name == "empty_rows":
        return (np.array([1, 1], np.int32), np.array([0, 5], np.int32), 4,
                2)
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 11 * 1024, 4000))
    return ((keys // 1024).astype(np.int32),
            (keys % 1024).astype(np.int32), 11, 32)


@pytest.mark.parametrize("case", ["bit31", "cross_word_runs", "empty_rows",
                                  "random"])
def test_pack_classify_matches_reference(case):
    rowidx, pos, n_rows, width32 = _pack_case(case)
    jw, jc, jr = jingest.pack_classify(rowidx, pos, n_rows, width32)
    tw, tc, tr = tbitops.ingest_kernel("pack_classify")(
        rowidx, pos, n_rows, width32, device="cpu")
    assert tw.dtype == torch.int32 and tw.shape == (n_rows, width32)
    assert tw.numpy().view(np.uint32).tobytes() == \
        np.asarray(jw).view(np.uint32).tobytes()
    assert np.array_equal(tc, jc) and np.array_equal(tr, jr)


# ---------------------------------------------------- formats and builds

def test_classify_formats_match_reference_and_choose_format():
    counts = np.array([0, 1, 4095, 4096, 4097, 4097, 8000, 5000, 4096,
                       4097, 100, 2, 3, 9000, 9000])
    runs = np.array([0, 1, 1, 2048, 2048, 2049, 2048, 2049, 4096, 1, 50,
                     1, 2, 4000, 2000])
    got = tingest.classify_formats(counts, runs)
    assert got.tolist() == jingest.classify_formats(counts, runs).tolist()
    assert got.tolist() == [tcont.choose_format(int(c), int(r))
                            for c, r in zip(counts, runs)]


def _positions(kind):
    if kind == "spread_4096":
        return np.arange(0, 8192, 2)
    if kind == "run_4097":
        return np.arange(100, 4197)
    if kind == "runs_2048":
        return (np.arange(2048)[:, None] * 4 + np.arange(3)).ravel()
    if kind == "runs_2049":
        return (np.arange(2049)[:, None] * 4 + np.arange(3)).ravel()
    if kind == "tail":
        return np.array([SLICE_WIDTH - 2, SLICE_WIDTH - 1])
    return np.array([7])


@pytest.mark.parametrize("kind", ["spread_4096", "run_4097", "runs_2048",
                                  "runs_2049", "tail", "one"])
def test_build_cells_match_reference(kind):
    pos = _positions(kind)
    rowidx = np.zeros(len(pos), np.int32)
    counts, runs = tingest.classify_stats_host(rowidx, pos, 1)
    fmt = str(tingest.classify_formats(counts, runs)[0])
    assert fmt == str(jingest.classify_formats(counts, runs)[0])
    want = jbitops.ingest_kernel("build." + fmt)(pos, SLICE_WIDTH // 32)
    got = tbitops.ingest_kernel("build." + fmt)(pos, SLICE_WIDTH // 32,
                                                device="cpu")
    if want is None:
        assert got is None and fmt == "dense"
        return
    assert (got.fmt, got.width32, got.count) == (want.fmt, want.width32,
                                                 want.count)
    for attr in ("positions", "runs"):
        w, g = getattr(want, attr), getattr(got, attr)
        assert (w is None) == (g is None)
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w)


# ------------------------------------------------------------- pipeline

def _fragment_files(root):
    """{relative path: bytes} of every fragment file and sidecar."""
    out = {}
    for d, _, files in os.walk(root):
        if os.path.basename(d) != "fragments":
            continue
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _row_counts(holder):
    out = {}
    for iname, idx in holder.indexes.items():
        for fname, fr in idx.frames.items():
            for vname, v in fr.views.items():
                for s, frag in v.fragments.items():
                    for r in frag.rows():
                        out[(iname, fname, vname, s, r)] = \
                            frag.row_count(r)
    return out


def _bits(seed, n, slices=3, rows=40):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, n)
    c = rng.integers(0, slices * SLICE_WIDTH, n)
    # A run row and a dense-ish row among the spread ones.
    a = min(3000, n // 3)
    b = min(6000, n - a)
    r[:a], c[:a] = 5, np.arange(a) + 2 * SLICE_WIDTH + 11
    r[a:a + b], c[a:a + b] = 6, rng.integers(0, 16384, b)
    return r, c


def _pair(tmp_path, host_bytes=None):
    j = JHolder(str(tmp_path / "j"), host_bytes=host_bytes).open()
    t = THolder(str(tmp_path / "t"), device="cpu",
                host_bytes=host_bytes).open()
    return j, t


def _schema(j, t):
    for h, FO, F in ((j, JFO, JField), (t, TFO, TField)):
        idx = h.create_index("i")
        idx.create_frame("f", FO())
        idx.create_frame("inv", FO(inverse_enabled=True))
        idx.create_frame("t", FO(time_quantum="YMD"))
        idx.create_frame("b", FO(range_enabled=True,
                                 fields=[F("v", min=-5, max=1000)]))


def _scenario(name, pipe, holder):
    """One scenario's writes through ``pipe``; -> the summaries."""
    out = []
    if name == "standard":
        out.append(pipe.ingest_bits("i", "f", *_bits(1, 20000)))
    elif name == "inverse":
        out.append(pipe.ingest_bits("i", "inv", *_bits(2, 8000, rows=9)))
    elif name == "time":
        r, c = _bits(3, 12000)
        ts = np.random.default_rng(3).integers(TS0, TS0 + 20 * 86400,
                                               len(r))
        ts[::3] = 0
        out.append(pipe.ingest_bits("i", "t", r, c, ts))
    elif name == "values":
        rng = np.random.default_rng(4)
        cols = rng.choice(3 * SLICE_WIDTH, 3000, replace=False)
        out.append(pipe.ingest_values("i", "b", "v", cols,
                                      rng.integers(-5, 1001, 3000)))
        out.append(pipe.ingest_values("i", "b", "v", cols[:100],
                                      np.full(100, 7)))
    elif name == "duplicates":
        r, c = _bits(5, 6000)
        out.append(pipe.ingest_bits("i", "f", np.tile(r, 3),
                                    np.tile(c, 3)))
    elif name == "existing_rows":
        r, c = _bits(6, 6000)
        holder.index("i").frame("f").import_bits(r[:2000], c[:2000])
        out.append(pipe.ingest_bits("i", "f", r, c))
        out.append(pipe.ingest_bits("i", "f", r[::2] + 1, c[::2]))
    elif name in ("tier_off", "snapshot"):
        out.append(pipe.ingest_bits("i", "f", *_bits(7, 9000)))
        out.append(pipe.ingest_bits("i", "f", *_bits(8, 9000)))
    return out


SCENARIOS = ("standard", "inverse", "time", "values", "duplicates",
             "existing_rows", "tier_off", "snapshot")


@pytest.mark.parametrize("name", SCENARIOS)
def test_pipeline_files_match_reference(tmp_path, monkeypatch, name):
    if name == "tier_off":
        tcont.set_enabled(False)
        jcont.set_enabled(False)
    if name == "snapshot":  # the op log's bound crossed: one snapshot
        monkeypatch.setattr(jfragment, "OPLOG_MAX_OPS", 5000)
        monkeypatch.setattr(tfragment, "OPLOG_MAX_OPS", 5000)
    j, t = _pair(tmp_path)
    _schema(j, t)
    jp, tp = JPipe(j), TPipe(t)
    assert _scenario(name, tp, t) == _scenario(name, jp, j)
    assert tp.snapshot() == jp.snapshot()
    assert tp.metrics() == jp.metrics()
    assert _row_counts(t) == _row_counts(j)
    if name == "snapshot":
        ops = {s: f.op_n for s, f in
               t.index("i").frame("f").view("standard").fragments.items()}
        assert ops == {s: f.op_n for s, f in
                       j.index("i").frame("f").view("standard")
                       .fragments.items()}
    j.close()
    t.close()
    files = _fragment_files(t.path)
    assert files and files == _fragment_files(j.path)


def test_seeded_rows_serve_without_conversion(tmp_path):
    """Rows the batch created serve the containers it built; rows that
    held bits before are left to the read path (ref:
    _seed_containers_locked)."""
    j, t = _pair(tmp_path)
    _schema(j, t)
    r, c = _bits(9, 12000)
    t.index("i").frame("f").import_bits([30], [2])  # row 30 pre-exists
    j.index("i").frame("f").import_bits([30], [2])
    snaps = []
    for h, P in ((t, TPipe), (j, JPipe)):
        p = P(h)
        p.ingest_bits("i", "f", np.append(r, 30), np.append(c, 9))
        snaps.append(p.snapshot()["containersSeeded"])
    assert snaps[0] == snaps[1] and snaps[0]["run"] == 1
    seeded = {}
    before = tcont.conversions_total()
    for s, frag in t.index("i").frame("f").view("standard") \
            .fragments.items():
        for row in frag.rows():
            phys = frag._row_index[row]
            fm = frag._cont_fmt.get(phys)
            if fm is None or fm[0] != frag._version:
                continue
            seeded[s, row] = fm[1]
            memo = frag._cont_dev.get(phys)
            cont = frag.row_container(row)
            assert cont.fmt == fm[1] and cont.count == frag.row_count(row)
            if fm[1] != "dense":
                assert memo[1] is cont  # the batch's own container
    assert tcont.conversions_total() == before
    assert (0, 30) not in seeded  # held a bit before the batch
    assert seeded[2, 5] == "run" and seeded[0, 6] == "dense"
    assert len(seeded) == sum(snaps[0].values())
    j.close()
    t.close()


def test_lazy_directory_under_budget_matches(tmp_path):
    """Ingest into a directory reopened lazily under a host budget: the
    fragments fault in before their scatter, the governor stays within
    its budget, and the files match pilosa_tpu's."""
    j, t = _pair(tmp_path)
    _schema(j, t)
    for h, P in ((j, JPipe), (t, TPipe)):
        P(h).ingest_bits("i", "f", *_bits(10, 9000, slices=6, rows=4))
        h.close()
    budget = 3 << 20
    j = JHolder(j.path, host_bytes=budget).open()
    t = THolder(t.path, device="cpu", host_bytes=budget).open()
    for h, P in ((j, JPipe), (t, TPipe)):
        P(h).ingest_bits("i", "f", *_bits(11, 9000, slices=6, rows=4))
    assert t.governor.resident_bytes() <= budget
    assert _row_counts(t) == _row_counts(j)
    j.close()
    t.close()
    assert _fragment_files(t.path) == _fragment_files(j.path)


def test_install_batch_unsorted_resorts(tmp_path):
    """Input that breaks the (row, column) order goes through
    import_bits; the seeding then checks counts (ref: install_batch)."""
    j, t = _pair(tmp_path)
    _schema(j, t)
    rows = np.array([3, 1, 1, 3, 2], np.uint64)
    cols = np.array([9, 4, 5, 1, 7], np.uint64)
    got = []
    for h, ing in ((t, tingest), (j, jingest)):
        frag = h.index("i").frame("f").create_view_if_not_exists(
            "standard").create_fragment_if_not_exists(0)
        kw = {"device": "cpu"} if h is t else {}
        conts = {1: ("array", ing._build_array(np.array([4, 5]), 32768,
                                                **kw)),
                 2: ("array", ing._build_array(np.array([7, 8]), 32768,
                                                **kw))}
        got.append(frag.install_batch(rows, cols, conts, {1: 2, 2: 2}))
    assert got[0] == got[1] == {"array": 1}
    j.close()
    t.close()
    assert _fragment_files(t.path) == _fragment_files(j.path)


def test_max_batch_bits_413_and_raising_classify(tmp_path, monkeypatch):
    j, t = _pair(tmp_path)
    _schema(j, t)
    r, c = _bits(12, 5000)
    for P, E, h in ((JPipe, JIngestError, j), (TPipe, TIngestError, t)):
        with pytest.raises(E) as e:
            P(h, max_batch_bits=4999).ingest_bits("i", "f", r, c)
        assert e.value.status == 413
    assert str(e.value) == ("batch of 5000 bits exceeds [ingest] "
                            "max-batch-bits (4999)")

    def boom(*a, **kw):
        raise RuntimeError("classify failed")

    monkeypatch.setitem(tbitops._INGEST_KERNELS, "classify", boom)
    monkeypatch.setitem(jbitops._INGEST_KERNELS, "classify", boom)
    snaps = []
    for P, h in ((JPipe, j), (TPipe, t)):
        p = P(h)
        with pytest.raises(RuntimeError):
            p.ingest_bits("i", "f", r, c)
        snaps.append(p.snapshot())
        assert sum(_row_counts(h).values()) == 0
    assert snaps[0] == snaps[1] and snaps[1]["errorsTotal"] == 1
    j.close()
    t.close()
    assert _fragment_files(t.path) == _fragment_files(j.path)


# ----------------------------------------------------------------- route

def _dispatch(handler, method, path, body=b"", ctype=None):
    u = urlparse(path)
    headers = {"Content-Type": ctype} if ctype else {}
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    return tuple(handler.dispatch(method, u.path, parse_qs(u.query), body,
                                  headers)[:3])


def _handlers(j, t, ingest=True, **kw):
    jh = JHandler(j, JExecutor(j), ingest=JPipe(j, **kw) if ingest else None)
    th = THandler(t, TExecutor(t), ingest=TPipe(t, **kw) if ingest else None)
    return jh, th


def _route_script():
    r, c = _bits(13, 8000)
    ts = np.random.default_rng(13).integers(TS0, TS0 + 5 * 86400, len(r))
    ts[::2] = 0
    vc = np.arange(0, 3 * SLICE_WIDTH, 1021)[:500]
    q = "/index/i/query"
    return [
        ("POST", "/index/i/ingest", jcodec.encode_bits("f", r, c), CT),
        ("POST", "/index/i/ingest", jcodec.encode_bits("t", r, c, ts), CT),
        ("POST", "/index/i/ingest?slice=0",
         jcodec.encode_bits("inv", r[:500] % 9, c[:500]), CT),
        ("POST", "/index/i/ingest", jcodec.encode_values(
            "b", "v", vc, np.arange(500) % 900), CT),
        ("POST", "/index/i/ingest", {"frame": "f", "rows": [1, 2, 2],
                                     "columns": [7, 8, 2**21],
                                     "timestamps": [None, TS0, 0]}),
        ("POST", "/index/i/ingest", {"frame": "t", "rows": [1],
                                     "columns": [3],
                                     "timestamps": [TS0 + 86400]}),
        ("POST", "/index/i/ingest", {"frame": "b", "field": "v",
                                     "columns": [1, 2], "values": [5, 6]}),
        ("POST", "/index/i/ingest", {"frame": "f", "rows": [],
                                     "columns": []}),
        ("POST", "/index/i/ingest", MALFORMED["rows"], CT),          # 400
        ("POST", "/index/i/ingest", b"PTIN1\x05", CT),               # 400
        ("POST", "/index/i/ingest", {"rows": [1], "columns": [1]}),  # 400
        ("POST", "/index/i/ingest", {"frame": "f", "rows": [1]}),    # 400
        ("POST", "/index/i/ingest", {"frame": "f", "rows": [-1],
                                     "columns": [1]}),               # 400
        ("POST", "/index/i/ingest", {"frame": "f", "rows": [1, 2],
                                     "columns": [1]}),               # 400
        ("POST", "/index/i/ingest", {"frame": "b", "field": "w",
                                     "columns": [1], "values": [1]}),
        ("POST", "/index/i/ingest", {"frame": "b", "field": "v",
                                     "columns": [1], "values": [5000]}),
        ("POST", "/index/i/ingest?slice=x", {"frame": "f", "rows": [1],
                                             "columns": [1]}),       # 400
        ("POST", "/index/i/ingest", b"{not json"),                   # 400
        ("POST", "/index/i/ingest", {"frame": "nope", "rows": [1],
                                     "columns": [1]}),               # 404
        ("POST", "/index/nope/ingest", {"frame": "f", "rows": [1],
                                        "columns": [1]}),            # 404
        ("POST", "/index/i/ingest", {"frame": "f",
                                     "rows": list(range(8001)),
                                     "columns": list(range(8001))}),  # 413
        ("POST", q, 'Count(Bitmap(frame="f", rowID=5))'),
        ("POST", q, 'Count(Intersect(Bitmap(frame="f", rowID=1), '
                    'Bitmap(frame="f", rowID=2)))'),
        ("POST", q, 'TopN(frame="f", n=5)'),
        ("POST", q, 'Bitmap(frame="inv", columnID=3)'),
        ("POST", q, 'Count(Range(frame="t", rowID=1, '
                    'start="2017-06-01T00:00", end="2017-06-03T00:00"))'),
        ("POST", q, 'Sum(frame="b", field="v")'),
        ("GET", "/export?index=i&frame=f&slice=2"),
    ]


def test_route_answers_match_reference(tmp_path):
    j, t = _pair(tmp_path)
    _schema(j, t)
    jh, th = _handlers(j, t, max_batch_bits=8000)
    seen = set()
    for method, path, *rest in _route_script():
        body = rest[0] if rest else b""
        if isinstance(body, str):
            body = body.encode()
        ctype = rest[1] if len(rest) > 1 else None
        got = _dispatch(th, method, path, body, ctype)
        assert got == _dispatch(jh, method, path, body, ctype), \
            (path, body[:80])
        seen.add(got[0])
    assert {200, 400, 404, 413} <= seen
    snap = json.loads(_dispatch(th, "GET", "/debug/vars")[2])["ingest"]
    assert snap == jh.ingest.snapshot()
    jh0, th0 = _handlers(j, t, ingest=False)
    req = ("POST", "/index/i/ingest", {"frame": "f", "rows": [1],
                                       "columns": [1]})
    got = _dispatch(th0, *req)
    assert got[0] == 501 and got == _dispatch(jh0, *req)
    assert json.loads(_dispatch(th0, "GET", "/debug/vars")[2])[
        "ingest"] == {"enabled": False}
    j.close()
    t.close()
    assert _fragment_files(t.path) == _fragment_files(j.path)


def test_count_after_ingest_misses_every_memo(tmp_path, monkeypatch):
    """With the result memos, the plan cache and the response cache on,
    a Count repeated after an ingest sees the new bits."""
    monkeypatch.setenv("PILOSA_TPU_RESULT_MEMO", "1")
    t = THolder(str(tmp_path / "t"), device="cpu").open()
    t.create_index("i").create_frame("f", TFO())
    th = THandler(t, TExecutor(t), ingest=TPipe(t))
    th.enable_response_cache()
    q = ('Count(Intersect(Bitmap(frame="f", rowID=1), '
         'Bitmap(frame="f", rowID=2)))')
    answers = []
    for k in range(3):
        _dispatch(th, "POST", "/index/i/ingest", tcodec.encode_bits(
            "f", [1, 2], [k * 7, k * 7]), CT)
        for _ in range(2):
            answers.append(json.loads(_dispatch(
                th, "POST", "/index/i/query", q.encode())[2]))
    assert [a["results"][0] for a in answers] == [1, 1, 2, 2, 3, 3]
    t.close()


def _raw(host, method, path, body, headers):
    conn = http.client.HTTPConnection(host, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_ingest_body_cap_over_a_socket(tmp_path):
    """A body over the 8 MiB request cap is taken on the ingest route
    and refused (413) on /import; a chunked ingest body lands too."""
    s = TServer(str(tmp_path / "d"), bind="localhost:0",
                device="cpu").open()
    try:
        s.holder.create_index("i").create_frame("f", TFO())
        n = 560_000  # 8,960,035 bytes of binary frame
        rng = np.random.default_rng(14)
        cols = rng.integers(0, 2 * SLICE_WIDTH, n)
        big = tcodec.encode_bits("f", np.zeros(n, np.int64), cols)
        assert len(big) > 8 << 20
        status, data = _raw(s.host, "POST", "/index/i/ingest", big,
                            {"Content-Type": CT})
        assert status == 200
        assert json.loads(data) == {"accepted": n, "slices": 2}
        host, port = s.host.rsplit(":", 1)
        head = (b"Host: x\r\nContent-Length: %d\r\n" % len(big))
        with socket.create_connection((host, int(port)), timeout=30) as c:
            # Refused before a byte of the body is sent.
            c.sendall(b"POST /import HTTP/1.1\r\n" + head + b"\r\n")
            got = b""
            while not got.endswith(b"}"):
                part = c.recv(65536)
                if not part:
                    break
                got += part
        assert got.startswith(b"HTTP/1.1 413")
        assert got.endswith(b'{"error": "request body too large"}')
        with socket.create_connection((host, int(port)), timeout=30) as c:
            c.sendall(b"POST /index/i/ingest HTTP/1.1\r\n" + head
                      + b"Expect: 100-continue\r\n\r\n")
            assert c.recv(4096).startswith(b"HTTP/1.1 100")
        small = tcodec.encode_bits("f", [3, 3], [1, 2])

        def chunks():
            for k in range(0, len(small), 7):
                yield small[k:k + 7]

        # An iterable body: http.client sends it chunked.
        status, data = _raw(s.host, "POST", "/index/i/ingest", chunks(),
                            {"Content-Type": CT})
        assert (status, json.loads(data)) == (200, {"accepted": 2,
                                                    "slices": 1})
        status, data = _raw(s.host, "POST", "/index/i/query",
                            b'Count(Bitmap(frame="f", rowID=0)) '
                            b'Count(Bitmap(frame="f", rowID=3))', {})
        assert json.loads(data)["results"] == [len(np.unique(cols)), 2]
    finally:
        s.close()


def test_server_ingest_options(tmp_path, monkeypatch):
    """[ingest] enabled and max-batch-bits, and their environment
    variables (ref: pilosa_tpu server.py:470-495)."""
    monkeypatch.setenv("PILOSA_INGEST_MAX_BATCH_BITS", "123")
    s = TServer(str(tmp_path / "a"), device="cpu")
    assert s.ingest.max_batch_bits == 123
    s.holder.close()
    s = TServer(str(tmp_path / "b"), device="cpu",
                ingest={"max_batch_bits": 9})
    assert s.ingest.max_batch_bits == 9
    monkeypatch.setenv("PILOSA_INGEST_ENABLED", "false")
    assert TServer(str(tmp_path / "c"), device="cpu").ingest is None
    assert TServer(str(tmp_path / "d"), device="cpu",
                   ingest={"enabled": True}).ingest is not None
