"""Port parity for bitmap results and the attribute stores: top-level
Bitmap/Intersect/Union/Difference/Xor/Range answered by pilosa_tpu's
executor and the port's, serial and batched (windowed halves included),
compared by ``columns()``, ``count()`` and ``attrs``; an inverse
``Bitmap(columnID=…)`` over the inverse slice list; ``exclude_attrs`` /
``exclude_bits``; SetRowAttrs (single and bulk) and SetColumnAttrs with
``.data`` files written by one package and read by the other; TopN
attribute filters on both paths; and the deferred result stack. Ten
slices at full width: words with bit 31 set, an all-ones row, an
all-zero slice and a missing one. Ids and counts are exact: tolerance 0.
"""
import sqlite3
from datetime import datetime

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import ExecOptions as JExecOptions
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.storage.frame import Field as JField
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu.storage.index import FrameOptions as JFrameOptions
from pilosa_tpu_torch import WORDS_PER_SLICE
from pilosa_tpu_torch.bitmap import Bitmap
from pilosa_tpu_torch.executor import ExecOptions as TExecOptions
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.storage.holder import Holder as THolder

N_SLICES = 10
EMPTY_SLICE = 2     # fragment exists, every row emptied
MISSING_SLICE = 3   # no fragment at all
ONES_SLICE = 4      # row 2 all ones
PATHS = ("serial", "batched")
T_ROWS = range(10, 18)


def _rand(rng, k):
    """uint64[16384] words of bit density 2^-k."""
    w = rng.integers(0, 1 << 64, 16384, dtype=np.uint64)
    for _ in range(k - 1):
        w &= rng.integers(0, 1 << 64, 16384, dtype=np.uint64)
    return w


def _positions(words):
    return np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little")).astype(np.uint64)


def _f_rows(s):
    """{row: words} of frame f in slice s: row 0 at density 1/8, row 1
    with bit 31 of every 32-bit word set, row 2 sparse (all ones in
    ONES_SLICE), row 3 sparse."""
    rng = np.random.default_rng([5, s])
    bit31 = np.uint64((1 << 31) | (1 << 63))
    ones = np.full(16384, ~np.uint64(0), np.uint64)
    return {0: _rand(rng, 3), 1: _rand(rng, 4) | bit31,
            2: ones if s == ONES_SLICE else _rand(rng, 6),
            3: _rand(rng, 9)}


def _import(frag, rows, s):
    rs, cs = [], []
    for r, w in rows.items():
        pos = _positions(w)
        rs.append(np.full(len(pos), r, np.uint64))
        cs.append(pos + np.uint64(s * SLICE_WIDTH))
    frag.import_bits(np.concatenate(rs), np.concatenate(cs))


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    """A directory written by pilosa_tpu: frame f (4 rows), frame t (8
    rows, the TopN candidates), frame inv (inverse-enabled), frame c (a
    YMD time quantum) and frame b (a BSI field)."""
    path = str(tmp_path_factory.mktemp("results") / "data")
    jh = JHolder(path).open()
    idx = jh.create_index("i")
    f = idx.create_frame("f")
    t = idx.create_frame("t")
    inv = idx.create_frame("inv", JFrameOptions(inverse_enabled=True))
    c = idx.create_frame("c", JFrameOptions(time_quantum="YMD"))
    b = idx.create_frame("b", JFrameOptions(range_enabled=True, fields=[
        JField("v", min=0, max=100)]))
    fv = f.create_view_if_not_exists("standard")
    tv = t.create_view_if_not_exists("standard")
    rng = np.random.default_rng(9)
    for s in range(N_SLICES):
        if s == MISSING_SLICE:
            continue
        if s == EMPTY_SLICE:
            frag = fv.create_fragment_if_not_exists(s)
            frag.set_bit(5, s * SLICE_WIDTH + 7)
            frag.clear_bit(5, s * SLICE_WIDTH + 7)
            continue
        _import(fv.create_fragment_if_not_exists(s), _f_rows(s), s)
        _import(tv.create_fragment_if_not_exists(s),
                {r: _rand(rng, 1 + r % 5) for r in T_ROWS}, s)
        cols = rng.choice(SLICE_WIDTH, 3000, replace=False).astype(
            np.uint64) + np.uint64(s * SLICE_WIDTH)
        inv.import_bits(rng.integers(0, 4, 3000).astype(np.uint64), cols)
        c.import_bits(rng.integers(0, 3, 3000).astype(np.uint64), cols,
                      [None if i % 5 == 0 else datetime(2017, 6, 1 + i % 20)
                       for i in range(3000)])
        b.import_value("v", cols[:500], rng.integers(0, 101, 500))
    inv.import_bits([1, 2], [5, 5])
    jh.close()
    return path


def _row(r, frame="f"):
    return f'Bitmap(frame="{frame}", rowID={r})'


BITMAP_QUERIES = [
    _row(0), _row(1), _row(3), _row(9),
    'Bitmap(frame="inv", columnID=5)',
    f"Intersect({_row(3)}, {_row(0)})",
    f"Intersect({_row(1)}, {_row(2)})",
    f"Union({_row(3)}, {_row(1)})",
    f"Union({_row(2)})",
    f"Difference({_row(2)}, {_row(1)})",
    f"Xor({_row(3)}, Intersect({_row(3)}, {_row(0)}))",
    f"Xor({_row(1)}, {_row(2)}, {_row(3)})",
    f'Intersect({_row(0)}, Range(frame="b", v > 60))',
    'Range(frame="b", v >< [10, 20])',
    'Range(frame="c", rowID=1, start="2017-06-03T00:00", '
    'end="2017-06-12T00:00")',
    f'Union({_row(3)}, Range(frame="c", rowID=2, start="2017-06-01T00:00", '
    'end="2017-07-01T00:00"))',
    f'Intersect({_row(9)}, {_row(0)})',
    f'Intersect({_row(3)}, Range(frame="b", v > 500))',
]


def _results(holder, ex_cls, queries, path, opt=None, budget=None):
    ex = ex_cls(holder)
    ex._force_path = path
    if budget is not None:
        ex.STACK_CACHE_BYTES = budget
    out = []
    for q in queries:
        bm = ex.execute("i", q, opt=opt)[0]
        out.append((bm.columns().tolist(), bm.count(), bm.attrs))
    return out


def _reference(path, queries, path_name, opt=None):
    jh = JHolder(path).open()
    try:
        return _results(jh, JExecutor, queries, path_name, opt)
    finally:
        jh.close()


@pytest.mark.parametrize("path_name", PATHS)
def test_bitmap_results_match_reference(datadir, path_name):
    want = _reference(datadir, BITMAP_QUERIES, path_name)
    th = THolder(datadir, device="cpu").open()
    try:
        got = _results(th, TExecutor, BITMAP_QUERIES, path_name)
    finally:
        th.close()
    for q, g, w in zip(BITMAP_QUERIES, got, want):
        assert g == w, q
        assert g[1] == len(g[0])
    ones = [c for c in got[BITMAP_QUERIES.index(f"Union({_row(2)})")][0]
            if c // SLICE_WIDTH == ONES_SLICE]
    assert len(ones) == SLICE_WIDTH
    assert any(c % 32 == 31 for c in got[1][0])
    assert got[3][0] == [] and got[4][0] != []


def test_windowed_halves_match_reference(datadir, monkeypatch):
    """A stack budget of two leaves and a result over half the slices:
    the compound trees run as two batched windows whose deferred stacks
    merge, and the ids still come out ascending."""
    queries = [q for q in BITMAP_QUERIES if q.count("Bitmap(") == 2
               and "Range" not in q]
    want = _reference(datadir, queries, "batched")
    th = THolder(datadir, device="cpu").open()
    try:
        calls = []
        real = TExecutor._batched_bitmap

        def spy(self, index, call, slices):
            calls.append(len(slices))
            return real(self, index, call, slices)

        monkeypatch.setattr(TExecutor, "_batched_bitmap", spy)
        budget = 3 * (N_SLICES // 2) * WORDS_PER_SLICE * 4
        got = _results(th, TExecutor, queries, "batched", budget=budget)
    finally:
        th.close()
    assert got == want
    assert calls == [N_SLICES, N_SLICES // 2, N_SLICES // 2] * len(queries)
    for cols, _, _ in got:
        assert cols == sorted(cols)


@pytest.mark.parametrize("exclude_attrs,exclude_bits",
                         [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("path_name", PATHS)
def test_exclude_options_match_reference(datadir, exclude_attrs,
                                         exclude_bits, path_name):
    queries = [_row(3), f"Intersect({_row(3)}, {_row(0)})"]
    writes = ('SetRowAttrs(frame="f", rowID=3, name="stargazer", '
              'active=true)')
    jh = JHolder(datadir).open()
    try:
        JExecutor(jh).execute("i", writes)
        want = _results(jh, JExecutor, queries, path_name,
                        JExecOptions(exclude_attrs=exclude_attrs,
                                     exclude_bits=exclude_bits))
    finally:
        jh.close()
    th = THolder(datadir, device="cpu").open()
    try:
        got = _results(th, TExecutor, queries, path_name,
                       TExecOptions(exclude_attrs=exclude_attrs,
                                    exclude_bits=exclude_bits))
        full = _results(th, TExecutor, queries[:1], path_name)[0]
    finally:
        th.close()
    assert got == want
    assert full[2] == {"name": "stargazer", "active": True}
    assert (got[0][0] == []) == exclude_bits
    assert (got[0][2] == {}) == exclude_attrs


def _attr_rows(path):
    with sqlite3.connect(path) as db:
        return db.execute("SELECT id, val FROM attrs ORDER BY id").fetchall()


ATTR_WRITES = [
    'SetRowAttrs(frame="t", rowID=10, category="a", stars=5) '
    'SetRowAttrs(frame="t", rowID=11, category="b") '
    'SetRowAttrs(frame="t", rowID=12, category="c") '
    'SetRowAttrs(frame="t", rowID=13, category="a", level=2) '
    'SetRowAttrs(frame="t", rowID=14, category="b") '
    'SetRowAttrs(frame="t", rowID=10, stars=null, tag="x")',
    'SetRowAttrs(frame="t", rowID=16, category="b", level=1)',
    'SetRowAttrs(frame="t", rowID=12, category="a")',
    'SetColumnAttrs(columnID=100, category="x", score=1.5)',
    'SetColumnAttrs(columnID=100, score=null) '
    f'SetColumnAttrs(columnID={5 * SLICE_WIDTH + 3}, name="far")',
    'SetRowAttrs(frame="f", rowID=3, name="stargazer", active=true)',
]
ATTR_READS = [_row(10, "t"), _row(12, "t"), _row(16, "t"), _row(3),
              'Bitmap(frame="inv", columnID=100)']


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_attribute_stores_are_shared(tmp_path, writer):
    """Attributes written by one package are read back by the other:
    bulk and single SetRowAttrs, SetColumnAttrs, a null deleting a key;
    the sqlite rows of both stores are identical."""
    dirs = {}
    for who in ("port", "reference"):
        path = str(tmp_path / who)
        jh = JHolder(path).open()
        idx = jh.create_index("i")
        for name in ("f", "t"):
            idx.create_frame(name)
        idx.create_frame("inv", JFrameOptions(inverse_enabled=True))
        jh.close()
        h = (THolder(path, device="cpu") if who == "port"
             else JHolder(path)).open()
        ex = (TExecutor if who == "port" else JExecutor)(h)
        res = [ex.execute("i", w) for w in ATTR_WRITES]
        h.close()
        assert res[0] == [None] * 6 and res[1] == [None]
        dirs[who] = path
    for sub in ("i/.data", "i/t/.data", "i/f/.data"):
        assert (_attr_rows(f"{dirs['port']}/{sub}")
                == _attr_rows(f"{dirs['reference']}/{sub}"))
    path = dirs[writer]
    reads = {}
    for who, holder, ex_cls in (("port", THolder(path, device="cpu"),
                                 TExecutor),
                                ("reference", JHolder(path), JExecutor)):
        h = holder.open()
        ex = ex_cls(h)
        reads[who] = [ex.execute("i", q)[0].attrs for q in ATTR_READS]
        h.close()
    assert reads["port"] == reads["reference"]
    assert reads["port"][0] == {"category": "a", "tag": "x"}
    assert reads["port"][4] == {"category": "x"}


TOPN_FILTERS = [
    'TopN(frame="t", n=3, field="category", filters=["a", "b"])',
    f'TopN({_row(0)}, frame="t", n=3, field="category", filters=["a", "b"])',
    f'TopN({_row(0)}, frame="t", n=2, field="category", filters=["a"])',
    f'TopN({_row(1)}, frame="t", field="level", filters=[1, 2])',
    f'TopN({_row(0)}, frame="t", ids=[10, 11, 12, 16], field="category", '
    'filters=["b", "c"])',
    f'TopN({_row(0)}, frame="t", n=4, field="category", filters=["zz"])',
    f'TopN({_row(0)}, frame="t", n=4, field="nope", filters=["a"])',
    f'TopN({_row(0)}, frame="t", n=3, tanimotoThreshold=10, '
    'field="category", filters=["a", "c"])',
]


@pytest.mark.parametrize("path_name", PATHS)
def test_topn_attribute_filters_match_reference(datadir, path_name):
    jh = JHolder(datadir).open()
    try:
        ex = JExecutor(jh)
        ex.execute("i", ATTR_WRITES[0])
        ex.execute("i", ATTR_WRITES[1])
        ex._force_path = path_name
        want = [ex.execute("i", q)[0] for q in TOPN_FILTERS]
    finally:
        jh.close()
    th = THolder(datadir, device="cpu").open()
    try:
        ex = TExecutor(th)
        ex._force_path = path_name
        got = [ex.execute("i", q)[0] for q in TOPN_FILTERS]
    finally:
        th.close()
    assert got == want
    assert {r for r, _ in got[0]} <= {10, 11, 13, 14, 16}
    assert got[0] and got[5] == [] and got[6] == []


def test_inverse_bitmap_spans_the_inverse_slices(tmp_path):
    """Bitmap(columnID=c) reads the inverse view, whose slices are row
    ids: a column set for row 3·2^20 + 5 answers from inverse slice 3,
    beyond the standard view's only slice."""
    path = str(tmp_path / "d")
    far = 3 * SLICE_WIDTH + 5
    jh = JHolder(path).open()
    jh.create_index("i").create_frame(
        "inv", JFrameOptions(inverse_enabled=True))
    JExecutor(jh).execute("i", f'SetBit(frame="inv", rowID={far}, '
                               'columnID=9) SetBit(frame="inv", rowID=2, '
                               'columnID=9)')
    want = {p: _results(jh, JExecutor, ['Bitmap(frame="inv", columnID=9)'],
                        p) for p in PATHS}
    jh.close()
    th = THolder(path, device="cpu").open()
    try:
        assert th.index("i").max_slice() == 0
        assert th.index("i").max_inverse_slice() == 3
        for p in PATHS:
            got = _results(th, TExecutor, ['Bitmap(frame="inv", columnID=9)'],
                           p)
            assert got == want[p]
            assert got[0][0] == [2, far]
    finally:
        th.close()


def test_bitmap_defer_stack_lazy():
    """A batched result stays one device stack until a caller touches
    segment words; count() never splits it (the port of
    tests/test_executor.py::test_bitmap_defer_stack_lazy, at full slice
    width: the port has no column windows)."""
    stack = torch.zeros((3, WORDS_PER_SLICE), dtype=torch.int32)
    stack[0, 0] = 1
    stack[2, 0], stack[2, 1] = 3, -2**31
    counts = np.array([1, 0, 3])
    bm = Bitmap()
    bm.defer_stack(stack, [0, 1, 5], counts)
    assert bm._stack is not None
    assert bm.count() == 4          # from counts, no split
    assert bm.columns().tolist() == [0, 5 * SLICE_WIDTH,
                                     5 * SLICE_WIDTH + 1,
                                     5 * SLICE_WIDTH + 63]
    assert bm._stack is not None    # columns() read the stack whole
    segs = bm.segments              # first touch splits
    assert bm._stack is None
    assert sorted(segs) == [0, 5]   # zero-count slice dropped
    assert segs[5].shape == (WORDS_PER_SLICE,)
    assert segs[5].data_ptr() == stack[2].data_ptr()   # a view, no copy

    # An empty target adopts a deferred stack without splitting it.
    bm2 = Bitmap()
    bm2.defer_stack(stack, [0, 1, 5], counts)
    target = Bitmap()
    target.merge(bm2)
    assert target._stack is not None and target.count() == 4
    assert target == bm2

    # Merging into content splits both and ors overlapping slices.
    other = Bitmap.from_columns([5 * SLICE_WIDTH + 2, 7 * SLICE_WIDTH],
                                device="cpu")
    other.defer_stack(stack, [0, 1, 5], counts)
    assert other.columns().tolist() == [0, 5 * SLICE_WIDTH,
                                        5 * SLICE_WIDTH + 1,
                                        5 * SLICE_WIDTH + 2,
                                        5 * SLICE_WIDTH + 63,
                                        7 * SLICE_WIDTH]
    assert other.count() == 6
    assert other.host_words(5)[0] == np.uint64(7 | (1 << 63))

    # segments assignment (the exclude_bits strip) clears the deferral.
    bm3 = Bitmap()
    bm3.defer_stack(stack, [0, 1, 5], counts)
    bm3.segments = {}
    assert bm3.count() == 0 and bm3.columns().tolist() == []


@pytest.mark.parametrize("bits_per_pass,group", [(1 << 23, 1024), (5000, 3),
                                                 (1, 1)])
def test_columns_in_passes_match_numpy(monkeypatch, bits_per_pass, group):
    """columns() cut into passes by bit count and into segment groups
    lists every id once, in order: rows of mixed density (zero, sparse,
    dense, bit 31 in every word) against numpy's unpacking."""
    import pilosa_tpu_torch.bitmap as tbitmap

    monkeypatch.setattr(tbitmap, "_BITS_PER_PASS", bits_per_pass)
    monkeypatch.setattr(tbitmap, "_SEGMENTS_PER_GROUP", group)
    rng = np.random.default_rng(bits_per_pass)
    rows = [_rand(rng, k) for k in (12, 1, 9, 14, 3, 6, 12)]
    rows[3][:] = 0
    rows[5] |= np.uint64((1 << 31) | (1 << 63))
    words = np.stack(rows)
    slice_ids = [0, 2, 3, 7, 8, 11, 40]
    want = np.concatenate([_positions(w) + np.uint64(s * SLICE_WIDTH)
                           for w, s in zip(words, slice_ids)])
    counts = np.bitwise_count(words).sum(axis=1)
    stack = torch.from_numpy(words.view(np.int32).copy())
    bm = Bitmap()
    bm.defer_stack(stack, slice_ids, counts)
    assert np.array_equal(bm.columns(), want)
    _ = bm.segments
    assert np.array_equal(bm.columns(), want)
    assert bm.count() == len(want)
