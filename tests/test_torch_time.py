"""Port parity for time-quantum views and time ``Range``: the view cover
of pilosa_tpu_torch/time_quantum.py against pilosa_tpu's for every valid
quantum over seeded windows; timestamped SetBit/ClearBit/import_bits in
both packages giving byte-identical fragment files in every view; Range
and Count(Range) through both executors on the serial and the batched
path, with the reference's error messages; and a view created after a
cached Count seen by the next one. Three slices at full width. Counts
and column ids are exact: tolerance 0."""
import os
from datetime import datetime, timedelta

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu import time_quantum as jtq
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu.storage.index import FrameOptions as JFrameOptions
from pilosa_tpu_torch import time_quantum as ttq
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.storage.frame import FrameOptions as TFrameOptions
from pilosa_tpu_torch.storage.holder import Holder as THolder

QUANTA = ["Y", "M", "D", "H", "YM", "MD", "DH", "YMD", "MDH", "YMDH"]
PATHS = ("serial", "batched")
N_SLICES = 3
T0 = datetime(2016, 12, 30)  # bits fall over 2016-12-30 .. 2017-03-10


def _windows(seed, n=60):
    """Seeded (start, end) pairs, reversed and equal ones included, plus
    month-end, year-end and leap boundaries."""
    rng = np.random.default_rng(seed)
    out = [(datetime(2016, 12, 31, 23), datetime(2017, 1, 1, 1)),
           (datetime(2017, 1, 31), datetime(2017, 3, 1)),
           (datetime(2016, 2, 28, 22), datetime(2016, 3, 1, 2)),
           (datetime(2016, 1, 1), datetime(2018, 1, 1)),
           (datetime(2017, 6, 1), datetime(2017, 6, 1)),
           (datetime(2017, 7, 1), datetime(2017, 6, 1)),
           (datetime(2017, 12, 1), datetime(2018, 1, 1)),
           (datetime(2017, 11, 30, 5), datetime(2018, 2, 1, 3))]
    for _ in range(n):
        a = datetime(2015, 11, 1) + timedelta(hours=int(rng.integers(0, 30000)))
        b = a + timedelta(hours=int(rng.integers(-50, 6000)))
        out.append((a, b))
    return out


@pytest.mark.parametrize("quantum", QUANTA)
def test_views_by_time_range_matches_reference(quantum):
    for start, end in _windows(QUANTA.index(quantum)):
        for name in ("standard", "inverse"):
            assert (ttq.views_by_time_range(name, start, end, quantum)
                    == jtq.views_by_time_range(name, start, end, quantum)), (
                start, end)
        assert (ttq.views_by_time("standard", start, quantum)
                == jtq.views_by_time("standard", start, quantum))


@pytest.mark.parametrize("q", QUANTA + ["", "ymd", "YD", "MY", "HD", "YMDHX",
                                        "Q", "YMH"])
def test_validate_quantum_matches_reference(q):
    try:
        want = jtq.validate_quantum(q)
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            ttq.validate_quantum(q)
        assert str(info.value) == str(e)
    else:
        assert ttq.validate_quantum(q) == want


# ------------------------------------------------------------- data

def _bits(seed, n):
    """(rows, cols, timestamps) of ``n`` seeded bits over N_SLICES
    slices, rows 0-3, timestamps over ~70 days at hour resolution, one
    in eight without a timestamp."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, n).astype(np.uint64)
    cols = rng.integers(0, N_SLICES * SLICE_WIDTH, n).astype(np.uint64)
    hours = rng.integers(0, 70 * 24, n)
    ts = [None if h % 8 == 0 else T0 + timedelta(hours=int(h))
          for h in hours]
    return rows, cols, ts


def _frames(idx, options_cls):
    idx.create_frame("t", options_cls(time_quantum="YMD",
                                      inverse_enabled=True))
    idx.create_frame("h", options_cls(time_quantum="YMDH"))
    idx.create_frame("n", options_cls())


def _write(frames, rows, cols, ts):
    for name in ("t", "h", "n"):
        frames(name).import_bits(rows, cols, ts)


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    """A directory written by pilosa_tpu: frames t (YMD, inverse), h
    (YMDH) and n (no quantum), the same timestamped bits in each."""
    path = str(tmp_path_factory.mktemp("time") / "data")
    jh = JHolder(path).open()
    idx = jh.create_index("i")
    _frames(idx, JFrameOptions)
    _write(idx.frame, *_bits(1, 3000))
    jh.close()
    return path


def _fragment_files(root):
    """{relative path: bytes} of every fragment data file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.isdigit():
                full = os.path.join(d, f)
                with open(full, "rb") as fh:
                    out[os.path.relpath(full, root)] = fh.read()
    return out


def test_timestamped_writes_give_identical_files(tmp_path):
    """import_bits with timestamps, then timestamped SetBit and ClearBit
    through each package's executor (a new day view, a clear of an
    existing time view, a clear that must not create one)."""
    rows, cols, ts = _bits(2, 1500)
    writes = [
        'SetBit(frame="t", rowID=1, columnID=5, timestamp="2017-06-20T08:00")',
        'SetBit(frame="h", rowID=2, columnID=1048583, '
        'timestamp="2017-01-03T04:00")',
        'SetBit(frame="t", rowID=1, columnID=6, timestamp="2017-06-20T09:00")',
        'ClearBit(frame="t", rowID=1, columnID=5, timestamp="2017-06-20T08:00")',
        'ClearBit(frame="t", rowID=3, columnID=9, timestamp="2018-02-02T00:00")',
        f'ClearBit(frame="h", rowID={int(rows[7])}, columnID={int(cols[7])}, '
        f'timestamp="{(ts[7] or T0).strftime("%Y-%m-%dT%H:%M")}")',
        'SetBit(frame="n", rowID=0, columnID=77, timestamp="2017-01-01T00:00")',
    ]
    results = []
    for holder_cls, ex_cls, opts, kw, sub in (
            (JHolder, JExecutor, JFrameOptions, {}, "j"),
            (THolder, TExecutor, TFrameOptions, {"device": "cpu"}, "t")):
        h = holder_cls(str(tmp_path / sub), **kw).open()
        idx = h.create_index("i")
        _frames(idx, opts)
        _write(idx.frame, rows, cols, ts)
        ex = ex_cls(h)
        results.append([ex.execute("i", w)[0] for w in writes])
        h.close()
    assert results[0] == results[1]
    assert results[1][4] is False
    want = _fragment_files(str(tmp_path / "j"))
    got = _fragment_files(str(tmp_path / "t"))
    assert sorted(got) == sorted(want)
    assert any("standard_20170620" in p for p in got)
    assert not any("2018" in p for p in got)
    assert os.path.join("h", "views", "standard_2017010304", "fragments",
                        "1") in "\n".join(got)
    for p in want:
        assert got[p] == want[p], p


# ------------------------------------------------------------ queries

def _rng(frame, row, start, end):
    return (f'Range(frame="{frame}", rowID={row}, start="{start}", '
            f'end="{end}")')


WINDOWS = [
    ("2016-12-30T00:00", "2017-03-11T00:00"),   # everything
    ("2017-01-01T00:00", "2017-02-01T00:00"),   # one month view
    ("2016-12-31T05:00", "2017-01-02T07:00"),   # year end, hours
    ("2017-01-05T00:00", "2017-01-12T00:00"),   # days
    ("2017-02-27T10:00", "2017-03-02T13:00"),   # month end
    ("2017-01-01T00:00", "2018-01-01T00:00"),   # one year view
    ("2015-06-01T00:00", "2015-07-01T00:00"),   # views that do not exist
    ("2017-01-10T00:00", "2017-01-10T05:00"),   # empty cover for YMD
    ("2017-01-10T00:00", "2017-01-09T00:00"),   # reversed
]
QUERIES = (
    [f"Count({_rng(f, r, a, b)})" for f in ("t", "h", "n") for r in (0, 3)
     for a, b in WINDOWS]
    + [f'Count(Intersect({_rng("t", 1, *WINDOWS[3])}, '
       f'Bitmap(frame="t", rowID=2)))',
       f'Count(Union({_rng("t", 1, *WINDOWS[1])}, {_rng("h", 2, *WINDOWS[2])}))',
       f'Count(Difference({_rng("h", 0, *WINDOWS[0])}, '
       f'{_rng("h", 0, *WINDOWS[4])}))',
       f'Count(Xor({_rng("t", 2, *WINDOWS[5])}, {_rng("t", 3, *WINDOWS[3])}))']
)
RANGES = ([_rng("t", 0, *w) for w in WINDOWS[:6]]
          + [_rng("h", 3, *WINDOWS[2]), _rng("n", 0, *WINDOWS[0]),
             'Range(frame="t", columnID=5, start="2016-12-30T00:00", '
             'end="2017-03-11T00:00")'])


def _answers(holder, ex_cls, queries, path):
    ex = ex_cls(holder)
    ex._force_path = path
    out = []
    for q in queries:
        r = ex.execute("i", q)[0]
        out.append(r if isinstance(r, int) else r.columns().tolist())
    return out


@pytest.mark.parametrize("path", PATHS)
def test_range_answers_match_reference(datadir, path):
    jh = JHolder(datadir).open()
    try:
        want = _answers(jh, JExecutor, QUERIES + RANGES, path)
    finally:
        jh.close()
    th = THolder(datadir, device="cpu").open()
    try:
        got = _answers(th, TExecutor, QUERIES + RANGES, path)
    finally:
        th.close()
    assert got == want
    assert sum(want[:len(QUERIES)]) > 0 and max(map(len, want[-3:])) > 0


@pytest.mark.parametrize("query", [
    'Range(frame="zz", rowID=1, start="2017-01-01T00:00", end="2017-02-01T00:00")',
    'Range(frame="t", rowID=1, columnID=2, start="2017-01-01T00:00", '
    'end="2017-02-01T00:00")',
    'Range(frame="t", start="2017-01-01T00:00", end="2017-02-01T00:00")',
    'Range(frame="t", rowID=1, end="2017-02-01T00:00")',
    'Range(frame="t", rowID=1, start="2017-01-01T00:00")',
    'Range(frame="t", rowID=1, start="2017-01-01", end="2017-02-01T00:00")',
    'Range(frame="t", rowID=1, start="2017-01-01T00:00", end="tomorrow")',
    'SetBit(frame="t", rowID=1, columnID=2, timestamp="2017-13-01T00:00")',
])
@pytest.mark.parametrize("path", PATHS)
def test_range_errors_match_reference(datadir, query, path):
    msgs = []
    for holder_cls, ex_cls, kw in ((JHolder, JExecutor, {}),
                                   (THolder, TExecutor, {"device": "cpu"})):
        h = holder_cls(datadir, **kw).open()
        try:
            ex = ex_cls(h)
            ex._force_path = path
            for q in (query, f"Count({query})"):
                if q.startswith("Count(SetBit"):
                    continue
                with pytest.raises(Exception) as info:
                    ex.execute("i", q)
                msgs.append((type(info.value).__name__, str(info.value)))
        finally:
            h.close()
    half = len(msgs) // 2
    assert msgs[:half] == msgs[half:]


def test_new_view_after_cached_count_is_seen(tmp_path):
    """A Count whose cover names a day view that does not exist caches a
    zero stack; the SetBit that creates the view bumps the index epoch,
    so the next Count rebuilds and sees the bit, on both paths."""
    h = THolder(str(tmp_path / "d"), device="cpu").open()
    try:
        h.create_index("i", time_quantum="YMD").create_frame("c")
        assert h.index("i").frame("c").time_quantum == "YMD"
        ex = TExecutor(h)
        ex.execute("i", 'SetBit(frame="c", rowID=3, columnID=1048577, '
                        'timestamp="2017-06-02T10:00")')
        q = (f'Count({_rng("c", 3, "2017-06-01T00:00", "2017-06-15T00:00")}) '
             f'Count({_rng("c", 3, "2017-06-15T00:00", "2017-06-25T00:00")})')
        for path in PATHS:
            ex._force_path = path
            assert ex.execute("i", q) == [1, 0]
        ex._force_path = "batched"
        epoch = h.index("i").epoch.value
        assert ex.execute("i", 'SetBit(frame="c", rowID=3, columnID=9, '
                               'timestamp="2017-06-20T08:00")') == [True]
        assert h.index("i").epoch.value > epoch
        assert "standard_20170620" in h.index("i").frame("c").views
        for path in ("batched", "serial"):
            ex._force_path = path
            assert ex.execute("i", q) == [1, 1]
        assert ex.execute("i", 'ClearBit(frame="c", rowID=3, columnID=9, '
                               'timestamp="2017-06-20T08:00")') == [True]
        for path in PATHS:
            ex._force_path = path
            assert ex.execute("i", q) == [1, 0]
    finally:
        h.close()
