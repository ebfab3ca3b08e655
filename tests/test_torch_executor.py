"""Port parity for the Count path: one data directory, the same PQL
through pilosa_tpu's executor and the port's, on the serial and the
batched path each, plus SetBit/ClearBit written by one package and
recounted by the other. Six slices at the full 32768-word width, with an
empty fragment and a missing one. Counts are integers: tolerance 0."""
import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu_torch import errors as terr
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.storage.holder import Holder as THolder

N_SLICES = 6
EMPTY_SLICE = 2     # fragment exists, every row empty
MISSING_SLICE = 3   # no fragment at all


def _row(r):
    return f'Bitmap(frame="f", rowID={r})'


R0, R1, R2 = _row(0), _row(1), _row(2)
QUERIES = [
    f"Count({R0})",
    f"Count({R2})",
    f"Count({_row(9)})",                       # row absent everywhere
    f"Count(Intersect({R0}, {R1}))",
    f"Count(Union({R0}, {R1}))",
    f"Count(Difference({R0}, {R1}))",
    f"Count(Xor({R0}, {R1}))",
    f"Count(Intersect({R0}, {R1}, {R2}))",
    f"Count(Difference(Union({R0}, {R2}), Intersect({R1}, {R2})))",
    f"Count(Xor({R2}, Union({R0}, Intersect({R1}, {R2}))))",
    f"Count(Union({R2}))",
]
# np words -> count, mirroring QUERIES over {row: uint64 words}
ORACLE = [
    lambda w: w[0], lambda w: w[2], lambda w: w[9],
    lambda w: w[0] & w[1], lambda w: w[0] | w[1], lambda w: w[0] & ~w[1],
    lambda w: w[0] ^ w[1], lambda w: w[0] & w[1] & w[2],
    lambda w: (w[0] | w[2]) & ~(w[1] & w[2]),
    lambda w: w[2] ^ (w[0] | (w[1] & w[2])), lambda w: w[2],
]


def _slice_rows(s):
    """{row: uint64[16384]} of slice s; rows missing from a slice read
    as zeros."""
    rng = np.random.default_rng(100 + s)
    zero = np.zeros(16384, np.uint64)
    rows = {r: zero for r in (0, 1, 2, 9)}
    if s in (EMPTY_SLICE, MISSING_SLICE):
        return rows

    def rand():
        return rng.integers(0, 1 << 64, 16384, dtype=np.uint64)

    rows[0] = rand()
    rows[1] = rand() & rand() & rand() if s == 1 else rand()
    if s != 1:
        rows[2] = rand() & rand()
    return rows


def _oracle(words_by_slice):
    return [sum(int(np.bitwise_count(fn(words_by_slice[s])).sum())
                for s in range(N_SLICES)) for fn in ORACLE]


def _put(words, s, r, col, value):
    """Oracle write: bit ``col`` (within slice s) of row r."""
    w = words[s][r].copy()
    mask = np.uint64(1 << (col % 64))
    w[col // 64] = w[col // 64] | mask if value else w[col // 64] & ~mask
    words[s] = dict(words[s])
    words[s][r] = w


def _positions(words):
    return np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little")).astype(np.uint64)


@pytest.fixture
def datadir(tmp_path):
    """Directory written by pilosa_tpu; returns (path, words by slice)."""
    path = str(tmp_path / "data")
    jh = JHolder(path).open()
    frame = jh.create_index("i").create_frame("f")
    words = {}
    view = frame.create_view_if_not_exists("standard")
    for s in range(N_SLICES):
        words[s] = _slice_rows(s)
        if s == MISSING_SLICE:
            continue
        frag = view.create_fragment_if_not_exists(s)
        rows, cols = [], []
        for r, w in words[s].items():
            pos = _positions(w)
            rows.append(np.full(len(pos), r, np.uint64))
            cols.append(pos + np.uint64(s * SLICE_WIDTH))
        if sum(len(c) for c in cols):
            frag.import_bits(np.concatenate(rows), np.concatenate(cols))
        if s == EMPTY_SLICE:   # a row that existed and was emptied
            frag.set_bit(5, s * SLICE_WIDTH + 7)
            frag.clear_bit(5, s * SLICE_WIDTH + 7)
    jh.close()
    return path, words


def _run_jax(path, queries, paths=("serial", "batched")):
    jh = JHolder(path).open()
    try:
        ex = JExecutor(jh)
        out = {}
        for p in paths:
            ex._force_path = p
            out[p] = [ex.execute("i", q)[0] for q in queries]
        return out
    finally:
        jh.close()


def _run_port(path, queries, paths=("serial", "batched")):
    th = THolder(path, device="cpu").open()
    try:
        ex = TExecutor(th)
        out = {}
        for p in paths:
            ex._force_path = p
            out[p] = [ex.execute("i", q)[0] for q in queries]
        return out
    finally:
        th.close()


def test_count_queries_match_reference_on_both_paths(datadir):
    path, words = datadir
    want = _oracle(words)
    jax_out = _run_jax(path, QUERIES)
    port_out = _run_port(path, QUERIES)
    for p in ("serial", "batched"):
        assert jax_out[p] == want, p
        assert port_out[p] == want, p


@pytest.mark.parametrize("path_name", ["serial", "batched"])
def test_writes_by_port_recount_in_both_packages(datadir, path_name):
    path, words = datadir
    # A set bit in the missing slice creates its fragment; a clear in
    # slice 0 removes a bit of row 0 that the queries all read.
    c0 = int(_positions(words[0][0])[17])
    writes = [
        f'SetBit(frame="f", rowID=0, columnID={MISSING_SLICE * SLICE_WIDTH + 99})',
        f'SetBit(frame="f", rowID=1, columnID={MISSING_SLICE * SLICE_WIDTH + 99})',
        f'ClearBit(frame="f", rowID=0, columnID={c0})',
        f'ClearBit(frame="f", rowID=0, columnID={c0})',
        f'SetBit(frame="f", rowID=2, columnID={5 * SLICE_WIDTH + 3})',
    ]
    th = THolder(path, device="cpu").open()
    ex = TExecutor(th)
    ex._force_path = path_name
    before = [ex.execute("i", q)[0] for q in QUERIES]  # warms stack cache
    applied = [ex.execute("i", w)[0] for w in writes]
    after = [ex.execute("i", q)[0] for q in QUERIES]
    th.close()

    was_set = bool(words[5][2][0] & np.uint64(1 << 3))
    _put(words, MISSING_SLICE, 0, 99, True)
    _put(words, MISSING_SLICE, 1, 99, True)
    _put(words, 0, 0, c0 % SLICE_WIDTH, False)
    _put(words, 5, 2, 3, True)
    assert before != after
    assert applied == [True, True, True, False, not was_set]
    assert after == _oracle(words)
    assert _run_jax(path, QUERIES, (path_name,))[path_name] == after


def test_writes_by_reference_recount_in_port(datadir):
    path, words = datadir
    jh = JHolder(path).open()
    ex = JExecutor(jh)
    col = 4 * SLICE_WIDTH + 1234
    assert ex.execute("i", f'SetBit(frame="f", rowID=9, columnID={col})') \
        == [True]
    jh.close()
    out = _run_port(path, [f"Count({_row(9)})",
                           f"Count(Union({_row(9)}, {R2}))"])
    r2 = sum(int(np.bitwise_count(words[s][2]).sum())
             for s in range(N_SLICES))
    extra = 0 if words[4][2][1234 // 64] & np.uint64(1 << (1234 % 64)) else 1
    for p in ("serial", "batched"):
        assert out[p] == [1, r2 + extra]


def test_stack_cache_evicts_to_its_byte_budget(datadir):
    path, words = datadir
    th = THolder(path, device="cpu").open()
    try:
        ex = TExecutor(th)
        ex._force_path = "batched"
        one_stack = N_SLICES * 32768 * 4
        ex.STACK_CACHE_BYTES = 2 * one_stack   # room for two of four leaves
        for _ in range(2):
            assert [ex.execute("i", q)[0] for q in QUERIES] == _oracle(words)
            assert ex._stack_bytes <= ex.STACK_CACHE_BYTES
            assert len(ex._stack_cache) == 2
    finally:
        th.close()


@pytest.mark.parametrize("query,exc", [
    ('Count(Bitmap(frame="nope", rowID=1))', "ErrFrameNotFound"),
    (f"Count({R0}, {R1})", ValueError),
    ('Count(Bitmap(frame="f"))', ValueError),
    ('Count(Bitmap(frame="f", rowID=1, columnID=2))', ValueError),
    ("Count(Intersect())", ValueError),
    ("Bogus()", ValueError),
])
@pytest.mark.parametrize("path_name", ["serial", "batched"])
def test_errors_match_reference(datadir, query, exc, path_name):
    path, _ = datadir
    msgs = []
    for holder_cls, ex_cls, kw in ((JHolder, JExecutor, {}),
                                   (THolder, TExecutor, {"device": "cpu"})):
        h = holder_cls(path, **kw).open()
        try:
            ex = ex_cls(h)
            ex._force_path = path_name
            with pytest.raises(Exception) as info:
                ex.execute("i", query)
            msgs.append(str(info.value))
            if isinstance(exc, str):
                assert type(info.value).__name__ == exc
            else:
                assert isinstance(info.value, exc)
        finally:
            h.close()
    assert msgs[0] == msgs[1]


def test_unported_calls_raise_and_missing_index(datadir):
    """The calls that once raised NotImplementedError answer now: a time
    Range over a frame without a time quantum is empty, a top-level
    Bitmap returns the row's columns; a missing index still raises."""
    path, words = datadir
    th = THolder(path, device="cpu").open()
    try:
        ex = TExecutor(th)
        assert ex.execute("i", 'Count(Range(frame="f", rowID=1, '
                               'start="2017-01-01T00:00", '
                               'end="2018-01-01T00:00"))') == [0]
        got = ex.execute("i", f"{R0}")[0].columns()
        want = np.concatenate([_positions(words[s][0])
                               + np.uint64(s * SLICE_WIDTH)
                               for s in range(N_SLICES)])
        assert np.array_equal(got, want)
        with pytest.raises(terr.ErrIndexNotFound):
            ex.execute("nope", f"Count({R0})")
        assert ex.execute("i", f"Count({R0})", slices=[0, 1]) == [
            sum(int(np.bitwise_count(_slice_rows(s)[0]).sum())
                for s in (0, 1))]
    finally:
        th.close()
