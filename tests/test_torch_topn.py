"""Port parity for TopN: one data directory written by pilosa_tpu, the
same TopN queries through pilosa_tpu's executor and the port's, on the
serial and the batched path each; writes by either package, read back
by the other through its ``.cache`` sidecars; and the Tanimoto helpers
against pilosa_tpu.ops.topn. Six slices at the full 32768-word width,
with an empty fragment and a missing one; frames with ranked, lru and
none caches and an inverse-enabled frame. Pairs are exact: tolerance 0.
"""
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.ops import topn as jtopn
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu.storage.index import FrameOptions as JFrameOptions
from pilosa_tpu_torch.executor import BATCH_OVER_BUDGET
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.ops import topn as ttopn
from pilosa_tpu_torch.storage.holder import Holder as THolder

N_SLICES = 6
EMPTY_SLICE = 2     # fragments exist, every row emptied
MISSING_SLICE = 3   # no fragment at all
BIG = 2 ** 40 + 3   # a row id beyond 32 bits (row·2^20 + col fits 64)
T_ROWS = {10: 1, 11: 1, 12: None, 13: 2, 14: 2, 15: 3, 16: 4, 17: 5}
W = SLICE_WIDTH

# A Tanimoto case that float32 decides differently from exact arithmetic:
# inter 346006 of a union of 1048503 scores 33.00000095 exactly (ceil 34,
# kept at threshold 33) but 33.0 in float32 (ceil 33, dropped).
TAN_SRC_N, TAN_ROW_LO, TAN_UNION = 700000, 353994, 1048503


def _rand(rng, k):
    """uint64[16384] words of bit density 2^-k."""
    w = rng.integers(0, 1 << 64, 16384, dtype=np.uint64)
    for _ in range(k - 1):
        w &= rng.integers(0, 1 << 64, 16384, dtype=np.uint64)
    return w


def _positions(words):
    return np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little")).astype(np.uint64)


def _t_rows(s):
    """{row: uint64 words} of frame t in slice s (the chip_smoke layout:
    rows 13 and 14 identical, row 12 at density 3/8)."""
    rng = np.random.default_rng([7, s, 1])
    rows = {}
    for r, k in T_ROWS.items():
        if r == 14:
            rows[r] = rows[13]
        elif r == 12:
            rows[r] = _rand(rng, 1) & (_rand(rng, 1) | _rand(rng, 1))
        else:
            rows[r] = _rand(rng, k)
    if s == 4:
        rows[BIG] = _rand(rng, 5)
    return rows


def _f_rows(s):
    rng = np.random.default_rng([7, s, 0])
    return {0: _rand(rng, 1), 1: _rand(rng, 1), 2: _rand(rng, 2)}


def _import(frag, rows, s):
    rs, cs = [], []
    for r, w in rows.items():
        pos = _positions(w)
        rs.append(np.full(len(pos), r, np.uint64))
        cs.append(pos + np.uint64(s * W))
    frag.import_bits(np.concatenate(rs), np.concatenate(cs))


def _write_reference_dir(path):
    jh = JHolder(path).open()
    idx = jh.create_index("i")
    frames = {
        "f": idx.create_frame("f"),
        "t": idx.create_frame("t"),
        "lru": idx.create_frame("lru", JFrameOptions(cache_type="lru",
                                                     cache_size=3)),
        "none": idx.create_frame("none", JFrameOptions(cache_type="none")),
        "rk": idx.create_frame("rk", JFrameOptions(cache_size=2)),
        "tan": idx.create_frame("tan"),
    }
    idx.create_frame("inv", JFrameOptions(inverse_enabled=True))
    rng = np.random.default_rng(11)
    for s in range(N_SLICES):
        if s == MISSING_SLICE:
            continue
        views = {n: fr.create_view_if_not_exists("standard")
                 for n, fr in frames.items()}
        if s == EMPTY_SLICE:
            for n in ("f", "t", "lru"):
                frag = views[n].create_fragment_if_not_exists(s)
                frag.set_bit(5, s * W + 7)
                frag.clear_bit(5, s * W + 7)
            continue
        _import(views["f"].create_fragment_if_not_exists(s), _f_rows(s), s)
        _import(views["t"].create_fragment_if_not_exists(s), _t_rows(s), s)
        # lru / rk: one import per row in a seeded order, so the cache
        # membership (last 3 used; ranked top-2 trim past 12) differs
        # from slice to slice.
        for name, n_rows in (("lru", 6), ("rk", 16)):
            frag = views[name].create_fragment_if_not_exists(s)
            for r in rng.permutation(n_rows):
                n = int(rng.integers(1, 400))
                cols = rng.choice(W, n, replace=False).astype(np.uint64)
                frag.import_bits(np.full(n, r, np.uint64),
                                 cols + np.uint64(s * W))
        frag = views["none"].create_fragment_if_not_exists(s)
        _import(frag, {r: _rand(rng, 6) for r in range(4)}, s)
    tan = frames["tan"]
    # test_executor.py:94-120: inter 1 of a union of 2 scores exactly 50.
    tan.import_bits([3] * 6, [0, 1, 2, 3, W + 0, W + 1])
    tan.import_bits([0] * 6, [0, 1, 2, 3, W + 0, W + 1])
    tan.import_bits([1] * 3, [0, 1, W + 0])
    tan.import_bits([2] * 2, [4, 5])
    src = np.arange(TAN_SRC_N, dtype=np.uint64) + np.uint64(4 * W)
    row = np.arange(TAN_ROW_LO, TAN_UNION, dtype=np.uint64) + np.uint64(4 * W)
    tan.import_bits(np.full(len(src), 20, np.uint64), src)
    tan.import_bits(np.full(len(row), 21, np.uint64), row)
    # Per-slice truncation decides the answer: row 5 is third in both
    # slices but first overall; phase 1 keeps each slice's top 2 only
    # (test_executor.py:320-351 adds the case where phase 2 restores a
    # truncated count).
    tr, trs = idx.create_frame("tr"), idx.create_frame("trs")
    trs.import_bits([0] * 200, [c + s * W for s in (0, 1) for c in range(100)])
    for s, counts in ((0, {1: 10, 2: 9, 5: 8}), (1, {3: 10, 4: 9, 5: 8})):
        for r, n in counts.items():
            tr.import_bits([r] * n, [s * W + c for c in range(n)])
    tr.import_bits([9] * 8, [0, 1, 2, 3, W + 0, W + 1, W + 2, W + 3])
    tr.import_bits([20] * 3, [0, 1, 2])
    tr.import_bits([21] * 2, [0, 1])
    tr.import_bits([22] * 4, [0, W + 0, W + 1, W + 2])
    tr.import_bits([21] * 1, [W + 0])
    # test_executor.py:70-80 and :305-317, in the default frame.
    general = idx.create_frame("general")
    general.import_bits([0] * 5 + [10] * 10 + [20] * 3 + [10],
                        list(range(5)) + list(range(10)) + list(range(3))
                        + [W])
    general.import_bits([5] * 3 + [6] * 1, [0, 1, W + 2, 4])
    ex = JExecutor(jh)
    for r, c in [(0, 7), (1, 7), (2, 7), (0, 8), (W + 1, 7), (W + 1, 9),
                 (W + 2, 9), (3, W + 5)]:
        assert ex.execute("i", f'SetBit(frame="inv", rowID={r}, '
                               f'columnID={c})') == [True]
    jh.close()


def _src(r):
    return f'Bitmap(frame="f", rowID={r})'


TAN50 = ('TopN(Bitmap(frame="tan", rowID=3), frame="tan", n=5, '
         'tanimotoThreshold=50)')
TAN40 = ('TopN(Bitmap(frame="tan", rowID=3), frame="tan", n=5, '
         'tanimotoThreshold=40)')
TAN33 = 'TopN(Bitmap(frame="tan", rowID=20), frame="tan", tanimotoThreshold=33)'
TAN32 = 'TopN(Bitmap(frame="tan", rowID=20), frame="tan", tanimotoThreshold=32)'


QUERIES = [
    # the chip_smoke set
    f'TopN({_src(0)}, frame="t", n=5)',
    'TopN(frame="t", n=5)',
    f'TopN(Intersect({_src(0)}, {_src(2)}), frame="t", n=8, threshold=30000)',
    f'TopN({_src(1)}, frame="t", tanimotoThreshold=30)',
    f'TopN({_src(0)}, frame="t", ids=[12, 14, 17])',
    # n, ties, thresholds, ids
    'TopN(frame="t")',
    'TopN(frame="t", n=1)',
    'TopN(frame="t", n=4)',
    f'TopN({_src(0)}, frame="t", n=4)',
    f'TopN({_src(2)}, frame="t", n=3, threshold=40000)',
    'TopN(frame="t", threshold=200000)',
    'TopN(frame="t", ids=[17, 13, 13, 99])',
    f'TopN({_src(1)}, frame="t", ids=[10, 10, 16], n=1)',
    f'TopN({_src(1)}, frame="t", n=3, tanimotoThreshold=20)',
    f'TopN({_src(0)}, frame="t", tanimotoThreshold=100)',
    # Src trees, and a Src from the ranked frame itself
    f'TopN(Union({_src(1)}, {_src(2)}), frame="t", n=3)',
    f'TopN(Difference({_src(0)}, {_src(1)}), frame="t", n=6)',
    f'TopN(Xor({_src(0)}, Intersect({_src(1)}, {_src(2)})), frame="t", n=2)',
    'TopN(Bitmap(frame="t", rowID=15), frame="t", n=3)',
    f'TopN(Bitmap(frame="f", rowID=9), frame="t", n=3)',
    # other caches
    'TopN(frame="lru", n=3)',
    'TopN(frame="lru")',
    f'TopN({_src(0)}, frame="lru", n=2)',
    'TopN(frame="lru", ids=[0, 1, 2, 3, 4, 5])',
    'TopN(frame="rk", n=5)',
    f'TopN({_src(1)}, frame="rk")',
    'TopN(frame="none", n=3)',
    f'TopN({_src(0)}, frame="none", n=3)',
    'TopN(frame="none", ids=[0, 2])',
    f'TopN({_src(0)}, frame="none", ids=[1, 3])',
    # per-slice truncation before the merge
    'TopN(Bitmap(frame="trs", rowID=0), frame="tr", n=2)',
    'TopN(Bitmap(frame="tr", rowID=9), frame="tr", n=2)',
    'TopN(frame="tr", n=2)',
    'TopN(Bitmap(frame="trs", rowID=0), frame="tr")',
    # the default frame
    'TopN(n=2)',
    'TopN(frame="general", ids=[5, 5, 6])',
    # inverse view, unknown frame
    'TopN(frame="inv", n=2, inverse=true)',
    'TopN(frame="inv", inverse=true)',
    'TopN(frame="inv", n=2)',
    'TopN(frame="nope", n=2)',
    # Tanimoto: exact 50 is not > 50; float32 rounding at the gate
    TAN50, TAN40, TAN33, TAN32,
]
PATHS = ("serial", "batched")


def _run(holder, ex_cls, queries):
    ex = ex_cls(holder)
    out = {}
    for p in PATHS:
        ex._force_path = p
        out[p] = {q: ex.execute("i", q)[0] for q in queries}
    return out


def _run_jax(path, queries):
    jh = JHolder(path).open()
    try:
        return _run(jh, JExecutor, queries)
    finally:
        jh.close()


def _run_port(path, queries):
    th = THolder(path, device="cpu").open()
    try:
        return _run(th, TExecutor, queries)
    finally:
        th.close()


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("topn") / "data")
    _write_reference_dir(path)
    return path


@pytest.fixture(scope="module")
def results(datadir):
    return _run_jax(datadir, QUERIES), _run_port(datadir, QUERIES)


@pytest.mark.parametrize("query", QUERIES)
def test_topn_matches_reference_on_both_paths(results, query):
    jax_out, port_out = results
    for p in PATHS:
        assert port_out[p][query] == jax_out[p][query], p
    assert port_out["serial"][query] == port_out["batched"][query]
    for rid, cnt in port_out["batched"][query]:
        assert type(rid) is int and type(cnt) is int


def _oracle(src_fn, n=0, threshold=0, ids=None, tanimoto=0):
    """Two-phase TopN over frame t by numpy: per-slice cache membership
    (every non-empty row), threshold, per-slice top n by (-count, id),
    merge, exact phase 2 over the merged ids, trim to n."""
    min_thr = max(threshold, 1)

    def slice_counts(s, cand):
        rows = _t_rows(s)
        src = src_fn(_f_rows(s)) if src_fn else None
        out = {}
        for r in cand:
            w = rows.get(r)
            if w is None:
                continue
            c = int(np.bitwise_count(w & src if src is not None else w).sum())
            if tanimoto and src is not None:
                rn, sn = int(np.bitwise_count(w).sum()), int(
                    np.bitwise_count(src).sum())
                d = rn + sn - c
                score = (np.float32(100.0) * np.float32(c) / np.float32(d)
                         if d > 0 else np.float32(0))
                c = c if math.ceil(float(score)) > tanimoto else 0
            if c >= min_thr:
                out[r] = c
        return out

    live = [s for s in range(N_SLICES)
            if s not in (EMPTY_SLICE, MISSING_SLICE)]

    def merged(cand, cut):
        tot = {}
        for s in live:
            pairs = sorted(slice_counts(s, cand if cand is not None
                                        else _t_rows(s)).items(),
                           key=lambda rc: (-rc[1], rc[0]))
            for r, c in (pairs[:n] if cut and n else pairs):
                tot[r] = tot.get(r, 0) + c
        return sorted(tot.items(), key=lambda rc: (-rc[1], rc[0]))

    if ids is not None:
        return merged(sorted(set(ids)), False)
    first = merged(None, True)
    if not first:
        return []
    out = merged(sorted(r for r, _ in first), False)
    return out[:n] if n else out


@pytest.mark.parametrize("query,want", [
    (QUERIES[0], lambda: _oracle(lambda f: f[0], n=5)),
    (QUERIES[1], lambda: _oracle(None, n=5)),
    (QUERIES[2], lambda: _oracle(lambda f: f[0] & f[2], n=8,
                                 threshold=30000)),
    (QUERIES[3], lambda: _oracle(lambda f: f[1], tanimoto=30)),
    (QUERIES[4], lambda: _oracle(lambda f: f[0], ids=[12, 14, 17])),
    (QUERIES[6], lambda: _oracle(None, n=1)),
])
def test_topn_matches_numpy_oracle(results, query, want):
    _, port_out = results
    expect = want()
    assert expect
    assert port_out["batched"][query] == expect


def test_known_answers(results):
    _, port = results
    got = port["batched"]
    assert got['TopN(frame="inv", n=2, inverse=true)'] == [(7, 4), (9, 2)]
    assert got['TopN(frame="none", n=3)'] == []
    assert got['TopN(n=2)'] == [(10, 11), (0, 5)]
    assert got['TopN(frame="general", ids=[5, 5, 6])'] == [(5, 3), (6, 1)]
    assert got['TopN(frame="nope", n=2)'] == []
    assert got[TAN50] == [(0, 6), (3, 6)]
    assert got[TAN40] == [(0, 6), (3, 6), (1, 3)]
    assert got[TAN33] == [(20, TAN_SRC_N)]
    assert got[TAN32] == [(20, TAN_SRC_N), (21, TAN_SRC_N - TAN_ROW_LO)]
    # Exact arithmetic would keep row 21 at threshold 33.
    inter = TAN_SRC_N - TAN_ROW_LO
    assert math.ceil(100 * inter / TAN_UNION) == 34
    # row 5 (8 + 8) never makes a slice's top 2, so phase 2 never sees it
    assert got['TopN(Bitmap(frame="trs", rowID=0), frame="tr", n=2)'] == [
        (1, 10), (3, 10)]
    assert got['TopN(Bitmap(frame="trs", rowID=0), frame="tr")'][0] == (
        5, 16)
    ones = got['TopN(frame="t", n=1)']
    assert len(ones) == 1
    # Rows 13 and 14 are identical: an exact tie, ordered by id.
    tie = dict(got['TopN(frame="t")'])
    assert tie[13] == tie[14]
    order = [r for r, _ in got['TopN(frame="t")']]
    assert order.index(13) + 1 == order.index(14)
    assert BIG in tie


def test_batched_path_engages_the_kernels(datadir, monkeypatch):
    """On the batched path a Src TopN is answered by the batched
    phases (one count_and_rows per phase), not by the serial walk."""
    from pilosa_tpu_torch.ops import bitops

    calls = []
    orig = bitops.count_and_rows_stacks

    def spy(rows, filt):
        calls.append((len(rows), tuple(filt.shape)))
        return orig(rows, filt)

    monkeypatch.setattr(bitops, "count_and_rows_stacks", spy)
    th = THolder(datadir, device="cpu").open()
    try:
        ex = TExecutor(th)
        ex._force_path = "batched"
        ex._execute_topn_slice = None  # the serial walk must not run
        ex.execute("i", QUERIES[0])
        ex.execute("i", QUERIES[3])
    finally:
        th.close()
    # phase 1 and phase 2 of each query: one launch each, over the
    # slices where frame t has a fragment (none at MISSING_SLICE: its
    # candidates count zero there without a staged row)
    assert len(calls) == 4
    assert {shape for _, shape in calls} == {(N_SLICES - 1, 32768)}


def _held_bytes(stacks):
    """Bytes of the distinct storages behind ``stacks``."""
    storages = {s.untyped_storage().data_ptr(): s.untyped_storage().nbytes()
                for s in stacks}
    return sum(storages.values())


def test_stacks_built_together_hold_their_own_storage(datadir):
    """Stacks built in one call are uploaded as one block, yet each holds
    storage of its own: the cache's byte count is what its stacks keep
    alive, and evicting one frees its bytes while the others stay."""
    from pilosa_tpu_torch import WORDS_PER_SLICE
    from pilosa_tpu_torch.storage.view import VIEW_STANDARD

    th = THolder(datadir, device="cpu").open()
    try:
        ex = TExecutor(th)
        slices = list(range(N_SLICES))
        win = (0, WORDS_PER_SLICE)
        specs = [("t", VIEW_STANDARD, r) for r in (10, 11, 13)]
        stacks = ex._leaf_stacks("i", specs, slices, win)
        one = stacks[0].numel() * stacks[0].element_size()
        for s in stacks:
            assert s.untyped_storage().nbytes() == one
        assert ex._stack_bytes == _held_bytes(stacks) == 3 * one
        # Room for two stacks: a fourth build evicts the oldest.
        ex.STACK_CACHE_BYTES = 2 * one
        ex._leaf_stacks("i", [("t", VIEW_STANDARD, 15)], slices, win)
        cached = [e[2] for e in ex._stack_cache.values()]
        assert len(cached) == 2
        assert ex._stack_bytes == _held_bytes(cached) == 2 * one
    finally:
        th.close()


def _clear_col(words, s):
    """Column of slice s whose bit is clear in ``words``."""
    return s * W + int(_positions(~words)[0])


def _set_col(words, s):
    return s * W + int(_positions(words)[5])


WRITES = [
    f'SetBit(frame="t", rowID=17, columnID={_clear_col(_t_rows(4)[17], 4)})',
    f'ClearBit(frame="t", rowID=13, columnID={_set_col(_t_rows(0)[13], 0)})',
    f'SetBit(frame="t", rowID=40, columnID={MISSING_SLICE * W + 1})',
    f'SetBit(frame="lru", rowID=9, columnID={5 * W + 12})',
    f'SetBit(frame="rk", rowID=30, columnID={4 * W + 13})',
    f'ClearBit(frame="f", rowID=0, columnID={_set_col(_f_rows(1)[0], 1)})',
    'SetBit(frame="inv", rowID=5, columnID=8)',
]
AFTER = [q for q in QUERIES if "tan" not in q]


def _cache_ids(holder):
    """{(frame, view, slice): cache ids} of every fragment."""
    out = {}
    idx = holder.index("i")
    for fname, fr in idx.frames.items():
        for vname, v in fr.views.items():
            for s, frag in v.fragments.items():
                out[(fname, vname, s)] = list(frag.cache.ids())
    return out


@pytest.fixture(scope="module")
def written(datadir, tmp_path_factory):
    """The same WRITES applied by each package to its own copy of the
    directory: {package: (path, write results, TopN answers, cache ids)}
    taken live, before the writer closes."""
    out = {}
    for name, holder_cls, ex_cls, kw in (
            ("port", THolder, TExecutor, {"device": "cpu"}),
            ("reference", JHolder, JExecutor, {})):
        path = str(tmp_path_factory.mktemp(name) / "d")
        shutil.copytree(datadir, path)
        h = holder_cls(path, **kw).open()
        try:
            ex = ex_cls(h)
            for p in PATHS:  # warm both paths' caches before writing
                ex._force_path = p
                for q in AFTER[:5]:
                    ex.execute("i", q)
            applied = [ex.execute("i", w)[0] for w in WRITES]
            out[name] = (path, applied, _run(h, ex_cls, AFTER),
                         _cache_ids(h))
        finally:
            h.close()
    return out


def test_writes_match_reference(written):
    """After the same writes, the port's TopN answers (both paths) and
    every fragment's cache membership equal pilosa_tpu's."""
    port, ref = written["port"], written["reference"]
    assert port[1] == ref[1] == [True] * len(WRITES)
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert 9 in port[3][("lru", "standard", 5)]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_writes_and_cache_sidecars_carry_across(written, writer):
    """Each package, reopening the other's written directory, reads its
    .cache sidecars and answers as the writer did."""
    path, _, live, ids = written[writer]
    other = _run_port(path, AFTER) if writer == "reference" else _run_jax(
        path, AFTER)
    assert other == live
    oh = (THolder(path, device="cpu") if writer == "reference"
          else JHolder(path)).open()
    try:
        assert _cache_ids(oh) == ids
    finally:
        oh.close()


def test_topn_after_writes_matches_reference_on_both_paths(datadir,
                                                           tmp_path):
    path = str(tmp_path / "d")
    shutil.copytree(datadir, path)
    th = THolder(path, device="cpu").open()
    ex = TExecutor(th)
    before = _run(th, TExecutor, AFTER[:5])
    for w in WRITES[:3]:
        ex.execute("i", w)
    after = _run(th, TExecutor, AFTER[:5])
    th.close()
    assert before != after
    assert after == _run_jax(path, AFTER[:5])


def test_recalculate_cache_matches_reference(datadir, tmp_path):
    """A lost sidecar leaves the cache empty on open in both packages;
    recalculate_cache rebuilds the same membership."""
    import glob
    import os

    path = str(tmp_path / "d")
    shutil.copytree(datadir, path)
    got = {}
    for name, h in (("port", THolder(path, device="cpu")),
                    ("reference", JHolder(path))):
        for f in glob.glob(os.path.join(path, "i", "rk", "views", "*",
                                        "fragments", "*.cache")):
            os.unlink(f)
        h.open()
        try:
            frags = h.index("i").frame("rk").view("standard").fragments
            assert all(len(fr.cache) == 0 for fr in frags.values())
            for fr in frags.values():
                fr.recalculate_cache()
            got[name] = ({s: fr.cache.ids() for s, fr in frags.items()},
                         _run(h, TExecutor if name == "port" else JExecutor,
                              ['TopN(frame="rk", n=3)']))
        finally:
            h.close()
    assert got["port"] == got["reference"]


def test_windowed_batch_halves_over_budget(tmp_path):
    """A candidate set over the stack budget streams through halved
    slice windows (16 slices → windows of 8) and answers as the
    reference does."""
    path = str(tmp_path / "d")
    jh = JHolder(path).open()
    fr = jh.create_index("i")
    frame, src = fr.create_frame("t"), fr.create_frame("f")
    rng = np.random.default_rng(5)
    for s in range(16):
        for target, rows in ((frame, range(4)), (src, range(1))):
            r = rng.integers(0, len(rows), 300).astype(np.uint64)
            c = rng.integers(0, W, 300).astype(np.uint64) + np.uint64(s * W)
            target.import_bits(r, c)
    jh.close()
    queries = [f'TopN({_src(0)}, frame="t", n=2)', 'TopN(frame="t", n=2)']
    want = _run_jax(path, queries)
    th = THolder(path, device="cpu").open()
    try:
        ex = TExecutor(th)
        ex.STACK_CACHE_BYTES = 5 * 8 * 32768 * 4  # 4 rows + Src at 8 slices
        windows = []
        orig = ex._topn_candidate_counts

        def spy(index, frame_name, view, row_ids, slices, *a):
            out = orig(index, frame_name, view, row_ids, slices, *a)
            windows.append((len(slices), out is BATCH_OVER_BUDGET))
            return out

        ex._topn_candidate_counts = spy
        got = {}
        for p in PATHS:
            ex._force_path = p
            got[p] = {q: ex.execute("i", q)[0] for q in queries}
    finally:
        th.close()
    assert got == want
    assert (16, True) in windows and (8, False) in windows


def test_windowed_batch_below_eight_slices_goes_serial():
    seen = []

    def batch_fn(ns):
        seen.append(len(ns))
        return BATCH_OVER_BUDGET if len(ns) > 4 else [(len(ns), 1)]

    fn = TExecutor._windowed_batch(batch_fn, lambda a, b: (a or []) + b)
    assert fn(range(7)) is None
    assert fn(range(16)) == [(4, 1)] * 4
    assert seen == [7, 16, 8, 4, 4, 8, 4, 4]


@pytest.mark.parametrize("query", [
    'TopN(frame="t", tanimotoThreshold=101)',
    f'TopN({_src(0)}, {_src(1)}, frame="t")',
    'TopN(frame="t", n=-1)',
])
@pytest.mark.parametrize("path_name", PATHS)
def test_errors_match_reference(datadir, query, path_name):
    msgs = []
    for holder_cls, ex_cls, kw in ((JHolder, JExecutor, {}),
                                   (THolder, TExecutor, {"device": "cpu"})):
        h = holder_cls(datadir, **kw).open()
        try:
            ex = ex_cls(h)
            ex._force_path = path_name
            with pytest.raises(ValueError) as info:
                ex.execute("i", query)
            msgs.append(str(info.value))
        finally:
            h.close()
    assert msgs[0] == msgs[1]


def test_attribute_filters_are_not_ported(datadir):
    """Attribute filters are ported now: with no row attributes stored,
    a filtered TopN keeps no row, on both paths, as pilosa_tpu does
    (tests/test_torch_results.py holds filters with attributes)."""
    queries = ['TopN(frame="t", n=2, field="cat", filters=["x"])',
               f'TopN({_src(0)}, frame="t", n=2, field="cat", '
               'filters=["x"])']
    for holder_cls, ex_cls, kw in ((JHolder, JExecutor, {}),
                                   (THolder, TExecutor, {"device": "cpu"})):
        h = holder_cls(datadir, **kw).open()
        try:
            ex = ex_cls(h)
            for p in PATHS:
                ex._force_path = p
                assert [ex.execute("i", q)[0] for q in queries] == [[], []]
        finally:
            h.close()


# ------------------------------------------------------ Tanimoto helpers

def _tan_inputs(seed):
    rng = np.random.default_rng(seed)
    inter = rng.integers(0, 1 << 19, 257).astype(np.int32)
    row_n = inter + rng.integers(0, 1 << 19, 257).astype(np.int32)
    src_n = rng.integers(0, 1 << 20, 257).astype(np.int32)
    src_n = np.maximum(src_n, inter)
    # exact integers, a zero denominator, and the float32 gate case
    inter[:4] = [1, 0, 2, TAN_SRC_N - TAN_ROW_LO]
    row_n[:4] = [1, 0, 2, TAN_UNION - TAN_ROW_LO]
    src_n[:4] = [2, 0, 4, TAN_SRC_N]
    return inter, row_n, src_n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tanimoto_score_counts_match_reference(seed):
    inter, row_n, src_n = _tan_inputs(seed)
    got = ttopn.tanimoto_score_counts(torch.from_numpy(inter),
                                      torch.from_numpy(row_n),
                                      torch.from_numpy(src_n))
    want = np.asarray(jtopn.tanimoto_score_counts(
        jnp.asarray(inter), jnp.asarray(row_n), jnp.asarray(src_n)))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert got[0] == 50.0 and got[1] == 0.0 and got[3] == 33.0
    for thr in (0, 30, 33, 50, 99, 100):
        assert np.array_equal(ttopn.tanimoto_keep(got.numpy(), thr),
                              jtopn.tanimoto_keep(want, thr))


@pytest.mark.parametrize("threshold", [1, 33, 50, 70])
def test_tanimoto_masked_counts_match_reference(threshold):
    rng = np.random.default_rng(threshold)
    m = rng.integers(0, 1 << 32, (9, 3000), dtype=np.uint64).astype(
        np.uint32)
    m[3] = 0
    src = rng.integers(0, 1 << 32, 3000, dtype=np.uint64).astype(np.uint32)
    row_n = np.bitwise_count(m).sum(axis=1).astype(np.int32)
    src_n = int(np.bitwise_count(src).sum())
    got = ttopn.tanimoto_masked_counts(
        torch.from_numpy(m.view(np.int32)),
        torch.from_numpy(src.view(np.int32)), torch.from_numpy(row_n),
        src_n, threshold)
    want = np.asarray(jtopn.tanimoto_masked_counts(
        jnp.asarray(m), jnp.asarray(src), jnp.asarray(row_n), src_n,
        threshold))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
