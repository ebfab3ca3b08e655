"""Port parity for column windows: the same seeded writes through
pilosa_tpu and the port, each in its own data directory, and then the
same answers, the same fragment windows (``win32``), the same plan
windows (``_union_window``) and the same device-stack shapes on the
batched path — stacks sized to the data, not to the 32,768-word slice.
The cases of tests/test_colwin.py (all but the background compile of
wider widths, which has no counterpart: torch compiles nothing per
shape), and the edge cases: all-zero and all-ones rows, bit 31 set,
data clustered in the highest window, a write that widens a window.
Answers are exact: tolerance 0."""
import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH, WORDS_PER_SLICE
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.storage.frame import Field as JField
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu.storage.index import FrameOptions as JFrameOptions
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.storage.frame import Field as TField
from pilosa_tpu_torch.storage.frame import FrameOptions as TFrameOptions
from pilosa_tpu_torch.storage.holder import Holder as THolder

Q_AND = ('Count(Intersect(Bitmap(frame="general", rowID=1), '
         'Bitmap(frame="general", rowID=2)))')
Q_OR = ('Count(Union(Bitmap(frame="general", rowID=1), '
        'Bitmap(frame="general", rowID=2)))')
B_AND = ('Intersect(Bitmap(frame="general", rowID=1), '
         'Bitmap(frame="general", rowID=2))')


class Pair:
    """One pilosa_tpu and one port holder over two directories that get
    the same writes; ``ex[pkg][path]`` pins the batched or serial path."""

    def __init__(self, tmp_path):
        self.j = JHolder(str(tmp_path / "j")).open()
        self.t = THolder(str(tmp_path / "t"), device="cpu").open()
        for h in (self.j, self.t):
            h.create_index("i").create_frame("general")
        self.ex = {}
        for name, h, cls in (("j", self.j, JExecutor),
                             ("t", self.t, TExecutor)):
            self.ex[name] = {}
            for path in ("batched", "serial"):
                e = cls(h)
                e._force_path = path
                self.ex[name][path] = e

    def frames(self, name="general"):
        return (self.j.index("i").frame(name), self.t.index("i").frame(name))

    def import_bits(self, rows, cols, frame="general"):
        for fr in self.frames(frame):
            fr.import_bits(list(rows), list(cols))

    def run(self, q):
        """The query's answer, equal from both packages on both paths."""
        got = {(n, p): e.execute("i", q)[0]
               for n, d in self.ex.items() for p, e in d.items()}
        norm = {k: v.columns().tolist() if hasattr(v, "columns") else v
                for k, v in got.items()}
        want = norm[("j", "serial")]
        assert all(v == want for v in norm.values()), norm
        return want

    def windows(self, view="standard", frame="general"):
        """{slice: win32} of every fragment, equal in both packages."""
        jv = self.j.index("i").frame(frame).view(view)
        tv = self.t.index("i").frame(frame).view(view)
        jw = {s: f.win32() for s, f in jv.fragments.items()}
        tw = {s: f.win32() for s, f in tv.fragments.items()}
        assert tw == jw
        return tw

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def _t_widths(e):
    """{words} of the cached stacks."""
    with e._cache_mu:
        return {v[2].shape[-1] for v in e._stack_cache.values()}


def _j_widths(e):
    """{words}: pilosa_tpu pads the slice axis to its device count and
    stacks BSI planes as [S, depth+1, W], the port as depth+1 stacks
    [S, W], so only the widths compare."""
    with e._cache_mu:
        return {v[1].shape[-1] for v in e._stack_cache.values()}


def _t_stack_bytes(e):
    with e._cache_mu:
        return sum(v[2].numel() * 4 for v in e._stack_cache.values())


def _fill_cluster(pair, rows, n_slices, col_lo, col_hi):
    """Set bits for each row in [col_lo, col_hi) of every slice."""
    for s in range(n_slices):
        base = s * SLICE_WIDTH
        for r in rows:
            cols = list(range(base + col_lo, base + col_hi))
            pair.import_bits([r] * len(cols), cols)


def _same_stacks(pair):
    assert _t_widths(pair.ex["t"]["batched"]) == _j_widths(
        pair.ex["j"]["batched"])
    return _t_widths(pair.ex["t"]["batched"])


def test_narrow_count_uses_narrow_stacks(pair):
    _fill_cluster(pair, [1, 2], n_slices=8, col_lo=0, col_hi=120)
    assert pair.run(Q_AND) == 8 * 120
    shapes = _same_stacks(pair)
    assert shapes == {TExecutor.MIN_WIN32}
    assert set(pair.windows().values()) == {(0, 128)}


def test_high_cluster_rebases_correctly(pair):
    """Bits clustered at the END of the slice: the window's base is not
    zero, and every word is rebased both ways."""
    lo, hi = SLICE_WIDTH - 130, SLICE_WIDTH - 3
    _fill_cluster(pair, [1], n_slices=4, col_lo=lo, col_hi=hi)
    _fill_cluster(pair, [2], n_slices=4, col_lo=lo + 5, col_hi=hi + 2)
    assert pair.run(Q_AND) == 4 * (hi - (lo + 5))
    shapes = _same_stacks(pair)
    assert shapes and max(shapes) < WORDS_PER_SLICE
    cols = pair.run(B_AND)
    assert cols[0] == lo + 5 and cols[-1] == 3 * SLICE_WIDTH + hi - 1
    bm = pair.ex["t"]["batched"].execute("i", B_AND)[0]
    assert bm._stack[3] == (SLICE_WIDTH // 32) - TExecutor.MIN_WIN32
    # Splitting the windowed stack into segments rebases to full width.
    seg = bm.segments[3]
    assert seg.shape == (WORDS_PER_SLICE,) and bm.columns().tolist() == cols


def test_mixed_clusters_widen_window(pair):
    """One row low, one high: the plan's window covers both."""
    _fill_cluster(pair, [1], n_slices=2, col_lo=0, col_hi=64)
    _fill_cluster(pair, [2], n_slices=2, col_lo=SLICE_WIDTH - 64,
                  col_hi=SLICE_WIDTH)
    for q in (Q_OR, Q_AND):
        pair.run(q)
    _same_stacks(pair)
    assert pair.run(Q_OR) == 2 * 128


def test_chem_shape_device_bytes_bounded(pair):
    """Fingerprint rows over a narrow column span: device stack bytes
    at most 2× the host windows, far below full width."""
    n_slices = 8
    rng = np.random.default_rng(7)
    for s in range(n_slices):
        base = s * SLICE_WIDTH
        for r in (0, 1, 2):
            cols = base + rng.choice(2000, size=400, replace=False)
            pair.import_bits([r] * len(cols), cols.tolist())
    q = ('Count(Intersect(Bitmap(frame="general", rowID=0), '
         'Bitmap(frame="general", rowID=1)))')
    pair.run(q)
    _same_stacks(pair)
    dev_bytes = _t_stack_bytes(pair.ex["t"]["batched"])
    wins = pair.windows()
    host_window_bytes = sum(2 * w * 4 for _, w in wins.values())
    assert 0 < dev_bytes <= 2 * host_window_bytes
    assert dev_bytes <= 2 * n_slices * WORDS_PER_SLICE * 4 // 8


def test_bsi_sum_min_max_windowed(pair):
    """BSI aggregates and Range ride windowed plane stacks."""
    for idx, opts in ((pair.j.index("i"), JFrameOptions(
            range_enabled=True,
            fields=[JField(name="v", type="int", min=0, max=1000)])),
                      (pair.t.index("i"), TFrameOptions(
            range_enabled=True,
            fields=[TField(name="v", type="int", min=0, max=1000)]))):
        idx.create_frame("f", opts)
    base = SLICE_WIDTH - 500  # high cluster
    for fr in pair.frames("f"):
        for i in range(200):
            fr.set_field_value(base + i, "v", (i * 7) % 1000)
    vals = [(i * 7) % 1000 for i in range(200)]
    for q, want in (('Sum(frame="f", field="v")', sum(vals)),
                    ('Min(frame="f", field="v")', 0),
                    ('Max(frame="f", field="v")', max(vals))):
        got = pair.run(q)
        assert got.sum == want
    assert pair.run('Count(Range(frame="f", v > 500))') == sum(
        v > 500 for v in vals)
    assert len(pair.run('Range(frame="f", v > 500)')) > 0
    _same_stacks(pair)
    pair.windows(view="field_v", frame="f")


def test_topn_windowed(pair):
    base = SLICE_WIDTH - 2048
    for s in range(3):
        off = s * SLICE_WIDTH + base
        pair.import_bits([5] * 30 + [6] * 20 + [7] * 10,
                         [off + i for i in range(30)]
                         + [off + i for i in range(20)]
                         + [off + i for i in range(10)])
    for q in ('TopN(Bitmap(frame="general", rowID=5), frame="general", '
              'n=2)',
              'TopN(Bitmap(frame="general", rowID=6), frame="general", '
              'tanimotoThreshold=50)',
              'TopN(frame="general", n=3)'):
        pair.run(q)
    _same_stacks(pair)


def test_writes_invalidate_windowed_stacks(pair):
    """A write that GROWS the window invalidates cached narrow stacks."""
    _fill_cluster(pair, [1, 2], n_slices=2, col_lo=0, col_hi=100)
    assert pair.run(Q_OR) == 2 * 100
    assert pair.windows() == {0: (0, 128), 1: (0, 128)}
    for e in (pair.ex["j"]["batched"], pair.ex["t"]["batched"]):
        e.execute("i", f'SetBit(frame="general", rowID=1, '
                       f'columnID={SLICE_WIDTH - 1})')
    assert pair.run(Q_OR) == 2 * 100 + 1
    assert pair.windows() == {0: (0, WORDS_PER_SLICE), 1: (0, 128)}


def test_lazy_window_is_span_exact_not_container_bound(tmp_path):
    """A non-resident fragment's window bounds its data's word span,
    not its containers, in both packages; an op-log bit past the
    snapshot widens it."""
    from pilosa_tpu.storage.fragment import Fragment as JFragment
    from pilosa_tpu_torch.storage.fragment import Fragment as TFragment

    rng = np.random.default_rng(7)
    bits = {rid: rng.choice(4000, size=300, replace=False).astype(np.uint64)
            for rid in (1, 2)}
    for name, cls in (("j", JFragment), ("t", TFragment)):
        f = cls(str(tmp_path / name), "i", "f", "standard", 0).open()
        for rid, cols in bits.items():
            f.import_bits(np.full(300, rid, dtype=np.uint64), cols)
        f.snapshot()
        assert f.win32() == (0, 128)
        f.unload()
        assert f.win32() == (0, 128)
        f.set_bit(1, 500_000)
        f.unload()
        b, w = f.win32()
        assert b <= 500_000 // 32 < b + w
        f.close()
    # Same bytes, same windows for a dense bitmap container.
    for name, cls in (("j2", JFragment), ("t2", TFragment)):
        f = cls(str(tmp_path / name), "i", "f", "standard", 0).open()
        f.import_bits(np.full(5000, 1, dtype=np.uint64),
                      np.arange(64_000, 69_000, dtype=np.uint64))
        f.snapshot()
        res = f.win32()
        f.unload()
        assert f.win32() == res == (0, 4096)
        f.close()


# ------------------------------------------------------------ edge cases


def _edge_rows(kind, rng):
    """{row: (columns)} of one slice for an edge case."""
    if kind == "all_zero":
        return {1: np.zeros(0, np.int64), 2: rng.choice(64, 5)}
    if kind == "all_ones":
        return {1: np.arange(SLICE_WIDTH), 2: rng.choice(SLICE_WIDTH, 900)}
    if kind == "bit31":
        cols = np.arange(31, 8192, 32)  # bit 31 of every 32-bit word
        return {1: cols, 2: cols[::3]}
    if kind == "highest":
        return {1: SLICE_WIDTH - 1 - rng.choice(4096, 700, replace=False),
                2: SLICE_WIDTH - 1 - rng.choice(300, 100, replace=False)}
    if kind == "odd_width":
        # 4097 bits in one container (array/bitmap threshold), spanning
        # a window that is not a multiple of 128 words of data.
        return {1: np.arange(70_000, 70_000 + 4097),
                2: np.arange(70_000, 70_000 + 4096)}
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["all_zero", "all_ones", "bit31",
                                  "highest", "odd_width"])
def test_edge_cases_match_reference(pair, kind):
    rng = np.random.default_rng(11)
    for s in range(3):
        for row, cols in _edge_rows(kind, rng).items():
            if len(cols):
                cols = np.unique(np.asarray(cols, np.uint64))
                pair.import_bits([row] * len(cols),
                                 (cols + np.uint64(s * SLICE_WIDTH)).tolist())
    for q in (Q_AND, Q_OR, 'Count(Bitmap(frame="general", rowID=1))',
              'Count(Xor(Bitmap(frame="general", rowID=1), '
              'Bitmap(frame="general", rowID=2)))',
              'TopN(Bitmap(frame="general", rowID=2), frame="general", '
              'n=2)', B_AND):
        pair.run(q)
    _same_stacks(pair)
    pair.windows()
    # Every fragment's rows read back padded to full width, equal, and
    # its window read from the file alone (unloaded) is the same.
    wins = pair.windows()
    jv = pair.j.index("i").frame("general").view("standard")
    tv = pair.t.index("i").frame("general").view("standard")
    for s, tf in tv.fragments.items():
        tf.unload()
        assert tf.win32() == wins[s] and not tf._resident
        for r in (1, 2):
            assert (tf.row_words(r) == jv.fragment(s).row_words(r)).all()


def test_write_widens_a_window_of_every_size(pair):
    """A fragment's window doubles around its data as writes spread,
    the same steps in both packages, and the plan window follows in
    powers of four."""
    seen, plans = [], []
    for col in (10, 5000, 70_000, 300_000, SLICE_WIDTH - 1):
        pair.import_bits([1], [col])
        seen.append(pair.windows()[0])
        pair.run(Q_OR)
        jfm = pair.ex["j"]["batched"]._leaf_frags(
            "i", [("row", "general", 1, "standard")], range(1))
        tfm = pair.ex["t"]["batched"]._leaf_frags(
            "i", [("general", "standard", 1)], range(1))
        plans.append(pair.ex["t"]["batched"]._union_window(tfm))
        assert plans[-1] == pair.ex["j"]["batched"]._union_window(jfm)
    assert [w for _, w in seen] == [128, 256, 4096, 16384, 32768]
    assert [w for _, w in plans] == [128, 512, 8192, 32768, 32768]


def test_chem_fragment_device_bytes_within_twice_its_window(tmp_path):
    """The chemical-similarity shape at a small size: many molecule rows
    of 4,096 fingerprint columns in one fragment. Its window is 128
    words in both packages, Tanimoto TopN answers alike, and the port's
    device tensors for the fragment (the mirror, row counts, rebased
    rows) stay within twice its host window."""
    from pilosa_tpu.storage.fragment import Fragment as JFragment
    from pilosa_tpu.storage.fragment import TopOptions as JTopOptions
    from pilosa_tpu_torch.storage.fragment import Fragment as TFragment
    from pilosa_tpu_torch.storage.fragment import TopOptions as TTopOptions

    rng = np.random.default_rng(13)
    n = 3000
    fam = rng.integers(0, 4096, (n // 50, 40))[np.arange(n) // 50]
    cols = np.where(rng.random(fam.shape) < 0.95, fam, 4095)
    rows = np.repeat(np.arange(n, dtype=np.uint64), cols.shape[1])
    cols = cols.ravel().astype(np.uint64)
    jf = JFragment(str(tmp_path / "j"), "i", "f", "standard", 0,
                   cache_size=n).open()
    tf = TFragment(str(tmp_path / "t"), "i", "f", "standard", 0,
                   device="cpu", cache_size=n).open()
    for f in (jf, tf):
        f.import_bits(rows, cols)
    assert tf.win32() == jf.win32() == (0, 128)
    for q in (0, 77, n - 1):
        jsrc = jf.row_words(q)
        want = jf.top(JTopOptions(n=10, src=jsrc, tanimoto_threshold=70))
        got = tf.top(TTopOptions(n=10, src=tf.device_row(q),
                                 tanimoto_threshold=70))
        assert got == want and len(got) > 1
    assert tf.top(TTopOptions(n=10)) == jf.top(JTopOptions(n=10))
    dev = tf.memory_stats()["deviceBytes"]
    assert 0 < dev <= 2 * tf._matrix.nbytes
    assert tf._matrix.nbytes * 64 <= n * WORDS_PER_SLICE * 4
    jf.close()
    tf.close()


def test_full_window_opt_out(pair, monkeypatch):
    """PILOSA_TPU_FULL_WIN=1 pins every batched plan to the full slice,
    in both packages, with the same answers."""
    monkeypatch.setenv("PILOSA_TPU_FULL_WIN", "1")
    _fill_cluster(pair, [1, 2], n_slices=2, col_lo=0, col_hi=100)
    full = Pair.__new__(Pair)
    full.j, full.t = pair.j, pair.t
    full.ex = {n: {p: cls(h) for p in ("batched", "serial")}
               for n, h, cls in (("j", pair.j, JExecutor),
                                 ("t", pair.t, TExecutor))}
    for n in full.ex:
        for p, e in full.ex[n].items():
            e._force_path = p
    assert full.run(Q_OR) == 2 * 100
    assert _same_stacks(full) == {WORDS_PER_SLICE}


def test_stacks_patch_written_slices_and_grow_with_new_ones(pair):
    """After a write the batched stacks are patched at the written
    slices only, and a new last slice extends them; the answers stay
    the reference's."""
    _fill_cluster(pair, [1, 2], n_slices=4, col_lo=0, col_hi=100)
    pair.run(Q_OR)
    e = pair.ex["t"]["batched"]
    reads = []
    for s in range(5):
        f = pair.t.fragment("i", "general", "standard", s)
        if f is not None:
            orig = f.host_rows_win

            def spy(rows, b, w, orig=orig, s=s):
                reads.append(s)
                return orig(rows, b, w)
            f.host_rows_win = spy
    for ex in (pair.ex["j"]["batched"], e):
        ex.execute("i", 'SetBit(frame="general", rowID=1, columnID=%d)'
                   % (2 * SLICE_WIDTH + 500))
    assert pair.run(Q_OR) == 100 * 4 + 1
    assert sorted(set(reads)) == [2]
    pair.import_bits([2], [4 * SLICE_WIDTH + 3])  # a new last slice
    reads.clear()
    assert pair.run(Q_OR) == 100 * 4 + 2
    assert reads == []  # the old slices' rows are not read again
