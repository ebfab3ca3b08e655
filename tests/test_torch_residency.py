"""Port parity for lazy fragment residency and the host-memory governor
(pilosa_tpu's roaring/codec.py LazyReader, storage/fragment.py lazy
open, fault-in and cold reads, storage/memgov.py): the same files read
by both packages' container readers; reads on non-resident fragments
answered without a fault-in; holders that open without decoding a
file; and the governor's evictions, in the same order and number as
the reference's on one access sequence. The cases of
tests/test_lazy_fault.py (all but the anti-entropy blocks, which the
port has no counterpart of yet) and tests/test_memgov.py. Answers are
exact: tolerance 0."""
import io
import threading

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH, WORDS_PER_SLICE
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.roaring import codec as jcodec
from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu.storage.fragment import TopOptions as JTopOptions
from pilosa_tpu.storage.frame import Field as JField
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu.storage.index import FrameOptions as JFrameOptions
from pilosa_tpu.storage.memgov import HostMemGovernor as JGovernor
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.ops import containers as tcontainers
from pilosa_tpu_torch.roaring import codec as tcodec
from pilosa_tpu_torch.storage import fragment as tfragment
from pilosa_tpu_torch.storage.fragment import Fragment as TFragment
from pilosa_tpu_torch.storage.fragment import TopOptions as TTopOptions
from pilosa_tpu_torch.storage.frame import Frame as TFrame
from pilosa_tpu_torch.storage.holder import Holder as THolder
from pilosa_tpu_torch.storage.index import Index as TIndex
from pilosa_tpu_torch.storage.memgov import HostMemGovernor as TGovernor
from pilosa_tpu_torch.storage.view import View as TView

CONTAINER_BITS = 1 << 16
PKGS = {"j": (JFragment, JTopOptions), "t": (TFragment, TTopOptions)}


@pytest.fixture(params=["j", "t"])
def frag(request, tmp_path):
    """A standalone fragment of either package (the port's on the CPU)."""
    cls = PKGS[request.param][0]
    kw = {"device": "cpu"} if request.param == "t" else {}
    f = cls(str(tmp_path / "frag"), "i", "f", "standard", 0, **kw).open()
    f.pkg = request.param
    yield f
    f.close()


def _fill(frag, n_rows=32, subs=(0, 8)):
    """Each row gets bits in len(subs) distinct containers."""
    rows, cols = [], []
    for r in range(n_rows):
        for sub in subs:
            rows.extend([r] * 3)
            base = sub * CONTAINER_BITS
            cols.extend([base + 7, base + 99, base + 1000])
    frag.import_bits(rows, cols)
    frag.snapshot()  # containers on disk, op log empty


def _bits(words):
    return np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little")).tolist()


# -------------------------------------------------------------- the reader


def _reader_file(tmp_path, tail):
    """A fragment file of array, bitmap and run containers written by
    pilosa_tpu, with an op-log tail and, for ``tail == "torn"``, a torn
    record after it."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / f"reader_{tail}")
    f = JFragment(path, "i", "f", "standard", 0).open()
    f.import_bits(rng.integers(0, 6, 3000).tolist(),
                  rng.integers(0, SLICE_WIDTH, 3000).tolist())
    f.import_bits([7] * 60000, rng.integers(0, 1 << 17, 60000).tolist())
    f.import_bits([8] * 5000, list(range(300_000, 305_000)))   # a run
    f.snapshot()
    if tail != "none":
        f.set_bit(2, 5)
        f.set_bit(9, 12345)            # a row only the op log holds
        f.clear_bit(8, 300_001)
        f.set_bit(7, 900_000)
    f.close()
    if tail == "torn":
        with open(path, "ab") as fh:
            fh.write(b"\x00\x01\x02")
    return path


@pytest.mark.parametrize("tail", ["none", "ops", "torn"])
def test_lazy_reader_equals_reference(tmp_path, tail):
    path = _reader_file(tmp_path, tail)
    jr, tr = jcodec.LazyReader(path), tcodec.LazyReader(path)
    assert tr.op_n == jr.op_n and tr.keys() == jr.keys()
    assert tr.metas == jr.metas and tr.op_index_bytes == jr.op_index_bytes
    for key in jr.keys() + [10 ** 6]:
        jb, tb = jr.container(key), tr.container(key)
        assert (jb is None) == (tb is None)
        if jb is not None:
            assert (jb == tb).all(), key
        assert tr.word_span(key) == jr.word_span(key), key
        assert tr.cardinality(key) == jr.cardinality(key), key
    for row in range(12):
        assert tr.row_count(row) == sum(
            jr.cardinality(row * 16 + s) for s in range(16))
    assert tr.decoded == jr.decoded
    jr.close()
    tr.close()


@pytest.mark.parametrize("tail", ["none", "ops", "torn"])
def test_full_load_equals_reference(tmp_path, tail):
    """A fault-in decodes straight into the window: the same rows,
    words, counts, window and op count as the reference's load."""
    path = _reader_file(tmp_path, tail)
    # The torn tail is repaired by the first load; read the bytes first.
    with open(path, "rb") as fh:
        raw = fh.read()
    tf = TFragment(path + ".t", "i", "f", "standard", 0, device="cpu")
    with open(path + ".t", "wb") as fh:
        fh.write(raw)
    tf.open()
    jf = JFragment(path, "i", "f", "standard", 0).open()
    assert tf.count() == jf.count() and tf.op_n == jf.op_n
    assert tf.rows() == jf.rows() and tf.win32() == jf.win32()
    assert tf._matrix.shape == jf._matrix.shape
    for r in jf.rows():
        assert (tf.row_words(r) == jf.row_words(r)).all(), r
    jf.close()
    tf.close()


def test_lazy_reader_torn_tail_tolerated(tmp_path):
    f = TFragment(str(tmp_path / "t"), "i", "f", "standard", 0,
                  device="cpu").open()
    f.import_bits([0, 0], [1, 2])
    f.snapshot()
    f.set_bit(0, 3)
    f.close()
    with open(str(tmp_path / "t"), "ab") as fh:
        fh.write(b"\x00\x01\x02")  # torn partial record
    r = tcodec.LazyReader(str(tmp_path / "t"))
    assert r.op_n == 1  # valid prefix applied, torn tail ignored
    assert _bits(r.container(0)) == [1, 2, 3]
    r.close()


# ------------------------------------------------------ cold fragment reads


def test_single_row_read_decodes_fraction_of_containers(frag):
    _fill(frag, n_rows=32, subs=(0, 8))
    assert frag.unload() is True and not frag._resident
    assert _bits(frag.row_words(5)) == [
        7, 99, 1000, 8 * CONTAINER_BITS + 7, 8 * CONTAINER_BITS + 99,
        8 * CONTAINER_BITS + 1000]
    assert not frag._resident and frag._lazy is not None
    assert frag._lazy.decoded == 2 < 0.1 * 64


def test_lazy_rows_no_fault_in(frag):
    _fill(frag, n_rows=5, subs=(0, 3))
    frag.set_bit(99, 7)  # op-only row after snapshot
    assert frag.unload() is True
    assert frag.rows() == [0, 1, 2, 3, 4, 99]
    assert not frag._resident


def test_lazy_row_count_uses_header_cardinalities(frag):
    _fill(frag, n_rows=16, subs=(0, 3, 8))
    assert frag.unload() is True
    assert frag.row_count(4) == 9
    assert frag._lazy.decoded == 0 and not frag._resident


def test_lazy_reads_apply_op_log(frag):
    _fill(frag, n_rows=4, subs=(0,))
    frag.set_bit(2, 5)                      # same container
    frag.set_bit(2, 9 * CONTAINER_BITS)     # new container, same row
    frag.set_bit(77, 123)                   # entirely new row
    frag.clear_bit(2, 7)                    # remove a snapshotted bit
    assert frag.unload() is True
    bits = set(_bits(frag.row_words(2)))
    assert 5 in bits and 9 * CONTAINER_BITS in bits
    assert 7 not in bits and 99 in bits
    assert frag.row_count(2) == len(bits)
    assert _bits(frag.row_words(77)) == [123]
    assert not frag._resident


def test_lazy_equals_resident_for_every_row(frag):
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 48, size=800).tolist()
    cols = rng.integers(0, SLICE_WIDTH, size=800).tolist()
    frag.import_bits(rows, cols)
    frag.snapshot()
    frag.set_bit(1, 17)
    frag.clear_bit(rows[0], cols[0])
    resident = {r: frag.row_words(r).copy() for r in set(rows) | {1}}
    assert frag.unload() is True
    for r, want in resident.items():
        assert (frag.row_words(r) == want).all()
        assert frag.row_count(r) == int(np.bitwise_count(want).sum())
    assert not frag._resident


def test_lazy_win32_no_fault_in(frag):
    hi = SLICE_WIDTH - 5
    frag.import_bits([1, 1], [hi - 100, hi])
    frag.snapshot()
    assert frag.unload() is True
    base32, width32 = frag.win32()
    assert not frag._resident
    assert base32 <= (hi - 100) // 32 and hi // 32 < base32 + width32
    assert width32 < WORDS_PER_SLICE


def test_lazy_topn_no_fault_in(frag):
    """Src-less TopN on an evicted fragment: sidecar ids + header
    cardinalities, identical to the resident walk."""
    opts = PKGS[frag.pkg][1]
    frag.import_bits([1] * 50 + [2] * 30 + [3] * 10,
                     list(range(50)) + list(range(30)) + list(range(10)))
    frag.snapshot()
    want = frag.top(opts(n=2))
    want_all = frag.top(opts())
    assert frag.unload() is True
    assert frag.top(opts(n=2)) == want == [(1, 50), (2, 30)]
    assert frag.top(opts()) == want_all
    assert frag.top(opts(row_ids=[2, 3])) == [(2, 30), (3, 10)]
    assert frag.top(opts(min_threshold=20)) == [(1, 50), (2, 30)]
    assert not frag._resident
    frag.set_bit(3, 99)  # faults in, appends an op
    frag.snapshot()
    want2 = frag.top(opts(n=3))
    assert frag.unload() is True
    assert frag.top(opts(n=3)) == want2
    assert not frag._resident


def test_lazy_invalidated_on_fault_in_and_snapshot(frag):
    _fill(frag, n_rows=4, subs=(0,))
    assert frag.unload() is True
    frag.row_words(1)
    assert frag._lazy is not None
    frag.set_bit(1, 500)  # faults in: the reader drops before the write
    assert frag._lazy is None
    assert frag.unload() is True
    assert 500 in _bits(frag.row_words(1))


def test_backup_cold_streams_file(frag, tmp_path):
    """write_to on an evicted fragment streams the roaring file (snapshot
    + op tail), no fault-in; either package restores it."""
    frag.import_bits([1] * 20 + [2] * 10, list(range(20)) + list(range(10)))
    frag.snapshot()
    frag.set_bit(1, 999)
    assert frag.unload() is True
    buf = io.BytesIO()
    frag.write_to(buf)
    assert not frag._resident
    for name, (cls, _) in PKGS.items():
        kw = {"device": "cpu"} if name == "t" else {}
        g = cls(str(tmp_path / f"restored_{name}"), "i", "f", "standard", 0,
                **kw).open()
        buf.seek(0)
        g.read_from(buf)
        assert g.row_count(1) == 21 and g.row_count(2) == 10
        g.close()


# --------------------------------------------------- cold executor reads


def _cold_holders(tmp_path, n_slices=4):
    """One directory written by pilosa_tpu: frame general (rows 1-3 over
    a low cluster) and a BSI frame; returns its path."""
    path = str(tmp_path / "data")
    h = JHolder(path).open()
    idx = h.create_index("i")
    fr = idx.create_frame("general")
    bf = idx.create_frame("bsif", JFrameOptions(
        range_enabled=True,
        fields=[JField(name="v", type="int", min=0, max=1000)]))
    for s in range(n_slices):
        base = s * SLICE_WIDTH
        fr.import_bits([1] * 60 + [2] * 40 + [3] * 20,
                       [base + i for i in range(60)]
                       + [base + i for i in range(40)]
                       + [base + i for i in range(20)])
        bf.import_value("v", [base + i for i in range(80)],
                        [(i * 13) % 1000 for i in range(80)])
    h.close()
    return path


COLD_QUERIES = [
    'Count(Intersect(Bitmap(frame="general", rowID=1), '
    'Bitmap(frame="general", rowID=2)))',
    'TopN(Bitmap(frame="general", rowID=1), frame="general", n=2)',
    'TopN(frame="general", n=2)',
    'Sum(frame="bsif", field="v")',
    'Min(frame="bsif", field="v")',
    'Max(frame="bsif", field="v")',
    'Range(frame="bsif", v > 500)',
    'Union(Bitmap(frame="general", rowID=3), Bitmap(frame="general", '
    'rowID=1))',
]


def _answer(v):
    return v.columns().tolist() if hasattr(v, "columns") else v


@pytest.mark.parametrize("path", ["batched", "serial"])
def test_cold_reads_answer_without_fault_in(tmp_path, path):
    """Count, TopN with and without Src, BSI and bitmap results over a
    freshly opened directory: the reference's answers, and the
    governor counts no fault-in (the serial Src TopN excepted: it counts
    on the fragment's device matrix, as in the reference)."""
    data = _cold_holders(tmp_path)
    jh = JHolder(data).open()
    je = JExecutor(jh)
    je._force_path = path
    want = [_answer(je.execute("i", q)[0]) for q in COLD_QUERIES]
    jh.close()
    th = THolder(data, device="cpu").open()
    assert th.governor.resident_bytes() == 0 and th.governor.faults == 0
    te = TExecutor(th)
    te._force_path = path
    for q, w in zip(COLD_QUERIES, want):
        faults = th.governor.faults
        assert _answer(te.execute("i", q)[0]) == w, q
        src_topn = q.startswith("TopN(Bitmap") and path == "serial"
        assert (th.governor.faults > faults) == src_topn, q
    frags = [f for fr in th.index("i").frames.values()
             for v in fr.views.values() for f in v.fragments.values()]
    if path == "batched":
        assert not any(f._resident for f in frags)
    th.close()


def test_holder_open_decodes_no_file(tmp_path, monkeypatch):
    """Opening a holder parses no roaring file, reads no sidecar and
    charges the governor nothing; the first read parses one header."""
    data = _cold_holders(tmp_path)
    calls = []
    real = tcodec.parse_header
    monkeypatch.setattr(tcodec, "parse_header",
                        lambda d: calls.append(1) or real(d))
    th = THolder(data, device="cpu").open()
    assert calls == [] and th.governor.resident_bytes() == 0
    frags = list(th.index("i").frame("general").view("standard")
                 .fragments.values())
    assert frags and not any(f._resident or f._lazy for f in frags)
    assert TExecutor(th).execute("i", COLD_QUERIES[0])[0] == 4 * 40
    assert len(calls) == len(frags)  # one header parse per fragment read
    th.close()


def test_cold_batched_stacks_live_on_the_holder_device(tmp_path,
                                                      monkeypatch):
    # The dense batched path: with the container tier on, these sparse
    # cold rows would serve serially from compressed containers.
    monkeypatch.setattr(tcontainers, "_ENABLED", False)
    data = _cold_holders(tmp_path)
    th = THolder(data, device="cpu").open()
    te = TExecutor(th)
    te._force_path = "batched"
    te.execute("i", COLD_QUERIES[0])
    with te._cache_mu:
        stacks = [v[2] for v in te._stack_cache.values()]
    assert stacks and all(s.device == th.device for s in stacks)
    assert {tuple(s.shape) for s in stacks} == {(4, TExecutor.MIN_WIN32)}
    th.close()


# ------------------------------------------------------------- governor


def test_unload_reload_preserves_state(tmp_path):
    f = TFragment(str(tmp_path / "frag"), "i", "f", "standard", 0,
                  device="cpu").open()
    f.import_bits([1, 1, 2], [0, 5, SLICE_WIDTH - 1])
    f.set_bit(3, 9)           # op-log append, no snapshot
    assert f.count() == 4
    f.unload()
    assert not f._resident
    assert f.count() == 4     # fault-in reloads from the file
    assert f.row_count(1) == 2 and f.row_count(3) == 1
    assert sorted(f.rows()) == [1, 2, 3]
    f.close()


def test_lazy_open_loads_nothing(tmp_path):
    path = str(tmp_path / "d")
    h = THolder(path, device="cpu").open()
    h.create_index("i").create_frame("f").import_bits([1, 2], [0, 3])
    h.close()
    h2 = THolder(path, device="cpu").open()
    assert h2.governor.resident_bytes() == 0
    e = TExecutor(h2)
    assert e.execute("i", 'Count(Bitmap(frame="f", rowID=1))')[0] == 1
    lazy_charge = h2.governor.resident_bytes()
    assert 0 < lazy_charge <= 32768
    frag = h2.fragment("i", "f", "standard", 0)
    assert not frag._resident
    assert frag.unload() is True and h2.governor.resident_bytes() == 0
    assert e.execute("i", 'SetBit(frame="f", rowID=1, columnID=9)')[0]
    assert frag._resident and h2.governor.resident_bytes() > 0
    assert h2.memory_stats()["totals"]["residentFragments"] == 1
    h2.close()


class FakeFrag:
    def __init__(self, name):
        self.name = name
        self._last_used = 0
        self._resident = True
        self.unloaded = 0

    def unload(self, blocking=True):
        self.unloaded += 1
        self._resident = False
        return True


@pytest.mark.parametrize("budget", [100, 250, None])
def test_governor_evicts_as_the_reference(budget):
    """One access sequence of registers, touches and re-registers: the
    same victims, in the same order, the same eviction counts."""
    rng = np.random.default_rng(5)
    steps = [(int(rng.integers(0, 8)), int(rng.integers(0, 60)),
              bool(rng.integers(0, 2))) for _ in range(200)]
    out = {}
    for name, cls in (("j", JGovernor), ("t", TGovernor)):
        gov = cls(budget_bytes=budget)
        frags = [FakeFrag(i) for i in range(8)]
        order = []
        for i, nbytes, touch in steps:
            f = frags[i]
            f._resident = True
            before = [g.unloaded for g in frags]
            if touch:
                gov.touch(f)
            gov.update(f, nbytes)
            order += [g.name for g, b in zip(frags, before)
                      if g.unloaded > b]
        out[name] = (order, gov.evictions, gov.resident_bytes(),
                     gov.resident_count())
        if budget is not None:
            assert gov.resident_bytes() <= budget
    assert out["t"] == out["j"]
    assert budget is None or out["t"][1] > 0


def _governed_sequence(path, holder_cls, budget, **kw):
    """Reads and writes over a 12-slice index under a host budget:
    (answers, evictions, faults)."""
    h = holder_cls(path, host_bytes=budget, **kw).open()
    answers = []
    for s in list(range(12)) + [3, 7, 0, 11]:
        f = h.fragment("i", "f", "standard", s)
        answers.append(int(f.row_words(1).sum() % 1000003))
        answers.append(f.row_count(2))
        if s % 4 == 0:
            answers.append(f.set_bit(1, s * SLICE_WIDTH + 777))
        answers.append(h.governor.resident_bytes() <= budget)
    gov = h.governor
    out = (answers, gov.evictions, gov.faults)
    h.close()
    return out


def test_governed_fragments_evict_as_the_reference(tmp_path):
    path = str(tmp_path / "d")
    h = JHolder(path).open()
    fr = h.create_index("i").create_frame("f")
    rng = np.random.default_rng(9)
    for s in range(12):
        fr.import_bits([1] * 300 + [2] * 50, (s * SLICE_WIDTH + rng.integers(
            0, 1 << 18, 350)).tolist())
    h.close()
    budget = 300_000
    j = _governed_sequence(path, JHolder, budget)
    # Both sequences write: run the port's on a copy of the original.
    import shutil
    shutil.rmtree(path)
    h = JHolder(path).open()
    fr = h.create_index("i").create_frame("f")
    rng = np.random.default_rng(9)
    for s in range(12):
        fr.import_bits([1] * 300 + [2] * 50, (s * SLICE_WIDTH + rng.integers(
            0, 1 << 18, 350)).tolist())
    h.close()
    t = _governed_sequence(path, THolder, budget, device="cpu")
    assert t == j
    assert t[1] > 0 and t[2] > 0


def test_thousand_slice_index_serves_under_cap(tmp_path):
    """A sparse index over many slices opens and serves Count/TopN and a
    write under a host-byte cap that full residency would exceed."""
    path = str(tmp_path / "d")
    h = THolder(path, device="cpu").open()
    fr = h.create_index("i").create_frame("f")
    n_slices = 300
    for s in range(n_slices):
        base = s * SLICE_WIDTH
        fr.import_bits([1, 2], [base + s % 97, base + 7 * s % 101 + 200])
    h.close()
    cap = 600 << 10  # full residency would need ~1.2 MB
    h2 = THolder(path, device="cpu", host_bytes=cap).open()
    gov = h2.governor
    assert gov.resident_bytes() == 0
    e = TExecutor(h2)
    assert e.execute("i", 'Count(Bitmap(frame="f", rowID=1))')[0] == n_slices
    assert gov.resident_bytes() <= cap
    assert e.execute("i", 'TopN(frame="f", n=2)')[0] == [(1, n_slices),
                                                        (2, n_slices)]
    assert gov.resident_bytes() <= cap
    e._force_path = "serial"
    assert e.execute("i", 'TopN(Bitmap(frame="f", rowID=1), frame="f", '
                          'n=2)')[0] == [(1, n_slices)]
    assert gov.resident_bytes() <= cap and gov.evictions > 0
    assert gov.resident_count() < n_slices
    e._force_path = None
    assert e.execute("i", 'SetBit(frame="f", rowID=9, columnID=%d)'
                     % (5 * SLICE_WIDTH)) == [True]
    assert gov.resident_bytes() <= cap
    assert e.execute("i", 'Count(Bitmap(frame="f", rowID=9))')[0] == 1
    h2.close()


def test_concurrent_fault_in_no_deadlock(tmp_path):
    """Two threads faulting fragments in while a tiny budget makes each
    update evict the other's: the governor skips lock-contended victims
    instead of blocking (the ABBA guard)."""
    path = str(tmp_path / "d")
    h = THolder(path, device="cpu").open()
    fr = h.create_index("i").create_frame("f")
    for s in range(16):
        fr.import_bits([1], [s * SLICE_WIDTH + 1])
    h.close()
    h2 = THolder(path, device="cpu", host_bytes=8192).open()
    errs = []

    def work(off):
        try:
            for i in range(150):
                f = h2.fragment("i", "f", "standard", (i + off) % 16)
                assert f.count() == 1   # faults in
                assert f.row_count(1) == 1
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    threads = [threading.Thread(target=work, args=(o,)) for o in (0, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "deadlock"
    assert not errs, errs
    assert h2.governor.evictions > 0
    h2.close()


def test_device_window_and_host_cap_compose(tmp_path):
    """A slice list over the stack budget streams through halved slice
    windows while the governor evicts: answers stay exact."""
    path = str(tmp_path / "d")
    h = THolder(path, device="cpu").open()
    fr = h.create_index("i").create_frame("f")
    n_slices = 96
    for s in range(n_slices):
        base = s * SLICE_WIDTH
        fr.import_bits([1, 2, 2], [base + 1, base + 1, base + 2])
    h.close()
    h2 = THolder(path, device="cpu", host_bytes=1 << 20).open()
    e = TExecutor(h2)
    e.STACK_CACHE_BYTES = 24 * TExecutor.MIN_WIN32 * 4 * 3
    assert e.execute("i", 'Count(Intersect(Bitmap(frame="f", rowID=1), '
                          'Bitmap(frame="f", rowID=2)))') == [n_slices]
    assert h2.governor.resident_bytes() <= (1 << 20)
    assert e.execute("i", 'TopN(frame="f", n=1)')[0] == [(2, 2 * n_slices)]
    h2.close()


@pytest.mark.parametrize("soft", [1024, 4096, 1 << 17])
def test_reader_cap_follows_the_descriptor_limit(monkeypatch, soft):
    """Without PILOSA_TPU_MAX_READERS the cap is the soft descriptor
    limit less 1,024, within [64, 32,768]; with it, its value."""
    import resource

    soft0, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    monkeypatch.setattr(tfragment, "MAX_LAZY_READERS", None)
    try:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(soft, hard), hard))
        want = min(max(min(soft, hard) - 1024, 64), 32768)
        assert tfragment.reader_cap() == want
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft0, hard))
    monkeypatch.setattr(tfragment, "MAX_LAZY_READERS", 5)
    assert tfragment.reader_cap() == 5


def test_reader_cap_bounds_open_readers(tmp_path, monkeypatch):
    """Past MAX_LAZY_READERS the oldest fragment's reader closes; its
    memos stay and a later read recreates it."""
    monkeypatch.setattr(tfragment, "MAX_LAZY_READERS", 3)
    path = str(tmp_path / "d")
    h = THolder(path, device="cpu").open()
    fr = h.create_index("i").create_frame("f")
    for s in range(6):
        fr.import_bits([1], [s * SLICE_WIDTH + s])
    h.close()
    h2 = THolder(path, device="cpu").open()
    frags = [h2.fragment("i", "f", "standard", s) for s in range(6)]
    for s, f in enumerate(frags):
        assert _bits(f.row_words(1)) == [s]
    assert sum(f._lazy is not None for f in frags) == 3
    assert frags[0]._lazy is None and frags[0]._lazy_rows
    assert _bits(frags[0].row_words(1)) == [0]
    h2.close()


# -------------------------------------------------------------- devices


def test_storage_constructors_default_to_the_gpu(tmp_path):
    """Index, Frame, View and Fragment run on the card unless asked for
    the CPU, as Holder and Server do; construction and a lazy open touch
    no device, so they work here without one."""
    idx = TIndex(str(tmp_path / "i"), "i")
    fr = TFrame(str(tmp_path / "i" / "f"), "i", "f")
    v = TView(str(tmp_path / "i" / "f" / "views" / "standard"), "i", "f",
              "standard")
    f = TFragment(str(tmp_path / "frag"), "i", "f", "standard", 0).open()
    assert idx.device == fr.device == v.device == "cuda"
    assert f.device.type == "cuda" and not f._resident
    f.close()


def test_holder_raises_file_limit_as_the_reference(tmp_path):
    """Holder.open raises the soft descriptor limit as pilosa_tpu's does
    (ref: setFileLimit holder.go:385-431), from the same starting limit."""
    import resource

    soft0, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    low = min(soft0, 1024)
    got = []
    try:
        for holder_cls, kw in ((JHolder, {}), (THolder, {"device": "cpu"})):
            resource.setrlimit(resource.RLIMIT_NOFILE, (low, hard))
            h = holder_cls(str(tmp_path / holder_cls.__module__), **kw).open()
            got.append(resource.getrlimit(resource.RLIMIT_NOFILE)[0])
            h.close()
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft0, hard))
    assert got[0] == got[1]
    assert got[1] > low or hard == low
