"""Port parity for the compressed container tier (pilosa_tpu's
ops/containers.py and its serving seams): ``build_container`` and
``choose_format`` format for format (windowed ``offset`` rebasing too),
the 4,096/4,097-bit and 2,048/2,049-run thresholds, all-zero and
all-ones rows, bit 31 and widths that are not a multiple of 128;
``dispatch_count`` for the 4 ops × 9 format pairs; the lanes (``RowLane``
pairs through ``lane_and_counts``, rows of one format and of mixed
formats) against pilosa_tpu's ``_fused_count_cell``; the plain version of
``container_and_counts`` (the lane kernel's, which the CPU runs) against
numpy at its edges; ``_array_to_dense`` and ``run_mask`` word for word.
Then the slice as a whole over a count100b-shaped index (rows of 500 and
300 spread bits, one 2,000-bit run, a row at density 0.5) written once
and opened lazily by both packages: serial and default-route answers
with the tier on and off, lone Counts through the lanes and their cached
rows, the coalesced lane group (cold and warm), the densify budget, the
``memory_stats`` container rollup, ``coalesce_snapshot``'s compressed
fields, and ``PILOSA_CONTAINER_FORMATS=0`` giving back the dense routes.

Every count, word vector and rollup must equal pilosa_tpu's (and the
numpy oracle's) exactly: tolerance 0."""
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.ops import bitops as jbitops
from pilosa_tpu.ops import containers as jcont
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.ops import bitops as tbitops
from pilosa_tpu_torch.ops import containers as tcont
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.storage.holder import Holder as THolder

OPS = ("and", "or", "xor", "andnot")
FMTS = ("array", "run", "dense")
W32 = 2048  # block width in 32-bit words (65,536 bits) for the unit cases


@pytest.fixture(autouse=True)
def tier_on():
    """Both packages' tiers on (their default), restored after."""
    prev = (tcont.enabled(), jcont.enabled())
    tcont.set_enabled(True)
    jcont.set_enabled(True)
    yield
    tcont.set_enabled(prev[0])
    jcont.set_enabled(prev[1])


def _words(bits, width32=W32):
    """uint64 words of a bit position list (or a 0/1 vector)."""
    v = np.zeros(width32 * 32, np.uint8)
    v[np.asarray(bits, dtype=np.int64)] = 1
    return np.packbits(v, bitorder="little").view(np.uint64)


def _runs_words(n_runs, length, width32=W32, first=0):
    bits = np.concatenate([np.arange(first + 2 * length * i,
                                     first + 2 * length * i + length)
                           for i in range(n_runs)]) if n_runs else []
    return _words(bits, width32)


def _kind_words(kind, rng, width32=W32):
    limit = width32 * 32
    if kind == "empty":
        return np.zeros(width32 // 2, np.uint64)
    if kind == "one":
        return _words([limit - 1], width32)
    if kind == "bit31":
        return _words(np.arange(31, limit, 32)[:4096], width32)
    if kind == "array":
        return _words(rng.choice(limit, 700, replace=False), width32)
    if kind == "array4096":
        return _words(rng.choice(limit, 4096, replace=False), width32)
    if kind == "array4097":
        return _words(rng.choice(limit, 4097, replace=False), width32)
    if kind == "run":
        return _runs_words(37, 29, width32, first=5)
    if kind in ("runs2048", "runs2049"):  # runs of 3 bits, or of 1
        return _runs_words(int(kind[4:]), 3 if limit > 12300 else 1,
                           width32)
    if kind == "ones":
        return np.full(width32 // 2, np.uint64(2**64 - 1))
    if kind == "dense":
        return rng.integers(0, 2**64, width32 // 2, dtype=np.uint64)
    raise ValueError(kind)


KINDS = ("empty", "one", "bit31", "array", "array4096", "array4097", "run",
         "runs2048", "runs2049", "ones", "dense")


def _same(tc, jc):
    assert tc.fmt == jc.fmt and tc.count == jc.count
    if tc.fmt == "array":
        assert np.array_equal(tc.positions, jc.positions)
        assert tc.positions.dtype == np.int32
    elif tc.fmt == "run":
        assert np.array_equal(tc.runs, jc.runs)
        assert tc.runs.dtype == np.int32
    assert np.array_equal(tc.host_words64(), np.asarray(jc.host_words64()))
    assert tc.nbytes() == jc.nbytes()
    assert tc.dense_equiv_bytes() == jc.dense_equiv_bytes()


# ------------------------------------------------------------- formats

@pytest.mark.parametrize("width32", [W32, 200, 1000])
@pytest.mark.parametrize("kind", KINDS)
def test_build_container_matches_reference(kind, width32):
    w = _kind_words(kind, np.random.default_rng(11), width32)
    tc = tcont.build_container(w, width32, device="cpu")
    jc = jcont.build_container(w, width32)
    _same(tc, jc)
    assert np.array_equal(tc.dense_words().numpy().view(np.uint32),
                          np.asarray(jc.dense_words()))


@pytest.mark.parametrize("kind", ["array", "run", "bit31", "dense"])
@pytest.mark.parametrize("base64", [0, 128, 960])
def test_windowed_offset_rebasing_matches_reference(kind, base64):
    """A window of 64 words at word ``base64`` of a full block: the
    fragment's resident build (offset = base · 64 bits)."""
    rng = np.random.default_rng(base64 + 3)
    win = _kind_words(kind, rng, 128)
    tc = tcont.build_container(win, W32, offset=base64 * 64, device="cpu")
    jc = jcont.build_container(win, W32, offset=base64 * 64)
    assert tc.fmt == jc.fmt and tc.count == jc.count
    if tc.fmt == "array":
        assert np.array_equal(tc.positions, jc.positions)
    elif tc.fmt == "run":
        assert np.array_equal(tc.runs, jc.runs)


@pytest.mark.parametrize("count,n_runs", [
    (0, 0), (1, 1), (2, 1), (3, 1), (4096, 1), (4096, 2048), (4096, 2049),
    (4097, 1), (4097, 2048), (4097, 2049), (5000, 2047), (100, 50),
    (100, 49), (2**20, 1)])
def test_choose_format_thresholds(count, n_runs):
    assert tcont.choose_format(count, n_runs) == jcont.choose_format(
        count, n_runs)


@pytest.mark.parametrize("kind", KINDS)
def test_run_bounds_and_positions_match_reference(kind):
    w = _kind_words(kind, np.random.default_rng(5))
    for a, b in zip(tcont.run_bounds(w), jcont.run_bounds(w)):
        assert np.array_equal(a, b) and a.dtype == np.int32
    assert np.array_equal(tcont.extract_positions(w),
                          jcont.extract_positions(w))


def test_pads_match_reference():
    pos = np.array([0, 31, 4095], np.int32)
    assert np.array_equal(tcont.pad_positions(pos, 65536),
                          jcont.pad_positions(pos, 65536))
    runs = np.array([[0, 5], [40, 64]], np.int32)
    for a, b in zip(tcont.pad_runs(runs, 65536),
                    jcont.pad_runs(runs, 65536)):
        assert np.array_equal(a, b)


def test_parse_enabled_matches_reference():
    for v in ("", "1", "0", "false", "no", "off", "OFF", "on", "yes"):
        assert tcont.parse_enabled(v) == jcont.parse_enabled(v)


def test_formats_off_by_environment():
    code = ("from pilosa_tpu_torch.ops import containers as c; "
            "print(c.enabled())")
    for value, want in (("0", "False"), ("off", "False"), ("1", "True"),
                        ("", "True")):
        env = dict(os.environ, PILOSA_CONTAINER_FORMATS=value)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True,
                             timeout=120)
        assert out.stdout.strip() == want


# ------------------------------------------------------- count cells

def _pair_conts(fa, fb, seed):
    """Words of a left block of format ``fa`` and a right one of ``fb``;
    a right array block takes every other bit of a compressed left one,
    so that the two intersect."""
    rng = np.random.default_rng(seed)
    wa, wb = _kind_words(fa, rng), _kind_words(fb, rng)
    if fb == "array" and fa != "dense":
        pos = tcont.extract_positions(wa)[::2]
        wb = wb | _words(pos)
    return wa, wb


@pytest.mark.parametrize("fb", FMTS)
@pytest.mark.parametrize("fa", FMTS)
@pytest.mark.parametrize("op", OPS)
def test_dispatch_count_matches_reference(op, fa, fb):
    wa, wb = _pair_conts(fa, fb, 17)
    ta = tcont.build_container(wa, W32, device="cpu")
    tb = tcont.build_container(wb, W32, device="cpu")
    ja, jb = jcont.build_container(wa, W32), jcont.build_container(wb, W32)
    assert (ta.fmt, tb.fmt) == (ja.fmt, jb.fmt) == (fa, fb)
    got = int(tbitops.dispatch_count(op, ta, tb))
    assert got == int(jbitops.dispatch_count(op, ja, jb))
    want = {"and": wa & wb, "or": wa | wb, "xor": wa ^ wb,
            "andnot": wa & ~wb}[op]
    assert got == int(np.bitwise_count(want).sum())
    # A raw dense tensor operand (a Bitmap segment) against a container.
    raw = torch.from_numpy(wb.view(np.int32).copy())
    assert int(tbitops.dispatch_count(op, ta, raw)) == got
    pair = tbitops.dispatch_pair(op, ta, tb).numpy().view(np.uint64)
    assert np.array_equal(pair, want)


def _lane(fmt, n, seed, empty_at=None):
    rng = np.random.default_rng(seed)
    words = [_kind_words(fmt, rng) for _ in range(n)]
    if empty_at is not None:
        words[empty_at] = np.zeros(W32 // 2, np.uint64)
    return words


def _lane_totals(op, pairs):
    inter, launches = tcont.lane_and_counts(pairs)
    return [int(tcont.count_identity(op, int(x), la.count, lb.count))
            for x, (la, lb) in zip(inter, pairs)], launches


@pytest.mark.parametrize("fb", FMTS)
@pytest.mark.parametrize("fa", FMTS)
@pytest.mark.parametrize("op", OPS)
def test_lane_cells_match_reference(op, fa, fb):
    """The lanes (the kernel's plain version for array × array and
    array × run, the serial cells for run × run and any dense block) and
    pilosa_tpu's lane cell on the same members: five one-slice row pairs
    in one call, then the five slices as one row pair."""
    wa = _lane(fa, 5, 1)
    wb = _lane(fb, 5, 2)
    ta = [tcont.build_container(w, W32, device="cpu") for w in wa]
    tb = [tcont.build_container(w, W32, device="cpu") for w in wb]
    ja = [jcont.build_container(w, W32) for w in wa]
    jb = [jcont.build_container(w, W32) for w in wb]
    got, launches = _lane_totals(op, [(tcont.RowLane([a]), tcont.RowLane([b]))
                                      for a, b in zip(ta, tb)])
    want = jbitops.fused_count_kernel(op, fa, fb)(ja, jb)
    assert got == [int(x) for x in np.asarray(want)]
    assert got == [int(tbitops.dispatch_count(op, a, b))
                   for a, b in zip(ta, tb)]
    cells = {("array", "array"), ("array", "run"), ("run", "array")}
    assert launches == (1 if (fa, fb) in cells else 0)
    whole, _ = _lane_totals(op, [(tcont.RowLane(ta), tcont.RowLane(tb))])
    assert whole == [sum(got)]


@pytest.mark.parametrize("cell", ["array_array", "array_run", "array_dense",
                                  "run_dense"])
def test_packed_lane_kernel_plain_matches_reference_lanes(cell):
    """The packed lane form through the kernel's plain version (what the
    card's lanes launch) against pilosa_tpu's padded vmapped lane, with
    an empty member among full ones."""
    fa, fb = cell.split("_")
    wa = _lane(fa, 6, 3, empty_at=2)
    wb = _lane(fb, 6, 4, empty_at=4)
    ta = [tcont.build_container(w, W32, device="cpu") for w in wa]
    tb = [tcont.build_container(w, W32, device="cpu") for w in wb]
    ja = [jcont.build_container(w, W32) for w in wa]
    jb = [jcont.build_container(w, W32) for w in wb]
    if cell == "array_array":
        got = kernels.container_and_counts(cell, tcont.stack_positions(ta),
                                           tcont.stack_positions(tb))
        want = jcont.fused_count_array_array(
            jcont.stack_positions(ja), jcont.stack_positions(jb, 1))
    elif cell == "array_run":
        tb = [c if c.fmt == "run" else tcont.Container(
            "run", W32, 0, runs=np.zeros((0, 2), np.int32), device="cpu")
            for c in tb]
        jb = [c if c.fmt == "run" else jcont.Container(
            "run", W32, 0, runs=np.zeros((0, 2), np.int32)) for c in jb]
        got = kernels.container_and_counts(cell, tcont.stack_positions(ta),
                                           tcont.stack_runs(tb))
        s, e = jcont.stack_runs(jb)
        want = jcont.fused_count_array_run(jcont.stack_positions(ja), s, e)
    elif cell == "array_dense":
        got = kernels.container_and_counts(cell, tcont.stack_positions(ta),
                                           [c.dense_words() for c in tb])
        want = jcont.fused_count_array_dense(jcont.stack_positions(ja),
                                             jcont.stack_dense(jb))
    else:
        ta = [c if c.fmt == "run" else tcont.Container(
            "run", W32, 0, runs=np.zeros((0, 2), np.int32), device="cpu")
            for c in ta]
        ja = [c if c.fmt == "run" else jcont.Container(
            "run", W32, 0, runs=np.zeros((0, 2), np.int32)) for c in ja]
        got = kernels.container_and_counts(cell, tcont.stack_runs(ta),
                                           [c.dense_words() for c in tb])
        s, e = jcont.stack_runs(ja)
        want = jcont.fused_count_run_dense(s, e, jcont.stack_dense(jb))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()


def _oracle_counts(cell, a_parts, b_parts, limit):
    out = []
    for pa, pb in zip(a_parts, b_parts):
        if cell == "run_dense":
            bits = np.zeros(limit, bool)
            for s, e in pa:
                bits[s:e] = True
            dense = np.unpackbits(pb.view(np.uint8),
                                  bitorder="little").astype(bool)
            out.append(int((bits & dense).sum()))
        elif cell == "array_dense":
            dense = np.unpackbits(pb.view(np.uint8),
                                  bitorder="little").astype(bool)
            out.append(int(dense[pa].sum()))
        elif cell == "array_run":
            inside = np.zeros(len(pa), bool)
            for s, e in pb:
                inside |= (pa >= s) & (pa < e)
            out.append(int(inside.sum()))
        else:
            out.append(len(np.intersect1d(pa, pb)))
    return out


@pytest.mark.parametrize("width32", [1, 3, 128, 1000])
@pytest.mark.parametrize("cell", ["array_array", "array_run", "array_dense",
                                  "run_dense"])
def test_container_and_counts_plain_at_edges(cell, width32):
    """Members with no item, a lone item, bit 0, bit 31 of a word and the
    last bit of the block; runs on word edges and across words; an
    all-ones dense row."""
    rng = np.random.default_rng(width32)
    limit = width32 * 32
    n = 7

    def positions(i):
        base = [0, 31, limit - 1] if i % 2 else []
        extra = rng.choice(limit, min(limit, 5 + 3 * i), replace=False)
        return np.unique(np.concatenate([base, extra])).astype(np.int32)

    def runs(i):
        if i == 3:
            return np.zeros((0, 2), np.int32)
        if i == 5:
            return np.array([[0, limit]], np.int32)
        cuts = np.unique(rng.choice(limit + 1, 2 * (1 + i % 4),
                                    replace=False))
        if len(cuts) % 2:
            cuts = cuts[:-1]
        return cuts.reshape(-1, 2).astype(np.int32)

    def dense(i):
        if i == 1:
            return np.full(width32, -1, np.int32)
        return rng.integers(-2**31, 2**31, width32, dtype=np.int64).astype(
            np.int32)

    fa, fb = cell.split("_")
    a_parts = [positions(i) if fa == "array" else runs(i) for i in range(n)]
    b_parts = [positions(i + 1) if fb == "array" else runs(i + 2)
               if fb == "run" else dense(i) for i in range(n)]
    if fa == "array":
        a_parts[4] = np.zeros(0, np.int32)
    if fa == "array":
        pa = tcont._pack(a_parts, "cpu")
    else:
        pa = tcont.stack_runs([tcont.Container("run", width32, 1, runs=r,
                                               device="cpu")
                               for r in a_parts])
    if fb == "dense":
        side_b = [torch.from_numpy(d) for d in b_parts]
    elif fb == "array":
        side_b = tcont._pack(b_parts, "cpu")
    else:
        side_b = tcont.stack_runs([tcont.Container("run", width32, 1, runs=r,
                                                   device="cpu")
                                   for r in b_parts])
    got = kernels.container_and_counts(cell, pa, side_b).tolist()
    want = _oracle_counts(cell, a_parts,
                          [p.view(np.uint32) if fb == "dense" else p
                           for p in b_parts], limit)
    assert got == want
    if fb == "dense":  # the same rows as one [N, W] tensor
        got2 = kernels.container_and_counts(
            cell, pa, torch.from_numpy(np.stack(b_parts)))
        assert got2.tolist() == want


def test_container_and_counts_checks_its_inputs():
    pos = torch.tensor([1, 2], dtype=torch.int32)
    offs = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.container_and_counts("array_bitmap", (pos, offs),
                                     (pos, offs))
    with pytest.raises(TypeError):
        kernels.container_and_counts("array_array", (pos.long(), offs),
                                     (pos, offs))
    with pytest.raises(ValueError):
        kernels.container_and_counts(
            "array_array", (pos, offs),
            (pos, torch.tensor([0, 1, 2], dtype=torch.int32)))
    with pytest.raises(ValueError):
        kernels.container_and_counts("array_dense", (pos, offs), [])
    empty = torch.zeros(1, dtype=torch.int32)
    assert kernels.container_and_counts(
        "array_array", (pos, empty), (pos, empty)).tolist() == []


@pytest.mark.parametrize("kind", ["array", "bit31", "array4096", "one"])
def test_array_to_dense_matches_reference(kind):
    w = _kind_words(kind, np.random.default_rng(8))
    jc = jcont.build_container(w, W32)
    tc = tcont.build_container(w, W32, device="cpu")
    got = tcont._array_to_dense(tc.device_positions(), W32)
    want = jcont._array_to_dense(jc.device_positions(), W32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert np.array_equal(got.numpy().view(np.uint64), w)


@pytest.mark.parametrize("kind", ["run", "runs2048", "ones"])
def test_run_mask_matches_reference(kind):
    w = _kind_words(kind, np.random.default_rng(9))
    tc = tcont.build_container(w, W32, device="cpu")
    jc = jcont.build_container(w, W32)
    assert tc.fmt == jc.fmt == "run"
    got = tcont.run_mask(*tc.device_runs(), W32)
    want = jcont.run_mask(*jc.device_runs(), W32)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert np.array_equal(got.numpy().view(np.uint64), w)


def test_count_run_run_and_host_reprs_match_reference():
    """count_run_run against the reference, and the lanes' run × run
    members (counted on the host) against pilosa_tpu's whole-row host
    pass over the same runs."""
    rng = np.random.default_rng(12)
    ta, tb, reprs = [], [], []
    for i in range(4):
        ca = tcont.build_container(_kind_words("run", rng), W32,
                                   device="cpu")
        cb = tcont.build_container(_runs_words(11 + i, 40, W32, 17 * i), W32,
                                   device="cpu")
        ra, rb = ca.runs, cb.runs
        assert tcont.count_run_run(ra, rb) == jcont.count_run_run(ra, rb)
        ta.append(ca)
        tb.append(cb)
        none = np.zeros(0, np.int64)
        reprs.append((jcont.host_row_repr([none], [ra.astype(np.int64)]),
                      jcont.host_row_repr([none], [rb.astype(np.int64)])))
    want = jcont.host_repr_and_counts([r[0] for r in reprs],
                                      [r[1] for r in reprs], (1 << 20) + 1)
    inter, launches = tcont.lane_and_counts(
        [(tcont.RowLane([a]), tcont.RowLane([b])) for a, b in zip(ta, tb)])
    assert inter.tolist() == np.asarray(want).tolist() and launches == 0


# ------------------------------------------------- the slice as a whole

N_SLICES = 16


def _count100b_dir(path, seed=0):
    """benchmarks/count100b.py's shape over N_SLICES slices: rows 1 and 2
    of 500 and 300 bits spread over each slice (array containers), row 3
    one 2,000-bit run a slice (a run container), row 0 at density 0.5
    (dense). Written by the port and closed; returns the words."""
    rng = np.random.default_rng(seed)
    words = np.zeros((N_SLICES, 4, SLICE_WIDTH // 64), np.uint64)
    h = THolder(path, device="cpu").open()
    try:
        frame = h.create_index("ns").create_frame("f")
        for s in range(N_SLICES):
            base = s * SLICE_WIDTH
            cols = {1: rng.choice(SLICE_WIDTH, 500, replace=False),
                    2: rng.choice(SLICE_WIDTH, 300, replace=False)}
            start = int(rng.integers(0, SLICE_WIDTH - 3000))
            cols[3] = np.arange(start, start + 2000)
            cols[0] = np.flatnonzero(rng.random(SLICE_WIDTH) < 0.5)
            rows = np.concatenate([[r] * len(c) for r, c in cols.items()])
            allc = np.concatenate([c for c in cols.values()])
            frame.import_bits(rows.tolist(), (base + allc).tolist())
            for r, c in cols.items():
                np.bitwise_or.at(words[s, r], c >> 6,
                                 np.uint64(1) << (c & 63).astype(np.uint64))
    finally:
        h.close()
    return words


SPARSE_QUERIES = {  # (PQL, numpy over (r0, r1, r2, r3))
    "and12": ("Count(Intersect({1}, {2}))", lambda w: w[1] & w[2]),
    "and13": ("Count(Intersect({1}, {3}))", lambda w: w[1] & w[3]),
    "or12": ("Count(Union({1}, {2}))", lambda w: w[1] | w[2]),
    "andnot13": ("Count(Difference({1}, {3}))", lambda w: w[1] & ~w[3]),
    "xor23": ("Count(Xor({2}, {3}))", lambda w: w[2] ^ w[3]),
    "and10": ("Count(Intersect({1}, {0}))", lambda w: w[1] & w[0]),
    "and30": ("Count(Intersect({3}, {0}))", lambda w: w[3] & w[0]),
    "leaf3": ("Count({3})", lambda w: w[3]),
    "deep": ("Count(Union(Intersect({1}, {2}), {3}))",
             lambda w: (w[1] & w[2]) | w[3]),
}


def _q(pql):
    return pql.format(*[f'Bitmap(frame="f", rowID={r})' for r in range(4)])


@pytest.fixture(scope="module")
def sparse(tmp_path_factory):
    """(path, words, {label: pilosa_tpu's answer}) of one directory."""
    path = str(tmp_path_factory.mktemp("sparse") / "data")
    words = _count100b_dir(path)
    jh = JHolder(path).open()
    try:
        je = JExecutor(jh)
        want = {k: je.execute("ns", _q(q))[0]
                for k, (q, _) in SPARSE_QUERIES.items()}
    finally:
        jh.close()
    for k, (_, fn) in SPARSE_QUERIES.items():
        assert want[k] == int(np.bitwise_count(fn(words.transpose(
            1, 0, 2))).sum()), k
    return path, words, want


@pytest.fixture
def port(sparse):
    path, _, want = sparse
    h = THolder(path, device="cpu").open()
    e = TExecutor(h)
    e._result_memo_off = True
    yield h, e, want
    h.close()


@pytest.mark.parametrize("tier", ["on", "off"])
@pytest.mark.parametrize("path_", ["serial", None])
def test_sparse_index_answers_match_reference(port, tier, path_):
    h, e, want = port
    tcont.set_enabled(tier == "on")
    e._force_path = path_
    for k, (q, _) in SPARSE_QUERIES.items():
        assert e.execute("ns", _q(q))[0] == want[k], k


def test_all_sparse_plans_take_the_serial_compressed_route(port):
    """A Count of a bare leaf or a two-operand node whose every row leaf
    is compressed on every slice stages no dense stack: it is answered
    from the container lanes; a deeper tree stays batched (served
    serially from the tier it would launch a kernel a slice a node); one
    dense leaf keeps a plan batched; the tier off restores the batched
    route for all of them."""
    h, e, want = port
    from pilosa_tpu_torch.pql import parse

    def batched(label):
        child = parse(_q(SPARSE_QUERIES[label][0])).calls[0].children[0]
        return e._batched_count("ns", child, range(N_SLICES))

    frag = h.fragment("ns", "f", "standard", 0)
    # Cold: the probe guesses from the counts.
    assert [frag.row_format_probe(r) for r in range(4)] == [
        "dense", "array", "array", "array"]
    for label in ("and12", "and13", "or12", "andnot13", "xor23", "leaf3"):
        assert batched(label) == want[label], label
    assert len(e._stack_cache) == 0
    assert batched("deep") == want["deep"]
    assert len(e._stack_cache) == 3  # rows 1, 2 and 3, dense
    for label in ("and10", "and30"):
        assert batched(label) == want[label], label
    assert not any(f._resident for f in h.index("ns").frame("f").view(
        "standard").fragments.values())
    assert [frag.row_compressed(r) for r in range(4)] == [
        False, True, True, True]
    assert [frag.row_container(r).fmt for r in range(4)] == [
        "dense", "array", "array", "run"]
    assert frag.row_format_probe(3) == "run"  # warm: the served format
    tcont.set_enabled(False)
    for label in ("and12", "xor23", "deep"):
        assert batched(label) == want[label], label
    assert frag.row_compressed(1) is False
    assert torch.is_tensor(e._serial_row(frag, 1))


def _lazy_frags(h):
    return list(h.index("ns").frame("f").view("standard").fragments.values())


def test_container_rollup_matches_reference(sparse):
    """The same serial queries in both packages leave the same container
    memos: Holder.memory_stats()'s rollup, per index and in total."""
    path, _, _ = sparse
    labels = ("and12", "and13", "and10", "and30", "xor23")
    jh = JHolder(path).open()
    try:
        je = JExecutor(jh)
        je._force_path = "serial"
        for k in labels:
            je.execute("ns", _q(SPARSE_QUERIES[k][0]))
        jstats = jh.memory_stats()
    finally:
        jh.close()
    th = THolder(path, device="cpu").open()
    try:
        te = TExecutor(th)
        te._force_path = "serial"
        for k in labels:
            te.execute("ns", _q(SPARSE_QUERIES[k][0]))
        tstats = th.memory_stats()
        frag = th.fragment("ns", "f", "standard", 0)
        assert frag.memory_stats()["containers"] == frag.container_stats()
    finally:
        th.close()
    assert tstats["totals"]["containers"] == jstats["totals"]["containers"]
    assert (tstats["indexes"]["ns"]["containers"]
            == jstats["indexes"]["ns"]["containers"])
    c = tstats["totals"]["containers"]
    assert c["formats"]["array"]["blocks"] == 2 * N_SLICES
    assert c["formats"]["run"]["blocks"] == N_SLICES
    compressed = c["formats"]["array"]["bytes"] + c["formats"]["run"]["bytes"]
    assert compressed * 10 <= 3 * N_SLICES * SLICE_WIDTH // 8
    assert c["conversions"] == 0


def test_resident_rows_classify_at_their_window(tmp_path):
    """A resident fragment builds from its window's words, rebased, and
    wraps its dense mirror; a write that moves a row across formats is
    a conversion, in both packages alike."""
    cols = [3, 40, 70_000, 70_001]
    out = []
    for holder, dev in ((THolder, {"device": "cpu"}), (JHolder, {})):
        d = str(tmp_path / holder.__module__.split(".")[0])
        h = holder(d, **dev).open()
        frame = h.create_index("i").create_frame("f")
        frame.import_bits([1] * len(cols), cols)
        frag = h.fragment("i", "f", "standard", 0)
        c1 = frag.row_container(1)
        frame.import_bits([1] * 5000, list(range(100_000, 110_000, 2)))
        c2 = frag.row_container(1)
        out.append((c1.fmt, c1.positions.tolist(), c2.fmt, c2.count,
                    frag.container_stats()))
        h.close()
    assert out[0] == out[1]
    assert out[0][0] == "array" and out[0][2] == "dense"
    assert out[0][4]["conversions"] == 1


def _concurrent(e, queries):
    e.set_coalesce_config(max_wait_us=10_000_000, max_group=len(queries))
    results, errors = {}, []
    barrier = threading.Barrier(len(queries))

    def run(i, q):
        try:
            barrier.wait(timeout=30)
            results[i] = e.execute("ns", q)[0]
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i, q))
               for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return [results.get(i) for i in range(len(queries))], errors


GROUP_OPS = {"Intersect": np.bitwise_and, "Union": np.bitwise_or,
             "Difference": lambda a, b: a & ~b, "Xor": np.bitwise_xor}
GROUP_PAIRS = [(1, 2), (1, 3), (2, 3), (1, 2), (3, 1), (2, 1), (3, 2),
               (1, 2)]


@pytest.mark.parametrize("lanes", ["members", "warm"])
@pytest.mark.parametrize("op", sorted(GROUP_OPS))
def test_coalesced_lane_group_matches_reference(sparse, port, op, lanes):
    """Eight all-compressed Counts of one structure released together
    form one group served from the container lanes through the lane
    kernel's plain version: the equal members once, one launch per
    format cell (array × array; array × run with run × array), the rows
    packed on first use ("members") or already cached ("warm", after
    the same Counts served alone); nothing densifies."""
    _, words, _ = sparse
    h, e, _ = port
    queries = [_q(f"Count({op}({{{a}}}, {{{b}}}))") for a, b in GROUP_PAIRS]
    w = words.transpose(1, 0, 2)
    want = [int(np.bitwise_count(GROUP_OPS[op](w[a], w[b])).sum())
            for a, b in GROUP_PAIRS]
    if lanes == "warm":
        assert [e.execute("ns", q)[0] for q in queries] == want
        assert len(e._lane_cache) == 3
    e._co_enabled_memo = True
    conv = tcont.conversions_total()
    built = [f.row_container for f in _lazy_frags(h)]
    got, errors = _concurrent(e, queries)
    assert errors == [] and got == want
    st = e.coalesce_snapshot()
    assert st["rounds"] == 1 and st["fused_queries"] == len(GROUP_PAIRS)
    assert st["compressedFusedQueries"] == len(GROUP_PAIRS)
    assert st["laneLaunches"] == 2 and st["declined"] == {}
    assert st["densifiedBlocks"] == 0 and tcont.conversions_total() == conv
    assert len(e._lane_cache) == 3 and len(built) == N_SLICES


LONE = ("and12", "and13", "or12", "andnot13", "xor23", "leaf3")


def test_lone_compressed_counts_take_the_lanes(sparse, tmp_path,
                                               monkeypatch):
    """A lone all-compressed Count of a leaf or a two-operand node is
    served from the lanes: each row is packed once (RowLane) and reused
    by the next query while the index's epoch stands; a write moves the
    epoch and the answer follows it (on a copy of the directory)."""
    path, words, want = sparse
    shutil.copytree(path, tmp_path / "data")
    h = THolder(str(tmp_path / "data"), device="cpu").open()
    e = TExecutor(h)
    e._result_memo_off = True
    built = []

    class Counting(tcont.RowLane):
        def __init__(self, conts):
            built.append(len(conts))
            super().__init__(conts)

    monkeypatch.setattr(tcont, "RowLane", Counting)
    for k in LONE:
        assert e.execute("ns", _q(SPARSE_QUERIES[k][0]))[0] == want[k], k
    assert built == [N_SLICES] * 3  # rows 1, 2 and 3, once each
    assert len(e._stack_cache) == 0 and len(e._lane_cache) == 3
    for k in LONE:
        assert e.execute("ns", _q(SPARSE_QUERIES[k][0]))[0] == want[k], k
    assert len(built) == 3
    col = int(np.flatnonzero(np.unpackbits(
        (words[0, 2] & ~words[0, 1]).view(np.uint8), bitorder="little"))[0])
    e.execute("ns", f'SetBit(frame="f", rowID=1, columnID={col})')
    q = _q(SPARSE_QUERIES["and12"][0])
    try:
        assert e.execute("ns", q)[0] == want["and12"] + 1
    finally:
        h.close()


@pytest.mark.parametrize("move", ["fault_in", "unload"])
def test_residency_moves_the_compressed_route(port, move):
    """The compressed-plan verdict is memoized on the index epoch and the
    fragments' residency: a fault-in (no write, no epoch) sends an
    all-sparse Count back to the batched path. After the eviction the
    batched stacks stay valid and serve it (a prelude-memo hit asks no
    verdict); once they are dropped it takes the lanes again. The
    answer never moves."""
    h, e, want = port
    q = _q(SPARSE_QUERIES["and12"][0])
    assert e.execute("ns", q)[0] == want["and12"]
    assert len(e._stack_cache) == 0 and len(e._lane_cache) == 2
    frag = h.fragment("ns", "f", "standard", 0)
    epoch = h.index("ns").epoch.value
    with frag.mu:  # entering the lock faults the fragment in
        assert frag._resident
    assert e.execute("ns", q)[0] == want["and12"]
    assert len(e._stack_cache) == 2  # rows 1 and 2, batched
    if move == "unload":
        assert frag.unload() is True and not frag._resident
        e._lane_cache.clear()
        e._lane_bytes = 0
        assert e.execute("ns", q)[0] == want["and12"]
        assert len(e._lane_cache) == 0  # the cached stacks served it
        e._stack_cache.clear()
        e._stack_bytes = 0
        assert e.execute("ns", q)[0] == want["and12"]
        assert len(e._stack_cache) == 0 and len(e._lane_cache) == 2
    assert h.index("ns").epoch.value == epoch


@pytest.mark.parametrize("op", OPS)
def test_row_lanes_of_mixed_formats_match_reference(op):
    """Rows whose blocks change format from slice to slice (and skip
    slices): each format cell takes the slices it covers (a packed row's
    subset is packed anew) and the rest count through the serial cells;
    the totals equal the reference's per-slice counts."""
    rng = np.random.default_rng(21)
    kinds_a = ["array", "run", None, "empty", "dense", "array", "run"]
    kinds_b = ["run", "array", "array", "run", "array", "array", "run"]

    def blocks(kinds):
        words = [None if k is None else _kind_words(k, rng) for k in kinds]
        return (words, [None if w is None else tcont.build_container(
            w, W32, device="cpu") for w in words])

    wa, ta = blocks(kinds_a)
    wb, tb = blocks(kinds_b)
    want = 0
    for x, y in zip(wa, wb):
        if x is None and y is None:
            continue
        x = np.zeros(W32 // 2, np.uint64) if x is None else x
        y = np.zeros(W32 // 2, np.uint64) if y is None else y
        want += int(jbitops.dispatch_count(op, jcont.build_container(x, W32),
                                           jcont.build_container(y, W32)))
    got, launches = _lane_totals(op, [(tcont.RowLane(ta),
                                       tcont.RowLane(tb))])
    assert got == [want] and launches == 2


@pytest.mark.parametrize("budget", [0, "one", None])
def test_lane_cache_holds_its_byte_budget(port, budget):
    """The packed rows stay within LANE_CACHE_BYTES, oldest out; a row
    larger than the budget is packed for its query and not kept."""
    h, e, want = port
    if budget == "one":
        probe = TExecutor(h)
        probe._lane_row("ns", ("f", "standard", 1), range(N_SLICES))
        budget = probe._lane_bytes
    if budget is not None:
        e.LANE_CACHE_BYTES = budget
    for k in ("and12", "and13", "xor23", "and12"):
        assert e.execute("ns", _q(SPARSE_QUERIES[k][0]))[0] == want[k], k
    assert e._lane_bytes <= e.LANE_CACHE_BYTES
    assert e._lane_bytes == sum(v[1].nbytes for v in e._lane_cache.values())
    assert len(e._lane_cache) == {0: 0, None: 3}.get(budget, 1)


def test_group_of_bare_leaves_counts_without_a_launch(port):
    h, e, want = port
    e._co_enabled_memo = True
    got, errors = _concurrent(e, [_q("Count({3})"), _q("Count({1})")])
    assert errors == [] and got[0] == want["leaf3"]
    assert e.coalesce_snapshot()["laneLaunches"] == 0


@pytest.mark.parametrize("budget", [None, 0])
def test_deep_compressed_group_densifies_within_its_budget(port, budget):
    h, e, want = port
    e._co_enabled_memo = True
    if budget is not None:
        e.CO_DENSIFY_BYTES = budget
    conv = tcont.conversions_total()
    got, errors = _concurrent(e, [_q(SPARSE_QUERIES["deep"][0])] * 3)
    assert errors == [] and got == [want["deep"]] * 3
    st = e.coalesce_snapshot()
    if budget is None:
        assert st["densifiedBlocks"] == 3 * 3 * N_SLICES
        assert tcont.conversions_total() - conv == st["densifiedBlocks"]
        assert st["fused_queries"] == 3 and st["declined"] == {}
    else:
        assert st["densifiedBlocks"] == 0
        assert st["declined"] == {"densify_budget": 1}


def test_compressed_lanes_off_serve_singly(port):
    h, e, want = port
    e._co_enabled_memo = True
    e.CO_COMPRESSED = False
    labels = ["and12", "and13", "and12", "and10"]
    got, errors = _concurrent(e, [_q(SPARSE_QUERIES[k][0])
                                  for k in labels])
    assert errors == [] and got == [want[k] for k in labels]
    st = e.coalesce_snapshot()
    assert st["declined"] == {"compressed_off": 1}
    assert st["compressedFusedQueries"] == 0 and st["compressed"] is False


def test_coalesce_snapshot_carries_the_reference_fields(sparse):
    """The reference's keys, with its default values; the port's lanes
    and densify budget are executor constants, and the snapshot reads
    them."""
    path, _, _ = sparse
    jh = JHolder(path).open()
    try:
        jsnap = JExecutor(jh).coalesce_snapshot()
    finally:
        jh.close()
    th = THolder(path, device="cpu").open()
    try:
        te = TExecutor(th)
        tsnap = te.coalesce_snapshot()
        te.CO_COMPRESSED, te.CO_DENSIFY_BYTES = False, 12345
        off = te.coalesce_snapshot()
    finally:
        th.close()
    assert set(jsnap) <= set(tsnap)
    for k in ("compressed", "densifyBudgetBytes", "compressedFusedQueries",
              "laneLaunches", "densifiedBlocks", "maxGroup", "maxWaitUs"):
        assert tsnap[k] == jsnap[k], k
    assert tsnap["compressed"] is True
    assert (off["compressed"], off["densifyBudgetBytes"]) == (False, 12345)


def test_formats_off_restore_the_dense_routes(port):
    """PILOSA_CONTAINER_FORMATS=0: serial leaves read dense device rows,
    nothing is classified or memoized, all-sparse plans stay batched
    and build their stacks, and the answers stand."""
    h, e, want = port
    tcont.set_enabled(False)
    for k, (q, _) in SPARSE_QUERIES.items():
        assert e.execute("ns", _q(q))[0] == want[k], k
    assert len(e._stack_cache) == 4  # rows 0-3, one stack each
    e._force_path = "serial"
    for k, (q, _) in SPARSE_QUERIES.items():
        assert e.execute("ns", _q(q))[0] == want[k], k
    for frag in _lazy_frags(h):
        assert frag._cont_dev == {} and frag._cont_fmt == {}
    c = h.memory_stats()["totals"]["containers"]
    assert all(v["blocks"] == 0 for v in c["formats"].values())


def test_governor_eviction_drops_lazy_containers(sparse):
    path, _, want = sparse
    h = THolder(path, device="cpu").open()
    try:
        e = TExecutor(h)
        e._force_path = "serial"
        assert e.execute("ns", _q(SPARSE_QUERIES["and13"][0]))[0] == \
            want["and13"]
        frag = h.fragment("ns", "f", "standard", 0)
        assert ("lazy", 1) in frag._cont_dev and frag.lazy_bytes() > 0
        before = frag.lazy_bytes()
        assert frag.unload() is True
        assert frag._cont_dev == {} and frag.lazy_bytes() < before
        assert e.execute("ns", _q(SPARSE_QUERIES["and13"][0]))[0] == \
            want["and13"]
    finally:
        h.close()
