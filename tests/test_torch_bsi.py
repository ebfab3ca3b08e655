"""Port parity for BSI integer fields: ``ops/bsi.py`` against
pilosa_tpu's jitted ops on the same seeded words (depths 0, 1, 10 and
41; words with bit 31 set, all-zero and all-one planes; W not a multiple
of 128; predicates at min, max, the middle and above 2^32), the
fragment's ``field_*`` methods against pilosa_tpu's on one file, and
``Executor.execute`` — SetFieldValue, Sum, Average, Min, Max and
Count(Range(…)) on the serial and the batched path — against
pilosa_tpu's executor and a numpy oracle on one data directory. Every
answer is an integer or a word: tolerance 0."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu.storage.frame import Field as JField
from pilosa_tpu.storage.frame import Frame as JFrame
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu.storage.index import FrameOptions as JFrameOptions
from pilosa_tpu_torch import errors as terr
from pilosa_tpu_torch.executor import BATCH_OVER_BUDGET, SumCount
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.ops import bsi as tbsi
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.storage.fragment import Fragment as TFragment
from pilosa_tpu_torch.storage.frame import Field, Frame, FrameOptions
from pilosa_tpu_torch.storage.holder import Holder as THolder

W = 200  # words per row in the ops tests: not a multiple of 128
DEPTHS = (0, 1, 10, 41)
CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
_T_CMP = {"==": tbsi.bsi_eq, "!=": tbsi.bsi_neq, "<": tbsi.bsi_lt,
          "<=": tbsi.bsi_lte, ">": tbsi.bsi_gt, ">=": tbsi.bsi_gte}
_J_CMP = {"==": jbsi.bsi_eq, "!=": jbsi.bsi_neq, "<": jbsi.bsi_lt,
          "<=": jbsi.bsi_lte, ">": jbsi.bsi_gt, ">=": jbsi.bsi_gte}


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _planes(depth, shape, seed):
    """uint32 planes [depth, *shape] and the not-null words [*shape]:
    random words, every word of column 0 with bit 31 set, plane 1 all
    zero and plane 2 all one where the depth has them, and a not-null
    row with all-one, all-zero and bit-31-only words."""
    rng = np.random.default_rng(seed)

    def rand(*s):
        return rng.integers(0, 1 << 32, size=s, dtype=np.uint64).astype(
            np.uint32)

    planes = rand(depth, *shape)
    planes[..., 0] |= np.uint32(0x80000000)
    if depth > 2:
        planes[1] = 0
        planes[2] = 0xFFFFFFFF
    exists = rand(*shape) | rand(*shape)
    exists[..., 1] = 0xFFFFFFFF
    exists[..., 2] = 0
    exists[..., 3] = 0x80000000
    return planes, exists


def _predicates(depth):
    """Base values at min, max and the middle of the depth's range, and
    one above 2^32 (the depth's low bits of it below depth 33)."""
    top = (1 << depth) - 1
    return (0, top, top // 2, (1 << 33) + 12345)


def _between_pairs(depth):
    top = (1 << depth) - 1
    return ((0, top), (top // 2, top // 2), (1, top // 2), (top, 0),
            ((1 << 33) + 1, (1 << 33) + (1 << 20)))


def _j_bits(value, depth):
    return jbsi.value_to_bits(value, depth)


def _run_port(fn, planes, exists, form, *values):
    """Port op over the fragment form ([depth, W] matrix) or the stack
    form (a list of [S, W] stacks); uint32 words out."""
    depth = planes.shape[0]
    bits = [tbsi.value_to_bits(v, depth) for v in values]
    if form == "matrix":
        return _u32(fn(_t(planes), _t(exists), *bits))
    return _u32(fn([_t(p) for p in planes], _t(exists), *bits))


def _run_jax(fn, planes, exists, form, *values):
    depth = planes.shape[0]
    bits = [_j_bits(v, depth) for v in values]
    if form == "matrix":
        return np.asarray(fn(jnp.asarray(planes), jnp.asarray(exists), *bits))
    return np.stack([np.asarray(fn(jnp.asarray(planes[:, s]),
                                   jnp.asarray(exists[s]), *bits))
                     for s in range(exists.shape[0])])


def _shape(form):
    return (W,) if form == "matrix" else (3, 72)


@pytest.mark.parametrize("depth", DEPTHS)
def test_value_to_bits_matches_reference(depth):
    for v in _predicates(depth) + (5, 1 << 40):
        assert tbsi.value_to_bits(v, depth) == tuple(
            int(b) for b in np.asarray(_j_bits(v, depth)))


@pytest.mark.parametrize("form", ["matrix", "stack"])
@pytest.mark.parametrize("op", CMP_OPS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_compare_ops_match_reference(depth, op, form):
    planes, exists = _planes(depth, _shape(form), seed=depth * 7 + 1)
    for v in _predicates(depth):
        got = _run_port(_T_CMP[op], planes, exists, form, v)
        want = _run_jax(_J_CMP[op], planes, exists, form, v)
        assert np.array_equal(got, want), (op, v)


@pytest.mark.parametrize("form", ["matrix", "stack"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_between_matches_reference(depth, form):
    planes, exists = _planes(depth, _shape(form), seed=depth * 7 + 2)
    for lo, hi in _between_pairs(depth):
        got = _run_port(tbsi.bsi_between, planes, exists, form, lo, hi)
        want = _run_jax(jbsi.bsi_between, planes, exists, form, lo, hi)
        assert np.array_equal(got, want), (lo, hi)


def test_descents_leave_their_inputs_alone():
    planes, exists = _planes(10, (W,), seed=3)
    tp, te = _t(planes.copy()), _t(exists.copy())
    for op in CMP_OPS:
        _T_CMP[op](tp, te, tbsi.value_to_bits(300, 10))
    tbsi.bsi_between(tp, te, tbsi.value_to_bits(3, 10),
                     tbsi.value_to_bits(900, 10))
    tbsi.bsi_extrema_indicators(tp, te, True)
    assert np.array_equal(_u32(tp), planes)
    assert np.array_equal(_u32(te), exists)


@pytest.mark.parametrize("filt_kind", ["exists", "random", "zeros"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_plane_counts_match_reference(depth, filt_kind):
    planes, exists = _planes(depth, (W,), seed=depth * 7 + 3)
    filt = {"exists": exists, "zeros": np.zeros(W, np.uint32),
            "random": _planes(0, (W,), seed=99)[1]}[filt_kind]
    got = tbsi.plane_counts(_t(planes), _t(filt))
    assert got.dtype == torch.int32 and got.shape == (depth,)
    want = np.asarray(jbsi.plane_counts(jnp.asarray(planes),
                                        jnp.asarray(filt)))
    assert np.array_equal(got.numpy(), want)


def _extrema_filters(exists, shape, seed):
    """The not-null words, a random subset, one column, none."""
    rng = np.random.default_rng(seed)
    sub = exists & rng.integers(0, 1 << 32, size=shape, dtype=np.uint64
                                ).astype(np.uint32)
    one = np.zeros(shape, np.uint32)
    one[(0,) * (len(shape) - 1) + (1,)] = 0x00010000
    return {"exists": exists, "subset": sub, "one": one,
            "none": np.zeros(shape, np.uint32)}


@pytest.mark.parametrize("find_max", [True, False])
@pytest.mark.parametrize("depth", DEPTHS)
def test_extrema_indicators_match_reference(depth, find_max):
    planes, exists = _planes(depth, (W,), seed=depth * 7 + 4)
    for name, filt in _extrema_filters(exists, (W,), depth).items():
        ind, rem = tbsi.bsi_extrema_indicators(_t(planes), _t(filt),
                                               find_max)
        assert ind.dtype == torch.int32 and ind.shape == (depth,)
        if depth:  # pilosa_tpu's fragment-form op cannot stack 0 planes
            j_ind, j_rem = jbsi.bsi_extrema_indicators(
                jnp.asarray(planes), jnp.asarray(filt), find_max)
            assert np.array_equal(ind.numpy(), np.asarray(j_ind)), name
            assert np.array_equal(_u32(rem), np.asarray(j_rem)), name
        else:
            assert np.array_equal(_u32(rem), filt), name


@pytest.mark.parametrize("find_max", [True, False])
@pytest.mark.parametrize("depth", DEPTHS)
def test_global_extrema_descent_matches_reference(depth, find_max):
    """The batched Min/Max form: one descent over [S, W] plane stacks,
    held against pilosa_tpu's ``Executor._minmax_descent``."""
    shape = (3, 72)
    planes, exists = _planes(depth, shape, seed=depth * 7 + 5)
    stack = np.concatenate([planes.transpose(1, 0, 2), exists[:, None]],
                           axis=1)  # [S, depth+1, W], the JAX layout
    for name, filt in _extrema_filters(exists, shape, depth + 1).items():
        ind, rem = tbsi.bsi_extrema_indicators([_t(p) for p in planes],
                                               _t(filt), find_max)
        j_ind, j_count = JExecutor._minmax_descent(
            jnp.asarray(stack), jnp.asarray(filt), depth, find_max)
        assert np.array_equal(ind.numpy(), np.asarray(j_ind)), name
        assert int(np.bitwise_count(_u32(rem)).sum()) == int(j_count), name


# ------------------------------------------------------------- fragment

DEPTH = 10
FRAG_COLS = 3000


def _frag_data(seed):
    """(columns, base values) of one slice-0 fragment: both extremes
    tied, a run of neighbouring columns, duplicates resolved last-wins
    by the import."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(SLICE_WIDTH, FRAG_COLS, replace=False)
    cols[:64] = np.arange(64) + 31 * 32   # a word run, bit 31 included
    vals = rng.integers(0, 1 << DEPTH, FRAG_COLS)
    vals[:5], vals[5:9] = 0, (1 << DEPTH) - 1
    return cols.astype(np.uint64), vals.astype(np.uint64)


def _filter_words(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 64, SLICE_WIDTH // 64, dtype=np.uint64)


@pytest.fixture
def frag_pair(tmp_path):
    """A slice-0 field fragment written by pilosa_tpu (bulk import,
    then single writes), opened by each package in turn."""
    path = str(tmp_path / "frag")
    cols, vals = _frag_data(11)
    jf = JFragment(path, "i", "g", "field_v", 0).open()
    jf.import_value_bits(cols, vals, DEPTH)
    jf.set_field_value(int(cols[10]), DEPTH, 777)   # overwrite
    jf.set_field_value(5, DEPTH, 1)                 # fresh column
    jf.close()
    return path


def _frag_answers(frag, filt, to_words):
    """Every field_* answer of one fragment, words as uint64 arrays."""
    out = {"value": [frag.field_value(c, DEPTH) for c in (5, 7, 31 * 32)]}
    for f_name, fw in (("all", None), ("filt", filt)):
        out[f"sum_{f_name}"] = frag.field_sum(fw, DEPTH)
        for find_max in (True, False):
            out[f"mm_{f_name}_{find_max}"] = frag.field_min_max(
                fw, DEPTH, find_max)
    for op in CMP_OPS:
        for v in (0, 1023, 511, 1 << 33):
            out[f"range{op}{v}"] = to_words(frag.field_range(op, DEPTH, v))
    for lo, hi in ((0, 1023), (10, 60), (60, 10), (777, 777)):
        out[f"btw{lo},{hi}"] = to_words(
            frag.field_range_between(DEPTH, lo, hi))
    out["notnull"] = to_words(frag.field_not_null(DEPTH))
    return out


def test_fragment_field_methods_match_reference(frag_pair):
    filt = _filter_words(12)
    jf = JFragment(frag_pair, "i", "g", "field_v", 0).open()
    want = _frag_answers(jf, filt, lambda w: np.asarray(w, np.uint64))
    jf.close()
    tf = TFragment(frag_pair, "i", "g", "field_v", 0, device="cpu").open()
    got = _frag_answers(tf, _t(filt),
                        lambda w: w.numpy().copy().view(np.uint64))
    planes = tf.planes(DEPTH)
    assert planes.shape == (DEPTH + 1, 32768)
    tf.close()
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    assert got["value"][0] == (1, True) and got["value"][1] == (0, False)


def test_fragment_planes_gather_absent_and_reordered_rows(tmp_path):
    path = str(tmp_path / "frag")
    tf = TFragment(path, "i", "g", "field_v", 0, device="cpu").open()
    tf.set_bit(3, 70)                  # row 3 first: rows out of order
    tf.set_field_value(64, 4, 0b1010)  # rows 0, 2 never get a bit
    planes = tf.planes(4).numpy().view(np.uint32)
    want = np.zeros((5, 32768), np.uint32)
    want[1, 2] = want[3, 2] = want[4, 2] = 1   # column 64
    want[3, 2] |= 1 << 6                       # column 70
    assert np.array_equal(planes, want)
    assert tf.planes(0).shape == (1, 32768)
    tf.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_import_value_bits_writes_identical_files(tmp_path, writer):
    """The same import and writes through each package give the same
    bytes on disk (op log then snapshot), and read back in the other."""
    cols, vals = _frag_data(21)
    files = {}
    for pkg, cls in (("port", TFragment), ("reference", JFragment)):
        path = str(tmp_path / pkg)
        f = cls(path, "i", "g", "field_v", 0).open()
        f.import_value_bits(cols[:100], vals[:100], DEPTH)  # op log
        f.import_value_bits(cols[50:60], vals[:10], DEPTH)  # overwrite
        f.import_value_bits(cols, vals, DEPTH)              # snapshot
        f.set_field_value(int(cols[3]), DEPTH, 9)
        f.close()
        files[pkg] = open(path, "rb").read()
    assert files["port"] == files["reference"]
    reader = JFragment if writer == "port" else TFragment
    f = reader(str(tmp_path / writer), "i", "g", "field_v", 0).open()
    assert f.field_value(int(cols[3]), DEPTH) == (9, True)
    assert f.field_value(int(cols[55]), DEPTH) == (int(vals[55]), True)
    f.close()


# ------------------------------------------------------------- executor

N_SLICES = 4
MISSING_SLICE = 2   # no field fragment at all
EMPTY_SLICE = 3     # field fragment whose only value was cleared
BIG = 1 << 40
FIELDS = (("v", -10, 1000), ("big", 0, BIG), ("z", 7, 7))


def _values(seed):
    """{field: (global columns, values)} of the data directory, and
    frame f's rows 0 and 1 as {slice: (uint64 words, uint64 words)}."""
    rng = np.random.default_rng(seed)
    data = {}
    for name, lo, hi in FIELDS:
        cols, vals = [], []
        for s in range(N_SLICES):
            if s in (MISSING_SLICE, EMPTY_SLICE):
                continue
            c = rng.choice(SLICE_WIDTH, 4000, replace=False)
            v = rng.integers(lo, hi + 1, len(c), dtype=np.int64)
            v[:3], v[3:7] = lo, hi     # tied extremes
            cols.append(c + s * SLICE_WIDTH)
            vals.append(v)
        data[name] = (np.concatenate(cols), np.concatenate(vals))
    rows = {s: (rng.integers(0, 1 << 64, 16384, dtype=np.uint64),
                rng.integers(0, 1 << 64, 16384, dtype=np.uint64)
                & rng.integers(0, 1 << 64, 16384, dtype=np.uint64))
            for s in range(N_SLICES)}
    return data, rows


def _positions(words):
    return np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little")).astype(np.uint64)


@pytest.fixture(scope="module")
def bsi_dir(tmp_path_factory):
    """Directory written by pilosa_tpu: frame f (two dense rows per
    slice) and range-enabled frame g with fields v, big (depth 41) and
    z (min == max, depth 0)."""
    path = str(tmp_path_factory.mktemp("bsi") / "data")
    data, rows = _values(5)
    jh = JHolder(path).open()
    idx = jh.create_index("i")
    f = idx.create_frame("f")
    for s, (r0, r1) in rows.items():
        p0, p1 = _positions(r0), _positions(r1)
        f.import_bits(np.concatenate([np.zeros(len(p0), np.uint64),
                                      np.ones(len(p1), np.uint64)]),
                      np.concatenate([p0, p1]) + np.uint64(s * SLICE_WIDTH))
    g = idx.create_frame("g", JFrameOptions(range_enabled=True, fields=[
        JField(n, min=lo, max=hi) for n, lo, hi in FIELDS]))
    for name, (cols, vals) in data.items():
        g.import_value(name, cols.tolist(), vals.tolist())
    # A fragment whose only value is cleared: plane bits stay, not-null
    # goes (a column must not count without its not-null bit).
    col = EMPTY_SLICE * SLICE_WIDTH + 77
    g.set_field_value(col, "v", 999)
    frag = g.view("field_v").fragment(EMPTY_SLICE)
    frag.clear_bit(JField("v", min=-10, max=1000).bit_depth(), col)
    jh.close()
    return path, data, rows


def _member(cols, rows, r):
    """bool per column: is it in frame f's row r?"""
    out = np.zeros(len(cols), bool)
    for s, words in rows.items():
        sel = cols // SLICE_WIDTH == s
        local = cols[sel] % SLICE_WIDTH
        out[sel] = (words[r][local // 64] >> (local % 64).astype(np.uint64)
                    ) & np.uint64(1) == 1
    return out


def _range(field, cond):
    return f'Count(Range(frame="g", {field} {cond}))'


V_CONDS = ["> 30", ">= -10", "> -10", "< 1000", "<= 1000", "< -10",
           "> 1000", "< 5000", "> -5000", "== -10", "== 1000", "== 495",
           "== 5000", "!= 495", "!= 5000", "!= null", ">< [10, 60]",
           ">< [-10, 1000]", ">< [-50, 5000]", ">< [2000, 3000]",
           ">< [-50, -20]", ">< [60, 10]", ">< [500, 500]", "<= 0",
           ">= 999"]
QUERIES = (
    [_range("v", c) for c in V_CONDS]
    + [_range("big", c) for c in ("> 4294967296", ">= 1099511627776",
                                  ">< [8589934592, 549755813888]",
                                  "< 4294967296", "== 0", "!= null")]
    + [_range("z", c) for c in ("== 7", "!= 7", "> 6", "< 7", "!= null")]
    + ['Count(Intersect(Bitmap(frame="f", rowID=0), '
       'Range(frame="g", v >= 500)))',
       'Count(Union(Range(frame="g", v < 0), Range(frame="g", v > 900)))',
       'Count(Difference(Bitmap(frame="f", rowID=1), '
       'Range(frame="g", v != null)))',
       'Count(Xor(Range(frame="g", v > 100), Range(frame="g", big > 5)))']
    + [f'{agg}({flt}frame="g", field="{fd}")'
       for agg in ("Sum", "Average", "Min", "Max")
       for fd in ("v", "big", "z")
       for flt in ("", 'Bitmap(frame="f", rowID=1), ')]
    + ['Sum(Intersect(Bitmap(frame="f", rowID=0), Range(frame="g", '
       'v > 100)), frame="g", field="v")',
       'Max(Bitmap(frame="f", rowID=9), frame="g", field="v")',
       'Min(Range(frame="g", v > 990), frame="g", field="v")',
       'Sum(frame="g", field="nope")', 'Sum(frame="nope", field="v")',
       'Max(frame="nope", field="v")'])
# Trees with a statically empty Range (value above max) inside them, and
# the kind of the plan's root once the empty operands fold away.
_EMPTY_V = 'Range(frame="g", v > 5000)'
_F0, _F1 = 'Bitmap(frame="f", rowID=0)', 'Bitmap(frame="f", rowID=1)'
EMPTY_TREES = [
    (f"Intersect({_F0}, {_EMPTY_V})", "empty"),
    (f"Union({_EMPTY_V}, {_F0})", "Union"),
    (f"Difference({_EMPTY_V}, {_F1})", "empty"),
    (f'Difference({_F1}, {_EMPTY_V}, Range(frame="g", v < 0))',
     "Difference"),
    (f'Xor({_EMPTY_V}, Range(frame="g", v < -50))', "empty"),
    (f"Union(Intersect({_F1}, {_EMPTY_V}), Xor({_F0}, {_EMPTY_V}))",
     "Union"),
]
QUERIES += (
    [f"Count({tree})" for tree, _ in EMPTY_TREES]
    + [f'{agg}({EMPTY_TREES[i][0]}, frame="g", field="v")'
       for agg, i in (("Sum", 0), ("Max", 1), ("Min", 2), ("Sum", 3))]
    + [f'TopN({EMPTY_TREES[i][0]}, frame="f", n=2)' for i in (0, 1, 5)])


def _cond_mask(vals, cond, lo, hi):
    op, rest = cond.split(" ", 1)
    if rest == "null":
        return np.ones(len(vals), bool)
    if op == "><":
        a, b = json.loads(rest)
        return (vals >= a) & (vals <= b)
    x = int(rest)
    return {"==": vals == x, "!=": vals != x, "<": vals < x, "<=": vals <= x,
            ">": vals > x, ">=": vals >= x}[op]


def _oracle(query, data, rows):
    """numpy answer of the QUERIES shapes."""
    if query.startswith("Count(Range("):
        field, cond = query[len('Count(Range(frame="g", '):-2].split(" ", 1)
        lo, hi = {n: (a, b) for n, a, b in FIELDS}[field]
        return int(_cond_mask(data[field][1], cond, lo, hi).sum())
    return None  # held against the reference alone


def _run_all(path, holder_cls, ex_cls, kw, queries):
    h = holder_cls(path, **kw).open()
    try:
        ex = ex_cls(h)
        out = {}
        for p in ("serial", "batched"):
            ex._force_path = p
            for q in queries:
                try:
                    out[(p, q)] = ex.execute("i", q)[0]
                except Exception as e:  # compared as (type, message)
                    out[(p, q)] = (type(e).__name__, str(e))
        return out
    finally:
        h.close()


@pytest.fixture(scope="module")
def bsi_results(bsi_dir):
    path, _, _ = bsi_dir
    return (_run_all(path, JHolder, JExecutor, {}, QUERIES),
            _run_all(path, THolder, TExecutor, {"device": "cpu"}, QUERIES))


# pilosa_tpu's serial Min/Max over a depth-0 field fails (it stacks an
# empty list of plane indicators; ROADMAP Queue C); its batched path and
# the port answer.
_REF_SERIAL_FAILS = {q for q in QUERIES
                     if q.startswith(("Min(", "Max(")) and '"z"' in q}


@pytest.mark.parametrize("query", QUERIES)
def test_bsi_queries_match_reference_on_both_paths(bsi_dir, bsi_results,
                                                   query):
    _, data, rows = bsi_dir
    jax_out, port_out = bsi_results
    want = jax_out[("batched", query)]
    assert not (isinstance(want, tuple) and isinstance(want[0], str)), want
    if query not in _REF_SERIAL_FAILS:
        assert jax_out[("serial", query)] == want
    assert port_out[("serial", query)] == want
    assert port_out[("batched", query)] == want
    oracle = _oracle(query, data, rows)
    if oracle is not None:
        assert want == oracle


def test_bsi_aggregates_match_numpy(bsi_dir, bsi_results):
    _, data, rows = bsi_dir
    _, port_out = bsi_results
    for name, _lo, _hi in FIELDS:
        cols, vals = data[name]
        f1 = _member(cols, rows, 1)
        for flt, sel in (("", np.ones(len(vals), bool)),
                         ('Bitmap(frame="f", rowID=1), ', f1)):
            v = vals[sel]
            q = f'{{}}({flt}frame="g", field="{name}")'
            for p in ("serial", "batched"):
                assert port_out[(p, q.format("Sum"))] == SumCount(
                    int(v.sum()), len(v))
                assert port_out[(p, q.format("Max"))] == SumCount(
                    int(v.max()), int((v == v.max()).sum()))
                assert port_out[(p, q.format("Min"))] == SumCount(
                    int(v.min()), int((v == v.min()).sum()))


@pytest.mark.parametrize("tree,root", EMPTY_TREES)
def test_static_empty_operands_fold_at_plan_time(bsi_dir, tree, root):
    """A statically empty operand never reaches evaluation: Intersect
    with it, or Difference with it on the left, plans as "empty"; Union,
    Xor and the right of a Difference drop it."""
    th = THolder(bsi_dir[0], device="cpu").open()
    try:
        plan = TExecutor(th)._batched_plan("i", parse(tree).calls[0], [])
    finally:
        th.close()

    def kinds(node):
        yield node[0]
        if node[0] in ("Intersect", "Union", "Difference", "Xor"):
            for kid in node[1]:
                yield from kinds(kid)

    assert plan[0] == root
    assert "empty" not in list(kinds(plan))[1:]


@pytest.mark.parametrize("query", [
    _range("big", "> 4294967296"),
    'Count(Xor(Range(frame="g", v > 100), Range(frame="g", big > 5)))'])
def test_batched_count_windows_over_the_stack_budget(bsi_dir, query):
    """A Count whose leaf stacks (42 for a depth-41 Range) exceed the
    stack budget halves its slice window rather than evicting the stacks
    it is building; every window fits and the answer stays exact."""
    th = THolder(bsi_dir[0], device="cpu").open()
    try:
        ex = TExecutor(th)
        leaves = []
        ex._batched_plan("i", parse(query).calls[0].children[0], leaves)
        ex.STACK_CACHE_BYTES = len(leaves) * 8 * 32768 * 4  # 8 slices
        windows = []
        batched_count = ex._batched_count

        def spy(index, child, ns):
            out = batched_count(index, child, ns)
            windows.append((len(ns), out is BATCH_OVER_BUDGET))
            assert ex._stack_bytes <= ex.STACK_CACHE_BYTES
            return out

        ex._batched_count = spy
        ex._force_path = "batched"
        got = ex.execute("i", query, slices=range(16))[0]
        ex._force_path = "serial"
        want = ex.execute("i", query, slices=range(16))[0]
    finally:
        th.close()
    assert windows == [(16, True), (8, False), (8, False)]
    assert got == want > 0


def test_reference_serial_min_max_fails_at_depth_zero(bsi_results):
    """Pins the divergence recorded in ROADMAP Queue C: both paths of
    the port answer Min/Max over a depth-0 field; pilosa_tpu's serial
    path raises."""
    jax_out, port_out = bsi_results
    for q in _REF_SERIAL_FAILS:
        assert jax_out[("serial", q)][0] == "ValueError"
        assert port_out[("serial", q)] == jax_out[("batched", q)]


ERROR_QUERIES = [
    _range("nope", "> 5"),
    'Min(frame="g", field="nope")',
    _range("v", ">< [10]"),
    _range("v", '> "abc"'),
    _range("v", "> 1.5"),
    'Count(Range(frame="g", v > 5, big < 3))',
    'Count(Range(frame="nope", v > 5))',
    'Sum(frame="g")',
    'SetFieldValue(frame="g", columnID=5, v=-11)',
    'SetFieldValue(frame="g", columnID=5, v=1001)',
    'SetFieldValue(frame="g", columnID=5, v="x")',
    'SetFieldValue(frame="g", columnID=5, nope=3)',
    'SetFieldValue(frame="f", columnID=5, v=3)',
    'SetFieldValue(frame="g", v=3)',
    'SetFieldValue(frame="g", columnID=5)',
    'SetFieldValue(frame="nope", columnID=5, v=3)',
]


@pytest.mark.parametrize("path_name", ["serial", "batched"])
@pytest.mark.parametrize("query", ERROR_QUERIES)
def test_bsi_errors_match_reference(bsi_dir, query, path_name):
    path, _, _ = bsi_dir
    got = []
    for holder_cls, ex_cls, kw in ((JHolder, JExecutor, {}),
                                   (THolder, TExecutor, {"device": "cpu"})):
        h = holder_cls(path, **kw).open()
        try:
            ex = ex_cls(h)
            ex._force_path = path_name
            with pytest.raises(Exception) as info:
                ex.execute("i", query)
            got.append((type(info.value).__name__, str(info.value)))
        finally:
            h.close()
    assert got[0] == got[1]


WRITE_QUERIES = [
    'Sum(frame="g", field="v")', 'Max(frame="g", field="v")',
    'Min(frame="g", field="v")', _range("v", "> 30"),
    _range("v", "== -10"), _range("v", "!= null"),
    'Sum(frame="g", field="big")', 'Max(frame="g", field="big")',
]


def _writes(data):
    """SetFieldValue writes: a fresh column, an overwrite of an existing
    value (to a new min), a value in the missing slice (creates its
    fragment), the max, and a depth-41 value above 2^32."""
    c_old = int(data["v"][0][10])
    return [
        f'SetFieldValue(frame="g", columnID={SLICE_WIDTH + 12345}, v=1000)',
        f'SetFieldValue(frame="g", columnID={c_old}, v=-10)',
        f'SetFieldValue(frame="g", columnID='
        f'{MISSING_SLICE * SLICE_WIDTH + 5}, v=500, big={BIG})',
        f'SetFieldValue(frame="g", columnID=7, big={(1 << 35) + 3})',
    ]


@pytest.mark.parametrize("writer", ["port-serial", "port-batched",
                                    "reference"])
def test_writes_read_back_in_both_packages(tmp_path, bsi_dir, writer):
    """One package writes through SetFieldValue (after warming its
    caches), then both answer on both paths, alike."""
    import shutil

    path = str(tmp_path / "data")
    shutil.copytree(bsi_dir[0], path)
    if writer == "reference":
        h, ex = JHolder(path).open(), None
        ex = JExecutor(h)
    else:
        h = THolder(path, device="cpu").open()
        ex = TExecutor(h)
        ex._force_path = writer.split("-")[1]
    before = [ex.execute("i", q)[0] for q in WRITE_QUERIES]
    assert [ex.execute("i", w)[0] for w in _writes(bsi_dir[1])] == [None] * 4
    after = [ex.execute("i", q)[0] for q in WRITE_QUERIES]
    h.close()
    assert before != after
    for holder_cls, ex_cls, kw in ((JHolder, JExecutor, {}),
                                   (THolder, TExecutor, {"device": "cpu"})):
        out = _run_all(path, holder_cls, ex_cls, kw, WRITE_QUERIES)
        for p in ("serial", "batched"):
            assert [out[(p, q)] for q in WRITE_QUERIES] == after, p


def test_setfieldvalue_returns_none_and_rejects_before_writing(tmp_path):
    path = str(tmp_path / "d")
    h = THolder(path, device="cpu").open()
    idx = h.create_index("i")
    idx.create_frame("g", FrameOptions(range_enabled=True,
                                       fields=[Field("v", max=10)]))
    ex = TExecutor(h)
    assert ex.execute("i", 'SetFieldValue(frame="g", columnID=3, v=4)\n'
                           'SetFieldValue(frame="g", columnID=3, v=9)') \
        == [None, None]
    with pytest.raises(terr.ErrFieldValueTooHigh):
        ex.execute("i", 'SetFieldValue(frame="g", columnID=4, v=11)')
    assert idx.frame("g").field_value(3, "v") == (9, True)
    assert idx.frame("g").field_value(4, "v") == (0, False)
    assert ex.execute("i", 'Sum(frame="g", field="v")') == [SumCount(9, 1)]
    h.close()


def test_frame_import_value_round_trips_to_reference(tmp_path):
    path = str(tmp_path / "d")
    rng = np.random.default_rng(8)
    cols = rng.choice(3 * SLICE_WIDTH, 5000, replace=False)
    vals = rng.integers(-100, 100, len(cols))
    h = THolder(path, device="cpu").open()
    g = h.create_index("i").create_frame("g", FrameOptions(
        range_enabled=True, fields=[Field("v", min=-100, max=100)]))
    g.import_value("v", cols, vals)
    with pytest.raises(terr.ErrFieldValueTooLow):
        g.import_value("v", [1], [-101])
    h.close()
    jh = JHolder(path).open()
    jg = jh.index("i").frame("g")
    for c, v in zip(cols[:50], vals[:50]):
        assert jg.field_value(int(c), "v") == (int(v), True)
    ex = JExecutor(jh)
    assert ex.execute("i", 'Sum(frame="g", field="v")')[0] == (
        int(vals.sum()), len(vals))
    jh.close()


@pytest.mark.parametrize("case,exc", [
    ("fields on a frame without range", terr.ErrFrameFieldsNotAllowed),
    ("duplicate", terr.ErrFieldExists),
    ("min above max", terr.ErrInvalidFieldRange),
    ("bad type", terr.ErrInvalidFieldType),
    ("no name", terr.ErrFieldNameRequired),
    ("range with inverse", terr.ErrInverseRangeNotAllowed),
    ("range with a cache", terr.ErrRangeCacheNotAllowed),
    ("unknown field", terr.ErrFieldNotFound),
])
def test_field_schema_errors(tmp_path, case, exc):
    h = THolder(str(tmp_path / "d"), device="cpu").open()
    idx = h.create_index("i")
    g = idx.create_frame("g", FrameOptions(range_enabled=True,
                                           fields=[Field("v", max=5)]))
    with pytest.raises(exc):
        if case == "fields on a frame without range":
            idx.create_frame("f").create_field(Field("v"))
        elif case == "duplicate":
            g.create_field(Field("v"))
        elif case == "min above max":
            g.create_field(Field("w", min=3, max=2))
        elif case == "bad type":
            g.create_field(Field("w", type="float"))
        elif case == "no name":
            g.create_field(Field(""))
        elif case == "range with inverse":
            idx.create_frame("x", FrameOptions(range_enabled=True,
                                               inverse_enabled=True))
        elif case == "range with a cache":
            idx.create_frame("x", FrameOptions(range_enabled=True,
                                               cache_type="ranked"))
        else:
            g.delete_field("nope")
    h.close()


def test_field_ddl_moves_the_epoch_and_drops_the_view(tmp_path):
    h = THolder(str(tmp_path / "d"), device="cpu").open()
    idx = h.create_index("i")
    g = idx.create_frame("g", FrameOptions(range_enabled=True))
    assert g.cache_type == "none"
    e0 = idx.epoch.value
    g.create_field(Field("v", max=100))
    g.set_field_value(1, "v", 42)
    assert idx.epoch.value > e0 and "field_v" in g.views
    e1 = idx.epoch.value
    g.delete_field("v")
    assert idx.epoch.value > e1 and "field_v" not in g.views
    assert g.fields == []
    h.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_meta_with_fields_is_byte_identical(tmp_path, writer):
    """A frame's .meta with fields, written by one package, loads in
    the other with the same fields and is written back byte for byte."""
    d = str(tmp_path / "g")
    fields = [("v", -10, 1000), ("big", 0, BIG), ("z", 7, 7)]
    make = (Frame, Field) if writer == "port" else (JFrame, JField)
    other = (JFrame, JField) if writer == "port" else (Frame, Field)
    fr = make[0](d, "i", "g")
    fr.range_enabled = True
    fr.cache_type = "none"
    fr.fields = [make[1](n, min=lo, max=hi) for n, lo, hi in fields]
    fr.save_meta()
    first = open(os.path.join(d, ".meta"), "rb").read()
    back = other[0](d, "i", "g")
    back.load_meta()
    assert [f.to_dict() for f in back.fields] == [
        {"name": n, "type": "int", "min": lo, "max": hi}
        for n, lo, hi in fields]
    assert back.range_enabled and back.field("big").bit_depth() == 41
    back.save_meta()
    assert open(os.path.join(d, ".meta"), "rb").read() == first
