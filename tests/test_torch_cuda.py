"""The CUDA kernels on the card: each held exactly against its plain
version on the same device tensors (the coalescer's ``count_op_pairs``
and ``count_and_rows_multi`` too), ``count_op_rows``/``count_rows`` and
``count_and_rows`` in each regime of their launch shapes at its edges;
the executor's Count, TopN, BSI,
time Range and bitmap-result paths and the coalescer's fused Count,
Sum and Max groups on a GPU holder, and the HTTP
``Server`` on the card, against the same directory served on the CPU;
and ``Bitmap.columns()`` on the card
against a host unpacking of the same words. Marked
``cuda``; where no GPU is present every test skips (decided inside the
fixture, never at import). Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``. The container
tier's lane kernel ``container_and_counts`` is held against its plain
version in every cell at its boundary shapes (N = 1 to 76,296 members).
The ingest classify kernel ``ingest_classify`` is held against its plain
version on phase 3's streams, and one small ingest through a GPU holder
gives the files of the same ingest on the CPU. A two-node cluster on the
card answers as the same cluster on the CPU."""
import json
import os
import re
from collections import Counter
from datetime import datetime

import numpy as np
import pytest
import torch

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.bitmap import Bitmap
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.storage.frame import Field
from pilosa_tpu_torch.storage.holder import Holder
from pilosa_tpu_torch.storage.index import FrameOptions

pytestmark = pytest.mark.cuda

OPS = ("and", "or", "xor", "andnot")
# The kernels a single query launches; coalesced groups add the others.
QUERY_KERNELS = ("count_op_rows", "count_rows", "count_and_rows")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(7)


def _rand(gen, *shape):
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                         device="cuda", generator=gen)


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (1, 192), (7, 32767),
                                   (64, 32768), (33,), (5, 0)])
@pytest.mark.parametrize("op", OPS)
def test_count_op_rows_equals_plain(gen, shape, op):
    a, b = _rand(gen, *shape), _rand(gen, *shape)
    assert torch.equal(kernels.count_op_rows(a, b, op),
                       kernels.count_op_rows_plain(a, b, op))


@pytest.mark.parametrize("fill", [0, -1, -2**31, None])
def test_count_rows_equals_plain(gen, fill):
    m = (_rand(gen, 7, 4097) if fill is None
         else torch.full((7, 4097), fill, dtype=torch.int32, device="cuda"))
    assert torch.equal(kernels.count_rows(m), kernels.count_rows_plain(m))


def test_misaligned_operands(gen):
    base = _rand(gen, 7 * 100 + 3)
    a = base[1:701].view(7, 100)   # 4-byte offset from 16-byte alignment
    b = base[3:703].view(7, 100)   # a different offset again
    for op in OPS:
        assert torch.equal(kernels.count_op_rows(a, b, op),
                           kernels.count_op_rows_plain(a, b, op))


@pytest.mark.parametrize("width", [1, 3, 192, 32767, 32768])
@pytest.mark.parametrize("rows", [1, 7, 8, 1000])
def test_count_and_rows_equals_plain(gen, rows, width):
    m, f = _rand(gen, rows, width), _rand(gen, width)
    assert torch.equal(kernels.count_and_rows(m, f),
                       kernels.count_and_rows_plain(m, f))


@pytest.mark.parametrize("width", [128, 512, 2048, 8192, 32768])
def test_kernels_at_every_window_bucket(gen, width):
    """The batched plans' stack widths: every kernel against its plain
    version at [S, W] for each power-of-four bucket."""
    a, b = _rand(gen, 37, width), _rand(gen, 37, width)
    for op in OPS:
        assert torch.equal(kernels.count_op_rows(a, b, op),
                           kernels.count_op_rows_plain(a, b, op))
    assert torch.equal(kernels.count_rows(a), kernels.count_rows_plain(a))
    rows = [_rand(gen, 37, width) for _ in range(9)]
    assert torch.equal(kernels.count_and_rows_stacks(rows, a),
                       kernels.count_and_rows_stacks_plain(rows, a))


@pytest.mark.parametrize("rows", [1, 9, 70_000, 524_288])
def test_count_and_rows_fragment_form_is_one_launch(gen, rows):
    """The strided fragment form: any row count in one launch, past the
    65,535-block limit of a grid dimension, exact against the plain
    version."""
    m, f = _rand(gen, rows, 128), _rand(gen, 128)
    kernels.reset_launches()
    got = kernels.count_and_rows(m, f)
    assert kernels.launches["count_and_rows"] == 1
    assert torch.equal(got, kernels.count_and_rows_plain(m, f))


@pytest.mark.parametrize("n_rows", [0, 1, 8, 9, 10, 11, 300])
@pytest.mark.parametrize("shape", [(1, 32768), (5, 4097), (64, 32768)])
def test_count_and_rows_stacks_equals_plain(gen, n_rows, shape):
    rows = [_rand(gen, *shape) for _ in range(n_rows)]
    f = _rand(gen, *shape)
    assert torch.equal(kernels.count_and_rows_stacks(rows, f),
                       kernels.count_and_rows_stacks_plain(rows, f))


@pytest.mark.parametrize("fill", [0, -1, -2**31])
def test_count_and_rows_edge_words(gen, fill):
    m = torch.full((9, 4099), fill, dtype=torch.int32, device="cuda")
    f = _rand(gen, 4099)
    assert torch.equal(kernels.count_and_rows(m, f),
                       kernels.count_and_rows_plain(m, f))
    assert torch.equal(kernels.count_and_rows(f[None].repeat(3, 1), m[0]),
                       kernels.count_and_rows_plain(f[None].repeat(3, 1),
                                                    m[0]))


def test_count_and_rows_misaligned(gen):
    base = _rand(gen, 4009)
    m = base[1:3001].view(3, 1000)   # one word off 16-byte alignment
    f = base[3002:4002]
    assert torch.equal(kernels.count_and_rows(m, f),
                       kernels.count_and_rows_plain(m, f))
    rows = [base[1:2001].view(2, 1000), base[4:2004].view(2, 1000)]
    filt = base[2005:4005].view(2, 1000)
    assert torch.equal(kernels.count_and_rows_stacks(rows, filt),
                       kernels.count_and_rows_stacks_plain(rows, filt))


def test_launch_counters_count_launches_only(gen):
    kernels.reset_launches()
    a = _rand(gen, 3, 64)
    kernels.count_rows(a)
    kernels.count_op_rows(a, a, "and")
    kernels.count_rows(a[:0])  # no rows: nothing launches
    kernels.count_and_rows(a, a[0])
    kernels.count_and_rows(a[:0], a[0])
    kernels.count_and_rows_stacks([], a)
    kernels.count_and_rows_stacks([a[:0]], a[:0])
    kernels.count_op_pairs([a[:0]], [a[:0]], "and")
    kernels.count_and_rows_multi([a], [])
    pos = torch.tensor([3, 31], dtype=torch.int32, device="cuda")
    none = torch.zeros(1, dtype=torch.int32, device="cuda")
    kernels.container_and_counts("array_array", (pos, none), (pos, none))
    offs = torch.tensor([0, 2], dtype=torch.int32, device="cuda")
    kernels.container_and_counts("array_array", (pos, offs), (pos, offs))
    assert kernels.launches == {"count_op_rows": 1, "count_rows": 1,
                                "count_and_rows": 1, "count_op_pairs": 0,
                                "count_and_rows_multi": 0,
                                "container_and_counts": 1,
                                "ingest_classify": 0}


def test_regime_launches_split_the_launch_counts(gen):
    kernels.reset_launches()
    shapes = [(3000, 64), (1, 32768), (600, 4096), (32768,)]
    for shape in shapes:
        a = _rand(gen, *shape)
        kernels.count_rows(a)
        kernels.count_op_rows(a, a, "or")
        if a.dim() == 2:
            kernels.count_and_rows(a, a[0])
    for name, split in kernels.regime_launches.items():
        assert sum(split.values()) == kernels.launches[name]
    op_want = Counter(kernels.regime("count_rows", 1 if len(s) == 1
                                     else s[0], s[-1]) for s in shapes)
    car_want = Counter(kernels.regime("count_and_rows", s[0], s[1])
                       for s in shapes if len(s) == 2)
    for name, want in (("count_rows", op_want), ("count_op_rows", op_want),
                       ("count_and_rows", car_want)):
        assert kernels.regime_launches[name] == {
            r: want[r] for r in kernels.REGIMES}
    assert set(op_want) == set(kernels.REGIMES)
    kernels.reset_launches()
    assert all(n == 0 for split in kernels.regime_launches.values()
               for n in split.values())


# Sizes at the regime thresholds of csrc/popcount.cu and
# csrc/count_and_rows.cu, named here and read from the built libraries
# (kernels.thresholds()) on the card: "op_split_rows-1" is one row below
# count_op_rows's split threshold. Each case below must take the regime
# the source names for its shape (kernels.regime).
_EDGES = {
    "op_narrow_max": lambda t: t["count_op_rows"]["narrow_max_words"],
    "op_split_min": lambda t: t["count_op_rows"]["split_min_words"],
    "op_split_rows": lambda t: t["count_op_rows"]["split_rows"],
    "op_narrow_min": lambda t: t["count_op_rows"]["narrow_min_rows"],
    "car_narrow_max": lambda t: t["count_and_rows"]["narrow_max_words"],
    "car_narrow_min": lambda t: t["count_and_rows"]["narrow_min_rows"],
    "car_split_min": lambda t: t["count_and_rows"]["split_min_words"],
    "car_split_items": lambda t: t["count_and_rows"]["split_items"],
    # The most rows of one slice that still split.
    "car_split_rows": lambda t: (t["count_and_rows"]["split_items"] - 1)
    * t["count_and_rows"]["rows_per_item"],
}


def _at(size):
    """An int, or a threshold named in _EDGES with an offset."""
    if isinstance(size, int):
        return size
    name, off = re.fullmatch(r"(\w+?)([+-]\d+)?", size).groups()
    return _EDGES[name](kernels.thresholds()) + int(off or 0)


def _took(name, fn):
    """fn()'s result and the regimes its launches of ``name`` took."""
    before = dict(kernels.regime_launches[name])
    got = fn()
    return got, {r for r, n in kernels.regime_launches[name].items()
                 if n > before[r]}


def _check_op_kernels(a, b):
    rows = 1 if a.dim() == 1 else a.shape[0]
    want = {kernels.regime("count_op_rows", rows, a.shape[-1])}
    for op in OPS:
        got, took = _took("count_op_rows",
                          lambda: kernels.count_op_rows(a, b, op))
        assert took == want
        assert torch.equal(got, kernels.count_op_rows_plain(a, b, op))
    got, took = _took("count_rows", lambda: kernels.count_rows(a))
    assert took == want
    assert torch.equal(got, kernels.count_rows_plain(a))


def _check_fragment_form(m, f):
    got, took = _took("count_and_rows", lambda: kernels.count_and_rows(m, f))
    assert took == {kernels.regime("count_and_rows", m.shape[0], m.shape[1])}
    assert torch.equal(got, kernels.count_and_rows_plain(m, f))


def _check_stacked_form(rows, f):
    got, took = _took("count_and_rows",
                      lambda: kernels.count_and_rows_stacks(rows, f))
    assert took == {kernels.regime("count_and_rows",
                                   min(kernels.CAR_MAX_ROWS, len(rows) - r0),
                                   f.shape[1], f.shape[0])
                    for r0 in range(0, len(rows), kernels.CAR_MAX_ROWS)}
    assert torch.equal(got, kernels.count_and_rows_stacks_plain(rows, f))


EDGE_WIDTHS = (1, 3, 4, 5, 127, 128, 129, "op_narrow_max-1", "op_narrow_max",
               "op_narrow_max+1", "car_narrow_max-1", "car_narrow_max",
               "car_narrow_max+1", 2047, 2048, 2049, "car_split_min",
               "car_split_min+1", "op_split_min", "op_split_min+1", 32768)
EDGE_ROWS = (1, 2, 7, 8, 9, 11, "op_split_rows-1", "op_split_rows",
             "op_narrow_min-1", "op_narrow_min")


@pytest.mark.parametrize("width", EDGE_WIDTHS)
@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_count_op_rows_regimes_at_edges(gen, rows, width):
    rows, width = _at(rows), _at(width)
    _check_op_kernels(_rand(gen, rows, width), _rand(gen, rows, width))


@pytest.mark.parametrize("width", EDGE_WIDTHS)
def test_count_op_rows_one_dim_rows(gen, width):
    """The serial path's 1-D slice segments: one row a launch."""
    width = _at(width)
    _check_op_kernels(_rand(gen, width), _rand(gen, width))


@pytest.mark.parametrize("width", [1, 5, 128, 129, 513, 2049])
def test_count_kernels_at_262144_rows(gen, width):
    a, b = _rand(gen, 262_144, width), _rand(gen, 262_144, width)
    _check_op_kernels(a, b)
    _check_fragment_form(a, b[0])


@pytest.mark.parametrize("width", EDGE_WIDTHS)
@pytest.mark.parametrize("rows", EDGE_ROWS + (
    "car_narrow_min-1", "car_narrow_min", "car_split_rows",
    "car_split_rows+1", 9537))
def test_count_and_rows_fragment_regimes_at_edges(gen, rows, width):
    rows, width = _at(rows), _at(width)
    _check_fragment_form(_rand(gen, rows, width), _rand(gen, width))


@pytest.mark.parametrize("n_rows,slices,width", [
    (8, "car_split_items-1", 4096), (8, "car_split_items", 4096),
    (9, 2000, "car_narrow_max"), (9, 2000, "car_narrow_max+1"),
    (11, 1, 32768), (1, "car_split_items-1", "car_split_min+1"),
    (1, "car_split_items", "car_split_min+1"), (8, 4, "car_split_min"),
    (8, 4, "car_split_min+1"), (1, "car_narrow_min-1", 128),
    (1, "car_narrow_min", 128), (300, 3, 128), (300, 1, 32768),
    (300, 30, 4096)])
def test_count_and_rows_stacked_regimes_at_edges(gen, n_rows, slices,
                                                 width):
    """Both sides of the split threshold, and past one parameter table
    of 256 rows (two launches, which may take two regimes)."""
    slices, width = _at(slices), _at(width)
    _check_stacked_form([_rand(gen, slices, width) for _ in range(n_rows)],
                        _rand(gen, slices, width))


@pytest.mark.parametrize("rows,width", [(9, 128), (7, 130), (9000, 130),
                                        (1, 32768), (300, 4096),
                                        (2105, 1025)])
def test_regimes_with_one_operand_off_alignment(gen, rows, width):
    def off(k):
        return _rand(gen, rows * width + k)[k:].view(rows, width)

    _check_op_kernels(off(1), _rand(gen, rows, width))
    _check_op_kernels(_rand(gen, rows, width), off(2))
    _check_fragment_form(off(1), _rand(gen, width))
    _check_fragment_form(_rand(gen, rows, width),
                         _rand(gen, width + 3)[3:])
    _check_stacked_form([off(k % 4) for k in range(9)],
                        _rand(gen, rows, width))


@pytest.mark.parametrize("rows,width", [(9, 128), (5000, 128), (1, 32768),
                                        (300, 4096), (2105, 1025),
                                        (11, 32768)])
@pytest.mark.parametrize("fill", [-2**31, -1])
def test_regimes_bit31_and_all_ones(gen, fill, rows, width):
    """Bit 31 (the sign bit of the int32 words) and all-ones rows, whose
    counts reach 32·W, in every regime."""
    m = torch.full((rows, width), fill, dtype=torch.int32, device="cuda")
    ones = torch.full((width,), -1, dtype=torch.int32, device="cuda")
    _check_op_kernels(m, _rand(gen, rows, width))
    _check_fragment_form(m, ones)
    _check_stacked_form([m, m], ones.expand(rows, width).contiguous())
    if fill == -1:
        assert bool((kernels.count_rows(m) == 32 * width).all())
        assert bool((kernels.count_and_rows(m, ones) == 32 * width).all())


def test_executor_on_gpu_matches_cpu(gen, tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    view = h.create_index("i").create_frame("f").create_view_if_not_exists(
        "standard")
    for s in (0, 2, 3):
        cols = rng.integers(0, SLICE_WIDTH, 300000) + s * SLICE_WIDTH
        rows = rng.integers(0, 3, len(cols))
        view.create_fragment_if_not_exists(s).import_bits(rows, cols)
    h.close()
    queries = [
        'Count(Bitmap(frame="f", rowID=0))',
        'Count(Intersect(Bitmap(frame="f", rowID=0), '
        'Bitmap(frame="f", rowID=1)))',
        'Count(Xor(Bitmap(frame="f", rowID=2), Union('
        'Bitmap(frame="f", rowID=0), Bitmap(frame="f", rowID=1))))',
    ]
    results = {}
    for device in ("cpu", "cuda"):
        h = Holder(path, device=device).open()
        ex = Executor(h)
        kernels.reset_launches()
        for p in ("serial", "batched"):
            ex._force_path = p
            results[(device, p)] = [ex.execute("i", q)[0] for q in queries]
        if device == "cuda":
            assert kernels.launches["count_rows"] > 0
            assert kernels.launches["count_op_rows"] > 0
        h.close()
    assert len(set(map(tuple, results.values()))) == 1


def test_topn_on_gpu_matches_cpu(gen, tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    idx = h.create_index("i")
    for name, n_rows in (("f", 2), ("t", 6)):
        view = idx.create_frame(name).create_view_if_not_exists("standard")
        for s in (0, 1, 3):
            cols = rng.integers(0, SLICE_WIDTH, 200000) + s * SLICE_WIDTH
            rows = rng.integers(0, n_rows, len(cols))
            view.create_fragment_if_not_exists(s).import_bits(rows, cols)
    h.close()
    src = 'Bitmap(frame="f", rowID=0)'
    queries = [f'TopN({src}, frame="t", n=3)', 'TopN(frame="t", n=2)',
               f'TopN({src}, frame="t", tanimotoThreshold=20)',
               f'TopN({src}, frame="t", ids=[1, 4], threshold=10)']
    results = {}
    for device in ("cpu", "cuda"):
        h = Holder(path, device=device).open()
        ex = Executor(h)
        kernels.reset_launches()
        for p in ("serial", "batched"):
            ex._force_path = p
            results[(device, p)] = [ex.execute("i", q)[0] for q in queries]
        if device == "cuda":
            assert kernels.launches["count_and_rows"] > 0
        h.close()
    assert len({repr(v) for v in results.values()}) == 1


def test_bsi_on_gpu_matches_cpu(gen, tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    idx = h.create_index("i")
    view = idx.create_frame("f").create_view_if_not_exists("standard")
    g = idx.create_frame("g", FrameOptions(range_enabled=True, fields=[
        Field("v", min=-5, max=1000), Field("big", max=1 << 40)]))
    for s in (0, 1, 3):
        cols = rng.choice(SLICE_WIDTH, 200000, replace=False) + s * SLICE_WIDTH
        g.import_value("v", cols, rng.integers(-5, 1001, len(cols)))
        g.import_value("big", cols[:5000], rng.integers(0, 1 << 40, 5000))
        view.create_fragment_if_not_exists(s).import_bits(
            rng.integers(0, 2, 300000),
            rng.integers(0, SLICE_WIDTH, 300000) + s * SLICE_WIDTH)
    h.close()
    src = 'Bitmap(frame="f", rowID=0)'
    queries = ['Sum(frame="g", field="v")', f'Sum({src}, frame="g", field="v")',
               'Count(Range(frame="g", v > 30))',
               'Count(Range(frame="g", v >< [10, 60]))',
               f'Count(Intersect({src}, Range(frame="g", v >= 500)))',
               'Min(frame="g", field="v")', 'Max(frame="g", field="v")',
               f'Max({src}, frame="g", field="v")',
               'Sum(frame="g", field="big")',
               'Count(Range(frame="g", big > 4294967296))']
    results = {}
    for device in ("cpu", "cuda"):
        h = Holder(path, device=device).open()
        ex = Executor(h)
        kernels.reset_launches()
        for p in ("serial", "batched"):
            ex._force_path = p
            results[(device, p)] = [ex.execute("i", q)[0] for q in queries]
        if device == "cuda":
            assert all(kernels.launches[k] for k in QUERY_KERNELS), \
                kernels.launches
        h.close()
    assert len({repr(v) for v in results.values()}) == 1


@pytest.mark.parametrize("k", [1, 9, 257])
@pytest.mark.parametrize("shape", [(1, 1), (7, 127), (5, 4097), (3, 32768)])
@pytest.mark.parametrize("op", (None,) + OPS)
def test_count_op_pairs_equals_plain(gen, k, shape, op):
    a = [_rand(gen, *shape) for _ in range(k)]
    b = [_rand(gen, *shape) for _ in range(k)]
    before = kernels.launches["count_op_pairs"]
    got = kernels.count_op_pairs(a, b, op)
    assert kernels.launches["count_op_pairs"] - before == (2 if k > 256
                                                           else 1)
    assert torch.equal(got, kernels.count_op_pairs_plain(a, b, op))


def test_count_op_pairs_misaligned_and_edge_words(gen):
    base = _rand(gen, 4 * 3 * 1001 + 8)
    a = [base[i * 3003 + 1 + i:(i + 1) * 3003 + 1 + i].view(3, 1001)
         for i in range(4)]
    b = [torch.full((3, 1001), f, dtype=torch.int32, device="cuda")
         for f in (0, -1, -2**31, 5)]
    for op in OPS:
        assert torch.equal(kernels.count_op_pairs(a, b, op),
                           kernels.count_op_pairs_plain(a, b, op))


@pytest.mark.parametrize("n_rows,n_filt", [(1, 1), (11, 8), (5, 300),
                                           (200, 3)])
@pytest.mark.parametrize("shape", [(1, 32768), (4, 4097), (9, 128)])
def test_count_and_rows_multi_equals_plain(gen, n_rows, n_filt, shape):
    rows = [_rand(gen, *shape) for _ in range(n_rows)]
    filts = [_rand(gen, *shape) for _ in range(n_filt)]
    got = kernels.count_and_rows_multi(rows, filts)
    assert got.shape == (n_filt, n_rows, shape[0])
    assert torch.equal(got, kernels.count_and_rows_multi_plain(rows, filts))


def test_count_and_rows_multi_misaligned(gen):
    base = _rand(gen, 6 * 2 * 999 + 8)
    stk = [base[i * 1998 + i:(i + 1) * 1998 + i].view(2, 999)
           for i in range(6)]
    assert torch.equal(kernels.count_and_rows_multi(stk[:4], stk[4:]),
                       kernels.count_and_rows_multi_plain(stk[:4], stk[4:]))


def test_fused_groups_on_gpu_match_cpu(gen, tmp_path):
    """Concurrent Counts, Sums and Max under a Barrier form one group
    each on a GPU holder (the coalescer is on by default there) and
    launch the group kernels; answers equal the CPU holder's."""
    import threading

    rng = np.random.default_rng(11)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    idx = h.create_index("i")
    f = idx.create_frame("f")
    g = idx.create_frame("g", FrameOptions(range_enabled=True, fields=[
        Field("v", min=0, max=1000)]))
    for s in range(4):
        for r in range(4):
            cols = rng.choice(SLICE_WIDTH, 50000, replace=False)
            f.import_bits([r] * len(cols), (cols + s * SLICE_WIDTH).tolist())
        cols = rng.choice(SLICE_WIDTH, 80000, replace=False)
        g.import_value("v", (cols + s * SLICE_WIDTH).tolist(),
                       rng.integers(0, 1001, len(cols)).tolist())
    h.close()
    row = 'Bitmap(frame="f", rowID={})'.format
    pairs = [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)]
    groups = [
        [f"Count(Intersect({row(a)}, {row(b)}))" for a, b in pairs],
        [f"Count(Xor({row(a)}, {row(b)}))" for a, b in pairs],
        [f'Sum(Union({row(a)}, {row(b)}), frame="g", field="v")'
         for a, b in pairs],
        [f'Max(Union({row(a)}, {row(b)}), frame="g", field="v")'
         for a, b in pairs],
    ]
    answers = {}
    for device in ("cpu", "cuda"):
        h = Holder(path, device=device).open()
        ex = Executor(h)
        ex._result_memo_off = True
        kernels.reset_launches()
        got = []
        for queries in groups:
            ex.set_coalesce_config(max_wait_us=10_000_000,
                                   max_group=len(queries))
            out = [None] * len(queries)
            barrier = threading.Barrier(len(queries))

            def run(i, q):
                barrier.wait(timeout=30)
                out[i] = ex.execute("i", q)[0]

            threads = [threading.Thread(target=run, args=(i, q))
                       for i, q in enumerate(queries)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            got.append(out)
        answers[device] = got
        if device == "cuda":
            st = ex.coalesce_snapshot()
            assert st["enabled"] and st["max_group"] == 6, st
            assert kernels.launches["count_op_pairs"] > 0, kernels.launches
            assert kernels.launches["count_and_rows_multi"] == 1
        h.close()
    assert answers["cuda"] == answers["cpu"]


def _host_columns(words, slice_ids):
    """Ascending ids of the set bits of host int32[R, W] rows."""
    out = [np.flatnonzero(np.unpackbits(w.view(np.uint8), bitorder="little"))
           .astype(np.uint64) + np.uint64(s * SLICE_WIDTH)
           for w, s in zip(words, slice_ids)]
    return np.concatenate(out) if out else np.empty(0, np.uint64)


@pytest.mark.parametrize("kind", ["sparse", "dense", "bit31", "zeros"])
def test_columns_on_gpu_match_host(gen, kind):
    """columns() finds the set bits on the card: a deferred stack read
    whole and the same rows as split segments, against numpy's unpacking
    of the same words (bit j of an int32 word is column 32·w + j)."""
    r = _rand(gen, 300, 32768)
    if kind == "sparse":
        for _ in range(8):
            r &= _rand(gen, 300, 32768)
    elif kind == "bit31":
        r = (r & _rand(gen, 300, 32768) & _rand(gen, 300, 32768)) | (-2**31)
    elif kind == "zeros":
        r = torch.zeros_like(r)
    r[7] = 0                      # an empty slice inside the stack
    slice_ids = list(range(0, 600, 2))
    want = _host_columns(r.cpu().numpy(), slice_ids)
    counts = kernels.count_rows(r).cpu().numpy()
    bm = Bitmap()
    bm.defer_stack(r, slice_ids, counts)
    assert bm.count() == len(want)
    assert np.array_equal(bm.columns(), want)
    _ = bm.segments               # split into per-slice views
    assert np.array_equal(bm.columns(), want)
    cpu = Bitmap()
    cpu.defer_stack(r.cpu(), slice_ids, counts)
    assert np.array_equal(cpu.columns(), want)


def test_results_and_time_on_gpu_match_cpu(gen, tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    idx = h.create_index("i")
    f = idx.create_frame("f")
    c = idx.create_frame("c", FrameOptions(time_quantum="YMD"))
    for s in (0, 1, 3):
        cols = rng.integers(0, SLICE_WIDTH, 200000) + s * SLICE_WIDTH
        f.import_bits(rng.integers(0, 3, len(cols)), cols)
        days = rng.integers(1, 15, 50000)
        c.import_bits(rng.integers(0, 2, 50000), cols[:50000],
                      [datetime(2017, 6, int(d)) for d in days])
    h.close()
    rng_q = ('Range(frame="c", rowID=1, start="2017-06-01T00:00", '
             'end="2017-06-15T00:00")')
    queries = ['Bitmap(frame="f", rowID=2)',
               'Intersect(Bitmap(frame="f", rowID=0), '
               'Bitmap(frame="f", rowID=1))',
               'Xor(Bitmap(frame="f", rowID=2), Bitmap(frame="f", rowID=1))',
               rng_q, f"Count({rng_q})",
               f'Count(Intersect({rng_q}, Bitmap(frame="f", rowID=0)))',
               'Count(Range(frame="c", rowID=0, start="2017-06-01T00:00", '
               'end="2017-07-01T00:00"))']
    results = {}
    for device in ("cpu", "cuda"):
        h = Holder(path, device=device).open()
        ex = Executor(h)
        kernels.reset_launches()
        for p in ("serial", "batched"):
            ex._force_path = p
            results[(device, p)] = [
                r if isinstance(r, int) else r.columns().tolist()
                for r in (ex.execute("i", q)[0] for q in queries)]
        if device == "cuda":
            assert kernels.launches["count_rows"] > 0
            assert kernels.launches["count_op_rows"] > 0
        h.close()
    assert len({repr(v) for v in results.values()}) == 1


def test_server_on_gpu_matches_cpu(gen, tmp_path):
    """The in-process Server on the card answers a Count, a TopN and a
    bitmap read, in JSON and protobuf, with the bytes the same Server on
    the CPU answers over the same data, through all three kernels."""
    import urllib.request

    from pilosa_tpu_torch.server.server import Server

    rng = np.random.default_rng(6)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    view = h.create_index("i").create_frame("f").create_view_if_not_exists(
        "standard")
    for s in (0, 1, 3):
        cols = rng.integers(0, SLICE_WIDTH, 200000) + s * SLICE_WIDTH
        view.create_fragment_if_not_exists(s).import_bits(
            rng.integers(0, 4, len(cols)), cols)
    h.close()
    queries = ['Count(Intersect(Bitmap(frame="f", rowID=0), '
               'Bitmap(frame="f", rowID=1)))',
               'TopN(Bitmap(frame="f", rowID=0), frame="f", n=3)',
               'Intersect(Bitmap(frame="f", rowID=3), '
               'Bitmap(frame="f", rowID=2))']
    answers = {}
    for device in ("cpu", "cuda"):
        s = Server(path, bind="127.0.0.1:0", device=device).open()
        kernels.reset_launches()
        try:
            got = []
            for q in queries:
                for ctype in ("text/plain", "application/x-protobuf"):
                    req = urllib.request.Request(
                        f"http://{s.host}/index/i/query", data=q.encode(),
                        method="POST", headers={"Accept": ctype})
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        got.append((resp.status, resp.read()))
            answers[device] = got
            if device == "cuda":
                assert all(kernels.launches[k] for k in QUERY_KERNELS), \
                    kernels.launches
        finally:
            s.close()
    assert answers["cuda"] == answers["cpu"]
    assert json.loads(answers["cpu"][0][1])["results"][0] > 0


def test_cluster_on_gpu_matches_cpu(gen, tmp_path):
    """A two-node cluster (replicas 1) on the card and one on the CPU get
    the same writes through both nodes; every query through either node
    answers the same bytes, and the card's local legs launch all three
    kernels."""
    import socket
    import urllib.request

    from pilosa_tpu_torch.server.server import Server

    def http(host, body, path="/index/i/query"):
        req = urllib.request.Request(f"http://{host}{path}", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()

    rng = np.random.default_rng(13)
    writes = [f'SetBit(frame="f", rowID={r}, columnID={c})'
              for r, c in zip(rng.integers(0, 4, 400),
                              rng.integers(0, 6 * SLICE_WIDTH, 400))]
    queries = ['Count(Intersect(Bitmap(frame="f", rowID=0), '
               'Bitmap(frame="f", rowID=1)))',
               'Count(Bitmap(frame="f", rowID=2))',
               'TopN(Bitmap(frame="f", rowID=0), frame="f", n=3)',
               'TopN(frame="f", n=2)',
               'Union(Bitmap(frame="f", rowID=3), Bitmap(frame="f", rowID=2))']
    answers = {}
    for device in ("cpu", "cuda"):
        socks = [socket.socket() for _ in range(2)]
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        hosts = [f"127.0.0.1:{sk.getsockname()[1]}" for sk in socks]
        for sk in socks:
            sk.close()
        nodes = [Server(str(tmp_path / f"{device}{k}"), bind=hosts[k],
                        cluster_hosts=hosts, device=device,
                        polling_interval=0).open() for k in range(2)]
        try:
            for n in nodes:
                n.cluster.node_set.close()
            http(hosts[0], b"{}", "/index/i")
            http(hosts[1], b"{}", "/index/i/frame/f")
            got = [http(hosts[k % 2], w.encode())
                   for k, w in enumerate(writes)]
            kernels.reset_launches()
            got += [http(h, q.encode()) for q in queries for h in hosts]
            answers[device] = got
            if device == "cuda":
                assert all(kernels.launches[k] for k in QUERY_KERNELS), \
                    kernels.launches
        finally:
            for n in nodes:
                n.close()
    assert answers["cuda"] == answers["cpu"]


def test_windows_and_cold_reads_on_gpu_match_cpu(gen, tmp_path,
                                                 monkeypatch):
    """A narrow, row-heavy frame (a 128-word window) written on the CPU,
    reopened on the GPU under a host budget: cold batched reads build
    CUDA stacks at the window without a fault-in, and Count, TopN with a
    Tanimoto threshold and a bitmap result answer as on the CPU. The
    container tier is off: with it on, these sparse cold rows would serve
    the Count and the bitmap result serially from compressed containers
    (test_compressed_tier_on_gpu_matches_cpu covers that route)."""
    from pilosa_tpu_torch.ops import containers

    monkeypatch.setattr(containers, "_ENABLED", False)
    rng = np.random.default_rng(3)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    fr = h.create_index("i").create_frame("f", FrameOptions(cache_size=5000))
    rows = np.repeat(np.arange(3000), 40)
    cols = rng.integers(0, 4096, len(rows)) + (rows % 2) * SLICE_WIDTH
    fr.import_bits(rows.tolist(), cols.tolist())
    h.close()
    queries = ['Count(Intersect(Bitmap(frame="f", rowID=7), '
               'Bitmap(frame="f", rowID=9)))',
               'TopN(Bitmap(frame="f", rowID=7), frame="f", n=5, '
               'tanimotoThreshold=5)',
               'TopN(frame="f", n=5)',
               'Union(Bitmap(frame="f", rowID=7), Bitmap(frame="f", '
               'rowID=8))']

    def run(device, **kw):
        hh = Holder(path, device=device, **kw).open()
        ex = Executor(hh)
        out = {}
        for p in ("batched", "serial"):
            ex._force_path = p
            for q in queries:
                v = ex.execute("i", q)[0]
                out[(p, q)] = v.columns().tolist() if hasattr(
                    v, "columns") else v
            if p == "batched":
                with ex._cache_mu:
                    stacks = [e[2] for e in ex._stack_cache.values()]
                assert stacks and all(st.device.type == device and
                                      st.shape[1] == 128 for st in stacks)
        out["faults"] = hh.governor.faults
        hh.close()
        return out

    kernels.reset_launches()
    got = run("cuda", host_bytes=1 << 20)
    assert all(kernels.launches[k] for k in QUERY_KERNELS)
    want = run("cpu")
    assert got.pop("faults") > 0 and {k: v for k, v in got.items()} == {
        k: v for k, v in want.items() if k != "faults"}


# ------------------------------------------------ container_and_counts

def _cont_side(fmt, n, seed, big=False):
    """n members of one side at full slice width on the card, cycling
    through the boundary cases of ``fmt`` (for ``big`` lanes, among 64
    rows of 500 spread bits): arrays of 0, 1 (bit 31; the last bit),
    700, 4,096 positions and 4,096 bit-31 positions; runs of 2,048 runs,
    one run over the whole row, one across words, none, 2,000 bits;
    dense rows of 4,097 bits, all ones, bit 31 of every word, random,
    zeros. Members share their case's payload. Returns (containers,
    packed side)."""
    from pilosa_tpu_torch.ops import containers as C

    rng = np.random.default_rng(seed)
    limit, w32 = SLICE_WIDTH, SLICE_WIDTH // 32

    def spread(k):
        return np.sort(rng.choice(limit, k, replace=False)).astype(np.int32)

    if fmt == "array":
        cases = [np.zeros(0, np.int32), np.array([31], np.int32),
                 np.array([limit - 1], np.int32), spread(700), spread(4096),
                 np.arange(31, limit, 32, dtype=np.int32)[:4096]]
        if big:
            cases += [spread(500) for _ in range(64)]
        conts = [C.Container("array", w32, len(p), positions=p,
                             device="cuda")
                 for p in (cases[i % len(cases)] for i in range(n))]
        return conts, C.stack_positions(conts)
    if fmt == "run":
        start = int(rng.integers(0, limit - 3000))
        cases = [np.stack([np.arange(2048) * 6, np.arange(2048) * 6 + 3],
                          axis=1), np.array([[0, limit]]),
                 np.array([[30, 70]]), np.zeros((0, 2)),
                 np.array([[start, start + 2000]])]
        cases = [c.astype(np.int32) for c in cases]
        # A big lane's members cover the whole row once, not a fifth of
        # the time (the plain version expands every covered word).
        pick = [cases[i % len(cases)] if not big or i < len(cases)
                else cases[4] for i in range(n)]
        conts = [C.Container("run", w32, int((r[:, 1] - r[:, 0]).sum()),
                             runs=r, device="cuda") for r in pick]
        return conts, C.stack_runs(conts)
    bits4097 = np.zeros(limit, np.uint8)
    bits4097[rng.choice(limit, 4097, replace=False)] = 1
    rows = [np.packbits(bits4097, bitorder="little").view(np.uint64),
            np.full(limit // 64, np.uint64(2**64 - 1)),
            np.full(limit // 64, np.uint64(0x8000000080000000)),
            rng.integers(0, 2**64, limit // 64, dtype=np.uint64),
            np.zeros(limit // 64, np.uint64)]
    rows = [torch.from_numpy(r.view(np.int32).copy()).cuda() for r in rows]
    conts = [C.dense_container(rows[i % len(rows)], w32, 0)
             for i in range(n)]
    return conts, [c.dense_words() for c in conts]


@pytest.mark.parametrize("n", [1, 7, 76_296])
@pytest.mark.parametrize("cell", ["array_array", "array_run", "array_dense",
                                  "run_dense"])
def test_container_and_counts_equals_plain(gen, cell, n):
    fa, fb = cell.split("_")
    big = n > 1000
    _, a = _cont_side(fa, n, 1, big)
    _, b = _cont_side(fb, n, 2, big)
    kernels.reset_launches()
    got = kernels.container_and_counts(cell, a, b)
    assert kernels.launches["container_and_counts"] == 1
    assert torch.equal(got, kernels.container_and_counts_plain(cell, a, b))
    if fb == "dense":  # one stacked [N, W] tensor instead of a table
        rows = torch.stack(list(b))
        assert torch.equal(kernels.container_and_counts(cell, a, rows), got)


def test_container_and_counts_rejects_cpu_device_mix(gen):
    pos = torch.tensor([1, 2], dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, 2], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        kernels.container_and_counts("array_array", (pos, offs),
                                     (pos.cpu(), offs.cpu()))


def test_compressed_tier_on_gpu_matches_cpu(gen, tmp_path):
    """A count100b-shaped index opened lazily: lone Counts through the
    lanes, the same pinned serial (a launch a slice), and a coalesced
    lane group on a GPU holder launch container_and_counts and answer as
    the CPU holder does."""
    import threading

    rng = np.random.default_rng(9)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    f = h.create_index("ns").create_frame("f")
    for s in range(6):
        base = s * SLICE_WIDTH
        cols = {1: rng.choice(SLICE_WIDTH, 500, replace=False),
                2: rng.choice(SLICE_WIDTH, 300, replace=False),
                0: np.flatnonzero(rng.random(SLICE_WIDTH) < 0.5)}
        start = int(rng.integers(0, SLICE_WIDTH - 3000))
        cols[3] = np.arange(start, start + 2000)
        for r, c in cols.items():
            f.import_bits([r] * len(c), (base + c).tolist())
    h.close()
    row = 'Bitmap(frame="f", rowID={})'.format
    serial = [f"Count({op}({row(a)}, {row(b)}))"
              for op in ("Intersect", "Union", "Difference", "Xor")
              for a, b in ((1, 2), (1, 3), (3, 2), (1, 0), (3, 0))]
    group = [f"Count(Intersect({row(a)}, {row(b)}))"
             for a, b in ((1, 2), (1, 3), (2, 3), (1, 2))]
    answers = {}
    for device in ("cpu", "cuda"):
        h = Holder(path, device=device).open()
        ex = Executor(h)
        ex._result_memo_off = True
        ex._co_enabled_memo = True
        kernels.reset_launches()
        got = [ex.execute("ns", q)[0] for q in serial]
        ex._force_path = "serial"
        got += [ex.execute("ns", q)[0] for q in serial]
        ex._force_path = None
        ex.set_coalesce_config(max_wait_us=10_000_000, max_group=len(group))
        out = [None] * len(group)
        barrier = threading.Barrier(len(group))

        def run(i, q):
            barrier.wait(timeout=30)
            out[i] = ex.execute("ns", q)[0]

        threads = [threading.Thread(target=run, args=(i, q))
                   for i, q in enumerate(group)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        answers[device] = (got, out)
        st = ex.coalesce_snapshot()
        assert st["compressedFusedQueries"] == len(group), st
        if device == "cuda":
            assert kernels.launches["container_and_counts"] > 0
        h.close()
    assert answers["cuda"] == answers["cpu"]


@pytest.mark.parametrize("op", OPS)
def test_row_lanes_on_gpu_match_cpu(gen, op):
    """RowLane pairs whose blocks change format from slice to slice: on
    the card one launch a format cell, the same totals as on the CPU."""
    from pilosa_tpu_torch.ops import containers as C

    rng = np.random.default_rng(31)
    limit, w32 = SLICE_WIDTH, SLICE_WIDTH // 32

    def block(kind, device):
        if kind is None:
            return None
        if kind == "run":
            s0 = int(rng.integers(0, limit - 3000))
            return C.Container("run", w32, 2000, runs=np.array(
                [[s0, s0 + 2000]], np.int32), device=device)
        p = np.sort(rng.choice(limit, 500, replace=False)).astype(np.int32)
        return C.Container("array", w32, 500, positions=p, device=device)

    kinds = [("array", "array"), ("array", "run"), ("run", "array"),
             ("run", "run"), (None, "array"), ("array", "array")] * 50
    state = rng.bit_generator.state
    totals = {}
    for device in ("cpu", "cuda"):
        rng.bit_generator.state = state
        blocks = [(block(a, device), block(b, device)) for a, b in kinds]
        la = C.RowLane([x for x, _ in blocks])
        lb = C.RowLane([y for _, y in blocks])
        kernels.reset_launches()
        inter, launches = C.lane_and_counts([(la, lb), (lb, la)])
        totals[device] = [int(C.count_identity(op, int(x), p.count, q.count))
                          for x, (p, q) in zip(inter, [(la, lb), (lb, la)])]
        assert launches == 2
        if device == "cuda":
            assert kernels.launches["container_and_counts"] == 2
    assert totals["cuda"] == totals["cpu"]


def _table_case(n, seed):
    """A member table over two identity sides of n members each, every
    side named twice, a shuffled three-in-four subset of the members.
    Returns (table, the members in table order)."""
    rng = np.random.default_rng(seed)
    pick = rng.permutation(n)[:max(1, (3 * n) // 4)]
    k = np.arange(len(pick))
    table = np.stack([k % 2, pick, (k // 2) % 2, pick], axis=1).astype(
        np.int32)
    return table, pick


@pytest.mark.parametrize("n", [1, 7, 76_296])
@pytest.mark.parametrize("cell", ["array_array", "array_run", "array_dense",
                                  "run_dense"])
def test_container_and_counts_table_equals_plain(gen, cell, n):
    """The lane table's form on the card: repeated sides, a shuffled
    subset of the members, 4,096-position and 2,048-run members (a block
    each) among light ones (a warp each), one launch, every count as the
    identity form's plain version gives it."""
    fa, fb = cell.split("_")
    big = n > 1000
    _, a = _cont_side(fa, n, 5, big)
    _, b = _cont_side(fb, n, 6, big)
    want = kernels.container_and_counts_plain(cell, a, b)
    table, pick = _table_case(n, n)
    kernels.reset_launches()
    for members in (table, torch.from_numpy(table).cuda()):
        got = kernels.container_and_counts(cell, [a, a], [b, b], members)
        assert torch.equal(got, want[torch.from_numpy(pick).cuda()])
    assert kernels.launches["container_and_counts"] == 2


def test_container_and_counts_threshold_edges(gen):
    """Members of block_min - 1, block_min and block_min + 1 staged ints
    among lane-sized ones, and empty members beside 4,096-position ones,
    on both sides of the block/warp split, in a shuffled order (the
    kernel sorts them itself)."""
    from pilosa_tpu_torch.ops import containers as C

    th = kernels.container_thresholds()
    block_min = th["block_min_ints"]
    rng = np.random.default_rng(8)
    sizes = []
    for k in range(1500):
        tot = (block_min - 1 + k % 4 if k % 4 < 3 else
               (0 if k % 8 == 3 else 8192))
        sizes.append((min(4096, tot // 2), tot - min(4096, tot // 2)))
    sizes = [sizes[i] for i in rng.permutation(len(sizes))]
    sides = [C.stack_positions([C.Container(
        "array", SLICE_WIDTH // 32, k, positions=np.sort(rng.choice(
            SLICE_WIDTH, k, replace=False)).astype(np.int32), device="cuda")
        for k in col]) for col in zip(*sizes)]
    assert 0 < sum(x + y > block_min for x, y in sizes) < len(sizes)
    ident = np.arange(len(sizes), dtype=np.int32)
    table = np.stack([0 * ident, ident, 0 * ident, ident], axis=1)
    want = kernels.container_and_counts_plain("array_array", *sides)
    for got in (kernels.container_and_counts("array_array", [sides[0]],
                                             [sides[1]], table),
                kernels.container_and_counts("array_array", *sides)):
        assert torch.equal(got, want)


def test_container_and_counts_past_max_sides(gen):
    """More distinct sides than the kernel's parameter table: the
    wrapper launches once per chunk of sides and puts the counts back in
    table order."""
    from pilosa_tpu_torch.ops import containers as C

    rng = np.random.default_rng(9)
    w32 = SLICE_WIDTH // 32
    m = kernels.container_thresholds()["max_sides"]
    assert m == kernels.CONT_MAX_SIDES

    def positions(k):
        return C.Container("array", w32, k, positions=np.sort(rng.choice(
            SLICE_WIDTH, k, replace=False)).astype(np.int32), device="cuda")

    sides_a = [C.stack_positions([positions(300) for _ in range(3)])
               for _ in range(2 * m + 3)]
    sides_b = [C.stack_positions([positions(500) for _ in range(3)])
               for _ in range(m + 1)]
    k = 4 * len(sides_a)
    table = np.stack([rng.integers(0, len(sides_a), k),
                      rng.integers(0, 3, k),
                      rng.integers(0, len(sides_b), k),
                      rng.integers(0, 3, k)], axis=1).astype(np.int32)
    kernels.reset_launches()
    got = kernels.container_and_counts("array_array", sides_a, sides_b,
                                       table)
    assert kernels.launches["container_and_counts"] >= 4
    assert torch.equal(got, kernels.container_and_counts_plain(
        "array_array", sides_a, sides_b, table))


def test_lane_round_reads_rows_in_place_on_card(gen):
    """A lane round on the card takes the RowLanes' packed sides
    themselves (no payload copied), sums each pair's members on the
    card, and gives the CPU's totals."""
    from pilosa_tpu_torch.ops import containers as C

    rng = np.random.default_rng(10)
    w32 = SLICE_WIDTH // 32
    state = rng.bit_generator.state
    totals = {}
    for device in ("cpu", "cuda"):
        rng.bit_generator.state = state
        rows = [C.RowLane([C.Container(
            "array", w32, k, positions=np.sort(rng.choice(
                SLICE_WIDTH, k, replace=False)).astype(np.int32),
            device=device) for k in rng.integers(0, 4097, 64)])
            for _ in range(3)]
        pairs = [(rows[0], rows[1]), (rows[1], rows[2]), (rows[0], rows[2])]
        cells = C.lane_cells(pairs)[0]
        for c in cells:
            assert all(any(s is r.packed[C.LANE_ARRAY] for r in rows)
                       for s in c.a_sides + c.b_sides)
        totals[device] = C.lane_and_counts(pairs)[0].tolist()
    assert totals["cuda"] == totals["cpu"]


# ---------------------------------------------------------------- ingest
# ingest_classify's cases (chip_smoke.py phase 3 has the same): sorted,
# deduplicated (row, position) streams as (rowidx, positions, n_rows).

def _classify_stream(lengths, rng, run_share=0.5):
    """Rows of the given lengths, each a mix of runs and spread bits."""
    rows, pos = [], []
    for r, k in enumerate(lengths):
        run = int(k * run_share)
        start = int(rng.integers(0, SLICE_WIDTH - run))
        p = set(range(start, start + run))
        while len(p) < k:
            p.update(rng.integers(0, SLICE_WIDTH, k - len(p)).tolist())
        pos.append(np.sort(np.fromiter(p, np.int64, len(p))[:k]))
        rows.append(np.full(k, r))
    if not lengths:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(pos).astype(np.int32), len(lengths))


def _classify_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 3
    if name == "one":
        return np.zeros(1, np.int32), np.array([5], np.int32), 1
    if name == "edges":  # bit 31/32 of a word, the slice's last bit
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
    if name == "chunk_edges":  # rows ending on and inside 23-entry chunks
        return _classify_stream([23, 22, 24, 46, 5888, 5889, 1, 23 * 256],
                                rng, run_share=0.9)
    raise KeyError(name)


CLASSIFY_CASES = ("empty", "one", "edges", "whole_row", "4096_4097",
                  "rows_1", "rows_3", "rows_1024", "chunk_edges")


@pytest.mark.parametrize("case", CLASSIFY_CASES)
def test_ingest_classify_equals_plain(gen, case):
    rowidx, pos, n_rows = _classify_case(case)
    r = torch.from_numpy(rowidx).cuda()
    p = torch.from_numpy(pos).cuda()
    kernels.reset_launches()
    got = kernels.ingest_classify(r, p, n_rows)
    assert kernels.launches["ingest_classify"] == (1 if len(rowidx) else 0)
    want = kernels.ingest_classify_plain(r, p, n_rows)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


def test_ingest_on_card_gives_the_cpu_files(gen, tmp_path):
    """One small ingest (bits with timestamps into an inverse, YMD frame,
    then values) through a cuda Holder and a cpu Holder: the fragment
    files and sidecars are equal, and the cuda classify launched."""
    from pilosa_tpu_torch.ingest.pipeline import IngestPipeline
    from pilosa_tpu_torch.storage.frame import Field

    rng = np.random.default_rng(12)
    n = 30_000
    rows = rng.integers(0, 40, n)
    cols = rng.integers(0, 3 * SLICE_WIDTH, n)
    rows[:6000], cols[:6000] = 3, np.arange(6000) + 77
    ts = rng.integers(1496275200, 1496275200 + 5 * 86400, n)
    ts[::4] = 0
    vcols = rng.choice(2 * SLICE_WIDTH, 2000, replace=False)
    vals = rng.integers(0, 1001, 2000)
    files = {}
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        h = Holder(str(d), device=device).open()
        idx = h.create_index("i")
        idx.create_frame("f", FrameOptions(inverse_enabled=True,
                                           time_quantum="YMD"))
        idx.create_frame("b", FrameOptions(range_enabled=True, fields=[
            Field("v", min=0, max=1000)]))
        pipe = IngestPipeline(h)
        kernels.reset_launches()
        pipe.ingest_bits("i", "f", rows, cols, ts)
        pipe.ingest_values("i", "b", "v", vcols, vals)
        if device == "cuda":
            assert kernels.launches["ingest_classify"] == \
                pipe.snapshot()["packPassesTotal"] > 0
        h.close()
        files[device] = {
            os.path.relpath(os.path.join(p, f), d): open(
                os.path.join(p, f), "rb").read()
            for p, _, fs in os.walk(d) for f in fs
            if os.path.basename(p) == "fragments"}
    assert files["cuda"] == files["cpu"]


def test_traced_count_op_rows_has_device_time(gen):
    """A launch under an active trace runs under ``kernel:count_op_rows``
    with ``deviceMs`` > 0, answers the untraced counts, counts one launch
    and charges its first operand's bytes; with no trace active it adds
    no span."""
    from pilosa_tpu_torch import querystats, tracing

    a, b = _rand(gen, 512, 32768), _rand(gen, 512, 32768)
    want = kernels.count_op_rows(a, b, "and")
    kernels.reset_launches()
    tracer, qs = tracing.Tracer(), querystats.QueryStats()
    with tracer.start("query"), querystats.scope(qs):
        got = kernels.count_op_rows(a, b, "and")
        rows = kernels.count_rows(a)
    assert torch.equal(got, want)
    assert torch.equal(rows, kernels.count_rows_plain(a))
    assert kernels.launches["count_op_rows"] == 1
    (trace,) = tracer.recent()
    kern = [s for s in trace["spans"] if s["name"].startswith("kernel:")]
    assert [s["name"] for s in kern] == ["kernel:count_op_rows",
                                         "kernel:count_rows"]
    for s in kern:
        assert 0 < s["tags"]["deviceMs"] < s["durationMs"] + 0.001
        assert s["tags"]["launches"] == 1
        assert s["tags"]["first_build"] is False
    assert qs.to_dict()["bytesPopcounted"] == 2 * a.nbytes
    kernels.count_op_rows(a, b, "and")
    assert tracer.summary()["traces"] == 1
