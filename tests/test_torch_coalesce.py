"""Port parity for the coalescer (ref: tests/test_coalesce.py's dense and
BSI scenarios): concurrent Counts, Count(Range), filtered Sums and
filtered Min/Max under a Barrier, fused as ONE group per tick on the
port's Executor and equal to pilosa_tpu's answers on the same data
directory; single-query passthrough, mixed structures in separate
groups, admission by priority, a deadline that expires without touching
its siblings, a budget decline that serves singly, a kernel failure
raised in every member, and a write seen by the next tick. Then the
plain versions of the two group kernels, ``count_op_pairs`` and
``count_and_rows_multi``, against a numpy oracle at the edges (all-zero
and all-one rows, bit 31, widths 1-32,768, storage offsets off 16
bytes, K = 1 and 257).

Every test pins the port's coalescer on for a CPU holder
(``_co_enabled_memo``) and the container tier off, so that the dense
group kernels serve (this directory's rows are sparse and reopened
lazily: with the tier on they would be compressed lanes, which
tests/test_torch_containers.py holds against pilosa_tpu), and holds the
tick window open
until the whole group has arrived (``set_coalesce_config``), so the
grouping is deterministic; the result memos are off so that each query
reaches the tick. Every answer is an integer: tolerance 0."""
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu_torch import errors as terr
from pilosa_tpu_torch.executor import PRIO_INTERACTIVE, SumCount
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.ops import bitops, containers, kernels
from pilosa_tpu_torch.storage.frame import Field, FrameOptions
from pilosa_tpu_torch.storage.holder import Holder as THolder

N_SLICES = 3
ROWS = (1, 2, 3, 4)


def _row(r, frame="f"):
    return f'Bitmap(frame="{frame}", rowID={r})'


def _fill(path):
    """Frame f: rows 1-4 of random density over N_SLICES slices, column
    31 of every word-aligned group set in row 1 (bit 31 of its words);
    BSI frame b: field v in [-10, 400] on about half the columns."""
    rng = np.random.default_rng(7)
    h = THolder(path, device="cpu").open()
    try:
        idx = h.create_index("i")
        f = idx.create_frame("f")
        for s in range(N_SLICES):
            for r, n in zip(ROWS, (900, 700, 400, 150)):
                cols = rng.choice(4000, n, replace=False)
                if r == 1:
                    cols = np.union1d(cols, np.arange(31, 4000, 32))
                f.import_bits([r] * len(cols),
                              (s * SLICE_WIDTH + cols).tolist())
        b = idx.create_frame("b", FrameOptions(
            range_enabled=True,
            fields=[Field("v", "int", min=-10, max=400)]))
        for s in range(N_SLICES):
            cols = rng.choice(4000, 1800, replace=False)
            vals = rng.integers(-10, 401, len(cols))
            b.import_value("v", (s * SLICE_WIDTH + cols).tolist(),
                           vals.tolist())
    finally:
        h.close()


COUNT_CASES = {
    "and": [f"Count(Intersect({_row(a)}, {_row(b)}))"
            for a, b in ((1, 2), (1, 3), (2, 3), (1, 4), (2, 4), (3, 4),
                         (1, 2), (4, 4))],
    "or": [f"Count(Union({_row(a)}, {_row(b)}))"
           for a, b in ((1, 2), (3, 4), (1, 4), (2, 3))],
    "xor": [f"Count(Xor({_row(a)}, {_row(b)}))"
            for a, b in ((1, 2), (3, 4), (1, 4), (2, 3))],
    "andnot": [f"Count(Difference({_row(a)}, {_row(b)}))"
               for a, b in ((1, 2), (2, 1), (4, 3), (3, 1))],
    "three_leaf": [f"Count(Union(Intersect({_row(a)}, {_row(b)}), "
                   f"{_row(c)}))"
                   for a, b, c in ((1, 2, 3), (2, 3, 4), (1, 4, 2),
                                   (3, 4, 1))],
    "range": [f'Count(Range(frame="b", v {op} {x}))'
              for op, x in ((">", 30), (">", 200), ("<", 0), ("<", 399),
                            (">=", 100), (">", -5))],
}
FILTERS = [f"Union({_row(a)}, {_row(b)})"
           for a, b in ((1, 2), (1, 3), (1, 4), (2, 3), (2, 4), (3, 4))]
SUM_CASES = ([f'Sum({flt}, frame="b", field="v")' for flt in FILTERS]
             + [f'Sum({FILTERS[0]}, frame="b", field="v")'])
MINMAX_CASES = {op: [f'{op}({flt}, frame="b", field="v")' for flt in FILTERS]
                for op in ("Min", "Max")}
ALL_QUERIES = (sorted({q for qs in COUNT_CASES.values() for q in qs})
               + sorted(set(SUM_CASES))
               + [q for qs in MINMAX_CASES.values() for q in qs]
               + ['Sum(frame="b", field="v")', 'Max(frame="b", field="v")'])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(path, {query: pilosa_tpu's answer}) over one data directory."""
    path = str(tmp_path_factory.mktemp("coalesce") / "data")
    _fill(path)
    jh = JHolder(path).open()
    try:
        je = JExecutor(jh)
        want = {q: je.execute("i", q)[0] for q in ALL_QUERIES}
    finally:
        jh.close()
    return path, want


@pytest.fixture
def port(data, monkeypatch):
    path, want = data
    monkeypatch.setattr(containers, "_ENABLED", False)
    h = THolder(path, device="cpu").open()
    e = TExecutor(h)
    e._co_enabled_memo = True
    e._result_memo_off = True
    yield h, e, want
    h.close()


def _concurrent(e, queries, max_group=None):
    """Run ``queries`` on threads released together; the tick's window
    stays open until ``max_group`` (default: all) requests wait, so they
    form one batch. -> (answers in order, errors)."""
    e.set_coalesce_config(max_wait_us=10_000_000,
                          max_group=max_group or len(queries))
    results, errors = {}, []
    barrier = threading.Barrier(len(queries))

    def run(i, q):
        try:
            barrier.wait(timeout=30)
            results[i] = e.execute("i", q)[0]
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i, q))
               for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return [results.get(i) for i in range(len(queries))], errors


def _one_group(e, k):
    st = e.coalesce_snapshot()
    assert st["rounds"] == 1, st
    assert st["fused_queries"] == k and st["max_group"] == k, st
    assert st["declined"] == {}, st


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_same_structure_counts_fuse(port, case):
    h, e, want = port
    queries = COUNT_CASES[case]
    got, errors = _concurrent(e, queries)
    assert errors == []
    assert got == [want[q] for q in queries]
    _one_group(e, len(queries))
    # Equal members share one kernel table entry.
    assert e.coalesce_snapshot()["tableEntries"] == len(set(queries))


def test_shared_leaf_group_counts_in_one_count_op_pairs_call(port,
                                                              monkeypatch):
    """Members that all Intersect one leaf count like any other group:
    one count_op_pairs call, one table entry per distinct member."""
    h, e, want = port
    queries = [f"Count(Intersect({_row(1)}, {_row(b)}))" for b in (2, 3, 4)]
    pairs = []
    monkeypatch.setattr(bitops, "count_op_pairs",
                        lambda *a: pairs.append(a) or kernels.count_op_pairs(
                            *a))
    got, errors = _concurrent(e, queries)
    assert errors == []
    assert got == [want[q] for q in queries]
    assert len(pairs) == 1 and len(pairs[0][0]) == len(queries)
    assert e.coalesce_snapshot()["tableEntries"] == len(queries)
    _one_group(e, len(queries))


def test_filtered_sums_fuse(port):
    h, e, want = port
    got, errors = _concurrent(e, SUM_CASES)
    assert errors == []
    assert got == [want[q] for q in SUM_CASES]
    assert all(isinstance(v, SumCount) for v in got)
    _one_group(e, len(SUM_CASES))


@pytest.mark.parametrize("op", ["Min", "Max"])
def test_filtered_minmax_fuse(port, op):
    h, e, want = port
    queries = MINMAX_CASES[op]
    got, errors = _concurrent(e, queries)
    assert errors == []
    assert got == [want[q] for q in queries]
    _one_group(e, len(queries))


@pytest.mark.parametrize("q", ['Sum(frame="b", field="v")',
                               'Max(frame="b", field="v")'])
def test_filterless_bsi_group_computes_once(port, q):
    h, e, want = port
    got, errors = _concurrent(e, [q] * 4)
    assert errors == []
    assert got == [want[q]] * 4
    _one_group(e, 4)


def test_single_query_passthrough(port):
    h, e, want = port
    q = COUNT_CASES["and"][0]
    assert e.execute("i", q)[0] == want[q]
    assert e.execute("i", q)[0] == want[q]
    st = e.coalesce_snapshot()
    assert st["rounds"] == 2 and st["fused_queries"] == 0, st
    assert st["max_group"] == 0


def test_mixed_structures_split_into_groups(port):
    h, e, want = port
    queries = COUNT_CASES["and"][:4] + COUNT_CASES["or"] + SUM_CASES[:2]
    got, errors = _concurrent(e, queries)
    assert errors == []
    assert got == [want[q] for q in queries]
    st = e.coalesce_snapshot()
    assert st["rounds"] == 1, st
    assert st["fused_queries"] == len(queries) and st["max_group"] == 4, st


def test_jax_coalescer_agrees_on_the_same_directory(data):
    """pilosa_tpu's own coalescer over the same directory, pinned on as
    its tests pin it, fuses the same group to the same answers."""
    path, want = data
    queries = COUNT_CASES["and"]
    jh = JHolder(path).open()
    try:
        je = JExecutor(jh)
        je._force_path = "batched"
        je._co_enabled_memo = True
        je._co_route_all = True
        je.set_coalesce_config(max_wait_us=10_000_000,
                               max_group=len(queries))
        got, errors = _concurrent(je, queries)
        assert errors == []
        assert got == [want[q] for q in queries]
        assert je._co_stats["max_group"] == len(queries)
    finally:
        jh.close()


def _req(e, key, prio=PRIO_INTERACTIVE, deadline=None, single=None,
         fuse=None):
    return {"key": key, "prio": prio, "deadline": deadline,
            "out": e._CO_PENDING, "single": single or (lambda: key[-1]),
            "fuse": fuse or (lambda reqs: False)}


def test_admission_priority_order(port):
    """When the tick truncates, lower priority classes admit first, FIFO
    within a class; the leader's own request always admits; leftovers
    stay queued (ref: test_tick_admission_priority_order)."""
    h, e, _ = port
    e.set_coalesce_config(max_wait_us=0, max_group=3)
    waiters = [_req(e, ("k", "b0"), prio=2), _req(e, ("k", "i0"), prio=1),
               _req(e, ("k", "g0"), prio=3), _req(e, ("k", "i1"), prio=1),
               _req(e, ("k", "b1"), prio=2)]
    own = _req(e, ("k", "own"), prio=2)
    with e._co_mu:
        e._co_leader = True
        e._co_pending = waiters + [own]
        batch = e._co_admit_locked(own)
        leftovers = list(e._co_pending)
        e._co_pending = []
        e._co_leader = False
    assert [r["key"][1] for r in batch] == ["i0", "i1", "own"]
    assert [r["key"][1] for r in leftovers] == ["b0", "g0", "b1"]


def test_expired_deadline_leaves_siblings_untouched(port):
    """A parked request whose deadline passes leaves the queue and raises
    DeadlineExceeded at its own deadline; its sibling, parked behind the
    same busy leader, is served by the next tick; and a member expired
    inside a batch is excluded before its group runs."""
    h, e, _ = port
    e.set_coalesce_config(max_wait_us=0, max_group=64)
    release, started = threading.Event(), threading.Event()

    def slow_single():
        started.set()
        assert release.wait(10)
        return "lead"

    out = {}

    def submit(name, req):
        try:
            out[name] = e._co_submit(req)
        except terr.DeadlineExceeded:
            out[name] = "expired"

    lead = threading.Thread(target=submit, args=(
        "lead", _req(e, ("lead",), single=slow_single)))
    lead.start()
    assert started.wait(10)
    sibling = threading.Thread(target=submit, args=(
        "sibling", _req(e, ("k", "sibling"))))
    sibling.start()
    expiring = threading.Thread(target=submit, args=(
        "expiring", _req(e, ("k", "expiring"),
                         deadline=time.monotonic() + 0.05)))
    expiring.start()
    expiring.join(timeout=10)
    assert out.get("expiring") == "expired"
    release.set()
    lead.join(timeout=10)
    sibling.join(timeout=10)
    assert out["lead"] == "lead" and out["sibling"] == "sibling"
    assert e.coalesce_snapshot()["expiredWaits"] == 1

    served = []
    reqs = [_req(e, ("g",), deadline=time.monotonic() - 1,
                 single=lambda: "a"),
            _req(e, ("g",), single=lambda: "b"),
            _req(e, ("g",), single=lambda: "c")]
    for r in reqs:
        r["fuse"] = lambda group: served.append(
            [m["single"]() for m in group]) or False
    e._co_run(reqs)
    assert isinstance(reqs[0]["out"], terr.DeadlineExceeded)
    assert [r["out"] for r in reqs[1:]] == ["b", "c"]
    assert served == [["b", "c"]]


def test_budget_decline_serves_singly(port):
    """A group whose stacks do not fit the stack budget together declines
    and serves each member on its own, exactly."""
    h, e, want = port
    queries = COUNT_CASES["and"][:6]
    e.STACK_CACHE_BYTES = 3 * N_SLICES * 32768 * 4  # one plan, not six
    e._fixed_full_window = True
    got, errors = _concurrent(e, queries)
    assert errors == []
    assert got == [want[q] for q in queries]
    st = e.coalesce_snapshot()
    assert st["declined"] == {"budget": 1} and st["fused_queries"] == 0


def test_kernel_failure_raises_in_every_member(port, monkeypatch):
    """A failed group launch reaches every member of the group; none is
    served singly instead."""
    h, e, _ = port

    def fail(*a):
        raise RuntimeError("count_op_pairs: kernel launch failed")

    singles = []
    monkeypatch.setattr(bitops, "count_op_pairs", fail)
    monkeypatch.setattr(e, "_batched_count",
                        lambda *a: singles.append(a) or 0)
    queries = COUNT_CASES["or"]
    got, errors = _concurrent(e, queries)
    assert len(errors) == len(queries)
    assert all("kernel launch failed" in str(x) for x in errors)
    assert singles == []


def test_write_between_ticks_is_seen_by_the_next_tick(port):
    h, e, want = port
    queries = COUNT_CASES["or"]
    got, errors = _concurrent(e, queries)
    assert errors == [] and got == [want[q] for q in queries]
    col = 2 * SLICE_WIDTH + 4321   # in no row of frame f
    assert e.execute("i", f'SetBit(frame="f", rowID=1, columnID={col})')
    try:
        got, errors = _concurrent(e, queries)
        assert errors == []
        assert got == [want[q] + (_row(1) in q) for q in queries]
    finally:
        e.execute("i", f'ClearBit(frame="f", rowID=1, columnID={col})')


# --------------------------------------------- the group kernels' plain form

def _np_popcount(words):
    return np.bitwise_count(words.view(np.uint32)).sum(
        axis=-1, dtype=np.int64).astype(np.int32)


_NP_OPS = {None: lambda a, b: a, "and": np.bitwise_and,
           "or": np.bitwise_or, "xor": np.bitwise_xor,
           "andnot": lambda a, b: a & ~b}


def _words(rng, s, w, fill):
    if fill == "zero":
        return np.zeros((s, w), np.int32)
    if fill == "ones":
        return np.full((s, w), -1, np.int32)
    if fill == "bit31":
        return np.full((s, w), -2**31, np.int32)
    return rng.integers(-2**31, 2**31, (s, w), dtype=np.int64).astype(
        np.int32)


def _offset_tensor(words, offset):
    """``words`` as a tensor whose storage starts ``offset`` int32 words
    into a larger buffer (offset 1-3: not 16-byte aligned)."""
    flat = torch.zeros(words.size + offset, dtype=torch.int32)
    t = flat[offset:].view(words.shape)
    t.copy_(torch.from_numpy(words))
    return t


@pytest.mark.parametrize("width", [1, 127, 128, 4097, 32768])
@pytest.mark.parametrize("op", [None, "and", "or", "xor", "andnot"])
def test_count_op_pairs_plain_matches_numpy(width, op):
    rng = np.random.default_rng(width)
    s = 2
    fills = ["rand", "zero", "ones", "bit31"]
    a = [_words(rng, s, width, fills[k % 4]) for k in range(5)]
    b = [_words(rng, s, width, fills[(k + 1) % 4]) for k in range(5)]
    ta = [_offset_tensor(x, k % 4) for k, x in enumerate(a)]
    tb = [_offset_tensor(x, (k + 1) % 4) for k, x in enumerate(b)]
    got = kernels.count_op_pairs(ta, tb, op)
    want = np.stack([_np_popcount(_NP_OPS[op](x, y)) for x, y in zip(a, b)])
    assert got.dtype == torch.int32 and got.shape == (5, s)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 257])
def test_count_op_pairs_plain_at_table_edges(k):
    rng = np.random.default_rng(k)
    a = [_words(rng, 3, 65, "rand") for _ in range(k)]
    b = [_words(rng, 3, 65, "rand") for _ in range(k)]
    got = kernels.count_op_pairs([torch.from_numpy(x) for x in a],
                                 [torch.from_numpy(y) for y in b], "and")
    want = np.stack([_np_popcount(x & y) for x, y in zip(a, b)])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [1, 127, 128, 4097, 32768])
def test_count_and_rows_multi_plain_matches_numpy(width):
    rng = np.random.default_rng(width + 1)
    s = 2
    fills = ["rand", "zero", "ones", "bit31"]
    rows = [_words(rng, s, width, fills[r % 4]) for r in range(5)]
    filts = [_words(rng, s, width, fills[(k + 2) % 4]) for k in range(3)]
    got = kernels.count_and_rows_multi(
        [_offset_tensor(x, r % 4) for r, x in enumerate(rows)],
        [_offset_tensor(x, (k + 3) % 4) for k, x in enumerate(filts)])
    want = np.stack([np.stack([_np_popcount(r & f) for r in rows])
                     for f in filts])
    assert got.dtype == torch.int32 and got.shape == (3, 5, s)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 257])
def test_count_and_rows_multi_plain_at_table_edges(k):
    rng = np.random.default_rng(k + 5)
    rows = [_words(rng, 2, 33, "rand") for _ in range(11)]
    filts = [_words(rng, 2, 33, "rand") for _ in range(k)]
    got = kernels.count_and_rows_multi([torch.from_numpy(x) for x in rows],
                                       [torch.from_numpy(x) for x in filts])
    want = np.stack([np.stack([_np_popcount(r & f) for r in rows])
                     for f in filts])
    assert np.array_equal(got.numpy(), want)
