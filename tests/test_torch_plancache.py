"""Port parity for the plan cache, the result memos, the prelude and
TopN discovery memos, and the response cache.

- ``pilosa_tpu_torch.plancache.PlanCache`` driven by the same calls as
  ``pilosa_tpu.plancache.PlanCache``: equal values, hits, misses,
  invalidations and LRU evictions, and equal ``slice_key``s.
- The result memos of Count, Sum, Min/Max and TopN hit on a repeat and
  go stale on every mutation path (SetBit, ClearBit, SetFieldValue,
  imports, SetRowAttrs, SetColumnAttrs, frame, view and field creation
  and deletion, time quantum changes), after which each answer equals a
  memo-less executor's; a write to another index and a governor
  eviction leave them valid. ``PILOSA_TPU_RESULT_MEMO=0`` and a pinned
  ``_force_path`` bypass them.
- The prelude memo when its stack was evicted; the src-less TopN
  discovery memo.
- The response cache replays bytes equal to pilosa_tpu's handler with
  its own cache on, over two directories written alike.

Every answer is an integer, a pair list or bytes: tolerance 0."""
import json

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu import plancache as jplancache
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.server.handler import Handler as JHandler
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu_torch import plancache
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.ops import containers as tcontainers
from pilosa_tpu_torch.server.handler import Handler as THandler
from pilosa_tpu_torch.storage.frame import Field, FrameOptions
from pilosa_tpu_torch.storage.holder import Holder as THolder

N_SLICES = 3


# ------------------------------------------------------------ PlanCache

SLICE_LISTS = [
    [], [5], [0, 1, 2], list(range(33)), list(range(7, 60)),
    [0, 2, 2] + list(range(3, 40)), list(range(40, 0, -1)),
    list(range(0, 80, 2)), range(0), range(12), range(100),
    range(3, 90), range(0, 90, 3),
]


@pytest.mark.parametrize("slices", SLICE_LISTS,
                         ids=[str(i) for i in range(len(SLICE_LISTS))])
def test_slice_key_matches_the_reference(slices):
    assert plancache.slice_key(slices) == jplancache.slice_key(slices)
    t = plancache.as_slice_list(slices)
    j = jplancache.as_slice_list(slices)
    assert t.skey == j.skey and list(t) == list(j)


def _script(rng):
    """A call sequence over a few keys of two indexes: (op, args)."""
    keys = [("plan", idx, k) for idx in ("i", "j") for k in range(6)]
    ops = []
    for _ in range(400):
        key = keys[int(rng.integers(len(keys)))]
        tok = int(rng.integers(3))
        r = rng.random()
        if r < 0.35:
            ops.append(("put", key, tok, int(rng.integers(100))))
        elif r < 0.75:
            ops.append(("get", key, tok, bool(rng.integers(2))))
        elif r < 0.85:
            ops.append(("peek", key, tok))
        elif r < 0.93:
            ops.append(("record", key[1], bool(rng.integers(2))))
        elif r < 0.97:
            ops.append(("set_capacity", int(rng.integers(0, 8))))
        else:
            ops.append(("drop_index", key[1]))
    return ops


@pytest.mark.parametrize("capacity", [0, 3, 512])
@pytest.mark.parametrize("seed", [1, 2])
def test_plan_cache_matches_the_reference(capacity, seed):
    caches = (plancache.PlanCache(capacity), jplancache.PlanCache(capacity))
    for op in _script(np.random.default_rng(seed)):
        outs = []
        for c in caches:
            name, args = op[0], op[1:]
            if name == "put":
                outs.append(c.put(*args))
            elif name == "get":
                key, tok, rec = args
                outs.append(c.get(key, tok, record=rec))
            else:
                outs.append(getattr(c, name)(*args))
        assert outs[0] == outs[1], op
        assert caches[0].entries_view() == caches[1].entries_view(), op
    mt, mj = caches[0].metrics(), caches[1].metrics()
    for k in ("hits", "misses", "invalidations", "entries", "capacity"):
        assert mt[k] == mj[k], k
    st, sj = caches[0].snapshot(), caches[1].snapshot()
    for k in ("enabled", "entries", "hits", "misses", "hitRate",
              "entriesByKind"):
        assert st[k] == sj[k], k
    assert ({i: (v["hits"], v["misses"]) for i, v in st["perIndex"].items()}
            == {i: (v["hits"], v["misses"])
                for i, v in sj["perIndex"].items()})


def test_lru_evicts_the_least_recently_used():
    for c in (plancache.PlanCache(2), jplancache.PlanCache(2)):
        c.put(("k", "i", 1), 0, "a")
        c.put(("k", "i", 2), 0, "b")
        assert c.get(("k", "i", 1), 0) == "a"
        c.put(("k", "i", 3), 0, "c")
        assert c.entries_view() == {("k", "i", 1): "a", ("k", "i", 3): "c"}


# --------------------------------------------------- the executor's memos

def _row(r, frame="f"):
    return f'Bitmap(frame="{frame}", rowID={r})'


QUERIES = [
    f"Count(Intersect({_row(1)}, {_row(2)}))",
    f'Sum({_row(1)}, frame="b", field="v")',
    'Max(frame="b", field="v")',
    f'Min({_row(2)}, frame="b", field="v")',
    f'TopN({_row(1)}, frame="f", n=2)',
    'TopN(frame="f", n=3, field="cat", filters=["a"])',
    'Count(Range(frame="f", rowID=1, start="2017-01-01T00:00", '
    'end="2018-01-01T00:00"))',
]


def _build(path, index="i"):
    """Frame f (rows 1-4, YMD time quantum), BSI frame b (field v), row
    attributes on f and an index ``other``."""
    rng = np.random.default_rng(3)
    h = THolder(path, device="cpu").open()
    try:
        for name in (index, "other"):
            idx = h.create_index(name)
            f = idx.create_frame("f", FrameOptions(time_quantum="YMD"))
            for s in range(N_SLICES):
                for r in (1, 2, 3, 4):
                    cols = rng.choice(3000, 300 * r, replace=False)
                    f.import_bits([r] * len(cols),
                                  (s * SLICE_WIDTH + cols).tolist())
            f.set_bit("standard", 1, 5, None)
            b = idx.create_frame("b", FrameOptions(
                range_enabled=True,
                fields=[Field("v", "int", min=0, max=500)]))
            cols = rng.choice(3000, 900, replace=False)
            b.import_value("v", cols.tolist(),
                           rng.integers(0, 501, len(cols)).tolist())
            f.row_attr_store.set_bulk_attrs({1: {"cat": "a"}, 2: {"cat": "b"},
                                             3: {"cat": "a"}})
    finally:
        h.close()


@pytest.fixture
def memo(tmp_path):
    path = str(tmp_path / "data")
    _build(path)
    h = THolder(path, device="cpu").open()
    e = TExecutor(h)
    fresh = TExecutor(h)
    fresh._result_memo_off = True
    yield h, e, fresh
    h.close()


class Spy:
    """Counts the batched/serial computations an executor runs."""

    def __init__(self, e):
        self.n = 0
        inner = e._map_reduce

        def spy(*a, **kw):
            self.n += 1
            return inner(*a, **kw)

        e._map_reduce = spy


def _mutations():
    def setbit(h, e):
        e.execute("i", 'SetBit(frame="f", rowID=2, columnID=3507)')

    def clearbit(h, e):
        e.execute("i", 'ClearBit(frame="f", rowID=1, columnID=5)')

    def setbit_time(h, e):
        e.execute("i", 'SetBit(frame="f", rowID=1, columnID=3509, '
                       'timestamp="2017-03-04T00:00")')

    def setfield(h, e):
        e.execute("i", 'SetFieldValue(frame="b", columnID=3507, v=499)')

    def import_bits(h, e):
        h.index("i").frame("f").import_bits([1, 2], [3511, 3511])

    def import_value(h, e):
        h.index("i").frame("b").import_value("v", [3505, 3511], [1, 500])

    def row_attrs(h, e):
        e.execute("i", 'SetRowAttrs(frame="f", rowID=4, cat="a")')

    def column_attrs(h, e):
        e.execute("i", 'SetColumnAttrs(columnID=5, x=1)')

    def create_frame(h, e):
        h.index("i").create_frame("g")

    def delete_frame(h, e):
        h.index("i").delete_frame("b")

    def create_view(h, e):
        h.index("i").frame("f").create_view_if_not_exists("standard_2017")

    def delete_view(h, e):
        h.index("i").frame("f").delete_view("standard")

    def time_quantum(h, e):
        h.index("i").frame("f").set_time_quantum("Y")

    def create_field(h, e):
        h.index("i").frame("b").create_field(Field("w", "int", min=0, max=9))

    def delete_field(h, e):
        h.index("i").frame("b").delete_field("v")

    return [setbit, clearbit, setbit_time, setfield, import_bits,
            import_value, row_attrs, column_attrs, create_frame,
            delete_frame, create_view, delete_view, time_quantum,
            create_field, delete_field]


def _answer(e, q):
    try:
        return e.execute("i", q)[0]
    except Exception as exc:  # noqa: BLE001 — an error is an answer
        return type(exc).__name__


@pytest.mark.parametrize("mutate", _mutations(), ids=lambda f: f.__name__)
def test_result_memos_go_stale_on_every_mutation(memo, mutate):
    h, e, fresh = memo
    first = [_answer(e, q) for q in QUERIES]
    spy = Spy(e)
    assert [_answer(e, q) for q in QUERIES] == first
    assert spy.n == 0                       # every query a memo hit
    epoch = h.index("i").epoch.value
    mutate(h, e)
    assert h.index("i").epoch.value != epoch
    got = [_answer(e, q) for q in QUERIES]
    assert got == [_answer(fresh, q) for q in QUERIES]
    assert spy.n > 0


def test_memos_survive_other_indexes_and_evictions(memo):
    h, e, fresh = memo
    first = [_answer(e, q) for q in QUERIES]
    spy = Spy(e)
    e.execute("other", 'SetBit(frame="f", rowID=1, columnID=77)')
    h.index("other").frame("f").row_attr_store.set_attrs(4, {"cat": "a"})
    epoch = h.index("i").epoch.value
    for s in range(N_SLICES):             # what the governor does
        for view in ("standard", "field_v"):
            frag = h.fragment("i", "f" if view == "standard" else "b",
                              view, s)
            if frag is not None:
                frag.unload()
    assert h.index("i").epoch.value == epoch
    assert [_answer(e, q) for q in QUERIES] == first
    assert spy.n == 0
    assert first == [_answer(fresh, q) for q in QUERIES]


def test_kill_switch_and_pinned_path_bypass_the_memos(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "data")
    _build(path)
    monkeypatch.setenv("PILOSA_TPU_RESULT_MEMO", "0")
    h = THolder(path, device="cpu").open()
    try:
        off = TExecutor(h)
        pinned = TExecutor(h)
        monkeypatch.delenv("PILOSA_TPU_RESULT_MEMO")
        pinned._force_path = "batched"
        for e in (off, pinned):
            spy = Spy(e)
            first = [_answer(e, q) for q in QUERIES]
            n = spy.n
            assert [_answer(e, q) for q in QUERIES] == first
            # Every query computed again (the src-less discovery memo is
            # no result memo: it stays on under the kill switch).
            assert spy.n - n >= len(QUERIES)
            assert e._result_memo == {}
    finally:
        h.close()


def test_prelude_memo_rebuilds_an_evicted_stack(memo, monkeypatch):
    # The batched path's prelude memo: with the container tier on, this
    # lazily reopened sparse Count would serve serially from containers.
    monkeypatch.setattr(tcontainers, "_ENABLED", False)
    h, e, fresh = memo
    e._result_memo_off = True
    q = QUERIES[0]
    want = _answer(fresh, q)
    assert _answer(e, q) == want
    assert [k for k in e.plans.entries_view(("plan",))]
    hits = e.plans.metrics()["hits"]
    assert _answer(e, q) == want                    # a prelude hit
    assert e.plans.metrics()["hits"] > hits
    with e._cache_mu:                               # the budget evicts
        e._stack_cache.clear()
        e._stack_bytes = 0
    misses = e.plans.metrics()["misses"]
    assert _answer(e, q) == want
    assert e.plans.metrics()["misses"] > misses
    assert len(e._stack_cache) == 2                 # rebuilt, re-put
    hits = e.plans.metrics()["hits"]
    assert _answer(e, q) == want
    assert e.plans.metrics()["hits"] > hits


def test_topn_discovery_memo(memo):
    h, e, fresh = memo
    e._result_memo_off = True
    q = 'TopN(frame="f", n=3)'
    calls = []
    inner = e._topn_map_reduce_exec
    e._topn_map_reduce_exec = lambda *a: calls.append(a[3]) or inner(*a)
    want = _answer(fresh, q)
    assert _answer(e, q) == want
    assert calls == [False, True]                   # discovery, re-count
    assert _answer(e, q) == want
    assert calls == [False, True, True]             # discovery memoized
    e.execute("i", 'SetBit(frame="f", rowID=4, columnID=1)')
    assert _answer(e, q) == _answer(fresh, q)
    assert calls[3:] == [False, True]


# ------------------------------------------------------- response cache

def _queries():
    reads = [q for q in QUERIES] + [_row(1), 'Count(Bitmap(frame="f"))']
    return ([("POST", "/index/i/query", q.encode()) for q in reads]
            + [("POST", "/index/i/query",
                b'SetBit(frame="f", rowID=1, columnID=99)'),
               ("POST", "/index/i/query", b'SetRowAttrs(frame="f", '
                                          b'rowID=2, cat="a")'),
               ("DELETE", "/index/i/frame/b", b"")]
            + [("POST", "/index/i/query", q.encode()) for q in reads])


def test_response_cache_replays_the_reference_bytes(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _build(a)
    _build(b)
    ja, tb = JHolder(a).open(), THolder(b, device="cpu").open()
    try:
        jh = JHandler(ja, JExecutor(ja))
        th = THandler(tb, TExecutor(tb))
        jh.enable_response_cache()
        th.enable_response_cache()
        for _ in range(2):
            for method, path, body in _queries():
                got_j = jh.dispatch(method, path, {}, body, {})[:3]
                got_t = th.dispatch(method, path, {}, body, {})[:3]
                assert got_t == got_j, (method, path, body)
        stats = th._resp_cache.stats()
        assert stats["hits"] > 0 and stats["entries"] > 0
        assert stats == jh._resp_cache.stats()
        doc = json.loads(th.dispatch("GET", "/debug/vars", {}, b"", {})[2])
        assert doc["responseCache"] == stats
        assert doc["countCoalescer"]["enabled"] is False
        assert doc["planCache"]["hits"] > 0
    finally:
        ja.close()
        tb.close()


def test_response_cache_off_switches(tmp_path, monkeypatch):
    path = str(tmp_path / "data")
    _build(path)
    h = THolder(path, device="cpu").open()
    try:
        monkeypatch.setenv("PILOSA_TPU_RESPONSE_CACHE", "0")
        off = THandler(h, TExecutor(h))
        off.enable_response_cache()
        assert off._resp_cache is None
        monkeypatch.delenv("PILOSA_TPU_RESPONSE_CACHE")
        ex = TExecutor(h)
        ex._result_memo_off = True
        th = THandler(h, ex)
        th.enable_response_cache()
        for _ in range(2):
            th.dispatch("POST", "/index/i/query", {}, QUERIES[0].encode(), {})
        assert th._resp_cache.stats()["hits"] == 0
    finally:
        h.close()
