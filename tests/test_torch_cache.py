"""Port parity for the TopN row caches: identical seeded add / bulk_add /
invalidate / get / clear sequences through pilosa_tpu's and the port's
RankCache, LRUCache and NopCache give identical ids(), top(), ids_arr()
and lengths after every step — including the ranked cache's entry
threshold once it holds more than max_entries + 10 rows."""
import numpy as np
import pytest

from pilosa_tpu.storage import cache as jcache
from pilosa_tpu_torch.storage import cache as tcache

KINDS = ("ranked", "lru", "none")


def _ops(seed, n_ops, n_rows, with_clear):
    """Seeded (op, row, count) sequence; counts include 0 (a row that
    emptied) and both small and large values."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        roll = rng.random()
        row = int(rng.integers(0, n_rows))
        cnt = int(rng.choice([0, 1, 2, 5, int(rng.integers(1, 10_000))]))
        if with_clear and i == n_ops // 2:
            ops.append(("clear", 0, 0))
        elif roll < 0.45:
            ops.append(("add", row, cnt))
        elif roll < 0.85:
            ops.append(("bulk_add", row, cnt))
        elif roll < 0.93:
            ops.append(("invalidate", 0, 0))
        else:
            ops.append(("get", row, 0))
    return ops


def _state(c):
    return (c.ids(), c.top(), list(c.ids_arr()), len(c))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", [3, 20])
def test_cache_sequences_match_reference(kind, size, seed):
    a = jcache.new_cache(kind, size)
    b = tcache.new_cache(kind, size)
    assert type(a).__name__ == type(b).__name__
    for op, row, cnt in _ops(seed, 400, 60, with_clear=seed % 2 == 1):
        if op == "get":
            assert a.get(row) == b.get(row)
        elif op in ("add", "bulk_add"):
            getattr(a, op)(row, cnt)
            getattr(b, op)(row, cnt)
        else:
            getattr(a, op)()
            getattr(b, op)()
        assert _state(a) == _state(b), (op, row, cnt)


@pytest.mark.parametrize("kind", ["ranked", "lru"])
def test_threshold_floor_past_max_entries(kind):
    """Fill past max_entries + 10 with bulk_add (no trim), then offer
    rows below and above 1.1 × the smallest count: the ranked cache
    admits only the latter; the LRU cache evicts oldest instead."""
    size = 5
    a, b = jcache.new_cache(kind, size), tcache.new_cache(kind, size)
    for r in range(size + 10):
        a.bulk_add(r, 100 + r)
        b.bulk_add(r, 100 + r)
    assert _state(a) == _state(b)
    for row, cnt in [(100, 105), (101, 110), (102, 111), (103, 99),
                     (104, 1000), (3, 1), (105, 0)]:
        a.bulk_add(row, cnt)
        b.bulk_add(row, cnt)
        # ids without top(): top() trims, which would end the threshold
        assert (a.ids(), len(a)) == (b.ids(), len(b)), (row, cnt)
    if kind == "ranked":  # below 1.1 × the floor of 100: refused
        assert 100 not in b.ids() and 103 not in b.ids()
        assert 102 in b.ids() and 104 in b.ids()
    a.invalidate()
    b.invalidate()
    assert _state(a) == _state(b)


def test_new_cache_types_match_reference():
    for kind in ("ranked", "", None, "lru", "none"):
        assert (type(tcache.new_cache(kind, 7)).__name__
                == type(jcache.new_cache(kind, 7)).__name__)
    for mod in (jcache, tcache):
        with pytest.raises(ValueError):
            mod.new_cache("bogus", 7)
    assert tcache.THRESHOLD_FACTOR == jcache.THRESHOLD_FACTOR


def test_ids_arr_is_uint64_and_memoized():
    c = tcache.RankCache(10)
    c.add(2 ** 40 + 3, 5)
    c.add(7, 9)
    arr = c.ids_arr()
    assert arr.dtype == np.uint64 and sorted(arr.tolist()) == [7, 2 ** 40 + 3]
    assert c.ids_arr() is arr
    c.add(7, 0)  # emptied: leaves the cache and drops the memo
    assert c.ids_arr().tolist() == [2 ** 40 + 3]
    assert tcache.NopCache().ids_arr().dtype == np.uint64
