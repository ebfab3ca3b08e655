"""Row-count caches backing TopN (ref: cache.go; counterpart of
pilosa_tpu/storage/cache.py, host-side and identical in behaviour).

The cache does not hold the counts TopN ranks by — those are exact,
from storage or from the count kernels. It decides which rows TopN may
return: with no explicit ``ids``, only rows in a fragment's cache are
candidates (ref: topBitmapPairs fragment.go:965), so ``cacheType``
(ranked / lru / none, frame.go:1234-1248) and ``cacheSize`` shape the
answer. The ids persist in the ``.cache`` sidecar (fragment.go:250-289).
"""
from collections import OrderedDict

import numpy as np

THRESHOLD_FACTOR = 1.1  # ref: cache.go:29-33


def _ids_array(entries):
    return np.fromiter(entries, dtype=np.uint64, count=len(entries))


class RankCache:
    """Top-K row→count map with entry threshold (ref: cache.go:136-299)."""

    def __init__(self, max_entries=50000):
        self.max_entries = max_entries
        self.entries = {}  # rowID -> count
        self._floor = None  # lazy lower bound of min(entries.values())
        self._ids_arr = None  # memoized uint64 key array

    def add(self, row_id, n):
        self.bulk_add(row_id, n)
        self.invalidate()

    def bulk_add(self, row_id, n):
        if n == 0:
            if self.entries.pop(row_id, None) is not None:
                self._ids_arr = None
            return
        n = int(n)
        if (len(self.entries) >= self.max_entries + 10
                and row_id not in self.entries):
            # Entry threshold: must beat threshold-factor × current min
            # (ref: cache.go:175-196), against a lower bound of the min
            # kept lazily instead of a full min() per add.
            if self._floor is None:
                self._floor = min(self.entries.values(), default=0)
            if n < self._floor * THRESHOLD_FACTOR:
                return
        if row_id not in self.entries:
            self._ids_arr = None
        self.entries[row_id] = n
        if self._floor is not None and n < self._floor:
            self._floor = n

    def get(self, row_id):
        return self.entries.get(row_id, 0)

    def __len__(self):
        return len(self.entries)

    def ids(self):
        return sorted(self.entries)

    def ids_arr(self):
        """Memoized uint64 array of cached row ids (TopN's eligibility
        mask reads it every query; membership changes invalidate)."""
        if self._ids_arr is None:
            self._ids_arr = _ids_array(self.entries)
        return self._ids_arr

    def invalidate(self):
        if len(self.entries) > self.max_entries + 10:
            top = sorted(self.entries.items(), key=lambda kv: (-kv[1], kv[0]))
            self.entries = dict(top[: self.max_entries])
            self._floor = top[self.max_entries - 1][1] if top else None
            self._ids_arr = None

    def top(self):
        """Pairs sorted count-desc, id-asc."""
        self.invalidate()
        return sorted(self.entries.items(), key=lambda kv: (-kv[1], kv[0]))

    def clear(self):
        self.entries = {}
        self._floor = None
        self._ids_arr = None


class LRUCache:
    """LRU row→count cache (ref: cache.go:58-130)."""

    def __init__(self, max_entries=50000):
        self.max_entries = max_entries
        self.entries = OrderedDict()
        self._ids_arr = None

    def add(self, row_id, n):
        self.bulk_add(row_id, n)

    def bulk_add(self, row_id, n):
        if row_id not in self.entries:
            self._ids_arr = None
        self.entries[row_id] = int(n)
        self.entries.move_to_end(row_id)
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)
            self._ids_arr = None

    def get(self, row_id):
        n = self.entries.get(row_id, 0)
        if row_id in self.entries:
            self.entries.move_to_end(row_id)
        return n

    def __len__(self):
        return len(self.entries)

    def ids(self):
        return sorted(self.entries)

    def ids_arr(self):
        if self._ids_arr is None:
            self._ids_arr = _ids_array(self.entries)
        return self._ids_arr

    def invalidate(self):
        pass

    def top(self):
        return sorted(self.entries.items(), key=lambda kv: (-kv[1], kv[0]))

    def clear(self):
        self.entries = OrderedDict()
        self._ids_arr = None


class NopCache:
    """cacheType: none (ref: cache.go:491-519)."""

    def add(self, row_id, n):
        pass

    def bulk_add(self, row_id, n):
        pass

    def get(self, row_id):
        return 0

    def __len__(self):
        return 0

    def ids(self):
        return []

    def ids_arr(self):
        return _ids_array(())

    def invalidate(self):
        pass

    def top(self):
        return []

    def clear(self):
        pass


def new_cache(cache_type, cache_size):
    if cache_type in ("ranked", None, ""):
        return RankCache(cache_size)
    if cache_type == "lru":
        return LRUCache(cache_size)
    if cache_type == "none":
        return NopCache()
    raise ValueError(f"unknown cache type: {cache_type}")
