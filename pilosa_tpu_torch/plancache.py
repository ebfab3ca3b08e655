"""Epoch-validated slice-plan cache (counterpart of pilosa_tpu/plancache.py).

At 10B columns an index spans ~9,540 slices, and without this tier every
query re-derives the same per-(index, slice range) facts on a Python
walk before any device work runs: the slice universe (``max_slice()``
walks every view of every frame), the column window of a plan's leaves
(``_leaf_frags`` + ``_union_window``) and its leaf stacks' cache keys.

- **Keys** are ``(kind, index, ...)`` tuples; kinds are the caller's
  ("win", "plan", "bsi", "topnp", ...) and show separately in the
  snapshot's ``entriesByKind``. The slice key is compact: a contiguous
  slice list keys as ``("#range", first, last)`` instead of a
  9,540-int tuple; a ``SliceList`` carries the key it was built with.
- **Validity** is a token the caller computes: the index's mutation
  epoch (``storage.fragment.MutationEpoch``), moved by every write,
  import, attribute write and schema change under the index. A stale
  entry is dropped when found; a ``None`` token computes without
  storing — cold, never stale.
- **An LRU** of ``capacity`` entries (``PILOSA_PLAN_CACHE_ENTRIES``;
  0 turns it off: every lookup misses and nothing is stored), with hit,
  miss and invalidation counters per index.
"""
import os
import threading
from collections import OrderedDict

import numpy as np

# Preludes and windows are a few hundred host bytes each (stacks live in
# the executor's byte-budgeted stack cache, not here).
DEFAULT_ENTRIES = 512

# Marker of compact contiguous slice keys. A real slices tuple holds only
# ints, so no exact-tuple key can collide with ("#range", first, last).
RANGE_MARK = "#range"


class SliceList(list):
    """A slice list that remembers its compact cache key. Treated as
    immutable: the executor shares one instance across queries."""

    __slots__ = ("skey",)


def slice_key(slices):
    """Compact, exact cache key of a slice list: a ``SliceList``'s own
    key; ``("#range", first, last)`` for a contiguous run of more than
    32 slices; the exact tuple otherwise (ref: pilosa_tpu plancache
    slice_key — the same keys for the same lists)."""
    k = getattr(slices, "skey", None)
    if k is not None:
        return k
    n = len(slices)
    if isinstance(slices, range):
        if n > 32 and slices.step == 1:
            return (RANGE_MARK, slices.start, slices.stop - 1)
        return tuple(slices)
    if n > 32 and slices[0] + n - 1 == slices[-1]:
        arr = np.asarray(slices)
        if bool(np.array_equal(arr, np.arange(arr[0], arr[-1] + 1))):
            return (RANGE_MARK, int(slices[0]), int(slices[-1]))
    return tuple(slices)


def as_slice_list(slices):
    """A ``SliceList`` of ``slices`` with its key computed once."""
    out = SliceList(slices)
    out.skey = slice_key(out)
    return out


def _universe(n):
    """``range(n)`` as a SliceList keyed ``("#range", 0, n - 1)`` at
    every length, as pilosa_tpu keys its universes."""
    out = SliceList(range(n))
    out.skey = (RANGE_MARK, 0, n - 1)
    return out


class PlanCache:
    """LRU of epoch-validated plan entries plus the per-index slice
    universe memo. Thread-safe: every operation is a few dict moves under
    one short lock. ``epoch_of(index)`` reads an index's current token
    for the snapshot (None: unknown)."""

    def __init__(self, capacity=None, epoch_of=None):
        if capacity is None:
            env = os.environ.get("PILOSA_PLAN_CACHE_ENTRIES")
            if env:
                try:
                    capacity = max(0, int(env))
                except ValueError:
                    capacity = DEFAULT_ENTRIES
            else:
                capacity = DEFAULT_ENTRIES
        self.capacity = int(capacity)
        self._epoch_of = epoch_of
        self._mu = threading.Lock()
        self._entries = OrderedDict()   # key -> (token, value)
        self._universe = {}             # index -> (token, std, inv)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self._by_index = {}             # index -> [hits, misses]

    def set_capacity(self, capacity):
        """Resize; shrinking evicts LRU-first, 0 wipes and disables."""
        with self._mu:
            self.capacity = max(0, int(capacity))
            if self.capacity == 0:
                self._entries.clear()
                self._universe.clear()
                return
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    # ------------------------------------------------------------ entries

    def _note(self, index, hit):
        """Per-index hit/miss tally. Caller holds self._mu."""
        st = self._by_index.get(index)
        if st is None:
            st = self._by_index[index] = [0, 0]
        st[0 if hit else 1] += 1

    def get(self, key, token, record=True):
        """The value of ``key`` when its stored token equals ``token``
        (LRU-refreshing); None on a miss. A stale entry is dropped and
        counts as an invalidation; ``token=None`` misses and drops
        nothing. ``record=False`` skips the hit/miss counters, for a
        caller whose lookup succeeds only after a second step and who
        calls ``record()`` with the outcome."""
        index = key[1]
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                if record:
                    self.misses += 1
                    self._note(index, False)
                return None
            if token is None or ent[0] != token:
                if token is not None:
                    del self._entries[key]
                    self.invalidations += 1
                if record:
                    self.misses += 1
                    self._note(index, False)
                return None
            self._entries.move_to_end(key)
            if record:
                self.hits += 1
                self._note(index, True)
            return ent[1]

    def peek(self, key, token):
        """The value of ``key`` when its token equals ``token``, else
        None: no LRU refresh, no counters, no drop."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None or token is None or ent[0] != token:
                return None
            return ent[1]

    def record(self, index, hit):
        """Count a deferred lookup outcome (see ``get(record=False)``)."""
        with self._mu:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
            self._note(index, hit)

    def put(self, key, token, value):
        """Store; a no-op when disabled or the token is None."""
        if token is None or self.capacity == 0:
            return
        with self._mu:
            if self.capacity == 0:
                return
            self._entries.pop(key, None)
            while len(self._entries) >= self.capacity and self._entries:
                self._entries.popitem(last=False)
            self._entries[key] = (token, value)

    def entries_view(self, kinds=None):
        """{key: value} of the entries (of the given kinds)."""
        with self._mu:
            return {k: v[1] for k, v in self._entries.items()
                    if kinds is None or k[0] in kinds}

    # ----------------------------------------------------------- universe

    def slice_universe(self, index, idx):
        """The index's (standard, inverse) slice lists as shared
        ``SliceList``s, memoized on its epoch and the maxima peers
        reported (which heartbeats and create-slice messages widen
        without an epoch move): no ``max_slice()`` walk over every view
        of every frame per query. The token is read before the walk, so
        a write landing mid-walk makes the memo stale on arrival, never
        wrong."""
        token = (idx.epoch.value, idx.remote_max_slice,
                 idx.remote_max_inverse_slice)
        if self.capacity != 0:
            with self._mu:
                ent = self._universe.get(index)
                if ent is not None and ent[0] == token:
                    self.hits += 1
                    self._note(index, True)
                    return ent[1], ent[2]
                self.misses += 1
                self._note(index, False)
        std = _universe(idx.max_slice() + 1)
        inv = _universe(idx.max_inverse_slice() + 1)
        if self.capacity != 0:
            with self._mu:
                if self.capacity != 0:
                    self._universe[index] = (token, std, inv)
        return std, inv

    def drop_index(self, index):
        """Drop every entry and the stats of ``index`` (its deletion)."""
        with self._mu:
            self._universe.pop(index, None)
            self._by_index.pop(index, None)
            dead = [k for k in self._entries if k[1] == index]
            for k in dead:
                del self._entries[k]
            self.invalidations += len(dead)

    # -------------------------------------------------------------- intro

    def metrics(self):
        """Flat counters; ``entries`` is the LRU's occupancy, universe
        memos report apart."""
        with self._mu:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "entries": len(self._entries),
                "universe_entries": len(self._universe),
                "capacity": self.capacity,
            }

    def snapshot(self):
        """Totals, per-index hit rates and validity epochs, entries per
        kind, and the universe memos."""
        with self._mu:
            total = self.hits + self.misses
            kinds = {}
            for k in self._entries:
                kinds[k[0]] = kinds.get(k[0], 0) + 1
            per_index = {}
            for index, (h, m) in self._by_index.items():
                per_index[index] = {
                    "hits": h, "misses": m,
                    "hitRate": round(h / (h + m), 4) if h + m else 0.0,
                    "validityEpoch": (self._epoch_of(index)
                                      if self._epoch_of else None),
                }
            universe = {
                index: {"slices": len(std), "inverseSlices": len(inv),
                        "token": tok}
                for index, (tok, std, inv) in self._universe.items()}
            return {
                "enabled": self.capacity != 0,
                "capacity": self.capacity,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "hitRate": round(self.hits / total, 4) if total else 0.0,
                "entriesByKind": kinds,
                "perIndex": per_index,
                "universe": universe,
            }
