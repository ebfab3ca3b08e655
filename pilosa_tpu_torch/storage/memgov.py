"""Host-memory governor: bounded fragment residency with LRU eviction
(counterpart of pilosa_tpu/storage/memgov.py, a copy of its logic).

The reference opens a fragment by mmap and lets the OS evict cold pages
(fragment.go:190-247, roaring.go:698-716), so host RSS is bounded by
page reclaim. Fragments here load dense row matrices into host RAM, so
the same economics need an explicit governor: every resident fragment
registers its host bytes, each access stamps an LRU clock, and while
the budget is exceeded the least-recently-used fragments are unloaded
(their matrices and device mirrors dropped; the roaring file and op log
stay the durable source, so the next touch faults the state back in,
like a page fault).

The budget comes from ``Holder(host_bytes=…)`` or the
``PILOSA_TPU_HOST_BYTES`` environment variable; None means unlimited
(tracking only).
"""
import itertools
import threading


class HostMemGovernor:
    def __init__(self, budget_bytes=None):
        self.budget = budget_bytes
        self._mu = threading.Lock()
        self._resident = {}          # fragment -> registered host bytes
        self._clock = itertools.count(1)
        self.evictions = 0           # fragments unloaded by budget
        self.faults = 0              # fragment fault-ins (reloads)

    def touch(self, frag):
        """Stamp access recency. Lock-free: a torn read of the stamp
        only perturbs LRU order, never correctness."""
        frag._last_used = next(self._clock)

    def update(self, frag, nbytes):
        """Re-register a fragment's host bytes (0 = gone) and evict LRU
        fragments while over budget. Victims are unloaded OUTSIDE the
        governor lock and WITHOUT blocking on their fragment locks: the
        caller typically holds its own fragment's lock, and two threads
        faulting in while each evicts the other's fragment would
        otherwise deadlock (ABBA). A contended victim is skipped (it is
        busy, hence not least recently used in spirit) and stays
        registered for the next update to retry.

        Eviction runs down to a low-water mark (90% of the budget), not
        to the budget's edge: a working set just over budget would
        otherwise evict one peer per update, whose next read evicts
        another — one-for-one churn paying an LRU sort per read."""
        victims = []
        with self._mu:
            if nbytes:
                self._resident[frag] = nbytes
            else:
                self._resident.pop(frag, None)
            if self.budget is not None:
                total = sum(self._resident.values())
                if total > self.budget:
                    low_water = int(self.budget * 0.9)
                    # Never the fragment being registered: it is
                    # mid-operation under its own lock.
                    order = sorted(
                        (f for f in self._resident if f is not frag),
                        key=lambda f: f._last_used)
                    for f in order:
                        if total <= low_water:
                            break
                        b = self._resident.pop(f)
                        total -= b
                        victims.append((f, b))
        for f, b in victims:
            out = f.unload(blocking=False)
            if out:  # True: resident state actually dropped
                with self._mu:
                    self.evictions += 1
            elif out is None and f._resident:
                # Lock-contended but still resident: re-register so a
                # later pass retries (False: it closed or unloaded
                # itself in the gap; do not resurrect it).
                with self._mu:
                    self._resident.setdefault(f, b)

    def resident_bytes(self):
        with self._mu:
            return sum(self._resident.values())

    def resident_count(self):
        with self._mu:
            return len(self._resident)

    def note_fault(self):
        with self._mu:
            self.faults += 1

    def snapshot(self):
        """The governor's gauges."""
        with self._mu:
            return {
                "budgetBytes": self.budget or 0,
                "residentBytes": sum(self._resident.values()),
                "residentFragments": len(self._resident),
                "evictions": self.evictions,
                "faults": self.faults,
            }
