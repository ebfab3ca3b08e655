"""Fragment — one (index, frame, view, slice) bitmap matrix
(ref: fragment.go; counterpart of pilosa_tpu/storage/fragment.py).

Column windows. Rows hold only a power-of-two WINDOW of 64-bit words
covering the columns the fragment's data touches: width from 64 words
(4,096 columns) up, base aligned to the width anywhere in the slice.
Words outside the window are zero by construction; the external APIs
pad on the way out (``row_words``, ``device_row``). A row-heavy,
column-narrow fragment — 500,000 molecule rows × 4,096 fingerprint
columns, the reference's chemical-similarity showcase — costs 512 bytes
a row instead of 128 KiB.

When resident, the fragment keeps two mirrors of the same bits:

- a host ``numpy uint64[capacity, w]`` row matrix (w the window's
  words) — the mutation target and serialization source;
- a device ``int32[rows, 2·w]`` tensor on the fragment's device — the
  compute surface of ``top()`` and the serial path. A little-endian view
  makes the two layouts identical, so a refresh is a plain copy. Rows
  dirtied by writes are copied in when a query next asks for the
  mirror; the refresh is out of place, so tensors handed out earlier
  never change under their holder.

Lazy residency (ref: pilosa_tpu fragment.py:468-565). ``open()`` takes
the file and the lock and reads nothing. The first operation that needs
the matrices takes the fragment's lock, a ``_ResidencyLock``, whose
enter faults them in from the roaring file (the TopN cache sidecar with
them). Reads that need no matrix — a row's words or count, the column
window, the rows, a Src-less TopN, BSI planes, cache ids — serve an
open but non-resident fragment from an mmap ``codec.LazyReader``,
container by container, and never fault it in. A host-memory governor
(``storage/memgov.py``), wired down from the holder, charges every
fragment's host bytes (matrices or lazy memos) and unloads the least
recently used when over budget; the file and op log stay the durable
source. Readers are capped process-wide (``reader_cap``): each mmap pins
a descriptor.

Durability follows the reference: every set/clear appends a 13-byte
op-log record to the roaring file (roaring.go:740) before memory flips;
once the log outgrows ``max(MAX_OPN, cardinality/2)`` records the file
is rewritten through an atomic temp-file rename (``snapshot()``,
fragment.go:1369-1438). The file format is shared with pilosa_tpu.

Each fragment keeps the frame's TopN cache (``storage/cache.py``):
restored from the ``.cache`` sidecar at fault-in, kept current by every
write, written back on unload and close. ``top()`` ranks exact counts
— host row counts, or the ``count_and_rows`` kernel against a Src row
on the device — over the rows the cache admits.

The compressed serving tier (ref: pilosa_tpu fragment.py:1583-1839).
``row_container`` serves one row as a ``containers.Container`` chosen by
the roaring thresholds: sorted positions (at most 4,096 bits), runs, or
the dense device row with its known count. Compressed containers are
memoized per (row, version), at most 8,192 a fragment, keyed by the
physical row or by ``("lazy", row)`` on a non-resident fragment (lazy
ones are governor-charged and dropped with the lazy memos); a rebuild
in another format is a conversion. ``row_compressed`` tells the
executor whether a row of a non-resident fragment serves compressed,
and ``container_stats`` rolls the tier up by format for
``memory_stats``.

A BSI field's fragment (view ``field_<name>``) holds the value bits in
rows 0..depth-1 and the not-null row ``depth``; ``planes_win`` hands
them to the descents of ``ops/bsi.py`` as one device matrix.

A fragment under a holder holds no per-file lock: the holder's
directory lock covers it.
"""
import io
import itertools
import json
import os
import resource
import tarfile
import threading

import numpy as np
import torch

from pilosa_tpu_torch import SLICE_WIDTH, WORDS_PER_SLICE
from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import containers
from pilosa_tpu_torch.ops import topn as topn_ops
from pilosa_tpu_torch.roaring import codec
from pilosa_tpu_torch.storage.cache import NopCache, new_cache

WORDS64 = SLICE_WIDTH // 64  # 16384 host words per row

# Snapshot after this many op-log records (ref: fragment.go:67 MaxOpN),
# scaled with cardinality and capped as pilosa_tpu does.
MAX_OPN = 2000
OPLOG_MAX_OPS = 4_000_000

_CONTAINERS_PER_ROW = SLICE_WIDTH // (1 << 16)  # 16
_WORDS64_PER_CONTAINER = 1024

# The narrowest column window, in 64-bit words (4,096 columns).
_MIN_W64 = 64

# A lazy read declined (the fragment is resident, or its file cannot be
# read lazily): the caller takes the resident path.
_NOT_LAZY = object()

# Moves whenever a fragment becomes resident or leaves residency. A
# fault-in or an eviction moves no index epoch, so a route memoized on
# the epoch (the executor's compressed-plan verdict, which asks
# ``row_compressed``) reads this too.
_residency = itertools.count(1)
_residency_gen = 0


def residency_generation():
    return _residency_gen


def _residency_moved():
    global _residency_gen
    _residency_gen = next(_residency)

HOLDER_LOCK_NAME = ".holder.lock"

# Process-wide cap on live LazyReaders. An mmap holds a dup'd file
# descriptor for its lifetime, so at 10,000-slice scale readers — not
# bytes — are the scarce resource. LRU over the fragments holding one;
# past the cap the oldest fragment's reader is dropped (its memos stay).
# PILOSA_TPU_MAX_READERS sets the cap; unset, ``reader_cap`` derives it
# from the descriptor limit.
try:
    MAX_LAZY_READERS = int(os.environ["PILOSA_TPU_MAX_READERS"])
except (KeyError, ValueError):  # a malformed value must not break import
    MAX_LAZY_READERS = None
_reader_mu = threading.Lock()
_reader_lru = {}  # Fragment -> None (dicts keep insertion order)


def reader_cap():
    """Live LazyReaders allowed at once: ``MAX_LAZY_READERS`` when set,
    else the soft descriptor limit (which ``Holder.open`` raises toward
    the hard one) less 1,024 descriptors for the rest of the process,
    within [64, 32,768] — under the kernel's default of 65,530 mappings
    a process may hold. A plan then reads each file once as long as its
    fragments fit the cap."""
    if MAX_LAZY_READERS is not None:
        return max(MAX_LAZY_READERS, 1)
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    if soft == resource.RLIM_INFINITY:
        soft = 1 << 20
    return min(max(soft - 1024, 64), 32768)


def _note_reader(frag):
    """Record reader use (LRU recency) and drop readers past the cap.
    Victims are locked non-blocking: a contended one goes back to the
    oldest end, so the next creation retries it."""
    global _reader_lru
    victims = []
    with _reader_mu:
        _reader_lru.pop(frag, None)
        _reader_lru[frag] = None
        cap = reader_cap()
        while len(_reader_lru) > cap:
            v = next(iter(_reader_lru))
            if v is frag:
                break
            del _reader_lru[v]
            victims.append(v)
    for v in victims:
        if not v._drop_reader() and v._lazy is not None:
            with _reader_mu:
                if v not in _reader_lru:
                    _reader_lru = {v: None, **_reader_lru}


def _forget_reader(frag):
    with _reader_mu:
        _reader_lru.pop(frag, None)


def window_for(lo_word, hi_word, w=_MIN_W64):
    """(base, width) in 64-bit words of the narrowest power-of-two
    window, at least ``w`` wide with its base aligned to its width, that
    covers words [lo_word, hi_word]; the full slice when nothing
    narrower does."""
    while True:
        b = lo_word // w * w
        if hi_word < b + w or w >= WORDS64:
            break
        w *= 2
    if w >= WORDS64:
        return 0, WORDS64
    return b, w


def try_flock(path, err_cls, transient=False):
    """Nonblocking exclusive flock on ``path``; returns the held file
    (``transient`` probes and releases at once, returning None). Raises
    ``err_cls`` when another open file description holds it."""
    lock = open(path, "ab")
    try:
        import fcntl

        fcntl.flock(lock.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:
        lock.close()
        raise err_cls()
    except ImportError:  # non-POSIX platform
        pass
    if transient:
        lock.close()  # close releases the flock
        return None
    return lock


# Epoch values come from one process-wide sequence, so two epochs never
# share a value: an index deleted and created again under its old name
# cannot alias a stack cached for the old one.
_EPOCH_SEQ = itertools.count(1)


class MutationEpoch:
    """A value moved by every fragment open, close, load and mutation
    under one index: an O(1) "has anything changed?" test for the
    executor's device-stack cache, instead of re-reading every
    fragment's version per query."""

    def __init__(self):
        self._mu = threading.Lock()
        self.value = next(_EPOCH_SEQ)

    def bump(self):
        with self._mu:
            self.value = next(_EPOCH_SEQ)


class TopOptions:
    """TopN options (ref: fragment.go:1004-1021)."""

    def __init__(self, n=0, src=None, row_ids=None, filter_row_ids=None,
                 min_threshold=0, tanimoto_threshold=0):
        self.n = n
        self.src = src                      # int32[32768] device words
        self.row_ids = row_ids              # explicit candidate rows
        self.filter_row_ids = filter_row_ids  # rows an attr filter allows
        self.min_threshold = min_threshold
        self.tanimoto_threshold = tanimoto_threshold


class _ResidencyLock:
    """Re-entrant fragment lock whose enter faults the fragment in: the
    one choke point where a fragment opened lazily, or unloaded by the
    governor, reloads its matrices from the roaring file — the analog
    of the OS faulting an mmap'd page back in (ref: pilosa_tpu
    fragment.py:342-381)."""

    def __init__(self, frag):
        self._frag = frag
        self._lock = threading.RLock()

    def __enter__(self):
        self._lock.acquire()
        try:
            self._frag._fault_in_locked()
        except BaseException:
            self._lock.release()
            raise
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def acquire_raw(self, blocking=True):
        """Acquire WITHOUT faulting in (open/unload bookkeeping and lazy
        reads); with ``blocking=False``, whether it was taken."""
        return self._lock.acquire(blocking=blocking)

    def release_raw(self):
        self._lock.release()

    def owned(self):
        """True iff the current thread holds this lock."""
        return self._lock._is_owned()


class Fragment:
    _UID_SEQ = itertools.count()

    def __init__(self, path, index, frame, view, slice_num, device="cuda",
                 epoch=None, holder_locked=False, cache_type="ranked",
                 cache_size=50000):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice_num
        self.cache_type = cache_type
        self._cache = new_cache(cache_type, cache_size)
        self.device = torch.device(device)
        self.epoch = epoch if epoch is not None else MutationEpoch()
        self.holder_locked = holder_locked
        # Wired by the owning View; None: always resident once used.
        self.governor = None
        self._last_used = 0
        # Process-unique id: cache tokens pair it with _version so a
        # closed and reopened fragment never aliases a cache entry.
        self._uid = next(self._UID_SEQ)
        self.mu = _ResidencyLock(self)
        self._opened = False      # open() ran
        self._resident = False    # host matrices loaded
        self._faulting = False    # re-entrancy guard during a fault-in
        self._cache_loaded = False
        self._cap = 0
        self._w64 = _MIN_W64      # window width in 64-bit words
        self._w64_base = 0        # window base word (a multiple of _w64)
        self._matrix = np.zeros((0, _MIN_W64), dtype=np.uint64)
        self._row_counts = np.zeros(0, dtype=np.int64)
        self._row_index = {}   # rowID -> physical row
        self._phys_rows = []   # physical row -> rowID
        self.max_row_id = 0
        self.op_n = 0
        self._snap_card = None  # cardinality at the last snapshot
        self._op_file = None
        self._lock_file = None
        self._version = 0      # bumped on every mutation and load
        self._dev = None       # int32[rows, 2·w] device mirror
        self._dirty = set()    # physical rows stale in the mirror
        self._rc_dev = None    # (version, int32[rows] device row counts)
        self._row_dev = {}     # (phys, base32, width32) -> (version, row)
        self._planes_cache = {}  # key -> (version, int32 planes)
        self._win32_memo = None  # (version, (base32, width32) | None)
        # The lazy read path of an open, non-resident fragment: an mmap
        # reader and memos of what it decoded, all governor-charged.
        self._lazy = None
        self._lazy_rows = {}     # row_id -> {sub: uint64[1024]}
        self._lazy_bytes = 0     # bytes of the _lazy_rows blocks
        self._lazy_cache_ids = None  # the sidecar's TopN ids
        self._lazy_counts = {}   # row_id -> exact count
        # The compressed serving tier (ops/containers.py): phys, or
        # ("lazy", row_id) on a non-resident fragment -> (version,
        # Container) for ARRAY/RUN rows (a dense row wraps the mirror per
        # call), the last format each row served as (conversions), and
        # this fragment's conversions.
        self._cont_dev = {}
        self._cont_fmt = {}
        self._conversions = 0

    @property
    def cache(self):
        """TopN cache; reading it faults the fragment in (the sidecar's
        ids are counted against loaded rows)."""
        if self._opened and not self._resident:
            with self.mu:
                pass
        return self._cache

    @property
    def cache_path(self):
        return self.path + ".cache"

    # ------------------------------------------------------------------ io

    def open(self, lock_file=None):
        """Create the file when missing and take the lock; the rows load
        on first touch (the reference's mmap likewise reads no page at
        open, fragment.go:190-247). Touches no device. A view that
        listed the file passes ``lock_file`` (whether its ``.lock``
        exists) and the open makes no file-system call: at 10,000-slice
        scale with many views, per-fragment metadata calls dominate."""
        self.mu.acquire_raw()
        try:
            if self._opened:
                return self
            if lock_file is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                if not (os.path.exists(self.path)
                        and os.path.getsize(self.path) > 0):
                    with open(self.path, "wb") as f:
                        f.write(codec.serialize({}))
            self._acquire_lock(lock_file)
            self._op_file = None
            self.op_n = 0  # the fault-in or a lazy parse sets it
            self._opened = True
            self.epoch.bump()
        finally:
            self.mu.release_raw()
        return self

    def _fault_in_locked(self):
        """Load the matrices from the roaring file (under the lock, from
        ``_ResidencyLock.__enter__``). A torn op-log tail (a crash
        mid-append) keeps the valid prefix and is rewritten away."""
        if self._resident or self._faulting or not self._opened:
            if self._resident and self.governor is not None:
                self.governor.touch(self)
            return
        self._faulting = True
        try:
            # Mutations and snapshots may follow: the reader goes stale.
            self._drop_lazy_locked()
            with open(self.path, "rb") as f:
                raw = f.read()
            if not raw:  # created and never written: give it its header
                raw = codec.serialize({})
                with open(self.path, "wb") as f:
                    f.write(raw)
            # The file's bytes are what the stacks were built from: a
            # fault-in moves neither the version nor the epoch, so
            # stacks and result memos survive an eviction.
            self.op_n, torn = self._load_file_locked(raw, bump=False)
            if self._snap_card is None:
                self._snap_card = int(self._row_counts.sum())
            self._resident = True
            _residency_moved()
            if torn:
                self.snapshot()
            if not self._cache_loaded:
                self._open_cache()
                self._cache_loaded = True
        finally:
            self._faulting = False
        if self.governor is not None:
            self.governor.touch(self)
            self.governor.note_fault()
            self.governor.update(self, self.host_bytes())

    def close(self):
        self.mu.acquire_raw()
        try:
            self.epoch.bump()
            # The next read after a close()+open() loads from disk.
            self._version += 1
            self._drop_lazy_locked()
            if self._cache_loaded:
                self._flush_cache_locked()
            self._cache.clear()  # a reopen restores it from the sidecar
            if self._op_file is not None:
                self._op_file.close()
                self._op_file = None
            self._release_lock()
            self._opened = False
            self._resident = False
            _residency_moved()
            self._cache_loaded = False
            self._reset_storage_locked()
        finally:
            self.mu.release_raw()
        if self.governor is not None:
            self.governor.update(self, 0)

    def _acquire_lock(self, lock_file=None):
        """Guard against a second open of this fragment (ref:
        syscall.Flock fragment.go:203-205), with pilosa_tpu's protocol:
        under a holder only a transient probe of the per-file ``.lock``
        (the holder's directory lock covers the tree; ``lock_file`` says
        whether it exists when a listing knows); standalone, a probe of
        any enclosing ``.holder.lock``, then a held ``.lock``."""
        if self.holder_locked:
            if lock_file is None:
                lock_file = os.path.exists(self.path + ".lock")
            if lock_file:
                try_flock(self.path + ".lock", perr.ErrFragmentLocked,
                          transient=True)
            return
        d = os.path.dirname(os.path.abspath(self.path))
        for _ in range(6):  # fragments sit 5 levels below a holder root
            marker = os.path.join(d, HOLDER_LOCK_NAME)
            if os.path.exists(marker):
                try_flock(marker, perr.ErrFragmentLocked, transient=True)
                break
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
        self._lock_file = try_flock(self.path + ".lock",
                                    perr.ErrFragmentLocked)

    def _release_lock(self):
        if self._lock_file is not None:
            self._lock_file.close()
            self._lock_file = None

    # ----------------------------------------------------------- residency

    def host_bytes(self):
        """Host bytes this fragment holds (the governor's unit): the
        matrices, plus the lazy-read memos."""
        return int(self._matrix.nbytes + self._row_counts.nbytes
                   + self.lazy_bytes())

    def _mem_changed(self):
        """Report a matrix reallocation to the governor."""
        if self.governor is not None and self._resident:
            self.governor.update(self, self.host_bytes())

    def memory_stats(self):
        """Where this fragment's bytes live: host matrices (when
        resident), device tensors (the mirror, row counts, rebased rows
        and planes), lazy-read memos, the file on disk, TopN cache
        entries (ref: pilosa_tpu fragment.py:726-778). Lock-free: a
        racing mutation may read the pre-write state."""
        dev = 0
        if self._dev is not None:
            dev += self._dev.nbytes
        rc = self._rc_dev
        if rc is not None:
            dev += rc[1].nbytes
        for memo in list(self._row_dev.values()):
            dev += memo[1].nbytes
        for memo in list(self._planes_cache.values()):
            dev += memo[1].nbytes
        for memo in list(self._cont_dev.values()):
            dev += memo[1].device_bytes()
        resident = self._resident
        try:
            disk = os.path.getsize(self.path)
        except OSError:
            disk = 0
        return {
            "resident": resident,
            "hostBytes": (int(self._matrix.nbytes + self._row_counts.nbytes)
                          if resident else 0),
            "deviceBytes": int(dev),
            "lazyBytes": int(self.lazy_bytes()),
            "diskBytes": int(disk),
            "cacheEntries": len(self._cache),
            "containers": self.container_stats(),
        }

    def unload(self, blocking=True):
        """Drop the matrices and device tensors; the roaring file and op
        log stay the durable source, so the next touch faults it all back
        in (ref: pilosa_tpu fragment.py:780-844). The governor calls it
        with ``blocking=False``: a busy fragment is skipped, not waited
        on (the evictor may hold another fragment's lock). True when
        state was dropped, False when there was none, None when the lock
        was contended."""
        if not blocking and self.mu.owned():
            # A re-entrant acquire would succeed and gut state an outer
            # frame of this thread is using.
            return None
        if not self.mu.acquire_raw(blocking=blocking):
            return None
        try:
            if not self._resident:
                # Evicted already, but maybe holding lazy memos: they
                # are charged too, so one eviction frees everything.
                if (self._lazy is None and not self._lazy_rows
                        and self._lazy_cache_ids is None
                        and not self._lazy_planes_bytes()
                        and not any(isinstance(k, tuple)
                                    for k in self._cont_dev)):
                    return False
                self._drop_lazy_locked()
            else:
                self._drop_lazy_locked()
                if self._op_file is not None:
                    # Evicted fragments hold no descriptor.
                    self._op_file.close()
                    self._op_file = None
                if self._cache_loaded:
                    self._flush_cache_locked()
                self._resident = False
                _residency_moved()
                # The file is unchanged: the version and the index's
                # epoch stay, so stacks and result memos built from it
                # stay valid across the eviction and the next fault-in.
                self._reset_storage_locked(bump=False)
        finally:
            self.mu.release_raw()
        if self.governor is not None:
            self.governor.update(self, 0)
        return True

    def _drop_lazy_locked(self):
        """Drop the reader and every lazy memo (the file is about to be
        rewritten or appended, the fragment closes, or the governor
        evicts it). Keeps ``_version``: the file's bytes did not change,
        so stacks built from them stay valid (ref: pilosa_tpu
        fragment.py:846-905)."""
        if self._lazy is not None:
            self._lazy.close()
            self._lazy = None
            _forget_reader(self)
        self._lazy_rows = {}
        self._lazy_bytes = 0
        self._lazy_cache_ids = None
        self._lazy_counts = {}
        if any(k[0] == "lazy" for k in self._planes_cache):
            self._planes_cache = {k: v for k, v in self._planes_cache.items()
                                  if k[0] != "lazy"}
        for name in ("_cont_dev", "_cont_fmt"):
            memo = getattr(self, name)
            if any(isinstance(k, tuple) for k in memo):
                setattr(self, name, {k: v for k, v in memo.items()
                                     if not isinstance(k, tuple)})

    def _drop_reader(self):
        """Release the mmap reader ONLY (the reader cap): memos stay and
        a miss recreates it. False when the lock was contended."""
        if not self.mu.acquire_raw(blocking=False):
            return False
        try:
            if self._lazy is not None:
                self._lazy.close()
                self._lazy = None
        finally:
            self.mu.release_raw()
        return True

    def lazy_bytes(self):
        """Host bytes of the lazy read path: decoded blocks, planes,
        count and cache-id memos, and the reader's parsed header and op
        index."""
        reader = self._lazy
        overhead = 0
        if reader is not None:
            overhead = len(reader.metas) * 64 + reader.op_index_bytes
        overhead += len(self._lazy_counts) * 64
        if self._lazy_cache_ids is not None:
            overhead += 32 + len(self._lazy_cache_ids) * 32
        overhead += self._lazy_planes_bytes()
        # Containers built from lazy decodes are charged like every other
        # lazy memo, so an evicted index's serving tier stays in budget.
        overhead += sum(v[1].nbytes() for k, v in list(self._cont_dev.items())
                        if isinstance(k, tuple))
        return self._lazy_bytes + overhead

    def _lazy_planes_bytes(self):
        return sum(v[1].nbytes for k, v in self._planes_cache.items()
                   if k[0] == "lazy")

    def _lazy_serve(self, fn, memo=None):
        """Serve one read from the mmap reader while the fragment is
        open but not resident, under the raw lock (no fault-in); returns
        _NOT_LAZY when it is resident (or its file unreadable lazily),
        and the caller takes the resident path. With ``memo`` (true when
        a memo answers the read) no reader is created for a hit: on a
        remote file system opening a file costs more than the read."""
        if self._resident or not self._opened:
            return _NOT_LAZY  # cheap pre-check; verified under the lock
        self.mu.acquire_raw()
        try:
            if self._resident or not self._opened:
                return _NOT_LAZY
            created = False
            if self._lazy is None and (memo is None or not memo()):
                try:
                    self._lazy = codec.LazyReader(self.path)
                except (OSError, ValueError):
                    return _NOT_LAZY
                created = True
                self.op_n = self._lazy.op_n
            if self._lazy is not None:
                _note_reader(self)
            before = self.lazy_bytes()
            out = fn(self._lazy)
            changed = created or self.lazy_bytes() != before
            charge = self.host_bytes() if changed else None
        finally:
            self.mu.release_raw()
        if self.governor is not None:
            self.governor.touch(self)
            if charge is not None:
                # Only on growth or shrink: update() takes a global lock
                # and sums the budget.
                self.governor.update(self, charge)
        return out

    def _lazy_row_blocks(self, reader, row_id):
        """{sub: uint64[1024]} populated containers of one row, decoded
        from O(row) containers and memoized (16 rows, oldest out)."""
        memo = self._lazy_rows.get(row_id)
        if memo is not None:
            return memo
        blocks = {}
        base_key = row_id * _CONTAINERS_PER_ROW
        for sub in range(_CONTAINERS_PER_ROW):
            block = reader.container(base_key + sub)
            if block is not None:
                blocks[sub] = block
        if len(self._lazy_rows) >= 16:
            old = self._lazy_rows.pop(next(iter(self._lazy_rows)))
            self._lazy_bytes -= sum(b.nbytes for b in old.values())
        self._lazy_rows[row_id] = blocks
        self._lazy_bytes += sum(b.nbytes for b in blocks.values())
        return blocks

    @staticmethod
    def _blit_block(dst, block, sub, b64, w64):
        """Copy container ``sub``'s overlap with the word span [b64,
        b64 + w64) into ``dst`` (uint64[w64])."""
        cbase = sub * _WORDS64_PER_CONTAINER
        lo = max(cbase, b64)
        hi = min(cbase + _WORDS64_PER_CONTAINER, b64 + w64)
        if lo < hi:
            dst[lo - b64:hi - b64] = block[lo - cbase:hi - cbase]

    def _lazy_row64_span(self, reader, row_id, b64, w64):
        """uint64[w64] host words [b64, b64 + w64) of one row, from its
        memoized container blocks."""
        row = np.zeros(w64, dtype=np.uint64)
        for sub, block in self._lazy_row_blocks(reader, row_id).items():
            self._blit_block(row, block, sub, b64, w64)
        return row

    def _lazy_fill(self, reader, row_id, b64, w64, out):
        """Decode only the containers of one row that overlap [b64, b64 +
        w64) into ``out``, bypassing the row memo: a stack build reads
        each (fragment, row) once, and memoizing every stacked row would
        hold a second host copy of the whole stack."""
        memo = self._lazy_rows.get(row_id)
        if memo is None:
            reader.fill_row(row_id, b64, w64, out)
            return True
        for sub, block in memo.items():
            self._blit_block(out, block, sub, b64, w64)
        return True

    def _lazy_row_count(self, reader, row_id):
        """Exact count of one row of a non-resident fragment, memoized
        (65,536 rows, oldest out)."""
        cnt = self._lazy_counts.get(row_id)
        if cnt is None:
            cnt = reader.row_count(row_id)
            while len(self._lazy_counts) >= 65536:
                self._lazy_counts.pop(next(iter(self._lazy_counts)))
            self._lazy_counts[row_id] = cnt
        return cnt

    def _lazy_row_ids(self, reader):
        return sorted({k // _CONTAINERS_PER_ROW for k in reader.keys()})

    def cache_entry_ids(self):
        """TopN candidate row ids (the cache's membership) without
        faulting in: the loaded cache when resident, else the sidecar's
        ids (batched TopN phase 1 reads this for every fragment of a
        slice list)."""
        if isinstance(self._cache, NopCache):
            return frozenset()
        if not self._resident and self._opened:
            self.mu.acquire_raw()
            try:
                if not self._resident and self._opened:
                    fresh = (self._lazy_cache_ids is None
                             and not self._cache_loaded)
                    out = frozenset(self._lazy_cache_ids_locked())
                else:
                    fresh, out = False, None
            finally:
                self.mu.release_raw()
            if out is not None:
                if self.governor is not None:
                    self.governor.touch(self)
                    if fresh:
                        self.governor.update(self, self.host_bytes())
                return out
        with self.mu:
            return frozenset(self._cache.entries)

    def _lazy_cache_ids_locked(self):
        if self._cache_loaded:
            return list(self._cache.entries)
        ids = self._lazy_cache_ids
        if ids is None:
            try:
                with open(self.cache_path) as f:
                    ids = json.load(f)
            except (OSError, ValueError):
                ids = []
            self._lazy_cache_ids = ids
        return ids

    def _lazy_top(self, reader, opt):
        """Src-less TopN on a non-resident fragment: candidates from the
        cache sidecar (or ``opt.row_ids``), exact counts from header
        cardinalities — the resident walk's semantics, no fault-in."""
        if opt.row_ids is not None:
            allowed = set(opt.row_ids)
        else:
            if isinstance(self._cache, NopCache):
                return []
            allowed = set(self._lazy_cache_ids_locked())
        if opt.filter_row_ids is not None:
            allowed &= set(opt.filter_row_ids)
        pairs = []
        for rid in allowed:
            cnt = self._lazy_row_count(reader, rid)
            if cnt <= 0 or cnt < opt.min_threshold:
                continue
            pairs.append((int(rid), int(cnt)))
        pairs.sort(key=lambda rc: (-rc[1], rc[0]))
        if opt.n and opt.row_ids is None:
            pairs = pairs[:opt.n]
        return pairs

    def _lazy_planes(self, reader, depth, base32, width32):
        """Windowed BSI planes from container decodes, memoized like the
        resident build (the version is stable while the reader lives)."""
        key = ("lazy", depth, base32, width32)
        cached = self._planes_cache.get(key)
        if cached and cached[0] == self._version:
            return cached[1]
        b64, w64 = base32 // 2, width32 // 2
        mat = np.zeros((depth + 1, w64), dtype=np.uint64)
        for i in range(depth + 1):
            self._lazy_fill(reader, i, b64, w64, mat[i])
        planes = torch.from_numpy(mat.view(np.int32)).to(self.device)
        self._planes_cache = {key: (self._version, planes)}
        return planes

    def _lazy_win32(self, reader):
        """The column window from container spans (not just keys: a
        key's container is 1,024 words, which over-covers clustered data
        up to 16×)."""
        span = reader.slice_span()
        if span is None:
            return None
        b, w = window_for(*span)
        return b * 2, w * 2

    # ----------------------------------------------------------- TopN cache

    def _open_cache(self):
        """Restore the TopN cache from its sidecar (ref: fragment.go:
        250-289); counts come from storage, the sidecar carries ids."""
        if not os.path.exists(self.cache_path):
            return
        try:
            with open(self.cache_path) as f:
                ids = json.load(f)
        except (ValueError, OSError):
            return
        for row_id in ids:
            phys = self._row_index.get(row_id)
            if phys is not None:
                self._cache.bulk_add(row_id, int(self._row_counts[phys]))
        self._cache.invalidate()

    def _flush_cache_locked(self):
        with open(self.cache_path, "w") as f:
            json.dump(self._cache.ids(), f)

    def flush_cache(self):
        """Write the TopN cache's ids to the ``.cache`` sidecar; a
        fragment never loaded has nothing newer than its sidecar."""
        self.mu.acquire_raw()
        try:
            if self._cache_loaded:
                self._flush_cache_locked()
        finally:
            self.mu.release_raw()

    def recalculate_cache(self):
        """Rebuild the TopN cache from storage counts (ref: Cache.
        Recalculate via handleRecalculateCaches handler.go:2016)."""
        with self.mu:
            for phys, row_id in enumerate(self._phys_rows):
                n = int(self._row_counts[phys])
                if n:
                    self._cache.bulk_add(row_id, n)
            self._cache.invalidate()

    # ------------------------------------------------------------- durability

    def _op_handle_locked(self):
        if not self._opened:
            raise ValueError(f"fragment {self.path} is not open")
        if self._op_file is None:
            self._op_file = open(self.path, "ab")
        return self._op_file

    def _append_ops_locked(self, data, fsync=False):
        """Append op records BEFORE memory changes: a failed write
        raises with memory still on the acknowledged prefix."""
        op = self._op_handle_locked()
        op.write(data)
        op.flush()
        if fsync:
            os.fsync(op.fileno())

    def _to_arrays_locked(self):
        """(sorted uint64[n] container keys, uint64[n, w] blocks) of the
        non-empty containers; w is 1024, or the window's width when the
        window lies inside one container at its start (the encoder takes
        narrow blocks)."""
        n = len(self._phys_rows)
        row_ids = np.asarray(self._phys_rows, dtype=np.uint64)
        w, base = self._w64, self._w64_base
        if n == 0:
            return (np.zeros(0, np.uint64),
                    np.zeros((0, _WORDS64_PER_CONTAINER), np.uint64))
        if w >= _WORDS64_PER_CONTAINER:
            # base is a multiple of w >= 1024: container-aligned.
            c0 = base // _WORDS64_PER_CONTAINER
            tiled = self._matrix[:n].reshape(
                n, w // _WORDS64_PER_CONTAINER, _WORDS64_PER_CONTAINER)
            phys_idx, sub_idx = np.nonzero(tiled.any(axis=2))
            keys = (row_ids[phys_idx] * np.uint64(_CONTAINERS_PER_ROW)
                    + (sub_idx + c0).astype(np.uint64))
            order = np.argsort(keys, kind="stable")  # phys != key order
            return keys[order], tiled[phys_idx[order], sub_idx[order]]
        # A narrow window lies inside one container.
        phys_idx = np.flatnonzero(self._matrix[:n].any(axis=1))
        c0, off = divmod(base, _WORDS64_PER_CONTAINER)
        keys = row_ids[phys_idx] * np.uint64(_CONTAINERS_PER_ROW) + \
            np.uint64(c0)
        order = np.argsort(keys, kind="stable")
        rows = self._matrix[:n][phys_idx[order]]
        if off == 0:
            return keys[order], np.ascontiguousarray(rows)
        blocks = np.zeros((len(phys_idx), _WORDS64_PER_CONTAINER), np.uint64)
        blocks[:, off:off + w] = rows
        return keys[order], blocks

    def snapshot(self):
        """Atomic full rewrite + op-log reset (ref: fragment.go:1393-1438):
        the previous file stays intact until the rename."""
        with self.mu:
            self._drop_lazy_locked()  # the file is about to be rewritten
            data = codec.serialize_arrays(*self._to_arrays_locked())
            tmp = self.path + ".snapshotting"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                if self._op_file is not None:
                    self._op_file.close()
                    self._op_file = None
                os.replace(tmp, self.path)
            except OSError:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            self.op_n = 0
            self._snap_card = int(self._row_counts.sum())

    def _op_log_room(self, extra):
        """True while appending ``extra`` more ops beats snapshotting."""
        snap = self._snap_card or 0
        limit = max(MAX_OPN, min(snap // 2, OPLOG_MAX_OPS))
        return self.op_n + extra <= limit

    # ------------------------------------------------------- row plumbing

    def _load_file_locked(self, data, bump=True):
        """Replace the matrices with roaring ``data`` (a snapshot and its
        op log) at the data's own window; returns (op count, torn).
        ``bump=False`` (a fault-in of the fragment's own file) keeps the
        version and the index's epoch.
        Containers decode straight into the window (``codec.
        fill_window``), the op log's net effect applies on top, and the
        window is then narrowed to the words that hold bits — what the
        reference's ``_load_blocks`` allocates."""
        header = codec.parse_header(data)
        keys, _, _, _, data_end = header
        typs, values, torn = codec.parse_ops(bytes(data[data_end:]))
        adds, removes = codec.final_ops(typs, values)
        self._reset_storage_locked(bump)
        rows = np.unique(np.concatenate([
            keys // np.uint64(_CONTAINERS_PER_ROW),
            values // np.uint64(SLICE_WIDTH)]))
        if len(rows) == 0:
            return len(typs), torn
        lo, hi = codec.container_spans(data, header)
        have = lo >= 0
        sub = (keys % np.uint64(_CONTAINERS_PER_ROW)).astype(np.int64) \
            * _WORDS64_PER_CONTAINER
        words = np.concatenate([
            sub[have] + lo[have], sub[have] + hi[have],
            ((adds % np.uint64(SLICE_WIDTH)) >> np.uint64(6)).astype(
                np.int64)])
        if len(words):
            self._w64_base, self._w64 = window_for(int(words.min()),
                                                   int(words.max()))
            self._matrix = np.zeros((0, self._w64), dtype=np.uint64)
        self._grow_rows_locked(len(rows))
        self._phys_rows = rows.tolist()
        self._row_index = {r: i for i, r in enumerate(self._phys_rows)}
        self.max_row_id = self._phys_rows[-1]
        phys = np.searchsorted(rows, keys // np.uint64(_CONTAINERS_PER_ROW))
        codec.fill_window(data, header, phys, self._matrix, self._w64_base)
        for vals, is_add in ((adds, True), (removes, False)):
            if len(vals):
                self._scatter_positions_locked(vals, is_add)
        used = np.flatnonzero(self._matrix[:len(rows)].any(axis=0))
        if len(used) == 0:
            self._rewindow_locked(0, _MIN_W64)
        else:
            self._rewindow_locked(*window_for(
                self._w64_base + int(used[0]),
                self._w64_base + int(used[-1])))
        self._recount_rows_locked(range(len(rows)))
        if bump:
            self._touch_locked(range(len(rows)))
        else:
            self._dirty.update(range(len(rows)))
        return len(typs), torn

    def _scatter_positions_locked(self, positions, set_value):
        """Set (or clear) the bits at slice positions row·2^20 + col of
        existing rows; a cleared bit outside the window is already
        zero."""
        rows = positions // np.uint64(SLICE_WIDTH)
        words = ((positions % np.uint64(SLICE_WIDTH)) >> np.uint64(6)
                 ).astype(np.int64) - self._w64_base
        inside = (words >= 0) & (words < self._w64)
        uniq, inverse = np.unique(rows[inside], return_inverse=True)
        phys = np.asarray([self._row_index[r] for r in uniq.tolist()],
                          dtype=np.int64)[inverse]
        words, positions = words[inside], positions[inside]
        masks = np.uint64(1) << (positions & np.uint64(63))
        key = phys * np.int64(self._w64) + words
        order, starts, _, folded = codec.group_sorted(key)
        ored = np.bitwise_or.reduceat(masks[order], starts)
        if set_value:
            self._matrix[folded // self._w64, folded % self._w64] |= ored
        else:
            self._matrix[folded // self._w64, folded % self._w64] &= ~ored

    def _rewindow_locked(self, b2, w2):
        """Move the matrix to the window [b2, b2 + w2), which must cover
        every word holding a bit."""
        if (b2, w2) == (self._w64_base, self._w64):
            return
        grown = np.zeros((self._cap, w2), dtype=np.uint64)
        lo = max(b2, self._w64_base)
        hi = min(b2 + w2, self._w64_base + self._w64)
        if lo < hi:
            grown[:, lo - b2:hi - b2] = self._matrix[
                :, lo - self._w64_base:hi - self._w64_base]
        self._matrix = grown
        self._w64, self._w64_base = w2, b2
        self._dev = None          # the mirror's shape changed
        self._row_dev = {}
        self._planes_cache = {}
        self._mem_changed()

    def _ensure_window(self, lo_word, hi_word):
        """Grow (or, while still empty, relocate) the window to cover
        slice words [lo_word, hi_word] (ref: pilosa_tpu fragment.py:
        1472-1505): existing data pins the current window inside the
        new one."""
        base, w = self._w64_base, self._w64
        if base <= lo_word and hi_word < base + w:
            return
        if self._cap and self._matrix.any():
            self._rewindow_locked(*window_for(
                min(lo_word, base), max(hi_word, base + w - 1), w))
        else:
            self._rewindow_locked(*window_for(lo_word, hi_word))

    def _ensure_row_locked(self, row_id):
        phys = self._row_index.get(row_id)
        if phys is not None:
            return phys
        n = len(self._phys_rows)
        if n >= self._cap:
            self._grow_rows_locked(n + 1)
        self._row_index[row_id] = n
        self._phys_rows.append(row_id)
        self.max_row_id = max(self.max_row_id, row_id)
        return n

    def _grow_rows_locked(self, need):
        """Grow row capacity (powers of two from 8) to hold ``need``
        physical rows at the window's width (ref: pilosa_tpu
        fragment.py:1452-1470)."""
        if need <= self._cap:
            return
        cap = max(8, self._cap or 8)
        while cap < need:
            cap *= 2
        grown = np.zeros((cap, self._w64), dtype=np.uint64)
        grown[:self._cap] = self._matrix
        counts = np.zeros(cap, dtype=np.int64)
        counts[:self._cap] = self._row_counts
        self._matrix, self._row_counts, self._cap = grown, counts, cap
        self._mem_changed()

    def _recount_rows_locked(self, phys_iter):
        idx = list(phys_iter)
        if idx:
            self._row_counts[idx] = codec.popcount64(
                self._matrix[idx]).sum(axis=-1, dtype=np.int64)

    def _touch_locked(self, phys_iter):
        """Record a mutation: mirror rows stale, version and epoch up."""
        self._dirty.update(phys_iter)
        self._version += 1
        self.epoch.bump()

    def _reset_storage_locked(self, bump=True):
        self._cap = 0
        self._w64 = _MIN_W64
        self._w64_base = 0
        self._matrix = np.zeros((0, _MIN_W64), dtype=np.uint64)
        self._row_counts = np.zeros(0, dtype=np.int64)
        self._row_index = {}
        self._phys_rows = []
        self.max_row_id = 0
        self._dev = None
        self._dirty = set()
        self._rc_dev = None
        self._row_dev = {}
        self._planes_cache = {}
        self._cont_dev = {}
        self._cont_fmt = {}
        if bump:
            self._version += 1
            self.epoch.bump()

    def rows(self, nonempty=False):
        """Row ids present in storage, ascending; from container keys on
        a non-resident fragment (a row whose bits were all cleared
        before the last snapshot is absent there — it counts nothing)."""
        lazy = self._lazy_serve(lambda r: [
            rid for rid in self._lazy_row_ids(r)
            if not nonempty or self._lazy_row_count(r, rid)])
        if lazy is not _NOT_LAZY:
            return lazy
        with self.mu:
            if not nonempty:
                return sorted(self._row_index)
            return sorted(r for r, p in self._row_index.items()
                          if self._row_counts[p])

    def row_count(self, row_id):
        lazy = self._lazy_serve(lambda r: self._lazy_row_count(r, row_id),
                                memo=lambda: row_id in self._lazy_counts)
        if lazy is not _NOT_LAZY:
            return lazy
        with self.mu:
            phys = self._row_index.get(row_id)
            return int(self._row_counts[phys]) if phys is not None else 0

    def count(self):
        with self.mu:
            return int(self._row_counts[:len(self._phys_rows)].sum())

    def row_words(self, row_id):
        """Host uint64[16384] copy of one row, padded to the full slice
        (zeros when absent)."""
        lazy = self._lazy_serve(
            lambda r: self._lazy_row64_span(r, row_id, 0, WORDS64),
            memo=lambda: row_id in self._lazy_rows)
        if lazy is not _NOT_LAZY:
            return lazy
        with self.mu:
            out = np.zeros(WORDS64, dtype=np.uint64)
            phys = self._row_index.get(row_id)
            if phys is not None:
                base = self._w64_base
                out[base:base + self._w64] = self._matrix[phys]
            return out

    def host_rows_win(self, rows, base32, width32):
        """Fill, for each (row id, out) of ``rows``, ``out`` (zeroed
        uint64[width32 // 2]) with the row's words in the window
        [base32, base32 + width32) of 32-bit words; bits outside it are
        dropped. A non-resident fragment decodes just the overlapping
        containers: batched stacks are assembled on the host this way,
        every row of a fragment in one visit, and uploaded once, and
        building them never faults a fragment in."""
        b64, w64 = base32 // 2, width32 // 2

        def lazy(reader):
            for row_id, out in rows:
                self._lazy_fill(reader, row_id, b64, w64, out)
            return True

        if self._lazy_serve(lazy, memo=lambda: all(
                r in self._lazy_rows for r, _ in rows)) is not _NOT_LAZY:
            return
        with self.mu:
            lo = max(self._w64_base, b64)
            hi = min(self._w64_base + self._w64, b64 + w64)
            for row_id, out in rows:
                phys = self._row_index.get(row_id)
                if phys is not None and lo < hi:
                    out[lo - b64:hi - b64] = self._matrix[
                        phys, lo - self._w64_base:hi - self._w64_base]

    # ------------------------------------------------------ device mirror

    def win32(self):
        """The column window as (base, width) in 32-bit device words, or
        None when the fragment holds no rows (ref: pilosa_tpu
        fragment.py:1843-1869). Executors union these across a plan's
        fragments to size device stacks to the data. Memoized on the
        version and read without the lock: a racing mutation serves the
        pre-write window, as the stack caches' tokens do."""
        memo = self._win32_memo
        if memo is not None and memo[0] == self._version:
            return memo[1]
        version = self._version
        lazy = self._lazy_serve(self._lazy_win32)
        if lazy is not _NOT_LAZY:
            self._win32_memo = (version, lazy)
            return lazy
        with self.mu:
            val = ((self._w64_base * 2, self._w64 * 2)
                   if self._row_index else None)
            self._win32_memo = (self._version, val)
            return val

    def device_matrix(self):
        """int32[rows, 2·w] mirror at the window's width on the
        fragment's device, brought up to date with the host matrix (ref:
        the HBM mirror of pilosa_tpu fragment.py:1871-1910). Callers trim
        full-slice operands to the window, as ``top()`` does."""
        with self.mu:
            n = len(self._phys_rows)
            if self._dev is None or tuple(self._dev.shape) != (
                    n, 2 * self._w64):
                self._dev = torch.from_numpy(
                    self._matrix[:n].view(np.int32)).to(self.device,
                                                        copy=True)
            elif self._dirty:
                idx = sorted(p for p in self._dirty if p < n)
                if idx:
                    rows = torch.from_numpy(
                        self._matrix[idx].view(np.int32)).to(self.device)
                    self._dev = self._dev.index_copy(
                        0, torch.tensor(idx, device=self.device), rows)
            self._dirty.clear()
            return self._dev

    def _row_counts_device(self, n_phys):
        """int32[n_phys] device copy of the per-row counts, memoised on
        the mutation version (the Tanimoto denominator reads it every
        query). Caller holds ``self.mu``."""
        rc = self._rc_dev
        if rc is None or rc[0] != self._version or rc[1].shape[0] != n_phys:
            arr = torch.from_numpy(
                self._row_counts[:n_phys].astype(np.int32)).to(self.device)
            self._rc_dev = rc = (self._version, arr)
        return rc[1]

    def device_row(self, row_id):
        """int32[32768] device words of one row (full slice width)."""
        return self.device_row_win(row_id, 0, WORDS_PER_SLICE)

    def device_row_win(self, row_id, base32, width32):
        """int32[width32] device words of one row rebased into the window
        [base32, base32 + width32) of 32-bit words, zero outside the
        fragment's window (ref: pilosa_tpu fragment.py:1931-1994). A view
        of the mirror when the row is clean and the request is the
        fragment's own window; otherwise one rebased copy, memoized per
        (row, window, version), at most 64. A non-resident fragment
        serves from its container reader, no fault-in."""
        lazy = self._lazy_serve(lambda r: torch.from_numpy(
            self._lazy_row64_span(r, row_id, base32 // 2, width32 // 2)
            .view(np.int32)).to(self.device),
            memo=lambda: row_id in self._lazy_rows)
        if lazy is not _NOT_LAZY:
            return lazy
        with self.mu:
            phys = self._row_index.get(row_id)
            if phys is None:
                return torch.zeros(width32, dtype=torch.int32,
                                   device=self.device)
            fb, fw = self._w64_base * 2, self._w64 * 2
            if fb == base32 and fw == width32:
                return self.device_matrix()[phys]
            key = (phys, base32, width32)
            memo = self._row_dev.get(key)
            if memo is not None and memo[0] == self._version:
                return memo[1]
            row = torch.zeros(width32, dtype=torch.int32, device=self.device)
            lo, hi = max(fb, base32), min(fb + fw, base32 + width32)
            if lo < hi:
                words = self._matrix[phys].view(np.int32)[lo - fb:hi - fb]
                row[lo - base32:hi - base32] = torch.from_numpy(
                    words.copy()).to(self.device)
            if len(self._row_dev) >= 64:
                self._row_dev.clear()
            self._row_dev[key] = (self._version, row)
            return row

    # ------------------------------------------- compressed serving tier

    def row_container(self, row_id):
        """``containers.Container`` of one row at full slice width (ref:
        pilosa_tpu fragment.py:1583-1667). Its format comes from the
        row's count and one vectorized run scan, by the roaring
        thresholds (``containers.choose_format``): sorted positions, runs,
        or the dense device row wrapped with its known count. ARRAY and
        RUN containers are memoized per (row, version); a rebuild in
        another format counts a conversion. A non-resident fragment
        classifies from its lazy decode: compressed results memoize
        (a memo hit touches no reader), dense rows upload per call, as
        ``device_row`` does."""
        if not self._resident and self._opened:
            # Memo first, without the lock: a warm compressed tier serves
            # without recreating the reader (each pins a descriptor).
            memo = self._cont_dev.get(("lazy", row_id))
            if memo is not None and memo[0] == self._version:
                if self.governor is not None:
                    # The recency stamp, or the hottest compressed
                    # fragments would be evicted first.
                    self.governor.touch(self)
                return memo[1]
            out = self._lazy_serve(
                lambda r: self._lazy_container(r, row_id))
            if out is not _NOT_LAZY:
                return out
        with self.mu:
            phys = self._row_index.get(row_id)
            if phys is None:
                return containers.empty_container(WORDS_PER_SLICE,
                                                  self.device)
            memo = self._cont_dev.get(phys)
            if memo is not None and memo[0] == self._version:
                return memo[1]
            fm = self._cont_fmt.get(phys)
            if fm is not None and fm == (self._version, bitops.FMT_DENSE):
                # Classified dense at this version: no run scan, wrap the
                # mirror (a hot dense row on the serial path stays a dict
                # hit and a wrap).
                return containers.dense_container(
                    self.device_row_win(row_id, 0, WORDS_PER_SLICE),
                    WORDS_PER_SLICE, int(self._row_counts[phys]))
            cont = self._build_container_locked(phys)
            self._note_format_locked(phys, fm, cont)
            return cont

    def _note_format_locked(self, key, fm, cont):
        """Record the format ``cont`` served in (a conversion when it
        differs from the last one) and memoize it when compressed."""
        if fm is not None and fm[1] != cont.fmt:
            self._conversions += 1
            containers.note_conversion()
        self._cont_fmt[key] = (self._version, cont.fmt)
        if cont.fmt != bitops.FMT_DENSE:
            self._memo_container(key, cont)

    def _lazy_container(self, reader, row_id):
        """Container of one row of a non-resident fragment from the lazy
        decode (ref: pilosa_tpu fragment.py:1669-1710): a sparse row costs
        one transient full-width host assembly, then lives as its
        payload. A dense row is not memoized (it would pin a 128 KB
        device row an entry)."""
        key = ("lazy", row_id)
        memo = self._cont_dev.get(key)
        if memo is not None and memo[0] == self._version:
            return memo[1]
        words = self._lazy_row64_span(reader, row_id, 0, WORDS64)
        fm = self._cont_fmt.get(key)
        if fm is not None and fm == (self._version, bitops.FMT_DENSE):
            # Classified dense at this version: no popcount or run scan.
            cnt = self._lazy_counts.get(row_id)
            if cnt is None:
                cnt = int(codec.popcount64(words).sum())
                if len(self._lazy_counts) < 65536:
                    self._lazy_counts[row_id] = cnt
            return containers.dense_container(
                torch.from_numpy(words.view(np.int32)).to(self.device),
                WORDS_PER_SLICE, cnt)
        cont = containers.build_container(words, WORDS_PER_SLICE,
                                          count=self._lazy_counts.get(row_id),
                                          device=self.device)
        self._note_format_locked(key, fm, cont)
        return cont

    def _memo_container(self, key, cont):
        """Memoize a compressed container, at most 8,192 a fragment,
        oldest out."""
        if len(self._cont_dev) >= 8192:
            self._cont_dev.pop(next(iter(self._cont_dev)))
        self._cont_dev[key] = (self._version, cont)

    def row_compressed(self, row_id):
        """Whether this row serves from the compressed tier rather than
        a dense device stack (ref: pilosa_tpu fragment.py:1720-1749):
        only for an open, non-resident fragment whose row has at most
        ARRAY_MAX_BITS bits (or none). Resident fragments keep the
        batched path: their dense mirrors are paid for already."""
        if not containers.enabled():
            return False
        if self._resident or not self._opened:
            return False
        memo = self._cont_dev.get(("lazy", row_id))
        if memo is not None and memo[0] == self._version:
            return memo[1].fmt != bitops.FMT_DENSE
        return self.row_count(row_id) <= containers.ARRAY_MAX_BITS

    def row_format_probe(self, row_id):
        """A read-only guess of one row's format, "dense", "array" or
        "run", from the serving memos when warm, else from the count
        (at most ARRAY_MAX_BITS: array). Builds nothing, memoizes
        nothing (ref: pilosa_tpu fragment.py:1751-1786)."""
        if not containers.enabled():
            return bitops.FMT_DENSE
        version = self._version
        if not self._resident and self._opened:
            memo = self._cont_dev.get(("lazy", row_id))
            if memo is not None and memo[0] == version:
                return memo[1].fmt
            fm = self._cont_fmt.get(("lazy", row_id))
            if fm is not None and fm[0] == version:
                return fm[1]
            return (bitops.FMT_ARRAY
                    if self.row_count(row_id) <= containers.ARRAY_MAX_BITS
                    else bitops.FMT_DENSE)
        phys = self._row_index.get(row_id)
        if phys is None:
            return bitops.FMT_ARRAY  # an absent row serves an empty array
        memo = self._cont_dev.get(phys)
        if memo is not None and memo[0] == version:
            return memo[1].fmt
        fm = self._cont_fmt.get(phys)
        if fm is not None and fm[0] == version:
            return fm[1]
        return bitops.FMT_DENSE

    def _build_container_locked(self, phys):
        """Classify and build one resident row's container from its window
        words: positions and runs rebase by the window's offset to slice
        bits, and a dense row wraps the device mirror. Caller holds
        ``self.mu``."""
        row_id = self._phys_rows[phys]
        return containers.build_container(
            self._matrix[phys], WORDS_PER_SLICE,
            count=int(self._row_counts[phys]), offset=self._w64_base * 64,
            dense_fn=lambda: self.device_row_win(row_id, 0, WORDS_PER_SLICE),
            device=self.device)

    def container_stats(self):
        """The compressed tier per format: blocks and payload bytes, the
        bytes the dense tier would hold for the same blocks (a resident
        row pages to this fragment's window, a lazy one to the full
        slice), and conversions (ref: pilosa_tpu fragment.py:1803-1839).
        Lock-free, like memory_stats."""
        out = {f: {"blocks": 0, "bytes": 0}
               for f in (bitops.FMT_DENSE, bitops.FMT_ARRAY, bitops.FMT_RUN)}
        dense_row_bytes = 2 * self._w64 * 4
        equiv = 0
        version = self._version
        for key, memo in list(self._cont_dev.items()):
            if memo[0] != version:
                continue
            c = memo[1]
            out[c.fmt]["blocks"] += 1
            out[c.fmt]["bytes"] += c.nbytes()
            equiv += (c.dense_equiv_bytes() if isinstance(key, tuple)
                      else dense_row_bytes)
        for key, (ver, fmt) in list(self._cont_fmt.items()):
            if fmt == bitops.FMT_DENSE and ver == version:
                b = (WORDS_PER_SLICE * 4 if isinstance(key, tuple)
                     else dense_row_bytes)
                out[fmt]["blocks"] += 1
                out[fmt]["bytes"] += b
                equiv += b
        return {"formats": out, "denseEquivBytes": equiv,
                "conversions": self._conversions}

    # ---------------------------------------------------------- mutations

    def _pos(self, row_id, column_id):
        """pos = row·2^20 + col%2^20 (ref: fragment.go:800-809)."""
        if column_id // SLICE_WIDTH != self.slice:
            raise ValueError(
                f"column:{column_id} out of bounds for slice {self.slice}")
        return row_id * SLICE_WIDTH + column_id % SLICE_WIDTH

    def _mutate_locked(self, row_id, column_id, set_value):
        pos = self._pos(row_id, column_id)
        col = column_id % SLICE_WIDTH
        word, mask = col >> 6, np.uint64(1 << (col & 63))
        phys = self._row_index.get(row_id)
        inside = self._w64_base <= word < self._w64_base + self._w64
        if not set_value and (phys is None or not inside):
            return False  # absent rows and out-of-window words hold no bits
        if phys is None:
            phys = self._ensure_row_locked(row_id)
        if not inside:
            self._ensure_window(word, word)
        word -= self._w64_base
        if bool(self._matrix[phys, word] & mask) == set_value:
            return False
        self._append_ops_locked(codec.op_record(
            codec.OP_ADD if set_value else codec.OP_REMOVE, pos))
        self.op_n += 1
        if set_value:
            self._matrix[phys, word] |= mask
            self._row_counts[phys] += 1
        else:
            self._matrix[phys, word] &= ~mask
            self._row_counts[phys] -= 1
        if not self._op_log_room(0):
            self.snapshot()
        self._touch_locked([phys])
        self._cache.add(row_id, int(self._row_counts[phys]))
        return True

    def set_bit(self, row_id, column_id):
        """Returns True iff the bit changed (ref: fragment.go:388-434)."""
        with self.mu:
            return self._mutate_locked(row_id, column_id, True)

    def clear_bit(self, row_id, column_id):
        with self.mu:
            return self._mutate_locked(row_id, column_id, False)

    def import_bits(self, row_ids, column_ids):
        """Bulk import (ref: fragment.go:1266-1333): a batch that fits
        the op-log budget appends fsync'd records, a larger one lands
        as one snapshot."""
        with self.mu:
            row_ids = np.asarray(row_ids, dtype=np.uint64)
            column_ids = np.asarray(column_ids, dtype=np.uint64)
            if len(row_ids) != len(column_ids):
                raise ValueError("row/column id length mismatch")
            if len(row_ids) == 0:
                return
            bad = column_ids // SLICE_WIDTH != self.slice
            if bad.any():
                raise ValueError(
                    f"column:{int(column_ids[bad][0])} out of bounds for "
                    f"slice {self.slice}")
            cols = column_ids % SLICE_WIDTH
            use_oplog = self._op_log_room(len(row_ids))
            if use_oplog:
                positions = row_ids * np.uint64(SLICE_WIDTH) + cols
                self._append_ops_locked(codec.op_records(
                    np.full(len(positions), codec.OP_ADD, dtype=np.uint8),
                    positions), fsync=True)
                self.op_n += len(positions)
            uniq_rows = np.unique(row_ids)
            touched = sorted(self._ensure_row_locked(int(r))
                             for r in uniq_rows.tolist())
            self._ensure_window(int(cols.min()) >> 6, int(cols.max()) >> 6)
            self._scatter_positions_locked(
                row_ids * np.uint64(SLICE_WIDTH) + cols, True)
            self._recount_rows_locked(touched)
            if not use_oplog:
                self.snapshot()
            self._touch_locked(touched)
            for p in touched:
                self._cache.bulk_add(self._phys_rows[p],
                                     int(self._row_counts[p]))
            self._cache.invalidate()

    def import_value_bits(self, column_ids, base_values, bit_depth):
        """Bulk BSI import: vectorized plane writes (ref: ImportValue
        fragment.go:1335-1367; pilosa_tpu fragment.py:2400). Overwrites
        any previous value, last write winning within the batch. A batch
        of fresh inserts that fits the op-log budget appends fsync'd
        records, column by column, each value sandwiched between a
        REMOVE and an ADD of its not-null bit, so a torn tail replays as
        null, never as a mix of old and new bits; a batch that
        overwrites a value, or a larger one, lands as one snapshot."""
        with self.mu:
            column_ids = np.asarray(column_ids, dtype=np.uint64)
            base_values = np.asarray(base_values, dtype=np.uint64)
            if len(column_ids) == 0:
                return
            bad = column_ids // SLICE_WIDTH != self.slice
            if bad.any():
                raise ValueError(
                    f"column:{int(column_ids[bad][0])} out of bounds for "
                    f"slice {self.slice}")
            cols = column_ids % SLICE_WIDTH
            self._ensure_window(int(cols.min()) >> 6, int(cols.max()) >> 6)
            _, last_rev = np.unique(cols[::-1], return_index=True)
            if len(last_rev) != len(cols):
                keep = np.sort(len(cols) - 1 - last_rev)
                cols, base_values = cols[keep], base_values[keep]
            lcols = cols - np.uint64(self._w64_base * 64)
            words = (lcols >> np.uint64(6)).astype(np.int64)
            masks = np.uint64(1) << (lcols & np.uint64(63))
            nn_phys = self._row_index.get(bit_depth)
            any_overwrite = (nn_phys is not None and bool(
                (self._matrix[nn_phys, words] & masks).any()))
            n_ops = (bit_depth + 2) * len(cols)
            use_oplog = not any_overwrite and self._op_log_room(n_ops)
            if use_oplog:
                plane_ids = np.arange(bit_depth, dtype=np.uint64)
                sel = ((base_values[None, :] >> plane_ids[:, None])
                       & np.uint64(1)) == 1
                nn_pos = np.uint64(bit_depth * SLICE_WIDTH) + cols
                # Record rows: REMOVE not-null, the plane ops, ADD
                # not-null; ravel(order="F") lays them out per column.
                pos_m = np.empty((bit_depth + 2, len(cols)), np.uint64)
                typ_m = np.empty((bit_depth + 2, len(cols)), np.uint8)
                pos_m[0], typ_m[0] = nn_pos, codec.OP_REMOVE
                pos_m[1:-1] = (plane_ids[:, None] * np.uint64(SLICE_WIDTH)
                               + cols[None, :])
                typ_m[1:-1] = np.where(sel, codec.OP_ADD, codec.OP_REMOVE)
                pos_m[-1], typ_m[-1] = nn_pos, codec.OP_ADD
                self._append_ops_locked(
                    codec.op_records(typ_m.ravel(order="F"),
                                     pos_m.ravel(order="F")), fsync=True)
                self.op_n += n_ops
            touched = []
            for i in range(bit_depth + 1):
                phys = self._ensure_row_locked(i)
                touched.append(phys)
                if i == bit_depth:
                    sel = np.ones(len(cols), dtype=bool)  # not-null row
                else:
                    sel = ((base_values >> np.uint64(i)) & np.uint64(1)) == 1
                # Clear the columns' stale bits, then set the selected.
                np.bitwise_and.at(self._matrix, (phys, words), ~masks)
                np.bitwise_or.at(self._matrix, (phys, words[sel]), masks[sel])
            self._recount_rows_locked(touched)
            if not use_oplog:
                self.snapshot()
            self._touch_locked(touched)
            for p in touched:
                self._cache.bulk_add(self._phys_rows[p],
                                     int(self._row_counts[p]))
            self._cache.invalidate()

    # ----------------------------------------------------------------- BSI

    def planes(self, depth):
        """int32[depth+1, 32768] device matrix of the BSI rows 0..depth
        (bit planes, then the not-null row) at full slice width."""
        return self.planes_win(depth, 0, WORDS_PER_SLICE)

    def planes_win(self, depth, base32, width32):
        """int32[depth+1, width32] device matrix of the BSI rows 0..depth
        rebased into the window [base32, base32 + width32), absent rows
        zero, memoized on the version (ref: pilosa_tpu fragment.py:
        2805-2838). A non-resident fragment assembles it from container
        decodes, no fault-in."""
        lazy = self._lazy_serve(
            lambda r: self._lazy_planes(r, depth, base32, width32))
        if lazy is not _NOT_LAZY:
            return lazy
        with self.mu:
            key = (depth, base32, width32)
            cached = self._planes_cache.get(key)
            if cached and cached[0] == self._version:
                return cached[1]
            b64, w64 = base32 // 2, width32 // 2
            mat = np.zeros((depth + 1, w64), dtype=np.uint64)
            lo = max(self._w64_base, b64)
            hi = min(self._w64_base + self._w64, b64 + w64)
            if lo < hi:
                for i in range(depth + 1):
                    phys = self._row_index.get(i)
                    if phys is not None:
                        mat[i, lo - b64:hi - b64] = self._matrix[
                            phys, lo - self._w64_base:hi - self._w64_base]
            planes = torch.from_numpy(mat.view(np.int32)).to(self.device)
            self._planes_cache = {key: (self._version, planes)}
            return planes

    def _filtered(self, planes, depth, filter_words):
        """The not-null row, intersected with ``filter_words`` (int32
        device words of the slice) when given."""
        exists = planes[depth]
        return exists if filter_words is None else exists & filter_words

    def set_field_value(self, column_id, bit_depth, value):
        """Write value bits into rows 0..depth-1 and the not-null row
        (ref: fragment.go:517-546); True iff a bit changed."""
        with self.mu:
            changed = False
            for i in range(bit_depth):
                changed |= self._mutate_locked(i, column_id,
                                               bool((value >> i) & 1))
            changed |= self._mutate_locked(bit_depth, column_id, True)
            return changed

    def field_value(self, column_id, bit_depth):
        """(value, exists) for one column (ref: fragment.go:493-515)."""
        with self.mu:
            col = column_id % SLICE_WIDTH
            word = (col >> 6) - self._w64_base
            mask = np.uint64(1 << (col & 63))

            def bit(row_id):
                phys = self._row_index.get(row_id)
                return (phys is not None and 0 <= word < self._w64
                        and bool(self._matrix[phys, word] & mask))

            if not bit(bit_depth):
                return 0, False
            return sum(1 << i for i in range(bit_depth) if bit(i)), True

    def field_sum(self, filter_words, bit_depth):
        """(sum, count) over the columns with a value, ∩ ``filter_words``
        when given (ref: FieldSum fragment.go:590-618). One
        ``count_and_rows`` launch counts every plane and, as its last
        row, the not-null row against the filter — the filter itself,
        which lies inside it."""
        planes = self.planes(bit_depth)
        filt = self._filtered(planes, bit_depth, filter_words)
        counts = bsi_ops.plane_counts(planes, filt).tolist()
        return (sum((1 << i) * c for i, c in enumerate(counts[:-1])),
                counts[-1])

    def _range_bits(self, fn, bit_depth, *predicates):
        planes = self.planes(bit_depth)
        return fn(planes[:bit_depth], planes[bit_depth],
                  *(bsi_ops.value_to_bits(p, bit_depth) for p in predicates))

    def field_range(self, op, bit_depth, predicate):
        """int32[32768] device words of the columns whose base value
        satisfies ``op predicate`` (ref: FieldRange fragment.go:621-798)."""
        return self._range_bits(bsi_ops.COMPARE[op], bit_depth, predicate)

    def field_range_between(self, bit_depth, lo, hi):
        """lo ≤ base value ≤ hi (ref: FieldRangeBetween
        fragment.go:760)."""
        return self._range_bits(bsi_ops.bsi_between, bit_depth, lo, hi)

    def field_not_null(self, bit_depth):
        """(ref: FieldNotNull fragment.go:755)."""
        return self.device_row(bit_depth)

    def field_min_max(self, filter_words, bit_depth, find_max):
        """(base value, count of columns attaining it) of the Min or Max
        over the columns with a value, ∩ ``filter_words`` when given;
        (0, 0) when there are none."""
        planes = self.planes(bit_depth)
        filt = self._filtered(planes, bit_depth, filter_words)
        if int(bitops.count(filt)) == 0:
            return 0, 0
        ind, remaining = bsi_ops.bsi_extrema_indicators(
            planes[:bit_depth], filt, find_max)
        value = sum((1 << i) * int(b) for i, b in enumerate(ind.tolist()))
        return value, int(bitops.count(remaining))

    # ---------------------------------------------------------------- TopN

    def top(self, opt=None):
        """TopN over this fragment (ref: fragment.go:831-963): exact
        counts — host row counts, or |row ∩ src| from the
        ``count_and_rows`` kernel against ``opt.src`` (the slice's Src
        words, on the fragment's device, trimmed to the window) — over
        the rows the cache admits (all rows named by ``opt.row_ids``
        when given), and of those only the rows of
        ``opt.filter_row_ids`` when given (an attribute filter). A
        ``none`` cache yields nothing without ids. Pairs are ordered by
        (-count, id); with ``n`` and no ids, count ties straddling the
        n-th place stay in and are cut by id. A Src-less TopN on a
        non-resident fragment reads the sidecar and header counts."""
        opt = opt or TopOptions()
        if opt.src is None:
            out = self._lazy_serve(lambda r: self._lazy_top(r, opt))
            if out is not _NOT_LAZY:
                return out
        with self.mu:
            n_phys = len(self._phys_rows)
            if n_phys == 0:
                return []
            if opt.row_ids is None and isinstance(self._cache, NopCache):
                return []
            if opt.src is not None:
                matrix = self.device_matrix()
                # Bits beyond the window are zero in every row, so the
                # trimmed Src gives every intersection; the Tanimoto
                # denominator's |src| counts the whole Src.
                base32, width32 = self._w64_base * 2, self._w64 * 2
                src = opt.src[base32:base32 + width32].contiguous()
                if opt.tanimoto_threshold:
                    counts = topn_ops.tanimoto_masked_counts(
                        matrix, src, self._row_counts_device(n_phys),
                        int(bitops.count(opt.src)), opt.tanimoto_threshold)
                else:
                    counts = bitops.count_and_rows(matrix, src)
                counts_np = counts.cpu().numpy().astype(np.int64)
            else:
                counts_np = self._row_counts[:n_phys].copy()

            row_ids = np.asarray(self._phys_rows, dtype=np.uint64)
            mask = counts_np > 0
            if opt.min_threshold:
                mask &= counts_np >= opt.min_threshold
            if opt.row_ids is not None:
                mask &= np.isin(row_ids, np.fromiter(
                    opt.row_ids, dtype=np.uint64))
            elif not isinstance(self._cache, NopCache):
                mask &= np.isin(row_ids, self._cache.ids_arr())
            if opt.filter_row_ids is not None:
                mask &= np.isin(row_ids, np.fromiter(
                    opt.filter_row_ids, dtype=np.uint64))
            idx = np.nonzero(mask)[0]
            # Explicit ids (the phase-2 exact re-query) are never cut per
            # slice; trimming happens after the cross-slice merge (ref:
            # fragment.go:835-838).
            truncate = bool(opt.n) and opt.row_ids is None
            if truncate and idx.size > opt.n:
                c = counts_np[idx]
                nth = c[np.argpartition(-c, opt.n - 1)[opt.n - 1]]
                idx = idx[c >= nth]
            order = np.lexsort((row_ids[idx], -counts_np[idx]))
            sel = idx[order[:opt.n]] if truncate else idx[order]
            return [(int(r), int(c))
                    for r, c in zip(row_ids[sel], counts_np[sel])]

    # -------------------------------------------------------------- backup

    def write_to(self, fileobj):
        """Tar archive of data + cache members (ref: fragment.go:1476-1560),
        the layout pilosa_tpu's read_from restores. A non-resident
        fragment's file (snapshot + op log) already is its state, so it
        streams as it is, without a fault-in."""
        if not self._resident and self._opened:
            self.mu.acquire_raw()
            try:
                if not self._resident and self._opened:
                    cache = json.dumps(sorted(
                        self._lazy_cache_ids_locked())).encode()
                    with open(self.path, "rb") as f:
                        self._write_backup_tar(
                            fileobj, f, os.fstat(f.fileno()).st_size, cache)
                    return
            finally:
                self.mu.release_raw()
        with self.mu:
            data = codec.serialize_arrays(*self._to_arrays_locked())
            cache = json.dumps(self._cache.ids()).encode()
        self._write_backup_tar(fileobj, io.BytesIO(data), len(data), cache)

    @staticmethod
    def _write_backup_tar(fileobj, data_stream, data_size, cache):
        with tarfile.open(fileobj=fileobj, mode="w") as tar:
            info = tarfile.TarInfo("data")
            info.size = data_size
            tar.addfile(info, data_stream)
            cinfo = tarfile.TarInfo("cache")
            cinfo.size = len(cache)
            tar.addfile(cinfo, io.BytesIO(cache))

    def read_from(self, fileobj):
        """Restore from a backup tar (ref: fragment.go:1562-1648):
        memory and the on-disk file are replaced by the archive's data;
        the old state is never faulted in first."""
        with tarfile.open(fileobj=fileobj, mode="r") as tar:
            for member in tar.getmembers():
                payload = tar.extractfile(member).read()
                if member.name == "data":
                    self.mu.acquire_raw()
                    try:
                        self._drop_lazy_locked()  # the file is replaced
                        self._load_file_locked(payload)
                        if self._op_file is not None:
                            self._op_file.close()
                            self._op_file = None
                        with open(self.path, "wb") as f:
                            f.write(codec.serialize_arrays(
                                *self._to_arrays_locked()))
                        self.op_n = 0
                        self._snap_card = int(self._row_counts.sum())
                        self._resident = True  # the restored state
                        _residency_moved()
                        if not self._cache_loaded:
                            self._cache.clear()
                            self._open_cache()
                            self._cache_loaded = True
                        self._mem_changed()
                    finally:
                        self.mu.release_raw()
                elif member.name == "cache":
                    with self.mu:
                        with open(self.cache_path, "wb") as f:
                            f.write(payload)
                        self._cache.clear()
                        self._open_cache()
                        self._cache_loaded = True
