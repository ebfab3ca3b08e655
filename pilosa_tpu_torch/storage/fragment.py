"""Fragment — one (index, frame, view, slice) bitmap matrix
(ref: fragment.go; counterpart of pilosa_tpu/storage/fragment.py).

The fragment keeps two mirrors of the same bits:

- a host ``numpy uint64[capacity, 16384]`` row matrix — the mutation
  target and serialization source;
- a device ``int32[rows, 32768]`` tensor on the fragment's device — the
  compute surface. A little-endian view makes the two layouts
  identical, so a refresh is a plain copy with no repacking. Rows
  dirtied by writes are copied in when a query next asks for the
  mirror; the refresh is out of place, so tensors handed out earlier
  never change under their holder.

Durability follows the reference: every set/clear appends a 13-byte
op-log record to the roaring file (roaring.go:740) before memory flips;
once the log outgrows ``max(MAX_OPN, cardinality/2)`` records the file
is rewritten through an atomic temp-file rename (``snapshot()``,
fragment.go:1369-1438). The file format is shared with pilosa_tpu.

Each fragment keeps the frame's TopN cache (``storage/cache.py``):
restored from the ``.cache`` sidecar at open, kept current by every
write, written back on close. ``top()`` ranks exact counts — host row
counts, or the ``count_and_rows`` kernel against a Src row on the device
— over the rows the cache admits.

A BSI field's fragment (view ``field_<name>``) holds the value bits in
rows 0..depth-1 and the not-null row ``depth``; ``planes`` hands them to
the descents of ``ops/bsi.py`` as one device matrix.

Rows always span the full slice (no column windows, no lazy/evicted
serving, no compressed containers — those are later slices of the
port). A fragment under a holder holds no per-file lock: the holder's
directory lock covers it.
"""
import io
import itertools
import json
import os
import tarfile
import threading

import numpy as np
import torch

from pilosa_tpu_torch import SLICE_WIDTH, WORDS_PER_SLICE
from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.ops import bsi as bsi_ops
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

HOLDER_LOCK_NAME = ".holder.lock"


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
    """A value moved by every fragment open, close and mutation under
    one index: an O(1) "has anything changed?" test for the executor's
    device-stack cache, instead of re-reading every fragment's version
    per query."""

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


class Fragment:
    _UID_SEQ = itertools.count()

    def __init__(self, path, index, frame, view, slice_num, device="cpu",
                 epoch=None, holder_locked=False, cache_type="ranked",
                 cache_size=50000):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice_num
        self.cache_type = cache_type
        self.cache = new_cache(cache_type, cache_size)
        self.device = torch.device(device)
        self.epoch = epoch if epoch is not None else MutationEpoch()
        self.holder_locked = holder_locked
        # Process-unique id: cache tokens pair it with _version so a
        # closed and reopened fragment never aliases a cache entry.
        self._uid = next(self._UID_SEQ)
        self.mu = threading.RLock()
        self._opened = False
        self._cap = 0
        self._matrix = np.zeros((0, WORDS64), dtype=np.uint64)
        self._row_counts = np.zeros(0, dtype=np.int64)
        self._row_index = {}   # rowID -> physical row
        self._phys_rows = []   # physical row -> rowID
        self.max_row_id = 0
        self.op_n = 0
        self._snap_card = 0    # cardinality at the last snapshot
        self._op_file = None
        self._lock_file = None
        self._version = 0      # bumped on every mutation
        self._dev = None       # int32[rows, 32768] device mirror
        self._dirty = set()    # physical rows stale in the mirror
        self._rc_dev = None    # (version, int32[rows] device row counts)

    @property
    def cache_path(self):
        return self.path + ".cache"

    # ------------------------------------------------------------------ io

    def open(self):
        """Open (creating an empty file if needed), lock, and load the
        snapshot with its op log replayed. A torn op-log tail (crash
        mid-append) keeps the valid prefix and is rewritten away."""
        with self.mu:
            if self._opened:
                return self
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            if not (os.path.exists(self.path)
                    and os.path.getsize(self.path) > 0):
                with open(self.path, "wb") as f:
                    f.write(codec.serialize({}))
            self._acquire_lock()
            try:
                with open(self.path, "rb") as f:
                    blocks, self.op_n, torn = codec.deserialize(f.read())
                self._load_blocks_locked(blocks)
                self._snap_card = int(self._row_counts.sum())
                self.cache.clear()
                self._open_cache()
                self._opened = True
                if torn:
                    self.snapshot()
            except BaseException:
                self._release_lock()
                raise
            self.epoch.bump()
        return self

    def close(self):
        with self.mu:
            if self._opened:
                self._flush_cache_locked()
            if self._op_file is not None:
                self._op_file.close()
                self._op_file = None
            self._release_lock()
            self._opened = False
            self._reset_storage_locked()

    def _acquire_lock(self):
        """Guard against a second open of this fragment (ref:
        syscall.Flock fragment.go:203-205), with pilosa_tpu's protocol:
        under a holder only a transient probe of the per-file ``.lock``
        (the holder's directory lock covers the tree); standalone, a
        probe of any enclosing ``.holder.lock``, then a held ``.lock``."""
        if self.holder_locked:
            if os.path.exists(self.path + ".lock"):
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
                self.cache.bulk_add(row_id, int(self._row_counts[phys]))
        self.cache.invalidate()

    def _flush_cache_locked(self):
        with open(self.cache_path, "w") as f:
            json.dump(self.cache.ids(), f)

    def flush_cache(self):
        """Write the TopN cache's ids to the ``.cache`` sidecar."""
        with self.mu:
            self._flush_cache_locked()

    def recalculate_cache(self):
        """Rebuild the TopN cache from storage counts (ref: Cache.
        Recalculate via handleRecalculateCaches handler.go:2016)."""
        with self.mu:
            for phys, row_id in enumerate(self._phys_rows):
                n = int(self._row_counts[phys])
                if n:
                    self.cache.bulk_add(row_id, n)
            self.cache.invalidate()

    def cache_entry_ids(self):
        """TopN candidate row ids: the cache's membership (batched TopN
        phase 1 reads it for every fragment of a slice list)."""
        if isinstance(self.cache, NopCache):
            return frozenset()
        with self.mu:
            return frozenset(self.cache.entries)

    def _release_lock(self):
        if self._lock_file is not None:
            self._lock_file.close()
            self._lock_file = None

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

    def _load_blocks_locked(self, blocks):
        for row_id in sorted({key // _CONTAINERS_PER_ROW for key in blocks}):
            self._ensure_row_locked(row_id)
        for key, block in blocks.items():
            phys = self._row_index[key // _CONTAINERS_PER_ROW]
            lo = (key % _CONTAINERS_PER_ROW) * _WORDS64_PER_CONTAINER
            self._matrix[phys, lo : lo + _WORDS64_PER_CONTAINER] = block
        self._recount_rows_locked(range(len(self._phys_rows)))
        self._touch_locked(range(len(self._phys_rows)))

    def _to_arrays_locked(self):
        """(sorted uint64[n] container keys, uint64[n, 1024] blocks) of
        the non-empty containers."""
        n = len(self._phys_rows)
        tiled = self._matrix[:n].reshape(n, _CONTAINERS_PER_ROW,
                                         _WORDS64_PER_CONTAINER)
        phys_idx, sub_idx = np.nonzero(tiled.any(axis=2))
        row_ids = np.asarray(self._phys_rows, dtype=np.uint64)
        keys = (row_ids[phys_idx] * np.uint64(_CONTAINERS_PER_ROW)
                + sub_idx.astype(np.uint64))
        order = np.argsort(keys, kind="stable")
        return keys[order], tiled[phys_idx[order], sub_idx[order]]

    def snapshot(self):
        """Atomic full rewrite + op-log reset (ref: fragment.go:1393-1438):
        the previous file stays intact until the rename."""
        with self.mu:
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
        limit = max(MAX_OPN, min(self._snap_card // 2, OPLOG_MAX_OPS))
        return self.op_n + extra <= limit

    # ------------------------------------------------------- row plumbing

    def _ensure_row_locked(self, row_id):
        phys = self._row_index.get(row_id)
        if phys is not None:
            return phys
        n = len(self._phys_rows)
        if n >= self._cap:
            cap = max(1, self._cap)
            while cap <= n:
                cap *= 2
            grown = np.zeros((cap, WORDS64), dtype=np.uint64)
            grown[: self._cap] = self._matrix
            counts = np.zeros(cap, dtype=np.int64)
            counts[: self._cap] = self._row_counts
            self._matrix, self._row_counts, self._cap = grown, counts, cap
        self._row_index[row_id] = n
        self._phys_rows.append(row_id)
        self.max_row_id = max(self.max_row_id, row_id)
        return n

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

    def _reset_storage_locked(self):
        self._cap = 0
        self._matrix = np.zeros((0, WORDS64), dtype=np.uint64)
        self._row_counts = np.zeros(0, dtype=np.int64)
        self._row_index = {}
        self._phys_rows = []
        self.max_row_id = 0
        self._dev = None
        self._dirty = set()
        self._version += 1
        self.epoch.bump()

    def rows(self, nonempty=False):
        """Row ids present in storage, ascending."""
        with self.mu:
            if not nonempty:
                return sorted(self._row_index)
            return sorted(r for r, p in self._row_index.items()
                          if self._row_counts[p])

    def row_count(self, row_id):
        with self.mu:
            phys = self._row_index.get(row_id)
            return int(self._row_counts[phys]) if phys is not None else 0

    def count(self):
        with self.mu:
            return int(self._row_counts[: len(self._phys_rows)].sum())

    def row_words(self, row_id):
        """Host uint64[16384] copy of one row (zeros when absent)."""
        with self.mu:
            phys = self._row_index.get(row_id)
            if phys is None:
                return np.zeros(WORDS64, dtype=np.uint64)
            return self._matrix[phys].copy()

    # ------------------------------------------------------ device mirror

    def device_matrix(self):
        """int32[rows, 32768] mirror on the fragment's device, brought
        up to date with the host matrix (ref: the HBM mirror of
        pilosa_tpu fragment.py:1871-1910)."""
        with self.mu:
            n = len(self._phys_rows)
            if self._dev is None or self._dev.shape[0] != n:
                self._dev = torch.from_numpy(
                    self._matrix[:n].view(np.int32)).to(self.device,
                                                        copy=True)
            elif self._dirty:
                idx = sorted(self._dirty)
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
        """int32[32768] device words of one row (zeros when absent)."""
        with self.mu:
            phys = self._row_index.get(row_id)
            if phys is None:
                return torch.zeros(WORDS_PER_SLICE, dtype=torch.int32,
                                   device=self.device)
            return self.device_matrix()[phys]

    # ---------------------------------------------------------- mutations

    def _pos(self, row_id, column_id):
        """pos = row·2^20 + col%2^20 (ref: fragment.go:800-809)."""
        if column_id // SLICE_WIDTH != self.slice:
            raise ValueError(
                f"column:{column_id} out of bounds for slice {self.slice}")
        return row_id * SLICE_WIDTH + column_id % SLICE_WIDTH

    def _mutate_locked(self, row_id, column_id, set_value):
        pos = self._pos(row_id, column_id)
        phys = self._row_index.get(row_id)
        if phys is None:
            if not set_value:
                return False  # absent rows hold no bits to clear
            phys = self._ensure_row_locked(row_id)
        col = column_id % SLICE_WIDTH
        word, mask = col >> 6, np.uint64(1 << (col & 63))
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
        self.cache.add(row_id, int(self._row_counts[phys]))
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
            uniq_rows, inverse = np.unique(row_ids, return_inverse=True)
            phys_u = np.asarray([self._ensure_row_locked(int(r))
                                 for r in uniq_rows.tolist()],
                                dtype=np.int64)
            words = (cols >> np.uint64(6)).astype(np.int64)
            masks = np.uint64(1) << (cols & np.uint64(63))
            key = phys_u[inverse] * np.int64(WORDS64) + words
            order, starts, _, folded = codec.group_sorted(key)
            ored = np.bitwise_or.reduceat(masks[order], starts)
            self._matrix[folded // WORDS64, folded % WORDS64] |= ored
            touched = sorted(phys_u.tolist())
            self._recount_rows_locked(touched)
            if not use_oplog:
                self.snapshot()
            self._touch_locked(touched)
            for p in touched:
                self.cache.bulk_add(self._phys_rows[p],
                                    int(self._row_counts[p]))
            self.cache.invalidate()

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
            _, last_rev = np.unique(cols[::-1], return_index=True)
            if len(last_rev) != len(cols):
                keep = np.sort(len(cols) - 1 - last_rev)
                cols, base_values = cols[keep], base_values[keep]
            words = (cols >> np.uint64(6)).astype(np.int64)
            masks = np.uint64(1) << (cols & np.uint64(63))
            nn_phys = self._row_index.get(bit_depth)
            any_overwrite = (nn_phys is not None and bool(
                (self._matrix[nn_phys, words] & masks).any()))
            n_ops = (bit_depth + 2) * len(cols)
            use_oplog = (self._opened and not any_overwrite
                         and self._op_log_room(n_ops))
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
                self.cache.bulk_add(self._phys_rows[p],
                                    int(self._row_counts[p]))
            self.cache.invalidate()

    # ----------------------------------------------------------------- BSI

    def planes(self, depth):
        """int32[depth+1, 32768] device matrix of the BSI rows 0..depth
        (bit planes, then the not-null row), full slice width. Rows
        stored in order at consecutive physical indices — what every
        import and first write leaves — come back as a view of the
        device mirror; otherwise they are gathered by physical index,
        absent rows as zeros."""
        with self.mu:
            phys = [self._row_index.get(i) for i in range(depth + 1)]
            dev = self.device_matrix()
            p0 = phys[0]
            if p0 is not None and phys == list(range(p0, p0 + depth + 1)):
                return dev[p0:p0 + depth + 1]
            out = torch.zeros((depth + 1, WORDS_PER_SLICE),
                              dtype=torch.int32, device=self.device)
            have = [(i, p) for i, p in enumerate(phys) if p is not None]
            if have:
                dst = torch.tensor([i for i, _ in have], device=self.device)
                src = torch.tensor([p for _, p in have], device=self.device)
                out.index_copy_(0, dst, dev.index_select(0, src))
            return out

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
                if (value >> i) & 1:
                    changed |= self._mutate_locked(i, column_id, True)
                else:
                    changed |= self._mutate_locked(i, column_id, False)
            changed |= self._mutate_locked(bit_depth, column_id, True)
            return changed

    def field_value(self, column_id, bit_depth):
        """(value, exists) for one column (ref: fragment.go:493-515)."""
        with self.mu:
            col = column_id % SLICE_WIDTH
            word, mask = col >> 6, np.uint64(1 << (col & 63))

            def bit(row_id):
                phys = self._row_index.get(row_id)
                return phys is not None and bool(self._matrix[phys, word]
                                                 & mask)

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
        words, on the fragment's device) — over the rows the cache
        admits (all rows named by ``opt.row_ids`` when given), and of
        those only the rows of ``opt.filter_row_ids`` when given (an
        attribute filter). A
        ``none`` cache yields nothing without ids. Pairs are ordered by
        (-count, id); with ``n`` and no ids, count ties straddling the
        n-th place stay in and are cut by id."""
        opt = opt or TopOptions()
        with self.mu:
            n_phys = len(self._phys_rows)
            if n_phys == 0:
                return []
            if opt.row_ids is None and isinstance(self.cache, NopCache):
                return []
            if opt.src is not None:
                matrix = self.device_matrix()[:n_phys]
                if opt.tanimoto_threshold:
                    counts = topn_ops.tanimoto_masked_counts(
                        matrix, opt.src, self._row_counts_device(n_phys),
                        int(bitops.count(opt.src)), opt.tanimoto_threshold)
                else:
                    counts = bitops.count_and_rows(matrix, opt.src)
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
            elif not isinstance(self.cache, NopCache):
                mask &= np.isin(row_ids, self.cache.ids_arr())
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
            sel = idx[order[: opt.n]] if truncate else idx[order]
            return [(int(r), int(c))
                    for r, c in zip(row_ids[sel], counts_np[sel])]

    # -------------------------------------------------------------- backup

    def write_to(self, fileobj):
        """Tar archive of data + cache members (ref: fragment.go:1476-1560),
        the layout pilosa_tpu's read_from restores."""
        with self.mu:
            data = codec.serialize_arrays(*self._to_arrays_locked())
            cache = json.dumps(self.cache.ids()).encode()
        with tarfile.open(fileobj=fileobj, mode="w") as tar:
            for name, payload in (("data", data), ("cache", cache)):
                info = tarfile.TarInfo(name)
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))

    def read_from(self, fileobj):
        """Restore from a backup tar (ref: fragment.go:1562-1648):
        memory and the on-disk file are replaced by the archive's
        data."""
        with tarfile.open(fileobj=fileobj, mode="r") as tar:
            for member in tar.getmembers():
                payload = tar.extractfile(member).read()
                if member.name == "data":
                    with self.mu:
                        blocks, _, _ = codec.deserialize(payload)
                        self._reset_storage_locked()
                        self._load_blocks_locked(blocks)
                        if self._op_file is not None:
                            self._op_file.close()
                            self._op_file = None
                        with open(self.path, "wb") as f:
                            f.write(codec.serialize_arrays(
                                *self._to_arrays_locked()))
                        self.op_n = 0
                        self._snap_card = int(self._row_counts.sum())
                elif member.name == "cache":
                    with self.mu:
                        with open(self.cache_path, "wb") as f:
                            f.write(payload)
                        self.cache.clear()
                        self._open_cache()
