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

Rows always span the full slice (no column windows, no lazy/evicted
serving, no compressed containers, no BSI planes, no TopN cache — those
are later slices of the port). A fragment under a holder holds no
per-file lock: the holder's directory lock covers it.
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
from pilosa_tpu_torch.roaring import codec

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


class MutationEpoch:
    """A counter bumped by every fragment open, close and mutation under
    one index: an O(1) "has anything changed?" test for the executor's
    device-stack cache, instead of re-reading every fragment's version
    per query."""

    def __init__(self):
        self.value = 0
        self._mu = threading.Lock()

    def bump(self):
        with self._mu:
            self.value += 1


class Fragment:
    _UID_SEQ = itertools.count()

    def __init__(self, path, index, frame, view, slice_num, device="cpu",
                 epoch=None, holder_locked=False):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice_num
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
                # Rank-cache sidecar (ref: fragment.go:250-289): the ids
                # of non-empty rows, so pilosa_tpu's TopN cache finds
                # every row this package wrote.
                with open(self.cache_path, "w") as f:
                    json.dump(self.rows(nonempty=True), f)
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

    # -------------------------------------------------------------- backup

    def write_to(self, fileobj):
        """Tar archive of data + cache members (ref: fragment.go:1476-1560),
        the layout pilosa_tpu's read_from restores."""
        with self.mu:
            data = codec.serialize_arrays(*self._to_arrays_locked())
            cache = json.dumps(self.rows(nonempty=True)).encode()
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
                    with open(self.cache_path, "wb") as f:
                        f.write(payload)
