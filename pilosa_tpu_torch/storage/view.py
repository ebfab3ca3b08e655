"""View — a named container of fragments keyed by slice (ref: view.go;
counterpart of pilosa_tpu/storage/view.py).

View names: ``standard``, ``inverse``, and ``field_<name>`` for BSI
fields (view.go:32-38)."""
import os
import threading

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.storage.fragment import Fragment

VIEW_STANDARD = "standard"
VIEW_INVERSE = "inverse"
VIEW_FIELD_PREFIX = "field_"


def view_field_name(field):
    return VIEW_FIELD_PREFIX + field


class View:
    def __init__(self, path, index, frame, name, device="cuda", epoch=None,
                 holder_locked=False, cache_type="ranked", cache_size=50000,
                 governor=None):
        self.path = path
        self.index = index
        self.frame = frame
        self.name = name
        self.cache_type = cache_type   # the frame's TopN cache, per fragment
        self.cache_size = cache_size
        self.device = device
        self.epoch = epoch
        self.holder_locked = holder_locked
        self.governor = governor  # the holder's host-memory governor
        self.mu = threading.RLock()
        self.fragments = {}  # slice -> Fragment
        # Called with (view name, slice) when a write creates a fragment
        # (the index's create-slice broadcast); None on one node.
        self.on_new_slice = None
        self._slice_notified = set()

    def open(self):
        """Open every fragment file of the view (ref: view.go:100-158);
        a fragment reads nothing at open, and one listing of the
        directory stands in for each fragment's own file checks."""
        with self.mu:
            frag_dir = os.path.join(self.path, "fragments")
            os.makedirs(frag_dir, exist_ok=True)
            names = set(os.listdir(frag_dir))
            for entry in sorted(names):
                if entry.isdigit():  # skips .cache/.lock/.snapshotting
                    self._open_fragment(int(entry),
                                        lock_file=entry + ".lock" in names)
        return self

    def close(self):
        with self.mu:
            for frag in self.fragments.values():
                frag.close()
            self.fragments = {}

    def fragment_path(self, slice_num):
        return os.path.join(self.path, "fragments", str(slice_num))

    def _open_fragment(self, slice_num, lock_file=None):
        """Caller holds self.mu. ``lock_file`` (whether the fragment's
        ``.lock`` exists) comes from a listing that found the file."""
        frag = Fragment(self.fragment_path(slice_num), self.index,
                        self.frame, self.name, slice_num, device=self.device,
                        epoch=self.epoch, holder_locked=self.holder_locked,
                        cache_type=self.cache_type,
                        cache_size=self.cache_size)
        frag.governor = self.governor
        frag.open(lock_file=lock_file)
        self.fragments[slice_num] = frag
        return frag

    def fragment(self, slice_num):
        with self.mu:
            return self.fragments.get(slice_num)

    def create_fragment_if_not_exists(self, slice_num):
        """(ref: view.go:224); a created fragment is announced through
        ``on_new_slice``, outside the view's lock (the broadcast waits on
        the network)."""
        notify = False
        with self.mu:
            frag = self.fragments.get(slice_num)
            if frag is None:
                frag = self._open_fragment(slice_num)
                if (self.on_new_slice is not None
                        and slice_num not in self._slice_notified):
                    self._slice_notified.add(slice_num)
                    notify = True
        if notify:
            self.on_new_slice(self.name, slice_num)
        return frag

    def max_slice(self):
        with self.mu:
            return max(self.fragments, default=0)

    def set_bit(self, row_id, column_id):
        return self.create_fragment_if_not_exists(
            column_id // SLICE_WIDTH).set_bit(row_id, column_id)

    def clear_bit(self, row_id, column_id):
        frag = self.fragment(column_id // SLICE_WIDTH)
        return frag.clear_bit(row_id, column_id) if frag else False

    def set_field_value(self, column_id, bit_depth, value):
        return self.create_fragment_if_not_exists(
            column_id // SLICE_WIDTH).set_field_value(column_id, bit_depth,
                                                      value)

    def field_value(self, column_id, bit_depth):
        frag = self.fragment(column_id // SLICE_WIDTH)
        return frag.field_value(column_id, bit_depth) if frag else (0, False)
