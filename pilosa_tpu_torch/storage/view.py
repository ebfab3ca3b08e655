"""View — a named container of fragments keyed by slice (ref: view.go;
counterpart of pilosa_tpu/storage/view.py)."""
import os
import threading

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.storage.fragment import Fragment

VIEW_STANDARD = "standard"
VIEW_INVERSE = "inverse"


class View:
    def __init__(self, path, index, frame, name, device="cpu", epoch=None,
                 holder_locked=False):
        self.path = path
        self.index = index
        self.frame = frame
        self.name = name
        self.device = device
        self.epoch = epoch
        self.holder_locked = holder_locked
        self.mu = threading.RLock()
        self.fragments = {}  # slice -> Fragment

    def open(self):
        """Open every fragment file of the view (ref: view.go:100-158)."""
        with self.mu:
            frag_dir = os.path.join(self.path, "fragments")
            os.makedirs(frag_dir, exist_ok=True)
            for entry in sorted(os.listdir(frag_dir)):
                if entry.isdigit():  # skips .cache/.lock/.snapshotting
                    self._open_fragment(int(entry))
        return self

    def close(self):
        with self.mu:
            for frag in self.fragments.values():
                frag.close()
            self.fragments = {}

    def fragment_path(self, slice_num):
        return os.path.join(self.path, "fragments", str(slice_num))

    def _open_fragment(self, slice_num):
        """Caller holds self.mu."""
        frag = Fragment(self.fragment_path(slice_num), self.index,
                        self.frame, self.name, slice_num, device=self.device,
                        epoch=self.epoch, holder_locked=self.holder_locked)
        frag.open()
        self.fragments[slice_num] = frag
        return frag

    def fragment(self, slice_num):
        with self.mu:
            return self.fragments.get(slice_num)

    def create_fragment_if_not_exists(self, slice_num):
        """(ref: view.go:224)."""
        with self.mu:
            frag = self.fragments.get(slice_num)
            return frag if frag is not None else self._open_fragment(
                slice_num)

    def max_slice(self):
        with self.mu:
            return max(self.fragments, default=0)

    def set_bit(self, row_id, column_id):
        return self.create_fragment_if_not_exists(
            column_id // SLICE_WIDTH).set_bit(row_id, column_id)

    def clear_bit(self, row_id, column_id):
        frag = self.fragment(column_id // SLICE_WIDTH)
        return frag.clear_bit(row_id, column_id) if frag else False
