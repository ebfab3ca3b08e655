"""Holder — root registry of all indexes under a data directory
(ref: holder.go:46-70; counterpart of pilosa_tpu/storage/holder.py).

The directory layout is pilosa_tpu's:
``<root>/<index>/<frame>/views/<view>/fragments/<slice>``. The holder
takes ONE exclusive flock on ``<root>/.holder.lock`` for its lifetime
(the protocol of pilosa_tpu holder.py:133-150), so the two packages
never have the same directory open at once: close one package's holder
before the other opens it.

The holder's device is where every fragment mirrors its rows and where
queries run. It is the GPU unless the caller asks for the CPU; without
a GPU, ``Holder(path)`` raises rather than carrying on on the CPU.
"""
import os
import threading

import torch

from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch.storage.fragment import HOLDER_LOCK_NAME, try_flock
from pilosa_tpu_torch.storage.index import Index


def resolve_device(device):
    """torch.device for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pilosa_tpu_torch runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev


class Holder:
    def __init__(self, path, device="cuda"):
        self.path = path
        self.device = resolve_device(device)
        self.mu = threading.RLock()
        self.indexes = {}
        self._dir_lock = None

    def open(self):
        """Lock the directory and open every index (ref: holder.go:87-150)."""
        with self.mu:
            os.makedirs(self.path, exist_ok=True)
            self._dir_lock = try_flock(
                os.path.join(self.path, HOLDER_LOCK_NAME),
                perr.ErrHolderLocked)
            try:
                for entry in sorted(os.listdir(self.path)):
                    full = os.path.join(self.path, entry)
                    if os.path.isdir(full) and not entry.startswith("."):
                        self.indexes[entry] = self._new_index(entry).open()
            except BaseException:
                self.close()
                raise
        return self

    def close(self):
        with self.mu:
            try:
                for idx in self.indexes.values():
                    idx.close()
                self.indexes = {}
            finally:
                if self._dir_lock is not None:
                    self._dir_lock.close()
                    self._dir_lock = None

    def _new_index(self, name):
        return Index(os.path.join(self.path, name), name,
                     device=self.device, holder_locked=True)

    def index(self, name):
        with self.mu:
            return self.indexes.get(name)

    def create_index(self, name, column_label=""):
        with self.mu:
            if not name:
                raise perr.ErrIndexRequired()
            if name in self.indexes:
                raise perr.ErrIndexExists()
            idx = self._new_index(name).open()
            if column_label:
                idx.column_label = perr.validate_label(column_label)
            idx.save_meta()
            self.indexes[name] = idx
            return idx

    def fragment(self, index, frame, view, slice_num):
        """Accessor chain (ref: holder.go:196-338)."""
        return self.fragments(index, frame, view, [slice_num])[0]

    def fragments(self, index, frame, view, slices):
        """One lookup per slice after resolving index→frame→view once."""
        idx = self.index(index)
        fr = idx.frame(frame) if idx is not None else None
        v = fr.view(view) if fr is not None else None
        if v is None:
            return [None] * len(slices)
        return [v.fragment(s) for s in slices]

    def max_slices(self):
        """{index: max_slice}."""
        with self.mu:
            return {name: idx.max_slice()
                    for name, idx in self.indexes.items()}
