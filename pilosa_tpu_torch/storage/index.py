"""Index — a database of frames (ref: index.go; counterpart of
pilosa_tpu/storage/index.py). ``.meta`` keys match pilosa_tpu's."""
import json
import os
import threading
import time

from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch.storage.fragment import MutationEpoch
from pilosa_tpu_torch.storage.frame import (
    CACHE_TYPES,
    DEFAULT_CACHE_TYPE,
    DEFAULT_ROW_LABEL,
    Frame,
    FrameOptions,
)

DEFAULT_COLUMN_LABEL = "columnID"  # ref: index.go


class Index:
    def __init__(self, path, name, device="cpu", holder_locked=False):
        perr.validate_name(name)
        self.path = path
        self.name = name
        self.device = device
        self.holder_locked = holder_locked
        # Bumped by every fragment open/close/mutation in this index.
        self.epoch = MutationEpoch()
        self.created_at = time.time()
        self.mu = threading.RLock()
        self.column_label = DEFAULT_COLUMN_LABEL
        self.time_quantum = ""
        self.frames = {}

    @property
    def meta_path(self):
        return os.path.join(self.path, ".meta")

    def load_meta(self):
        try:
            with open(self.meta_path) as f:
                m = json.load(f)
        except FileNotFoundError:
            return
        self.column_label = m.get("columnLabel", DEFAULT_COLUMN_LABEL)
        self.time_quantum = m.get("timeQuantum", "")
        self.created_at = float(m.get("createdAt") or 0.0)

    def save_meta(self):
        os.makedirs(self.path, exist_ok=True)
        with open(self.meta_path, "w") as f:
            json.dump({"columnLabel": self.column_label,
                       "timeQuantum": self.time_quantum,
                       "createdAt": self.created_at}, f)

    def open(self):
        """Open every frame directory (ref: index.go:153-208); dot
        entries (.meta, attribute and key stores) are not frames."""
        with self.mu:
            os.makedirs(self.path, exist_ok=True)
            self.load_meta()
            for entry in sorted(os.listdir(self.path)):
                full = os.path.join(self.path, entry)
                if os.path.isdir(full) and not entry.startswith("."):
                    self.frames[entry] = self._new_frame(entry).open()
        return self

    def close(self):
        with self.mu:
            for f in self.frames.values():
                f.close()
            self.frames = {}

    def _new_frame(self, name):
        return Frame(os.path.join(self.path, name), self.name, name,
                     device=self.device, epoch=self.epoch,
                     holder_locked=self.holder_locked)

    def max_slice(self):
        """(ref: index.go:275-322, single node)."""
        with self.mu:
            return max((f.max_slice() for f in self.frames.values()),
                       default=0)

    def frame(self, name):
        with self.mu:
            return self.frames.get(name)

    def create_frame(self, name, opt=None):
        """Validations per createFrame (ref: index.go:427-517)."""
        opt = opt or FrameOptions()
        with self.mu:
            if not name:
                raise perr.ErrFrameRequired()
            if name in self.frames:
                raise perr.ErrFrameExists()
            if opt.cache_type and opt.cache_type not in CACHE_TYPES:
                raise perr.ErrInvalidCacheType()
            if (self.column_label == opt.row_label
                    or (not opt.row_label
                        and self.column_label == DEFAULT_ROW_LABEL)):
                raise perr.ErrColumnRowLabelEqual()
            frame = self._new_frame(name)
            frame.time_quantum = self.time_quantum
            frame.cache_type = opt.cache_type or DEFAULT_CACHE_TYPE
            if opt.row_label:
                perr.validate_label(opt.row_label)
                frame.row_label = opt.row_label
            if opt.cache_size:
                frame.cache_size = opt.cache_size
            frame.inverse_enabled = opt.inverse_enabled
            frame.open()
            frame.save_meta()
            self.frames[name] = frame
            return frame
