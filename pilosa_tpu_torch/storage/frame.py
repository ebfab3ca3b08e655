"""Frame — a row namespace with its views (ref: frame.go; counterpart of
pilosa_tpu/storage/frame.py). The ``.meta`` file is read and written
with pilosa_tpu's keys, so either package opens what the other wrote;
keys this slice does not act on (time quantum, BSI fields) are carried
through unchanged."""
import json
import os
import threading
import time

from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch.storage.view import VIEW_INVERSE, View

DEFAULT_ROW_LABEL = "rowID"        # ref: frame.go:34-43
DEFAULT_CACHE_TYPE = "ranked"
DEFAULT_CACHE_SIZE = 50000
CACHE_TYPES = ("ranked", "lru", "none")


class Frame:
    def __init__(self, path, index_name, name, device="cpu", epoch=None,
                 holder_locked=False):
        perr.validate_name(name)
        self.path = path
        self.index_name = index_name
        self.name = name
        self.device = device
        self.epoch = epoch
        self.holder_locked = holder_locked
        self.created_at = time.time()
        self.mu = threading.RLock()
        self.row_label = DEFAULT_ROW_LABEL
        self.inverse_enabled = False
        self.range_enabled = False
        self.cache_type = DEFAULT_CACHE_TYPE
        self.cache_size = DEFAULT_CACHE_SIZE
        self.time_quantum = ""
        self.fields = []  # BSI field schema dicts, carried through
        self.views = {}

    @property
    def meta_path(self):
        return os.path.join(self.path, ".meta")

    def load_meta(self):
        try:
            with open(self.meta_path) as f:
                m = json.load(f)
        except FileNotFoundError:
            return
        self.row_label = m.get("rowLabel", DEFAULT_ROW_LABEL)
        self.inverse_enabled = m.get("inverseEnabled", False)
        self.range_enabled = m.get("rangeEnabled", False)
        self.cache_type = m.get("cacheType", DEFAULT_CACHE_TYPE)
        self.cache_size = m.get("cacheSize", DEFAULT_CACHE_SIZE)
        self.time_quantum = m.get("timeQuantum", "")
        self.fields = list(m.get("fields", []))
        self.created_at = float(m.get("createdAt") or 0.0)

    def save_meta(self):
        os.makedirs(self.path, exist_ok=True)
        with open(self.meta_path, "w") as f:
            json.dump({
                "rowLabel": self.row_label,
                "inverseEnabled": self.inverse_enabled,
                "rangeEnabled": self.range_enabled,
                "cacheType": self.cache_type,
                "cacheSize": self.cache_size,
                "timeQuantum": self.time_quantum,
                "fields": self.fields,
                "createdAt": self.created_at,
            }, f)

    def open(self):
        """(ref: frame.go:238-297)."""
        with self.mu:
            views_dir = os.path.join(self.path, "views")
            os.makedirs(views_dir, exist_ok=True)
            self.load_meta()
            for entry in sorted(os.listdir(views_dir)):
                if os.path.isdir(os.path.join(views_dir, entry)):
                    self._open_view(entry)
        return self

    def close(self):
        with self.mu:
            for v in self.views.values():
                v.close()
            self.views = {}

    def _open_view(self, name):
        """Caller holds self.mu."""
        v = View(os.path.join(self.path, "views", name), self.index_name,
                 self.name, name, device=self.device, epoch=self.epoch,
                 holder_locked=self.holder_locked,
                 cache_type=self.cache_type, cache_size=self.cache_size)
        v.open()
        self.views[name] = v
        return v

    def view(self, name):
        with self.mu:
            return self.views.get(name)

    def create_view_if_not_exists(self, name):
        with self.mu:
            return self.views.get(name) or self._open_view(name)

    def max_slice(self):
        """Max over every non-inverse view (ref: frame.go:115-127)."""
        with self.mu:
            return max((v.max_slice() for name, v in self.views.items()
                        if name != VIEW_INVERSE), default=0)

    def max_inverse_slice(self):
        """(ref: frame.go max_inverse_slice)."""
        with self.mu:
            v = self.views.get(VIEW_INVERSE)
            return v.max_slice() if v else 0

    def set_bit(self, view_name, row_id, column_id):
        return self.create_view_if_not_exists(view_name).set_bit(
            row_id, column_id)

    def clear_bit(self, view_name, row_id, column_id):
        v = self.view(view_name)
        return v.clear_bit(row_id, column_id) if v else False


class FrameOptions:
    def __init__(self, row_label="", inverse_enabled=False, cache_type="",
                 cache_size=0):
        self.row_label = row_label
        self.inverse_enabled = inverse_enabled
        self.cache_type = cache_type
        self.cache_size = cache_size
