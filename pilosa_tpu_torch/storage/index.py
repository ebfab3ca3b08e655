"""Index — a database of frames (ref: index.go; counterpart of
pilosa_tpu/storage/index.py). ``.meta`` keys match pilosa_tpu's; column
attributes live in the sqlite store ``<index>/.data``, the column keys of
keyed imports in ``<index>/.keys`` and the input definitions as JSON
files under ``<index>/.input-definitions/``, as pilosa_tpu keeps them."""
import json
import os
import shutil
import threading
import time

from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch import time_quantum as tq
from pilosa_tpu_torch.storage.attrs import AttrStore
from pilosa_tpu_torch.storage.fragment import MutationEpoch
from pilosa_tpu_torch.storage.inputdef import InputDefinition
from pilosa_tpu_torch.storage.translate import TranslateStore
from pilosa_tpu_torch.storage.frame import (
    CACHE_TYPES,
    DEFAULT_CACHE_TYPE,
    DEFAULT_ROW_LABEL,
    Frame,
    FrameOptions,
)

DEFAULT_COLUMN_LABEL = "columnID"  # ref: index.go


class Index:
    def __init__(self, path, name, device="cuda", holder_locked=False,
                 governor=None):
        perr.validate_name(name)
        self.path = path
        self.name = name
        self.device = device
        self.holder_locked = holder_locked
        self.governor = governor  # the holder's host-memory governor
        # Bumped by every fragment open/close/mutation in this index.
        self.epoch = MutationEpoch(name)
        self.created_at = time.time()
        self.mu = threading.RLock()
        self.column_label = DEFAULT_COLUMN_LABEL
        self.time_quantum = ""
        self.frames = {}
        self.column_attr_store = AttrStore(os.path.join(path, ".data"),
                                           epoch=self.epoch)
        # Column key -> ID translation of keyed imports (translate.py).
        self.column_key_store = TranslateStore(os.path.join(path, ".keys"))
        self.input_definitions = {}
        # The largest slices peers reported (create-slice messages,
        # heartbeats, the max-slice poll): a coordinator plans over
        # slices only a peer holds.
        self.remote_max_slice = 0
        self.remote_max_inverse_slice = 0
        # Set by the holder on a cluster: sends create-slice messages.
        self.broadcaster = None

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
            self.column_attr_store.open()
            self.column_key_store.open()
            self._load_input_definitions()
        return self

    def close(self):
        with self.mu:
            for f in self.frames.values():
                f.close()
            self.frames = {}
            self.column_attr_store.close()
            self.column_key_store.close()

    def set_time_quantum(self, q):
        """The quantum new frames inherit (ref: index.go SetTimeQuantum)."""
        q = tq.validate_quantum(q)
        with self.mu:
            self.time_quantum = q
            self.save_meta()

    def _new_frame(self, name):
        frame = Frame(os.path.join(self.path, name), self.name, name,
                      device=self.device, epoch=self.epoch,
                      holder_locked=self.holder_locked,
                      governor=self.governor)
        frame.on_new_slice = self._on_new_slice
        return frame

    def _on_new_slice(self, view_name, slice_num):
        """Tell peers of a new standard or inverse slice (ref:
        view.go:240-255, server.go:361 ReceiveMessage) by the
        broadcaster's async send, which never raises: a peer it misses
        gets the message from its retry queue, a DOWN one from the
        rejoin schema push, and the max-slice poll is the backstop."""
        if self.broadcaster is None or view_name not in ("standard",
                                                         "inverse"):
            return
        self.broadcaster.send_async({
            "type": "create-slice", "index": self.name,
            "slice": slice_num, "inverse": view_name == "inverse"})

    def max_slice(self):
        """Max slice over the frames and what peers reported (ref:
        index.go:275-322)."""
        with self.mu:
            local = max((f.max_slice() for f in self.frames.values()),
                        default=0)
            return max(local, self.remote_max_slice)

    def max_inverse_slice(self):
        """The slice range of inverse-view calls (TopN(inverse=true);
        ref: index.go MaxInverseSlice)."""
        with self.mu:
            local = max((f.max_inverse_slice() for f in self.frames.values()),
                        default=0)
            return max(local, self.remote_max_inverse_slice)

    def set_remote_max_slice(self, n):
        with self.mu:
            self.remote_max_slice = max(self.remote_max_slice, n)

    def set_remote_max_inverse_slice(self, n):
        with self.mu:
            self.remote_max_inverse_slice = max(
                self.remote_max_inverse_slice, n)

    def frame(self, name):
        with self.mu:
            return self.frames.get(name)

    def create_frame(self, name, opt=None):
        with self.mu:
            if name in self.frames:
                raise perr.ErrFrameExists()
            return self._create_frame(name, opt or FrameOptions())

    def create_frame_if_not_exists(self, name, opt=None):
        with self.mu:
            frame = self.frames.get(name)
            if frame is not None:
                return frame
            return self._create_frame(name, opt or FrameOptions())

    def _create_frame(self, name, opt):
        """Validations per createFrame (ref: index.go:427-517)."""
        with self.mu:
            if not name:
                raise perr.ErrFrameRequired()
            if opt.cache_type and opt.cache_type not in CACHE_TYPES:
                raise perr.ErrInvalidCacheType()
            if (self.column_label == opt.row_label
                    or (not opt.row_label
                        and self.column_label == DEFAULT_ROW_LABEL)):
                raise perr.ErrColumnRowLabelEqual()
            if opt.range_enabled:
                if opt.inverse_enabled:
                    raise perr.ErrInverseRangeNotAllowed()
                if opt.cache_type and opt.cache_type != "none":
                    raise perr.ErrRangeCacheNotAllowed()
            elif opt.fields:
                raise perr.ErrFrameFieldsNotAllowed()
            for fd in opt.fields:
                fd.validate()
            frame = self._new_frame(name)
            frame.time_quantum = tq.validate_quantum(
                opt.time_quantum or self.time_quantum)
            frame.cache_type = ("none" if opt.range_enabled
                                else opt.cache_type or DEFAULT_CACHE_TYPE)
            if opt.row_label:
                perr.validate_label(opt.row_label)
                frame.row_label = opt.row_label
            if opt.cache_size:
                frame.cache_size = opt.cache_size
            frame.inverse_enabled = opt.inverse_enabled
            frame.range_enabled = opt.range_enabled
            frame.fields = list(opt.fields)
            frame.open()
            frame.save_meta()
            self.frames[name] = frame
            self.epoch.bump()
            return frame

    def delete_frame(self, name):
        """Close the frame and remove its directory; a frame that does
        not exist is no error (ref: index.go DeleteFrame)."""
        with self.mu:
            frame = self.frames.pop(name, None)
            if frame is None:
                return
            frame.close()
            shutil.rmtree(frame.path, ignore_errors=True)
            self.epoch.bump()

    # -------------------------------------------------- input definitions

    def input_definition_path(self):
        return os.path.join(self.path, ".input-definitions")

    def _load_input_definitions(self):
        """Caller holds self.mu (open)."""
        path = self.input_definition_path()
        if not os.path.isdir(path):
            return
        for entry in sorted(os.listdir(path)):
            with open(os.path.join(path, entry)) as f:
                self.input_definitions[entry] = InputDefinition.from_dict(
                    entry, json.load(f))

    def create_input_definition(self, name, frames, fields):
        """Validate, create the definition's frames, then store it (ref:
        pilosa_tpu index.py:352-389): a definition that can be read
        always has its frames. Frame options are the FrameOptions
        keyword names, as the reference reads them."""
        with self.mu:
            if not name:
                raise perr.ErrInputDefinitionNameRequired()
            if name in self.input_definitions:
                raise perr.ErrInputDefinitionExists()
            idef = InputDefinition(name, frames, fields)
            idef.validate(self.column_label)
        for fr in idef.frames:
            self.create_frame_if_not_exists(
                fr["name"], FrameOptions(**fr.get("options", {})))
        with self.mu:
            if name in self.input_definitions:  # raced a duplicate
                raise perr.ErrInputDefinitionExists()
            os.makedirs(self.input_definition_path(), exist_ok=True)
            with open(os.path.join(self.input_definition_path(), name),
                      "w") as f:
                json.dump(idef.to_dict(), f)
            self.input_definitions[name] = idef
            return idef

    def input_definition(self, name):
        with self.mu:
            idef = self.input_definitions.get(name)
            if idef is None:
                raise perr.ErrInputDefinitionNotFound()
            return idef

    def delete_input_definition(self, name):
        with self.mu:
            self.input_definition(name)
            del self.input_definitions[name]
            os.remove(os.path.join(self.input_definition_path(), name))

    def input_bits(self, frame, bits):
        """Apply mapped (row, column, timestamp) bits (ref: Index.InputBits
        index.go:785-806)."""
        fr = self.frame(frame)
        if fr is None:
            raise perr.ErrFrameNotFound()
        for row_id, col_id, t in bits:
            fr.set_bit("standard", row_id, col_id, t)
