"""Frame — a row namespace with its views and BSI field schema (ref:
frame.go; counterpart of pilosa_tpu/storage/frame.py). The ``.meta``
file is read and written with pilosa_tpu's keys and key order, so either
package opens what the other wrote, byte for byte; the time quantum is
carried through unchanged.

A BSI integer field ``f`` stores each column's value, offset by the
field's ``min``, in rows 0..depth-1 of the view ``field_f`` (row i holds
bit i) and marks the column in the not-null row ``depth``
(fragment.go:493-528).

A frame with a time quantum (``"YMD"``, …) also writes each timestamped
bit into one view per unit (``standard_2017``, ``standard_201706``,
``standard_20170601``; ``time_quantum.py``). Row attributes live in the
sqlite store ``<frame>/.data``, shared with pilosa_tpu, and the row keys
of keyed imports in ``<frame>/.keys`` (``translate.py``)."""
import json
import os
import shutil
import threading
import time

import numpy as np

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch import time_quantum as tq
from pilosa_tpu_torch.storage.attrs import AttrStore
from pilosa_tpu_torch.storage.translate import TranslateStore
from pilosa_tpu_torch.storage.view import (
    VIEW_INVERSE,
    VIEW_STANDARD,
    View,
    view_field_name,
)

DEFAULT_ROW_LABEL = "rowID"        # ref: frame.go:34-43
DEFAULT_CACHE_TYPE = "ranked"
DEFAULT_CACHE_SIZE = 50000
CACHE_TYPES = ("ranked", "lru", "none")
FIELD_TYPE_INT = "int"


class Field:
    """BSI int field schema (ref: FrameSchema/Field frame.go:983-1221)."""

    def __init__(self, name, type=FIELD_TYPE_INT, min=0, max=0):
        self.name = name
        self.type = type
        self.min = int(min)
        self.max = int(max)

    def validate(self):
        if not self.name:
            raise perr.ErrFieldNameRequired()
        if self.type != FIELD_TYPE_INT:
            raise perr.ErrInvalidFieldType()
        if self.min > self.max:
            raise perr.ErrInvalidFieldRange()
        return self

    def bit_depth(self):
        """Bits needed for max-min (ref: frame.go:1100-1107)."""
        for i in range(63):
            if self.max - self.min < (1 << i):
                return i
        return 63

    def base_value(self, op, value):
        """(base_value, out_of_range) — offset encoding
        (ref: Field.BaseValue frame.go:1121-1143)."""
        base = 0
        if op in (">", ">="):
            if value > self.max:
                return 0, True
            if value > self.min:
                base = value - self.min
        elif op in ("<", "<="):
            if value < self.min:
                return 0, True
            if value > self.max:
                base = self.max - self.min
            else:
                base = value - self.min
        elif op in ("==", "!="):
            if value < self.min or value > self.max:
                return 0, True
            base = value - self.min
        return base, False

    def base_value_between(self, lo, hi):
        """(ref: Field.BaseValueBetween frame.go:1146-1162)."""
        if hi < self.min or lo > self.max:
            return 0, 0, True
        base_lo = lo - self.min if lo > self.min else 0
        if hi > self.max:
            base_hi = self.max - self.min
        elif hi > self.min:
            base_hi = hi - self.min
        else:
            base_hi = 0
        return base_lo, base_hi, False

    def to_dict(self):
        return {"name": self.name, "type": self.type,
                "min": self.min, "max": self.max}

    @classmethod
    def from_dict(cls, d):
        return cls(d["name"], d.get("type", FIELD_TYPE_INT),
                   d.get("min", 0), d.get("max", 0))


class Frame:
    def __init__(self, path, index_name, name, device="cuda", epoch=None,
                 holder_locked=False, governor=None):
        perr.validate_name(name)
        self.path = path
        self.index_name = index_name
        self.name = name
        self.device = device
        self.epoch = epoch
        self.holder_locked = holder_locked
        self.governor = governor  # the holder's host-memory governor
        self.created_at = time.time()
        self.mu = threading.RLock()
        self.row_label = DEFAULT_ROW_LABEL
        self.inverse_enabled = False
        self.range_enabled = False
        self.cache_type = DEFAULT_CACHE_TYPE
        self.cache_size = DEFAULT_CACHE_SIZE
        self.time_quantum = ""
        self.fields = []  # [Field]
        self.views = {}
        self.row_attr_store = AttrStore(os.path.join(path, ".data"),
                                        epoch=epoch)
        # Row key -> ID translation of keyed imports (translate.py).
        self.row_key_store = TranslateStore(os.path.join(path, ".keys"))
        # Handed to every view (View.on_new_slice); set by the index.
        self.on_new_slice = None

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
        self.fields = [Field.from_dict(d) for d in m.get("fields", [])]
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
                "fields": [fd.to_dict() for fd in self.fields],
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
            self.row_attr_store.open()
            self.row_key_store.open()
        return self

    def close(self):
        with self.mu:
            for v in self.views.values():
                v.close()
            self.views = {}
            self.row_attr_store.close()
            self.row_key_store.close()

    def _open_view(self, name):
        """Caller holds self.mu."""
        v = View(os.path.join(self.path, "views", name), self.index_name,
                 self.name, name, device=self.device, epoch=self.epoch,
                 holder_locked=self.holder_locked,
                 cache_type=self.cache_type, cache_size=self.cache_size,
                 governor=self.governor)
        v.on_new_slice = self.on_new_slice
        v.open()
        self.views[name] = v
        return v

    def view(self, name):
        with self.mu:
            return self.views.get(name)

    def create_view_if_not_exists(self, name):
        """A new view bumps the index's epoch: a cached stack or plan
        that found no such view is stale from then on."""
        with self.mu:
            v = self.views.get(name)
            if v is None:
                v = self._open_view(name)
                self._bump_epoch()
            return v

    def delete_view(self, name):
        """Close the view and remove its fragments (ref: Frame.DeleteView
        frame.go:587-607)."""
        with self.mu:
            v = self.views.pop(name, None)
            if v is None:
                raise perr.ErrInvalidView()
            v.close()
            shutil.rmtree(v.path, ignore_errors=True)
            self._bump_epoch()

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

    def set_time_quantum(self, q):
        q = tq.validate_quantum(q)
        with self.mu:
            self.time_quantum = q
            self.save_meta()
            # A time Range's view cover follows the quantum.
            self._bump_epoch()

    def set_bit(self, view_name, row_id, column_id, t=None):
        """Write one bit and, with a timestamp ``t``, its time-quantum
        views (ref: Frame.SetBit frame.go:610-649)."""
        changed = self.create_view_if_not_exists(view_name).set_bit(
            row_id, column_id)
        if t is not None:
            for sub in tq.views_by_time(view_name, t, self.time_quantum):
                changed |= self.create_view_if_not_exists(sub).set_bit(
                    row_id, column_id)
        return changed

    def clear_bit(self, view_name, row_id, column_id, t=None):
        """(ref: Frame.ClearBit frame.go:652-700): time views that exist
        are cleared; none is created."""
        v = self.view(view_name)
        changed = v.clear_bit(row_id, column_id) if v else False
        if t is not None:
            for sub in tq.views_by_time(view_name, t, self.time_quantum):
                sv = self.view(sub)
                if sv:
                    changed |= sv.clear_bit(row_id, column_id)
        return changed

    def import_bits(self, row_ids, column_ids, timestamps=None):
        """Bulk import grouped by (view, slice): the standard view, the
        inverse view of an inverse-enabled frame (rows and columns
        swapped), and each timestamped bit's time views (ref:
        Frame.Import frame.go:806-884). ``timestamps`` holds a datetime
        or None per bit."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        if len(row_ids) != len(column_ids):
            raise ValueError("row/column id length mismatch")
        has_ts = timestamps is not None and len(timestamps) > 0
        if has_ts and len(timestamps) != len(row_ids):
            raise ValueError("timestamp length mismatch")
        if len(row_ids) == 0:
            return

        def import_view(view_name, rows, cols):
            if len(rows) == 0:
                return
            slices = cols // SLICE_WIDTH
            order = np.argsort(slices, kind="stable")
            rows, cols, slices = rows[order], cols[order], slices[order]
            bounds = np.flatnonzero(
                np.concatenate(([True], slices[1:] != slices[:-1])))
            bounds = np.append(bounds, len(slices))
            view = self.create_view_if_not_exists(view_name)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                frag = view.create_fragment_if_not_exists(int(slices[lo]))
                frag.import_bits(rows[lo:hi], cols[lo:hi])

        import_view(VIEW_STANDARD, row_ids, column_ids)
        if self.inverse_enabled:
            import_view(VIEW_INVERSE, column_ids, row_ids)
        if has_ts:
            groups = {}  # time view -> ([rows], [cols])
            for row, col, t in zip(row_ids, column_ids, timestamps):
                if t is None:
                    continue
                for sub in tq.views_by_time(VIEW_STANDARD, t,
                                            self.time_quantum):
                    g = groups.setdefault(sub, ([], []))
                    g[0].append(row)
                    g[1].append(col)
            for view_name, (rows, cols) in sorted(groups.items()):
                import_view(view_name, np.asarray(rows, dtype=np.uint64),
                            np.asarray(cols, dtype=np.uint64))


    # ------------------------------------------------------------ fields

    def field(self, name):
        for fd in self.fields:
            if fd.name == name:
                return fd
        raise perr.ErrFieldNotFound()

    def _bump_epoch(self):
        """Field DDL invalidates the executor's stacks and plans, which
        bake the field's depth and range in."""
        if self.epoch is not None:
            self.epoch.bump()

    def create_field(self, field):
        """(ref: Frame.CreateField frame.go:367-385)."""
        with self.mu:
            if not self.range_enabled:
                raise perr.ErrFrameFieldsNotAllowed()
            if any(fd.name == field.name for fd in self.fields):
                raise perr.ErrFieldExists()
            field.validate()
            self.fields.append(field)
            self.save_meta()
            self._bump_epoch()

    def delete_field(self, name):
        with self.mu:
            fd = self.field(name)
            self.fields.remove(fd)
            self.save_meta()
            v = self.views.pop(view_field_name(name), None)
            if v:
                v.close()
            self._bump_epoch()

    def _field_view(self, field):
        return self.create_view_if_not_exists(view_field_name(field.name))

    def set_field_value(self, column_id, field_name, value):
        """Offset-encode and store (ref: Frame.SetFieldValue
        frame.go:711-736); True iff a bit changed."""
        field = self.field(field_name)
        if value < field.min:
            raise perr.ErrFieldValueTooLow()
        if value > field.max:
            raise perr.ErrFieldValueTooHigh()
        return self._field_view(field).set_field_value(
            column_id, field.bit_depth(), value - field.min)

    def field_value(self, column_id, field_name):
        """(value, exists) (ref: Frame.FieldValue frame.go:702-709)."""
        field = self.field(field_name)
        value, exists = self._field_view(field).field_value(
            column_id, field.bit_depth())
        return (value + field.min if exists else 0), exists

    def import_value(self, field_name, column_ids, values):
        """Bulk BSI import, one ``import_value_bits`` per slice (ref:
        Frame.ImportValue frame.go:885-947)."""
        field = self.field(field_name)
        column_ids = [int(c) for c in column_ids]
        values = [int(v) for v in values]
        for val in values:
            if val < field.min:
                raise perr.ErrFieldValueTooLow()
            if val > field.max:
                raise perr.ErrFieldValueTooHigh()
        view = self._field_view(field)
        by_slice = {}
        for col, val in zip(column_ids, values):
            by_slice.setdefault(col // SLICE_WIDTH, []).append((col, val))
        for slice_num, pairs in sorted(by_slice.items()):
            view.create_fragment_if_not_exists(slice_num).import_value_bits(
                [c for c, _ in pairs], [v - field.min for _, v in pairs],
                field.bit_depth())


class FrameOptions:
    def __init__(self, row_label="", inverse_enabled=False,
                 range_enabled=False, cache_type="", cache_size=0,
                 time_quantum="", fields=None):
        self.row_label = row_label
        self.inverse_enabled = inverse_enabled
        self.range_enabled = range_enabled
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.time_quantum = time_quantum
        self.fields = fields or []

    @classmethod
    def from_dict(cls, opts):
        """The options of a frame's wire form (the body of POST
        /index/{i}/frame/{f})."""
        return cls(
            row_label=opts.get("rowLabel", ""),
            inverse_enabled=opts.get("inverseEnabled", False),
            range_enabled=opts.get("rangeEnabled", False),
            cache_type=opts.get("cacheType", ""),
            cache_size=opts.get("cacheSize", 0),
            time_quantum=opts.get("timeQuantum", ""),
            fields=[Field.from_dict(f) for f in opts.get("fields", [])])
