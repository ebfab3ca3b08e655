"""Attribute store: key/value metadata per row or column id (ref:
attr.go:37-229; counterpart of pilosa_tpu/storage/attrs.py).

The reference keeps BoltDB files with msgpack values and an in-memory
cache. Like pilosa_tpu, this store is one sqlite3 file (table ``attrs(id
INTEGER PRIMARY KEY, val TEXT)``, values JSON with sorted keys) with the
same cache overlay, so a ``.data`` file written by either package reads
back in the other.
"""
import json
import os
import sqlite3
import threading


class AttrStore:
    def __init__(self, path, epoch=None):
        self.path = path
        # The owning index's mutation epoch: an attribute write moves it,
        # so result memos over bitmap attrs and TopN filters go stale.
        self.epoch = epoch
        self.mu = threading.RLock()
        self._db = None
        self._cache = {}

    def open(self):
        with self.mu:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._db = sqlite3.connect(self.path, check_same_thread=False)
            self._db.execute("CREATE TABLE IF NOT EXISTS attrs "
                             "(id INTEGER PRIMARY KEY, val TEXT)")
            self._db.commit()
        return self

    def close(self):
        with self.mu:
            if self._db:
                self._db.close()
                self._db = None
            self._cache = {}

    def attrs(self, id_):
        """A copy of the id's attributes, {} when it has none (ref:
        AttrStore.Attrs attr.go:131)."""
        with self.mu:
            if id_ in self._cache:
                return dict(self._cache[id_])
            row = self._db.execute(
                "SELECT val FROM attrs WHERE id=?", (id_,)).fetchone()
            m = json.loads(row[0]) if row else {}
            self._cache[id_] = m
            return dict(m)

    def _merge_locked(self, id_, m):
        """Merge ``m`` into the id's attributes (a None value deletes
        the key) and write the row; the caller commits."""
        cur = self.attrs(id_)
        for k, v in m.items():
            if v is None:
                cur.pop(k, None)
            else:
                cur[k] = v
        self._db.execute("INSERT OR REPLACE INTO attrs (id, val) VALUES (?, ?)",
                         (id_, json.dumps(cur, sort_keys=True)))
        self._cache[id_] = cur

    def set_attrs(self, id_, m):
        """(ref: SetAttrs attr.go:158-190)."""
        with self.mu:
            self._merge_locked(id_, m)
            self._db.commit()
        self._bump_epoch()

    def set_bulk_attrs(self, attr_map):
        """{id: attrs} in one transaction (ref: SetBulkAttrs
        attr.go:192-229)."""
        with self.mu:
            for id_, m in sorted(attr_map.items()):
                self._merge_locked(id_, m)
            self._db.commit()
        self._bump_epoch()

    def _bump_epoch(self):
        if self.epoch is not None:
            self.epoch.bump()

    def ids(self):
        """Every id with a stored row, ascending."""
        with self.mu:
            return [r[0] for r in self._db.execute(
                "SELECT id FROM attrs ORDER BY id")]
