"""Key→ID translation store for keyed imports (counterpart of
pilosa_tpu/storage/translate.py: the same sqlite ``.keys`` schema, so a
file written by either package is read by the other).

The reference's wire format carries string keys (ImportRequest
RowKeys/ColumnKeys, internal/public.proto:77-78) and the client/CLI can
send them (`ImportK` client.go:307-330, `import -k` ctl/import.go), but
the server at this version never reads the key fields — keyed import is
a dead end there. Here the server completes the feature: every index
owns a column-key store and every frame a row-key store; unknown keys
are allocated dense monotonically-increasing IDs, so keyed data flows
through the same bitmap pipeline as integer IDs.

sqlite (stdlib, transactional, single-file) mirrors the attr store's
storage choice.
"""
import os
import sqlite3
import threading


class TranslateStore:
    def __init__(self, path):
        self.path = path
        self.mu = threading.RLock()
        self._db = None
        self._cache = {}

    def open(self):
        with self.mu:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._db = sqlite3.connect(self.path, check_same_thread=False)
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS keys ("
                "key TEXT PRIMARY KEY, id INTEGER NOT NULL)")
            self._db.execute(
                "CREATE UNIQUE INDEX IF NOT EXISTS keys_id ON keys (id)")
            self._db.commit()
        return self

    def close(self):
        with self.mu:
            if self._db:
                self._db.close()
                self._db = None
            self._cache = {}

    def translate(self, keys):
        """keys -> ids, allocating dense new IDs for unknown keys."""
        with self.mu:
            missing = [k for k in dict.fromkeys(keys)
                       if k not in self._cache]
            if missing:
                # sqlite caps host parameters (32766); chunk the lookup.
                for lo in range(0, len(missing), 900):
                    chunk = missing[lo : lo + 900]
                    placeholders = ",".join("?" * len(chunk))
                    for key, id_ in self._db.execute(
                            "SELECT key, id FROM keys WHERE key IN "
                            f"({placeholders})", chunk):
                        self._cache[key] = id_
                new = [k for k in missing if k not in self._cache]
                if new:
                    row = self._db.execute(
                        "SELECT COALESCE(MAX(id) + 1, 0) FROM keys").fetchone()
                    next_id = row[0]
                    self._db.executemany(
                        "INSERT INTO keys (key, id) VALUES (?, ?)",
                        [(k, next_id + i) for i, k in enumerate(new)])
                    self._db.commit()
                    for i, k in enumerate(new):
                        self._cache[k] = next_id + i
            return [self._cache[k] for k in keys]

    def key_of(self, id_):
        """Reverse lookup; None if unallocated."""
        with self.mu:
            row = self._db.execute(
                "SELECT key FROM keys WHERE id=?", (id_,)).fetchone()
            return row[0] if row else None
