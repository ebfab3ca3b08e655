"""Epoch-validated response replay cache (counterpart of
pilosa_tpu/server/respcache.py): the exact response bytes of identical
read queries, valid while their index's mutation-epoch token stands.
"""
import re
import threading

from pilosa_tpu_torch.pql.ast import WRITE_CALLS

# Exactly the PQL query route: endswith("/query") would also match other
# routes that end in "query".
_QUERY_ROUTE = re.compile(r"/index/[^/]+/query\Z")


class ResponseCache:
    """Replay of identical READ-query responses.

    The handler is deterministic, and the epoch token moves (before a
    write's HTTP response) on every data or schema change visible to the
    node, so replaying the bytes produced for (path, query parameters,
    body, content type, accept) is indistinguishable from re-executing
    as long as the token read BEFORE the original request still equals
    the current one. A ``None`` token (an index that does not exist)
    stores nothing. A body naming any write call is never cached, so no
    cached entry acknowledges a write it did not perform."""

    MAX = 512
    MAX_BYTES = 64 << 20  # payload budget, as the executor's result memo
    _WRITE_MARKERS = tuple(name.encode() for name in WRITE_CALLS)

    def __init__(self, epoch_reader):
        # epoch_reader(path) -> hashable validity token, or None (cold).
        self._epoch = epoch_reader
        self._mu = threading.Lock()
        self._entries = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def cacheable(self, method, path, body):
        return (method == "POST"
                and _QUERY_ROUTE.fullmatch(path) is not None
                and not any(m in body for m in self._WRITE_MARKERS))

    @staticmethod
    def make_key(path, qp, body, headers):
        """The cache key: the encoding negotiation is part of the
        response bytes; parse_qs values are lists, tupled to hash."""
        return (path,
                tuple((k, tuple(v)) for k, v in sorted(qp.items()))
                if qp else None,
                body, headers.get("Content-Type"),
                headers.get("Accept"))

    def pre_epoch(self, path):
        """Read BEFORE serving the request: a write landing mid-flight
        makes the stored token stale and the entry a harmless miss."""
        return self._epoch(path)

    def get(self, key):
        cur = self._epoch(key[0])
        with self._mu:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                return None
            if cur is None or hit[0] != cur:
                self.misses += 1
                if cur is not None:
                    # Tokens never return: evict on discovery.
                    del self._entries[key]
                    self._bytes -= len(hit[1][2])
                return None
            self.hits += 1
        return hit[1]

    def stats(self):
        with self._mu:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses}

    def put(self, key, epoch, resp):
        status, _, payload = resp[:3]
        if epoch is None or status != 200 \
                or len(payload) > self.MAX_BYTES // 8:
            return
        with self._mu:
            old = self._entries.get(key)
            if old is not None:
                self._bytes -= len(old[1][2])
            if (len(self._entries) >= self.MAX
                    or self._bytes + len(payload) > self.MAX_BYTES):
                self._entries.clear()
                self._bytes = 0
            self._entries[key] = (epoch, resp[:3])
            self._bytes += len(payload)
