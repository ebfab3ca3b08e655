"""Metadata broadcast plane (ref: broadcast.go; counterpart of
pilosa_tpu/cluster/broadcast.py).

Schema DDL goes to every live peer synchronously (``send_sync``: POST
/cluster/message, fail on any peer); create-slice messages go
asynchronously (``send_async``). An async send posts every peer in
parallel and waits up to ``ASYNC_WAIT`` seconds, so healthy peers hold
the message before the write that caused it returns; a peer it fails to
reach enters a bounded retry queue, drained by a background thread and
coalesced per (host, message kind), the HTTP analog of re-gossiping an
undelivered broadcast. Peers membership knows to be DOWN are skipped:
the schema push on their rejoin reconciles them.
"""
import threading
import time


class NopBroadcaster:
    """(ref: broadcast.go:70-100)."""

    def send_sync(self, msg):
        pass

    def send_async(self, msg):
        pass

    def close(self):
        pass


class HTTPBroadcaster:
    """SendSync to every peer (ref: Server.SendSync server.go:444-465)."""

    RETRY_INTERVAL = 5      # seconds between queue drains
    RETRY_MAX = 12          # attempts per message before giving up
    QUEUE_MAX = 1024        # bounded: DDL is low-rate; drop oldest
    # How long send_async waits for its parallel deliveries; stragglers
    # go on and queue the message themselves if they fail.
    ASYNC_WAIT = 3.0

    def __init__(self, client, cluster, local_host):
        self.client = client
        self.cluster = cluster
        self.local_host = local_host
        self._retry = []     # [(coalesce key, host, msg, attempts)]
        self._mu = threading.Lock()
        self._closing = threading.Event()
        self._retry_thread = None

    def _peers(self):
        ns = self.cluster.node_set
        nodes = ns.nodes() if ns is not None else self.cluster.nodes
        return [n for n in nodes if n.host != self.local_host]

    def send_sync(self, msg):
        errors = []
        for node in self._peers():
            try:
                self.client.send_message(node, msg)
            except Exception as e:  # noqa: BLE001 — collect and report
                errors.append((node.host, str(e)))
        if errors:
            raise RuntimeError(f"broadcast errors: {errors}")

    def send_async(self, msg):
        """Best-effort delivery that never raises (ref: SendAsync
        broadcast.go:116)."""
        def run(node):
            try:
                self.client.send_message(node, msg, timeout=5)
            except Exception:  # noqa: BLE001 — queued for retry
                self._enqueue(node.host, msg)

        threads = []
        for node in self._peers():
            t = threading.Thread(target=run, args=(node,), daemon=True)
            t.start()
            threads.append(t)
        deadline = time.monotonic() + self.ASYNC_WAIT
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    # --------------------------------------------------------- retry queue

    @staticmethod
    def _coalesce_key(host, msg):
        """Messages that supersede each other share a key: a
        create-slice keeps only the largest slice of its (host, index,
        inverse) — the receiver keeps a maximum — and DDL re-sent is
        idempotent."""
        return (host, msg.get("type"), msg.get("index"), msg.get("frame"),
                msg.get("name"), msg.get("field"), msg.get("view"),
                msg.get("inverse"))

    def _enqueue(self, host, msg, attempts=0):
        key = self._coalesce_key(host, msg)
        with self._mu:
            for i, (k, _, m, att) in enumerate(self._retry):
                if k == key:
                    if (msg.get("type") == "create-slice"
                            and m.get("slice", 0) > msg.get("slice", 0)):
                        msg = m
                    self._retry[i] = (key, host, msg, min(att, attempts))
                    break
            else:
                if len(self._retry) >= self.QUEUE_MAX:
                    self._retry.pop(0)
                self._retry.append((key, host, msg, attempts))
            if self._retry_thread is None and not self._closing.is_set():
                self._retry_thread = threading.Thread(
                    target=self._retry_loop, daemon=True,
                    name="broadcast-retry")
                self._retry_thread.start()

    def _drain_once(self):
        with self._mu:
            pending, self._retry = self._retry, []
        by_host = {n.host: n for n in self.cluster.nodes}
        ns = self.cluster.node_set
        for _, host, msg, attempts in pending:
            node = by_host.get(host)
            if node is None:
                continue
            if ns is not None and hasattr(ns, "is_down") and ns.is_down(host):
                continue  # the rejoin schema push reconciles it
            try:
                self.client.send_message(node, msg)
            except Exception:  # noqa: BLE001 — still unreachable
                if attempts + 1 < self.RETRY_MAX:
                    self._enqueue(host, msg, attempts + 1)

    def _retry_loop(self):
        while not self._closing.wait(self.RETRY_INTERVAL):
            self._drain_once()

    def pending_retries(self):
        with self._mu:
            return len(self._retry)

    def close(self):
        self._closing.set()


class StaticNodeSet:
    """Static membership from configuration (ref: broadcast.go:39-61)."""

    def __init__(self, nodes=None):
        self._nodes = list(nodes or [])

    def open(self):
        return self

    def close(self):
        pass

    def nodes(self):
        return list(self._nodes)
