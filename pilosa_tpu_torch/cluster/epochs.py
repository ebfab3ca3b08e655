"""The cluster's epoch vector: one validity check for every warm tier of
a node of a static cluster (counterpart of pilosa_tpu/cluster/epochs.py).

On one node a memo or a replayed response is valid while its index's
mutation epoch stands. On a cluster a peer's write moves only the
peer's counters, so each node keeps the last counters it saw of every
peer, by index (``ClusterEpochs``), and a warm tier validates on the
vector over the nodes that own the query's slices:

- **Piggyback.** Every response of a node of a cluster carries the
  node's counters in one header (``X-Pilosa-Epochs``), and every
  heartbeat in one field; the internal client feeds each into the
  registry. A node that relays a write learns the owners' moved counters
  from the write's own responses: read-your-writes through it is strict.
- **Probes.** Before a replay, a peer whose last observation is older
  than ``ttl`` is asked (``GET /internal/epochs``, in parallel for
  several): a write this node never relayed shows in its caches at most
  ``ttl`` seconds after it landed.
- **Cold, never stale.** An unknown peer, or a stale one a probe could
  not refresh, gives ``token() is None``, and every tier then neither
  replays nor stores.

A token is ``((host, incarnation, counter), ...)`` sorted by host; the
incarnation (``!``, a per-process boot nonce) makes a restarted peer,
whose counters start again at 0, unable to re-validate an entry minted
before its restart. The wire carries one counter per index (the
process's counter of the index name, ``storage.fragment.mutation_epoch``)
and the process total ``*`` for an index the peer had not created.

Left for later ports: the publisher of the vector to worker processes
(``attach_worker_publisher``, ROADMAP Queue A 19) and the
``client.epoch.stale`` failpoint (Queue A 22).
"""
import os
import threading
import time
import urllib.parse

from pilosa_tpu_torch.storage import fragment as _frag
from pilosa_tpu_torch.utils import fanpool

EPOCH_HEADER = "X-Pilosa-Epochs"
INCARNATION_KEY = "!"
TOTAL_KEY = "*"
_BOOT_NONCE = int.from_bytes(os.urandom(8), "little")

# The membership heartbeat's interval: heartbeats refresh every peer's
# counters, so the serving path seldom has to probe.
DEFAULT_PROBE_TTL = 5.0


def local_epochs(holder):
    """This process's counters of the holder's indexes, its total and
    its boot nonce: the payload of every piggyback, probe and heartbeat."""
    out = {name: _frag.mutation_epoch(name) for name in list(holder.indexes)}
    out[TOTAL_KEY] = _frag.epoch_total()
    out[INCARNATION_KEY] = _BOOT_NONCE
    return out


def encode_epochs(host, epochs):
    """``host;key=counter,...``, keys sorted and URL-quoted."""
    parts = ",".join(
        f"{urllib.parse.quote(str(k), safe='*')}={int(v)}"
        for k, v in sorted(epochs.items()))
    return f"{urllib.parse.quote(host, safe=':')};{parts}"


def decode_epochs(value):
    """-> (host, {key: counter}); raises ValueError on garbage."""
    head, _, rest = value.partition(";")
    host = urllib.parse.unquote(head)
    if not host:
        raise ValueError("epoch header missing host")
    epochs = {}
    for item in rest.split(","):
        if not item:
            continue
        k, sep, v = item.partition("=")
        if not sep:
            raise ValueError(f"bad epoch entry: {item!r}")
        epochs[urllib.parse.unquote(k)] = int(v)
    return host, epochs


class ClusterEpochs:
    """The epoch-vector registry of one node of a cluster; thread-safe.
    A one-node server has none, and every hook is then one attribute
    read."""

    HEADER = EPOCH_HEADER

    def __init__(self, local_host, holder, cluster=None, client=None,
                 ttl=DEFAULT_PROBE_TTL, probe_timeout=None):
        self.local_host = local_host
        self.holder = holder
        self.cluster = cluster
        self.client = client
        self.ttl = float(ttl)
        # A probe never stalls a replay longer than the staleness bound.
        self.probe_timeout = (probe_timeout if probe_timeout is not None
                              else min(1.0, self.ttl) or 1.0)
        # A failed probe is not retried for one ttl: a dead peer means
        # cold for that window, not a connect per cached request.
        self.probe_backoff = self.ttl
        self._mu = threading.Lock()
        self._peers = {}      # host -> (epochs dict, monotonic seen at)
        self._probe_at = {}   # host -> monotonic of the last probe
        self._version = 0     # moves on every observed change
        self._hdr_memo = (None, None)
        self._pool = None     # FanoutPool of parallel probes, lazily
        self.counters = {"observations": 0, "changes": 0, "probes": 0,
                         "probe_failures": 0, "cold": 0, "tokens": 0}

    # ---------------------------------------------------------- piggyback

    def header_value(self):
        """The local vector for a response header, memoized on the
        process total."""
        tot = _frag.epoch_total()
        memo = self._hdr_memo
        if memo[0] == tot:
            return memo[1]
        val = encode_epochs(self.local_host, local_epochs(self.holder))
        self._hdr_memo = (tot, val)
        return val

    def observe_header(self, value):
        try:
            host, epochs = decode_epochs(value)
        except (ValueError, TypeError):
            return
        self.observe(host, epochs)

    def observe(self, host, epochs):
        """Learn a peer's counters (a response header, a heartbeat or a
        probe)."""
        if host == self.local_host or not isinstance(epochs, dict):
            return
        try:
            epochs = {str(k): int(v) for k, v in epochs.items()}
        except (TypeError, ValueError):
            return
        with self._mu:
            self.counters["observations"] += 1
            cur = self._peers.get(host)
            if cur is None or cur[0] != epochs:
                self._version += 1
                self.counters["changes"] += 1
            self._peers[host] = (epochs, time.monotonic())
            self._probe_at.pop(host, None)

    # ------------------------------------------------------------- tokens

    def _peer_counter_locked(self, host, index, now):
        """(incarnation, counter) of a fresh peer entry, else None."""
        ent = self._peers.get(host)
        if ent is None or now - ent[1] > self.ttl:
            return None
        epochs = ent[0]
        ctr = epochs.get(index)
        if ctr is None:
            ctr = epochs.get(TOTAL_KEY)
        if ctr is None:
            return None
        return epochs.get(INCARNATION_KEY, 0), ctr

    def peer_fresh(self, host):
        """Whether ``host`` is this node or was observed within ttl."""
        if host == self.local_host:
            return True
        now = time.monotonic()
        with self._mu:
            ent = self._peers.get(host)
        return ent is not None and now - ent[1] <= self.ttl

    def token(self, index, hosts):
        """The validity token over ``hosts`` (the owners of the queried
        slices; this node reads its live counter), or None when a peer
        is unknown or stale: cold, never stale."""
        now = time.monotonic()
        parts = []
        with self._mu:
            self.counters["tokens"] += 1
            for h in sorted(set(hosts)):
                if h == self.local_host:
                    continue
                ent = self._peer_counter_locked(h, index, now)
                if ent is None:
                    self.counters["cold"] += 1
                    return None
                parts.append((h, ent[0], ent[1]))
        parts.append((self.local_host, _BOOT_NONCE,
                      _frag.mutation_epoch(index)))
        parts.sort()
        return tuple(parts)

    def ensure_fresh(self, index, hosts):
        """``token()``, after probing the stale peers among ``hosts`` in
        parallel (each at most once a ttl, bounded by probe_timeout)."""
        tok = self.token(index, hosts)
        if tok is not None:
            return tok
        now = time.monotonic()
        stale = []
        with self._mu:
            for h in set(hosts):
                if h == self.local_host:
                    continue
                ent = self._peers.get(h)
                if ent is not None and now - ent[1] <= self.ttl:
                    continue
                if now - self._probe_at.get(h, -1e9) < self.probe_backoff:
                    continue  # probed lately and still cold: stay cold
                self._probe_at[h] = now
                stale.append(h)
        if stale:
            self._probe_hosts(stale)
        return self.token(index, hosts)

    def validate(self, index, stored):
        """The current token over a stored token's own hosts: equal to
        it means valid, None or unequal a miss."""
        return self.ensure_fresh(index, [p[0] for p in stored])

    # ------------------------------------------------------------- probes

    def _probe_hosts(self, hosts):
        if self.client is None or self.cluster is None:
            return
        nodes = [n for h in hosts
                 for n in (self.cluster.node_by_host(h),) if n is not None]
        if not nodes:
            return

        def probe(node):
            with self._mu:
                self.counters["probes"] += 1
            try:
                out = self.client.epochs_fetch(
                    node, timeout=self.probe_timeout)
            except Exception:  # noqa: BLE001 — unprobeable means cold
                with self._mu:
                    self.counters["probe_failures"] += 1
                return
            eps = out.get("epochs")
            if isinstance(eps, dict):
                # Keyed by the member we probed, as token() looks up.
                self.observe(node.host, eps)

        if len(nodes) == 1:
            probe(nodes[0])
            return
        if self._pool is None:
            self._pool = fanpool.FanoutPool(max_idle=4)
        fanpool.run_all(self._pool, [lambda n=n: probe(n) for n in nodes])

    # -------------------------------------------------------------- intro

    def snapshot(self):
        """``GET /debug/epochs``."""
        now = time.monotonic()
        with self._mu:
            peers = {
                host: {"ageSeconds": round(now - at, 3),
                       "fresh": now - at <= self.ttl,
                       "epochs": dict(eps)}
                for host, (eps, at) in self._peers.items()}
            return {"enabled": True, "host": self.local_host,
                    "ttlSeconds": self.ttl,
                    "probeTimeout": self.probe_timeout,
                    "version": self._version,
                    "local": local_epochs(self.holder),
                    "peers": peers, "counters": dict(self.counters)}

    def metrics(self):
        """The ``pilosa_epoch_*`` counters."""
        with self._mu:
            out = {f"{k}_total": v for k, v in self.counters.items()}
            out["version"] = self._version
            out["peers_known"] = len(self._peers)
            return out

    def close(self):
        if self._pool is not None:
            self._pool.close()
