"""HTTP heartbeat membership — failure detection without gossip
(ref: gossip/gossip.go over memberlist's SWIM; counterpart of
pilosa_tpu/cluster/membership.py).

- **Probe subsets.** Each round probes at most ``probe_subset`` peers
  from a shuffled cycle (every peer once per ceil((n-1)/k) rounds), plus
  every peer that is DOWN, so a rejoin is seen within one round.
- **Suspicion by indirect probes.** A peer that fails ``suspect_after``
  direct probes in a row is not declared DOWN at once: up to
  ``indirect_n`` other live peers are asked to probe it
  (GET /internal/probe), and any success clears the suspicion.
- **State exchange.** With ``status_fn``/``merge_fn`` a probe is a POST
  /internal/heartbeat carrying this node's compact status (schema,
  schema digest, max-slice maps) and answered with the peer's, which
  ``merge_fn`` applies; the schema is left out while the peer's last
  digest equals ours. Without them a probe is a GET /id.

DOWN peers drop out of ``nodes()``, which feeds
``Cluster.node_states``, the executor's slice mapping and its hinted
handoff. A DOWN peer that answers again rejoins and ``on_rejoin`` runs
(the server pushes its schema and replays the writes hinted for it).
"""
import logging
import random
import threading

logger = logging.getLogger(__name__)


class HTTPNodeSet:
    def __init__(self, cluster, local_host, client, interval=5,
                 suspect_after=3, on_rejoin=None, probe_subset=3,
                 indirect_n=2, status_fn=None, merge_fn=None):
        self.cluster = cluster
        self.local_host = local_host
        self.client = client
        self.interval = interval
        self.suspect_after = suspect_after
        self.on_rejoin = on_rejoin
        self.probe_subset = probe_subset
        self.indirect_n = indirect_n
        self.status_fn = status_fn
        self.merge_fn = merge_fn
        self._peer_digests = {}       # host -> last schemaDigest seen
        self._failures = {}   # host -> consecutive failed probes
        self._down = set()
        self._cycle = []      # shuffled peer hosts left in this cycle
        self._mu = threading.Lock()
        self._closing = threading.Event()
        self._thread = None
        self._rng = random.Random()

    # ---------------------------------------------------------- NodeSet

    def open(self):
        self._thread = threading.Thread(target=self._probe_loop,
                                        daemon=True, name="membership")
        self._thread.start()
        return self

    def close(self):
        self._closing.set()

    def nodes(self):
        """Live members (ref: GossipNodeSet.Nodes gossip.go:44-51)."""
        with self._mu:
            return [n for n in self.cluster.nodes if n.host not in self._down]

    def is_down(self, host):
        with self._mu:
            return host in self._down

    # ---------------------------------------------------------- probing

    def _peers(self):
        return [n for n in self.cluster.nodes if n.host != self.local_host]

    def _next_subset(self):
        peers = self._peers()
        by_host = {n.host: n for n in peers}
        with self._mu:
            self._cycle = [h for h in self._cycle if h in by_host]
            picked = []
            while len(picked) < min(self.probe_subset, len(by_host)):
                if not self._cycle:
                    hosts = list(by_host)
                    self._rng.shuffle(hosts)
                    self._cycle = hosts
                h = self._cycle.pop()
                if h not in picked:
                    picked.append(h)
            down = [h for h in self._down if h in by_host and h not in picked]
        return [by_host[h] for h in dict.fromkeys(picked + down)]

    def probe_once(self):
        for node in self._next_subset():
            self._probe_node(node)

    def _probe_node(self, node):
        if not self._probe(node):
            with self._mu:
                n = self._failures.get(node.host, 0) + 1
                self._failures[node.host] = n
                suspect = (n >= self.suspect_after
                           and node.host not in self._down)
            if suspect:
                if self._indirect_probe(node):
                    with self._mu:
                        self._failures[node.host] = 0
                    return
                with self._mu:
                    self._down.add(node.host)
            return
        with self._mu:
            was_down = node.host in self._down
            self._failures[node.host] = 0
            self._down.discard(node.host)
        if was_down and self.on_rejoin:
            try:
                self.on_rejoin(node)
            except Exception:  # noqa: BLE001 — reconciliation is best-effort
                logger.warning("rejoin of %s: reconciliation failed",
                               node.host, exc_info=True)

    def _indirect_probe(self, target):
        helpers = [n for n in self.nodes()
                   if n.host not in (self.local_host, target.host)]
        self._rng.shuffle(helpers)
        for helper in helpers[: self.indirect_n]:
            try:
                if self.client.indirect_probe(helper, target):
                    return True
            except Exception:  # noqa: BLE001 — the helper may be sick
                continue
        return False

    def _probe(self, node):
        if self.status_fn is None:
            return self.client.probe(node, timeout=self.interval)
        status = self.status_fn()
        if (status.get("schemaDigest")
                and self._peer_digests.get(node.host)
                == status.get("schemaDigest")):
            status = {k: v for k, v in status.items() if k != "schema"}
        try:
            peer = self.client.heartbeat(node, status, timeout=self.interval)
        except Exception:  # noqa: BLE001 — transport down
            return False
        if peer.get("schemaDigest"):
            self._peer_digests[node.host] = peer["schemaDigest"]
        if peer and self.merge_fn is not None:
            try:
                self.merge_fn(peer)
            except Exception:  # noqa: BLE001 — liveness stands
                logger.warning("heartbeat merge from %s failed", node.host,
                               exc_info=True)
        return True

    def _probe_loop(self):
        while not self._closing.wait(self.interval):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — detection outlives a round
                logger.warning("membership probe round failed",
                               exc_info=True)
