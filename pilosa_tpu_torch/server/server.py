"""Server assembly of one node: holder, executor, handler and the HTTP
listener, and on a cluster the internal client, the broadcaster and
heartbeat membership (ref: server.go:55-234; counterpart of
pilosa_tpu/server/server.py).

``Server(data_dir).open()`` opens the data directory on the GPU and
serves Pilosa's public HTTP API on a thread; ``close()`` stops the
listener, then closes the holder, which releases the directory's lock.
It runs on the CPU only when the caller passes ``device="cpu"``.
``host_bytes`` bounds the host memory of resident fragments (the
holder's governor; None reads ``PILOSA_TPU_HOST_BYTES``, unset is
unbounded). ``stack_bytes`` bounds the executor's device stack cache
(None reads ``PILOSA_TPU_STACK_BYTES``; several nodes on one card each
take a share of its memory).

``ingest`` is the ``[ingest]`` table (ref: pilosa_tpu server.py:470-495):
``enabled`` (default on; ``PILOSA_INGEST_ENABLED``) and
``max-batch-bits`` (default 8,000,000; ``PILOSA_INGEST_MAX_BATCH_BITS``).
Disabled, ``POST /index/{i}/ingest`` answers 501.

A static cluster: ``cluster_hosts`` lists every node's ``host:port``,
this node's bind among them, in the same order on every node;
``replica_n`` owners hold each slice. Queries fan out from whichever
node receives them, writes go to every owner, schema DDL is broadcast,
and membership probes a subset of peers every 5 seconds (a DOWN peer
is hinted the writes it misses, pushed the schema and replayed them on
rejoin). ``polling_interval`` seconds (0: never) between polls of the
peers' max slices, the backstop of the create-slice messages.

On a cluster the warm tiers (result memos, response cache) validate on
the cluster's epoch vector (``ClusterEpochs``, cluster/epochs.py): every
response and heartbeat carries the node's counters, and a peer observed
longer than ``epoch_probe_ttl`` seconds ago is probed before a replay
(None reads ``PILOSA_EPOCH_PROBE_TTL``, unset is the heartbeat
interval): a write this node did not relay shows in its caches within
that bound. Bulk ingest and keyed imports through any node land on
every owner of each slice.

Tracing (``tracing.py``) is off by default: ``trace_enabled`` (None
reads ``PILOSA_TRACE_ENABLED``) keeps the recent and slow traces, read
at ``GET /debug/traces``; ``trace_slow_threshold`` seconds (None reads
``PILOSA_TRACE_SLOW_THRESHOLD``, unset is 0.25), ``trace_ring_size``
and ``trace_slow_ring_size`` size it (ref: pilosa_tpu
server.py:64-93). With it off, ``?profile=true`` still traces the one
request.
"""
import logging
import os
import threading

from pilosa_tpu_torch import tracing
from pilosa_tpu_torch.cluster.broadcast import HTTPBroadcaster
from pilosa_tpu_torch.cluster import epochs as epochs_mod
from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.cluster import Cluster, Node
from pilosa_tpu_torch.cluster.membership import HTTPNodeSet
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ingest.pipeline import (
    DEFAULT_MAX_BATCH_BITS,
    IngestPipeline,
)
from pilosa_tpu_torch.server.handler import (
    DEFAULT_MAX_BODY_SIZE,
    Handler,
    make_http_server,
)
from pilosa_tpu_torch.storage.holder import Holder

DEFAULT_POLLING_INTERVAL = 60   # max-slice poll (ref: server.go:321)

_LOG = logging.getLogger(__name__)


class Server:
    def __init__(self, data_dir, bind="localhost:10101", device="cuda",
                 max_body_size=DEFAULT_MAX_BODY_SIZE, host_bytes=None,
                 ingest=None, cluster_hosts=None, replica_n=1,
                 polling_interval=DEFAULT_POLLING_INTERVAL,
                 stack_bytes=None, epoch_probe_ttl=None,
                 trace_enabled=None, trace_ring_size=None,
                 trace_slow_threshold=None, trace_slow_ring_size=None):
        self.data_dir = data_dir
        self.bind = bind
        self.host = bind  # host:port once open; the bound port for port 0
        self.scheme = "http"
        self.max_body_size = max_body_size
        self.stack_bytes = stack_bytes
        self.polling_interval = polling_interval
        # Raises without a GPU unless device="cpu".
        self.holder = Holder(data_dir, device=device,
                             host_bytes=host_bytes or None)
        self.cluster = self.client = self.broadcaster = None
        self.epochs = None
        hosts = list(cluster_hosts or [])
        if len(hosts) > 1:
            self.cluster = Cluster(nodes=[Node(h) for h in hosts],
                                   replica_n=replica_n)
            self.client = InternalClient()
            self.cluster.node_set = HTTPNodeSet(
                self.cluster, bind, InternalClient(timeout=5),
                on_rejoin=self._on_peer_rejoin,
                status_fn=self._heartbeat_status,
                merge_fn=self._merge_peer_status)
            self.broadcaster = HTTPBroadcaster(self.client, self.cluster,
                                               bind)
            self.holder.broadcaster = self.broadcaster
            self.epochs = epochs_mod.ClusterEpochs(
                bind, self.holder, cluster=self.cluster, client=self.client,
                ttl=_probe_ttl(epoch_probe_ttl,
                               self.cluster.node_set.interval))
            # Every internal response's header reaches the registry: a
            # relayed write's answer carries the owner's moved counter.
            self.client.epochs = self.epochs
        self.ingest = _ingest_pipeline(self.holder, ingest, self.cluster,
                                       self.client)
        self.tracer = _tracer(trace_enabled, trace_ring_size,
                              trace_slow_threshold, trace_slow_ring_size)
        self.executor = None
        self.handler = None
        self._httpd = None
        self._thread = None
        self._closing = threading.Event()
        self._monitor = None

    def open(self):
        self.holder.open()
        try:
            self.executor = Executor(self.holder, cluster=self.cluster,
                                     client=self.client,
                                     stack_bytes=self.stack_bytes)
            self.executor.epochs = self.epochs
            self.handler = Handler(self.holder, self.executor,
                                   ingest=self.ingest, cluster=self.cluster,
                                   broadcaster=self.broadcaster,
                                   epochs=self.epochs, tracer=self.tracer)
            self.handler.enable_response_cache()
            self._httpd = make_http_server(self.handler, self.bind,
                                           self.max_body_size)
        except BaseException:
            self.holder.close()
            raise
        port = self._httpd.server_address[1]
        self.host = f"{self.bind.rsplit(':', 1)[0]}:{port}"
        self.handler.local_host = self.host
        self.executor.host = self.host
        if self.cluster is not None:
            # Our own entry names the bound port (a ':0' bind).
            node = self.cluster.node_by_host(self.bind)
            if node is not None:
                node.host = self.host
                self.cluster.topology_version += 1
            self.broadcaster.local_host = self.host
            self.cluster.node_set.local_host = self.host
            self.epochs.local_host = self.host
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="http-serve")
        self._thread.start()
        if self.cluster is not None:
            self.cluster.node_set.open()
            if self.polling_interval:
                self._monitor = threading.Thread(
                    target=self._poll_loop, daemon=True,
                    name="max-slices")
                self._monitor.start()
        return self

    def close(self):
        self._closing.set()
        if self.cluster is not None:
            self.cluster.node_set.close()
            self.broadcaster.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join()
            self._httpd = None
        if self.executor is not None:
            self.executor.close()
        if self.ingest is not None:
            self.ingest.close()
        if self.epochs is not None:
            self.epochs.close()
        if self.client is not None:
            self.client.close()
            self.cluster.node_set.client.close()
        self.holder.close()

    # ------------------------------------------------------------ cluster

    def _heartbeat_status(self):
        """The compact status a membership probe carries, with this
        node's epoch counters (ref: pilosa_tpu server.py:839)."""
        st = self.holder.node_status_compact(self.host)
        st["epochs"] = epochs_mod.local_epochs(self.holder)
        return st

    def _merge_peer_status(self, st):
        """A heartbeat reply: its epochs first, so that a schema merge's
        failure never loses them, then the holder's create-only merge
        (ref: pilosa_tpu server.py:849-860)."""
        if isinstance(st.get("epochs"), dict) and st.get("host"):
            self.epochs.observe(st["host"], st["epochs"])
        self.holder.merge_remote_status(st)

    def _on_peer_rejoin(self, node):
        """A peer membership saw again: push it the schema (with
        options and fields), then replay the writes it missed (the
        reference's gossip state merge, and hinted handoff)."""
        self.client.post_schema(node, self.holder.schema(include_meta=True))
        self.executor.replay_hints(node, self.client)

    def _poll_loop(self):
        while not self._closing.wait(self.polling_interval):
            try:
                self._monitor_max_slices()
            except Exception:  # noqa: BLE001 — the monitor must not die
                _LOG.warning("max-slice poll failed", exc_info=True)

    def _monitor_max_slices(self):
        """Poll peers' max slices (ref: monitorMaxSlices
        server.go:321-357); a peer that does not answer is skipped."""
        from pilosa_tpu_torch.cluster.client import ClientError

        for node in self.cluster.nodes:
            if node.host == self.host:
                continue
            try:
                for inverse in (False, True):
                    for index, n in self.client.max_slices(
                            node, inverse=inverse).items():
                        idx = self.holder.index(index)
                        if idx is None:
                            continue
                        if inverse:
                            idx.set_remote_max_inverse_slice(n)
                        else:
                            idx.set_remote_max_slice(n)
            except ClientError:
                continue


def _probe_ttl(ttl, heartbeat_interval):
    """The epoch probe ttl: the argument, else PILOSA_EPOCH_PROBE_TTL,
    else the heartbeat interval (0 or unparseable: the default)."""
    if ttl is None:
        try:
            ttl = float(os.environ.get("PILOSA_EPOCH_PROBE_TTL") or 0)
        except ValueError:
            ttl = 0
    return float(ttl or heartbeat_interval or epochs_mod.DEFAULT_PROBE_TTL)


def _tracer(enabled, ring_size, slow_threshold, slow_ring_size):
    """The node's Tracer, or tracing.NOP when tracing is off; None
    arguments read PILOSA_TRACE_ENABLED and PILOSA_TRACE_SLOW_THRESHOLD
    (an unparseable threshold keeps the default)."""
    if enabled is None:
        enabled = os.environ.get("PILOSA_TRACE_ENABLED", "").lower() in (
            "1", "true", "yes")
    if not enabled:
        return tracing.NOP
    if slow_threshold is None:
        slow_threshold = tracing.DEFAULT_SLOW_THRESHOLD
        env = os.environ.get("PILOSA_TRACE_SLOW_THRESHOLD")
        if env:
            try:
                slow_threshold = float(env)
            except ValueError:
                pass
    return tracing.Tracer(
        ring_size=ring_size or tracing.DEFAULT_RING_SIZE,
        slow_threshold=slow_threshold,
        slow_ring_size=slow_ring_size or tracing.DEFAULT_SLOW_RING_SIZE)


def _ingest_pipeline(holder, cfg, cluster=None, client=None):
    """The IngestPipeline the ``[ingest]`` table and its environment
    variables ask for, or None when disabled; on a cluster it fans each
    batch out to the owners of its slices."""
    cfg = {k.replace("_", "-"): v for k, v in (cfg or {}).items()}
    enabled = cfg.get("enabled")
    if enabled is None:
        env = os.environ.get("PILOSA_INGEST_ENABLED")
        enabled = env.lower() in ("1", "true", "yes") if env else True
    if not enabled:
        return None
    max_bits = cfg.get("max-batch-bits")
    if max_bits is None:
        env = os.environ.get("PILOSA_INGEST_MAX_BATCH_BITS")
        if env:
            try:
                max_bits = int(env)
            except ValueError:
                pass
    return IngestPipeline(holder, cluster=cluster, client=client,
                          max_batch_bits=max_bits or DEFAULT_MAX_BATCH_BITS)
