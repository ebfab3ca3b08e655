"""Cluster topology and deterministic slice placement (ref: cluster.go;
counterpart of pilosa_tpu/cluster/cluster.py).

Placement is two-level, as in the reference: slice → partition by
fnv64a(index || bigendian(slice)) % 256, partition → node by jump
consistent hash over the configured node list, replicas = the successor
nodes around that list (cluster.go:224-307). ``ModHasher`` and
``ConstHasher`` are the reference's test hashers (test/cluster.go:24-55).

Placement is static: the node list comes from configuration and never
reorders, so ownership is a pure function of (index, slice, node count,
replica count), memoized per (index, slice).
"""
import threading

DEFAULT_PARTITION_N = 256   # ref: cluster.go:32-38
DEFAULT_REPLICA_N = 1

NODE_STATE_UP = "UP"
NODE_STATE_DOWN = "DOWN"


def fnv64a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class JmpHasher:
    """Jump consistent hash (ref: cluster.go:288-307)."""

    def hash(self, key, n):
        b, j = -1, 0
        key &= 0xFFFFFFFFFFFFFFFF
        while j < n:
            b = j
            key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
            j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
        return b


class ModHasher:
    """key % n — deterministic test placement (ref: test/cluster.go)."""

    def hash(self, key, n):
        return key % n


class ConstHasher:
    def __init__(self, i=0):
        self.i = i

    def hash(self, key, n):
        return self.i


class Node:
    """(ref: cluster.go:46-86)."""

    def __init__(self, host, scheme="http"):
        self.host = host
        self.scheme = scheme

    def uri(self):
        return f"{self.scheme}://{self.host}"

    def __repr__(self):
        return f"Node({self.host})"

    def __eq__(self, other):
        return isinstance(other, Node) and self.host == other.host

    def __hash__(self):
        return hash(self.host)


class Cluster:
    def __init__(self, nodes=None, hasher=None,
                 partition_n=DEFAULT_PARTITION_N, replica_n=DEFAULT_REPLICA_N):
        self.nodes = nodes or []
        self.hasher = hasher or JmpHasher()
        self.partition_n = partition_n
        self.replica_n = replica_n
        self.node_set = None  # membership: StaticNodeSet or HTTPNodeSet
        # Bumped by every change of the node list or of a node's host
        # (a ':0' bind resolved at open); ownership memos key on it.
        self.topology_version = 0
        self._frag_cache = {}
        self._frag_cache_state = None
        self._frag_cache_mu = threading.Lock()

    def node_by_host(self, host):
        for n in self.nodes:
            if n.host == host:
                return n
        return None

    def partition(self, index, slice_num):
        """(ref: cluster.go:224-238)."""
        buf = index.encode() + slice_num.to_bytes(8, "big")
        return fnv64a(buf) % self.partition_n

    def partition_nodes(self, partition_id):
        """Primary + ReplicaN-1 successors (ref: cluster.go:250-271)."""
        if not self.nodes:
            return []
        replica_n = min(self.replica_n, len(self.nodes)) or 1
        start = self.hasher.hash(partition_id, len(self.nodes))
        return [self.nodes[(start + i) % len(self.nodes)]
                for i in range(replica_n)]

    def topology_state(self):
        """What every ownership memo keys on."""
        return (self.topology_version, len(self.nodes), self.replica_n)

    def fragment_nodes(self, index, slice_num):
        """The slice's owners, primary first, as a tuple (memoized: the
        hash costs ~9 µs and a fan-out asks for every slice of the
        index)."""
        state = self.topology_state()
        key = (index, slice_num)
        with self._frag_cache_mu:
            if state != self._frag_cache_state:
                self._frag_cache = {}
                self._frag_cache_state = state
            hit = self._frag_cache.get(key)
        if hit is None:
            hit = tuple(self.partition_nodes(self.partition(index,
                                                            slice_num)))
            with self._frag_cache_mu:
                if state == self._frag_cache_state:
                    self._frag_cache[key] = hit
        return hit

    def owns_fragment(self, host, index, slice_num):
        return any(n.host == host
                   for n in self.fragment_nodes(index, slice_num))

    def owns_slices(self, index, max_slice, host):
        """Primary-owned slices (ref: cluster.go:274-287)."""
        out = []
        for s in range(max_slice + 1):
            owners = self.fragment_nodes(index, s)
            if owners and owners[0].host == host:
                out.append(s)
        return out

    def healthy_nodes(self, nodes=None, keep_host=None):
        """``nodes`` less the peers a breaker tier refuses; with no
        breaker tier (this package has none yet) every node is healthy,
        as in the reference when QoS is off."""
        return self.nodes if nodes is None else nodes

    def node_states(self):
        """UP/DOWN per host from membership (ref: cluster.go:180-200)."""
        states = {n.host: NODE_STATE_DOWN for n in self.nodes}
        members = self.node_set.nodes() if self.node_set else self.nodes
        for m in members:
            if m.host in states:
                states[m.host] = NODE_STATE_UP
        return states

    def status(self):
        return {"nodes": [{"host": n.host, "scheme": n.scheme}
                          for n in self.nodes]}


def new_test_cluster(n):
    """Fake topology with deterministic placement (ref: test/cluster.go)."""
    return Cluster(nodes=[Node(f"host{i}") for i in range(n)],
                   hasher=ModHasher())
