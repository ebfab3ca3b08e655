"""Internal HTTP client — the node-to-node query plane and the calls the
CLI makes (ref: client.go; counterpart of the part of
pilosa_tpu/cluster/client.py ``InternalClient`` that the static cluster
and the CLI use).

A node is a ``cluster.Node``, ``host:port`` or an ``http://host:port``
URL. Keep-alive connections are pooled per node (TCP_NODELAY: the
internal plane is request/response ping-pong); a pooled connection the
peer closed between two requests is replaced once. A timeout never
retries — the peer may still be executing the request — and raises
``ClientError`` with ``timed_out`` set, as every transport failure
raises ``ClientError``.
"""
import http.client
import json
import socket
import threading
import urllib.parse

from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch import querystats
from pilosa_tpu_torch.ingest import codec as ingest_codec
from pilosa_tpu_torch.server import wireproto
from pilosa_tpu_torch.utils import fanpool


class ClientError(Exception):
    """``status`` is the HTTP status when one was received; ``timed_out``
    marks a socket timeout."""

    def __init__(self, msg, status=None, timed_out=False):
        super().__init__(msg)
        self.status = status
        self.timed_out = timed_out


def _netloc(node):
    """``host:port`` of a Node, ``host:port`` or an ``http://`` URL."""
    if hasattr(node, "host"):
        scheme, loc = getattr(node, "scheme", "http"), node.host
    else:
        u = urllib.parse.urlsplit(node if "://" in node else f"http://{node}")
        scheme, loc = u.scheme, u.netloc
    if scheme != "http":
        raise ValueError(f"unsupported scheme: {scheme}")
    return loc


def _path(path, **params):
    qs = urllib.parse.urlencode(
        {k: v for k, v in params.items() if v is not None})
    return path + (f"?{qs}" if qs else "")


class InternalClient:
    # Idle connections kept per node: the replica fan-out plus the
    # membership probes, without hoarding descriptors.
    POOL_PER_HOST = 8

    def __init__(self, timeout=30):
        self.timeout = timeout
        # The node's ClusterEpochs, set by the server on a cluster.
        self.epochs = None
        self._mu = threading.Lock()
        self._conns = {}  # netloc -> [idle HTTPConnection]
        self._fan_pool = None  # owners' parallel posts, lazily

    def close(self):
        with self._mu:
            pools, self._conns = list(self._conns.values()), {}
            fan_pool, self._fan_pool = self._fan_pool, None
        for idle in pools:
            for c in idle:
                c.close()
        if fan_pool is not None:
            fan_pool.close()

    def _checkout(self, netloc, timeout, fresh):
        """A pooled connection to ``netloc``, or a new one; ``fresh``
        (the retry after a stale keep-alive) drops the node's idle list,
        every connection of which a restarted peer closed."""
        with self._mu:
            idle = self._conns.get(netloc)
            if fresh:
                stale, self._conns[netloc] = idle or [], []
                conn = None
            else:
                stale = []
                conn = idle.pop() if idle else None
        for c in stale:
            c.close()
        if conn is None:
            return http.client.HTTPConnection(netloc, timeout=timeout)
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def _checkin(self, netloc, conn):
        with self._mu:
            idle = self._conns.setdefault(netloc, [])
            if len(idle) < self.POOL_PER_HOST:
                idle.append(conn)
                return
        conn.close()

    def _do(self, method, node, path, body=None,
            content_type="application/json", accept=None, timeout=None,
            extra_headers=None, headers_out=None):
        """-> (status, body bytes, content type); ``headers_out``, a
        dict, receives the response's headers."""
        netloc = _netloc(node)
        headers = {"Content-Type": content_type} if body is not None else {}
        if accept:
            headers["Accept"] = accept
        if extra_headers:
            headers.update(extra_headers)
        t = timeout or self.timeout
        for attempt in (0, 1):
            conn = self._checkout(netloc, t, fresh=attempt > 0)
            reused = conn.sock is not None
            try:
                if not reused:
                    conn.connect()
                    conn.sock.setsockopt(socket.IPPROTO_TCP,
                                         socket.TCP_NODELAY, 1)
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except socket.timeout as e:
                conn.close()
                raise ClientError(f"{method} {netloc}{path}: {e}",
                                  timed_out=True) from e
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                if reused and attempt == 0:
                    continue  # stale keep-alive: once more, fresh
                raise ClientError(f"{method} {netloc}{path}: {e}") from e
            except BaseException:
                conn.close()
                raise
            if resp.will_close:
                conn.close()
            else:
                self._checkin(netloc, conn)
            ep = self.epochs
            if ep is not None:
                hv = resp.getheader(ep.HEADER)
                if hv:
                    ep.observe_header(hv)
            if headers_out is not None:
                headers_out.update(resp.getheaders())
            return resp.status, data, resp.getheader("Content-Type", "")

    def _json(self, method, node, path, payload=None, timeout=None):
        body = json.dumps(payload).encode() if payload is not None else None
        status, data, _ = self._do(method, node, path, body, timeout=timeout)
        if status >= 400:
            raise ClientError(f"{method} {path}: {status}: {data!r}",
                              status=status)
        return json.loads(data) if data else {}

    # ------------------------------------------------------------ queries

    def execute_query(self, node, index, query, slices=None, remote=False,
                      exclude_attrs=False, exclude_bits=False, timeout=None,
                      trace_headers=None):
        """POST /index/{i}/query as a protobuf QueryRequest (ref:
        client.go:227-276) -> the decoded results: ints, bools, pairs,
        ``SumCount``s, None, and ``{"bits", "attrs"}`` dicts for bitmaps.
        A query error the peer reports raises ClientError.
        ``trace_headers`` (``tracing.trace_headers()``) puts the peer's
        spans under the caller's trace; with a ``QueryStats`` active on
        this thread the peer is asked for its counts, which merge into
        it, and the call counts as a ``fanoutCall`` (ref: pilosa_tpu
        client.py:386-459)."""
        body = wireproto.encode_query_request(
            str(query), slices=slices, remote=remote,
            exclude_attrs=exclude_attrs, exclude_bits=exclude_bits)
        path = f"/index/{index}/query"
        extra = dict(trace_headers) if trace_headers else {}
        qstats_acc = querystats.active()
        if qstats_acc is not None:
            extra[querystats.COLLECT_HEADER] = "1"
        got = {} if qstats_acc is not None else None
        status, data, ctype = self._do(
            "POST", node, path, body, content_type=wireproto.CONTENT_TYPE,
            accept=wireproto.CONTENT_TYPE, timeout=timeout,
            extra_headers=extra, headers_out=got)
        if ctype != wireproto.CONTENT_TYPE:
            raise ClientError(f"POST {path}: {status}: {data[:200]!r}",
                              status=status)
        resp = wireproto.decode_query_response(data)
        if qstats_acc is not None:
            qstats_acc.add("fanoutCalls", 1)
            qstats_acc.merge(querystats.decode(
                got.get(querystats.STATS_HEADER)))
        if resp["error"]:
            raise ClientError(resp["error"], status=status)
        if status >= 400:
            raise ClientError(f"POST {path}: {status}", status=status)
        return resp["results"]

    # ---------------------------------------------------------------- DDL

    def ensure_index(self, node, index, opts=None):
        status, data, _ = self._do(
            "POST", node, f"/index/{index}",
            json.dumps({"options": opts or {}}).encode())
        if status >= 400 and status != 409:
            raise ClientError(f"POST /index/{index}: {status}: {data!r}",
                              status=status)

    def ensure_frame(self, node, index, frame, opts=None):
        path = f"/index/{index}/frame/{frame}"
        status, data, _ = self._do(
            "POST", node, path, json.dumps({"options": opts or {}}).encode())
        if status >= 400 and status != 409:
            raise ClientError(f"POST {path}: {status}: {data!r}",
                              status=status)

    def ensure_field(self, node, index, frame, field, min_val=0, max_val=0):
        """Create an int field; one that exists already is no error."""
        path = f"/index/{index}/frame/{frame}/field/{field}"
        status, data, _ = self._do("POST", node, path, json.dumps(
            {"type": "int", "min": min_val, "max": max_val}).encode())
        if status >= 400 and str(perr.ErrFieldExists()).encode() not in data:
            raise ClientError(f"POST {path}: {status}: {data!r}",
                              status=status)

    def post_schema(self, node, indexes):
        """Merge ``indexes`` (``Holder.schema(include_meta=True)``) into
        the node's schema: the rejoin push."""
        self._json("POST", node, "/schema", {"indexes": indexes})

    # ------------------------------------------------------------- import

    def _post_pb(self, node, path, body,
                 content_type=wireproto.CONTENT_TYPE):
        status, data, _ = self._do("POST", node, path, body, content_type)
        if status >= 400:
            raise ClientError(f"POST {path}: {status}: {data!r}",
                              status=status)

    @staticmethod
    def _slice_owners(cluster, index, slice_num):
        """A Cluster's owners of the slice, or a single node as given."""
        if hasattr(cluster, "fragment_nodes"):
            return cluster.fragment_nodes(index, slice_num)
        return [cluster]

    def _post_owners(self, owners, path, body,
                     content_type=wireproto.CONTENT_TYPE):
        """POST ``body`` to every owner at once; wait for all, then
        raise the first failure in owner order (ref: pilosa_tpu
        client.py:615-661): owners that can take the write do."""
        owners = list(owners)
        if len(owners) <= 1:
            for node in owners:
                self._post_pb(node, path, body, content_type)
            return
        with self._mu:
            if self._fan_pool is None:
                self._fan_pool = fanpool.FanoutPool(max_idle=8)
            pool = self._fan_pool
        fanpool.run_all(pool, [
            lambda n=n: self._post_pb(n, path, body, content_type)
            for n in owners])

    def import_bits(self, cluster, index, frame, slice_num, row_ids,
                    column_ids, timestamps=None):
        """One slice's bits as a protobuf ImportRequest to every owner
        of the slice (``cluster`` a Cluster; a single node takes it
        alone); ``timestamps`` in epoch seconds, 0 for none."""
        self._post_owners(
            self._slice_owners(cluster, index, slice_num), "/import",
            wireproto.encode_import_request(
                index, frame, slice_num, row_ids, column_ids, timestamps))

    def import_k(self, node, index, frame, row_keys, column_keys,
                 timestamps=None):
        """Keyed import: string keys, translated by the server (ref:
        ImportK client.go:307-330); one request to one node, since a
        key's slice is unknown before its translation."""
        self._post_pb(node, "/import", wireproto.encode_import_request(
            index, frame, 0, [], [], timestamps, row_keys=row_keys,
            column_keys=column_keys))

    def import_values(self, cluster, index, frame, slice_num, field,
                      column_ids, values):
        """One slice's values to every owner, as ``import_bits``."""
        self._post_owners(
            self._slice_owners(cluster, index, slice_num), "/import-value",
            wireproto.encode_import_value_request(
                index, frame, slice_num, field, column_ids, values))

    def ingest_slice(self, cluster, index, frame, slice_num, rows, columns,
                     timestamps=None):
        """One slice's bulk-ingest leg, the binary columnar frame, to
        every owner of the slice (ref: pilosa_tpu client.py:681-697)."""
        self._post_owners(
            self._slice_owners(cluster, index, slice_num),
            f"/index/{index}/ingest?slice={slice_num}",
            ingest_codec.encode_bits(frame, rows, columns, timestamps),
            content_type=ingest_codec.CONTENT_TYPE)

    # -------------------------------------------------------------- reads

    def max_slices(self, node, inverse=False):
        """{index: max slice} of the standard (or inverse) views."""
        return {k: int(v) for k, v in self._json(
            "GET", node, _path("/slices/max",
                               inverse="true" if inverse else None)
        )["maxSlices"].items()}

    def fragment_nodes(self, node, index, slice_num):
        """[{host, scheme}] of the slice's owners, primary first."""
        return self._json("GET", node, _path("/fragment/nodes", index=index,
                                             slice=slice_num))

    def hosts(self, node):
        """[{host, ...}] of the node's cluster (itself when alone)."""
        return self._json("GET", node, "/hosts")

    def status(self, node):
        return self._json("GET", node, "/status")["status"]

    def export_csv(self, node, index, frame, view, slice_num):
        path = _path("/export", index=index, frame=frame, view=view,
                     slice=slice_num)
        status, data, _ = self._do("GET", node, path)
        if status >= 400:
            raise ClientError(f"GET {path}: {status}", status=status)
        return data.decode()

    # ------------------------------------------------ membership, messages

    def epochs_fetch(self, node, timeout=None):
        """The peer's mutation counters (GET /internal/epochs): the
        epoch registry's probe (ref: pilosa_tpu client.py:854-866)."""
        status, data, _ = self._do("GET", node, "/internal/epochs",
                                   timeout=timeout)
        if status >= 400:
            raise ClientError(f"GET /internal/epochs: {status}",
                              status=status)
        return json.loads(data)

    def probe(self, node, timeout=None):
        """True iff the node's /id answers 200; any failure is False."""
        try:
            return self._do("GET", node, "/id", timeout=timeout)[0] == 200
        except ClientError:
            return False

    def heartbeat(self, node, status, timeout=None):
        """POST our compact node status to /internal/heartbeat and return
        the peer's; raises ClientError on a transport failure or a
        non-200 answer."""
        return self._json("POST", node, "/internal/heartbeat", status,
                          timeout=timeout)

    def indirect_probe(self, helper, target, timeout=8):
        """Ask ``helper`` to probe ``target`` (the SWIM indirect ping)."""
        out = self._json("GET", helper, _path("/internal/probe",
                                              host=target.host),
                         timeout=timeout)
        return bool(out.get("ok"))

    def send_message(self, node, msg, timeout=None):
        """POST /cluster/message in the reference's envelope: one type
        byte and a protobuf body (ref: server.go:444-465,
        broadcast.go:139)."""
        status, data, _ = self._do(
            "POST", node, "/cluster/message",
            wireproto.encode_cluster_message(msg),
            content_type=wireproto.CONTENT_TYPE, timeout=timeout)
        if status >= 400:
            raise ClientError(f"POST /cluster/message: {status}: {data!r}",
                              status=status)
