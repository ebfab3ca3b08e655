"""HTTP API handler of one node (ref: handler.go:98-151 route table;
counterpart of pilosa_tpu/server/handler.py).

A regex route table over stdlib ``ThreadingHTTPServer``. JSON is the
primary representation; the query and import routes also speak the
reference's protobuf (``wireproto``) when the client sends
``application/x-protobuf``. For the same request over the same data
every route answers the status, content type and body bytes that
pilosa_tpu's handler answers; only ``/version`` and ``/id`` differ.

Every request is wrapped in panic recovery (ref: handler.go:157-194):
errors become JSON ``{"error": ...}`` bodies with their status.

``enable_response_cache()`` (the server calls it) replays the exact
bytes of an identical read query while its index's epoch stands
(``respcache.py``); it stays off when the executor's result memos are
off, and ``PILOSA_TPU_RESPONSE_CACHE=0`` turns it off alone.
``GET /debug/vars`` serves the coalescer's, the plan cache's, the
response cache's and the ingest pipeline's counters.

Writes: ``/import`` (by ids, or by string keys translated through the
frame's and the index's key stores), ``/import-value``, the bulk-ingest
route ``POST /index/{i}/ingest`` (binary columnar or JSON bodies through
``ingest/pipeline.py``; its body may exceed the request cap, up to a
2 GiB ceiling) and ``POST /index/{i}/input/{def}`` through a stored
input definition.

On a cluster (``cluster`` and ``broadcaster`` given): a query with
``remote`` set runs on this node's slices alone; schema DDL is sent to
every live peer; ``POST /cluster/message`` receives peers' DDL and
create-slice messages; ``POST /internal/heartbeat`` exchanges membership
status and ``GET /internal/probe`` probes a member for a peer;
``/status``, ``/hosts`` and ``/fragment/nodes`` describe the cluster,
and ``/import`` and ``/import-value`` refuse a slice this node does not
own (412). Every response carries this node's epoch counters
(``X-Pilosa-Epochs``, cluster/epochs.py), ``GET /internal/epochs`` is
the peers' probe and ``GET /debug/epochs`` shows the registry; the
response cache validates on the epoch vector over every node. Bulk
ingest through any node fans each slice out to its owners (a leg with
``?slice=`` installs here, 412 when this node does not own the slice);
a keyed import goes to the key authority, the lowest host, which
translates and imports each slice on its owners.
"""
import io
import json
import os
import re
import socket
import threading
import traceback
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from pilosa_tpu_torch import SLICE_WIDTH, __version__
from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch import querystats, tracing
from pilosa_tpu_torch.bitmap import Bitmap
from pilosa_tpu_torch.cluster import epochs as epochs_mod
from pilosa_tpu_torch.cluster.broadcast import NopBroadcaster
from pilosa_tpu_torch.executor import ExecOptions, SumCount
from pilosa_tpu_torch.ingest import codec as ingest_codec
from pilosa_tpu_torch.ingest.pipeline import IngestError
from pilosa_tpu_torch.pql.parser import ParseError
from pilosa_tpu_torch.server import wireproto
from pilosa_tpu_torch.server.respcache import ResponseCache
from pilosa_tpu_torch.storage.frame import Field, FrameOptions

# Request bodies above this many bytes are refused with 413 before any
# of their bytes is read (pilosa_tpu's config.DEFAULT_MAX_BODY_SIZE).
DEFAULT_MAX_BODY_SIZE = 8 << 20
# The bulk-ingest route's body cap instead: a ceiling far above any
# configured batch bound (max-batch-bits answers 413 first in practice).
INGEST_HARD_CAP = 2 << 30
_INGEST_PATH = re.compile(r"^/index/[^/]+/ingest$")

PROTOBUF = wireproto.CONTENT_TYPE


def result_to_json(result):
    """QueryResult encoding (ref: QueryResult tagged union,
    internal/public.proto:60-70 + handler.go JSON path)."""
    if isinstance(result, Bitmap):
        return {"attrs": result.attrs, "bits": result.columns().tolist()}
    if isinstance(result, SumCount):
        return {"sum": result.sum, "count": result.count}
    if isinstance(result, list):  # pairs
        return [{"id": rid, "count": cnt} for rid, cnt in result]
    return result  # bool / int / None


class HTTPError(Exception):
    def __init__(self, status, message):
        self.status = status
        self.message = message
        super().__init__(message)


def _json(status, doc):
    return status, "application/json", json.dumps(doc).encode()


_OK = (200, "application/json", b"{}")


class Handler:
    """Routing and endpoint logic, transport-independent:
    ``dispatch(method, path, query_params, body, headers)`` ->
    ``(status, content_type, payload)``."""

    def __init__(self, holder, executor, local_host=None,
                 version=__version__, ingest=None, cluster=None,
                 broadcaster=None, epochs=None, tracer=None):
        self.holder = holder
        self.executor = executor
        # The node's tracer (tracing.NOP: off; ?profile=true still
        # traces its own request).
        self.tracer = tracer or tracing.NOP
        self.local_host = local_host
        self.version = version
        self.cluster = cluster
        # The cluster's epoch-vector registry (None: one node).
        self.epochs = epochs
        self.broadcaster = broadcaster or NopBroadcaster()
        # The bulk-ingest pipeline; None: the ingest route answers 501.
        self.ingest = ingest
        self._resp_cache = None  # enable_response_cache
        idx, fr = r"^/index/(?P<index>[^/]+)", "/frame/(?P<frame>[^/]+)"
        self.routes = [(m, re.compile(p), fn) for m, p, fn in [
            ("POST", idx + r"/query$", self.post_query),
            ("GET", idx + r"/query$", self.method_not_allowed),
            ("GET", r"^/index$", self.get_schema),
            ("GET", r"^/schema$", self.get_schema),
            ("POST", r"^/schema$", self.post_schema),
            ("GET", r"^/status$", self.get_status),
            ("GET", r"^/debug/vars$", self.get_debug_vars),
            ("GET", r"^/debug/traces$", self.get_debug_traces),
            ("GET", r"^/version$", self.get_version),
            ("GET", r"^/hosts$", self.get_hosts),
            ("GET", r"^/id$", self.get_id),
            ("GET", r"^/slices/max$", self.get_slices_max),
            ("GET", idx + "$", self.get_index),
            ("POST", idx + "$", self.post_index),
            ("DELETE", idx + "$", self.delete_index),
            ("PATCH", idx + r"/time-quantum$",
             self.patch_index_time_quantum),
            ("POST", idx + fr + "$", self.post_frame),
            ("DELETE", idx + fr + "$", self.delete_frame),
            ("PATCH", idx + fr + r"/time-quantum$",
             self.patch_frame_time_quantum),
            ("POST", idx + fr + r"/field/(?P<field>[^/]+)$",
             self.post_field),
            ("DELETE", idx + fr + r"/field/(?P<field>[^/]+)$",
             self.delete_field),
            ("GET", idx + fr + r"/fields$", self.get_fields),
            ("POST", idx + fr + r"/views/(?P<view>[^/]+)$",
             self.post_view),
            ("GET", idx + fr + r"/views$", self.get_views),
            ("DELETE", idx + fr + r"/view/(?P<view>[^/]+)$",
             self.delete_view),
            ("POST", idx + r"/input-definition/(?P<def>[^/]+)$",
             self.post_input_definition),
            ("GET", idx + r"/input-definition/(?P<def>[^/]+)$",
             self.get_input_definition),
            ("DELETE", idx + r"/input-definition/(?P<def>[^/]+)$",
             self.delete_input_definition),
            ("POST", idx + r"/input/(?P<def>[^/]+)$", self.post_input),
            ("POST", idx + r"/ingest$", self.post_ingest),
            ("POST", r"^/import$", self.post_import),
            ("POST", r"^/import-value$", self.post_import_value),
            ("GET", r"^/export$", self.get_export),
            ("GET", r"^/fragment/nodes$", self.get_fragment_nodes),
            ("POST", r"^/recalculate-caches$",
             self.post_recalculate_caches),
            ("POST", r"^/cluster/message$", self.post_cluster_message),
            ("POST", r"^/internal/heartbeat$",
             self.post_internal_heartbeat),
            ("GET", r"^/internal/probe$", self.get_internal_probe),
            ("GET", r"^/internal/epochs$", self.get_internal_epochs),
            ("GET", r"^/debug/epochs$", self.get_debug_epochs),
        ]]

    def enable_response_cache(self):
        """Replay identical read queries' response bytes while their
        validity token stands (ref: pilosa_tpu handler.py:175-205):
        parse, execution and encoding are skipped. On one node the token
        is the index's mutation epoch, on a cluster the epoch vector over
        every node (``_cluster_epoch_token``). Off when the executor's
        result memos are off, under PILOSA_TPU_RESPONSE_CACHE=0, and on
        a cluster without an epoch registry."""
        if os.environ.get("PILOSA_TPU_RESPONSE_CACHE", "1").lower() in (
                "0", "false", "no"):
            return
        if self.epochs is not None:
            self._resp_cache = ResponseCache(self._cluster_epoch_token)
        elif not self._multi_node():
            self._resp_cache = ResponseCache(
                lambda path: self.executor._epoch(path.split("/", 3)[2]))

    def _cluster_epoch_token(self, path):
        """A cluster's replay token (ref: pilosa_tpu handler.py:206-228):
        the epoch vector over every node (a whole-index query reads
        slices of all of them), probed when stale, and the lengths of
        this node's slice universes, which heartbeats widen without an
        epoch move. None: cold."""
        index = path.split("/", 3)[2]
        tok = self.epochs.ensure_fresh(
            index, [n.host for n in self.cluster.nodes])
        if tok is None:
            return None
        idx = self.holder.index(index)
        if idx is None:
            return tok
        std, inv = self.executor.plans.slice_universe(index, idx)
        return (tok, len(std), len(inv))

    def dispatch(self, method, path, query_params, body, headers):
        """-> (status, content_type, payload bytes[, extra headers])."""
        cache = self._resp_cache
        key = epoch = None
        out = None
        if (cache is not None and not self.executor.memos_off()
                and not self.tracer.enabled
                and "profile" not in (query_params or ())
                and headers.get(querystats.COLLECT_HEADER) is None
                and cache.cacheable(method, path, body)):
            key = cache.make_key(path, query_params, body, headers)
            out = cache.get(key)
            if out is None:
                epoch = cache.pre_epoch(path)
        if out is None:
            out = self._dispatch_route(method, path, query_params, body,
                                       headers)
            if key is not None:
                cache.put(key, epoch, out)
        ep = self.epochs
        if ep is not None:
            # Read after the handler ran: a write's own answer carries
            # its moved counter to the node that relayed it.
            extra = dict(out[3]) if len(out) > 3 and out[3] else {}
            extra[ep.HEADER] = ep.header_value()
            out = out[:3] + (extra,)
        return out

    def _dispatch_route(self, method, path, query_params, body, headers):
        for m, pattern, fn in self.routes:
            if m != method:
                continue
            match = pattern.match(path)
            if match:
                try:
                    return fn(match.groupdict(), query_params, body, headers)
                except HTTPError as e:
                    return _json(e.status, {"error": e.message})
                except (perr.PilosaError, ParseError, ValueError) as e:
                    return _json(400, {"error": str(e)})
                except Exception as e:  # panic recovery (handler.go:157-194)
                    traceback.print_exc()
                    return _json(500, {"error": str(e)})
        return _json(404, {"error": "not found"})

    # ------------------------------------------------------------- query

    def post_query(self, params, qp, body, headers):
        """(ref: handlePostQuery handler.go:243-309; pilosa_tpu
        handler.py:675-765). With tracing on, ``?profile=true`` or the
        collect header, the serve runs under a root span, ``query``, or
        ``query.remote`` when it adopts an incoming X-Pilosa-Trace-Id/
        X-Pilosa-Span-Id pair (a coordinator's fan-out leg), and a
        ``QueryStats`` scope. The trace id rides back in
        X-Pilosa-Trace-Id; ``?profile=true`` inlines the span tree and
        the counts next to the results; the collect header gets the
        counts back in the X-Pilosa-Query-Stats header. A server with
        tracing off profiles a request on a one-trace tracer of its
        own, which keeps nothing."""
        tracer = self.tracer
        profile = qp.get("profile", ["false"])[0] == "true"
        collect = headers.get(querystats.COLLECT_HEADER) is not None
        if not (tracer.enabled or profile or collect):
            return self._post_query(params, qp, body, headers)
        if not tracer.enabled:
            tracer = tracing.Tracer(ring_size=1)
        trace_id = headers.get(tracing.TRACE_HEADER)
        parent_id = headers.get(tracing.SPAN_HEADER)
        root = tracer.start(
            "query.remote" if trace_id else "query",
            trace_id=trace_id, parent_id=parent_id,
            index=params["index"], host=self.local_host or "")
        qs = querystats.QueryStats()
        with root, querystats.scope(qs):
            resp = self._post_query(params, qp, body, headers)
        root.trace.resources = qs.to_dict()
        status, ctype, payload = resp[:3]
        if (profile and status == 200 and ctype == "application/json"
                and payload.startswith(b"{")):
            doc = json.loads(payload)
            doc["profile"] = root.trace.to_dict()
            payload = json.dumps(doc).encode()
        extra = {tracing.TRACE_HEADER: root.trace.trace_id}
        if collect:
            # This node's partial, which the coordinator merges.
            extra[querystats.STATS_HEADER] = querystats.encode(
                qs.to_dict())
        return status, ctype, payload, extra

    def _post_query(self, params, qp, body, headers):
        index = params["index"]
        ctype = headers.get("Content-Type", "")
        if ctype == PROTOBUF:
            try:
                req = wireproto.decode_query_request(body)
            except Exception:  # noqa: BLE001 — any undecodable body:
                # wrong wire types surface as AttributeError/TypeError,
                # truncation as IndexError, bad UTF-8 as ValueError
                # (ref: handler.go:252 "unmarshal body error" → 400).
                raise HTTPError(400, "unmarshal body error")
            q_string = req["query"]
            slices = req.get("slices") or None
            opt = ExecOptions(remote=req.get("remote", False),
                              exclude_attrs=req.get("exclude_attrs", False),
                              exclude_bits=req.get("exclude_bits", False))
        else:
            q_string = body.decode()
            slices = None
            sl = qp.get("slices")
            if sl:
                slices = [int(s) for s in sl[0].split(",") if s]
            opt = ExecOptions(
                remote=qp.get("remote", ["false"])[0] == "true",
                exclude_attrs=qp.get("excludeAttrs", ["false"])[0] == "true",
                exclude_bits=qp.get("excludeBits", ["false"])[0] == "true")
        if not q_string:
            raise HTTPError(400, "query required")
        proto = headers.get("Accept") == PROTOBUF or ctype == PROTOBUF
        try:
            results = self.executor.execute(index, q_string, slices=slices,
                                            opt=opt)
        except (perr.PilosaError, ValueError) as e:
            if proto:
                return (400, PROTOBUF,
                        wireproto.encode_query_response([], error=str(e)))
            return _json(400, {"error": str(e)})
        if proto:
            return 200, PROTOBUF, wireproto.encode_query_response(results)
        return _json(200, {"results": [result_to_json(r) for r in results]})

    def method_not_allowed(self, params, qp, body, headers):
        """(ref: methodNotAllowedHandler handler.go:147)."""
        return 405, "application/json", b""

    # ------------------------------------------------------ schema, node

    def get_schema(self, params, qp, body, headers):
        return _json(200, {"indexes": self.holder.schema()})

    def post_schema(self, params, qp, body, headers):
        """Merge a peer's schema, create-only (the rejoin push)."""
        schema = json.loads(body or b"{}")
        self.holder.apply_schema(schema.get("indexes", []))
        return _OK

    def get_status(self, params, qp, body, headers):
        """(ref: handler.go handleGetStatus): JSON with the cluster's
        nodes and their UP/DOWN states, or, asked for protobuf, the
        reference's NodeStatus bytes (private.proto:127-132)."""
        if "protobuf" in headers.get("Accept", ""):
            schema = self.holder.schema(include_meta=True)
            max_slices = self.holder.max_slices()
            for idx in schema:
                idx["maxSlice"] = max_slices.get(idx["name"], 0)
            me = (self.cluster.node_by_host(self.local_host)
                  if self.cluster and self.local_host else None)
            return 200, PROTOBUF, wireproto.encode_node_status({
                "host": self.local_host or "", "state": "NORMAL",
                "scheme": me.scheme if me is not None else "http",
                "indexes": schema})
        status = {"state": "NORMAL",
                  "nodes": self.cluster.status()["nodes"] if self.cluster
                  else [],
                  "indexes": self.holder.schema()}
        if self.cluster:
            states = self.cluster.node_states()
            status["nodeStates"] = states
            # The reference's wire shape: Go marshals ClusterStatus with
            # capitalized keys (docs/getting-started.md:37).
            status["Nodes"] = [{"Host": n.host,
                                "State": states.get(n.host, "UP")}
                               for n in self.cluster.nodes]
        return _json(200, {"status": status})

    def get_debug_vars(self, params, qp, body, headers):
        """The serving tiers' counters (ref: pilosa_tpu handler
        get_debug_vars: countCoalescer, remoteBatcher once a round went
        out, responseCache, epochs, ingest), with the plan cache's
        snapshot."""
        doc = {"countCoalescer": self.executor.coalesce_snapshot(),
               "planCache": self.executor.plans.snapshot(),
               "ingest": (self.ingest.snapshot() if self.ingest is not None
                          else {"enabled": False}),
               "epochs": (self.epochs.snapshot() if self.epochs is not None
                          else {"enabled": False})}
        rb = self.executor.remote_batch_snapshot()
        if rb["rounds"]:
            doc["remoteBatcher"] = rb
        if self._resp_cache is not None:
            doc["responseCache"] = self._resp_cache.stats()
        return _json(200, doc)

    def get_debug_traces(self, params, qp, body, headers):
        """Recent traces as span trees (ref: pilosa_tpu
        handler.py:2187-2205): ``?slow=true`` reads the slow-query ring,
        ``?traceId=`` filters (how a cluster trace is gathered for
        ``tracing.stitch``), ``?n=`` bounds the count (1-512)."""
        try:
            n = max(1, min(int(qp.get("n", ["32"])[0]), 512))
        except ValueError:
            raise HTTPError(400, "n must be an integer")
        slow = qp.get("slow", ["false"])[0] == "true"
        trace_id = qp.get("traceId", [None])[0]
        tr = self.tracer
        return _json(200, {
            "enabled": tr.enabled,
            "slowThresholdMs": round(tr.slow_threshold * 1000, 3),
            "summary": tr.summary(),
            "traces": tr.recent(n, slow=slow, trace_id=trace_id),
        })

    def get_version(self, params, qp, body, headers):
        return _json(200, {"version": self.version})

    def get_hosts(self, params, qp, body, headers):
        if self.cluster:
            return _json(200, self.cluster.status()["nodes"])
        return _json(200, [{"host": self.local_host or "localhost"}])

    def get_id(self, params, qp, body, headers):
        return 200, "text/plain", (self.holder.local_id or "").encode()

    def get_slices_max(self, params, qp, body, headers):
        if qp.get("inverse", ["false"])[0] == "true":
            m = self.holder.max_inverse_slices()
        else:
            m = self.holder.max_slices()
        return _json(200, {"maxSlices": m})

    def get_fragment_nodes(self, params, qp, body, headers):
        """(ref: handler.go:1366): the slice's owners, primary first."""
        if self.cluster:
            index = qp.get("index", [""])[0]
            slice_num = int(qp.get("slice", ["0"])[0])
            return _json(200, [{"host": n.host, "scheme": n.scheme}
                               for n in self.cluster.fragment_nodes(
                                   index, slice_num)])
        return _json(200, [{"host": self.local_host or "localhost",
                            "scheme": "http"}])

    def _multi_node(self):
        return self.cluster is not None and len(self.cluster.nodes) > 1

    def _check_slice_ownership(self, index, slice_num):
        """(ref: handler.go:1199-1203)."""
        if self.cluster and self.local_host and not \
                self.cluster.owns_fragment(self.local_host, index, slice_num):
            raise HTTPError(412, "host does not own slice")

    def _broadcast(self, msg):
        self.broadcaster.send_sync(msg)

    # ----------------------------------------------------------- indexes

    def _index(self, name):
        idx = self.holder.index(name)
        if idx is None:
            raise HTTPError(404, str(perr.ErrIndexNotFound()))
        return idx

    def get_index(self, params, qp, body, headers):
        idx = self._index(params["index"])
        return _json(200, {"index": {"name": idx.name,
                                     "columnLabel": idx.column_label,
                                     "timeQuantum": idx.time_quantum}})

    def post_index(self, params, qp, body, headers):
        opts = json.loads(body or b"{}").get("options", {})
        try:
            self.holder.create_index(
                params["index"],
                column_label=opts.get("columnLabel", ""),
                time_quantum=opts.get("timeQuantum", ""))
        except perr.ErrIndexExists as e:
            raise HTTPError(409, str(e))
        self._broadcast({"type": "create-index", "index": params["index"],
                         "options": opts})
        return _OK

    def delete_index(self, params, qp, body, headers):
        self.holder.delete_index(params["index"])
        self._broadcast({"type": "delete-index", "index": params["index"]})
        return _OK

    def patch_index_time_quantum(self, params, qp, body, headers):
        q = json.loads(body or b"{}").get("timeQuantum", "")
        self._index(params["index"]).set_time_quantum(q)
        return _OK

    # ------------------------------------------------------------ frames

    def _frame(self, index, frame):
        fr = self._index(index).frame(frame)
        if fr is None:
            raise HTTPError(404, str(perr.ErrFrameNotFound()))
        return fr

    def post_frame(self, params, qp, body, headers):
        opts = json.loads(body or b"{}").get("options", {})
        try:
            self._index(params["index"]).create_frame(
                params["frame"], FrameOptions.from_dict(opts))
        except perr.ErrFrameExists as e:
            raise HTTPError(409, str(e))
        self._broadcast({"type": "create-frame", "index": params["index"],
                         "frame": params["frame"], "options": opts})
        return _OK

    def delete_frame(self, params, qp, body, headers):
        self._index(params["index"]).delete_frame(params["frame"])
        self._broadcast({"type": "delete-frame", "index": params["index"],
                         "frame": params["frame"]})
        return _OK

    def patch_frame_time_quantum(self, params, qp, body, headers):
        q = json.loads(body or b"{}").get("timeQuantum", "")
        self._frame(params["index"], params["frame"]).set_time_quantum(q)
        return _OK

    def post_field(self, params, qp, body, headers):
        opts = json.loads(body or b"{}")
        field = Field(params["field"], opts.get("type", "int"),
                      opts.get("min", 0), opts.get("max", 0))
        self._frame(params["index"], params["frame"]).create_field(field)
        self._broadcast({"type": "create-field", "index": params["index"],
                         "frame": params["frame"], "field": field.to_dict()})
        return _OK

    def delete_field(self, params, qp, body, headers):
        self._frame(params["index"], params["frame"]).delete_field(
            params["field"])
        self._broadcast({"type": "delete-field", "index": params["index"],
                         "frame": params["frame"], "field": params["field"]})
        return _OK

    def get_fields(self, params, qp, body, headers):
        fr = self._frame(params["index"], params["frame"])
        return _json(200, {"fields": [f.to_dict() for f in fr.fields]})

    def post_view(self, params, qp, body, headers):
        self._frame(params["index"], params["frame"]) \
            .create_view_if_not_exists(params["view"])
        return _OK

    def get_views(self, params, qp, body, headers):
        fr = self._frame(params["index"], params["frame"])
        return _json(200, {"views": sorted(fr.views)})

    def delete_view(self, params, qp, body, headers):
        """(ref: handleDeleteView handler.go:127): a view that does not
        exist is no error."""
        fr = self._frame(params["index"], params["frame"])
        try:
            fr.delete_view(params["view"])
        except perr.ErrInvalidView:
            pass
        self._broadcast({"type": "delete-view", "index": params["index"],
                         "frame": params["frame"], "view": params["view"]})
        return _OK

    # ------------------------------------------------------------ import

    @staticmethod
    def _require(req, *keys):
        """A missing field of a request body is the caller's fault (400),
        not a handler bug (500)."""
        for key in keys:
            if key not in req:
                raise HTTPError(400, f"missing field: {key}")

    def post_import(self, params, qp, body, headers):
        """Bulk bit import (ref: handlePostImport handler.go:1164-1243).
        Body: protobuf ImportRequest or JSON {index, frame, slice,
        rowIDs, columnIDs, timestamps?}, or rowKeys and columnKeys in
        place of the ids; a timestamp of 0 is none."""
        if headers.get("Content-Type") == PROTOBUF:
            req = wireproto.decode_import_request(body)
        else:
            req = json.loads(body)
        self._require(req, "index", "frame")
        fr = self._frame(req["index"], req["frame"])
        timestamps = req.get("timestamps")
        ts = None
        if timestamps and any(timestamps):
            ts = [datetime.fromtimestamp(t) if t else None
                  for t in timestamps]
        if req.get("rowKeys") or req.get("columnKeys"):
            return self._post_import_keyed(req["index"], fr, req, ts, body,
                                           headers)
        self._check_slice_ownership(req["index"], int(req.get("slice", 0)))
        self._require(req, "rowIDs", "columnIDs")
        fr.import_bits(req["rowIDs"], req["columnIDs"], ts)
        return _OK

    def _post_import_keyed(self, index, fr, req, ts, body, headers):
        """Keyed import (ref: pilosa_tpu handler.py:1183-1275): row keys
        become ids in the frame's key store, column keys in the index's
        (dense ids from 0, allocated in first-seen order). One node
        imports them through ``Frame.import_bits``. On a cluster one node
        allocates, the key authority (the lowest host): another node
        passes the body on to it, and it imports each slice's bits on
        every owner of the slice."""
        row_keys = req.get("rowKeys") or []
        col_keys = req.get("columnKeys") or []
        if len(row_keys) != len(col_keys):
            raise HTTPError(400, "row/column key length mismatch")
        if ts is not None and len(ts) != len(row_keys):
            raise HTTPError(400, "timestamp length mismatch")
        client = self.executor.client
        if self._multi_node():
            if client is None:
                raise HTTPError(
                    500, "no internal client for multi-node keyed import")
            authority = min(self.cluster.nodes, key=lambda n: n.host)
            if authority.host != self.local_host:
                # pilosa_tpu (handler.py:1213-1240) also sends the QoS
                # priority and the remaining deadline along; this port
                # has no QoS tier yet.
                status, data, _ = client._do(
                    "POST", authority, "/import", body,
                    content_type=headers.get("Content-Type",
                                             "application/json"))
                return status, "application/json", data or b"{}"
        idx = self._index(index)
        row_ids = np.asarray(fr.row_key_store.translate(row_keys),
                             dtype=np.int64)
        col_ids = np.asarray(idx.column_key_store.translate(col_keys),
                             dtype=np.int64)
        if not self._multi_node():
            fr.import_bits(row_ids, col_ids, ts)
            return _OK
        slices = col_ids // SLICE_WIDTH
        order = np.argsort(slices, kind="stable")
        for g in np.split(order, np.flatnonzero(np.diff(slices[order])) + 1):
            if not len(g):
                continue
            gts = ([int(ts[i].timestamp()) if ts[i] else 0 for i in g]
                   if ts else None)
            client.import_bits(self.cluster, index, fr.name,
                               int(slices[g[0]]), row_ids[g].tolist(),
                               col_ids[g].tolist(), gts)
        return _OK

    def post_import_value(self, params, qp, body, headers):
        """(ref: handler.go:1244+). Body: {index, frame, field, slice,
        columnIDs, values}."""
        if headers.get("Content-Type") == PROTOBUF:
            req = wireproto.decode_import_value_request(body)
        else:
            req = json.loads(body)
        self._require(req, "index", "frame", "field", "columnIDs",
                      "values")
        self._check_slice_ownership(req["index"], int(req.get("slice", 0)))
        fr = self._frame(req["index"], req["frame"])
        fr.import_value(req["field"], req["columnIDs"], req["values"])
        return _OK

    # ------------------------------------------------------------ ingest

    def post_ingest(self, params, qp, body, headers):
        """Bulk ingest (ref: pilosa_tpu handler.py:1314-1350): one
        (row, column[, timestamp]) or (column, value) batch in a binary
        columnar body (``application/x-pilosa-ingest``, ingest/codec.py)
        or in JSON. On a cluster the pipeline sends each slice's part to
        every owner; ``?slice=`` marks such a leg, which installs here
        and answers 412 when this node does not own the slice (ref:
        pilosa_tpu handler.py:1314-1356)."""
        if self.ingest is None:
            raise HTTPError(
                501, "ingest pipeline disabled ([ingest] enabled)")
        index = params["index"]
        if headers.get("Content-Type") == ingest_codec.CONTENT_TYPE:
            try:
                req = ingest_codec.decode(body)
            except ingest_codec.CodecError as e:
                raise HTTPError(400, str(e))
        else:
            req = json.loads(body or b"{}")
        self._require(req, "frame")
        self._frame(index, req["frame"])  # 404 like /import
        local = "slice" in qp
        if local:
            self._check_slice_ownership(index, int(qp["slice"][0]))
        try:
            if req.get("values") is not None:
                self._require(req, "field", "columns", "values")
                out = self.ingest.ingest_values(
                    index, req["frame"], req["field"], req["columns"],
                    req["values"], local=local)
            else:
                self._require(req, "rows", "columns")
                ts = req.get("timestamps")
                if ts is not None and isinstance(ts, list):
                    # JSON: null is no timestamp (0 in the binary frame).
                    ts = [int(t) if t else 0 for t in ts]
                out = self.ingest.ingest_bits(
                    index, req["frame"], req["rows"], req["columns"],
                    ts, local=local)
        except IngestError as e:
            raise HTTPError(e.status, str(e))
        return _json(200, out)

    # -------------------------------------------------- input definitions

    def post_input_definition(self, params, qp, body, headers):
        """(ref: pilosa_tpu handler.py:1102-1112)."""
        req = json.loads(body or b"{}")
        for fr in req.get("frames", []):
            self._require(fr, "name")
        self._index(params["index"]).create_input_definition(
            params["def"], req.get("frames", []), req.get("fields", []))
        return _OK

    def get_input_definition(self, params, qp, body, headers):
        idef = self._index(params["index"]).input_definition(params["def"])
        return _json(200, idef.to_dict())

    def delete_input_definition(self, params, qp, body, headers):
        self._index(params["index"]).delete_input_definition(params["def"])
        return _OK

    def post_input(self, params, qp, body, headers):
        """JSON records through an input definition (ref: handler.go:
        1907-2014; pilosa_tpu handler.py:1125-1138)."""
        idx = self._index(params["index"])
        idef = idx.input_definition(params["def"])
        records = json.loads(body or b"[]")
        for frame, bits in idef.parse_records(records).items():
            idx.input_bits(frame, [
                (row, col,
                 datetime.fromtimestamp(t) if t is not None else None)
                for row, col, t in bits])
        return _OK

    def get_export(self, params, qp, body, headers):
        """CSV of one view and slice, a ``row,column`` line per bit in
        row order (ref: handler.go:1314-1364)."""
        index = qp.get("index", [""])[0]
        frame = qp.get("frame", [""])[0]
        view = qp.get("view", ["standard"])[0]
        slice_num = int(qp.get("slice", ["0"])[0])
        frag = self.holder.fragment(index, frame, view, slice_num)
        out = io.StringIO()
        if frag is not None:
            base = slice_num * SLICE_WIDTH
            for row_id in frag.rows():
                cols = np.flatnonzero(np.unpackbits(
                    frag.row_words(row_id).view(np.uint8),
                    bitorder="little")) + base
                out.write("".join(f"{row_id},{c}\n" for c in cols.tolist()))
        return 200, "text/csv", out.getvalue().encode()

    # ---------------------------------------------------------- cluster

    def post_cluster_message(self, params, qp, body, headers):
        """A peer's broadcast (ref: handler.go:2041, Server.ReceiveMessage
        server.go:359-442) in the reference's envelope: one type byte and
        a protobuf body."""
        try:
            msg = wireproto.decode_cluster_message(body)
        except (ValueError, IndexError):
            raise HTTPError(400, "unmarshal body error")
        self.receive_message(msg)
        return _OK

    def receive_message(self, msg):
        """Apply a peer's DDL or create-slice message; one that already
        holds here is no error."""
        t = msg.get("type")
        idx = self.holder.index(msg.get("index", ""))
        fr = idx.frame(msg.get("frame", "")) if idx is not None else None
        if t == "create-index":
            opts = msg.get("options", {})
            self.holder.create_index_if_not_exists(
                msg["index"], column_label=opts.get("columnLabel", ""),
                time_quantum=opts.get("timeQuantum", ""))
        elif t == "delete-index":
            if idx is not None:
                self.holder.delete_index(msg["index"])
        elif t == "create-frame":
            if idx is not None:
                idx.create_frame_if_not_exists(
                    msg["frame"], FrameOptions.from_dict(
                        msg.get("options", {})))
        elif t == "delete-frame":
            if idx is not None:
                idx.delete_frame(msg["frame"])
        elif t == "create-field":
            if fr is not None:
                try:
                    fr.create_field(Field.from_dict(msg["field"]))
                except perr.ErrFieldExists:
                    pass
        elif t == "delete-field":
            if fr is not None:
                fr.delete_field(msg["field"])
        elif t == "delete-view":
            if fr is not None:
                try:
                    fr.delete_view(msg["view"])
                except perr.ErrInvalidView:
                    pass
        elif t == "create-slice":
            if idx is not None:
                if msg.get("inverse"):
                    idx.set_remote_max_inverse_slice(msg["slice"])
                else:
                    idx.set_remote_max_slice(msg["slice"])
        elif t == "create-input-definition":
            if idx is not None:
                d = msg["definition"]
                try:
                    idx.create_input_definition(
                        msg["name"], d.get("frames", []),
                        d.get("fields", []))
                except perr.ErrInputDefinitionExists:
                    pass
        elif t == "delete-input-definition":
            if idx is not None:
                idx.delete_input_definition(msg["name"])

    def post_internal_heartbeat(self, params, qp, body, headers):
        """The membership probe's state exchange (the memberlist
        push/pull analog): merge the prober's compact status and answer
        with ours, without the schema when the digests agree."""
        st = json.loads(body or b"{}")
        if st:
            if (self.epochs is not None and isinstance(st.get("epochs"),
                                                       dict)
                    and st.get("host")):
                self.epochs.observe(st["host"], st["epochs"])
            try:
                self.holder.merge_remote_status(st)
            except Exception:  # noqa: BLE001 — a malformed peer status
                traceback.print_exc()  # must not fail the liveness probe
        local = self.holder.node_status_compact(self.local_host or "")
        if self.epochs is not None:
            local["epochs"] = epochs_mod.local_epochs(self.holder)
        if st.get("schemaDigest") and \
                st.get("schemaDigest") == local.get("schemaDigest"):
            local.pop("schema", None)
        return _json(200, local)

    def get_internal_probe(self, params, qp, body, headers):
        """Probe a cluster member's /id for a peer (the SWIM indirect
        ping). Only members are probed: this is no fetch proxy."""
        host = qp.get("host", [""])[0]
        if not host:
            raise HTTPError(400, "host required")
        node = self.cluster.node_by_host(host) if self.cluster else None
        if node is None:
            raise HTTPError(400, "host is not a cluster member")
        client = self.executor.client
        ok = client.probe(node, timeout=3) if client is not None else False
        return _json(200, {"ok": ok})

    def get_internal_epochs(self, params, qp, body, headers):
        """The epoch probe's target (ref: pilosa_tpu handler.py:1699-1708):
        this node's counters, on one node too."""
        return _json(200, {"host": self.local_host or "",
                           "epochs": epochs_mod.local_epochs(self.holder)})

    def get_debug_epochs(self, params, qp, body, headers):
        """The epoch registry's state, ``{"enabled": false}`` on one
        node."""
        return _json(200, self.epochs.snapshot() if self.epochs is not None
                     else {"enabled": False})

    def post_recalculate_caches(self, params, qp, body, headers):
        """(ref: handler.go:2016): rebuild the TopN caches from storage."""
        self.holder.recalculate_caches()
        return 204, "application/json", b""


class _FastHeaders(dict):
    """Case-insensitive header mapping with Title-Case canonical keys."""

    def get(self, key, default=None):
        return dict.get(self, key.title(), default)

    def __contains__(self, key):
        return dict.__contains__(self, key.title())


def make_http_server(handler, bind="localhost:0",
                     max_body_size=DEFAULT_MAX_BODY_SIZE):
    """Wrap a Handler in a ThreadingHTTPServer (one thread per
    connection, HTTP/1.1 keep-alive, TCP_NODELAY). A request whose body
    is larger than ``max_body_size`` is answered 413 before any byte of
    the body is read (0 disables the check); chunked bodies are counted
    as they arrive. The bulk-ingest route's cap is ``INGEST_HARD_CAP``
    instead: its batches are far beyond the default cap."""
    host, _, port = bind.rpartition(":")

    class _Req(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Headers and payload go out as separate writes; with Nagle on,
        # the payload segment waits out the peer's delayed ACK (~40 ms
        # per keep-alive request).
        disable_nagle_algorithm = True

        def parse_request(self):
            """Fast request parse: plain ``METHOD path HTTP/1.x`` requests
            read their headers in a direct line loop into a
            case-insensitive dict (the stdlib's email parser costs ~130
            µs per request); anything unusual in the request line goes to
            the stdlib before a header byte is consumed."""
            line = str(self.raw_requestline, "iso-8859-1").rstrip("\r\n")
            words = line.split()
            if (len(words) != 3
                    or words[2] not in ("HTTP/1.1", "HTTP/1.0")):
                return super().parse_request()
            self.requestline = line
            self.command, self.path, self.request_version = words
            self.close_connection = words[2] == "HTTP/1.0"
            headers = _FastHeaders()
            last = None
            for _ in range(201):
                hline = self.rfile.readline(65537)
                if len(hline) > 65536:
                    self.send_error(431)  # header line too long
                    return False
                if hline in (b"\r\n", b"\n", b""):
                    break
                if hline[0] in (32, 9):
                    if last is not None:
                        # Obsolete line folding: append to the
                        # anchoring field's value.
                        headers[last] += " " + hline.strip().decode(
                            "iso-8859-1")
                    continue
                name, sep, value = hline.decode("iso-8859-1") \
                    .partition(":")
                if not sep or not name.strip():
                    last = None
                    continue  # junk line: tolerated, as email parser
                if name != name.strip():
                    # RFC 7230 §3.2.4: whitespace between field name and
                    # colon MUST be rejected (a request-smuggling
                    # differential with proxies that drop the field).
                    self.send_error(400, "whitespace in header name")
                    return False
                key = name.title()
                value = value.strip()
                if key in headers:
                    if key == "Content-Length" \
                            and dict.get(headers, key) != value:
                        # Conflicting lengths desync body framing.
                        self.send_error(400,
                                        "conflicting Content-Length")
                        return False
                    last = None  # duplicate: the FIRST value wins
                    continue
                headers[key] = value
                last = key
            else:
                self.send_error(431)  # too many headers
                return False
            self.headers = headers
            conntype = headers.get("Connection", "").lower()
            if conntype == "close":
                self.close_connection = True
            elif conntype == "keep-alive":
                self.close_connection = False
            # 100-continue must be answered or body-bearing clients
            # (curl above 1 KB) stall waiting for it.
            if (headers.get("Expect", "").lower() == "100-continue"
                    and self.request_version >= "HTTP/1.1"):
                if not self.handle_expect_100():
                    return False
            return True

        def _content_length(self):
            """Declared body length; None for an unparseable or negative
            header (answered 400: a negative length would read to EOF
            past the 413 gate)."""
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                return None
            return None if length < 0 else length

        def _body_cap(self, path):
            """The byte cap of this route's body, 0 for none (ref:
            pilosa_tpu handler.py:2602-2624)."""
            if _INGEST_PATH.match(path):
                return INGEST_HARD_CAP
            return max_body_size

        def _read_chunked(self, cap):
            """RFC 7230 §4.1 chunked body with the cap enforced as the
            chunks arrive. Returns (body, None) or (None, "bad" for
            malformed framing | "too_large")."""
            total = 0
            parts = []
            while True:
                line = self.rfile.readline(65537)
                if not line or len(line) > 65536:
                    return None, "bad"
                try:
                    size = int(line.split(b";")[0].strip(), 16)
                except ValueError:
                    return None, "bad"
                if size < 0:
                    return None, "bad"
                if size == 0:
                    while True:  # trailer section
                        t = self.rfile.readline(65537)
                        if t in (b"\r\n", b"\n", b""):
                            break
                    return b"".join(parts), None
                total += size
                if cap and total > cap:
                    return None, "too_large"
                data = self.rfile.read(size)
                if len(data) < size:
                    return None, "bad"
                parts.append(data)
                if self.rfile.read(2) != b"\r\n":
                    return None, "bad"

        def handle_expect_100(self):
            """Answer 413 instead of ``100 Continue`` when the declared
            body is too large: the client then never sends it."""
            length = self._content_length()
            if length is None:
                self.send_error(400, "bad Content-Length")
                return False
            cap = self._body_cap(urlparse(self.path).path)
            if cap and length > cap:
                self.send_error(413, "request body too large")
                return False
            return super().handle_expect_100()

        def _serve(self):
            parsed = urlparse(self.path)
            qp = parse_qs(parsed.query)
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                body, err = self._read_chunked(self._body_cap(parsed.path))
                if err is not None:
                    # The peer may still be sending: the connection
                    # cannot be reused either way.
                    self.close_connection = True
                    if err == "too_large":
                        self._reject_oversized()
                    else:
                        self.send_error(400, "bad chunked encoding")
                    return
            else:
                length = self._content_length()
                if length is None:
                    self.close_connection = True
                    self.send_error(400, "bad Content-Length")
                    return
                cap = self._body_cap(parsed.path)
                if cap and length > cap:
                    # Refused before a byte of it is buffered; the body
                    # is never read, so the connection closes.
                    self.close_connection = True
                    self._reject_oversized()
                    return
                body = self.rfile.read(length) if length else b""
            self._respond(handler.dispatch(self.command, parsed.path, qp,
                                           body, self.headers))

        def _reject_oversized(self):
            payload = json.dumps(
                {"error": "request body too large"}).encode()
            self.send_response(413)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(payload)

        def _respond(self, resp):
            status, ctype, payload = resp[:3]
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            for name, value in (resp[3] if len(resp) > 3 else {}).items():
                self.send_header(name, value)
            # A small payload goes out in the headers' write (one
            # syscall, no delayed-ACK interplay between two segments); a
            # large one in a write of its own, not copied into the
            # header buffer.
            if (len(payload) < 16384
                    and hasattr(self, "_headers_buffer")):
                self._headers_buffer.append(b"\r\n")
                self._headers_buffer.append(payload)
                self.flush_headers()
            else:
                self.end_headers()
                self.wfile.write(payload)

        do_GET = do_POST = do_DELETE = do_PATCH = _serve

        def setup(self):
            super().setup()
            self.server.track_conn(self.connection, True)

        def finish(self):
            self.server.track_conn(self.connection, False)
            super().finish()

        def log_message(self, fmt, *args):  # quiet test output
            pass

    class _Server(ThreadingHTTPServer):
        # The default listen backlog of 5 resets a burst of connects.
        request_queue_size = 128
        daemon_threads = True

        # Keep-alive connections outlive shutdown(), which stops only
        # the accept loop: server_close() severs them, so that no
        # connection thread answers from a closed holder.
        def __init__(self, *args, **kw):
            self._open_conns = set()
            self._conns_mu = threading.Lock()
            super().__init__(*args, **kw)

        def track_conn(self, sock, on):
            with self._conns_mu:
                if on:
                    self._open_conns.add(sock)
                else:
                    self._open_conns.discard(sock)

        def server_close(self):
            super().server_close()
            with self._conns_mu:
                conns = list(self._open_conns)
                self._open_conns.clear()
            for sock in conns:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                sock.close()

    return _Server((host or "localhost", int(port or 0)), _Req)
