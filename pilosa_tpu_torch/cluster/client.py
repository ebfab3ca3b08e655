"""HTTP client of one node's public API: the calls the CLI makes (ref:
client.go; counterpart of the single-node subset of
pilosa_tpu/cluster/client.py ``InternalClient``).

A node is ``host:port`` or an ``http://host:port`` URL. One keep-alive
connection per node is reused across requests; a connection the server
closed between two requests is replaced once.
"""
import http.client
import json
import threading
import urllib.parse

from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch.server import wireproto


class ClientError(Exception):
    """``status`` is the HTTP status when one was received."""

    def __init__(self, msg, status=None):
        super().__init__(msg)
        self.status = status


def _netloc(node):
    """``host:port`` of ``host:port`` or an ``http://`` URL."""
    u = urllib.parse.urlsplit(node if "://" in node else f"http://{node}")
    if u.scheme != "http":
        raise ValueError(f"unsupported scheme: {u.scheme}")
    return u.netloc


def _path(path, **params):
    qs = urllib.parse.urlencode(
        {k: v for k, v in params.items() if v is not None})
    return path + (f"?{qs}" if qs else "")


class InternalClient:
    def __init__(self, timeout=30):
        self.timeout = timeout
        self._mu = threading.Lock()
        self._conns = {}  # netloc -> idle HTTPConnection

    def close(self):
        with self._mu:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()

    def _do(self, method, node, path, body=None,
            content_type="application/json"):
        """-> (status, body bytes). A request on a reused connection
        that the server has closed is sent again on a fresh one."""
        netloc = _netloc(node)
        headers = {"Content-Type": content_type} if body is not None else {}
        for attempt in (0, 1):
            with self._mu:
                conn = self._conns.pop(netloc, None)
            reused = conn is not None
            if conn is None:
                conn = http.client.HTTPConnection(netloc,
                                                  timeout=self.timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.RemoteDisconnected, BrokenPipeError,
                    ConnectionResetError):
                conn.close()
                if reused and attempt == 0:
                    continue
                raise
            except BaseException:
                conn.close()
                raise
            if resp.will_close:
                conn.close()
            else:
                with self._mu:
                    self._conns.setdefault(netloc, conn)
            return resp.status, data

    def _json(self, method, node, path, payload=None):
        body = json.dumps(payload).encode() if payload is not None else None
        status, data = self._do(method, node, path, body)
        if status >= 400:
            raise ClientError(f"{method} {path}: {status}: {data!r}",
                              status=status)
        return json.loads(data) if data else {}

    # --------------------------------------------------------------- DDL

    def ensure_index(self, node, index, opts=None):
        status, data = self._do("POST", node, f"/index/{index}",
                                json.dumps({"options": opts or {}}).encode())
        if status >= 400 and status != 409:
            raise ClientError(f"POST /index/{index}: {status}: {data!r}",
                              status=status)

    def ensure_frame(self, node, index, frame, opts=None):
        path = f"/index/{index}/frame/{frame}"
        status, data = self._do("POST", node, path,
                                json.dumps({"options": opts or {}}).encode())
        if status >= 400 and status != 409:
            raise ClientError(f"POST {path}: {status}: {data!r}",
                              status=status)

    def ensure_field(self, node, index, frame, field, min_val=0, max_val=0):
        """Create an int field; one that exists already is no error."""
        path = f"/index/{index}/frame/{frame}/field/{field}"
        status, data = self._do("POST", node, path, json.dumps(
            {"type": "int", "min": min_val, "max": max_val}).encode())
        if status >= 400 and str(perr.ErrFieldExists()).encode() not in data:
            raise ClientError(f"POST {path}: {status}: {data!r}",
                              status=status)

    # ------------------------------------------------------------ import

    def _post_pb(self, node, path, body):
        status, data = self._do("POST", node, path, body,
                                wireproto.CONTENT_TYPE)
        if status >= 400:
            raise ClientError(f"POST {path}: {status}: {data!r}",
                              status=status)

    def import_bits(self, node, index, frame, slice_num, row_ids,
                    column_ids, timestamps=None):
        """One slice's bits as a protobuf ImportRequest; ``timestamps``
        in epoch seconds, 0 for none."""
        self._post_pb(node, "/import", wireproto.encode_import_request(
            index, frame, slice_num, row_ids, column_ids, timestamps))

    def import_k(self, node, index, frame, row_keys, column_keys,
                 timestamps=None):
        """Keyed import: string keys, translated by the server (ref:
        ImportK client.go:307-330); one request to one node, since a
        key's slice is unknown before its translation."""
        self._post_pb(node, "/import", wireproto.encode_import_request(
            index, frame, 0, [], [], timestamps, row_keys=row_keys,
            column_keys=column_keys))

    def import_values(self, node, index, frame, slice_num, field,
                      column_ids, values):
        self._post_pb(node, "/import-value",
                      wireproto.encode_import_value_request(
                          index, frame, slice_num, field, column_ids,
                          values))

    # ------------------------------------------------------------- reads

    def max_slices(self, node):
        """{index: max slice} of the standard views."""
        return {k: int(v) for k, v in self._json(
            "GET", node, "/slices/max")["maxSlices"].items()}

    def export_csv(self, node, index, frame, view, slice_num):
        path = _path("/export", index=index, frame=frame, view=view,
                     slice=slice_num)
        status, data = self._do("GET", node, path)
        if status >= 400:
            raise ClientError(f"GET {path}: {status}", status=status)
        return data.decode()
