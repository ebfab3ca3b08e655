"""End-to-end distributed query tracing (counterpart of
pilosa_tpu/tracing.py; the same names, span trees and ring semantics).

- ``Span``/``Trace``: monotonic timings, tags, parent links. Finished
  traces land in a bounded in-memory ring; traces slower than
  ``slow_threshold`` seconds also land in a slow-query ring and count
  in ``summary()``'s ``slowQueries``.
- Trace-context propagation: the coordinator stamps
  ``X-Pilosa-Trace-Id``/``X-Pilosa-Span-Id`` on its internal fan-out
  requests (cluster/client.py); the remote handler adopts them, so the
  remote node's spans carry the same trace id and a parent link into
  the coordinator's fan-out span. ``stitch()`` reassembles the pieces
  (one ``to_dict()`` payload per node, from each node's
  ``/debug/traces?traceId=``) into one tree.
- A thread-local ACTIVE SPAN: instrumentation anywhere calls
  ``tracing.span(name, **tags)``, which is the shared no-op unless a
  trace is active on the calling thread, so disabled tracing costs one
  call and one attribute read per instrumentation point (per-slice
  loops hoist even that behind an ``active_span()`` check).

Roots are opened by whoever owns a Tracer (the HTTP handler, tests);
everything below nests by itself. Work handed to another thread adopts
its parent explicitly through ``child_of`` (thread-locals do not cross
threads).

The reference's tracer also registers its lock with a lock-order
checker, stamps a slow trace with the sampling profiler's top stacks and
counts slow queries and latency buckets on a stats client for
``/metrics``; this port has none of those yet (``Tracer(stats=None)`` is
the only form).
"""
import os
import threading
import time
from collections import deque

TRACE_HEADER = "X-Pilosa-Trace-Id"
SPAN_HEADER = "X-Pilosa-Span-Id"

DEFAULT_SLOW_THRESHOLD = 0.25   # seconds
DEFAULT_RING_SIZE = 128
DEFAULT_SLOW_RING_SIZE = 64

_ACTIVE = threading.local()


def _new_id():
    return os.urandom(8).hex()


def active_span():
    """The span active on this thread, or None."""
    return getattr(_ACTIVE, "span", None)


class _NopCM:
    """Shared, stateless no-op span: ``with`` it from any thread."""

    __slots__ = ()
    tags = None  # instrumentation must not write into it

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kw):
        pass


NOP_SPAN = _NopCM()


def span(name, **tags):
    """A child of the thread's active span; the shared no-op when no
    trace is active."""
    parent = getattr(_ACTIVE, "span", None)
    if parent is None:
        return NOP_SPAN
    return Span(parent.trace, name, parent_id=parent.span_id, tags=tags)


def child_of(parent, name, **tags):
    """A span under an explicit parent, for work handed to another
    thread: capture ``active_span()`` before handing it over, open the
    child on the other thread."""
    if parent is None or parent is NOP_SPAN:
        return NOP_SPAN
    return Span(parent.trace, name, parent_id=parent.span_id, tags=tags)


class _Adopt:
    __slots__ = ("_span", "_prev")

    def __init__(self, sp):
        self._span = sp

    def __enter__(self):
        self._prev = getattr(_ACTIVE, "span", None)
        _ACTIVE.span = self._span
        return self._span

    def __exit__(self, *exc):
        _ACTIVE.span = self._prev
        return False


def adopt(sp):
    """Make ``sp``, an open span of another thread, this thread's active
    span for the block, or no span at all when ``sp`` is None: work one
    thread does for another's request (a coalescer leader serving a
    parked member) nests under that request's trace, or under none,
    never under the serving thread's own."""
    return _Adopt(None if sp is NOP_SPAN else sp)


def trace_headers():
    """The propagation headers of the active trace context, or None."""
    sp = getattr(_ACTIVE, "span", None)
    if sp is None:
        return None
    return {TRACE_HEADER: sp.trace.trace_id, SPAN_HEADER: sp.span_id}


class Span:
    """One timed operation, a context manager: entering activates it on
    the current thread; exiting records its duration, appends it to its
    trace and restores the previous active span."""

    __slots__ = ("trace", "name", "span_id", "parent_id", "tags",
                 "start", "duration", "_t0", "_prev")

    def __init__(self, trace, name, parent_id=None, tags=None):
        self.trace = trace
        self.name = name
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.tags = dict(tags) if tags else {}
        self.start = None
        self.duration = None
        self._t0 = None
        self._prev = None

    def tag(self, **kw):
        self.tags.update(kw)

    def __enter__(self):
        self._prev = getattr(_ACTIVE, "span", None)
        _ACTIVE.span = self
        self._t0 = time.perf_counter()
        # Wall clock from the trace's epoch pair: one process's spans
        # share one clock.
        self.start = self.trace.epoch0 + (self._t0 - self.trace.perf0)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration = time.perf_counter() - self._t0
        if exc is not None:
            self.tags["error"] = f"{type(exc).__name__}: {exc}"[:200]
        self.trace.add(self)
        _ACTIVE.span = self._prev
        if self is self.trace.root:
            self.trace.tracer._finish(self.trace)
        return False

    def to_dict(self):
        return {
            "name": self.name,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "start": self.start,
            "durationMs": (round(self.duration * 1000, 3)
                           if self.duration is not None else None),
            "tags": dict(self.tags),
        }


class Trace:
    """The spans of one trace id. Spans append on exit (children before
    parents), so the list is whole when the root exits."""

    def __init__(self, tracer, trace_id=None):
        self.tracer = tracer
        self.trace_id = trace_id or _new_id()
        self.epoch0 = time.time()
        self.perf0 = time.perf_counter()
        self.spans = []
        self._mu = threading.Lock()
        self.root = None
        self.dropped = 0  # added to the tracer's total at finish

    def add(self, sp):
        with self._mu:
            if len(self.spans) < self.tracer.max_spans:
                self.spans.append(sp)
            else:
                self.dropped += 1

    def to_dict(self):
        with self._mu:
            spans = [s.to_dict() for s in self.spans]
        out = {
            "traceId": self.trace_id,
            "durationMs": (round(self.root.duration * 1000, 3)
                           if self.root and self.root.duration is not None
                           else None),
            "spans": spans,
            "roots": _build_tree(spans),
        }
        # The query's resource counts (querystats.py), set by the handler
        # once the root closed.
        resources = getattr(self, "resources", None)
        if resources:
            out["resources"] = resources
        return out


def _build_tree(span_dicts):
    """Nest flat span dicts by parent links. A span whose parent is not
    in the set (a trace root; a remote piece whose parent lives on the
    coordinator) becomes a root; siblings and roots are ordered by
    start time."""
    nodes = {}
    for s in span_dicts:
        n = dict(s)
        n["children"] = []
        nodes[s["spanId"]] = n
    roots = []
    for n in nodes.values():
        parent = nodes.get(n["parentId"]) if n["parentId"] else None
        if parent is not None and parent is not n:
            parent["children"].append(n)
        else:
            roots.append(n)
    key = lambda n: n["start"] or 0  # noqa: E731
    for n in nodes.values():
        n["children"].sort(key=key)
    roots.sort(key=key)
    return roots


def stitch(trace_dicts):
    """Merge ``Trace.to_dict()`` payloads of one trace id, typically one
    per cluster node, into one span tree: a remote root resolves under
    the coordinator's fan-out span through its propagated parent id."""
    if not trace_dicts:
        return None
    tids = {t["traceId"] for t in trace_dicts}
    if len(tids) != 1:
        raise ValueError(f"cannot stitch distinct trace ids: {sorted(tids)}")
    spans, seen = [], set()
    for t in trace_dicts:
        for s in t["spans"]:
            if s["spanId"] not in seen:
                seen.add(s["spanId"])
                spans.append(s)
    durations = [t["durationMs"] for t in trace_dicts
                 if t.get("durationMs") is not None]
    return {
        "traceId": tids.pop(),
        "durationMs": max(durations) if durations else None,
        "spans": spans,
        "roots": _build_tree(spans),
    }


class Tracer:
    """The recording tracer: a bounded ring of recent traces and a
    slow-query ring. ``stats`` must be None (no stats client yet)."""

    enabled = True

    def __init__(self, ring_size=DEFAULT_RING_SIZE,
                 slow_threshold=DEFAULT_SLOW_THRESHOLD,
                 slow_ring_size=DEFAULT_SLOW_RING_SIZE,
                 stats=None, max_spans=4096):
        if stats is not None:
            raise ValueError("tracing: no stats client in this package")
        self.slow_threshold = slow_threshold
        self.max_spans = max_spans
        self._ring = deque(maxlen=max(int(ring_size), 1))
        self._slow_ring = deque(maxlen=max(int(slow_ring_size), 1))
        self._latencies = deque(maxlen=512)
        self._mu = threading.Lock()
        self._finished = 0
        self._slow = 0
        self._dropped = 0
        self.stats = stats

    # ------------------------------------------------------------ record

    def start(self, name, trace_id=None, parent_id=None, **tags):
        """Open a root span (a new trace); ``trace_id``/``parent_id`` from
        propagated headers put it under a remote parent."""
        trace = Trace(self, trace_id=trace_id)
        root = Span(trace, name, parent_id=parent_id, tags=tags)
        trace.root = root
        return root

    def span(self, name, **tags):
        """A child of the thread's active span, or a new root when no
        trace is active."""
        parent = getattr(_ACTIVE, "span", None)
        if parent is not None:
            return Span(parent.trace, name, parent_id=parent.span_id,
                        tags=tags)
        return self.start(name, **tags)

    def _finish(self, trace):
        dur = trace.root.duration
        slow = dur is not None and dur >= self.slow_threshold
        with self._mu:
            self._ring.append(trace)
            self._finished += 1
            self._dropped += trace.dropped
            if dur is not None:
                self._latencies.append(dur)
            if slow:
                self._slow += 1
                self._slow_ring.append(trace)

    # ------------------------------------------------------------- read

    def recent(self, n=32, slow=False, trace_id=None):
        """Newest-first trace dicts from the requested ring."""
        with self._mu:
            ring = list(self._slow_ring if slow else self._ring)
        out = []
        for trace in reversed(ring):
            if trace_id and trace.trace_id != trace_id:
                continue
            out.append(trace.to_dict())
            if len(out) >= n:
                break
        return out

    def ring_len(self, slow=False):
        with self._mu:
            return len(self._slow_ring if slow else self._ring)

    def summary(self):
        """Totals and p50/p99 over the recent-latency window."""
        with self._mu:
            lats = sorted(self._latencies)
            out = {"traces": self._finished, "slowQueries": self._slow,
                   "droppedSpans": self._dropped}
        if lats:
            out["p50Ms"] = round(lats[len(lats) // 2] * 1000, 3)
            out["p99Ms"] = round(
                lats[min(len(lats) - 1, (len(lats) * 99) // 100)] * 1000, 3)
        return out


class NopTracer:
    """Disabled tracing: every surface answers, nothing records."""

    enabled = False
    slow_threshold = DEFAULT_SLOW_THRESHOLD

    def start(self, name, trace_id=None, parent_id=None, **tags):
        return NOP_SPAN

    def span(self, name, **tags):
        return NOP_SPAN

    def recent(self, n=32, slow=False, trace_id=None):
        return []

    def ring_len(self, slow=False):
        return 0

    def summary(self):
        return {}


NOP = NopTracer()
