"""pilosa_tpu_torch.tracing against pilosa_tpu.tracing, on the CPU.

The same script of spans (nesting, tags, errors, explicit parents on
other threads, remote roots under propagated ids) runs through both
packages' ``Tracer``s, from a numpy seed; with span and trace ids and
times masked, the recent and slow rings' ``to_dict()`` trees, the ring
lengths, ``summary()`` (its counts; p50/p99 are times), the dropped
count past ``max_spans`` and ``stitch()`` over the same payloads are
equal. Disabled tracing hands out the shared no-op in both. Tolerance:
none, the masked trees equal.
"""
import threading

import numpy as np
import pytest

from pilosa_tpu import tracing as jtr
from pilosa_tpu_torch import tracing as ttr


def _mask(obj, ids):
    """Ids replaced by their order of first appearance, times by None;
    without the reference's ``profile`` key, the sampling profiler's
    stacks on a slow trace (not ported; present when a test in the same
    process turned that profiler on)."""
    if isinstance(obj, list):
        return [_mask(x, ids) for x in obj]
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        if k == "profile" and "traceId" in obj:
            continue
        if k in ("spanId", "parentId", "traceId") and v is not None:
            out[k] = ids.setdefault(v, f"id{len(ids)}")
        elif k in ("start", "durationMs"):
            out[k] = None
        else:
            out[k] = _mask(v, ids)
    return out


def _script(seed, n_traces=6):
    """A list of traces, each a list of (depth, name, tags, error,
    on_thread) spans in creation order, from a numpy seed."""
    rng = np.random.default_rng(seed)
    traces = []
    for t in range(n_traces):
        spans = []
        for i in range(int(rng.integers(0, 7))):
            depth = int(rng.integers(1, 4))
            tags = {f"k{j}": int(rng.integers(0, 100))
                    for j in range(int(rng.integers(0, 3)))}
            spans.append((depth, f"s{t}.{i}", tags,
                          bool(rng.random() < 0.2),
                          bool(rng.random() < 0.3)))
        traces.append((f"q{t}", {"index": f"i{t}"}, spans,
                       bool(rng.random() < 0.2)))
    return traces


def _run(mod, tracer, script):
    """Play ``script`` through ``tracer`` of package ``mod``."""
    for root_name, root_tags, spans, root_err in script:
        root = tracer.start(root_name, **root_tags)
        try:
            with root:
                _play(mod, spans)
                if root_err:
                    raise ValueError(f"{root_name} failed")
        except ValueError:
            pass


def _play(mod, spans):
    if not spans:
        return
    depth, name, tags, err, on_thread = spans[0]
    rest = spans[1:]
    # Nest the run of deeper spans that follows under this one.
    inner = []
    for s in rest:
        if s[0] <= depth:
            break
        inner.append(s)
    after = rest[len(inner):]

    def body():
        try:
            with mod.span(name, **tags) as sp:
                sp.tag(order=len(inner))
                _play(mod, inner)
                if err:
                    raise KeyError(name)
        except KeyError:
            pass

    if on_thread:
        parent = mod.active_span()

        def run():
            try:
                with mod.child_of(parent, name, **tags):
                    _play(mod, inner)
                    if err:
                        raise KeyError(name)
            except KeyError:
                pass

        th = threading.Thread(target=run)
        th.start()
        th.join()
    else:
        body()
    _play(mod, after)


@pytest.mark.parametrize("slow", [0.0, 1e9])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_script_matches_reference(seed, slow):
    script = _script(seed)
    jt = jtr.Tracer(ring_size=4, slow_threshold=slow, slow_ring_size=3,
                    stats=None)
    tt = ttr.Tracer(ring_size=4, slow_threshold=slow, slow_ring_size=3)
    _run(jtr, jt, script)
    _run(ttr, tt, script)
    for slow_ring in (False, True):
        assert tt.ring_len(slow_ring) == jt.ring_len(slow_ring)
        for n in (1, 2, 32):
            got = tt.recent(n, slow=slow_ring)
            want = jt.recent(n, slow=slow_ring)
            assert _mask(got, {}) == _mask(want, {})
    js, ts = jt.summary(), tt.summary()
    assert set(ts) == set(js)
    for k in ("traces", "slowQueries", "droppedSpans"):
        assert ts[k] == js[k]
    # A trace id filter finds the same trace.
    tid = tt.recent(1)[0]["traceId"]
    assert tt.recent(32, trace_id=tid)[0]["traceId"] == tid
    assert tt.recent(32, trace_id="nope") == jt.recent(32, trace_id="nope")


def test_dropped_spans_past_max_spans():
    out = []
    for mod, tr in ((jtr, jtr.Tracer(max_spans=3, stats=None)),
                    (ttr, ttr.Tracer(max_spans=3))):
        for n in (2, 10):
            with tr.start("q"):
                for i in range(n):
                    with mod.span(f"s{i}"):
                        pass
        out.append((tr.summary()["droppedSpans"],
                    _mask(tr.recent(8), {})))
    assert out[0] == out[1]
    assert out[1][0] == 8  # 11 spans of the second trace, 3 kept


def _cluster_trace(mod, tracer, remote_tracer):
    """A coordinator trace whose fan-out span stamps the headers a peer's
    root adopts; -> the two to_dict payloads."""
    with tracer.start("query", index="i"):
        with mod.span("call:Count"):
            with mod.span("remote.h2", host="h2"):
                hdr = mod.trace_headers()
                root = remote_tracer.start(
                    "query.remote", trace_id=hdr[mod.TRACE_HEADER],
                    parent_id=hdr[mod.SPAN_HEADER], index="i")
                with root:
                    with mod.span("call:Count"):
                        pass
    return [tracer.recent(1)[0], remote_tracer.recent(1)[0]]


def test_stitch_matches_reference():
    got = _cluster_trace(ttr, ttr.Tracer(), ttr.Tracer())
    want = _cluster_trace(jtr, jtr.Tracer(stats=None),
                          jtr.Tracer(stats=None))
    sj, st = jtr.stitch(want), ttr.stitch(got)
    assert _mask(st, {}) == _mask(sj, {})
    # The peer's root sits under the coordinator's fan-out span.
    (root,) = st["roots"]
    leg = root["children"][0]["children"][0]
    assert leg["name"] == "remote.h2"
    assert [c["name"] for c in leg["children"]] == ["query.remote"]
    # Stitching the same payloads twice keeps each span once.
    assert len(ttr.stitch(got + got)["spans"]) == len(st["spans"])
    assert ttr.stitch([]) is None and jtr.stitch([]) is None
    other = dict(got[1], traceId="ffff")
    with pytest.raises(ValueError) as et:
        ttr.stitch([got[0], other])
    with pytest.raises(ValueError) as ej:
        jtr.stitch([dict(got[0]), other])
    assert str(et.value) == str(ej.value)


def test_disabled_tracing_is_the_shared_no_op():
    for mod in (jtr, ttr):
        assert mod.active_span() is None
        assert mod.span("x", a=1) is mod.NOP_SPAN
        assert mod.child_of(None, "x") is mod.NOP_SPAN
        assert mod.child_of(mod.NOP_SPAN, "x") is mod.NOP_SPAN
        assert mod.trace_headers() is None
        with mod.span("x") as sp:
            sp.tag(a=1)
        assert mod.NOP_SPAN.tags is None
        assert mod.NOP.start("q") is mod.NOP_SPAN
        assert mod.NOP.span("q") is mod.NOP_SPAN
        assert mod.NOP.enabled is False
    for surface in ("recent", "ring_len", "summary"):
        assert getattr(ttr.NOP, surface)() == getattr(jtr.NOP, surface)()
    assert ttr.NOP.slow_threshold == jtr.NOP.slow_threshold


def test_constants_match_reference():
    for name in ("TRACE_HEADER", "SPAN_HEADER", "DEFAULT_SLOW_THRESHOLD",
                 "DEFAULT_RING_SIZE", "DEFAULT_SLOW_RING_SIZE"):
        assert getattr(ttr, name) == getattr(jtr, name), name
    assert ttr.Tracer().max_spans == jtr.Tracer(stats=None).max_spans
    with pytest.raises(ValueError):
        ttr.Tracer(stats=object())


def test_tracer_span_without_a_trace_opens_a_root():
    for mod, tr in ((jtr, jtr.Tracer(stats=None)), (ttr, ttr.Tracer())):
        with tr.span("lone"):
            with tr.span("inner"):
                pass
        (t,) = tr.recent()
        assert [r["name"] for r in t["roots"]] == ["lone"]
        assert [c["name"] for c in t["roots"][0]["children"]] == ["inner"]


def test_adopt_runs_work_under_another_threads_span():
    tr = ttr.Tracer()
    with tr.start("query") as root:
        with ttr.span("leader-own"):
            with ttr.adopt(root):
                with ttr.span("for-member"):
                    pass
            with ttr.adopt(None):
                assert ttr.span("none") is ttr.NOP_SPAN
            assert ttr.active_span().name == "leader-own"
    (t,) = tr.recent()
    names = {c["name"] for c in t["roots"][0]["children"]}
    assert names == {"leader-own", "for-member"}
