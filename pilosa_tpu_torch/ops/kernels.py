"""Count kernels: the CUDA launches and their plain PyTorch versions.

Each CUDA source's header says what it replaces in pilosa_tpu, its bound
and its design:

- :func:`count_op_rows` — per-row popcount(a OP b), OP in and / or /
  xor / andnot; ports the Pallas ``count_and`` and serves every
  two-operand Count (``csrc/popcount.cu``).
- :func:`count_rows` — per-row popcount(m); ports the Pallas
  ``count_rows`` without its all-ones filter read (the same template).
- :func:`count_and_rows` / :func:`count_and_rows_stacks` — per-row
  popcount(row & filter) against one filter, read once for all rows;
  ports the Pallas ``count_and_rows`` and serves TopN with a Src
  (``csrc/count_and_rows.cu``): the fragment form is one strided launch
  for any row count, the stacked form a table of row pointers.
- :func:`count_op_pairs` — popcount(a_k OP b_k) per slice for K pairs
  of stacks in one launch; replaces the XLA fusion of the coalescer's
  fused Count groups and the fused Min/Max occupancy tests
  (``csrc/popcount.cu``).
- :func:`count_and_rows_multi` — popcount(row_r & filt_k) per slice for
  R shared row stacks and K filter stacks; replaces the fused Sum
  group's XLA fusion (``csrc/count_and_rows.cu``).
- :func:`container_and_counts` — per-member |a ∩ b| of compressed row
  blocks (array × array, array × run, array × dense, run × dense), N
  members in one launch, read in place from their packed sides through
  a member table (the lane table); replaces the count cells of the
  compressed container tier and their lane twins
  (``csrc/containers.cu``).
- :func:`ingest_classify` — per-row cardinality and run starts of a
  sorted (row, position) stream; replaces the bulk-ingest pipeline's XLA
  classify fusion (``csrc/ingest.cu``).

Words are ``int32`` views of the 32-bit device words, shape
``[..., W]``; results are ``int32[...]``. A wrapper takes the plain
version ONLY for tensors on the CPU. For a CUDA tensor it launches the
kernel or raises — there is no fallback. ``launches`` counts kernel
launches per wrapper; ``regime_launches`` splits those of
``count_op_rows``, ``count_rows`` and ``count_and_rows`` by the
decomposition the launch took from its shape (``csrc/popcount.cu`` and
``csrc/count_and_rows.cu``): ``narrow`` (narrow rows, a lane group a
row), ``split`` (few wide rows, a cluster of blocks a row) or ``full``
(a block a row).

While a trace is active on the calling thread (``tracing.py``), each
wrapper runs under a ``kernel:<name>`` span. On the card the wrapper
passes an event list down to its launch sites, and each launch is
bracketed by a ``torch.cuda.Event`` pair recorded on the current stream
just before and just after it; the span waits on the last end event and
tags ``deviceMs``, the sum of the pairs' device times (the kernels alone:
the wrapper's host work falls outside every pair), and ``launches``.
``first_build`` marks the call that built or loaded the kernel's
library, which happens before any event. On a CPU tensor the plain
version runs under the same span, without ``deviceMs``.
``count_op_rows``, ``count_rows`` and ``count_and_rows`` charge their
first operand's bytes to the active query's ``bytesPopcounted`` (ref:
pilosa_tpu ops/bitops.py:153-159); the group kernels' members are
charged their shares by the executor. With no trace active a wrapper
reads one thread-local and nothing else: no event, no sync.
"""
import ctypes
import functools
import math
import threading

import numpy as np
import torch

from pilosa_tpu_torch import querystats, tracing
from pilosa_tpu_torch.ops import loader

# Op codes shared with csrc/popcount.cu.
OP_NONE = 0
OPS = {"and": 1, "or": 2, "xor": 3, "andnot": 4}

# Per-row counts are int32: a row of W words holds 32·W bits.
MAX_WIDTH = (1 << 26) - 1

launches = {"count_op_rows": 0, "count_rows": 0, "count_and_rows": 0,
            "count_op_pairs": 0, "count_and_rows_multi": 0,
            "container_and_counts": 0, "ingest_classify": 0}
# The kernels' regime codes (REGIME_* in the CUDA sources), by value.
REGIMES = ("full", "narrow", "split")
regime_launches = {name: dict.fromkeys(REGIMES, 0)
                   for name in ("count_op_rows", "count_rows",
                                "count_and_rows")}
# container_and_counts' launches by form: the identity form (the serial
# cells, a member a slice) and the table form (the lanes).
container_forms = {"serial": 0, "lane": 0}
# Server threads launch concurrently; a count is a read-modify-write.
_launches_mu = threading.Lock()

# Row pointers per count_and_rows launch (the kernel's parameter table;
# csrc/count_and_rows.cu MAX_ROWS).
CAR_MAX_ROWS = 256

_fn = None
_car_fn = None
_car_strided_fn = None
_pairs_fn = None
_multi_fn = None
_cont_fn = None
_ingest_fn = None


def reset_launches():
    with _launches_mu:
        for name in launches:
            launches[name] = 0
        for split in regime_launches.values():
            for regime in split:
                split[regime] = 0
        for form in container_forms:
            container_forms[form] = 0


def _count_launch(name, regime=None, form=None):
    with _launches_mu:
        launches[name] += 1
        if regime is not None:
            regime_launches[name][REGIMES[regime]] += 1
        if form is not None:
            container_forms[form] += 1


# The library each wrapper's kernel lives in.
_LIBRARY = {"count_op_rows": "popcount", "count_rows": "popcount",
            "count_op_pairs": "popcount", "count_and_rows": "count_and_rows",
            "count_and_rows_multi": "count_and_rows",
            "container_and_counts": "containers",
            "ingest_classify": "ingest"}


def _first_tensor(x):
    if torch.is_tensor(x):
        return x
    if isinstance(x, (list, tuple)):
        for y in x:
            t = _first_tensor(y)
            if t is not None:
                return t
    return None


def _traced(name, charge=False):
    """Run the wrapped wrapper under a ``kernel:<name>`` span while a
    trace is active (see the module docstring); ``charge`` charges its
    first operand's bytes to the query's ``bytesPopcounted``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kw):
            if tracing.active_span() is None:
                return fn(*args, **kw)
            return _traced_call(name, charge, fn, args, kw)
        return traced
    return wrap


def _traced_call(name, charge, fn, args, kw):
    if charge:
        first = args[0]
        if torch.is_tensor(first):
            querystats.add("bytesPopcounted", int(first.nbytes))
        elif isinstance(first, (list, tuple)):
            querystats.add("bytesPopcounted",
                           int(sum(t.nbytes for t in first)))
    t = _first_tensor(args)
    with tracing.span(f"kernel:{name}") as sp:
        if t is None or t.device.type != "cuda":
            return fn(*args, **kw)
        lib = _LIBRARY[name]
        built = loader.loaded(lib)
        loader.library(lib)  # a build or load stays out of deviceMs
        sp.tag(first_build=not built)
        events = []
        out = fn(*args, _events=events, **kw)
        if events:
            # The last end event alone (one stream, in order): a
            # device-wide synchronize would charge other threads'
            # kernels to this span.
            events[-1][1].synchronize()
        sp.tag(deviceMs=round(sum(a.elapsed_time(b) for a, b in events), 4),
               launches=len(events))
        return out


def _timed(events, fn, *args):
    """``fn(*args)``, a kernel launch on the current device's current
    stream; with ``events`` (a traced call's list, see ``_traced_call``)
    it is bracketed by an event pair recorded on that stream, which is
    appended to the list."""
    if events is None:
        return fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rc = fn(*args)
    end.record()
    events.append((start, end))
    return rc


# ----------------------------------------------------------- plain versions

def _popcount16(v):
    """Set bits of values in [0, 2^16) (SWAR; no intermediate leaves the
    16-bit range, so the int32 arithmetic never overflows)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount32(x):
    """Per-element set bits of int32 words (bit 31, the sign bit,
    included): the two 16-bit halves counted separately, with the
    arithmetic shift's sign fill masked off."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


def combine(a, b, op):
    """a OP b on int32 words."""
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "andnot":
        return a & ~b
    raise ValueError(f"unknown count op: {op!r}")


def count_op_rows_plain(a, b, op):
    """Plain version of :func:`count_op_rows`."""
    return popcount32(combine(a, b, op)).sum(dim=-1, dtype=torch.int32)


def count_rows_plain(m):
    """Plain version of :func:`count_rows`."""
    return popcount32(m).sum(dim=-1, dtype=torch.int32)


def count_and_rows_plain(m, filt):
    """Plain version of :func:`count_and_rows`: int32[R, W] & int32[W]
    (or int32[S, W] & int32[S, W]) -> int32[R] (int32[S])."""
    return popcount32(m & filt).sum(dim=-1, dtype=torch.int32)


def count_and_rows_stacks_plain(rows, filt):
    """Plain version of :func:`count_and_rows_stacks`: one candidate at
    a time."""
    if not rows:
        return torch.empty((0, filt.shape[0]), dtype=torch.int32,
                           device=filt.device)
    return torch.stack([count_and_rows_plain(r, filt) for r in rows])


def count_op_pairs_plain(a, b, op):
    """Plain version of :func:`count_op_pairs`: one pair at a time."""
    if not a:
        return torch.empty((0, 0), dtype=torch.int32)
    if op is None:
        return torch.stack([count_rows_plain(x) for x in a])
    return torch.stack([count_op_rows_plain(x, y, op)
                        for x, y in zip(a, b)])


def count_and_rows_multi_plain(rows, filts):
    """Plain version of :func:`count_and_rows_multi`: one filter at a
    time -> int32[K, R, S]."""
    return torch.stack([count_and_rows_stacks_plain(rows, f)
                        for f in filts])


# ----------------------------------------------------------------- wrappers

def _check(name, *ts):
    a = ts[0]
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: words must be int32, got {t.dtype}")
        if t.shape != a.shape:
            raise ValueError(f"{name}: shape mismatch {tuple(a.shape)} vs "
                             f"{tuple(t.shape)}")
        if t.device != a.device:
            raise ValueError(f"{name}: device mismatch {a.device} vs "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: words must be contiguous")
    if a.dim() == 0:
        raise ValueError(f"{name}: words need a trailing word axis")
    if a.shape[-1] > MAX_WIDTH:
        raise ValueError(f"{name}: width {a.shape[-1]} exceeds {MAX_WIDTH} "
                         "words (int32 per-row counts)")


def _kernel():
    global _fn
    if _fn is None:
        lib = loader.library("popcount")
        fn = lib.pilosa_count_op_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.pilosa_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pilosa_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.pilosa_cuda_error_string)
    return _fn


def _launch(name, a, b, op, events=None):
    if a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {a.device}")
    out = torch.empty(a.shape[:-1], dtype=torch.int32, device=a.device)
    rows = math.prod(a.shape[:-1])
    if rows == 0:
        return out
    fn, err_str = _kernel()
    regime = ctypes.c_int(-1)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _timed(events, fn, a.data_ptr(), b.data_ptr(), rows,
                    a.shape[-1], op, out.data_ptr(), stream,
                    ctypes.byref(regime))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} "
                           f"({err_str(rc).decode()})")
    _count_launch(name, regime.value)
    return out


def _car_kernel():
    global _car_fn
    if _car_fn is None:
        lib = loader.library("count_and_rows")
        fn = lib.pilosa_count_and_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.pilosa_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pilosa_cuda_error_string.restype = ctypes.c_char_p
        _car_fn = (fn, lib.pilosa_cuda_error_string)
    return _car_fn


def _car_strided_kernel():
    global _car_strided_fn
    if _car_strided_fn is None:
        lib = loader.library("count_and_rows")
        fn = lib.pilosa_count_and_rows_strided
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _car_strided_fn = (fn, _car_kernel()[1])
    return _car_strided_fn


def _launch_and_rows(ptrs, filt, slices, width, out, events=None):
    """Queue count_and_rows over device row addresses ``ptrs`` (row r's
    slice s at ptrs[r] + s·width words) against ``filt``, into ``out``
    (int32, row r's slice s at r·slices + s), CAR_MAX_ROWS rows per
    launch. The caller holds every operand until this returns, by which
    time each launch is queued on the current stream."""
    if filt.device.type != "cuda":
        raise ValueError(f"count_and_rows: no kernel for device {filt.device}")
    fn, err_str = _car_kernel()
    regime = ctypes.c_int(-1)
    with torch.cuda.device(filt.device):
        stream = torch.cuda.current_stream(filt.device).cuda_stream
        for r0 in range(0, len(ptrs), CAR_MAX_ROWS):
            table = np.asarray(ptrs[r0:r0 + CAR_MAX_ROWS], dtype=np.uint64)
            rc = _timed(events, fn, table.ctypes.data, len(table),
                        filt.data_ptr(), slices, width,
                        out.data_ptr() + r0 * slices * 4, slices, stream,
                        ctypes.byref(regime))
            if rc != 0:
                raise RuntimeError(
                    f"count_and_rows: kernel launch failed: CUDA error "
                    f"{rc} ({err_str(rc).decode()})")
            _count_launch("count_and_rows", regime.value)


@_traced("count_and_rows", charge=True)
def count_and_rows(m, filt, *, _events=None):
    """Per-row popcount(m & filt): int32[R, W], int32[W] -> int32[R]
    (the Pallas ``count_and_rows`` signature)."""
    if (m.dim() != 2 or filt.dim() != 1 or m.shape[1] != filt.shape[0]
            or m.device != filt.device):
        raise ValueError("count_and_rows: m must be [R, W] and filt [W] on "
                         f"one device, got {tuple(m.shape)} on {m.device} "
                         f"and {tuple(filt.shape)} on {filt.device}")
    _check("count_and_rows", m)
    _check("count_and_rows", filt)
    if filt.device.type == "cpu":
        return count_and_rows_plain(m, filt)
    if filt.device.type != "cuda":
        raise ValueError(f"count_and_rows: no kernel for device {filt.device}")
    rows, width = m.shape
    out = torch.empty(rows, dtype=torch.int32, device=m.device)
    if rows:
        # Row r at m + r·width words: one launch for every row.
        fn, err_str = _car_strided_kernel()
        regime = ctypes.c_int(-1)
        with torch.cuda.device(filt.device):
            stream = torch.cuda.current_stream(filt.device).cuda_stream
            rc = _timed(_events, fn, m.data_ptr(), max(width, 1), rows,
                        filt.data_ptr(), 1, width, out.data_ptr(), 1, stream,
                        ctypes.byref(regime))
        if rc != 0:
            raise RuntimeError(f"count_and_rows: kernel launch failed: CUDA "
                               f"error {rc} ({err_str(rc).decode()})")
        _count_launch("count_and_rows", regime.value)
    return out


@_traced("count_and_rows", charge=True)
def count_and_rows_stacks(rows, filt, *, _events=None):
    """Per-(row, slice) popcount(rows[r][s] & filt[s]): R tensors
    int32[S, W] and int32[S, W] -> int32[R, S]. The filter is read once
    per chunk of rows, not once per row."""
    rows = list(rows)
    if filt.dim() != 2:
        raise ValueError(f"count_and_rows_stacks: filt must be [S, W], "
                         f"got {tuple(filt.shape)}")
    _check("count_and_rows_stacks", filt, *rows)
    if filt.device.type == "cpu":
        return count_and_rows_stacks_plain(rows, filt)
    slices, width = filt.shape
    out = torch.empty((len(rows), slices), dtype=torch.int32,
                      device=filt.device)
    if rows and slices:
        _launch_and_rows([r.data_ptr() for r in rows], filt, slices, width,
                         out, _events)
    return out


_thresholds = None


def thresholds():
    """The regime thresholds of the CUDA sources, read once from the
    built libraries: ``count_op_rows`` (and ``count_rows``):
    ``narrow_max_words``, ``split_min_words``, ``split_rows``,
    ``narrow_min_rows``; ``count_and_rows``: ``narrow_max_words``,
    ``split_items`` (items of ``rows_per_item`` rows of one slice),
    ``narrow_chunk`` (the most rows a narrow lane group walks with one
    load of its filter), ``narrow_min_rows`` ((row, slice) counts),
    ``split_min_words``."""
    global _thresholds
    if _thresholds is None:
        got = {}
        for lib, name, keys in (
                ("popcount", "pilosa_count_op_rows_thresholds",
                 ("narrow_max_words", "split_min_words", "split_rows",
                  "narrow_min_rows")),
                ("count_and_rows", "pilosa_count_and_rows_thresholds",
                 ("narrow_max_words", "split_items", "rows_per_item",
                  "narrow_chunk", "narrow_min_rows", "split_min_words"))):
            vals = (ctypes.c_longlong * len(keys))()
            getattr(loader.library(lib), name)(vals)
            got[name[len("pilosa_"):-len("_thresholds")]] = dict(
                zip(keys, map(int, vals)))
        got["count_rows"] = got["count_op_rows"]
        _thresholds = got
    return _thresholds


def regime(name, rows, width, slices=1):
    """The regime (one of REGIMES) that one launch of kernel ``name``
    (``count_op_rows``, ``count_rows`` or ``count_and_rows``) takes over
    ``rows`` rows of [slices, width] words, as the CUDA source decides
    it (count_and_rows: at most CAR_MAX_ROWS rows a launch)."""
    if name == "count_and_rows":
        fn = loader.library("count_and_rows").pilosa_count_and_rows_regime
        fn.argtypes = [ctypes.c_longlong] * 3
        return REGIMES[fn(rows, slices, width)]
    fn = loader.library("popcount").pilosa_count_op_rows_regime
    fn.argtypes = [ctypes.c_longlong] * 2
    return REGIMES[fn(rows * slices, width)]


@_traced("count_op_rows", charge=True)
def count_op_rows(a, b, op, *, _events=None):
    """Per-row popcount(a OP b): int32[..., W] × 2 -> int32[...]."""
    if op not in OPS:
        raise ValueError(f"unknown count op: {op!r}")
    _check("count_op_rows", a, b)
    if a.device.type == "cpu":
        return count_op_rows_plain(a, b, op)
    return _launch("count_op_rows", a, b, OPS[op], _events)


@_traced("count_rows", charge=True)
def count_rows(m, *, _events=None):
    """Per-row popcount(m): int32[..., W] -> int32[...]."""
    _check("count_rows", m)
    if m.device.type == "cpu":
        return count_rows_plain(m)
    return _launch("count_rows", m, m, OP_NONE, _events)


def _pairs_kernel():
    global _pairs_fn
    if _pairs_fn is None:
        lib = loader.library("popcount")
        fn = lib.pilosa_count_op_pairs
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pilosa_count_op_pairs_max.restype = ctypes.c_int
        _pairs_fn = (fn, _kernel()[1], lib.pilosa_count_op_pairs_max())
    return _pairs_fn


def _stack_list(name, stacks):
    """The stacks as a list, each an int32 [S, W] tensor of one shape
    and device."""
    stacks = list(stacks)
    if stacks:
        if stacks[0].dim() != 2:
            raise ValueError(f"{name}: stacks must be [S, W], got "
                             f"{tuple(stacks[0].shape)}")
        _check(name, *stacks)
    return stacks


@_traced("count_op_pairs")
def count_op_pairs(a, b, op, *, _events=None):
    """Per-(pair, slice) popcount(a[k][s] OP b[k][s]): K pairs of int32
    [S, W] stacks -> int32[K, S], OP in and / or / xor / andnot, or None
    for popcount(a[k][s]) alone (``b`` ignored). One launch for up to the
    kernel's table of pairs (256 with CUDA 12.1+), pointers by value."""
    if op is not None and op not in OPS:
        raise ValueError(f"unknown count op: {op!r}")
    a = _stack_list("count_op_pairs", a)
    b = a if op is None else _stack_list("count_op_pairs", b)
    if len(a) != len(b):
        raise ValueError(f"count_op_pairs: {len(a)} left operands, "
                         f"{len(b)} right")
    if a and op is not None:
        _check("count_op_pairs", a[0], *b)
    if not a:
        return torch.empty((0, 0), dtype=torch.int32)
    dev = a[0].device
    if dev.type == "cpu":
        return count_op_pairs_plain(a, b, op)
    if dev.type != "cuda":
        raise ValueError(f"count_op_pairs: no kernel for device {dev}")
    slices, width = a[0].shape
    out = torch.empty((len(a), slices), dtype=torch.int32, device=dev)
    if slices == 0:
        return out
    fn, err_str, max_pairs = _pairs_kernel()
    code = OP_NONE if op is None else OPS[op]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0 in range(0, len(a), max_pairs):
            ta = np.asarray([t.data_ptr() for t in a[k0:k0 + max_pairs]],
                            dtype=np.uint64)
            tb = np.asarray([t.data_ptr() for t in b[k0:k0 + max_pairs]],
                            dtype=np.uint64)
            rc = _timed(_events, fn, ta.ctypes.data, tb.ctypes.data,
                        len(ta), slices, width, code,
                        out.data_ptr() + k0 * slices * 4, stream)
            if rc != 0:
                raise RuntimeError(
                    f"count_op_pairs: kernel launch failed: CUDA error {rc} "
                    f"({err_str(rc).decode()})")
            _count_launch("count_op_pairs")
    return out


def _multi_kernel():
    global _multi_fn
    if _multi_fn is None:
        lib = loader.library("count_and_rows")
        fn = lib.pilosa_count_and_rows_multi
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _multi_fn = (fn, _car_kernel()[1])
    return _multi_fn


@_traced("count_and_rows_multi")
def count_and_rows_multi(rows, filts, *, _events=None):
    """Per-(filter, row, slice) popcount(rows[r][s] & filts[k][s]): R
    and K int32 [S, W] stacks -> int32[K, R, S]. Each launch reads its
    rows and filters once for all their products; rows and filters share
    one table of CAR_MAX_ROWS pointers, chunked past it."""
    rows = _stack_list("count_and_rows_multi", rows)
    filts = _stack_list("count_and_rows_multi", filts)
    if rows and filts:
        _check("count_and_rows_multi", rows[0], *filts)
    if not filts:
        return torch.empty((0, len(rows), 0), dtype=torch.int32)
    dev = filts[0].device
    if not rows:
        return torch.empty((len(filts), 0, filts[0].shape[0]),
                           dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return count_and_rows_multi_plain(rows, filts)
    if dev.type != "cuda":
        raise ValueError(f"count_and_rows_multi: no kernel for device {dev}")
    slices, width = filts[0].shape
    n_r, n_k = len(rows), len(filts)
    out = torch.empty((n_k, n_r, slices), dtype=torch.int32, device=dev)
    if slices == 0:
        return out
    fn, err_str = _multi_kernel()
    rc_max = min(n_r, CAR_MAX_ROWS // 2)
    kc_max = CAR_MAX_ROWS - rc_max
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r0 in range(0, n_r, rc_max):
            rp = [t.data_ptr() for t in rows[r0:r0 + rc_max]]
            for k0 in range(0, n_k, kc_max):
                fp = [t.data_ptr() for t in filts[k0:k0 + kc_max]]
                table = np.asarray(rp + fp, dtype=np.uint64)
                rc = _timed(_events, fn, table.ctypes.data, len(rp),
                            len(fp), slices, width,
                            out.data_ptr() + (k0 * n_r + r0) * slices * 4,
                            n_r * slices, slices, stream)
                if rc != 0:
                    raise RuntimeError(
                        f"count_and_rows_multi: kernel launch failed: CUDA "
                        f"error {rc} ({err_str(rc).decode()})")
                _count_launch("count_and_rows_multi")
    return out


# ------------------------------------------------------ container counts

# Cell codes shared with csrc/containers.cu.
CONTAINER_CELLS = {"array_array": 0, "array_run": 1, "array_dense": 2,
                   "run_dense": 3}
# Distinct sides one launch reads on each side of its cell
# (csrc/containers.cu MAX_SIDES); the wrapper launches again past it.
CONT_MAX_SIDES = 64


def _item_members(offs):
    """(item indices, their member ids) of a packed side whose member m
    holds items [offs[m], offs[m + 1]), both int64."""
    offs = offs.to(torch.int64)
    items = torch.arange(int(offs[0]), int(offs[-1]), dtype=torch.int64,
                         device=offs.device)
    return items, torch.searchsorted(offs[1:], items, right=True)


def _dense_rows(rows, device):
    """(distinct dense rows stacked, each member's index into them): a
    lane's members often share rows, which are stacked once."""
    if torch.is_tensor(rows):
        return rows, torch.arange(rows.shape[0], device=device)
    seen, distinct, index = {}, [], []
    for r in rows:
        j = seen.setdefault((r.data_ptr(), r.shape[0]), len(distinct))
        if j == len(distinct):
            distinct.append(r)
        index.append(j)
    return (torch.stack(distinct),
            torch.tensor(index, dtype=torch.int64, device=device))


def _identity_plain(cell, a, b):
    """The plain count over one side each, member m against member m.
    The members' items are keyed by (member, value) as int64, so one
    ``searchsorted`` over a whole packed side serves every member."""
    n = a[-1].shape[0] - 1
    out = torch.zeros(n, dtype=torch.int64, device=a[0].device)
    ia, ma = _item_members(a[-1])
    if cell == "run_dense":
        rows, ridx = _dense_rows(b, out.device)
        limit = rows.shape[-1] * 32
        s = a[0].to(torch.int64)[ia].clamp(min=0)
        e = a[1].to(torch.int64)[ia].clamp(max=limit)
        first, last = s >> 5, (e - 1) >> 5
        nw = torch.where(s < e, last - first + 1, torch.zeros_like(s))
        run = torch.repeat_interleave(
            torch.arange(len(s), device=s.device), nw)
        start = torch.cumsum(nw, 0) - nw
        w = first[run] + torch.arange(len(run), device=s.device) - start[run]
        words = rows[ridx[ma[run]], w].to(torch.int64) & 0xFFFFFFFF
        mask = torch.full_like(words, 0xFFFFFFFF)
        lo = w == first[run]
        hi = w == last[run]
        mask = torch.where(lo, mask & ((0xFFFFFFFF << (s[run] & 31))
                                       & 0xFFFFFFFF), mask)
        mask = torch.where(hi, mask & (0xFFFFFFFF >> (31 - ((e[run] - 1)
                                                           & 31))), mask)
        out.index_add_(0, ma[run], popcount32(words & mask))
        return out.to(torch.int32)
    pos = a[0].to(torch.int64)[ia]
    if cell == "array_dense":
        rows, ridx = _dense_rows(b, out.device)
        ok = (pos >= 0) & (pos < rows.shape[-1] * 32)
        p = torch.where(ok, pos, torch.zeros_like(pos))
        bit = (rows[ridx[ma], p >> 5].to(torch.int64) >> (p & 31)) & 1
        out.index_add_(0, ma, torch.where(ok, bit, torch.zeros_like(bit)))
        return out.to(torch.int32)
    ib, mb = _item_members(b[-1])
    key_a = (ma << 32) + pos
    key_b = (mb << 32) + b[0].to(torch.int64)[ib]
    if cell == "array_array":
        j = torch.searchsorted(key_b, key_a)
        jc = j.clamp(max=max(len(key_b) - 1, 0))
        hit = (j < len(key_b)) & (key_b[jc] == key_a) if len(key_b) else \
            torch.zeros_like(key_a, dtype=torch.bool)
    elif cell == "array_run":
        j = torch.searchsorted(key_b, key_a, right=True) - 1
        jc = j.clamp(min=0)
        ends = b[1].to(torch.int64)[ib]
        hit = ((j >= 0) & (mb[jc] == ma) & (pos < ends[jc])
               if len(key_b) else torch.zeros_like(key_a, dtype=torch.bool))
    else:
        raise ValueError(f"unknown container cell: {cell!r}")
    out.index_add_(0, ma, hit.to(torch.int64))
    return out.to(torch.int32)


def _gather_side(sides, side_idx, mem_idx):
    """One packed side holding, in table order, the members (side_idx[k],
    mem_idx[k]) of ``sides`` (int64 index tensors): the sides' payloads
    concatenated and indexed, the offsets rebuilt."""
    dev = sides[0][0].device
    vals = [torch.cat([s[t] for s in sides]) for t in range(len(sides[0])
                                                            - 1)]
    base = torch.tensor([0] + [s[0].shape[0] for s in sides[:-1]],
                        dtype=torch.int64, device=dev).cumsum(0)
    start = torch.tensor([0] + [s[-1].shape[0] for s in sides[:-1]],
                         dtype=torch.int64, device=dev).cumsum(0)
    offs = torch.cat([s[-1].to(torch.int64) + base[i]
                      for i, s in enumerate(sides)])
    lo = offs[start[side_idx] + mem_idx]
    sizes = offs[start[side_idx] + mem_idx + 1] - lo
    new = torch.zeros(len(lo) + 1, dtype=torch.int64, device=dev)
    torch.cumsum(sizes, 0, out=new[1:])
    items = (torch.repeat_interleave(lo - new[:-1], sizes)
             + torch.arange(int(new[-1]), dtype=torch.int64, device=dev))
    return (*[v[items] for v in vals], new.to(torch.int32))


def container_and_counts_plain(cell, a, b, members=None):
    """Plain version of :func:`container_and_counts`, in both forms: the
    table's members are gathered into one side each, then counted as
    the identity form."""
    if members is None:
        return _identity_plain(cell, a, b)
    table = torch.as_tensor(members).to(a[0][0].device,
                                        torch.int64).reshape(-1, 4)
    ga = _gather_side(a, table[:, 0], table[:, 1])
    if cell.endswith("dense"):
        gb = [b[s][m] for s, m in table[:, 2:].tolist()]
    else:
        gb = _gather_side(b, table[:, 2], table[:, 3])
    return _identity_plain(cell, ga, gb)


def _cont_kernel():
    global _cont_fn
    if _cont_fn is None:
        lib = loader.library("containers")
        fn = lib.pilosa_container_and_counts
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ll, vp, ctypes.c_int, vp, ctypes.c_int,
                       vp, ll, vp, vp]
        fn.restype = ctypes.c_int
        lib.pilosa_containers_error_string.argtypes = [ctypes.c_int]
        lib.pilosa_containers_error_string.restype = ctypes.c_char_p
        _cont_fn = (fn, lib.pilosa_containers_error_string)
    return _cont_fn


_cont_thresholds = None


def container_thresholds():
    """csrc/containers.cu's thresholds, read once from the built library:
    ``block_min_ints`` (the kernel gives a member of more staged ints —
    positions, plus run starts and ends — a block, a lighter one a
    warp), ``block_all_max_n`` (a launch of at most this many members
    gives each a block), ``max_sides``."""
    global _cont_thresholds
    if _cont_thresholds is None:
        keys = ("block_min_ints", "block_all_max_n", "max_sides")
        vals = (ctypes.c_longlong * len(keys))()
        loader.library("containers").pilosa_containers_thresholds(vals)
        _cont_thresholds = dict(zip(keys, map(int, vals)))
    return _cont_thresholds


def _check_side(name, side, dev):
    """A packed array side (vals, offs) or run side (starts, ends, offs):
    1-D contiguous int32 on ``dev``. Returns its member count."""
    for t in side:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: payloads and offsets must be 1-D "
                            f"int32, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: device mismatch {dev} vs {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: payloads must be contiguous")
    if len(side) == 3 and side[0].shape != side[1].shape:
        raise ValueError(f"{name}: {side[0].shape[0]} run starts, "
                         f"{side[1].shape[0]} ends")
    return side[-1].shape[0] - 1


def _side_rows(rows):
    """(rows, width) of a dense side: one [R, W] tensor or R [W]
    tensors."""
    if torch.is_tensor(rows):
        return rows.shape[0], rows.shape[-1]
    return len(rows), (rows[0].shape[-1] if len(rows) else 1)


def _check_rows(rows, dev):
    """A dense side: int32 rows of one width on ``dev``, one [R, W]
    tensor or a list of [W] tensors. Returns (R, W)."""
    one = rows if torch.is_tensor(rows) else rows[0] if rows else None
    count, width = _side_rows(rows)
    if one is None:
        return count, width
    if one.dim() != (2 if torch.is_tensor(rows) else 1):
        raise ValueError("container_and_counts: dense rows must be [N, W] "
                         f"or N of [W], got {tuple(one.shape)}")
    _check("container_and_counts", *([rows] if torch.is_tensor(rows)
                                     else rows))
    if one.device != dev:
        raise ValueError("container_and_counts: dense rows on another "
                         "device")
    return count, width


def _side_ptrs(side, dense, dev, keep):
    """The 3 device addresses csrc/containers.cu takes for a side; a
    dense side of several separate rows uploads its table of row
    pointers (kept alive in ``keep``)."""
    if not dense:
        vals, offs = side[0], side[-1]
        ends = side[1] if len(side) == 3 else None
        return (vals.data_ptr(), 0 if ends is None else ends.data_ptr(),
                offs.data_ptr())
    if torch.is_tensor(side):
        return side.data_ptr(), 0, 0
    if len(side) == 1:
        return side[0].data_ptr(), 0, 0
    ptrs = np.asarray([r.data_ptr() for r in side], dtype=np.uint64)
    table = torch.from_numpy(ptrs.view(np.int64)).to(dev)
    keep.append(table)
    return 0, table.data_ptr(), 0


def _launch_cont(cell, a, b, table, n, width, out, events=None):
    """One launch over at most CONT_MAX_SIDES sides a side; ``table`` is a
    device int32 [n, 4] tensor or None (the identity)."""
    fn, err_str = _cont_kernel()
    dev = out.device
    dense = cell.endswith("dense")
    keep = []
    pa = np.asarray([_side_ptrs(s, False, dev, keep) for s in a],
                    dtype=np.uint64)
    pb = np.asarray([_side_ptrs(s, dense, dev, keep) for s in b],
                    dtype=np.uint64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _timed(events, fn, CONTAINER_CELLS[cell], n, pa.ctypes.data,
                    len(a), pb.ctypes.data, len(b),
                    0 if table is None else table.data_ptr(), width,
                    out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"container_and_counts: kernel launch failed: "
                           f"CUDA error {rc} ({err_str(rc).decode()})")
    _count_launch("container_and_counts",
                  form="serial" if table is None else "lane")


def _launch_split(cell, a, b, host, width, out, events=None):
    """Launches past CONT_MAX_SIDES sides: the table's rows grouped by
    the chunks of sides they read, each group one launch over its chunks
    with rebased side indices, the counts put back in table order."""
    dev = out.device
    m = CONT_MAX_SIDES
    key = (host[:, 0] // m).astype(np.int64) * (len(b) // m + 1) + \
        host[:, 2] // m
    order = np.argsort(key, kind="stable")
    bounds = np.flatnonzero(np.diff(key[order])) + 1
    tmp = torch.empty(len(host), dtype=torch.int32, device=dev)
    for lo, hi in zip(np.concatenate(([0], bounds)),
                      np.concatenate((bounds, [len(host)]))):
        rows = host[order[lo:hi]].copy()
        ca, cb = rows[0, 0] // m, rows[0, 2] // m
        rows[:, 0] -= ca * m
        rows[:, 2] -= cb * m
        sub = torch.from_numpy(rows).to(dev)
        _launch_cont(cell, a[ca * m:(ca + 1) * m], b[cb * m:(cb + 1) * m],
                     sub, hi - lo, width, tmp[lo:hi], events)
    out[torch.from_numpy(order).to(dev)] = tmp


@_traced("container_and_counts")
def container_and_counts(cell, a, b, members=None, *, _events=None):
    """Per-member |a ∩ b| of N compressed row blocks in one launch ->
    int32[N]. ``cell`` is ``array_array``, ``array_run``,
    ``array_dense`` or ``run_dense``. A side is an array side
    (positions, offsets), a run side (starts, ends, offsets) — its
    members' sorted int32 payloads concatenated, member m's at
    [offsets[m], offsets[m + 1]) — or a dense side of rows, one [R, W]
    tensor or a list of R int32[W] tensors.

    Without ``members`` (the identity form), ``a`` and ``b`` are one side
    each and member m of a meets member m of b. With ``members``, an
    int32 [N, 4] table of (a side, a member, b side, b member) rows, ``a``
    and ``b`` are lists of sides, read in place: the lanes' RowLanes are
    never repacked. A table on the host is checked and uploaded; one
    already on the card is taken as is. How the kernel spreads the
    members over the card (a warp or a block each) is its own choice."""
    if cell not in CONTAINER_CELLS:
        raise ValueError(f"unknown container cell: {cell!r}")
    dense = cell.endswith("dense")
    want_a = 3 if cell == "run_dense" else 2
    want_b = {"array_array": 2, "array_run": 3}.get(cell)
    name = "container_and_counts"
    if members is None:
        sides_a, sides_b = [a], [b if torch.is_tensor(b) or not dense
                                 else list(b)]
    else:
        sides_a, sides_b = list(a), list(b)
        if not sides_a or not sides_b:
            raise ValueError(f"{name}: a table form needs a side on each "
                             "side")
    for s in sides_a:
        if len(s) != want_a:
            raise ValueError(f"{name}: {cell} takes a side of {want_a} "
                             f"tensors, got {len(s)}")
    dev = sides_a[0][0].device
    sizes_a = [_check_side(name, s, dev) for s in sides_a]
    if dense:
        sizes_b = [_check_rows(r, dev)[0] for r in sides_b]
        width = _side_rows(sides_b[0])[1]
        if any(_side_rows(r)[1] != width for r in sides_b):
            raise ValueError(f"{name}: dense rows of different widths")
    else:
        for s in sides_b:
            if len(s) != want_b:
                raise ValueError(f"{name}: {cell}'s right side has "
                                 f"{len(s)} tensors")
        sizes_b = [_check_side(name, s, dev) for s in sides_b]
        width = 1
    table, host = None, None
    if members is None:
        n = sizes_a[0]
        if sizes_b[0] != n:
            what = "dense rows" if dense else "on the other"
            raise ValueError(f"{name}: {n} members on one side, "
                             f"{sizes_b[0]} {what}")
    else:
        table = torch.as_tensor(members).contiguous()
        if (table.dtype != torch.int32 or table.dim() != 2
                or table.shape[1] != 4):
            raise TypeError(f"{name}: members must be int32 [N, 4], got "
                            f"{table.dtype} {tuple(table.shape)}")
        n = table.shape[0]
        if table.device.type == "cpu":
            host = table.numpy()
            for col, sizes in ((0, sizes_a), (2, sizes_b)):
                if n and (host[:, col].min() < 0
                          or host[:, col].max() >= len(sizes)):
                    raise ValueError(f"{name}: a side index out of range")
                if n and ((host[:, col + 1] < 0).any() or (
                        host[:, col + 1] >= np.asarray(sizes)[
                            host[:, col]]).any()):
                    raise ValueError(f"{name}: a member index out of "
                                     "range")
        elif table.device != dev:
            raise ValueError(f"{name}: members on {table.device}, sides on "
                             f"{dev}")
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return container_and_counts_plain(cell, a, b, members)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if len(sides_a) <= CONT_MAX_SIDES and len(sides_b) <= CONT_MAX_SIDES:
        if host is not None:
            table = table.to(dev)
        _launch_cont(cell, sides_a, sides_b, table, n, width, out, _events)
    else:
        if host is None:
            host = table.cpu().numpy()
        _launch_split(cell, sides_a, sides_b, host, width, out, _events)
    return out


# ------------------------------------------------------------------ ingest

def ingest_classify_plain(rowidx, positions, n_rows):
    """Plain version of :func:`ingest_classify`: two bincounts and one
    adjacency compare (pilosa_tpu ops/ingest.py classify_stats_host)."""
    rows = rowidx.long()
    counts = torch.bincount(rows, minlength=n_rows)[:n_rows]
    start = torch.ones(len(rows), dtype=torch.bool, device=rows.device)
    if len(rows) > 1:
        start[1:] = ~((rows[1:] == rows[:-1])
                      & (positions[1:] == positions[:-1] + 1))
    runs = torch.bincount(rows[start], minlength=n_rows)[:n_rows]
    return counts.to(torch.int32), runs.to(torch.int32)


def _ingest_kernel():
    global _ingest_fn
    if _ingest_fn is None:
        lib = loader.library("ingest")
        fn = lib.pilosa_ingest_classify
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pilosa_ingest_error_string.argtypes = [ctypes.c_int]
        lib.pilosa_ingest_error_string.restype = ctypes.c_char_p
        _ingest_fn = (fn, lib.pilosa_ingest_error_string)
    return _ingest_fn


@_traced("ingest_classify")
def ingest_classify(rowidx, positions, n_rows, *, _events=None):
    """Per-row (counts, run starts), int32[n_rows] each, of a stream
    sorted by (row, position) and deduplicated: ``rowidx`` int32[nnz] in
    0..n_rows-1, ``positions`` int32[nnz]. An entry starts a run when it
    is its row's first or its position is not the previous one plus
    one."""
    name = "ingest_classify"
    for t in (rowidx, positions):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: rowidx and positions must be int32 "
                            f"[nnz], got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if rowidx.shape != positions.shape or rowidx.device != positions.device:
        raise ValueError(f"{name}: rowidx {tuple(rowidx.shape)} on "
                         f"{rowidx.device}, positions "
                         f"{tuple(positions.shape)} on {positions.device}")
    n_rows = int(n_rows)
    if n_rows < 0 or n_rows >= 1 << 31:
        raise ValueError(f"{name}: n_rows {n_rows} out of range")
    dev = rowidx.device
    if dev.type == "cpu":
        return ingest_classify_plain(rowidx, positions, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    both = torch.zeros(2, n_rows, dtype=torch.int32, device=dev)
    if len(rowidx) and n_rows:
        fn, err_str = _ingest_kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _timed(_events, fn, rowidx.data_ptr(), positions.data_ptr(),
                        len(rowidx), n_rows, both[0].data_ptr(),
                        both[1].data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                               f"{rc} ({err_str(rc).decode()})")
        _count_launch(name)
    return both[0], both[1]
