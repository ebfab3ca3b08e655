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
  members packed into one launch; replaces the count cells of the
  compressed container tier and their lane twins
  (``csrc/containers.cu``).

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
"""
import ctypes
import math
import threading

import numpy as np
import torch

from pilosa_tpu_torch.ops import loader

# Op codes shared with csrc/popcount.cu.
OP_NONE = 0
OPS = {"and": 1, "or": 2, "xor": 3, "andnot": 4}

# Per-row counts are int32: a row of W words holds 32·W bits.
MAX_WIDTH = (1 << 26) - 1

launches = {"count_op_rows": 0, "count_rows": 0, "count_and_rows": 0,
            "count_op_pairs": 0, "count_and_rows_multi": 0,
            "container_and_counts": 0}
# The kernels' regime codes (REGIME_* in the CUDA sources), by value.
REGIMES = ("full", "narrow", "split")
regime_launches = {name: dict.fromkeys(REGIMES, 0)
                   for name in ("count_op_rows", "count_rows",
                                "count_and_rows")}
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


def reset_launches():
    with _launches_mu:
        for name in launches:
            launches[name] = 0
        for split in regime_launches.values():
            for regime in split:
                split[regime] = 0


def _count_launch(name, regime=None):
    with _launches_mu:
        launches[name] += 1
        if regime is not None:
            regime_launches[name][REGIMES[regime]] += 1


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


def _launch(name, a, b, op):
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
        rc = fn(a.data_ptr(), b.data_ptr(), rows, a.shape[-1], op,
                out.data_ptr(), stream, ctypes.byref(regime))
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


def _launch_and_rows(ptrs, filt, slices, width, out):
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
            rc = fn(table.ctypes.data, len(table), filt.data_ptr(), slices,
                    width, out.data_ptr() + r0 * slices * 4, slices, stream,
                    ctypes.byref(regime))
            if rc != 0:
                raise RuntimeError(
                    f"count_and_rows: kernel launch failed: CUDA error "
                    f"{rc} ({err_str(rc).decode()})")
            _count_launch("count_and_rows", regime.value)


def count_and_rows(m, filt):
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
            rc = fn(m.data_ptr(), max(width, 1), rows, filt.data_ptr(), 1,
                    width, out.data_ptr(), 1, stream, ctypes.byref(regime))
        if rc != 0:
            raise RuntimeError(f"count_and_rows: kernel launch failed: CUDA "
                               f"error {rc} ({err_str(rc).decode()})")
        _count_launch("count_and_rows", regime.value)
    return out


def count_and_rows_stacks(rows, filt):
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
                         out)
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


def count_op_rows(a, b, op):
    """Per-row popcount(a OP b): int32[..., W] × 2 -> int32[...]."""
    if op not in OPS:
        raise ValueError(f"unknown count op: {op!r}")
    _check("count_op_rows", a, b)
    if a.device.type == "cpu":
        return count_op_rows_plain(a, b, op)
    return _launch("count_op_rows", a, b, OPS[op])


def count_rows(m):
    """Per-row popcount(m): int32[..., W] -> int32[...]."""
    _check("count_rows", m)
    if m.device.type == "cpu":
        return count_rows_plain(m)
    return _launch("count_rows", m, m, OP_NONE)


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


def count_op_pairs(a, b, op):
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
            rc = fn(ta.ctypes.data, tb.ctypes.data, len(ta), slices, width,
                    code, out.data_ptr() + k0 * slices * 4, stream)
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


def count_and_rows_multi(rows, filts):
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
                rc = fn(table.ctypes.data, len(rp), len(fp), slices, width,
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
# Blocks a launch gives the card at the least (two per SM), spread over
# few members; csrc/containers.cu takes up to 65,535 per member.
_CONT_MIN_BLOCKS = 2 * 132
_CONT_MAX_BLOCKS_PER_MEMBER = 64


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


def container_and_counts_plain(cell, a, b):
    """Plain version of :func:`container_and_counts`. The members'
    items are keyed by (member, value) as int64, so one
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


def _cont_kernel():
    global _cont_fn
    if _cont_fn is None:
        lib = loader.library("containers")
        fn = lib.pilosa_container_and_counts
        fn.argtypes = [ctypes.c_int, ctypes.c_longlong] + \
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pilosa_containers_error_string.argtypes = [ctypes.c_int]
        lib.pilosa_containers_error_string.restype = ctypes.c_char_p
        _cont_fn = (fn, lib.pilosa_containers_error_string)
    return _cont_fn


def _check_side(name, side, n, dev):
    """A packed array side (vals, offs) or run side (starts, ends, offs):
    1-D contiguous int32 on ``dev``, offsets of n + 1 members."""
    for t in side:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: payloads and offsets must be 1-D "
                            f"int32, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: device mismatch {dev} vs {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: payloads must be contiguous")
    if side[-1].shape[0] != n + 1:
        raise ValueError(f"{name}: {side[-1].shape[0] - 1} members on one "
                         f"side, {n} on the other")
    if len(side) == 3 and side[0].shape != side[1].shape:
        raise ValueError(f"{name}: {side[0].shape[0]} run starts, "
                         f"{side[1].shape[0]} ends")


def _check_rows(rows, n, dev):
    """A dense side: n int32 rows of one width on ``dev``, one [n, W]
    tensor or a list of [W] tensors. Returns W."""
    one = rows if torch.is_tensor(rows) else rows[0] if rows else None
    count = rows.shape[0] if torch.is_tensor(rows) else len(rows)
    if count != n:
        raise ValueError(f"container_and_counts: {n} members, {count} "
                         "dense rows")
    if one is None:
        return 1
    if one.dim() != (2 if torch.is_tensor(rows) else 1):
        raise ValueError("container_and_counts: dense rows must be [N, W] "
                         f"or N of [W], got {tuple(one.shape)}")
    _check("container_and_counts", *([rows] if torch.is_tensor(rows)
                                     else rows))
    if one.device != dev:
        raise ValueError("container_and_counts: dense rows on another "
                         "device")
    return one.shape[-1]


def container_and_counts(cell, a, b):
    """Per-member |a ∩ b| of N compressed row blocks in one launch ->
    int32[N]. ``cell`` is ``array_array``, ``array_run``,
    ``array_dense`` or ``run_dense``; an array side is (positions,
    offsets), a run side (starts, ends, offsets) — the members' sorted
    int32 payloads concatenated, member m's at [offsets[m], offsets[m +
    1]) — and a dense side N int32[W] rows, a list or one [N, W]
    tensor."""
    if cell not in CONTAINER_CELLS:
        raise ValueError(f"unknown container cell: {cell!r}")
    want_a = 3 if cell == "run_dense" else 2
    if len(a) != want_a:
        raise ValueError(f"container_and_counts: {cell} takes a side of "
                         f"{want_a} tensors, got {len(a)}")
    n = a[-1].shape[0] - 1
    dev = a[0].device
    _check_side("container_and_counts", a, n, dev)
    if cell.endswith("dense"):
        rows = b if torch.is_tensor(b) else list(b)
        row_width = _check_rows(rows, n, dev)
    else:
        if len(b) != (2 if cell == "array_array" else 3):
            raise ValueError(f"container_and_counts: {cell}'s right side "
                             f"has {len(b)} tensors")
        _check_side("container_and_counts", b, n, dev)
        row_width = 1
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return container_and_counts_plain(cell, a, b)
    if dev.type != "cuda":
        raise ValueError(f"container_and_counts: no kernel for device {dev}")
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    fn, err_str = _cont_kernel()
    a_vals, a_offs = a[0], a[-1]
    a_ends = a[1] if cell == "run_dense" else a[0]
    b_vals = b_ends = b_offs = a_offs
    base, table = 0, None
    if cell.endswith("dense"):
        if torch.is_tensor(rows):
            base = rows.data_ptr()
        elif len(rows) == 1:
            base = rows[0].data_ptr()
        else:
            ptrs = np.asarray([r.data_ptr() for r in rows], dtype=np.uint64)
            table = torch.from_numpy(ptrs.view(np.int64)).to(dev)
    else:
        b_vals, b_offs = b[0], b[-1]
        b_ends = b[1] if cell == "array_run" else b[0]
    per = max(1, min(_CONT_MAX_BLOCKS_PER_MEMBER,
                     -(-_CONT_MIN_BLOCKS // n)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(CONTAINER_CELLS[cell], n, a_vals.data_ptr(),
                a_ends.data_ptr(), a_offs.data_ptr(), b_vals.data_ptr(),
                b_ends.data_ptr(), b_offs.data_ptr(), base,
                0 if table is None else table.data_ptr(), row_width, per,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"container_and_counts: kernel launch failed: "
                           f"CUDA error {rc} ({err_str(rc).decode()})")
    _count_launch("container_and_counts")
    return out
