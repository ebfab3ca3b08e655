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

Words are ``int32`` views of the 32-bit device words, shape
``[..., W]``; results are ``int32[...]``. A wrapper takes the plain
version ONLY for tensors on the CPU. For a CUDA tensor it launches the
kernel or raises — there is no fallback. ``launches`` counts kernel
launches per wrapper.
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

launches = {"count_op_rows": 0, "count_rows": 0, "count_and_rows": 0}
# Server threads launch concurrently; a count is a read-modify-write.
_launches_mu = threading.Lock()

# Row pointers per count_and_rows launch (the kernel's parameter table;
# csrc/count_and_rows.cu MAX_ROWS).
CAR_MAX_ROWS = 256

_fn = None
_car_fn = None
_car_strided_fn = None


def reset_launches():
    with _launches_mu:
        for name in launches:
            launches[name] = 0


def _count_launch(name):
    with _launches_mu:
        launches[name] += 1


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
                       ctypes.c_void_p]
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
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), rows, a.shape[-1], op,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} "
                           f"({err_str(rc).decode()})")
    _count_launch(name)
    return out


def _car_kernel():
    global _car_fn
    if _car_fn is None:
        lib = loader.library("count_and_rows")
        fn = lib.pilosa_count_and_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
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
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
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
    with torch.cuda.device(filt.device):
        stream = torch.cuda.current_stream(filt.device).cuda_stream
        for r0 in range(0, len(ptrs), CAR_MAX_ROWS):
            table = np.asarray(ptrs[r0:r0 + CAR_MAX_ROWS], dtype=np.uint64)
            rc = fn(table.ctypes.data, len(table), filt.data_ptr(), slices,
                    width, out.data_ptr() + r0 * slices * 4, slices, stream)
            if rc != 0:
                raise RuntimeError(
                    f"count_and_rows: kernel launch failed: CUDA error "
                    f"{rc} ({err_str(rc).decode()})")
            _count_launch("count_and_rows")


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
        with torch.cuda.device(filt.device):
            stream = torch.cuda.current_stream(filt.device).cuda_stream
            rc = fn(m.data_ptr(), max(width, 1), rows, filt.data_ptr(), 1,
                    width, out.data_ptr(), 1, stream)
        if rc != 0:
            raise RuntimeError(f"count_and_rows: kernel launch failed: CUDA "
                               f"error {rc} ({err_str(rc).decode()})")
        _count_launch("count_and_rows")
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
