"""Count kernels: the CUDA launches and their plain PyTorch versions.

Both kernels are instances of one CUDA template in ``csrc/popcount.cu``
(see its header for what each replaces in pilosa_tpu, its bound and its
design):

- :func:`count_op_rows` — per-row popcount(a OP b), OP in and / or /
  xor / andnot; ports the Pallas ``count_and`` and serves every
  two-operand Count.
- :func:`count_rows` — per-row popcount(m); ports the Pallas
  ``count_rows`` without its all-ones filter read.

Words are ``int32`` views of the 32-bit device words, shape
``[..., W]``; results are ``int32[...]``. A wrapper takes the plain
version ONLY for tensors on the CPU. For a CUDA tensor it launches the
kernel or raises — there is no fallback. ``launches`` counts kernel
launches per wrapper.
"""
import ctypes
import math

import torch

from pilosa_tpu_torch.ops import loader

# Op codes shared with csrc/popcount.cu.
OP_NONE = 0
OPS = {"and": 1, "or": 2, "xor": 3, "andnot": 4}

# Per-row counts are int32: a row of W words holds 32·W bits.
MAX_WIDTH = (1 << 26) - 1

launches = {"count_op_rows": 0, "count_rows": 0}

_fn = None


def reset_launches():
    for name in launches:
        launches[name] = 0


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
    launches[name] += 1
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
