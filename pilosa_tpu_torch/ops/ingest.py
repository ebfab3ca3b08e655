"""Ingest cells: the classify pass, the format thresholds and the
container builders of the bulk-ingest pipeline (counterpart of
pilosa_tpu/ops/ingest.py).

The pipeline (ingest/pipeline.py) reaches these through the ``bitops``
ingest registry:

- ``classify`` — per-row cardinality and run starts of one (view, slice)
  batch, sorted by (row, position) and deduplicated, in the position
  domain: no words matrix. On a ``cuda`` holder it is the hand kernel
  ``kernels.ingest_classify`` (``csrc/ingest.cu``); on a ``cpu`` holder
  its plain version. The holder's ``device`` picks it, not a probe of
  the backend: ``classify`` is ``classify.device``, which takes the
  device; ``classify.host`` is the plain version.
- ``build.<fmt>`` — one classified row's sorted positions to its
  ``containers.Container``: ARRAY and RUN from the batch's positions, no
  dense host intermediate; DENSE returns None (such rows serve from the
  fragment's device mirror).
- ``pack_classify`` — the reference's fused scatter/pack/classify pass,
  in plain PyTorch. Nothing in the ingest path of either package launches
  it (pilosa_tpu ingest/pipeline.py:26-28); it stays registered for
  consumers that want the packed rows.
"""
import numpy as np
import torch

from pilosa_tpu_torch.ops import bitops, containers, kernels


def pack_classify(rowidx, positions, n_rows, width32, device="cuda"):
    """One scatter/pack/classify pass over a slice batch (ref: pilosa_tpu
    ops/ingest.py:95). ``rowidx`` (int32[nnz]) maps each position to its
    0..n_rows-1 row; ``positions`` (int32[nnz]) are window-relative bit
    positions. The pairs MUST be deduplicated: the scatter adds masks,
    which equals OR only for distinct bits. Returns ``(words, counts,
    n_runs)``: int32[n_rows, width32] words on ``device`` (the bytes of
    the reference's uint32 words) and two host int32[n_rows] vectors."""
    dev = torch.device(device)
    ridx = torch.as_tensor(np.asarray(rowidx, dtype=np.int64), device=dev)
    pos = torch.as_tensor(np.asarray(positions, dtype=np.int64), device=dev)
    # 1 << 31 lands as the int32 pattern 0x80000000 (-2^31).
    masks = torch.bitwise_left_shift(
        torch.ones_like(pos), pos & 31).to(torch.int32)
    words = torch.zeros((n_rows, width32), dtype=torch.int32, device=dev)
    words.index_put_((ridx, pos >> 5), masks, accumulate=True)
    counts = kernels.popcount32(words).sum(dim=-1, dtype=torch.int32)
    # Run starts: bit p set with bit p-1 clear; bit 0 of word w consults
    # bit 31 of word w-1. ``>>`` on int32 is arithmetic: mask the carry.
    carry = torch.zeros_like(words)
    carry[:, 1:] = (words[:, :-1] >> 31) & 1
    starts = words & ~((words << 1) | carry)
    n_runs = kernels.popcount32(starts).sum(dim=-1, dtype=torch.int32)
    return words, counts.cpu().numpy(), n_runs.cpu().numpy()


def classify_stats_device(rowidx, positions, n_rows, device="cuda"):
    """(counts, n_runs) per row, host int32[n_rows] each, from one
    ``kernels.ingest_classify`` pass over the stream on ``device`` (the
    kernel on a CUDA device, its plain version on the CPU)."""
    dev = torch.device(device)
    ridx = torch.from_numpy(np.ascontiguousarray(rowidx, dtype=np.int32))
    pos = torch.from_numpy(np.ascontiguousarray(positions, dtype=np.int32))
    counts, runs = kernels.ingest_classify(ridx.to(dev), pos.to(dev),
                                           n_rows)
    return counts.cpu().numpy(), runs.cpu().numpy()


def classify_stats_host(rowidx, positions, n_rows):
    """The same stats through the kernel's plain version on the CPU."""
    return classify_stats_device(rowidx, positions, n_rows, device="cpu")


def classify_formats(counts, n_runs):
    """Vectorized roaring thresholds over a batch, element for element
    ``containers.choose_format``: run when two ints a run undercut both
    encodings, else array at <= 4,096 bits, else dense; empty rows are
    array (ref: pilosa_tpu ops/ingest.py:215)."""
    counts = np.asarray(counts, dtype=np.int64)
    n_runs = np.asarray(n_runs, dtype=np.int64)
    run_ok = ((n_runs <= containers.RUN_MAX_RUNS)
              & (2 * n_runs < np.minimum(counts,
                                         containers.ARRAY_MAX_BITS + 1)))
    array_ok = counts <= containers.ARRAY_MAX_BITS
    out = np.where(run_ok, bitops.FMT_RUN,
                   np.where(array_ok, bitops.FMT_ARRAY, bitops.FMT_DENSE))
    return np.where(counts == 0, bitops.FMT_ARRAY, out)


# ------------------------------------------------------- build cells
# One classified row's sorted (deduplicated) positions -> its Container
# at full slice width, in slice bit coordinates: the shape
# Fragment.row_container serves.

def _build_array(positions, width32, device="cuda"):
    return containers.Container(
        bitops.FMT_ARRAY, width32, len(positions),
        positions=np.ascontiguousarray(positions, dtype=np.int32),
        device=device)


def _build_run(positions, width32, device="cuda"):
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    brk = np.flatnonzero(np.diff(pos) != 1)
    starts = pos[np.concatenate(([0], brk + 1))]
    ends = pos[np.concatenate((brk, [len(pos) - 1]))] + 1
    runs = np.stack([starts, ends], axis=1).astype(np.int32)
    return containers.Container(bitops.FMT_RUN, width32, len(pos),
                                runs=runs, device=device)


def _build_dense(positions, width32, device="cuda"):
    """Dense rows serve from the fragment's device mirror: None seeds the
    format memo only."""
    return None


def _register():
    bitops.register_ingest_kernel("pack_classify", pack_classify)
    bitops.register_ingest_kernel("classify.device", classify_stats_device)
    bitops.register_ingest_kernel("classify.host", classify_stats_host)
    # The holder's device picks the kernel (cuda) or its plain version.
    bitops.register_ingest_kernel("classify", classify_stats_device)
    bitops.register_ingest_kernel("build." + bitops.FMT_ARRAY, _build_array)
    bitops.register_ingest_kernel("build." + bitops.FMT_RUN, _build_run)
    bitops.register_ingest_kernel("build." + bitops.FMT_DENSE, _build_dense)


_register()
