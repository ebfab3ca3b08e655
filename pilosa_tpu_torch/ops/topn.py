"""TopN scoring (counterpart of pilosa_tpu/ops/topn.py).

Tanimoto similarity ×100 from popcount triples, in float32 with the
reference's order of operations, so both packages keep and drop the
same rows at the ``ceil(score) > threshold`` gate (ref:
fragment.go:850-858, 908-918). The per-row counts themselves come from
the ``count_and_rows`` and ``count_rows`` kernels.
"""
import numpy as np
import torch

from pilosa_tpu_torch.ops import bitops


def tanimoto_score_counts(inter, row_n, src_n):
    """100·|A∩B| / (|A|+|B|−|A∩B|) as float32, 0 where the denominator
    is 0. ``inter`` and ``row_n`` are int32 tensors; ``src_n`` an int32
    tensor that broadcasts against them, or an int."""
    denom = row_n + src_n - inter
    score = 100.0 * inter.to(torch.float32) / denom.to(torch.float32)
    return torch.where(denom > 0, score, 0.0)


def tanimoto_masked_counts(matrix, src, row_n, src_n, threshold):
    """Per-fragment Tanimoto path: |row ∩ src| for every row of
    ``matrix`` (int32[R, W]) against ``src`` (int32[W]), zeroed where
    ``ceil(score) <= threshold``; the gate runs on the device, so the
    host fetches one int32[R]."""
    inter = bitops.count_and_rows(matrix, src)
    scores = tanimoto_score_counts(inter, row_n, src_n)
    keep = torch.ceil(scores) > threshold
    return torch.where(keep, inter, 0)


def tanimoto_keep(scores, threshold):
    """Host-side gate on float32 scores: keep rows whose ceil(score) is
    STRICTLY greater than the threshold."""
    return np.ceil(np.asarray(scores)) > threshold
