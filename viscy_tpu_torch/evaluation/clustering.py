"""Representation metrics (counterpart of ``viscy_tpu/evaluation/clustering.py``;
only ``effective_rank`` so far)."""

from __future__ import annotations

import numpy as np


def effective_rank(embeddings: np.ndarray, eps: float = 1e-12) -> float:
    """Effective rank: the exponential of the entropy of the centred
    embedding matrix's normalized singular values (float64)."""
    x = np.asarray(embeddings, np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    s = np.linalg.svd(x, compute_uv=False)
    p = s / (s.sum() + eps)
    p = p[p > eps]
    return float(np.exp(-(p * np.log(p)).sum()))
