"""Variance and correlation pruning of the CP feature columns (counterpart
of ``viscy_tpu/apps/dynacell/eval/feature_select.py``, pycytominer's
BSD-3 rules): drop near-constant columns, then greedily drop one column of
every highly correlated pair. numpy float64 on the host, bit-identical to
JAX (the keep mask is a discrete decision, and the columns are few).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "DEFAULT_FREQ_CUT",
    "DEFAULT_UNIQUE_CUT",
    "DEFAULT_CORR_THRESHOLD",
    "variance_threshold",
    "correlation_threshold",
    "select_features",
]

DEFAULT_FREQ_CUT = 0.05
DEFAULT_UNIQUE_CUT = 0.01
DEFAULT_CORR_THRESHOLD = 0.9


def variance_threshold(
    X_pooled: np.ndarray,
    freq_cut: float = DEFAULT_FREQ_CUT,
    unique_cut: float = DEFAULT_UNIQUE_CUT,
) -> np.ndarray:
    """Keep-mask dropping near-constant columns.

    A column drops iff its second-most-common/most-common value-count
    ratio is below ``freq_cut`` (single-valued columns define the ratio
    as 0 and always drop) OR its unique-value fraction is below
    ``unique_cut``.
    """
    n_samples, n_features = X_pooled.shape
    keep = np.ones(n_features, bool)
    for j in range(n_features):
        _, counts = np.unique(X_pooled[:, j], return_counts=True)
        top = np.sort(counts)[::-1]
        freq_ratio = 0.0 if top.size == 1 else top[1] / top[0]
        uniqueness = top.size / n_samples
        if freq_ratio < freq_cut or uniqueness < unique_cut:
            keep[j] = False
    return keep


def correlation_threshold(
    X_pooled: np.ndarray,
    threshold: float = DEFAULT_CORR_THRESHOLD,
    method: str = "pearson",
) -> np.ndarray:
    """Greedy iterative drop of correlated columns.

    Walk every pair with ``|corr| > threshold`` in descending order; for
    each surviving pair drop the member with the larger total |corr| to
    the remaining columns (ties -> higher index). NaN correlations count
    as 0.
    """
    if method != "pearson":
        raise ValueError(f"Only method='pearson' is supported, got {method!r}.")
    n_features = X_pooled.shape[1]
    if n_features == 0:
        return np.ones(0, bool)
    corr = np.atleast_2d(np.abs(np.nan_to_num(np.corrcoef(X_pooled, rowvar=False), nan=0.0)))
    np.fill_diagonal(corr, 0.0)
    iu, ju = np.triu_indices(n_features, k=1)
    sel = corr[iu, ju] > threshold
    order = np.argsort(-corr[iu, ju][sel], kind="stable")
    pairs = list(zip(iu[sel][order], ju[sel][order]))
    keep = np.ones(n_features, bool)
    for i, j in pairs:
        if not keep[i] or not keep[j]:
            continue
        surv_i = keep.copy()
        surv_i[i] = False
        surv_j = keep.copy()
        surv_j[j] = False
        sum_i = corr[i, surv_i].sum()
        sum_j = corr[j, surv_j].sum()
        if np.isclose(sum_i, sum_j, rtol=1e-5, atol=1e-8):
            drop = max(i, j)
        else:
            drop = i if sum_i > sum_j else j
        keep[drop] = False
    return keep


def select_features(
    gt: np.ndarray,
    pred: np.ndarray,
    freq_cut: float = DEFAULT_FREQ_CUT,
    unique_cut: float = DEFAULT_UNIQUE_CUT,
    corr_threshold: float = DEFAULT_CORR_THRESHOLD,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pool (gt, pred), run variance then correlation pruning, return
    ``(gt_filtered, pred_filtered, keep_mask)``."""
    if gt.shape[1] != pred.shape[1]:
        raise ValueError(f"feature dim mismatch: {gt.shape[1]} vs {pred.shape[1]}")
    n_features = gt.shape[1]
    pooled = np.vstack([gt, pred]).astype(np.float64)
    mask_var = variance_threshold(pooled, freq_cut, unique_cut)
    mask_corr = correlation_threshold(pooled[:, mask_var], corr_threshold)
    keep = np.zeros(n_features, bool)
    keep[np.flatnonzero(mask_var)[mask_corr]] = True
    return gt[:, keep], pred[:, keep], keep
