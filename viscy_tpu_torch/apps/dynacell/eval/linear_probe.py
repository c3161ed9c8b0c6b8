"""FOV-grouped linear probes of per-cell embeddings (counterpart of
``viscy_tpu/apps/dynacell/eval/linear_probe.py``): MAD scaling and a
class-balanced logistic regression under a group k-fold whose groups are
FOVs, so no validation FOV leaks into training. ``indistinguishability``
maps AUROC 0.5 to 1 (real and predicted cells cannot be told apart) and 0
or 1 to 0.

Without sklearn: the folds are ``GroupKFold(n_splits)``'s (no shuffle: the
largest groups first, each to the lightest fold), the AUROC is
``roc_auc_score``'s (the trapezoid under the ROC of the distinct
thresholds), and the probe is
:func:`viscy_tpu_torch.evaluation.linear_classifier.fit_logistic_regression`
(sklearn's objective, L-BFGS in float64 on the device). sklearn stops at
``tol = 1e-4``; at a tight tolerance on both sides the AUROCs agree within
1e-3.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from viscy_tpu_torch.apps.dynacell.eval._ops import host, on, resolve_device

__all__ = ["PROBE_TOL", "MADScaler", "group_kfold", "indistinguishability", "roc_auc_score", "fov_stratified_auroc",
           "paired_auroc"]


#: the probe's L-BFGS stops at ``max |grad| <= PROBE_TOL`` (sklearn's default ``tol``)
PROBE_TOL = 1e-4


class MADScaler:
    """Median-absolute-deviation scaler: (x - median) / (MAD + 1e-12)."""

    def fit(self, X, y=None):
        self.median_ = np.median(X, axis=0)
        self.mad_ = np.median(np.abs(X - self.median_), axis=0)
        return self

    def transform(self, X):
        return (X - self.median_) / (self.mad_ + 1e-12)

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


def indistinguishability(auroc: float) -> float:
    """1 - 2 |AUROC - 0.5|: chance -> 1, separable -> 0."""
    return 1.0 - 2.0 * abs(auroc - 0.5)


def group_kfold(groups: np.ndarray, n_splits: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``list(GroupKFold(n_splits).split(X, y, groups))``: ``(train, test)``
    row indices, ascending."""
    unique_groups, group_idx = np.unique(np.asarray(groups), return_inverse=True)
    if n_splits > len(unique_groups):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the number of groups: "
                         f"{len(unique_groups)}.")
    n_per_group = np.bincount(group_idx)
    order = np.argsort(n_per_group, kind="stable")[::-1]
    n_per_fold = np.zeros(n_splits)
    group_to_fold = np.zeros(len(unique_groups))
    for gi, weight in zip(order, n_per_group[order]):
        lightest = np.argmin(n_per_fold)
        n_per_fold[lightest] += weight
        group_to_fold[gi] = lightest
    fold = group_to_fold[group_idx]
    rows = np.arange(len(fold))
    return [(rows[fold != f], rows[fold == f]) for f in range(n_splits)]


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary ``sklearn.metrics.roc_auc_score`` (the larger label positive):
    scores sorted descending (stable), the cumulative true and false
    positives at each distinct score, collinear points dropped, the
    trapezoid from (0, 0)."""
    y_true = np.asarray(y_true)
    labels = np.unique(y_true)
    if len(labels) != 2:
        return float("nan")
    pos = (y_true == labels[1]).astype(np.float64)
    order = np.argsort(-np.asarray(y_score, np.float64), kind="stable")
    score = np.asarray(y_score)[order]
    pos = pos[order]
    thresholds = np.concatenate([np.nonzero(np.diff(score))[0], [pos.size - 1]])
    tps = np.cumsum(pos)[thresholds]
    fps = 1 + thresholds.astype(np.float64) - tps
    if fps.shape[0] > 2:
        keep = np.concatenate([[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]])
        fps, tps = fps[keep], tps[keep]
    fps = np.concatenate([[0.0], fps])
    tps = np.concatenate([[0.0], tps])
    return float(np.trapezoid(tps / tps[-1], fps / fps[-1]))


def fov_stratified_auroc(X: np.ndarray, y: np.ndarray, fov_id: np.ndarray, n_splits: int = 5, rng_seed: int = 2020,
                         device="cuda") -> dict:
    """FOV-grouped cross-validated AUROC of MAD scaling (fit inside each
    fold) and a balanced logistic regression; fewer folds when FOVs are
    scarce, NaN below 2 groups. ``{"auroc_mean", "auroc_std", "n_folds"}``.
    The solver stops at :data:`PROBE_TOL`; ``rng_seed`` is accepted for
    JAX's signature (lbfgs draws nothing)."""
    from viscy_tpu_torch.evaluation.linear_classifier import fit_logistic_regression

    dev = resolve_device(device)
    X, y = np.asarray(X), np.asarray(y)
    n_unique = len(np.unique(fov_id))
    effective = min(n_splits, n_unique)
    nan = {"auroc_mean": float("nan"), "auroc_std": float("nan"), "n_folds": effective}
    if effective < 2:
        warnings.warn(f"Only {n_unique} unique FOV(s); need >=2 for GroupKFold. Returning NaN.", UserWarning,
                      stacklevel=2)
        return nan
    aurocs: list[float] = []
    for tr, va in group_kfold(fov_id, effective):
        if len(np.unique(y[va])) < 2:
            warnings.warn("Skipping fold with only one class in validation set.", UserWarning, stacklevel=2)
            continue
        classes, codes = np.unique(y[tr], return_inverse=True)
        if len(classes) < 2:
            raise ValueError(f"This solver needs samples of at least 2 classes in the data, but the data contains "
                             f"only one class: {classes[0]!r}")
        scaler = MADScaler().fit(X[tr])
        coef, intercept = fit_logistic_regression(on(scaler.transform(X[tr]), dev), codes, 2, "balanced",
                                                  max_iter=2000, tol=PROBE_TOL)
        z = on(scaler.transform(X[va]), dev) @ on(coef, dev).T + on(intercept, dev)
        aurocs.append(roc_auc_score(y[va] == classes[1], host(torch.sigmoid(z[:, 0]))))
    if not aurocs:
        return nan
    return {
        "auroc_mean": float(np.mean(aurocs)),
        "auroc_std": float(np.std(aurocs)) if len(aurocs) >= 2 else float("nan"),
        "n_folds": effective,
    }


def paired_auroc(x_a: np.ndarray, x_b: np.ndarray, fov_a: np.ndarray, fov_b: np.ndarray, n_splits: int = 5,
                 rng_seed: int = 2020, device="cuda") -> dict:
    """Binary probe of two stacked cohorts (y = 0 for a, 1 for b) grouped by
    FOV; all NaN with ``n_folds`` 0 when either side is empty."""
    if x_a.size == 0 or x_b.size == 0:
        return {"auroc_mean": float("nan"), "auroc_std": float("nan"), "n_folds": 0}
    X = np.vstack([x_a, x_b])
    y = np.concatenate([np.zeros(len(x_a), np.int8), np.ones(len(x_b), np.int8)])
    fov = np.concatenate([np.asarray(fov_a), np.asarray(fov_b)])
    return fov_stratified_auroc(X, y, fov, n_splits=n_splits, rng_seed=rng_seed, device=device)
