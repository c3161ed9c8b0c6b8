"""Pseudotime quality against annotations (counterpart of
``viscy_tpu/apps/dynaclr/pseudotime/evaluation.py``): ROC-AUC of pseudotime
as a score of a binary annotation, per-track onset concordance (Spearman,
scipy), per-timepoint AUC, average precision, and the combined
:func:`evaluate_embedding` scorecard; AUROC and average precision are the
port's own (:mod:`viscy_tpu_torch.evaluation.linear_classifier`)."""

from __future__ import annotations

import math

import numpy as np

from viscy_tpu_torch.apps.dynaclr.pseudotime._tables import dropna, floats
from viscy_tpu_torch.apps.dynaclr.pseudotime.alignment import track_groups

__all__ = ["evaluate_embedding", "onset_concordance", "per_timepoint_auc", "pseudotime_ap",
           "pseudotime_vs_annotation_auc"]


def _scored(df, pseudotime_col: str, annotation_col: str, positive_value: str):
    """The rows with both columns present and a non-empty annotation; their
    0/1 target and score."""
    valid = dropna(df, [pseudotime_col, annotation_col])
    valid = valid.take(np.asarray([v != "" for v in valid[annotation_col].tolist()], bool))
    y = np.asarray([v == positive_value for v in valid[annotation_col].tolist()], np.int64)
    return valid, y, floats(valid[pseudotime_col])


def pseudotime_vs_annotation_auc(df, pseudotime_col: str = "pseudotime", annotation_col: str = "infection_state",
                                 positive_value: str = "infected") -> float:
    """ROC-AUC of pseudotime as a score of the binary annotation."""
    from viscy_tpu_torch.evaluation.linear_classifier import roc_auc

    valid, y, score = _scored(df, pseudotime_col, annotation_col, positive_value)
    if not len(valid) or len(np.unique(y)) < 2:
        return float("nan")
    return roc_auc(y, score)


def onset_concordance(df, pseudotime_col: str = "pseudotime", annotation_col: str = "infection_state",
                      positive_value: str = "infected", min_track_timepoints: int = 3) -> tuple[float, int]:
    """Spearman rho between each track's onset by annotation (its first
    positive frame) and by DTW (its first frame above the track's median
    pseudotime)."""
    from scipy.stats import spearmanr

    valid, y, score = _scored(df, pseudotime_col, annotation_col, positive_value)
    t = np.asarray(valid["t"]) if len(valid) else np.zeros(0)
    dtw_onsets, ann_onsets = [], []
    for rows in track_groups(valid).values():
        if len(rows) < min_track_timepoints:
            continue
        rows = rows[np.argsort(t[rows], kind="stable")]
        pos = rows[y[rows] == 1]
        if not len(pos):
            continue
        above = rows[score[rows] > np.median(score[rows])]
        if not len(above):
            continue
        ann_onsets.append(t[pos[0]])
        dtw_onsets.append(t[above[0]])
    if len(dtw_onsets) < 3:
        return float("nan"), len(dtw_onsets)
    rho, _ = spearmanr(dtw_onsets, ann_onsets)
    return float(rho), len(dtw_onsets)


def per_timepoint_auc(df, pseudotime_col: str = "pseudotime", annotation_col: str = "infection_state",
                      positive_value: str = "infected", time_col: str = "t"):
    """AUC of pseudotime against the annotation within each timepoint: the
    score must separate the classes without leaning on wall-clock time."""
    from viscy_tpu_torch.apps.dynaclr.pseudotime._tables import records
    from viscy_tpu_torch.evaluation.linear_classifier import roc_auc

    valid, y, score = _scored(df, pseudotime_col, annotation_col, positive_value)
    rows = []
    for (t,), idx in track_groups(valid, (time_col,)).items():
        auc = roc_auc(y[idx], score[idx]) if len(np.unique(y[idx])) >= 2 else np.nan
        rows.append({"t": t, "auc": auc, "n_cells": len(idx)})
    return records(rows)


def pseudotime_ap(df, pseudotime_col: str = "pseudotime", annotation_col: str = "infection_state",
                  positive_value: str = "infected") -> float:
    """Average precision of pseudotime ranking the positive class."""
    from viscy_tpu_torch.evaluation.linear_classifier import average_precision

    valid, y, score = _scored(df, pseudotime_col, annotation_col, positive_value)
    if not len(valid) or len(np.unique(y)) < 2:
        return float("nan")
    return average_precision(y, score)


def evaluate_embedding(df, pseudotime_col: str = "pseudotime", annotation_col: str = "infection_state",
                       positive_value: str = "infected") -> dict[str, float]:
    """Global AUC and AP, onset concordance, mean per-timepoint AUC."""
    rho, n_tracks = onset_concordance(df, pseudotime_col, annotation_col, positive_value)
    per_t = per_timepoint_auc(df, pseudotime_col, annotation_col, positive_value)
    aucs = floats(per_t["auc"]) if len(per_t) else np.zeros(0)
    return {"auc": pseudotime_vs_annotation_auc(df, pseudotime_col, annotation_col, positive_value),
            "average_precision": pseudotime_ap(df, pseudotime_col, annotation_col, positive_value),
            "onset_concordance_rho": rho, "onset_concordance_n_tracks": n_tracks,
            "mean_per_timepoint_auc": float(np.nanmean(aucs)) if len(aucs) and not np.isnan(aucs).all()
            else math.nan}
