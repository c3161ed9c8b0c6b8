"""Signal extraction for pseudotime analysis (counterpart of
``viscy_tpu/apps/dynaclr/pseudotime/signals.py``): annotations, classifier
predictions or embedding distances as a per-frame ``signal`` column of the
aligned tracking table (a :class:`~viscy_tpu_torch.evaluation.anndata_lite.Frame`)."""

from __future__ import annotations

import logging

import numpy as np
from scipy.spatial.distance import cdist

from viscy_tpu_torch.apps.dynaclr.pseudotime._tables import copy, floats, missing
from viscy_tpu_torch.apps.dynaclr.pseudotime.alignment import track_groups

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["extract_annotation_signal", "extract_embedding_distance", "extract_prediction_signal"]


def extract_annotation_signal(df, state_col: str = "organelle_state", positive_value: str = "remodel"):
    """A 1 / 0 / NaN signal from human annotations."""
    result = copy(df)
    state = df[state_col]
    hit = np.asarray([v == positive_value for v in state.tolist()], np.float64)
    result["signal"] = np.where(missing(state), np.nan, hit)
    return result


def _obs_keys(obs, fov_as_str: bool = False) -> dict[tuple, int]:
    fov = [str(f) for f in obs["fov_name"].tolist()] if fov_as_str else obs["fov_name"].tolist()
    return {k: i for i, k in enumerate(zip(fov, np.asarray(obs["track_id"]).astype(int).tolist(),
                                           np.asarray(obs["t"]).astype(int).tolist()))}


def extract_prediction_signal(adata, aligned_df, task: str = "organelle_state", positive_value: str = "remodel",
                              use_probability: bool = False):
    """The signal from classifier predictions on the store
    (``obs["predicted_{task}"]``, or the positive class's column of
    ``obsm["predicted_{task}_proba"]``), joined by (fov_name, track_id, t)."""
    pred_col = f"predicted_{task}"
    if pred_col not in adata.obs:
        raise KeyError(f"Column {pred_col!r} not found in obs. Run apply-classifier first.")
    result = copy(aligned_df)
    where = _obs_keys(adata.obs)
    keys = zip(aligned_df["fov_name"].tolist(), np.asarray(aligned_df["track_id"]).astype(int).tolist(),
               np.asarray(aligned_df["t"]).astype(int).tolist())
    rows = np.asarray([where.get(k, -1) for k in keys], np.int64)
    hit = rows >= 0
    if use_probability:
        proba_key = f"predicted_{task}_proba"
        if proba_key not in adata.obsm:
            raise KeyError(f"{proba_key!r} not in obsm; run the classifier with probabilities.")
        pos = list(adata.uns[f"predicted_{task}_classes"]).index(positive_value)
        values = np.asarray(adata.obsm[proba_key])[:, pos].astype(np.float64)
        result["signal"] = np.where(hit, values[np.where(hit, rows, 0)], np.nan)
    else:
        preds = adata.obs[pred_col]
        got = preds[np.where(hit, rows, 0)]
        present = hit & ~missing(got)
        result["signal"] = np.where(present, np.asarray([v == positive_value for v in got.tolist()], float), np.nan)
    _logger.info("Matched %d/%d rows between aligned_df and adata", int(np.isfinite(result["signal"]).sum()),
                 len(result))
    return result


def extract_embedding_distance(adata, aligned_df, reference: str = "pre_perturb_mean", metric: str = "cosine",
                               pre_window_minutes: float = 120.0):
    """A continuous signal: each frame's embedding distance from a reference
    state (each track's mean embedding over the ``pre_window_minutes``
    before the event by default, else its first frame)."""
    result = copy(aligned_df)
    where = _obs_keys(adata.obs, fov_as_str=True)
    X = np.asarray(adata.X, np.float64)
    signal = np.full(len(aligned_df), np.nan)
    t_all = np.asarray(aligned_df["t"]).astype(int)
    rel = floats(aligned_df["t_relative_minutes"]) if "t_relative_minutes" in aligned_df else None
    for (fov, tid), rows in track_groups(aligned_df).items():
        rows = rows[np.argsort(t_all[rows], kind="stable")]
        locs = [where.get((str(fov), int(tid), int(t))) for t in t_all[rows].tolist()]
        valid = np.asarray([loc is not None for loc in locs], bool)
        if valid.sum() < 2:
            continue
        emb = X[np.asarray([loc for loc in locs if loc is not None], np.int64)]
        if reference == "pre_perturb_mean" and rel is not None:
            r = rel[rows][valid]
            pre = (r < 0) & (r >= -pre_window_minutes)
            ref = emb[pre].mean(axis=0) if pre.any() else emb[:1].mean(axis=0)
        else:
            ref = emb[0]
        signal[rows[valid]] = cdist(emb, ref[None], metric=metric)[:, 0]
    result["signal"] = signal
    return result
