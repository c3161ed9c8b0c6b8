"""The first pseudotime API (counterpart of
``viscy_tpu/apps/dynaclr/pseudotime/_legacy.py``): align each track's
embedding trajectory to a reference trajectory by global DTW and assign
pseudotime from the matched reference positions. The DP is host kernel H2
(the recurrence JAX's loop computes, bit for bit)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist

from viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_core import dtw_accumulated_cost, dtw_best_path
from viscy_tpu_torch.evaluation.anndata_lite import Frame

__all__ = ["compute_pseudotime", "dtw_align"]


def dtw_align(query: np.ndarray, reference: np.ndarray, metric: str = "cosine") -> tuple[np.ndarray, float]:
    """Global DTW of an (n, d) query against an (m, d) reference: the path
    over (query, reference) indices and the cost divided by its length."""
    acc = dtw_accumulated_cost(cdist(query, reference, metric=metric))
    path = dtw_best_path(acc)
    return path, float(acc[-1, -1] / len(path))


def compute_pseudotime(features: np.ndarray, index: Frame, reference_track: tuple[str, int] | None = None,
                       metric: str = "cosine") -> Frame:
    """Every observation's pseudotime by DTW against a reference track
    (``(fov_name, track_id)``; the longest by default): the index with
    ``pseudotime`` and ``dtw_cost`` columns added."""
    index = index.reset_index()
    fov_col = "fov_name" if "fov_name" in index else "fov"
    t = np.asarray(index["t"])
    groups: dict[tuple, list[int]] = {}
    for i, key in enumerate(zip(index[fov_col].tolist(), index["track_id"].tolist())):
        groups.setdefault(key, []).append(i)
    groups = {k: np.asarray(v)[np.argsort(t[v], kind="stable")] for k, v in groups.items()}
    if reference_track is None:
        reference_track = max(groups, key=lambda k: len(groups[k]))
    ref_traj = features[groups[reference_track]]
    m = len(ref_traj)
    pseudotime, cost_col = np.full(len(index), np.nan), np.full(len(index), np.nan)
    for rows in groups.values():
        path, cost = dtw_align(features[rows], ref_traj, metric=metric)
        pt, counts = np.zeros(len(rows)), np.zeros(len(rows))
        for qi, ri in path.tolist():
            pt[qi] += ri / max(m - 1, 1)
            counts[qi] += 1
        pseudotime[rows] = pt / np.maximum(counts, 1)
        cost_col[rows] = cost
    index["pseudotime"] = pseudotime
    index["dtw_cost"] = cost_col
    return index
