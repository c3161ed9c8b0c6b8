"""Temporal smoothness of embedding tracks (counterpart of
``viscy_tpu/evaluation/smoothness.py``).

Adjacent-frame distances of every track and the 2000 random-pair
distances are each one batched distance call on the device, where JAX
calls ``cdist`` per track and per pair. The random pairs are numpy's
``default_rng(0).choice(N, (n, 2))``, as JAX draws them, or ``pairs``
given. The distribution peaks are scipy's ``gaussian_kde`` on the host.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import host, on, resolve_device, rowwise

__all__ = ["compute_embeddings_smoothness", "find_distribution_peak", "random_pairs"]


def find_distribution_peak(data: np.ndarray, method: Literal["histogram", "kde_robust"] = "kde_robust") -> float:
    """The mode of a 1-D sample: the peak of its Gaussian KDE on a
    512-point grid, or of a 64-bin histogram (also for fewer than three
    distinct values)."""
    from scipy.stats import gaussian_kde

    data = np.asarray(data, np.float64)
    if method == "histogram" or len(np.unique(data)) < 3:
        hist, edges = np.histogram(data, bins=64)
        centers = (edges[:-1] + edges[1:]) / 2
        return float(centers[np.argmax(hist)])
    kde = gaussian_kde(data)
    grid = np.linspace(data.min(), data.max(), 512)
    return float(grid[np.argmax(kde(grid))])


def random_pairs(n_rows: int, seed: int = 0) -> np.ndarray:
    """JAX's random pairs: ``default_rng(seed).choice(n_rows, (min(2000,
    n_rows), 2))``."""
    return np.random.default_rng(seed).choice(n_rows, (min(2000, n_rows), 2))


def compute_embeddings_smoothness(features, index, distance_metric: str = "cosine",
                                  return_distributions: bool = False, pairs: np.ndarray | None = None,
                                  device: str = "cuda"):
    """Peak and dynamic range of per-track step displacements against
    random-pair distances; the statistics carry JAX's names and order (see
    ``viscy_tpu/evaluation/smoothness.py``). Tracks are ``(fov_name,
    track_id)`` groups in order of first appearance, each sorted by ``t``."""
    from viscy_tpu_torch.evaluation.distance import track_groups

    dev = resolve_device(device)
    feats = on(np.asarray(features), dev)
    t = np.asarray(index["t"])
    first, second = [], []
    for rows in track_groups(index, sort=False):
        rows = rows[np.argsort(t[rows], kind="stable")]
        if len(rows) >= 2:
            first.append(rows[:-1])
            second.append(rows[1:])
    if not first:
        displacements = np.asarray([])
        stats = {"smoothness_peak": np.nan, "dynamic_range": np.nan, "n_steps": 0}
        if return_distributions:
            return stats, {"adjacent_frame_distribution": displacements,
                           "random_frame_distribution": np.asarray([])}
        return stats

    def distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return host(rowwise(feats[torch.as_tensor(a, device=dev)], feats[torch.as_tensor(b, device=dev)],
                            distance_metric))

    displacements = distances(np.concatenate(first), np.concatenate(second))
    idx = random_pairs(len(t)) if pairs is None else np.asarray(pairs)
    random_d = distances(idx[:, 0], idx[:, 1])
    peak = find_distribution_peak(displacements)
    random_peak = find_distribution_peak(random_d)
    stats = {
        "adjacent_frame_mean": float(displacements.mean()),
        "adjacent_frame_std": float(displacements.std()),
        "adjacent_frame_median": float(np.median(displacements)),
        "adjacent_frame_peak": peak,
        "random_frame_mean": float(random_d.mean()),
        "random_frame_std": float(random_d.std()),
        "random_frame_median": float(np.median(random_d)),
        "random_frame_peak": random_peak,
        "smoothness_score": float(displacements.mean() / random_d.mean()),
        "dynamic_range": random_peak - peak,
        "smoothness_peak": peak,
        "random_peak": random_peak,
        "n_steps": int(len(displacements)),
        "mean_displacement": float(displacements.mean()),
    }
    if return_distributions:
        return stats, {"adjacent_frame_distribution": displacements, "random_frame_distribution": random_d}
    return stats
