"""Track displacement and cosine drift over an embedding store
(counterpart of ``viscy_tpu/evaluation/distance.py``).

Datasets are the port's :class:`~viscy_tpu_torch.evaluation.anndata_lite.
AnnDataLite` (``ds["features"]``, ``ds["index"]`` with ``fov_name``,
``track_id``, ``t``). Where JAX computes one ``cdist`` matrix per track,
the port gathers every (earlier, later) pair of every track and computes
their distances in one batch on the device, in JAX's order: tracks by
``(fov_name, track_id)``, then offset, then start.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import host, on, resolve_device, rowwise

__all__ = ["calculate_cosine_similarity_cell", "compute_track_displacement", "track_groups"]


def track_groups(index, sort: bool = True) -> list[np.ndarray]:
    """Row indices of each ``(fov_name, track_id)`` group, each in row
    order: groups in sorted key order (``groupby(...).groups``) or, with
    ``sort=False``, in order of first appearance."""
    groups: dict[tuple, list[int]] = {}
    for i, key in enumerate(zip(index["fov_name"].tolist(), index["track_id"].tolist())):
        groups.setdefault(key, []).append(i)
    keys = sorted(groups) if sort else list(groups)
    return [np.asarray(groups[k], dtype=np.int64) for k in keys]


def calculate_cosine_similarity_cell(embedding_dataset, fov_name: str, track_id: int,
                                     device: str = "cuda") -> tuple[np.ndarray, list[float]]:
    """Cosine similarity of each of the track's timepoints to its first."""
    index = embedding_dataset["index"]
    mask = (np.asarray(index["fov_name"]) == fov_name) & (np.asarray(index["track_id"]) == track_id)
    time_points = np.asarray(index["t"])[mask]
    order = np.argsort(time_points, kind="stable")
    f = on(np.asarray(embedding_dataset["features"])[mask][order], resolve_device(device))
    f0 = f[0]
    norms = torch.linalg.vector_norm(f, dim=1) * torch.linalg.vector_norm(f0)
    sims = ((f @ f0) / norms.clamp_min(1e-12)).clamp(-1.0, 1.0)
    return time_points[order], host(sims).tolist()


def compute_track_displacement(embedding_dataset, distance_metric: str = "cosine",
                               device: str = "cuda") -> dict[int, list[float]]:
    """Every lag ``tau`` mapped to the embedding displacements of all pairs
    of a track's frames ``tau`` apart."""
    index = embedding_dataset["index"]
    t = np.asarray(index["t"])
    first, second = [], []
    for rows in track_groups(index):
        rows = rows[np.argsort(t[rows], kind="stable")]
        for off in range(1, len(rows)):
            first.append(rows[:-off])
            second.append(rows[off:])
    out: dict[int, list[float]] = defaultdict(list)
    if not first:
        return {}
    a, b = np.concatenate(first), np.concatenate(second)
    feats = on(np.asarray(embedding_dataset["features"]), resolve_device(device))
    ia, ib = torch.as_tensor(a, device=feats.device), torch.as_tensor(b, device=feats.device)
    d = host(rowwise(feats[ia], feats[ib], distance_metric))
    for tau, value in zip((t[b] - t[a]).tolist(), d.tolist()):
        out[int(tau)].append(float(value))
    return dict(out)
