"""Tracking benchmark from embeddings (counterpart of
``viscy_tpu/apps/dynaclr/tracking.py``): link each cell at t+1 to the
nearest cell at t (by embedding distance, within a spatial gate), on the
device, and score the links against the ground-truth track ids."""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import cdist, host, on, resolve_device
from viscy_tpu_torch.evaluation.anndata_lite import Frame

__all__ = ["link_by_embedding", "tracking_accuracy"]


def link_by_embedding(features, index: Frame, spatial_gate: float = 50.0, metric: str = "cosine",
                      device: str = "cuda") -> Frame:
    """Greedy frame-to-frame links: ``index`` (renumbered) with
    ``linked_prev_row``, the row of the nearest cell of the previous
    timepoint of the same FOV within ``spatial_gate`` pixels (the first on a
    tie), or -1. FOVs in order of first appearance."""
    dev = resolve_device(device)
    out = index.reset_index()
    fov_col = "fov_name" if "fov_name" in out else "fov"
    fovs, t = np.asarray(out[fov_col]), np.asarray(out["t"])
    feats = on(np.asarray(features), dev)
    yx = on(np.stack([np.asarray(out["y"], float), np.asarray(out["x"], float)], axis=1), dev)
    linked = np.full(len(out), -1, dtype=np.int64)
    for fov in dict.fromkeys(fovs.tolist()):
        rows = np.flatnonzero(fovs == fov)
        times = sorted(set(t[rows].tolist()))
        for t_prev, t_next in zip(times[:-1], times[1:]):
            prev = torch.as_tensor(rows[t[rows] == t_prev], device=dev)
            nxt = rows[t[rows] == t_next]
            nxt_t = torch.as_tensor(nxt, device=dev)
            emb_d = cdist(feats[nxt_t], feats[prev], metric)
            gate = torch.cdist(yx[nxt_t], yx[prev], compute_mode="donot_use_mm_for_euclid_dist") <= spatial_gate
            emb_d = torch.where(gate, emb_d, torch.inf)
            best = emb_d.argmin(dim=1)
            valid = host(torch.isfinite(emb_d.gather(1, best[:, None])[:, 0]))
            linked[nxt[valid]] = host(prev[best])[valid]
    out["linked_prev_row"] = linked
    return out


def tracking_accuracy(linked: Frame) -> dict:
    """The fraction of links that stay within a ground-truth track."""
    prev = np.asarray(linked["linked_prev_row"])
    has = prev >= 0
    if not has.any():
        return {"link_accuracy": float("nan"), "n_links": 0}
    tracks = np.asarray(linked["track_id"])
    return {"link_accuracy": float((tracks[has] == tracks[prev[has]]).mean()), "n_links": int(has.sum())}
