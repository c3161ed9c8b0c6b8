"""Retrieval mean average precision over embeddings (counterpart of
``viscy_tpu/evaluation/embedding_map.py``), on the device.

The distance matrix and each query's ranking come from the device in row
chunks; the ranking is a stable sort, where JAX's ``np.argsort`` is not:
tied distances (duplicate embeddings) may rank in another order there, which
moves an AP only when the tied rows differ in label. The permutation null
ranks once and re-labels per permutation (numpy's ``default_rng(seed)``
permutations, as JAX draws them, or ``permutations`` given).
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import cdist, host, on, resolve_device

__all__ = ["average_precision_per_sample", "compute_embedding_map", "mean_average_precision"]


def _rankings(feats: torch.Tensor, metric: str, chunk: int = 2048) -> torch.Tensor:
    """Each row's other rows, nearest first (self excluded), (n, n - 1)."""
    n = feats.shape[0]
    out = []
    for s in range(0, n, chunk):
        d = cdist(feats[s: s + chunk], feats, metric)
        d[torch.arange(d.shape[0], device=d.device), torch.arange(s, s + d.shape[0], device=d.device)] = torch.inf
        out.append(torch.sort(d, dim=1, stable=True).indices[:, : n - 1])
    return torch.cat(out)


def _ap(order: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """AP of each query given its ranking and integer labels (NaN without a
    positive)."""
    hits = codes[order] == codes[:, None]
    cum = torch.cumsum(hits, dim=1, dtype=torch.float64)
    rank = torch.arange(1, order.shape[1] + 1, device=order.device, dtype=torch.float64)
    n_pos = hits.sum(dim=1)
    total = torch.where(hits, cum / rank, 0.0).sum(dim=1)
    return torch.where(n_pos > 0, total / n_pos.clamp_min(1), torch.nan)


def average_precision_per_sample(features, labels, metric: str = "cosine", device: str = "cuda") -> np.ndarray:
    """AP of retrieving same-label rows for every query (self excluded)."""
    dev = resolve_device(device)
    _, codes = np.unique(np.asarray(labels), return_inverse=True)
    order = _rankings(on(features, dev), metric)
    return host(_ap(order, torch.as_tensor(codes, device=dev)))


def mean_average_precision(features, labels, metric: str = "cosine", device: str = "cuda") -> dict:
    """mAP over all queries and per label."""
    labels = np.asarray(labels)
    aps = average_precision_per_sample(features, labels, metric, device=device)
    out = {"map": float(np.nanmean(aps))}
    for lab in np.unique(labels):
        out[f"map/{lab}"] = float(np.nanmean(aps[labels == lab]))
    return out


def compute_embedding_map(meta, features, reference_condition: str, target_condition: str,
                          condition_col: str = "perturbation", group_col: str = "marker", distance: str = "cosine",
                          null_size: int = 10000, seed: int = 0, permutations: list | None = None,
                          device: str = "cuda") -> dict | None:
    """Target-condition retrieval mAP against the reference condition with
    a label-permutation null (JAX's ``compute_embedding_map``); ``None``
    when either side has fewer than two rows."""
    dev = resolve_device(device)
    cond = np.asarray([str(c) for c in np.asarray(meta[condition_col])])
    sel = np.isin(cond, [str(reference_condition), str(target_condition)])
    if not sel.any():
        return None
    labels = cond[sel]
    target_mask = labels == str(target_condition)
    if target_mask.sum() < 2 or (~target_mask).sum() < 2:
        return None
    order = _rankings(on(np.asarray(features)[sel], dev), distance)
    codes = torch.as_tensor(target_mask.astype(np.int64), device=dev)
    observed = float(np.nanmean(host(_ap(order, codes))[target_mask]))
    n_perm = int(min(max(null_size // max(len(labels), 1), 20), 1000))
    if permutations is None:
        rng = np.random.default_rng(seed)
        permutations = [rng.permutation(labels) for _ in range(n_perm)]
    null = np.empty(len(permutations))
    for i, perm in enumerate(permutations):
        is_target = np.asarray(perm) == str(target_condition)
        aps = host(_ap(order, torch.as_tensor(is_target.astype(np.int64), device=dev)))
        null[i] = np.nanmean(aps[is_target])
    return {"mean_average_precision": observed, "p_value": float((null >= observed).mean())}
