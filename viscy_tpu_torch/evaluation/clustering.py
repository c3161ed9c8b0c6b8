"""Clustering and representation metrics (counterpart of
``viscy_tpu/evaluation/clustering.py``), on the device.

JAX calls sklearn (``KNeighborsClassifier``, ``DBSCAN``, the NMI and ARI
scores) and scipy's ``cdist``; the port computes the distances in float64
on the device and reproduces sklearn's rules:

- ``knn_accuracy``: uniform votes among the k nearest by Euclidean
  distance (the query itself included, as sklearn's ``predict`` on its
  own training rows includes it), the smallest label on a tie;
- ``dbscan_clustering``: neighbours within ``eps`` (inclusive, the point
  itself counted), core points with at least ``min_samples`` of them,
  clusters numbered in order of their first core point, a border point in
  the cluster of lowest number among its core neighbours (the cluster that
  sklearn's expansion, in index order, reaches first), noise -1;
- NMI (arithmetic mean) and ARI from the contingency table, with sklearn's
  special cases.

``rank_nearest_neighbors`` sorts stably, where JAX's ``np.argsort`` is not
stable: tied dissimilarities (a row with repeated values) can rank in a
different order there.
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import ROW_CHUNK, cdist, exact_knn, host, on, resolve_device

__all__ = ["clustering_evaluation", "compare_time_offset", "dbscan_clustering", "effective_rank", "knn_accuracy",
           "pairwise_distance_matrix", "rank_nearest_neighbors"]


def knn_accuracy(embeddings, annotations, k: int = 5, device: str = "cuda") -> float:
    """Accuracy of the k-NN vote of each row's annotation over all rows
    (``KNeighborsClassifier(k).fit(X, y).predict(X)``)."""
    dev = resolve_device(device)
    x = on(embeddings, dev)
    classes, y = np.unique(np.asarray(annotations), return_inverse=True)
    if k > len(y):
        raise ValueError(f"Expected n_neighbors <= n_samples_fit, but n_neighbors = {k}, n_samples_fit = {len(y)}")
    yt = torch.as_tensor(y, device=dev)
    nearest = exact_knn(x, x, k)[1]  # distance first, index second
    votes = torch.zeros(len(y), len(classes), dtype=torch.int64, device=dev)
    votes.scatter_add_(1, yt[nearest], torch.ones_like(nearest))
    return float((votes.argmax(dim=1) == yt).double().mean())


def pairwise_distance_matrix(features, metric: str = "cosine", device: str = "cuda") -> np.ndarray:
    """The full pairwise distance matrix (``cdist(features, features,
    metric)``), float64."""
    x = on(features, resolve_device(device))
    return host(cdist(x, x, metric, same=True))


def rank_nearest_neighbors(cross_dissimilarity, normalize: bool = True, device: str = "cuda") -> np.ndarray:
    """Each entry's rank within its row (0 the least dissimilar), stable;
    divided by ``columns - 1`` with ``normalize``."""
    d = on(cross_dissimilarity, resolve_device(device))
    order = torch.sort(d, dim=1, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(d.shape[1], device=d.device).expand_as(order).contiguous())
    ranks = ranks.to(torch.float64)
    if normalize:
        ranks = ranks / max(d.shape[1] - 1, 1)
    return host(ranks)


def compare_time_offset(single_track_distances: np.ndarray, time_offset: int = 1) -> np.ndarray:
    """The diagonal at ``time_offset`` (a view, as ``np.diagonal``)."""
    return np.diagonal(single_track_distances, offset=time_offset)


def dbscan_clustering(embeddings, eps: float = 0.5, min_samples: int = 5, device: str = "cuda") -> np.ndarray:
    """sklearn's DBSCAN labels (see the module docstring); Euclidean
    distances on the device, the core points' connected components with
    scipy on the host."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    dev = resolve_device(device)
    x = on(embeddings, dev)
    n = x.shape[0]
    rows, cols = [], []
    for s in range(0, n, ROW_CHUNK):
        r, c = torch.nonzero(cdist(x[s: s + ROW_CHUNK], x) <= eps, as_tuple=True)
        rows.append(host(r + s))
        cols.append(host(c))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    core = np.bincount(rows, minlength=n) >= min_samples
    labels = np.full(n, -1, dtype=np.int64)
    if not core.any():
        return labels
    cc = core[rows] & core[cols]
    graph = sp.coo_matrix((np.ones(cc.sum()), (rows[cc], cols[cc])), shape=(n, n)).tocsr()
    _, comp = connected_components(graph, directed=False)
    core_idx = np.flatnonzero(core)
    # number the components of core points by their first core point
    first = {}
    for i in core_idx:
        first.setdefault(comp[i], len(first))
    labels[core_idx] = [first[comp[i]] for i in core_idx]
    border = ~core[rows] & core[cols]
    if border.any():
        cand = np.full(n, np.iinfo(np.int64).max)
        np.minimum.at(cand, rows[border], labels[cols[border]])
        hit = cand != np.iinfo(np.int64).max
        labels[hit] = cand[hit]
    return labels


def _contingency(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), dtype=np.int64)
    np.add.at(table, (ai, bi), 1)
    return table


def _entropy(labels: np.ndarray) -> float:
    if len(labels) == 0:
        return 1.0
    _, counts = np.unique(labels, return_counts=True)
    pi = counts.astype(np.float64)
    pi = pi[pi > 0]
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - np.log(pi_sum))))


def _nmi(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """sklearn's ``normalized_mutual_info_score`` (arithmetic mean)."""
    classes, clusters = np.unique(labels_true), np.unique(labels_pred)
    if classes.shape[0] == clusters.shape[0] == 1 or classes.shape[0] == clusters.shape[0] == 0:
        return 1.0
    c = _contingency(labels_true, labels_pred).astype(np.float64)
    nzx, nzy = np.nonzero(c)
    nz = c[nzx, nzy]
    total = c.sum()
    pi, pj = c.sum(axis=1), c.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        mi = 0.0
    else:
        log_c = np.log(nz)
        c_nm = nz / total
        outer = pi.take(nzx).astype(np.int64, copy=False) * pj.take(nzy).astype(np.int64, copy=False)
        log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
        mi = float(np.clip((c_nm * (log_c - np.log(total)) + c_nm * log_outer).sum(), 0.0, None))
    if mi == 0:
        return 0.0
    normalizer = max((_entropy(labels_true) + _entropy(labels_pred)) / 2, np.finfo("float64").eps)
    return float(mi / normalizer)


def _ari(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """sklearn's ``adjusted_rand_score`` from the pair confusion matrix."""
    n = np.int64(len(labels_true))
    c = _contingency(labels_true, labels_pred)
    n_c, n_k = c.sum(axis=1), c.sum(axis=0)
    sum_squares = int((c**2).sum())
    tp = sum_squares - int(n)
    fp = int((c @ n_k).sum()) - sum_squares
    fn = int((c.T @ n_c).sum()) - sum_squares
    tn = int(n) ** 2 - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def clustering_evaluation(embeddings, annotations, method: str = "nmi", eps: float = 0.5, min_samples: int = 5,
                          device: str = "cuda") -> float:
    """DBSCAN on the embeddings scored against the annotations (``nmi`` or
    ``ari``)."""
    if method not in ("nmi", "ari"):
        raise ValueError(f"Unknown method {method}")
    labels = dbscan_clustering(embeddings, eps=eps, min_samples=min_samples, device=device)
    annotations = np.asarray(annotations)
    return _nmi(annotations, labels) if method == "nmi" else _ari(annotations, labels)


def effective_rank(embeddings: np.ndarray, eps: float = 1e-12) -> float:
    """Effective rank: the exponential of the entropy of the centred
    embedding matrix's normalized singular values (float64)."""
    x = np.asarray(embeddings, np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    s = np.linalg.svd(x, compute_uv=False)
    p = s / (s.sum() + eps)
    p = p[p > eps]
    return float(np.exp(-(p * np.log(p)).sum()))
