"""Device primitives shared by the evaluation modules: float64 tensors on
the requested device, pairwise distances as ``scipy.spatial.distance.cdist``
defines them, and exact k-nearest neighbours.

Every public entry point of the evaluation package resolves its ``device``
through :func:`viscy_tpu_torch.device.resolve_device` (``"cuda"`` raises
without a card) and does its heavy part here, on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.device import resolve_device

__all__ = ["ROW_CHUNK", "cdist", "exact_knn", "host", "on", "resolve_device", "rowwise"]

METRICS = ("euclidean", "sqeuclidean", "cosine")
ROW_CHUNK = 4096  # query rows per (rows, N) distance block: 1.6 GB of float64 at N = 50,000
_KNN_MARGIN = 8  # candidates beyond k re-ranked by the exact distance


def on(x, device: torch.device, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``x`` (array or tensor) as a ``dtype`` tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise NotImplementedError(f"metric {metric!r} is not ported to viscy_tpu_torch; use one of {METRICS}")


def cdist(a: torch.Tensor, b: torch.Tensor, metric: str = "euclidean", same: bool = False) -> torch.Tensor:
    """Pairwise distances between the rows of ``a`` and ``b`` (float64 in,
    float64 out) for ``euclidean``, ``sqeuclidean`` and ``cosine``
    (``1 - cos``, the cosine clipped to [-1, 1] as scipy clips it). The
    squared distance is formed by the matrix product ``|a|^2 - 2 a.b +
    |b|^2`` and clipped at 0: within ``1e-15 * (|a|^2 + |b|^2)`` of scipy's
    difference form. With ``same`` (``a`` is ``b``) the diagonal is exactly
    0, as scipy's is (the product form leaves a rounding residue there)."""
    _check_metric(metric)
    if metric == "cosine":
        an = a / torch.linalg.vector_norm(a, dim=1, keepdim=True)
        bn = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
        d = 1.0 - (an @ bn.T).clamp(-1.0, 1.0)
    else:
        d = ((a * a).sum(1)[:, None] - 2.0 * (a @ b.T) + (b * b).sum(1)[None, :]).clamp_min(0.0)
        d = d if metric == "sqeuclidean" else d.sqrt()
    if same:
        d.fill_diagonal_(0.0)
    return d


def _exact(q: torch.Tensor, r: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances of each row of ``q`` (c, d) to its own rows of ``r`` (c, k, d)
    by differences (no cancellation: a point's distance to itself is 0),
    the squares summed feature by feature in order, as sklearn's tree
    search and scipy's ``cdist`` sum them."""
    if metric == "cosine":
        qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        rn = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)
        return 1.0 - torch.einsum("cd,ckd->ck", qn, rn).clamp(-1.0, 1.0)
    d2 = torch.zeros(r.shape[:2], dtype=r.dtype, device=r.device)
    for j in range(q.shape[1]):
        d2 += (q[:, None, j] - r[:, :, j]) ** 2
    return d2 if metric == "sqeuclidean" else d2.sqrt()


def rowwise(a: torch.Tensor, b: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """The distance of each row of ``a`` to the same row of ``b`` (the
    diagonal of ``cdist(a, b)``), by differences."""
    _check_metric(metric)
    return _exact(a, b[:, None, :], metric)[:, 0]


def exact_knn(query: torch.Tensor, ref: torch.Tensor, k: int,
              metric: str = "euclidean") -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest rows of ``ref`` to each row of ``query``:
    ``(distances (m, k) float64, indices (m, k) int64)``, ascending, ties by
    index. Candidates come from the matrix-product distances (``k + 8``
    of them, ``ROW_CHUNK`` query rows at a time), then each candidate's distance is recomputed from
    the difference of the two rows, so a query row that is also a ``ref``
    row has distance exactly 0 to itself (sklearn's brute-force search
    returns the product form's rounding there: see ``umap_native``)."""
    _check_metric(metric)
    n = ref.shape[0]
    k = min(k, n)
    kc = min(n, k + _KNN_MARGIN)
    out_d, out_i = [], []
    for s in range(0, query.shape[0], ROW_CHUNK):
        q = query[s: s + ROW_CHUNK]
        cand = torch.topk(cdist(q, ref, metric), kc, dim=1, largest=False, sorted=False).indices
        cand = torch.sort(cand, dim=1).values  # index order first, so the stable sort below breaks ties by index
        d = _exact(q, ref[cand], metric)
        order = torch.sort(d, dim=1, stable=True).indices[:, :k]
        out_d.append(torch.gather(d, 1, order))
        out_i.append(torch.gather(cand, 1, order))
    return torch.cat(out_d), torch.cat(out_i)

