"""Feature-space similarity of two cell cohorts on the device, float64:
FID, KID, improved precision / recall / F1, MIND and the median cosine
(counterpart of ``viscy_tpu/apps/dynacell/eval/feature_metrics.py``; the
same ``f"{prefix}_<METRIC>"`` columns).

- FID: ``|mu1 - mu2|^2 + Tr S1 + Tr S2 - 2 Tr sqrt(S1 S2)``. JAX sums
  ``sqrt(max(Re eig(S1 S2), 0))`` from the general eigensolver; the port
  takes the symmetric form ``eig(sqrt(S1) S2 sqrt(S1))`` (``eigh``, equal
  in exact arithmetic). With full-rank covariances the two agree within
  1e-8 of the FID; with fewer cells than features each of the zero
  eigenvalues comes out of a solver as rounding of size ``eps |S|``,
  whose square root adds up to ``sqrt(eps |S|)`` per eigenvalue to
  ``Tr sqrt``. The port counts eigenvalues at or below numpy's rank
  tolerance as 0 (in ``sqrt(S1)`` too), so its FID does not depend on
  the solver (the card's and the CPU's agree); JAX's sums its solver's
  noise: the tests hold the two within that noise's bound.
- KID: the unbiased cubic-polynomial-kernel MMD^2 over random subsets.
- Precision / recall / F1: Kynkaanniemi et al.'s k-NN manifolds, with the
  bootstrap's mean and standard deviation.
- MIND: the sliced Wasserstein-2 distance over random unit directions.

Every subset and projection is drawn on the host with numpy's
``default_rng(seed)`` in JAX's order, then moved to the device. Rows with
a non-finite value (a CP row of a cell whose values are constant) are left
out first; JAX's eigensolver raises on them (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.apps.dynacell.eval._ops import host, on, quantile_sorted, resolve_device
from viscy_tpu_torch.apps.dynacell.eval.metrics import drop_paired_nonfinite_rows

__all__ = [
    "compute_feature_similarity",
    "compute_feature_similarity_pairwise",
    "frechet_distance",
    "kid_metric",
    "precision_recall_f1",
    "mind_metric",
]

_KID_MIN_SUBSET_SIZE = 16
_KID_CHUNK = 10  # subsets per batched kernel product


def _finite_rows(pred: np.ndarray, target: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The rows with no non-finite value: paired when the cohorts align row
    for row, else each side's own. (A CP row is NaN where a cell's values
    are constant: JAX's covariance eigensolver then raises.)"""
    if pred.shape[0] == target.shape[0]:
        return drop_paired_nonfinite_rows(pred, target)
    return pred[np.isfinite(pred).all(axis=1)], target[np.isfinite(target).all(axis=1)]


def _median_cosine_similarity(pred: np.ndarray, target: np.ndarray, device) -> float:
    """Median of the row-wise cosine of aligned pairs (rows with a zero norm
    on either side left out); NaN when none is left."""
    pred, target = drop_paired_nonfinite_rows(pred, target)
    if pred.shape[0] == 0:
        return float("nan")
    p, t = on(pred, device), on(target, device)
    num = host((p * t).sum(dim=1))
    den = host(torch.linalg.vector_norm(p, dim=1) * torch.linalg.vector_norm(t, dim=1))
    nz = den > 0
    if not nz.any():
        return float("nan")
    return float(np.median(np.clip(num[nz] / den[nz], -1.0, 1.0)))


def _cov(x: torch.Tensor) -> torch.Tensor:
    """``np.cov(x, rowvar=False)``: unbiased, ``(d, d)`` (the product times
    ``1 / (n - 1)``, as numpy scales it)."""
    xc = x - x.mean(dim=0)
    return (xc.T @ xc) * (1.0 / (x.shape[0] - 1))


def _rank_floor(lam: torch.Tensor) -> torch.Tensor:
    """The eigenvalues of a symmetric PSD matrix, those at or below numpy's
    rank tolerance (``d eps lam_max``) set to 0: they are rounding of its
    null space, and each one's square root would add the solver's noise,
    about ``sqrt(eps lam_max)``, to a trace of square roots."""
    tol = lam.shape[-1] * torch.finfo(lam.dtype).eps * lam.max().clamp_min(0.0)
    return torch.where(lam > tol, lam, torch.zeros_like(lam))


def _sqrtm_psd(s: torch.Tensor) -> torch.Tensor:
    lam, v = torch.linalg.eigh(s)
    return (v * _rank_floor(lam).sqrt()) @ v.T


def frechet_distance(pred, target, device="cuda") -> float:
    """FID of two feature cohorts; NaN below 2 rows on either side."""
    if np.shape(pred)[0] < 2 or np.shape(target)[0] < 2:
        return float("nan")
    dev = resolve_device(device)
    x, y = on(pred, dev), on(target, dev)
    s1, s2 = _cov(x), _cov(y)
    diff = x.mean(dim=0) - y.mean(dim=0)
    r = _sqrtm_psd(s1)
    m = r @ s2 @ r
    eigs = torch.linalg.eigvalsh((m + m.T) / 2)
    tr_sqrt = float(_rank_floor(eigs).sqrt().sum())
    return float(diff @ diff) + float(torch.trace(s1)) + float(torch.trace(s2)) - 2.0 * tr_sqrt


def _poly_kernel(x: torch.Tensor, y: torch.Tensor, degree: int = 3, coef: float = 1.0) -> torch.Tensor:
    gamma = 1.0 / x.shape[-1]
    return (x @ y.transpose(-1, -2) * gamma + coef) ** degree


def _unbiased_mmd2(kxx: torch.Tensor, kyy: torch.Tensor, kxy: torch.Tensor) -> torch.Tensor:
    """Per batch of kernel matrices ``(b, m, m)``, ``(b, n, n)``, ``(b, m, n)``."""
    m, n = kxx.shape[-1], kyy.shape[-1]
    sum_xx = (kxx.sum(dim=(1, 2)) - kxx.diagonal(dim1=1, dim2=2).sum(dim=1)) / (m * (m - 1))
    sum_yy = (kyy.sum(dim=(1, 2)) - kyy.diagonal(dim1=1, dim2=2).sum(dim=1)) / (n * (n - 1))
    return sum_xx + sum_yy - 2.0 * kxy.mean(dim=(1, 2))


def kid_metric(pred, target, kid_subsets: int = 100, kid_subset_size: int = 1000, rng_seed: int = 2020,
               device="cuda") -> tuple[float, float]:
    """KID mean and standard deviation over random subsets (the subset size
    shrunk to the smaller cohort); NaN below 16 rows a subset."""
    n_pred, n_target = np.shape(pred)[0], np.shape(target)[0]
    if n_pred < 2 or n_target < 2:
        return float("nan"), float("nan")
    size = min(kid_subset_size, n_pred, n_target)
    if size < _KID_MIN_SUBSET_SIZE:
        return float("nan"), float("nan")
    dev = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    picks = [(rng.choice(n_pred, size, replace=False), rng.choice(n_target, size, replace=False))
             for _ in range(kid_subsets)]
    x_all, y_all = on(pred, dev), on(target, dev)
    vals = []
    for s in range(0, kid_subsets, _KID_CHUNK):
        chunk = picks[s:s + _KID_CHUNK]
        xi = x_all[torch.as_tensor(np.stack([a for a, _ in chunk]), device=dev)]
        yi = y_all[torch.as_tensor(np.stack([b for _, b in chunk]), device=dev)]
        vals.append(_unbiased_mmd2(_poly_kernel(xi, xi), _poly_kernel(yi, yi), _poly_kernel(xi, yi)))
    v = host(torch.cat(vals))
    return float(v.mean()), float(v.std())


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max(|a|^2 + |b|^2 - 2 a.b, 0)`` (the product form, as JAX's)."""
    return ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)).clamp_min(0.0)


def _knn_radii(x: torch.Tensor, k: int) -> torch.Tensor:
    """Distance to the k-th nearest other row, per row."""
    d2 = _sq_dists(x, x)
    d2.fill_diagonal_(float("inf"))
    k = min(k, x.shape[0] - 1)
    return torch.kthvalue(d2, k, dim=1).values.sqrt()


def _fraction_in_manifold(query: torch.Tensor, ref: torch.Tensor, ref_radii: torch.Tensor) -> float:
    """Fraction of query rows inside any ref row's k-NN hypersphere."""
    inside = (_sq_dists(query, ref).sqrt() <= ref_radii[None, :]).any(dim=1)
    return float(inside.double().mean())


def _prf(generated: torch.Tensor, real: torch.Tensor, neighborhood: int) -> tuple[float, float, float]:
    if generated.shape[0] <= neighborhood or real.shape[0] <= neighborhood:
        return float("nan"), float("nan"), float("nan")
    precision = _fraction_in_manifold(generated, real, _knn_radii(real, neighborhood))
    recall = _fraction_in_manifold(real, generated, _knn_radii(generated, neighborhood))
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0.0
    return precision, recall, f1


def precision_recall_f1(generated, real, neighborhood: int = 5, device="cuda") -> tuple[float, float, float]:
    """Kynkaanniemi improved precision / recall and their F1."""
    dev = resolve_device(device)
    return _prf(on(generated, dev), on(real, dev), neighborhood)


def _bootstrap_prc(pred: torch.Tensor, target: torch.Tensor, prc_neighborhood: int, prc_bootstrap_subsets: int,
                   prc_bootstrap_size: int, rng_seed: int) -> tuple[float, float, float, float, float, float]:
    """Bootstrap means and standard deviations of precision, recall and F1
    (each side resampled with replacement)."""
    rng = np.random.default_rng(rng_seed)
    out = np.empty((prc_bootstrap_subsets, 3))
    for b in range(prc_bootstrap_subsets):
        gi = rng.integers(0, pred.shape[0], prc_bootstrap_size)
        ri = rng.integers(0, target.shape[0], prc_bootstrap_size)
        out[b] = _prf(pred[torch.as_tensor(gi, device=pred.device)], target[torch.as_tensor(ri, device=pred.device)],
                      prc_neighborhood)
    ps, rs, fs = out.T
    return (float(np.nanmean(ps)), float(np.nanstd(ps)), float(np.nanmean(rs)), float(np.nanstd(rs)),
            float(np.nanmean(fs)), float(np.nanstd(fs)))


def mind_metric(pred, target, num_projections: int = 1000, rng_seed: int = 2020, device="cuda") -> float:
    """Sliced Wasserstein-2 distance: both cohorts projected on random unit
    directions and sorted, the mean squared difference at common quantiles,
    its square root."""
    if np.shape(pred)[0] == 0 or np.shape(target)[0] == 0:
        return float("nan")
    dev = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    dirs = rng.standard_normal((np.shape(pred)[1], num_projections))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True) + 1e-12
    d = on(dirs, dev)
    pp = torch.sort(on(pred, dev) @ d, dim=0).values
    tt = torch.sort(on(target, dev) @ d, dim=0).values
    n = min(pp.shape[0], tt.shape[0])
    if pp.shape[0] != tt.shape[0]:
        q = np.linspace(0, 1, n)
        pp = quantile_sorted(pp, q, dim=0)
        tt = quantile_sorted(tt, q, dim=0)
    return float(np.sqrt(float(((pp - tt) ** 2).mean())))


def compute_feature_similarity(pred: np.ndarray, target: np.ndarray, prefix: str, kid_subsets: int = 100,
                               kid_subset_size: int = 1000, prc_neighborhood: int = 5,
                               prc_bootstrap_subsets: int = 100, prc_bootstrap_size: int | None = None,
                               mind_num_projections: int = 1000, rng_seed: int = 2020,
                               device="cuda") -> dict[str, float]:
    """Dataset-level metrics of one backbone: FID, KID (and std), precision,
    recall, F1 (and bootstrap stds), MIND and the median cosine, keyed
    ``f"{prefix}_<METRIC>"``. Empty input: all NaN."""
    keys = tuple(f"{prefix}_{k}" for k in (
        "FID", "KID", "KID_std", "Precision", "Precision_std", "Recall", "Recall_std", "F1", "F1_std", "MIND",
        "Median_Cosine_Similarity"))
    if pred.size == 0 or target.size == 0:
        return dict.fromkeys(keys, float("nan"))
    if pred.shape[1] != target.shape[1]:
        raise ValueError(f"Feature dim mismatch: pred {pred.shape[1]} vs target {target.shape[1]}")
    dev = resolve_device(device)
    pred, target = _finite_rows(np.asarray(pred, np.float64), np.asarray(target, np.float64))
    if pred.size == 0 or target.size == 0:
        return dict.fromkeys(keys, float("nan"))
    fid = frechet_distance(pred, target, device=dev)
    kid_mean, kid_std = kid_metric(pred, target, kid_subsets, kid_subset_size, rng_seed, device=dev)
    size = prc_bootstrap_size or min(pred.shape[0], target.shape[0])
    prc = _bootstrap_prc(on(pred, dev), on(target, dev), prc_neighborhood, prc_bootstrap_subsets, size, rng_seed)
    mind = mind_metric(pred, target, mind_num_projections, rng_seed, device=dev)
    cos = _median_cosine_similarity(pred, target, dev)
    return dict(zip(keys, (fid, kid_mean, kid_std, *prc, mind, cos)))


def compute_feature_similarity_pairwise(pred: np.ndarray, target: np.ndarray, prefix: str, kid_subsets: int = 100,
                                        kid_subset_size: int = 1000, rng_seed: int = 2020,
                                        device="cuda") -> dict[str, float]:
    """Per-(FOV, t) metrics: FID, KID (and std) and the median cosine."""
    keys = (f"{prefix}_FID", f"{prefix}_KID", f"{prefix}_KID_std", f"{prefix}_Median_Cosine_Similarity")
    if pred.size == 0 or target.size == 0:
        return dict.fromkeys(keys, float("nan"))
    if pred.shape[1] != target.shape[1]:
        raise ValueError(f"Feature dim mismatch: pred {pred.shape[1]} vs target {target.shape[1]}")
    dev = resolve_device(device)
    pred, target = _finite_rows(np.asarray(pred, np.float64), np.asarray(target, np.float64))
    if pred.size == 0 or target.size == 0:
        return dict.fromkeys(keys, float("nan"))
    kid_mean, kid_std = kid_metric(pred, target, kid_subsets, kid_subset_size, rng_seed, device=dev)
    return {
        f"{prefix}_FID": frechet_distance(pred, target, device=dev),
        f"{prefix}_KID": kid_mean,
        f"{prefix}_KID_std": kid_std,
        f"{prefix}_Median_Cosine_Similarity": _median_cosine_similarity(pred, target, dev),
    }
