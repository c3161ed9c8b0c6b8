"""PHATE from first principles on the device (counterpart of
``viscy_tpu/evaluation/phate_native.py``).

The JAX module's algorithm (Moon et al., 2019) in float64 on the device:
PCA to ``n_pca`` (exact, where sklearn's ``PCA`` is exact only for N >= 10
D and D <= 1000 and randomized elsewhere), the kNN alpha-decay kernel, the
row-stochastic diffusion operator, the landmark compression through a
k-means partition, the diffusion time at the von Neumann entropy knee, the
log potential, classical MDS and SMACOF. The entropy and knee (100 numbers)
are numpy on the host.

Departures, each in ``ROADMAP.md`` Queue 3:

- the landmark partition is the port's own mini-batch k-means on the device
  (:func:`minibatch_kmeans`), where JAX calls sklearn's ``MiniBatchKMeans``;
  the two partitions differ, so ``fit`` takes JAX's ``labels`` as an input
  for comparison;
- the classical-MDS eigenvectors get sklearn's deterministic sign (largest
  absolute entry positive) before SMACOF, so the card's eigensolver and the
  CPU's give the same start; JAX keeps LAPACK's signs, so its embedding
  equals the port's up to one sign per component.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import exact_knn, host, on, resolve_device
from viscy_tpu_torch.evaluation.dimensionality_reduction import pca_fit

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["NativePHATE", "minibatch_kmeans", "select_knee", "smacof", "von_neumann_entropy"]


def von_neumann_entropy(singular_values: np.ndarray, t_max: int = 100) -> np.ndarray:
    """H(t), t = 1..t_max: the entropy of the normalized ``sigma_i^t``."""
    s = np.maximum(np.asarray(singular_values, dtype=np.float64), 0.0)
    s = s / max(s.max(), 1e-300)
    ent = np.empty(t_max)
    st = s.copy()
    for i in range(t_max):
        p = st / max(st.sum(), 1e-300)
        nz = p > 0
        ent[i] = -(p[nz] * np.log(p[nz])).sum()
        st = st * s
    return ent


def select_knee(values: np.ndarray) -> int:
    """The 1-based index farthest from the secant through the end points."""
    n = len(values)
    x = np.arange(n, dtype=np.float64)
    y = np.asarray(values, dtype=np.float64)
    p0, p1 = np.array([x[0], y[0]]), np.array([x[-1], y[-1]])
    d = p1 - p0
    norm = np.hypot(*d)
    if norm < 1e-12:
        return 1
    dist = np.abs(d[0] * (p0[1] - y) - d[1] * (p0[0] - x)) / norm
    return int(np.argmax(dist)) + 1


def _alpha_decay(data: torch.Tensor, ref: torch.Tensor, knn: int, decay: float, metric: str,
                 eps_fit: torch.Tensor | None = None):
    """``(affinities (m, knn_max), neighbour indices, eps)``: ``exp(-(d /
    eps_i)^decay)`` over ``knn_max = 3 knn`` neighbours, ``eps_i`` the
    distance to the ``knn``-th; with ``eps_fit`` (the out-of-sample case)
    averaged with the columns' own bandwidths."""
    n_ref = ref.shape[0]
    knn = min(knn, max(1, n_ref - 1))
    knn_max = min(3 * knn, n_ref)
    dists, idx = exact_knn(data, ref, knn_max, metric)
    eps = dists[:, min(knn, knn_max - 1)].clamp_min(1e-12)
    aff = torch.exp(-((dists / eps[:, None]) ** decay))
    if eps_fit is not None:
        aff = 0.5 * aff + 0.5 * torch.exp(-((dists / eps_fit[idx].clamp_min(1e-12)) ** decay))
    return aff, idx, eps


def minibatch_kmeans(x, n_clusters: int, batch_size: int = 1024, n_init: int = 3, n_steps: int | None = None,
                     random_state: int = 42, device: str = "cuda") -> tuple[np.ndarray, float]:
    """Mini-batch k-means (Sculley 2010, the update of sklearn's
    ``MiniBatchKMeans``: each centre moves towards its batch members with
    step ``1 / count``) on ``device`` in float64; returns ``(labels,
    inertia)`` of the best of ``n_init`` runs by full-data inertia. Each run
    seeds by k-means++ on ``3 * batch_size`` rows and takes ``n_steps``
    batches (default: ten passes over the data). Every draw (the seeding
    rows and uniforms, the batches) is numpy's ``default_rng(random_state)``
    on the host."""
    dev = resolve_device(device)
    X = on(x, dev)
    n = X.shape[0]
    n_clusters = min(n_clusters, n)
    rng = np.random.default_rng(random_state)
    steps = n_steps if n_steps is not None else 10 * -(-n // batch_size)
    best = None
    for _ in range(n_init):
        init_rows = rng.choice(n, size=min(n, 3 * batch_size), replace=False)
        uniforms = torch.as_tensor(rng.random(n_clusters), device=dev)
        first = int(rng.integers(len(init_rows)))
        sub = X[torch.as_tensor(init_rows, device=dev)]
        centres = torch.empty(n_clusters, X.shape[1], dtype=X.dtype, device=dev)
        centres[0] = sub[first]
        pot = ((sub - sub[first]) ** 2).sum(1)
        for c in range(1, n_clusters):  # k-means++: the next centre with probability proportional to D^2
            cum = torch.cumsum(pot, 0)
            pick = torch.searchsorted(cum, (uniforms[c] * cum[-1]).reshape(1)).clamp_max(len(sub) - 1)
            centres[c] = sub[pick[0]]
            pot = torch.minimum(pot, ((sub - centres[c]) ** 2).sum(1))
        counts = torch.zeros(n_clusters, dtype=X.dtype, device=dev)
        batches = torch.as_tensor(rng.integers(0, n, size=(steps, min(batch_size, n))), device=dev)
        for s in range(steps):
            xb = X[batches[s]]
            lab = torch.cdist(xb, centres).argmin(1)
            sums = torch.zeros_like(centres).index_add_(0, lab, xb)
            cnt = torch.bincount(lab, minlength=n_clusters).to(X.dtype)
            counts += cnt
            rate = torch.where(counts > 0, cnt / counts.clamp_min(1), 0.0)
            mean = sums / cnt.clamp_min(1)[:, None]
            centres = centres + rate[:, None] * (mean - centres)
        labels, inertia = _assign(X, centres)
        if best is None or inertia < best[1]:
            best = (labels, inertia)
    return host(best[0]), float(best[1])


def _assign(X: torch.Tensor, centres: torch.Tensor, chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    labels, inertia = [], X.new_zeros(())
    cn = (centres * centres).sum(1)
    for s in range(0, X.shape[0], chunk):
        xb = X[s: s + chunk]
        d2 = ((xb * xb).sum(1)[:, None] - 2.0 * xb @ centres.T + cn[None, :]).clamp_min(0.0)
        v, i = d2.min(1)
        labels.append(i)
        inertia = inertia + v.sum()
    return torch.cat(labels), inertia


def _gemm_distances(x: torch.Tensor) -> torch.Tensor:
    """sklearn's ``euclidean_distances(x)``: ``-2 x.x^T + |x|^2 + |x|^2``,
    clipped at 0, zero diagonal, square root."""
    xx = (x * x).sum(1)
    d2 = (-2.0 * (x @ x.T) + xx[:, None] + xx[None, :]).clamp_min(0.0)
    d2.fill_diagonal_(0.0)
    return d2.sqrt()


def smacof(dissimilarities: torch.Tensor, init: torch.Tensor, max_iter: int = 300,
           eps: float = 1e-6) -> tuple[torch.Tensor, float, int]:
    """Metric SMACOF from ``init`` (sklearn's ``_smacof_single`` with
    ``metric=True``): Guttman transforms until the stress falls by less
    than ``eps`` of half the squared distances, or ``max_iter``. Returns
    ``(X, stress, iterations)``; one host sync per iteration."""
    n = dissimilarities.shape[0]
    X = init
    distances = _gemm_distances(X)
    old_stress = None
    it = 0
    for it in range(max_iter):
        distances = torch.where(distances == 0, 1e-5, distances)
        ratio = dissimilarities / distances
        B = -ratio
        B.diagonal().add_(ratio.sum(dim=1))
        X = 1.0 / n * (B @ X)
        distances = _gemm_distances(X)
        stress = float(((distances - dissimilarities) ** 2).sum() / 2)
        if old_stress is not None:
            if (old_stress - stress) / (float((distances**2).sum()) / 2) < eps:
                break
        old_stress = stress
    return X, stress, it + 1


def metric_mds(potentials: torch.Tensor, n_components: int, max_iter: int) -> torch.Tensor:
    """Potential distances, classical MDS (the top eigenvectors of the
    double-centred squared distances, signs made deterministic), then
    SMACOF (JAX's ``_metric_mds``), on the potentials' device."""
    d = torch.cdist(potentials, potentials, compute_mode="donot_use_mm_for_euclid_dist")
    n = d.shape[0]
    j = torch.eye(n, dtype=d.dtype, device=d.device) - 1.0 / n
    b = -0.5 * j @ (d**2) @ j
    w, v = torch.linalg.eigh(b)
    order = torch.argsort(w, descending=True, stable=True)[:n_components]
    vecs = v[:, order]
    signs = torch.sign(vecs[torch.argmax(vecs.abs(), dim=0), torch.arange(vecs.shape[1], device=d.device)])
    init = vecs * signs * w[order].clamp_min(0.0).sqrt()
    emb, _, _ = smacof(d, init, max_iter=max_iter)
    return emb


class NativePHATE:
    """``fit`` / ``fit_transform`` / ``transform`` for the ``phate.PHATE``
    arguments the JAX class takes (``n_components``, ``knn``, ``decay``,
    ``knn_dist``, ``t``, ``gamma``, ``n_pca``, ``n_landmark``,
    ``mds_max_iter``, ``random_state``; ``n_jobs`` accepted and ignored),
    plus ``device``."""

    def __init__(
        self,
        n_components: int = 2,
        knn: int = 5,
        decay: float = 40.0,
        knn_dist: str = "euclidean",
        t: int | str = "auto",
        gamma: float = 1.0,
        n_pca: int | None = 100,
        n_landmark: int = 2000,
        mds_max_iter: int = 300,
        random_state: int | None = 42,
        n_jobs: int = 1,
        device: str = "cuda",
        **_ignored,
    ) -> None:
        if _ignored:
            _logger.info("NativePHATE ignoring kwargs: %s", sorted(_ignored))
        self.n_components = n_components
        self.knn = knn
        self.decay = decay
        self.knn_dist = knn_dist
        self.t = t
        self.gamma = gamma
        self.n_pca = n_pca
        self.n_landmark = n_landmark
        self.mds_max_iter = mds_max_iter
        self.random_state = 42 if random_state is None else random_state
        self.device = resolve_device(device)
        self.embedding_: np.ndarray | None = None
        self.t_: int | None = None

    def _pca(self, X: torch.Tensor, fit: bool) -> torch.Tensor:
        if self.n_pca is None or X.shape[1] <= self.n_pca:
            return X
        if fit:
            scores, _, self._pca_components, self._pca_mean = pca_fit(X, min(self.n_pca, min(X.shape) - 1))
            return scores
        return (X - self._pca_mean) @ self._pca_components.T

    def _potential(self, p_t: torch.Tensor) -> torch.Tensor:
        if self.gamma == 1.0:
            return -torch.log(p_t + 1e-7)
        if self.gamma == 0.0:
            return 2.0 * torch.sqrt(p_t)
        return 2.0 / (1.0 - self.gamma) * (p_t + 1e-7) ** ((1.0 - self.gamma) / 2.0)

    def fit(self, X, labels: np.ndarray | None = None) -> "NativePHATE":
        """Fit on ``X``; with more than ``n_landmark`` rows, ``labels`` (one
        landmark per row, e.g. JAX's ``_labels``) replaces the port's k-means
        partition."""
        dev = self.device
        Xt = on(X, dev)
        n = Xt.shape[0]
        Xp = self._pca(Xt, fit=True)
        self._fit_X = Xp
        aff, idx, eps = _alpha_decay(Xp, Xp, self.knn, self.decay, self.knn_dist)
        self._eps = eps
        rows = torch.arange(n, device=dev).repeat_interleave(idx.shape[1])
        cols = idx.reshape(-1)
        half = 0.5 * aff.reshape(-1)
        # k = (a + a^T) / 2 as an edge list: every kNN entry once in each direction
        er, ec, ev = torch.cat([rows, cols]), torch.cat([cols, rows]), torch.cat([half, half])
        deg = torch.zeros(n, dtype=Xp.dtype, device=dev).index_add_(0, er, ev)
        deg = torch.where(deg == 0, 1.0, deg)
        if n > self.n_landmark:
            m = self.n_landmark
            if labels is None:
                labels, _ = minibatch_kmeans(Xp, m, random_state=self.random_state, device=str(dev))
            lab = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
            p_nm = torch.zeros(n * m, dtype=Xp.dtype, device=dev)
            p_nm.index_put_((er * m + lab[ec],), ev / deg[er], accumulate=True)
            p_nm = p_nm.reshape(n, m)
            k_mn = torch.zeros(m * n, dtype=Xp.dtype, device=dev)
            k_mn.index_put_((lab[er] * n + ec,), ev, accumulate=True)
            k_mn = k_mn.reshape(m, n)
            deg_m = k_mn.sum(dim=1)
            deg_m = torch.where(deg_m == 0, 1.0, deg_m)
            diff_op = (k_mn / deg_m[:, None]) @ p_nm
            self._p_nm, self._labels, self._n_landmark = p_nm, host(lab), m
        else:
            p = torch.zeros(n * n, dtype=Xp.dtype, device=dev)
            p.index_put_((er * n + ec,), ev / deg[er], accumulate=True)
            diff_op = p.reshape(n, n)
            self._p_nm = None
        if self.t == "auto":
            self.t_ = select_knee(von_neumann_entropy(host(torch.linalg.svdvals(diff_op))))
        else:
            self.t_ = int(self.t)
        pot = self._potential(torch.linalg.matrix_power(diff_op, self.t_))
        self._landmark_embedding = metric_mds(pot, self.n_components, self.mds_max_iter)
        emb = self._landmark_embedding if self._p_nm is None else self._p_nm @ self._landmark_embedding
        self.embedding_ = host(emb).astype(np.float32)
        return self

    def fit_transform(self, X, labels: np.ndarray | None = None) -> np.ndarray:
        return self.fit(X, labels=labels).embedding_

    def transform(self, X) -> np.ndarray:
        """New points through their alpha-decay transitions to the fitted
        points (JAX's ``transform``), on the device."""
        if self.embedding_ is None:
            raise RuntimeError("fit before transform")
        dev = self.device
        Xp = self._pca(on(X, dev), fit=False)
        aff, idx, _ = _alpha_decay(Xp, self._fit_X, self.knn, self.decay, self.knn_dist, eps_fit=self._eps)
        deg = aff.sum(dim=1)
        p_new = aff / torch.where(deg == 0, 1.0, deg)[:, None]
        if self._p_nm is not None:
            m = self._n_landmark
            lab = torch.as_tensor(self._labels, device=dev)
            rows = torch.arange(len(Xp), device=dev).repeat_interleave(idx.shape[1])
            p_new_m = torch.zeros(len(Xp) * m, dtype=Xp.dtype, device=dev)
            p_new_m.index_put_((rows * m + lab[idx.reshape(-1)],), p_new.reshape(-1), accumulate=True)
            out = p_new_m.reshape(len(Xp), m) @ self._landmark_embedding
        else:
            out = torch.einsum("nk,nkd->nd", p_new, self._landmark_embedding[idx])
        return host(out).astype(np.float32)
