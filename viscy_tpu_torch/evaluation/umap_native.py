"""UMAP from first principles on the device (counterpart of
``viscy_tpu/evaluation/umap_native.py``).

The same algorithm as the JAX module (McInnes, Healy & Melville, 2018):
exact kNN, the smooth-kNN bandwidth bisection, the probabilistic t-conorm
of the fuzzy 1-skeleton, a spectral initialisation, and edge-sampled SGD
with negative sampling, synchronous per epoch.

Where each part runs:

- the kNN search, the bisection and the membership weights: float64 on the
  device (:func:`~viscy_tpu_torch.evaluation._ops.exact_knn`);
- the t-conorm, the weak-edge cut and ``find_ab_params``: scipy on the
  host, the JAX module's own calls, so the edge list comes out in its order;
- the spectral initialisation: sklearn's ``SpectralEmbedding(affinity=
  "precomputed")`` rebuilt with scipy on the host (:func:`spectral_layout`);
- the layout SGD: float64 on the device, :func:`_add_rows` in place of
  ``np.add.at``: a sum in index order with no global state, so two calls
  give the same layout (on CUDA too, where ``index_add_`` uses atomics).

The negative samples are numpy's: ``default_rng(random_state).integers``
per epoch, as the JAX loop draws them, or given whole as ``negatives``.

One departure: sklearn's brute-force kNN (above 15 features) forms the
squared distance as ``|x|^2 - 2 x.y + |y|^2``, so a point's distance to
itself is a rounding residue (up to about 1e-6 at 768 features) for about
half of the points, and the JAX module then takes that residue as ``rho``
(its "smallest positive distance"). The port's distance to self is exactly
0, so ``rho`` is the distance to the nearest other point, as UMAP defines
it (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import exact_knn, host, on, resolve_device

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["NativeUMAP", "find_ab_params", "fuzzy_simplicial_set", "optimize_layout", "smooth_knn_dist",
           "spectral_layout"]

_SMOOTH_K_TOLERANCE = 1e-5
_MIN_K_DIST_SCALE = 1e-3


def smooth_knn_dist(knn_dists: torch.Tensor, k: float, n_iter: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point ``(sigma, rho)`` (UMAP paper, algorithm 3): ``rho`` the
    smallest positive distance of the row, ``sigma`` the bisection root of
    ``sum_j exp(-max(0, d_ij - rho) / sigma) = log2(k)``, floored at 1e-3 of
    the row's (or, with ``rho`` 0, all rows') mean distance. Float64, on
    ``knn_dists``' device; the iteration stops when every row is within
    1e-5, as in JAX."""
    d = knn_dists.to(torch.float64)
    n = d.shape[0]
    target = float(np.log2(k))
    rho = torch.where(d > 0.0, d, torch.inf).min(dim=1).values
    rho = torch.where(torch.isfinite(rho), rho, 0.0)
    lo = torch.zeros(n, dtype=d.dtype, device=d.device)
    hi = torch.full_like(lo, torch.inf)
    mid = torch.ones_like(lo)
    shifted = (d - rho[:, None]).clamp_min(0.0)
    for _ in range(n_iter):
        err = torch.exp(-shifted / mid[:, None]).sum(dim=1) - target
        if bool((err.abs() < _SMOOTH_K_TOLERANCE).all()):
            break
        too_big = err > 0
        hi = torch.where(too_big, mid, hi)
        lo = torch.where(too_big, lo, mid)
        mid = torch.where(too_big, (lo + hi) / 2.0, torch.where(torch.isfinite(hi), (lo + hi) / 2.0, mid * 2))
    floor = torch.where(rho > 0.0, _MIN_K_DIST_SCALE * d.mean(dim=1), _MIN_K_DIST_SCALE * d.mean())
    return torch.maximum(mid, floor), rho


def _memberships(data: torch.Tensor, n_neighbors: int, metric: str) -> tuple[np.ndarray, np.ndarray]:
    """``(weights, indices)`` of each point's kNN on the host, self included."""
    dists, idx = exact_knn(data, data, n_neighbors, metric)
    sigma, rho = smooth_knn_dist(dists, k=float(n_neighbors))
    w = torch.exp(-(dists - rho[:, None]).clamp_min(0.0) / sigma[:, None])
    return host(w), host(idx)


def fuzzy_simplicial_set(data, n_neighbors: int, metric: str = "euclidean", device: str = "cuda"):
    """The symmetrized fuzzy 1-skeleton of ``data`` as a
    ``scipy.sparse.coo_matrix`` (JAX's entry order): kNN and memberships on
    ``device`` in float64, ``W + W^T - W o W^T`` with scipy."""
    import scipy.sparse as sp

    dev = resolve_device(device)
    x = on(data, dev)
    w, knn_idx = _memberships(x, n_neighbors, metric)
    n = x.shape[0]
    rows = np.repeat(np.arange(n), knn_idx.shape[1])
    cols = knn_idx.ravel()
    vals = w.ravel()
    keep = rows != cols
    g = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, n)).tocsr()
    gt = g.T.tocsr()
    return (g + gt - g.multiply(gt)).tocoo()


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1) -> tuple[float, float]:
    """``(a, b)`` of ``1 / (1 + a d^(2b))`` fitted to the offset exponential
    (scipy's ``curve_fit`` on the host, as JAX)."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0.0, spread * 3.0, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2.0 * b))

    params, _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=5000)
    return float(params[0]), float(params[1])


def spectral_layout(graph, n_components: int, random_state: int) -> np.ndarray:
    """sklearn's ``SpectralEmbedding(n_components, affinity="precomputed",
    random_state=random_state).fit_transform(graph)`` with scipy (the
    ARPACK path of ``_spectral_embedding``): the normalized Laplacian and
    its degree vector, the diagonal set to 1, ``eigsh(k=n_components + 1,
    sigma=-1e-5, which="LM", tol=0)`` from ``v0 =
    RandomState(random_state).uniform(-1, 1, n)``, the eigenvectors divided
    by the degree vector, each row's sign flipped so its largest absolute
    entry is positive, and the first dropped."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import laplacian as csgraph_laplacian
    from scipy.sparse.linalg import eigsh

    adjacency = sp.csr_matrix(graph, dtype=np.float64)
    k = n_components + 1
    lap, dd = csgraph_laplacian(adjacency, normed=True, return_diag=True)
    lap = lap.tocoo()
    lap.data[lap.row == lap.col] = 1.0
    lap = lap.todia() if np.unique(lap.row - lap.col).size <= 7 else lap.tocsr()
    v0 = np.random.RandomState(random_state).uniform(-1, 1, lap.shape[0])
    lap = sp.csr_matrix(lap)
    lap.indices = lap.indices.astype(np.int32, copy=False)
    lap.indptr = lap.indptr.astype(np.int32, copy=False)
    _, vecs = eigsh(lap, k=k, sigma=-1e-5, which="LM", tol=0, v0=v0)
    emb = vecs.T[:k] / dd
    signs = np.sign(emb[np.arange(k), np.argmax(np.abs(emb), axis=1)])
    emb *= signs[:, None]
    return emb[1:k].T


def _spectral_init(graph, n_components: int, random_state: int) -> np.ndarray:
    """The spectral layout scaled to a 10-unit box plus ``N(0, 1e-4)`` noise
    from ``default_rng(random_state)``, as float32 (JAX's ``_spectral_init``;
    a graph of at most ``n_components + 2`` points starts uniform in
    [-10, 10]). An eigensolver failure raises, where JAX falls back to a
    random start."""
    n = graph.shape[0]
    rng = np.random.default_rng(random_state)
    if n <= n_components + 2:
        return rng.uniform(-10.0, 10.0, size=(n, n_components))
    emb = spectral_layout(graph, n_components, random_state)
    emb = emb * (10.0 / max(np.abs(emb).max(), 1e-12))
    emb = emb + rng.normal(scale=1e-4, size=emb.shape)
    return emb.astype(np.float32)


def epoch_schedule(weights: np.ndarray, n_epochs: int) -> list[np.ndarray]:
    """The edges each epoch samples: edge ``e`` fires when its clock
    ``next_sample`` (starting at ``max(w) / w_e`` and advancing by it) is at
    most ``epoch + 1`` (float64 numpy, as JAX's loop)."""
    epochs_per_sample = weights.max() / weights
    next_sample = epochs_per_sample.copy()
    out = []
    for epoch in range(n_epochs):
        active = np.flatnonzero(next_sample <= epoch + 1)
        out.append(active)
        next_sample[active] += epochs_per_sample[active]
    return out


def draw_negatives(schedule: list[np.ndarray], n: int, negative_sample_rate: int,
                   random_state: int) -> list[np.ndarray]:
    """JAX's negative samples: ``default_rng(random_state).integers(0, n,
    (active edges, rate))`` for each epoch that samples an edge."""
    rng = np.random.default_rng(random_state)
    n_neg = int(float(negative_sample_rate))
    return [rng.integers(0, n, size=(len(a), n_neg)) if len(a) and n_neg > 0 else None for a in schedule]


def _add_rows(x: torch.Tensor, rows: torch.Tensor, values: torch.Tensor) -> None:
    """``np.add.at(x, rows, values)``, each row's terms added in index
    order. On the CPU ``index_add_`` adds them one after another. On CUDA
    ``index_put_(accumulate=True)`` sorts the indices stably and adds each
    row's terms in that order, without atomics; that is torch's default
    there, where ``index_add_`` is deterministic only in the process-wide
    deterministic mode."""
    if x.is_cuda:
        x.index_put_((rows,), values, accumulate=True)
    else:
        x.index_add_(0, rows, values)


def optimize_layout(emb, head, tail, weights, n_epochs: int, a: float, b: float, lr: float,
                    negative_sample_rate: int, random_state: int, clip: float = 4.0,
                    negatives: list | None = None, device: str = "cuda") -> np.ndarray:
    """Edge-sampled SGD on UMAP's cross-entropy (JAX's ``_optimize_layout``),
    float64 on ``device``: each epoch the edges whose clock fires get one
    attractive step on both ends, then ``negative_sample_rate`` repulsive
    steps on the head from ``negatives`` (by default JAX's draws), each step
    clipped to ``clip`` and scaled by the epoch's learning rate. Returns
    float32, as JAX."""
    dev = resolve_device(device)
    schedule = epoch_schedule(np.asarray(weights, np.float64), n_epochs)
    if negatives is None:
        negatives = draw_negatives(schedule, int(np.asarray(emb).shape[0]), negative_sample_rate, random_state)
    x = on(np.ascontiguousarray(emb, dtype=np.float64), dev).contiguous()
    head_t = torch.as_tensor(np.asarray(head, np.int64), device=dev)
    tail_t = torch.as_tensor(np.asarray(tail, np.int64), device=dev)
    for epoch in range(n_epochs):
        active = schedule[epoch]
        if not len(active):
            continue
        alpha = lr * (1.0 - epoch / float(n_epochs))
        sel = torch.as_tensor(active, device=dev)
        h, t = head_t[sel], tail_t[sel]
        diff = x[h] - x[t]
        d2 = (diff * diff).sum(dim=1).clamp_min(1e-12)
        coef = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2**b + 1.0)
        g = (coef[:, None] * diff).clamp(-clip, clip) * alpha
        _add_rows(x, h, g)
        _add_rows(x, t, -g)
        neg = negatives[epoch]
        if neg is not None:
            neg = torch.as_tensor(neg, device=dev)
            m, n_neg = neg.shape
            diff = x[h][:, None, :] - x[neg.reshape(-1)].reshape(m, n_neg, -1)
            d2 = (diff * diff).sum(dim=2).clamp_min(1e-12)
            rep = (2.0 * b) / ((0.001 + d2) * (a * d2**b + 1.0))
            g = (rep[:, :, None] * diff).clamp(-clip, clip) * alpha
            total = g[:, 0]
            for j in range(1, n_neg):  # numpy's order along a non-contiguous axis
                total = total + g[:, j]
            _add_rows(x, h, total)
    return host(x).astype(np.float32)


class NativeUMAP:
    """``fit`` / ``fit_transform`` / ``transform`` for the ``umap.UMAP``
    arguments the JAX class takes (``n_components``, ``n_neighbors``,
    ``min_dist``, ``spread``, ``metric`` (euclidean, sqeuclidean or cosine),
    ``n_epochs``, ``negative_sample_rate``, ``learning_rate``,
    ``random_state``), plus ``device``. Other keyword arguments are logged
    and ignored, as in JAX."""

    def __init__(
        self,
        n_components: int = 2,
        n_neighbors: int = 15,
        min_dist: float = 0.1,
        spread: float = 1.0,
        metric: str = "euclidean",
        n_epochs: int | None = None,
        negative_sample_rate: int = 5,
        learning_rate: float = 1.0,
        random_state: int | None = 42,
        device: str = "cuda",
        **_ignored,
    ) -> None:
        if _ignored:
            _logger.info("NativeUMAP ignoring kwargs: %s", sorted(_ignored))
        self.n_components = n_components
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.spread = spread
        self.metric = metric
        self.n_epochs = n_epochs
        self.negative_sample_rate = negative_sample_rate
        self.learning_rate = learning_rate
        self.random_state = 42 if random_state is None else random_state
        self.device = resolve_device(device)
        self.embedding_: np.ndarray | None = None

    def prepare(self, X) -> dict:
        """Everything before the layout: the graph's kept edges ``head``,
        ``tail``, ``weights``, the float32 ``init``, ``a``, ``b`` and
        ``n_epochs`` (JAX's ``fit`` up to ``_optimize_layout``)."""
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        n_neighbors = min(self.n_neighbors, max(2, n - 1))
        graph = fuzzy_simplicial_set(X, n_neighbors, self.metric, device=str(self.device))
        n_epochs = self.n_epochs or (500 if n < 10_000 else 200)
        w = graph.data.copy()
        w[w < w.max() / float(n_epochs)] = 0.0
        keep = w > 0
        a, b = find_ab_params(self.spread, self.min_dist)
        return dict(head=graph.row[keep], tail=graph.col[keep], weights=w[keep],
                    init=_spectral_init(graph, self.n_components, self.random_state), a=a, b=b, n_epochs=n_epochs)

    def fit(self, X, negatives: list | None = None) -> "NativeUMAP":
        p = self.prepare(X)
        self.embedding_ = optimize_layout(
            p["init"], p["head"], p["tail"], p["weights"], n_epochs=p["n_epochs"], a=p["a"], b=p["b"],
            lr=self.learning_rate, negative_sample_rate=self.negative_sample_rate, random_state=self.random_state,
            negatives=negatives, device=str(self.device))
        self._fit_X = np.asarray(X, dtype=np.float64)
        return self

    def fit_transform(self, X, negatives: list | None = None) -> np.ndarray:
        return self.fit(X, negatives=negatives).embedding_

    def transform(self, X) -> np.ndarray:
        """New points as fuzzy-weighted barycentres of their fitted
        neighbours (JAX's ``transform``), on the device."""
        if self.embedding_ is None:
            raise RuntimeError("fit before transform")
        dev = self.device
        k = min(self.n_neighbors, self._fit_X.shape[0])
        dists, idx = exact_knn(on(X, dev), on(self._fit_X, dev), k, self.metric)
        sigma, rho = smooth_knn_dist(dists, k=float(k))
        w = torch.exp(-(dists - rho[:, None]).clamp_min(0.0) / sigma[:, None])
        w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)
        emb = on(self.embedding_, dev)
        return host(torch.einsum("nk,nkd->nd", w, emb[idx])).astype(np.float32)
