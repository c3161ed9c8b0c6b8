"""Maximum mean discrepancy with an RBF kernel and a permutation test
(counterpart of ``viscy_tpu/evaluation/mmd.py``), on the device.

The kernel is JAX's: squared Euclidean distances in float64 of the
float32 inputs, ``exp(-sq / (2 bandwidth))`` in float32. The port builds
the pooled kernel once; each permutation's statistic is a masked sum of
it, and the permutations are batched as products of the pooled kernel
(promoted to float64) with their membership indicators. Every sum is in
float64, where JAX sums its float32 kernels in float32 (numpy's pairwise
summation), so ``mmd2`` and the null agree with JAX to the relative error
of those float32 sums. The draws are numpy's: the median heuristic's
subsample from ``default_rng(0)`` and the permutations from
``default_rng(seed)``, or given (``rows``, ``permutations``).
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import cdist, host, on, resolve_device

__all__ = ["compute_mmd_unbiased", "gaussian_rbf_kernel", "median_heuristic", "mmd_permutation_test"]


def _pool(X, Y) -> np.ndarray:
    return np.concatenate([X, Y], axis=0).astype(np.float32)


def median_heuristic(X, Y, subsample: int = 1000, rows: np.ndarray | None = None, device: str = "cuda") -> float:
    """The median of the pooled sample's pairwise squared distances (at
    most ``subsample`` rows, drawn as JAX draws them), plus 1e-12."""
    pool = _pool(X, Y)
    if rows is None and len(pool) > subsample:
        rows = np.random.default_rng(0).choice(len(pool), subsample, replace=False)
    if rows is not None:
        pool = pool[rows]
    x = on(pool, resolve_device(device))
    sq = cdist(x, x, "sqeuclidean", same=True)
    iu = torch.triu_indices(len(x), len(x), offset=1, device=x.device)
    upper = torch.sort(sq[iu[0], iu[1]]).values
    m = upper.numel()
    med = upper[m // 2] if m % 2 else (upper[m // 2 - 1] + upper[m // 2]) / 2
    return float(med) + 1e-12


def _kernel(a: torch.Tensor, b: torch.Tensor, bandwidth: float, same: bool = False) -> torch.Tensor:
    return torch.exp((-cdist(a, b, "sqeuclidean", same) / (2.0 * bandwidth)).to(torch.float32))


def gaussian_rbf_kernel(X, Y, bandwidth: float, device: str = "cuda") -> np.ndarray:
    """``exp(-|x - y|^2 / (2 bandwidth))`` (float32)."""
    dev = resolve_device(device)
    return host(_kernel(on(np.asarray(X, np.float32), dev), on(np.asarray(Y, np.float32), dev), bandwidth))


def _unbiased(k: torch.Tensor, n: int) -> torch.Tensor:
    """MMD^2 from the pooled kernel, X the first ``n`` rows (float64)."""
    m = k.shape[0] - n
    kxx, kyy, kxy = k[:n, :n].double(), k[n:, n:].double(), k[:n, n:].double()
    return ((kxx.sum() - kxx.diagonal().sum()) / (n * (n - 1)) + (kyy.sum() - kyy.diagonal().sum()) / (m * (m - 1))
            - 2 * kxy.sum() / (n * m))


def compute_mmd_unbiased(X, Y, bandwidth: float | None = None, device: str = "cuda") -> float:
    """The unbiased MMD^2 estimate between the rows of X and of Y."""
    dev = resolve_device(device)
    if bandwidth is None:
        bandwidth = median_heuristic(X, Y, device=str(dev))
    pool = on(_pool(X, Y), dev)
    return float(_unbiased(_kernel(pool, pool, bandwidth, same=True), len(X)))


def draw_permutations(n_pool: int, n_permutations: int, seed: int = 0) -> np.ndarray:
    """JAX's permutations: ``default_rng(seed).permutation(n_pool)`` each."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_pool) for _ in range(n_permutations)])


def mmd_permutation_test(X, Y, n_permutations: int = 1000, bandwidth: float | None = None, seed: int = 0,
                         permutations: np.ndarray | None = None, chunk: int = 250, device: str = "cuda") -> dict:
    """The permutation test of X ~ Y: ``{mmd2, p_value, bandwidth,
    null_mean, null_std}`` as JAX returns them. A permutation's X is its
    first ``len(X)`` pooled rows; with ``s`` their indicator and ``t = 1 -
    s``, its statistic is ``(s'Ks - tr_s) / (n(n-1)) + (t'Kt - tr_t) /
    (m(m-1)) - 2 s'Kt / (nm)``, each quadratic form a column of ``K S``."""
    dev = resolve_device(device)
    if bandwidth is None:
        bandwidth = median_heuristic(X, Y, device=str(dev))
    pool = on(_pool(X, Y), dev)
    N, n = pool.shape[0], len(X)
    m = N - n
    k32 = _kernel(pool, pool, bandwidth, same=True)
    observed = float(_unbiased(k32, n))
    k = k32.double()
    del k32
    diag = k.diagonal().clone()
    r = k.sum(dim=1)
    total = r.sum()
    perms = draw_permutations(N, n_permutations, seed) if permutations is None else np.asarray(permutations)
    nulls = []
    for start in range(0, len(perms), chunk):
        block = torch.as_tensor(perms[start: start + chunk, :n], device=dev)
        s = torch.zeros(N, block.shape[0], dtype=k.dtype, device=dev)
        s.scatter_(0, block.T.contiguous(), 1.0)
        sks = (s * (k @ s)).sum(dim=0)
        sr = r @ s
        s_diag = diag @ s
        sxx = (sks - s_diag) / (n * (n - 1))
        syy = (total - 2 * sr + sks - (diag.sum() - s_diag)) / (m * (m - 1))
        sxy = (sr - sks) / (n * m)
        nulls.append(sxx + syy - 2 * sxy)
    null = host(torch.cat(nulls))
    return {
        "mmd2": observed,
        "p_value": float((null >= observed).mean()),
        "bandwidth": bandwidth,
        "null_mean": float(null.mean()),
        "null_std": float(null.std()),
    }
