"""DTW primitives: the accumulated-cost DP, warp paths, DBA (counterpart of
``viscy_tpu/apps/dynaclr/pseudotime/dtw_core.py``).

The O(T N) DP is host kernel H2, ``viscy_tpu_torch/csrc/dtw.cpp``, built
with the host compiler by :mod:`viscy_tpu_torch.ops._build` at first use
and called through ctypes. A failed build or load raises: there is no
fallback. :func:`dtw_accumulated_cost_plain` is the same recurrence as a
Python loop, kept for the tests. The DP stays on the host: DBA aligns
pairs of tens by tens of frames, and a device launch a pair would cost
more than the DP. The pairwise cost matrix is scipy's ``cdist`` (the
backtracking's ``argmin`` ties depend on its bits) and the backtracking is
O(T + N) Python. ``subsequence=True`` frees the query's start and end (the
template must fully take part), the ``SubsequenceAlignment`` semantics
``dtw_align_tracks`` defaults to.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np
from scipy.spatial.distance import cdist

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["dba", "dtw_accumulated_cost", "dtw_accumulated_cost_plain", "dtw_align_pair", "dtw_best_path",
           "dtw_distance", "launches", "subsequence_align"]

_KERNEL = "dtw"
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
launches = {"dtw_dp": 0}  # calls of the host kernel


def _lib() -> ctypes.CDLL:
    from viscy_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    if lib.dtw_dp.argtypes is None:
        lib.dtw_dp.restype = None
        lib.dtw_dp.argtypes = [_DOUBLE_P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _DOUBLE_P]
    return lib


def dtw_accumulated_cost(cost: np.ndarray, subsequence: bool = False) -> np.ndarray:
    """The (T+1, N+1) accumulated-cost matrix of a (T, N) local-cost matrix,
    by host kernel H2."""
    cost = np.ascontiguousarray(cost, np.float64)
    T, N = cost.shape
    acc = np.empty((T + 1, N + 1), np.float64)
    _lib().dtw_dp(cost.ctypes.data_as(_DOUBLE_P), T, N, int(subsequence), acc.ctypes.data_as(_DOUBLE_P))
    launches["dtw_dp"] += 1
    return acc


def dtw_accumulated_cost_plain(cost: np.ndarray, subsequence: bool = False) -> np.ndarray:
    """:func:`dtw_accumulated_cost` as a Python loop (the plain version)."""
    cost = np.asarray(cost, np.float64)
    T, N = cost.shape
    acc = np.full((T + 1, N + 1), np.inf)
    acc[0, 0] = 0.0
    if subsequence:
        acc[0, :] = 0.0
    for i in range(1, T + 1):
        for j in range(1, N + 1):
            acc[i, j] = cost[i - 1, j - 1] + min(acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1])
    return acc


def dtw_best_path(acc: np.ndarray, end_j: int | None = None, subsequence: bool = False) -> np.ndarray:
    """The optimal (i, j) warp path, 0-indexed into the cost matrix; in
    subsequence mode it stops at the free row 0. Ties go to the diagonal,
    then up, then left (``np.argmin``'s first)."""
    T, N = acc.shape[0] - 1, acc.shape[1] - 1
    j = int(np.argmin(acc[T, 1:]) + 1) if end_j is None and subsequence else (end_j or N)
    i = T
    rows = acc.tolist()
    path = []
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        if subsequence and i == 1:
            break
        diag, up, left = rows[i - 1][j - 1], rows[i - 1][j], rows[i][j - 1]
        if diag <= up and diag <= left:
            i, j = i - 1, j - 1
        elif up <= left:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return np.asarray(path, np.int64)


def dtw_align_pair(a: np.ndarray, b: np.ndarray, metric: str = "euclidean") -> tuple[np.ndarray, float]:
    """Global DTW of (T, D) against (N, D): the path over (a, b) indices and
    the total cost."""
    acc = dtw_accumulated_cost(cdist(np.atleast_2d(a), np.atleast_2d(b), metric=metric))
    return dtw_best_path(acc), float(acc[-1, -1])


def subsequence_align(template: np.ndarray, query: np.ndarray, metric: str = "euclidean") -> tuple[np.ndarray, float]:
    """The query segment that best matches the whole template (free query
    start and end): the path over (template, query) indices and its cost."""
    acc = dtw_accumulated_cost(cdist(np.atleast_2d(template), np.atleast_2d(query), metric=metric), subsequence=True)
    end_j = int(np.argmin(acc[-1, 1:]) + 1)
    return dtw_best_path(acc, end_j=end_j, subsequence=True), float(acc[-1, end_j])


def dtw_distance(a: np.ndarray, b: np.ndarray, metric: str = "euclidean") -> float:
    return dtw_align_pair(a, b, metric=metric)[1]


def dba(sequences: list[np.ndarray], max_iter: int = 30, tol: float = 1e-5, init: str = "medoid",
        random_state: int = 42) -> np.ndarray:
    """DTW Barycenter Averaging: the mean trajectory under warping.
    ``init="medoid"`` starts from the sequence of least total DTW cost to the
    others (50 candidates drawn by ``np.random.default_rng(random_state)``
    above 50 sequences); it stops when the mean absolute change is under
    ``tol``."""
    if not sequences:
        raise ValueError("No sequences provided for DBA.")
    if init == "medoid":
        n = len(sequences)
        max_candidates = 50
        if n > max_candidates:
            candidates = np.random.default_rng(random_state).choice(n, max_candidates, replace=False)
        else:
            candidates = np.arange(n)
        costs = np.zeros(len(candidates))
        for ci, i in enumerate(candidates):
            for j in range(n):
                if i != j:
                    costs[ci] += dtw_distance(sequences[i], sequences[j])
        avg = sequences[int(candidates[np.argmin(costs)])].astype(np.float64).copy()
    else:
        avg = sequences[0].astype(np.float64).copy()
    for iteration in range(max_iter):
        accum = np.zeros_like(avg)
        counts = np.zeros(len(avg))
        for seq in sequences:
            path, _ = dtw_align_pair(avg, seq)
            for ia, js in path.tolist():
                accum[ia] += seq[js]
                counts[ia] += 1
        new_avg = accum / np.maximum(counts, 1)[:, None]
        change = float(np.mean(np.abs(new_avg - avg)))
        avg = new_avg
        if change < tol:
            _logger.debug("DBA converged at iteration %d (change=%.2e)", iteration + 1, change)
            break
    return avg
