"""Tensor helpers the dynacell evaluation shares: numpy's order statistics
(``np.median`` and ``np.quantile``'s ``linear`` rule) on a device, and the
exact division of a tensor by a Python float.

On a CUDA tensor ``x / 2.5`` multiplies by the rounded reciprocal, which can
differ from the quotient in the last bit; :func:`div` divides by a 0-d
tensor on the same device, which is IEEE division on both the CPU and the
card, as numpy's is.
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import host, on, resolve_device

__all__ = ["div", "host", "median", "on", "order_stats", "quantile", "quantile_sorted", "resolve_device"]


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` by IEEE division on ``x``'s device."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def order_stats(x: torch.Tensor, ranks) -> list[float]:
    """The values at 0-based ``ranks`` of the flat ``x`` in ascending order:
    ``kthvalue`` on the CPU (selection), one sort on the card (a 1-D
    ``kthvalue`` there runs in one thread block)."""
    x = x.reshape(-1)
    if x.device.type == "cpu":
        return [float(torch.kthvalue(x, int(r) + 1).values) for r in ranks]
    xs = torch.sort(x).values
    return [float(xs[int(r)]) for r in ranks]


def _lerp(a, b, t):
    """numpy's two-sided ``_lerp``: ``b - (b - a)(1 - t)`` where ``t >= 0.5``."""
    diff = b - a
    return torch.where(t >= 0.5, b - diff * (1 - t), a + diff * t)


def _virtual(n: int, q):
    """numpy's ``linear`` rule: the virtual index ``(n - 1) q``, its floor
    and the next index (both the last at or past the end), and the weight."""
    virt = (n - 1) * np.atleast_1d(np.asarray(q, np.float64))
    prev = np.floor(virt)
    gamma = virt - prev
    nxt = prev + 1
    above = virt >= n - 1
    prev[above] = n - 1
    nxt[above] = n - 1
    return prev.astype(np.int64), nxt.astype(np.int64), gamma


def quantile(x: torch.Tensor, q: float) -> float:
    """``np.quantile(x, q)`` (method ``linear``) of all of ``x``."""
    prev, nxt, gamma = _virtual(x.numel(), q)
    a, b = order_stats(x, [prev[0], nxt[0]])
    t = torch.tensor(gamma[0], dtype=torch.float64)
    return float(_lerp(torch.tensor(a, dtype=torch.float64), torch.tensor(b, dtype=torch.float64), t))


def quantile_sorted(xs: torch.Tensor, q, dim: int = 0) -> torch.Tensor:
    """``np.quantile(x, q, axis=dim)`` (method ``linear``) of ``xs``, which
    is ``x`` sorted along ``dim``; ``q`` an array gives a leading axis of
    ``len(q)``."""
    prev, nxt, gamma = _virtual(xs.shape[dim], q)
    a = xs.index_select(dim, torch.as_tensor(prev, device=xs.device)).movedim(dim, 0)
    b = xs.index_select(dim, torch.as_tensor(nxt, device=xs.device)).movedim(dim, 0)
    t = torch.as_tensor(gamma, dtype=xs.dtype, device=xs.device).reshape(-1, *([1] * (a.ndim - 1)))
    out = _lerp(a, b, t)
    return out[0] if np.ndim(q) == 0 else out


def median(x: torch.Tensor) -> float:
    """``np.median`` of all of ``x``: the middle value, or the mean of the
    two middle values of an even count."""
    n = x.numel()
    if n == 0:
        return float("nan")
    if n % 2:
        return order_stats(x, [n // 2])[0]
    lo, hi = order_stats(x, [n // 2 - 1, n // 2])
    return (lo + hi) / 2
