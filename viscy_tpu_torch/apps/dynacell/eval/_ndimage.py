"""``scipy.ndimage`` filters on a device, bit-identical to scipy: the
Gaussian filter, the maximum filter and the Euclidean distance transform
that the nucleus segmentation runs on whole (20, 2048, 2048) volumes,
where scipy takes a minute for the distance transform alone. The
evaluation calls them on a CUDA device only (:func:`on_card`); on the CPU
it calls scipy itself, so the CPU has one path and the card's is held
against it.

- :func:`gaussian_filter`: scipy's ``correlate1d`` per axis in order, its
  symmetric accumulation (``x0 w0``, then ``(x[-j] + x[j]) w[-j]`` from the
  outermost pair in) in float64, each axis's result stored in the input's
  dtype as scipy stores it, the ``reflect`` boundary. Elementwise IEEE
  additions and products in that order give scipy's bits on the CPU and
  the card.
- :func:`maximum_filter`, :func:`minimum_filter`, :func:`white_tophat`:
  extrema over a box (per axis, ``reflect``): order does not change them.
  A flat grey closing of odd size is the maximum filter, then the minimum.
- :func:`sobel`, :func:`laplace`: scipy's 3-tap ``correlate1d`` passes
  (the antisymmetric ``[-1, 0, 1]``, the symmetric ``[1, 2, 1]`` and ``[1,
  -2, 1]``) in the same order and precision.
- :func:`binary_fill_holes` (host): one labelling of the background in
  place of scipy's dilation from the border, which is slower.
- :func:`distance_transform_edt`: the exact squared distance to the
  nearest background voxel, in int64, by the separable minimum of
  ``g[k] + (j - k)^2`` along each axis, then numpy's float64 square root of
  it on the host; scipy's feature transform is exact too and takes the
  same square root.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["on_card", "reflect_index", "gaussian_filter", "maximum_filter", "minimum_filter", "white_tophat",
           "binary_fill_holes", "distance_transform_edt", "sobel", "laplace"]


def on_card(device) -> bool:
    """Whether the filters run through this module on ``device``: on a CUDA
    device; ``None`` and the CPU take scipy."""
    return device is not None and torch.device(device).type == "cuda"


def reflect_index(n: int, left: int, right: int, device) -> torch.Tensor:
    """Indices of an axis of length ``n`` extended by ``left`` / ``right``
    samples with scipy's ``reflect`` rule (``d c b a | a b c d | d c b a``,
    repeating for extensions longer than the axis)."""
    i = np.mod(np.arange(-left, n + right), 2 * n)
    return torch.as_tensor(np.where(i >= n, 2 * n - 1 - i, i), device=device)


def gaussian_filter(x: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(x, sigma)`` (``reflect``, order 0)."""
    from scipy.ndimage._filters import _gaussian_kernel1d

    r = int(truncate * float(sigma) + 0.5)
    w = _gaussian_kernel1d(float(sigma), 0, r)[::-1]
    dtype = x.dtype
    for axis in range(x.ndim):
        n = x.shape[axis]
        xp = x.double().index_select(axis, reflect_index(n, r, r, x.device))
        acc = xp.narrow(axis, r, n) * float(w[r])
        for j in range(r, 0, -1):
            acc = acc + (xp.narrow(axis, r - j, n) + xp.narrow(axis, r + j, n)) * float(w[r - j])
        x = acc.to(dtype)
    return x


def _correlate3(x: torch.Tensor, axis: int, w: tuple[float, float, float], dtype) -> torch.Tensor:
    """``scipy.ndimage.correlate1d(x, w, axis)`` of a 3-tap ``w`` that is
    symmetric (``x0 w0 + (x[-1] + x[1]) w[-1]``) or antisymmetric (``x0 w0
    + (x[-1] - x[1]) w[-1]``), in float64, stored as ``dtype``."""
    n = x.shape[axis]
    xp = x.double().index_select(axis, reflect_index(n, 1, 1, x.device))
    lo, mid, hi = xp.narrow(axis, 0, n), xp.narrow(axis, 1, n), xp.narrow(axis, 2, n)
    pair = lo + hi if w[0] == w[2] else lo - hi
    return (mid * w[1] + pair * w[0]).to(dtype)


def sobel(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``scipy.ndimage.sobel(x, axis)`` (``reflect``): ``[-1, 0, 1]`` along
    ``axis``, then ``[1, 2, 1]`` along each other axis in order, each stored
    in ``x``'s dtype."""
    out = _correlate3(x, axis, (-1.0, 0.0, 1.0), x.dtype)
    for ii in range(x.ndim):
        if ii != axis:
            out = _correlate3(out, ii, (1.0, 2.0, 1.0), x.dtype)
    return out


def laplace(x: torch.Tensor) -> torch.Tensor:
    """``scipy.ndimage.laplace(x)`` (``reflect``): ``[1, -2, 1]`` along each
    axis, added in axis order."""
    out = _correlate3(x, 0, (1.0, -2.0, 1.0), x.dtype)
    for ii in range(1, x.ndim):
        out = out + _correlate3(x, ii, (1.0, -2.0, 1.0), x.dtype)
    return out


def _box(x: torch.Tensor, size: int, op, axes=None) -> torch.Tensor:
    for axis in range(x.ndim) if axes is None else axes:
        n = x.shape[axis]
        xp = x.index_select(axis, reflect_index(n, size // 2, size - 1 - size // 2, x.device))
        out = xp.narrow(axis, 0, n).clone()
        for k in range(1, size):
            out = op(out, xp.narrow(axis, k, n))
        x = out
    return x


def maximum_filter(x: torch.Tensor, size: int, axes=None) -> torch.Tensor:
    """``scipy.ndimage.maximum_filter(x, size)`` (``reflect``): the window of
    each axis ``[i - size // 2, i + size - 1 - size // 2]``; over ``axes``
    only when given (scipy's ``axes``)."""
    return _box(x, size, torch.maximum, axes)


def minimum_filter(x: torch.Tensor, size: int, axes=None) -> torch.Tensor:
    """``scipy.ndimage.minimum_filter(x, size)`` (``reflect``), over ``axes``
    only when given."""
    return _box(x, size, torch.minimum, axes)


def white_tophat(x: torch.Tensor, size: int) -> torch.Tensor:
    """``scipy.ndimage.white_tophat(x, size=size)`` for an odd ``size``: ``x``
    less its grey opening (a flat box's erosion, then dilation)."""
    if size % 2 == 0:
        raise ValueError("white_tophat on the device takes an odd size")
    return x - maximum_filter(minimum_filter(x, size), size)


def binary_fill_holes(mask: np.ndarray) -> np.ndarray:
    """``scipy.ndimage.binary_fill_holes(mask)`` (host): the background
    components (connected as scipy's default cross connects them) that touch
    no face of the array are filled. scipy dilates the outside into the
    background until it stops; one labelling finds the same components."""
    from scipy import ndimage

    mask = np.asarray(mask, bool)
    bg, n = ndimage.label(~mask)
    outside = np.zeros(n + 1, bool)
    for axis in range(mask.ndim):
        for face in (0, mask.shape[axis] - 1):
            outside[np.take(bg, face, axis=axis)] = True
    outside[0] = False  # label 0: the foreground, kept
    return ~outside[bg]


_FAR = 1 << 60  # "no background yet" in int64 squared distances
_CHECK = 16  # offsets between the checks of the parabola pass


def _parabola_min(g: torch.Tensor, axis: int) -> torch.Tensor:
    """``h[j] = min_k g[k] + (j - k)^2`` along ``axis``: offsets taken in
    order, stopped once every ``h`` is at most the next offset's square (no
    farther ``k`` can then lower it)."""
    n = g.shape[axis]
    h = g.clone()
    for o in range(1, n):
        cand = g.narrow(axis, 0, n - o) + o * o
        tail = h.narrow(axis, o, n - o)
        torch.minimum(tail, cand, out=tail)
        cand = g.narrow(axis, o, n - o) + o * o
        head = h.narrow(axis, 0, n - o)
        torch.minimum(head, cand, out=head)
        if o % _CHECK == 0 and int(h.max()) <= (o + 1) * (o + 1):
            break
    return h


def distance_transform_edt(mask: np.ndarray, device) -> np.ndarray:
    """``scipy.ndimage.distance_transform_edt(mask)`` (unit sampling):
    float64, 0 on the background. A mask without background goes to scipy
    (its result there is the feature transform's, not a distance)."""
    from scipy import ndimage

    m = torch.as_tensor(np.asarray(mask, bool), device=device)
    if bool(m.all()):
        return ndimage.distance_transform_edt(mask)
    n0 = m.shape[0]
    idx = torch.arange(n0, device=device, dtype=torch.int64).reshape(-1, *([1] * (m.ndim - 1)))
    # along the first axis: the nearest background index before and after
    before = torch.where(~m, idx, torch.full_like(idx, -_FAR).expand(m.shape)).cummax(dim=0).values
    after = torch.where(~m, -idx, torch.full_like(idx, -_FAR).expand(m.shape)).flip(0).cummax(dim=0).values.flip(0)
    d = torch.minimum(idx - before, -after - idx)
    g = torch.where(d < (1 << 30), d * d, torch.full_like(d, _FAR))
    for axis in range(1, m.ndim):
        g = _parabola_min(g, axis)
    return np.sqrt(g.double().cpu().numpy())  # numpy's sqrt is IEEE; torch's vectorized CPU one is not always
