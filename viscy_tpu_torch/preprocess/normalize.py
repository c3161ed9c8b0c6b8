"""Intensity normalization helpers (counterpart of
``viscy_tpu/preprocess/normalize.py``): z-scoring, its inverse, percentile
clipping and a native CLAHE, ``hist_adapteq_2d`` (numpy tile histograms and
bilinear interpolation between the tile mappings, skimage's
``equalize_adapthist`` semantics, for hosts without scikit-image).
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["zscore", "unzscore", "hist_clipping", "hist_adapteq_2d"]

_EPS = sys.float_info.epsilon


def zscore(input_image: np.ndarray, im_mean: float | None = None, im_std: float | None = None) -> np.ndarray:
    """Z-score normalize (NaN-aware when the statistics are not supplied)."""
    if not im_mean:
        im_mean = np.nanmean(input_image)
    if not im_std:
        im_std = np.nanstd(input_image)
    return (input_image - im_mean) / (im_std + _EPS)


def unzscore(im_norm: np.ndarray, zscore_median: float, zscore_iqr: float) -> np.ndarray:
    """Invert median / IQR normalization."""
    return im_norm * (zscore_iqr + _EPS) + zscore_median


def hist_clipping(
    input_image: np.ndarray, min_percentile: float = 2, max_percentile: float = 98
) -> np.ndarray:
    """Clip intensities to percentile bounds."""
    if not (min_percentile < max_percentile <= 100):
        raise ValueError(f"invalid percentiles ({min_percentile}, {max_percentile})")
    pmin, pmax = np.percentile(input_image, (min_percentile, max_percentile))
    return np.clip(input_image, pmin, pmax)


def hist_adapteq_2d(
    input_image: np.ndarray,
    kernel_size: int | tuple[int, int] | None = None,
    clip_limit: float | None = None,
    nbins: int = 256,
) -> np.ndarray:
    """CLAHE for 2D images (skimage ``equalize_adapthist`` semantics):
    per-tile clipped-histogram equalization with bilinear interpolation
    between tile mappings. Returns values in [0, 1].
    """
    img = np.asarray(input_image, np.float64)
    nrows, ncols = img.shape
    if kernel_size is None:
        kernel_size = (max(nrows // 8, 1), max(ncols // 8, 1))
    elif isinstance(kernel_size, int):
        if kernel_size >= min(nrows, ncols):
            raise ValueError("kernel size must be smaller than the image")
        kernel_size = (kernel_size, kernel_size)
    clip_limit = 0.01 if clip_limit is None else clip_limit
    if not 0 <= clip_limit <= 1:
        raise ValueError(f"Clip limit {clip_limit} is out of range [0, 1]")

    lo, hi = img.min(), img.max()
    norm = (img - lo) / max(hi - lo, _EPS)
    bins = np.minimum((norm * (nbins - 1)).astype(np.int64), nbins - 1)

    ty = int(np.ceil(nrows / kernel_size[0]))
    tx = int(np.ceil(ncols / kernel_size[1]))
    # per-tile clipped CDF lookup tables
    luts = np.zeros((ty, tx, nbins), np.float64)
    centers_y = np.zeros(ty)
    centers_x = np.zeros(tx)
    for i in range(ty):
        y0, y1 = i * kernel_size[0], min((i + 1) * kernel_size[0], nrows)
        centers_y[i] = (y0 + y1 - 1) / 2
        for j in range(tx):
            x0, x1 = j * kernel_size[1], min((j + 1) * kernel_size[1], ncols)
            centers_x[j] = (x0 + x1 - 1) / 2
            hist = np.bincount(bins[y0:y1, x0:x1].ravel(), minlength=nbins).astype(np.float64)
            n = hist.sum()
            if clip_limit > 0 and n > 0:
                limit = max(clip_limit * n, 1.0)
                excess = np.clip(hist - limit, 0, None).sum()
                hist = np.minimum(hist, limit) + excess / nbins
            cdf = np.cumsum(hist)
            luts[i, j] = cdf / max(cdf[-1], _EPS)

    # bilinear interpolation between the four surrounding tile mappings
    yy = np.arange(nrows)[:, None]
    xx = np.arange(ncols)[None, :]
    fy = np.clip(np.searchsorted(centers_y, yy.ravel(), side="right") - 1, 0, ty - 2 if ty > 1 else 0)
    fx = np.clip(np.searchsorted(centers_x, xx.ravel(), side="right") - 1, 0, tx - 2 if tx > 1 else 0)
    fy = fy.reshape(nrows, 1)
    fx = fx.reshape(1, ncols)
    cy0 = centers_y[fy]
    cx0 = centers_x[fx]
    if ty > 1:
        wy = np.clip((yy - cy0) / np.maximum(centers_y[fy + 1] - cy0, _EPS), 0, 1)
    else:
        wy = np.zeros((nrows, 1))
    if tx > 1:
        wx = np.clip((xx - cx0) / np.maximum(centers_x[fx + 1] - cx0, _EPS), 0, 1)
    else:
        wx = np.zeros((1, ncols))
    fy2 = np.minimum(fy + 1, ty - 1)
    fx2 = np.minimum(fx + 1, tx - 1)
    v00 = luts[fy, fx, bins]
    v01 = luts[fy, fx2, bins]
    v10 = luts[fy2, fx, bins]
    v11 = luts[fy2, fx2, bins]
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11)).astype(
        np.float32
    )


# the reference spelling
hist_adapteq_2D = hist_adapteq_2d
