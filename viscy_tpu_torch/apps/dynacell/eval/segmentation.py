"""Nucleus instance segmentation of the test stage (counterpart of
``viscy_tpu/apps/dynacell/eval/segmentation.py``'s native backend):
Gaussian smoothing, Otsu, hole filling and small-object removal for the
semantic mask, then seeds at the local maxima of the smoothed distance
transform and a marker watershed on its negative. numpy and scipy only.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from viscy_tpu_torch.preprocess.stats import otsu_threshold

#: Gaussian sigma (pixels) applied to nucleus fluorescence before
#: thresholding: it damps bright chromatin tips and shot noise that would
#: otherwise raise the Otsu threshold.
NUCLEUS_GAUSSIAN_SIGMA = 1.0


def _remove_small(mask: np.ndarray, min_size: int) -> np.ndarray:
    """Drop connected components below ``min_size`` pixels."""
    if min_size <= 1:
        return mask
    labels, n = ndimage.label(mask)
    if n == 0:
        return mask
    sizes = np.bincount(labels.ravel())
    keep = sizes >= min_size
    keep[0] = False
    return keep[labels]


def watershed(cost: np.ndarray, markers: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """Marker-controlled watershed on a float cost image: scipy's
    ``watershed_ift`` floods the cost, rescaled to uint16, from the integer
    markers; a background marker covers ``~mask`` so labels never leak out
    of it. Marker ids are kept."""
    markers = np.asarray(markers, np.int32)
    c = np.asarray(cost, np.float64)
    c = c - c.min()
    cmax = c.max()
    cost_u16 = np.zeros(c.shape, np.uint16) if cmax <= 0 else ((c / cmax) * 65534).astype(np.uint16)
    work = markers.copy()
    bg_id = int(markers.max()) + 1
    if mask is not None:
        work[(~np.asarray(mask, bool)) & (work == 0)] = bg_id
    out = ndimage.watershed_ift(cost_u16, work)
    out[out == bg_id] = 0
    if mask is not None:
        out[~np.asarray(mask, bool)] = 0
    return out.astype(np.int32)


def nucleus_mask(img: np.ndarray) -> np.ndarray:
    """Semantic nucleus mask of one image (the JAX ``_segment_native``'s
    nucleus branch)."""
    sm = ndimage.gaussian_filter(np.asarray(img, np.float32), NUCLEUS_GAUSSIAN_SIGMA)
    mask = ndimage.binary_fill_holes(sm > otsu_threshold(sm.ravel()))
    return _remove_small(mask, min_size=max(16, mask.size // 50_000)).astype(bool)


def segment_nucleus_instances(img: np.ndarray, min_distance: int = 5) -> np.ndarray:
    """Nucleus instance labels (int32, 0 background) from fluorescence:
    the semantic mask, its Euclidean distance transform smoothed, seeds at
    its strict local maxima ``min_distance`` apart where the distance
    exceeds 1, then the watershed of the negative smoothed distance. With
    no seed, the mask's connected components."""
    mask = nucleus_mask(img)
    if not mask.any():
        return np.zeros(mask.shape, np.int32)
    edt = ndimage.distance_transform_edt(mask)
    edt_s = ndimage.gaussian_filter(edt, 1.0)
    peaks = (edt_s == ndimage.maximum_filter(edt_s, size=2 * min_distance + 1)) & (edt > 1.0)
    seeds, n = ndimage.label(peaks, structure=np.ones((3,) * mask.ndim))
    if n == 0:
        return ndimage.label(mask)[0].astype(np.int32)
    return watershed(-edt_s, seeds, mask=mask)
