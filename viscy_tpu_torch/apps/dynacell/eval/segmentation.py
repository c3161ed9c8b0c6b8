"""Segmentation of the evaluation (counterpart of
``viscy_tpu/apps/dynacell/eval/segmentation.py``): the native classical
backend, bit-identical to JAX's. numpy and scipy on the host; on a CUDA
``device`` the Gaussian, extremum and top-hat filters and the distance
transform run there (:mod:`._ndimage`, scipy's bits: a (20, 2048, 2048)
volume's distance transform takes scipy a minute), the labellings, Otsu's
histogram and the watershed stay scipy's.

- Semantic masks (:func:`segment`): blob targets (nucleus, nucleoli,
  lysosomes) by Gaussian smoothing, Otsu, hole filling and small-object
  removal; filament targets (membrane, ER, mitochondria) by a light
  smoothing plus a white top-hat before Otsu.
- Nucleus instances (:func:`segment_nucleus_instances`): the nucleus mask,
  seeds at the local maxima of its smoothed distance transform, and a
  marker watershed of the negative smoothed distance.

The ``cellpose`` backend is refused by name: the package is on neither
machine this port runs on (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from viscy_tpu_torch.apps.dynacell.eval import _ndimage as nd
from viscy_tpu_torch.apps.dynacell.eval._ops import div
from viscy_tpu_torch.preprocess.stats import otsu_threshold

__all__ = [
    "segment",
    "segment_nucleus_instances",
    "prepare_segmentation_model",
    "multi_otsu_thresholds",
    "nucleus_mask",
    "watershed",
]

#: Gaussian sigma (pixels) applied to nucleus fluorescence before
#: thresholding: it damps bright chromatin tips and shot noise that would
#: otherwise raise the Otsu threshold.
NUCLEUS_GAUSSIAN_SIGMA = 1.0

_BLOB_TARGETS = {"nucleus", "nucleoli", "lysosomes"}
_TEXTURE_TARGETS = {"membrane", "er", "mitochondria"}
_ALL_TARGETS = _BLOB_TARGETS | _TEXTURE_TARGETS


def _refuse_cellpose() -> None:
    raise NotImplementedError(
        "segmentation backend 'cellpose' is not ported to viscy_tpu_torch: the cellpose package is not "
        "installed on the machines the port runs on (ROADMAP.md Queue 3); use backend: native")


def multi_otsu_thresholds(values: np.ndarray, n_bins: int = 128) -> tuple[float, float]:
    """Two-threshold (three-class) Otsu: the exhaustive maximum of the
    between-class variance over the histogram. Returns (lower, upper)."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    lo, hi = float(v.min()), float(v.max())
    if hi <= lo:
        return lo, lo
    hist, edges = np.histogram(v, bins=n_bins, range=(lo, hi))
    centers = (edges[:-1] + edges[1:]) / 2
    p = hist / hist.sum()
    w = np.cumsum(p)
    m = np.cumsum(p * centers)
    m_total = m[-1]
    best, best_t = -1.0, (0, n_bins - 1)
    for i in range(1, n_bins - 1):
        w0, m0 = w[i - 1], m[i - 1]
        if w0 <= 0:
            continue
        for j in range(i + 1, n_bins):
            w1 = w[j - 1] - w0
            w2 = 1.0 - w0 - w1
            if w1 <= 0 or w2 <= 0:
                continue
            m1 = m[j - 1] - m0
            m2 = m_total - m0 - m1
            var = w0 * (m0 / w0 - m_total) ** 2 + w1 * (m1 / w1 - m_total) ** 2 + w2 * (
                m2 / w2 - m_total
            ) ** 2
            if var > best:
                best, best_t = var, (i, j)
    return float(centers[best_t[0]]), float(centers[best_t[1]])


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


def _cost_u16(cost, device) -> np.ndarray:
    """The cost rescaled to [0, 65534] and truncated to uint16 (on a CUDA
    ``device``: elementwise IEEE steps, the same integers)."""
    if not nd.on_card(device):
        c = np.asarray(cost, np.float64)
        c = c - c.min()
        cmax = c.max()
        return np.zeros(c.shape, np.uint16) if cmax <= 0 else ((c / cmax) * 65534).astype(np.uint16)
    c = torch.as_tensor(cost, dtype=torch.float64, device=device)
    c = c - float(c.min())
    cmax = float(c.max())
    if cmax <= 0:
        return np.zeros(tuple(c.shape), np.uint16)
    return (div(c, cmax) * 65534).to(torch.int32).cpu().numpy().astype(np.uint16)


def watershed(cost, markers: np.ndarray, mask: np.ndarray | None = None, device=None) -> np.ndarray:
    """Marker-controlled watershed on a float cost image: scipy's
    ``watershed_ift`` floods the cost, rescaled to uint16, from the integer
    markers; a background marker covers ``~mask`` so labels never leak out
    of it. Marker ids are kept."""
    markers = np.asarray(markers, np.int32)
    cost_u16 = _cost_u16(cost, device)
    work = markers.copy()
    bg_id = int(markers.max()) + 1
    if mask is not None:
        work[(~np.asarray(mask, bool)) & (work == 0)] = bg_id
    out = ndimage.watershed_ift(cost_u16, work)
    out[out == bg_id] = 0
    if mask is not None:
        out[~np.asarray(mask, bool)] = 0
    return out.astype(np.int32)


def _segment_native(img: np.ndarray, target_name: str, device=None) -> np.ndarray:
    """Classical semantic segmentation of one organelle class; its filters
    on a CUDA ``device`` (scipy's bits, :mod:`._ndimage`)."""
    x = np.asarray(img, np.float32)
    if target_name in _BLOB_TARGETS:
        if not nd.on_card(device):
            sm = ndimage.gaussian_filter(x, NUCLEUS_GAUSSIAN_SIGMA)
            mask = ndimage.binary_fill_holes(sm > otsu_threshold(sm.ravel()))
        else:
            sm = nd.gaussian_filter(torch.as_tensor(x, device=device), NUCLEUS_GAUSSIAN_SIGMA).cpu().numpy()
            mask = nd.binary_fill_holes(sm > otsu_threshold(sm.ravel()))
        mask = _remove_small(mask, min_size=max(16, mask.size // 50_000))
    else:
        # filaments and granules: a white top-hat keeps thin bright features
        # that the global threshold would swallow into the background
        if not nd.on_card(device):
            sm = ndimage.gaussian_filter(x, 0.5)
            enhanced = sm + ndimage.white_tophat(sm, size=5)
        else:
            sm = nd.gaussian_filter(torch.as_tensor(x, device=device), 0.5)
            enhanced = (sm + nd.white_tophat(sm, 5)).cpu().numpy()
        mask = enhanced > otsu_threshold(enhanced.ravel())
        mask = _remove_small(mask, min_size=max(8, mask.size // 100_000))
    return mask.astype(bool)


def nucleus_mask(img: np.ndarray, device=None) -> np.ndarray:
    """Semantic nucleus mask of one image or stack."""
    return _segment_native(img, "nucleus", device)


def segment(img: np.ndarray, target_name: str | None = None, seg_model=None, *, backend: str = "native",
            spacing_zyx=None, device=None) -> np.ndarray:
    """Semantic (boolean) segmentation of one z-stack for ``target_name``;
    the filters on a CUDA ``device`` (the same mask)."""
    if target_name not in _ALL_TARGETS:
        raise ValueError(f"Unsupported target_name: {target_name!r} (expected one of {sorted(_ALL_TARGETS)})")
    if backend == "cellpose":
        _refuse_cellpose()
    return _segment_native(img, target_name, device)


def segment_nucleus_instances(img: np.ndarray, spacing_zyx=None, *, seg_model=None, backend: str = "native",
                              min_distance: int = 5, mask: np.ndarray | None = None, device=None) -> np.ndarray:
    """Nucleus instance labels (int32, 0 background) from fluorescence:
    the semantic mask, its Euclidean distance transform smoothed, seeds at
    its local maxima ``min_distance`` apart where the distance exceeds 1,
    then the watershed of the negative smoothed distance. With no seed, the
    mask's connected components. ``mask`` is ``nucleus_mask(img)`` when the
    caller has it already. On a CUDA ``device`` the filters and the distance
    transform run there (scipy's bits); the labelling and the watershed
    stay scipy's on the host. ``spacing_zyx`` is accepted for JAX's
    signature (the native backend works in voxels)."""
    if backend == "cellpose":
        _refuse_cellpose()
    mask = nucleus_mask(img, device) if mask is None else mask
    if not mask.any():
        return np.zeros(mask.shape, np.int32)
    if not nd.on_card(device):
        edt = ndimage.distance_transform_edt(mask)
        edt_s = ndimage.gaussian_filter(edt, 1.0)
        peaks = (edt_s == ndimage.maximum_filter(edt_s, size=2 * min_distance + 1)) & (edt > 1.0)
    else:
        edt = torch.as_tensor(nd.distance_transform_edt(mask, device), device=device)
        edt_s = nd.gaussian_filter(edt, 1.0)
        peaks = ((edt_s == nd.maximum_filter(edt_s, 2 * min_distance + 1)) & (edt > 1.0)).cpu().numpy()
        del edt
    seeds, n = ndimage.label(peaks, structure=np.ones((3,) * mask.ndim))
    if n == 0:
        return ndimage.label(mask)[0].astype(np.int32)
    return watershed(-edt_s, seeds, mask=mask, device=device)


def prepare_segmentation_model(config) -> None:
    """The segmentation model a config asks for: none for the native
    backend; ``cellpose`` (and ``cellpose_watershed``) raise by name."""
    seg_cfg = (config.get("segmentation") if isinstance(config, dict) else getattr(config, "segmentation", None)) or {}
    backend = seg_cfg.get("backend", "native") if isinstance(seg_cfg, dict) else getattr(seg_cfg, "backend", "native")
    if backend in ("cellpose", "cellpose_watershed"):
        _refuse_cellpose()
    return None
