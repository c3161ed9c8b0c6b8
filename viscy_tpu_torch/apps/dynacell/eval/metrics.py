"""Pixel, mask and per-cell metrics of the dynacell benchmark (counterpart
of ``viscy_tpu/apps/dynacell/eval/metrics.py``).

- On the device, in float64: :func:`pcc`, :func:`ssim3d` (a uniform window
  with ``scipy.ndimage.uniform_filter``'s ``reflect`` boundary and its
  window placement, clipped per axis to the volume) and
  :func:`compute_pixel_metrics` with the spectral suite of
  :mod:`.spectral`.
- On the host, bit-identical to JAX: :func:`evaluate_segmentations`,
  :func:`cp_regionprops` (with GLCM texture; its Sobel and Laplace filters
  on a CUDA device, scipy's bits), :func:`per_cell_similarity`,
  :func:`build_crops` and :func:`features_from_crops`. Each visits the
  labels through one ``ndimage.find_objects`` sweep and works inside each
  cell's bounding box (JAX also sorts the whole label volume with
  ``np.unique``, and :func:`build_crops` scans it once per label).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from scipy import ndimage

from viscy_tpu_torch.apps.dynacell.eval import _ndimage as nd
from viscy_tpu_torch.apps.dynacell.eval._ops import div, on, resolve_device

__all__ = [
    "evaluate_segmentations",
    "compute_pixel_metrics",
    "pcc",
    "ssim3d",
    "cp_regionprops",
    "active_cp_feature_names",
    "drop_paired_nonfinite_rows",
    "per_cell_similarity",
    "build_crops",
    "features_from_crops",
    "deep_features",
    "CP_FEATURE_VERSION",
    "MIN_SPECTRAL_DEPTH",
]


def _minmax_norm(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Min-max to [0, 1] in float32 (host; JAX's arithmetic)."""
    x = x.astype(np.float32)
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / max(hi - lo, eps)


def _minmax_norm_t(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    lo, hi = float(x.min()), float(x.max())
    return div(x - lo, max(hi - lo, eps))


def _robust_norm(x: np.ndarray, p_lo: float = 1.0, p_hi: float = 99.0, eps: float = 1e-8) -> np.ndarray:
    """Percentile-clip to [p_lo, p_hi], then min-max to [0, 1] (float32)."""
    lo, hi = np.percentile(x, (p_lo, p_hi))
    x = np.clip(x, lo, hi)
    return ((x - lo) / ((hi - lo) + eps)).astype(np.float32)


# -- pixel tier (device) --------------------------------------------------------
def pcc(a, b, mask=None, device="cuda") -> float:
    """Pearson correlation in float64 (inside a boolean ``mask`` when given)."""
    dev = resolve_device(device)
    a, b = on(a, dev), on(b, dev)
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask), device=dev) if not isinstance(mask, torch.Tensor) else mask.to(dev)
        a, b = a[m], b[m]
    if a.numel() == 0:
        return float("nan")
    a = a - a.mean()
    b = b - b.mean()
    denom = float(a.std(unbiased=False)) * float(b.std(unbiased=False))
    return float((a * b).mean()) / denom if denom > 0 else float("nan")


def uniform_filter(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``scipy.ndimage.uniform_filter(x, size, mode="reflect")``: a moving
    mean per axis over ``[i - s // 2, i + s - 1 - s // 2]`` (the window's
    ``s`` shifted slices of the reflected axis added in order, then divided
    by ``s``), axes of size 1 untouched."""
    for axis, s in enumerate(size):
        if s <= 1:
            continue
        n = x.shape[axis]
        xp = x.index_select(axis, nd.reflect_index(n, s // 2, s - 1 - s // 2, x.device))
        acc = xp.narrow(axis, 0, n).clone()
        for k in range(1, s):
            acc += xp.narrow(axis, k, n)
        x = div(acc, float(s))
    return x


def ssim3d(img1, img2, win_size: int = 7, data_range: float = 1.0, k1: float = 0.01, k2: float = 0.03, mask=None,
           scale_invariant: bool = False, device="cuda") -> float:
    """Windowed SSIM of two 2-D or 3-D arrays with a uniform window of
    ``win_size`` clipped per axis to the array. ``scale_invariant`` first
    least-squares fits a gain and offset of ``img2`` onto ``img1`` (inside
    ``mask`` when given) and takes ``img1``'s range as the data range."""
    dev = resolve_device(device)
    x, y = on(img1, dev), on(img2, dev)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    m = None
    if mask is not None:
        m = mask.to(dev) if isinstance(mask, torch.Tensor) else torch.as_tensor(np.asarray(mask, bool), device=dev)
    if scale_invariant:
        ym = y[m] if m is not None else y.reshape(-1)
        xm = x[m] if m is not None else x.reshape(-1)
        vy = float(ym.var(unbiased=False))
        if vy > 1e-30:
            gain = float(((xm - xm.mean()) * (ym - ym.mean())).mean()) / vy
            y = (y - float(ym.mean())) * gain + float(xm.mean())
        data_range = float(max(float(x.max() - x.min()), 1e-8))

    size = tuple(min(win_size, s) for s in x.shape)
    mu_x = uniform_filter(x, size)
    mu_y = uniform_filter(y, size)
    mu_xx = uniform_filter(x * x, size)
    mu_yy = uniform_filter(y * y, size)
    mu_xy = uniform_filter(x * y, size)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    sx = mu_xx - mu_x**2
    sy = mu_yy - mu_y**2
    sxy = mu_xy - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / ((mu_x**2 + mu_y**2 + c1) * (sx + sy + c2))
    if m is not None:
        vals = ssim_map[m]
        return float(vals.mean()) if vals.numel() else float("nan")
    return float(ssim_map.mean())


#: below this Z depth the spectral metrics run per slice in 2-D: the radial
#: Nyquist of a thin anisotropic stack is capped by its coarse Z axis, which
#: would discard nearly all lateral content
MIN_SPECTRAL_DEPTH = 8


def _spectral_inputs(p: torch.Tensor, t: torch.Tensor, spacing):
    """(pred, target, spacing) of each slab: the volume, or each z-slice of
    a thin stack (averaged by the callers)."""
    if p.ndim == 3 and p.shape[0] < MIN_SPECTRAL_DEPTH:
        sp2 = None if spacing is None else list(spacing)[-2:]
        return [(p[z], t[z], sp2) for z in range(p.shape[0])]
    return [(p, t, None if spacing is None else list(spacing))]


def compute_pixel_metrics(prediction, target, spacing: Sequence[float] | None = None, fsc_kwargs: dict | None = None,
                          spectral_pcc_kwargs: dict | None = None, multiband_ev: bool = False,
                          device="cuda") -> dict[str, float]:
    """Pixel metrics of one (D, H, W) prediction against its target: PCC,
    SSIM, NRMSE and PSNR (the last three on min-max normalized volumes),
    and ``Spectral_PCC``, ``*_FSC_Resolution`` and ``Multiband_EV_NC`` when
    asked. Thin stacks (D < 8) score the spectral metrics per z-slice in
    2-D and average them."""
    from viscy_tpu_torch.apps.dynacell.eval.spectral import fsc_resolution, multiband_ev_score, spectral_pcc

    dev = resolve_device(device)
    p, t = on(prediction, dev), on(target, dev)
    pn, tn = _minmax_norm_t(p), _minmax_norm_t(t)
    mse = float(((pn - tn) ** 2).mean())
    metrics: dict[str, float] = {
        "PCC": pcc(t, p, device=dev),
        "SSIM": ssim3d(tn, pn, device=dev),
        "NRMSE": float(np.sqrt(mse)),
        "PSNR": float(10.0 * np.log10(1.0 / mse)) if mse > 0 else float("inf"),
    }
    del pn, tn
    if spectral_pcc_kwargs is None and fsc_kwargs is None and not multiband_ev:
        return metrics
    slabs = _spectral_inputs(p, t, spacing)
    if spectral_pcc_kwargs is not None:
        metrics["Spectral_PCC"] = float(np.mean(
            [spectral_pcc(pp, tt, spacing=sp, device=dev, **spectral_pcc_kwargs) for pp, tt, sp in slabs]))
    if fsc_kwargs is not None:
        per_slab = [fsc_resolution(tt, pp, spacing=sp, device=dev, **fsc_kwargs) for pp, tt, sp in slabs]
        for k in per_slab[0]:
            metrics[f"{k.upper()}_FSC_Resolution"] = float(np.mean([r[k] for r in per_slab]))
    if multiband_ev:
        metrics["Multiband_EV_NC"] = float(np.mean(
            [multiband_ev_score(pp, tt, spacing=sp, device=dev)[0] for pp, tt, sp in slabs]))
    return metrics


# -- mask tier (host) ------------------------------------------------------------
def evaluate_segmentations(segmented_pred, segmented_gt) -> dict[str, float]:
    """Binary segmentation metrics (Dice, IoU, precision, recall, accuracy
    and the confusion counts); any non-zero value is foreground."""
    pred = np.asarray(segmented_pred)
    gt = np.asarray(segmented_gt)
    if pred.shape != gt.shape:
        raise ValueError(f"Shape mismatch: {pred.shape} != {gt.shape}")
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    tp = int(np.count_nonzero(pred & gt))
    fp = int(np.count_nonzero(pred)) - tp
    fn = int(np.count_nonzero(gt)) - tp
    tn = pred.size - tp - fp - fn

    def ratio(n, d):
        return float(n / d) if d else 0.0

    return {
        "Dice": ratio(2 * tp, 2 * tp + fp + fn),
        "IoU": ratio(tp, tp + fp + fn),
        "Precision": ratio(tp, tp + fp),
        "Recall": ratio(tp, tp + fn),
        "Accuracy": ratio(tp + tn, tp + tn + fp + fn),
        "TP": float(tp),
        "FP": float(fp),
        "FN": float(fn),
        "TN": float(tn),
    }


# -- CP feature tier (host) ------------------------------------------------------
_CP_BASE_FEATURE_NAMES: tuple[str, ...] = (
    "intensity_mean",
    "intensity_std",
    "intensity_min",
    "intensity_max",
    "p10",
    "p25",
    "p50",
    "p75",
    "p90",
    "iqr",
    "skewness",
    "kurtosis",
    "gradient_mean",
    "gradient_std",
    "laplacian_var",
)
_GLCM_PROP_KEYS: tuple[str, ...] = ("contrast", "dissimilarity", "homogeneity", "ASM", "energy", "correlation",
                                    "entropy")
_CP_GLCM_FEATURE_NAMES: tuple[str, ...] = tuple(f"glcm_{k}" for k in _GLCM_PROP_KEYS)

#: version tag recorded in the cache manifest: a bump invalidates CP caches
CP_FEATURE_VERSION = "v2_dist_texture"


def active_cp_feature_names(glcm_enabled: bool) -> tuple[str, ...]:
    """Ordered CP column names (GLCM columns appended when enabled)."""
    return _CP_BASE_FEATURE_NAMES + _CP_GLCM_FEATURE_NAMES if glcm_enabled else _CP_BASE_FEATURE_NAMES


def drop_paired_nonfinite_rows(pred: np.ndarray, target: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop the rows where either side has a non-finite value."""
    if pred.shape[0] == 0:
        return pred, target
    valid = np.isfinite(pred).all(axis=1) & np.isfinite(target).all(axis=1)
    if valid.all():
        return pred, target
    return pred[valid], target[valid]


def _sobel_magnitude(img: np.ndarray, device=None) -> np.ndarray:
    """Gradient magnitude by per-axis Sobel, over sqrt(ndim) (skimage's);
    the Sobel passes and squares on a CUDA ``device`` (scipy's bits), the
    square root numpy's."""
    if not nd.on_card(device):
        acc = np.zeros(img.shape, np.float64)
        for axis in range(img.ndim):
            g = ndimage.sobel(img, axis=axis, mode="reflect")
            acc += g * g
        return np.sqrt(acc / img.ndim)
    x = torch.as_tensor(img, device=device)
    acc = torch.zeros(x.shape, dtype=torch.float64, device=device)
    for axis in range(x.ndim):
        g = nd.sobel(x, axis)
        acc += (g * g).double()
    return np.sqrt(acc.cpu().numpy() / img.ndim)


def _laplace(img: np.ndarray, device=None) -> np.ndarray:
    if not nd.on_card(device):
        return ndimage.laplace(img.astype(np.float64), mode="reflect")
    return nd.laplace(torch.as_tensor(img.astype(np.float64), device=device)).cpu().numpy()


def _cells(labels: np.ndarray) -> list[tuple[int, tuple]]:
    """``(label, bounding-box slices)`` of every positive label, ascending,
    from one ``find_objects`` sweep (the labels of ``np.unique(labels)``
    above 0)."""
    labels = np.asarray(labels)
    if labels.size == 0 or int(labels.max()) <= 0:
        return []
    objects = ndimage.find_objects(labels)
    return [(i + 1, sl) for i, sl in enumerate(objects) if sl is not None]


def _per_cell_glcm(img: np.ndarray, labels: np.ndarray, glcm_cfg: dict, cells) -> np.ndarray:
    """Per-cell GLCM Haralick props (columns ``_CP_GLCM_FEATURE_NAMES``) on
    the robust-normalized image, quantized over the shared [0, 1] range; a
    3-D crop is its single slice or its max projection."""
    from viscy_tpu_torch.evaluation.feature import _glcm, _glcm_props

    levels = int(glcm_cfg.get("levels", 32))
    distances = tuple(glcm_cfg.get("distances", (1,)))
    rows = []
    for lab, sl in cells:
        crop = np.asarray(img[sl], np.float64)
        mask = labels[sl] == lab
        if crop.ndim == 3:
            crop = crop[0] if crop.shape[0] == 1 else crop.max(axis=0)
            mask = mask[0] if mask.shape[0] == 1 else mask.any(axis=0)
        q = np.clip((crop * (levels - 1)).astype(np.int32), 0, levels - 1)
        q = np.where(mask, q, 0).astype(np.uint8)
        props_acc: dict[str, list[float]] = {k: [] for k in _GLCM_PROP_KEYS}
        for d in distances:
            for off in ((0, d), (d, 0), (d, d), (d, -d)):
                p = _glcm_props(_glcm(q, off, levels=levels))
                for k in _GLCM_PROP_KEYS:
                    props_acc[k].append(p.get(k, p.get(k.lower(), 0.0)))
        rows.append([float(np.mean(props_acc[k])) for k in _GLCM_PROP_KEYS])
    return np.asarray(rows, float).reshape(len(rows), len(_GLCM_PROP_KEYS))


def cp_regionprops(image: np.ndarray, cell_segmentation: np.ndarray, spacing: Sequence[float] | None = None, *,
                   norm: dict | None = None, glcm_cfg: dict | None = None, device=None) -> np.ndarray:
    """Per-cell conventional ("CP") features of one image and its labels:
    ``(n_cells, n_features)`` in the order of :func:`active_cp_feature_names`
    (intensity distribution, gradient and Laplacian texture, optional GLCM)
    on the robust-normalized image. On a CUDA ``device`` the Sobel and
    Laplace filters run there (scipy's bits); the rest is numpy on the host."""
    norm = dict(norm or {})
    glcm_cfg = dict(glcm_cfg or {})
    glcm_enabled = bool(glcm_cfg.get("enabled", False))
    names = active_cp_feature_names(glcm_enabled)
    labels = np.asarray(cell_segmentation)
    cells = _cells(labels)
    if not cells:
        return np.empty((0, len(names)), float)
    img = _robust_norm(np.asarray(image), norm.get("p_lo", 1.0), norm.get("p_hi", 99.0))
    grad = _sobel_magnitude(img, device)
    lap = _laplace(img, device)
    rows = []
    for lab, sl in cells:
        mask = labels[sl] == lab
        vals = np.asarray(img[sl], np.float64)[mask]
        gvals = grad[sl][mask]
        lvals = lap[sl][mask]
        p10, p25, p50, p75, p90 = np.percentile(vals, (10, 25, 50, 75, 90))
        mean = vals.mean()
        std = vals.std()
        if vals.size < 2 or std == 0.0:
            skew = kurt = np.nan
        else:
            z = (vals - mean) / std
            skew = float((z**3).mean())
            kurt = float((z**4).mean() - 3.0)
        rows.append([mean, std, vals.min(), vals.max(), p10, p25, p50, p75, p90, p75 - p25, skew, kurt,
                     gvals.mean(), gvals.std(), float(lvals.std() ** 2)])
    out = np.asarray(rows, float)
    if glcm_enabled:
        out = np.concatenate([out, _per_cell_glcm(img, labels, glcm_cfg, cells)], axis=1)
    return out


# -- per-cell paired similarity (host) ---------------------------------------------
def _pcc_np(a: np.ndarray, b: np.ndarray, mask: np.ndarray) -> float:
    a = np.asarray(a, np.float64)[mask]
    b = np.asarray(b, np.float64)[mask]
    if a.size == 0:
        return float("nan")
    a = a - a.mean()
    b = b - b.mean()
    denom = a.std() * b.std()
    return float((a * b).mean() / denom) if denom > 0 else float("nan")


def _ssim_np(x: np.ndarray, y: np.ndarray, win_size: int, mask: np.ndarray) -> float:
    """JAX's host ``ssim3d(..., mask=mask, scale_invariant=True)``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    ym, xm = y[mask], x[mask]
    vy = ym.var()
    if vy > 1e-30:
        gain = float(((xm - xm.mean()) * (ym - ym.mean())).mean() / vy)
        y = (y - ym.mean()) * gain + xm.mean()
    data_range = float(max(x.max() - x.min(), 1e-8))
    size = tuple(min(win_size, s) for s in x.shape)
    mu_x = ndimage.uniform_filter(x, size)
    mu_y = ndimage.uniform_filter(y, size)
    mu_xx = ndimage.uniform_filter(x * x, size)
    mu_yy = ndimage.uniform_filter(y * y, size)
    mu_xy = ndimage.uniform_filter(x * y, size)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    sx = mu_xx - mu_x**2
    sy = mu_yy - mu_y**2
    sxy = mu_xy - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / ((mu_x**2 + mu_y**2 + c1) * (sx + sy + c2))
    vals = ssim_map[mask]
    return float(vals.mean()) if vals.size else float("nan")


def _cell_ssim(gt_crop: np.ndarray, pred_crop: np.ndarray, mask: np.ndarray, *, min_size: int = 7) -> float:
    """2-D scale-invariant masked SSIM of one cell crop (NaN when smaller
    than ``min_size``); 3-D crops are max-projected first."""
    if gt_crop.ndim == 3:
        gt_crop, pred_crop, mask = gt_crop.max(axis=0), pred_crop.max(axis=0), mask.any(axis=0)
    if min(gt_crop.shape[-2:]) < min_size:
        return float("nan")
    return _ssim_np(gt_crop, pred_crop, min_size, mask)


def per_cell_similarity(predict_t: np.ndarray, target_t: np.ndarray, cell_segmentation_t: np.ndarray, *,
                        metrics: tuple[str, ...] = ("pcc",), reduce: tuple[str, ...] = ("mean", "median"),
                        z_slab: slice | None = None) -> dict[str, float]:
    """Per-cell paired GT-against-prediction similarity, reduced over the
    cells with finite values: ``{f"PerCell_{METRIC}_{reduce}": value}``.
    An empty or unknown ``metrics`` or ``reduce`` raises."""
    if not metrics or set(metrics) - {"pcc", "ssim"}:
        raise ValueError(f"cell_similarity.metrics must be a non-empty subset of {{'pcc','ssim'}}; got {metrics!r}")
    if not reduce or set(reduce) - {"mean", "median"}:
        raise ValueError(f"cell_similarity.reduce must be a non-empty subset of {{'mean','median'}}; got {reduce!r}")
    if z_slab is not None:
        predict_t, target_t, cell_segmentation_t = predict_t[z_slab], target_t[z_slab], cell_segmentation_t[z_slab]
    labels = np.asarray(cell_segmentation_t)
    per_metric: dict[str, list[float]] = {m: [] for m in metrics}
    for lab, sl in _cells(labels):
        mask = labels[sl] == lab
        gt_crop = np.asarray(target_t[sl], np.float64)
        pred_crop = np.asarray(predict_t[sl], np.float64)
        if "pcc" in metrics:
            per_metric["pcc"].append(_pcc_np(gt_crop, pred_crop, mask))
        if "ssim" in metrics:
            per_metric["ssim"].append(_cell_ssim(gt_crop, pred_crop, mask))
    out: dict[str, float] = {}
    for m in metrics:
        vals = np.asarray(per_metric[m], float)
        finite = vals[np.isfinite(vals)]
        for r in reduce:
            key = f"PerCell_{m.upper()}_{r}"
            if finite.size == 0:
                out[key] = float("nan")
            else:
                out[key] = float(finite.mean()) if r == "mean" else float(np.median(finite))
    return out


# -- deep-feature crops (host) -----------------------------------------------------
def build_crops(image: np.ndarray, cell_segmentation: np.ndarray, patch_size: int, *,
                z_slab: slice | None = None) -> list[np.ndarray]:
    """Per-cell ``(patch_size, patch_size)`` crops of the min-max normalized
    max-Z projection, centred on each cell's footprint (the centre of mass
    of its projected mask, truncated), masked to the footprint and
    zero-padded past the image border."""
    if image.shape != cell_segmentation.shape:
        raise ValueError(f"Shape mismatch: image {image.shape} vs labels {cell_segmentation.shape}")
    if z_slab is not None:
        image, cell_segmentation = image[z_slab], cell_segmentation[z_slab]
    img2d = _minmax_norm(np.max(image, axis=0))
    H, W = img2d.shape
    half = patch_size // 2
    labels = np.asarray(cell_segmentation)
    crops: list[np.ndarray] = []
    for lab, sl in _cells(labels):
        ys, xs = sl[-2], sl[-1]
        foot = np.any(labels[sl] == lab, axis=0)  # the footprint inside the bounding box
        coords = np.argwhere(foot)
        if len(coords) == 0:
            continue
        cy, cx = (np.mean(coords + (ys.start, xs.start), axis=0)).astype(int)
        y0, y1 = cy - half, cy + half
        x0, x1 = cx - half, cx + half
        ry0, ry1, rx0, rx1 = max(0, y0), min(H, y1), max(0, x0), min(W, x1)
        crop = np.zeros((max(0, ry1 - ry0), max(0, rx1 - rx0)), np.float32)
        # the window's overlap with the bounding box holds the masked image
        oy0, oy1, ox0, ox1 = max(ry0, ys.start), min(ry1, ys.stop), max(rx0, xs.start), min(rx1, xs.stop)
        if oy1 > oy0 and ox1 > ox0:
            crop[oy0 - ry0:oy1 - ry0, ox0 - rx0:ox1 - rx0] = (
                img2d[oy0:oy1, ox0:ox1] * foot[oy0 - ys.start:oy1 - ys.start, ox0 - xs.start:ox1 - xs.start])
        py0, py1 = max(0, -y0), max(0, y1 - H)
        px0, px1 = max(0, -x0), max(0, x1 - W)
        if py0 or py1 or px0 or px1:
            crop = np.pad(crop, ((py0, py1), (px0, px1)))
        crops.append(crop)
    return crops


def features_from_crops(crops: list[np.ndarray], feature_extractor) -> np.ndarray:
    """A deep-feature extractor over masked 2-D crops: its
    ``extract_features_batch(crops) -> (n, d)`` when it has one, else
    ``extract_features(crop) -> (d,)`` per crop; float32."""
    if not crops:
        return np.empty((0, 0), np.float32)
    batch_fn = getattr(feature_extractor, "extract_features_batch", None)
    if batch_fn is not None:
        out = np.asarray(batch_fn(crops))
        return out.reshape(len(crops), -1).astype(np.float32, copy=False)
    feats = [np.asarray(feature_extractor.extract_features(c)).reshape(-1) for c in crops]
    return np.stack(feats, axis=0).astype(np.float32)


def deep_features(image: np.ndarray, cell_segmentation: np.ndarray, feature_extractor, patch_size: int, *,
                  z_slab: slice | None = None) -> np.ndarray:
    """Per-cell deep embeddings ``(n_cells, d)`` of one image."""
    return features_from_crops(build_crops(image, cell_segmentation, patch_size, z_slab=z_slab), feature_extractor)
