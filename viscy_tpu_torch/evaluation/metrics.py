"""Instance-segmentation metrics of the test stage (counterpart of
``viscy_tpu/evaluation/metrics.py``'s ``mean_average_precision``).

The pairwise IoU comes from the joint histogram of the two label images
(one ``np.bincount`` of ``pred * (T + 1) + target`` over dense instance
ids), not from (N, H, W) instance masks and a float64 product: a 1024^2
frame can hold hundreds of instances, and the dense route needs P x H W
float64 values per side. The counts are the same exact integers either
way, so every IoU, AP and AR equals the JAX package's.
"""

from __future__ import annotations

import numpy as np


def _dense_ids(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """Flat ids: 0 for background, 1..N for the instances in ascending label
    order (the order ``labels_to_masks`` stacks them in), and N."""
    ids, inverse = np.unique(labels, return_inverse=True)
    inst = ids != 0
    lut = np.where(inst, np.cumsum(inst), 0)
    return lut[inverse.reshape(-1)], int(inst.sum())


def label_iou_matrix(pred_labels: np.ndarray, target_labels: np.ndarray) -> np.ndarray:
    """(P, T) float64 IoU of every predicted instance with every target one."""
    p, n_p = _dense_ids(pred_labels)
    t, n_t = _dense_ids(target_labels)
    joint = np.bincount(p * (n_t + 1) + t, minlength=(n_p + 1) * (n_t + 1)).reshape(n_p + 1, n_t + 1)
    inter = joint[1:, 1:].astype(np.float64)
    union = joint[1:].sum(axis=1)[:, None] + joint[:, 1:].sum(axis=0)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def _ap_at_threshold(iou: np.ndarray, thr: float) -> tuple[float, float]:
    """COCO-style AP/AR at one IoU threshold with uniform scores: greedy
    match each prediction (in order) to its best unmatched GT, then
    101-point-interpolated AP over the cumulative PR curve."""
    n_pred, n_tgt = iou.shape
    if n_tgt == 0:
        return (0.0, 0.0) if n_pred else (float("nan"), float("nan"))
    if n_pred == 0:
        return 0.0, 0.0
    matched = np.zeros(n_tgt, bool)
    tp = np.zeros(n_pred, bool)
    for i in range(n_pred):
        cand = np.where(~matched & (iou[i] >= thr))[0]
        if cand.size:
            j = cand[np.argmax(iou[i, cand])]
            matched[j] = True
            tp[i] = True
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(~tp)
    recall = tp_cum / n_tgt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    # monotone non-increasing precision envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    rec_grid = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, rec_grid, side="left")
    p_interp = np.where(idx < n_pred, precision[np.minimum(idx, n_pred - 1)], 0.0)
    return float(p_interp.mean()), float(recall[-1])


def mean_average_precision(
    pred_labels: np.ndarray,
    target_labels: np.ndarray,
    iou_thresholds: np.ndarray | None = None,
) -> dict:
    """COCO-style instance-segmentation mAP of one pair of 2-D label images
    (torchmetrics ``MeanAveragePrecision(iou_type="segm")`` with uniform
    scores): ``map`` over IoU 0.50:0.95, ``map_50``, ``map_75``, ``mar_100``
    and the instance counts."""
    pred_labels, target_labels = np.asarray(pred_labels), np.asarray(target_labels)
    for labels in (pred_labels, target_labels):
        if labels.ndim != 2:
            raise ValueError(f"Labels must be 2D, got shape {labels.shape}.")
    if pred_labels.shape != target_labels.shape:
        raise ValueError(f"label images differ in shape: {pred_labels.shape} vs {target_labels.shape}")
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    iou = label_iou_matrix(pred_labels, target_labels)
    aps, ars = zip(*(_ap_at_threshold(iou, float(thr)) for thr in iou_thresholds))
    return {
        "map": float(np.nanmean(aps)),
        "map_50": _ap_at_threshold(iou, 0.5)[0],
        "map_75": _ap_at_threshold(iou, 0.75)[0],
        "mar_100": float(np.nanmean(ars)),
        "num_pred": int(iou.shape[0]),
        "num_target": int(iou.shape[1]),
    }
