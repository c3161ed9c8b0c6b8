"""Instance-segmentation average precision, Cellpose's definition
(counterpart of ``viscy_tpu/apps/dynacell/eval/instance_metrics.py``):
per IoU threshold AP = TP / (TP + FP + FN) under one-to-one matching by
``scipy.optimize.linear_sum_assignment`` (solved once for the sweep, on the
objects that overlap), the symmetric best Dice, and the 0.50..0.95 sweep.
numpy and scipy on the host, bit-identical to JAX where the optimal
matching is unique.

The label relabelling and the overlap matrix count with ``bincount`` in one
pass over the volume (JAX sorts it with ``np.unique`` and scatters with
``np.add.at``); the counts, and so every result, are the same integers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DEFAULT_IOU_THRESHOLDS", "instance_average_precision", "mean_instance_dice"]

DEFAULT_IOU_THRESHOLDS = (0.50, 0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.85, 0.90, 0.95)
"""IoU thresholds of the AP sweep (Cellpose / StarDist standard)."""

_PRIMARY_THRESHOLD = 0.50


def _relabel_sequential(labels: np.ndarray) -> np.ndarray:
    """Dense relabel to ``0, 1..K`` (background stays 0; disjoint pieces that
    share an id stay one object): ``np.unique``'s inverse, shifted by one
    when there is no background."""
    labels = np.asarray(labels)
    if labels.size and np.issubdtype(labels.dtype, np.integer) and int(labels.min()) >= 0 \
            and int(labels.max()) <= 4 * labels.size:
        present = np.bincount(labels.ravel()) > 0
        uniq = np.flatnonzero(present)
        lut = np.zeros(present.size, np.intp)
        lut[uniq] = np.arange(uniq.size)
        inv = lut[labels]
    else:
        uniq, inv = np.unique(labels, return_inverse=True)
        inv = inv.reshape(labels.shape)
    return inv if uniq[0] == 0 else inv + 1


def _iou_matrix(gt: np.ndarray, pred: np.ndarray, n_gt: int, n_pred: int) -> np.ndarray:
    """Object-wise IoU matrix ``(n_gt, n_pred)`` of sequential label images."""
    flat = gt.ravel().astype(np.int64) * (n_pred + 1) + pred.ravel()
    overlap = np.bincount(flat, minlength=(n_gt + 1) * (n_pred + 1)).reshape(n_gt + 1, n_pred + 1)
    gt_area = overlap.sum(axis=1)
    pred_area = overlap.sum(axis=0)
    inter = overlap[1:, 1:].astype(np.float64)
    union = gt_area[1:, None] + pred_area[None, 1:] - inter
    return np.divide(inter, union, out=np.zeros_like(inter), where=union > 0)


def _matched_ious(iou: np.ndarray, positive_only: bool) -> np.ndarray:
    """The IoUs of the one-to-one assignment maximizing the total IoU (the
    matrix padded square with zeros), Cellpose's matching. The assignment
    does not depend on the threshold: it is solved once and counted at each
    (JAX solves it again per threshold). With ``positive_only`` (every
    threshold above 0) the objects that overlap nothing are left out
    first: they can only be matched at IoU 0, which no threshold counts,
    and the optimal assignments of the overlapping objects are the same
    (the counts equal JAX's unless two optimal assignments tie). A
    prediction of tens of thousands of fragments would otherwise take a
    square matrix of gigabytes."""
    from scipy.optimize import linear_sum_assignment

    if positive_only:
        iou = iou[np.ix_(iou.any(axis=1), iou.any(axis=0))]
    if iou.size == 0:
        return np.zeros(0)
    n = max(iou.shape)
    cost = np.zeros((n, n))
    cost[: iou.shape[0], : iou.shape[1]] = iou
    rows, cols = linear_sum_assignment(-cost)
    return cost[rows, cols]


def mean_instance_dice(gt: np.ndarray, pred: np.ndarray, n_gt: int, n_pred: int) -> float:
    """Symmetric best Dice: each object's best IoU in both directions as
    Dice ``2u / (1 + u)``, averaged; NaN when both sides are empty, 0 when
    one is."""
    if n_gt == 0 and n_pred == 0:
        return float("nan")
    if n_gt == 0 or n_pred == 0:
        return 0.0
    iou = _iou_matrix(gt, pred, n_gt, n_pred)
    best = np.concatenate([iou.max(axis=1), iou.max(axis=0)])
    return float(np.mean(2.0 * best / (1.0 + best)))


def instance_average_precision(labels_pred: np.ndarray, labels_gt: np.ndarray,
                               iou_thresholds=DEFAULT_IOU_THRESHOLDS) -> dict:
    """AP sweep of predicted against ground-truth instance labels:
    ``n_gt`` / ``n_pred``, ``AP_<th>`` per threshold, ``mAP``,
    ``instance_dice`` and ``instance_{TP,FP,FN}@0.50``. Both sides empty:
    NaN; one side empty: zeros."""
    thresholds = [float(t) for t in iou_thresholds]
    pred = _relabel_sequential(labels_pred)
    gt = _relabel_sequential(labels_gt)
    n_pred = int(pred.max())
    n_gt = int(gt.max())

    iou = None
    if n_gt == 0 and n_pred == 0:
        ap_vals = [float("nan")] * len(thresholds)
        tp = fp = fn = float("nan")
    elif n_gt == 0 or n_pred == 0:
        ap_vals = [0.0] * len(thresholds)
        tp, fp, fn = 0.0, float(n_pred), float(n_gt)
    else:
        iou = _iou_matrix(gt, pred, n_gt, n_pred)
        matched = _matched_ious(iou, positive_only=min(thresholds) > 0)
        tps = [int((matched >= th).sum()) for th in thresholds]
        ap_vals = [tp_i / (n_gt + n_pred - tp_i) for tp_i in tps]
        idx = thresholds.index(_PRIMARY_THRESHOLD) if _PRIMARY_THRESHOLD in thresholds else 0
        tp = float(tps[idx])
        fp = float(n_pred - tps[idx])
        fn = float(n_gt - tps[idx])

    result: dict = {"n_gt": n_gt, "n_pred": n_pred}
    for th, a in zip(thresholds, ap_vals):
        result[f"AP_{th:.2f}"] = float(a)
    result["mAP"] = float(np.mean(ap_vals))
    if iou is None:
        result["instance_dice"] = mean_instance_dice(gt, pred, n_gt, n_pred)
    else:
        best = np.concatenate([iou.max(axis=1), iou.max(axis=0)])
        result["instance_dice"] = float(np.mean(2.0 * best / (1.0 + best)))
    result[f"instance_TP@{_PRIMARY_THRESHOLD:.2f}"] = tp
    result[f"instance_FP@{_PRIMARY_THRESHOLD:.2f}"] = fp
    result[f"instance_FN@{_PRIMARY_THRESHOLD:.2f}"] = fn
    return result
