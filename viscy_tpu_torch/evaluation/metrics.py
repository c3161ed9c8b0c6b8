"""Host-side segmentation metrics (counterpart of
``viscy_tpu/evaluation/metrics.py``'s ``voi_score``, ``pod_metric`` and
``mean_average_precision``), in numpy as in the JAX package.

The pairwise IoU of ``mean_average_precision`` comes from the joint
histogram of the two label images (one ``np.bincount`` of ``pred * (T + 1)
+ target`` over dense instance ids), not from (N, H, W) instance masks and a
float64 product: a 1024^2 frame can hold hundreds of instances, and the
dense route needs P x H W float64 values per side. The counts are the same
exact integers either way, so every IoU, AP and AR equals the JAX
package's.
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


def voi_score(pred_labels: np.ndarray, target_labels: np.ndarray) -> tuple[float, float]:
    """Variation of information between two label images: ``(H(pred | target),
    H(target | pred))`` in nats."""
    p = np.asarray(pred_labels).ravel().astype(np.int64)
    t = np.asarray(target_labels).ravel().astype(np.int64)
    n = p.size
    pu, pi = np.unique(p, return_inverse=True)
    tu, ti = np.unique(t, return_inverse=True)
    joint = np.zeros((len(pu), len(tu)), np.float64)
    np.add.at(joint, (pi, ti), 1.0)
    joint /= n
    pm = joint.sum(axis=1, keepdims=True)
    tm = joint.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        h_p_given_t = -np.nansum(joint * np.log(joint / tm, where=joint > 0))
        h_t_given_p = -np.nansum(joint * np.log(joint / pm, where=joint > 0))
    return float(h_p_given_t), float(h_t_given_p)


def pod_metric(pred_labels: np.ndarray, target_labels: np.ndarray, iou_threshold: float = 0.5) -> dict:
    """Probability of detection over instance labels: each predicted instance
    (in label order) matches its best unmatched target instance by IoU, at
    or above ``iou_threshold``; true / false positives, false negatives,
    precision, recall and F1."""
    pred_ids = [i for i in np.unique(pred_labels) if i != 0]
    target_ids = [i for i in np.unique(target_labels) if i != 0]
    matched_t = set()
    tp = 0
    for pid in pred_ids:
        pm = pred_labels == pid
        best_iou, best_t = 0.0, None
        for tid in np.unique(target_labels[pm]):
            if tid == 0 or tid in matched_t:
                continue
            tm = target_labels == tid
            inter = np.logical_and(pm, tm).sum()
            union = np.logical_or(pm, tm).sum()
            iou = inter / union if union else 0.0
            if iou > best_iou:
                best_iou, best_t = iou, tid
        if best_t is not None and best_iou >= iou_threshold:
            matched_t.add(best_t)
            tp += 1
    fp = len(pred_ids) - tp
    fn = len(target_ids) - tp
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {
        "true_positives": tp,
        "false_positives": fp,
        "false_negatives": fn,
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / max(precision + recall, 1e-8),
    }
