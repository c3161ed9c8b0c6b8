"""Segmentation test-stage module (counterpart of
``viscy_tpu/apps/cytoland/evaluation.py``).

Compares predicted and target instance segmentations slice by slice:
binary accuracy, Dice and Jaccard, instance-level POD and the variation of
information, on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.evaluation.metrics import pod_metric, voi_score
from viscy_tpu_torch.training.module import TrainModule


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SegmentationMetrics2D(TrainModule):
    """``Trainer.test`` module over ``SegmentationDataModule`` batches (batch
    size 1): each batch's metrics, which the trainer means. It has no
    weights."""

    def __init__(self, aggregate_epoch: bool = False) -> None:
        super().__init__()
        self.aggregate_epoch = aggregate_epoch
        self.model = None

    def test_step(self, batch: dict) -> dict:
        pred = _host(batch["pred"])[0]
        target = _host(batch["target"])[0]
        pred_binary = pred > 0
        target_binary = target > 0
        tp = np.logical_and(pred_binary, target_binary).sum()
        union = np.logical_or(pred_binary, target_binary).sum()
        acc = (pred_binary == target_binary).mean()
        dice = 2 * tp / max(pred_binary.sum() + target_binary.sum(), 1)
        jaccard = tp / max(union, 1)
        pod = pod_metric(pred, target)
        voi_pt, voi_tp = voi_score(pred, target)
        return {
            "test_metrics/accuracy": float(acc),
            "test_metrics/dice": float(dice),
            "test_metrics/jaccard": float(jaccard),
            "test_metrics/pod_f1": pod["f1"],
            "test_metrics/pod_precision": pod["precision"],
            "test_metrics/pod_recall": pod["recall"],
            "test_metrics/voi": float(voi_pt + voi_tp),
        }
