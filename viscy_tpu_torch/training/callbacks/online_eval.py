"""Online representation QC during training (counterpart of
``viscy_tpu/training/callbacks/online_eval.py``).

Three metrics of the accumulated validation embeddings, on the host in
numpy and scipy:

1. **k-NN accuracy** of a metadata label: cosine k-NN with uniform votes
   (a tie goes to the smallest label in sorted order), scored by
   ``StratifiedKFold(folds, shuffle=False)`` cross-validation or a
   stratified holdout drawn as ``train_test_split(stratify=y,
   random_state=0)`` draws it; both splits copy sklearn's, which the card's
   machine lacks. ``cv`` falls back to ``holdout`` when a class has one
   member. A fold whose training part has fewer than ``k`` rows scores NaN,
   as sklearn's ``cross_val_score`` scores it.
2. **Effective rank** of the embedding matrix (collapse detection).
3. **Temporal smoothness**: Spearman's rho between within-track cosine
   distance and |dt|.

In a job of several processes every rank's features, labels, track ids and
timepoints are gathered (rank 0's rows first) before the metrics, so every
rank computes them on the whole validation set; string labels are encoded
to codes of a vocabulary shared by all ranks first. A failed gather
raises (the JAX callback falls back to the local shard).
"""

from __future__ import annotations

import json
import logging
import math
from typing import Literal

import numpy as np
import torch

from viscy_tpu_torch.parallel.distributed import process_count
from viscy_tpu_torch.training.callbacks.base import Callback
from viscy_tpu_torch.training.callbacks.embedding_snapshot import anchor_features

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["OnlineEvalCallback", "effective_rank", "knn_accuracy", "temporal_smoothness"]


def effective_rank(features: np.ndarray, eps: float = 1e-12) -> float:
    """:func:`~viscy_tpu_torch.evaluation.clustering.effective_rank` of the
    finite rows (a warning names how many were dropped); NaN below 2 rows."""
    from viscy_tpu_torch.evaluation.clustering import effective_rank as _er

    finite = np.isfinite(features).all(axis=1)
    if not finite.all():
        _logger.warning("effective_rank: %d/%d rows contain NaN/Inf; skipping those", int((~finite).sum()),
                        len(features))
        features = features[finite]
    if features.shape[0] < 2:
        return float("nan")
    return _er(features, eps)


def temporal_smoothness(features: np.ndarray, track_ids: np.ndarray, timepoints: np.ndarray) -> float:
    """Spearman's rho between within-track cosine distance and |dt| over
    every within-track pair (L2-normalized embeddings); NaN below 3 pairs."""
    from scipy.stats import spearmanr

    f = features / (np.linalg.norm(features, axis=1, keepdims=True) + 1e-10)
    emb_dists: list[np.ndarray] = []
    time_dists: list[np.ndarray] = []
    for tid in np.unique(track_ids):
        mask = track_ids == tid
        n = int(mask.sum())
        if n < 2:
            continue
        ft = f[mask]
        tt = np.asarray(timepoints[mask], np.float64)
        iu, ju = np.triu_indices(n, k=1)
        emb_dists.append(1.0 - (ft @ ft.T)[iu, ju])
        time_dists.append(np.abs(tt[iu] - tt[ju]))
    if not emb_dists:
        return float("nan")
    ed = np.concatenate(emb_dists)
    td = np.concatenate(time_dists)
    if len(ed) < 3:
        return float("nan")
    rho, _ = spearmanr(td, ed)
    return float(rho)


# -- the k-NN probe and sklearn's splits ------------------------------------------------------------------


def _unit_rows(a: np.ndarray) -> np.ndarray:
    """Rows scaled to unit L2 norm in float64 (zero rows stay zero)."""
    a = np.asarray(a, np.float64)
    norm = np.linalg.norm(a, axis=1, keepdims=True)
    return a / np.where(norm > 0, norm, 1.0)


def knn_predict(train_x: np.ndarray, train_y: np.ndarray, test_x: np.ndarray, k: int) -> np.ndarray:
    """Cosine k-NN with uniform votes (``KNeighborsClassifier(k,
    metric="cosine")``): the k training rows of least cosine distance, the
    most frequent label among them, the smallest on a tie. Distances in
    float64. ``k`` above the training rows raises ``ValueError``, as sklearn
    does."""
    if k > len(train_x):
        raise ValueError(f"Expected n_neighbors <= n_samples_fit, but n_neighbors = {k}, "
                         f"n_samples_fit = {len(train_x)}")
    dist = 1.0 - _unit_rows(test_x) @ _unit_rows(train_x).T
    nearest = np.argsort(dist, axis=1, kind="stable")[:, :k]
    votes = np.apply_along_axis(np.bincount, 1, train_y[nearest], minlength=int(train_y.max()) + 1)
    return np.argmax(votes, axis=1)


def stratified_kfold_test_folds(y: np.ndarray, n_splits: int) -> np.ndarray:
    """Each row's test fold under ``StratifiedKFold(n_splits, shuffle=False)``
    (sklearn's ``_make_test_folds``): classes numbered by first appearance,
    each class's rows dealt to folds in blocks of the round-robin
    allocation over the sorted labels."""
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(allocation[:, k])
    return test_folds


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_approximate_mode``: the floored proportional draw, the
    remainder handed out by largest left-over share, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_holdout(y: np.ndarray, test_size: float, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``(train, test)`` row indices of ``train_test_split(stratify=y,
    test_size=test_size, random_state=seed)``: sklearn's
    ``StratifiedShuffleSplit`` draw on ``np.random.RandomState(seed)``."""
    n_samples = len(y)
    n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few.")
    if n_train < n_classes or n_test < n_classes:
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each be at least the number of "
                         f"classes ({n_classes})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def knn_accuracy(features: np.ndarray, labels: np.ndarray, k: int, mode: Literal["cv", "holdout"] = "cv",
                 holdout_test_size: float = 0.2) -> float | None:
    """The k-NN probe's accuracy (see the module docstring); None with fewer
    than two classes, or in holdout mode when a class has one member."""
    _, y = np.unique(np.asarray(labels).astype(str), return_inverse=True)
    if len(np.unique(y)) < 2:
        return None
    n = len(features)
    k = max(1, min(k, n - 1))
    min_class_count = int(np.bincount(y).min())
    if mode == "cv" and min_class_count < 2:
        mode = "holdout"
    if mode == "cv":
        folds = stratified_kfold_test_folds(y, min(5, min_class_count))
        scores = []
        for f in range(folds.max() + 1):
            train, test = folds != f, folds == f
            if k > train.sum():
                scores.append(float("nan"))
                continue
            scores.append(float(np.mean(knn_predict(features[train], y[train], features[test], k) == y[test])))
        return float(np.mean(scores))
    if min_class_count >= 2:
        train, test = stratified_holdout(y, holdout_test_size)
        return float(np.mean(knn_predict(features[train], y[train], features[test], k) == y[test]))
    return None


# -- several processes ----------------------------------------------------------------------------------------


def _gather_rows(x: np.ndarray, device: torch.device) -> np.ndarray:
    from viscy_tpu_torch.parallel.mesh import gather_batch

    return gather_batch(torch.as_tensor(np.ascontiguousarray(x), device=device)).cpu().numpy()


def _gather_labels(values: np.ndarray, device: torch.device) -> np.ndarray:
    """``values`` of every rank, rank 0's first. Numbers travel as they are
    (int64 or float64); anything else as codes of the sorted union of every
    rank's distinct strings (exchanged as UTF-8 bytes of a JSON list), then
    decoded, so every rank holds the same labels."""
    if values.dtype.kind in "iub":
        return _gather_rows(values.astype(np.int64), device)
    if values.dtype.kind == "f":
        return _gather_rows(values.astype(np.float64), device)
    strings = values.astype(str)
    blob = np.frombuffer(json.dumps(sorted(set(strings.tolist()))).encode(), np.uint8).astype(np.int64)
    lengths = _gather_rows(np.asarray([len(blob)], np.int64), device)
    blobs = _gather_rows(blob, device)
    vocab, start = set(), 0
    for length in lengths.tolist():
        vocab.update(json.loads(bytes(blobs[start:start + length].astype(np.uint8)).decode()))
        start += length
    vocab = np.asarray(sorted(vocab))
    return vocab[_gather_rows(np.searchsorted(vocab, strings).astype(np.int64), device)]


def gather_across_processes(feats: np.ndarray | None, device: torch.device, *values: np.ndarray | None) -> tuple:
    """Every rank's features and metadata arrays, concatenated in rank order
    on every rank; a metadata array missing on any rank is None everywhere,
    and a rank without features contributes no rows. The identity in one
    process."""
    if process_count() <= 1:
        return (feats, *values)
    from viscy_tpu_torch.parallel.mesh import all_reduce_mean, global_max

    width = int(global_max(torch.tensor(0.0 if feats is None else float(feats.shape[1]), device=device)))
    # 1.0 where every rank holds the array
    present = all_reduce_mean(torch.tensor([float(v is not None) for v in values], dtype=torch.float64,
                                           device=device)).tolist()
    local = np.zeros((0, width), np.float32) if feats is None else feats.astype(np.float32)
    out = [_gather_rows(local, device)]
    for v, share in zip(values, present):
        out.append(_gather_labels(np.asarray(v), device) if share == 1.0 else None)
    return tuple(out)


class OnlineEvalCallback(Callback):
    """Collect validation embeddings; log effective rank, k-NN accuracy and
    temporal smoothness under the JAX callback's metric names.

    Features are ``outputs["features"]`` when the step returns them, else the
    engine's encoder on the batch's anchors (eval mode, no gradient).
    Metadata comes from the batch's ``anchor_meta`` or ``index`` list of
    dicts (a key or its ``labels`` sub-dict)."""

    def __init__(
        self,
        every_n_epochs: int = 1,
        max_samples: int = 4096,
        label_key: str = "marker",
        k: int = 20,
        track_id_key: str = "track_id",
        timepoint_key: str = "t",
        knn_eval_mode: Literal["cv", "holdout"] = "cv",
        holdout_test_size: float = 0.2,
    ) -> None:
        self.every_n_epochs = every_n_epochs
        self.max_samples = max_samples
        self.label_key = label_key
        self.k = k
        self.track_id_key = track_id_key
        self.timepoint_key = timepoint_key
        self.knn_eval_mode = knn_eval_mode
        self.holdout_test_size = holdout_test_size
        self._features: list[np.ndarray] = []
        self._meta: list[dict] = []

    def on_validation_epoch_start(self, trainer, module) -> None:
        self._features.clear()
        self._meta.clear()

    def on_validation_batch_end(self, trainer, module, outputs, batch, batch_idx) -> None:
        if trainer.current_epoch % self.every_n_epochs:
            return
        feats = outputs.get("features") if isinstance(outputs, dict) else None
        if feats is None and getattr(module, "model", None) is not None and "anchor" in batch:
            feats = anchor_features(module, batch["anchor"])
        if feats is None:
            return
        self._features.append(feats.float().cpu().numpy() if isinstance(feats, torch.Tensor) else np.asarray(feats))
        meta = batch.get("anchor_meta") or batch.get("index") or []
        if isinstance(meta, dict):
            meta = [meta]
        self._meta.extend(meta)

    def _extract(self, key: str, n: int) -> np.ndarray | None:
        if len(self._meta) != n:
            return None
        values = []
        for m in self._meta:
            labels = m.get("labels") if isinstance(m.get("labels"), dict) else None
            v = (labels or {}).get(key, m.get(key))
            if v is None:
                return None
            values.append(v)
        return np.asarray(values)

    def on_validation_epoch_end(self, trainer, module, metrics: dict) -> None:
        if trainer.current_epoch % self.every_n_epochs:
            return
        feats = labels = track_ids = timepoints = None
        if self._features:
            feats = np.concatenate(self._features)[: self.max_samples]
            total = sum(len(f) for f in self._features)
            labels, track_ids, timepoints = (self._extract(key, total) for key in (self.label_key, self.track_id_key,
                                                                                   self.timepoint_key))
            labels, track_ids, timepoints = (None if a is None else a[: len(feats)]
                                             for a in (labels, track_ids, timepoints))
            if feats.ndim != 2:
                feats = None
        feats, labels, track_ids, timepoints = gather_across_processes(feats, trainer.device, labels, track_ids,
                                                                       timepoints)
        if feats is None or len(feats) < 4:
            return
        out: dict[str, float] = {"metrics/effective_rank/val": effective_rank(feats)}
        if track_ids is not None and timepoints is not None:
            out["metrics/temporal_smoothness/val"] = temporal_smoothness(feats, track_ids, timepoints)
        if labels is not None:
            acc = knn_accuracy(feats, labels, self.k, self.knn_eval_mode, self.holdout_test_size)
            if acc is not None:
                out[f"metrics/knn_acc/{self.label_key}/val"] = acc
        trainer.logger.log_metrics({k: v for k, v in out.items() if np.isfinite(v)}, trainer.global_step)
        trainer.logger.log_metrics({"online_eval/effective_rank": out["metrics/effective_rank/val"]},
                                   trainer.global_step)
