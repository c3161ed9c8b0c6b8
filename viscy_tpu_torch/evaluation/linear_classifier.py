"""Linear probing of embeddings (counterpart of
``viscy_tpu/evaluation/linear_classifier.py``, its ``:18-102`` and
``predict_with_classifier``), on the device without sklearn.

- Scaling: sklearn's ``StandardScaler`` (mean, population standard
  deviation, a zero scale taken as 1), float64.
- The probe: sklearn's ``LogisticRegression(C=1, class_weight=...)``
  objective, ``sum_i w_i loss_i / sum_i w_i + |W|^2 / (2 C sum_i w_i)``
  (the intercept unpenalized; ``w_i`` the ``"balanced"`` class weights
  ``N / (K count_c)`` or 1), multinomial for three or more classes and the
  binomial loss on ``classes[1]`` for two, minimized by L-BFGS in float64
  on the device (``torch.optim.LBFGS`` with a strong-Wolfe line search,
  ``max |grad| <= tol`` as scipy's ``gtol``). sklearn stops at ``tol =
  1e-4``, so its coefficients are within that tolerance of the optimum,
  not of the port's.
- Folds: ``StratifiedKFold(shuffle=True, random_state=seed)``'s indices,
  drawn with numpy's ``RandomState`` as sklearn draws them.
- Metrics: accuracy and the support-weighted F1 over the labels of truth
  and prediction (0 where undefined), as sklearn's.

The dataset-level probe (``load_and_combine_datasets``,
``train_linear_classifier_anndata``, JAX ``:104-233``) adds:

- ``solver="liblinear"``, the default of DynaCLR's linear-classifier
  pipelines: liblinear's objective ``0.5 (|w|^2 + b^2) + C sum_i cw_i
  log(1 + exp(-y_i (w.x_i + b)))`` (the intercept a penalized weight on a
  constant column, ``intercept_scaling=1``), binary only: three or more
  classes (or one) raise sklearn's ``ValueError`` word for word, as sklearn
  1.9 does. ``solver="lbfgs"`` takes the objective above. Both are
  minimized by Newton's method in float64 on the device, to a gradient at
  round-off (sklearn stops at ``tol``, so the port's objective is at or
  below sklearn's);
- the splits ``train_test_split(train_size=..., stratify=y, shuffle=True)``
  and ``GroupShuffleSplit(n_splits=1, train_size=...)``, drawn with numpy's
  ``RandomState`` as sklearn draws them, their ``ValueError`` messages word for word;
- the exact PCA of :func:`viscy_tpu_torch.evaluation.dimensionality_reduction.
  pca_fit` (sklearn's ``PCA(n_components)`` without a ``random_state`` is
  randomized, and so not repeatable, above 500 rows and columns when
  ``n_components < 0.8 min(shape)`` and fewer than ``10 x n_features`` rows
  are given);
- ``classification_report(..., zero_division=0)``, and AUROC (binary on
  ``proba[:, 1]``, else one-vs-rest macro) and average precision by the
  trapezoid over distinct thresholds, ties grouped, as sklearn computes them.

A pipeline is saved as a ``.npz`` of its arrays (no pickle): the scaler's
``mean`` and ``scale``, ``coef``, ``intercept``, ``classes``, the
optional PCA's ``pca_components`` and ``pca_mean``, and the dataset-level
probe's ``objective`` at its minimum. The JAX package pickles
its sklearn pipeline, which the card's machine cannot load: such a file
raises by name, and :func:`viscy_tpu_torch.training.convert.
linear_pipeline_from_jax` carries a loaded JAX pipeline across.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import host, on, resolve_device

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["LinearClassifierPipeline", "average_precision", "classification_report", "concat_frames",
           "cross_validate_classifier",
           "annotated_store", "f1_weighted", "fit_logistic_newton", "fit_logistic_regression", "group_shuffle_split", "label_mask",
           "load_and_combine_datasets", "logistic_objective", "predict_with_classifier", "roc_auc",
           "stratified_kfold", "subset", "train_linear_classifier", "train_linear_classifier_anndata",
           "train_test_split_rows", "value_counts"]


def stratified_kfold(y: np.ndarray, n_splits: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``list(StratifiedKFold(n_splits, shuffle=True, random_state=seed)
    .split(X, y))``: ``(train, test)`` row indices, each ascending."""
    from viscy_tpu_torch.training.callbacks.online_eval import stratified_kfold_test_folds

    folds = stratified_kfold_test_folds(np.asarray(y), n_splits, shuffle_seed=seed)
    rows = np.arange(len(y))
    return [(rows[folds != i], rows[folds == i]) for i in range(n_splits)]


def f1_weighted(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn's ``f1_score(average="weighted", zero_division="warn")``."""
    labels = np.unique(np.concatenate([np.asarray(y_true), np.asarray(y_pred)]))
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    f1, support = [], []
    for c in labels:
        tp = float(((y_true == c) & (y_pred == c)).sum())
        fp = float(((y_true != c) & (y_pred == c)).sum())
        fn = float(((y_true == c) & (y_pred != c)).sum())
        denom = 2 * tp + fp + fn
        f1.append(2 * tp / denom if denom > 0 else 0.0)
        support.append(tp + fn)
    support = np.asarray(support)
    if support.sum() == 0:
        return 0.0
    return float(np.average(np.asarray(f1), weights=support))


class LinearClassifierPipeline:
    """Standard scaling (optional), an optional PCA, and a logistic
    regression; ``predict`` / ``predict_proba`` on ``device``."""

    def __init__(self, mean, scale, coef, intercept, classes, pca_components=None, pca_mean=None,
                 device: str = "cuda") -> None:
        self.mean = None if mean is None else np.asarray(mean, np.float64)
        self.scale = None if scale is None else np.asarray(scale, np.float64)
        self.coef = np.asarray(coef, np.float64)
        self.intercept = np.asarray(intercept, np.float64)
        self.classes = list(np.asarray(classes).tolist())
        self.pca_components = None if pca_components is None else np.asarray(pca_components, np.float64)
        self.pca_mean = None if pca_mean is None else np.asarray(pca_mean, np.float64)
        self.device = resolve_device(device)

    def _transform(self, X) -> torch.Tensor:
        x = on(X, self.device)
        if self.mean is not None:
            x = (x - on(self.mean, self.device)) / on(self.scale, self.device)
        if self.pca_components is not None:
            x = (x - on(self.pca_mean, self.device)) @ on(self.pca_components, self.device).T
        return x

    def transform(self, X) -> np.ndarray:
        return host(self._transform(X))

    def decision_function(self, X) -> torch.Tensor:
        return self._transform(X) @ on(self.coef, self.device).T + on(self.intercept, self.device)

    def predict(self, X) -> np.ndarray:
        z = self.decision_function(X)
        pick = (z[:, 0] > 0).long() if z.shape[1] == 1 else z.argmax(dim=1)
        return np.asarray(self.classes, dtype=object if isinstance(self.classes[0], str) else None)[host(pick)]

    def predict_proba(self, X) -> np.ndarray:
        z = self.decision_function(X)
        if z.shape[1] == 1:
            p = torch.sigmoid(z[:, 0])
            return host(torch.stack([1 - p, p], dim=1))
        return host(torch.softmax(z, dim=1))

    def save(self, path: str | Path) -> None:
        arrays = dict(coef=self.coef, intercept=self.intercept, classes=np.asarray(self.classes))
        for name in ("mean", "scale", "pca_components", "pca_mean"):
            if getattr(self, name) is not None:
                arrays[name] = getattr(self, name)
        if getattr(self, "objective", None) is not None:  # the fit's objective at its minimum
            arrays["objective"] = np.float64(self.objective)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path: str | Path, device: str = "cuda") -> "LinearClassifierPipeline":
        with open(path, "rb") as f:
            head = f.read(2)
        if head[:1] == b"\x80":
            raise NotImplementedError(
                f"{path} is a pickled JAX LinearClassifierPipeline (sklearn objects), which viscy_tpu_torch "
                "cannot load; convert it with viscy_tpu_torch.training.convert.linear_pipeline_from_jax where "
                "sklearn is installed")
        with np.load(path, allow_pickle=False) as z:
            get = lambda k: z[k] if k in z.files else None  # noqa: E731
            pipe = cls(get("mean"), get("scale"), z["coef"], z["intercept"], z["classes"], get("pca_components"),
                       get("pca_mean"), device=device)
            if "objective" in z.files:
                pipe.objective = float(z["objective"])
            return pipe


def _scaler(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mean = x.mean(dim=0)
    scale = ((x - mean) ** 2).mean(dim=0).sqrt()
    scale = torch.where(scale < 10 * torch.finfo(torch.float64).eps, 1.0, scale)
    return mean, scale


def fit_logistic_regression(x: torch.Tensor, codes: np.ndarray, n_classes: int, class_weight: str | None = "balanced",
                            C: float = 1.0, max_iter: int = 1000, tol: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
    """``(coef, intercept)`` of sklearn's L2 logistic regression on the
    float64 rows ``x`` (on their device) and integer labels ``codes`` in
    ``[0, n_classes)``: ``(K, d)`` and ``(K,)`` for K >= 3 classes, ``(1,
    d)`` and ``(1,)`` (the logit of class 1) for two.

    L-BFGS runs on the columns divided by their largest magnitude (the
    penalty carried over, so the optimum is the same): a column some orders
    of magnitude above the others (a MAD scaler's ``1e-12`` floor under a
    MAD of 0 makes one of 1e11) would otherwise stall it at the start."""
    dev, N, d = x.device, x.shape[0], x.shape[1]
    col = x.abs().amax(dim=0)
    col = torch.where(col > 0, col, torch.ones_like(col))
    x = x / col
    y = torch.as_tensor(codes, device=dev)
    sw = torch.ones(N, dtype=x.dtype, device=dev)
    if class_weight == "balanced":
        counts = torch.bincount(y, minlength=n_classes).to(x.dtype)
        sw = (N / (n_classes * counts))[y]
    elif class_weight is not None:
        raise NotImplementedError(f"class_weight={class_weight!r} is not ported; use 'balanced' or None")
    sw_sum = sw.sum()
    binary = n_classes == 2
    w = torch.zeros((1 if binary else n_classes, d + 1), dtype=x.dtype, device=dev, requires_grad=True)
    opt = torch.optim.LBFGS([w], lr=1.0, max_iter=max_iter, max_eval=int(max_iter * 1.25), tolerance_grad=tol,
                            tolerance_change=64 * np.finfo(float).eps, history_size=10,
                            line_search_fn="strong_wolfe")
    target = y.to(x.dtype)

    def objective() -> torch.Tensor:
        opt.zero_grad()
        z = x @ w[:, :d].T + w[:, d]
        if binary:
            loss = torch.nn.functional.softplus(z[:, 0]) - target * z[:, 0]
        else:
            loss = torch.logsumexp(z, dim=1) - z.gather(1, y[:, None])[:, 0]
        f = (sw * loss).sum() / sw_sum + 0.5 / (C * sw_sum) * ((w[:, :d] / col) ** 2).sum()
        f.backward()
        return f

    opt.step(objective)
    coef = w.detach()
    return host(coef[:, :d] / col), host(coef[:, d])


def train_linear_classifier(features, labels, val_features=None, val_labels=None, max_iter: int = 1000,
                            class_weight: str | None = "balanced", seed: int = 42, tol: float = 1e-4,
                            device: str = "cuda") -> tuple[LinearClassifierPipeline, dict]:
    """Scale, fit the probe; returns ``(pipeline, metrics)`` with train (and
    validation) accuracy and weighted F1. ``seed`` is accepted for JAX's
    signature (the lbfgs solver draws nothing)."""
    dev = resolve_device(device)
    x = on(features, dev)
    labels = np.asarray(labels)
    classes, codes = np.unique(labels, return_inverse=True)
    mean, scale = _scaler(x)
    coef, intercept = fit_logistic_regression((x - mean) / scale, codes, len(classes), class_weight,
                                              max_iter=max_iter, tol=tol)
    pipe = LinearClassifierPipeline(host(mean), host(scale), coef, intercept, classes, device=str(dev))
    pred = pipe.predict(features)
    metrics = {"train_accuracy": float((pred == labels).mean()), "train_f1_weighted": f1_weighted(labels, pred)}
    if val_features is not None and val_labels is not None:
        val_labels = np.asarray(val_labels)
        pred = pipe.predict(val_features)
        metrics["val_accuracy"] = float((pred == val_labels).mean())
        metrics["val_f1_weighted"] = f1_weighted(val_labels, pred)
    return pipe, metrics


def cross_validate_classifier(features, labels, n_splits: int = 5, seed: int = 42, device: str = "cuda") -> dict:
    """Stratified, shuffled k-fold probe accuracy and weighted F1."""
    features, labels = np.asarray(features), np.asarray(labels)
    accs, f1s = [], []
    for train_idx, val_idx in stratified_kfold(labels, n_splits, seed):
        _, m = train_linear_classifier(features[train_idx], labels[train_idx], features[val_idx], labels[val_idx],
                                       seed=seed, device=device)
        accs.append(m["val_accuracy"])
        f1s.append(m["val_f1_weighted"])
    return {"accuracy_mean": float(np.mean(accs)), "accuracy_std": float(np.std(accs)),
            "f1_mean": float(np.mean(f1s)), "f1_std": float(np.std(f1s))}


def _well_mask(fov_names: np.ndarray, include_wells) -> np.ndarray:
    names = np.asarray([str(f) for f in fov_names])
    prefixes = tuple(w + "/" for w in include_wells)
    return np.asarray([n.startswith(prefixes) or n in include_wells for n in names], bool)


def predict_with_classifier(adata, pipeline: LinearClassifierPipeline, task: str, include_wells=None):
    """Apply a probe: ``obs["predicted_{task}"]`` (NaN outside
    ``include_wells``), ``obsm["predicted_{task}_proba"]`` and
    ``uns["predicted_{task}_classes"]``."""
    mask = (np.ones(adata.n_obs, bool) if include_wells is None
            else _well_mask(adata.obs["fov_name"], include_wells))
    X = np.asarray(adata.X)[mask]
    preds, proba = pipeline.predict(X), pipeline.predict_proba(X)
    all_preds = np.full(adata.n_obs, np.nan, dtype=object)
    all_preds[mask] = preds
    all_proba = np.full((adata.n_obs, proba.shape[1]), np.nan)
    all_proba[mask] = proba
    adata.obs[f"predicted_{task}"] = all_preds
    adata.obsm[f"predicted_{task}_proba"] = all_proba
    adata.uns[f"predicted_{task}_classes"] = list(pipeline.classes)
    return adata


# -- the dataset-level probe (JAX ``linear_classifier.py:104-233``) ----------------------------------------------
LIBLINEAR_MULTICLASS = ("The 'liblinear' solver does not support multiclass classification (n_classes >= 3). Either "
                        "use another solver or wrap the estimator in a OneVsRestClassifier to keep applying a "
                        "one-versus-rest scheme.")


def label_mask(values) -> np.ndarray:
    """Which annotation cells hold a label: not missing (NaN, None, an
    empty CSV cell) and not ``"unknown"`` or ``"nan"``."""
    values = np.asarray(values, dtype=object)
    text = values.astype(str)
    return ~np.isin(text, ["", "unknown", "nan"]) & np.asarray([v is not None for v in values.tolist()], bool)


def value_counts(values) -> dict:
    """``pd.Series(values).astype(str).value_counts().to_dict()``: counts by
    descending count, ties in order of first appearance."""
    text = np.asarray(values, dtype=object).astype(str)
    uniq, first, counts = np.unique(text, return_index=True, return_counts=True)
    order = sorted(range(len(uniq)), key=lambda i: (-counts[i], first[i]))
    return {str(uniq[i]): int(counts[i]) for i in order}


def subset(adata, rows):
    """The rows ``rows`` (indices or a mask) of an ``AnnDataLite``: ``X``,
    ``obs`` and every ``obsm`` entry, ``uns`` shared."""
    from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite

    rows = np.asarray(rows)
    return AnnDataLite(np.asarray(adata.X)[rows], adata.obs.take(rows), obsm={k: np.asarray(v)[rows] for k, v in
                                                                            adata.obsm.items()}, uns=adata.uns)


def _split_sizes(n_samples: int, train_size: float) -> tuple[int, int]:
    """sklearn's ``_validate_shuffle_split(n, None, train_size)``."""
    if train_size <= 0 or train_size >= 1:
        raise ValueError(f"train_size={train_size} should be either positive and smaller than the number of samples "
                         f"{n_samples} or a float in the (0, 1) range")
    n_train = math.floor(train_size * n_samples)
    n_test = n_samples - n_train
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size=None and train_size={train_size}, the resulting train "
                         "set will be empty. Adjust any of the aforementioned parameters.")
    return n_train, n_test


def train_test_split_rows(y, train_size: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(train, test)`` rows of ``train_test_split(..., train_size=train_size,
    stratify=y, shuffle=True, random_state=seed)``, each in sklearn's
    permuted order."""
    from viscy_tpu_torch.training.callbacks.online_eval import _approximate_mode

    n_train, n_test = _split_sizes(len(y), train_size)
    if n_test >= len(y) or n_test <= 0:
        raise ValueError(f"test_size={n_test} should be either positive and smaller than the number of samples "
                         f"{len(y)} or a float in the (0, 1) range")
    classes, y_indices, class_counts = np.unique(np.asarray(y), return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too few. The minimum number "
                         "of groups for any class cannot be less than 2. Classes with too few members are: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < len(classes):
        raise ValueError(f"The train_size = {n_train} should be greater or equal to the number of classes = "
                         f"{len(classes)}")
    if n_test < len(classes):
        raise ValueError(f"The test_size = {n_test} should be greater or equal to the number of classes = "
                         f"{len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def group_shuffle_split(groups, train_size: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``next(GroupShuffleSplit(n_splits=1, train_size=train_size,
    random_state=seed).split(X, y, groups))``: a ``ShuffleSplit`` of the
    unique groups, mapped back to rows (each ascending)."""
    unique, group_idx = np.unique(np.asarray(groups), return_inverse=True)
    n_train, n_test = _split_sizes(len(unique), train_size)
    perm = np.random.RandomState(seed).permutation(len(unique))
    group_test, group_train = perm[:n_test], perm[n_test: n_test + n_train]
    return np.flatnonzero(np.isin(group_idx, group_train)), np.flatnonzero(np.isin(group_idx, group_test))


def classification_report(y_true, y_pred) -> dict:
    """``sklearn.metrics.classification_report(y_true, y_pred,
    output_dict=True, zero_division=0)``: per label (as a string, labels
    sorted over truth and prediction) precision, recall, F1 and support,
    ``accuracy``, and the ``macro avg`` and ``weighted avg``."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    tp = np.asarray([((y_true == c) & (y_pred == c)).sum() for c in labels], np.float64)
    pred_sum = np.asarray([(y_pred == c).sum() for c in labels], np.float64)
    true_sum = np.asarray([(y_true == c).sum() for c in labels], np.float64)

    def divide(a, b):
        out = np.zeros_like(a)
        np.divide(a, b, out=out, where=b != 0)
        return out

    precision, recall, f1 = divide(tp, pred_sum), divide(tp, true_sum), divide(2 * tp, true_sum + pred_sum)
    rep: dict = {str(c): {"precision": float(p), "recall": float(r), "f1-score": float(f), "support": float(n)}
                 for c, p, r, f, n in zip(labels, precision, recall, f1, true_sum)}
    rep["accuracy"] = float((y_true == y_pred).mean())
    total = float(true_sum.sum())
    for name, weights in (("macro avg", None), ("weighted avg", true_sum)):
        rep[name] = {k: float(np.average(v, weights=weights)) for k, v in
                     (("precision", precision), ("recall", recall), ("f1-score", f1))}
        rep[name]["support"] = total
    return rep


def _binary_curve(pos: np.ndarray, score: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """False and true positives at each distinct score, descending (sklearn's
    ``_binary_clf_curve``)."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, pos = score[order], pos[order]
    idx = np.r_[np.where(np.diff(score))[0], pos.size - 1]
    tps = np.cumsum(pos, dtype=np.float64)[idx]
    return 1 + idx - tps, tps


def _binary_auroc(pos: np.ndarray, score: np.ndarray) -> float:
    fps, tps = _binary_curve(pos.astype(np.float64), np.asarray(score, np.float64))
    if len(fps) > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    return float(np.trapezoid(tps / tps[-1], fps / fps[-1]))


def roc_auc(y_true, scores) -> float:
    """``roc_auc_score(y_true, scores)`` for a 1-D score (binary: the larger
    label positive) or ``roc_auc_score(y_true, proba, multi_class="ovr",
    average="macro")`` for a (N, K) one, with sklearn's ``ValueError`` messages."""
    y_true, scores = np.asarray(y_true), np.asarray(scores, np.float64)
    labels = np.unique(y_true)
    if scores.ndim == 1:
        if len(labels) > 2:
            raise ValueError("multi_class must be in ('ovo', 'ovr')")
        if len(labels) < 2:
            raise ValueError("Only one class is present in y_true. ROC AUC score is not defined in that case.")
        return _binary_auroc(y_true == labels[1], scores)
    if len(labels) != scores.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns in 'y_score'")
    return float(np.mean([_binary_auroc(y_true == c, scores[:, k]) for k, c in enumerate(labels)]))


def average_precision(pos, score) -> float:
    """``average_precision_score(pos, score)`` of a 0/1 target: the step
    integral of precision over recall at each distinct score."""
    fps, tps = _binary_curve(np.asarray(pos, np.float64), np.asarray(score, np.float64))
    precision = np.zeros_like(tps)
    np.divide(tps, tps + fps, out=precision, where=(tps + fps) != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision, recall = np.r_[precision[::-1], 1], np.r_[recall[::-1], 0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def logistic_objective(w: torch.Tensor, x: torch.Tensor, codes, n_classes: int, solver: str,
                       class_weight: str | None = "balanced", C: float = 1.0, derivatives: bool = False):
    """The objective the solver minimizes at ``w`` (``(K, d + 1)``, the
    intercept last; one row for two classes) on rows ``x`` (float64, on its
    device), with its gradient and Hessian (over ``w`` flattened) when
    ``derivatives``. ``liblinear``: ``0.5 |w|^2 + C sum_i cw_i log(1 +
    exp(-y_i z_i))``; ``lbfgs``: ``sum_i cw_i loss_i / sum_i cw_i +
    |coef|^2 / (2 C sum_i cw_i)``."""
    dev, dt = x.device, x.dtype
    N, d = x.shape
    y = torch.as_tensor(np.asarray(codes), device=dev, dtype=torch.int64)
    sw = torch.ones(N, dtype=dt, device=dev)
    if class_weight == "balanced":
        sw = (N / (n_classes * torch.bincount(y, minlength=n_classes).to(dt)))[y]
    elif class_weight is not None:
        raise NotImplementedError(f"class_weight={class_weight!r} is not ported; use 'balanced' or None")
    xb = torch.cat([x, torch.ones(N, 1, dtype=dt, device=dev)], dim=1)
    z = xb @ w.T
    if solver == "liblinear":
        s = 2 * y.to(dt) - 1
        m = -s * z[:, 0]
        f = 0.5 * (w * w).sum() + C * (sw * torch.nn.functional.softplus(m)).sum()
        if not derivatives:
            return f
        sig = torch.sigmoid(m)
        g = w[0] - C * xb.T @ (sw * s * sig)
        h = C * sw * sig * (1 - sig)
        H = (xb.T * h) @ xb + torch.eye(d + 1, dtype=dt, device=dev)
        return f, g, H
    if solver != "lbfgs":
        raise NotImplementedError(f"solver={solver!r} is not ported; use 'liblinear' or 'lbfgs'")
    S = sw.sum()
    pen = torch.ones(d + 1, dtype=dt, device=dev)
    pen[d] = 0
    if n_classes == 2:
        t = y.to(dt)
        f = (sw * (torch.nn.functional.softplus(z[:, 0]) - t * z[:, 0])).sum() / S + (pen * w[0] ** 2).sum() / (2 * C * S)
        if not derivatives:
            return f
        p = torch.sigmoid(z[:, 0])
        g = xb.T @ (sw * (p - t)) / S + pen * w[0] / (C * S)
        H = (xb.T * (sw * p * (1 - p) / S)) @ xb + torch.diag(pen / (C * S))
        return f, g, H
    K = n_classes
    f = (sw * (torch.logsumexp(z, dim=1) - z.gather(1, y[:, None])[:, 0])).sum() / S + (pen * w**2).sum() / (2 * C * S)
    if not derivatives:
        return f
    p = torch.softmax(z, dim=1)
    r = p - torch.nn.functional.one_hot(y, K).to(dt)
    g = ((r * sw[:, None]).T @ xb / S + pen * w / (C * S)).reshape(-1)
    D = d + 1
    H = torch.zeros(K * D, K * D, dtype=dt, device=dev)
    for k in range(K):
        for l in range(k, K):
            c = sw * p[:, k] * ((1.0 if k == l else 0.0) - p[:, l]) / S
            block = (xb.T * c) @ xb
            H[k * D:(k + 1) * D, l * D:(l + 1) * D] = block
            if l != k:
                H[l * D:(l + 1) * D, k * D:(k + 1) * D] = block.T
    H += torch.diag((pen / (C * S)).repeat(K))
    return f, g, H


def fit_logistic_newton(x: torch.Tensor, codes, n_classes: int, solver: str = "lbfgs",
                        class_weight: str | None = "balanced", C: float = 1.0,
                        max_iter: int = 1000) -> tuple[np.ndarray, np.ndarray, float]:
    """``(coef, intercept, objective)`` of :func:`logistic_objective`'s
    minimum: Newton steps with a backtracking (Armijo) line search from 0,
    in float64 on ``x``'s device, until the largest gradient entry is at
    most ``1e-11 max(1, |f|)``, the Newton decrement at most ``1e-15 max(1,
    |f|)`` (the objective's own rounding), no step lowers the objective, or
    ``max_iter`` steps. The softmax's intercepts are fixed up to a common
    shift, so the multinomial Hessian gets that direction added (it holds
    the intercepts' sum at 0, where sklearn's solver also keeps it)."""
    if solver == "liblinear" and n_classes != 2:
        raise ValueError(LIBLINEAR_MULTICLASS)
    dev, d = x.device, x.shape[1]
    rows = 1 if n_classes == 2 else n_classes
    w = torch.zeros(rows, d + 1, dtype=x.dtype, device=dev)
    fix = None
    if rows > 1:
        fix = torch.zeros(rows * (d + 1), dtype=x.dtype, device=dev)
        fix[d::d + 1] = 1.0 / math.sqrt(rows)
    args = (x, codes, n_classes, solver, class_weight, C)
    f = logistic_objective(w, *args)
    for _ in range(max_iter):
        f, g, H = logistic_objective(w, *args, derivatives=True)
        if float(g.abs().max()) <= 1e-11 * max(1.0, abs(float(f))):
            break
        if fix is not None:
            H = H + fix[:, None] * fix[None, :]
        step = torch.linalg.solve(H, g).reshape(w.shape)
        slope = float(g @ step.reshape(-1))  # the Newton decrement: about twice f - min f
        if slope <= 1e-15 * max(1.0, abs(float(f))):
            break
        a = 1.0
        while a > 1e-10:
            f_new = logistic_objective(w - a * step, *args)
            if float(f_new) <= float(f) - 1e-4 * a * slope:
                break
            a *= 0.5
        if a <= 1e-10 or float(f_new) >= float(f):
            break
        w = w - a * step
        f = f_new
    f = float(logistic_objective(w, *args))
    return host(w[:, :d]), host(w[:, d]), f


def _report(prefix: str, pipe: LinearClassifierPipeline, X, y: np.ndarray) -> dict:
    out: dict = {}
    pred = pipe.predict(X)
    rep = classification_report(y, pred)
    out[f"{prefix}_accuracy"] = rep["accuracy"]
    for stat in ("precision", "recall", "f1-score"):
        out[f"{prefix}_weighted_{stat.replace('-score', '')}"] = rep["weighted avg"][stat]
    proba = pipe.predict_proba(X)
    try:
        out[f"{prefix}_auroc"] = roc_auc(y, proba[:, 1] if len(pipe.classes) == 2 else proba)
    except ValueError:
        pass
    for cls in pipe.classes:
        if cls in rep:
            out[f"{prefix}_{cls}_f1"] = rep[cls]["f1-score"]
            out[f"{prefix}_{cls}_support"] = int(rep[cls]["support"])
    return out


def _pca_count(ratio: np.ndarray, n_components, n_max: int) -> int:
    if n_components is None:
        return n_max
    if isinstance(n_components, float) and 0 < n_components < 1:
        return int(np.searchsorted(np.cumsum(ratio), n_components, side="right") + 1)
    if isinstance(n_components, (int, np.integer)) and 0 < n_components <= n_max:
        return int(n_components)
    raise NotImplementedError(f"PCA n_components={n_components!r} is not ported (an int in [1, {n_max}] or a "
                              "float in (0, 1))")


def train_linear_classifier_anndata(adata, task: str, use_scaling: bool = True, use_pca: bool = False,
                                    n_pca_components=None, classifier_params: dict | None = None,
                                    split_train_data: float = 0.8, random_seed: int = 42, groups=None,
                                    device: str = "cuda") -> tuple[LinearClassifierPipeline, dict, dict]:
    """Fit the scaler and PCA on every row, split (stratified, or by
    ``groups``), fit the probe on the training rows; returns ``(pipeline,
    metrics, val_outputs)`` with JAX's keys (per-split accuracy, weighted
    precision, recall and F1, AUROC, and each class's F1 and support).
    ``classifier_params``: ``solver`` (``"lbfgs"`` or ``"liblinear"``, the
    latter binary only), ``class_weight``, ``max_iter``, ``C``."""
    params = dict(classifier_params or {})
    unknown = sorted(set(params) - {"solver", "class_weight", "max_iter", "C", "random_state"})
    if unknown:
        raise NotImplementedError(f"classifier_params {unknown} are not ported (solver, class_weight, max_iter, C)")
    dev = resolve_device(device)
    x = on(np.asarray(adata.X), dev)
    y = np.asarray(adata.obs[task], dtype=object)
    mean = scale = comps = pmean = None
    if use_scaling:
        mean, scale = _scaler(x)
        x = (x - mean) / scale
    if use_pca:
        from viscy_tpu_torch.evaluation.dimensionality_reduction import pca_fit

        n_max = min(x.shape)
        _, ratio, vt, pmean = pca_fit(x, n_max)
        comps = vt[: _pca_count(host(ratio), n_pca_components, n_max)]
        x = (x - pmean) @ comps.T
    if split_train_data < 1.0:
        if groups is not None:
            tr, va = group_shuffle_split(groups, split_train_data, random_seed)
        else:
            tr, va = train_test_split_rows(y, split_train_data, random_seed)
    else:
        tr, va = np.arange(len(y)), None
    classes, codes = np.unique(y[tr], return_inverse=True)
    solver = params.get("solver", "lbfgs")
    if solver != "liblinear" and len(classes) < 2:
        raise ValueError("This solver needs samples of at least 2 classes in the data, but the data contains only "
                         f"one class: {classes[0]!r}")
    idx = torch.as_tensor(tr, device=dev)
    coef, intercept, objective = fit_logistic_newton(x[idx], codes, len(classes), solver,
                                                     params.get("class_weight", "balanced"), params.get("C", 1.0),
                                                     params.get("max_iter", 1000))
    pipe = LinearClassifierPipeline(None, None, coef, intercept, classes, device=str(dev))
    xh = host(x)
    metrics = _report("train", pipe, xh[tr], y[tr])
    y_va = proba = None
    if va is not None:
        y_va = y[va]
        metrics.update(_report("val", pipe, xh[va], y_va))
        proba = pipe.predict_proba(xh[va])
    pipeline = LinearClassifierPipeline(None if mean is None else host(mean), None if scale is None else host(scale),
                                        coef, intercept, classes, None if comps is None else host(comps),
                                        None if pmean is None else host(pmean), device=str(dev))
    pipeline.task, pipeline.objective = task, objective
    return pipeline, metrics, {"y_val": y_va, "y_val_proba": proba, "classes": list(pipeline.classes)}


def annotated_store(embeddings, annotations, task: str, cache: dict | None = None):
    """The embedding store with the annotation CSV's ``task`` column joined
    (``KeyError`` when the CSV lacks it); with ``cache``, each (store, CSV,
    task) is read and joined once per cache (the caller's own dict), and a
    fresh container over the same arrays is returned."""
    from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite, Frame
    from viscy_tpu_torch.evaluation.annotation import load_annotation_anndata
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    key = (str(embeddings), str(annotations), task)
    if cache is None or key not in cache:
        try:
            joined = load_annotation_anndata(read_embedding_dataset(embeddings), str(annotations), task)
        except KeyError as e:
            joined = e
        if cache is None:
            if isinstance(joined, KeyError):
                raise joined
            return joined
        cache[key] = joined
    hit = cache[key]
    if isinstance(hit, KeyError):
        raise KeyError(*hit.args)
    return AnnDataLite(hit.X, Frame(dict(hit.obs.columns), index=hit.obs.index), obsm=dict(hit.obsm),
                       uns=dict(hit.uns))


def load_and_combine_datasets(datasets: list[dict], task: str, cache: dict | None = None):
    """Each dataset's embedding store (``embeddings``) with its annotation
    CSV's ``task`` column joined (``annotations``), filtered to
    ``include_wells`` when given and to rows holding a label, concatenated;
    a dataset whose CSV lacks the task is skipped. ``ValueError`` when no
    row is left. ``cache``: see :func:`annotated_store`."""
    from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite

    parts = []
    for ds in datasets:
        try:
            adata = annotated_store(ds["embeddings"], ds["annotations"], task, cache)
        except KeyError:
            _logger.warning("skipping %s: task %r not in annotations", ds["embeddings"], task)
            continue
        if ds.get("include_wells"):
            adata = subset(adata, _well_mask(adata.obs["fov_name"], ds["include_wells"]))
        adata = subset(adata, label_mask(adata.obs[task]))
        if adata.n_obs:
            parts.append(adata)
    if not parts:
        raise ValueError("No training data loaded from any dataset!")
    if len(parts) == 1:
        return parts[0]
    return AnnDataLite(np.concatenate([p.X for p in parts]), concat_frames([p.obs for p in parts]))


def concat_frames(frames: list) -> "Frame":
    """``pd.concat(frames, ignore_index=True)``: the union of the columns in
    order of first appearance, a column a frame lacks filled with NaN, the
    index ``"0"``, ``"1"``, ..."""
    from viscy_tpu_torch.evaluation.anndata_lite import Frame

    names = list(dict.fromkeys(n for f in frames for n in f.names))
    columns = {}
    for name in names:
        parts = [f[name] if name in f else np.full(len(f), np.nan) for f in frames]
        if any(p.dtype == object for p in parts) and not all(p.dtype == object for p in parts):
            parts = [p.astype(object) for p in parts]
        columns[name] = np.concatenate(parts)
    return Frame(columns, n_rows=sum(len(f) for f in frames))
