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

A pipeline is saved as a ``.npz`` of its arrays (no pickle): the scaler's
``mean`` and ``scale``, ``coef``, ``intercept``, ``classes`` and the
optional PCA's ``pca_components`` and ``pca_mean``. The JAX package pickles
its sklearn pipeline, which the card's machine cannot load: such a file
raises by name, and :func:`viscy_tpu_torch.training.convert.
linear_pipeline_from_jax` carries a loaded JAX pipeline across.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import host, on, resolve_device

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["LinearClassifierPipeline", "cross_validate_classifier", "f1_weighted", "fit_logistic_regression",
           "predict_with_classifier", "stratified_kfold", "train_linear_classifier"]


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
            return cls(get("mean"), get("scale"), z["coef"], z["intercept"], z["classes"], get("pca_components"),
                       get("pca_mean"), device=device)


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
