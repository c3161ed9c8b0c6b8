"""Linear classifier analysis (counterpart of
``viscy_tpu/evaluation/lca.py``): thin orchestration over
:mod:`viscy_tpu_torch.evaluation.linear_classifier`."""

from __future__ import annotations

import numpy as np

from viscy_tpu_torch.evaluation.linear_classifier import (
    LinearClassifierPipeline,
    cross_validate_classifier,
    train_linear_classifier,
)

__all__ = ["fit_logistic_regression", "linear_from_embeddings"]


def fit_logistic_regression(features, labels, train_fovs: list[str] | None = None, index=None,
                            device: str = "cuda", **kwargs) -> tuple[LinearClassifierPipeline, dict]:
    """A probe, validated on the FOVs outside ``train_fovs`` when both
    ``train_fovs`` and the ``index`` (a ``Frame`` with ``fov_name`` or
    ``fov``) are given."""
    features, labels = np.asarray(features), np.asarray(labels)
    if train_fovs is not None and index is not None:
        fov_col = "fov_name" if "fov_name" in index else "fov"
        train = np.isin(np.asarray(index[fov_col]).astype(str), [str(f) for f in train_fovs])
        return train_linear_classifier(features[train], labels[train], features[~train], labels[~train],
                                       device=device, **kwargs)
    return train_linear_classifier(features, labels, device=device, **kwargs)


def linear_from_embeddings(embeddings_path: str, label_column: str, n_splits: int = 5, device: str = "cuda") -> dict:
    """Cross-validated probe accuracy from an embedding store on disk."""
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    ds = read_embedding_dataset(embeddings_path)
    return cross_validate_classifier(ds["features"], np.asarray(ds["index"][label_column]), n_splits=n_splits,
                                     device=device)
