"""Embedding writer (counterpart of
``viscy_tpu/training/callbacks/embedding_writer.py``; reference
``callbacks/embedding_writer.py:219``).

Collects the contrastive engine's ``{features, projections}`` predictions
and the batches' tracking ``index`` and writes an AnnData zarr store
(:mod:`viscy_tpu_torch.evaluation.anndata_lite`): the index columns as
``obs`` (``fov_name`` stripped of ``/``), the primary embedding as ``X``
(``embedding_key``), the other array in ``obsm``, the PCA of ``X`` in
``obsm["X_pca"]`` and the data and tracks paths in ``uns``.

PCA is an exact SVD in float64 with sklearn's sign rule, where the JAX
writer calls ``sklearn.decomposition.PCA`` (the card's machine has no
sklearn); a PCA that fails raises, where the JAX writer logs a warning.
UMAP and PHATE (``umap_kwargs`` / ``phate_kwargs``) and the legacy
``index.parquet`` layout are not ported and raise by name.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Literal

import numpy as np

from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite, Frame, read_anndata_zarr
from viscy_tpu_torch.training.callbacks.base import Callback

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["EmbeddingWriter", "pca", "read_embedding_dataset", "write_embedding_dataset"]


def pca(X: np.ndarray, n_components: int) -> np.ndarray:
    """The first ``n_components`` principal-component scores of ``X``, in
    float64: ``sklearn.decomposition.PCA(n_components).fit_transform(X)``
    with the full solver (center, exact SVD, ``U[:, :n] * S[:n]``), each
    component's sign chosen so its largest absolute loading is positive
    (``svd_flip(u_based_decision=False)``)."""
    X = np.asarray(X, np.float64)
    U, S, Vt = np.linalg.svd(X - X.mean(axis=0), full_matrices=False)
    signs = np.sign(Vt[np.arange(Vt.shape[0]), np.argmax(np.abs(Vt), axis=1)])
    return U[:, :n_components] * signs[:n_components] * S[:n_components]


def _refuse_reductions(umap_kwargs, phate_kwargs) -> None:
    for name, kw in (("umap_kwargs", umap_kwargs), ("phate_kwargs", phate_kwargs)):
        if kw is not None:
            raise NotImplementedError(f"{name}: UMAP and PHATE embeddings are not ported to viscy_tpu_torch")


def write_embedding_dataset(
    output_path: Path | str,
    features: np.ndarray,
    index: Frame | list[dict],
    projections: np.ndarray | None = None,
    embedding_key: Literal["features", "projections"] = "features",
    umap_kwargs: dict | None = None,
    phate_kwargs: dict | None = None,
    pca_kwargs: dict | None = None,
    overwrite: bool = False,
    uns_metadata: dict | None = None,
    provenance: dict | None = None,
    compute_pca: bool = False,
    pca_components: int = 8,
) -> AnnDataLite:
    """Write embeddings to an AnnData zarr store (reference
    ``write_embedding_dataset``, embedding_writer.py:105-215). ``index`` is
    a :class:`Frame` or a list of row dicts; with ``compute_pca`` (or
    ``pca_kwargs``) and more than two rows, ``obsm["X_pca"]`` holds
    ``min(n_components, min(X.shape) - 1)`` components."""
    _refuse_reductions(umap_kwargs, phate_kwargs)
    output_path = Path(output_path)
    if output_path.exists() and not overwrite:
        raise FileExistsError(f"Output path {output_path} already exists.")
    obs = (Frame.from_records(index) if isinstance(index, list) else index).reset_index()
    if "fov_name" in obs:
        obs["fov_name"] = np.asarray([str(v).strip("/") for v in obs["fov_name"]], dtype=object)

    features = np.asarray(features, np.float32)
    obsm: dict[str, np.ndarray] = {}
    if embedding_key == "projections":
        if projections is None:
            raise ValueError("embedding_key='projections' requires projections.")
        X = np.asarray(projections, np.float32)
        obsm["X_backbone"] = features
    else:
        X = features
        if projections is not None:
            obsm["X_projections"] = np.asarray(projections, np.float32)
    if compute_pca and pca_kwargs is None:
        pca_kwargs = {"n_components": pca_components}
    if pca_kwargs and X.shape[0] > 2:
        n = min(int(pca_kwargs.get("n_components", 8)), min(X.shape) - 1)
        obsm["X_pca"] = pca(X, n).astype(np.float32)
    uns = {str(k): v for k, v in {**(provenance or {}), **(uns_metadata or {})}.items()}
    adata = AnnDataLite(X=X, obs=obs, obsm=obsm, uns=uns)
    adata.write_zarr(output_path, overwrite=True)
    return adata


def read_embedding_dataset(path: Path | str) -> AnnDataLite:
    """Read an embedding store (the AnnData zarr layout); the legacy layout
    with ``index.parquet`` raises by name (no parquet reader here)."""
    path = Path(path)
    if (path / "index.parquet").exists():
        raise NotImplementedError(
            f"{path}: the legacy embedding layout (zarr arrays + index.parquet) is not readable in "
            "viscy_tpu_torch (no parquet reader); convert it to an AnnData zarr store first"
        )
    return read_anndata_zarr(path)


class EmbeddingWriter(Callback):
    """Collects predictions and writes the AnnData store at predict end."""

    def __init__(
        self,
        output_path: str,
        write_projections: bool = True,
        embedding_key: Literal["features", "projections"] = "features",
        umap_kwargs: dict | None = None,
        phate_kwargs: dict | None = None,
        pca_kwargs: dict | None = None,
        compute_pca: bool = False,
        pca_components: int = 8,
        overwrite: bool = False,
    ) -> None:
        _refuse_reductions(umap_kwargs, phate_kwargs)
        self.output_path = Path(output_path)
        self.write_projections = write_projections
        self.embedding_key = embedding_key
        self.pca_kwargs = pca_kwargs
        self.compute_pca = compute_pca
        self.pca_components = pca_components
        self.overwrite = overwrite
        self._features: list[np.ndarray] = []
        self._projections: list[np.ndarray] = []
        self._indices: list[dict] = []

    def on_predict_start(self, trainer, module) -> None:
        if self.output_path.exists() and not self.overwrite:
            raise FileExistsError(f"{self.output_path} exists; pass overwrite=True")
        self._features.clear()
        self._projections.clear()
        self._indices.clear()

    def write_on_batch_end(self, trainer, module, prediction, batch, batch_idx) -> None:
        self._features.append(_host(prediction["features"]))
        if self.write_projections and "projections" in prediction:
            self._projections.append(_host(prediction["projections"]))
        self._indices.extend(batch.get("index", []))

    def on_predict_end(self, trainer, module) -> None:
        features = np.concatenate(self._features) if self._features else np.zeros((0, 0), np.float32)
        projections = np.concatenate(self._projections) if self._projections else None
        index = self._indices if self._indices else Frame({"sample": np.arange(len(features))})
        dm = getattr(trainer, "_active_datamodule", None)
        uns = {
            "data_path": str(getattr(dm, "data_path", "")),
            "tracks_path": str(getattr(dm, "tracks_path", "")),
        }
        write_embedding_dataset(
            self.output_path, features, index, projections=projections, embedding_key=self.embedding_key,
            pca_kwargs=self.pca_kwargs, compute_pca=self.compute_pca, pca_components=self.pca_components,
            overwrite=True, uns_metadata=uns,
        )
        _logger.info(f"Wrote {len(features)} embeddings to {self.output_path}")


def _host(x) -> np.ndarray:
    """A prediction as a float32 numpy array on the host."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)
