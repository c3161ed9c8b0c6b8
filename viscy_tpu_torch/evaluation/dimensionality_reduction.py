"""Dimensionality reduction of embeddings (counterpart of
``viscy_tpu/evaluation/dimensionality_reduction.py``): PCA, UMAP and
PHATE on the device.

PCA is exact (centre, float64 SVD on the device, sklearn's ``svd_flip``
sign rule on the components). sklearn's ``PCA(svd_solver="auto")``, which
JAX calls, is exact only for N >= 10 D with D <= 1000 (``covariance_eigh``)
or for at most 500 rows and columns (``full``); elsewhere it is randomized,
and the port still computes the exact decomposition. JAX computes in the
input's dtype (float32 for an embedding store); the port in float64. UMAP
and PHATE are the port's native implementations only (JAX prefers
``umap-learn`` / ``phate`` when installed).
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.evaluation._ops import host, on, resolve_device

__all__ = ["compute_pca", "compute_phate", "compute_umap", "pca_fit", "reduce_features"]


def pca_fit(x: torch.Tensor, n_components: int, whiten: bool = False):
    """``(scores, explained_variance_ratio, components, mean)`` of the exact
    PCA of ``x`` (float64, on its device): scores ``U[:, :n] * S[:n]`` (or
    ``U * sqrt(N - 1)`` whitened), each component signed so its largest
    absolute loading is positive."""
    mean = x.mean(dim=0)
    U, S, Vt = torch.linalg.svd(x - mean, full_matrices=False)
    signs = torch.sign(Vt[torch.arange(Vt.shape[0], device=x.device), Vt.abs().argmax(dim=1)])
    U, Vt = U * signs, Vt * signs[:, None]
    var = S**2
    ratio = var / var.sum()
    scores = U[:, :n_components] * (float(np.sqrt(x.shape[0] - 1)) if whiten else S[:n_components])
    return scores, ratio[:n_components], Vt[:n_components], mean


def compute_pca(features, n_components: int = 8, whiten: bool = False, device: str = "cuda"):
    """``(projected, explained_variance_ratio)`` with ``min(n_components,
    min(features.shape) - 1)`` components, float64."""
    dev = resolve_device(device)
    x = on(features, dev)
    n = min(n_components, min(x.shape) - 1)
    scores, ratio, _, _ = pca_fit(x, n, whiten)
    return host(scores), host(ratio)


def compute_umap(features, n_components: int = 2, device: str = "cuda", **kwargs) -> np.ndarray:
    """UMAP projection (:class:`~viscy_tpu_torch.evaluation.umap_native.NativeUMAP`)."""
    from viscy_tpu_torch.evaluation.umap_native import NativeUMAP

    return NativeUMAP(n_components=n_components, device=device, **kwargs).fit_transform(features)


def compute_phate(features, n_components: int = 2, device: str = "cuda", **kwargs) -> np.ndarray:
    """PHATE projection (:class:`~viscy_tpu_torch.evaluation.phate_native.NativePHATE`)."""
    from viscy_tpu_torch.evaluation.phate_native import NativePHATE

    return NativePHATE(n_components=n_components, device=device, **kwargs).fit_transform(features)


def reduce_features(features, method: str = "pca", n_components: int = 8, device: str = "cuda",
                    **kwargs) -> np.ndarray:
    """PCA, UMAP or PHATE by name."""
    method = method.lower()
    if method == "pca":
        return compute_pca(features, n_components=n_components, device=device, **kwargs)[0]
    if method == "umap":
        return compute_umap(features, n_components=n_components, device=device, **kwargs)
    if method == "phate":
        return compute_phate(features, n_components=n_components, device=device, **kwargs)
    raise ValueError(f"unknown reduction method {method!r}")
