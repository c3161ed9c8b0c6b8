"""Precompute normalized arrays and convert embedding stores (counterpart
of ``viscy_tpu/preprocess/precompute.py``).

``precompute_normalized`` (the ``viscy-torch precompute`` subcommand)
writes a new HCS store with each channel's ``(x - subtrahend) / (divisor +
1e-8)`` applied from its normalization metadata, so training skips the
per-sample normalization. The arithmetic is the JAX package's, in its
float32 order, so the store is bit for bit its. ``convert_to_anndata``
(the ``viscy-torch convert_to_anndata`` subcommand) rewrites an embedding
store as a plain AnnData zarr store.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from viscy_tpu_torch.zarr_io.store import open_ome_zarr

_logger = logging.getLogger("viscy_tpu_torch")


def precompute_normalized(
    data_path: str | Path,
    output_path: str | Path,
    channel_names: list[str],
    level: str = "fov_statistics",
    subtrahend: str = "mean",
    divisor: str = "std",
) -> Path:
    """Write ``(x - sub) / div`` of ``channel_names`` per FOV and timepoint
    into a new store at ``output_path`` (which must not exist); its
    normalization metadata becomes the identity (0, 1)."""
    src = open_ome_zarr(data_path, mode="r")
    dst = open_ome_zarr(output_path, layout="hcs", mode="w-", channel_names=channel_names)
    ch_idx = [src.channel_names.index(c) for c in channel_names]
    for name, pos in src.positions():
        out_pos = dst.create_position(*name.split("/"))
        norm = pos.zattrs.get("normalization", {})
        img = pos["0"]
        t, _, z, y, x = img.shape
        out = out_pos.create_zeros("0", (t, len(ch_idx), z, y, x), np.float32)
        for ci, (ch, idx) in enumerate(zip(channel_names, ch_idx)):
            stats = norm.get(ch, {}).get(level, {})
            sub = float(stats.get(subtrahend, 0.0))
            div = float(stats.get(divisor, 1.0)) + 1e-8
            for ti in range(t):
                out[ti, ci] = (img[ti, idx].astype(np.float32) - sub) / div
        out_pos.zattrs["normalization"] = {ch: {level: {subtrahend: 0.0, divisor: 1.0}} for ch in channel_names}
        _logger.info(f"Precomputed {name}")
    return Path(output_path)


def convert_to_anndata(embeddings_path: str | Path, output_path: str | Path) -> Path:
    """Convert an embedding dataset to an AnnData zarr store (reference
    ``trainer.py:187``), through :mod:`viscy_tpu_torch.evaluation.anndata_lite`
    (the JAX package's path when the ``anndata`` package is absent): the
    features as ``X``, the index as ``obs`` under a fresh ``"0"``, ``"1"``,
    ... index, the projections as ``obsm["X_projections"]``; an existing
    store at ``output_path`` is replaced."""
    from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite, write_anndata_zarr
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    ds = read_embedding_dataset(embeddings_path)
    obsm = {"X_projections": np.asarray(ds["projections"])} if "projections" in ds else None
    write_anndata_zarr(output_path, AnnDataLite(np.asarray(ds["features"]), obs=ds["index"].reset_index(), obsm=obsm))
    return Path(output_path)
