"""Human annotations joined onto an embedding store, and an embedding set
converted to an AnnData store (counterpart of
``viscy_tpu/evaluation/annotation.py``: ``convert``, ``load_annotation`` and
``load_annotation_anndata``), on :class:`~viscy_tpu_torch.evaluation.
anndata_lite.Frame` tables.

:func:`convert` writes a dict's embeddings to a temporary store beside the
output first, as JAX does, and removes it at the end, where JAX leaves it
behind (``ROADMAP.md`` Queue 3).

The CSV joins by ``(fov_name, id)`` when both sides have ``id``, else by
``(fov_name, t, track_id)``; ``fov_name`` is stripped of ``/`` on both
sides. Duplicate annotation keys (mitosis frames) resolve to the row
nearest in ``(y, x)`` by Chebyshev distance within ``spatial_tolerance``,
the first in the CSV's order on a tie. A row without a match gets NaN (a
numeric column turns float64, as pandas' reindex turns it; a string column
holds a NaN object). This module computes no distances at scale and takes
no device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from viscy_tpu_torch.evaluation.anndata_lite import Frame
from viscy_tpu_torch.evaluation.zarr_utils import _key

__all__ = ["convert", "load_annotation", "load_annotation_anndata"]


def convert(embeddings: dict | str | Path, output_path: str | Path, overwrite: bool = False,
            return_anndata: bool = False):
    """Convert an embedding set to an AnnData zarr store at ``output_path``:
    a store the embedding writer wrote, or a dict of ``features``, ``index``
    (a :class:`Frame` or a list of row dicts) and optionally
    ``projections``. Returns the written store read back
    (:func:`~viscy_tpu_torch.evaluation.anndata_lite.read_anndata_zarr`)
    when ``return_anndata``, else None."""
    import shutil

    from viscy_tpu_torch.evaluation.anndata_lite import read_anndata_zarr
    from viscy_tpu_torch.preprocess.precompute import convert_to_anndata
    from viscy_tpu_torch.training.callbacks.embedding_writer import write_embedding_dataset

    output_path = Path(output_path)
    if output_path.exists() and not overwrite:
        raise FileExistsError(f"Output path {output_path} already exists.")
    tmp = None
    if isinstance(embeddings, dict):
        # one converter for both inputs: the dict goes to a store first
        tmp = output_path.with_suffix(".tmp_embeddings")
        write_embedding_dataset(tmp, embeddings["features"], embeddings["index"],
                                projections=embeddings.get("projections"), overwrite=True)
        embeddings = tmp
    try:
        result = convert_to_anndata(embeddings, output_path)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return read_anndata_zarr(result) if return_anndata else None


def load_annotation(dataset, path: str | Path, name: str, categories: dict | None = None,
                    spatial_tolerance: float = 4.0) -> np.ndarray:
    """The annotation column ``name`` aligned to the embedding rows; also
    added to ``dataset``'s index (``ds["index"]``, or the ``Frame`` itself)
    in place."""
    from viscy_tpu_torch.data._tracks import read_csv

    index = dataset if isinstance(dataset, Frame) else dataset["index"]
    ann = read_csv(path)
    ann_fov = np.asarray([str(f).strip("/") for f in ann["fov_name"]], dtype=object)
    obs_fov = np.asarray([str(f).strip("/") for f in index["fov_name"]], dtype=object)
    if "id" in index and "id" in ann:
        key_cols = ["id"]
    elif all(c in index for c in ("fov_name", "t", "track_id")) and all(c in ann for c in ("fov_name", "t", "track_id")):
        key_cols = ["t", "track_id"]
    else:
        raise KeyError("Cannot join annotations: embeddings have neither (fov_name, id) nor (fov_name, t, track_id) "
                       "columns.")
    ann_keys = list(zip(ann_fov.tolist(), *(map(_key, ann[c].tolist()) for c in key_cols)))
    obs_keys = list(zip(obs_fov.tolist(), *(map(_key, index[c].tolist()) for c in key_cols)))
    where: dict[tuple, list[int]] = {}
    for i, k in enumerate(ann_keys):
        where.setdefault(k, []).append(i)
    values = ann[name]
    unique = all(len(v) == 1 for v in where.values())
    if unique:
        rows = np.asarray([where.get(k, [-1])[0] for k in obs_keys], dtype=np.int64)
    else:
        if not all(c in ann for c in ("y", "x")) or not all(c in index for c in ("y", "x")):
            raise ValueError(f"Annotation index {['fov_name', *key_cols]} has duplicate keys (typical of mitosis "
                             "split frames) but cannot disambiguate: both sides must carry (y, x) columns for "
                             "spatial matching.")
        ay, ax = np.asarray(ann["y"], float), np.asarray(ann["x"], float)
        ey, ex = np.asarray(index["y"], float), np.asarray(index["x"], float)
        rows = np.full(len(obs_keys), -1, dtype=np.int64)
        for i, k in enumerate(obs_keys):
            cand = np.asarray(where.get(k, []), dtype=np.int64)
            if not len(cand):
                continue
            dist = np.maximum(np.abs(ay[cand] - ey[i]), np.abs(ax[cand] - ex[i]))
            ok = dist <= spatial_tolerance
            if ok.any():
                rows[i] = cand[ok][np.argmin(dist[ok])]
    hit = rows >= 0
    if hit.all() and unique:
        selected = values[rows]
    else:
        selected = np.full(len(rows), np.nan, dtype=np.float64 if values.dtype.kind in "iuf" else object)
        if not unique:
            selected = selected.astype(object)
        selected[hit] = values[rows[hit]]
    if categories:
        selected = np.asarray([categories.get(v, v) for v in selected.tolist()], dtype=object)
    index[name] = selected
    return selected


def load_annotation_anndata(adata, path: str | Path, name: str, **kwargs):
    """Join the annotation column ``name`` onto ``adata.obs`` and return
    ``adata``; ``KeyError`` when the CSV lacks the column."""
    import csv

    with open(path, newline="") as f:
        cols = [h if h else f"Unnamed: {i}" for i, h in enumerate(next(csv.reader(f), []))]
    if name not in cols:
        raise KeyError(f"task {name!r} not in annotation CSV columns {list(cols)}")
    load_annotation(adata.obs, path, name, **kwargs)
    return adata
