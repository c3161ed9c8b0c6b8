"""In-place edits of an AnnData embedding store (counterpart of
``viscy_tpu/evaluation/zarr_utils.py``) through
:mod:`viscy_tpu_torch.evaluation.anndata_lite`, without pandas.

The port writes uncompressed arrays (``obsm``, ``uns``) and rewrites
``obs`` whole; the legacy ``index.parquet`` layout raises by name, as the
port's reader does. Tables are :class:`~viscy_tpu_torch.evaluation.
anndata_lite.Frame`\\ s; the CSV is read as ``pd.read_csv`` types it
(:func:`viscy_tpu_torch.data._tracks.read_csv`).
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any

import numpy as np

from viscy_tpu_torch.evaluation.anndata_lite import (
    _ARRAY_ATTRS,
    AnnDataLite,
    Frame,
    _init_group,
    _write_array,
    _write_dataframe,
)

__all__ = ["append_to_anndata_zarr", "append_to_embedding_dataset", "merge_csv_into_obs", "notna"]


def _replace(path: Path) -> Path:
    if path.exists():
        shutil.rmtree(path)
    return path


def append_to_embedding_dataset(
    path: str | Path,
    *,
    obsm: dict[str, Any] | None = None,
    obs: Frame | None = None,
    uns: dict | None = None,
) -> None:
    """Replace or add ``obsm`` arrays (float32), the ``obs`` table, or
    ``uns`` entries of an existing store without rewriting ``X``."""
    path = Path(path)
    if (path / "index.parquet").exists():
        raise NotImplementedError(f"{path}: the legacy index.parquet layout is not ported to viscy_tpu_torch")
    if not (path / ".zattrs").exists():
        raise FileNotFoundError(f"{path} is not an embedding dataset")
    if obsm:
        _init_group(path / "obsm", {"encoding-type": "dict", "encoding-version": "0.1.0"})
        for key, value in obsm.items():
            _write_array(_replace(path / "obsm" / key), np.asarray(value, np.float32), attrs=_ARRAY_ATTRS)
    if obs is not None:
        _write_dataframe(_replace(path / "obs"), obs)
    if uns:
        _init_group(path / "uns", {"encoding-type": "dict", "encoding-version": "0.1.0"})
        for key, value in uns.items():
            if isinstance(value, str):
                _write_array(_replace(path / "uns" / key), np.asarray(value, dtype=object).reshape(()),
                             attrs={"encoding-type": "string", "encoding-version": "0.2.0"})
            else:
                _write_array(_replace(path / "uns" / key), np.asarray(value), attrs=_ARRAY_ATTRS)


append_to_anndata_zarr = append_to_embedding_dataset


def notna(values: np.ndarray) -> np.ndarray:
    """``pd.Series(values).notna()``: NaN in a float column, NaN or None in
    an object column, are missing. A store writes a missing string as the
    category ``"nan"``, which reads back present, in pandas as here."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return ~np.isnan(values)
    if values.dtype == object:
        return np.asarray([not (v is None or (isinstance(v, float) and v != v)) for v in values], bool)
    return np.ones(len(values), bool)


def _key(v):
    """A merge key cell: numbers compare by value (an int column joins a
    float one, as in pandas), everything else as its string."""
    if isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, (bool, np.bool_)):
        return float(v)
    return str(v)


def _missing_like(values: np.ndarray, n: int) -> np.ndarray:
    if values.dtype.kind in "iufb":
        return np.full(n, np.nan)
    return np.full(n, np.nan, dtype=object)


def merge_csv_into_obs(
    dataset: AnnDataLite | Frame,
    csv_path: str | Path,
    merge_key: str | list[str] = "id",
    columns: list[str] | None = None,
    prefix: str = "",
) -> tuple[AnnDataLite | Frame, dict[str, int]]:
    """Left-join CSV columns onto ``obs`` by ``merge_key`` (JAX's
    ``merge_csv_into_obs``): the CSV's first row of each key wins; a row
    without a match gets NaN (an integer column turns float64, as pandas
    turns it). Returns the dataset
    (``obs`` replaced; a bare ``Frame`` comes back as a new one) and
    ``{column: matched rows}``."""
    from viscy_tpu_torch.data._tracks import read_csv

    index = dataset if isinstance(dataset, Frame) else dataset.obs
    keys = [merge_key] if isinstance(merge_key, str) else list(merge_key)
    csv = read_csv(csv_path)
    if columns is None:
        columns = [c for c in csv.names if c not in keys]
    missing = [c for c in keys + columns if c not in csv]
    if missing:
        raise ValueError(f"Usecols do not match columns, columns expected but not found: {missing}")
    first: dict[tuple, int] = {}
    for i, k in enumerate(zip(*(csv[c].tolist() for c in keys))):
        first.setdefault(tuple(_key(v) for v in k), i)
    rows = np.asarray([first.get(tuple(_key(v) for v in k), -1)
                       for k in zip(*(index[c].tolist() for c in keys))], dtype=np.int64)
    hit = rows >= 0
    merged = Frame(dict(index.columns), index=index.index)
    stats = {}
    for c in columns:
        values = csv[c]
        if hit.all():
            col = values[rows]
        else:
            col = _missing_like(values, len(rows))
            col[hit] = values[rows[hit]]
        merged[f"{prefix}{c}"] = col
        stats[f"{prefix}{c}"] = int((notna(col) & hit).sum())
    if isinstance(dataset, Frame):
        return merged, stats
    dataset.obs = merged
    return dataset, stats
