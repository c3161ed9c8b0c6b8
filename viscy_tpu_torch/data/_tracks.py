"""Track and annotation tables without pandas, for the triplet and
classification datamodules (:mod:`viscy_tpu_torch.data.triplet`,
:mod:`viscy_tpu_torch.data.cell_classification`).

The JAX datamodule holds each FOV's tracking CSV as a pandas DataFrame
(``viscy_tpu/data/triplet.py``); the card's machine has no pandas, so the
port keeps named numpy columns in a
:class:`~viscy_tpu_torch.evaluation.anndata_lite.Frame` and reproduces the
pandas operations it relies on, row order included:

- ``pd.read_csv(path).astype(int)``: every column becomes int64, floats
  truncate toward zero, a missing or non-finite value raises;
- ``groupby("global_track_id")`` walks the groups in sorted key order
  (string order: ``"A/1/0_10"`` before ``"A/1/0_2"``), each group's rows in
  their original order;
- an inner ``merge`` keeps the order of the left rows;
- ``pd.read_csv(path)`` of an annotation table (:func:`read_csv`) types
  each column as pandas infers it: int64, else float64 (a missing value
  becomes NaN), else strings. Floats are parsed correctly rounded; pandas'
  default parser can differ from that in the last bit, which moves no
  comparison with an integer and no truncation of a value written from one.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterable

import numpy as np

from viscy_tpu_torch.evaluation.anndata_lite import Frame


def _int64_column(name: str, cells: list[str], where: Path) -> np.ndarray:
    """One CSV column as ``astype(int)`` gives it after ``read_csv``."""
    raw = np.asarray(cells, dtype=str)
    if (np.char.strip(raw) == "").any():
        raise ValueError(f"{where}: column {name!r} has a missing value, which cannot be converted to an integer")
    try:
        return raw.astype(np.int64)
    except ValueError:
        pass
    try:
        values = raw.astype(np.float64)
    except ValueError:
        raise ValueError(f"{where}: column {name!r} holds a value that is not a number") from None
    if not np.isfinite(values).all():
        raise ValueError(
            f"{where}: column {name!r} holds a missing or non-finite value, which cannot be "
            "converted to an integer"
        )
    return values.astype(np.int64)  # truncation toward zero


def _csv_columns(path: Path) -> tuple[list[str], list[list[str]], int]:
    """``(header, cells of each column, rows)`` of a CSV file; an unnamed
    header cell becomes ``"Unnamed: <i>"``, a short row is padded with
    empty cells, a long one raises."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: no header")
    header = [h if h else f"Unnamed: {i}" for i, h in enumerate(rows[0])]
    body = [r for r in rows[1:] if r]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields for {len(header)} columns")
    return header, [[r[j] if j < len(r) else "" for r in body] for j in range(len(header))], len(body)


def read_tracks_csv(path: str | Path) -> Frame:
    """A tracking CSV with every column as int64 (``pd.read_csv(path)
    .astype(int)``)."""
    path = Path(path)
    header, cells, _ = _csv_columns(path)
    return Frame({h: _int64_column(h, c, path) for h, c in zip(header, cells)})


def group_order(keys: np.ndarray) -> np.ndarray:
    """Row order of ``groupby(keys)`` walked group by group: groups in sorted
    key order, each group's rows in their original order."""
    return np.asarray(sorted(range(len(keys)), key=lambda i: keys[i]), dtype=np.int64)


def rows_with_partner(tracks: Frame, interval: int) -> Frame:
    """The rows whose track also has a row at ``t + interval``, in
    ``groupby("global_track_id")`` order (``TripletDataset._filter_anchors``)."""
    gid, t = tracks["global_track_id"], tracks["t"]
    times: dict[str, set] = {}
    for g, ti in zip(gid.tolist(), t.tolist()):
        times.setdefault(g, set()).add(ti)
    order = group_order(gid)
    keep = [i for i in order.tolist() if t[i] + interval in times[gid[i]]]
    return tracks.take(np.asarray(keep, dtype=np.int64))


def merge_inner(left_keys: Iterable[tuple], right: Frame, right_keys: Iterable[tuple]) -> Frame:
    """``right``'s rows that match each left key, left by left, each left
    key's matches in ``right``'s order (an inner merge on those keys)."""
    where: dict[tuple, list[int]] = {}
    for i, k in enumerate(right_keys):
        where.setdefault(k, []).append(i)
    rows = [i for k in left_keys for i in where.get(k, ())]
    return right.take(np.asarray(rows, dtype=np.int64))


def _infer_csv_column(cells: list[str]) -> np.ndarray:
    """One CSV column as ``pd.read_csv`` types it: int64 when every cell is
    an integer, float64 when every cell is a number or empty (NaN), else
    strings (an empty cell of a string column stays empty)."""
    raw = np.asarray(cells, dtype=str)
    stripped = np.char.strip(raw)
    if len(raw) and not (stripped == "").any():
        try:
            return raw.astype(np.int64)
        except ValueError:
            pass
    try:
        return np.where(stripped == "", "nan", raw).astype(np.float64)
    except ValueError:
        return np.asarray(cells, dtype=object)


def read_csv(path: str | Path) -> Frame:
    """A CSV table with its columns typed as ``pd.read_csv(path)`` types
    them (see :func:`_infer_csv_column`)."""
    header, cells, n = _csv_columns(Path(path))
    return Frame({h: _infer_csv_column(c) for h, c in zip(header, cells)}, n_rows=n)
