"""Track tables without pandas, for the triplet datamodule
(:mod:`viscy_tpu_torch.data.triplet`).

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
- an inner ``merge`` keeps the order of the left rows.
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


def read_tracks_csv(path: str | Path) -> Frame:
    """A tracking CSV with every column as int64 (``pd.read_csv(path)
    .astype(int)``); an unnamed header cell becomes ``"Unnamed: <i>"``."""
    path = Path(path)
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: no header")
    header = [h if h else f"Unnamed: {i}" for i, h in enumerate(rows[0])]
    body = [r for r in rows[1:] if r]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields for {len(header)} columns")
    cells = [[r[j] if j < len(r) else "" for r in body] for j in range(len(header))]
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
