"""Lineage-aware track alignment to a perturbation event (counterpart of
``viscy_tpu/apps/dynaclr/pseudotime/alignment.py``), on
:class:`~viscy_tpu_torch.evaluation.anndata_lite.Frame` tables: build
lineages from (fov_name, track_id, parent_track_id), find each lineage's
earliest infected frame, and anchor every member track's clock there
(``t_perturb`` / ``t_relative_minutes``). Row order follows pandas'
``groupby`` (keys sorted, rows in their order), as JAX's
``set_index(...).loc[valid]`` leaves it.
"""

from __future__ import annotations

import logging
from typing import Literal

import numpy as np

from viscy_tpu_torch.evaluation.anndata_lite import Frame

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["align_tracks", "assign_t_perturb", "filter_tracks", "identify_lineages", "track_groups"]


def track_groups(df: Frame, keys: tuple[str, ...] = ("fov_name", "track_id")) -> dict[tuple, np.ndarray]:
    """``groupby(keys)``: each key (sorted) to its rows, in order."""
    out: dict[tuple, list[int]] = {}
    for i, k in enumerate(zip(*(df[c].tolist() for c in keys))):
        out.setdefault(k, []).append(i)
    return {k: np.asarray(out[k], np.int64) for k in sorted(out)}


def _keep_long_tracks(df: Frame, min_timepoints: int) -> Frame:
    """``df.set_index(["fov_name", "track_id"]).loc[valid].reset_index()``
    with the tracks of at least ``min_timepoints`` rows: grouped, the key
    columns first."""
    rows = [r for r in track_groups(df).values() if len(r) >= min_timepoints]
    taken = df.take(np.concatenate(rows) if rows else np.zeros(0, np.int64))
    names = ["fov_name", "track_id", *[n for n in df.names if n not in ("fov_name", "track_id")]]
    return Frame({n: taken[n] for n in names}, n_rows=len(taken))


def identify_lineages(tracking_df: Frame, return_both_branches: bool = False) -> list[tuple[str, list[int]]]:
    """(fov_name, [track_ids]) per lineage branch from parent-child links;
    ``return_both_branches`` yields every branch after a division, else the
    first of each root."""
    all_lineages: list[tuple[str, list[int]]] = []
    fovs = tracking_df["fov_name"].tolist()
    for fov_id in sorted(set(fovs)):
        rows = [i for i, f in enumerate(fovs) if f == fov_id]
        first: dict[int, int] = {}
        for i in rows:
            tid, parent = int(tracking_df["track_id"][i]), tracking_df["parent_track_id"][i]
            if tid not in first and parent == parent:  # .first() skips NaN
                first[tid] = int(parent)
        first = dict(sorted(first.items()))
        all_tracks = set(first)
        child_to_parent = {t: p for t, p in first.items() if p != -1}
        root_tracks = {t for t in all_tracks if first[t] == -1 or first[t] not in all_tracks}
        parent_to_children: dict[int, list[int]] = {}
        for child, parent in child_to_parent.items():
            parent_to_children.setdefault(parent, []).append(child)

        def branches(track_id: int) -> list[list[int]]:
            if track_id not in parent_to_children:
                return [[track_id]]
            return [[track_id] + br for child in parent_to_children[track_id] for br in branches(child)]

        for root in root_tracks:
            lineage = branches(root)
            if return_both_branches:
                all_lineages.extend((fov_id, br) for br in lineage)
            else:
                all_lineages.append((fov_id, lineage[0]))
    return all_lineages


def filter_tracks(df: Frame, fov_pattern: str | list[str] | None = None, min_timepoints: int = 1) -> Frame:
    """The rows whose FOV name holds any of ``fov_pattern`` (substrings), of
    tracks at least ``min_timepoints`` long."""
    result = df
    if fov_pattern is not None:
        patterns = [fov_pattern] if isinstance(fov_pattern, str) else list(fov_pattern)
        names = [str(f) for f in df["fov_name"].tolist()]
        result = df.take(np.asarray([any(p in n for p in patterns) for n in names], bool))
        if not len(result):
            _logger.warning("No FOVs matched pattern(s): %s", patterns)
            return result
    if min_timepoints > 1:
        result = _keep_long_tracks(result, min_timepoints)
    return result


def assign_t_perturb(df: Frame, frame_interval_minutes: float,
                     source: Literal["annotation", "prediction"] = "annotation", infection_col: str = "infection_state",
                     infected_value: str = "infected", min_track_timepoints: int = 3) -> Frame:
    """Anchor every track's clock at its lineage's earliest infected frame:
    adds ``t_perturb`` (int) and ``t_relative_minutes``; drops the tracks
    whose lineage never shows infection and those shorter than
    ``min_track_timepoints``. A track outside every infected lineage
    anchors on its own first infected frame."""
    df = Frame(dict(df.columns), index=df.index)
    if "parent_track_id" not in df:
        df["parent_track_id"] = np.full(len(df), -1, np.int64)
    col = f"predicted_{infection_col}" if source == "prediction" else infection_col
    if col not in df:
        raise KeyError(f"Column {col!r} not found. Available: {df.names}")
    fov, tid, t = df["fov_name"].tolist(), df["track_id"].tolist(), df["t"].tolist()
    first_infected: dict[tuple, int] = {}  # each track's earliest infected frame
    for key, ti, v in zip(zip(fov, tid), t, df[col].tolist()):
        if v == infected_value:
            first_infected[key] = min(ti, first_infected.get(key, ti))
    track_to_tp: dict[tuple, int] = {}
    in_lineage: set[tuple] = set()
    for fov_name, track_ids in identify_lineages(df, return_both_branches=True):
        times = [first_infected[(fov_name, tr)] for tr in track_ids if (fov_name, tr) in first_infected]
        if not times:
            continue
        tp = int(min(times))
        for track in track_ids:
            track_to_tp[(fov_name, track)] = tp
            in_lineage.add((fov_name, track))
    n_lineage, n_orphan = len(in_lineage), 0
    for key in track_groups(df):
        if key not in in_lineage and key in first_infected:
            track_to_tp[key] = int(first_infected[key])
            n_orphan += 1
    tp = [track_to_tp.get(k) for k in zip(fov, tid)]
    keep = np.asarray([v is not None for v in tp], bool)
    df["t_perturb"] = np.asarray([v if v is not None else -1 for v in tp], np.int64)
    df = df.take(keep)
    if min_track_timepoints > 1:
        df = _keep_long_tracks(df, min_track_timepoints)
    df["t_relative_minutes"] = (np.asarray(df["t"]) - df["t_perturb"]) * frame_interval_minutes
    _logger.info("Tracks with infection: %d (lineage: %d, orphan: %d)", len(track_to_tp), n_lineage, n_orphan)
    return df


def align_tracks(df: Frame, frame_interval_minutes: float, source: Literal["annotation", "prediction"] = "annotation",
                 infection_col: str = "infection_state", infected_value: str = "infected",
                 min_track_timepoints: int = 3, fov_pattern: str | list[str] | None = None) -> Frame:
    """:func:`filter_tracks` then :func:`assign_t_perturb`."""
    return assign_t_perturb(filter_tracks(df, fov_pattern=fov_pattern, min_timepoints=1), frame_interval_minutes,
                            source=source, infection_col=infection_col, infected_value=infected_value,
                            min_track_timepoints=min_track_timepoints)
