"""Collation and norm-meta utilities (the part of
``viscy_tpu/data/utils.py`` the port's datamodule uses)."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np


def ensure_channel_list(channels) -> list[str]:
    if isinstance(channels, str):
        return [channels]
    return list(channels)


def read_norm_meta(fov) -> dict | None:
    """``.zattrs["normalization"]`` of a Position with float32 values."""
    norm = fov.zattrs.get("normalization")
    if norm is None:
        return None
    out = {}
    for channel, levels in norm.items():
        out[channel] = {
            level: {k: np.float32(v) for k, v in stats.items()}
            if level != "timepoint_statistics"
            else {tp: {k: np.float32(v) for k, v in s.items()} for tp, s in stats.items()}
            for level, stats in levels.items()
        }
    return out


def _collate_leaves(values: list[Any]) -> Any:
    """Stack arrays, recurse dicts, list everything else."""
    v0 = values[0]
    if isinstance(v0, np.ndarray):
        return np.stack(values)
    if isinstance(v0, (np.floating, np.integer, float, int)):
        return np.asarray(values)
    if isinstance(v0, dict):
        return {k: _collate_leaves([v[k] for v in values]) for k in v0}
    return values


def collate_samples(samples: Sequence[dict]) -> dict:
    """Collate sample dicts into a batch dict; a dataset item that is a
    list of patches (the weighted crop's ``num_samples``) is flattened, so
    all patches of the batch concatenate along the leading axis."""
    flat: list[dict] = []
    for s in samples:
        if isinstance(s, list):
            flat.extend(s)
        else:
            flat.append(s)
    keys = flat[0].keys()
    return {k: _collate_leaves([s[k] for s in flat]) for k in keys}
