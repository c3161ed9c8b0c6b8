"""Synthetic OME-Zarr HCS plate factory for tests and benchmarks
(counterpart of ``viscy_tpu/zarr_io/synthetic.py``).

The same numpy draws in the same order as the JAX factory, so one seed
gives the same arrays; a 2x2-well, 4-FOV-per-well plate of U[0, max) data
by default, zarr v2 or sharded v3 (uncompressed, the port's default), with
optional analytically known normalization statistics.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from viscy_tpu_torch.zarr_io.store import open_ome_zarr

DEFAULT_CHANNELS = ["Phase", "Retardance", "GFP", "DAPI"]


def build_hcs_plate(
    path: Path | str,
    channel_names: Sequence[str] = tuple(DEFAULT_CHANNELS),
    zyx_shape: tuple[int, int, int] = (12, 64, 64),
    dtype=np.float32,
    max_value: float = 1.0,
    sharded: bool = False,
    multiscales: bool = False,
    num_timepoints: int = 2,
    rows: Sequence[str] = ("A", "B"),
    cols: Sequence[str] = ("1", "2"),
    fovs: Sequence[str] = ("0", "1", "2", "3"),
    seed: int | None = 42,
    norm_meta: bool = False,
) -> Path:
    """Build a synthetic HCS plate; returns the store path."""
    path = Path(path)
    channel_names = list(channel_names)
    plate = open_ome_zarr(
        path,
        layout="hcs",
        mode="w",
        channel_names=channel_names,
        version="0.5" if sharded else "0.4",
    )
    rng = np.random.default_rng(seed)
    for row in rows:
        for col in cols:
            for fov in fovs:
                pos = plate.create_position(row, col, fov)
                data = (
                    rng.random((num_timepoints, len(channel_names), *zyx_shape)) * max_value
                ).astype(dtype)
                pos.create_image("0", data, chunks=(1, 1, 1, *zyx_shape[1:]), shard=sharded)
                if multiscales:
                    pos.create_image("1", data[::2, :, ::2, ::2, ::2], shard=sharded)
    if norm_meta:
        inject_uniform_norm_meta(path, channel_names, max_value)
    return path


def inject_uniform_norm_meta(
    path: Path | str, channel_names: Sequence[str], max_value: float = 1.0
) -> None:
    """Write analytically known U[0, max) normalization statistics to zattrs."""
    expected = {
        "mean": max_value / 2,
        "std": max_value / np.sqrt(12),
        "median": max_value / 2,
        "iqr": max_value / 2,
        "min": 0.0,
        "max": max_value,
        "p1": 0.01 * max_value,
        "p5": 0.05 * max_value,
        "p95": 0.95 * max_value,
        "p99": 0.99 * max_value,
    }
    meta = {
        ch: {"dataset_statistics": dict(expected), "fov_statistics": dict(expected)}
        for ch in channel_names
    }
    plate = open_ome_zarr(path, mode="r+")
    plate.zattrs["normalization"] = meta
    for _, fov in plate.positions():
        fov.zattrs["normalization"] = meta
