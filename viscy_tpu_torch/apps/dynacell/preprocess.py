"""DynaCell preprocessing helpers (counterpart of
``viscy_tpu/apps/dynacell/preprocess.py``; reference ``dynacell/preprocess``):
the YAML config and a store copied into new chunks."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import yaml

_logger = logging.getLogger(__name__)

__all__ = ["load_preprocess_config", "rewrite_zarr"]


def load_preprocess_config(config_path: Path | str) -> dict:
    """A preprocessing YAML config as a plain dict."""
    config_path = Path(config_path)
    if not config_path.exists():
        raise FileNotFoundError(f"Config file not found: {config_path}")
    with open(config_path) as f:
        return yaml.safe_load(f)


def rewrite_zarr(input_path: Path | str, output_path: Path | str, chunks: tuple[int, ...],
                 shards_ratio: tuple[int, ...] | None = None, version: str = "0.5") -> None:
    """Copy an OME-Zarr HCS store into a new one with ``chunks`` (sharded v3
    when ``shards_ratio`` is given): every position's data, the channel
    names and each position's voxel scale. Positions are read whole into
    memory, as the reference does."""
    from viscy_tpu_torch.zarr_io.store import TransformationMeta, open_ome_zarr

    old = open_ome_zarr(input_path, mode="r")
    new = open_ome_zarr(output_path, layout="hcs", mode="w", channel_names=old.channel_names, version=version)
    for name, old_pos in old.positions():
        row, col, fov = name.split("/")
        data = np.asarray(old_pos["0"][:])
        # the voxel scale carries over: a reset to 1.0 would corrupt every physical-space reader
        new.create_position(row, col, fov).create_image(
            "0", data, chunks=tuple(chunks), transform=[TransformationMeta(scale=list(old_pos.scale))],
            shard=shards_ratio is not None)
        _logger.info("rewrote %s %s -> chunks=%s", name, data.shape, tuple(chunks))
    if shards_ratio is not None:
        _logger.info("sharded v3 layout (shard extents follow the store's chunk-doubling rule; shards_ratio=%s "
                     "is advisory here)", tuple(shards_ratio))
