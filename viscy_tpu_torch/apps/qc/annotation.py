"""Channel annotation and experiment metadata into OME-Zarr zattrs
(counterpart of ``viscy_tpu/apps/qc/annotation.py``)."""

from __future__ import annotations

from pathlib import Path

from viscy_tpu_torch.apps.airtable_utils.schemas import parse_position_name
from viscy_tpu_torch.zarr_io.store import open_ome_zarr


def write_annotation_metadata(zarr_dir: str | Path, annotation) -> None:
    """Write ``channels_metadata`` to the plate and to every position, and
    each well's ``experiment_metadata`` to its positions.

    Raises ``ValueError`` naming a channel of ``annotation`` that the plate
    lacks, or a well path it lacks, before anything is written.
    """
    plate = open_ome_zarr(zarr_dir, mode="r+")
    plate_channels = set(plate.channel_names)
    for ch_name in annotation.channels_metadata:
        if ch_name not in plate_channels:
            raise ValueError(
                f"Channel '{ch_name}' in annotation config not found in plate. "
                f"Available channels: {sorted(plate_channels)}"
            )
    position_list = list(plate.positions())
    plate_well_paths = {parse_position_name(name)[0] for name, _ in position_list}
    for well_path in annotation.experiment_metadata:
        if well_path not in plate_well_paths:
            raise ValueError(
                f"Well path '{well_path}' in annotation config not found in "
                f"plate. Available wells: {sorted(plate_well_paths)}"
            )
    channels_metadata = {k: v.model_dump() for k, v in annotation.channels_metadata.items()}
    plate.zattrs["channels_metadata"] = channels_metadata
    for name, pos in position_list:
        pos.zattrs["channels_metadata"] = channels_metadata
        well_path = parse_position_name(name)[0]
        if well_path in annotation.experiment_metadata:
            pos.zattrs["experiment_metadata"] = annotation.experiment_metadata[well_path].model_dump()
