"""QC metric protocol and metadata writer (counterpart of
``viscy_tpu/apps/qc/qc_metrics.py``)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Protocol

from viscy_tpu_torch.preprocess.stats import write_meta_field
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

_logger = logging.getLogger("viscy_tpu_torch")


class QCMetric(Protocol):
    """A QC metric computes per-(FOV, channel) metadata."""

    field_name: str

    def channels(self) -> list[str]: ...

    def __call__(self, position, channel_name: str, channel_index: int, num_workers: int = 4) -> dict: ...


def generate_qc_metadata(zarr_dir: str | Path, metrics: list[QCMetric], num_workers: int = 4) -> None:
    """Run each metric over every FOV of the plate and merge its result into
    the FOV's ``zattrs[metric.field_name][channel]``."""
    plate = open_ome_zarr(zarr_dir, mode="r+")
    channel_names = plate.channel_names
    for metric in metrics:
        for ch in metric.channels():
            ch_idx = channel_names.index(ch)
            for name, pos in plate.positions():
                result = metric(pos, ch, ch_idx, num_workers=num_workers)
                write_meta_field(pos, result, metric.field_name, ch)
                _logger.info(f"{metric.field_name}[{ch}] done for {name}")
