"""Well and FOV selection helpers (counterpart of ``viscy_tpu/data/select.py``)."""

from __future__ import annotations

from typing import Iterable

from viscy_tpu_torch.zarr_io.store import Plate, Position


def filter_fovs(
    plate: Plate,
    include_fov_names: Iterable[str] | None = None,
    exclude_fov_names: Iterable[str] | None = None,
) -> list[Position]:
    """The plate's positions named in ``include_fov_names`` (all when it is
    empty) and not in ``exclude_fov_names``, in plate order."""
    include = set(include_fov_names) if include_fov_names else None
    exclude = set(exclude_fov_names) if exclude_fov_names else set()
    return [
        pos
        for name, pos in plate.positions()
        if (include is None or name in include) and name not in exclude
    ]


class SelectWell:
    """Mixin holding a well filter (``row/col`` names) and FOV exclusions."""

    _include_wells: list[str] | None = None
    _exclude_fovs: list[str] | None = None

    def _filter_fit_fovs(self, plate: Plate) -> list[Position]:
        positions = [
            pos
            for name, pos in plate.positions()
            if (self._include_wells is None or "/".join(name.split("/")[:2]) in self._include_wells)
            and (self._exclude_fovs is None or name not in self._exclude_fovs)
        ]
        if not positions:
            raise ValueError("No FOVs left after filtering.")
        return positions
