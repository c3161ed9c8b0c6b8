"""Batched center crop (counterpart of ``viscy_tpu/transforms/crop.py``)."""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from viscy_tpu_torch.transforms.base import MapTransform


def _roi3(roi_size: Sequence[int] | int) -> tuple[int, int, int]:
    if isinstance(roi_size, int):
        return (roi_size,) * 3
    roi = tuple(int(r) for r in roi_size)
    if len(roi) == 2:
        return (1, *roi)
    return roi


def center_crop(x: torch.Tensor, roi: Sequence[int]) -> torch.Tensor:
    """Center-crop the trailing spatial dims of (..., Z, Y, X); ``-1`` keeps
    a dim whole (MONAI semantics)."""
    roi = _roi3(roi)
    slices = [slice(None)] * (x.ndim - 3)
    for size, r in zip(x.shape[-3:], roi):
        r = size if r < 0 else min(r, size)
        start = (size - r) // 2
        slices.append(slice(start, start + r))
    return x[tuple(slices)]


class BatchedCenterSpatialCropd(MapTransform):
    """Center crop shared across the batch."""

    is_spatial = True
    changes_shape = True

    def __init__(
        self,
        keys: str | Iterable[str],
        roi_size: Sequence[int] | int,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.roi_size = _roi3(roi_size)

    def __call__(self, data: dict) -> dict:
        data = dict(data)
        for k in self.key_iterator(data):
            data[k] = center_crop(data[k], self.roi_size)
        return data
