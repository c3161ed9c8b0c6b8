"""Batched spatial crops (counterpart of ``viscy_tpu/transforms/crop.py``):
center, per-sample random and divisible crops."""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from viscy_tpu_torch.transforms.base import MapTransform, RandTransform

__all__ = [
    "BatchedCenterSpatialCropd",
    "BatchedDivisibleCropd",
    "BatchedRandSpatialCropd",
    "batched_crop_at",
    "center_crop",
]


def _roi3(roi_size: Sequence[int] | int) -> tuple[int, int, int]:
    if isinstance(roi_size, int):
        return (roi_size,) * 3
    roi = tuple(int(r) for r in roi_size)
    if len(roi) == 2:
        return (1, *roi)
    return roi


def batched_crop_at(x: torch.Tensor, starts: torch.Tensor, roi: Sequence[int]) -> torch.Tensor:
    """Crop (B, C, Z, Y, X) at per-sample (B, 3) start voxels to the static
    ``roi``: one gather per axis, no read of ``starts`` on the host. A start
    that would overrun the input is clamped to fit, as
    ``jax.lax.dynamic_slice`` clamps it."""
    starts = starts.to(device=x.device, dtype=torch.long)
    b, c = x.shape[:2]
    for a, r in enumerate(roi):
        dim = 2 + a
        first = torch.clamp(starts[:, a, None], 0, x.shape[dim] - r)
        idx = first + torch.arange(r, device=x.device)[None]  # (B, r)
        shape = [b, 1, 1, 1, 1]
        shape[dim] = r
        size = list(x.shape)
        size[dim] = r
        x = torch.gather(x, dim, idx.reshape(shape).expand(size))
    return x


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


def rand_crop_roi(roi_size: Sequence[int], spatial: Sequence[int]) -> tuple[int, int, int]:
    """The crop size per axis: ``-1`` keeps the whole extent (MONAI
    semantics), else at most the extent."""
    return tuple(s if r < 0 else min(r, s) for r, s in zip(roi_size, spatial))


def draw_crop_starts(generator, b: int, spatial, roi, device) -> torch.Tensor:
    """Uniform per-sample (B, 3) int32 crop starts in ``[0, S - R]``, as
    ``jax.random.uniform(key, (B, 3)) * (S - R + 1)`` truncated, clamped."""
    maxs = torch.tensor([s - r for s, r in zip(spatial, roi)], device=device)
    u = torch.rand((b, 3), generator=generator, device=device)
    return torch.minimum((u * (maxs + 1)).to(torch.int32), maxs.to(torch.int32))


class BatchedRandSpatialCropd(RandTransform):
    """Per-sample random crop with shared coordinates across keys
    (``random_center=False``: the center crop). Draws: ``starts`` (B, 3)
    int."""

    is_spatial = True
    changes_shape = True

    def __init__(
        self,
        keys: str | Iterable[str],
        roi_size: Sequence[int] | int,
        random_center: bool = True,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, 1.0, allow_missing_keys)
        self.roi_size = _roi3(roi_size)
        self.random_center = random_center

    def draw(self, data: dict, generator: torch.Generator) -> dict:
        first = data[self.first_key(data)]
        b, spatial = first.shape[0], tuple(first.shape[-3:])
        roi = rand_crop_roi(self.roi_size, spatial)
        if self.random_center:
            starts = draw_crop_starts(generator, b, spatial, roi, first.device)
        else:
            center = [(s - r) // 2 for s, r in zip(spatial, roi)]
            starts = torch.tensor(center, dtype=torch.int32, device=first.device).expand(b, 3)
        return dict(starts=starts)

    def apply(self, data: dict, draws: dict) -> dict:
        first = data[self.first_key(data)]
        roi = rand_crop_roi(self.roi_size, tuple(first.shape[-3:]))
        for k in self.key_iterator(data):
            data[k] = batched_crop_at(data[k], draws["starts"], roi)
        return data


class BatchedDivisibleCropd(MapTransform):
    """Center-crop spatial dims down to the nearest multiple of ``k``."""

    is_spatial = True
    changes_shape = True

    def __init__(
        self,
        keys: str | Iterable[str],
        k: int | Sequence[int],
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.k = tuple(k) if isinstance(k, Sequence) else (k,)

    def __call__(self, data: dict) -> dict:
        data = dict(data)
        spatial = tuple(data[self.first_key(data)].shape[-3:])
        k = self.k if len(self.k) == 3 else self.k * 3
        roi = tuple(s // ki * ki for s, ki in zip(spatial, k))
        if any(r == 0 for r in roi):
            raise ValueError(f"DivisibleCrop k={k} larger than spatial dims {spatial}")
        if roi == spatial:
            return data
        for kk in self.key_iterator(data):
            data[kk] = center_crop(data[kk], roi)
        return data
