"""Batched spatial crops (counterpart of ``viscy_tpu/transforms/crop.py``):
center, per-sample random, divisible and weighted crops, and the tiled
crop samples."""

from __future__ import annotations

from typing import Iterable, Sequence

import torch
import torch.nn.functional as F

from viscy_tpu_torch.transforms.base import MapTransform, RandTransform

__all__ = [
    "BatchedCenterSpatialCropd",
    "BatchedDivisibleCropd",
    "BatchedRandSpatialCropd",
    "BatchedRandWeightedCropd",
    "TiledSpatialCropSamplesd",
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


def window_sums(w: torch.Tensor, cy: int, cx: int) -> torch.Tensor:
    """VALID (cy, cx) window sums of (B, Y, X) weights, (B, Y - cy + 1,
    X - cx + 1), from an integral image in float64."""
    integral = F.pad(w.double(), (1, 0, 1, 0)).cumsum(1).cumsum(2)
    vy, vx = w.shape[1] - cy + 1, w.shape[2] - cx + 1
    return (integral[:, cy:, cx:][:, :vy, :vx] - integral[:, :-cy, cx:][:, :vy, :vx]
            - integral[:, cy:, :-cx][:, :vy, :vx] + integral[:, :-cy, :-cx][:, :vy, :vx])


class BatchedRandWeightedCropd(RandTransform):
    """Per-sample random crops whose YX origin is drawn with probability
    proportional to the window sum of the ``w_key`` weights (summed over C
    and Z, negatives clipped to 0; all-zero weights give a uniform draw);
    the Z origin is uniform. All keys share the crop. Draws: ``index``
    (B,), the flat origin in the (Y - cy + 1, X - cx + 1) grid, and
    ``z_starts`` (B,)."""

    is_spatial = True
    changes_shape = True

    def __init__(
        self,
        keys: str | Iterable[str],
        w_key: str,
        spatial_size: Sequence[int],
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, 1.0, allow_missing_keys)
        self.w_key = w_key
        self.spatial_size = _roi3(spatial_size)

    def _check(self, w: torch.Tensor) -> None:
        if w.ndim != 5:
            raise ValueError(f"requires 5D (B, C, Z, Y, X), got {w.ndim}D")
        if any(c > s for c, s in zip(self.spatial_size, w.shape[-3:])):
            raise ValueError(f"spatial_size {self.spatial_size} exceeds input {tuple(w.shape[-3:])}")

    def draw(self, data: dict, generator: torch.Generator) -> dict:
        w = data[self.w_key]
        self._check(w)
        b, z = w.shape[0], w.shape[2]
        cz, cy, cx = self.spatial_size
        # the four-corner differences of a window wholly on zero weights can round below 0
        sums = torch.clamp_min(window_sums(torch.clamp_min(w.float().sum(dim=(1, 2)), 0.0), cy, cx), 0.0)
        sums = sums.reshape(b, -1)
        probs = torch.where(sums.sum(dim=1, keepdim=True) > 0, sums, torch.ones_like(sums))
        index = torch.multinomial(probs, 1, generator=generator).reshape(b)
        if cz >= z:
            z_starts = torch.zeros((b,), dtype=torch.long, device=w.device)
        else:
            z_starts = torch.randint(0, z - cz + 1, (b,), generator=generator, device=w.device)
        return dict(index=index, z_starts=z_starts)

    def apply(self, data: dict, draws: dict) -> dict:
        w = data[self.w_key]
        self._check(w)
        vx = w.shape[-1] - self.spatial_size[2] + 1
        index = draws["index"].to(w.device).long()
        starts = torch.stack([draws["z_starts"].to(w.device).long(), index // vx, index % vx], dim=1)
        for k in self.key_iterator(data):
            data[k] = batched_crop_at(data[k], starts, self.spatial_size)
        return data


class TiledSpatialCropSamplesd(MapTransform):
    """Deterministic non-overlapping grid crops (reproducible validation):
    the first ``num_samples`` tiles of ``roi_size`` on a grid from the
    origin, Z then Y then X; returns a list of sample dicts."""

    is_spatial = True
    changes_shape = True

    def __init__(
        self,
        keys: str | Iterable[str],
        roi_size: Sequence[int],
        num_samples: int,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.roi_size = _roi3(roi_size)
        self.num_samples = num_samples

    def origins(self, spatial: Sequence[int]) -> list[tuple[int, int, int]]:
        counts = [max(1, s // r) for s, r in zip(spatial, self.roi_size)]
        if counts[0] * counts[1] * counts[2] < self.num_samples:
            raise ValueError(f"Cannot tile {self.num_samples} crops of {self.roi_size} from {tuple(spatial)}")
        rz, ry, rx = self.roi_size
        grid = [(iz * rz, iy * ry, ix * rx)
                for iz in range(counts[0]) for iy in range(counts[1]) for ix in range(counts[2])]
        return grid[: self.num_samples]

    def __call__(self, data: dict) -> list[dict]:
        first = data[self.first_key(data)]
        rz, ry, rx = self.roi_size
        out = []
        for oz, oy, ox in self.origins(tuple(first.shape[-3:])):
            tile = dict(data)
            for k in self.key_iterator(data):
                tile[k] = data[k][..., oz : oz + rz, oy : oy + ry, ox : ox + rx]
            out.append(tile)
        return out
