"""Normalization with precomputed statistics (counterpart of
``viscy_tpu/transforms/normalize.py``): ``NormalizeSampled`` and
``MinMaxSampled``.

Statistics come from ``sample["norm_meta"][key][level][stat]``, as the
preprocess pipeline writes them into OME-Zarr ``.zattrs["normalization"]``.
Inputs may be numpy arrays (per sample, on the host) or torch tensors
(batched, on the device); a statistic is a scalar or a ``(B,)`` vector.
"""

from __future__ import annotations

from typing import Iterable, Literal

import numpy as np
import torch

from viscy_tpu_torch.transforms.base import MapTransform

__all__ = ["MinMaxSampled", "NormalizeSampled"]

_DATA_RANGE_KEYS = {
    "min_max": ("min", "max"),
    "p1_p99": ("p1", "p99"),
    "p5_p95": ("p5", "p95"),
}


def _match_image(stat, target):
    """A scalar or (B,) stat in ``target``'s array type, float dtype and
    device, reshaped to broadcast against it."""
    if isinstance(target, np.ndarray):
        dtype = target.dtype if target.dtype.kind == "f" else np.float32
        stat = np.asarray(stat, dtype=dtype)
    else:
        dtype = target.dtype if target.dtype.is_floating_point else torch.float32
        stat = torch.as_tensor(stat, dtype=dtype, device=target.device)
    if stat.ndim == 0:
        return stat
    return stat.reshape(stat.shape + (1,) * (target.ndim - stat.ndim))


def _clip(x, lo, hi):
    if isinstance(x, np.ndarray):
        return np.clip(x, lo, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


class NormalizeSampled(MapTransform):
    """(x - subtrahend) / (divisor + 1e-8) with stats from ``norm_meta``."""

    def __init__(
        self,
        keys: str | Iterable[str],
        level: Literal["fov_statistics", "dataset_statistics", "timepoint_statistics"],
        subtrahend: str = "mean",
        divisor: str = "std",
        remove_meta: bool = False,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.level = level
        self.subtrahend = subtrahend
        self.divisor = divisor
        self.remove_meta = remove_meta

    def __call__(self, sample: dict) -> dict:
        sample = dict(sample)
        for k in self.key_iterator(sample):
            level_meta = sample["norm_meta"][k][self.level]
            sub = _match_image(level_meta[self.subtrahend], sample[k])
            div = _match_image(level_meta[self.divisor], sample[k]) + 1e-8
            sample[k] = (sample[k] - sub) / div
        if self.remove_meta:
            sample.pop("norm_meta", None)
        return sample


class MinMaxSampled(MapTransform):
    """Clip to a stat range, then rescale to [-1, 1]."""

    def __init__(
        self,
        keys: str | Iterable[str],
        level: Literal["fov_statistics", "dataset_statistics", "timepoint_statistics"],
        data_range: Literal["min_max", "p1_p99", "p5_p95"] = "p1_p99",
        remove_meta: bool = False,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.level = level
        if data_range not in _DATA_RANGE_KEYS:
            raise ValueError(f"Invalid data_range: {data_range}")
        self._low_key, self._high_key = _DATA_RANGE_KEYS[data_range]
        self.remove_meta = remove_meta

    def __call__(self, sample: dict) -> dict:
        sample = dict(sample)
        for k in self.key_iterator(sample):
            level_meta = sample["norm_meta"][k][self.level]
            lo = _match_image(level_meta[self._low_key], sample[k])
            hi = _match_image(level_meta[self._high_key], sample[k])
            x = _clip(sample[k], lo, hi)
            sample[k] = 2.0 * (x - lo) / (hi - lo + 1e-8) - 1.0
        if self.remove_meta:
            sample.pop("norm_meta", None)
        return sample
