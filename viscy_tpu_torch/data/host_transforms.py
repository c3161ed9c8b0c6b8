"""Host-side (numpy / scipy) per-sample transforms of the input pipeline
(counterpart of ``viscy_tpu/data/host_transforms.py``), the classes behind
the MONAI names of ``viscy_tpu_torch.transforms`` (``RandWeightedCropd``,
``RandAffined``, ...).

They run in loader threads before the host-to-device copy, to cut its
volume. Randomness comes from the ``numpy.random.Generator`` the dataset
hands them, with the same calls in the same order as the JAX package, so a
(seed, epoch, index) gives the same samples in both, bit for bit.

Where the JAX package departs from MONAI, so does this module:
``HostRandAffined`` rotates about Z only (the first ``rotate_range``
entry), takes ``scale_range`` as ``1 + U(-s, s)`` per axis and accepts
``shear_range`` without using it; ``HostRandAdjustContrastd`` maps a
scalar ``gamma`` to the range ``(gamma, 2 gamma)``; the percentile rescale
and the z-score cast to float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from viscy_tpu_torch.transforms.base import MapTransform

__all__ = [
    "HostCenterSpatialCropd",
    "HostNormalizeIntensityd",
    "HostRandAdjustContrastd",
    "HostRandAffined",
    "HostRandFlipd",
    "HostRandGaussianNoised",
    "HostRandGaussianSmoothd",
    "HostRandScaleIntensityd",
    "HostRandSpatialCropd",
    "HostRandWeightedCropd",
    "HostScaleIntensityRangePercentilesd",
    "HostTransform",
    "ToDeviced",
]


def _roi3(roi) -> tuple[int, int, int]:
    if isinstance(roi, int):
        return (roi,) * 3
    roi = tuple(int(r) for r in roi)
    return (1, *roi) if len(roi) == 2 else roi


class HostTransform(MapTransform):
    """Marker base for host transforms consuming a numpy Generator."""

    is_random = False

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> dict:
        raise NotImplementedError


class HostCenterSpatialCropd(HostTransform):
    """Center crop of the trailing (Z, Y, X) to ``roi_size`` (at most the
    extent)."""

    is_spatial = True

    def __init__(self, keys, roi_size, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.roi_size = _roi3(roi_size)

    def __call__(self, data: dict, rng=None) -> dict:
        data = dict(data)
        for k in self.key_iterator(data):
            x = data[k]
            slices = [slice(None)] * (x.ndim - 3)
            for size, r in zip(x.shape[-3:], self.roi_size):
                r = min(r, size)
                start = (size - r) // 2
                slices.append(slice(start, start + r))
            data[k] = x[tuple(slices)]
        return data


class HostRandSpatialCropd(HostTransform):
    """Random crop to ``roi_size``, one start per axis from
    ``rng.integers(0, s - r + 1)``, shared across keys."""

    is_spatial = True
    is_random = True

    def __init__(self, keys, roi_size, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.roi_size = _roi3(roi_size)

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> dict:
        rng = rng or np.random.default_rng()
        data = dict(data)
        spatial = data[self.first_key(data)].shape[-3:]
        roi = tuple(min(r, s) for r, s in zip(self.roi_size, spatial))
        starts = [rng.integers(0, s - r + 1) for s, r in zip(spatial, roi)]
        sl = tuple(slice(st, st + r) for st, r in zip(starts, roi))
        for k in self.key_iterator(data):
            data[k] = data[k][..., sl[0], sl[1], sl[2]]
        return data


class HostRandFlipd(HostTransform):
    """Flip along each of ``spatial_axes`` (0 = Z) with probability
    ``prob``, one ``rng.random()`` per axis, shared across keys."""

    is_spatial = True
    is_random = True

    def __init__(self, keys, spatial_axes=(0, 1, 2), prob=0.5, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.spatial_axes = tuple(spatial_axes)
        self.prob = prob

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> dict:
        rng = rng or np.random.default_rng()
        data = dict(data)
        flips = [ax for ax in self.spatial_axes if rng.random() < self.prob]
        if not flips:
            return data
        for k in self.key_iterator(data):
            x = data[k]
            data[k] = np.flip(x, axis=tuple(x.ndim - 3 + ax for ax in flips)).copy()
        return data


class HostRandWeightedCropd(HostTransform):
    """Weighted multi-crop (MONAI ``RandWeightedCropd``): ``num_samples``
    crops per stack, each YX origin drawn with probability proportional to
    the window sum of the ``w_key`` channel (over channels and Z); returns
    a *list* of sample dicts, flattened by ``collate_samples``."""

    is_spatial = True
    is_random = True

    def __init__(
        self,
        keys,
        w_key: str,
        spatial_size: Sequence[int],
        num_samples: int = 1,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.w_key = w_key
        self.spatial_size = _roi3(spatial_size)
        self.num_samples = num_samples

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> list[dict]:
        rng = rng or np.random.default_rng()
        w = np.asarray(data[self.w_key], np.float32)
        spatial = w.shape[-3:]
        cz, cy, cx = tuple(min(c, s) for c, s in zip(self.spatial_size, spatial))
        z, y, x = spatial
        wm = np.clip(w.reshape(-1, y, x).sum(axis=0), 0, None)
        # integral image: O(1) window sums over the valid origins
        integral = np.pad(wm, ((1, 0), (1, 0))).cumsum(0).cumsum(1)
        vy, vx = y - cy + 1, x - cx + 1
        window = (
            integral[cy:, cx:][:vy, :vx]
            - integral[:-cy, cx:][:vy, :vx]
            - integral[cy:, :-cx][:vy, :vx]
            + integral[:-cy, :-cx][:vy, :vx]
        )
        flat = window.reshape(-1)
        total = flat.sum()
        p = np.full_like(flat, 1.0 / flat.size) if total <= 0 else flat / total
        out = []
        for _ in range(self.num_samples):
            idx = rng.choice(flat.size, p=p)
            ys, xs = divmod(int(idx), vx)
            zs = 0 if cz >= z else int(rng.integers(0, z - cz + 1))
            crop = dict(data)
            for k in self.key_iterator(data):
                crop[k] = np.ascontiguousarray(data[k][..., zs : zs + cz, ys : ys + cy, xs : xs + cx])
            out.append(crop)
        return out


class HostScaleIntensityRangePercentilesd(HostTransform):
    """Rescale the percentile window ``[lower, upper]`` of each key (of each
    channel with ``channel_wise``) to ``[b_min, b_max]``, in float32."""

    is_spatial = False

    def __init__(
        self,
        keys,
        lower: float,
        upper: float,
        b_min: float,
        b_max: float,
        clip: bool = False,
        allow_missing_keys: bool = False,
        channel_wise: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.lower = lower
        self.upper = upper
        self.b_min = b_min
        self.b_max = b_max
        self.clip = clip
        self.channel_wise = channel_wise

    def __call__(self, data: dict, rng=None) -> dict:
        data = dict(data)
        for k in self.key_iterator(data):
            x = np.asarray(data[k], np.float32)
            if self.channel_wise and x.ndim >= 4:
                axes = tuple(range(1, x.ndim))
                lo = np.percentile(x, self.lower, axis=axes, keepdims=True)
                hi = np.percentile(x, self.upper, axis=axes, keepdims=True)
            else:
                lo = np.percentile(x, self.lower)
                hi = np.percentile(x, self.upper)
            y = (x - lo) / np.maximum(hi - lo, 1e-8)
            y = y * (self.b_max - self.b_min) + self.b_min
            if self.clip:
                y = np.clip(y, self.b_min, self.b_max)
            data[k] = y.astype(np.float32)
        return data


class HostNormalizeIntensityd(HostTransform):
    """Per-sample z-score ``(x - mean) / (std + 1e-8)`` of each key."""

    is_spatial = False

    def __init__(self, keys, allow_missing_keys: bool = False) -> None:
        super().__init__(keys, allow_missing_keys)

    def __call__(self, data: dict, rng=None) -> dict:
        data = dict(data)
        for k in self.key_iterator(data):
            x = np.asarray(data[k], np.float32)
            data[k] = (x - x.mean()) / (x.std() + 1e-8)
        return data


class HostRandAdjustContrastd(HostTransform):
    """With probability ``prob``, gamma ``U(gamma)`` on each key's own
    [min, max]: ``((x - lo) / span) ** gamma * span + lo``."""

    is_spatial = False
    is_random = True

    def __init__(self, keys, prob=0.1, gamma=(0.5, 4.5), allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.gamma = (gamma, gamma * 2) if isinstance(gamma, (int, float)) else tuple(gamma)

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> dict:
        rng = rng or np.random.default_rng()
        if rng.random() >= self.prob:
            return data
        data = dict(data)
        gamma = rng.uniform(*self.gamma)
        for k in self.key_iterator(data):
            x = np.asarray(data[k], np.float32)
            lo, hi = x.min(), x.max()
            span = max(hi - lo, 1e-8)
            data[k] = ((x - lo) / span) ** gamma * span + lo
        return data


class HostRandScaleIntensityd(HostTransform):
    """With probability ``prob``, ``x * (1 + U(factors))``."""

    is_spatial = False
    is_random = True

    def __init__(self, keys, factors=0.5, prob=0.1, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.factors = (-abs(factors), abs(factors)) if isinstance(factors, (int, float)) else tuple(factors)
        self.prob = prob

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> dict:
        rng = rng or np.random.default_rng()
        if rng.random() >= self.prob:
            return data
        data = dict(data)
        factor = 1.0 + rng.uniform(*self.factors)
        for k in self.key_iterator(data):
            data[k] = np.asarray(data[k], np.float32) * factor
        return data


class HostRandGaussianNoised(HostTransform):
    """With probability ``prob``, additive Gaussian noise of mean ``mean``;
    the std is drawn from U(0, std) when ``sample_std``."""

    is_spatial = False
    is_random = True

    def __init__(self, keys, prob=0.1, mean=0.0, std=0.1, sample_std=True, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.mean = mean
        self.std = std
        self.sample_std = sample_std

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> dict:
        rng = rng or np.random.default_rng()
        if rng.random() >= self.prob:
            return data
        data = dict(data)
        std = rng.uniform(0.0, self.std) if self.sample_std else self.std
        for k in self.key_iterator(data):
            x = np.asarray(data[k], np.float32)
            data[k] = x + rng.normal(self.mean, std, x.shape).astype(np.float32)
        return data


class HostRandGaussianSmoothd(HostTransform):
    """With probability ``prob``, a Gaussian blur (scipy) with per-axis
    sigmas drawn from the (Z, Y, X) ranges (an axis whose range ends at 0
    is not blurred and draws nothing)."""

    is_spatial = False
    is_random = True

    def __init__(
        self,
        keys,
        prob=0.1,
        sigma_x=(0.25, 1.5),
        sigma_y=(0.25, 1.5),
        sigma_z=(0.0, 0.0),
        allow_missing_keys=False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.sigmas = (sigma_z, sigma_y, sigma_x)

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> dict:
        from scipy.ndimage import gaussian_filter

        rng = rng or np.random.default_rng()
        if rng.random() >= self.prob:
            return data
        data = dict(data)
        sig = [rng.uniform(*s) if s[1] > 0 else 0.0 for s in self.sigmas]
        for k in self.key_iterator(data):
            x = np.asarray(data[k], np.float32)
            data[k] = gaussian_filter(x, sigma=[0.0] * (x.ndim - 3) + sig).astype(np.float32)
        return data


class HostRandAffined(HostTransform):
    """With probability ``prob``, a rotation about Z (angle from the first
    ``rotate_range`` entry) and per-axis scales ``1 + U(-s, s)`` about the
    volume center, one draw shared across keys, sampled by scipy's
    ``affine_transform`` (order 1, constant 0 outside). ``shear_range`` is
    accepted and not used, as in the JAX package."""

    is_spatial = True
    is_random = True

    def __init__(
        self,
        keys,
        prob=0.1,
        rotate_range=(0.0, 0.0, 0.0),
        scale_range=(0.0, 0.0, 0.0),
        shear_range=(0.0, 0.0, 0.0),
        allow_missing_keys=False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.rotate_range = tuple(rotate_range)
        self.scale_range = tuple(scale_range)
        self.shear_range = tuple(shear_range)

    @staticmethod
    def _range(rng, r):
        if isinstance(r, (tuple, list)):
            lo, hi = r if len(r) == 2 else (-r[0], r[0])
        else:
            lo, hi = -r, r
        return rng.uniform(lo, hi)

    def __call__(self, data: dict, rng: np.random.Generator | None = None) -> dict:
        from scipy.ndimage import affine_transform

        rng = rng or np.random.default_rng()
        if rng.random() >= self.prob:
            return data
        data = dict(data)
        angle = self._range(rng, self.rotate_range[0]) if self.rotate_range else 0.0
        if self.scale_range:
            scales = np.array([1.0 + self._range(rng, s) for s in self.scale_range], np.float64)
        else:
            scales = np.ones(3)
        cos, sin = np.cos(angle), np.sin(angle)
        rot = np.array([[1, 0, 0], [0, cos, -sin], [0, sin, cos]], np.float64)
        mat = rot @ np.diag(1.0 / scales)
        for k in self.key_iterator(data):
            x = np.asarray(data[k], np.float32)
            center = (np.asarray(x.shape[-3:]) - 1) / 2.0
            offset = center - mat @ center
            flat = x.reshape(-1, *x.shape[-3:])
            out = np.stack([affine_transform(f, mat, offset=offset, order=1) for f in flat])
            data[k] = out.reshape(x.shape).astype(np.float32)
        return data


class ToDeviced(HostTransform):
    """A no-op under the MONAI name: the trainer moves each batch to its
    device."""

    is_spatial = False

    def __init__(self, keys=None, device=None, allow_missing_keys=False) -> None:
        super().__init__(keys or [], True)

    def __call__(self, data: dict, rng=None) -> dict:
        return data
