"""Host-side (numpy) per-sample transforms of the input pipeline
(counterpart of ``viscy_tpu/data/host_transforms.py``: ``HostTransform``
and ``HostRandWeightedCropd``).

They run in loader threads before the host-to-device copy, to cut its
volume. Randomness comes from the ``numpy.random.Generator`` the dataset
hands them, with the same calls as the JAX package, so a (seed, epoch,
index) gives the same crops in both.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from viscy_tpu_torch.transforms.base import MapTransform

__all__ = ["HostRandWeightedCropd", "HostTransform"]


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
