"""Transform protocol for batched on-device augmentation (counterpart of
``viscy_tpu/transforms/base.py``).

A batched transform maps a dict of ``(B, C, Z, Y, X)`` tensors to a new
dict; random parameters are drawn once per call and shared across its
``keys``, so paired inputs (source / target) stay aligned, while draws vary
across the batch.

Randomness: JAX threefry and torch Philox cannot give the same numbers, so
a random transform splits into ``draw(data, generator)``, which draws every
random tensor it needs from an explicit ``torch.Generator`` on the data's
device, and ``apply(data, draws)``, a deterministic function of the draws.
``transform(data, generator)`` does both; ``transform(data, draws=d)``
takes the draws as given (the parity tests hand in the JAX draws).
"""

from __future__ import annotations

import copy
from typing import Iterable, Sequence

import torch


def ensure_tuple(keys: str | Iterable[str]) -> tuple[str, ...]:
    if isinstance(keys, str):
        return (keys,)
    return tuple(keys)


class Transform:
    """Base class: deterministic dict transform."""

    is_spatial: bool = False
    is_random: bool = False

    def __call__(self, data: dict) -> dict:
        raise NotImplementedError


class MapTransform(Transform):
    """Dict transform applied to a set of keys."""

    def __init__(self, keys: str | Iterable[str], allow_missing_keys: bool = False) -> None:
        self.keys = ensure_tuple(keys)
        self.allow_missing_keys = allow_missing_keys

    def key_iterator(self, data: dict):
        for k in self.keys:
            if k in data:
                yield k
            elif not self.allow_missing_keys:
                raise KeyError(f"Key {k!r} missing from sample with keys {list(data)}")

    def first_key(self, data: dict) -> str:
        for k in self.key_iterator(data):
            return k
        raise KeyError("no keys present")


class RandTransform(MapTransform):
    """Random dict transform: ``draw`` then ``apply``."""

    is_random = True

    def __init__(
        self, keys: str | Iterable[str], prob: float = 1.0, allow_missing_keys: bool = False
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.prob = float(prob)

    def _apply_mask(self, generator: torch.Generator, batch: int, device) -> torch.Tensor:
        """Per-sample Bernoulli(prob) application mask, shape (B,)."""
        return torch.rand((batch,), generator=generator, device=device) < self.prob

    @staticmethod
    def _where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        """Select transformed samples by per-sample mask."""
        return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

    def draw(self, data: dict, generator: torch.Generator) -> dict:
        raise NotImplementedError

    def apply(self, data: dict, draws: dict) -> dict:
        raise NotImplementedError

    def __call__(
        self, data: dict, generator: torch.Generator | None = None, draws: dict | None = None
    ) -> dict:
        if draws is None:
            if generator is None:
                raise ValueError(f"{type(self).__name__} needs a torch.Generator or its draws")
            draws = self.draw(data, generator)
        return self.apply(dict(data), draws)


def _fuse_affine_crop(transforms: list) -> list:
    """Peephole: ``BatchedRandAffined`` followed by a crop on the same keys
    fuses into one output-space warp, then :func:`_fuse_affine_flip` runs.

    - ``BatchedCenterSpatialCropd``: the sample grid covers only the crop
      region (``BatchedRandAffined.crop_size``), equal to warp-then-crop.
    - ``BatchedRandSpatialCropd`` with ``random_center``: the per-sample
      starts become per-sample grid offsets
      (``BatchedRandAffined._rand_crop_size``); the fused member draws the
      starts too."""
    out: list = []
    i = 0
    while i < len(transforms):
        t = transforms[i]
        nxt = transforms[i + 1] if i + 1 < len(transforms) else None
        fusable_affine = (
            nxt is not None
            and type(t).__name__ == "BatchedRandAffined"
            and getattr(t, "crop_size", None) is None
            and getattr(t, "_rand_crop_size", None) is None
            and set(getattr(t, "keys", ())) == set(getattr(nxt, "keys", ()))
        )
        if fusable_affine and type(nxt).__name__ == "BatchedCenterSpatialCropd":
            fused = copy.copy(t)
            fused.crop_size = tuple(nxt.roi_size)
            out.append(fused)
            i += 2
            continue
        if (
            fusable_affine
            and type(nxt).__name__ == "BatchedRandSpatialCropd"
            and getattr(nxt, "random_center", False)
        ):
            fused = copy.copy(t)
            fused._rand_crop_size = tuple(nxt.roi_size)
            out.append(fused)
            i += 2
            continue
        out.append(t)
        i += 1
    return _fuse_affine_flip(out)


def _fuse_affine_flip(transforms: list) -> list:
    """Peephole: ``BatchedRandAffined`` (plain or crop-fused) followed by an
    in-plane ``BatchedRandFlipd`` (spatial axes within {1, 2}) on the same
    keys folds the flip into the warp's grid: mirroring an output index is
    a sign flip of the centered output coordinate. The fused member draws
    the flips too. Z flips stay a member of their own."""
    out: list = []
    i = 0
    while i < len(transforms):
        t = transforms[i]
        nxt = transforms[i + 1] if i + 1 < len(transforms) else None
        if (
            nxt is not None
            and type(t).__name__ == "BatchedRandAffined"
            and getattr(t, "_flip_axes", "missing") is None
            and type(nxt).__name__ == "BatchedRandFlipd"
            and set(getattr(nxt, "spatial_axes", ())) <= {1, 2}
            and len(getattr(nxt, "spatial_axes", ())) > 0
            and set(getattr(t, "keys", ())) == set(getattr(nxt, "keys", ()))
        ):
            fused = copy.copy(t)
            fused._flip_axes = tuple(nxt.spatial_axes)
            fused._flip_prob = nxt.prob
            out.append(fused)
            i += 2
            continue
        out.append(t)
        i += 1
    return out


def _fuse_smooth_crop(transforms: list) -> list:
    """Peephole: ``BatchedRandGaussianSmoothd`` followed by a
    ``BatchedCenterSpatialCropd`` covering its keys blurs only the crop
    region plus a kernel-radius halo, then trims the halo
    (``BatchedRandGaussianSmoothd._post_crop``): the same tap sums in the
    same order as blur-then-crop. Keys the smooth does not touch keep a
    residual crop member."""
    out: list = []
    i = 0
    while i < len(transforms):
        t = transforms[i]
        nxt = transforms[i + 1] if i + 1 < len(transforms) else None
        if (
            nxt is not None
            and type(t).__name__ == "BatchedRandGaussianSmoothd"
            and getattr(t, "_post_crop", None) is None
            and type(nxt).__name__ == "BatchedCenterSpatialCropd"
            and set(t.keys) <= set(nxt.keys)
        ):
            fused = copy.copy(t)
            fused._post_crop = tuple(nxt.roi_size)
            out.append(fused)
            rest = [k for k in nxt.keys if k not in set(t.keys)]
            if rest:
                residual = copy.copy(nxt)
                residual.keys = tuple(rest)
                out.append(residual)
            i += 2
            continue
        out.append(t)
        i += 1
    return out


class Compose(Transform):
    """Compose transforms (with the affine+crop, affine+flip and smooth+crop
    fusions, which yield the JAX ``Compose``'s member list).

    Random members draw in pipeline order from one generator; ``draws``
    instead gives one draws dict per random member, in pipeline order (a
    fused member's dict holds the draws of every member it took in)."""

    def __init__(self, transforms: Sequence[Transform]) -> None:
        self.transforms = _fuse_smooth_crop(
            _fuse_affine_crop([t for t in transforms if t is not None])
        )

    @property
    def is_spatial(self) -> bool:  # type: ignore[override]
        return any(getattr(t, "is_spatial", False) for t in self.transforms)

    @property
    def random_members(self) -> list[RandTransform]:
        return [t for t in self.transforms if getattr(t, "is_random", False)]

    def __call__(
        self,
        data: dict,
        generator: torch.Generator | None = None,
        draws: Sequence[dict] | None = None,
    ) -> dict:
        n_random = len(self.random_members)
        if draws is not None and len(draws) != n_random:
            raise ValueError(f"{len(draws)} draws given for {n_random} random members")
        if n_random and draws is None and generator is None:
            raise ValueError("Compose with random transforms requires a torch.Generator")
        ki = 0
        for t in self.transforms:
            if getattr(t, "is_random", False):
                data = t(data, generator, None if draws is None else draws[ki])
                ki += 1
            else:
                data = t(data)
        return data

    def __iter__(self):
        return iter(self.transforms)

    def __len__(self) -> int:
        return len(self.transforms)
