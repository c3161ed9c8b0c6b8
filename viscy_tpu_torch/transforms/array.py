"""Array (non-dict) transform variants (counterpart of
``viscy_tpu/transforms/array.py``): each is a thin adapter over its ``*d``
transform, with the same arguments minus ``keys``; ``__call__`` takes the
bare (B, C, Z, Y, X) tensor, and a random member a ``torch.Generator`` or
its draws, so the two variants cannot drift."""

from __future__ import annotations

import torch

from viscy_tpu_torch.transforms.crop import BatchedCenterSpatialCropd, BatchedRandSpatialCropd
from viscy_tpu_torch.transforms.flip import BatchedRandFlipd
from viscy_tpu_torch.transforms.intensity import (
    BatchedRandAdjustContrastd,
    BatchedRandGaussianNoised,
    BatchedRandGaussianSmoothd,
    BatchedRandScaleIntensityd,
    BatchedScaleIntensityRangePercentilesd,
    RandGaussianNoiseTensord,
)

__all__ = [
    "BatchedCenterSpatialCrop",
    "BatchedRandAdjustContrast",
    "BatchedRandFlip",
    "BatchedRandGaussianNoise",
    "BatchedRandGaussianSmooth",
    "BatchedRandScaleIntensity",
    "BatchedRandSpatialCrop",
    "BatchedScaleIntensityRangePercentiles",
    "Decollate",
    "RandGaussianNoiseTensor",
]

_KEY = "img"


def _array_variant(dict_cls: type, name: str) -> type:
    """The array adapter class of a dict transform."""

    class _ArrayTransform:
        is_random = getattr(dict_cls, "is_random", False)
        is_spatial = getattr(dict_cls, "is_spatial", False)

        def __init__(self, *args, **kwargs) -> None:
            kwargs.pop("allow_missing_keys", None)
            self._inner = dict_cls(_KEY, *args, **kwargs)

        def __call__(self, img: torch.Tensor, generator=None, draws: dict | None = None) -> torch.Tensor:
            if self.is_random:
                return self._inner({_KEY: img}, generator, draws)[_KEY]
            return self._inner({_KEY: img})[_KEY]

    _ArrayTransform.__name__ = _ArrayTransform.__qualname__ = name
    _ArrayTransform.__doc__ = (
        f"Array variant of :class:`{dict_cls.__name__}`: the same arguments minus ``keys``; call with "
        "the bare batched tensor."
    )
    return _ArrayTransform


BatchedCenterSpatialCrop = _array_variant(BatchedCenterSpatialCropd, "BatchedCenterSpatialCrop")
BatchedRandAdjustContrast = _array_variant(BatchedRandAdjustContrastd, "BatchedRandAdjustContrast")
BatchedRandFlip = _array_variant(BatchedRandFlipd, "BatchedRandFlip")
BatchedRandGaussianNoise = _array_variant(BatchedRandGaussianNoised, "BatchedRandGaussianNoise")
BatchedRandGaussianSmooth = _array_variant(BatchedRandGaussianSmoothd, "BatchedRandGaussianSmooth")
BatchedRandScaleIntensity = _array_variant(BatchedRandScaleIntensityd, "BatchedRandScaleIntensity")
BatchedRandSpatialCrop = _array_variant(BatchedRandSpatialCropd, "BatchedRandSpatialCrop")
BatchedScaleIntensityRangePercentiles = _array_variant(
    BatchedScaleIntensityRangePercentilesd, "BatchedScaleIntensityRangePercentiles"
)
RandGaussianNoiseTensor = _array_variant(RandGaussianNoiseTensord, "RandGaussianNoiseTensor")


class Decollate:
    """Split a batched tensor into a list of per-sample tensors (array
    variant of :class:`~viscy_tpu_torch.transforms.z_ops.Decollated`)."""

    is_random = False
    is_spatial = False

    def __call__(self, img: torch.Tensor) -> list[torch.Tensor]:
        return [img[i] for i in range(img.shape[0])]
