"""Batched device-side augmentations (counterpart of ``viscy_tpu/transforms``),
the members of the VSCyto3D training augmentations and the normalizations
of its datamodule."""

from viscy_tpu_torch.transforms.affine import BatchedRandAffined
from viscy_tpu_torch.transforms.base import Compose, MapTransform, RandTransform, Transform
from viscy_tpu_torch.transforms.crop import (
    BatchedCenterSpatialCropd,
    BatchedDivisibleCropd,
    BatchedRandSpatialCropd,
    batched_crop_at,
    center_crop,
)
from viscy_tpu_torch.transforms.flip import BatchedRandFlipd
from viscy_tpu_torch.transforms.intensity import (
    BatchedRandAdjustContrastd,
    BatchedRandGaussianNoised,
    BatchedRandGaussianSmoothd,
    BatchedRandScaleIntensityd,
)
from viscy_tpu_torch.transforms.normalize import MinMaxSampled, NormalizeSampled

__all__ = [
    "BatchedCenterSpatialCropd",
    "BatchedDivisibleCropd",
    "BatchedRandAdjustContrastd",
    "BatchedRandAffined",
    "BatchedRandFlipd",
    "BatchedRandGaussianNoised",
    "BatchedRandGaussianSmoothd",
    "BatchedRandScaleIntensityd",
    "BatchedRandSpatialCropd",
    "Compose",
    "MapTransform",
    "MinMaxSampled",
    "NormalizeSampled",
    "RandTransform",
    "Transform",
    "batched_crop_at",
    "center_crop",
]
