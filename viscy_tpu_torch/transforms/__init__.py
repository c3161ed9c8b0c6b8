"""Batched device-side augmentations (counterpart of ``viscy_tpu/transforms``),
the members of the flagship VSCyto3D training augmentation."""

from viscy_tpu_torch.transforms.affine import BatchedRandAffined
from viscy_tpu_torch.transforms.base import Compose, MapTransform, RandTransform, Transform
from viscy_tpu_torch.transforms.crop import BatchedCenterSpatialCropd, center_crop
from viscy_tpu_torch.transforms.intensity import (
    BatchedRandAdjustContrastd,
    BatchedRandGaussianNoised,
    BatchedRandGaussianSmoothd,
    BatchedRandScaleIntensityd,
)

__all__ = [
    "BatchedCenterSpatialCropd",
    "BatchedRandAdjustContrastd",
    "BatchedRandAffined",
    "BatchedRandGaussianNoised",
    "BatchedRandGaussianSmoothd",
    "BatchedRandScaleIntensityd",
    "Compose",
    "MapTransform",
    "RandTransform",
    "Transform",
    "center_crop",
]
