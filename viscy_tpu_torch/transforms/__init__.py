"""Batched device-side augmentations (counterpart of ``viscy_tpu/transforms``),
their array variants, the normalizations of the datamodule, and the
per-sample host transforms under their MONAI names.

The MONAI names (``RandAffined``, ``RandWeightedCropd``, ...) resolve
lazily to the host transforms of :mod:`viscy_tpu_torch.data.host_transforms`
through the module ``__getattr__``: that module imports
``viscy_tpu_torch.transforms.base``, so a direct import here would be
circular.
"""

from viscy_tpu_torch.transforms.affine import BatchedRand3DElasticd, BatchedRandAffined
from viscy_tpu_torch.transforms.array import (
    BatchedCenterSpatialCrop,
    BatchedRandAdjustContrast,
    BatchedRandFlip,
    BatchedRandGaussianNoise,
    BatchedRandGaussianSmooth,
    BatchedRandScaleIntensity,
    BatchedRandSpatialCrop,
    BatchedScaleIntensityRangePercentiles,
    Decollate,
    RandGaussianNoiseTensor,
)
from viscy_tpu_torch.transforms.base import Compose, MapTransform, RandTransform, Transform
from viscy_tpu_torch.transforms.crop import (
    BatchedCenterSpatialCropd,
    BatchedDivisibleCropd,
    BatchedRandSpatialCropd,
    BatchedRandWeightedCropd,
    TiledSpatialCropSamplesd,
    batched_crop_at,
    center_crop,
)
from viscy_tpu_torch.transforms.flip import BatchedRandFlipd
from viscy_tpu_torch.transforms.intensity import (
    BatchedRandAdjustContrastd,
    BatchedRandGaussianNoised,
    BatchedRandGaussianSmoothd,
    BatchedRandHistogramShiftd,
    BatchedRandInvertIntensityd,
    BatchedRandLocalPixelShufflingd,
    BatchedRandScaleIntensityd,
    BatchedRandSharpend,
    BatchedRandZStackShiftd,
    BatchedScaleIntensityRangePercentilesd,
    RandGaussianNoiseTensord,
    RandInvertIntensityd,
)
from viscy_tpu_torch.transforms.normalize import MinMaxSampled, NormalizeSampled
from viscy_tpu_torch.transforms.z_ops import (
    BatchedChannelWiseZReduction,
    BatchedChannelWiseZReductiond,
    BatchedStackChannelsd,
    Decollated,
    StackChannelsd,
)
from viscy_tpu_torch.transforms.zoom import BatchedZoom, BatchedZoomd

# MONAI name -> host transform of viscy_tpu_torch.data.host_transforms
_HOST_ALIASES = {
    "CenterSpatialCropd": "HostCenterSpatialCropd",
    "NormalizeIntensityd": "HostNormalizeIntensityd",
    "RandFlipd": "HostRandFlipd",
    "RandSpatialCropd": "HostRandSpatialCropd",
    "RandWeightedCropd": "HostRandWeightedCropd",
    "ScaleIntensityRangePercentilesd": "HostScaleIntensityRangePercentilesd",
    "RandAffined": "HostRandAffined",
    "RandAdjustContrastd": "HostRandAdjustContrastd",
    "RandScaleIntensityd": "HostRandScaleIntensityd",
    "RandGaussianNoised": "HostRandGaussianNoised",
    "RandGaussianSmoothd": "HostRandGaussianSmoothd",
    "ToDeviced": "ToDeviced",
}


def __getattr__(name: str):
    target = _HOST_ALIASES.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from viscy_tpu_torch.data import host_transforms

    return getattr(host_transforms, target)


__all__ = [
    "BatchedCenterSpatialCrop",
    "BatchedCenterSpatialCropd",
    "BatchedChannelWiseZReduction",
    "BatchedChannelWiseZReductiond",
    "BatchedDivisibleCropd",
    "BatchedRand3DElasticd",
    "BatchedRandAdjustContrast",
    "BatchedRandAdjustContrastd",
    "BatchedRandAffined",
    "BatchedRandFlip",
    "BatchedRandFlipd",
    "BatchedRandGaussianNoise",
    "BatchedRandGaussianNoised",
    "BatchedRandGaussianSmooth",
    "BatchedRandGaussianSmoothd",
    "BatchedRandHistogramShiftd",
    "BatchedRandInvertIntensityd",
    "BatchedRandLocalPixelShufflingd",
    "BatchedRandScaleIntensity",
    "BatchedRandScaleIntensityd",
    "BatchedRandSharpend",
    "BatchedRandSpatialCrop",
    "BatchedRandSpatialCropd",
    "BatchedRandWeightedCropd",
    "BatchedRandZStackShiftd",
    "BatchedScaleIntensityRangePercentiles",
    "BatchedScaleIntensityRangePercentilesd",
    "BatchedStackChannelsd",
    "BatchedZoom",
    "BatchedZoomd",
    "Compose",
    "Decollate",
    "Decollated",
    "MapTransform",
    "MinMaxSampled",
    "NormalizeSampled",
    "RandGaussianNoiseTensor",
    "RandGaussianNoiseTensord",
    "RandInvertIntensityd",
    "RandTransform",
    "StackChannelsd",
    "TiledSpatialCropSamplesd",
    "Transform",
    "batched_crop_at",
    "center_crop",
    *_HOST_ALIASES,
]
