"""OME-Zarr HCS storage in numpy (counterpart of ``viscy_tpu/zarr_io``):
plain JSON metadata and chunk files decoded with the standard library."""

from viscy_tpu_torch.zarr_io.store import (
    ImageArray,
    Plate,
    Position,
    TransformationMeta,
    UnsupportedCodecError,
    open_ome_zarr,
)
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

__all__ = [
    "ImageArray",
    "Plate",
    "Position",
    "TransformationMeta",
    "UnsupportedCodecError",
    "build_hcs_plate",
    "open_ome_zarr",
]
