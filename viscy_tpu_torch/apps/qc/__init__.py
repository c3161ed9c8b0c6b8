"""QC: quality-control metrics on HCS OME-Zarr (counterpart of
``viscy_tpu/apps/qc``)."""

from viscy_tpu_torch.apps.qc.annotation import write_annotation_metadata
from viscy_tpu_torch.apps.qc.config import AnnotationConfig, QCConfig
from viscy_tpu_torch.apps.qc.focus import FocusSliceMetric, focus_from_transverse_band
from viscy_tpu_torch.apps.qc.qc_metrics import QCMetric, generate_qc_metadata

__all__ = [
    "AnnotationConfig",
    "FocusSliceMetric",
    "QCConfig",
    "QCMetric",
    "focus_from_transverse_band",
    "generate_qc_metadata",
    "write_annotation_metadata",
]
