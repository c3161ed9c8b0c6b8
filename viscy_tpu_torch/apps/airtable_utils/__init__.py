"""Experiment-metadata schemas (counterpart of ``viscy_tpu/apps/airtable_utils``):
only the position-name parser and the zattrs models QC writes."""

from viscy_tpu_torch.apps.airtable_utils.schemas import (
    BiologicalAnnotation,
    ChannelAnnotationEntry,
    Perturbation,
    WellExperimentMetadata,
    parse_position_name,
)

__all__ = [
    "BiologicalAnnotation",
    "ChannelAnnotationEntry",
    "Perturbation",
    "WellExperimentMetadata",
    "parse_position_name",
]
