"""Experiment-metadata schemas (counterpart of ``viscy_tpu/apps/airtable_utils``):
the position-name and channel-label parsers, the zattrs models QC writes
and the Airtable Datasets record. The registry, the REST client and the
``prepare`` pipeline are not ported (``ROADMAP.md`` Queue 1 item 11)."""

from viscy_tpu_torch.apps.airtable_utils.schemas import (
    BiologicalAnnotation,
    ChannelAnnotationEntry,
    DatasetRecord,
    Perturbation,
    WellExperimentMetadata,
    parse_channel_fields,
    parse_position_name,
)

__all__ = [
    "BiologicalAnnotation",
    "ChannelAnnotationEntry",
    "DatasetRecord",
    "Perturbation",
    "WellExperimentMetadata",
    "parse_channel_fields",
    "parse_position_name",
]
