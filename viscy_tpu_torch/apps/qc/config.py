"""QC run configuration (counterpart of ``viscy_tpu/apps/qc/config.py``),
validated by :class:`~viscy_tpu_torch.apps.airtable_utils.schemas.Model`
as the JAX package's pydantic models validate it."""

from __future__ import annotations

from pathlib import Path

from viscy_tpu_torch.apps.airtable_utils.schemas import (
    REQUIRED,
    ChannelAnnotationEntry,
    Model,
    WellExperimentMetadata,
    as_float,
    as_int,
    as_str,
    dict_of,
    list_of,
    literal,
    model,
    optional,
)


class AnnotationConfig(Model):
    """Channel annotations keyed by channel name (the plate's omero labels)
    and experiment metadata keyed by well path (``"A/1"``)."""

    fields = (
        ("channels_metadata", dict_of(model(ChannelAnnotationEntry)), REQUIRED),
        ("experiment_metadata", dict_of(model(WellExperimentMetadata)), REQUIRED),
    )


def _fractions(value) -> tuple[float, float]:
    if not isinstance(value, (list, tuple)) or len(value) != 2:
        raise ValueError(f"Input should be a pair of numbers, got {value!r}")
    return tuple(as_float(v) for v in value)


def _path(value) -> Path:
    if not isinstance(value, (str, Path)):
        raise ValueError(f"Input is not a valid path, got {value!r}")
    return Path(value)


def _workers(value) -> int:
    n = as_int(value)
    if n < 1:
        raise ValueError(f"Input should be greater than or equal to 1, got {n}")
    return n


class FocusMetricConfig(Model):
    """The focus-slice metric's settings. ``device`` (the reference configs
    carry a torch device) is accepted and not used: the QC command takes its
    device from its own ``--device`` option."""

    fields = (
        ("kind", literal("focus_slice"), "focus_slice"),
        ("NA_det", as_float, REQUIRED),
        ("lambda_ill", as_float, REQUIRED),
        ("pixel_size", as_float, REQUIRED),
        ("channel_names", list_of(as_str), REQUIRED),
        ("midband_fractions", _fractions, (0.125, 0.25)),
        ("device", optional(as_str), None),
    )


class QCConfig(Model):
    """A QC run: a ``metrics:`` list, or one top-level section per metric
    kind (``focus_slice: {...}``, the reference layout), appended to it;
    ``annotation`` optional; at least one metric or the annotation."""

    fields = (
        ("data_path", _path, REQUIRED),
        ("num_workers", _workers, 4),
        ("metrics", list_of(model(FocusMetricConfig)), list),
        ("focus_slice", optional(model(FocusMetricConfig)), None),
        ("annotation", optional(model(AnnotationConfig)), None),
    )

    def __init__(self, **data) -> None:
        super().__init__(**data)
        if self.focus_slice is not None:
            self._values["metrics"] = list(self.metrics) + [self.focus_slice]
        if not self.metrics and self.annotation is None:
            raise ValueError("QCConfig needs at least one metric or annotation section")

    def build_metrics(self, device: str = "cuda") -> list:
        """One :class:`~viscy_tpu_torch.apps.qc.focus.FocusSliceMetric` a
        metric section, computing on ``device``."""
        from viscy_tpu_torch.apps.qc.focus import FocusSliceMetric

        return [
            FocusSliceMetric(NA_det=m.NA_det, lambda_ill=m.lambda_ill, pixel_size=m.pixel_size,
                             channel_names=m.channel_names, midband_fractions=m.midband_fractions, device=device)
            for m in self.metrics
        ]
