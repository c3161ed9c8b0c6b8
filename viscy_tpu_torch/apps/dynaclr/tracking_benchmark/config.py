"""Configuration of the CTC tracking-accuracy benchmark (counterpart of
``viscy_tpu/apps/dynaclr/tracking_benchmark/config.py``).

JAX validates these with pydantic, which the card's machine may lack; here
they are :class:`~viscy_tpu_torch.apps.airtable_utils.schemas.Model`\\ s,
validated as QC's zattrs models are, with JAX's defaults. A bad or missing
field raises ``ValueError`` naming the model and the field. A model entry's
``path`` is a ``.pt`` state dict or a ``viscy-torch fit`` checkpoint loaded
into ``model_class(**model_init_args)``, or a ``"module:attr"`` factory
(an Orbax checkpoint of the JAX package raises by name).
"""

from __future__ import annotations

from typing import Any

from viscy_tpu_torch.apps.airtable_utils.schemas import (
    REQUIRED,
    Model,
    any_dict,
    as_float,
    as_int,
    as_str,
    list_of,
    model,
    non_empty,
    optional,
)

__all__ = ["EmbeddingModelEntry", "CTCDatasetEntry", "TrackingAccuracyConfig"]


def int_pair(value: Any) -> tuple[int, int]:
    if not isinstance(value, (list, tuple)) or len(value) != 2:
        raise ValueError(f"Input should be a pair of integers, got {value!r}")
    return as_int(value[0]), as_int(value[1])


class EmbeddingModelEntry(Model):
    """One model to benchmark; ``path: null`` is the IoU + distance
    baseline."""

    fields = (
        ("path", optional(as_str), REQUIRED),
        ("label", as_str, REQUIRED),
        ("pixel_size_um", optional(as_float), None),
        ("model_class", optional(as_str), None),
        ("model_init_args", any_dict, dict),
    )


class CTCDatasetEntry(Model):
    """One CTC dataset root with ``{seq}_ERR_SEG``, ``{seq}`` and
    ``{seq}_GT/TRA``."""

    fields = (
        ("path", as_str, REQUIRED),
        ("sequences", list_of(as_str), lambda: ["01", "02"]),
        ("pixel_size_um", optional(as_float), None),
    )


class TrackingAccuracyConfig(Model):
    """The whole evaluation (defaults as JAX's and the reference's)."""

    fields = (
        ("models", non_empty(list_of(model(EmbeddingModelEntry))), REQUIRED),
        ("datasets", non_empty(list_of(model(CTCDatasetEntry))), REQUIRED),
        ("ctc_metadata_path", optional(as_str), None),
        ("model_input_shape", int_pair, (160, 160)),
        ("distance_threshold", as_float, 325.0),
        ("n_neighbors", as_int, 10),
        ("delta_t", as_int, 5),
        ("division_weight", as_float, 0.5),
        ("appearance_weight", as_float, 0.0),
        ("disappearance_weight", as_float, 0.0),
        ("node_weight", as_float, -10.0),
        ("output_dir", as_str, REQUIRED),
        ("ctc_metrics", optional(list_of(as_str)), None),
        ("batch_size", as_int, 128),
        ("solver_time_limit", optional(as_float), None),
    )
