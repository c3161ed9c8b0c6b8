"""The zattrs models QC writes (counterpart of the models at
``viscy_tpu/apps/airtable_utils/schemas.py:75-106`` and its
``parse_position_name``).

The JAX package validates them with pydantic, which the card's machine may
not have; here a small :class:`Model` base does what pydantic's lax mode
does for these fields: a required field must be given; a ``str`` field
takes only a string; a ``float`` field takes a number, a bool or a numeric
string, stored as ``float`` (a ``3`` in a YAML file is dumped as
``3.0``); a ``Literal`` field takes one of its values; a nested model
takes a dict. Unknown keys are dropped, except on :class:`Perturbation`,
which keeps them after its fields. ``model_dump()`` returns every field,
``None`` ones included, nested models as dicts. A failed check raises
``ValueError`` naming the model and the field.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = [
    "Model",
    "parse_position_name",
    "BiologicalAnnotation",
    "ChannelAnnotationEntry",
    "Perturbation",
    "WellExperimentMetadata",
]

REQUIRED = object()


def parse_position_name(name: str) -> tuple[str, str]:
    """Split an OME-Zarr position name ``"B/1/000000"`` into
    ``("B/1", "000000")``."""
    parts = name.split("/")
    return "/".join(parts[:2]), parts[2] if len(parts) > 2 else ""


def as_str(value: Any) -> str:
    if not isinstance(value, str):
        raise ValueError(f"Input should be a valid string, got {value!r}")
    return value


def as_float(value: Any) -> float:
    if isinstance(value, (bool, int, float)):
        return float(value)
    if isinstance(value, (str, bytes)):
        try:
            return float(value)
        except ValueError:
            pass
    raise ValueError(f"Input should be a valid number, got {value!r}")


def as_int(value: Any) -> int:
    if isinstance(value, bool) or isinstance(value, int):
        return int(value)
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
    raise ValueError(f"Input should be a valid integer, got {value!r}")


def as_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    raise ValueError(f"Input should be a valid boolean, got {value!r}")


def any_dict(value: Any) -> dict:
    if not isinstance(value, dict):
        raise ValueError(f"Input should be a valid dictionary, got {value!r}")
    return dict(value)


def non_empty(check: Callable) -> Callable:
    def run(value: Any) -> list:
        out = check(value)
        if not out:
            raise ValueError("List should have at least 1 item after validation, not 0")
        return out

    return run


def optional(check: Callable) -> Callable:
    return lambda value: None if value is None else check(value)


def literal(*choices: str) -> Callable:
    def check(value: Any) -> str:
        if value not in choices:
            raise ValueError(f"Input should be one of {choices}, got {value!r}")
        return value

    return check


def list_of(check: Callable) -> Callable:
    def run(value: Any) -> list:
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"Input should be a valid list, got {value!r}")
        return [check(v) for v in value]

    return run


def dict_of(check: Callable) -> Callable:
    def run(value: Any) -> dict:
        if not isinstance(value, dict):
            raise ValueError(f"Input should be a valid dictionary, got {value!r}")
        return {as_str(k): check(v) for k, v in value.items()}

    return run


def model(cls: type) -> Callable:
    def run(value: Any):
        if isinstance(value, cls):
            return value
        if not isinstance(value, dict):
            raise ValueError(f"Input should be a valid dictionary or {cls.__name__}, got {value!r}")
        return cls(**value)

    return run


def _dump(value: Any) -> Any:
    if isinstance(value, Model):
        return value.model_dump()
    if isinstance(value, list):
        return [_dump(v) for v in value]
    if isinstance(value, dict):
        return {k: _dump(v) for k, v in value.items()}
    return value


class Model:
    """A validated record: ``fields`` holds ``(name, check, default)``,
    ``default`` :data:`REQUIRED`, a value, or a zero-argument factory (a
    callable such as ``list``); ``extra_allowed`` keeps unknown keys."""

    fields: tuple[tuple[str, Callable, Any], ...] = ()
    extra_allowed = False

    def __init__(self, **data: Any) -> None:
        self._values: dict[str, Any] = {}
        for name, check, default in self.fields:
            if name in data:
                try:
                    value = check(data.pop(name))
                except ValueError as e:
                    raise ValueError(f"validation error for {type(self).__name__}.{name}: {e}") from None
            elif default is REQUIRED:
                raise ValueError(f"validation error for {type(self).__name__}.{name}: Field required")
            else:
                value = default() if callable(default) else default
            self._values[name] = value
        self._extra = dict(data) if self.extra_allowed else {}

    def __getattr__(self, name: str) -> Any:
        values = self.__dict__.get("_values", {})
        if name in values:
            return values[name]
        extra = self.__dict__.get("_extra", {})
        if name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__} has no field {name!r}")

    def model_dump(self) -> dict:
        """Every field (``None`` ones too), then the kept extra keys."""
        return {k: _dump(v) for k, v in {**self._values, **self._extra}.items()}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(f'{k}={v!r}' for k, v in self.model_dump().items())})"


class BiologicalAnnotation(Model):
    """Biological meaning of a channel (organelle / marker / attachment)."""

    fields = (
        ("organelle", optional(as_str), None),
        ("marker", as_str, REQUIRED),
        ("marker_type", literal("protein_tag", "direct_label", "nuclear_dye", "virtual_stain"), "protein_tag"),
        ("fluorophore", optional(as_str), None),
    )


class ChannelAnnotationEntry(Model):
    """Annotation for a single channel in ``.zattrs["channels_metadata"]``."""

    fields = (
        ("channel_type", literal("fluorescence", "labelfree", "virtual_stain"), REQUIRED),
        ("biological_annotation", optional(model(BiologicalAnnotation)), None),
    )


class Perturbation(Model):
    """A perturbation applied to a well (extra keys kept: moi, ...)."""

    fields = (
        ("name", as_str, REQUIRED),
        ("type", as_str, "unknown"),
        ("hours_post", as_float, REQUIRED),
    )
    extra_allowed = True


class WellExperimentMetadata(Model):
    """Experiment metadata of a well in ``.zattrs["experiment_metadata"]``."""

    fields = (
        ("perturbations", list_of(model(Perturbation)), list),
        ("time_sampling_minutes", as_float, REQUIRED),
    )
