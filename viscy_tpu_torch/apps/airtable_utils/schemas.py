"""Airtable Datasets records and the zattrs models QC writes (counterpart of
``viscy_tpu/apps/airtable_utils/schemas.py``): ``MAX_CHANNELS``,
``parse_position_name``, ``parse_channel_fields``, the zattrs models and
:class:`DatasetRecord` with its conversions (``to_fov_record`` builds
:class:`viscy_tpu_torch.data.schemas.FOVRecord`).

The JAX package validates them with pydantic, which the card's machine may
not have; here a small :class:`Model` base does what pydantic's lax mode
does for these fields: a required field must be given; a ``str`` field
takes only a string; a ``float`` field takes a number, a bool or a numeric
string, stored as ``float`` (a ``3`` in a YAML file is dumped as
``3.0``); an ``int`` field takes an int, a bool, a float or a numeric
string of integral value; a list field takes a list, tuple or set; a
``Literal`` field takes one of its values; a nested model takes a dict.
Unknown keys are dropped, except on :class:`Perturbation`, which keeps
them after its fields. A default factory (``list``, ``dict``) makes a new
value for each instance. Fields can be assigned without a check, as in
pydantic. ``model_dump()`` returns every field (``exclude_none`` drops the
``None`` ones), nested models as dicts. A failed check raises
``ValueError`` naming the model and the field.
"""

from __future__ import annotations

import re
from typing import Any, Callable

MAX_CHANNELS = 8

__all__ = [
    "MAX_CHANNELS",
    "Model",
    "parse_position_name",
    "parse_channel_fields",
    "DatasetRecord",
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


def parse_channel_fields(name: str) -> dict:
    """Classify a zarr channel label: ``channel_type`` (labelfree,
    fluorescence, virtual_stain or unknown), with ``filter_cube``,
    ``excitation_nm`` and ``emission_nm`` where the label names them (e.g.
    ``"raw GFP EX488 EM525-45"`` -> fluorescence, GFP, 488, 525)."""
    result: dict = {}
    low = name.lower()
    fl = re.match(r"raw\s+(\w+)\s+EX(\d+)\s+EM(\d+)(?:-(\d+))?", name, re.IGNORECASE)
    if fl:
        result["channel_type"] = "fluorescence"
        result["filter_cube"] = fl.group(1)
        result["excitation_nm"] = int(fl.group(2))
        result["emission_nm"] = int(fl.group(3))
        return result
    if any(kw in low for kw in ("prediction", "virtual", "vs_")):
        result["channel_type"] = "virtual_stain"
        return result
    if any(kw in low for kw in ("phase", "brightfield", "retardance")) or any(
        re.search(p, low) for p in (r"\bbf(\b|_)", r"\bdic\b", r"\bpol\b", r"\bphc\b")
    ):
        result["channel_type"] = "labelfree"
        return result
    ex_em = re.search(r"EX(\d+)\s*EM(\d+)", name, re.IGNORECASE)
    if ex_em:
        result["channel_type"] = "fluorescence"
        result["excitation_nm"] = int(ex_em.group(1))
        result["emission_nm"] = int(ex_em.group(2))
        return result
    result["channel_type"] = "unknown"
    return result


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
    if isinstance(value, (bool, int)):
        return int(value)
    if isinstance(value, bytes):
        value = value.decode()
    if isinstance(value, str):
        # digits (underscores between them), a fractional part of zeros at most
        m = re.fullmatch(r"([+-]?\d+(?:_\d+)*)(?:\.0+)?", value.strip())
        if m:
            return int(m.group(1))
    elif isinstance(value, float) and value.is_integer() and abs(value) < 2**63:
        return int(value)
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
        if not isinstance(value, (list, tuple, set, frozenset)):
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

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self.__dict__.get("_values", {}):
            self._values[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str) -> Any:
        values = self.__dict__.get("_values", {})
        if name in values:
            return values[name]
        extra = self.__dict__.get("_extra", {})
        if name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__} has no field {name!r}")

    def model_dump(self, exclude_none: bool = False) -> dict:
        """Every field (``None`` ones too unless ``exclude_none``), then the
        kept extra keys."""
        items = {**self._values, **self._extra}.items()
        return {k: _dump(v) for k, v in items if not (exclude_none and v is None)}

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


_OPT_STR, _OPT_FLOAT, _OPT_INT = optional(as_str), optional(as_float), optional(as_int)


class DatasetRecord(Model):
    """One FOV-level record of the Airtable Datasets table. ``channel_names``
    and ``channel_markers``, when not given, are derived from the
    ``channel_{i}_name`` / ``channel_{i}_marker`` fields."""

    fields = (
        ("dataset", as_str, ""),
        ("well_id", as_str, ""),
        ("fov", _OPT_STR, None),
        ("cell_type", _OPT_STR, None),
        ("cell_state", _OPT_STR, None),
        ("cell_line", list_of(as_str), list),
        ("marker", _OPT_STR, None),
        ("organelle", _OPT_STR, None),
        ("perturbation", _OPT_STR, None),
        ("hours_post_perturbation", _OPT_FLOAT, None),
        ("moi", _OPT_FLOAT, None),
        ("time_interval_min", _OPT_FLOAT, None),
        ("seeding_density", _OPT_FLOAT, None),
        ("treatment_concentration_nm", _OPT_FLOAT, None),
        ("data_path", _OPT_STR, None),
        ("tracks_path", _OPT_STR, None),
        ("fluorescence_modality", _OPT_STR, None),
        ("microscope", _OPT_STR, None),
        ("labelfree_modality", _OPT_STR, None),
        ("treatment", _OPT_STR, None),
        ("hours_post_treatment", _OPT_FLOAT, None),
        *((f"{axis}_shape", _OPT_INT, None) for axis in "tczyx"),
        ("pixel_size_xy_um", _OPT_FLOAT, None),
        ("pixel_size_z_um", _OPT_FLOAT, None),
        ("channel_names", list_of(as_str), list),
        ("channel_markers", dict_of(as_str), dict),
        ("record_id", _OPT_STR, None),
        *((f"channel_{i}_{attr}", _OPT_STR, None) for i in range(MAX_CHANNELS) for attr in ("name", "marker")),
    )

    def __init__(self, **data: Any) -> None:
        super().__init__(**data)
        self._derive_channel_names()

    def _derive_channel_names(self) -> None:
        """Flatten ``channel_{i}_name`` / ``_marker`` into the list and dict
        views, where those were not given."""
        if not self.channel_names:
            self.channel_names = [n for i in range(MAX_CHANNELS) if (n := getattr(self, f"channel_{i}_name"))
                                  is not None]
        if not self.channel_markers:
            markers: dict[str, str] = {}
            for i in range(MAX_CHANNELS):
                name, marker = getattr(self, f"channel_{i}_name"), getattr(self, f"channel_{i}_marker")
                if name is not None and marker is not None:
                    markers[name] = marker
            self.channel_markers = markers

    @classmethod
    def from_airtable_record(cls, record: dict) -> "DatasetRecord":
        """Parse a raw Airtable API record (``{"id", "fields"}``), taking the
        ``name`` of single-select values and of each multi-select entry."""
        fields = record.get("fields", {})

        def _select(v):
            return v.get("name", v) if isinstance(v, dict) else v

        def _multi(v):
            if isinstance(v, list):
                return [x.get("name", x) if isinstance(x, dict) else x for x in v]
            return v if v is not None else []

        return cls(
            dataset=fields.get("dataset", ""),
            well_id=fields.get("well_id", ""),
            fov=fields.get("fov"),
            cell_type=_select(fields.get("cell_type")),
            cell_state=_select(fields.get("cell_state")),
            cell_line=_multi(fields.get("cell_line")),
            marker=_select(fields.get("marker")),
            organelle=_select(fields.get("organelle")),
            perturbation=_select(fields.get("perturbation")),
            hours_post_perturbation=fields.get("hours_post_perturbation"),
            moi=fields.get("moi"),
            time_interval_min=fields.get("time_interval_min"),
            seeding_density=fields.get("seeding_density"),
            treatment_concentration_nm=fields.get("treatment_concentration_nm"),
            **{
                f"channel_{i}_{attr}": (fields.get(f"channel_{i}_{attr}") if attr == "name"
                                        else _select(fields.get(f"channel_{i}_{attr}")))
                for i in range(MAX_CHANNELS)
                for attr in ("name", "marker")
            },
            data_path=fields.get("data_path"),
            tracks_path=fields.get("tracks_path"),
            fluorescence_modality=_select(fields.get("fluorescence_modality")),
            microscope=_select(fields.get("microscope")),
            labelfree_modality=_select(fields.get("labelfree_modality")),
            treatment=_select(fields.get("treatment")),
            hours_post_treatment=fields.get("hours post treatment"),
            **{f"{axis}_shape": fields.get(f"{axis}_shape") for axis in "tczyx"},
            pixel_size_xy_um=fields.get("pixel_size_xy_um"),
            pixel_size_z_um=fields.get("pixel_size_z_um"),
            record_id=record.get("id"),
        )

    def to_channels_metadata(self) -> dict[str, dict]:
        """``.zattrs["channels_metadata"]``: channel name -> a
        :class:`ChannelAnnotationEntry`-shaped dict."""
        annotation: dict[str, dict] = {}
        for i in range(MAX_CHANNELS):
            name = getattr(self, f"channel_{i}_name")
            if name is None:
                continue
            ch_type = parse_channel_fields(name).get("channel_type", "unknown")
            if ch_type not in ("fluorescence", "labelfree", "virtual_stain"):
                ch_type = "labelfree"
            marker_value = getattr(self, f"channel_{i}_marker")
            bio_dict = None
            if ch_type == "labelfree":
                bio_dict = {"marker": name}
            elif marker_value is not None:
                bio_dict = {"marker": marker_value, "marker_type": "protein_tag", "fluorophore": None}
            annotation[name] = {"channel_type": ch_type, "biological_annotation": bio_dict}
        return annotation

    def to_experiment_metadata(self) -> dict:
        """``.zattrs["experiment_metadata"]``: the perturbation (with its MOI
        and concentration where known) and the time sampling."""
        perturbations: list[dict] = []
        if self.perturbation is not None:
            p: dict = {"name": self.perturbation, "type": "unknown", "hours_post": self.hours_post_perturbation or 0.0}
            if self.moi is not None:
                p["moi"] = self.moi
            if self.treatment_concentration_nm is not None:
                p["concentration_nm"] = self.treatment_concentration_nm
            perturbations.append(p)
        return {"perturbations": perturbations, "time_sampling_minutes": self.time_interval_min or 0.0}

    def to_airtable_fields(self) -> dict:
        """The set fields for a create or update: no ``None``, empty list or
        empty dict, and none of the identity keys."""
        exclude = {"record_id", "dataset", "well_id", "fov"}
        return {k: v for k, v in self.model_dump(exclude_none=True).items()
                if k not in exclude and v != [] and v != {}}

    def to_fov_record(self):
        """The collection-level :class:`viscy_tpu_torch.data.schemas.FOVRecord`."""
        from viscy_tpu_torch.data.schemas import FOVRecord

        return FOVRecord(
            fov_name=f"{self.well_id}/{self.fov}" if self.fov else self.well_id,
            store_path=self.data_path or "",
            well=self.well_id,
            channel_names=self.channel_names,
            perturbation=self.perturbation,
            cell_line=self.cell_line[0] if self.cell_line else None,
            marker=self.marker,
            organelle=self.organelle,
            microscope=self.microscope,
            pixel_size_xy_um=self.pixel_size_xy_um,
            pixel_size_z_um=self.pixel_size_z_um,
            interval_minutes=self.time_interval_min,
            hours_post_perturbation_start=self.hours_post_perturbation,
        )
