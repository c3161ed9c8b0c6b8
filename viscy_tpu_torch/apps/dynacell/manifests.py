"""Manifest-driven dataset references of the DynaCell benchmark
(counterpart of ``viscy_tpu/apps/dynacell/manifests.py``; reference
``dynacell/data/{manifests,resolver}.py``).

A dataset manifest is ``<root>/<dataset>/manifest.yaml``: voxel spacing,
the source channel and the stores of each target. :func:`resolve_dataset_ref`
turns a ``{dataset, target}`` reference into paths and channel names; the
roots come from ``cli_roots``, then the ``DYNACELL_MANIFEST_ROOTS``
variable (``os.pathsep``-separated).

JAX validates these records with pydantic, which the card's machine may
lack; here they are :class:`~viscy_tpu_torch.apps.airtable_utils.schemas.Model`\\ s,
which check the same fields as pydantic's lax mode does (a path field takes
a string or a path and holds a :class:`~pathlib.Path`; a failed check raises
``ValueError`` naming the model and the field). ``ChannelEntry`` is the
port's own copy of the record ``viscy_tpu/data/collection.py`` defines.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import yaml

from viscy_tpu_torch.apps.airtable_utils.schemas import (
    REQUIRED,
    Model,
    as_float,
    as_int,
    as_str,
    dict_of,
    list_of,
    model,
    optional,
)

_ENV_VAR = "DYNACELL_MANIFEST_ROOTS"
REQUIRED_REF_KEYS: tuple[str, ...] = ("dataset", "target")

__all__ = [
    "ChannelEntry",
    "DatasetRef",
    "VoxelSpacing",
    "TargetStores",
    "TargetEntry",
    "DatasetManifest",
    "ResolvedDataset",
    "NoManifestRootsError",
    "ManifestNotFoundError",
    "TargetNotFoundError",
    "dataset_ref_from_dict",
    "discover_manifest_roots",
    "load_manifest",
    "resolve_dataset_ref",
]


class NoManifestRootsError(RuntimeError):
    """No manifest roots configured via CLI or env."""


class ManifestNotFoundError(LookupError):
    """Dataset slug not found under any configured root."""


class TargetNotFoundError(LookupError):
    """Target slug not present in the located manifest."""


def as_path(value: Any) -> Path:
    if isinstance(value, Path):
        return value
    if isinstance(value, str):
        return Path(value)
    raise ValueError(f"Input is not a valid path, got {value!r}")


def as_dict(value: Any) -> dict:
    if not isinstance(value, dict):
        raise ValueError(f"Input should be a valid dictionary, got {value!r}")
    return value


class ChannelEntry(Model):
    """One channel with its biological marker label."""

    fields = (("name", as_str, REQUIRED), ("marker", as_str, REQUIRED))


class DatasetRef(Model):
    fields = (("dataset", as_str, REQUIRED), ("target", as_str, REQUIRED))


class VoxelSpacing(Model):
    fields = (("z", as_float, REQUIRED), ("y", as_float, REQUIRED), ("x", as_float, REQUIRED))

    def as_list(self) -> list[float]:
        return [self.z, self.y, self.x]


class TargetStores(Model):
    fields = (
        ("train", as_path, REQUIRED),
        ("test", as_path, REQUIRED),
        ("cell_segmentation", optional(as_path), None),
        ("gt_cache_dir", optional(as_path), None),
    )


class TargetEntry(Model):
    fields = (
        ("target_channel", as_str, REQUIRED),
        ("stores", model(TargetStores), REQUIRED),
        ("gene", optional(as_str), None),
        ("organelle", optional(as_str), None),
        ("display_name", optional(as_str), None),
        ("splits", optional(as_str), None),
    )


class _Channels(Model):
    fields = (("source", as_str, REQUIRED), ("auxiliary", list_of(as_str), list))


class DatasetManifest(Model):
    fields = (
        ("name", as_str, REQUIRED),
        ("spacing", model(VoxelSpacing), REQUIRED),
        ("channels", model(_Channels), REQUIRED),
        ("targets", dict_of(model(TargetEntry)), REQUIRED),
        ("version", optional(as_str), None),
        ("description", optional(as_str), None),
        ("cell_type", optional(as_str), None),
        ("imaging_modality", optional(as_str), None),
    )

    @property
    def source_channel(self) -> str:
        return self.channels.source


class ResolvedDataset(Model):
    """The manifest's fields a composed config needs, flat."""

    fields = (
        ("manifest_path", as_path, REQUIRED),
        ("data_path_train", as_path, REQUIRED),
        ("data_path_test", as_path, REQUIRED),
        ("source_channel", as_str, REQUIRED),
        ("target_channel", as_str, REQUIRED),
        ("spacing", model(VoxelSpacing), REQUIRED),
        ("cell_segmentation_path", optional(as_path), None),
        ("gt_cache_dir", optional(as_path), None),
    )


def dataset_ref_from_dict(ref_dict: object) -> DatasetRef | None:
    """``benchmark.dataset_ref`` validated: a partial or missing reference is
    no reference (``None``); a full one is checked."""
    if not isinstance(ref_dict, dict):
        return None
    if not all(k in ref_dict for k in REQUIRED_REF_KEYS):
        return None
    return DatasetRef(**ref_dict)


def discover_manifest_roots(cli_roots: list[Path] | None = None) -> list[Path]:
    """The roots in precedence order: ``cli_roots``, then the variable's."""
    roots: list[Path] = []
    if cli_roots:
        roots.extend(Path(p) for p in cli_roots)
    env_value = os.environ.get(_ENV_VAR)
    if env_value:
        roots.extend(Path(p) for p in env_value.split(os.pathsep) if p)
    if not roots:
        raise NoManifestRootsError(f"No dynacell manifest roots configured; set {_ENV_VAR} or pass cli_roots.")
    return roots


def _load_yaml(path: Path | str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


def _validated(cls: type[Model], data: Any) -> Model:
    if not isinstance(data, dict):
        raise ValueError(f"validation error for {cls.__name__}: Input should be a valid dictionary, got {data!r}")
    return cls(**data)


def load_manifest(path: Path | str) -> DatasetManifest:
    return _validated(DatasetManifest, _load_yaml(path))


def _find_manifest(dataset: str, roots: list[Path]) -> Path:
    searched = []
    for root in roots:
        candidate = root / dataset / "manifest.yaml"
        searched.append(candidate)
        if candidate.is_file():
            return candidate
    lines = "\n".join(f"  - {p}" for p in searched)
    raise ManifestNotFoundError(f"dataset {dataset!r} not found.\nSearched:\n{lines}")


def resolve_dataset_ref(ref: DatasetRef, roots: list[Path] | None = None) -> ResolvedDataset:
    """Resolve a reference against the manifests under the roots."""
    manifest_path = _find_manifest(ref.dataset, discover_manifest_roots(roots))
    manifest = load_manifest(manifest_path)
    if ref.target not in manifest.targets:
        available = ", ".join(sorted(manifest.targets)) or "(none)"
        raise TargetNotFoundError(f"target {ref.target!r} not found in dataset {ref.dataset!r}; "
                                  f"available: {available}")
    target = manifest.targets[ref.target]
    return ResolvedDataset(
        manifest_path=manifest_path,
        data_path_train=target.stores.train,
        data_path_test=target.stores.test,
        source_channel=manifest.source_channel,
        target_channel=target.target_channel,
        spacing=manifest.spacing,
        cell_segmentation_path=target.stores.cell_segmentation,
        gt_cache_dir=target.stores.gt_cache_dir,
    )


# -- the reference's names (dynacell/data/manifests.py) ----------------------------
StoreLocations = TargetStores
TargetConfig = TargetEntry


class SplitDefinition(Model):
    """The train / val / test FOV split of one organelle; a declared
    ``count`` must match a non-empty ``fovs`` list."""

    fields = (
        ("split_version", as_str, REQUIRED),
        ("random_seed", as_int, REQUIRED),
        ("source_stores", optional(list_of(as_path)), None),
        ("selection_criteria", optional(as_dict), None),
        ("train", as_dict, REQUIRED),
        ("test", as_dict, REQUIRED),
        ("val", optional(as_dict), None),
    )

    def __init__(self, **data: Any) -> None:
        super().__init__(**data)
        for split_name in ("train", "val", "test"):
            split = getattr(self, split_name)
            if split is None:
                continue
            fovs = split.get("fovs", [])
            if fovs and "count" in split and len(fovs) != split["count"]:
                raise ValueError(f"validation error for SplitDefinition: {split_name} declares "
                                 f"count={split['count']} but has {len(fovs)} FOVs.")


def load_splits(split_path: Path | str) -> SplitDefinition:
    return _validated(SplitDefinition, _load_yaml(split_path))


def get_target(manifest: DatasetManifest, target_name: str) -> TargetEntry:
    """One organelle target of a manifest."""
    if target_name not in manifest.targets:
        raise TargetNotFoundError(f"Target {target_name!r} not in manifest {manifest.name!r}; "
                                  f"have {sorted(manifest.targets)}")
    return manifest.targets[target_name]


# -- frozen benchmark collections and specs (dynacell/data/{collections,specs}.py) --
class CollectionProvenance(Model):
    """Where a frozen collection came from (``created_at`` / ``created_by``
    required, for the benchmark's traceability)."""

    fields = (
        ("airtable_base_id", optional(as_str), None),
        ("airtable_query", optional(as_str), None),
        ("record_ids", list_of(as_str), list),
        ("created_at", as_str, REQUIRED),
        ("created_by", as_str, REQUIRED),
    )


class CollectionExperiment(Model):
    """One experiment of a benchmark collection."""

    fields = (
        ("name", as_str, REQUIRED),
        ("data_path", as_path, REQUIRED),
        ("channels", list_of(model(ChannelEntry)), REQUIRED),
        ("perturbation_wells", optional(dict_of(list_of(as_str))), None),
        ("interval_minutes", optional(as_float), None),
        ("start_hpi", optional(as_float), None),
        ("marker", optional(as_str), None),
        ("organelle", optional(as_str), None),
        ("pixel_size_xy_um", as_float, REQUIRED),
        ("pixel_size_z_um", optional(as_float), None),
        ("exclude_fovs", list_of(as_str), list),
    )


class BenchmarkCollection(Model):
    """A frozen collection tying experiments to train / test FOVs."""

    fields = (
        ("name", as_str, REQUIRED),
        ("description", as_str, REQUIRED),
        ("provenance", model(CollectionProvenance), REQUIRED),
        ("experiments", list_of(model(CollectionExperiment)), REQUIRED),
        ("train_fovs", optional(list_of(as_str)), None),
        ("test_fovs", optional(list_of(as_str)), None),
    )


Provenance = CollectionProvenance


def load_collection(collection_path: Path | str) -> BenchmarkCollection:
    return _validated(BenchmarkCollection, _load_yaml(collection_path))


class BenchmarkSpec(Model):
    """A benchmark recipe tying the pipeline's stages together."""

    fields = (
        ("name", as_str, REQUIRED),
        ("version", as_str, REQUIRED),
        ("description", as_str, REQUIRED),
        ("collection_path", as_path, REQUIRED),
        ("preprocess_configs", list_of(as_path), list),
        ("train_preset", optional(as_str), None),
        ("predict_preset", optional(as_str), None),
        ("evaluate_config", optional(as_path), None),
        ("report_config", optional(as_path), None),
        ("output_root", as_path, REQUIRED),
        ("checkpoint_path", optional(as_path), None),
    )


def load_benchmark_spec(spec_path: Path | str) -> BenchmarkSpec:
    return _validated(BenchmarkSpec, _load_yaml(spec_path))
