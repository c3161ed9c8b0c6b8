"""Artifact cache of the evaluation pipeline (counterpart of
``viscy_tpu/apps/dynacell/eval/cache.py``), in the same files and layout:
masks, instance labels and per-cell feature matrices persist as ``.npy``
files per (artifact, position[, timepoint]) under a cache directory, beside
a JSON ``manifest.json``, so repeat runs skip segmentation and feature
extraction. A cache written by either package serves the other.

The cache's identity is its source plate and channel (and segmentation
source): a mismatch raises :class:`StaleCacheError`. Each artifact class
records the parameters it was built with; when they disagree with the
current config, that class is dropped and recomputed. With
``require_complete`` a missing artifact raises instead of being computed.
"""

from __future__ import annotations

import json
import shutil
import threading
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Literal

import numpy as np

__all__ = [
    "CACHE_SCHEMA_VERSION",
    "FEATURE_KINDS",
    "StaleCacheError",
    "CachePaths",
    "cache_paths",
    "load_manifest",
    "save_manifest",
    "check_cache_identity",
    "seed_cache_identity",
    "diff_artifact_params",
    "CacheContext",
    "init_cache_context",
    "fov_masks",
    "fov_nucleus_instances",
    "fov_cp_features",
    "fov_deep_features",
    "flush_manifest",
]

CACHE_SCHEMA_VERSION = 1

#: FOV worker threads share one manifest per side: its updates take this lock
_manifest_lock = threading.Lock()
FEATURE_KINDS = ("cp", "dinov3", "dynaclr", "celldino")


class StaleCacheError(RuntimeError):
    """Cache identity or artifact params disagree with the current config."""


def _sanitize(name: str) -> str:
    return name.replace("/", "_")


@dataclass(frozen=True)
class CachePaths:
    root: Path
    manifest: Path
    masks_dir: Path
    features_dir: Path
    instance_masks_dir: Path

    def mask_file(self, side: str, target_name: str, pos_name: str, backend: str = "native") -> Path:
        stem = target_name if backend == "native" else f"{target_name}__{backend}"
        return self.masks_dir / f"{side}__{stem}" / f"{_sanitize(pos_name)}.npy"

    def instance_file(self, side: str, target_name: str, pos_name: str, backend: str) -> Path:
        return self.instance_masks_dir / f"{side}__{target_name}__{backend}" / f"{_sanitize(pos_name)}.npy"

    def feature_file(self, side: str, kind: str, pos_name: str, t: int) -> Path:
        return self.features_dir / f"{side}__{kind}" / f"{_sanitize(pos_name)}__t{t}.npy"


def cache_paths(cache_dir: Path | str) -> CachePaths:
    root = Path(cache_dir)
    return CachePaths(
        root=root,
        manifest=root / "manifest.json",
        masks_dir=root / "masks",
        features_dir=root / "features",
        instance_masks_dir=root / "instance_masks",
    )


def load_manifest(paths: CachePaths) -> dict[str, Any]:
    if paths.manifest.exists():
        return json.loads(paths.manifest.read_text())
    return {"cache_schema_version": CACHE_SCHEMA_VERSION, "artifacts": {}}


def save_manifest(paths: CachePaths, manifest: dict[str, Any]) -> None:
    paths.root.mkdir(parents=True, exist_ok=True)
    tmp = paths.manifest.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(manifest, indent=1, sort_keys=True, default=str))
    tmp.replace(paths.manifest)


def built_at_now() -> str:
    return datetime.now(timezone.utc).isoformat()


def check_cache_identity(
    manifest: dict[str, Any],
    *,
    source: Literal["gt", "pred"] | None = None,
    plate_path: str | None = None,
    channel_name: str | None = None,
    cell_segmentation_path: str | None = None,
) -> None:
    """Raise :class:`StaleCacheError` when the manifest's identity disagrees
    with the current config: schema version, per-side plate and channel,
    segmentation source."""
    version = manifest.get("cache_schema_version")
    if version is not None and version != CACHE_SCHEMA_VERSION:
        raise StaleCacheError(
            f"Cache schema version mismatch: manifest has {version}, current is "
            f"{CACHE_SCHEMA_VERSION}. Delete the cache directory."
        )
    if source is not None:
        entry = manifest.get(source)
        if entry is not None and plate_path is not None and entry.get("plate_path") != plate_path:
            raise StaleCacheError(
                f"{source}.plate_path mismatch: manifest={entry.get('plate_path')!r}, config={plate_path!r}"
            )
        if entry is not None and channel_name is not None and entry.get("channel_name") != channel_name:
            raise StaleCacheError(
                f"{source}.channel_name mismatch: manifest={entry.get('channel_name')!r}, config={channel_name!r}"
            )
    seg = manifest.get("cell_segmentation")
    if seg is not None and cell_segmentation_path is not None:
        if seg.get("plate_path") != cell_segmentation_path:
            raise StaleCacheError(
                f"cell_segmentation.plate_path mismatch: manifest={seg.get('plate_path')!r}, "
                f"config={cell_segmentation_path!r}"
            )


def seed_cache_identity(
    manifest: dict[str, Any],
    *,
    source: Literal["gt", "pred"] | None = None,
    plate_path: str | None = None,
    channel_name: str | None = None,
    cell_segmentation_path: str | None = None,
) -> None:
    manifest["cache_schema_version"] = CACHE_SCHEMA_VERSION
    if source is not None and plate_path is not None and manifest.get(source) is None:
        manifest[source] = {"plate_path": plate_path, "channel_name": channel_name}
    if cell_segmentation_path is not None and manifest.get("cell_segmentation") is None:
        manifest["cell_segmentation"] = {"plate_path": cell_segmentation_path}


def diff_artifact_params(
    entry: dict[str, Any] | None,
    current: dict[str, Any],
    *,
    numeric_keys: tuple[str, ...] = (),
) -> list[tuple[str, Any, Any]]:
    """Per-key mismatches between a manifest entry and the current params
    (numeric keys compare with allclose; malformed entries surface every
    key as a mismatch so the caller soft-invalidates)."""
    if entry is None:
        return []
    if not isinstance(entry, dict):
        return [(k, entry, v) for k, v in current.items()]
    mismatches = []
    for key, value in current.items():
        cached = entry.get(key)
        if key in numeric_keys:
            try:
                close = cached is not None and np.allclose(
                    np.asarray(cached, float), np.asarray(value, float), rtol=1e-9, atol=0.0
                )
            except (TypeError, ValueError):
                close = False
            if not close:
                mismatches.append((key, cached, value))
        elif cached != value:
            mismatches.append((key, cached, value))
    return mismatches


# -- read-through context ------------------------------------------------------
@dataclass
class CacheContext:
    """One side's cache handle: paths + manifest + behavior flags."""

    paths: CachePaths | None
    manifest: dict[str, Any]
    force: dict[str, bool]
    require_complete: bool = False

    @property
    def enabled(self) -> bool:
        return self.paths is not None


def init_cache_context(
    cache_dir: str | Path | None,
    *,
    source: Literal["gt", "pred"] | None = None,
    plate_path: str | None = None,
    channel_name: str | None = None,
    force: dict[str, bool] | None = None,
    require_complete: bool = False,
) -> CacheContext:
    """Open (or create) one cache dir, validating + seeding identity."""
    force = dict(force or {})
    if cache_dir is None:
        return CacheContext(None, {}, force, require_complete)
    paths = cache_paths(cache_dir)
    manifest = load_manifest(paths)
    check_cache_identity(manifest, source=source, plate_path=plate_path, channel_name=channel_name)
    seed_cache_identity(manifest, source=source, plate_path=plate_path, channel_name=channel_name)
    return CacheContext(paths, manifest, force, require_complete)


def _artifact_entry(ctx: CacheContext, artifact: str) -> dict | None:
    return ctx.manifest.setdefault("artifacts", {}).get(artifact)


def _invalidate_artifact(ctx: CacheContext, artifact: str, subdir: Path) -> None:
    ctx.manifest.setdefault("artifacts", {}).pop(artifact, None)
    if subdir.exists():
        shutil.rmtree(subdir, ignore_errors=True)


def _auto_invalidate(ctx: CacheContext, artifact: str, params: dict, subdir: Path, numeric_keys=()) -> None:
    """Soft invalidation: drop + delete the artifact class on param
    mismatch so it recomputes with the current config."""
    with _manifest_lock:
        entry = _artifact_entry(ctx, artifact)
        mismatches = diff_artifact_params(entry.get("params") if isinstance(entry, dict) else entry, params,
                                          numeric_keys=numeric_keys)
        if mismatches:
            _invalidate_artifact(ctx, artifact, subdir)


def _record_artifact(ctx: CacheContext, artifact: str, params: dict, pos_name: str) -> None:
    with _manifest_lock:
        art = ctx.manifest.setdefault("artifacts", {}).setdefault(
            artifact, {"params": params, "built_at": built_at_now(), "positions": []}
        )
        if pos_name not in art["positions"]:
            art["positions"].append(pos_name)


def _raise_if_require_complete(ctx: CacheContext, artifact: str, pos_name: str) -> None:
    if ctx.require_complete:
        raise StaleCacheError(
            f"require_complete_cache: {artifact} for position {pos_name!r} is "
            "not cached and recomputation is disabled."
        )


def _read_through(
    ctx: CacheContext,
    artifact: str,
    file: Path | None,
    params: dict,
    pos_name: str,
    compute,
    *,
    force_key: str,
    numeric_keys=(),
    dtype=None,
):
    """Generic read-through: cached npy when valid, else compute + write."""
    force = ctx.force.get("all") or ctx.force.get(force_key)
    if ctx.enabled and file is not None:
        _auto_invalidate(ctx, artifact, params, file.parent, numeric_keys=numeric_keys)
        if file.exists() and not force:
            return np.load(file)
        if not file.exists() and not force:
            _raise_if_require_complete(ctx, artifact, pos_name)
    result = compute()
    if ctx.enabled and file is not None:
        file.parent.mkdir(parents=True, exist_ok=True)
        np.save(file, result if dtype is None else np.asarray(result, dtype))
        _record_artifact(ctx, artifact, params, pos_name)
    return result


def fov_masks(
    ctx: CacheContext,
    side: str,
    target_name: str,
    pos_name: str,
    compute,
    *,
    backend: str = "native",
    params: dict | None = None,
):
    """Per-(side, FOV) semantic mask stack (T, D, H, W) bool, cached."""
    params = {"backend": backend, "target_name": target_name, **(params or {})}
    file = ctx.paths.mask_file(side, target_name, pos_name, backend) if ctx.enabled else None
    return _read_through(
        ctx, f"masks_{side}", file, params, pos_name, compute, force_key="masks", dtype=bool
    )


def fov_nucleus_instances(
    ctx: CacheContext,
    side: str,
    target_name: str,
    pos_name: str,
    compute,
    *,
    backend: str = "native",
    params: dict | None = None,
):
    """Per-(side, FOV) instance label stack (T, D, H, W) int32, cached."""
    params = {"backend": backend, "target_name": target_name, **(params or {})}
    file = ctx.paths.instance_file(side, target_name, pos_name, backend) if ctx.enabled else None
    return _read_through(
        ctx, f"instances_{side}", file, params, pos_name, compute, force_key="instances", dtype=np.int32
    )


def fov_cp_features(
    ctx: CacheContext,
    side: str,
    pos_name: str,
    t: int,
    compute,
    *,
    params: dict | None = None,
):
    """Per-(side, FOV, t) CP feature matrix (n_cells, n_features), cached.
    Params include CP_FEATURE_VERSION so recipe bumps auto-invalidate."""
    from viscy_tpu_torch.apps.dynacell.eval.metrics import CP_FEATURE_VERSION

    params = {"cp_version": CP_FEATURE_VERSION, **(params or {})}
    file = ctx.paths.feature_file(side, "cp", pos_name, t) if ctx.enabled else None
    return _read_through(
        ctx, f"cp_features_{side}", file, params, pos_name, compute, force_key="cp_features"
    )


def fov_deep_features(
    ctx: CacheContext,
    side: str,
    kind: str,
    pos_name: str,
    t: int,
    compute,
    *,
    params: dict | None = None,
):
    """Per-(side, kind, FOV, t) deep feature matrix, cached. Params carry
    the extractor identity (checkpoint hash / config hash / patch size)."""
    file = ctx.paths.feature_file(side, kind, pos_name, t) if ctx.enabled else None
    return _read_through(
        ctx,
        f"{kind}_features_{side}",
        file,
        dict(params or {}),
        pos_name,
        compute,
        force_key="deep_features",
        numeric_keys=("patch_size",),
    )


def flush_manifest(ctx: CacheContext) -> None:
    if ctx.enabled:
        with _manifest_lock:
            save_manifest(ctx.paths, ctx.manifest)
