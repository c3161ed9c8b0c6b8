"""Config composition (counterpart of ``viscy_tpu/training/compose.py``):
YAML ``base:`` inheritance with a recursive deep merge. Dicts merge key by
key; lists and scalars replace. Top-level keys starting with ``_`` (YAML
anchor definitions) are stripped; circular ``base:`` references raise."""

from __future__ import annotations

import copy
from functools import lru_cache
from pathlib import Path
from typing import Callable

import yaml


@lru_cache(maxsize=256)
def _load_yaml_cached(resolved_path: Path) -> dict:
    with open(resolved_path) as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge ``override`` into ``base`` (lists replace)."""
    result = dict(base)
    for k, v in override.items():
        if k in result and isinstance(result[k], dict) and isinstance(v, dict):
            result[k] = deep_merge(result[k], v)
        else:
            result[k] = v
    return result


def load_composed_config(
    path: str | Path,
    _seen: frozenset[Path] | None = None,
    *,
    resolver: Callable[[dict], dict] | None = None,
) -> dict:
    """Load a YAML config, resolving its ``base:`` references (relative to
    the file) first."""
    path = Path(path).resolve()
    _seen = _seen or frozenset()
    if path in _seen:
        raise ValueError(f"Circular base: reference detected: {path}")
    _seen = _seen | {path}
    cfg = copy.deepcopy(_load_yaml_cached(path))
    bases = cfg.pop("base", []) or []
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for rel in bases:
        merged = deep_merge(merged, load_composed_config(path.parent / rel, _seen))
    result = deep_merge(merged, cfg)
    if resolver is not None:
        result = resolver(result)
    return {k: v for k, v in result.items() if not k.startswith("_")}
