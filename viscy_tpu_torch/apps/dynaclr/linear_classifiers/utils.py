"""Discovery and registry utilities of the linear-classifier pipelines
(counterpart of ``viscy_tpu/apps/dynaclr/linear_classifiers/utils.py``):
which (model, dataset, channel, task) combinations can be evaluated from
what exists on disk (per-channel embedding stores, annotation CSVs with
task columns), and the job registry the orchestrated pipeline and the
rotating cross-validation consume. No pandas: CSV headers are read with the
``csv`` module.
"""

from __future__ import annotations

import csv
import logging
import re
from pathlib import Path

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["build_registry", "discover_predictions", "extract_epoch", "find_annotation_csv", "find_channel_zarrs",
           "get_available_tasks", "print_registry_summary", "resolve_task_channels"]

#: metadata columns never treated as annotation tasks
_NON_TASK_COLUMNS = {"fov_name", "track_id", "t", "id", "y", "x", "z", "parent_track_id", "parent_id", "experiment",
                     "fov", "well"}


def extract_epoch(ckpt_path: str) -> str:
    """Epoch token from a checkpoint filename (``epoch=12-...`` -> ``12``)."""
    m = re.search(r"epoch[=_-](\d+)", str(ckpt_path))
    return m.group(1) if m else "unknown"


def _is_embedding_store(path: Path) -> bool:
    return (path / "obs").exists() or (path / "index.parquet").exists()


def find_channel_zarrs(embeddings_dir: Path, channels: list[str]) -> dict[str, Path]:
    """Per-channel embedding stores under one directory: ``<dir>/<channel>
    .zarr``, ``<dir>/<channel>/``, or any store whose name holds the channel
    (case-insensitive)."""
    embeddings_dir = Path(embeddings_dir)
    out: dict[str, Path] = {}
    if not embeddings_dir.exists():
        return out
    candidates = [p for p in embeddings_dir.iterdir() if p.is_dir()]
    for channel in channels:
        exact = embeddings_dir / f"{channel}.zarr"
        if exact.exists():
            out[channel] = exact
            continue
        plain = embeddings_dir / channel
        if plain.exists() and _is_embedding_store(plain):
            out[channel] = plain
            continue
        for p in candidates:
            if channel.lower() in p.name.lower() and _is_embedding_store(p):
                out[channel] = p
                break
    return out


def find_annotation_csv(annotations_dir: Path, dataset_name: str) -> Path | None:
    """Annotation CSV for one dataset: ``<name>.csv`` or any CSV whose
    filename holds the dataset token."""
    annotations_dir = Path(annotations_dir)
    if not annotations_dir.exists():
        return None
    exact = annotations_dir / f"{dataset_name}.csv"
    if exact.exists():
        return exact
    for p in sorted(annotations_dir.glob("*.csv")):
        if dataset_name.lower() in p.stem.lower():
            return p
    return None


def get_available_tasks(csv_path: Path) -> list[str]:
    """Task columns of one annotation CSV (every non-metadata column); none
    when the file is missing or has no header, as in JAX."""
    try:
        with open(csv_path, newline="") as f:
            header = next(csv.reader(f))
    except (OSError, StopIteration, csv.Error, UnicodeDecodeError):
        return []
    cols = [h if h else f"Unnamed: {i}" for i, h in enumerate(header)]
    return [c for c in cols if c not in _NON_TASK_COLUMNS]


def resolve_task_channels(task_channels: dict[str, list[str]] | None,
                          annotation_csvs: list[Path]) -> dict[str, list[str]]:
    """Task -> channels: the config's when given, else every task column
    found in the annotation CSVs, each with no channel (callers fill in
    their channel list)."""
    if task_channels:
        return {k: list(v) for k, v in task_channels.items()}
    tasks: dict[str, list[str]] = {}
    for path in annotation_csvs:
        for task in get_available_tasks(path):
            tasks.setdefault(task, [])
    return tasks


def discover_predictions(predictions_root: Path, channels: list[str], epoch: str | None = None) -> dict[str, dict]:
    """Dataset name -> channel -> store under a predictions root
    (``<root>/<dataset>/[...epoch token.../]<channel>.zarr``; the latest
    epoch directory when ``epoch`` is None)."""
    predictions_root = Path(predictions_root)
    out: dict[str, dict[str, Path]] = {}
    if not predictions_root.exists():
        return out
    for ds_dir in sorted(p for p in predictions_root.iterdir() if p.is_dir()):
        found = find_channel_zarrs(ds_dir, channels)
        if not found:
            subdirs = sorted(p for p in ds_dir.iterdir() if p.is_dir())
            if epoch is not None:
                subdirs = [p for p in subdirs if epoch in p.name] or subdirs
            for sub in reversed(subdirs):
                found = find_channel_zarrs(sub, channels)
                if found:
                    break
        if found:
            out[ds_dir.name] = found
    return out


def build_registry(datasets: list[dict], channels: list[str],
                   task_channels: dict[str, list[str]] | None = None) -> list[dict]:
    """(dataset, channel, task) jobs with their ``embeddings`` and
    ``annotations`` paths; a combination whose store or task column is
    missing is left out."""
    registry: list[dict] = []
    for ds in datasets:
        name = ds.get("name", Path(str(ds.get("embeddings_dir", ""))).name)
        annotations = Path(ds["annotations"])
        available = get_available_tasks(annotations)
        channel_zarrs = find_channel_zarrs(Path(ds["embeddings_dir"]), channels)
        tc = resolve_task_channels(task_channels, [annotations])
        for task in tc or {t: channels for t in available}:
            if task not in available:
                continue
            for channel in tc.get(task) or channels:
                if channel not in channel_zarrs:
                    continue
                job = {"dataset": name, "channel": channel, "task": task, "embeddings": str(channel_zarrs[channel]),
                       "annotations": str(annotations)}
                if "include_wells" in ds:
                    job["include_wells"] = ds["include_wells"]
                registry.append(job)
    return registry


def print_registry_summary(registry: list[dict]) -> str:
    """A readable summary: the datasets of each (task, channel)."""
    if not registry:
        return "registry: empty (no evaluable combinations found)"
    lines = [f"registry: {len(registry)} jobs over {len({r['dataset'] for r in registry})} datasets"]
    groups: dict[tuple, list[str]] = {}
    for r in registry:
        groups.setdefault((r["task"], r["channel"]), []).append(r["dataset"])
    for (task, channel), names in sorted(groups.items()):
        lines.append(f"  {task} / {channel}: {sorted(names)}")
    text = "\n".join(lines)
    _logger.info(text)
    return text
