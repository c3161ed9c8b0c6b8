"""Orchestrated linear-classifier evaluation from a combined embedding store
(counterpart of ``viscy_tpu/apps/dynaclr/linear_classifiers/orchestrated.py``).

Reads the combined embeddings (one store, or a directory of per-experiment
stores), filters by marker, joins each experiment's annotation CSV, and
trains one probe per (task, marker filter) with
:func:`viscy_tpu_torch.evaluation.linear_classifier.train_linear_classifier_anndata`
on the device, its split grouped by ``split_groups_by`` when given (no
track leaks across the split). Writes ``metrics_summary.csv``, the
pipelines as ``{task}_{marker}.npz`` with ``pipelines/manifest.json``
naming them (JAX writes sklearn pickles, ``.joblib``, which the card's
machine cannot load), and the atomically published, versioned bundle
(``publish_dir/v{n}`` and its ``latest`` symlink).

JAX then always draws a PDF of figures a task (``summary_{task}.pdf``):
that needs matplotlib, absent on the card's machine, so the port raises by
name once everything else is written (ROADMAP.md Queue 1 item 9). A
training ``ValueError`` (too few classes; ``liblinear``, the default
solver, with three or more classes) skips the (task, marker) pair, as in
JAX.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["PLOTS_REFUSAL", "publish_atomically", "run_linear_classifiers"]

PLOTS_REFUSAL = ("run-linear-classifiers wrote {written}; its per-task figures ({pdfs}) need matplotlib, which the "
                 "card's machine lacks, and are not drawn by viscy_tpu_torch (ROADMAP.md Queue 1 item 9)")


def _load_combined(embeddings_path: Path):
    """One store, or a directory of per-experiment ``*.zarr`` stores
    concatenated in name order."""
    from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite
    from viscy_tpu_torch.evaluation.linear_classifier import concat_frames
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    embeddings_path = Path(embeddings_path)
    if embeddings_path.is_dir() and not ((embeddings_path / "obs").exists()
                                         or (embeddings_path / "index.parquet").exists()):
        paths = sorted(embeddings_path.glob("*.zarr"))
        if not paths:
            raise FileNotFoundError(f"No .zarr stores found in {embeddings_path}")
        parts = [read_embedding_dataset(p) for p in paths]
        return AnnDataLite(np.concatenate([p.X for p in parts]), concat_frames([p.obs for p in parts]))
    return read_embedding_dataset(embeddings_path)


def _strings(values) -> np.ndarray:
    return np.asarray([str(v) for v in values.tolist()], dtype=object)


def run_linear_classifiers(embeddings_path: Path, config: dict, output_dir: Path, device: str = "cuda") -> list[dict]:
    """Train the probes of each (task, marker filter); see the module
    docstring. Config keys as JAX's: ``annotations`` ([{experiment,
    path}]), ``tasks`` ([{task, marker_filters}]), ``split_groups_by``,
    ``use_scaling``, ``use_pca``, ``n_pca_components``, ``solver``,
    ``class_weight``, ``max_iter``, ``split_train_data``, ``random_seed``,
    ``publish_dir``. Returns the metric rows when nothing was trained (an
    empty list); otherwise raises at the figures, after writing."""
    from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite
    from viscy_tpu_torch.evaluation.annotation import load_annotation_anndata
    from viscy_tpu_torch.evaluation.linear_classifier import (concat_frames, label_mask, subset,
                                                              train_linear_classifier_anndata)
    from viscy_tpu_torch.training.cli_utils import rows_to_csv

    output_dir = Path(output_dir)
    adata = _load_combined(Path(embeddings_path))
    _logger.info("loaded %d cells x %d features", adata.n_obs, adata.X.shape[1])
    missing = [c for c in ("experiment", "marker") if c not in adata.obs]
    if missing:
        raise ValueError(f"embeddings obs is missing columns: {missing}. Re-run the predict step with the updated "
                         "pipeline to include metadata.")
    markers = _strings(adata.obs["marker"])
    experiments = _strings(adata.obs["experiment"])
    all_metrics: list[dict] = []
    pipelines_dir = output_dir / "pipelines"
    pipelines_dir.mkdir(parents=True, exist_ok=True)
    pipeline_manifest: list[dict] = []
    trained: list[tuple] = []
    tasks: list[str] = []
    for task_spec in config.get("tasks", []):
        task = task_spec["task"]
        marker_filters = task_spec.get("marker_filters")
        runs = marker_filters if marker_filters is not None else sorted(set(markers.tolist()))
        tasks.append(task)
        for marker_filter in runs:
            sel = np.ones(adata.n_obs, bool) if marker_filter is None else markers == str(marker_filter)
            if not sel.any():
                continue
            parts = []
            for ann_src in config.get("annotations", []):
                rows = np.flatnonzero(sel & (experiments == str(ann_src["experiment"])))
                if not len(rows):
                    continue
                ann_path = Path(ann_src["path"])
                if not ann_path.exists():
                    raise FileNotFoundError(f"Annotation CSV not found: {ann_path}")
                try:
                    part = load_annotation_anndata(subset(adata, rows), str(ann_path), task)
                except KeyError:
                    continue
                valid = label_mask(part.obs[task])
                if valid.any():
                    parts.append(subset(part, valid))
            if not parts:
                _logger.info("no annotated data for task %r / marker %r", task, marker_filter)
                continue
            combined = parts[0] if len(parts) == 1 else AnnDataLite(
                np.concatenate([p.X for p in parts]), concat_frames([p.obs for p in parts]))
            groups = None
            split_groups_by = config.get("split_groups_by")
            if split_groups_by:
                miss = [c for c in split_groups_by if c not in combined.obs]
                if miss:
                    raise ValueError(f"split_groups_by columns missing from obs: {miss}")
                groups = _strings(combined.obs[split_groups_by[0]])
                for col in split_groups_by[1:]:
                    groups = np.asarray([f"{a}::{b}" for a, b in zip(groups, _strings(combined.obs[col]))],
                                        dtype=object)
            try:
                pipeline, metrics, _ = train_linear_classifier_anndata(
                    combined, task, use_scaling=config.get("use_scaling", True), use_pca=config.get("use_pca", False),
                    n_pca_components=config.get("n_pca_components"),
                    classifier_params={"max_iter": config.get("max_iter", 1000),
                                       "class_weight": config.get("class_weight", "balanced"),
                                       "solver": config.get("solver", "liblinear")},
                    split_train_data=config.get("split_train_data", 0.8), random_seed=config.get("random_seed", 42),
                    groups=groups, device=device)
            except ValueError as exc:
                _logger.warning("skipping %s/%s: %s", task, marker_filter, exc)
                continue
            filename = f"{task}_{marker_filter}.npz"
            pipeline.save(pipelines_dir / filename)
            pipeline_manifest.append({"task": task, "marker_filter": marker_filter, "path": filename})
            trained.append((task, str(marker_filter), pipeline))
            all_metrics.append({"task": task, "marker_filter": marker_filter, "n_samples": combined.n_obs, **metrics})
    if not all_metrics:
        _logger.warning("No classifiers trained — check annotations and marker filters.")
        return []
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "metrics_summary.csv").write_text(rows_to_csv(all_metrics))
    manifest = {"trained_at": datetime.now(timezone.utc).isoformat(), "pipelines": pipeline_manifest}
    (pipelines_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    written = [str(output_dir / "metrics_summary.csv"), str(pipelines_dir)]
    if config.get("publish_dir"):
        written.append(str(publish_atomically(Path(config["publish_dir"]), trained, manifest)))
    pdfs = [str(output_dir / f"summary_{t}.pdf") for t in dict.fromkeys(tasks)
            if any(r["task"] == t for r in all_metrics)]
    raise NotImplementedError(PLOTS_REFUSAL.format(written=", ".join(written), pdfs=", ".join(pdfs)))


def publish_atomically(publish_dir: Path, trained: list[tuple], manifest: dict) -> Path:
    """The trained pipelines and the manifest staged in a temporary
    directory, renamed into the next ``v{n}``, and ``latest`` pointed at
    it."""
    publish_dir = Path(publish_dir)
    publish_dir.mkdir(parents=True, exist_ok=True)
    existing = sorted(int(p.name[1:]) for p in publish_dir.iterdir()
                      if p.is_dir() and p.name.startswith("v") and p.name[1:].isdigit())
    final = publish_dir / f"v{(existing[-1] + 1) if existing else 1}"
    with tempfile.TemporaryDirectory(dir=publish_dir) as tmp:
        stage = Path(tmp) / "stage"
        stage.mkdir()
        for task, marker, pipeline in trained:
            pipeline.save(stage / f"{task}_{marker}.npz")
        (stage / "manifest.json").write_text(json.dumps(manifest, indent=2))
        os.replace(stage, final)
    latest = publish_dir / "latest"
    if latest.is_symlink() or latest.exists():
        latest.unlink()
    latest.symlink_to(final.name)
    return final
