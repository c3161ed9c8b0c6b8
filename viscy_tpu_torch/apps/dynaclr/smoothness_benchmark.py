"""The temporal-smoothness benchmark of embedding models (counterpart of
``viscy_tpu/apps/dynaclr/smoothness_benchmark.py``; reference
``dynaclr/evaluation/benchmarking/smoothness``).

Config-driven: per model, the store's smoothness statistics on
``device`` (:mod:`viscy_tpu_torch.evaluation.smoothness`),
optionally per ``group_by`` value with the groups' mean and sample
standard deviation, written as the CSVs (and ``.npy`` distributions) JAX
writes, in the text pandas writes; and a comparison table of saved result
CSVs. The configs validate without pydantic (``ValueError`` naming the
model and the field).

Departure from JAX (``ROADMAP.md`` Queue 3): ``save_plots`` defaults to
``False`` and ``save_plots: true`` is refused by name before any work
(the histograms need matplotlib, which the card's machine lacks;
``ROADMAP.md`` Queue 1 item 9). A model whose store fails raises (JAX logs
it and leaves it out).
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Any

import numpy as np

from viscy_tpu_torch.apps.airtable_utils.schemas import (
    REQUIRED,
    Model,
    as_bool,
    as_int,
    as_str,
    list_of,
    literal,
    model,
    non_empty,
    optional,
)
from viscy_tpu_torch.evaluation.smoothness import compute_embeddings_smoothness
from viscy_tpu_torch.training.cli_utils import csv_text

_logger = logging.getLogger(__name__)

__all__ = [
    "ModelEntry",
    "SmoothnessEvalConfig",
    "ResultFileEntry",
    "CompareModelsConfig",
    "refuse_plots",
    "validate_embedding_index",
    "save_results",
    "format_comparison_summary",
    "evaluate_smoothness",
    "compare_result_files",
    "pipe_table",
]

PLOT_REFUSAL = ("save_plots: true is refused by viscy_tpu_torch: the {what} need matplotlib, which the card's machine "
                "lacks (ROADMAP.md Queue 1 item 9); set save_plots: false")


def refuse_plots(config, what: str) -> None:
    """Raise before any work when a config asks for figures."""
    if config.save_plots:
        raise NotImplementedError(PLOT_REFUSAL.format(what=what))


class ModelEntry(Model):
    fields = (("path", as_str, REQUIRED), ("label", as_str, REQUIRED))


class SmoothnessEvalConfig(Model):
    """``evaluate-smoothness``'s config (JAX's fields and defaults, but
    ``save_plots``)."""

    fields = (
        ("models", non_empty(list_of(model(ModelEntry))), REQUIRED),
        ("distance_metric", literal("cosine", "euclidean"), "cosine"),
        ("time_offsets", list_of(as_int), lambda: [1]),
        ("output_dir", as_str, REQUIRED),
        ("save_plots", as_bool, False),
        ("save_distributions", as_bool, False),
        ("use_optimized", as_bool, True),  # accepted for config compatibility
        ("verbose", as_bool, False),
        ("group_by", optional(as_str), "marker"),
    )


class ResultFileEntry(Model):
    fields = (("path", as_str, REQUIRED), ("label", as_str, REQUIRED))


class CompareModelsConfig(Model):
    """``compare-models -c``'s config."""

    fields = (
        ("result_files", non_empty(list_of(model(ResultFileEntry))), REQUIRED),
        ("metrics", list_of(as_str),
         lambda: ["smoothness_score", "dynamic_range", "adjacent_frame_mean", "random_frame_mean"]),
        ("output_path", optional(as_str), None),
        ("output_format", literal("markdown", "csv", "json"), "markdown"),
    )


def validate_embedding_index(index) -> None:
    """The store's index must have ``fov_name``, ``track_id`` and ``t`` and
    at least one row."""
    names = list(index.names)
    missing = [c for c in ("fov_name", "track_id", "t") if c not in names]
    if missing:
        raise ValueError(f"Embedding missing required metadata columns: {missing}. Available columns: {names}")
    if len(index) == 0:
        raise ValueError("Embedding has no samples")


def save_results(results: dict[str, Any], output_path: Path, format: str = "csv") -> None:
    """A stats dict as a one-row CSV (or JSON)."""
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if format == "csv":
        output_path.write_text(csv_text(list(results), [list(results.values())]))
    else:
        output_path.write_text(json.dumps(results, indent=2, default=float))


def format_comparison_summary(all_results: dict[str, dict], metric: str, lower_is_better: bool) -> str:
    """The 'best model by <metric>' line."""
    vals = {label: res.get(metric) for label, res in all_results.items()
            if res.get(metric) is not None and np.isfinite(res.get(metric))}
    if not vals:
        return f"- {metric}: no valid results"
    pick = min(vals, key=vals.get) if lower_is_better else max(vals, key=vals.get)
    direction = "lowest" if lower_is_better else "highest"
    return f"- Best {metric} ({direction}): **{pick}** ({vals[pick]:.4f})"


def _mean_std(values: list) -> tuple[float, float]:
    """pandas' column ``mean`` and ``std`` (ddof 1) as ``nanops`` computes
    them: NaN cells as 0 in the (pairwise) sums, divided by the count of
    the others."""
    x = np.asarray(values, dtype=np.float64)
    mask = np.isnan(x)
    count = int((~mask).sum())
    if count == 0:
        return math.nan, math.nan
    vals = np.where(mask, 0.0, x)
    avg = vals.sum() / count
    sqr = np.where(mask, 0.0, (avg - vals) ** 2)
    return float(avg), math.sqrt(sqr.sum() / (count - 1)) if count > 1 else math.nan


def _group_rows(values: np.ndarray) -> list[tuple[Any, np.ndarray]]:
    """``groupby(sort=False)``: each value's rows, in order of first
    appearance."""
    keys = [str(v) if isinstance(v, str) else v for v in np.asarray(values).tolist()]
    groups: dict[Any, list[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return [(k, np.asarray(rows)) for k, rows in groups.items()]


def evaluate_smoothness(config: SmoothnessEvalConfig, device: str = "cuda") -> dict[str, dict]:
    """Each model's smoothness statistics ``{label: stats}``, the per-group
    CSV (with ``group_by``), the stats CSV, the distributions (with
    ``save_distributions``) and ``combined_smoothness_stats.csv``."""
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    refuse_plots(config, "smoothness histograms")
    output_dir = Path(config.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    all_results: dict[str, dict] = {}
    for i, entry in enumerate(config.models, 1):
        label, experiment = entry.label, Path(entry.path).stem
        _logger.info(f"Processing {i}/{len(config.models)}: {label}")
        ds = read_embedding_dataset(entry.path)
        features = np.asarray(ds["features"])
        index = ds["index"].reset_index()
        validate_embedding_index(index)
        group_col = config.group_by
        if group_col and group_col in index:
            per_group = []
            dists = []
            for group_val, rows in _group_rows(index[group_col]):
                g_stats, g_dists = compute_embeddings_smoothness(features[rows], index.take(rows).reset_index(),
                                                                 distance_metric=config.distance_metric,
                                                                 return_distributions=True, device=device)
                per_group.append((group_val, g_stats))
                dists.append(g_dists)
            metric_cols = list(dict.fromkeys(k for _, s in per_group for k in s))
            header = ["experiment", group_col, *metric_cols]
            (output_dir / f"{label}_{experiment}_per_{group_col}_smoothness.csv").write_text(
                csv_text(header, [[experiment, g, *(s.get(k, math.nan) for k in metric_cols)] for g, s in per_group]))
            moments = {k: _mean_std([s.get(k, math.nan) for _, s in per_group]) for k in metric_cols}
            stats = {k: m for k, (m, _) in moments.items()}
            stats.update({f"{k}_std": s for k, (_, s) in moments.items()})
            distributions = {key: np.concatenate([np.asarray(d[key]) for d in dists])
                             for key in ("adjacent_frame_distribution", "random_frame_distribution")}
        else:
            stats, distributions = compute_embeddings_smoothness(features, index,
                                                                 distance_metric=config.distance_metric,
                                                                 return_distributions=True, device=device)
        all_results[label] = stats
        save_results(stats, output_dir / f"{label}_{experiment}_smoothness_stats.csv")
        if config.save_distributions:
            for key, suffix in (("adjacent_frame_distribution", "adjacent"), ("random_frame_distribution", "random")):
                np.save(output_dir / f"{label}_{experiment}_{suffix}_distribution.npy", distributions[key])
    if all_results:
        columns = list(dict.fromkeys(k for s in all_results.values() for k in s))
        # pd.DataFrame(all_results).T: every cell a float64
        rows = [[label, *(float(s.get(k, math.nan)) for k in columns)] for label, s in all_results.items()]
        (output_dir / "combined_smoothness_stats.csv").write_text(csv_text(["model", *columns], rows))
    return all_results


def _read_first_row(path: Path) -> dict:
    """The first row of a CSV, numbers as numbers (``pd.read_csv``'s
    inference: a column of integers as ``int``, other numbers as
    ``float``, an empty cell NaN)."""
    from viscy_tpu_torch.apps.dynacell.eval.tables import read_csv_columns

    cols = read_csv_columns(path)
    if not cols or not next(iter(cols.values())):
        return {}
    row = {}
    for name, cells in cols.items():
        try:
            nums = [math.nan if c == "" else float(c) for c in cells]
        except ValueError:
            row[name] = cells[0]
            continue
        is_int = all(c != "" and c.lstrip("-").isdigit() for c in cells)
        row[name] = int(cells[0]) if is_int else nums[0]
    return row


def _g(value) -> str:
    return format(float(value), "g")


def _afterpoint(s: str) -> int:
    """tabulate's digits after the decimal point (-1: none)."""
    if s.lstrip("-").isdigit() or s in ("nan", "inf", "-inf"):
        return -1
    pos = s.rfind(".")
    pos = s.lower().rfind("e") if pos < 0 else pos
    return len(s) - pos - 1 if pos >= 0 else -1


def pipe_table(index_name: str, labels: list[str], columns: list[str], rows: list[list[float]]) -> str:
    """``DataFrame.to_markdown()`` of a table of floats with a string index:
    tabulate's ``pipe`` format, numbers as ``format(v, "g")`` aligned on
    their decimal points and flushed right."""
    width = max([len(index_name) + 2] + [len(s) for s in labels])
    built = [([index_name.ljust(width)] + [s.ljust(width) for s in labels], ":" + "-" * (width + 1))]
    for j, name in enumerate(columns):
        cells = [_g(r[j]) for r in rows]
        pad = max(_afterpoint(c) for c in cells)
        cells = [c + " " * (pad - _afterpoint(c)) for c in cells]
        width = max([len(name) + 2] + [len(c) for c in cells])
        built.append(([s.rjust(width) for s in [name, *cells]], "-" * (width + 1) + ":"))
    lines = ["| " + " | ".join(col[0] for col, _ in built) + " |", "|" + "|".join(sep for _, sep in built) + "|"]
    lines += ["| " + " | ".join(col[i] for col, _ in built) + " |" for i in range(1, len(labels) + 1)]
    return "\n".join(lines)


def compare_result_files(config: CompareModelsConfig) -> tuple[list[str], list[str], list[list[float]]]:
    """The comparison of saved result CSVs: ``(labels, metrics, rows)`` of
    the metrics asked that the files have, written to ``output_path`` as
    markdown, CSV or JSON. A missing or empty file is skipped with a
    warning, as in JAX."""
    results: dict[str, dict] = {}
    for entry in config.result_files:
        path = Path(entry.path)
        if not path.exists():
            _logger.warning(f"Result file not found: {path}")
            continue
        row = _read_first_row(path)
        if row:
            results[entry.label] = row
        else:
            _logger.warning(f"Empty result file: {path}")
    if not results:
        return [], [], []
    present = list(dict.fromkeys(k for r in results.values() for k in r))
    keep = [m for m in config.metrics if m in present]
    labels = list(results)
    rows = [[float(results[lab].get(m, math.nan)) for m in keep] for lab in labels]
    if config.output_path:
        out = Path(config.output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        if config.output_format == "csv":
            out.write_text(csv_text(["model", *keep], [[lab, *r] for lab, r in zip(labels, rows)]))
        elif config.output_format == "json":
            out.write_text(json.dumps({lab: dict(zip(keep, [None if math.isnan(v) else v for v in r]))
                                       for lab, r in zip(labels, rows)}, indent=2))
        else:
            out.write_text(pipe_table("model", labels, keep, rows))
    return labels, keep, rows
