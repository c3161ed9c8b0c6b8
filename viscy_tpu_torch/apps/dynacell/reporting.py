"""Benchmark reporting over tidy metric rows, without pandas (counterpart of
``viscy_tpu/apps/dynacell/reporting.py``): per-(channel, metric) summaries,
a model-by-channel table of one metric, and its markdown; and the
comparison tables of :mod:`.eval.tables` under the reference's names.

Rows are dicts with ``channel``, ``metric`` and ``value`` (and ``fov``,
``t``), as :func:`viscy_tpu_torch.apps.dynacell.evaluation.evaluate_plates`
returns them, where JAX passes DataFrames.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from viscy_tpu_torch.apps.dynacell.eval.tables import (  # noqa: F401  (the reference's reporting surface)
    FEATURE_METRICS,
    HIGHER_IS_BETTER,
    MASK_METRICS,
    PIXEL_METRICS,
    Table,
    aggregate_metrics,
    load_and_aggregate,
    load_eval_results,
    mean_std,
    metric_comparison_barplot,
    to_latex,
)

__all__ = ["summarize_metrics", "comparison_table", "to_markdown"]


def _groups(rows: list[dict], keys: tuple[str, ...]) -> dict[tuple, list[float]]:
    """``{key values: [value, ...]}`` in sorted key order, as ``groupby``."""
    out: dict[tuple, list[float]] = {}
    for r in rows:
        out.setdefault(tuple(r[k] for k in keys), []).append(float(r["value"]))
    return dict(sorted(out.items()))


def summarize_metrics(rows: list[dict]) -> list[dict]:
    """Per (channel, metric), sorted: the mean, sample std, median and count
    of the values over FOVs and timepoints (NaN skipped)."""
    out = []
    for (channel, metric), values in _groups(rows, ("channel", "metric")).items():
        mean, std = mean_std(values)
        v = np.asarray(values, np.float64)
        v = v[~np.isnan(v)]
        out.append({"channel": channel, "metric": metric, "mean": mean, "std": std,
                    "median": float(np.median(v)) if v.size else math.nan, "count": int(v.size)})
    return out


def comparison_table(results: dict[str, list[dict]], metric: str = "pearson") -> Table:
    """One metric's mean per model (rows, sorted) and channel (columns,
    sorted); a missing pair is ``None``."""
    table = Table()
    for model, rows in results.items():
        for (channel,), values in _groups([r for r in rows if r["metric"] == metric], ("channel",)).items():
            table.cells[(model, channel)] = mean_std(values)[0]
    table.index = sorted({m for m, _ in table.cells})
    table.columns = sorted({c for _, c in table.cells})
    return table


def to_markdown(table: Table, path: str | Path | None = None, floatfmt: str = ".4f") -> str:
    """A markdown table, the row names first under ``model``, numbers with
    ``floatfmt``."""
    def fmt(v) -> str:
        if v is None:
            v = math.nan
        return f"{v:{floatfmt}}" if isinstance(v, (float, np.floating)) else str(v)

    cols = ["model", *table.columns]
    lines = ["| " + " | ".join(cols) + " |", "|" + "|".join("---" for _ in cols) + "|"]
    for row in table.index:
        lines.append("| " + " | ".join([str(row), *(fmt(table.cell(row, c)) for c in table.columns)]) + " |")
    out = "\n".join(lines)
    if path is not None:
        Path(path).write_text(out)
    return out
