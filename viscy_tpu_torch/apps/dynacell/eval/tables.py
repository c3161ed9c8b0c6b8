"""Benchmark comparison tables from the evaluation's CSVs, without pandas
(counterpart of ``viscy_tpu/apps/dynacell/eval/tables.py``; reference
``dynacell/reporting/tables.py``).

Each model's tier CSVs (``pixel_metrics.csv``, ``mask_metrics.csv``, and
``feature_metrics.csv`` where read) are joined on (FOV, Timepoint), each
metric reduced to its mean and sample standard deviation over the rows
that have it (NaN skipped), and the models rendered as a :class:`Table` of
``"mean +/- std"`` cells: :func:`to_markdown`, :func:`to_latex` and
:meth:`Table.to_csv` give the text JAX's pandas code gives (a missing
cell is ``nan`` in markdown, ``NaN`` in LaTeX and empty in the CSV). The
card's machine has no pandas.

``metric_comparison_barplot`` needs matplotlib, which the card's machine
lacks: it raises by name (``ROADMAP.md`` Queue 1 item 9).
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = [
    "PIXEL_METRICS",
    "MASK_METRICS",
    "FEATURE_METRICS",
    "HIGHER_IS_BETTER",
    "Table",
    "read_csv_columns",
    "load_eval_results",
    "mean_std",
    "aggregate_metrics",
    "load_and_aggregate",
    "comparison_table",
    "to_markdown",
    "to_latex",
    "metric_comparison_barplot",
]

PIXEL_METRICS = ["PCC", "SSIM", "NRMSE", "PSNR", "Spectral_PCC", "Multiband_EV_NC"]
MASK_METRICS = ["Dice", "IoU", "Precision", "Recall", "mAP", "instance_dice"]
FEATURE_METRICS = [
    "CP_Median_Cosine_Similarity",
    "DINOv3_Median_Cosine_Similarity",
    "DynaCLR_Median_Cosine_Similarity",
    "CP_FID",
    "DINOv3_FID",
    "DynaCLR_FID",
]

HIGHER_IS_BETTER = {
    "PCC", "SSIM", "PSNR", "Spectral_PCC", "Multiband_EV_NC", "Dice", "IoU", "Precision", "Recall", "Accuracy",
    "mAP", "instance_dice", "CP_Median_Cosine_Similarity", "DINOv3_Median_Cosine_Similarity",
    "DynaCLR_Median_Cosine_Similarity",
}

_KEYS = ("FOV", "Timepoint")
BARPLOT_REFUSAL = ("metric_comparison_barplot (the report's barplot) is not ported to viscy_tpu_torch: it needs "
                   "matplotlib, which the card's machine lacks, and waits for a plotting decision "
                   "(ROADMAP.md Queue 1 item 9)")


@dataclass
class Table:
    """Rows named by ``index``, cells by ``(row, column)``; ``None`` is a
    missing cell."""

    index: list[str] = field(default_factory=list)
    columns: list[str] = field(default_factory=list)
    cells: dict[tuple[str, str], str | None] = field(default_factory=dict)

    def cell(self, row: str, col: str) -> str | None:
        return self.cells.get((row, col))

    def copy(self) -> "Table":
        return Table(list(self.index), list(self.columns), dict(self.cells))

    def to_csv(self, path: str | Path | None = None) -> str:
        """``DataFrame.to_csv`` of the table: the index first, its header
        empty; a missing cell empty."""
        lines = [",".join(["", *map(_quote, self.columns)]) if self.columns else '""']
        for row in self.index:
            lines.append(",".join([_quote(row), *(_quote(self.cell(row, c) or "") for c in self.columns)]))
        text = "\n".join(lines) + "\n"
        if path is not None:
            Path(path).write_text(text)
        return text


def _quote(s: str) -> str:
    """A CSV field as the csv module's minimal quoting writes it."""
    return f'"{s.replace(chr(34), chr(34) * 2)}"' if any(ch in s for ch in ',"\n\r') else s


def _float(cell: str) -> float:
    """A CSV cell as a number: empty is NaN; a cell that is no number raises
    (a metric column holds numbers)."""
    return math.nan if cell == "" else float(cell)


def read_csv_columns(path: str | Path) -> dict[str, list[str]]:
    """A CSV file as ``{column: [cell, ...]}`` in the header's order."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        cols: dict[str, list[str]] = {h: [] for h in header}
        for line in reader:
            for h, v in zip(header, line):
                cols[h].append(v)
    return cols


def load_eval_results(results_dir: Path, pixel_csv: str = "pixel_metrics.csv", mask_csv: str = "mask_metrics.csv",
                      feature_csv: str = "feature_metrics.csv") -> dict[str, dict[str, list[str]]]:
    """The tier CSVs that exist under ``results_dir``, each as columns."""
    results_dir = Path(results_dir)
    out = {}
    for key, filename in (("pixel", pixel_csv), ("mask", mask_csv), ("feature", feature_csv)):
        path = results_dir / filename
        if path.exists():
            out[key] = read_csv_columns(path)
    return out


def mean_std(values) -> tuple[float, float]:
    """pandas' ``mean`` and ``std`` of numbers: NaN skipped, the sample
    (n - 1) standard deviation, NaN below two values."""
    v = np.asarray(values, np.float64)
    v = v[~np.isnan(v)]
    mean = float(v.sum() / v.size) if v.size else math.nan
    std = float(np.sqrt(((v - mean) ** 2).sum() / (v.size - 1))) if v.size > 1 else math.nan
    return mean, std


def aggregate_metrics(columns: dict[str, list], metrics: list[str] | None = None) -> dict[str, tuple[float, float]]:
    """``{metric: (mean, std)}`` over a tier's rows (:func:`mean_std`)."""
    if metrics is None:
        metrics = [c for c in columns if c not in _KEYS]
    return {m: mean_std([_float(c) if isinstance(c, str) else float(c) for c in columns[m]]) for m in metrics}


def load_and_aggregate(results_dir: Path, metrics: list[str], pixel_csv: str = "pixel_metrics.csv",
                       mask_csv: str = "mask_metrics.csv") -> tuple[dict[str, tuple[float, float]], list[str]]:
    """The tier CSVs joined on (FOV, Timepoint) and reduced to ``{metric:
    (mean, std)}``, with the metric names available. The join is one to one
    (a repeated key raises) and outer (a metric's rows are its own tier's);
    a column two merged tiers share is suffixed ``_x`` / ``_y``, as pandas'
    merge suffixes it."""
    data = load_eval_results(Path(results_dir), pixel_csv=pixel_csv, mask_csv=mask_csv)
    if not data:
        return {}, []
    if len(data) > 1:
        for label, cols in data.items():
            missing = [k for k in _KEYS if k not in cols]
            if missing:
                raise ValueError(f"{results_dir}/{label}: missing key columns {missing}; "
                                 "cannot merge CSVs without FOV and Timepoint.")
            keys = list(zip(*(cols[k] for k in _KEYS)))
            if len(set(keys)) != len(keys):
                raise ValueError(f"{results_dir}/{label}: repeated (FOV, Timepoint) keys: the merge is one to one")
    tiers = [{c: v for c, v in cols.items() if c not in _KEYS} for cols in data.values()]
    merged = tiers[0]
    for cols in tiers[1:]:  # pandas' merge: a column both sides have becomes <c>_x and <c>_y
        shared = set(merged) & set(cols)
        merged = {**{f"{c}_x" if c in shared else c: v for c, v in merged.items()},
                  **{f"{c}_y" if c in shared else c: v for c, v in cols.items()}}
    available = [m for m in metrics if m in merged]
    return aggregate_metrics(merged, available), available


def comparison_table(model_results: dict[str, Path], metrics: list[str] | None = None,
                     pixel_csv: str = "pixel_metrics.csv", mask_csv: str = "mask_metrics.csv") -> Table:
    """Models as rows, ``"mean +/- std"`` cells (four decimals); columns in
    the order the models first have them; a model without any of
    ``metrics`` has no row."""
    if metrics is None:
        metrics = PIXEL_METRICS + MASK_METRICS
    table = Table()
    for model_name, results_dir in model_results.items():
        agg, available = load_and_aggregate(results_dir, metrics, pixel_csv=pixel_csv, mask_csv=mask_csv)
        if available:  # a model with no metric has no row, as in pandas' from_dict
            table.index.append(model_name)
        for m in available:
            if m not in table.columns:
                table.columns.append(m)
            mean, std = agg[m]
            table.cells[(model_name, m)] = f"{mean:.4f} +/- {std:.4f}"
    return table


def _best_index(table: Table, col: str) -> int | None:
    vals: list[float | None] = []
    for row in table.index:
        try:
            v = float(str(table.cell(row, col) or "nan").split(" +/- ")[0])
            vals.append(v if np.isfinite(v) else None)
        except ValueError:
            vals.append(None)
    if all(v is None for v in vals):
        return None
    sign = 1.0 if col in HIGHER_IS_BETTER else -1.0
    numeric = [sign * v if v is not None else float("-inf") for v in vals]
    return max(range(len(numeric)), key=lambda i: numeric[i])


def _bolded(table: Table, bold_best: bool, fmt: str) -> Table:
    out = table.copy()
    if bold_best and len(out.index) > 1:
        for col in out.columns:
            idx = _best_index(out, col)
            if idx is not None:
                row = out.index[idx]
                out.cells[(row, col)] = fmt.format(out.cell(row, col))
    return out


def to_markdown(table: Table, bold_best: bool = True) -> str:
    """GitHub markdown, the best cell of each column in bold."""
    out = _bolded(table, bold_best, "**{}**")
    lines = ["| model | " + " | ".join(out.columns) + " |", "|" + "---|" * (len(out.columns) + 1)]
    for row in out.index:
        cells = [str(out.cell(row, c)) if out.cell(row, c) is not None else "nan" for c in out.columns]
        lines.append("| " + " | ".join([str(row), *cells]) + " |")
    return "\n".join(lines)


def to_latex(table: Table, bold_best: bool = True, caption: str | None = None, label: str | None = None) -> str:
    r"""A booktabs ``tabular`` (``DataFrame.to_latex(escape=False)``'s text),
    ``\textbf`` on the best cell of each column; in a ``table`` with a
    ``caption`` or ``label``."""
    out = _bolded(table, bold_best, "\\textbf{{{}}}")
    lines = ["\\begin{tabular}{" + "l" * (len(out.columns) + 1) + "}", "\\toprule"]
    if out.columns:
        lines.append(" & " + " & ".join(out.columns) + " \\\\")
    lines.append("\\midrule")
    for row in out.index:
        cells = [out.cell(row, c) if out.cell(row, c) is not None else "NaN" for c in out.columns]
        lines.append(" & ".join([str(row), *cells]) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    body = "\n".join(lines)
    if caption or label:
        wrapped = ["\\begin{table}[ht]", "\\centering"]
        if caption:
            wrapped.append(f"\\caption{{{caption}}}")
        if label:
            wrapped.append(f"\\label{{{label}}}")
        wrapped.extend([body, "\\end{table}"])
        return "\n".join(wrapped)
    return body


def metric_comparison_barplot(model_results: dict, metrics: list[str] | None = None, save_path=None,
                              pixel_csv: str = "pixel_metrics.csv", mask_csv: str = "mask_metrics.csv"):
    """The grouped bar chart of JAX's report: refused by name (it needs
    matplotlib)."""
    raise NotImplementedError(BARPLOT_REFUSAL)
