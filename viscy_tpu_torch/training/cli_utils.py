"""CLI formatting and config-section loading (counterpart of
``viscy_tpu/training/cli_utils.py``; reference ``viscy_utils/cli_utils.py``).

:func:`format_markdown_table` writes the text JAX writes, character for
character; :func:`load_config` composes ``base:`` recipes through the
port's :mod:`~viscy_tpu_torch.training.compose`. :func:`csv_text` and
:func:`rows_to_csv` write the text ``DataFrame.to_csv(index=False)``
writes, for the subcommands whose JAX versions write CSVs with pandas
(the card's machine has none).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from viscy_tpu_torch.training.compose import load_composed_config

__all__ = ["format_markdown_table", "load_config", "load_config_section", "to_numpy", "csv_quote", "csv_cell",
           "csv_text", "rows_to_csv"]


def _fmt(value) -> str:
    return f"{value:.3f}" if isinstance(value, float) else str(value)


def format_markdown_table(data: dict | list[dict], title: str | None = None, headers: list[str] | None = None) -> str:
    """A dict as a two-column key / value table, or a list of dicts as one
    row each; floats to three decimals, keys title-cased with ``_`` as a
    space."""
    lines: list[str] = []
    if title:
        lines += [f"## {title}", ""]
    if isinstance(data, dict):
        headers = headers or ["Metric", "Value"]
        lines.append(f"| {' | '.join(headers)} |")
        lines.append("|" + "|".join("---" + "-" * len(h) for h in headers) + "|")
        for key, value in data.items():
            lines.append(f"| {str(key).replace('_', ' ').title()} | {_fmt(value)} |")
    elif isinstance(data, list) and data and isinstance(data[0], dict):
        headers = headers or list(data[0].keys())
        titles = [str(h).replace("_", " ").title() for h in headers]
        lines.append(f"| {' | '.join(titles)} |")
        lines.append("|" + "|".join("---" + "-" * len(t) for t in titles) + "|")
        for row in data:
            lines.append("| " + " | ".join(_fmt(row.get(k, "")) for k in headers) + " |")
    lines.append("")
    return "\n".join(lines)


def load_config(config_path: str | Path) -> dict:
    """A YAML config with its ``base:`` recipes composed."""
    return load_composed_config(Path(config_path))


def load_config_section(config_path: str | Path, section: str | None, default_section: str | None = None) -> dict:
    """``config[section]`` with the root's other keys merged in where the
    section lacks them (one YAML serving several steps); the whole config
    when neither ``section`` nor a present ``default_section`` is given."""
    cfg = load_config(config_path)
    if section is None:
        if default_section is None or default_section not in cfg:
            return cfg
        section = default_section
    if section not in cfg:
        raise KeyError(f"Config section not found: {section}")
    section_cfg = cfg[section] or {}
    if not isinstance(section_cfg, dict):
        raise TypeError(f"Config section must be a mapping: {section}")
    merged = dict(section_cfg)
    for k, v in cfg.items():
        if k != section:
            merged.setdefault(k, v)
    return merged


def to_numpy(x) -> np.ndarray:
    """An array-like (a torch tensor on any device, numpy, a list) as numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def csv_quote(s: str) -> str:
    """A CSV field as the csv module's minimal quoting writes it."""
    return f'"{s.replace(chr(34), chr(34) * 2)}"' if any(ch in s for ch in ',"\n\r') else s


def csv_cell(value) -> str:
    """A value as ``DataFrame.to_csv`` writes it: an integer or bool as
    is, a float as its shortest ``repr``, NaN and ``None`` empty, a string
    minimally quoted."""
    if value is None:
        return ""
    if isinstance(value, str):
        return csv_quote(value)
    if isinstance(value, (bool, np.bool_, int, np.integer)):
        return str(value)
    value = float(value)
    return "" if math.isnan(value) else repr(value)


def csv_text(header: list, rows: list[list]) -> str:
    """A CSV of ``header`` and ``rows`` (lists of cells)."""
    return "\n".join([",".join(map(csv_cell, header))] + [",".join(map(csv_cell, r)) for r in rows]) + "\n"


def rows_to_csv(rows: list[dict]) -> str:
    """``pd.DataFrame(rows).to_csv(index=False)``: the keys in order of first
    appearance, a missing cell empty."""
    columns = list(dict.fromkeys(k for r in rows for k in r))
    return csv_text(columns, [[r.get(c) for c in columns] for r in rows])
