"""pandas' missing-value and reduction rules on numpy columns, for the
pseudotime modules' :class:`~viscy_tpu_torch.evaluation.anndata_lite.Frame`
tables: NaN, None and an empty CSV cell (which ``pd.read_csv`` reads as NaN)
are missing; ``mean`` / ``std`` (ddof 1) / ``median`` / ``max`` skip them."""

from __future__ import annotations

import math

import numpy as np

from viscy_tpu_torch.evaluation.anndata_lite import Frame


def missing(values) -> np.ndarray:
    """``Series.isna()``, with an empty string counted as missing."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype.kind in "iub":
        return np.zeros(len(values), bool)
    return np.asarray([v is None or v == "" or (isinstance(v, float) and math.isnan(v)) for v in values.tolist()],
                      bool)


def floats(values) -> np.ndarray:
    """A numeric column as float64, missing cells NaN."""
    values = np.asarray(values)
    if values.dtype.kind in "fiub":
        return values.astype(np.float64)
    miss = missing(values)
    return np.asarray([math.nan if m else float(v) for v, m in zip(values.tolist(), miss)], np.float64)


def nanmean(v) -> float:
    v = np.asarray(v, np.float64)
    v = v[~np.isnan(v)]
    return float(v.mean()) if len(v) else math.nan


def nanstd(v) -> float:
    v = np.asarray(v, np.float64)
    v = v[~np.isnan(v)]
    return float(v.std(ddof=1)) if len(v) > 1 else math.nan


def dropna(df: Frame, columns: list[str]) -> Frame:
    """The rows with every column of ``columns`` present."""
    keep = np.ones(len(df), bool)
    for c in columns:
        keep &= ~missing(df[c])
    return df.take(keep)


def copy(df: Frame) -> Frame:
    return Frame(dict(df.columns), index=df.index)


def records(rows: list[dict]) -> Frame:
    """``pd.DataFrame(rows)``: the keys of the first row in order (every row
    has them), numbers as float64 unless every value is an int."""
    if not rows:
        return Frame()
    out = {}
    for k in rows[0]:
        vals = [r[k] for r in rows]
        if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in vals):
            out[k] = np.asarray(vals, np.int64)
        elif all(isinstance(v, (int, float, np.integer, np.floating)) or v is None for v in vals):
            out[k] = np.asarray([math.nan if v is None else float(v) for v in vals], np.float64)
        else:
            out[k] = np.asarray(vals, dtype=object)
    return Frame(out)
