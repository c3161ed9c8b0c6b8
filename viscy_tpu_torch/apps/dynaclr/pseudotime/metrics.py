"""Population aggregation and event-timing metrics of pseudotime signals
(counterpart of ``viscy_tpu/apps/dynaclr/pseudotime/metrics.py``): binned
population curves (fractions with Wilson intervals, or continuous mean /
median / IQR), onset (baseline + N sigma), half-max time, peak and pulse
metrics, per-track timing, and the Fisher / Mann-Whitney tests (scipy), on
:class:`~viscy_tpu_torch.evaluation.anndata_lite.Frame` tables with pandas'
rules for missing values."""

from __future__ import annotations

import logging
import math
from itertools import combinations
from typing import Literal

import numpy as np

from viscy_tpu_torch.apps.dynaclr.pseudotime._tables import dropna, floats, nanmean, nanstd, records
from viscy_tpu_torch.apps.dynaclr.pseudotime.alignment import track_groups

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["aggregate_population", "compute_track_timing", "find_half_max_time", "find_onset_time",
           "find_peak_metrics", "run_statistical_tests", "wilson_interval"]


def wilson_interval(k: int, n: int, alpha: float = 0.05) -> tuple[float, float]:
    """Wilson score interval of a binomial proportion."""
    from scipy.stats import norm

    if n == 0:
        return float("nan"), float("nan")
    z = norm.ppf(1 - alpha / 2)
    p = k / n
    denom = 1 + z**2 / n
    center = (p + z**2 / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z**2 / (4 * n**2)) / denom
    return float(center - half), float(center + half)


def aggregate_population(df, time_bins: np.ndarray, signal_col: str = "signal",
                         signal_type: Literal["fraction", "continuous"] = "fraction", ci_alpha: float = 0.05,
                         min_cells_per_bin: int = 5):
    """Cells binned by ``t_relative_minutes``, the signal aggregated per bin."""
    valid = dropna(df, [signal_col])
    t = floats(valid["t_relative_minutes"])
    signal = floats(valid[signal_col])
    results = []
    for bin_start, bin_end in zip(time_bins[:-1], time_bins[1:]):
        vals = signal[(t >= bin_start) & (t < bin_end)]
        n_total = len(vals)
        if signal_type == "fraction":
            if n_total == 0:
                results.append({"time_minutes": bin_start, "fraction": np.nan, "ci_lower": np.nan, "ci_upper": np.nan,
                                "n_cells": 0, "n_positive": 0})
            else:
                n_pos = int(vals.sum())
                lo, hi = wilson_interval(n_pos, n_total, ci_alpha)
                results.append({"time_minutes": bin_start, "fraction": n_pos / n_total, "ci_lower": lo, "ci_upper": hi,
                                "n_cells": n_total, "n_positive": n_pos})
        elif n_total == 0:
            results.append({"time_minutes": bin_start, "mean": np.nan, "median": np.nan, "std": np.nan, "q25": np.nan,
                            "q75": np.nan, "n_cells": 0})
        else:
            results.append({"time_minutes": bin_start, "mean": float(vals.mean()), "median": float(np.median(vals)),
                            "std": float(vals.std()), "q25": float(np.percentile(vals, 25)),
                            "q75": float(np.percentile(vals, 75)), "n_cells": n_total})
    return records(results)


def _auto_signal_col(population) -> str:
    return "fraction" if "fraction" in population else "mean"


def find_onset_time(population, baseline_window: tuple[float, float] = (-600, -120), sigma_threshold: float = 2.0,
                    min_cells_per_bin: int = 5, signal_col: str | None = None):
    """The first bin at or after the event above baseline + N sigma:
    ``(onset minutes or None, threshold, baseline mean, baseline std)``."""
    signal_col = signal_col or _auto_signal_col(population)
    time, n, sig = floats(population["time_minutes"]), np.asarray(population["n_cells"]), floats(population[signal_col])
    base = (time >= baseline_window[0]) & (time < baseline_window[1]) & (n >= min_cells_per_bin)
    if base.sum() < 3:
        return None, np.nan, np.nan, np.nan
    mean_bl, std_bl = nanmean(sig[base]), nanstd(sig[base])
    threshold = mean_bl + sigma_threshold * std_bl
    onset = np.flatnonzero((time >= 0) & (n >= min_cells_per_bin) & (sig > threshold))
    first = float(time[onset[0]]) if len(onset) else None
    return first, float(threshold), float(mean_bl), float(std_bl)


def find_half_max_time(population, signal_col: str | None = None) -> float:
    """T50: the first time at or after the event above half the response's
    maximum over the baseline."""
    signal_col = signal_col or _auto_signal_col(population)
    time, sig = floats(population["time_minutes"]), floats(population[signal_col])
    post = time >= 0
    if not post.any() or np.isnan(sig[post]).all():
        return float("nan")
    max_val = np.nanmax(sig[post])
    base = time < -60
    baseline_mean = nanmean(sig[base]) if base.any() else 0.0
    half_max = baseline_mean + (max_val - baseline_mean) / 2
    exceeds = np.flatnonzero(post & (sig > half_max))
    return float(time[exceeds[0]]) if len(exceeds) else float("nan")


def find_peak_metrics(population, signal_col: str | None = None) -> dict[str, float]:
    """Peak time and amplitude, return to baseline, pulse duration and the
    area over the baseline, for pulsatile dynamics."""
    signal_col = signal_col or _auto_signal_col(population)
    nan_result = {"T_peak_minutes": np.nan, "peak_amplitude": np.nan, "T_return_minutes": np.nan,
                  "pulse_duration_minutes": np.nan, "auc": np.nan}
    time, sig = floats(population["time_minutes"]), floats(population[signal_col])
    post = np.flatnonzero(time >= 0)
    base = time < -60
    if not len(post) or np.isnan(sig[post]).all():
        return nan_result
    baseline_mean = nanmean(sig[base]) if base.any() else 0.0
    baseline_std = nanstd(sig[base]) if base.any() else 0.0
    peak = post[np.nanargmax(sig[post])]
    t_peak = float(time[peak])
    peak_amp = float(sig[peak] - baseline_mean)
    returns = [i for i in post if time[i] > t_peak and sig[i] < baseline_mean + baseline_std]
    t_return = float(time[returns[0]]) if returns else np.nan
    t_onset = find_onset_time(population, signal_col=signal_col)[0]
    pulse = t_return - t_onset if (t_onset is not None and np.isfinite(t_return)) else np.nan
    valid = post[~np.isnan(sig[post])]
    auc = float(np.trapezoid(sig[valid] - baseline_mean, time[valid])) if len(valid) > 1 else np.nan
    return {"T_peak_minutes": t_peak, "peak_amplitude": peak_amp, "T_return_minutes": t_return,
            "pulse_duration_minutes": pulse, "auc": auc}


def _mode(values: np.ndarray) -> float | None:
    """``Series.mode().iloc[0]``: the smallest of the most frequent values."""
    if not len(values):
        return None
    uniq, counts = np.unique(values, return_counts=True)
    return float(uniq[counts == counts.max()][0])


def compute_track_timing(df, signal_col: str = "signal", signal_type: Literal["fraction", "continuous"] = "fraction",
                         positive_value: float = 1.0):
    """Per track: onset, positive duration and span of the positive signal."""
    valid = dropna(df, [signal_col])
    extra_cols = [c for c in ("experiment", "marker") if c in valid]
    sig, rel = floats(valid[signal_col]), floats(valid["t_relative_minutes"])
    rows = []
    for keys, idx in track_groups(valid, ("fov_name", "track_id", *extra_cols)).items():
        s, r = sig[idx], rel[idx]
        if signal_type == "fraction":
            pos = s == positive_value
        else:
            pre = r < 0
            thr = (nanmean(s[pre]) + 2 * nanstd(s[pre])) if pre.sum() >= 2 else float(np.median(s))
            pos = s > thr
        if not pos.any():
            continue
        diffs = np.diff(r)
        mode = _mode(diffs[~np.isnan(diffs)])
        interval = mode if mode is not None else 30.0
        rows.append({"fov_name": keys[0], "track_id": keys[1], "onset_minutes": float(r[pos].min()),
                     "total_positive_minutes": int(pos.sum()) * interval,
                     "span_minutes": float(r[pos].max() - r[pos].min() + interval),
                     "n_positive_frames": int(pos.sum()), "n_total_frames": len(idx),
                     **dict(zip(extra_cols, keys[2:]))})
    return records(rows)


def run_statistical_tests(organelle_results: dict[str, dict], track_timing_df,
                          control_results: dict[str, dict] | None = None):
    """Fisher's exact test of remodeling against infection (with controls)
    and pairwise Mann-Whitney onset and duration tests between markers."""
    from scipy.stats import fisher_exact, mannwhitneyu

    rows = []
    if control_results:
        for organelle, res in organelle_results.items():
            ctrl = control_results.get(organelle)
            if not ctrl:
                continue
            table = np.array([[res.get("n_positive", 0), res.get("n_cells", 0) - res.get("n_positive", 0)],
                              [ctrl.get("n_positive", 0), ctrl.get("n_cells", 0) - ctrl.get("n_positive", 0)]])
            if (table >= 0).all() and table.sum() > 0:
                odds, p = fisher_exact(table)
                rows.append({"test": "fisher_remodel_vs_infection", "organelle": organelle, "statistic": float(odds),
                             "p_value": float(p)})
    if len(track_timing_df) and "marker" in track_timing_df:
        marker = np.asarray(track_timing_df["marker"])
        for m1, m2 in combinations(sorted(set(marker.tolist())), 2):
            for col, test in (("onset_minutes", "mannwhitney_onset"),
                              ("total_positive_minutes", "mannwhitney_duration")):
                values = floats(track_timing_df[col])
                va, vb = values[marker == m1], values[marker == m2]
                va, vb = va[~np.isnan(va)], vb[~np.isnan(vb)]
                if len(va) >= 3 and len(vb) >= 3:
                    stat, p = mannwhitneyu(va, vb)
                    rows.append({"test": test, "organelle": f"{m1}_vs_{m2}", "statistic": float(stat),
                                 "p_value": float(p)})
    return records(rows)
