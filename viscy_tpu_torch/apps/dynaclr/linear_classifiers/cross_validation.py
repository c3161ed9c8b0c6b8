"""Rotating test-set cross-validation for training-dataset impact analysis
(counterpart of ``viscy_tpu/apps/dynaclr/linear_classifiers/cross_validation.py``).

Each dataset in turn is the test set; the probe trains on the rest of the
pool (the baseline) and on every leave-one-out subset of it, over
``n_bootstrap`` seeds, on the device. Paired within-fold deltas against the
baseline label each dataset's impact (helps / hurts / uncertain / unsafe).
Writes ``cv_results.csv``, ``cv_summary.csv`` and
``cv_recommended_subsets.csv`` with JAX's columns and row order, without
pandas.

Departures from JAX (ROADMAP.md Queue 3):

- JAX catches every exception of a fold into its row's ``error`` column.
  The port keeps such a row only for the ``ValueError`` messages the
  training raises by design (too few classes; ``liblinear``, the default
  solver, with three or more classes); anything else (a missing store, an
  unreadable CSV) raises.
- With ``n_workers > 1`` JAX's rows come back in completion order; the
  port keeps the order of submission.
- ``report: true`` (``--report``, JAX's ``report.py``: a PDF) is refused
  by name before any work: it needs matplotlib, which the card's machine
  lacks (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import json
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np

from viscy_tpu_torch.apps.dynaclr.linear_classifiers.utils import (find_channel_zarrs, get_available_tasks,
                                                                   resolve_task_channels)

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["REPORT_REFUSAL", "compute_summary", "cross_validate", "get_recommended_subsets"]

REPORT_REFUSAL = ("cross-validate-datasets --report (report: true) is refused by viscy_tpu_torch: the report is a PDF "
                  "drawn with matplotlib, which the card's machine lacks (ROADMAP.md Queue 1 item 9)")


def _build_cv_pairs(datasets: list[dict], channel: str, task: str) -> list[tuple[dict, dict]]:
    """(dataset spec, training dict) for each dataset with the channel's
    store and the task's column."""
    result = []
    for ds in datasets:
        channel_zarrs = find_channel_zarrs(Path(ds["embeddings_dir"]), [channel])
        if channel not in channel_zarrs or task not in get_available_tasks(Path(ds["annotations"])):
            continue
        training = {"embeddings": str(channel_zarrs[channel]), "annotations": str(ds["annotations"])}
        if "include_wells" in ds:
            training["include_wells"] = ds["include_wells"]
        result.append((ds, training))
    return result


def _get_class_counts(datasets: list[dict], task: str, cache: dict | None = None) -> dict[str, int]:
    from viscy_tpu_torch.evaluation.linear_classifier import load_and_combine_datasets, value_counts

    try:
        combined = load_and_combine_datasets(datasets, task, cache)
    except ValueError:
        return {}
    return value_counts(combined.obs[task].tolist())


def _check_class_safety(datasets: list[dict], task: str, min_class_samples: int, cache: dict | None = None) -> bool:
    counts = _get_class_counts(datasets, task, cache)
    return bool(counts) and min(counts.values()) >= min_class_samples


def _compute_temporal_metrics(row: dict, t: np.ndarray | None, y_true: np.ndarray, y_pred: np.ndarray,
                              y_proba: np.ndarray, classes, n_bins: int = 10) -> None:
    """AUROC and macro F1 in each of ``n_bins`` bins of normalized ``t``,
    as JSON in ``row["temporal_metrics"]``."""
    from viscy_tpu_torch.evaluation.linear_classifier import classification_report, roc_auc

    if t is None or len(np.unique(t)) < 2:
        row["temporal_metrics"] = None
        return
    t = np.asarray(t, float)
    t_norm = (t - t.min()) / (t.max() - t.min())
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    bins = np.clip(np.digitize(t_norm, edges[1:-1]), 0, n_bins - 1)
    aurocs, f1s, ns = [], [], []
    for b in range(n_bins):
        sel = bins == b
        ns.append(int(sel.sum()))
        if not sel.any():
            aurocs.append(None)
            f1s.append(None)
            continue
        f1s.append(classification_report(y_true[sel], y_pred[sel])["macro avg"]["f1-score"])
        if len(np.unique(y_true[sel])) < 2:
            aurocs.append(None)
            continue
        try:
            aurocs.append(roc_auc(y_true[sel], y_proba[sel][:, 1] if len(classes) == 2 else y_proba[sel]))
        except ValueError:
            aurocs.append(None)
    row["temporal_metrics"] = json.dumps({"bin_edges": edges.tolist(), "auroc": aurocs, "f1_macro": f1s,
                                          "n_samples": ns})


def _train_and_evaluate(config: dict, model_label: str, task: str, channel: str, train_datasets: list[dict],
                        test_dataset: dict, test_dataset_name: str, seed: int, excluded_dataset: str | None = None,
                        device: str = "cuda", cache: dict | None = None) -> dict[str, Any]:
    """One fold: train on the pool, evaluate on the held-out dataset.
    ``cache`` holds each store read and joined with its annotations once a
    run (JAX reads them again for every fold)."""
    from viscy_tpu_torch.evaluation.linear_classifier import (annotated_store, classification_report, label_mask,
                                                              load_and_combine_datasets, predict_with_classifier,
                                                              roc_auc, train_linear_classifier_anndata)

    row: dict[str, Any] = {"model": model_label, "task": task, "channel": channel,
                           "excluded_dataset": excluded_dataset or "baseline", "test_dataset": test_dataset_name,
                           "seed": seed, "n_train_datasets": len(train_datasets)}
    class_counts = _get_class_counts(train_datasets, task, cache)
    for cls, cnt in class_counts.items():
        row[f"train_class_{cls}"] = cnt
    if class_counts:
        minority = min(class_counts, key=class_counts.get)
        row["minority_class"] = minority
        row["minority_class_count"] = class_counts[minority]
    else:
        row["minority_class"] = None
        row["minority_class_count"] = 0
    n_pca = config.get("n_pca_components")
    try:
        combined = load_and_combine_datasets(train_datasets, task, cache)
        pipeline, metrics, _ = train_linear_classifier_anndata(
            combined, task, use_scaling=config.get("use_scaling", True), use_pca=n_pca is not None,
            n_pca_components=n_pca,
            classifier_params={"max_iter": config.get("max_iter", 1000),
                               "class_weight": config.get("class_weight", "balanced"),
                               "solver": config.get("solver", "liblinear")},
            split_train_data=config.get("split_train_data", 0.8), random_seed=seed, device=device)
    except ValueError as e:  # the training's own refusals: too few classes, liblinear with three or more
        row["auroc"] = math.nan
        row["error"] = str(e)
        _logger.warning("CV fold failed: %s, seed=%s: %s", excluded_dataset, seed, e)
        return row
    row.update(metrics)
    annotated = predict_with_classifier(annotated_store(test_dataset["embeddings"], test_dataset["annotations"], task,
                                                        cache), pipeline, task)
    mask = label_mask(annotated.obs[task])
    if not mask.any():
        row["auroc"] = math.nan
        row["error"] = "no annotated test cells"
        return row
    y_true = np.asarray(annotated.obs[task][mask], dtype=object)
    y_pred = np.asarray(annotated.obs[f"predicted_{task}"][mask], dtype=object)
    proba = np.asarray(annotated.obsm[f"predicted_{task}_proba"])[mask]
    classes = annotated.uns.get(f"predicted_{task}_classes", [])
    if len(classes):
        try:
            row["auroc"] = roc_auc(y_true, proba[:, 1] if len(classes) == 2 else proba)
        except ValueError:
            row["auroc"] = math.nan
        t = np.asarray(annotated.obs["t"])[mask] if "t" in annotated.obs else None
        _compute_temporal_metrics(row, t, y_true, y_pred, proba, classes)
    else:
        row["auroc"] = math.nan
    report = classification_report(y_true, y_pred)
    row["test_accuracy"] = report["accuracy"]
    row["test_weighted_f1"] = report["weighted avg"]["f1-score"]
    row["test_weighted_precision"] = report["weighted avg"]["precision"]
    row["test_weighted_recall"] = report["weighted avg"]["recall"]
    row["test_n_samples"] = int(mask.sum())
    for cls in sorted(set(map(str, y_true)) | set(map(str, y_pred))):
        if cls in report:
            row[f"test_{cls}_f1"] = report[cls]["f1-score"]
            row[f"test_{cls}_precision"] = report[cls]["precision"]
            row[f"test_{cls}_recall"] = report[cls]["recall"]
    mc = row.get("minority_class")
    if mc and mc in report:
        row["minority_f1"] = report[mc]["f1-score"]
        row["minority_recall"] = report[mc]["recall"]
        row["minority_precision"] = report[mc]["precision"]
    return row


def cross_validate(config: dict, device: str = "cuda") -> tuple[list[dict], list[dict]]:
    """Rotating cross-validation (see the module docstring). Config keys as
    JAX's: ``models`` (label -> {datasets: [{name, embeddings_dir,
    annotations, include_wells}]}), ``output_dir``, ``ranking_metric``
    (auroc), ``n_bootstrap`` (seeds), ``min_class_samples``, ``n_workers``,
    ``task`` / ``task_channels`` / ``channels``, ``marker``, and the
    classifier's knobs. Returns ``(rows, summary rows)`` and writes the
    CSVs."""
    from viscy_tpu_torch.training.cli_utils import rows_to_csv

    if config.get("report"):
        raise NotImplementedError(REPORT_REFUSAL)
    ranking_metric = config.get("ranking_metric", "auroc")
    n_bootstrap = config.get("n_bootstrap", 5)
    min_class_samples = config.get("min_class_samples")
    n_workers = config.get("n_workers", 1)
    annotation_csvs = [Path(ds["annotations"]) for spec in config["models"].values() for ds in spec["datasets"]]
    tc = resolve_task_channels(config.get("task_channels"), annotation_csvs)
    if config.get("task"):
        tc = {config["task"]: tc.get(config["task"], [])}
    if not tc:
        raise ValueError("No valid tasks found across datasets.")
    n_pca = config.get("n_pca_components")
    if min_class_samples is None:
        min_class_samples = n_pca if n_pca else 16
    base_seed = config.get("random_seed", 42)
    seeds = [base_seed + i for i in range(n_bootstrap)]
    jobs: list[tuple] = []
    all_rows: list[dict[str, Any]] = []
    cache: dict = {}
    for model_label, model_spec in config["models"].items():
        datasets = model_spec["datasets"]
        for task, channels in tc.items():
            for channel in channels or config.get("channels", []):
                pairs = _build_cv_pairs(datasets, channel, task)
                if len(pairs) < 3:
                    _logger.info("%s/%s/%s: only %d dataset(s), need >= 3; skipping", model_label, task, channel,
                                 len(pairs))
                    continue
                for test_idx, (test_ds, test_dict) in enumerate(pairs):
                    test_name = test_ds["name"]
                    pool = [(ds, d) for j, (ds, d) in enumerate(pairs) if j != test_idx]
                    for seed in seeds:
                        jobs.append((config, model_label, task, channel, [d for _, d in pool], test_dict, test_name,
                                     seed, None))
                    for loo_idx, (loo_ds, _) in enumerate(pool):
                        remaining = [d for j, (_, d) in enumerate(pool) if j != loo_idx]
                        if not _check_class_safety(remaining, task, min_class_samples, cache):
                            for seed in seeds:
                                all_rows.append({"model": model_label, "task": task, "channel": channel,
                                                 "excluded_dataset": loo_ds["name"], "test_dataset": test_name,
                                                 "seed": seed, "n_train_datasets": len(remaining),
                                                 "impact": "unsafe", "auroc": math.nan})
                            continue
                        for seed in seeds:
                            jobs.append((config, model_label, task, channel, remaining, test_dict, test_name, seed,
                                         loo_ds["name"]))
    if n_workers and n_workers > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            all_rows.extend(pool.map(lambda args: _train_and_evaluate(*args, device=device, cache=cache), jobs))
    else:
        all_rows.extend(_train_and_evaluate(*args, device=device, cache=cache) for args in jobs)
    if not all_rows:
        return [], []
    summary = compute_summary(all_rows, ranking_metric)
    output_dir = Path(config["output_dir"])
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "cv_results.csv").write_text(rows_to_csv(all_rows))
    (output_dir / "cv_summary.csv").write_text(rows_to_csv(summary) if summary else "\n")
    recommendations = get_recommended_subsets(summary)
    if recommendations:
        if config.get("marker"):
            for r in recommendations:
                r["marker"] = config["marker"]
        (output_dir / "cv_recommended_subsets.csv").write_text(rows_to_csv(recommendations))
    return all_rows, summary


def _values(rows: list[dict], metric: str) -> np.ndarray:
    """The metric of each row, NaN where a row lacks it."""
    return np.asarray([float("nan") if r.get(metric) is None else float(r[metric]) for r in rows])


def _nanmean(v: np.ndarray) -> float:
    v = v[~np.isnan(v)]
    return float(v.mean()) if len(v) else math.nan


def _nanstd(v: np.ndarray) -> float:
    v = v[~np.isnan(v)]
    return float(v.std(ddof=1)) if len(v) > 1 else math.nan


def _fold_means(rows: list[dict], metric: str) -> dict[str, float]:
    by_fold: dict[str, list[dict]] = {}
    for r in rows:
        by_fold.setdefault(r["test_dataset"], []).append(r)
    means = {td: _nanmean(_values(v, metric)) for td, v in sorted(by_fold.items())}
    return {td: m for td, m in means.items() if not math.isnan(m)}


def _groups(rows: list[dict], keys: tuple[str, ...]) -> list[tuple[tuple, list[dict]]]:
    """``groupby(keys)`` in sorted key order, each group's rows in order."""
    out: dict[tuple, list[dict]] = {}
    for r in rows:
        out.setdefault(tuple(r[k] for k in keys), []).append(r)
    return sorted(out.items())


def compute_summary(rows: list[dict], ranking_metric: str = "auroc") -> list[dict]:
    """Per (model, task, channel) and excluded dataset: paired within-fold
    deltas against the baseline. ``helps`` (delta < -SEM: removing the
    dataset hurts, keep it), ``hurts`` (delta > SEM: removing it helps, drop
    it), ``uncertain``, ``unsafe`` (under the class-count threshold)."""
    out = []
    m = ranking_metric
    for (model, task, channel), group in _groups(rows, ("model", "task", "channel")):
        bl_fold_means = _fold_means([r for r in group if r["excluded_dataset"] == "baseline"], m)
        baseline_mean = float(np.mean(list(bl_fold_means.values()))) if bl_fold_means else math.nan
        n_test_folds = len({r["test_dataset"] for r in group})
        for (exc_ds,), exc in _groups(group, ("excluded_dataset",)):
            vals = _values(exc, m)
            exc_mean, exc_std = _nanmean(vals), _nanstd(vals)
            head = {"model": model, "task": task, "channel": channel, "excluded_dataset": exc_ds}
            if exc_ds == "baseline":
                out.append({**head, f"mean_{m}": baseline_mean, f"std_{m}": exc_std, "baseline_mean": baseline_mean,
                            "delta": 0.0, "impact": "baseline", "n_test_folds": len(bl_fold_means)})
                continue
            if any(r.get("impact") == "unsafe" for r in exc):
                out.append({**head, f"mean_{m}": exc_mean, f"std_{m}": exc_std, "baseline_mean": baseline_mean,
                            "delta": math.nan, "impact": "unsafe", "n_test_folds": n_test_folds})
                continue
            exc_fold_means = _fold_means(exc, m)
            shared = sorted(set(bl_fold_means) & set(exc_fold_means))
            deltas = [exc_fold_means[td] - bl_fold_means[td] for td in shared]
            if not deltas:
                delta, delta_std = math.nan, math.nan
            else:
                delta = float(np.mean(deltas))
                delta_std = float(np.std(deltas, ddof=1)) if len(shared) > 1 else 0.0
            impact = "uncertain"
            if not math.isnan(delta) and len(shared) >= 2:
                sem = delta_std / np.sqrt(len(shared))
                if sem != 0 and delta > 0 and delta > sem:
                    impact = "hurts"
                elif sem != 0 and delta < 0 and abs(delta) > sem:
                    impact = "helps"
            out.append({**head,
                        f"mean_{m}": float(np.mean([exc_fold_means[td] for td in shared])) if shared else exc_mean,
                        f"std_{m}": exc_std,
                        "baseline_mean": float(np.mean([bl_fold_means[td] for td in shared])) if shared
                        else baseline_mean,
                        "delta": delta, "delta_std": delta_std, "impact": impact, "n_test_folds": len(shared)})
    return out


def get_recommended_subsets(summary: list[dict]) -> list[dict]:
    """Per (model, task, channel): drop the datasets labelled ``hurts``."""
    out = []
    for (model, task, channel), group in _groups([r for r in summary if r["excluded_dataset"] != "baseline"],
                                                 ("model", "task", "channel")):
        hurts = [r["excluded_dataset"] for r in group if r["impact"] == "hurts"]
        keeps = [r["excluded_dataset"] for r in group if r["impact"] != "hurts"]
        out.append({"model": model, "task": task, "channel": channel, "drop_datasets": ";".join(sorted(hurts)),
                    "keep_datasets": ";".join(sorted(keeps)), "n_dropped": len(hurts)})
    return out
