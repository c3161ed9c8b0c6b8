"""Cross-condition linear probes (counterpart of
``viscy_tpu/apps/dynacell/eval/cross_condition.py``): two infection
conditions probed against each other for each feature space (CP, DINOv3,
DynaCLR, CellDINO), separately on the GT and the predicted embeddings, from
the ``embeddings/*_single_cell_embeddings.npz`` files an evaluation writes.
A directory's condition is its name's trailing ``_{mock,denv,zikv}``. The
probes fit on ``device``.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from viscy_tpu_torch.apps.dynacell.eval.cache import FEATURE_KINDS
from viscy_tpu_torch.apps.dynacell.eval.feature_select import select_features
from viscy_tpu_torch.apps.dynacell.eval.linear_probe import MADScaler, paired_auroc

__all__ = ["run", "run_for_group", "GROUP_PROBE_FILENAME"]

_SOURCES = ("pred", "gt")
_CONDITION_TOKENS = ("mock", "denv", "zikv")
_DEFAULT_PAIRS = (("mock", "denv"), ("mock", "zikv"))
_FIELDNAMES = (
    "feature_type",
    "pair",
    "source",
    "n_cells_c0",
    "n_cells_c1",
    "n_fovs",
    "n_folds",
    "auroc_mean",
    "auroc_std",
    "skipped_reason",
)
GROUP_PROBE_FILENAME = "cross_condition_probe.csv"


def _detect_condition(eval_dir: Path) -> str:
    name = eval_dir.name
    for token in _CONDITION_TOKENS:
        if name.endswith(f"_{token}"):
            return token
    raise ValueError(f"cannot infer condition from {name!r}: expected trailing _{{mock,denv,zikv}}")


def _load_embeddings(eval_dir: Path, source: str, feature: str, cache: dict | None = None):
    npz_path = (eval_dir / "embeddings" / f"{source}_{feature}_single_cell_embeddings.npz").resolve()
    if cache is not None and npz_path in cache:
        return cache[npz_path]
    with np.load(npz_path, allow_pickle=True) as data:
        result = (np.asarray(data["embeddings"]), np.asarray(data["fov"]))
    if cache is not None:
        cache[npz_path] = result
    return result


def _probe_pair(
    dirs_by_condition: dict[str, Path],
    pair: tuple[str, str],
    feature: str,
    source: str,
    n_splits: int,
    rng_seed: int,
    cache: dict | None = None,
    device="cuda",
) -> dict:
    c0, c1 = pair
    row = {
        "feature_type": feature,
        "pair": f"{c0}_vs_{c1}",
        "source": source,
        "n_cells_c0": 0,
        "n_cells_c1": 0,
        "n_fovs": 0,
        "n_folds": 0,
        "auroc_mean": float("nan"),
        "auroc_std": float("nan"),
        "skipped_reason": "",
    }
    if c0 not in dirs_by_condition or c1 not in dirs_by_condition:
        row["skipped_reason"] = "missing eval dir for one side of pair"
        return row
    try:
        x0, fov0 = _load_embeddings(dirs_by_condition[c0], source, feature, cache)
        x1, fov1 = _load_embeddings(dirs_by_condition[c1], source, feature, cache)
    except FileNotFoundError as e:
        row["skipped_reason"] = f"missing embeddings file: {e}"
        return row
    if x0.size == 0 or x1.size == 0:
        row["skipped_reason"] = "empty embeddings on one side"
        return row
    if x0.shape[1] != x1.shape[1]:
        raise ValueError(f"feature dim mismatch for {feature} {source}: {x0.shape[1]} vs {x1.shape[1]}")

    # CP: prune near-constant/redundant columns on the pooled cohort;
    # dense learned features skip the pruning.
    if feature == "cp":
        x0, x1, _ = select_features(x0, x1)
        if x0.size == 0 or x1.size == 0:
            row["skipped_reason"] = "all CP columns dropped by select_features"
            return row

    # per-plate MAD normalization cancels plate-level intensity offsets
    # that would make plates trivially separable
    x0s = MADScaler().fit_transform(x0.astype(np.float64))
    x1s = MADScaler().fit_transform(x1.astype(np.float64))
    fov0_t = np.asarray([f"{c0}::{f}" for f in fov0])
    fov1_t = np.asarray([f"{c1}::{f}" for f in fov1])
    result = paired_auroc(x0s, x1s, fov0_t, fov1_t, n_splits=n_splits, rng_seed=rng_seed, device=device)
    row.update(
        {
            "n_cells_c0": int(len(x0)),
            "n_cells_c1": int(len(x1)),
            "n_fovs": int(len(np.unique(fov0_t)) + len(np.unique(fov1_t))),
            "n_folds": int(result["n_folds"]),
            "auroc_mean": float(result["auroc_mean"]),
            "auroc_std": float(result["auroc_std"]),
        }
    )
    return row


def _write_rows(out_path: Path, rows: list[dict]) -> None:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with out_path.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=_FIELDNAMES)
        writer.writeheader()
        writer.writerows(rows)


def run_for_group(eval_dirs: list[Path], n_splits: int = 5, rng_seed: int = 2020, device="cuda") -> list[Path]:
    """Probe each infected condition against mock and write one CSV into
    each infected condition's eval dir; returns the CSV paths (none without
    a mock and an infected condition)."""
    by_condition: dict[str, Path] = {}
    for d in eval_dirs:
        try:
            cond = _detect_condition(Path(d))
        except ValueError:
            continue
        if cond in by_condition:
            raise ValueError(f"duplicate condition {cond!r}: {by_condition[cond]} and {d}")
        by_condition[cond] = Path(d)
    if "mock" not in by_condition:
        return []
    cache: dict = {}
    written: list[Path] = []
    for ref, cond in _DEFAULT_PAIRS:
        if cond not in by_condition:
            continue
        rows = [
            _probe_pair(by_condition, (ref, cond), feature, source, n_splits, rng_seed, cache, device)
            for feature in FEATURE_KINDS
            for source in _SOURCES
        ]
        out_path = by_condition[cond] / GROUP_PROBE_FILENAME
        _write_rows(out_path, rows)
        written.append(out_path)
    return written


def run(
    eval_dirs: list[Path],
    out_path: Path,
    pairs: tuple[tuple[str, str], ...] = _DEFAULT_PAIRS,
    n_splits: int = 5,
    rng_seed: int = 2020,
    device="cuda",
) -> Path:
    """Probe every (pair, feature, source) and dump one long-form CSV."""
    by_condition: dict[str, Path] = {}
    for d in eval_dirs:
        cond = _detect_condition(Path(d))
        if cond in by_condition:
            raise ValueError(f"duplicate condition {cond!r}: {by_condition[cond]} and {d}")
        by_condition[cond] = Path(d)
    cache: dict = {}
    rows = [
        _probe_pair(by_condition, pair, feature, source, n_splits, rng_seed, cache, device)
        for feature in FEATURE_KINDS
        for pair in pairs
        for source in _SOURCES
    ]
    _write_rows(Path(out_path), rows)
    return Path(out_path)
