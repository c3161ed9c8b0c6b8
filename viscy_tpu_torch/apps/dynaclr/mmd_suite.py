"""The MMD perturbation-effect suite (counterpart of
``viscy_tpu/apps/dynaclr/mmd_suite.py``; reference
``dynaclr/evaluation/mmd``), over AnnData embedding stores, on ``device``.

Three modes, each a list of row dicts (``mmd_<mode>.csv`` in the CLI):

- per experiment (:func:`run_mmd_analysis`): explicit (cond_a, cond_b)
  comparisons by (experiment, marker), whole or per time bin, with an
  optional bandwidth shared from one comparison;
- combined (:func:`run_mmd_combined`): each pair of experiments at a
  matched condition (and time bin), each side mean-centred;
- pooled (:func:`run_mmd_pooled`): the experiments mean-centred, pooled,
  then the per-experiment sweep.

Each row holds ``mmd2``, the permutation ``p_value``, the median-heuristic
``bandwidth``, ``effect_size`` and ``activity_zscore``, and the optional
copairs-style mAP. The subsamples are drawn with numpy exactly as JAX
draws them; the tests run on :mod:`~viscy_tpu_torch.evaluation.mmd` and
:mod:`~viscy_tpu_torch.evaluation.embedding_map` on ``device``. The configs validate
without pydantic.

Departures from JAX (``ROADMAP.md`` Queue 3): ``save_plots`` defaults to
``False``, and ``save_plots: true`` is refused by name before any work
(the heatmaps need matplotlib; ``ROADMAP.md`` Queue 1 item 9); a failing
mAP raises (JAX logs it and reports NaN).
"""

from __future__ import annotations

from itertools import combinations
from pathlib import Path
from typing import Any

import numpy as np

from viscy_tpu_torch.apps.airtable_utils.schemas import (
    REQUIRED,
    Model,
    any_dict,
    as_bool,
    as_float,
    as_int,
    as_str,
    list_of,
    model,
    optional,
)
from viscy_tpu_torch.apps.dynaclr.smoothness_benchmark import refuse_plots
from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite, Frame
from viscy_tpu_torch.evaluation.mmd import median_heuristic, mmd_permutation_test

__all__ = [
    "ComparisonSpec",
    "MMDSettings",
    "MAPSettings",
    "MMDEvalConfig",
    "MMDCombinedConfig",
    "MMDPooledConfig",
    "run_mmd_analysis",
    "run_mmd_combined",
    "run_mmd_pooled",
]

NAN = float("nan")


class ComparisonSpec(Model):
    fields = (("cond_a", as_str, REQUIRED), ("cond_b", as_str, REQUIRED), ("label", as_str, REQUIRED))


class MMDSettings(Model):
    fields = (
        ("n_permutations", as_int, 1000),
        ("max_cells", optional(as_int), 2000),
        ("min_cells", as_int, 20),
        ("seed", as_int, 42),
        ("balance_samples", as_bool, False),
        ("share_bandwidth_from", optional(as_str), None),
    )


class MAPSettings(Model):
    fields = (
        ("enabled", as_bool, False),
        ("distance", as_str, "cosine"),
        ("null_size", as_int, 10000),
        ("seed", as_int, 0),
    )


_BASE = (
    ("output_dir", as_str, REQUIRED),
    ("group_by", as_str, "perturbation"),
    ("obs_filter", optional(any_dict), None),
    ("embedding_key", optional(as_str), None),
    ("mmd", model(MMDSettings), MMDSettings),
    ("map_settings", model(MAPSettings), MAPSettings),
    ("temporal_bin_size", optional(as_float), None),
    ("temporal_bins", optional(list_of(as_float)), None),
    ("save_plots", as_bool, False),
)
_COMPARISONS = ("comparisons", list_of(model(ComparisonSpec)), REQUIRED)
_PATHS = ("input_paths", list_of(as_str), REQUIRED)


class _MMDBaseConfig(Model):
    def __init__(self, **data: Any) -> None:
        super().__init__(**data)
        if self.temporal_bin_size is not None and self.temporal_bins is not None:
            raise ValueError(f"validation error for {type(self).__name__}: temporal_bin_size and temporal_bins are "
                             "mutually exclusive")


class MMDEvalConfig(_MMDBaseConfig):
    fields = (*_BASE, ("input_path", as_str, REQUIRED), _COMPARISONS)


class MMDCombinedConfig(_MMDBaseConfig):
    fields = (*_BASE, _PATHS)


class MMDPooledConfig(_MMDBaseConfig):
    fields = (*_BASE, _PATHS, _COMPARISONS)


def _resolve_bin_edges(bin_size, bins, max_hours) -> list[tuple[float, float]] | None:
    if bins is not None:
        edges = list(bins)
    elif bin_size is not None:
        edges = list(np.arange(0, max_hours + bin_size, bin_size))
    else:
        return None
    return list(zip(edges[:-1], edges[1:]))


def _as_str(values) -> np.ndarray:
    """``series.astype(str)``."""
    return np.asarray([str(v) for v in np.asarray(values).tolist()], dtype=object)


def _subset(adata: AnnDataLite, rows: np.ndarray) -> AnnDataLite:
    return AnnDataLite(X=adata.X[rows], obs=adata.obs.take(rows), obsm={k: v[rows] for k, v in adata.obsm.items()},
                       uns=adata.uns)


def _extract_embeddings(adata: AnnDataLite, embedding_key: str | None) -> np.ndarray:
    return np.asarray(adata.X if embedding_key is None else adata.obsm[embedding_key], np.float64)


def _subsample(X: np.ndarray, max_n: int | None, rng) -> np.ndarray:
    if max_n is None or len(X) <= max_n:
        return X
    return X[rng.choice(len(X), max_n, replace=False)]


def _run_one_comparison(emb_a: np.ndarray, emb_b: np.ndarray, settings: MMDSettings, bandwidth: float | None = None,
                        device: str = "cuda") -> tuple:
    """One permutation test: (mmd2, p, bandwidth, effect_size,
    activity_zscore, n_a, n_b), NaN below ``min_cells``."""
    rng = np.random.default_rng(settings.seed)
    emb_a = _subsample(emb_a, settings.max_cells, rng)
    emb_b = _subsample(emb_b, settings.max_cells, rng)
    if settings.balance_samples:
        m = min(len(emb_a), len(emb_b))
        emb_a = _subsample(emb_a, m, rng)
        emb_b = _subsample(emb_b, m, rng)
    na, nb = len(emb_a), len(emb_b)
    if na < settings.min_cells or nb < settings.min_cells:
        return (NAN,) * 5 + (na, nb)
    if bandwidth is None:
        bandwidth = median_heuristic(emb_a, emb_b, device=device)
    res = mmd_permutation_test(emb_a, emb_b, n_permutations=settings.n_permutations, bandwidth=bandwidth,
                               seed=settings.seed, device=device)
    mmd2 = res["mmd2"]
    es = mmd2 / bandwidth if bandwidth > 0 else NAN
    az = float((mmd2 - res["null_mean"]) / (res["null_std"] + 1e-12))
    return mmd2, res["p_value"], bandwidth, es, az, na, nb


def _maybe_map(obs_sub: Frame, emb_sub: np.ndarray, comp: ComparisonSpec, group_by: str, settings: MAPSettings,
               device: str) -> tuple[float, float]:
    if not settings.enabled:
        return NAN, NAN
    from viscy_tpu_torch.evaluation.embedding_map import compute_embedding_map

    result = compute_embedding_map(meta=obs_sub, features=emb_sub, reference_condition=comp.cond_a,
                                   target_condition=comp.cond_b, condition_col=group_by, group_col="marker",
                                   distance=settings.distance, null_size=settings.null_size, seed=settings.seed,
                                   device=device)
    if result is None:
        return NAN, NAN
    return result["mean_average_precision"], result["p_value"]


def _apply_obs_filter(adata: AnnDataLite, obs_filter: dict | None) -> AnnDataLite:
    if not obs_filter:
        return adata
    mask = np.ones(adata.n_obs, bool)
    for col, val in obs_filter.items():
        if col not in adata.obs:
            raise KeyError(f"obs_filter column {col!r} not found. Available: {adata.obs.names}")
        mask &= _as_str(adata.obs[col]) == str(val)
    return _subset(adata, mask)


def _shared_bandwidth(all_emb, group: np.ndarray, base_mask, comparisons, settings: MMDSettings,
                      device: str) -> float | None:
    """The bandwidth of the ``share_bandwidth_from`` comparison, if any."""
    if settings.share_bandwidth_from is None:
        return None
    for comp in comparisons:
        if comp.label == settings.share_bandwidth_from:
            a = all_emb[base_mask & (group == comp.cond_a)]
            b = all_emb[base_mask & (group == comp.cond_b)]
            if len(a) >= settings.min_cells and len(b) >= settings.min_cells:
                return median_heuristic(a, b, device=device)
            return None
    return None


def _unique(values) -> list:
    """``series.unique()``: values in order of first appearance."""
    return list(dict.fromkeys(np.asarray(values).tolist()))


def _hours(obs: Frame) -> np.ndarray:
    return np.asarray(obs["hours_post_perturbation"], np.float64)


def run_mmd_analysis(adata: AnnDataLite, config: MMDEvalConfig, device: str = "cuda") -> list[dict]:
    """Per-experiment MMD of the comparison pairs by marker: one row per
    (experiment, marker, comparison[, time bin])."""
    adata = _apply_obs_filter(adata, config.obs_filter)
    obs = adata.obs
    if config.group_by not in obs:
        raise KeyError(f"obs column {config.group_by!r} not found. Available: {obs.names}")
    emb_key_label = config.embedding_key or "X"
    all_emb = _extract_embeddings(adata, config.embedding_key)
    group = _as_str(obs[config.group_by])
    experiments = _unique(obs["experiment"]) if "experiment" in obs else ["unknown"]
    markers = sorted(set(_as_str(obs["marker"]).tolist())) if "marker" in obs else ["all"]
    records = []
    for experiment in experiments:
        exp_mask = (np.asarray(obs["experiment"]) == experiment if "experiment" in obs
                    else np.ones(len(obs), bool))
        for marker in markers:
            marker_mask = exp_mask & (_as_str(obs["marker"]) == marker if "marker" in obs else True)
            bin_pairs = None
            if config.temporal_bin_size is not None or config.temporal_bins is not None:
                if "hours_post_perturbation" not in obs:
                    raise KeyError("temporal binning requires obs column 'hours_post_perturbation'")
                bin_pairs = _resolve_bin_edges(config.temporal_bin_size, config.temporal_bins, np.nanmax(_hours(obs)))
            for b_start, b_end in bin_pairs or [(NAN, NAN)]:
                if bin_pairs is None:
                    window = marker_mask
                else:
                    hours = _hours(obs)
                    window = marker_mask & (hours >= b_start) & (hours < b_end)
                shared_bw = _shared_bandwidth(all_emb, group, window, config.comparisons, config.mmd, device)
                for comp in config.comparisons:
                    # cond_a (the control) pools all times; cond_b is the bin's
                    mask_a = marker_mask & (group == comp.cond_a)
                    mask_b = window & (group == comp.cond_b)
                    mmd2, p, bw, es, az, na, nb = _run_one_comparison(all_emb[mask_a], all_emb[mask_b], config.mmd,
                                                                      bandwidth=shared_bw, device=device)
                    map_val, map_p = _maybe_map(obs.take(marker_mask), all_emb[marker_mask], comp, config.group_by,
                                                config.map_settings, device)
                    records.append({
                        "experiment": experiment, "marker": marker, "cond_a": comp.cond_a, "cond_b": comp.cond_b,
                        "label": comp.label, "hours_bin_start": b_start, "hours_bin_end": b_end, "n_a": na,
                        "n_b": nb, "mmd2": mmd2, "p_value": p, "bandwidth": bw, "effect_size": es,
                        "activity_zscore": az, "map_value": map_val, "map_p_value": map_p,
                        "embedding_key": emb_key_label,
                    })
    return records


def _load_stores(paths: list[str]) -> dict[str, AnnDataLite]:
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    out = {}
    for p in paths:
        adata = read_embedding_dataset(p)
        name = str(np.asarray(adata.obs["experiment"])[0]) if "experiment" in adata.obs else Path(p).stem
        out[name] = adata
    return out


def run_mmd_combined(config: MMDCombinedConfig, device: str = "cuda") -> list[dict]:
    """Each pair of experiments at a matched condition (and time bin),
    each side mean-centred first: the batch-effect scale."""
    adatas = {name: _apply_obs_filter(a, config.obs_filter) for name, a in _load_stores(config.input_paths).items()}
    marker_to_exps: dict[str, list[str]] = {}
    for name, adata in adatas.items():
        for marker in _unique(_as_str(adata.obs["marker"])):
            marker_to_exps.setdefault(marker, []).append(name)
    emb_key_label = config.embedding_key or "X"
    records = []
    for marker, exp_names in sorted(marker_to_exps.items()):
        if len(exp_names) < 2:
            continue
        for exp_a, exp_b in combinations(exp_names, 2):
            a = _subset(adatas[exp_a], _as_str(adatas[exp_a].obs["marker"]) == marker)
            b = _subset(adatas[exp_b], _as_str(adatas[exp_b].obs["marker"]) == marker)
            emb_a = _extract_embeddings(a, config.embedding_key)
            emb_b = _extract_embeddings(b, config.embedding_key)
            emb_a = emb_a - emb_a.mean(axis=0)
            emb_b = emb_b - emb_b.mean(axis=0)
            group_a, group_b = _as_str(a.obs[config.group_by]), _as_str(b.obs[config.group_by])
            for condition in sorted(set(group_a.tolist()) & set(group_b.tolist())):
                ca, cb = group_a == condition, group_b == condition
                bin_pairs = None
                if config.temporal_bin_size is not None or config.temporal_bins is not None:
                    max_hours = min(np.nanmax(_hours(a.obs)), np.nanmax(_hours(b.obs)))
                    bin_pairs = _resolve_bin_edges(config.temporal_bin_size, config.temporal_bins, max_hours)
                for b_start, b_end in bin_pairs or [(NAN, NAN)]:
                    if bin_pairs is None:
                        sel_a, sel_b = ca, cb
                    else:
                        ha, hb = _hours(a.obs), _hours(b.obs)
                        sel_a = ca & (ha >= b_start) & (ha < b_end)
                        sel_b = cb & (hb >= b_start) & (hb < b_end)
                    mmd2, p, bw, es, az, na, nb = _run_one_comparison(emb_a[sel_a], emb_b[sel_b], config.mmd,
                                                                      device=device)
                    records.append({
                        "marker": marker, "exp_a": exp_a, "exp_b": exp_b, "condition": condition,
                        "hours_bin_start": b_start, "hours_bin_end": b_end, "n_a": na, "n_b": nb, "mmd2": mmd2,
                        "p_value": p, "bandwidth": bw, "effect_size": es, "activity_zscore": az,
                        "embedding_key": emb_key_label,
                    })
    return records


def run_mmd_pooled(config: MMDPooledConfig, device: str = "cuda") -> list[dict]:
    """The experiments each mean-centred, pooled (``experiment`` =
    ``"pooled"``), then :func:`run_mmd_analysis`'s sweep."""
    parts, obs_parts = [], []
    for name, adata in _load_stores(config.input_paths).items():
        adata = _apply_obs_filter(adata, config.obs_filter)
        emb = _extract_embeddings(adata, config.embedding_key)
        parts.append(emb - emb.mean(axis=0))
        obs = Frame(dict(adata.obs.columns), n_rows=len(adata.obs))
        if "experiment" not in obs:
            obs["experiment"] = np.full(len(obs), name, dtype=object)
        obs_parts.append(obs)
    pooled = AnnDataLite(X=np.concatenate(parts, axis=0).astype(np.float32), obs=Frame.concat(obs_parts).reset_index())
    pooled.obs["experiment"] = np.full(pooled.n_obs, "pooled", dtype=object)
    eval_cfg = MMDEvalConfig(input_path="<pooled>", comparisons=config.comparisons, output_dir=config.output_dir,
                             group_by=config.group_by, embedding_key=None, mmd=config.mmd,
                             map_settings=config.map_settings, temporal_bin_size=config.temporal_bin_size,
                             temporal_bins=config.temporal_bins)
    return run_mmd_analysis(pooled, eval_cfg, device=device)


def run_mode(raw: dict, mode: str, device: str = "cuda") -> tuple[Any, list[dict]]:
    """``mmd-analysis --mode``: the validated config (figures refused before
    any work) and its rows."""
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    cls = {"per_experiment": MMDEvalConfig, "combined": MMDCombinedConfig, "pooled": MMDPooledConfig}[mode]
    cfg = cls(**raw)
    refuse_plots(cfg, "MMD heatmaps and temporal curves")
    if mode == "per_experiment":
        return cfg, run_mmd_analysis(read_embedding_dataset(cfg.input_path), cfg, device=device)
    if mode == "combined":
        return cfg, run_mmd_combined(cfg, device=device)
    return cfg, run_mmd_pooled(cfg, device=device)
