"""The dynacell evaluation run: load, segment, score, save (counterpart of
``viscy_tpu/apps/dynacell/eval/pipeline.py``).

Per FOV the three tiers: pixel (:func:`.metrics.compute_pixel_metrics` on
the device, the per-cell similarity on the host), mask (binary metrics and
instance AP) and feature (CP regionprops and deep embeddings, scored per
(FOV, t) and pooled into the dataset-level FID / KID / PRC / MIND and the
real-against-predicted probe). Segmentations and features go through the
artifact cache of :mod:`.cache`; ``precompute-gt`` fills the GT side ahead
of the runs. The per-FOV results are taken in submission order (the
plate's FOV order), so the CSVs and the pooled cohorts are the same from
run to run; JAX takes them as ``as_completed`` yields them (``ROADMAP.md``
Queue 3).

Outputs under ``save.save_dir``: ``pixel_metrics.csv``,
``mask_metrics.csv`` and ``feature_metrics.csv`` with their ``.npy``
twins (object arrays of the row dicts), ``cp_selected_feature_mask.json``,
``embeddings/{side}_{kind}_single_cell_embeddings.npz`` and
``timings.csv``, with JAX's names, columns and column order. The config is
JAX's plain nested dict:

```
io: {pred_path, gt_path, pred_channel_name, gt_channel_name, gt_cache_dir, pred_cache_dir,
     include_fovs, require_complete_cache}
target_name: nucleus | membrane | er | ...
spacing: [z, y, x]
compute_feature_metrics: bool
compute_instance_ap: bool
cell_similarity: {metrics: [pcc, ssim], reduce: [mean, median]}
pixel_metrics: {spectral_pcc: {...} | null, fsc: {...} | null, multiband_ev: bool}
feature_metrics: {patch_size, cp: {glcm: {...}}, dinov3 / dynaclr / celldino: spec}
segmentation: {backend: native}
save: {save_dir, *_csv_filename, *_metrics_filename}
force_recompute: {all, masks, instances, cp_features, deep_features, final_metrics}
runtime: {executor: serial | thread, workers: N}
build: {masks, instances, cp_features, deep_features}   # precompute-gt
conditions: {name: {overrides}}                        # evaluate-grouped
```
"""

from __future__ import annotations

import csv
import json
import logging
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from viscy_tpu_torch.apps.dynacell.eval._ops import resolve_device
from viscy_tpu_torch.apps.dynacell.eval.cache import (
    CacheContext,
    flush_manifest,
    fov_cp_features,
    fov_deep_features,
    fov_masks,
    fov_nucleus_instances,
    init_cache_context,
)
from viscy_tpu_torch.apps.dynacell.eval.feature_metrics import (
    compute_feature_similarity,
    compute_feature_similarity_pairwise,
)
from viscy_tpu_torch.apps.dynacell.eval.feature_select import (
    DEFAULT_CORR_THRESHOLD,
    DEFAULT_FREQ_CUT,
    DEFAULT_UNIQUE_CUT,
    select_features,
)
from viscy_tpu_torch.apps.dynacell.eval.features import EvalModels, load_eval_models
from viscy_tpu_torch.apps.dynacell.eval.instance_metrics import instance_average_precision
from viscy_tpu_torch.apps.dynacell.eval.linear_probe import indistinguishability, paired_auroc
from viscy_tpu_torch.apps.dynacell.eval.metrics import (
    active_cp_feature_names,
    build_crops,
    compute_pixel_metrics,
    cp_regionprops,
    evaluate_segmentations,
    features_from_crops,
    per_cell_similarity,
)
from viscy_tpu_torch.apps.dynacell.eval.runtime import (
    device_serialization_lock,
    dump_timings_csv,
    extend_timings,
    get_timings,
    make_fov_executor,
    region_timer,
    reset_timings,
    resolve_runtime,
)
from viscy_tpu_torch.apps.dynacell.eval.segmentation import segment, segment_nucleus_instances
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["FovResult", "evaluate_predictions", "evaluate_predictions_grouped", "evaluate_model", "save_metrics",
           "precompute_gt_artifacts", "write_csv"]

_BACKBONE_KEYS = ("cp", "dinov3", "dynaclr", "celldino")
_DISPLAY = {"cp": "CP", "dinov3": "DINOv3", "dynaclr": "DynaCLR", "celldino": "CellDINO"}
_TIERS = (
    ("mask", "mask_csv_filename", "mask_metrics.csv", "mask_metrics_filename", "mask_metrics.npy"),
    ("pixel", "pixel_csv_filename", "pixel_metrics.csv", "pixel_metrics_filename", "pixel_metrics.npy"),
    ("feature", "feature_csv_filename", "feature_metrics.csv", "feature_metrics_filename", "feature_metrics.npy"),
)


@dataclass
class _BackboneLists:
    """Per-backbone accumulators across FOVs."""

    pred_feats: list = field(default_factory=list)
    gt_feats: list = field(default_factory=list)
    pred_fovs: list = field(default_factory=list)
    gt_fovs: list = field(default_factory=list)
    pred_ts: list = field(default_factory=list)
    gt_ts: list = field(default_factory=list)


@dataclass
class FovResult:
    """Everything one FOV contributes to the run."""

    pos_name: str
    per_t_pixel_rows: list[dict]
    per_t_mask_rows: list[dict]
    per_t_feature_rows: list[dict]
    backbones: dict[str, _BackboneLists]
    timings: list = field(default_factory=list)


def _cfg(config: dict, *keys, default=None):
    node = config
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node


def _read_stack(pos, channel_name: str) -> np.ndarray:
    """(T, D, H, W) float32 of one channel of a position."""
    return np.asarray(pos["0"][:, pos.get_channel_index(channel_name)], np.float32)


class _Segmenter:
    """One FOV's segmentations of each side's (T, D, H, W) stack, their
    filters and distance transforms on a CUDA ``device`` (scipy's bits). For
    ``nucleus`` (native backend) the semantic mask is the one the instance
    segmentation starts from: when this FOV computed it, the instances
    reuse it (JAX computes it twice; the labels are the same)."""

    def __init__(self, target_name: str, spacing, backend: str, seg_model, device) -> None:
        self.target_name, self.spacing, self.backend, self.seg_model = target_name, spacing, backend, seg_model
        self.device = device
        self._nucleus_masks: dict[str, np.ndarray] = {}

    def masks(self, side: str, data: np.ndarray) -> np.ndarray:
        out = np.stack([segment(data[t], self.target_name, self.seg_model, backend=self.backend, device=self.device)
                        for t in range(data.shape[0])])
        if self.target_name == "nucleus" and self.backend == "native":
            self._nucleus_masks[side] = out
        return out

    def instances(self, side: str, data: np.ndarray) -> np.ndarray:
        masks = self._nucleus_masks.get(side)
        return np.stack([segment_nucleus_instances(data[t], self.spacing, seg_model=self.seg_model,
                                                   backend=self.backend, mask=None if masks is None else masks[t],
                                                   device=self.device)
                         for t in range(data.shape[0])])


def _process_one_fov(config: dict, models: EvalModels, gt_ctx: CacheContext, pred_ctx: CacheContext, pos_name: str,
                     pred_pos, gt_pos, device) -> FovResult:
    """All three tiers of one FOV; its timings are its own (the thread's log
    is set aside and restored around it)."""
    saved = get_timings()
    reset_timings()
    try:
        return _score_fov(config, models, gt_ctx, pred_ctx, pos_name, pred_pos, gt_pos, device)
    finally:
        reset_timings()
        extend_timings(saved)


def _score_fov(config: dict, models: EvalModels, gt_ctx: CacheContext, pred_ctx: CacheContext, pos_name: str,
               pred_pos, gt_pos, device) -> FovResult:
    target_name = config.get("target_name", "nucleus")
    spacing = config.get("spacing", [1.0, 1.0, 1.0])
    backend = _cfg(config, "segmentation", "backend", default="native")
    pm_cfg = dict(_cfg(config, "pixel_metrics", default={}) or {})
    cs_cfg = _cfg(config, "cell_similarity")
    compute_features = bool(config.get("compute_feature_metrics", False))
    compute_instance_ap = bool(config.get("compute_instance_ap", False))
    patch_size = int(_cfg(config, "feature_metrics", "patch_size", default=64))
    cp_glcm = _cfg(config, "feature_metrics", "cp", "glcm", default=None)
    seg = _Segmenter(target_name, spacing, backend, models.seg_model, device)

    with region_timer("read", pos_name):
        predict = _read_stack(pred_pos, _cfg(config, "io", "pred_channel_name"))
        target = _read_stack(gt_pos, _cfg(config, "io", "gt_channel_name"))
    t_count = predict.shape[0]

    with region_timer("segment", pos_name):
        gt_masks = fov_masks(gt_ctx, "gt", target_name, pos_name, lambda: seg.masks("gt", target), backend=backend)
        pred_masks = fov_masks(pred_ctx, "pred", target_name, pos_name, lambda: seg.masks("pred", predict),
                               backend=backend)
        gt_inst = pred_inst = None
        if compute_instance_ap or compute_features or cs_cfg:
            gt_inst = fov_nucleus_instances(gt_ctx, "gt", target_name, pos_name,
                                            lambda: seg.instances("gt", target), backend=backend)
        if compute_instance_ap:
            pred_inst = fov_nucleus_instances(pred_ctx, "pred", target_name, pos_name,
                                              lambda: seg.instances("pred", predict), backend=backend)

    pixel_rows: list[dict] = []
    mask_rows: list[dict] = []
    feature_rows: list[dict] = []
    bbs = {k: _BackboneLists() for k in _BACKBONE_KEYS}
    for t in range(t_count):
        base = {"FOV": pos_name, "Timepoint": t}
        with region_timer("pixel", pos_name, t):
            row = dict(base)
            with device_serialization_lock:
                row.update(compute_pixel_metrics(
                    predict[t], target[t], spacing=spacing, spectral_pcc_kwargs=pm_cfg.get("spectral_pcc"),
                    fsc_kwargs=pm_cfg.get("fsc"), multiband_ev=bool(pm_cfg.get("multiband_ev")), device=device))
            if cs_cfg and gt_inst is not None:
                row.update(per_cell_similarity(predict[t], target[t], gt_inst[t],
                                               metrics=tuple(cs_cfg.get("metrics", ("pcc",))),
                                               reduce=tuple(cs_cfg.get("reduce", ("mean", "median")))))
            pixel_rows.append(row)

        with region_timer("mask", pos_name, t):
            row = dict(base)
            row.update(evaluate_segmentations(pred_masks[t], gt_masks[t]))
            if compute_instance_ap and pred_inst is not None and gt_inst is not None:
                row.update(instance_average_precision(pred_inst[t], gt_inst[t]))
            mask_rows.append(row)

        if compute_features and gt_inst is not None:
            with region_timer("features", pos_name, t):
                row = dict(base)
                gt_cp = fov_cp_features(gt_ctx, "gt", pos_name, t, lambda: cp_regionprops(
                    target[t], gt_inst[t], spacing, glcm_cfg=cp_glcm, device=device))
                pred_cp = fov_cp_features(pred_ctx, "pred", pos_name, t, lambda: cp_regionprops(
                    predict[t], gt_inst[t], spacing, glcm_cfg=cp_glcm, device=device))
                _accumulate(bbs["cp"], pred_cp, gt_cp, pos_name, t)
                row.update(compute_feature_similarity_pairwise(pred_cp, gt_cp, "CP", device=device))
                if models.extractors:
                    gt_crops = build_crops(target[t], gt_inst[t], patch_size)
                    pred_crops = build_crops(predict[t], gt_inst[t], patch_size)
                    for kind, extractor in models.extractors.items():
                        params = {"patch_size": patch_size}
                        gt_f = fov_deep_features(gt_ctx, "gt", kind, pos_name, t,
                                                 lambda: features_from_crops(gt_crops, extractor), params=params)
                        pred_f = fov_deep_features(pred_ctx, "pred", kind, pos_name, t,
                                                   lambda: features_from_crops(pred_crops, extractor), params=params)
                        _accumulate(bbs[kind], pred_f, gt_f, pos_name, t)
                        row.update(compute_feature_similarity_pairwise(pred_f, gt_f, _DISPLAY[kind], device=device))
                feature_rows.append(row)

    return FovResult(pos_name, pixel_rows, mask_rows, feature_rows, bbs, get_timings())


def _accumulate(bb: _BackboneLists, pred_f: np.ndarray, gt_f: np.ndarray, pos_name: str, t: int) -> None:
    if pred_f.size:
        bb.pred_feats.append(pred_f)
        bb.pred_fovs.append(np.full(len(pred_f), pos_name))
        bb.pred_ts.append(np.full(len(pred_f), t))
    if gt_f.size:
        bb.gt_feats.append(gt_f)
        bb.gt_fovs.append(np.full(len(gt_f), pos_name))
        bb.gt_ts.append(np.full(len(gt_f), t))


def _real_vs_pred_probe(pred_arr, target_arr, pred_fovs, target_fovs, prefix, rng_seed=2020, device="cuda") -> dict:
    """A FOV-grouped probe of real against predicted cells; its
    ``Indistinguishability`` near 1 means they cannot be told apart."""
    result = paired_auroc(target_arr, pred_arr, target_fovs, pred_fovs, rng_seed=rng_seed, device=device)
    auroc = float(result["auroc_mean"])
    return {
        f"{prefix}_RealVsPred_AUROC": auroc,
        f"{prefix}_RealVsPred_AUROC_std": float(result["auroc_std"]),
        f"{prefix}_Indistinguishability": indistinguishability(auroc) if np.isfinite(auroc) else float("nan"),
    }


def _zscore_per_side(pred: np.ndarray, target: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    p = (pred - pred.mean(axis=0)) / (pred.std(axis=0) + 1e-8)
    t = (target - target.mean(axis=0)) / (target.std(axis=0) + 1e-8)
    return p, t


def _save_embeddings(save_dir: Path, groups: dict[str, tuple[list, list, list]]) -> None:
    """``{side}_{kind}_single_cell_embeddings.npz``: what the
    cross-condition probe reads."""
    embed_dir = save_dir / "embeddings"
    embed_dir.mkdir(parents=True, exist_ok=True)
    for name, (feats, fovs, ts) in groups.items():
        if feats:
            np.savez(embed_dir / f"{name}_single_cell_embeddings.npz", embeddings=np.concatenate(feats, axis=0),
                     fov=np.concatenate(fovs, axis=0), timepoint=np.concatenate(ts, axis=0))


def _dataset_row(config: dict, parent: dict[str, _BackboneLists], save_dir: Path, device) -> dict[str, float]:
    """The ``Dataset_<prefix>_*`` columns: the pooled cohorts' similarity and
    probe per backbone (CP pruned and z-scored per side first)."""
    row: dict[str, float] = {}
    cp = parent["cp"]
    if cp.pred_feats:
        pred_raw = np.concatenate(cp.pred_feats, axis=0)
        gt_raw = np.concatenate(cp.gt_feats, axis=0)
        pred_fovs, gt_fovs = np.concatenate(cp.pred_fovs), np.concatenate(cp.gt_fovs)
        # a cell whose values are constant has NaN moments: left out (JAX raises on it)
        finite = np.isfinite(pred_raw).all(axis=1) & np.isfinite(gt_raw).all(axis=1)
        pred_raw, gt_raw, pred_fovs, gt_fovs = pred_raw[finite], gt_raw[finite], pred_fovs[finite], gt_fovs[finite]
        gt_filt, pred_filt, keep = select_features(gt_raw, pred_raw)
        glcm_enabled = bool(_cfg(config, "feature_metrics", "cp", "glcm", "enabled", default=False))
        (save_dir / "cp_selected_feature_mask.json").write_text(json.dumps({
            "feature_names": list(active_cp_feature_names(glcm_enabled)),
            "keep_mask": [bool(b) for b in keep],
            "n_kept": int(keep.sum()),
            "n_total": int(keep.size),
            "criteria": {"freq_cut": DEFAULT_FREQ_CUT, "unique_cut": DEFAULT_UNIQUE_CUT,
                         "corr_threshold": DEFAULT_CORR_THRESHOLD},
        }, indent=2))
        if pred_filt.size and gt_filt.size:
            pred_z, gt_z = _zscore_per_side(pred_filt, gt_filt)
        else:
            pred_z, gt_z = pred_filt, gt_filt
        raw = {**compute_feature_similarity(pred_z, gt_z, "CP", device=device),
               **_real_vs_pred_probe(pred_filt, gt_filt, pred_fovs, gt_fovs, "CP", device=device)}
        row.update({f"Dataset_{k}": v for k, v in raw.items()})
    for kind in ("dinov3", "dynaclr", "celldino"):
        bb = parent[kind]
        if bb.pred_feats:
            pred_arr = np.concatenate(bb.pred_feats, axis=0)
            gt_arr = np.concatenate(bb.gt_feats, axis=0)
            raw = {**compute_feature_similarity(pred_arr, gt_arr, _DISPLAY[kind], device=device),
                   **_real_vs_pred_probe(pred_arr, gt_arr, np.concatenate(bb.pred_fovs),
                                         np.concatenate(bb.gt_fovs), _DISPLAY[kind], device=device)}
            row.update({f"Dataset_{k}": v for k, v in raw.items()})
    return row


def evaluate_predictions(config: dict, *, models: EvalModels | None = None, device="cuda"):
    """Evaluate one prediction plate against its GT plate; returns
    ``(pixel_rows, mask_rows, feature_rows)``. The dataset-level columns
    are merged into every feature row and the per-cell embeddings written
    for the cross-condition probe."""
    dev = resolve_device(device)
    reset_timings()
    io = dict(config.get("io") or {})
    if models is None:
        models = load_eval_models(config, device=dev)
    save_dir = Path(_cfg(config, "save", "save_dir", default="dynacell_eval"))
    save_dir.mkdir(parents=True, exist_ok=True)
    force = dict(config.get("force_recompute") or {})
    gt_ctx = init_cache_context(io.get("gt_cache_dir"), source="gt", plate_path=str(io.get("gt_path")),
                                channel_name=io.get("gt_channel_name"), force=force,
                                require_complete=bool(io.get("require_complete_cache", False)))
    pred_ctx = init_cache_context(io.get("pred_cache_dir"), source="pred", plate_path=str(io.get("pred_path")),
                                  channel_name=io.get("pred_channel_name"), force=force, require_complete=False)

    pred_positions = dict(open_ome_zarr(io["pred_path"]).positions())
    gt_positions = dict(open_ome_zarr(io["gt_path"]).positions())
    names = [n for n in pred_positions if n in gt_positions]
    include = io.get("include_fovs")
    if include:
        names = [n for n in names if n in set(include)]
    if not names:
        raise ValueError("no overlapping FOVs between prediction and GT plates")

    executor = make_fov_executor(resolve_runtime(config.get("runtime")))
    all_pixel: list[dict] = []
    all_mask: list[dict] = []
    all_feature: list[dict] = []
    parent = {k: _BackboneLists() for k in _BACKBONE_KEYS}
    futures = [executor.submit(_process_one_fov, config, models, gt_ctx, pred_ctx, name, pred_positions[name],
                               gt_positions[name], dev) for name in names]
    try:
        for fut in futures:
            result: FovResult = fut.result()
            extend_timings(result.timings)
            all_pixel.extend(result.per_t_pixel_rows)
            all_mask.extend(result.per_t_mask_rows)
            all_feature.extend(result.per_t_feature_rows)
            for k in _BACKBONE_KEYS:
                src, dst = result.backbones[k], parent[k]
                for f in ("pred_feats", "gt_feats", "pred_fovs", "gt_fovs", "pred_ts", "gt_ts"):
                    getattr(dst, f).extend(getattr(src, f))
    finally:
        executor.shutdown(wait=True)
    flush_manifest(gt_ctx)
    flush_manifest(pred_ctx)

    if config.get("compute_feature_metrics") and all_feature:
        with region_timer("dataset_metrics", "<parent>"):
            dataset_row = _dataset_row(config, parent, save_dir, dev)
            for row in all_feature:
                row.update(dataset_row)
            groups: dict[str, tuple] = {}
            for k in _BACKBONE_KEYS:
                bb = parent[k]
                groups[f"pred_{k}"] = (bb.pred_feats, bb.pred_fovs, bb.pred_ts)
                groups[f"gt_{k}"] = (bb.gt_feats, bb.gt_fovs, bb.gt_ts)
            _save_embeddings(save_dir, groups)

    dump_timings_csv(save_dir / "timings.csv")
    return all_pixel, all_mask, all_feature


def _cell(v) -> str:
    """A CSV cell as pandas' ``to_csv`` writes it: NaN and None empty."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return str(v)


def write_csv(path: Path, rows: list[dict]) -> None:
    """Rows as a CSV, the columns in order of first appearance."""
    columns: dict[str, None] = {}
    for row in rows:
        columns.update(dict.fromkeys(row))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(columns)
        for row in rows:
            w.writerow([_cell(row.get(c)) for c in columns])


def save_metrics(config: dict, pixel_metrics=None, mask_metrics=None, feature_metrics=None) -> None:
    """Each tier's rows as a CSV and an ``.npy`` of the row dicts."""
    save = dict(config.get("save") or {})
    save_dir = Path(save.get("save_dir", "dynacell_eval"))
    save_dir.mkdir(parents=True, exist_ok=True)
    tiers = {"mask": mask_metrics, "pixel": pixel_metrics, "feature": feature_metrics}
    for tier, csv_key, csv_default, npy_key, npy_default in _TIERS:
        rows = tiers[tier]
        if not rows:
            continue
        write_csv(save_dir / save.get(csv_key, csv_default), rows)
        np.save(save_dir / save.get(npy_key, npy_default), np.asarray(rows, dtype=object), allow_pickle=True)


def _final_metrics_cache_valid(config: dict) -> bool:
    """Whether the saved per-tier ``.npy`` files can stand for a new run."""
    force = dict(config.get("force_recompute") or {})
    if force.get("all") or force.get("final_metrics"):
        return False
    save = dict(config.get("save") or {})
    save_dir = Path(save.get("save_dir", "dynacell_eval"))
    pixel_ok = (save_dir / save.get("pixel_metrics_filename", "pixel_metrics.npy")).exists()
    mask_path = save_dir / save.get("mask_metrics_filename", "mask_metrics.npy")
    mask_ok = mask_path.exists()
    feature_ok = ((save_dir / save.get("feature_metrics_filename", "feature_metrics.npy")).exists()
                  if config.get("compute_feature_metrics") else True)
    if mask_ok and config.get("compute_instance_ap"):
        rows = np.load(mask_path, allow_pickle=True).tolist()
        if not rows or "mAP" not in rows[0] or "instance_dice" not in rows[0]:
            return False
    return pixel_ok and mask_ok and feature_ok


def _load_cached_final_metrics(config: dict):
    save = dict(config.get("save") or {})
    save_dir = Path(save.get("save_dir", "dynacell_eval"))

    def load(name, default):
        p = save_dir / save.get(name, default)
        return np.load(p, allow_pickle=True).tolist() if p.exists() else []

    return (load("pixel_metrics_filename", "pixel_metrics.npy"), load("mask_metrics_filename", "mask_metrics.npy"),
            load("feature_metrics_filename", "feature_metrics.npy"))


def precompute_gt_artifacts(config: dict, device="cuda") -> dict[str, int]:
    """Fill the GT artifact cache (``io.gt_cache_dir``) with what
    ``config["build"]`` turns on (``masks``, ``instances``, ``cp_features``,
    ``deep_features``) without scoring, so later ``evaluate`` runs hit it.
    Returns per-artifact counts. The FOVs run on the config's ``runtime``
    executor (JAX runs them one after the other)."""
    io = dict(config.get("io") or {})
    if not io.get("gt_cache_dir"):
        raise ValueError("precompute-gt needs io.gt_cache_dir")
    build = dict(config.get("build")
                 or {"masks": True, "instances": True, "cp_features": False, "deep_features": False})
    dev = resolve_device(device)
    models = load_eval_models(config, device=dev)
    gt_ctx = init_cache_context(io["gt_cache_dir"], source="gt", plate_path=str(io.get("gt_path")),
                                channel_name=io.get("gt_channel_name"),
                                force=dict(config.get("force_recompute") or {}), require_complete=False)
    gt_plate = open_ome_zarr(io["gt_path"])
    names = [n for n, _ in gt_plate.positions()]
    include = io.get("include_fovs")
    if include:
        names = [n for n in names if n in set(include)]
    executor = make_fov_executor(resolve_runtime(config.get("runtime")))
    try:
        futures = [executor.submit(_precompute_fov, config, build, models, gt_ctx, name, gt_plate[name], dev)
                   for name in names]
        per_fov = [f.result() for f in futures]
    finally:
        executor.shutdown(wait=True)
    flush_manifest(gt_ctx)
    return {k: sum(c[k] for c in per_fov) for k in ("masks", "instances", "cp_features", "deep_features")}


def _precompute_fov(config: dict, build: dict, models: EvalModels, gt_ctx: CacheContext, pos_name: str,
                    pos, device) -> dict[str, int]:
    io = dict(config.get("io") or {})
    target_name = config.get("target_name", "nucleus")
    spacing = config.get("spacing", [1.0, 1.0, 1.0])
    backend = _cfg(config, "segmentation", "backend", default="native")
    patch_size = int(_cfg(config, "feature_metrics", "patch_size", default=64))
    cp_glcm = _cfg(config, "feature_metrics", "cp", "glcm", default=None)
    target = _read_stack(pos, io.get("gt_channel_name"))
    seg = _Segmenter(target_name, spacing, backend, models.seg_model, device)
    counts = {"masks": 0, "instances": 0, "cp_features": 0, "deep_features": 0}
    if build.get("masks"):
        fov_masks(gt_ctx, "gt", target_name, pos_name, lambda: seg.masks("gt", target), backend=backend)
        counts["masks"] += 1
    gt_inst = None
    if build.get("instances") or build.get("cp_features") or build.get("deep_features"):
        gt_inst = fov_nucleus_instances(gt_ctx, "gt", target_name, pos_name, lambda: seg.instances("gt", target),
                                        backend=backend)
        counts["instances"] += 1
    for t in range(target.shape[0]):
        if build.get("cp_features") and gt_inst is not None:
            fov_cp_features(gt_ctx, "gt", pos_name, t,
                            lambda: cp_regionprops(target[t], gt_inst[t], spacing, glcm_cfg=cp_glcm, device=device))
            counts["cp_features"] += 1
        if build.get("deep_features") and gt_inst is not None and models.extractors:
            gt_crops = build_crops(target[t], gt_inst[t], patch_size)
            for kind, extractor in models.extractors.items():
                fov_deep_features(gt_ctx, "gt", kind, pos_name, t, lambda: features_from_crops(gt_crops, extractor),
                                  params={"patch_size": patch_size})
                counts["deep_features"] += 1
    _logger.info(f"precompute-gt: {pos_name} done")
    return counts


def evaluate_model(config: dict, device="cuda"):
    """Evaluate and save one leaf config, unless the final-metrics cache
    holds its results."""
    if _final_metrics_cache_valid(config):
        _logger.info("final metrics cache valid; skipping recompute")
        return _load_cached_final_metrics(config)
    pixel, mask, feature = evaluate_predictions(config, device=device)
    save_metrics(config, pixel_metrics=pixel, mask_metrics=mask, feature_metrics=feature)
    return pixel, mask, feature


def _merge_condition(base: dict, overrides: dict) -> dict:
    """Deep merge of one condition's overrides onto the base config."""
    out = {}
    for k in set(base) | set(overrides):
        if isinstance(base.get(k), dict) and isinstance(overrides.get(k), dict):
            out[k] = _merge_condition(base[k], overrides[k])
        elif k in overrides:
            out[k] = overrides[k]
        else:
            out[k] = base[k]
    return out


def evaluate_predictions_grouped(config: dict, device="cuda") -> list[tuple[str, tuple]]:
    """Evaluate every condition of a group into ``save_dir/eval_<name>``,
    then run the cross-condition probe over those directories."""
    conditions = dict(config.get("conditions") or {})
    if not conditions:
        raise ValueError("grouped evaluation requires a non-empty 'conditions' mapping")
    results = []
    eval_dirs = []
    base_dir = Path(_cfg(config, "save", "save_dir", default="dynacell_eval"))
    for name, overrides in conditions.items():
        leaf = _merge_condition({k: v for k, v in config.items() if k != "conditions"}, overrides or {})
        leaf["save"] = {**dict(config.get("save") or {}), "save_dir": str(base_dir / f"eval_{name}")}
        results.append((name, evaluate_model(leaf, device=device)))
        eval_dirs.append(Path(leaf["save"]["save_dir"]))
    if config.get("compute_feature_metrics"):
        from viscy_tpu_torch.apps.dynacell.eval.cross_condition import run_for_group

        run_for_group(eval_dirs, device=device)
    return results
