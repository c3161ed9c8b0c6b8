"""DTW template building and track alignment for pseudotime (counterpart of
``viscy_tpu/apps/dynaclr/pseudotime/dtw_alignment.py``), on
:class:`~viscy_tpu_torch.evaluation.anndata_lite.Frame` tables.

- :func:`build_template`: per-dataset z-scoring and the optional PCA in
  float64 on the device (the exact PCA of
  :func:`viscy_tpu_torch.evaluation.dimensionality_reduction.pca_fit`;
  sklearn's, which JAX calls without a ``random_state``, is randomized
  above 500 rows and columns), event-anchored crops, DBA into one template
  trajectory (host kernel H2), label propagation and real-time calibration
  from ``t_relative_minutes``;
- :func:`resample_template_to_frame_interval`;
- :func:`dtw_align_tracks`: subsequence DTW of every track against the
  template, the length-normalized cost and path-skew gates, per-frame
  pseudotime, warping speed, propagated labels, pre/aligned/post regions;
- :func:`classify_response_groups`, :func:`alignment_results_to_dataframe`
  (a ``Frame`` of columns) and :func:`extract_dtw_pseudotime`.

Copied from JAX (ROADMAP.md Queue 3): in label propagation a class first
seen after other template positions were filled gets no zeros for the
tracks before it, so its fractions are taken over fewer tracks.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from viscy_tpu_torch.apps.dynaclr.pseudotime.alignment import track_groups
from viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_core import dtw_align_pair, subsequence_align
from viscy_tpu_torch.evaluation._ops import host, on, resolve_device
from viscy_tpu_torch.evaluation.anndata_lite import Frame

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["DEFAULT_POSITIVE_CLASSES", "AlignmentResult", "PCAProjection", "TemplateResult",
           "alignment_results_to_dataframe", "build_template", "classify_response_groups", "dtw_align_tracks",
           "extract_dtw_pseudotime", "resample_template_to_frame_interval"]

#: annotation column -> positive class, used by the signal functions when no
#: ``positive_classes`` is given
DEFAULT_POSITIVE_CLASSES: dict[str, str] = {"infection_state": "infected", "organelle_state": "remodel"}


class PCAProjection:
    """A fitted PCA's projection, under sklearn's attribute names:
    ``transform(x) = (x - mean_) @ components_.T``."""

    def __init__(self, components, mean, explained_variance=None, explained_variance_ratio=None) -> None:
        self.components_ = np.asarray(components, np.float64)
        self.mean_ = np.asarray(mean, np.float64)
        self.n_components_ = self.components_.shape[0]
        self.explained_variance_ = (np.ones(self.n_components_) if explained_variance is None
                                    else np.asarray(explained_variance, np.float64))
        self.explained_variance_ratio_ = (None if explained_variance_ratio is None
                                          else np.asarray(explained_variance_ratio, np.float64))

    def transform(self, x) -> np.ndarray:
        return (np.asarray(x, np.float64) - self.mean_) @ self.components_.T


class TemplateResult(NamedTuple):
    """An event-anchored response template."""

    template: np.ndarray  # (T, D)
    template_id: str
    pca: PCAProjection | None
    zscore_params: dict[str, tuple[np.ndarray, np.ndarray]]
    template_cell_ids: list[tuple[str, str, int]]
    n_input_tracks: int
    explained_variance: float | None
    template_labels: dict[str, dict[str, np.ndarray]] | None
    time_calibration: np.ndarray | None = None  # (T,) mean t_relative_minutes


class AlignmentResult(NamedTuple):
    """DTW alignment of one track: ``path_skew`` is the primary gate
    (degenerate, non-diagonal warps), ``length_normalized_cost`` the
    secondary (stereotypy)."""

    cell_uid: str
    dataset_id: str
    fov_name: str
    track_id: int
    timepoints: np.ndarray
    pseudotime: np.ndarray
    dtw_cost: float
    length_normalized_cost: float
    path_skew: float
    warping_path: np.ndarray
    warping_speed: np.ndarray
    propagated_labels: dict[str, dict[str, np.ndarray]] | None
    alignment_region: np.ndarray  # per frame: "pre" | "aligned" | "post"


def _zscore(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``((x - mean) / std, mean, std)``, the population std with one under
    1e-10 taken as 1."""
    mean = x.mean(dim=0)
    std = ((x - mean) ** 2).mean(dim=0).sqrt()
    std = torch.where(std < 1e-10, torch.ones_like(std), std)
    return (x - mean) / std, mean, std


def _unit_rows(x: torch.Tensor, pca: PCAProjection | None) -> np.ndarray:
    """PCA-projected (when given), each row scaled to unit length (norms
    floored at 1e-12), back on the host."""
    if pca is not None:
        x = (x - on(pca.mean_, x.device)) @ on(pca.components_, x.device).T
    return host(x / x.norm(dim=1, keepdim=True).clamp_min(1e-12))


def _key_positions(obs: Frame) -> dict[tuple, int]:
    keys = zip([str(f) for f in obs["fov_name"].tolist()], np.asarray(obs["track_id"]).astype(int).tolist(),
               np.asarray(obs["t"]).astype(int).tolist())
    return {k: i for i, k in enumerate(keys)}


def _track_trajectories(obs: Frame, df: Frame, min_track_timepoints: int):
    """Per track of ``df`` (``groupby(["fov_name", "track_id"])`` order):
    ``(fov, track_id, store rows, timepoints, df rows)`` ordered by ``t``,
    keeping the frames found in the store; tracks with fewer found frames
    than ``min_track_timepoints`` are left out."""
    where = _key_positions(obs)
    t_all = np.asarray(df["t"])
    out = []
    for (fov, tid), rows in track_groups(df).items():
        rows = rows[np.argsort(t_all[rows], kind="stable")]
        locs = [where.get((str(fov), int(tid), int(t))) for t in t_all[rows].astype(int).tolist()]
        valid = np.asarray([loc is not None for loc in locs], bool)
        if valid.sum() < min_track_timepoints:
            continue
        out.append((str(fov), int(tid), np.asarray([loc for loc in locs if loc is not None], np.int64),
                    t_all[rows][valid], rows[valid]))
    return out


def build_template(adata_dict: dict, aligned_df_dict: dict[str, Frame], pca_n_components: int | None = 20,
                   pca_variance_threshold: float | None = None, dba_max_iter: int = 30, dba_tol: float = 1e-5,
                   dba_init: str = "medoid", crop_window: int | dict[str, int] | None = None,
                   propagate_columns: list[str] | None = None, template_id: str = "template",
                   random_state: int = 42, device: str = "cuda") -> TemplateResult:
    """A DTW pseudotime template from anchored trajectories (any anchored
    event, given ``aligned_df_dict`` carries ``t_perturb`` from
    :func:`~viscy_tpu_torch.apps.dynaclr.pseudotime.alignment.assign_t_perturb`)."""
    from viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_core import dba
    from viscy_tpu_torch.evaluation.dimensionality_reduction import pca_fit

    dev = resolve_device(device)
    zscored, zparams = {}, {}
    for dataset_id, adata in adata_dict.items():
        z, mean, std = _zscore(on(np.asarray(adata.X), dev))
        zscored[dataset_id] = z
        zparams[dataset_id] = (host(mean), host(std))
    pca, explained = None, None
    if pca_n_components or pca_variance_threshold:
        pooled = torch.cat(list(zscored.values()))
        n_max = min(pooled.shape)
        _, ratio, vt, pmean = pca_fit(pooled, n_max)
        ratio = host(ratio)
        if pca_variance_threshold is not None:
            n = int(np.searchsorted(np.cumsum(ratio), pca_variance_threshold, side="right") + 1)
        else:
            n = min(pca_n_components, n_max - 1)
        var = host(((pooled - pmean) @ vt[:n].T).var(dim=0))
        pca = PCAProjection(host(vt[:n]), host(pmean), var, ratio[:n])
        explained = float(ratio[:n].sum())
    sequences: list[np.ndarray] = []
    cell_ids: list[tuple[str, str, int]] = []
    label_rows: list[tuple[Frame, np.ndarray]] = []
    rel_times: list[np.ndarray] = []
    for dataset_id, adata in adata_dict.items():
        df = aligned_df_dict[dataset_id]
        win = crop_window.get(dataset_id) if isinstance(crop_window, dict) else crop_window
        for fov, tid, rows, timepoints, df_rows in _track_trajectories(adata.obs, df, 3):
            if win is not None and "t_perturb" in df:
                tp = int(df["t_perturb"][df_rows[0]])
                sel = (timepoints >= tp - win) & (timepoints <= tp + win)
                if sel.sum() < 3:
                    continue
                rows, timepoints, df_rows = rows[sel], timepoints[sel], df_rows[sel]
            sequences.append(_unit_rows(zscored[dataset_id][torch.as_tensor(rows, device=dev)], pca))
            cell_ids.append((dataset_id, fov, tid))
            label_rows.append((df, df_rows))
            rel_times.append(np.asarray(df["t_relative_minutes"], float)[df_rows] if "t_relative_minutes" in df
                             else np.full(len(df_rows), np.nan))
    if not sequences:
        raise ValueError("No usable tracks to build a template from.")
    template = dba(sequences, max_iter=dba_max_iter, tol=dba_tol, init=dba_init, random_state=random_state)
    template = template / np.maximum(np.linalg.norm(template, axis=1, keepdims=True), 1e-12)
    T = len(template)
    # every build sequence aligned to the template once: label propagation and time calibration ride on the paths
    labels: dict[str, dict[str, list[list[float]]]] | None = None
    time_acc, time_cnt = np.zeros(T), np.zeros(T)
    if propagate_columns:
        labels = {col: {} for col in propagate_columns}
    for seq, (df, df_rows), rel in zip(sequences, label_rows, rel_times):
        path, _ = subsequence_align(template, seq)
        for ti, qi in path.tolist():
            if np.isfinite(rel[qi]):
                time_acc[ti] += rel[qi]
                time_cnt[ti] += 1
            if labels is None:
                continue
            for col in labels:
                if col not in df:
                    continue
                val = df[col][df_rows[qi]]
                if val is None or val == "" or (isinstance(val, float) and np.isnan(val)):  # pandas' NaN
                    continue
                per_class = labels[col].setdefault(str(val), [[] for _ in range(T)])
                per_class[ti].append(1.0)
                for other_cls, other in labels[col].items():
                    if other_cls != str(val):
                        other[ti].append(0.0)
    template_labels = None
    if labels is not None:
        template_labels = {col: {cls: np.asarray([np.mean(v) if v else np.nan for v in per_pos])
                                 for cls, per_pos in classes.items()}
                           for col, classes in labels.items() if classes}
    time_calibration = np.where(time_cnt > 0, time_acc / np.maximum(time_cnt, 1), np.nan)
    if np.isnan(time_calibration).all():
        time_calibration = None
    elif np.isnan(time_calibration).any():
        good = np.flatnonzero(~np.isnan(time_calibration))
        time_calibration = np.interp(np.arange(T), good, time_calibration[good])
    return TemplateResult(template=template, template_id=template_id, pca=pca, zscore_params=zparams,
                          template_cell_ids=cell_ids, n_input_tracks=len(sequences), explained_variance=explained,
                          template_labels=template_labels, time_calibration=time_calibration)


def resample_template_to_frame_interval(template_result: TemplateResult,
                                        target_frame_interval_minutes: float) -> TemplateResult:
    """The template interpolated onto a frame grid of the target interval,
    so warps in frames stay warps in real time across datasets."""
    tc = template_result.time_calibration
    if tc is None or len(tc) < 2:
        raise ValueError("Template has no usable time_calibration; cannot resample.")
    n_new = int(round(float(tc[-1] - tc[0]) / float(target_frame_interval_minutes))) + 1
    if n_new < 2:
        raise ValueError(f"Resample to interval={target_frame_interval_minutes} min would yield only {n_new} frames.")
    tc_new = np.linspace(tc[0], tc[-1], n_new)
    tpl = template_result.template
    new_template = np.stack([np.interp(tc_new, tc, tpl[:, d]) for d in range(tpl.shape[1])], axis=1)
    new_template = new_template / np.maximum(np.linalg.norm(new_template, axis=1, keepdims=True), 1e-12)
    new_labels = None
    if template_result.template_labels is not None:
        new_labels = {col: {cls: np.interp(tc_new, tc, arr) for cls, arr in classes.items()}
                      for col, classes in template_result.template_labels.items()}
    return template_result._replace(
        template=new_template,
        template_id=f"{template_result.template_id}_resampled_{target_frame_interval_minutes:.0f}min",
        template_labels=new_labels, time_calibration=tc_new)


def _path_skew(path: np.ndarray) -> float:
    """Mean normalized L1 deviation of the warp path from its own diagonal."""
    K = len(path)
    if K < 2:
        return float("inf")
    t_span = max(path[-1, 0] - path[0, 0], 1)
    q_span = max(path[-1, 1] - path[0, 1], 1)
    k = np.arange(K)
    ideal_t = path[0, 0] + k * t_span / (K - 1)
    ideal_q = path[0, 1] + k * q_span / (K - 1)
    dev = np.abs(path[:, 0] - ideal_t) / t_span + np.abs(path[:, 1] - ideal_q) / q_span
    return float(dev.mean() / 2.0)


def dtw_align_tracks(adata, df: Frame, template_result: TemplateResult, dataset_id: str,
                     min_track_timepoints: int = 3, subsequence: bool = True,
                     device: str = "cuda") -> list[AlignmentResult]:
    """Align every track to the template. In subsequence mode (the default)
    frames before the matched region get pseudotime 0, frames after it 1,
    matched frames their template position / (T - 1)."""
    dev = resolve_device(device)
    emb = on(np.asarray(adata.X), dev)
    if dataset_id in template_result.zscore_params:
        mean, std = (on(v, dev) for v in template_result.zscore_params[dataset_id])
        z = (emb - mean) / std
    else:
        z = _zscore(emb)[0]
    template = template_result.template
    T = template.shape[0]
    results: list[AlignmentResult] = []
    for fov, tid, rows, timepoints, _ in _track_trajectories(adata.obs, df, min_track_timepoints):
        processed = _unit_rows(z[torch.as_tensor(rows, device=dev)], template_result.pca)
        n = len(processed)
        path, cost = subsequence_align(template, processed) if subsequence else dtw_align_pair(template, processed)
        lnc = float(cost) / len(path) if len(path) and np.isfinite(cost) else float("inf")
        skew = _path_skew(path)
        pt = np.full(n, np.nan)
        counts, acc = np.zeros(n), np.zeros(n)
        for ti, qi in path.tolist():
            acc[qi] += ti / max(T - 1, 1)
            counts[qi] += 1
        matched = counts > 0
        pt[matched] = acc[matched] / counts[matched]
        q_start, q_end = int(path[0, 1]), int(path[-1, 1])
        region = np.full(n, "aligned", dtype=object)
        region[:q_start] = "pre"
        region[q_end + 1:] = "post"
        pt[:q_start] = 0.0
        pt[q_end + 1:] = 1.0
        speed = np.zeros(n)
        for qi in range(n):
            tis = path[path[:, 1] == qi, 0]
            if len(tis):
                speed[qi] = (tis.max() - tis.min() + 1) / 1.0
        propagated = None
        if template_result.template_labels:
            propagated = {}
            for col, classes in template_result.template_labels.items():
                per_cls = {}
                for cls, frac in classes.items():
                    vals, vacc = np.full(n, np.nan), np.zeros(n)
                    for ti, qi in path.tolist():
                        if np.isfinite(frac[ti]):
                            vals[qi] = 0.0 if np.isnan(vals[qi]) else vals[qi]
                            vals[qi] += frac[ti]
                            vacc[qi] += 1
                    sel = vacc > 0
                    vals[sel] = vals[sel] / vacc[sel]
                    per_cls[cls] = vals
                propagated[col] = per_cls
        results.append(AlignmentResult(
            cell_uid=f"{dataset_id}/{fov}/{tid}", dataset_id=dataset_id, fov_name=fov, track_id=tid,
            timepoints=timepoints, pseudotime=pt, dtw_cost=float(cost), length_normalized_cost=lnc, path_skew=skew,
            warping_path=path, warping_speed=speed, propagated_labels=propagated, alignment_region=region))
    return results


def classify_response_groups(results: list[AlignmentResult], cost_threshold: float | None = None,
                             skew_threshold: float = 0.25) -> dict[str, list[AlignmentResult]]:
    """Responders, non-responders and degenerate warps: path skew first,
    then the length-normalized cost (``cost_threshold`` defaults to the
    median of the skew-passing tracks')."""
    skew_pass = [r for r in results if r.path_skew <= skew_threshold]
    skew_fail = [r for r in results if r.path_skew > skew_threshold]
    if cost_threshold is None:
        lncs = [r.length_normalized_cost for r in skew_pass if np.isfinite(r.length_normalized_cost)]
        cost_threshold = float(np.median(lncs)) if lncs else float("inf")
    return {"responder": [r for r in skew_pass if r.length_normalized_cost <= cost_threshold],
            "non_responder": [r for r in skew_pass if r.length_normalized_cost > cost_threshold],
            "degenerate": skew_fail}


def alignment_results_to_dataframe(results: list[AlignmentResult]) -> Frame:
    """The long table of alignment outputs, one row a (track, frame), as
    columns (JAX's DataFrame's, in its order)."""
    cols: dict[str, list] = {k: [] for k in ("cell_uid", "dataset_id", "fov_name", "track_id", "t", "pseudotime",
                                             "dtw_cost", "length_normalized_cost", "path_skew", "warping_speed",
                                             "alignment_region")}
    extra: dict[str, list] = {}
    n = 0
    for r in results:
        k = len(r.timepoints)
        for name, v in (("cell_uid", r.cell_uid), ("dataset_id", r.dataset_id), ("fov_name", r.fov_name),
                        ("track_id", r.track_id), ("dtw_cost", r.dtw_cost),
                        ("length_normalized_cost", r.length_normalized_cost), ("path_skew", r.path_skew)):
            cols[name].extend([v] * k)
        cols["t"].extend(np.asarray(r.timepoints).astype(int).tolist())
        cols["pseudotime"].extend(np.asarray(r.pseudotime, float).tolist())
        cols["warping_speed"].extend(np.asarray(r.warping_speed, float).tolist())
        cols["alignment_region"].extend(list(r.alignment_region))
        for col, classes in (r.propagated_labels or {}).items():
            for cls, vals in classes.items():
                extra.setdefault(f"propagated_{col}_{cls}", [np.nan] * n).extend(np.asarray(vals, float).tolist())
        n += k
        for v in extra.values():
            v.extend([np.nan] * (n - len(v)))
    if not n:
        return Frame()
    kinds = {"cell_uid": object, "dataset_id": object, "fov_name": object, "alignment_region": object,
             "track_id": np.int64, "t": np.int64}
    out = {k: np.asarray(v, dtype=kinds.get(k, np.float64)) for k, v in cols.items()}
    out.update({k: np.asarray(v, np.float64) for k, v in extra.items()})
    return Frame(out)


def extract_dtw_pseudotime(results: list[AlignmentResult]) -> Frame:
    """(fov_name, track_id, t, pseudotime) for joining onto ``obs``."""
    df = alignment_results_to_dataframe(results)
    return Frame({k: df[k] for k in ("fov_name", "track_id", "t", "pseudotime")}) if len(df) else df
