"""Per-position time series of spectral metrics of virtual-staining
predictions, the compute leg of ``dynacell spectral-eval`` (counterpart of
``viscy_tpu/apps/dynacell/eval/spectral_eval.py``; reference
``evaluation/spectral_pcc/evaluate.py``).

At every timepoint of every position of a GT / prediction plate pair: the
pixel metrics (PCC, PSNR, SSIM), resolution (FSC, DCR), the spectral-PCC
family (raw, OTF, frozen noise floor, Wiener, SNR-squared, log-SNR, FRCW
and frozen FRCW), band-limited PCC / SSIM at the DCR, FSC and OTF cutoffs,
the multiband explainable variance, in 3-D and on the mid-Z slice, and the
DCR-A0 reliability weight; each position's ``metrics.csv`` (one row a
timepoint, JAX's columns in JAX's order, written without pandas as
``DataFrame.to_csv(index=False)`` writes them) and ``slices.npz`` (mid-Z
slices of the first, middle and last timepoint).

Every volume is read once per timepoint and its metrics computed on the
requested device in float64 (:mod:`.spectral`, :mod:`.decorr`); the
per-bin curves come to the host. The figures (``plot``, JAX's default mode
``all``) need matplotlib, which the card's machine lacks: they are refused
by name before any work starts, and the port's command defaults to
``compute``.

The config is JAX's plain dict::

    input_zarr: gt.zarr          # ground truth HCS plate
    pred_zarr: pred.zarr         # predictions (null -> the same store)
    channel: Nuclei              # or gt_channel / pred_channel
    positions: [A/1/0]           # null -> all
    spacing: [2.0, 0.5, 0.5]     # when the store's scale is all 1.0
    output_dir: eval_out/
    fsc: {threshold: 0.143}
    dcr: {num_radii: 100, num_highpass: 10}
    spectral_pcc: {bin_delta: 1.0, nbins_low: 3, tail_fraction: 0.2}
    bandlimited: {order: 2, win_size: 7}
    optics: {numerical_aperture: 1.35, wavelength_emission: 0.698}
"""

from __future__ import annotations

import logging
import math
from pathlib import Path

import numpy as np
import torch

from viscy_tpu_torch.apps.dynacell.eval._ops import on, resolve_device
from viscy_tpu_torch.apps.dynacell.eval.decorr import (
    _DCR_KEYS,
    band_limited_pcc,
    band_limited_ssim,
    dcr_curve,
    dcr_resolution,
    frc_weights,
    otf_cutoff,
    psnr,
    spectral_pcc_frcw,
    ssim,
)
from viscy_tpu_torch.apps.dynacell.eval.spectral import (
    _radial_bins,
    estimate_gt_noise_floor,
    estimate_noise_floor,
    fsc_resolution,
    multiband_ev_score,
    radial_power_spectrum,
    spectral_pcc,
    spectral_weights,
)
from viscy_tpu_torch.training.cli_utils import rows_to_csv

__all__ = [
    "corr_coef",
    "compute_gt_reliability",
    "compute_frozen_frcw_weights",
    "compute_timepoint_metrics",
    "compute_timepoint_metrics_2d",
    "dcr_reliability_weights",
    "evaluate_position",
    "resolve_spacing",
    "rows_to_csv",
    "compute",
    "main",
]

log = logging.getLogger(__name__)

_SPCC_SHARED_KEYS = ("bin_delta", "cutoff", "apodization", "nbins_low")

PLOT_REFUSAL = ("the figures of dynacell spectral-eval (--mode plot or all) are not ported to viscy_tpu_torch: "
                "they need matplotlib, which the card's machine lacks, and wait for a plotting decision "
                "(ROADMAP.md Queue 1 item 9); run --mode compute")


def corr_coef(a, b, mask=None, device="cuda") -> float:
    """Pearson correlation, inside a boolean foreground ``mask`` when given
    (NaN for a constant input)."""
    dev = resolve_device(device)
    a, b = on(a, dev), on(b, dev)
    if a.shape != b.shape:
        raise ValueError(f"Inputs must be same shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if mask is not None:
        a, b = a[mask], b[mask]
    num = float(((a - a.mean()) * (b - b.mean())).mean())
    denom = float(a.std(unbiased=False)) * float(b.std(unbiased=False))
    return num / denom if denom > 0 else float("nan")


def _prepare_masked_inputs(gt_f: torch.Tensor, pred_f: torch.Tensor):
    """The GT's foreground (its zeros are registration corrections) and
    copies of both volumes with those zeros filled by each one's foreground
    mean, spectrally invisible: ``(gt filled, pred filled, mask or None,
    data range, zero fraction)``."""
    mask = gt_f > 0
    if not bool(mask.all()) and bool(mask.any()):
        fg = gt_f[mask]
        gt_filled = torch.where(mask, gt_f, fg.mean())
        pred_filled = torch.where(mask, pred_f, pred_f[mask].mean())
        zero_frac = 1.0 - float(mask.sum()) / float(mask.numel())
        return gt_filled, pred_filled, mask, float(fg.max() - fg.min()), zero_frac
    return gt_f, pred_f, None, float(gt_f.max() - gt_f.min()), 0.0


def compute_gt_reliability(gt_2d, spacing_2d, dcr_kwargs: dict, device="cuda") -> tuple[float, float]:
    """DCR ``(A0, r0)`` of a GT slice, the first valid peak (the unfiltered
    curve's when it has one): its amplitude tracks the image's SNR. (0, 0)
    for an empty image or no peak."""
    gt_f = on(gt_2d, resolve_device(device))
    mask = torch.isfinite(gt_f) & (gt_f != 0)
    if not bool(mask.any()):
        return 0.0, 0.0
    if not bool(mask.all()):
        gt_f = torch.where(mask, gt_f, gt_f[mask].mean())
    kw = {k: v for k, v in (dcr_kwargs or {}).items() if k in _DCR_KEYS}
    all_peaks = dcr_curve(gt_f, spacing_2d, device=gt_f.device, **kw)[3]
    valid = all_peaks[:, 1] > 0
    if valid.any():
        idx = int(np.argmax(valid))
        return float(all_peaks[idx, 1]), float(all_peaks[idx, 0])
    return 0.0, 0.0


def compute_frozen_frcw_weights(frames_2d: list, spectral_pcc_kwargs: dict, device="cuda") -> np.ndarray:
    """Frozen FRCW weights: each early frame's one-image FRC weights, their
    median over the frames, median-smoothed, made non-increasing, the
    lowest ``frcw_nbins_low`` bins zeroed."""
    from scipy.ndimage import median_filter

    bin_delta = spectral_pcc_kwargs.get("bin_delta", 1.0)
    nbins_low = spectral_pcc_kwargs.get("frcw_nbins_low", 3)
    smooth_window = spectral_pcc_kwargs.get("frcw_smooth_window", 5)
    per_frame = [frc_weights(f, bin_delta=bin_delta, device=device) for f in frames_2d]
    frozen = np.median(np.stack(per_frame), axis=0)
    sw = int(smooth_window) | 1
    sw = max(3, min(sw, len(frozen) | 1))
    frozen = median_filter(frozen, size=sw)
    frozen = np.maximum.accumulate(frozen[::-1])[::-1]
    frozen[: min(int(nbins_low), len(frozen))] = 0
    return frozen


def _k90_diagnostic(gt_filled: torch.Tensor, spacing, shared_kw: dict, tail_fraction: float) -> float:
    """The frequency (a fraction of the Nyquist) below which 90 % of the
    spectral weight's mass lies."""
    bin_delta = shared_kw.get("bin_delta", 1.0)
    radii, power = radial_power_spectrum(gt_filled, spacing=spacing, bin_delta=bin_delta, device=gt_filled.device)
    nf = estimate_noise_floor(radii, power, tail_fraction)
    w_bins = spectral_weights(radii, power, nf, cutoff=shared_kw.get("cutoff"))
    nbl = min(int(shared_kw.get("nbins_low", 0)), len(w_bins))
    if nbl > 0:
        w_bins = w_bins.copy()
        w_bins[:nbl] = 0.0
    _, bid = _radial_bins(tuple(gt_filled.shape), spacing, bin_delta, gt_filled.device)
    counts = torch.bincount(bid[bid >= 0], minlength=len(w_bins)).cpu().numpy()
    mass = w_bins * counts[: len(w_bins)]
    total = mass.sum()
    if total <= 0:
        return 0.0
    cum = np.cumsum(mass) / total
    k_nyq = min(1.0 / (2.0 * s) for s in spacing)
    idx = min(int(np.searchsorted(cum, 0.9)), len(radii) - 1)
    return float(radii[idx]) / k_nyq


def _spectral_pcc_variants(pred_filled, gt_filled, spacing, spectral_pcc_kwargs: dict, otf_cut, ref_noise_floor,
                           suffix: str = "") -> dict[str, float]:
    """The spectral-PCC battery the 3-D and 2-D rows share."""
    dev = gt_filled.device
    m: dict[str, float] = {}
    spcc_kw = {k: v for k, v in spectral_pcc_kwargs.items() if not k.startswith("frcw_") and k != "tail_fraction"}
    m[f"Spectral_PCC{suffix}"] = spectral_pcc(pred_filled, gt_filled, spacing=spacing, device=dev, **spcc_kw)
    if otf_cut is not None:
        m[f"Spectral_PCC_OTF{suffix}"] = spectral_pcc(pred_filled, gt_filled, spacing=spacing, device=dev,
                                                      **dict(spcc_kw, cutoff=otf_cut))
    shared_kw = {k: v for k, v in spectral_pcc_kwargs.items() if k in _SPCC_SHARED_KEYS}
    if ref_noise_floor is not None:
        m[f"Spectral_PCC_Fixed{suffix}"] = spectral_pcc(pred_filled, gt_filled, spacing=spacing,
                                                        noise_floor=ref_noise_floor, device=dev, **shared_kw)
    # the timepoint's own noise floor, shared by the Wiener, SNR-squared and log-SNR weightings
    tail = spectral_pcc_kwargs.get("tail_fraction", 0.2)
    radii, power = radial_power_spectrum(gt_filled, spacing=spacing, bin_delta=shared_kw.get("bin_delta", 1.0),
                                         device=dev)
    nf_tp = estimate_noise_floor(radii, power, tail)
    m[f"k90{suffix}"] = _k90_diagnostic(gt_filled, spacing, shared_kw, tail)
    for name, weighting in (("Wiener", "wiener"), ("SNR2", "snr_squared"), ("LogSNR", "log_snr")):
        m[f"Spectral_PCC_{name}{suffix}"] = spectral_pcc(pred_filled, gt_filled, spacing=spacing, noise_floor=nf_tp,
                                                         weighting=weighting, device=dev, **shared_kw)
    m[f"Multiband_EV_NC{suffix}"] = multiband_ev_score(pred_filled, gt_filled, spacing=spacing,
                                                       noise_corrected=True, device=dev)[0]
    m[f"Multiband_EV_PCC{suffix}"] = multiband_ev_score(pred_filled, gt_filled, spacing=spacing,
                                                        noise_corrected=False, device=dev)[0]
    return m


def _bandlimited_battery(pred_filled, gt_filled, spacing, bandlimited_kwargs: dict,
                         cutoffs: dict[str, float | None]) -> dict[str, float]:
    """Band-limited PCC and SSIM at every usable cutoff."""
    bl_kw = {k: v for k, v in bandlimited_kwargs.items() if k != "method"}
    ssim_extra = {k: bl_kw.pop(k) for k in ("win_size", "data_range") if k in bl_kw}
    m: dict[str, float] = {}
    for label, cut in cutoffs.items():
        if cut is None or not np.isfinite(cut) or cut <= 0:
            continue
        kw = dict(spacing=spacing, cutoff=cut, device=gt_filled.device, **bl_kw)
        m[f"BL_PCC_{label}"] = band_limited_pcc(pred_filled, gt_filled, **kw)
        m[f"BL_SSIM_{label}"] = band_limited_ssim(pred_filled, gt_filled, **kw, **ssim_extra)
    return m


def _otf(optics: dict | None) -> float | None:
    if optics is None:
        return None
    return otf_cutoff(optics["numerical_aperture"], optics["wavelength_emission"],
                      modality=optics.get("modality", "widefield"))


def _inverse(res: float) -> float | None:
    return 1.0 / res if np.isfinite(res) and res > 0 else None


def compute_timepoint_metrics(gt, pred, spacing, fsc_kwargs: dict, dcr_kwargs: dict,
                              spectral_pcc_kwargs: dict | None = None, bandlimited_kwargs: dict | None = None,
                              optics: dict | None = None, ref_noise_floor: float | None = None,
                              device="cuda") -> dict[str, float]:
    """Pixel, resolution and spectral metrics of one 3-D timepoint."""
    dev = resolve_device(device)
    gt_f, pred_f = on(gt, dev), on(pred, dev)
    gt_filled, pred_filled, mask, data_range, zero_frac = _prepare_masked_inputs(gt_f, pred_f)
    metrics: dict[str, float] = {
        "PCC": corr_coef(gt_f, pred_f, mask=mask, device=dev),
        "PSNR": psnr(gt_f, pred_f, data_range=data_range, mask=mask, device=dev),
        "SSIM": ssim(gt_f, pred_f, data_range=data_range, device=dev),
        "zero_frac": zero_frac,
    }
    fsc = fsc_resolution(gt_filled, pred_filled, spacing=spacing, device=dev, **(fsc_kwargs or {}))
    metrics["FSC_XY"] = fsc["xy"]
    metrics["FSC_Z"] = fsc["z"]
    fsc_gt = fsc_resolution(gt_filled, spacing=spacing, device=dev, **(fsc_kwargs or {}))
    metrics["FSC_GT_XY"] = fsc_gt["xy"]
    metrics["FSC_GT_Z"] = fsc_gt["z"]
    dcr = dcr_resolution(pred_filled, spacing, device=dev, **(dcr_kwargs or {}))
    metrics["DCR_XY"] = dcr["xy"]
    metrics["DCR_Z"] = dcr["z"]
    otf_cut = _otf(optics)
    if spectral_pcc_kwargs is not None:
        metrics.update(_spectral_pcc_variants(pred_filled, gt_filled, spacing, spectral_pcc_kwargs, otf_cut,
                                              ref_noise_floor))
    if bandlimited_kwargs is not None:
        cutoffs = {"DCR_XY": _inverse(dcr["xy"]), "DCR_Z": _inverse(dcr["z"]), "FSC_XY": _inverse(fsc["xy"]),
                   "FSC_Z": _inverse(fsc["z"]), "OTF": otf_cut}
        metrics.update(_bandlimited_battery(pred_filled, gt_filled, spacing, bandlimited_kwargs, cutoffs))
    return metrics


def compute_timepoint_metrics_2d(gt, pred, spacing, dcr_kwargs: dict, spectral_pcc_kwargs: dict | None = None,
                                 bandlimited_kwargs: dict | None = None, optics: dict | None = None,
                                 ref_noise_floor: float | None = None,
                                 frozen_frcw_weights: np.ndarray | None = None, device="cuda") -> dict[str, float]:
    """The 2-D (mid-Z slice) battery, keys suffixed ``_2D``, with the smooth,
    FRCW and frozen-FRCW spectral PCCs that exist in 2-D only."""
    dev = resolve_device(device)
    gt_f, pred_f = on(gt, dev), on(pred, dev)
    gt_filled, pred_filled, mask, data_range, _ = _prepare_masked_inputs(gt_f, pred_f)
    metrics: dict[str, float] = {
        "PCC_2D": corr_coef(gt_f, pred_f, mask=mask, device=dev),
        "PSNR_2D": psnr(gt_f, pred_f, data_range=data_range, mask=mask, device=dev),
        "SSIM_2D": ssim(gt_f, pred_f, data_range=data_range, device=dev),
    }
    dcr_val = float(dcr_resolution(pred_filled, spacing, device=dev, **(dcr_kwargs or {})))
    metrics["DCR_2D"] = dcr_val
    otf_cut = _otf(optics)
    if spectral_pcc_kwargs is not None:
        metrics.update(_spectral_pcc_variants(pred_filled, gt_filled, spacing, spectral_pcc_kwargs, otf_cut,
                                              ref_noise_floor, suffix="_2D"))
        spcc_kw = {k: v for k, v in spectral_pcc_kwargs.items() if not k.startswith("frcw_") and k != "tail_fraction"}
        metrics["Spectral_PCC_Smooth_2D"] = spectral_pcc(pred_filled, gt_filled, spacing=spacing, smooth=True,
                                                         device=dev, **spcc_kw)
        frcw_kw = {k: v for k, v in spectral_pcc_kwargs.items() if k in ("bin_delta", "apodization")}
        metrics["Spectral_PCC_FRCW_2D"] = spectral_pcc_frcw(pred_filled, gt_filled, spacing=spacing, device=dev,
                                                            **frcw_kw)
        if frozen_frcw_weights is not None:
            metrics["Spectral_PCC_FRCW_Frozen_2D"] = spectral_pcc_frcw(
                pred_filled, gt_filled, spacing=spacing, frozen_weights=frozen_frcw_weights, device=dev, **frcw_kw)
    if bandlimited_kwargs is not None:
        cutoffs = {"DCR_2D": _inverse(dcr_val), "OTF_2D": otf_cut}
        metrics.update(_bandlimited_battery(pred_filled, gt_filled, spacing, bandlimited_kwargs, cutoffs))
    return metrics


def dcr_reliability_weights(a0_vals: np.ndarray, k_ref: int = 5) -> np.ndarray:
    """Per-timepoint reliability weights from the DCR-A0 trajectory: 1 at
    the early (high-SNR) level, 0 at the late (bleached) one."""
    a_good = float(np.median(a0_vals[:k_ref]))
    a_bad = float(np.median(a0_vals[-k_ref:]))
    if a_good <= 0:
        return np.zeros_like(a0_vals)
    if (a_good - a_bad) < 1e-6:
        return np.ones_like(a0_vals)
    w = np.clip((a0_vals - a_bad) / (a_good - a_bad), 0.0, 1.0)
    return np.where(np.isfinite(a0_vals), w, 0.0)


def evaluate_position(pos_name: str, pos_gt, pos_pred, gt_ch_idx: int, pred_ch_idx: int, spacing, cfg: dict,
                      device="cuda") -> list[dict]:
    """Every timepoint of one position: one row (a dict) a timepoint, its
    keys in the columns' order: ``timepoint``, the metrics in the order of
    their first appearance, then ``DCR_w``; a metric a row lacks is NaN."""
    dev = resolve_device(device)
    fsc_kwargs = dict(cfg.get("fsc") or {})
    dcr_kwargs = dict(cfg.get("dcr") or {})
    spectral_pcc_kwargs = dict(cfg["spectral_pcc"]) if cfg.get("spectral_pcc") is not None else None
    bandlimited_kwargs = dict(cfg["bandlimited"]) if cfg.get("bandlimited") is not None else None
    optics_kwargs = dict(cfg["optics"]) if cfg.get("optics") is not None else None

    gt_data, pred_data = pos_gt.data, pos_pred.data
    n_timepoints = gt_data.shape[0]
    mid_z = gt_data.shape[2] // 2
    spacing_2d = list(spacing)[1:]

    ref_noise_floor = frozen_frcw = None
    if spectral_pcc_kwargs is not None:
        ref_noise_floor = estimate_gt_noise_floor(
            gt_data[0, gt_ch_idx], spacing, bin_delta=spectral_pcc_kwargs.get("bin_delta", 1.0),
            tail_fraction=spectral_pcc_kwargs.get("tail_fraction", 0.2), device=dev)
        log.info("  Reference noise floor (t=0): %.4f", ref_noise_floor)
        frames = [gt_data[t, gt_ch_idx, mid_z] for t in range(min(5, n_timepoints))]
        frozen_frcw = compute_frozen_frcw_weights(frames, spectral_pcc_kwargs, device=dev)
        log.info("Frozen FRCW: %d/%d nonzero, total mass=%.3f", int((frozen_frcw > 0).sum()), len(frozen_frcw),
                 float(frozen_frcw.sum()))

    rows = []
    for t in range(n_timepoints):
        log.info("  timepoint %d / %d", t + 1, n_timepoints)
        gt_vol, pred_vol = on(gt_data[t, gt_ch_idx], dev), on(pred_data[t, pred_ch_idx], dev)
        m = compute_timepoint_metrics(gt_vol, pred_vol, spacing, fsc_kwargs, dcr_kwargs, spectral_pcc_kwargs,
                                      bandlimited_kwargs, optics_kwargs, ref_noise_floor, device=dev)
        m.update(compute_timepoint_metrics_2d(gt_vol[mid_z], pred_vol[mid_z], spacing_2d, dcr_kwargs,
                                              spectral_pcc_kwargs, bandlimited_kwargs, optics_kwargs,
                                              ref_noise_floor, frozen_frcw_weights=frozen_frcw, device=dev))
        m["DCR_A0"], m["DCR_r0"] = compute_gt_reliability(gt_vol[mid_z], spacing_2d, dcr_kwargs, device=dev)
        m["timepoint"] = t
        rows.append(m)
        del gt_vol, pred_vol

    columns = list(dict.fromkeys(k for r in rows for k in r))
    if "DCR_A0" in columns:
        weights = dcr_reliability_weights(np.array([r.get("DCR_A0", math.nan) for r in rows], np.float64))
        for r, w in zip(rows, weights):
            r["DCR_w"] = float(w)
        columns.append("DCR_w")
    columns = ["timepoint"] + [c for c in columns if c != "timepoint"]
    return [{c: r.get(c, math.nan) for c in columns} for r in rows]


def resolve_spacing(pos, cfg: dict) -> list[float]:
    """The voxel spacing (Z, Y, X) from the store's scale, the config's
    ``spacing`` when that scale is all 1.0 or unreadable."""
    try:
        scale = pos.scale
        spacing = [scale[pos.get_axis_index(a)] for a in ("z", "y", "x")]
        if all(s == 1.0 for s in spacing):
            log.warning("Zarr scale is all 1.0, using config spacing: %s", cfg.get("spacing"))
            return list(cfg["spacing"])
        return spacing
    except Exception:
        log.warning("Could not read spacing from zarr, using config: %s", cfg.get("spacing"))
        return list(cfg["spacing"])


def compute(cfg: dict, device="cuda") -> list[Path]:
    """Stage 1: each selected position's ``metrics.csv`` and ``slices.npz``
    under ``output_dir/<position>``; returns the position directories."""
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    dev = resolve_device(device)
    output_dir = Path(cfg["output_dir"])
    output_dir.mkdir(parents=True, exist_ok=True)
    allowed = set(cfg["positions"]) if cfg.get("positions") else None
    two_zarr = cfg.get("pred_zarr") is not None
    input_store = open_ome_zarr(cfg["input_zarr"], mode="r")
    pred_store = open_ome_zarr(cfg["pred_zarr"], mode="r") if two_zarr else input_store

    done = []
    for pos_name, pos_gt in input_store.positions():
        if allowed is not None and pos_name not in allowed:
            continue
        log.info("Processing position: %s", pos_name)
        pos_pred = pred_store[pos_name] if two_zarr else pos_gt
        gt_ch_idx = pos_gt.get_channel_index(cfg.get("gt_channel") or cfg["channel"])
        pred_ch_idx = pos_pred.get_channel_index(cfg.get("pred_channel") or cfg["channel"])
        spacing = resolve_spacing(pos_gt, cfg)
        rows = evaluate_position(pos_name, pos_gt, pos_pred, gt_ch_idx, pred_ch_idx, spacing, cfg, device=dev)

        pos_dir = output_dir / pos_name
        pos_dir.mkdir(parents=True, exist_ok=True)
        (pos_dir / "metrics.csv").write_text(rows_to_csv(rows))
        n_t, mid_z = pos_gt.data.shape[0], pos_gt.data.shape[2] // 2
        ts = (0, n_t // 2, n_t - 1)
        np.savez(pos_dir / "slices.npz", labels=[f"t={t}" for t in ts],
                 gt=[pos_gt.data[t, gt_ch_idx, mid_z] for t in ts],
                 pred=[pos_pred.data[t, pred_ch_idx, mid_z] for t in ts])
        log.info("  Saved %s", pos_dir)
        done.append(pos_dir)
    return done


def main(cfg: dict, device="cuda") -> list[Path]:
    """``cfg["mode"]``: ``compute`` runs :func:`compute`; ``plot`` and
    ``all`` (JAX's default) raise before any work starts."""
    mode = cfg.get("mode", "compute")
    if mode in ("plot", "all"):
        raise NotImplementedError(PLOT_REFUSAL)
    if mode != "compute":
        raise ValueError(f"Unknown mode {mode!r} (compute, plot or all)")
    return compute(cfg, device=device)
