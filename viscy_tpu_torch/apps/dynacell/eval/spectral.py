"""Spectral image-quality metrics on the device: spectral PCC, band-limited
PCC, the multiband explainable-variance score and FSC resolution
(counterpart of ``viscy_tpu/apps/dynacell/eval/spectral.py``).

The voxel work (apodization, ``torch.fft.fftn``, radial binning by
``bincount``, the weighted sums, the band-passes and their order
statistics) runs in float64 on the requested device; the per-bin curves
(a few hundred values: power spectrum, noise floor, weights, FSC curve and
its crossing) come to the host and follow JAX's numpy code. The
frequency grid is numpy's ``fftfreq`` and the bin ids ``floor(k / df)`` by
IEEE division, so a voxel lands in the same bin on the CPU and the card.

JAX computes these metrics in float32 where numpy 2 keeps float32 (the
input cast, the apodization, a ``complex64`` FFT, float32 means, dots and
variances); the port is JAX's algorithm in float64 throughout. Its tests
hold it to JAX's source evaluated in float64 within 1e-8, and to JAX as it
runs within JAX's float32 error.

Spacing is the voxel size per axis: frequencies are cycles per physical
unit, so the radial bins respect an anisotropic Z.
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.apps.dynacell.eval._ops import div, median, on, quantile, resolve_device

__all__ = [
    "tukey_apodize",
    "radial_frequencies",
    "radial_power_spectrum",
    "estimate_noise_floor",
    "estimate_gt_noise_floor",
    "spectral_weights",
    "wiener_spectral_weights",
    "snr_adaptive_weights",
    "spectral_pcc",
    "band_limited_pcc",
    "multiband_ev_score",
    "fsc_resolution",
    "trimmed_mad_sigma2",
]


# -- apodization ---------------------------------------------------------------
def _tukey_window(n: int, alpha: float = 0.5) -> np.ndarray:
    """1-D Tukey (tapered cosine) window."""
    if alpha <= 0:
        return np.ones(n)
    if alpha >= 1:
        return np.hanning(n)
    x = np.linspace(0.0, 1.0, n)
    w = np.ones(n)
    edge = alpha / 2.0
    lo = x < edge
    hi = x >= 1 - edge
    w[lo] = 0.5 * (1 + np.cos(np.pi * (2 * x[lo] / alpha - 1)))
    w[hi] = 0.5 * (1 + np.cos(np.pi * (2 * x[hi] / alpha - 2 / alpha + 1)))
    return w


def tukey_apodize(img: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """Separable Tukey apodization over every axis (a new tensor)."""
    out = img.clone()
    for axis, n in enumerate(img.shape):
        shape = [1] * img.ndim
        shape[axis] = n
        out *= torch.as_tensor(_tukey_window(n, alpha), dtype=img.dtype, device=img.device).reshape(shape)
    return out


_APODIZATION_FNS = {"tukey": tukey_apodize, "none": lambda x: x}


# -- radial machinery ----------------------------------------------------------
def _normalize_spacing(spacing, ndim: int) -> list[float]:
    if spacing is None:
        return [1.0] * ndim
    if np.isscalar(spacing):
        return [float(spacing)] * ndim
    spacing = [float(s) for s in spacing]
    if len(spacing) != ndim:
        raise ValueError(f"spacing has {len(spacing)} entries for a {ndim}-D image")
    return spacing


def _freq(n: int, d: float, device) -> torch.Tensor:
    return torch.as_tensor(np.fft.fftfreq(n, d=d), dtype=torch.float64, device=device)


def radial_frequencies(shape, spacing=None, device="cuda") -> torch.Tensor:
    """Radial spatial-frequency magnitude map (cycles / physical unit), f64."""
    dev = resolve_device(device)
    spacing = _normalize_spacing(spacing, len(shape))
    k2 = torch.zeros(tuple(shape), dtype=torch.float64, device=dev)
    for axis, (n, d) in enumerate(zip(shape, spacing)):
        view = [1] * len(shape)
        view[axis] = n
        k2 = k2 + _freq(n, d, dev).reshape(view) ** 2
    return torch.sqrt(k2)


def _radial_bins(shape, spacing, bin_delta: float, device) -> tuple[np.ndarray, torch.Tensor]:
    """Bin edges (host) and per-voxel bin ids (device, int64; -1 above the
    radial Nyquist of the most limiting axis). The bin width is
    ``bin_delta`` Fourier pixels of the finest axis."""
    spacing = _normalize_spacing(spacing, len(shape))
    k = radial_frequencies(shape, spacing, device)
    df = min(1.0 / (n * d) for n, d in zip(shape, spacing)) * bin_delta
    k_nyq = min(1.0 / (2.0 * d) for d in spacing)
    edges = np.arange(0.0, k_nyq + df, df, dtype=np.float64)
    bid = torch.floor(div(k, df)).long()
    bid[(k > k_nyq) | (bid >= len(edges) - 1)] = -1
    return edges, bid


def _binned_power(x: torch.Tensor, edges: np.ndarray, bid: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """``(radii, mean |F|^2 per bin)`` of the mean-centred ``x``."""
    p = torch.fft.fftn(x - x.mean()).abs() ** 2
    nbins = len(edges) - 1
    valid = bid >= 0
    b = bid[valid]
    sums = torch.bincount(b, weights=p[valid], minlength=nbins).cpu().numpy()
    counts = torch.bincount(b, minlength=nbins).cpu().numpy()
    power = np.divide(sums, counts, out=np.zeros(nbins), where=counts > 0)
    return (edges[:-1] + edges[1:]) / 2.0, power


def radial_power_spectrum(img, spacing=None, bin_delta: float = 1.0, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Radially binned power spectrum of the mean-centred image: ``(radii,
    power)``, bin-centre frequencies and the mean ``|F|^2`` per bin."""
    x = on(img, resolve_device(device))
    edges, bid = _radial_bins(x.shape, spacing, bin_delta, x.device)
    return _binned_power(x, edges, bid)


def estimate_noise_floor(radii: np.ndarray, power: np.ndarray, tail_fraction: float = 0.2) -> float:
    """Median power of the top ``tail_fraction`` of radial bins (assumed
    beyond the optical cutoff)."""
    n = len(power)
    n_tail = max(1, int(round(n * tail_fraction)))
    return float(np.median(power[n - n_tail:]))


def estimate_gt_noise_floor(gt, spacing=None, bin_delta: float = 1.0, tail_fraction: float = 0.2,
                            device="cuda") -> float:
    """Noise floor of a GT volume, its registration zeros first filled with
    the mean of the rest."""
    x = on(gt, resolve_device(device)).clone()
    mask = x > 0
    if not bool(mask.all()) and bool(mask.any()):
        x[~mask] = float(x[mask].mean())
    radii, power = radial_power_spectrum(x, spacing=spacing, bin_delta=bin_delta, device=x.device)
    return estimate_noise_floor(radii, power, tail_fraction=tail_fraction)


# -- weights (per bin, host) -----------------------------------------------------
def spectral_weights(radii, power, noise_floor: float, cutoff: float | None = None) -> np.ndarray:
    """Subtract-and-normalize weights: max(P - N, 0) / P."""
    w = np.maximum(power - noise_floor, 0.0) / np.maximum(power, 1e-30)
    return np.where(radii > cutoff, 0.0, w) if cutoff is not None else w


def wiener_spectral_weights(radii, power, noise_floor: float, cutoff: float | None = None) -> np.ndarray:
    """Wiener-style weights: P^2 / (P^2 + N^2)."""
    w = power**2 / (power**2 + noise_floor**2)
    return np.where(radii > cutoff, 0.0, w) if cutoff is not None else w


def snr_adaptive_weights(radii, power, noise_floor: float, cutoff: float | None = None,
                         method: str = "snr_squared") -> np.ndarray:
    """``snr_squared``: max(SNR - 1, 0)^2; ``log_snr``: max(log2(SNR), 0)."""
    snr = power / max(noise_floor, 1e-30)
    if method == "snr_squared":
        w = np.maximum(snr - 1.0, 0.0) ** 2
    elif method == "log_snr":
        w = np.maximum(np.log2(np.maximum(snr, 1.0)), 0.0)
    else:
        raise ValueError(f"Unknown SNR-adaptive method: {method!r}")
    return np.where(radii > cutoff, 0.0, w) if cutoff is not None else w


_WEIGHTING_FNS = {
    "subtract": spectral_weights,
    "wiener": wiener_spectral_weights,
    "snr_squared": lambda r, p, n, cutoff=None: snr_adaptive_weights(r, p, n, cutoff, "snr_squared"),
    "log_snr": lambda r, p, n, cutoff=None: snr_adaptive_weights(r, p, n, cutoff, "log_snr"),
}


def _centred(x: torch.Tensor, apodization: str) -> torch.Tensor:
    return _APODIZATION_FNS[apodization](x - x.mean())


def _power_sum(F: torch.Tensor, w: torch.Tensor) -> float:
    return float((w * F.abs() ** 2).sum())


def _cross(Fa: torch.Tensor, Fb: torch.Tensor) -> torch.Tensor:
    """Re(Fa conj(Fb))."""
    return Fa.real * Fb.real + Fa.imag * Fb.imag


# -- spectral PCC --------------------------------------------------------------
def spectral_pcc(prediction, target, spacing=None, *, noise_floor: float | None = None, bin_delta: float = 1.0,
                 cutoff: float | None = None, apodization: str = "tukey", weighting: str = "subtract",
                 nbins_low: int = 0, taper_low: int = 0, tail_fraction: float = 0.2, smooth: bool = False,
                 device="cuda") -> float:
    """Noise-aware frequency-weighted Pearson correlation:
    ``sum(W Re(F_p conj F_t)) / sqrt(sum(W |F_p|^2) sum(W |F_t|^2))`` with
    per-radial-bin weights from the target's power spectrum against a noise
    floor (the high-frequency tail's median unless given), an optional
    hard ``cutoff``, ``nbins_low`` bins cut and ``taper_low`` bins ramped
    at the low end."""
    dev = resolve_device(device)
    p, t = on(prediction, dev), on(target, dev)
    if p.shape != t.shape:
        raise ValueError(f"shape mismatch {tuple(p.shape)} vs {tuple(t.shape)}")
    spacing = _normalize_spacing(spacing, t.ndim)
    edges, bid = _radial_bins(t.shape, spacing, bin_delta, dev)
    radii, power = _binned_power(t, edges, bid)
    if noise_floor is None:
        noise_floor = estimate_noise_floor(radii, power, tail_fraction)
    w_bins = _WEIGHTING_FNS[weighting](radii, power, noise_floor, cutoff=cutoff)
    if smooth and len(w_bins) >= 3:
        from scipy.ndimage import median_filter

        w_bins = median_filter(w_bins, size=5, mode="nearest")
    w_bins = np.array(w_bins, np.float64)
    w_bins[: min(int(nbins_low), len(w_bins))] = 0.0
    tpl = min(int(taper_low), len(w_bins))
    if tpl > 0:
        w_bins[:tpl] *= np.arange(tpl, dtype=np.float64) / float(tpl)
    if float(w_bins.max(initial=0.0)) == 0.0:
        return 0.0
    W = torch.as_tensor(w_bins, device=dev)[bid.clamp_min(0)] * (bid >= 0)
    F_pred = torch.fft.fftn(_centred(p, apodization))
    F_targ = torch.fft.fftn(_centred(t, apodization))
    num = float((W * _cross(F_pred, F_targ)).sum())
    denom = np.sqrt(_power_sum(F_pred, W) * _power_sum(F_targ, W))
    if denom < 1e-12:
        return 0.0
    return float(np.clip(num / denom, -1.0, 1.0))


def band_limited_pcc(prediction, target, spacing=None, *, k_lo: float = 0.0, k_hi: float = np.inf,
                     apodization: str = "tukey", device="cuda") -> float:
    """Pearson correlation restricted to the radial band [k_lo, k_hi]."""
    dev = resolve_device(device)
    p, t = on(prediction, dev), on(target, dev)
    spacing = _normalize_spacing(spacing, t.ndim)
    F_pred = torch.fft.fftn(_centred(p, apodization))
    F_targ = torch.fft.fftn(_centred(t, apodization))
    k = radial_frequencies(t.shape, spacing, dev)
    sel = (k >= k_lo) & (k <= k_hi)
    if not bool(sel.any()):
        return 0.0
    fp, ft = F_pred[sel], F_targ[sel]
    num = float(_cross(fp, ft).sum())
    denom = np.sqrt(float((fp.abs() ** 2).sum()) * float((ft.abs() ** 2).sum()))
    return float(np.clip(num / denom, -1.0, 1.0)) if denom > 1e-12 else 0.0


# -- multiband EV --------------------------------------------------------------
def _butterworth_lp(k_rad: torch.Tensor, cutoff: float, order: int = 2) -> torch.Tensor:
    """Amplitude Butterworth low-pass: 1 / sqrt(1 + (k/k_c)^(2n))."""
    return 1.0 / torch.sqrt(1.0 + div(k_rad, max(cutoff, 1e-30)) ** (2 * order))


def trimmed_mad_sigma2(arr, trim_quantile: float = 0.85, device="cuda") -> tuple[float, int]:
    """Noise variance by trimmed MAD: drop the values above the
    ``trim_quantile`` of |value| (structure), then (1.4826 MAD)^2 of the
    rest."""
    flat = on(arr, resolve_device(device)).reshape(-1)
    a = flat.abs()
    threshold = quantile(a, trim_quantile)
    kept = flat[a <= threshold]
    if kept.numel() < 10:
        return float(flat.var(unbiased=False)), int(kept.numel())
    med = median(kept)
    mad = 1.4826 * median((kept - med).abs())
    return mad**2, int(kept.numel())


def multiband_ev_score(prediction, target, spacing=None, band_edges: list[float] | None = None,
                       filter_order: int = 2, apodization: str = "tukey", noise_corrected: bool = True,
                       device="cuda") -> tuple[float, dict]:
    """Multi-band explainable-variance score: Butterworth band-passes into
    radial bands; per-band noise variance by trimmed MAD (the top band's
    standing in for the lowest); one gain ``a`` fit on the two lowest
    bands; per band the noise-corrected EV fraction (or the band's PCC
    without ``noise_corrected``); the EV-weighted mean. Returns ``(score,
    details)``."""
    dev = resolve_device(device)
    p, t = on(prediction, dev), on(target, dev)
    spacing = _normalize_spacing(spacing, t.ndim)
    k_nyq = min(1.0 / (2.0 * s) for s in spacing)
    if band_edges is None:
        band_edges = [0.0, 0.3, 0.7, 1.2]
    edges = [e for e in band_edges if e < k_nyq] + [k_nyq]
    n_bands = len(edges) - 1

    F_pred = torch.fft.fftn(_centred(p, apodization))
    F_targ = torch.fft.fftn(_centred(t, apodization))
    F_pred.view(-1)[0] = 0.0
    F_targ.view(-1)[0] = 0.0
    k_rad = radial_frequencies(t.shape, spacing, dev)

    bp_pred, bp_targ = [], []
    for j in range(n_bands):
        H = _butterworth_lp(k_rad, edges[j + 1], filter_order)
        if edges[j] > 0:
            H = H - _butterworth_lp(k_rad, edges[j], filter_order)
        bp_pred.append(torch.fft.ifftn(F_pred * H).real)
        bp_targ.append(torch.fft.ifftn(F_targ * H).real)
    del F_pred, F_targ, k_rad

    sigma2 = np.zeros(n_bands)
    n_keep = np.zeros(n_bands, dtype=int)
    sigma2[-1], n_keep[-1] = trimmed_mad_sigma2(bp_targ[-1], device=dev)
    for j in range(1, n_bands - 1):
        sigma2[j], n_keep[j] = trimmed_mad_sigma2(bp_targ[j], device=dev)
    sigma2[0] = sigma2[-1]
    n_keep[0] = n_keep[-1]

    n_fit = min(2, n_bands)
    x_fit = torch.cat([bp_pred[j].reshape(-1) for j in range(n_fit)])
    y_fit = torch.cat([bp_targ[j].reshape(-1) for j in range(n_fit)])
    x_fit = x_fit - x_fit.mean()
    y_fit = y_fit - y_fit.mean()
    xx = float(torch.dot(x_fit, x_fit))
    a = max(float(torch.dot(x_fit, y_fit)) / xx, 0.0) if xx > 1e-30 else 1.0
    del x_fit, y_fit

    details: dict = {}
    ev_values = np.zeros(n_bands)
    scores = np.zeros(n_bands)
    for j in range(n_bands):
        v_j = float(bp_targ[j].var(unbiased=False))
        ev_j = max(v_j - sigma2[j], 0.0)
        ev_values[j] = ev_j
        if ev_j > 0:
            if noise_corrected:
                m_j = float(((bp_targ[j] - a * bp_pred[j]) ** 2).mean())
                s_j = float(np.clip(1.0 - max(m_j - sigma2[j], 0.0) / ev_j, -1.0, 1.0))
            else:
                t_c = bp_targ[j].reshape(-1) - bp_targ[j].mean()
                p_c = bp_pred[j].reshape(-1) - bp_pred[j].mean()
                denom = np.sqrt(float(torch.dot(t_c, t_c)) * float(torch.dot(p_c, p_c)))
                s_j = float(torch.dot(t_c, p_c)) / denom if denom > 1e-12 else 0.0
        else:
            s_j = 0.0
        scores[j] = s_j
        details[f"B{j}_{edges[j]:.1f}-{edges[j + 1]:.1f}"] = {
            "EV": ev_j, "score": s_j, "sigma2": float(sigma2[j]), "var": v_j, "n_keep": int(n_keep[j]),
        }

    ev_total = float(ev_values.sum())
    score = float(np.sum(ev_values * scores) / ev_total) if ev_total > 0 else 0.0
    details["a"] = a
    details["EV_total"] = ev_total
    return score, details


# -- FSC resolution ------------------------------------------------------------
def _fsc_curve_resolution(F_t: torch.Tensor, F_p: torch.Tensor, bid: torch.Tensor, edges: np.ndarray,
                          sel: torch.Tensor | None, threshold: float) -> float:
    """Resolution at the first populated bin (radius > 0) whose FSC falls
    below ``threshold``; bins a cone leaves empty are skipped."""
    nbins = len(edges) - 1
    valid = bid >= 0
    if sel is not None:
        valid &= sel
    b = bid[valid]
    ft, fp = F_t[valid], F_p[valid]
    host = lambda v: v.cpu().numpy()  # noqa: E731
    num = host(torch.bincount(b, weights=_cross(ft, fp), minlength=nbins))
    dt = host(torch.bincount(b, weights=ft.abs() ** 2, minlength=nbins))
    dp = host(torch.bincount(b, weights=fp.abs() ** 2, minlength=nbins))
    counts = host(torch.bincount(b, minlength=nbins))
    denom = np.sqrt(dt * dp)
    fsc = np.divide(num, denom, out=np.zeros(nbins), where=denom > 1e-30)
    radii = (edges[:-1] + edges[1:]) / 2.0
    populated = counts > 0
    below = np.flatnonzero((fsc < threshold) & (radii > 0) & populated)
    if below.size == 0:
        pop_radii = radii[populated]
        return 1.0 / float(pop_radii[-1]) if pop_radii.size else float("inf")
    k_cut = float(radii[below[0]])
    return 1.0 / k_cut if k_cut > 0 else float("inf")


def _checkerboard_split(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent sub-images by 2x2 decimation of the last two axes."""
    sl_even = [slice(None)] * img.ndim
    sl_odd = [slice(None)] * img.ndim
    for ax in (img.ndim - 2, img.ndim - 1):
        n2 = (img.shape[ax] // 2) * 2
        sl_even[ax] = slice(0, n2, 2)
        sl_odd[ax] = slice(1, n2, 2)
    return img[tuple(sl_even)], img[tuple(sl_odd)]


def fsc_resolution(target, prediction=None, spacing=None, *, threshold: float = 1.0 / 7.0, bin_delta: float = 1.0,
                   apodization: str = "tukey", cone_half_angle: float = 45.0, device="cuda") -> dict[str, float]:
    """Fourier shell/ring correlation resolution (1/7 criterion) in physical
    units: ``{"fsc"}`` isotropic, and for 3-D volumes ``{"xy", "z"}`` from
    the cones within ``cone_half_angle`` of the lateral plane and of the
    axial axis (``"xy"`` equals ``"fsc"`` in 2-D). Without ``prediction``
    the target is split by in-plane checkerboard decimation and its halves
    correlated (their spacing doubled in-plane). ``inf`` where the curve
    never crosses."""
    dev = resolve_device(device)
    t_all = on(target, dev)
    spacing = _normalize_spacing(spacing, t_all.ndim)
    if prediction is None:
        t_img, p_img = _checkerboard_split(t_all)
        spacing = list(spacing)
        spacing[-1] *= 2.0
        spacing[-2] *= 2.0
    else:
        t_img, p_img = t_all, on(prediction, dev)
    F_t = torch.fft.fftn(_centred(t_img, apodization))
    F_p = torch.fft.fftn(_centred(p_img, apodization))
    shape = tuple(F_t.shape)
    edges, bid = _radial_bins(shape, spacing, bin_delta, dev)

    out = {"fsc": _fsc_curve_resolution(F_t, F_p, bid, edges, None, threshold)}
    if len(shape) == 3:
        # sectioned FSC: voxels by the angle between k and the kz axis
        kz = _freq(shape[0], spacing[0], dev).reshape(-1, 1, 1)
        k = radial_frequencies(shape, spacing, dev)
        cos_theta = torch.where(k > 0, kz.abs() / k.clamp_min(1e-30), torch.zeros((), dtype=k.dtype, device=dev))
        sel_z = cos_theta >= float(np.cos(np.deg2rad(cone_half_angle)))
        sel_xy = cos_theta <= float(np.sin(np.deg2rad(cone_half_angle)))
        out["xy"] = _fsc_curve_resolution(F_t, F_p, bid, edges, sel_xy, threshold)
        out["z"] = _fsc_curve_resolution(F_t, F_p, bid, edges, sel_z, threshold)
    else:
        out["xy"] = out["fsc"]
    return out
