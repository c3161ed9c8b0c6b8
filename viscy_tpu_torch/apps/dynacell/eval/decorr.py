"""Resolution and band-limited metrics on the device: DCR decorrelation,
Fourier ring correlation (one image or two), the OTF cutoff, the
Butterworth low-pass, band-limited PCC and SSIM, masked PSNR and SSIM
(counterpart of ``viscy_tpu/apps/dynacell/eval/decorr.py``).

Built on :mod:`.spectral`: the same apodization, spacing rules, radial
frequencies and radial bins. The voxel work (``torch.fft.fftn``, the
filters, the radial sums and the decorrelation curves' cumulative sums)
runs in float64 on the requested device; the curves (a few hundred values)
come to the host and follow JAX's numpy code (peaks, crossings, clipping).

JAX computes in float32 where numpy 2 keeps it (``decorr.py:222,367,417``
cast to float32; the FFT of float32 data is ``complex64``); the port is
JAX's algorithm in float64 throughout, as :mod:`.spectral` is. A
decorrelation curve's value at radius ``r`` is the sum over the
frequencies at or below ``r``: JAX sorts the radii with numpy's unstable
``argsort`` and reads a cumulative sum; the port bins each frequency by
the first radius at or above it and adds the bins up. The sets summed are
the same; only the order of the additions differs.
"""

from __future__ import annotations

import numpy as np
import torch

from viscy_tpu_torch.apps.dynacell.eval._ops import div, on, resolve_device
from viscy_tpu_torch.apps.dynacell.eval.metrics import uniform_filter
from viscy_tpu_torch.apps.dynacell.eval.spectral import (
    _APODIZATION_FNS,
    _cross,
    _normalize_spacing,
    _radial_bins,
    radial_frequencies,
)

__all__ = [
    "otf_cutoff",
    "apply_lowpass",
    "psnr",
    "ssim",
    "dcr_curve",
    "dcr_resolution",
    "calculate_frc",
    "frc_weights",
    "spectral_pcc_frcw",
    "estimate_cutoff",
    "band_limited_pcc",
    "band_limited_ssim",
]

_DCR_KEYS = ("num_radii", "num_highpass", "windowing", "refine", "min_amplitude")


# -- optics --------------------------------------------------------------------
def otf_cutoff(numerical_aperture: float, wavelength_emission: float, modality: str = "widefield") -> float:
    """Incoherent OTF lateral cutoff in cycles per physical unit: ``2 NA /
    lambda_em`` for widefield detection, twice that for an ideal confocal."""
    base = 2.0 * numerical_aperture / wavelength_emission
    if modality == "widefield":
        return base
    if modality == "confocal":
        return 2.0 * base
    raise ValueError(f"Unknown modality: {modality!r}")


# -- Butterworth low-pass --------------------------------------------------------
def apply_lowpass(image, cutoff: float, spacing=None, order: int = 2, device="cuda") -> torch.Tensor:
    """Butterworth amplitude low-pass ``1 / sqrt(1 + (k / k_c)^(2 order))``
    on the isotropic radial physical frequency; a float64 tensor on the
    device."""
    x = on(image, resolve_device(device))
    spacing = _normalize_spacing(spacing, x.ndim)
    k = radial_frequencies(x.shape, spacing, x.device)
    h = 1.0 / torch.sqrt(1.0 + div(k, max(cutoff, 1e-30)) ** (2 * order))
    return torch.fft.ifftn(torch.fft.fftn(x) * h).real


# -- pixel metrics (masked) ------------------------------------------------------
def _mask(mask, dev) -> torch.Tensor | None:
    if mask is None:
        return None
    return mask.to(dev) if isinstance(mask, torch.Tensor) else torch.as_tensor(np.asarray(mask, bool), device=dev)


def psnr(image_true, image_test, data_range: float | None = None, mask=None, device="cuda") -> float:
    """Peak signal-to-noise ratio, inside a boolean foreground ``mask`` when
    given; ``inf`` for identical images."""
    dev = resolve_device(device)
    t, p = on(image_true, dev), on(image_test, dev)
    m = _mask(mask, dev)
    if m is not None:
        t, p = t[m], p[m]
    if data_range is None:
        data_range = float(t.max() - t.min())
    mse = float(((t - p) ** 2).mean())
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def ssim(im1, im2, data_range: float | None = None, win_size: int = 7, device="cuda") -> float:
    """Mean structural similarity with skimage's protocol: a uniform window
    of ``win_size`` (at most the smallest axis, made odd) on every axis,
    K1 = 0.01, K2 = 0.03, the sample-covariance correction, the map's
    border of half a window left out of the mean. 2-D or 3-D."""
    dev = resolve_device(device)
    x, y = on(im1, dev), on(im2, dev)
    if data_range is None:
        data_range = float(x.max() - x.min())
    if data_range <= 0:
        return 1.0
    win_size = min(win_size, *x.shape)
    if win_size % 2 == 0:
        win_size -= 1
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    size = (win_size,) * x.ndim
    n = float(win_size) ** x.ndim
    cov_norm = n / (n - 1.0)
    ux, uy = uniform_filter(x, size), uniform_filter(y, size)
    uxx, uyy, uxy = uniform_filter(x * x, size), uniform_filter(y * y, size), uniform_filter(x * y, size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, dim - pad) for dim in s.shape)
    return float(s[crop].mean())


# -- DCR: image decorrelation analysis -------------------------------------------
def _dcr_single_curve(fk: torch.Tensor, fk_norm: torch.Tensor, bucket: torch.Tensor, num_radii: int) -> np.ndarray:
    """Decorrelation curve ``d(r) = sum_{|k| <= r} |F| |F_n| / sqrt(sum |F|^2
    sum_{|k| <= r} |F_n|^2)`` at every radius (Descloux et al. 2019, eq. 1):
    the cosine similarity between the spectrum and its phase-only copy
    masked to ``r``. ``bucket`` holds each frequency's first radius at or
    above it (``num_radii``: beyond the last)."""
    mag = fk.abs()
    mask_norm2 = fk_norm.abs() ** 2
    n = num_radii + 1
    cum_mag = torch.bincount(bucket, weights=(mag * mask_norm2.sqrt()).reshape(-1), minlength=n)[:num_radii]
    cum_n = torch.bincount(bucket, weights=mask_norm2.reshape(-1), minlength=n)[:num_radii]
    total_e = float((mag**2).sum())
    cum_mag, cum_n = cum_mag.cumsum(0).cpu().numpy(), cum_n.cumsum(0).cpu().numpy()
    return cum_mag / np.sqrt(total_e * np.maximum(cum_n, 1e-30))


def _find_peak(radii: np.ndarray, d: np.ndarray, min_amplitude: float = 0.0) -> tuple[float, float]:
    """Highest-amplitude interior local maximum of a decorrelation curve:
    ``(r0, A0)``, or (0, 0) when no local maximum exceeds
    ``min_amplitude``."""
    if len(d) < 3:
        return 0.0, 0.0
    interior = np.flatnonzero((d[1:-1] >= d[:-2]) & (d[1:-1] >= d[2:])) + 1
    interior = interior[d[interior] > min_amplitude]
    if interior.size == 0:
        return 0.0, 0.0
    best = interior[np.argmax(d[interior])]
    return float(radii[best]), float(d[best])


def dcr_curve(image, spacing=None, *, num_radii: int = 100, num_highpass: int = 10, windowing: bool = True,
              refine: bool = True, min_amplitude: float = 0.001, device="cuda"):
    """Image decorrelation analysis of a 2-D image (Descloux et al., Nat.
    Methods 2019): the curve of the raw spectrum and of ``num_highpass``
    Gaussian high-passes; the resolution is set by the highest peak
    frequency over all curves (with ``refine``, also over five high-passes
    bracketing the best one).

    Returns ``(resolution, radii, curves, all_peaks)``: the resolution in
    physical units (``inf`` without a peak), the radii normalized to the
    inscribed Nyquist, the ``(num_highpass + 1, num_radii)`` curves and the
    ``(num_highpass + 1, 2)`` peaks ``(r0, A0)``, the unfiltered curve first."""
    dev = resolve_device(device)
    x = on(image, dev)
    if x.ndim != 2:
        raise ValueError(f"dcr_curve expects a 2D image, got shape {tuple(x.shape)}")
    spacing = _normalize_spacing(spacing, 2)
    img = x - x.mean()
    if windowing:
        img = _APODIZATION_FNS["tukey"](img)
    fk = torch.fft.fftn(img)
    mag = fk.abs()
    fk_norm = torch.where(mag > 0, fk / mag.clamp_min(1e-30), torch.zeros((), dtype=fk.dtype, device=dev))

    # radial frequency normalized to the inscribed Nyquist; the corners beyond it are masked out
    k_nyq = min(0.5 / s for s in spacing)
    r_map = div(radial_frequencies(tuple(x.shape), spacing, dev), k_nyq)
    inside = r_map <= 1.0
    zero = torch.zeros((), dtype=fk.dtype, device=dev)
    fk = torch.where(inside, fk, zero)
    fk_norm = torch.where(inside, fk_norm, zero)

    radii = np.linspace(1.0 / num_radii, 1.0, num_radii)
    sigmas = np.geomspace(0.15, 1.0, num_highpass) if num_highpass > 0 else []
    bucket = torch.searchsorted(torch.as_tensor(radii, device=dev), r_map.reshape(-1))
    r2 = r_map**2

    def curve(sig: float | None) -> np.ndarray:
        if sig is None:
            return _dcr_single_curve(fk, fk_norm, bucket, num_radii)
        hp = 1.0 - torch.exp(div(-r2, 2.0 * sig**2))
        return _dcr_single_curve(fk * hp, fk_norm * hp, bucket, num_radii)

    curves = np.zeros((1 + len(sigmas), num_radii))
    peaks = np.zeros((1 + len(sigmas), 2))
    for i, sig in enumerate([None, *sigmas]):
        curves[i] = curve(sig)
        peaks[i] = _find_peak(radii, curves[i], min_amplitude)

    valid = peaks[:, 1] > min_amplitude
    if not valid.any():
        return float("inf"), radii, curves, peaks
    r_max = float(peaks[valid, 0].max())

    if refine and len(sigmas) > 0:
        # a finer high-pass sweep bracketing the best sigma
        best_i = int(np.argmax(np.where(valid, peaks[:, 0], -1.0)))
        if best_i > 0:
            s_best = sigmas[best_i - 1]
            for sig in np.geomspace(s_best * 0.6, s_best * 1.6, 5):
                r0, a0 = _find_peak(radii, curve(float(sig)), min_amplitude)
                if a0 > min_amplitude:
                    r_max = max(r_max, r0)

    if r_max <= 0:
        return float("inf"), radii, curves, peaks
    return 1.0 / (r_max * k_nyq), radii, curves, peaks


def dcr_resolution(image, spacing=None, device="cuda", **kwargs):
    """DCR resolution: a float for a 2-D image; for a 3-D volume ``{"xy",
    "z"}``, lateral from the mid-Z YX slice and axial from the mid-X ZY
    slice (anisotropic spacing respected). Keywords other than
    :func:`dcr_curve`'s are ignored."""
    x = on(image, resolve_device(device))
    spacing = _normalize_spacing(spacing, x.ndim)
    kwargs = {k: v for k, v in kwargs.items() if k in _DCR_KEYS}
    if x.ndim == 2:
        return dcr_curve(x, spacing, device=x.device, **kwargs)[0]
    if x.ndim != 3:
        raise ValueError(f"dcr_resolution expects 2D or 3D, got shape {tuple(x.shape)}")
    res_xy = dcr_curve(x[x.shape[0] // 2], spacing[1:], device=x.device, **kwargs)[0]
    res_z = dcr_curve(x[:, :, x.shape[2] // 2], [spacing[0], spacing[1]], device=x.device, **kwargs)[0]
    return {"xy": res_xy, "z": res_z}


# -- FRC: (one-image) Fourier ring correlation ------------------------------------
def _frc_two_image(a: torch.Tensor, b: torch.Tensor, bin_delta: float = 1.0,
                   disable_hamming: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """FRC curve between two images, the normalized cross power per radial
    bin (index units): ``(frequency normalized to the Nyquist, correlation)``."""
    if not disable_hamming:
        for axis, n in enumerate(a.shape):
            shape = [1] * a.ndim
            shape[axis] = n
            w = torch.as_tensor(np.hamming(n), device=a.device).reshape(shape)
            a = a * w
            b = b * w
    fa, fb = torch.fft.fftn(a), torch.fft.fftn(b)
    spacing = _normalize_spacing(None, a.ndim)
    edges, bid = _radial_bins(tuple(a.shape), spacing, bin_delta, a.device)
    nbins = len(edges) - 1
    valid = bid >= 0
    bsel = bid[valid]
    fa, fb = fa[valid], fb[valid]

    def binned(w: torch.Tensor) -> np.ndarray:
        return torch.bincount(bsel, weights=w, minlength=nbins).cpu().numpy()

    num, da, db = binned(_cross(fa, fb)), binned(fa.abs() ** 2), binned(fb.abs() ** 2)
    denom = np.sqrt(da * db)
    frc = np.divide(num, denom, out=np.zeros(nbins), where=denom > 1e-30)
    centers = (edges[:-1] + edges[1:]) / 2.0
    k_nyq = min(0.5 / s for s in spacing)
    return centers / k_nyq, frc


def calculate_frc(image, image2=None, *, bin_delta: float = 1.0, disable_hamming: bool = False,
                  average: bool = True, device="cuda", **_ignored) -> dict:
    """Fourier ring correlation. With ``image2`` the two images'; without,
    one image split into two by 2x2 decimation (Koho et al., Nat. Commun.
    2019): the even/even against the odd/odd sub-image, averaged with the
    anti-diagonal pair when ``average``.

    Returns ``{"correlation": {"frequency": ..., "correlation": ...}}``."""
    dev = resolve_device(device)
    x = on(image, dev)
    img = x - x.mean()
    if image2 is not None:
        y = on(image2, dev)
        freq, corr = _frc_two_image(img, y - y.mean(), bin_delta, disable_hamming)
        return {"correlation": {"frequency": freq, "correlation": corr}}
    if img.ndim != 2:
        raise ValueError("one-image FRC requires a 2D image")
    h2, w2 = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    img = img[:h2, :w2]
    freq, corr = _frc_two_image(img[0::2, 0::2], img[1::2, 1::2], bin_delta, disable_hamming)
    if average:
        _, corr2 = _frc_two_image(img[0::2, 1::2], img[1::2, 0::2], bin_delta, disable_hamming)
        corr = 0.5 * (corr + corr2)
    return {"correlation": {"frequency": freq, "correlation": corr}}


def frc_weights(image, bin_delta: float = 1.0, device="cuda") -> np.ndarray:
    """Per-radial-bin weights: the one-image FRC curve clipped to [0, 1]."""
    corr = calculate_frc(image, bin_delta=bin_delta, device=device)["correlation"]["correlation"]
    return np.clip(corr, 0.0, 1.0)


def spectral_pcc_frcw(prediction, target, spacing=None, *, bin_delta: float = 1.0, apodization: str = "tukey",
                      frozen_weights: np.ndarray | None = None, device="cuda") -> float:
    """Spectral PCC weighted per radial bin by the target's one-image FRC
    (its SNR signature), or by ``frozen_weights``. The FRC of the
    half-resolution sub-images covers the low half of the full image's
    bins; the others weigh 0."""
    dev = resolve_device(device)
    p, t = on(prediction, dev), on(target, dev)
    if p.shape != t.shape:
        raise ValueError(f"shape mismatch {tuple(p.shape)} vs {tuple(t.shape)}")
    spacing = _normalize_spacing(spacing, t.ndim)
    apo = _APODIZATION_FNS[apodization]
    f_pred = torch.fft.fftn(apo(p - p.mean()))
    f_targ = torch.fft.fftn(apo(t - t.mean()))
    w_frc = frozen_weights if frozen_weights is not None else frc_weights(t, bin_delta=bin_delta, device=dev)

    _, bid = _radial_bins(tuple(t.shape), spacing, bin_delta, dev)
    nbins = int(bid.max()) + 1
    w_bins = np.zeros(nbins)
    n = min(nbins, len(w_frc))
    w_bins[:n] = w_frc[:n]
    if float(w_bins.max(initial=0.0)) == 0.0:
        return 0.0
    w_full = torch.as_tensor(w_bins, device=dev)[bid.clamp_min(0)] * (bid >= 0)
    num = float((w_full * _cross(f_pred, f_targ)).sum())
    denom = np.sqrt(float((w_full * f_pred.abs() ** 2).sum()) * float((w_full * f_targ.abs() ** 2).sum()))
    if denom < 1e-12:
        return 0.0
    return float(np.clip(num / denom, -1.0, 1.0))


# -- cutoff estimation + band-limited metrics --------------------------------------
def estimate_cutoff(image, spacing=None, *, method: str = "dcr", numerical_aperture: float | None = None,
                    wavelength_emission: float | None = None, dcr_kwargs: dict | None = None,
                    frc_kwargs: dict | None = None, frc_threshold: float = 1.0 / 7.0, device="cuda") -> float:
    """A low-pass cutoff frequency from an image: ``dcr`` (the inverse
    decorrelation resolution, lateral for a volume), ``frc`` (the one-image
    FRC's first crossing of ``frc_threshold``) or ``otf`` (the optics'
    bound)."""
    ndim = image.ndim
    spacing = _normalize_spacing(spacing, ndim)
    if method == "otf":
        if numerical_aperture is None or wavelength_emission is None:
            raise ValueError("otf method requires numerical_aperture and wavelength_emission")
        return otf_cutoff(numerical_aperture, wavelength_emission)
    if method == "dcr":
        res = dcr_resolution(image, spacing, device=device, **(dcr_kwargs or {}))
        if isinstance(res, dict):
            res = res["xy"]
        if not np.isfinite(res) or res <= 0:
            raise ValueError("DCR found no resolution peak")
        return 1.0 / res
    if method == "frc":
        result = calculate_frc(image, device=device, **(frc_kwargs or {}))
        freq = result["correlation"]["frequency"]
        corr = result["correlation"]["correlation"]
        below = np.flatnonzero((corr < frc_threshold) & (freq > 0))
        # the sub-images' Nyquist is half the full image's
        k_nyq_sub = min(0.5 / s for s in spacing) / 2.0
        if below.size == 0:
            return float(freq[-1]) * k_nyq_sub
        return float(freq[below[0]]) * k_nyq_sub
    raise ValueError(f"Unknown cutoff method: {method!r}")


def band_limited_pcc(prediction, target, spacing=None, *, cutoff: float, order: int = 2, device="cuda",
                     **_ignored) -> float:
    """Pearson correlation after the Butterworth low-pass at ``cutoff``.
    (:func:`.spectral.band_limited_pcc` is another metric: the correlation
    of the spectra within a radial band.)"""
    dev = resolve_device(device)
    p, t = on(prediction, dev), on(target, dev)
    spacing = _normalize_spacing(spacing, t.ndim)
    pc = apply_lowpass(p, cutoff, spacing, order, dev).reshape(-1)
    tc = apply_lowpass(t, cutoff, spacing, order, dev).reshape(-1)
    pc, tc = pc - pc.mean(), tc - tc.mean()
    denom = np.sqrt(float(torch.dot(pc, pc)) * float(torch.dot(tc, tc)))
    if denom < 1e-12:
        return 0.0
    return float(np.clip(float(torch.dot(pc, tc)) / denom, -1.0, 1.0))


def band_limited_ssim(prediction, target, spacing=None, *, cutoff: float, order: int = 2, win_size: int = 7,
                      data_range: float | None = None, device="cuda", **_ignored) -> float:
    """SSIM after the Butterworth low-pass at ``cutoff`` (the low-passed
    target's range unless ``data_range``)."""
    dev = resolve_device(device)
    p, t = on(prediction, dev), on(target, dev)
    spacing = _normalize_spacing(spacing, t.ndim)
    p = apply_lowpass(p, cutoff, spacing, order, dev)
    t = apply_lowpass(t, cutoff, spacing, order, dev)
    if data_range is None:
        data_range = float(t.max() - t.min())
    return ssim(t, p, data_range=data_range, win_size=win_size, device=dev)
