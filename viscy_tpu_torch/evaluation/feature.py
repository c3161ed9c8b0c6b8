"""Engineered single-cell features (counterpart of
``viscy_tpu/evaluation/feature.py``): GLCM texture, region properties,
Zernike moments, :class:`CellFeatures` (intensity, texture, morphology and
symmetry of one patch), :class:`DynamicFeatures` (velocity, displacement
and turning of tracks) and the ``compute_*`` conveniences.

They run in numpy and scipy on the host, as in JAX, and keep JAX's
operation order, so their results are JAX's bit for bit (the GLCM's index
grids and the Zernike moments' powers and phases are computed once and
reused, the same values). Two departures:

- ``_glcm`` counts pairs with ``np.bincount`` where JAX uses
  ``np.add.at`` (the same integer counts, several times faster), and on a
  crop as narrow (or as short) as a negative offset it counts no pair where
  JAX raises (``ROADMAP.md`` Queue 3).
- :class:`DynamicFeatures` sorts a track's rows by ``t`` with a stable
  sort; JAX's ``sort_values("t")`` is not stable, so a track with a
  repeated ``t`` may be ordered otherwise there (``ROADMAP.md`` Queue
  3). Rows are picked by ``track_id`` alone, as in JAX: one id in
  several FOVs is one track.

Tables are :class:`~viscy_tpu_torch.evaluation.anndata_lite.Frame`\\ s with
JAX's columns in JAX's order (no pandas).
"""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np

from viscy_tpu_torch.evaluation.anndata_lite import Frame

__all__ = [
    "CellFeatures",
    "DynamicFeatures",
    "compute_intensity_features",
    "compute_texture_features",
    "compute_patch_features",
]

_EPS = 1e-10


# -- GLCM texture -------------------------------------------------------------------


def _glcm(image_u8: np.ndarray, offset: tuple[int, int], levels: int = 256) -> np.ndarray:
    """Symmetric, normalized gray-level co-occurrence matrix of one offset."""
    dy, dx = offset
    h, w = image_u8.shape
    a = image_u8[max(0, -dy): h - max(0, dy), max(0, -dx): w - max(0, dx)]
    # JAX writes ``h + min(0, dy) or h``: an end of 0 becomes the whole axis,
    # and a crop exactly |dy| rows (|dx| columns) across raises in np.stack
    b = image_u8[max(0, dy): h + min(0, dy), max(0, dx): w + min(0, dx)]
    pairs = a.astype(np.int64).ravel() * levels + b.ravel()
    m = np.bincount(pairs, minlength=levels * levels).reshape(levels, levels).astype(np.float64)
    m = m + m.T
    total = m.sum()
    return m / max(total, _EPS)


@functools.lru_cache(maxsize=4)
def _glcm_grid(levels: int) -> tuple[np.ndarray, ...]:
    """``i``, ``j``, ``|i - j|``, ``|i - j|**2`` and ``1 + |i - j|**2`` of a
    ``levels`` x ``levels`` GLCM (read-only, shared between calls)."""
    i, j = np.indices((levels, levels))
    d = np.abs(i - j)
    grid = (i, j, d, d**2, 1.0 + d**2)
    for a in grid:
        a.setflags(write=False)
    return grid


def _glcm_props(glcm: np.ndarray) -> dict:
    """Contrast, dissimilarity, homogeneity, energy, entropy and correlation
    of a normalized GLCM."""
    i, j, d, d2, one_d2 = _glcm_grid(glcm.shape[0])
    contrast = float((glcm * d2).sum())
    dissimilarity = float((glcm * d).sum())
    homogeneity = float((glcm / one_d2).sum())
    energy = float((glcm**2).sum())
    ent = float(-(glcm * np.log(glcm + _EPS)).sum())
    mu_i = (glcm * i).sum()
    mu_j = (glcm * j).sum()
    si = np.sqrt((glcm * (i - mu_i) ** 2).sum())
    sj = np.sqrt((glcm * (j - mu_j) ** 2).sum())
    corr = float(((glcm * (i - mu_i) * (j - mu_j)).sum()) / max(si * sj, _EPS))
    return {
        "contrast": contrast,
        "dissimilarity": dissimilarity,
        "homogeneity": homogeneity,
        "energy": energy,
        "entropy": ent,
        "correlation": corr,
    }


# -- region properties --------------------------------------------------------------


def _region_props(mask: np.ndarray) -> list[dict]:
    """Area, perimeter (in-mask pixels with a 4-neighbour outside) and
    eccentricity (of the second central moments) of each non-zero label, in
    label order."""
    labels = np.unique(mask)
    labels = labels[labels != 0]
    out = []
    for lab in labels:
        m = mask == lab
        area = float(m.sum())
        padded = np.pad(m, 1)
        interior = padded[:-2, 1:-1] & padded[2:, 1:-1] & padded[1:-1, :-2] & padded[1:-1, 2:]
        perimeter = float((m & ~interior).sum())
        ys, xs = np.nonzero(m)
        cy, cx = ys.mean(), xs.mean()
        mu20 = ((xs - cx) ** 2).mean() + 1 / 12
        mu02 = ((ys - cy) ** 2).mean() + 1 / 12
        mu11 = ((xs - cx) * (ys - cy)).mean()
        common = np.sqrt(max((mu20 - mu02) ** 2 + 4 * mu11**2, 0.0))
        l1 = (mu20 + mu02 + common) / 2
        l2 = (mu20 + mu02 - common) / 2
        ecc = float(np.sqrt(max(1 - l2 / max(l1, _EPS), 0.0)))
        out.append({"area": area, "perimeter": perimeter, "eccentricity": ecc})
    return out


# -- Zernike moments ----------------------------------------------------------------


def _zernike_moments(image: np.ndarray, radius: float, degree: int = 8) -> np.ndarray:
    """|Zernike moments| up to ``degree`` on the disk of ``radius`` about the
    image's intensity centroid (its centre when the image sums to 0 or
    less), mahotas' ``zernike_moments`` ordering: n, then m <= n of n's
    parity."""
    h, w = image.shape
    total = image.sum()
    if total <= 0:
        cy, cx = (h - 1) / 2, (w - 1) / 2
    else:
        ys, xs = np.indices(image.shape)
        cy = (image * ys).sum() / total
        cx = (image * xs).sum() / total
    y, x = np.indices(image.shape)
    rho = np.sqrt((y - cy) ** 2 + (x - cx) ** 2) / max(radius, _EPS)
    theta = np.arctan2(y - cy, x - cx)
    inside = rho <= 1.0
    f = image * inside
    norm = f.sum() + _EPS
    powers: dict[int, np.ndarray] = {}  # rho ** k and exp(-i m theta), each computed once a call
    phases: dict[int, np.ndarray] = {}
    moments = []
    for n in range(degree + 1):
        for m in range(n + 1):
            if (n - m) % 2 != 0:
                continue
            r = np.zeros_like(rho)
            for s in range((n - m) // 2 + 1):
                c = (
                    (-1) ** s
                    * math.factorial(n - s)
                    / (math.factorial(s) * math.factorial((n + m) // 2 - s) * math.factorial((n - m) // 2 - s))
                )
                k = n - 2 * s
                if k not in powers:
                    powers[k] = rho**k
                r += c * powers[k]
            if m not in phases:
                phases[m] = np.exp(-1j * m * theta)
            v = r * phases[m] * inside
            a = (n + 1) / np.pi * (f * np.conj(v)).sum() / norm
            moments.append(abs(a))
    return np.asarray(moments)


# -- CellFeatures -------------------------------------------------------------------


class CellFeatures:
    """Intensity, texture, morphology and symmetry features of one 2-D patch
    (and its label mask, for the morphology)."""

    def __init__(self, image: np.ndarray, segmentation_mask: np.ndarray | None = None) -> None:
        self.image = np.asarray(image, np.float64)
        self.segmentation_mask = None if segmentation_mask is None else np.asarray(segmentation_mask)
        lo, hi = self.image.min(), self.image.max()
        self.image_normalized = (self.image - lo) / max(hi - lo, _EPS)
        self.intensity_features: dict | None = None
        self.texture_features: dict | None = None
        self.morphology_features: dict | None = None
        self.symmetry_descriptor: dict | None = None

    # -- intensity --------------------------------------------------------------------
    def _compute_kurtosis(self) -> float:
        x = self.image - self.image.mean()
        var = (x**2).mean()
        return float((x**4).mean() / max(var**2, _EPS) - 3.0)

    def _compute_skewness(self) -> float:
        x = self.image - self.image.mean()
        var = (x**2).mean()
        return float((x**3).mean() / max(var**1.5, _EPS))

    def _compute_iqr(self) -> float:
        return float(np.percentile(self.image, 75) - np.percentile(self.image, 25))

    def _compute_spectral_entropy(self) -> float:
        power = np.abs(np.fft.fft2(self.image)) ** 2 + _EPS
        p = power / power.sum()
        return float(-(p * np.log(p)).sum())

    def _radial_profile(self, values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Mean of ``values`` in each integer radius about the centre pixel,
        below the inscribed radius; and which radii hold pixels."""
        h, w = values.shape
        y, x = np.indices(values.shape)
        r = np.sqrt((x - w // 2) ** 2 + (y - h // 2) ** 2).astype(int)
        max_radius = min(h // 2, w // 2)
        keep = r < max_radius
        sums = np.bincount(r[keep], values[keep], minlength=max_radius)
        counts = np.bincount(r[keep], minlength=max_radius)
        valid = counts > 0
        profile = np.zeros(max_radius)
        profile[valid] = sums[valid] / counts[valid]
        return profile, valid

    def _compute_weighted_intensity_gradient(self) -> float:
        """Slope of the radial profile of the intensity-weighted gradient
        magnitude."""
        gy, gx = np.gradient(self.image)
        weighted = np.sqrt(gx**2 + gy**2) * self.image
        profile, valid = self._radial_profile(weighted)
        xs = np.arange(profile.size)[valid]
        if xs.size < 2:
            return 0.0
        return float(np.polyfit(xs, profile[valid], 1)[0])

    def _compute_radial_intensity_gradient(self) -> float:
        profile, valid = self._radial_profile(self.image_normalized)
        xs = np.arange(profile.size)[valid]
        if xs.size < 2:
            return 0.0
        return float(np.polyfit(xs, profile[valid], 1)[0])

    # -- texture ----------------------------------------------------------------------
    def _compute_glcm_features(self) -> tuple[float, float, float]:
        u8 = (self.image_normalized * 255).astype(np.uint8)
        props = _glcm_props(_glcm(u8, (-1, 1)))  # distance 1, 45 degrees
        return props["contrast"], props["dissimilarity"], props["homogeneity"]

    def _compute_texture_features(self) -> float:
        """Directional anisotropy: the mean over the GLCM statistics of
        their peak-to-peak across the four Haralick directions."""
        u8 = (self.image_normalized * 255).astype(np.uint8)
        per_dir = []
        for off in [(0, 1), (-1, 1), (-1, 0), (-1, -1)]:
            p = _glcm_props(_glcm(u8, off))
            per_dir.append([p[k] for k in sorted(p)])
        return float(np.ptp(np.asarray(per_dir), axis=0).mean())

    # -- morphology -------------------------------------------------------------------
    def _compute_perimeter_area_ratio(self) -> tuple[float, float, float]:
        regions = _region_props(self.segmentation_mask)
        if not regions:
            return 0.0, 0.0, 0.0
        total_p = sum(r["perimeter"] for r in regions)
        total_a = sum(r["area"] for r in regions)
        n = len(regions)
        return total_p / n, total_a / n, total_p / max(total_a, _EPS)

    def _compute_nucleus_eccentricity(self) -> float:
        regions = _region_props(self.segmentation_mask)
        if not regions:
            return 0.0
        return float(np.mean([r["eccentricity"] for r in regions]))

    def _compute_intensity_localization(self) -> float:
        from scipy.ndimage import distance_transform_edt

        edt = distance_transform_edt((self.segmentation_mask > 0).astype(np.uint8))
        return float((self.image * edt).sum() / (edt.sum() + _EPS))

    def _compute_area(self, sigma: float = 0.6) -> tuple[float, float]:
        from scipy.ndimage import gaussian_filter

        from viscy_tpu_torch.preprocess.stats import otsu_threshold

        blurred = gaussian_filter(self.image, sigma=sigma)
        mask = self.image >= otsu_threshold(blurred)
        return float((self.image * mask).mean()), float(mask.sum())

    # -- the four groups --------------------------------------------------------------
    def compute_intensity_features(self) -> None:
        self.intensity_features = {
            "mean_intensity": float(self.image.mean()),
            "std_dev": float(self.image.std()),
            "min_intensity": float(self.image.min()),
            "max_intensity": float(self.image.max()),
            "kurtosis": self._compute_kurtosis(),
            "skewness": self._compute_skewness(),
            "spectral_entropy": self._compute_spectral_entropy(),
            "iqr": self._compute_iqr(),
            "weighted_intensity_gradient": self._compute_weighted_intensity_gradient(),
        }

    def compute_texture_features(self) -> None:
        contrast, dissimilarity, homogeneity = self._compute_glcm_features()
        spectral = self._compute_spectral_entropy()
        self.texture_features = {
            "spectral_entropy": spectral,
            "contrast": contrast,
            "entropy": spectral,
            "homogeneity": homogeneity,
            "dissimilarity": dissimilarity,
            "texture": self._compute_texture_features(),
        }

    def compute_morphology_features(self) -> None:
        if self.segmentation_mask is None:
            raise AssertionError("Segmentation mask is required")
        if np.sum(self.segmentation_mask) == 0:
            raise AssertionError("Segmentation mask is empty")
        masked_intensity, masked_area = self._compute_area()
        perimeter, area, ratio = self._compute_perimeter_area_ratio()
        self.morphology_features = {
            "area": area,
            "perimeter": perimeter,
            "perimeter_area_ratio": ratio,
            "eccentricity": self._compute_nucleus_eccentricity(),
            "intensity_localization": self._compute_intensity_localization(),
            "masked_intensity": masked_intensity,
            "masked_area": masked_area,
        }

    def compute_symmetry_descriptor(self) -> None:
        z = _zernike_moments(self.image, radius=32)
        self.symmetry_descriptor = {
            "zernike_std": float(z.std()),
            "zernike_mean": float(z.mean()),
            "radial_intensity_gradient": self._compute_radial_intensity_gradient(),
        }

    def compute_all_features(self) -> Frame:
        """Every group (morphology only with a mask), as one row."""
        self.compute_intensity_features()
        self.compute_texture_features()
        self.compute_symmetry_descriptor()
        if self.segmentation_mask is not None:
            self.compute_morphology_features()
        return self.to_df()

    def to_df(self) -> Frame:
        """One row of the computed groups, in the order intensity, texture,
        morphology, symmetry; a name two groups share keeps its first place
        and its last value (``spectral_entropy``), as a dict update does."""
        features: dict = {}
        for group in (self.intensity_features, self.texture_features, self.morphology_features,
                      self.symmetry_descriptor):
            if group:
                features.update(group)
        return Frame.from_records([features])


# -- DynamicFeatures ----------------------------------------------------------------


def _tracking_frame(tracking) -> Frame:
    if isinstance(tracking, Frame):
        return tracking
    if isinstance(tracking, (str, Path)):
        from viscy_tpu_torch.data._tracks import read_csv

        return read_csv(tracking)
    if isinstance(tracking, dict):
        return Frame(tracking)
    raise TypeError(f"a tracking table is a Frame, a dict of columns or a CSV path, got {type(tracking).__name__}")


class DynamicFeatures:
    """Velocity, displacement and angular features of the tracks of a table
    with ``track_id``, ``t``, ``y`` and ``x`` columns (a :class:`Frame`, a
    dict of columns or a CSV path)."""

    def __init__(self, tracking_df) -> None:
        self.tracking_df = _tracking_frame(tracking_df)

    def _track(self, track_id) -> dict[str, np.ndarray]:
        """The rows of ``track_id``, sorted by ``t`` (stably)."""
        df = self.tracking_df
        rows = np.flatnonzero(df["track_id"] == track_id)
        rows = rows[np.argsort(df["t"][rows], kind="stable")]
        return {k: df[k][rows] for k in ("t", "y", "x")}

    def _compute_instantaneous_velocity(self, track_id) -> np.ndarray:
        track = self._track(track_id)
        if len(track["t"]) < 2:
            return np.array([0.0])
        dx = np.diff(track["x"])
        dy = np.diff(track["y"])
        dt = np.diff(track["t"]).astype(float)
        velocities = np.zeros(len(track["t"]))
        velocities[1:] = np.sqrt(dx**2 + dy**2) / np.maximum(dt, _EPS)
        return velocities

    def _compute_displacement(self, track_id) -> tuple[float, float, float]:
        track = self._track(track_id)
        if len(track["t"]) < 2:
            return 0.0, 0.0, 0.0
        x, y = track["x"], track["y"]
        total = float(np.sqrt(np.diff(x) ** 2 + np.diff(y) ** 2).sum())
        net = float(np.hypot(x[-1] - x[0], y[-1] - y[0]))
        return total, net, net / max(total, _EPS)

    def _compute_angular_velocity(self, track_id) -> tuple[float, float, float]:
        track = self._track(track_id)
        if len(track["t"]) < 3:
            return 0.0, 0.0, 0.0
        dx = np.diff(track["x"])
        dy = np.diff(track["y"])
        dt = np.diff(track["t"]).astype(float)
        dtheta = np.diff(np.arctan2(dy, dx))
        dtheta = np.arctan2(np.sin(dtheta), np.cos(dtheta))  # wrap to [-pi, pi]
        omega = np.abs(dtheta) / np.maximum(dt[1:], _EPS)
        return float(omega.mean()), float(omega.max()), float(omega.std())

    def _features(self, track_id) -> dict:
        velocities = self._compute_instantaneous_velocity(track_id)
        total, net, persistence = self._compute_displacement(track_id)
        mean_w, max_w, std_w = self._compute_angular_velocity(track_id)
        return {
            "track_id": track_id,
            "mean_velocity": float(velocities.mean()),
            "max_velocity": float(velocities.max()),
            "std_velocity": float(velocities.std()),
            "total_distance": total,
            "net_displacement": net,
            "directional_persistence": persistence,
            "mean_angular_velocity": mean_w,
            "max_angular_velocity": max_w,
            "std_angular_velocity": std_w,
        }

    def compute_all_features(self, track_id) -> Frame:
        """One row of the features of ``track_id``."""
        return Frame.from_records([self._features(track_id)])

    def to_df(self) -> Frame:
        """One row a track, in order of each ``track_id``'s first row."""
        ids = list(dict.fromkeys(self.tracking_df["track_id"].tolist()))
        return Frame.from_records([self._features(tid) for tid in ids])


# -- conveniences -------------------------------------------------------------------


def compute_intensity_features(patch: np.ndarray) -> dict:
    cf = CellFeatures(np.asarray(patch).squeeze())
    cf.compute_intensity_features()
    return cf.intensity_features


def compute_texture_features(patch: np.ndarray) -> dict:
    cf = CellFeatures(np.asarray(patch).squeeze())
    cf.compute_texture_features()
    return cf.texture_features


def compute_patch_features(patch: np.ndarray, mask: np.ndarray | None = None) -> Frame:
    return CellFeatures(np.asarray(patch).squeeze(), mask).compute_all_features()
