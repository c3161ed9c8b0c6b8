"""Gray-level co-occurrence texture of engineered single-cell features:
``_glcm`` and ``_glcm_props`` of ``viscy_tpu/evaluation/feature.py``
(``:31-70``), numpy on the host and bit-identical to it where JAX's
``_glcm`` returns: on a crop as narrow (or as short) as a negative offset
JAX raises (``ROADMAP.md`` Queue 3) and the port counts no pair. The
dynacell CP features use them; the rest of that module (``CellFeatures``,
``DynamicFeatures``) is not ported yet (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import numpy as np

__all__ = ["_glcm", "_glcm_props"]

_EPS = 1e-10


def _glcm(image_u8: np.ndarray, offset: tuple[int, int], levels: int = 256) -> np.ndarray:
    """Symmetric, normalized gray-level co-occurrence matrix of one offset."""
    dy, dx = offset
    h, w = image_u8.shape
    a = image_u8[max(0, -dy): h - max(0, dy), max(0, -dx): w - max(0, dx)]
    # JAX writes ``h + min(0, dy) or h``: an end of 0 becomes the whole axis,
    # and a crop exactly |dy| rows (|dx| columns) across raises in np.stack
    b = image_u8[max(0, dy): h + min(0, dy), max(0, dx): w + min(0, dx)]
    pairs = np.stack([a.ravel(), b.ravel()])
    m = np.zeros((levels, levels), np.float64)
    np.add.at(m, (pairs[0], pairs[1]), 1.0)
    m = m + m.T
    total = m.sum()
    return m / max(total, _EPS)


def _glcm_props(glcm: np.ndarray) -> dict:
    """Contrast, dissimilarity, homogeneity, energy, entropy and correlation
    of a normalized GLCM."""
    levels = glcm.shape[0]
    i, j = np.indices((levels, levels))
    d = np.abs(i - j)
    contrast = float((glcm * d**2).sum())
    dissimilarity = float((glcm * d).sum())
    homogeneity = float((glcm / (1.0 + d**2)).sum())
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
