"""Array normalization helpers (counterpart of
``viscy_tpu/training/normalize.py``).

Small numpy utilities for preprocessing scripts and notebooks; the
device-side normalization lives in :mod:`viscy_tpu_torch.transforms.normalize`.
One implementation backs this module and
:mod:`viscy_tpu_torch.preprocess.normalize`; CLAHE uses skimage's
``equalize_adapthist`` when the library is installed and the native numpy
tile-histogram version otherwise, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from viscy_tpu_torch.preprocess.normalize import (
    hist_adapteq_2d as _hist_adapteq_2d_native,
    hist_clipping,
    unzscore,
    zscore,
)

__all__ = ["zscore", "unzscore", "hist_clipping", "hist_adapteq_2D"]


def hist_adapteq_2D(input_image: np.ndarray, kernel_size=None, clip_limit=None):
    """CLAHE on a 2D image: skimage when importable, else
    :func:`viscy_tpu_torch.preprocess.normalize.hist_adapteq_2d`."""
    try:
        from skimage.exposure import equalize_adapthist
    except ImportError:
        return _hist_adapteq_2d_native(input_image, kernel_size=kernel_size, clip_limit=clip_limit)
    return equalize_adapthist(input_image, kernel_size=kernel_size, clip_limit=clip_limit)
