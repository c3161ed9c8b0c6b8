"""Preprocessing: normalization statistics, Otsu thresholds, foreground masks,
and normalized copies of a plate."""

from viscy_tpu_torch.preprocess.precompute import precompute_normalized
from viscy_tpu_torch.preprocess.stats import (
    generate_fg_masks,
    generate_normalization_metadata,
    get_val_stats,
)

__all__ = ["generate_fg_masks", "generate_normalization_metadata", "get_val_stats", "precompute_normalized"]
