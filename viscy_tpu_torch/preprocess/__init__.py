"""Preprocessing: normalization statistics, Otsu thresholds, foreground masks."""

from viscy_tpu_torch.preprocess.stats import (
    generate_fg_masks,
    generate_normalization_metadata,
    get_val_stats,
)

__all__ = ["generate_fg_masks", "generate_normalization_metadata", "get_val_stats"]
