"""Preprocessing: normalization statistics, Otsu thresholds, foreground masks,
normalized copies of a plate, and AnnData copies of embedding stores."""

from viscy_tpu_torch.preprocess.precompute import convert_to_anndata, precompute_normalized
from viscy_tpu_torch.preprocess.stats import (
    generate_fg_masks,
    generate_normalization_metadata,
    get_val_stats,
)

__all__ = ["convert_to_anndata", "generate_fg_masks", "generate_normalization_metadata", "get_val_stats", "precompute_normalized"]
