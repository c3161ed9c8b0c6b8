"""Loss functions."""

from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss
from viscy_tpu_torch.training.losses.spotlight import SpotlightLoss

__all__ = ["MixedLoss", "SpotlightLoss"]
