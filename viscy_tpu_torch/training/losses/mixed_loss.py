"""Mixed reconstruction loss (counterpart of
``viscy_tpu/training/losses/mixed_loss.py``):
``l1_alpha * L1 + l2_alpha * L2 + ms_dssim_alpha * (1 - MS-SSIM-2.5D)``
with the bf16-safe clamped MS-SSIM."""

from __future__ import annotations

import torch

from viscy_tpu_torch.ops.ssim import ms_ssim_25d


class MixedLoss:
    """Callable mixed loss over ``(B, C, D, H, W)`` prediction/target pairs.
    Inputs may be bf16: every term upcasts at its consumer and all
    arithmetic and accumulation runs in float32."""

    def __init__(self, l1_alpha: float = 0.5, l2_alpha: float = 0.0, ms_dssim_alpha: float = 0.5):
        if not any([l1_alpha, l2_alpha, ms_dssim_alpha]):
            raise ValueError("Loss term weights cannot be all zero!")
        self.l1_alpha = l1_alpha
        self.l2_alpha = l2_alpha
        self.ms_dssim_alpha = ms_dssim_alpha

    def __call__(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        loss = 0.0
        if self.l1_alpha:
            diff = preds.float() - target.float()
            # |d| with JAX's subgradient at 0 (+1, where torch's abs gives 0):
            # bf16 inputs hit equal pairs
            loss += torch.where(diff >= 0, diff, -diff).mean() * self.l1_alpha
        if self.l2_alpha:
            loss += (preds.float() - target.float()).square().mean() * self.l2_alpha
        if self.ms_dssim_alpha:
            loss += (1 - ms_ssim_25d(preds, target, clamp=True)) * self.ms_dssim_alpha
        return loss
