"""Spotlight foreground-aware loss (counterpart of
``viscy_tpu/training/losses/spotlight.py``; Kalinin et al. 2025,
arXiv:2507.05383), plain PyTorch.

Masked MSE + Dice on a tunable-sigmoid soft threshold; the foreground mask
comes from a precomputed ``fg_mask``, a fixed threshold, or a per-(B, C)
Otsu threshold on the target. In a job of several processes the Dice term
averages over the real masks of the global batch.
"""

from __future__ import annotations

import torch

from viscy_tpu_torch.parallel.mesh import global_sum

__all__ = ["SpotlightLoss", "otsu_threshold_batch", "tunable_sigmoid"]


def tunable_sigmoid(x: torch.Tensor, k: float) -> torch.Tensor:
    """Normalized tunable sigmoid (Emery 2022), clamped to [0, 1]."""
    raw = (x - k * x) / (k - 2 * k * x.abs() + 1)
    return raw.clamp(0.0, 1.0)


def otsu_threshold_batch(target: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """Per-(sample, channel) Otsu thresholds, shape (B, C, 1, ...): a
    ``n_bins`` histogram of each (sample, channel) between its min and max,
    and the bin center of the first maximum of the between-class variance."""
    b, c = target.shape[:2]
    flat = target.reshape(b * c, -1).float()
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    width = (hi - lo) / n_bins
    edges = lo + width * torch.arange(n_bins, device=flat.device)
    bin_idx = ((flat - lo) / torch.clamp_min(width, 1e-12)).to(torch.int32).clamp(0, n_bins - 1)
    hist = torch.zeros((b * c, n_bins), dtype=torch.float32, device=flat.device)
    hist.scatter_add_(1, bin_idx.long(), torch.ones_like(flat))
    centers = edges + width / 2
    total = hist.sum(dim=1, keepdim=True)
    cum_sum = torch.cumsum(hist, dim=1)
    cum_mean = torch.cumsum(hist * centers, dim=1) / (cum_sum + 1e-10)
    global_mean = (hist * centers).sum(dim=1, keepdim=True) / total
    mu0_minus_mu = cum_mean * total - global_mean * cum_sum
    inter_class_var = mu0_minus_mu**2 / (cum_sum * (total - cum_sum) + 1e-10)
    # torch.argmax, like jnp.argmax, returns the first of tied maxima
    thresholds = torch.gather(centers, 1, torch.argmax(inter_class_var, dim=1, keepdim=True))
    return thresholds.reshape(b, c, *([1] * (target.ndim - 2)))


class SpotlightLoss:
    """Masked-MSE + Dice foreground-aware loss."""

    def __init__(
        self,
        lambda_mse: float = 0.5,
        sigmoid_k: float = -0.95,
        eps: float = 1e-6,
        fg_threshold: float | None = None,
    ) -> None:
        if not -1 < sigmoid_k < 0:
            raise ValueError(f"sigmoid_k must be in (-1, 0), got {sigmoid_k}")
        if not 0 < lambda_mse < 1:
            raise ValueError(f"lambda_mse must be in (0, 1), got {lambda_mse}")
        if eps <= 0:
            raise ValueError(f"eps must be > 0, got {eps}")
        self.lambda_mse = lambda_mse
        self.sigmoid_k = sigmoid_k
        self.eps = eps
        self.fg_threshold = fg_threshold

    def __call__(
        self, pred: torch.Tensor, target: torch.Tensor, fg_mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        pred = pred.float()
        target = target.float()
        if fg_mask is not None:
            mask = fg_mask.float()
        elif self.fg_threshold is not None:
            mask = (target >= self.fg_threshold).float()
        else:
            mask = (target >= otsu_threshold_batch(target)).float()

        spatial = tuple(range(2, pred.ndim))
        n_spatial = 1
        for s in pred.shape[2:]:
            n_spatial *= s

        fg_per_ch = mask.sum(dim=spatial)  # (B, C)
        has_real_mask = (fg_per_ch > 0) & (fg_per_ch < n_spatial)

        sq_err = (pred - target) ** 2
        masked_sum = (sq_err * mask).sum(dim=spatial)
        unmasked_mse = sq_err.mean(dim=spatial)
        channel_mse = torch.where(fg_per_ch > 0, masked_sum / (fg_per_ch + self.eps), unmasked_mse)
        masked_mse = channel_mse.mean()

        soft_pred = tunable_sigmoid(pred, self.sigmoid_k)
        intersection = (soft_pred * mask).sum(dim=spatial)
        soft_sum = soft_pred.sum(dim=spatial)
        channel_dice = 1 - (2 * intersection) / (soft_sum + fg_per_ch + self.eps)
        # the dice mean over the real masks of the global batch
        dice_sum, n_real = global_sum(torch.stack([(channel_dice * has_real_mask.float()).sum(),
                                                   has_real_mask.sum().to(channel_dice.dtype)]))
        dice = torch.where(n_real > 0, dice_sum / torch.clamp_min(n_real, 1), torch.zeros((), device=pred.device))
        return self.lambda_mse * masked_mse + (1 - self.lambda_mse) * dice
