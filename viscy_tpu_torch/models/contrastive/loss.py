"""NT-Xent losses with an optional temperature schedule and hard-negative
concentration, and the triplet margin loss (counterpart of
``viscy_tpu/models/contrastive/loss.py``; reference
``contrastive/loss.py:20,73``).

In a job of several processes each loss takes the global batch
(:func:`~viscy_tpu_torch.parallel.mesh.gather_batch`): NT-Xent draws its
negatives from every rank's rows, as the JAX step over the sharded batch
does, and every rank computes the one global loss; the gather's backward
sums the ranks' gradients and the trainer's mean over the ranks then gives
that loss's gradient."""

from __future__ import annotations

import math
from typing import Literal

import torch

from viscy_tpu_torch.models.schedule import cosine_anneal
from viscy_tpu_torch.parallel.mesh import gather_batch

__all__ = ["ntxent_loss", "NTXentLoss", "NTXentHCL", "triplet_margin_loss", "cosine_anneal"]


def _norm(z: torch.Tensor) -> torch.Tensor:
    return (z * z).sum(dim=1, keepdim=True).sqrt()


def ntxent_loss(
    z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.07, beta: float = 0.0, eps: float = 1e-8
) -> torch.Tensor:
    """NT-Xent (InfoNCE with in-batch negatives) over paired ``(B, D)``
    projections: positives are the ``(i, i + B)`` pairs of the concatenated
    batch. ``beta > 0`` weights each negative's exponential by
    ``exp(beta * sim)``, normalized to keep the per-anchor negative count
    (HCL). Over the global batch in a job of several processes."""
    z1, z2 = gather_batch(z1), gather_batch(z2)
    z = torch.cat([z1, z2], dim=0)
    z = z / (_norm(z) + eps)
    n, b = z.shape[0], z1.shape[0]
    sim = z @ z.T
    idx = torch.arange(n, device=z.device)
    pos_idx = torch.cat([idx[:b] + b, idx[:b]])
    neg_mask = ~(torch.eye(n, dtype=torch.bool, device=z.device) | (idx[None, :] == pos_idx[:, None]))
    logits = sim / temperature
    pos_logits = logits.gather(1, pos_idx[:, None])[:, 0]
    neg_logits = torch.where(neg_mask, logits, logits.new_full((), -math.inf))
    max_val = torch.maximum(pos_logits, neg_logits.max(dim=1).values)
    numerator = torch.exp(pos_logits - max_val)
    if beta > 0.0:
        w = torch.exp(beta * sim) * neg_mask
        counts = neg_mask.sum(dim=1, keepdim=True)
        w = w * counts / torch.clamp_min(w.sum(dim=1, keepdim=True), eps)
        shifted = torch.where(neg_mask, logits - max_val[:, None], logits.new_full((), -math.inf))
        denom = (w * torch.exp(shifted)).sum(dim=1) + numerator
    else:
        denom = torch.exp(neg_logits - max_val[:, None]).sum(dim=1) + numerator
    return -torch.log(numerator / denom + eps).mean()


def triplet_margin_loss(
    anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor, margin: float = 0.5
) -> torch.Tensor:
    """Euclidean triplet margin loss, the mean over the (global) batch."""
    anchor, positive, negative = gather_batch(anchor), gather_batch(positive), gather_batch(negative)
    d_pos = _norm(anchor - positive)[:, 0]
    d_neg = _norm(anchor - negative)[:, 0]
    return torch.clamp_min(d_pos - d_neg + margin, 0.0).mean()


class NTXentLoss:
    """NT-Xent with an optional cosine temperature schedule, stepped per
    epoch by :meth:`step`."""

    def __init__(
        self,
        temperature: float = 0.07,
        temperature_schedule: Literal["cosine", "constant"] = "constant",
        temperature_start: float = 0.1,
        temperature_warmup_epochs: int = 50,
    ) -> None:
        self.temperature = temperature
        self.temperature_schedule = temperature_schedule
        self.temperature_start = temperature_start
        self.temperature_end = temperature
        self.temperature_warmup_epochs = temperature_warmup_epochs
        self.beta = 0.0

    def step(self, epoch: int) -> None:
        if self.temperature_schedule == "cosine":
            self.temperature = cosine_anneal(
                self.temperature_start, self.temperature_end, epoch, self.temperature_warmup_epochs
            )

    def __call__(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        return ntxent_loss(z1, z2, self.temperature, beta=self.beta)


class NTXentHCL(NTXentLoss):
    """NT-Xent with hard-negative concentration (a beta-weighted denominator)."""

    def __init__(self, temperature: float = 0.07, beta: float = 0.5, **kwargs) -> None:
        super().__init__(temperature=temperature, **kwargs)
        self.beta = beta
