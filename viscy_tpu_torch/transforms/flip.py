"""Batched random flips (counterpart of ``viscy_tpu/transforms/flip.py``)."""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from viscy_tpu_torch.transforms.base import RandTransform

__all__ = ["BatchedRandFlipd"]


def _flip_batch(x: torch.Tensor, flips: torch.Tensor, spatial_axes: Sequence[int]) -> torch.Tensor:
    """Per-sample conditional flips along spatial axes (0 = Z, 1 = Y, 2 = X);
    ``flips`` is (B, len(spatial_axes)) bool."""
    for j, ax in enumerate(spatial_axes):
        axis = x.ndim - 3 + ax
        mask = flips[:, j].reshape((-1,) + (1,) * (x.ndim - 1))
        x = torch.where(mask, torch.flip(x, dims=(axis,)), x)
    return x


class BatchedRandFlipd(RandTransform):
    """Randomly flip batched (B, C, Z, Y, X) data along spatial axes.

    Each (sample, axis) pair draws an independent Bernoulli(prob), shared
    across keys. Draws: ``flips`` (B, len(spatial_axes)) bool.
    """

    is_spatial = True

    def __init__(
        self,
        keys: str | Iterable[str],
        spatial_axes: Sequence[int] | int = (0, 1, 2),
        prob: float = 0.5,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.spatial_axes = (spatial_axes,) if isinstance(spatial_axes, int) else tuple(spatial_axes)

    def draw(self, data: dict, generator: torch.Generator) -> dict:
        first = data[self.first_key(data)]
        shape = (first.shape[0], len(self.spatial_axes))
        return dict(flips=torch.rand(shape, generator=generator, device=first.device) < self.prob)

    def apply(self, data: dict, draws: dict) -> dict:
        for k in self.key_iterator(data):
            data[k] = _flip_batch(data[k], draws["flips"].to(data[k].device), self.spatial_axes)
        return data
