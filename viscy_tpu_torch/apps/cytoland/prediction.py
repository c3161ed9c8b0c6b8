"""Tiled YX prediction, rotation TTA and the TTA prediction wrapper
(counterpart of ``viscy_tpu/apps/cytoland/prediction.py``).

``AugmentedPredictionVSUNet`` runs a trained model under forward / inverse
transforms (divisible pad, forward, center crop, inverse) and reduces the
predictions by their mean or median; ``predict_sliding_windows`` covers any
depth with Z windows blended as the prediction writer blends them
(``blend_in``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Literal

import numpy as np
import torch

from viscy_tpu_torch.training.module import TrainModule


def tile_positions(size: int, tile: int, min_overlap: int = 32) -> np.ndarray:
    """Evenly spaced tile origins covering ``[0, size)``: first tile at 0,
    last flush with the edge, neighbours overlapping by >= ``min_overlap``."""
    if tile >= size:
        return np.zeros(1, np.int64)
    min_overlap = min(min_overlap, tile // 2)
    n = math.ceil((size - min_overlap) / (tile - min_overlap))
    return np.round(np.linspace(0, size - tile, n)).astype(np.int64)


def _hat_weights_2d(tile_y: int, tile_x: int) -> np.ndarray:
    """Separable triangular blend weights, strictly positive so edge pixels
    covered by a single tile normalize to that tile's prediction."""

    def ramp(n: int) -> np.ndarray:
        half = (np.arange(n, dtype=np.float32) + 1.0) / ((n + 1) / 2.0)
        return np.minimum(half, half[::-1]) + 1e-3

    return np.outer(ramp(tile_y), ramp(tile_x))


def tiled_forward_yx(
    fwd: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    tile: tuple[int, int] = (320, 320),
    tile_batch: int = 104,
    min_overlap: int = 32,
) -> torch.Tensor:
    """Batched sliding-window YX inference with feathered blending.

    ``x`` ``(B, C, D, H, W)`` is cut into overlapping ``tile`` windows
    (tile-major, so each ``fwd`` batch mixes the B samples), run through
    ``fwd`` ``tile_batch`` tiles at a time, and blended back with separable
    triangular weights in float32 on ``x``'s device.
    """
    b, _, _, h, w = x.shape
    ty, tx = min(tile[0], h), min(tile[1], w)
    ys = tile_positions(h, ty, min_overlap)
    xs = tile_positions(w, tx, min_overlap)
    if len(ys) * len(xs) == 1:
        return fwd(x)
    coords = [(int(y0), int(x0)) for y0 in ys for x0 in xs]
    tiles = torch.cat([x[:, :, :, y0 : y0 + ty, x0 : x0 + tx] for y0, x0 in coords], dim=0)
    n = tiles.shape[0]
    out_tiles = torch.cat(
        [fwd(tiles[i : min(i + tile_batch, n)]) for i in range(0, n, tile_batch)], dim=0
    )
    c_out, d_out = out_tiles.shape[1], out_tiles.shape[2]
    weight = torch.from_numpy(_hat_weights_2d(ty, tx)).to(x.device)
    acc = torch.zeros((b, c_out, d_out, h, w), dtype=torch.float32, device=x.device)
    wacc = torch.zeros((h, w), dtype=torch.float32, device=x.device)
    for k, (y0, x0) in enumerate(coords):
        acc[:, :, :, y0 : y0 + ty, x0 : x0 + tx] += out_tiles[k * b : (k + 1) * b].float() * weight
        wacc[y0 : y0 + ty, x0 : x0 + tx] += weight
    return acc / wacc


def rotation_tta_transforms(n: int = 4):
    """Forward/inverse 90-degree YX rotations (reference ``engine.py:75``)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    forward = [partial(torch.rot90, k=k, dims=(-2, -1)) for k in range(n)]
    inverse = [partial(torch.rot90, k=-k, dims=(-2, -1)) for k in range(n)]
    return forward, inverse


def tta_median(stacked: torch.Tensor) -> torch.Tensor:
    """The median over dim 0 as numpy and ``jnp.median`` take it: the mean of
    the two middle values for an even count (``torch.median`` returns the
    lower one)."""
    s = stacked.sort(dim=0).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class AugmentedPredictionVSUNet(TrainModule):
    """TTA and Z-sliding-window prediction around a trained model (an
    ``nn.Module`` with ``num_blocks``; ``downsamples_z`` pads Z too,
    ``out_stack_depth`` sets the window depth). Inputs are moved to the
    model's device; each transform's prediction is reduced by ``reduction``
    (``"mean"`` or ``"median"``, the two middle values averaged)."""

    def __init__(
        self,
        model: torch.nn.Module,
        forward_transforms: list[Callable] | None = None,
        inverse_transforms: list[Callable] | None = None,
        reduction: Literal["mean", "median"] = "mean",
    ) -> None:
        super().__init__()
        if reduction not in ("mean", "median"):
            raise ValueError(f"reduction must be 'mean' or 'median', got {reduction!r}")
        self.model = model
        self._forward_transforms = forward_transforms or [_identity]
        self._inverse_transforms = inverse_transforms or [_identity]
        self._reduction = reduction

    @classmethod
    def with_rotation_tta(cls, model: torch.nn.Module, n_rotations: int = 4,
                          reduction: Literal["mean", "median"] = "median") -> "AugmentedPredictionVSUNet":
        """``n_rotations`` 90-degree YX rotations and their inverses."""
        fwd, inv = rotation_tta_transforms(n_rotations)
        return cls(model, fwd, inv, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def _reduce(self, preds: list[torch.Tensor]) -> torch.Tensor:
        stacked = torch.stack(preds, dim=0)
        return stacked.mean(dim=0) if self._reduction == "mean" else tta_median(stacked)

    def _predict_with_tta(self, source: torch.Tensor) -> torch.Tensor:
        from viscy_tpu_torch.apps.cytoland.engine import _center_crop_to_shape, _divisible_pad

        factor = 2**self.model.num_blocks
        pad_z = getattr(self.model, "downsamples_z", False)
        preds = []
        for fwd_t, inv_t in zip(self._forward_transforms, self._inverse_transforms):
            aug = fwd_t(source)
            pred = self.forward(_divisible_pad(aug, factor, pad_z=pad_z))
            preds.append(inv_t(_center_crop_to_shape(pred, aug.shape[2:])))
        return preds[0] if len(preds) == 1 else self._reduce(preds)

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def predict_step(self, batch: dict) -> torch.Tensor:
        return self._predict_with_tta(torch.as_tensor(batch["source"], device=self._device()))

    def predict_sliding_windows(self, x, out_channel: int = 2, step: int = 1) -> np.ndarray:
        """Z windows of ``out_stack_depth`` every ``step`` slices through the
        TTA forward (no gradient), blended on the host by ``blend_in``:
        ``(B, out_channel, Z, Y, X)`` float32."""
        from viscy_tpu_torch.training.callbacks.prediction_writer import blend_in

        if x.ndim != 5:
            raise ValueError(f"Expected (B, C, Z, Y, X), got {tuple(x.shape)}")
        b, _, depth, h, w = x.shape
        in_stack_depth = getattr(self.model, "out_stack_depth", None)
        if in_stack_depth is None:
            raise ValueError(f"Model {type(self.model).__name__} has no out_stack_depth")
        if in_stack_depth > depth:
            raise ValueError(f"in_stack_depth {in_stack_depth} > input depth {depth}")
        x = torch.as_tensor(x, device=self._device())
        out = np.zeros((b, out_channel, depth, h, w), np.float32)
        with torch.inference_mode():
            for start in range(0, depth - in_stack_depth + 1, step):
                z_slice = slice(start, start + in_stack_depth)
                pred = self._predict_with_tta(x[:, :, z_slice]).float().cpu().numpy()
                for bi in range(b):
                    out[bi, :, z_slice] = blend_in(out[bi, :, z_slice], pred[bi], z_slice)
        return out
