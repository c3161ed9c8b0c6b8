"""Tiled YX prediction and rotation TTA (counterpart of
``viscy_tpu/apps/cytoland/prediction.py``)."""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import numpy as np
import torch


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
