"""2-D U-Net (counterpart of ``viscy_tpu/models/unet/unet2d.py``; reference
``unet/unet2d.py:11``).

Residual ``ConvBlock2D`` levels at widths ``16 * 2**i``, 2x2 average
pooling down, 2x linear upsampling (``jax.image.resize(..., "linear")``,
half-pixel centres, the edge sample repeated: ``F.interpolate(mode=
"bilinear", align_corners=False)``) and skip concatenation up, and a
terminal block without norm. Takes (B, C, H, W) or (B, C, 1, H, W).
Parameters carry the reference torch names (``down_conv_block_{i}``,
``bottom_transition_block``, ``up_conv_block_{i}``, ``terminal_block``).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.models.components.conv_blocks import ConvBlock


def upsample_yx(x: torch.Tensor) -> torch.Tensor:
    """2x linear upsampling of the last two axes of an NC(D)HW map, as
    ``jax.image.resize(..., "linear")`` at twice the size (the depth, if
    any, kept)."""
    size = (*x.shape[2:-2], 2 * x.shape[-2], 2 * x.shape[-1])
    return F.interpolate(x, size=size, mode="bilinear" if x.ndim == 4 else "trilinear", align_corners=False)


def avg_pool_yx(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of the last two axes (VALID: an odd edge row or
    column is dropped)."""
    if x.ndim == 4:
        return F.avg_pool2d(x, 2)
    return F.avg_pool3d(x, (1, 2, 2))


def filters_of(num_filters: Sequence[int], num_blocks: int) -> list[int]:
    """The level widths: ``num_filters`` (``num_blocks + 1`` of them) or
    ``16 * 2**i``."""
    if num_filters:
        filters = list(num_filters)
        if len(filters) != num_blocks + 1:
            raise ValueError(f"num_filters needs {num_blocks + 1} widths, got {len(filters)}")
        return filters
    return [16 * 2**i for i in range(num_blocks + 1)]


class Unet2d(nn.Module):
    """Classic 2-D U-Net with (optionally residual) conv blocks."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_size: Sequence[int] = (3, 3),
        residual: bool = False,
        dropout: float = 0.2,
        num_blocks: int = 4,
        num_block_layers: int = 2,
        num_filters: Sequence[int] = (),
        task: str = "seg",
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_blocks = num_blocks
        filters = filters_of(num_filters, num_blocks)
        block = dict(kernel_size=tuple(kernel_size), num_repeats=num_block_layers, residual=residual, dropout=dropout)
        c = in_channels
        for i in range(num_blocks):
            self.add_module(f"down_conv_block_{i}", ConvBlock(c, filters[i], g, **block))
            c = filters[i]
        self.bottom_transition_block = ConvBlock(c, filters[-1], g, **block)
        c = filters[-1]
        for i in range(num_blocks):
            out = filters[-(i + 2)] if i < num_blocks - 1 else filters[0]
            self.add_module(f"up_conv_block_{i}", ConvBlock(c + filters[-(i + 2)], out, g, **block))
            c = out
        # the reference's terminal block: no norm for either task, dropout kept
        self.terminal_block = ConvBlock(c, out_channels, g, tuple(kernel_size), num_repeats=1, residual=False,
                                        norm="none", activation="linear" if task == "reg" else "relu",
                                        dropout=dropout)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                dropout_masks: Iterator[torch.Tensor] | None = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training; ``dropout_masks``
        gives them instead, one per conv in module order."""
        squeeze = x.ndim == 5
        if squeeze:
            x = x[:, :, 0]
        masks = None if dropout_masks is None else iter(dropout_masks)
        skips = []
        for i in range(self.num_blocks):
            x = getattr(self, f"down_conv_block_{i}")(x, generator, masks)
            skips.append(x)
            x = avg_pool_yx(x)
        x = self.bottom_transition_block(x, generator, masks)
        for i in range(self.num_blocks):
            x = torch.cat([upsample_yx(x), skips[-(i + 1)]], dim=1)
            x = getattr(self, f"up_conv_block_{i}")(x, generator, masks)
        x = self.terminal_block(x, generator, masks)
        return x[:, :, None] if squeeze else x
