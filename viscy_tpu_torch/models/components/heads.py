"""Spatial output head (counterpart of ``viscy_tpu/models/components/heads.py``)."""

from __future__ import annotations

import torch
from einops import rearrange
from torch import nn

from viscy_tpu_torch.models.components.blocks import pad_pool_blur_2d, pixel_shuffle_2d


class PixelToVoxelShuffleHead(nn.Module):
    """Pure pixel-shuffle head (reference ``heads.py:656``): one sub-pixel
    upsample by ``xy_scaling`` (optionally pad-pool blurred), then the
    channels unfold into ``(C_out, D)`` with torch ordering ``c*D + d``.
    Channels-last ``(B, h, w, C_out*D*r*r)`` in, ``(B, C_out, D, H, W)`` out,
    in the input's dtype. It has no parameters."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        out_stack_depth: int = 5,
        xy_scaling: int = 4,
        pool: bool = False,
    ) -> None:
        super().__init__()
        self.out_channels = out_channels
        self.out_stack_depth = out_stack_depth
        self.xy_scaling = xy_scaling
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pixel_shuffle_2d(x, self.xy_scaling)
        if self.pool:
            x = pad_pool_blur_2d(x, self.xy_scaling)
        return rearrange(
            x, "b h w (c d) -> b c d h w", c=self.out_channels, d=self.out_stack_depth
        )
