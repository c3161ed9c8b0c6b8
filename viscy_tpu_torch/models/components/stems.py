"""3D-to-2D projection stem for FCMAE (counterpart of
``viscy_tpu/models/components/stems.py``).

A strided 3D convolution (kernel == stride) tokenizes the (Z, Y, X)
volume and the surviving depth axis is folded into channels with torch
``reshape(b, c*d, h, w)`` ordering (``k = c*D + d``). Inputs are
``(B, C, D, H, W)``; outputs are channels-last ``(B, H', W', C')``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from viscy_tpu_torch.models.components.blocks import Conv, LayerNorm


class MaskedAdaptiveProjection(nn.Module):
    """FCMAE patchify stem (reference ``fcmae.py:311``), unmasked path.

    Like the reference it holds both ``conv3d`` (used when the input has
    more than one slice) and ``conv2d`` (single-slice input), then a
    LayerNorm over channels."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        generator: torch.Generator,
        kernel_size_2d: Sequence[int] = (4, 4),
        kernel_depth: int = 5,
        in_stack_depth: int = 5,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel_3d = (kernel_depth, *kernel_size_2d)
        self.kernel_2d = tuple(kernel_size_2d)
        ratio = max(1, in_stack_depth // kernel_depth)
        self.conv3d = Conv(in_channels, out_channels // ratio, self.kernel_3d, generator)
        self.conv2d = Conv(in_channels, out_channels, self.kernel_2d, generator)
        self.norm = LayerNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if x.shape[2] > 1:
            y = F.conv3d(x.to(dt), self.conv3d.weight.to(dt), None, self.kernel_3d)
            y = y + self.conv3d.bias.to(dt).view(1, -1, 1, 1, 1)
            y = rearrange(y, "b c d h w -> b h w (c d)")
        else:
            y = self.conv2d.nhwc(x[:, :, 0].permute(0, 2, 3, 1), dt, stride=self.kernel_2d)
        return self.norm(y, dt)
