"""2.5-D U-Net (Guo et al., eLife 55502; counterpart of
``viscy_tpu/models/unet/unet25d.py``, reference ``unet/unet25d.py:11``).

A 3-D encoder of ``ConvBlock3D`` levels with (3, ky, kx) kernels over the
Z stack and YX-only average pooling; the bottom transition and one conv a
skip compress Z with VALID (zk, 1, 1) kernels, ``zk = 1 + in_stack_depth
- out_stack_depth``; a decoder of (1, ky, kx) blocks that upsamples YX
only; a terminal block whose norm and dropout depend on the task.
Parameters carry the reference torch names (``down_conv_block_{i}``,
``bottom_transition_block``, ``skip_conv_layer_{i}``,
``up_conv_block_{i}``, ``terminal_block``). NCDHW in and out.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.models.components.blocks import Conv
from viscy_tpu_torch.models.components.conv_blocks import ConvBlock
from viscy_tpu_torch.models.unet.unet2d import avg_pool_yx, filters_of, upsample_yx


class Unet25d(nn.Module):
    """2.5-D U-Net learning a 3-D to 2-D compression."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        in_stack_depth: int = 5,
        out_stack_depth: int = 1,
        xy_kernel_size: Sequence[int] = (3, 3),
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
        self.in_stack_depth, self.out_stack_depth = in_stack_depth, out_stack_depth
        self.num_blocks = num_blocks
        filters = filters_of(num_filters, num_blocks)
        zk = 1 + in_stack_depth - out_stack_depth
        ky, kx = xy_kernel_size
        block = dict(num_repeats=num_block_layers, residual=residual, dropout=dropout)
        c = in_channels
        for i in range(num_blocks):
            self.add_module(f"down_conv_block_{i}", ConvBlock(c, filters[i], g, (3, ky, kx), **block))
            c = filters[i]
        self.bottom_transition_block = Conv(c, filters[-1], (zk, 1, 1), g)
        for i in range(num_blocks):
            self.add_module(f"skip_conv_layer_{i}", Conv(filters[i], filters[i], (zk, 1, 1), g))
        c = filters[-1]
        for i in range(num_blocks):
            out = filters[-(i + 2)] if i < num_blocks - 1 else filters[0]
            self.add_module(f"up_conv_block_{i}", ConvBlock(c + filters[-(i + 2)], out, g, (1, ky, kx), **block))
            c = out
        reg = task == "reg"
        self.terminal_block = ConvBlock(c, out_channels, g, (1, 3, 3), num_repeats=1, residual=False,
                                        norm="none" if reg else "batch", activation="linear" if reg else "relu",
                                        dropout=0.0 if reg else dropout)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                dropout_masks: Iterator[torch.Tensor] | None = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training; ``dropout_masks``
        gives them instead, one per conv in module order."""
        masks = None if dropout_masks is None else iter(dropout_masks)
        skips = []
        for i in range(self.num_blocks):
            x = getattr(self, f"down_conv_block_{i}")(x, generator, masks)
            skips.append(x)
            x = avg_pool_yx(x)
        bt = self.bottom_transition_block
        x = F.conv3d(x, bt.weight, bt.bias)
        for i in range(self.num_blocks):
            conv = getattr(self, f"skip_conv_layer_{i}")
            skips[i] = F.conv3d(skips[i], conv.weight, conv.bias)
        for i in range(self.num_blocks):
            x = torch.cat([upsample_yx(x), skips[-(i + 1)]], dim=1)
            x = getattr(self, f"up_conv_block_{i}")(x, generator, masks)
        return self.terminal_block(x, generator, masks)
