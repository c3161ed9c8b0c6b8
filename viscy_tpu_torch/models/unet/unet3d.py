"""3-D U-Net, the FNet3D preset (counterpart of
``viscy_tpu/models/unet/unet3d.py``; reference ``unet/unet3d.py:37``).

:class:`UNet3DBase` with batch norm, ReLU, non-residual double-conv
blocks, a ``ResnetBottleneck`` and Z downsampled with Y and X. The
reference's signature (``in_channels, out_channels, depth, mult_chan,
in_stack_depth``); the keyword fields after it override the preset.
"""

from __future__ import annotations

from typing import Literal, Sequence

import torch

from viscy_tpu_torch.models.unet.unet3d_base import ResnetBottleneck, UNet3DBase


class Unet3d(UNet3DBase):
    """FNet3D-style 3-D U-Net for volume-to-volume regression. Every spatial
    dim must be divisible by ``2**depth``; ``in_stack_depth`` is kept for
    the engine (example inputs, predict) and the network takes any
    divisible Z extent."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        depth: int = 4,
        mult_chan: int = 32,
        in_stack_depth: int | None = None,
        dims: Sequence[int] | None = None,
        num_res_block: Sequence[int] | None = None,
        downsample_z: bool = True,
        residual: bool = False,
        norm: Literal["group", "batch"] = "batch",
        activation: Literal["silu", "relu"] = "relu",
        groups: int = 8,
        generator: torch.Generator | None = None,
    ) -> None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        dims = tuple(dims) if dims is not None else tuple(mult_chan * 2**i for i in range(depth + 1))
        num_res_block = tuple(num_res_block) if num_res_block is not None else (1,) * (len(dims) - 1)
        style = dict(residual=residual, norm=norm, activation=activation, groups=groups)
        bottleneck = ResnetBottleneck(dims[-1], g, **style)
        super().__init__(in_channels, out_channels, dims, num_res_block, bottleneck, g,
                         downsample_z=downsample_z, **style)
        self.in_stack_depth = in_stack_depth

    @property
    def out_stack_depth(self) -> int | None:
        return self.in_stack_depth

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """The network on ``x`` (NCDHW). ``generator`` is accepted for the
        engine's call and not drawn from: the network has no random layer."""
        return super().forward(x)
