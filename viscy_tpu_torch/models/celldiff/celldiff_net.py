"""CELLDiff networks (counterpart of
``viscy_tpu/models/celldiff/celldiff_net.py``; reference
``celldiff/celldiff_net.py:21``, ``unet_vit_3d.py:17``): the 3-D U-Net with
the ViT bottleneck, with (``CELLDiffNet``) and without (``UNetViT3D``)
timestep and source conditioning.
"""

from __future__ import annotations

from typing import Sequence

import torch

from viscy_tpu_torch.models.celldiff.vit_bottleneck import ViTBottleneck3D
from viscy_tpu_torch.models.unet.unet3d_base import UNet3DBase


def _vit(dims, generator, conditioned, **kw) -> ViTBottleneck3D:
    return ViTBottleneck3D(dims[-1], generator, conditioned=conditioned, **kw)


class CELLDiffNet(UNet3DBase):
    """Flow-matching velocity network ``v = net(x_t, cond=source, t)``: the
    time embedding is ``time_embed_dim`` wide (``hidden_size`` when
    unset), the source enters through ``_cond_inconv``, and every block and
    the ViT's adaLN are conditioned on ``t``. ``input_spatial_size`` is the
    native (D, H, W) window, kept for the engine."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        cond_channels: int = 1,
        dims: Sequence[int] = (32, 64, 128),
        num_res_block: Sequence[int] = (2, 2),
        downsample_z: bool = False,
        input_spatial_size: Sequence[int] | None = None,
        time_embed_dim: int | None = None,
        hidden_size: int = 512,
        num_heads: int = 8,
        num_hidden_layers: int = 2,
        patch_size: int = 4,
        dim_head: int | None = 64,
        dropout: float = 0.0,
        final_dropout: float = 0.0,
        generator: torch.Generator | None = None,
    ) -> None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        vit = _vit(dims, g, True, hidden_size=hidden_size, num_heads=num_heads, num_hidden_layers=num_hidden_layers,
                   patch_size=patch_size, dim_head=dim_head, dropout=dropout, final_dropout=final_dropout)
        super().__init__(in_channels, out_channels, dims, num_res_block, vit, g, downsample_z=downsample_z,
                         time_embed_dim=time_embed_dim or hidden_size, cond_channels=cond_channels)
        self.cond_channels = cond_channels
        self.input_spatial_size = tuple(input_spatial_size) if input_spatial_size else None

    def forward(self, x: torch.Tensor, cond: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return super().forward(x, cond=cond, t=t)


class UNetViT3D(UNet3DBase):
    """The deterministic regression variant (no time or source
    conditioning). ``input_spatial_size`` is the native (D, H, W) patch for
    tiled inference, informational as in the JAX package."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        dims: Sequence[int] = (32, 64, 128),
        num_res_block: Sequence[int] = (2, 2),
        downsample_z: bool = False,
        input_spatial_size: Sequence[int] | None = None,
        hidden_size: int = 512,
        num_heads: int = 8,
        num_hidden_layers: int = 2,
        patch_size: int = 4,
        dim_head: int | None = 64,
        dropout: float = 0.0,
        final_dropout: float = 0.0,
        generator: torch.Generator | None = None,
    ) -> None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        vit = _vit(dims, g, False, hidden_size=hidden_size, num_heads=num_heads, num_hidden_layers=num_hidden_layers,
                   patch_size=patch_size, dim_head=dim_head, dropout=dropout, final_dropout=final_dropout)
        super().__init__(in_channels, out_channels, dims, num_res_block, vit, g, downsample_z=downsample_z)
        self.input_spatial_size = tuple(input_spatial_size) if input_spatial_size else None

    @property
    def downsamples_z(self) -> bool:
        return self.downsample_z

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """The network on ``x`` (NCDHW). ``generator`` is accepted for the
        engine's call and not drawn from: the network has no random layer."""
        return super().forward(x)
