"""Output heads (counterpart of ``viscy_tpu/models/components/heads.py``):
the spatial heads re-inflate channels-last 2-D decoder features to
``(B, C, D, H, W)`` voxels; the projection MLP maps contrastive embeddings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from viscy_tpu_torch.models.components.blocks import (
    BatchNorm,
    Conv,
    Linear,
    icnr_init,
    pad_pool_blur_2d,
    pixel_shuffle_2d,
)


def normal_init(std: float):
    """flax ``initializers.normal(std)`` (MONAI's ``normal_init``)."""

    def init(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return nn.init.normal_(weight, 0.0, std, generator=generator)

    return init


class _ConvPReLU(nn.Module):
    """MONAI ``Convolution`` parameters as the reference names them: ``conv``
    and the PReLU's single slope ``adn.A.weight`` (0.25 at init)."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator) -> None:
        super().__init__()
        self.conv = Conv(in_ch, out_ch, (3, 3, 3), generator, init=normal_init(0.02))
        self.adn = nn.ModuleDict({"A": nn.PReLU(1, 0.25)})


class PixelToVoxelHead(nn.Module):
    """Pixel-shuffle head (reference ``heads.py:594``): 2-D features ->
    3-D voxels. Pixel shuffle x2 (optionally pad-pool blurred), the channels
    folded into ``out_stack_depth + 2`` slices (``c*D + d``), a 3x3x3 conv
    valid in Z, a non-affine instance norm (float32 statistics with the fast
    variance, eps 1e-6 as the JAX package's flax ``GroupNorm``), PReLU with
    one slope, a 1x1x1 conv (ICNR init), float32, then a per-slice pixel
    shuffle x2. Channels-last ``(B, h, w, C)`` in, float32 ``(B, C_out, D,
    4h, 4w)`` out."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        out_stack_depth: int,
        generator: torch.Generator,
        expansion_ratio: int = 4,
        pool: bool = False,
        dtype: torch.dtype = torch.float32,
        eps: float = 1e-6,
    ) -> None:
        super().__init__()
        self.out_stack_depth = out_stack_depth
        self.pool = pool
        self.dtype = dtype
        self.eps = eps
        mid = out_channels * expansion_ratio * 2**2
        c_in = in_channels // 2**2 // (out_stack_depth + 2)
        self.conv = nn.ModuleList(
            [
                _ConvPReLU(c_in, mid, generator),
                Conv(mid, out_channels * 2**2, (1, 1, 1), generator, init=icnr_init(2, 2)),
            ]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = pixel_shuffle_2d(x, 2)
        if self.pool:
            x = pad_pool_blur_2d(x, 2)
        x = rearrange(x, "b h w (c d) -> b c d h w", d=self.out_stack_depth + 2)
        first, last = self.conv
        y = F.conv3d(x.to(dt), first.conv.weight.to(dt), None, 1, (0, 1, 1))
        y = y + first.conv.bias.to(dt).view(1, -1, 1, 1, 1)
        y32 = y.float()
        mu = y32.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp_min((y32 * y32).mean(dim=(2, 3, 4), keepdim=True) - mu * mu, 0.0)
        y = ((y32 - mu) * torch.rsqrt(var + self.eps)).to(y.dtype)
        y = torch.where(y >= 0, y, first.adn["A"].weight * y)
        y = F.conv3d(y.to(dt), last.weight.to(dt)) + last.bias.to(dt).view(1, -1, 1, 1, 1)
        return rearrange(y.float(), "b (c i j) d h w -> b c d (h i) (w j)", i=2, j=2)


class ProjectionMLP(nn.Sequential):
    """Linear -> BN -> ReLU -> Linear -> BN (reference
    ``contrastive/encoder.py:118``), state names ``0``, ``1``, ``3``, ``4``;
    the BatchNorms update their running statistics as flax does
    (:class:`BatchNorm`) in training mode."""

    def __init__(self, in_dims: int, hidden_dims: int, out_dims: int, generator: torch.Generator) -> None:
        super().__init__(
            Linear(in_dims, hidden_dims, generator),
            BatchNorm(hidden_dims),
            nn.ReLU(),
            Linear(hidden_dims, out_dims, generator),
            BatchNorm(out_dims),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc0, bn0, _, fc1, bn1 = self
        x = torch.relu(bn0(F.linear(x, fc0.weight, fc0.bias)))
        return bn1(F.linear(x, fc1.weight, fc1.bias))


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
