"""3D-to-2D projection stems (counterpart of
``viscy_tpu/models/components/stems.py``): UNeXt2's, the contrastive
encoder's and FCMAE's masked one.

A strided 3D convolution tokenizes the (Z, Y, X) volume and the surviving
depth axis is folded into channels with torch ``reshape(b, c*d, h, w)``
ordering (``k = c*D + d``). Inputs are ``(B, C, D, H, W)``; outputs are
channels-last ``(B, H', W', C')``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from viscy_tpu_torch.models.components.blocks import Conv, LayerNorm


def _conv3d_fold(conv: Conv, x: torch.Tensor, stride: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """VALID strided conv3d in ``dtype`` (bias added in it), then depth folded
    into channels: ``(B, C, D, H, W)`` -> ``(B, H', W', C' * D')``."""
    y = F.conv3d(x.to(dtype), conv.weight.to(dtype), None, tuple(stride))
    y = y + conv.bias.to(dtype).view(1, -1, 1, 1, 1)
    return rearrange(y, "b c d h w -> b h w (c d)")


class UNeXt2Stem(nn.Module):
    """Conv3d tokenizer with kernel == stride, depth folded into channels
    (reference ``stems.py``): ``out_channels / (in_stack_depth //
    kernel_depth)`` conv channels, so the fold gives ``out_channels``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        generator: torch.Generator,
        kernel_size: Sequence[int] = (5, 4, 4),
        in_stack_depth: int = 5,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        if in_stack_depth < kernel_size[0]:
            raise ValueError(f"in_stack_depth ({in_stack_depth}) must be >= kernel depth ({kernel_size[0]})")
        ratio = in_stack_depth // kernel_size[0]
        if out_channels % ratio:
            raise ValueError(f"out_channels ({out_channels}) must be divisible by {ratio}")
        self.dtype = dtype
        self.kernel_size = tuple(kernel_size)
        self.conv = Conv(in_channels, out_channels // ratio, self.kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv3d_fold(self.conv, x, self.kernel_size, self.dtype)


class StemDepthtoChannels(nn.Module):
    """Contrastive-encoder stem (reference ``stems.py:53``): a strided conv3d
    whose channel count makes the folded ``C * D'`` equal the encoder's
    first width; raises when the depth leaves channels over."""

    def __init__(
        self,
        in_channels: int,
        in_stack_depth: int,
        in_channels_encoder: int,
        generator: torch.Generator,
        stem_kernel_size: Sequence[int] = (5, 4, 4),
        stem_stride: Sequence[int] = (5, 4, 4),
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.stem_stride = tuple(stem_stride)
        out_depth = (in_stack_depth - stem_kernel_size[0]) // stem_stride[0] + 1
        out_channels = in_channels_encoder // out_depth
        mismatch = in_channels_encoder - out_depth * out_channels
        if mismatch:
            raise ValueError(
                f"Stem needs to output {mismatch} more channels to match the encoder. "
                "Adjust the in_stack_depth."
            )
        self.conv = Conv(in_channels, out_channels, tuple(stem_kernel_size), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv3d_fold(self.conv, x, self.stem_stride, self.dtype)


def upsample_mask_2d(mask: torch.Tensor, target_hw: Sequence[int]) -> torch.Tensor:
    """Nearest-upsample a ``(B, 1, h, w)`` bool mask to ``(B, H, W)`` by
    repeating each cell ``H / h`` x ``W / w`` times (reference
    ``fcmae.py:69``); the ratios must be integers."""
    m = mask[:, 0]
    h, w = m.shape[1:]
    hh, ww = target_hw
    if (hh, ww) != (h, w):
        if hh % h or ww % w:
            raise ValueError(f"target {tuple(target_hw)} not divisible by mask {(h, w)}")
        m = m.repeat_interleave(hh // h, dim=1).repeat_interleave(ww // w, dim=2)
    return m


class MaskedAdaptiveProjection(nn.Module):
    """FCMAE patchify stem (reference ``fcmae.py:311``).

    Like the reference it holds both ``conv3d`` (used when the input has
    more than one slice) and ``conv2d`` (single-slice input), then a
    LayerNorm over channels. Patches never cross mask cells (kernel ==
    stride), so the masked stem runs the dense convolution and re-zeroes
    the LayerNorm output at masked positions with ``where`` (not a
    multiply: a non-finite value there still becomes 0)."""

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

    def forward(self, x: torch.Tensor, unmasked: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, C, D, H, W)`` -> channels-last ``(B, H', W', C')``;
        ``unmasked``: ``(B, 1, h, w)`` bool, True where tokens are kept, at
        the stem's output grid or a divisor of it."""
        dt = self.dtype
        if x.shape[2] > 1:
            y = _conv3d_fold(self.conv3d, x, self.kernel_3d, dt)
        else:
            y = self.conv2d.nhwc(x[:, :, 0].permute(0, 2, 3, 1), dt, stride=self.kernel_2d)
        y = self.norm(y, dt)
        if unmasked is not None:
            keep = upsample_mask_2d(unmasked, y.shape[1:3])
            y = torch.where(keep[..., None], y, y.new_zeros(()))
        return y
