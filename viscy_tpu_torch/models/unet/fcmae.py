"""Fully Convolutional Masked Autoencoder, supervised (unmasked) path
(counterpart of ``viscy_tpu/models/unet/fcmae.py``).

This module serves fine-tuned FCMAE models (``pretraining=False``,
``mask_ratio=0``): masked pretraining (``generate_mask``, ``MaskedGRN``)
is not ported yet. Parameter names and shapes equal the reference VisCy
torch model's (``viscy_tpu/training/state_dict_inventory.py``), so a
released checkpoint loads with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from viscy_tpu_torch.models.components.blocks import (
    Conv,
    GrnMlp,
    LayerNorm,
    UNeXt2Decoder,
    apply_downsample,
    downsample,
    mlp_grn_residual,
    trunc_normal_init,
)
from viscy_tpu_torch.models.components.heads import PixelToVoxelShuffleHead
from viscy_tpu_torch.models.components.stems import MaskedAdaptiveProjection


def _dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    return dtype


class MaskedConvNeXtV2Block(nn.Module):
    """FCMAE ConvNeXt-v2 block (reference ``fcmae.py:144``), unmasked:
    7x7 depthwise conv WITHOUT bias (timm ``create_conv2d`` default) ->
    fused LN/fc1/GELU/GRN/fc2 -> residual."""

    def __init__(
        self,
        dim: int,
        generator: torch.Generator,
        kernel_size: int = 7,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.dwconv = Conv(
            dim,
            dim,
            (kernel_size, kernel_size),
            generator,
            groups=dim,
            bias=False,
            init=trunc_normal_init(),
        )
        self.layernorm = LayerNorm(dim)
        self.mlp = GrnMlp(dim, mlp_ratio * dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dwconv.nhwc(x, self.dtype, padding=self.kernel_size // 2)
        return mlp_grn_residual(y, x, self.layernorm, self.mlp)


class MaskedConvNeXtV2Stage(nn.Module):
    """LN + strided-conv downsample (when channels change or ``stride > 1``),
    then blocks (reference ``fcmae.py:224``)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        generator: torch.Generator,
        kernel_size: int = 7,
        stride: int = 2,
        num_blocks: int = 2,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.downsample = None
        if in_channels != out_channels or stride > 1:
            k = stride if stride > 1 else 1
            self.downsample = downsample(in_channels, out_channels, k, generator)
        self.blocks = nn.ModuleList(
            MaskedConvNeXtV2Block(out_channels, generator, kernel_size=kernel_size, dtype=dtype)
            for _ in range(num_blocks)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = apply_downsample(self.downsample, x, self.stride, self.dtype)
        for block in self.blocks:
            x = block(x)
        return x


class MaskedMultiscaleEncoder(nn.Module):
    """ConvNeXt-v2 encoder with the FCMAE stem (reference ``fcmae.py:388``)."""

    def __init__(
        self,
        in_channels: int,
        generator: torch.Generator,
        stage_blocks: Sequence[int] = (3, 3, 9, 3),
        dims: Sequence[int] = (96, 192, 384, 768),
        stem_kernel_size: Sequence[int] = (5, 4, 4),
        in_stack_depth: int = 5,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.stem_kernel_size = tuple(stem_kernel_size)
        self.stem = MaskedAdaptiveProjection(
            in_channels,
            dims[0],
            generator,
            kernel_size_2d=self.stem_kernel_size[1:],
            kernel_depth=self.stem_kernel_size[0],
            in_stack_depth=in_stack_depth,
            dtype=dtype,
        )
        chs = [dims[0], *dims]
        self.stages = nn.ModuleList(
            MaskedConvNeXtV2Stage(
                chs[i],
                chs[i + 1],
                generator,
                stride=1 if i == 0 else 2,
                num_blocks=n,
                dtype=dtype,
            )
            for i, n in enumerate(self.stage_blocks)
        )

    @property
    def total_stride(self) -> int:
        return int(self.stem_kernel_size[1] * 2 ** (len(self.stage_blocks) - 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``(B, C, D, H, W)`` -> channels-last features, one per stage."""
        y = self.stem(x)
        features = []
        for stage in self.stages:
            y = stage(y)
            features.append(y)
        return features


class FullyConvolutionalMAE(nn.Module):
    """FCMAE (reference ``fcmae.py:456``) for supervised prediction.

    Keyword arguments follow the JAX model so its configs load. Weights are
    drawn from ``generator`` (default: a generator seeded with 0) with the
    flax initializers. ``fused_mlp`` is accepted for config compatibility:
    every block runs the fused MLP+GRN segment, there is no unfused path.
    ``encoder_drop_path_rate`` only affects training and is ignored here.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        encoder_blocks: Sequence[int] = (3, 3, 9, 3),
        dims: Sequence[int] = (96, 192, 384, 768),
        encoder_drop_path_rate: float = 0.0,
        stem_kernel_size: Sequence[int] = (5, 4, 4),
        in_stack_depth: int = 5,
        decoder_conv_blocks: int = 1,
        pretraining: bool = True,
        head_conv: bool = False,
        dtype: str | torch.dtype | None = None,
        fused_mlp: bool = True,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if pretraining:
            raise NotImplementedError("masked FCMAE pretraining is not ported; use pretraining=False")
        if head_conv:
            raise NotImplementedError("PixelToVoxelHead (head_conv=True) is not ported")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.dims = tuple(dims)
        self.stem_kernel_size = tuple(stem_kernel_size)
        self.in_stack_depth = in_stack_depth
        self.dtype = _dtype(dtype)
        self.encoder = MaskedMultiscaleEncoder(
            in_channels,
            generator,
            stage_blocks=encoder_blocks,
            dims=self.dims,
            stem_kernel_size=self.stem_kernel_size,
            in_stack_depth=in_stack_depth,
            dtype=self.dtype,
        )
        decoder_channels = list(self.dims[::-1])
        decoder_channels[-1] = out_channels * in_stack_depth * self.stem_kernel_size[-1] ** 2
        self.decoder = UNeXt2Decoder(
            decoder_channels,
            [2] * (len(self.dims) - 1) + [self.stem_kernel_size[-1]],
            generator,
            conv_blocks=decoder_conv_blocks,
            dtype=self.dtype,
        )
        self.head = PixelToVoxelShuffleHead(
            decoder_channels[-1],
            out_channels,
            out_stack_depth=in_stack_depth,
            xy_scaling=self.stem_kernel_size[-1],
            pool=True,
        )

    @property
    def num_blocks(self) -> int:
        """Reference-compatible divisible-pad exponent (``fcmae.py:515``)."""
        return len(self.dims) * int(math.log2(self.stem_kernel_size[-1]))

    @property
    def total_stride(self) -> int:
        """True YX downsampling factor: the divisibility the forward needs."""
        return int(self.stem_kernel_size[-1] * 2 ** (len(self.dims) - 1))

    @property
    def out_stack_depth(self) -> int:
        return self.in_stack_depth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C_in, D, H, W)`` -> float32 ``(B, C_out, D, H, W)``."""
        features = self.encoder(x)[::-1]
        feat = self.decoder(features)
        return self.head(feat).float()
