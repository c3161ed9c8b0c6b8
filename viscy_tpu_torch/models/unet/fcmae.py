"""Fully Convolutional Masked Autoencoder (counterpart of
``viscy_tpu/models/unet/fcmae.py``): masked pretraining
(``pretraining=True``: ``forward`` returns ``(pred, mask)``) and supervised
prediction (``pretraining=False``).

Masking is dense, as in the JAX package: masked positions are zeroed before
and after each depthwise conv, the fused MLP+GRN segment takes the mask
(GRN statistics over kept tokens, the branch zeroed at masked ones), and
the stem re-zeroes its output at masked positions. Parameter names and
shapes equal the reference VisCy torch model's
(``viscy_tpu/training/state_dict_inventory.py``), so a released checkpoint
loads with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from viscy_tpu_torch.models.components.blocks import (
    Conv,
    DropPath,
    GrnMlp,
    LayerNorm,
    UNeXt2Decoder,
    apply_downsample,
    downsample,
    mlp_grn_residual,
    trunc_normal_init,
)
from viscy_tpu_torch.models.components.heads import PixelToVoxelHead, PixelToVoxelShuffleHead
from viscy_tpu_torch.models.components.stems import MaskedAdaptiveProjection, upsample_mask_2d


def generate_mask(
    generator: torch.Generator, batch: int, hw: Sequence[int], stride: int, mask_ratio: float
) -> torch.Tensor:
    """Random low-resolution bool mask ``(B, 1, H // stride, W // stride)``,
    True = masked (reference ``fcmae.py:40``): each sample ranks uniform
    scores drawn from ``generator`` (on its device) and masks exactly
    ``int(numel * mask_ratio)`` cells."""
    mh, mw = hw[0] // stride, hw[1] // stride
    numel = mh * mw
    masked = int(numel * mask_ratio)
    scores = torch.rand((batch, numel), generator=generator, device=generator.device)
    ranks = scores.argsort(dim=1).argsort(dim=1)
    return (ranks < masked).reshape(batch, 1, mh, mw)


def _dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    return dtype


class MaskedConvNeXtV2Block(nn.Module):
    """FCMAE ConvNeXt-v2 block (reference ``fcmae.py:144``): 7x7 depthwise
    conv WITHOUT bias (timm ``create_conv2d`` default) -> fused
    LN/fc1/GELU/GRN/fc2 -> residual. With ``mask2d`` (``(B, H, W)`` bool,
    True where kept) the input is zeroed at masked positions before and
    after the depthwise conv and the fused segment runs masked.

    With stochastic depth active (training, ``drop_path > 0``) the fused
    kernel computes the (masked) branch alone (shortcut zeros: ``0 + z`` is
    ``z``), then ``DropPath`` scales it and the shortcut is added in torch,
    the JAX unfused block's order (``x * m``, drop path, ``+ shortcut``);
    otherwise one fused call adds the shortcut."""

    def __init__(
        self,
        dim: int,
        generator: torch.Generator,
        kernel_size: int = 7,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
        drop_path: float = 0.0,
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
        self.drop_path = DropPath(drop_path)

    def forward(
        self,
        x: torch.Tensor,
        generator: torch.Generator | None = None,
        keep: torch.Tensor | None = None,
        mask2d: torch.Tensor | None = None,
    ) -> torch.Tensor:
        m = None if mask2d is None else mask2d[..., None].to(x.dtype)
        y = x if m is None else x * m
        y = self.dwconv.nhwc(y, self.dtype, padding=self.kernel_size // 2)
        if m is not None:
            y = y * m
        if not self.drop_path.active:
            return mlp_grn_residual(y, x, self.layernorm, self.mlp, mask2d)
        branch = mlp_grn_residual(y, torch.zeros_like(y), self.layernorm, self.mlp, mask2d)
        return self.drop_path(branch, generator, keep) + x


class MaskedConvNeXtV2Stage(nn.Module):
    """LN + strided-conv downsample (when channels change or ``stride > 1``),
    then blocks (reference ``fcmae.py:224``); the mask is upsampled to the
    stage's grid after the downsample."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        generator: torch.Generator,
        kernel_size: int = 7,
        stride: int = 2,
        num_blocks: int = 2,
        dtype: torch.dtype = torch.float32,
        drop_path_rates: Sequence[float] | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        rates = list(drop_path_rates) if drop_path_rates is not None else [0.0] * num_blocks
        self.downsample = None
        if in_channels != out_channels or stride > 1:
            k = stride if stride > 1 else 1
            self.downsample = downsample(in_channels, out_channels, k, generator)
        self.blocks = nn.ModuleList(
            MaskedConvNeXtV2Block(out_channels, generator, kernel_size=kernel_size, dtype=dtype, drop_path=r)
            for r in rates
        )

    def forward(
        self,
        x: torch.Tensor,
        generator: torch.Generator | None = None,
        keeps=None,
        unmasked: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``keeps``: an iterator of per-block ``(B,)`` keep masks, else None;
        ``unmasked``: the ``(B, 1, h, w)`` bool mask of kept cells, else None."""
        if self.downsample is not None:
            x = apply_downsample(self.downsample, x, self.stride, self.dtype)
        mask2d = None if unmasked is None else upsample_mask_2d(unmasked, x.shape[1:3])
        for block in self.blocks:
            x = block(x, generator, None if keeps is None else next(keeps), mask2d)
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
        drop_path_rate: float = 0.0,
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
                drop_path_rates=[drop_path_rate] * n,
            )
            for i, n in enumerate(self.stage_blocks)
        )

    @property
    def total_stride(self) -> int:
        return int(self.stem_kernel_size[1] * 2 ** (len(self.stage_blocks) - 1))

    def forward(
        self,
        x: torch.Tensor,
        generator: torch.Generator | None = None,
        drop_path_masks=None,
        mask_ratio: float = 0.0,
        mask_generator: torch.Generator | None = None,
        mask: torch.Tensor | None = None,
    ) -> tuple[list[torch.Tensor], torch.Tensor | None]:
        """``(B, C, D, H, W)`` -> (channels-last features, one per stage;
        the ``(B, 1, H, W)`` bool mask, True = masked, or None).

        ``generator`` draws the blocks' drop-path masks in training;
        ``drop_path_masks`` gives them instead, one ``(B,)`` mask per block
        in block order. At ``mask_ratio > 0`` the token mask is drawn from
        ``mask_generator`` (:func:`generate_mask` at ``total_stride``);
        ``mask`` gives it instead, ``(B, 1, H / total_stride, W /
        total_stride)`` bool."""
        b, _, _, h, w = x.shape
        if mask is None and mask_ratio > 0.0:
            if mask_generator is None:
                raise ValueError("masking at mask_ratio > 0 needs a mask_generator or a given mask")
            mask = generate_mask(mask_generator, b, (h, w), self.total_stride, mask_ratio)
        unmasked = None
        if mask is not None:
            mask = mask.to(device=x.device, dtype=torch.bool)
            unmasked = ~mask
        y = self.stem(x, unmasked)
        keeps = None if drop_path_masks is None else iter(drop_path_masks)
        features = []
        for stage in self.stages:
            y = stage(y, generator, keeps, unmasked)
            features.append(y)
        full_mask = None if mask is None else upsample_mask_2d(mask, (h, w))[:, None]
        return features, full_mask


class FullyConvolutionalMAE(nn.Module):
    """FCMAE (reference ``fcmae.py:456``): masked pretraining
    (``pretraining=True``, ``forward`` returns ``(pred, mask)``) or
    supervised prediction (``pretraining=False``, ``forward`` returns
    ``pred``).

    ``head_conv`` swaps the pure pixel-shuffle head for ``PixelToVoxelHead``
    (2x shuffle, 3x3x3 conv, norm, PReLU, 1x1x1 conv, 2x shuffle).
    Keyword arguments follow the JAX model so its configs load. Weights are
    drawn from ``generator`` (default: a generator seeded with 0) with the
    flax initializers. ``fused_mlp`` is accepted for config compatibility:
    every block runs the fused MLP+GRN segment, there is no unfused path.
    ``encoder_drop_path_rate`` is every encoder block's stochastic-depth
    rate (reference ``fcmae.py:223``); it acts in training mode only, with
    the masks drawn from the ``generator`` given to ``forward`` (or the
    ``drop_path_masks`` given there).
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
        head_conv_expansion_ratio: int = 4,
        head_conv_pool: bool = True,
        dtype: str | torch.dtype | None = None,
        fused_mlp: bool = True,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.dims = tuple(dims)
        self.stem_kernel_size = tuple(stem_kernel_size)
        self.in_stack_depth = in_stack_depth
        self.pretraining = pretraining
        self.dtype = _dtype(dtype)
        self.encoder = MaskedMultiscaleEncoder(
            in_channels,
            generator,
            stage_blocks=encoder_blocks,
            dims=self.dims,
            stem_kernel_size=self.stem_kernel_size,
            in_stack_depth=in_stack_depth,
            dtype=self.dtype,
            drop_path_rate=encoder_drop_path_rate,
        )
        decoder_channels = list(self.dims[::-1])
        if head_conv:
            # the reference sizes this head by in_channels (fcmae.py:484-497)
            decoder_channels[-1] = (in_stack_depth + 2) * in_channels * 2**2 * head_conv_expansion_ratio
        else:
            decoder_channels[-1] = out_channels * in_stack_depth * self.stem_kernel_size[-1] ** 2
        self.decoder = UNeXt2Decoder(
            decoder_channels,
            [2] * (len(self.dims) - 1) + [self.stem_kernel_size[-1]],
            generator,
            conv_blocks=decoder_conv_blocks,
            dtype=self.dtype,
        )
        if head_conv:
            self.head = PixelToVoxelHead(
                decoder_channels[-1],
                out_channels,
                in_stack_depth,
                generator,
                expansion_ratio=head_conv_expansion_ratio,
                pool=head_conv_pool,
                dtype=self.dtype,
            )
        else:
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

    def forward(
        self,
        x: torch.Tensor,
        generator: torch.Generator | None = None,
        drop_path_masks=None,
        mask_ratio: float = 0.0,
        mask_generator: torch.Generator | None = None,
        mask: torch.Tensor | None = None,
    ):
        """``(B, C_in, D, H, W)`` -> float32 ``(B, C_out, D, H, W)``, and
        with ``pretraining`` also the ``(B, 1, H, W)`` bool mask (True =
        masked; None when nothing was masked). The drop-path ``generator`` /
        ``drop_path_masks`` and the token mask (``mask_ratio`` with
        ``mask_generator``, or a given low-resolution ``mask``) as in the
        encoder."""
        features, full_mask = self.encoder(x, generator, drop_path_masks, mask_ratio, mask_generator, mask)
        feat = self.decoder(features[::-1])
        out = self.head(feat).float()
        if self.pretraining:
            return out, full_mask
        return out
