"""ConvNeXt-v2 building blocks and the UNeXt2 decoder (counterpart of
``viscy_tpu/models/components/blocks.py``).

Activations are channels-last ``(B, H, W, C)`` as in the JAX package; the
convolutions view them as channels-last NCHW tensors, so no copy is made.
Parameters are float32 and use the reference VisCy torch layout and names
(``(O, I, kh, kw)`` convs, ``(O, I)`` linears), so released checkpoints
load with ``strict=True``. ``dtype`` is the compute dtype: inputs and
weights are cast to it where flax casts them (conv/dense outputs and their
bias adds in ``dtype``; LayerNorm statistics in float32). No autocast.

Every ConvNeXt-v2 block runs its LN -> fc1 -> GELU -> GRN -> fc2 ->
residual segment through :func:`viscy_tpu_torch.ops.fused_block.fused_mlp_grn`
(the Hopper kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from viscy_tpu_torch.ops.fused_block import fused_mlp_grn

Init = Callable[[torch.Tensor, torch.Generator], torch.Tensor]

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _fan_in(weight: torch.Tensor) -> int:
    # torch layout (O, I, *kernel): fan_in = I * prod(kernel)
    return math.prod(weight.shape[1:])


def trunc_normal_init(std: float = 0.02) -> Init:
    """timm ``_init_weights`` init: normal with ``std`` truncated at +-2 std
    (flax ``truncated_normal(stddev=std)``)."""

    def init(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)

    return init


def variance_scaling_init(scale: float) -> Init:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    ``scale=1`` is ``lecun_normal`` (flax's conv/dense default), ``scale=2``
    is ``he_normal``."""

    def init(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        std = math.sqrt(scale / _fan_in(weight)) / _TRUNC_STD
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)

    return init


def icnr_init(upsample_factor: int, upsample_dims: int, init: Init | None = None) -> Init:
    """ICNR init for a weight whose output feeds a pixel shuffle (reference
    ``components/blocks.py:14``): the ``factor**dims`` output channels of
    each shuffled phase group start equal. Output channel ``o = c * scale +
    phase`` (pixel-shuffle order), so one sub-kernel repeats along dim 0."""
    init = init or variance_scaling_init(2.0)
    scale = upsample_factor**upsample_dims

    def initializer(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        out = weight.shape[0]
        if scale <= 1 or out % scale:
            return init(weight, generator)
        sub = init(torch.empty((out // scale, *weight.shape[1:])), generator)
        with torch.no_grad():
            weight.copy_(sub.repeat_interleave(scale, dim=0))
        return weight

    return initializer


class Conv(nn.Module):
    """Convolution parameters ``weight (O, I/groups, *kernel)`` and ``bias (O,)``."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel: Sequence[int],
        generator: torch.Generator,
        groups: int = 1,
        bias: bool = True,
        init: Init | None = None,
    ) -> None:
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch // groups, *kernel)))
        with torch.no_grad():
            (init or variance_scaling_init(1.0))(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def nhwc(self, x: torch.Tensor, dtype: torch.dtype, stride: int = 1, padding: int = 0):
        """flax ``nn.Conv(dtype=dtype)`` on channels-last 2-D input."""
        y = F.conv2d(
            x.permute(0, 3, 1, 2).to(dtype),
            self.weight.to(dtype),
            None,
            stride,
            padding,
            1,
            self.groups,
        ).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class Linear(nn.Module):
    """Dense parameters ``weight (O, I)`` and ``bias (O,)``."""

    def __init__(
        self, in_dim: int, out_dim: int, generator: torch.Generator, init: Init | None = None
    ) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_dim, in_dim)))
        with torch.no_grad():
            (init or variance_scaling_init(1.0))(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_dim))


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, dtype: torch.dtype
) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis: f32 statistics
    with the fast variance ``max(E[x^2] - mu^2, 0)``, output in ``dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    y = (x32 - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(dtype)


class LayerNorm(nn.Module):
    """Channels-last LayerNorm with ``weight``/``bias`` (flax scale/bias)."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, dtype)


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXt-v2) parameters: ``gamma``
    (``weight``) and ``beta`` (``bias``), both zero at init. The GRN itself
    (``gx = ||x||_2`` over the spatial axes, ``nx = gx / mean_c(gx)``,
    ``gamma * x * nx + beta + x``) runs inside
    :func:`viscy_tpu_torch.ops.fused_block.fused_mlp_grn`."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def pixel_shuffle_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sub-pixel upsample, torch ``nn.PixelShuffle`` channel order:
    ``(B, H, W, C*r*r) -> (B, H*r, W*r, C)``, channel ``k = c*r^2 + i*r + j``."""
    return rearrange(x, "b h w (c i j) -> b (h i) (w j) c", i=r, j=r)


def pad_pool_blur_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """MONAI SubpixelUpsample pad-pool blur: zero pad of ``r - 1`` on the
    LEADING (top/left) edges, then a stride-1 ``r x r`` mean."""
    if r == 1:
        return x
    x = F.pad(x, (0, 0, r - 1, 0, r - 1, 0))
    return F.avg_pool2d(x.permute(0, 3, 1, 2), r, stride=1).permute(0, 2, 3, 1)


class GrnMlp(nn.Module):
    """fc1 / GRN / fc2 parameters of a ConvNeXt-v2 MLP. ``conv_mlp`` keeps
    fc1/fc2 as 1x1 convs (timm ``conv_mlp=True``, the decoder), else dense."""

    def __init__(
        self,
        dim: int,
        hidden: int,
        generator: torch.Generator,
        conv_mlp: bool = False,
        fc2_init: Init | None = None,
    ) -> None:
        super().__init__()
        if conv_mlp:
            self.fc1 = Conv(dim, hidden, (1, 1), generator, init=trunc_normal_init())
            self.grn = GRN(hidden)
            self.fc2 = Conv(hidden, dim, (1, 1), generator, init=fc2_init or trunc_normal_init())
        else:
            self.fc1 = Linear(dim, hidden, generator, init=trunc_normal_init())
            self.grn = GRN(hidden)
            self.fc2 = Linear(hidden, dim, generator, init=fc2_init or trunc_normal_init())


def mlp_grn_residual(
    x: torch.Tensor, shortcut: torch.Tensor, norm: LayerNorm, mlp: GrnMlp
) -> torch.Tensor:
    """``shortcut + fc2(GRN(gelu(fc1(LN(x)))))`` on channels-last maps
    through the fused kernel (the block's whole MLP segment)."""
    b, h, w, c = x.shape
    m = mlp.grn.weight.shape[0]
    out = fused_mlp_grn(
        x.reshape(b, h * w, c).contiguous(),
        shortcut.reshape(b, h * w, c).contiguous(),
        norm.weight,
        norm.bias,
        mlp.fc1.weight.view(m, c),
        mlp.fc1.bias,
        mlp.grn.weight,
        mlp.grn.bias,
        mlp.fc2.weight.view(c, m),
        mlp.fc2.bias,
        eps_ln=norm.eps,
        eps_grn=mlp.grn.eps,
    )
    return out.reshape(b, h, w, c)


class ConvNeXtBlock(nn.Module):
    """timm ConvNeXt-v2 block with 1x1-conv MLP (decoder refinement):
    7x7 depthwise conv (with bias) -> fused LN/fc1/GELU/GRN/fc2 -> residual.

    Only the inference path of the JAX block's v2 configuration exists here
    (GRN, no layer scale, no stochastic depth); it always runs the fused
    segment."""

    def __init__(
        self,
        dim: int,
        generator: torch.Generator,
        kernel_size: int = 7,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
        fc2_init: Init | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.conv_dw = Conv(
            dim, dim, (kernel_size, kernel_size), generator, groups=dim, init=trunc_normal_init()
        )
        self.norm = LayerNorm(dim)
        self.mlp = GrnMlp(dim, mlp_ratio * dim, generator, conv_mlp=True, fc2_init=fc2_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_dw.nhwc(x, self.dtype, padding=self.kernel_size // 2)
        return mlp_grn_residual(y, x, self.norm, self.mlp)


def downsample(in_chs: int, out_chs: int, k: int, generator: torch.Generator) -> nn.ModuleList:
    """LayerNorm + ``k x k`` stride-``k`` conv pair (timm stage downsample;
    state-dict names ``downsample.0`` / ``downsample.1``)."""
    return nn.ModuleList(
        [LayerNorm(in_chs), Conv(in_chs, out_chs, (k, k), generator, init=trunc_normal_init())]
    )


def apply_downsample(ds: nn.ModuleList, x: torch.Tensor, stride: int, dtype) -> torch.Tensor:
    return ds[1].nhwc(ds[0](x, dtype), dtype, stride=stride)


class ConvNeXtStage(nn.Module):
    """Optional LN + strided-conv downsample (when ``in_chs != out_chs`` or
    ``stride > 1``), then ConvNeXt blocks; ``last_fc2_init`` initializes the
    last block's fc2 (ICNR when the stage feeds a pixel shuffle)."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        generator: torch.Generator,
        depth: int = 2,
        stride: int = 2,
        kernel_size: int = 7,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
        last_fc2_init: Init | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.downsample = None
        if in_chs != out_chs or stride > 1:
            self.downsample = downsample(in_chs, out_chs, stride if stride > 1 else 1, generator)
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(
                out_chs,
                generator,
                kernel_size=kernel_size,
                mlp_ratio=mlp_ratio,
                dtype=dtype,
                fc2_init=last_fc2_init if i == depth - 1 else None,
            )
            for i in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = apply_downsample(self.downsample, x, self.stride, self.dtype)
        for block in self.blocks:
            x = block(x)
        return x


class UNeXt2UpStage(nn.Module):
    """Decoder stage: pixel-shuffle upsample, concat skip, ConvNeXt refine.

    As in the reference (``components/blocks.py:77``), the refining stage is
    built for ``in_channels / scale^2 + in_channels / 2`` input channels
    (upsampled map plus the skip one level up)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        scale_factor: int,
        generator: torch.Generator,
        conv_blocks: int = 2,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.scale_factor = scale_factor
        mid = in_channels // scale_factor**2
        self.conv = ConvNeXtStage(
            mid + in_channels // 2,
            out_channels,
            generator,
            depth=conv_blocks,
            stride=1,
            dtype=dtype,
            last_fc2_init=icnr_init(scale_factor, 2),
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
        x = pixel_shuffle_2d(x, self.scale_factor)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.conv(x)


class UNeXt2Decoder(nn.Module):
    """Multi-stage decoder (reference ``components/blocks.py:175``);
    ``num_channels`` runs bottleneck -> output, stage ``i`` upsamples by
    ``strides[i]`` and fuses the next-higher-resolution skip."""

    def __init__(
        self,
        num_channels: Sequence[int],
        strides: Sequence[int],
        generator: torch.Generator,
        conv_blocks: int = 2,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.decoder_stages = nn.ModuleList(
            UNeXt2UpStage(
                num_channels[i],
                num_channels[i + 1],
                strides[i],
                generator,
                conv_blocks=conv_blocks,
                dtype=dtype,
            )
            for i in range(len(num_channels) - 1)
        )

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        feat = features[0]
        skips = list(features[1:]) + [None]
        for stage, skip in zip(self.decoder_stages, skips):
            feat = stage(feat, skip)
        return feat
