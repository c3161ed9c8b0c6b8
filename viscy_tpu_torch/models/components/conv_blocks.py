"""Residual conv blocks (counterpart of
``viscy_tpu/models/components/conv_blocks.py``): the activations, the
configurable norm, the legacy U-Nets' ``ConvBlock`` (``ConvBlock2D`` /
``ConvBlock3D``), the sinusoidal timestep embedder and the
(time-conditioned) ``ResnetBlock`` that ``UNet3DBase`` builds FNet3D,
``UNetViT3D`` and ``CELLDiffNet`` from.

Activations are NC(D)HW, as torch's convolutions take them. Parameters use
the reference VisCy torch names (``Conv2d_{i}`` / ``Conv3d_{i}``,
``batch_norm_{i}``, ``resid_conv`` of a ``ConvBlock``; ``block1.proj``,
``block1.norm``, ``mlp.1``, ``res_conv``; ``mlp.0`` / ``mlp.2`` of the
embedder), so ``viscy_tpu.training.convert``'s converters read them
unchanged.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Literal, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.models.components.blocks import BatchNorm, Conv, Linear

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.2),
    "elu": F.elu,
    "selu": F.selu,
    "silu": F.silu,
    # flax nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "linear": lambda x: x,
}


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation of the JAX package's ``_activation`` table."""
    return _ACTIVATIONS[name]


def same_padding(size: int, kernel: int, stride: int = 1) -> tuple[int, int]:
    """XLA ``"SAME"`` padding of one axis: ``ceil(size / stride)`` outputs,
    the total pad split with the smaller half first (so an even kernel, or a
    stride, pads more on the high side than torch's symmetric ``padding``)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
              stride: int | Sequence[int] = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` on NC(D)HW ``x`` with a torch-layout
    ``weight`` (1-3 spatial dims): symmetric pads go to the convolution,
    others through ``F.pad`` first."""
    nd = x.ndim - 2
    stride = (stride,) * nd if isinstance(stride, int) else tuple(stride)
    pads = [same_padding(n, k, s) for n, k, s in zip(x.shape[2:], weight.shape[2:], stride)]
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    if all(lo == hi for lo, hi in pads):
        return conv(x, weight, bias, stride, tuple(lo for lo, _ in pads))
    x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    return conv(x, weight, bias, stride)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None = None,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training: ``where(keep, x / (1 - rate),
    0)``, each element kept with probability ``1 - rate``; the keep mask is
    drawn from ``generator`` or given (``x``'s shape, bool)."""
    if keep is None:
        if generator is None:
            raise ValueError("dropout in training needs a torch.Generator or a keep mask")
        keep = torch.rand(x.shape, generator=generator, device=generator.device) < 1.0 - rate
    keep_prob = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep.to(x.device), x / keep_prob, x.new_zeros(()))


class _BatchNorm(BatchNorm):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel axis 1."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class _GroupNorm(nn.Module):
    """``groups``-group norm, eps 1e-5 (torch's default), ``weight`` / ``bias``."""

    def __init__(self, channels: int, groups: int) -> None:
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.weight, self.bias, eps=1e-5)


class _InstanceNorm(nn.Module):
    """Non-affine instance norm, eps 1e-5 (torch ``InstanceNorm`` defaults)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, x.shape[1], eps=1e-5)


def norm_layer(kind: Literal["batch", "instance", "group", "none"], channels: int, groups: int = 8) -> nn.Module:
    """The JAX package's configurable ``Norm`` over the channel axis 1 of
    NCDHW maps: ``"batch"`` with flax semantics (momentum 0.9, eps 1e-5, the
    biased batch variance in the running statistics; torch's names
    ``weight``, ``bias``, ``running_mean``, ``running_var``), ``"instance"``
    (non-affine), ``"group"`` (``groups`` groups, affine) or ``"none"``."""
    if kind == "batch":
        return _BatchNorm(channels)
    if kind == "group":
        return _GroupNorm(channels, groups)
    if kind == "instance":
        return _InstanceNorm()
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding (``[cos | sin]`` of ``t`` times
    ``exp(-ln(10000) k / half)``, float32) through ``mlp.0`` -> SiLU ->
    ``mlp.2`` to ``hidden_size``."""

    def __init__(self, hidden_size: int, generator: torch.Generator, freq_embed_size: int = 256) -> None:
        super().__init__()
        self.freq_embed_size = freq_embed_size
        self.mlp = nn.ModuleList([Linear(freq_embed_size, hidden_size, generator), nn.SiLU(),
                                  Linear(hidden_size, hidden_size, generator)])

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.freq_embed_size // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        fc0, _, fc1 = self.mlp
        return F.linear(F.silu(F.linear(emb, fc0.weight, fc0.bias)), fc1.weight, fc1.bias)


class _Block(nn.Module):
    """One [conv 3^3 -> norm] sub-block's parameters: ``proj`` and ``norm``."""

    def __init__(self, in_ch: int, out_ch: int, norm: str, groups: int, generator: torch.Generator) -> None:
        super().__init__()
        self.proj = Conv(in_ch, out_ch, (3, 3, 3), generator)
        self.norm = norm_layer(norm, out_ch, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.conv3d(x, self.proj.weight, self.proj.bias, padding=1))


class ResnetBlock(nn.Module):
    """Two [conv 3^3 -> norm -> act] sub-blocks (``block1``, ``block2``),
    with the FiLM ``h * (scale + 1) + shift`` between ``block1``'s norm
    and its activation when ``time_emb_dim`` is set and time embeddings are
    given (``scale, shift`` from ``mlp.1(silu(time_embeds))``, chunked).
    With ``residual`` the input is added back, through the 1x1x1
    ``res_conv`` when the channels change; ``residual=False`` is a plain
    double conv."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        generator: torch.Generator,
        residual: bool = True,
        norm: str = "group",
        activation: str = "silu",
        groups: int = 8,
        time_emb_dim: int | None = None,
    ) -> None:
        super().__init__()
        self.out_channels = out_channels
        self.residual = residual
        self.act = _activation(activation)
        self.mlp = (nn.ModuleList([nn.SiLU(), Linear(time_emb_dim, 2 * out_channels, generator)])
                    if time_emb_dim is not None else None)
        self.block1 = _Block(in_channels, out_channels, norm, groups, generator)
        self.block2 = _Block(out_channels, out_channels, norm, groups, generator)
        self.res_conv = (Conv(in_channels, out_channels, (1, 1, 1), generator)
                         if residual and in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, time_embeds: torch.Tensor | None = None) -> torch.Tensor:
        h = self.block1(x)
        if self.mlp is not None and time_embeds is not None:
            fc = self.mlp[1]
            emb = F.linear(F.silu(time_embeds), fc.weight, fc.bias)[:, :, None, None, None]
            scale, shift = emb.chunk(2, dim=1)
            h = h * (scale + 1.0) + shift
        h = self.act(self.block2(self.act(h)))
        if self.residual:
            if self.res_conv is not None:
                x = F.conv3d(x, self.res_conv.weight, self.res_conv.bias)
            h = h + x
        return h


class ConvBlock(nn.Module):
    """``num_repeats`` x [conv -> dropout -> activation -> norm] (the
    reference's layer order ``'can'``, dropout right after each conv), XLA
    ``"SAME"`` padding for every kernel size, with an optional residual:
    a 1x1 ``resid_conv`` only when the channels SHRINK; when they grow the
    input is zero-padded on the LOW side of the channel axis, so it lands
    in the trailing channels (``conv_block_2d.py:330-339``).

    ``kernel_size`` sets the dimensionality: 2-D blocks name their convs
    ``Conv2d_{i}``, 3-D ones ``Conv3d_{i}``; every norm is
    ``batch_norm_{i}`` (flax BatchNorm semantics for ``"batch"``). A
    ``resid_conv`` exists only where the forward runs it. Dropout acts in
    training at ``dropout > 0``, its keep masks drawn from ``generator`` or
    taken in order from ``masks`` (an iterator of bool tensors)."""

    def __init__(
        self,
        in_filters: int,
        out_filters: int,
        generator: torch.Generator,
        kernel_size: Sequence[int] = (3, 3, 3),
        num_repeats: int = 2,
        residual: bool = True,
        norm: str = "batch",
        activation: str = "relu",
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.num_repeats = num_repeats
        self.residual = residual
        self.dropout = float(dropout)
        self.act = _activation(activation)
        self.in_filters, self.out_filters = in_filters, out_filters
        nd = len(self.kernel_size)
        self._conv_name = f"Conv{nd}d"
        for i in range(num_repeats):
            setattr(self, f"{self._conv_name}_{i}",
                    Conv(in_filters if i == 0 else out_filters, out_filters, self.kernel_size, generator))
            setattr(self, f"batch_norm_{i}", norm_layer(norm, out_filters))
        self.resid_conv = (Conv(in_filters, out_filters, (1,) * nd, generator)
                           if residual and in_filters > out_filters else None)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                masks: Iterator[torch.Tensor] | None = None) -> torch.Tensor:
        inp = x
        for i in range(self.num_repeats):
            conv = getattr(self, f"{self._conv_name}_{i}")
            x = conv_same(x, conv.weight, conv.bias)
            if self.dropout and self.training:
                x = dropout(x, self.dropout, generator, None if masks is None else next(masks))
            x = getattr(self, f"batch_norm_{i}")(self.act(x))
        if not self.residual:
            return x
        if self.resid_conv is not None:
            inp = conv_same(inp, self.resid_conv.weight, self.resid_conv.bias)
        elif self.in_filters < self.out_filters:
            inp = F.pad(inp, [0, 0] * (inp.ndim - 2) + [self.out_filters - self.in_filters, 0])
        return x + inp


class ConvBlock2D(ConvBlock):
    """Reference-named 2-D variant (``conv_block_2d.py:11``): 3x3 kernels."""

    def __init__(self, in_filters: int, out_filters: int, generator: torch.Generator,
                 kernel_size: Sequence[int] = (3, 3), **kwargs) -> None:
        super().__init__(in_filters, out_filters, generator, kernel_size, **kwargs)


class ConvBlock3D(ConvBlock):
    """Reference-named 3-D variant (``conv_block_3d.py:11``): 3x3x3 kernels."""
