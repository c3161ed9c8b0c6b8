"""Residual conv blocks of the 3-D U-Net family (counterpart of
``viscy_tpu/models/components/conv_blocks.py``): the activations, the
configurable norm, the sinusoidal timestep embedder and the
(time-conditioned) ``ResnetBlock`` that ``UNet3DBase`` builds FNet3D,
``UNetViT3D`` and ``CELLDiffNet`` from.

Activations are NCDHW, as torch's convolutions take them. Parameters use
the reference VisCy torch names (``block1.proj``, ``block1.norm``,
``mlp.1``, ``res_conv``; ``mlp.0`` / ``mlp.2`` of the embedder), so
``viscy_tpu.training.convert.convert_unet3d_state_dict`` /
``convert_celldiff_state_dict`` read them unchanged.
"""

from __future__ import annotations

import math
from typing import Callable, Literal

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
