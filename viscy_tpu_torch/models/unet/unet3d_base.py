"""Parametrized 3-D U-Net with an injected bottleneck (counterpart of
``viscy_tpu/models/unet/unet3d_base.py``; reference ``unet/unet3d_base.py:19``),
shared by FNet3D (``Unet3d``), ``UNetViT3D`` and ``CELLDiffNet``.

NCDHW in and out. The encoder halves YX (and Z with ``downsample_z``) with
a strided 3^3 conv after each level; the decoder upsamples with a
transposed conv and concatenates the level's skips one block at a time.
An optional conditioning input adds ``_cond_inconv(cond)`` to the first
conv's output, and timestep embeddings condition every block (FiLM).
Parameters use the reference torch names (``inconv``, ``_cond_inconv``,
``_time_embedder``, ``_encoder_blocks.i.j``, ``_downsamples.i``,
``bottleneck``, ``_upsamples.i``, ``_decoder_blocks.i.j``, ``outconv``).
The reference's fixed ``_time_embedder.freqs`` and ``img_pos_embed``
buffers are recomputed, as in the JAX package, and dropped from a
``state_dict`` that carries them when it loads.
"""

from __future__ import annotations

from typing import Literal, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.models.components.blocks import Conv, variance_scaling_init
from viscy_tpu_torch.models.components.conv_blocks import ResnetBlock, TimestepEmbedder

# the reference's fixed buffers, recomputed here (and by the JAX converter)
_RECOMPUTED_BUFFERS = ("_time_embedder.freqs", "img_pos_embed")


class ConvTranspose(nn.Module):
    """Transposed-convolution parameters in torch's layout: ``weight (I, O,
    *kernel)`` and ``bias (O,)`` (flax ``ConvTranspose(transpose_kernel=True)``
    stores the same kernel as ``(*kernel, O, I)``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int], generator: torch.Generator) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty((in_ch, out_ch, *kernel)))
        with torch.no_grad():
            variance_scaling_init(1.0)(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch))


class IdentityBottleneck(nn.Module):
    """Pass-through bottleneck."""

    def forward(self, x: torch.Tensor, time_embeds: torch.Tensor | None = None) -> torch.Tensor:
        return x


class ResnetBottleneck(nn.Module):
    """One ``ResnetBlock`` at the bottleneck (reference ``ConvBottleneck3D``),
    under the name ``block``."""

    def __init__(
        self,
        dim: int,
        generator: torch.Generator,
        residual: bool = True,
        norm: str = "group",
        activation: str = "silu",
        groups: int = 8,
        time_emb_dim: int | None = None,
    ) -> None:
        super().__init__()
        self.block = ResnetBlock(dim, dim, generator, residual, norm, activation, groups, time_emb_dim)

    def forward(self, x: torch.Tensor, time_embeds: torch.Tensor | None = None) -> torch.Tensor:
        return self.block(x, time_embeds)


class UNet3DBase(nn.Module):
    """Encoder -> ``bottleneck`` -> decoder with concatenated skips.

    ``bottleneck`` is a module called as ``bottleneck(h, time_embeds)``
    on the deepest level's ``dims[-1]`` channels. ``time_embed_dim`` builds
    the timestep embedder and conditions every block; ``cond_channels``
    builds ``_cond_inconv``. Weights are drawn from ``generator``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        dims: Sequence[int],
        num_res_block: Sequence[int],
        bottleneck: nn.Module,
        generator: torch.Generator,
        downsample_z: bool = False,
        residual: bool = True,
        norm: Literal["group", "batch"] = "group",
        activation: Literal["silu", "relu"] = "silu",
        groups: int = 8,
        time_embed_dim: int | None = None,
        cond_channels: int | None = None,
    ) -> None:
        super().__init__()
        if len(dims) != len(num_res_block) + 1:
            raise ValueError("len(dims) must equal len(num_res_block) + 1")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.dims = tuple(dims)
        self.num_res_block = tuple(num_res_block)
        self.downsample_z = downsample_z
        g = generator
        block = dict(residual=residual, norm=norm, activation=activation, groups=groups,
                     time_emb_dim=time_embed_dim)
        self.inconv = Conv(in_channels, dims[0], (3, 3, 3), g)
        self._cond_inconv = Conv(cond_channels, dims[0], (3, 3, 3), g) if cond_channels is not None else None
        self._time_embedder = TimestepEmbedder(time_embed_dim, g) if time_embed_dim is not None else None
        levels = range(len(self.num_res_block))
        self._encoder_blocks = nn.ModuleList(
            nn.ModuleList(ResnetBlock(dims[i], dims[i], g, **block) for _ in range(num_res_block[i]))
            for i in levels)
        self._downsamples = nn.ModuleList(Conv(dims[i], dims[i + 1], (3, 3, 3), g) for i in levels)
        self.bottleneck = bottleneck
        up_kernel = (3, 3, 3) if downsample_z else (1, 3, 3)
        self._upsamples = nn.ModuleList(ConvTranspose(dims[i + 1], dims[i], up_kernel, g) for i in reversed(levels))
        self._decoder_blocks = nn.ModuleList(
            nn.ModuleList(ResnetBlock(2 * dims[i], dims[i], g, **block) for _ in range(num_res_block[i]))
            for i in reversed(levels))
        self.outconv = Conv(dims[0], out_channels, (3, 3, 3), g)
        self.register_load_state_dict_pre_hook(_drop_recomputed_buffers)

    @property
    def num_blocks(self) -> int:
        return len(self.num_res_block)

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None = None, t: torch.Tensor | None = None) -> torch.Tensor:
        divisor = 2 ** len(self.num_res_block)
        for name, size in zip(("D", "H", "W"), x.shape[2:]):
            if (self.downsample_z or name != "D") and size % divisor != 0:
                raise ValueError(f"Spatial dim {name}={size} must be divisible by {divisor}")
        time_embeds = self._time_embedder(t) if self._time_embedder is not None and t is not None else None
        # torch Conv3d(k=3, s=2, p=1) is what the JAX code's explicit (1, 1) pad reproduces
        stride = (2, 2, 2) if self.downsample_z else (1, 2, 2)
        # ConvTranspose3d(k, s, p, output_padding) = the JAX code's (k-1-p, k-1-p+op) pad
        up_pad, up_out_pad = ((1, 1, 1), (1, 1, 1)) if self.downsample_z else ((0, 1, 1), (0, 1, 1))

        h = F.conv3d(x, self.inconv.weight, self.inconv.bias, padding=1)
        if self._cond_inconv is not None and cond is not None:
            h = h + F.conv3d(cond, self._cond_inconv.weight, self._cond_inconv.bias, padding=1)
        skips: list[torch.Tensor] = []
        for blocks, down in zip(self._encoder_blocks, self._downsamples):
            for blk in blocks:
                h = blk(h, time_embeds)
                skips.append(h)
            h = F.conv3d(h, down.weight, down.bias, stride=stride, padding=1)
        h = self.bottleneck(h, time_embeds)
        for up, blocks in zip(self._upsamples, self._decoder_blocks):
            h = F.conv_transpose3d(h, up.weight, up.bias, stride=stride, padding=up_pad, output_padding=up_out_pad)
            for blk in blocks:
                h = blk(torch.cat([h, skips.pop()], dim=1), time_embeds)
        return F.conv3d(h, self.outconv.weight, self.outconv.bias, padding=1)


def _drop_recomputed_buffers(module, state_dict, prefix, *args) -> None:
    for k in [k for k in state_dict if k.startswith(prefix) and k.endswith(_RECOMPUTED_BUFFERS)]:
        del state_dict[k]
