"""2.5-D beta-VAE (counterpart of ``viscy_tpu/models/vae/beta_vae_25d.py``;
reference ``vae/beta_vae_25d.py:270``).

A ConvNeXt encoder behind a 3-D stem folding Z into channels, a globally
pooled latent (``fc_mean``, ``fc_logvar``, the reparameterized ``z``), a
``fc_decode`` projection back to the bottleneck grid, ``decoder_stages``
no-skip up stages (pixel shuffle x2, then a ConvNeXt-v2 stage, whose
blocks run the fused MLP+GRN kernels) and a ``PixelToVoxelHead``.

As in the JAX model, every up stage upsamples by 2 (its
``scale_factor=2 if i < len(channels)`` is always 2), so the
reconstruction's YX is ``2**(decoder_stages + 2) / (8 * stem YX stride)``
times the input's: twice it at the defaults.

Parameter names: the stem, the encoder (timm ``features_only`` names) and
the head as the port's other models name them; the rest after the flax
tree (``fc_mean``, ``fc_logvar``, ``fc_decode``, ``up{i}.conv`` with the
port's ``ConvNeXtStage`` names, dense fc1 / fc2).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from viscy_tpu_torch.models.components.blocks import ConvNeXtStage, Linear, MultiscaleEncoder, convnext_arch, \
    pixel_shuffle_2d
from viscy_tpu_torch.models.components.heads import PixelToVoxelHead
from viscy_tpu_torch.models.components.stems import StemDepthtoChannels


class VaeOutput(NamedTuple):
    recon_x: torch.Tensor
    mean: torch.Tensor
    logvar: torch.Tensor
    z: torch.Tensor


def reparameterize(mean: torch.Tensor, logvar: torch.Tensor, generator: torch.Generator | None,
                   eps: torch.Tensor | None) -> torch.Tensor:
    """``mean + exp(logvar / 2) * eps``, ``eps`` standard normal drawn from
    ``generator`` unless given (threefry and Philox draw differently, so
    tests hand JAX's draw in)."""
    if eps is None:
        if generator is None:
            raise ValueError("sampling the latent in training needs a torch.Generator or eps")
        eps = torch.randn(mean.shape, generator=generator, device=generator.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.device, mean.dtype)


class VaeUpStage(nn.Module):
    """Decoder up stage without skips: pixel shuffle by ``scale_factor``,
    then a ConvNeXt-v2 stage (an LN + 1x1 conv when the width changes, then
    ``conv_blocks`` blocks with dense fc1 / fc2). Channels-last."""

    def __init__(self, in_channels: int, out_channels: int, generator: torch.Generator, scale_factor: int = 2,
                 conv_blocks: int = 2) -> None:
        super().__init__()
        self.scale_factor = scale_factor
        mid = in_channels // scale_factor**2 if scale_factor > 1 else in_channels
        self.conv = ConvNeXtStage(mid, out_channels, generator, depth=conv_blocks, stride=1, conv_mlp=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale_factor > 1:
            x = pixel_shuffle_2d(x, self.scale_factor)
        return self.conv(x)


def encoder_grid(size: Sequence[int], stem_stride: Sequence[int], stages: int) -> tuple[int, int]:
    """The bottleneck's (h, w): the stem's VALID stride, then ``stages - 1``
    2x downsamples (floored)."""
    h, w = ((n - s) // s + 1 for n, s in zip(size, stem_stride[1:]))
    for _ in range(stages - 1):
        h, w = h // 2, w // 2
    return h, w


class BetaVae25D(nn.Module):
    """2.5-D beta-VAE: (B, C, D, H, W) -> :class:`VaeOutput` (``recon_x``
    float32 (B, C, out_stack_depth, ...), ``mean``, ``logvar``, ``z``).

    In training ``z`` is sampled (:func:`reparameterize`) and the encoder's
    drop path acts (masks from ``generator``, or ``drop_path_masks``); in
    eval ``z`` is the mean. ``input_spatial_size`` sets ``fc_decode``'s
    width (the flax model infers it from the input)."""

    def __init__(
        self,
        backbone: str = "convnext_tiny",
        in_channels: int = 2,
        in_stack_depth: int = 16,
        out_stack_depth: int = 16,
        latent_dim: int = 1024,
        input_spatial_size: Sequence[int] = (256, 256),
        stem_kernel_size: Sequence[int] = (2, 4, 4),
        stem_stride: Sequence[int] = (2, 4, 4),
        drop_path_rate: float = 0.0,
        decoder_stages: int = 4,
        head_expansion_ratio: int = 2,
        head_pool: bool = False,
        conv_blocks: int = 2,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        depths, dims, v2 = convnext_arch(backbone)
        self.in_channels, self.out_stack_depth = in_channels, out_stack_depth
        self.stem = StemDepthtoChannels(in_channels, in_stack_depth, dims[0], g, tuple(stem_kernel_size),
                                        tuple(stem_stride))
        self.encoder = MultiscaleEncoder(depths, dims, g, use_grn=v2, ls_init_value=None if v2 else 1e-6,
                                         drop_path_rate=drop_path_rate)
        base = dims[-1]
        self.grid = encoder_grid(input_spatial_size, stem_stride, len(dims))
        self.fc_mean = Linear(base, latent_dim, g)
        self.fc_logvar = Linear(base, latent_dim, g)
        self.fc_decode = Linear(latent_dim, base * self.grid[0] * self.grid[1], g)
        channels = [base] + [base // 2 ** (i + 1) for i in range(decoder_stages - 1)]
        head_in = (out_stack_depth + 2) * in_channels * 2**2 * head_expansion_ratio
        channels.append(head_in)
        self.num_up = len(channels) - 1
        for i in range(1, len(channels)):
            self.add_module(f"up{i - 1}", VaeUpStage(channels[i - 1], channels[i], g,
                                                     scale_factor=2 if i < len(channels) else 1,
                                                     conv_blocks=conv_blocks))
        self.head = PixelToVoxelHead(head_in, in_channels, out_stack_depth, g, expansion_ratio=head_expansion_ratio,
                                     pool=head_pool)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, eps: torch.Tensor | None = None,
                drop_path_masks=None) -> VaeOutput:
        bottom = self.encoder(self.stem(x), generator, drop_path_masks)[-1]
        if tuple(bottom.shape[1:3]) != self.grid:
            raise ValueError(f"the encoder's grid {tuple(bottom.shape[1:3])} is not the {self.grid} of "
                             "input_spatial_size")
        pooled = bottom.mean(dim=(1, 2))
        mean = torch.nn.functional.linear(pooled, self.fc_mean.weight, self.fc_mean.bias)
        logvar = torch.nn.functional.linear(pooled, self.fc_logvar.weight, self.fc_logvar.bias)
        z = reparameterize(mean, logvar, generator, eps) if self.training else mean
        y = torch.nn.functional.linear(z, self.fc_decode.weight, self.fc_decode.bias)
        y = y.reshape(-1, *self.grid, bottom.shape[-1])
        for i in range(self.num_up):
            y = getattr(self, f"up{i}")(y)
        return VaeOutput(recon_x=self.head(y), mean=mean, logvar=logvar, z=z)


def vae_loss(output: VaeOutput, target: torch.Tensor, beta: float = 1.0) -> tuple[torch.Tensor, dict]:
    """ELBO: reconstruction MSE + ``beta`` * KL (each a mean, float32);
    returns ``(loss, {"loss/recon", "loss/kl"})``. A reconstruction of
    another shape than the target raises, as in JAX."""
    recon = ((output.recon_x.float() - target.float()) ** 2).mean()
    kl = -0.5 * (1 + output.logvar - output.mean**2 - torch.exp(output.logvar)).mean()
    return recon + beta * kl, {"loss/recon": recon, "loss/kl": kl}
