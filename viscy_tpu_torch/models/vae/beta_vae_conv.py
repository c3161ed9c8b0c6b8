"""Generic strided-conv beta-VAE (counterpart of
``viscy_tpu/models/vae/beta_vae_conv.py``; reference
``vae/beta_vae_monai.py:12``, which wraps MONAI's ``VarAutoEncoder``).

A ladder of XLA-``"SAME"`` strided convs (or MONAI-style residual units)
with instance norm (eps 1e-6, flax's ``GroupNorm`` default) and a PReLU of
one slope (0.25 at init), a dense latent with the reparameterization, and
a transposed-conv decoder (flax ``nn.ConvTranspose``, ``"SAME"``: the
input dilated by the stride, padded as ``lax.conv_transpose`` pads, then
a convolution with the kernel as stored), cropped back to ``in_shape``.
``norm="batch"`` is instance norm too, the JAX package's documented
deviation. Returns :class:`VaeOutput`.

Parameter names follow the flax tree (``down{i}``, ``down_adn{i}.prelu``,
``down{i}.conv{j}`` / ``.adn{j}`` / ``.skip``, ``mu``, ``logvar``,
``decode_fc``, ``up{i}``, ``up_adn{i}``). NC(D)HW in and out.
"""

from __future__ import annotations

import math
from typing import Literal, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.models.components.blocks import Conv, Linear
from viscy_tpu_torch.models.components.conv_blocks import conv_same
from viscy_tpu_torch.models.vae.beta_vae_25d import VaeOutput, reparameterize


def _tuple(v, n: int) -> tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(int(x) for x in v)


class _NormAct(nn.Module):
    """Non-affine instance norm (float32 fast variance, eps 1e-6), then a
    PReLU whose one slope is ``prelu``."""

    def __init__(self) -> None:
        super().__init__()
        self.prelu = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(2, x.ndim))
        mu = x32.mean(dim=axes, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(dim=axes, keepdim=True) - mu * mu, 0.0)
        y = ((x32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)
        return torch.where(y >= 0, y, self.prelu * y)


def _conv(conv: Conv, x: torch.Tensor, stride) -> torch.Tensor:
    return conv_same(x, conv.weight, conv.bias, stride)


class _ResidualUnit(nn.Module):
    """MONAI ``ResidualUnit`` shape semantics: ``subunits`` [conv -> norm ->
    PReLU], the first strided; a strided 1x1 ``skip`` conv when the output
    shape differs from the input's."""

    def __init__(self, in_ch: int, channels: int, kernel, stride, in_spatial, generator, subunits: int = 2) -> None:
        super().__init__()
        self.stride = tuple(stride)
        self.subunits = max(subunits, 1)
        for i in range(self.subunits):
            self.add_module(f"conv{i}", Conv(in_ch if i == 0 else channels, channels, kernel, generator))
            self.add_module(f"adn{i}", _NormAct())
        out_spatial = [-(-n // s) for n, s in zip(in_spatial, stride)]
        self.skip = (Conv(in_ch, channels, (1,) * len(kernel), generator)
                     if in_ch != channels or list(in_spatial) != out_spatial else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.subunits):
            y = getattr(self, f"adn{i}")(_conv(getattr(self, f"conv{i}"), y, self.stride if i == 0 else 1))
        return y + (x if self.skip is None else _conv(self.skip, x, self.stride))


def conv_transpose_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                        stride: Sequence[int]) -> torch.Tensor:
    """flax ``nn.ConvTranspose(padding="SAME", transpose_kernel=False)``:
    ``x`` dilated by ``stride`` (zeros between samples), padded per axis as
    ``lax.conv_transpose`` pads ``"SAME"`` (``k + s - 2`` in all, ``k - 1``
    before when ``s > k - 1``, else the ceiling half), then a stride-1
    convolution with ``weight`` as stored (torch layout (O, I, *k)):
    ``in * stride`` outputs an axis."""
    nd = x.ndim - 2
    if any(s > 1 for s in stride):
        shape = (*x.shape[:2], *((n - 1) * s + 1 for n, s in zip(x.shape[2:], stride)))
        dilated = x.new_zeros(shape)
        dilated[(slice(None), slice(None), *(slice(None, None, s) for s in stride))] = x
        x = dilated
    pads = []
    for k, s in zip(weight.shape[2:], stride):
        total = k + s - 2
        lo = k - 1 if s > k - 1 else math.ceil(total / 2)
        pads.append((lo, total - lo))
    x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    return (F.conv1d, F.conv2d, F.conv3d)[nd - 1](x, weight, bias)


class BetaVaeConv(nn.Module):
    """Strided-conv VAE over 2-D or 3-D inputs (``BetaVaeMonai``'s
    counterpart): (B, C, *spatial) -> :class:`VaeOutput`. In training ``z``
    is sampled (:func:`reparameterize`), in eval it is the mean."""

    def __init__(
        self,
        spatial_dims: int,
        in_shape: Sequence[int],
        out_channels: int,
        latent_size: int,
        channels: Sequence[int],
        strides: Sequence[int] | Sequence[Sequence[int]],
        kernel_size: Sequence[int] | int = 3,
        up_kernel_size: Sequence[int] | int = 3,
        num_res_units: int = 0,
        use_sigmoid: bool = False,
        norm: Literal["batch", "instance"] = "instance",
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        nd = spatial_dims
        self.in_shape = tuple(in_shape)
        self.use_sigmoid = use_sigmoid
        kernel, up_kernel = _tuple(kernel_size, nd), _tuple(up_kernel_size, nd)
        self.strides = [_tuple(s, nd) for s in strides]
        self.res = num_res_units > 0
        c, spatial = self.in_shape[0], list(self.in_shape[1:])
        for i, (ch, st) in enumerate(zip(channels, self.strides)):
            if self.res:
                self.add_module(f"down{i}", _ResidualUnit(c, ch, kernel, st, spatial, g, subunits=num_res_units))
            else:
                self.add_module(f"down{i}", Conv(c, ch, kernel, g))
                self.add_module(f"down_adn{i}", _NormAct())
            c, spatial = ch, [-(-n // s) for n, s in zip(spatial, st)]
        self.n_down = len(channels)
        self.feat_shape = (c, *spatial)
        flat = math.prod(self.feat_shape)
        self.mu = Linear(flat, latent_size, g)
        self.logvar = Linear(flat, latent_size, g)
        self.decode_fc = Linear(latent_size, flat, g)
        dec_channels = list(channels[-2::-1]) + [out_channels]
        self.n_up = len(list(zip(dec_channels, self.strides[::-1])))
        for i, ch in enumerate(dec_channels[: self.n_up]):
            self.add_module(f"up{i}", Conv(c, ch, up_kernel, g))
            if i < len(dec_channels) - 1:
                self.add_module(f"up_adn{i}", _NormAct())
            c = ch

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None) -> VaeOutput:
        h = x
        for i, st in enumerate(self.strides[: self.n_down]):
            if self.res:
                h = getattr(self, f"down{i}")(h)
            else:
                h = getattr(self, f"down_adn{i}")(_conv(getattr(self, f"down{i}"), h, st))
        # flax flattens channels-last: (*spatial, C)
        flat = h.movedim(1, -1).reshape(h.shape[0], -1)
        mean = F.linear(flat, self.mu.weight, self.mu.bias)
        logvar = F.linear(flat, self.logvar.weight, self.logvar.bias)
        z = reparameterize(mean, logvar, generator, eps) if self.training else mean
        c, *spatial = self.feat_shape
        h = F.linear(z, self.decode_fc.weight, self.decode_fc.bias).reshape(-1, *spatial, c).movedim(-1, 1)
        for i, st in enumerate(self.strides[::-1][: self.n_up]):
            up = getattr(self, f"up{i}")
            h = conv_transpose_same(h, up.weight, up.bias, st)
            adn = getattr(self, f"up_adn{i}", None)
            if adn is not None:
                h = adn(h)
        h = h[(slice(None), slice(None), *(slice(0, t) for t in self.in_shape[1:]))]
        if self.use_sigmoid:
            h = torch.sigmoid(h)
        return VaeOutput(recon_x=h, mean=mean, logvar=logvar, z=z)


# the reference's name (its MONAI backend replaced by plain convs)
BetaVaeMonai = BetaVaeConv
