"""PatchGAN 3-D discriminators (counterpart of
``viscy_tpu/models/gan/patchgan3d.py``; reference ``gan/patchgan3d.py:22,132``).

``PatchGAN3D``: ``n_layers`` k=4 convs with explicit (1, 1) padding on
every axis and strides (1,2,2), (1,2,2), (2,2,2), (2,2,2); an affine
instance norm (eps 1e-5, one channel per group, float32 statistics with
the fast variance as flax's ``GroupNorm``) on layers 2 and up; LeakyReLU
0.2; a (1, 4, 4) logit conv padded in YX only. ``MultiScalePatchGAN3D``
runs independent instances on YX-average-pooled (VALID) inputs.

Spectral normalization is the JAX package's (flax ``nn.SpectralNorm``),
not torch's ``spectral_norm``: every call runs one power iteration from
the stored ``u`` (1, C_out) on the kernel flattened as flax flattens it
(``(kd kh kw C_in, C_out)``), divides the kernel by ``sigma = v W u^T``
with ``u`` and ``v`` held constant (``sigma`` itself is differentiated),
in training and in eval alike. The new ``u`` and ``sigma`` are stored only
for a call with ``update_stats=True``, and only when
:meth:`MultiScalePatchGAN3D.commit_stats` is called, so every call of a
step, before and after the updating one, starts from the same ``u``, as
the JAX engine's step does. ``u`` and ``sigma`` are buffers, in the state
dict and checkpoints.

Activations are NCDHW; ``return_features`` adds every layer's activation
(after its LeakyReLU).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.models.components.blocks import Conv


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax ``_l2_normalize``: ``x * rsqrt(sum(x^2) + eps)``."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNormConv3d(Conv):
    """A 3-D conv whose kernel is spectrally normalized as flax's
    ``SpectralNorm`` does it (one power-iteration step a call); without
    ``spectral_norm`` a plain conv. Buffers ``u`` (1, C_out) and ``sigma``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int], stride: Sequence[int],
                 padding: Sequence[int], generator: torch.Generator, spectral_norm: bool = True,
                 eps: float = 1e-12) -> None:
        super().__init__(in_ch, out_ch, tuple(kernel), generator)
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.spectral_norm, self.eps = spectral_norm, eps
        self.pending: tuple[torch.Tensor, torch.Tensor] | None = None
        if spectral_norm:
            self.register_buffer("u", torch.randn((1, out_ch), generator=generator))
            self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool = False) -> torch.Tensor:
        """The kernel divided by its power-iteration ``sigma``; with
        ``update_stats`` the new ``u`` and ``sigma`` wait in ``pending``."""
        if not self.spectral_norm:
            return self.weight
        w = self.weight
        mat = w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0])
        with torch.no_grad():
            v = _l2_normalize(self.u.to(mat.dtype) @ mat.t(), self.eps)
            u = _l2_normalize(v @ mat, self.eps)
        sigma = (v @ mat @ u.t())[0, 0]
        if update_stats:
            self.pending = (u, sigma.detach())
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return F.conv3d(x, self.normalized_weight(update_stats), self.bias, self.stride, self.padding)

    @torch.no_grad()
    def commit(self) -> None:
        if self.pending is not None:
            self.u.copy_(self.pending[0])
            self.sigma.copy_(self.pending[1])
            self.pending = None


class InstanceNorm3d(nn.Module):
    """Affine instance norm (torch ``InstanceNorm3d(affine=True)``, eps
    1e-5): flax ``GroupNorm`` with one channel per group, float32 fast
    variance ``max(E[x^2] - mu^2, 0)``, ``(x - mu) * (rsqrt(var + eps) *
    weight) + bias``. Written out, so it is twice differentiable (R1/R2)."""

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(2, x.ndim))
        mu = x32.mean(dim=axes, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(dim=axes, keepdim=True) - mu * mu, 0.0)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.weight.view(shape)) + self.bias.view(shape)
        return y.to(x.dtype)


class PatchGAN3D(nn.Module):
    """Single-scale 3-D PatchGAN: (B, C, D, H, W) -> patch logits
    (``layer{1..n}`` convs with their norms at ``.1``, ``layer{n+1}`` the
    logit conv)."""

    def __init__(self, in_channels: int = 2, base_channels: int = 64, n_layers: int = 4,
                 use_spectral_norm: bool = True, generator: torch.Generator | None = None) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.n_layers = n_layers
        c = in_channels
        for i in range(1, n_layers + 1):
            ch = base_channels * min(2 ** (i - 1), 8)
            stride = (1, 2, 2) if i <= 2 else (2, 2, 2)
            layer = [SpectralNormConv3d(c, ch, (4, 4, 4), stride, (1, 1, 1), g, use_spectral_norm)]
            if i > 1:
                layer.append(InstanceNorm3d(ch))
            self.add_module(f"layer{i}", nn.ModuleList(layer))
            c = ch
        self.add_module(f"layer{n_layers + 1}",
                        SpectralNormConv3d(c, 1, (1, 4, 4), (1, 1, 1), (0, 1, 1), g, use_spectral_norm))

    def forward(self, x: torch.Tensor, return_features: bool = False, update_stats: bool = False):
        features = []
        h = x
        for i in range(1, self.n_layers + 1):
            layer = getattr(self, f"layer{i}")
            h = layer[0](h, update_stats)
            if len(layer) > 1:
                h = layer[1](h)
            h = F.leaky_relu(h, 0.2)
            features.append(h)
        logits = getattr(self, f"layer{self.n_layers + 1}")(h, update_stats)
        return (logits, features) if return_features else logits


class MultiScalePatchGAN3D(nn.Module):
    """``num_scales`` PatchGAN3D instances (``discriminators.{s}``), scale
    ``s`` on the input average-pooled ``s`` times over (1, 2, 2), VALID.
    Returns the list of per-scale logits, with ``return_features`` also the
    per-scale lists of layer activations."""

    def __init__(self, in_channels: int = 2, base_channels: int = 64, n_layers: int = 4, num_scales: int = 2,
                 use_spectral_norm: bool = True, generator: torch.Generator | None = None) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.in_channels = in_channels
        self.discriminators = nn.ModuleList(
            PatchGAN3D(in_channels, base_channels, n_layers, use_spectral_norm, g) for _ in range(num_scales))

    def forward(self, x: torch.Tensor, return_features: bool = False, update_stats: bool = False):
        outputs, features = [], []
        current = x
        for s, d in enumerate(self.discriminators):
            out = d(current, return_features=return_features, update_stats=update_stats)
            if return_features:
                outputs.append(out[0])
                features.append(out[1])
            else:
                outputs.append(out)
            if s < len(self.discriminators) - 1:
                current = F.avg_pool3d(current, (1, 2, 2))
        return (outputs, features) if return_features else outputs

    def commit_stats(self) -> None:
        """Store the ``u`` and ``sigma`` of the last ``update_stats`` call."""
        for m in self.modules():
            if isinstance(m, SpectralNormConv3d):
                m.commit()
