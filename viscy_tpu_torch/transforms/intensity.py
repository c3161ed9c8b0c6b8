"""Batched intensity augmentations (counterpart of
``viscy_tpu/transforms/intensity.py``): per-sample random parameters and
Bernoulli application masks, plain PyTorch."""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F

from viscy_tpu_torch.transforms.base import RandTransform

__all__ = [
    "BatchedRandAdjustContrastd",
    "BatchedRandGaussianNoised",
    "BatchedRandScaleIntensityd",
    "BatchedRandGaussianSmoothd",
]


def _per_sample(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reshape a (B,) parameter vector to broadcast over (B, C, ...)."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def _uniform(generator, shape, lo, hi, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=lo, maxval=hi)``'s law."""
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def _adjust_contrast(x, gamma, invert: bool, retain_stats: bool) -> torch.Tensor:
    """MONAI AdjustContrast math, per sample."""
    eps = 1e-7
    dims = tuple(range(1, x.ndim))
    if invert:
        x = -x
    if retain_stats:
        mean0 = x.mean(dim=dims, keepdim=True)
        std0 = x.std(dim=dims, keepdim=True, correction=0)
    mn = x.amin(dim=dims, keepdim=True)
    rng = x.amax(dim=dims, keepdim=True) - mn
    y = ((x - mn) / (rng + eps)) ** _per_sample(x, gamma) * rng + mn
    if retain_stats:
        mean1 = y.mean(dim=dims, keepdim=True)
        std1 = y.std(dim=dims, keepdim=True, correction=0)
        y = (y - mean1) / (std1 + eps) * std0 + mean0
    if invert:
        y = -y
    return y


class BatchedRandAdjustContrastd(RandTransform):
    """Random per-sample gamma contrast. Draws: ``mask``, ``gamma`` (B,)."""

    def __init__(
        self,
        keys: str | Iterable[str],
        gamma: tuple[float, float] | float = (0.5, 4.5),
        prob: float = 0.1,
        invert_image: bool = False,
        retain_stats: bool = False,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        if isinstance(gamma, (int, float)):
            self.gamma_range = (float(gamma), float(gamma))
        else:
            self.gamma_range = (min(gamma), max(gamma))
        if self.gamma_range[0] <= 0.0:
            raise ValueError("Gamma must be a positive value.")
        self.invert_image = invert_image
        self.retain_stats = retain_stats

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        b, dev = x.shape[0], x.device
        return dict(
            mask=self._apply_mask(generator, b, dev),
            gamma=_uniform(generator, (b,), *self.gamma_range, dev),
        )

    def apply(self, data, draws):
        for k in self.key_iterator(data):
            new = _adjust_contrast(data[k], draws["gamma"], self.invert_image, self.retain_stats)
            data[k] = self._where(draws["mask"], new, data[k])
        return data


class BatchedRandGaussianNoised(RandTransform):
    """Additive Gaussian noise per sample. Draws: ``mask``, ``std`` (B,),
    ``noise`` (one field per key, in key order, in the key's dtype)."""

    def __init__(
        self,
        keys: str | Iterable[str],
        prob: float = 0.1,
        mean: float = 0.0,
        std: float = 0.1,
        sample_std: bool = True,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.mean = mean
        self.std = std
        self.sample_std = sample_std

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        b, dev = x.shape[0], x.device
        mask = self._apply_mask(generator, b, dev)
        if self.sample_std:
            std = _uniform(generator, (b,), 0.0, self.std, dev)
        else:
            std = torch.full((b,), float(self.std), device=dev)
        noise = [
            torch.randn(data[k].shape, generator=generator, device=dev, dtype=data[k].dtype)
            for k in self.key_iterator(data)
        ]
        return dict(mask=mask, std=std, noise=noise)

    def apply(self, data, draws):
        for i, k in enumerate(self.key_iterator(data)):
            x = data[k]
            new = x + self.mean + draws["noise"][i] * _per_sample(x, draws["std"]).to(x.dtype)
            data[k] = self._where(draws["mask"], new, x)
        return data


class BatchedRandScaleIntensityd(RandTransform):
    """``x * (1 + U(-factors, factors))`` per sample. Draws: ``mask``,
    ``factor`` (B,)."""

    def __init__(
        self,
        keys: str | Iterable[str],
        factors: float | tuple[float, float],
        prob: float = 0.1,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        if isinstance(factors, (int, float)):
            self.factors = (-abs(factors), abs(factors))
        else:
            self.factors = (min(factors), max(factors))

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        b, dev = x.shape[0], x.device
        return dict(
            mask=self._apply_mask(generator, b, dev),
            factor=_uniform(generator, (b,), *self.factors, dev),
        )

    def apply(self, data, draws):
        for k in self.key_iterator(data):
            x = data[k]
            new = x * (1.0 + _per_sample(x, draws["factor"]).to(x.dtype))
            data[k] = self._where(draws["mask"], new, x)
        return data


def _gaussian_kernel_1d(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """Per-sample 1-D Gaussian kernels: sigma (B,) -> (B, 2r+1), normalized."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x[None, :] / torch.clamp_min(sigma[:, None], 1e-6)) ** 2)
    return k / k.sum(dim=1, keepdim=True)


def _separable_blur(x: torch.Tensor, sigmas: torch.Tensor, radius) -> torch.Tensor:
    """Per-sample separable Gaussian blur over (Z, Y, X) of (B, C, Z, Y, X):
    per axis, zero-pad by the radius and sum the ``2r+1`` shifted slices
    weighted by the per-sample taps, in tap order, in float32."""
    b = x.shape[0]
    y = x.float()
    for axis in range(3):
        r = radius[axis]
        if r == 0:
            continue
        kern = _gaussian_kernel_1d(sigmas[:, axis], r)
        ax = y.ndim - 3 + axis
        pad = [0, 0] * (y.ndim - 1 - ax) + [r, r]
        yp = F.pad(y, pad)
        length = y.shape[ax]
        acc = None
        for t in range(2 * r + 1):
            w = kern[:, t].reshape((b,) + (1,) * (y.ndim - 1))
            term = w * yp.narrow(ax, t, length)
            acc = term if acc is None else acc + term
        y = acc
    return y.to(x.dtype)


class BatchedRandGaussianSmoothd(RandTransform):
    """Per-sample random Gaussian blur. Draws: ``mask``, ``sigmas`` (B, 3)."""

    # set by the Compose [smooth, center-crop] peephole
    # (``transforms.base._fuse_smooth_crop``)
    _post_crop: tuple[int, int, int] | None = None

    def __init__(
        self,
        keys: str | Iterable[str],
        sigma_z: tuple[float, float] = (0.25, 1.5),
        sigma_y: tuple[float, float] = (0.25, 1.5),
        sigma_x: tuple[float, float] = (0.25, 1.5),
        prob: float = 0.1,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.sigma_ranges = (tuple(sigma_z), tuple(sigma_y), tuple(sigma_x))
        # static kernel radius from the max sigma (truncate at 4 sigma)
        self.radius = tuple(max(1, int(4.0 * s[1] + 0.5)) for s in self.sigma_ranges)

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        b, dev = x.shape[0], x.device
        mask = self._apply_mask(generator, b, dev)
        lo = torch.tensor([s[0] for s in self.sigma_ranges], device=dev)
        hi = torch.tensor([s[1] for s in self.sigma_ranges], device=dev)
        sigmas = torch.rand((b, 3), generator=generator, device=dev) * (hi - lo) + lo
        return dict(mask=mask, sigmas=sigmas)

    def apply(self, data, draws):
        for k in self.key_iterator(data):
            x = data[k]
            if self._post_crop is None:
                data[k] = self._where(draws["mask"], _separable_blur(x, draws["sigmas"], self.radius), x)
            else:
                data[k] = self._smooth_into_crop(x, draws["sigmas"], draws["mask"])
        return data

    def _smooth_into_crop(self, x, sigmas, mask):
        """Fused blur + center crop to ``self._post_crop``: blur the crop
        region expanded by the radius (clipped at the frame, where the blur's
        zero padding reproduces the frame's), then trim the halo."""
        spatial = x.shape[-3:]
        roi = tuple(s if r < 0 else min(r, s) for s, r in zip(spatial, self._post_crop))
        starts = tuple((s - f) // 2 for s, f in zip(spatial, roi))
        lo = tuple(max(0, st - rr) for st, rr in zip(starts, self.radius))
        hi = tuple(min(s, st + f + rr) for st, f, rr, s in zip(starts, roi, self.radius, spatial))
        region = x[(Ellipsis, *(slice(a, b) for a, b in zip(lo, hi)))]
        blurred = _separable_blur(region, sigmas, self.radius)
        off = tuple(st - a for st, a in zip(starts, lo))
        trim = (Ellipsis, *(slice(o, o + f) for o, f in zip(off, roi)))
        return self._where(mask, blurred[trim], region[trim])
