"""Batched intensity augmentations (counterpart of
``viscy_tpu/transforms/intensity.py``): per-sample random parameters and
Bernoulli application masks, plain PyTorch on the batch's own device."""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from viscy_tpu_torch.transforms.base import MapTransform, RandTransform

__all__ = [
    "BatchedRandAdjustContrastd",
    "BatchedRandGaussianNoised",
    "BatchedRandScaleIntensityd",
    "BatchedRandGaussianSmoothd",
    "BatchedScaleIntensityRangePercentilesd",
    "BatchedRandHistogramShiftd",
    "BatchedRandInvertIntensityd",
    "RandInvertIntensityd",
    "RandGaussianNoiseTensord",
    "BatchedRandSharpend",
    "BatchedRandLocalPixelShufflingd",
    "BatchedRandZStackShiftd",
    "percentile",
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


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q, axis=-1)`` (linear interpolation): the two
    order statistics around ``q / 100 * (n - 1)``, with the position, the
    floor, the ceiling and the weights in float32 as JAX computes them. The
    order statistics come from one ``sort``, which takes any length
    (``torch.quantile`` refuses inputs over 2**24 elements); a row holding
    a NaN gives NaN."""
    n = x.shape[-1]
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
    lo_f, hi_f = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo_f)
    w_lo = np.float32(np.float32(1.0) - w_hi)
    lo, hi = (int(min(max(v, 0.0), n - 1)) for v in (lo_f, hi_f))
    xs = torch.sort(x.float(), dim=-1).values
    out = xs[..., lo] * float(w_lo) + xs[..., hi] * float(w_hi)
    return torch.where(torch.isnan(x).any(dim=-1), torch.full_like(out, float("nan")), out)


class BatchedScaleIntensityRangePercentilesd(MapTransform):
    """Rescale each sample's (or each sample and channel's) percentile
    window ``[lower, upper]`` to ``[b_min, b_max]``."""

    is_spatial = False

    def __init__(
        self,
        keys: str | Iterable[str],
        lower: float,
        upper: float,
        b_min: float,
        b_max: float,
        clip: bool = False,
        channel_wise: bool = True,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.lower = lower
        self.upper = upper
        self.b_min = b_min
        self.b_max = b_max
        self.clip = clip
        self.channel_wise = channel_wise

    def __call__(self, data: dict) -> dict:
        data = dict(data)
        for k in self.key_iterator(data):
            x = data[k]
            lead = x.shape[:2] if self.channel_wise else x.shape[:1]
            flat = x.reshape(*lead, -1)
            shape = tuple(lead) + (1,) * (x.ndim - len(lead))
            a_min = percentile(flat, self.lower).reshape(shape)
            a_max = percentile(flat, self.upper).reshape(shape)
            y = (x - a_min) / torch.clamp_min(a_max - a_min, 1e-8)
            y = y * (self.b_max - self.b_min) + self.b_min
            if self.clip:
                y = torch.clamp(y, self.b_min, self.b_max)
            data[k] = y.to(x.dtype)
        return data


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` per row: ``x`` (R, N), knots ``xp`` (K,)
    shared, values ``fp`` (R, K). The segment comes from
    ``searchsorted(right=True)``, as in JAX, so a value on a knot takes the
    segment to its right; outside ``xp`` the end values hold."""
    k = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, k - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    dx = x1 - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


class BatchedRandHistogramShiftd(RandTransform):
    """Random monotone piecewise-linear intensity remap per sample: the
    control points ``linspace(0, 1, n)`` jittered by up to
    ``±1 / (2 (n - 1))``, the ends pinned, sorted; each sample is remapped
    over its own [min, max]. A tuple ``num_control_points`` uses its
    maximum. Draws: ``mask`` (B,), ``jitter`` (B, n)."""

    def __init__(
        self,
        keys: str | Iterable[str],
        num_control_points: int | tuple[int, int] = 10,
        prob: float = 0.1,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        if isinstance(num_control_points, int):
            self.num_control_points = num_control_points
        else:
            self.num_control_points = int(max(num_control_points))
        if self.num_control_points < 2:
            raise ValueError("num_control_points must be >= 2")

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        b, dev, n = x.shape[0], x.device, self.num_control_points
        half = 0.5 / (n - 1)
        return dict(mask=self._apply_mask(generator, b, dev), jitter=_uniform(generator, (b, n), -half, half, dev))

    def apply(self, data, draws):
        jitter = draws["jitter"]
        n = self.num_control_points
        # the knots as jnp.linspace(0, 1, n) computes them on the CPU: iota
        # times the float32 reciprocal of n - 1, then the end point
        knots = np.append(np.arange(n - 1, dtype=np.float32) * (np.float32(1.0) / np.float32(n - 1)), np.float32(1.0))
        ref = torch.from_numpy(knots).to(jitter.device)
        pts = ref[None, :] + jitter
        pts[:, 0], pts[:, -1] = 0.0, 1.0
        pts = torch.sort(pts, dim=1).values
        for k in self.key_iterator(data):
            x = data[k]
            dims = tuple(range(1, x.ndim))
            mn, mx = x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)
            unit = (x - mn) / torch.clamp_min(mx - mn, 1e-8)
            remapped = interp(unit.reshape(x.shape[0], -1).float(), ref, pts).reshape(x.shape)
            new = (remapped * (mx - mn) + mn).to(x.dtype)
            data[k] = self._where(draws["mask"], new, x)
        return data


class BatchedRandInvertIntensityd(RandTransform):
    """Random per-sample negation ``x -> -x`` (the JAX code negates; its
    docstring's "about the maximum" is not what it does). Draws: ``mask``
    (B,)."""

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        return dict(mask=self._apply_mask(generator, x.shape[0], x.device))

    def apply(self, data, draws):
        for k in self.key_iterator(data):
            data[k] = self._where(draws["mask"], -data[k], data[k])
        return data


class RandInvertIntensityd(RandTransform):
    """One Bernoulli(prob) draw per call negates every key's tensor
    (batched or not). Draws: ``do`` () bool."""

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        return dict(do=torch.rand((), generator=generator, device=x.device) < self.prob)

    def apply(self, data, draws):
        for k in self.key_iterator(data):
            x = data[k]
            sign = torch.where(draws["do"], -1.0, 1.0).to(device=x.device, dtype=x.dtype)
            data[k] = x * sign
        return data


class RandGaussianNoiseTensord(RandTransform):
    """Additive Gaussian noise, one Bernoulli(prob) draw for the whole call,
    the std drawn from U(0, std) when ``sample_std`` (batched or not).
    Draws: ``do`` () bool, ``std`` (), ``noise`` (one field per key, in key
    order, in the key's dtype)."""

    def __init__(
        self,
        keys: str | Iterable[str],
        prob: float = 0.1,
        mean: float = 0.0,
        std: float = 0.1,
        sample_std: bool = True,
        allow_missing_keys: bool = False,
        dtype=None,  # accepted for reference-config compatibility
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.mean = mean
        self.std = std
        self.sample_std = sample_std

    def draw(self, data, generator):
        dev = data[self.first_key(data)].device
        do = torch.rand((), generator=generator, device=dev) < self.prob
        if self.sample_std:
            std = _uniform(generator, (), 0.0, self.std, dev)
        else:
            std = torch.tensor(float(self.std), device=dev)
        noise = [
            torch.randn(data[k].shape, generator=generator, device=dev, dtype=data[k].dtype)
            for k in self.key_iterator(data)
        ]
        return dict(do=do, std=std, noise=noise)

    def apply(self, data, draws):
        for i, k in enumerate(self.key_iterator(data)):
            x = data[k]
            new = x + self.mean + draws["noise"][i] * draws["std"].to(x.dtype)
            data[k] = torch.where(draws["do"].to(x.device), new, x)
        return data


class BatchedRandSharpend(RandTransform):
    """Random unsharp masking ``x + alpha (x - blur(x))``, the blur in-plane
    (sigma 0 in Z) with radius ``int(4 sigma + 0.5)``. Draws: ``mask``,
    ``alpha`` (B,)."""

    def __init__(
        self,
        keys: str | Iterable[str],
        prob: float = 0.1,
        alpha: tuple[float, float] = (10.0, 30.0),
        sigma: float = 1.0,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.alpha = tuple(alpha)
        self.sigma = sigma
        self.radius = max(1, int(4.0 * sigma + 0.5))

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        b, dev = x.shape[0], x.device
        return dict(mask=self._apply_mask(generator, b, dev), alpha=_uniform(generator, (b,), *self.alpha, dev))

    def apply(self, data, draws):
        alpha = draws["alpha"]
        sigmas = torch.full((alpha.shape[0], 3), float(self.sigma), device=alpha.device)
        sigmas[:, 0] = 0.0
        for k in self.key_iterator(data):
            x = data[k]
            blurred = _separable_blur(x, sigmas, (0, self.radius, self.radius))
            new = x + _per_sample(x, alpha).to(x.dtype) * (x - blurred)
            data[k] = self._where(draws["mask"], new, x)
        return data


class BatchedRandLocalPixelShufflingd(RandTransform):
    """Local pixel shuffling, as the JAX package approximates it: each
    sample's frame is rolled in-plane by a random shift in
    ``[-bs // 2, bs // 2]`` (Python floor division: ``-7 // 2 == -4``), and
    the rolled voxels replace the originals inside a random subset of the
    ``bs x bs`` cells (each cell with probability
    ``min(1, num_blocks / cells)``). Y and X must be multiples of ``bs``
    (or below it), as in JAX. Draws: ``mask`` (B,), ``shifts`` (B, 2) int,
    ``blocks`` (B, 1, 1, Y // bs, X // bs) bool."""

    def __init__(
        self,
        keys: str | Iterable[str],
        prob: float = 0.1,
        num_blocks: int = 100,
        block_size: int = 8,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.num_blocks = num_blocks
        self.block_size = block_size

    def _grid(self, y: int, x: int) -> tuple[int, int]:
        bs = self.block_size
        return max(1, y // bs), max(1, x // bs)

    def draw(self, data, generator):
        first = data[self.first_key(data)]
        b, dev = first.shape[0], first.device
        bs = self.block_size
        gy, gx = self._grid(*first.shape[-2:])
        frac = min(1.0, self.num_blocks / (gy * gx))
        return dict(
            mask=self._apply_mask(generator, b, dev),
            shifts=torch.randint(-bs // 2, bs // 2 + 1, (b, 2), generator=generator, device=dev),
            blocks=torch.rand((b, 1, 1, gy, gx), generator=generator, device=dev) < frac,
        )

    def apply(self, data, draws):
        first = data[self.first_key(data)]
        b, (y, x) = first.shape[0], first.shape[-2:]
        bs = self.block_size
        blocks = draws["blocks"].to(first.device)
        cells = blocks.repeat_interleave(bs, dim=-2).repeat_interleave(bs, dim=-1)[..., :y, :x]
        if cells.shape[-2:] != (y, x):
            raise ValueError(f"the {bs} x {bs} cells do not tile a {y} x {x} frame")
        cells = cells.reshape(b, 1, 1, y, x)
        shifts = draws["shifts"].to(first.device).long()
        # roll by a per-sample shift: output i reads input (i - s) mod n
        iy = torch.remainder(torch.arange(y, device=first.device)[None] - shifts[:, :1], y)
        ix = torch.remainder(torch.arange(x, device=first.device)[None] - shifts[:, 1:], x)
        for k in self.key_iterator(data):
            v = data[k]
            rolled = torch.gather(v, -2, iy.reshape(b, 1, 1, y, 1).expand(*v.shape[:-2], y, v.shape[-1]))
            rolled = torch.gather(rolled, -1, ix.reshape(b, 1, 1, 1, x).expand(v.shape))
            new = torch.where(cells, rolled, v)
            data[k] = self._where(draws["mask"], new, v)
        return data


class BatchedRandZStackShiftd(RandTransform):
    """Random per-sample shift along Z by an integer in
    ``[-max_shift, max_shift]``, the vacated slices set to ``cval``.
    Draws: ``mask``, ``shifts`` (B,) int."""

    is_spatial = True

    def __init__(
        self,
        keys: str | Iterable[str],
        max_shift: int = 3,
        prob: float = 0.1,
        mode: str = "constant",
        cval: float = 0.0,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.max_shift = max_shift
        self.cval = cval

    def draw(self, data, generator):
        x = data[self.first_key(data)]
        b, dev = x.shape[0], x.device
        mask = self._apply_mask(generator, b, dev)
        return dict(mask=mask, shifts=torch.randint(-self.max_shift, self.max_shift + 1, (b,), generator=generator,
                                                    device=dev))

    def apply(self, data, draws):
        for k in self.key_iterator(data):
            x = data[k]
            b, z = x.shape[0], x.shape[2]
            src = torch.arange(z, device=x.device)[None, :] - draws["shifts"].to(x.device).long()[:, None]
            valid = (src >= 0) & (src < z)
            idx = torch.clamp(src, 0, z - 1).reshape(b, 1, z, 1, 1).expand(x.shape)
            gathered = torch.gather(x, 2, idx)
            new = torch.where(valid[:, None, :, None, None], gathered, torch.full_like(gathered, self.cval))
            data[k] = self._where(draws["mask"], new.to(x.dtype), x)
        return data
