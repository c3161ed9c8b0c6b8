"""Batched zoom (counterpart of ``viscy_tpu/transforms/zoom.py``), with
``jax.image.resize``'s rules: the output size is ``int(s * f)`` per axis,
sampling is half-pixel, ``area`` resamples linearly and ``bicubic`` with
the Keys cubic (a = -0.5), and antialiasing widens the kernel by the
downscale factor.

``F.interpolate`` follows other rules (its bicubic has a = -0.75, it has no
3-D bicubic and no 3-D antialias, and its ``nearest`` rounds differently),
so each resized axis gets the resampling matrix that
``jax.image.scale_and_translate`` builds, applied with ``tensordot``.
"""

from __future__ import annotations

import functools
import math
from typing import Iterable

import torch

from viscy_tpu_torch.transforms.base import MapTransform, Transform

__all__ = ["BatchedZoom", "BatchedZoomd"]

_METHOD_MAP = {
    "nearest": "nearest",
    "nearest-exact": "nearest",
    "linear": "linear",
    "bilinear": "linear",
    "trilinear": "linear",
    "triangle": "linear",
    "bicubic": "cubic",
    "cubic": "cubic",
    "tricubic": "cubic",
    "area": "linear",
    "lanczos3": "lanczos3",
    "lanczos5": "lanczos5",
}


def _triangle(x):
    return torch.clamp_min(1 - x.abs(), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float):
    def kernel(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi**2 * x**2, torch.ones_like(x)),
                          torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)

    return kernel


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic, "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int, method: str, antialias: bool, device=None) -> torch.Tensor:
    """The (n_in, n_out) float32 resampling matrix of one axis, as
    ``jax.image.resize`` builds it: output sample ``j`` sits at input
    coordinate ``(j + 0.5) / scale - 0.5``; with ``antialias`` and
    ``scale < 1`` the kernel is stretched by ``1 / scale``; each column is
    normalized, and a column whose sample falls outside the input is 0.
    Built once per argument tuple and shared: do not modify it."""
    scale = torch.tensor(n_out / n_in, dtype=torch.float32)
    inv = 1.0 / scale
    kernel_scale = torch.clamp_min(inv, 1.0) if antialias else torch.tensor(1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


@functools.lru_cache(maxsize=64)
def _nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """``floor((j + 0.5) * n_in / n_out)`` in float32, as JAX's nearest."""
    offsets = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
    return torch.floor(offsets).long().to(device)


class BatchedZoom(Transform):
    """Resize the spatial dims of a (B, C, Z, Y, X) batch by a scale factor."""

    is_spatial = True
    changes_shape = True

    def __init__(
        self,
        scale_factor: float | tuple[float, float, float],
        mode: str = "trilinear",
        align_corners: bool | None = None,
        antialias: bool = False,
    ) -> None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = (float(scale_factor),) * 3
        self.scale_factor = tuple(float(s) for s in scale_factor)
        self.method = _METHOD_MAP.get(mode, mode)
        if self.method not in _KERNELS and self.method != "nearest":
            raise ValueError(f"Unknown resize method {mode!r}")
        self.antialias = antialias

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        spatial = x.shape[-3:]
        out_spatial = tuple(int(s * f) for s, f in zip(spatial, self.scale_factor))
        y = x if self.method == "nearest" else x.float()
        for a, (n_in, n_out) in enumerate(zip(spatial, out_spatial)):
            if n_in == n_out:
                continue
            dim = x.ndim - 3 + a
            if self.method == "nearest":
                y = torch.index_select(y, dim, _nearest_index(n_in, n_out, x.device))
            else:
                w = resize_matrix(n_in, n_out, self.method, self.antialias, x.device)
                y = torch.movedim(torch.tensordot(y, w, dims=([dim], [0])), -1, dim)
        return y.to(x.dtype)


class BatchedZoomd(MapTransform):
    """Dictionary wrapper for :class:`BatchedZoom`."""

    is_spatial = True
    changes_shape = True

    def __init__(
        self,
        keys: str | Iterable[str],
        scale_factor: float | tuple[float, float, float],
        mode: str = "trilinear",
        align_corners: bool | None = None,
        antialias: bool = False,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.zoom = BatchedZoom(scale_factor, mode, align_corners, antialias)

    def __call__(self, data: dict) -> dict:
        data = dict(data)
        for k in self.key_iterator(data):
            data[k] = self.zoom(data[k])
        return data
