"""Host kernel H1: the batched crop of the cached fit's pushdown path
(counterpart of ``viscy_tpu/native/__init__.py``).

:func:`batched_crop_normalize` crops a batch of patches from a (C, Z, Y, X)
volume into (N, C, pz, py, px), with an optional per-channel
normalization, in ``viscy_tpu_torch/csrc/crop_norm.cpp``: built with the
host compiler by :mod:`viscy_tpu_torch.ops._build` at first use, called
through ctypes (which releases the GIL, so loader threads crop at once). A
failed build or load raises: there is no fallback.

The normalization is JAX's kernel's: ``(x - mean) * (1.0f / std)`` where a
channel's std is above 0, the channel unchanged where it is not. (JAX's
numpy fallback divides, which differs in the last bit, and gives inf or
nan at std 0: ``ROADMAP.md`` Queue 3.)
:func:`batched_crop_normalize_plain` is the same rule in PyTorch, float32,
the plain version the tests and the chip script hold the kernel against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["batched_crop_normalize", "batched_crop_normalize_plain", "launches"]

_KERNEL = "crop_norm"
_I64 = ctypes.c_int64
_I64_P = ctypes.POINTER(ctypes.c_int64)
_F32_P = ctypes.POINTER(ctypes.c_float)
_U16_P = ctypes.POINTER(ctypes.c_uint16)
launches = {"crop_norm": 0}  # calls of the host kernel (either entry)


def _lib() -> ctypes.CDLL:
    from viscy_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    if lib.crop_norm_f32.argtypes is None:
        shape = [_I64] * 4 + [_I64_P, _I64] + [_I64] * 3
        lib.crop_norm_f32.restype = None
        lib.crop_norm_f32.argtypes = [_F32_P, *shape, _F32_P, _F32_P, _F32_P, _I64]
        lib.crop_u16.restype = None
        lib.crop_u16.argtypes = [_U16_P, *shape, _U16_P, _I64]
    return lib


def _checked(volume: np.ndarray, origins, patch_size, means, stds):
    """The volume in the kernel's dtype, the origins as (n, 3) int64, the
    patch size and the statistics as (C) float32; raises on an origin
    whose patch leaves the volume."""
    keep_u16 = volume.dtype == np.uint16 and means is None
    volume = np.ascontiguousarray(volume, np.uint16 if keep_u16 else np.float32)
    origins = np.ascontiguousarray(origins, np.int64).reshape(-1, 3)
    pz, py, px = (int(p) for p in patch_size)
    c, zdim, ydim, xdim = volume.shape
    if ((origins < 0).any() or (origins[:, 0] + pz > zdim).any() or (origins[:, 1] + py > ydim).any()
            or (origins[:, 2] + px > xdim).any()):
        raise ValueError("crop origins out of bounds")
    if means is not None:
        means = np.ascontiguousarray(means, np.float32).reshape(c)
        stds = np.ascontiguousarray(stds, np.float32).reshape(c)
    return volume, origins, (pz, py, px), means, stds


def batched_crop_normalize(
    volume: np.ndarray,
    origins: np.ndarray,
    patch_size: tuple[int, int, int],
    means: np.ndarray | None = None,
    stds: np.ndarray | None = None,
    n_threads: int = 0,
) -> np.ndarray:
    """``len(origins)`` patches of ``patch_size`` at ``origins`` ((z0, y0,
    x0) each) of a (C, Z, Y, X) volume, as an (N, C, pz, py, px) array,
    with ``(x - mean) * (1 / std)`` per channel where ``means`` / ``stds``
    are given and the std is above 0. float32 out; a uint16 volume without
    statistics stays uint16. ``n_threads=0`` runs a thread per hardware
    thread; the result does not depend on it."""
    volume, origins, (pz, py, px), means, stds = _checked(volume, origins, patch_size, means, stds)
    c, zdim, ydim, xdim = volume.shape
    lib = _lib()
    dims = (c, zdim, ydim, xdim, origins.ctypes.data_as(_I64_P), origins.shape[0], pz, py, px)
    out = np.empty((origins.shape[0], c, pz, py, px), volume.dtype)
    if volume.dtype == np.uint16:
        lib.crop_u16(volume.ctypes.data_as(_U16_P), *dims, out.ctypes.data_as(_U16_P), int(n_threads))
    else:
        stat = (lambda a: None if a is None else a.ctypes.data_as(_F32_P))
        lib.crop_norm_f32(volume.ctypes.data_as(_F32_P), *dims, stat(means), stat(stds), out.ctypes.data_as(_F32_P),
                          int(n_threads))
    launches["crop_norm"] += 1
    return out


def batched_crop_normalize_plain(
    volume: np.ndarray,
    origins: np.ndarray,
    patch_size: tuple[int, int, int],
    means: np.ndarray | None = None,
    stds: np.ndarray | None = None,
) -> np.ndarray:
    """:func:`batched_crop_normalize` in PyTorch on the CPU, float32 (the
    plain version)."""
    volume, origins, (pz, py, px), means, stds = _checked(volume, origins, patch_size, means, stds)
    v = torch.from_numpy(volume)
    patches = torch.stack([v[:, z0:z0 + pz, y0:y0 + py, x0:x0 + px] for z0, y0, x0 in origins.tolist()])
    if means is None:
        return patches.numpy()
    mean = torch.from_numpy(means)[:, None, None, None]
    std = torch.from_numpy(stds)[:, None, None, None]
    scaled = (patches - mean) * torch.reciprocal(std)
    return torch.where(std > 0, scaled, patches).numpy()
