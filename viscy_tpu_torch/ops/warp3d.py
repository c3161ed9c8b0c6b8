"""Batched 3D affine warp with exact trilinear sampling (counterpart of
``viscy_tpu/ops/pallas/warp3d.py``).

:func:`affine_warp_3d` resamples ``(B, C, Zi, Yi, Xi)`` volumes through
per-sample ``(B, 3, 4)`` output->input maps (center-anchored voxel
coordinates, see :mod:`viscy_tpu_torch.ops.warp`), with an optional fused
crop offset and fused flip signs. On a CUDA tensor it launches the
hand-written kernel ``csrc/affine_warp3d.cu`` (one thread per output voxel
over all channels); on a CPU tensor it runs the plain version
:func:`viscy_tpu_torch.ops.warp.affine_warp_3d`, which computes the same
function bit for bit. Unlike the TPU kernel it replaces, it is exact
trilinear and takes any shape, offset and padding mode.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from viscy_tpu_torch.ops import warp as plain

_KERNEL = "affine_warp3d"
_MODES = {"zeros": 0, "border": 1, "reflection": 2}

# kernel launches on CUDA tensors
launches = 0
_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from viscy_tpu_torch.ops import _build

        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.aw3_warp.argtypes = [p, p, p, p, p, *[i] * 9, p]
        lib.aw3_warp.restype = i
        _lib = lib
    return _lib


def affine_warp_3d(
    vol: torch.Tensor,
    matrices: torch.Tensor,
    out_shape: Sequence[int] | None = None,
    padding_mode: str = "zeros",
    out_offset: Sequence[float] | torch.Tensor | None = None,
    flip_signs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Warp ``vol`` to ``(B, C, *out_shape)`` in ``vol``'s dtype (computed in
    float32). ``out_offset`` is a per-axis tuple or a per-sample ``(B, 3)``
    tensor; ``flip_signs`` a ``(B, 3)`` tensor of +-1."""
    if vol.ndim != 5:
        raise ValueError(f"expected (B, C, Z, Y, X), got {tuple(vol.shape)}")
    if padding_mode not in _MODES:
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    b = vol.shape[0]
    if tuple(matrices.shape) != (b, 3, 4):
        raise ValueError(f"matrices must be ({b}, 3, 4), got {tuple(matrices.shape)}")
    in_shape = tuple(vol.shape[-3:])
    out_shape = in_shape if out_shape is None else tuple(int(s) for s in out_shape)
    if vol.device.type == "cpu":
        return plain.affine_warp_3d(vol, matrices, out_shape, padding_mode, out_offset, flip_signs)
    if vol.device.type != "cuda":
        raise RuntimeError(f"affine_warp_3d runs on cuda (kernel) or cpu (plain), not {vol.device}")
    return _warp_cuda(vol, matrices, out_shape, padding_mode, out_offset, flip_signs)


def _warp_cuda(vol, matrices, out_shape, padding_mode, out_offset, flip_signs):
    global launches
    dev = vol.device
    b, c = vol.shape[:2]

    def f32(t):
        if t.device != dev:
            raise ValueError(f"warp inputs must all be on {dev}, got {t.device}")
        return t.to(torch.float32).contiguous()

    v = f32(vol)
    mats = f32(matrices)
    off = f32(plain._per_sample_offsets(out_offset, b, dev))
    signs = None
    if flip_signs is not None:
        if tuple(flip_signs.shape) != (b, 3):
            raise ValueError(f"flip_signs must be ({b}, 3), got {tuple(flip_signs.shape)}")
        signs = f32(flip_signs)
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=dev)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.aw3_warp(
            ptr(v), ptr(mats), ptr(off), ptr(signs), ptr(out), b, c, *v.shape[-3:], *out_shape,
            _MODES[padding_mode], stream,
        )
    if rc:
        raise RuntimeError(f"affine_warp_3d kernel failed to launch (cudaError {rc})")
    launches += 1
    return out.to(vol.dtype)
