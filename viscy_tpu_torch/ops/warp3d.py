"""Batched 3D affine warp with exact trilinear sampling (counterpart of
``viscy_tpu/ops/pallas/warp3d.py``).

:func:`affine_warp_3d_keys` resamples up to four ``(B, C_k, Zi, Yi, Xi)``
keys through one set of per-sample ``(B, 3, 4)`` output->input maps
(center-anchored voxel coordinates, see :mod:`viscy_tpu_torch.ops.warp`),
with an optional fused crop offset, fused flip signs and an apply mask (a
sample left at False gets the exact integer crop of its input);
:func:`affine_warp_3d` is its one-key case. On CUDA tensors one call is one
launch of the hand-written kernel ``csrc/affine_warp3d.cu`` (16 x 16 output
tiles, source boxes staged in shared memory, see its note); on CPU tensors
it runs the plain version :func:`viscy_tpu_torch.ops.warp.affine_warp_3d_keys`,
which computes the same function bit for bit. Unlike the TPU kernel it
replaces, it is exact trilinear and takes any shape, offset and padding
mode. :func:`warp_plan` mirrors the kernel's box and plane arithmetic.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from viscy_tpu_torch.ops import warp as plain

_KERNEL = "affine_warp3d"
_MODES = {"zeros": 0, "border": 1, "reflection": 2}
MAX_KEYS = 4
TILE = 16
EPS = 0.0625
# shared-memory ring of the kernel, in floats (csrc/affine_warp3d.cu RING_FLOATS)
RING_FLOATS = 14080
# dtypes whose values float32 holds exactly: the kernel's copy of an
# unapplied sample is exact for these
_F32_EXACT = {torch.float32, torch.bfloat16, torch.float16, torch.uint8, torch.int8, torch.int16,
              torch.bool}

# kernel launches on CUDA tensors
launches = 0
_lib: ctypes.CDLL | None = None
_counters: dict[torch.device, torch.Tensor] = {}


def direct_counter(device: torch.device | str) -> torch.Tensor:
    """The kernel's int64 counters on ``device``, summed over launches:
    ``[0]`` blocks with a slice on the direct path, ``[1]`` voxels of staged
    slices read directly, ``[2]`` samples warped (each ran one block per
    output tile, :func:`tiles`). Zero it in place to start a count."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _counters:
        _counters[device] = torch.zeros(3, dtype=torch.int64, device=device)
    return _counters[device]


def tiles(out_shape: Sequence[int]) -> int:
    """Output tiles (one kernel block each) of one sample."""
    return -(-out_shape[1] // TILE) * -(-out_shape[2] // TILE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from viscy_tpu_torch.ops import _build

        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.aw3_warp.argtypes = [p, p, p, *[i] * 8, p, p, p, p, i, i, p, p]
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
    return affine_warp_3d_keys([vol], matrices, out_shape, padding_mode, out_offset, flip_signs)[0]


def affine_warp_3d_keys(
    vols: Sequence[torch.Tensor],
    matrices: torch.Tensor,
    out_shape: Sequence[int] | None = None,
    padding_mode: str = "zeros",
    out_offset: Sequence[float] | torch.Tensor | None = None,
    flip_signs: torch.Tensor | None = None,
    apply_mask: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """Warp every ``(B, C_k, Z, Y, X)`` key of ``vols`` (one spatial shape)
    through the same maps, each to ``(B, C_k, *out_shape)`` in its dtype.
    Where ``apply_mask`` (``(B,)`` bool) is False the sample's output is
    the integer center crop of its input (start ``(n_in - n_out) // 2``).
    One kernel launch per four keys."""
    vols = list(vols)
    if not vols:
        raise ValueError("need at least one volume")
    for v in vols:
        if v.ndim != 5:
            raise ValueError(f"expected (B, C, Z, Y, X), got {tuple(v.shape)}")
    b, in_shape, dev = vols[0].shape[0], tuple(vols[0].shape[-3:]), vols[0].device
    for v in vols[1:]:
        if v.shape[0] != b or tuple(v.shape[-3:]) != in_shape or v.device != dev:
            raise ValueError("every key needs the same batch, spatial shape and device")
    if padding_mode not in _MODES:
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    if tuple(matrices.shape) != (b, 3, 4):
        raise ValueError(f"matrices must be ({b}, 3, 4), got {tuple(matrices.shape)}")
    if flip_signs is not None and tuple(flip_signs.shape) != (b, 3):
        raise ValueError(f"flip_signs must be ({b}, 3), got {tuple(flip_signs.shape)}")
    out_shape = in_shape if out_shape is None else tuple(int(s) for s in out_shape)
    if apply_mask is not None:
        if tuple(apply_mask.shape) != (b,):
            raise ValueError(f"apply_mask must be ({b},), got {tuple(apply_mask.shape)}")
        if any(o > i for o, i in zip(out_shape, in_shape)):
            raise ValueError(f"a center crop to {out_shape} does not fit in {in_shape}")
    if dev.type == "cpu":
        return plain.affine_warp_3d_keys(vols, matrices, out_shape, padding_mode, out_offset, flip_signs,
                                         apply_mask)
    if dev.type != "cuda":
        raise RuntimeError(f"affine_warp_3d runs on cuda (kernel) or cpu (plain), not {dev}")
    outs = []
    for i in range(0, len(vols), MAX_KEYS):
        outs += _warp_cuda(vols[i : i + MAX_KEYS], matrices, out_shape, padding_mode, out_offset,
                           flip_signs, apply_mask)
    return outs


def _warp_cuda(vols, matrices, out_shape, padding_mode, out_offset, flip_signs, apply_mask):
    global launches
    dev = vols[0].device
    b = vols[0].shape[0]

    def on_dev(t):
        if t.device != dev:
            raise ValueError(f"warp inputs must all be on {dev}, got {t.device}")
        return t

    srcs = [on_dev(v).to(torch.float32).contiguous() for v in vols]
    mats = on_dev(matrices).to(torch.float32).contiguous()
    off = on_dev(plain._per_sample_offsets(out_offset, b, dev)).contiguous()
    signs = None if flip_signs is None else on_dev(flip_signs).to(torch.float32).contiguous()
    mask = None if apply_mask is None else on_dev(apply_mask).to(torch.uint8).contiguous()
    outs = [torch.empty((b, v.shape[1], *out_shape), dtype=torch.float32, device=dev) for v in srcs]
    xi = vols[0].shape[-1]
    vec = int(xi % 4 == 0 and all(s.data_ptr() % 16 == 0 for s in srcs))
    counters = direct_counter(dev)
    n = len(srcs)
    pad = MAX_KEYS - n
    src_ptrs = (ctypes.c_void_p * MAX_KEYS)(*[s.data_ptr() for s in srcs], *[None] * pad)
    dst_ptrs = (ctypes.c_void_p * MAX_KEYS)(*[o.data_ptr() for o in outs], *[None] * pad)
    chans = (ctypes.c_int * MAX_KEYS)(*[s.shape[1] for s in srcs], *[0] * pad)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = _library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.aw3_warp(
            src_ptrs, dst_ptrs, chans, n, b, *vols[0].shape[-3:], *out_shape, ptr(mats), ptr(off),
            ptr(signs), ptr(mask), _MODES[padding_mode], vec, ptr(counters), stream,
        )
    if rc:
        raise RuntimeError(f"affine_warp_3d kernel failed to launch (cudaError {rc})")
    launches += 1
    result = []
    for v, o in zip(vols, outs):
        o = o.to(v.dtype)
        if mask is not None and v.dtype not in _F32_EXACT:
            # the kernel copies through float32: restore the exact values
            keep = ~apply_mask.to(torch.bool)
            start = plain.crop_start(vols[0].shape[-3:], out_shape)
            crop = tuple(slice(s, s + r) for s, r in zip(start, out_shape))
            o[keep] = v[(Ellipsis, *crop)][keep]
        result.append(o)
    return result


@dataclass
class WarpPlan:
    """What the kernel stages for each (sample, tile): ``box`` the input
    rows and columns ``(ylo, yhi, xlo, xhi)`` (inclusive), ``ring`` the
    planes its ring holds, ``cpass`` the channels each plane holds (every
    channel, or one per pass when every channel does not fit), and per
    output slice the planes
    ``za``/``zb`` (inclusive) it reads and whether it is ``staged`` (else
    direct).
    Tensors are ``(B, tiles_y, tiles_x)`` and ``(B, tiles_y, tiles_x, Zo)``."""

    box: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    ring: torch.Tensor
    cpass: torch.Tensor  # channels staged per pass
    za: torch.Tensor
    zb: torch.Tensor
    staged: torch.Tensor

    @property
    def direct_blocks(self) -> torch.Tensor:
        """``(B, tiles_y, tiles_x)``: blocks with a slice on the direct path."""
        return ~self.staged.all(dim=-1)


def _first_read(c: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(torch.floor(c - EPS), 0, max(n - 2, 0)).long()


def _last_read(c: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(torch.floor(c + EPS), 0, max(n - 2, 0)).long() + int(n > 1)


def warp_plan(
    matrices: torch.Tensor,
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    padding_mode: str = "zeros",
    out_offset: Sequence[float] | torch.Tensor | None = None,
    flip_signs: torch.Tensor | None = None,
    channels: int = 1,
    vec: bool = True,
) -> WarpPlan:
    """The kernel's staging plan, computed as the kernel computes it: the
    tile corners' coordinates (:func:`~viscy_tpu_torch.ops.warp.grid_points`,
    the same float32 roundings), floored with the ``EPS`` margin and
    clamped; ``vec`` widens the columns to 16-byte chunks (needs
    ``Xi % 4 == 0``)."""
    zi, yi, xi = in_shape
    zo, yo, xo = out_shape
    dev = matrices.device

    def ends(n):  # first and last index of each tile along an axis
        first = torch.arange(0, n, TILE, device=dev)
        return first, torch.clamp_max(first + TILE - 1, n - 1)

    y0, y1 = ends(yo)
    x0, x1 = ends(xo)
    ny, nx = len(y0), len(x0)
    iy = torch.stack([y0, y1], -1).flatten()
    ix = torch.stack([x0, x1], -1).flatten()
    iz = torch.arange(zo, device=dev)
    pz, py, px = plain.grid_points(matrices, in_shape, out_shape, (iz, iy, ix), out_offset, flip_signs)
    b = pz.shape[0]
    # (B, Zo, ny, 2, nx, 2) -> per tile
    pz, py, px = (p.reshape(b, zo, ny, 2, nx, 2) for p in (pz, py, px))
    z_lo, z_hi = pz.amin(dim=(3, 5)), pz.amax(dim=(3, 5))  # (B, Zo, ny, nx)
    ends_z = py[:, [0, zo - 1]], px[:, [0, zo - 1]]
    y_lo, y_hi = (f(ends_z[0], dim=(1, 3, 5)) for f in (torch.amin, torch.amax))
    x_lo, x_hi = (f(ends_z[1], dim=(1, 3, 5)) for f in (torch.amin, torch.amax))
    ylo, yhi = _first_read(y_lo, yi), _last_read(y_hi, yi)
    xlo, xhi = _first_read(x_lo, xi), _last_read(x_hi, xi)
    if vec:
        xlo = xlo & ~3
        xhi = torch.clamp_max(xhi | 3, xi - 1)
    area = (yhi - ylo + 1) * (xhi - xlo + 1)
    za = _first_read(z_lo, zi).permute(0, 2, 3, 1)
    zb = _last_read(z_hi, zi).permute(0, 2, 3, 1)
    need = (zb - za + 1).amax(dim=-1)
    # a box too large for one slice's planes of every channel is staged
    # one channel per pass, when one channel fits
    one_pass = channels * area * need <= RING_FLOATS
    cpass = torch.where(~one_pass & (area * need <= RING_FLOATS), 1, channels)
    ring = torch.zeros_like(area) if padding_mode == "reflection" else RING_FLOATS // (cpass * area)
    staged = zb - za + 1 <= ring[..., None]
    return WarpPlan((ylo, yhi, xlo, xhi), ring, cpass, za, zb, staged)

