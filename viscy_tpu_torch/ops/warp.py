"""Batched 3D affine warps, plain PyTorch (counterpart of
``viscy_tpu/ops/warp.py``).

Coordinate convention: voxel-index space, ``(z, y, x)`` order. A matrix
``A (3, 4)`` maps *output* voxel coordinates to *input* sampling
coordinates: ``p_in = A[:, :3] @ p_out + A[:, 3]`` with both measured from
the volume center (rotations and scales are center-anchored).

These functions are the plain version the warp kernel
(:mod:`viscy_tpu_torch.ops.warp3d`, ``csrc/affine_warp3d.cu``) is checked
against, and what the warp runs on CPU tensors. The grid is written as
explicit products and sums, in the order the kernel evaluates them, so it
does not depend on the matmul precision settings (TF32) of the card.
"""

from __future__ import annotations

from typing import Literal, Sequence

import torch

Padding = Literal["zeros", "border", "reflection"]


def _reflect(c: torch.Tensor, n: int) -> torch.Tensor:
    """Mirror coordinates into [0, n-1] (reflect across edges)."""
    if n == 1:
        return torch.zeros_like(c)
    period = 2 * (n - 1)
    c = torch.remainder(c, period)
    return torch.where(c > n - 1, period - c, c)


def batched_trilinear_sample(
    vol: torch.Tensor, coords: torch.Tensor, padding_mode: Padding = "zeros"
) -> torch.Tensor:
    """Trilinearly sample ``(B, C, Z, Y, X)`` volumes at per-sample voxel
    coordinates ``(B, 3, *out_shape)``; returns ``(B, C, *out_shape)`` in
    ``vol``'s dtype, computed in float32.

    JAX semantics: the base corner is clamped to ``[0, n-2]`` and the
    fraction clipped to ``[0, 1]`` (so ``c == n-1`` selects index ``n-1``
    exactly); neighbour steps are 0 on singleton axes; in ``"zeros"`` mode
    a point with any coordinate outside ``[0, n-1]`` is zeroed as a whole.
    """
    b, c = vol.shape[:2]
    zi, yi, xi = vol.shape[-3:]
    out_shape = coords.shape[2:]
    cz, cy, cx = (coords[:, i].float() for i in range(3))
    if padding_mode == "reflection":
        cz, cy, cx = _reflect(cz, zi), _reflect(cy, yi), _reflect(cx, xi)
    elif padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")

    def base_and_frac(cc, n):
        b0 = torch.clamp(torch.floor(cc), 0, max(n - 2, 0))
        return b0.long(), torch.clamp(cc - b0, 0.0, 1.0)

    z0, fz = base_and_frac(cz, zi)
    y0, fy = base_and_frac(cy, yi)
    x0, fx = base_and_frac(cx, xi)
    x_step = 1 if xi > 1 else 0
    y_step = xi if yi > 1 else 0
    z_step = yi * xi if zi > 1 else 0

    v = vol.float().reshape(b, c, -1)
    base = ((z0 * yi + y0) * xi + x0).reshape(b, 1, -1)
    fx, fy, fz = (f.reshape(b, 1, -1) for f in (fx, fy, fz))

    def take(off):
        return torch.gather(v, 2, (base + off).expand(b, c, -1))

    def plane(o):
        w0 = take(o) * (1 - fx) + take(o + x_step) * fx
        w1 = take(o + y_step) * (1 - fx) + take(o + y_step + x_step) * fx
        return w0 * (1 - fy) + w1 * fy

    out = (plane(0) * (1 - fz) + plane(z_step) * fz).reshape(b, c, *out_shape)
    if padding_mode == "zeros":
        inside = (
            (cz >= 0) & (cz <= zi - 1) & (cy >= 0) & (cy <= yi - 1) & (cx >= 0) & (cx <= xi - 1)
        )
        out = torch.where(inside[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out.to(vol.dtype)


def _per_sample_offsets(out_offset, b: int, device) -> torch.Tensor:
    """``out_offset`` (None, a per-axis tuple or a ``(B, 3)`` tensor) as a
    ``(B, 3)`` float32 tensor."""
    if out_offset is None:
        return torch.zeros((b, 3), dtype=torch.float32, device=device)
    if isinstance(out_offset, torch.Tensor):
        return out_offset.to(device=device, dtype=torch.float32).expand(b, 3)
    return torch.tensor([float(o) for o in out_offset], device=device).expand(b, 3)


def grid_points(
    matrices: torch.Tensor,
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    index: Sequence[torch.Tensor],
    out_offset: Sequence[float] | torch.Tensor | None = None,
    flip_signs: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Input voxel coordinates ``(z, y, x)``, each ``(B, len(iz), len(iy),
    len(ix))``, of the output voxels at the index vectors ``index = (iz, iy,
    ix)``: the arithmetic of :func:`affine_grid_3d` (and of the kernel) at
    chosen points, so a corner's coordinate here equals that voxel's in the
    full grid bit for bit."""
    m = matrices.float()
    b, dev = m.shape[0], m.device
    off = _per_sample_offsets(out_offset, b, dev)
    signs = torch.ones((b, 3), device=dev) if flip_signs is None else flip_signs.float()

    def axis(a, shape):
        n = out_shape[a]
        centered = index[a].to(device=dev, dtype=torch.float32) - (n - 1) / 2.0
        q = signs[:, a, None] * centered[None] + off[:, a, None]
        return q.reshape(b, *shape)

    qz = axis(0, (-1, 1, 1))
    qy = axis(1, (1, -1, 1))
    qx = axis(2, (1, 1, -1))
    shape = (b, len(index[0]), len(index[1]), len(index[2]))
    rows = []
    for a in range(3):
        mm = m[:, a].reshape(b, 4, 1, 1, 1)
        p = mm[:, 0] * qz + mm[:, 1] * qy + mm[:, 2] * qx + mm[:, 3] + (in_shape[a] - 1) / 2.0
        rows.append(p.expand(shape))
    return tuple(rows)


def affine_grid_3d(
    matrices: torch.Tensor,
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    out_offset: Sequence[float] | torch.Tensor | None = None,
    flip_signs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-sample sampling grids ``(B, 3, Zo, Yo, Xo)`` of input voxel
    coordinates from center-anchored ``(B, 3, 4)`` output->input matrices.

    The centered output coordinate of axis ``a`` is ``s_a * (i - (n_a-1)/2)
    + off_a``: ``out_offset`` (a per-axis tuple, or a per-sample ``(B, 3)``
    tensor) shifts it, as a fused crop does; ``flip_signs`` (``(B, 3)`` of
    +-1) mirrors it first, as a fused flip does."""
    index = [torch.arange(n, dtype=torch.float32, device=matrices.device) for n in out_shape]
    return torch.stack(grid_points(matrices, in_shape, out_shape, index, out_offset, flip_signs), dim=1)


def affine_warp_3d(
    vol: torch.Tensor,
    matrices: torch.Tensor,
    out_shape: Sequence[int] | None = None,
    padding_mode: Padding = "zeros",
    out_offset: Sequence[float] | torch.Tensor | None = None,
    flip_signs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Warp a ``(B, C, Z, Y, X)`` batch with per-sample ``(B, 3, 4)``
    matrices to ``(B, C, *out_shape)`` (default: the input's spatial
    shape): :func:`batched_trilinear_sample` of :func:`affine_grid_3d`."""
    in_shape = tuple(vol.shape[-3:])
    out_shape = in_shape if out_shape is None else tuple(out_shape)
    grids = affine_grid_3d(matrices, in_shape, out_shape, out_offset, flip_signs)
    return batched_trilinear_sample(vol, grids, padding_mode)


def crop_start(in_shape: Sequence[int], out_shape: Sequence[int]) -> tuple[int, int, int]:
    """The integer center-crop start ``(n_in - n_out) // 2`` per axis, as
    ``transforms.crop.center_crop`` takes it."""
    return tuple((i - o) // 2 for i, o in zip(in_shape, out_shape))


def affine_warp_3d_keys(
    vols: Sequence[torch.Tensor],
    matrices: torch.Tensor,
    out_shape: Sequence[int] | None = None,
    padding_mode: Padding = "zeros",
    out_offset: Sequence[float] | torch.Tensor | None = None,
    flip_signs: torch.Tensor | None = None,
    apply_mask: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """:func:`affine_warp_3d` of several ``(B, C_k, Z, Y, X)`` keys on one
    set of coordinates. Where ``apply_mask`` (``(B,)`` bool) is False, a
    sample's output is instead the exact integer crop ``x[..., s:s+r]`` of
    its input, ``s =`` :func:`crop_start`."""
    in_shape = tuple(vols[0].shape[-3:])
    out_shape = in_shape if out_shape is None else tuple(out_shape)
    grids = affine_grid_3d(matrices, in_shape, out_shape, out_offset, flip_signs)
    outs = [batched_trilinear_sample(v, grids, padding_mode) for v in vols]
    del grids
    if apply_mask is not None:
        crop = tuple(slice(a, a + n) for a, n in zip(crop_start(in_shape, out_shape), out_shape))
        keep = ~apply_mask.to(device=vols[0].device, dtype=torch.bool)
        for v, o in zip(vols, outs):
            o[keep] = v[(Ellipsis, *crop)][keep].to(o.dtype)
    return outs


def compose_affine_3d(
    rotation: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    shear: torch.Tensor | None = None,
    translate: torch.Tensor | None = None,
    batch: int | None = None,
) -> torch.Tensor:
    """Compose ``(B, 3, 4)`` output->input matrices from per-sample draws.

    - rotation : (B, 3) Euler angles (radians) about the z, y, x axes.
    - scale : (B, 3) scale factors per axis (values > 1 zoom in).
    - shear : (B, 6) shear coefficients (zy, zx, yz, yx, xz, xy).
    - translate : (B, 3) translations in voxels (applied in output space).

    The *inverse* of the forward map is returned (output voxel -> input
    voxel), which is what :func:`affine_warp_3d` consumes."""
    given = [a for a in (rotation, scale, shear, translate) if a is not None]
    if batch is None:
        if not given:
            raise ValueError("need at least one parameter or explicit batch")
        batch = given[0].shape[0]
    dev = given[0].device if given else torch.device("cpu")
    eye = torch.eye(3, device=dev).expand(batch, 3, 3)
    fwd = eye
    if shear is not None:
        sh = torch.zeros((batch, 3, 3), device=dev)
        for k, (i, j) in enumerate(((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))):
            sh[:, i, j] = shear[:, k]
        fwd = torch.matmul(eye + sh, fwd)
    if rotation is not None:
        az, ay, ax = rotation[:, 0], rotation[:, 1], rotation[:, 2]
        cz, sz = torch.cos(az), torch.sin(az)
        cy, sy = torch.cos(ay), torch.sin(ay)
        cx, sx = torch.cos(ax), torch.sin(ax)
        zero, one = torch.zeros_like(cz), torch.ones_like(cz)
        # about z mixes (y, x); about y mixes (z, x); about x mixes (z, y)
        rz = torch.stack([one, zero, zero, zero, cz, -sz, zero, sz, cz], -1).reshape(batch, 3, 3)
        ry = torch.stack([cy, zero, -sy, zero, one, zero, sy, zero, cy], -1).reshape(batch, 3, 3)
        rx = torch.stack([cx, -sx, zero, sx, cx, zero, zero, zero, one], -1).reshape(batch, 3, 3)
        fwd = torch.matmul(rz, torch.matmul(ry, torch.matmul(rx, fwd)))
    if scale is not None:
        fwd = fwd * scale[:, :, None]
    # inv_ex: the same inverse without inv's singularity check, which reads
    # a status back from the card (a host sync per call); jnp.linalg.inv
    # does not raise either
    inv = torch.linalg.inv_ex(fwd.float()).inverse
    if translate is not None:
        t = -torch.matmul(inv, translate.float()[:, :, None])[:, :, 0]
    else:
        t = torch.zeros((batch, 3), device=dev)
    return torch.cat([inv, t[:, :, None]], dim=2)
