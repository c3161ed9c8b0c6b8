"""Batched random 3D affine and elastic deformation (counterpart of
``viscy_tpu/transforms/affine.py``: ``BatchedRandAffined``,
``BatchedRand3DElasticd``).

Per-sample rotate / shear / translate / scale draws shared across keys, MONAI
(Z, Y, X) parameter order, the safe-crop scale clamp, the downstream crops
and in-plane flip that ``Compose`` fuses into it, and one warp for all
keys. The warp goes through
:func:`viscy_tpu_torch.ops.warp3d.affine_warp_3d_keys`: one launch of the
hand-written kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch
import torch.nn.functional as F

from viscy_tpu_torch.ops.warp import batched_trilinear_sample, compose_affine_3d
from viscy_tpu_torch.ops.warp3d import affine_warp_3d_keys
from viscy_tpu_torch.transforms.base import RandTransform
from viscy_tpu_torch.transforms.crop import draw_crop_starts, rand_crop_roi

__all__ = ["BatchedRand3DElasticd", "BatchedRandAffined"]


def _as_range3(value, default=0.0) -> list[tuple[float, float]]:
    """Normalize a MONAI-style per-axis range spec to 3 (lo, hi) pairs (ZYX)."""
    if value is None:
        return [(default, default)] * 3
    if isinstance(value, (int, float)):
        v = float(value)
        return [(-v, v)] * 3
    value = list(value)
    if len(value) == 2 and all(isinstance(v, (int, float)) for v in value):
        return [(float(value[0]), float(value[1]))] * 3
    out = []
    for v in value:
        if isinstance(v, (int, float)):
            out.append((-float(v), float(v)))
        else:
            out.append((float(v[0]), float(v[1])))
    while len(out) < 3:
        out.append((default, default))
    return out[:3]


class BatchedRandAffined(RandTransform):
    """Random batched 3D affine: rotate / shear / translate / scale.

    - ``rotate_range``: radians per (Z, Y, X) axis.
    - ``shear_range``: 3-value shorthand ``[s_zy, s_zx, s_yz]`` (scaled by
      ``Z / Y`` on the Z facets when ``scale_z_shear``), the 6-facet Kornia
      form (scalars or ``(min, max)`` pairs), a shared ``(min, max)``, or
      per-axis ranges.
    - ``translate_range``: fraction of the image size per (Z, Y, X) axis.
    - ``scale_range``: absolute scale factor range, shared or per axis;
      ``isotropic_scale`` draws one factor for all axes.

    - ``safe_crop_size`` / ``safe_crop_coverage``: the draw clamps the
      scale from below so the rotated source covers a downstream center
      crop of that size.

    ``Compose`` fuses a following crop or in-plane flip into the warp:
    ``crop_size`` (a center crop: the grid covers only the crop),
    ``_rand_crop_size`` (a random crop: per-sample starts become per-sample
    grid offsets) and ``_flip_axes`` / ``_flip_prob`` (a flip: sign flips
    of the centered output coordinate). With a fused random crop or flip
    the application mask goes into the maps: an unapplied sample is warped
    by the identity, at exact integer coordinates, so it comes out as its
    own random crop, flipped where its flip draw says.

    Draws (``draw``): ``mask`` (B,) bool, ``rotation`` (B, 3), ``scale``
    (B, 3), ``shear`` (B, 6) or None, ``translate`` (B, 3); with a fused
    random crop ``starts`` (B, 3) int, with a fused flip ``flips``
    (B, len(_flip_axes)) bool.
    """

    is_spatial = True

    def __init__(
        self,
        keys: str | Iterable[str],
        prob: float = 0.1,
        rotate_range=None,
        shear_range=None,
        translate_range=None,
        scale_range=None,
        isotropic_scale: bool = False,
        scale_z_shear: bool = True,
        mode: str = "bilinear",
        padding_mode: str = "zeros",
        safe_crop_size: Sequence[int] | None = None,
        safe_crop_coverage: float = 1.0,
        crop_size: Sequence[int] | None = None,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        if mode != "bilinear":
            raise ValueError(f"only trilinear ('bilinear') sampling exists, got {mode!r}")
        self.safe_crop_size = tuple(safe_crop_size) if safe_crop_size else None
        self.safe_crop_coverage = safe_crop_coverage
        self.crop_size = tuple(crop_size) if crop_size else None
        self._rand_crop_size: tuple | None = None
        self._flip_axes: tuple[int, ...] | None = None
        self._flip_prob = 0.5
        self.rotate_range = _as_range3(rotate_range)
        self.translate_range = _as_range3(translate_range)
        self.scale_range = _as_range3(scale_range, default=1.0) if scale_range is not None else None
        self.isotropic_scale = isotropic_scale
        self.scale_z_shear = scale_z_shear
        self.padding_mode = padding_mode
        self._shear3 = None
        self._shear6 = None
        self.shear_range = None
        if shear_range is not None:
            sr = list(shear_range) if not isinstance(shear_range, (int, float)) else [shear_range]
            if len(sr) == 3 and all(isinstance(v, (int, float)) for v in sr):
                self._shear3 = [float(v) for v in sr]
            elif len(sr) == 6:
                # Kornia order (sxy, sxz, syx, syz, szx, szy) reversed is the
                # ZYX facet order (zy, zx, yz, yx, xz, xy) of compose_affine_3d
                self._shear6 = [
                    (float(v[0]), float(v[1])) if isinstance(v, (list, tuple)) else (-float(v), float(v))
                    for v in reversed(sr)
                ]
            elif len(sr) == 2 and all(isinstance(v, (int, float)) for v in sr):
                self._shear6 = [(float(sr[0]), float(sr[1]))] * 6
            else:
                self.shear_range = _as_range3(shear_range)

    def _sample_params(self, generator, b: int, spatial, device):
        z, y, x = spatial

        def uniform(shape):
            return torch.rand(shape, generator=generator, device=device)

        def rng(ranges):
            lo = torch.tensor([r[0] for r in ranges], device=device)
            hi = torch.tensor([r[1] for r in ranges], device=device)
            return lo, hi

        lo, hi = rng(self.rotate_range)
        rotation = uniform((b, 3)) * (hi - lo) + lo
        if self.scale_range is not None:
            slo, shi = rng(self.scale_range)
            if self.isotropic_scale:
                scale = (uniform((b, 1)) * (shi[0] - slo[0]) + slo[0]).expand(b, 3)
            else:
                scale = uniform((b, 3)) * (shi - slo) + slo
        else:
            scale = torch.ones((b, 3), device=device)
        tlo, thi = rng(self.translate_range)
        translate = (uniform((b, 3)) * (thi - tlo) + tlo) * torch.tensor(
            [z, y, x], dtype=torch.float32, device=device
        )
        shear = None
        if self._shear3 is not None:
            s3 = torch.tensor(self._shear3, device=device)
            if self.scale_z_shear:
                # rescale Z-related facets so displacement follows depth, not YX extent
                zf = z / max(y, 1)
                s3 = s3 * torch.tensor([zf, zf, 1.0], device=device)
            draws = (uniform((b, 3)) * 2.0 - 1.0) * s3[None, :]
            shear = torch.zeros((b, 6), device=device)
            shear[:, :3] = draws
        elif self._shear6 is not None:
            shlo, shhi = rng(self._shear6)
            shear = uniform((b, 6)) * (shhi - shlo) + shlo
        elif self.shear_range is not None:
            shlo, shhi = rng(self.shear_range)
            shear = torch.zeros((b, 6), device=device)
            shear[:, :3] = uniform((b, 3)) * (shhi - shlo) + shlo
        if self.safe_crop_size is not None:
            scale = self.clamp_scale_for_crop(rotation, scale, spatial)
        return rotation, scale, shear, translate

    def clamp_scale_for_crop(self, rotation: torch.Tensor, scale: torch.Tensor, spatial) -> torch.Tensor:
        """Lower-bound ``scale`` so the rotated source covers the safe crop:
        ``max(scale, coverage * |R| (crop / 2) / (spatial / 2))``."""
        b, dev = rotation.shape[0], rotation.device
        d = torch.tensor(self.safe_crop_size, dtype=torch.float32, device=dev) / 2.0
        h = torch.tensor(tuple(spatial), dtype=torch.float32, device=dev) / 2.0
        az, ay, ax = rotation[:, 0], rotation[:, 1], rotation[:, 2]
        cz, sz = torch.cos(az), torch.sin(az)
        cy, sy = torch.cos(ay), torch.sin(ay)
        cx, sx = torch.cos(ax), torch.sin(ax)
        zero, one = torch.zeros_like(cz), torch.ones_like(cz)
        rz = torch.stack([one, zero, zero, zero, cz, -sz, zero, sz, cz], -1).reshape(b, 3, 3)
        ry = torch.stack([cy, zero, -sy, zero, one, zero, sy, zero, cy], -1).reshape(b, 3, 3)
        rx = torch.stack([cx, -sx, zero, sx, cx, zero, zero, zero, one], -1).reshape(b, 3, 3)
        rot = torch.matmul(rz, torch.matmul(ry, rx))
        smin = self.safe_crop_coverage * (rot.abs() * d).sum(-1) / h[None, :]
        return torch.maximum(scale, smin)

    def draw(self, data: dict, generator: torch.Generator) -> dict:
        first = data[self.first_key(data)]
        b, dev = first.shape[0], first.device
        mask = self._apply_mask(generator, b, dev)
        spatial = tuple(first.shape[-3:])
        rotation, scale, shear, translate = self._sample_params(generator, b, spatial, dev)
        draws = dict(mask=mask, rotation=rotation, scale=scale, shear=shear, translate=translate)
        if self._rand_crop_size is not None:
            roi = rand_crop_roi(self._rand_crop_size, spatial)
            draws["starts"] = draw_crop_starts(generator, b, spatial, roi, dev)
        if self._flip_axes is not None:
            n = len(self._flip_axes)
            draws["flips"] = torch.rand((b, n), generator=generator, device=dev) < self._flip_prob
        return draws

    def apply(self, data: dict, draws: dict) -> dict:
        first = data[self.first_key(data)]
        spatial = tuple(first.shape[-3:])
        matrices = compose_affine_3d(
            rotation=draws["rotation"],
            scale=draws["scale"],
            shear=draws.get("shear"),
            translate=draws["translate"],
        )
        mask = draws["mask"]
        signs = None
        if self._flip_axes is not None:
            flips = draws["flips"]
            signs = torch.ones((flips.shape[0], 3), device=matrices.device)
            for j, ax in enumerate(self._flip_axes):
                signs[:, ax] = torch.where(flips[:, j].to(signs.device), -1.0, 1.0)
        fold = signs is not None or self._rand_crop_size is not None
        if fold:
            # the mask goes into the maps: an unapplied sample is warped by
            # the identity at exact integer coordinates (start - (S - R) / 2
            # plus the half-integer centers), i.e. it is its random crop,
            # still flipped
            eye = torch.eye(3, 4, device=matrices.device).expand_as(matrices)
            matrices = torch.where(mask.reshape(-1, 1, 1).to(matrices.device), matrices, eye)
        if self._rand_crop_size is not None:
            out_shape = rand_crop_roi(self._rand_crop_size, spatial)
            # output voxel q of the crop sits at q + start in warp-output
            # space: the centered coordinate shifts by start - (S - R) / 2
            center = torch.tensor([(s - r) / 2.0 for r, s in zip(out_shape, spatial)],
                                  device=matrices.device)
            offset = draws["starts"].to(device=matrices.device, dtype=torch.float32) - center
        elif self.crop_size is None:
            out_shape, offset = spatial, None
        else:
            out_shape = tuple(s if r < 0 else min(r, s) for r, s in zip(self.crop_size, spatial))
            # the integer crop start (s - r) // 2 sits half a voxel off the
            # exact center when s - r is odd; the grid offset absorbs it
            offset = tuple((s - r) // 2 - (s - r) / 2.0 for r, s in zip(out_shape, spatial))
        keys = list(self.key_iterator(data))
        vols = [data[k] for k in keys]
        # every key in one launch on one set of coordinates; without a fold,
        # a sample the mask leaves alone gets the integer center crop,
        # copied by the same launch
        outs = affine_warp_3d_keys(vols, matrices, out_shape, self.padding_mode, offset, signs,
                                   apply_mask=None if fold else mask)
        for k, out in zip(keys, outs):
            data[k] = out
        return data


class BatchedRand3DElasticd(RandTransform):
    """Random elastic deformation: a standard normal displacement field
    (B, 3, Z, Y, X) times a per-sample magnitude, smoothed by a box blur of
    radius ``max(1, int(3 sigma_max) | 1) // 2`` run three times along each
    axis (zero padding), added to the identity grid and sampled
    trilinearly (``mode`` is ignored, as in JAX). Draws: ``mask`` (B,),
    ``magnitude`` (B,), ``noise`` (B, 3, Z, Y, X)."""

    is_spatial = True

    def __init__(
        self,
        keys: str | Iterable[str],
        sigma_range: tuple[float, float],
        magnitude_range: tuple[float, float],
        prob: float = 0.1,
        mode: str = "bilinear",
        padding_mode: str = "reflection",
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.sigma_range = tuple(sigma_range)
        self.magnitude_range = tuple(magnitude_range)
        self.padding_mode = padding_mode
        self._radius = max(1, int(self.sigma_range[1] * 3) | 1) // 2

    def smooth(self, field: torch.Tensor) -> torch.Tensor:
        """Three passes of the zero-padded box mean along Z, Y and X: the
        mean over ``2r + 1`` taps of the zero-padded field is JAX's grouped
        convolution with taps ``1 / (2r + 1)`` (no TF32 on the card, and a
        radius may exceed the extent)."""
        r = self._radius
        k = 2 * r + 1
        b, c = field.shape[:2]
        y = field.reshape(b * c, 1, *field.shape[2:])
        for _ in range(3):
            for axis in range(3):
                kernel, pad = [1, 1, 1], [0, 0, 0, 0, 0, 0]
                kernel[axis] = k
                pad[4 - 2 * axis] = pad[5 - 2 * axis] = r
                y = F.avg_pool3d(F.pad(y, pad), kernel, stride=1)
        return y.reshape(field.shape)

    def draw(self, data: dict, generator: torch.Generator) -> dict:
        first = data[self.first_key(data)]
        b, dev = first.shape[0], first.device
        lo, hi = self.magnitude_range
        return dict(
            mask=self._apply_mask(generator, b, dev),
            magnitude=torch.rand((b,), generator=generator, device=dev) * (hi - lo) + lo,
            noise=torch.randn((b, 3, *first.shape[-3:]), generator=generator, device=dev),
        )

    def apply(self, data: dict, draws: dict) -> dict:
        first = data[self.first_key(data)]
        dev = first.device
        z, y, x = first.shape[-3:]
        noise = draws["noise"].to(dev)
        field = self.smooth(noise * draws["magnitude"].to(dev).reshape(-1, 1, 1, 1, 1))
        base = torch.stack(torch.meshgrid(
            *(torch.arange(n, dtype=torch.float32, device=dev) for n in (z, y, x)), indexing="ij"))
        grids = base[None] + field
        for k in self.key_iterator(data):
            v = data[k]
            new = batched_trilinear_sample(v, grids, self.padding_mode)
            data[k] = self._where(draws["mask"].to(dev), new, v)
        return data
