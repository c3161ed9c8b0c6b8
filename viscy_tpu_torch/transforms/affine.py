"""Batched random 3D affine (counterpart of
``viscy_tpu/transforms/affine.py``, ``BatchedRandAffined``).

Per-sample rotate / shear / translate / scale draws shared across keys, MONAI
(Z, Y, X) parameter order, an optional fused downstream center crop, and
one warp for all keys, the apply mask included. The warp goes through
:func:`viscy_tpu_torch.ops.warp3d.affine_warp_3d_keys`: one launch of the
hand-written kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from viscy_tpu_torch.ops.warp import compose_affine_3d
from viscy_tpu_torch.ops.warp3d import affine_warp_3d_keys
from viscy_tpu_torch.transforms.base import RandTransform

__all__ = ["BatchedRandAffined"]


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

    Draws (``draw``): ``mask`` (B,) bool, ``rotation`` (B, 3), ``scale``
    (B, 3), ``shear`` (B, 6) or None, ``translate`` (B, 3).
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
        crop_size: Sequence[int] | None = None,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        if mode != "bilinear":
            raise ValueError(f"only trilinear ('bilinear') sampling exists, got {mode!r}")
        if safe_crop_size is not None:
            raise NotImplementedError("safe_crop_size scale clamping is not ported")
        self.crop_size = tuple(crop_size) if crop_size else None
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
        return rotation, scale, shear, translate

    def draw(self, data: dict, generator: torch.Generator) -> dict:
        first = data[self.first_key(data)]
        b, dev = first.shape[0], first.device
        mask = self._apply_mask(generator, b, dev)
        rotation, scale, shear, translate = self._sample_params(
            generator, b, tuple(first.shape[-3:]), dev
        )
        return dict(mask=mask, rotation=rotation, scale=scale, shear=shear, translate=translate)

    def apply(self, data: dict, draws: dict) -> dict:
        first = data[self.first_key(data)]
        spatial = tuple(first.shape[-3:])
        matrices = compose_affine_3d(
            rotation=draws["rotation"],
            scale=draws["scale"],
            shear=draws.get("shear"),
            translate=draws["translate"],
        )
        if self.crop_size is None:
            out_shape, offset = spatial, None
        else:
            out_shape = tuple(s if r < 0 else min(r, s) for r, s in zip(self.crop_size, spatial))
            # the integer crop start (s - r) // 2 sits half a voxel off the
            # exact center when s - r is odd; the grid offset absorbs it
            offset = tuple((s - r) // 2 - (s - r) / 2.0 for r, s in zip(out_shape, spatial))
        # every key in one launch on one set of coordinates; a sample the
        # mask leaves alone gets the integer center crop (center_crop's
        # start), copied by the same launch
        keys = list(self.key_iterator(data))
        outs = affine_warp_3d_keys([data[k] for k in keys], matrices, out_shape, self.padding_mode,
                                   offset, apply_mask=draws["mask"])
        for k, out in zip(keys, outs):
            data[k] = out
        return data
