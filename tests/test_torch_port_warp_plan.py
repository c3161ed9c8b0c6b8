"""The warp kernel's staging plan (``ops/warp3d.py::warp_plan``, the Python
mirror of ``csrc/affine_warp3d.cu``'s box and plane arithmetic) and the
multi-key plain entry, on the CPU.

- The plan covers every corner the plain version reads: for each output
  voxel that is not zeroed, its base corner and neighbour lie in its
  tile's staged box and its slice's planes (production-range draws,
  flips, tuple and per-sample offsets, tiles ragged at both edges, 16-byte
  and 4-byte column rounding).
- Every production-range draw at the flagship shape is staged with the
  ring sized for four blocks per SM; reflection mode and an extreme scale
  go to the direct path.
- ``affine_warp_3d_keys`` with an apply mask equals the composition it
  replaces (``torch.cat`` of the keys -> one warp -> ``torch.where``
  against the center crop) bit for bit, and so does
  ``BatchedRandAffined.apply``.
"""

import re

import numpy as np
import pytest
import torch

from viscy_tpu_torch.ops import _build
from viscy_tpu_torch.ops import warp as tw
from viscy_tpu_torch.ops import warp3d
from viscy_tpu_torch.transforms import BatchedRandAffined
from viscy_tpu_torch.transforms.crop import center_crop

STACK = (20, 600, 600)
PATCH = (15, 384, 384)
# H100: 228 KiB of shared memory per SM, 1 KiB of it reserved per block
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024


def _production(prob=0.8, crop=None):
    return BatchedRandAffined(keys=["source", "target"], prob=prob, rotate_range=[3.14, 0, 0],
                              shear_range=[0.0, 0.05, 0.05],
                              scale_range=[[0.7, 1.3], [0.5, 1.5], [0.5, 1.5]], crop_size=crop)


def _production_maps(b, spatial, seed):
    rot, scale, shear, trans = _production()._sample_params(torch.Generator().manual_seed(seed), b,
                                                           spatial, "cpu")
    return tw.compose_affine_3d(rotation=rot, scale=scale, shear=shear, translate=trans)


def _crop_offset(in_shape, out_shape):
    return tuple((s - r) // 2 - (s - r) / 2.0 for r, s in zip(out_shape, in_shape))


def _uncovered_reads(plan, grids, in_shape, mode):
    """Voxels of staged slices, not zeroed, whose corners leave the plan."""
    b, _, zo, yo, xo = grids.shape
    inside = torch.ones((b, zo, yo, xo), dtype=torch.bool)
    base = []
    for a, n in enumerate(in_shape):
        c = grids[:, a]
        inside &= (c >= 0) & (c <= n - 1)
        base.append(torch.clamp(torch.floor(c), 0, max(n - 2, 0)).long())
    zero = ~inside if mode == "zeros" else torch.zeros_like(inside)
    ty = torch.arange(yo) // warp3d.TILE
    tx = torch.arange(xo) // warp3d.TILE

    def per_voxel(t):  # (B, ty, tx) -> (B, 1, Yo, Xo)
        return t[:, ty][:, :, tx][:, None]

    def per_slice(t):  # (B, ty, tx, Zo) -> (B, Zo, Yo, Xo)
        return t[:, ty][:, :, tx].permute(0, 3, 1, 2)

    ylo, yhi, xlo, xhi = (per_voxel(t) for t in plan.box)
    za, zb, staged = per_slice(plan.za), per_slice(plan.zb), per_slice(plan.staged)
    dz, dy, dx = (int(n > 1) for n in in_shape)
    z0, y0, x0 = base
    covered = ((z0 >= za) & (z0 + dz <= zb) & (y0 >= ylo) & (y0 + dy <= yhi) & (x0 >= xlo)
               & (x0 + dx <= xhi))
    return int((staged & ~zero & ~covered).sum()), int(staged.sum())


@pytest.mark.parametrize("vec", [True, False], ids=["16B", "4B"])
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("offset", ["crop", "per-sample"])
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_plan_covers_every_corner_the_plain_version_reads(mode, offset, flip, vec):
    """(10, 90, 84) -> (7, 45, 38): tiles ragged in y (45 = 2 x 16 + 13)
    and x (38 = 2 x 16 + 6); production-range maps."""
    in_shape, out_shape, b = (10, 90, 84), (7, 45, 38), 6
    g = torch.Generator().manual_seed(11)
    mats = _production_maps(b, in_shape, seed=12)
    off = (_crop_offset(in_shape, out_shape) if offset == "crop"
           else (torch.rand((b, 3), generator=g) - 0.5) * 6)
    signs = torch.where(torch.rand((b, 3), generator=g) < 0.5, -1.0, 1.0) if flip else None
    plan = warp3d.warp_plan(mats, in_shape, out_shape, mode, off, signs, channels=3, vec=vec)
    grids = tw.affine_grid_3d(mats, in_shape, out_shape, off, signs)
    uncovered, staged = _uncovered_reads(plan, grids, in_shape, mode)
    assert staged == b * int(np.prod(out_shape)) and uncovered == 0
    ylo, yhi, xlo, xhi = plan.box
    assert (ylo >= 0).all() and (yhi <= in_shape[1] - 1).all() and (xhi <= in_shape[2] - 1).all()
    if vec:
        assert (xlo % 4 == 0).all() and ((xhi + 1) % 4 == 0).all()


def test_plan_box_is_the_tight_hull_of_the_reads():
    """Without its margin the box would miss reads; with it, it is at most
    one voxel wider than the reads on each side (no 16-byte rounding)."""
    in_shape, out_shape, b = (10, 90, 84), (7, 45, 38), 6
    mats = _production_maps(b, in_shape, seed=13)
    off = _crop_offset(in_shape, out_shape)
    plan = warp3d.warp_plan(mats, in_shape, out_shape, "border", off, channels=1, vec=False)
    grids = tw.affine_grid_3d(mats, in_shape, out_shape, off)
    y0 = torch.clamp(torch.floor(grids[:, 1]), 0, in_shape[1] - 2).long()
    ty = torch.arange(out_shape[1]) // warp3d.TILE
    for t in range(int(ty.max()) + 1):
        rows = y0[:, :, ty == t, :16]
        lo, hi = rows.amin(dim=(1, 2, 3)), rows.amax(dim=(1, 2, 3)) + 1
        assert (plan.box[0][:, t, 0] >= lo - 1).all() and (plan.box[1][:, t, 0] <= hi + 1).all()


def test_production_draws_are_staged_with_four_blocks_per_sm():
    """The ring leaves room for four blocks per SM, and every seeded
    production-range draw, and the range's worst corner (scale 0.5 in y
    and x, rotation 45 degrees, the largest shears), stage every slice:
    the largest boxes one channel per pass."""
    src = (_build.CSRC / "affine_warp3d.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("RING_FLOATS") == warp3d.RING_FLOATS and const("TILE") == warp3d.TILE
    assert const("BLOCKS_PER_SM") == 4
    # the ring and the slice table (two ints per output slice) of four blocks
    assert 4 * (4 * warp3d.RING_FLOATS + 8 * PATCH[0] + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    worst = tw.compose_affine_3d(rotation=torch.tensor([[np.pi / 4, 0.0, 0.0]]),
                                 scale=torch.tensor([[0.7, 0.5, 0.5]]),
                                 shear=torch.tensor([[0.0, 0.05 * STACK[0] / STACK[1], 0.05, 0.0, 0.0, 0.0]]))
    plan = warp3d.warp_plan(worst, STACK, PATCH, "zeros", _crop_offset(STACK, PATCH), channels=3)
    assert (plan.cpass == 1).any() and plan.staged.all()
    mats = _production_maps(256, STACK, seed=14)
    for flip in (None, torch.where(torch.rand((256, 3), generator=torch.Generator().manual_seed(15)) < 0.5,
                                   -1.0, 1.0)):
        plan = warp3d.warp_plan(mats, STACK, PATCH, "zeros", _crop_offset(STACK, PATCH), flip, channels=3)
        assert plan.staged.all() and not plan.direct_blocks.any()
        assert (plan.zb - plan.za + 1).max() <= 3 and plan.ring.min() >= 3


def test_reflection_and_an_extreme_scale_go_direct():
    mats = _production_maps(8, STACK, seed=16)
    off = _crop_offset(STACK, PATCH)
    plan = warp3d.warp_plan(mats, STACK, PATCH, "reflection", off, channels=3)
    assert (plan.ring == 0).all() and plan.direct_blocks.all()
    # zoomed out 5x in y and x: an interior tile's box is about 80 x 80,
    # staged one channel per pass; 10x: about 160 x 160, too large for one
    wide = tw.compose_affine_3d(scale=torch.tensor([[0.7, 0.2, 0.2], [0.7, 0.1, 0.1]]))
    plan = warp3d.warp_plan(wide, STACK, (15, 48, 48), "zeros", channels=3)
    assert plan.staged[0].all() and (plan.cpass[0, 1, 1] == 1) and (plan.cpass[0] <= 3).all()
    assert plan.direct_blocks[1, 1, 1] and not plan.staged[1, 1, 1].any()


def _old_member(keys, mats, out_shape, mode, offset, mask, crop):
    """The member's former composition: cat -> one warp -> where(center crop)."""
    splits = [k.shape[1] for k in keys]
    warped = tw.affine_warp_3d(torch.cat(keys, dim=1), mats, out_shape, mode, offset)
    outs, start = [], 0
    for x, c in zip(keys, splits):
        new = warped[:, start : start + c]
        start += c
        if crop:
            x = center_crop(x, out_shape)
        outs.append(torch.where(mask.reshape(-1, 1, 1, 1, 1), new.to(x.dtype), x))
    return outs


@pytest.mark.parametrize("mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("crop", [True, False], ids=["crop", "nocrop"])
def test_multi_key_entry_with_mask_equals_cat_warp_where(mode, crop):
    g = torch.Generator().manual_seed(21)
    in_shape = (9, 41, 44)
    out_shape = (6, 30, 27) if crop else in_shape
    b = 5
    keys = [torch.rand((b, 1, *in_shape), generator=g), torch.rand((b, 2, *in_shape), generator=g)]
    mats = _production_maps(b, in_shape, seed=22)
    offset = _crop_offset(in_shape, out_shape) if crop else None
    mask = torch.tensor([True, False, True, False, True])
    got = warp3d.affine_warp_3d_keys(keys, mats, out_shape, mode, offset, apply_mask=mask)
    want = _old_member(keys, mats, out_shape, mode, offset, mask, crop)
    for a, w in zip(got, want):
        assert a.shape == w.shape and torch.equal(a, w)
    # BatchedRandAffined.apply goes through it
    aff = _production(crop=out_shape if crop else None)
    aff.padding_mode = mode
    rot, scale, shear, trans = aff._sample_params(torch.Generator().manual_seed(23), b, in_shape, "cpu")
    draws = dict(mask=mask, rotation=rot, scale=scale, shear=shear, translate=trans)
    out = aff.apply({"source": keys[0], "target": keys[1]}, draws)
    m2 = tw.compose_affine_3d(rotation=rot, scale=scale, shear=shear, translate=trans)
    for k, w in zip(("source", "target"), _old_member(keys, m2, out_shape, mode, offset, mask, crop)):
        assert torch.equal(out[k], w)


def test_multi_key_entry_keeps_dtypes_and_checks_its_inputs():
    g = torch.Generator().manual_seed(31)
    x64 = torch.rand((3, 1, 6, 20, 20), generator=g, dtype=torch.float64)
    x32 = x64.float()
    mats = _production_maps(3, (6, 20, 20), seed=32)
    mask = torch.tensor([False, True, False])
    out64, out32 = warp3d.affine_warp_3d_keys([x64, x32], mats, (4, 12, 12), apply_mask=mask)
    assert out64.dtype == torch.float64 and out32.dtype == torch.float32
    crop = (slice(1, 5), slice(4, 16), slice(4, 16))
    assert torch.equal(out64[0], x64[0][(Ellipsis, *crop)])  # exact, not through float32
    assert torch.equal(out32[2], x32[2][(Ellipsis, *crop)])
    assert torch.equal(out32[1], warp3d.affine_warp_3d(x32, mats, (4, 12, 12))[1])
    with pytest.raises(ValueError, match="apply_mask"):
        warp3d.affine_warp_3d_keys([x32], mats, (4, 12, 12), apply_mask=mask[:2])
    with pytest.raises(ValueError, match="fit"):
        warp3d.affine_warp_3d_keys([x32], mats, (7, 12, 12), apply_mask=mask)
    with pytest.raises(ValueError, match="same batch"):
        warp3d.affine_warp_3d_keys([x32, x32[:, :, :5]], mats)
    with pytest.raises(ValueError):
        warp3d.affine_warp_3d_keys([], mats)
    with pytest.raises(RuntimeError, match="cuda"):
        warp3d.affine_warp_3d_keys([x32.to("meta")], mats.to("meta"))
