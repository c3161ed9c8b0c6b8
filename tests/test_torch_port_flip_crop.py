"""The port's flip, crops, their fusions into the affine warp, the safe-crop
clamp and the sampled normalizations against viscy_tpu.transforms.

JAX threefry and torch Philox give different numbers, so each random
transform takes the draws the JAX transform made, read off the PRNG keys
the JAX ``Compose`` hands its members (a fused member takes several).
Stacks are small ((B, C, 8, 48, 48)). Tolerances: bit-exact for the flip,
the crops and the normalizations; 1e-6 relative for the safe-crop clamp
(float32 roundings of a 3x3 product); max |d| <= 1e-5 (inputs in [0, 1])
for the fused warps, the bound of the plain affine member in
test_torch_port_augment.py: the port's grid sums its products in the
kernel's order, JAX's in its matmul's, and the two grids differ by up to
4e-6 voxel on the same maps; 1e-4 of the range for the recipe's composed
augmentation (a warp difference passes through gamma).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu import transforms as J
from viscy_tpu.transforms.crop import batched_crop_at as j_crop_at
from viscy_tpu_torch import transforms as T

from _torch_port_draws import jax_draws, run_jax_compose
from test_torch_port_augment import production

STACK = (8, 48, 48)


def _batch(seed, b=4, mask=False):
    rng = np.random.default_rng(seed)
    out = {
        "source": rng.random((b, 1, *STACK), np.float32),
        "target": rng.random((b, 2, *STACK), np.float32),
    }
    if mask:
        out["fg_mask"] = rng.random((b, 1, *STACK)) > 0.6
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_same(got: dict, want: dict, atol=0.0):
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if atol == 0.0 or w.dtype == np.bool_:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("axes", [(0, 1, 2), (1, 2), 2], ids=["zyx", "yx", "x"])
def test_flip_with_jax_draws_is_bit_exact(axes):
    batch = _batch(0, mask=True)
    jt = J.BatchedRandFlipd(keys=["source", "target", "fg_mask"], spatial_axes=axes, prob=0.5)
    tt = T.BatchedRandFlipd(keys=["source", "target", "fg_mask"], spatial_axes=axes, prob=0.5)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(jt, _j(batch), key)
    assert draws["flips"].any() and not draws["flips"].all()
    _assert_same(tt(_t(batch), draws=draws), jt(_j(batch), key))
    gen_draws = tt.draw(_t(batch), torch.Generator().manual_seed(0))
    assert gen_draws["flips"].shape == (4, len(tt.spatial_axes)) and gen_draws["flips"].dtype == torch.bool


@pytest.mark.parametrize(
    "roi,random_center",
    [((5, 32, 30), True), ((-1, 40, 17), True), ((6, 31, 31), False), ((20, 64, 64), True)],
    ids=["random", "keep-z", "center", "larger-than-input"],
)
def test_random_crop_with_jax_draws_is_bit_exact(roi, random_center):
    batch = _batch(1)
    jt = J.BatchedRandSpatialCropd(keys=["source", "target"], roi_size=roi, random_center=random_center)
    tt = T.BatchedRandSpatialCropd(keys=["source", "target"], roi_size=roi, random_center=random_center)
    key = jax.random.PRNGKey(4)
    draws = jax_draws(jt, _j(batch), key)
    _assert_same(tt(_t(batch), draws=draws), jt(_j(batch), key))
    starts = tt.draw(_t(batch), torch.Generator().manual_seed(1))["starts"]
    out_roi = [s if r < 0 else min(r, s) for r, s in zip(tt.roi_size, STACK)]
    assert ((starts >= 0) & (starts <= torch.tensor(STACK) - torch.tensor(out_roi))).all()


def test_batched_crop_at_matches_jax():
    x = np.random.default_rng(2).random((3, 2, *STACK), np.float32)
    starts = np.array([[0, 0, 0], [3, 10, 17], [2, 16, 0]], np.int32)
    want = j_crop_at(jnp.asarray(x), jnp.asarray(starts), (6, 32, 31))
    got = T.batched_crop_at(torch.from_numpy(x), torch.from_numpy(starts), (6, 32, 31))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [5, (1, 16, 20), (3, 7, 5)], ids=["5", "zyx", "odd"])
def test_divisible_crop_is_bit_exact(k):
    batch = _batch(3)
    jt = J.BatchedDivisibleCropd(keys=["source", "target"], k=k)
    tt = T.BatchedDivisibleCropd(keys=["source", "target"], k=k)
    _assert_same(tt(_t(batch)), jt(_j(batch)))
    with pytest.raises(ValueError):
        T.BatchedDivisibleCropd(keys=["source"], k=64)(_t(batch))


def _affine(ns, keys, prob=0.7, **kw):
    return ns.BatchedRandAffined(keys=list(keys), prob=prob, rotate_range=[3.14, 0, 0],
                                 shear_range=[0.0, 0.05, 0.05],
                                 scale_range=[[0.8, 1.2], [0.7, 1.3], [0.7, 1.3]], **kw)


def _fused_case(ns, crop, flip, keys):
    members = [_affine(ns, keys)]
    if crop == "random":
        members.append(ns.BatchedRandSpatialCropd(keys=list(keys), roi_size=[5, 32, 30]))
    elif crop == "center":
        members.append(ns.BatchedCenterSpatialCropd(keys=list(keys), roi_size=[5, 32, 30]))
    if flip:
        members.append(ns.BatchedRandFlipd(keys=list(keys), spatial_axes=(1, 2), prob=0.5))
    return ns.Compose(members)


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("crop", ["none", "center", "random"])
def test_fused_affine_with_jax_draws_matches_jax(crop, flip):
    """Affine + (none, center, random) crop + (no) in-plane flip fuse into one
    member on both sides; with the JAX draws the port's warp (the plain
    version here) gives JAX's output, a bool ``fg_mask`` key included. With
    a flip, a sample the affine's mask leaves alone is warped by the
    identity and still flipped."""
    keys = ("source", "target", "fg_mask")
    jc, tc = _fused_case(J, crop, flip, keys), _fused_case(T, crop, flip, keys)
    assert len(jc) == len(tc) == 1
    fused = tc.transforms[0]
    assert (fused._rand_crop_size is not None) == (crop == "random")
    assert (fused.crop_size is not None) == (crop == "center")
    assert fused._flip_axes == ((1, 2) if flip else None)
    batch = _batch(5, mask=True)
    for seed in range(40):
        want, draws = run_jax_compose(jc, _j(batch), jax.random.PRNGKey(seed))
        d = draws[0]
        unapplied_flipped = (~d["mask"] & d["flips"].any(dim=1)).any() if flip else True
        if d["mask"].any() and not d["mask"].all() and unapplied_flipped:
            break
    else:
        raise AssertionError("no key gave applied, unapplied and unapplied-flipped samples")
    got = tc(_t(batch), draws=draws)
    _assert_same(got, want, atol=1e-5)
    assert got["fg_mask"].dtype == torch.bool
    if crop == "random" and not flip:
        # the identity in the maps gives an unapplied sample its random crop exactly
        keep = ~d["mask"]
        for k in keys:
            assert torch.equal(got[k][keep], T.batched_crop_at(_t(batch)[k], d["starts"], (5, 32, 30))[keep])
    if flip:
        # an unapplied sample is its own (cropped) input, mirrored
        i = int(torch.nonzero(~d["mask"] & d["flips"].any(dim=1))[0, 0])
        assert not torch.equal(got["source"][i], _t(batch)["source"][i, ..., :got["source"].shape[-1]])


@pytest.mark.parametrize("roi", [(5, 31, 29), (6, 32, 30)], ids=["odd", "even"])
def test_fused_random_crop_leaves_an_unapplied_sample_as_its_crop(roi):
    """The affine + random crop fusion with the mask folded into the maps:
    an unapplied sample is warped by the identity at integer coordinates
    (S - R odd on every axis, or even) and comes out as its random crop
    bit for bit, the bool key too, as JAX's copy of the crop gives it;
    applied samples match JAX's warp to 1e-5."""
    keys = ["source", "target", "fg_mask"]

    def make(ns):
        return ns.Compose([_affine(ns, keys, prob=0.5),
                           ns.BatchedRandSpatialCropd(keys=keys, roi_size=list(roi))])

    jc, tc = make(J), make(T)
    assert len(jc) == len(tc) == 1 and tc.transforms[0]._rand_crop_size == roi
    batch = _batch(12, b=6, mask=True)
    for seed in range(40):
        want, draws = run_jax_compose(jc, _j(batch), jax.random.PRNGKey(seed))
        d = draws[0]
        if d["mask"].any() and not d["mask"].all():
            break
    else:
        raise AssertionError("no key gave applied and unapplied samples")
    got = tc(_t(batch), draws=draws)
    _assert_same(got, want, atol=1e-5)
    keep = ~d["mask"]
    for k in keys:
        crops = T.batched_crop_at(_t(batch)[k], d["starts"], roi)
        assert torch.equal(got[k][keep], crops[keep])
        np.testing.assert_array_equal(got[k][keep].numpy(), np.asarray(want[k])[keep.numpy()])


def test_fused_member_draws_from_a_generator():
    keys = ("source", "target")
    tc = _fused_case(T, "random", True, keys)
    batch = _t(_batch(6))
    d = tc.transforms[0].draw(batch, torch.Generator().manual_seed(2))
    assert set(d) == {"mask", "rotation", "scale", "shear", "translate", "starts", "flips"}
    assert d["starts"].shape == (4, 3) and d["flips"].shape == (4, 2)
    a = tc(batch, torch.Generator().manual_seed(3))
    b = tc(batch, torch.Generator().manual_seed(3))
    for k in keys:
        assert torch.equal(a[k], b[k]) and a[k].shape[-3:] == (5, 32, 30)


def test_safe_crop_clamp_matches_jax():
    """The port's clamp applied to JAX's drawn rotations and unclamped
    scales gives JAX's clamped scales; the member draws through it."""
    kw = dict(keys=["source"], prob=1.0, rotate_range=[3.14, 0.2, 0.1],
              scale_range=[[0.5, 1.0], [0.4, 1.0], [0.4, 1.0]])
    jt = J.BatchedRandAffined(safe_crop_size=(5, 32, 32), safe_crop_coverage=0.9, **kw)
    tt = T.BatchedRandAffined(safe_crop_size=(5, 32, 32), safe_crop_coverage=0.9, **kw)
    free = J.BatchedRandAffined(**kw)
    key = jax.random.PRNGKey(7)
    rot, scale, _, _ = free._sample_params(key, 16, STACK)
    _, want, _, _ = jt._sample_params(key, 16, STACK)
    got = tt.clamp_scale_for_crop(torch.from_numpy(np.array(rot)), torch.from_numpy(np.array(scale)), STACK)
    assert (np.asarray(want) > np.asarray(scale)).any()  # the clamp bites
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    d = tt.draw(_t(_batch(7)), torch.Generator().manual_seed(0))
    lo = tt.clamp_scale_for_crop(d["rotation"], torch.zeros_like(d["scale"]), STACK)
    assert (d["scale"] >= lo).all()


def _norm_meta(b, rng, keys=("source", "target")):
    def stats():
        return {"mean": rng.random(b).astype(np.float32), "std": rng.random(b).astype(np.float32) + 0.5,
                "p1": rng.random(b).astype(np.float32) * 0.2,
                "p99": 0.8 + rng.random(b).astype(np.float32) * 0.2}

    return {k: {"fov_statistics": stats()} for k in keys}


@pytest.mark.parametrize("cls", ["NormalizeSampled", "MinMaxSampled"])
@pytest.mark.parametrize("host", [False, True], ids=["batched-torch", "host-numpy"])
def test_sampled_normalizations_are_bit_exact(cls, host):
    rng = np.random.default_rng(8)
    batch = _batch(8)
    meta = _norm_meta(4, rng)
    jt = getattr(J, cls)(keys=["source", "target"], level="fov_statistics", remove_meta=True)
    tt = getattr(T, cls)(keys=["source", "target"], level="fov_statistics", remove_meta=True)
    if host:  # one sample on the host: numpy arrays, scalar stats
        sample = {k: v[0] for k, v in batch.items()}
        meta0 = {k: {"fov_statistics": {s: v[0] for s, v in m["fov_statistics"].items()}}
                 for k, m in meta.items()}
        want = jt(dict(sample, norm_meta=meta0))
        got = tt(dict(sample, norm_meta=meta0))
        assert "norm_meta" not in got and isinstance(got["source"], np.ndarray)
        for k in sample:
            np.testing.assert_array_equal(got[k], want[k])
        return
    tmeta = {k: {"fov_statistics": {s: torch.from_numpy(v) for s, v in m["fov_statistics"].items()}}
             for k, m in meta.items()}
    jmeta = {k: {"fov_statistics": {s: jnp.asarray(v) for s, v in m["fov_statistics"].items()}}
             for k, m in meta.items()}
    want = jt(dict(_j(batch), norm_meta=jmeta))
    got = tt(dict(_t(batch), norm_meta=tmeta))
    assert "norm_meta" not in got
    _assert_same(got, want)


def recipe(ns):
    """The device augmentation of configs/vscyto3d_fit.yml."""
    keys = ["source", "target"]
    return ns.Compose([
        ns.BatchedRandFlipd(keys=keys, prob=0.5),
        ns.BatchedRandAffined(keys=keys, prob=0.5, rotate_range=[3.14, 0.0, 0.0],
                              scale_range=[[1.0, 1.3], [0.75, 1.3], [0.75, 1.3]]),
        ns.BatchedRandAdjustContrastd(keys=["source"], gamma=[0.8, 1.2], prob=0.3),
        ns.BatchedRandGaussianNoised(keys=["source"], prob=0.5, std=0.5),
    ])


def _members(compose):
    return [(type(t).__name__, getattr(t, "crop_size", None), getattr(t, "_rand_crop_size", None),
             getattr(t, "_flip_axes", None), getattr(t, "_flip_prob", None), getattr(t, "_post_crop", None),
             tuple(getattr(t, "keys", ())))
            for t in compose]


@pytest.mark.parametrize(
    "make",
    [
        recipe,
        production,
        lambda ns: _fused_case(ns, "random", True, ("source", "target")),
        lambda ns: ns.Compose([_affine(ns, ["source", "target"]),
                               ns.BatchedRandFlipd(keys=["source", "target"], spatial_axes=(0, 1))]),
        lambda ns: ns.Compose([_affine(ns, ["source", "target"]),
                               ns.BatchedRandFlipd(keys=["source"], spatial_axes=(1, 2))]),
        lambda ns: ns.Compose([_affine(ns, ["source"]),
                               ns.BatchedRandSpatialCropd(keys=["source"], roi_size=[5, 32, 30],
                                                          random_center=False)]),
    ],
    ids=["vscyto3d-fit", "bench", "affine-randcrop-flip", "z-flip-unfused", "keys-differ-unfused",
         "center-randcrop-unfused"],
)
def test_compose_yields_the_jax_member_list(make):
    assert _members(make(T)) == _members(make(J))


@pytest.mark.parametrize("seed", [0, 1])
def test_recipe_augmentation_with_jax_draws_matches_jax(seed):
    batch = _batch(10 + seed)
    jc, tc = recipe(J), recipe(T)
    want, draws = run_jax_compose(jc, _j(batch), jax.random.PRNGKey(seed))
    got = tc(_t(batch), draws=draws)
    for k in ("source", "target"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == batch[k].shape
        assert np.abs(got[k].numpy() - w).max() <= 1e-4 * float(w.max() - w.min()), k
