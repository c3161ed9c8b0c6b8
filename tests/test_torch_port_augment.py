"""The port's device augmentation against viscy_tpu.transforms.

JAX threefry and torch Philox give different numbers, so every random
transform here takes the draws the JAX transform made (mask, rotation,
scale, shear, translate, gamma, factor, std, noise field, sigmas), read off
the same PRNG keys the JAX ``Compose`` hands its members. Stacks are small
(2, C, 8, 48, 48) -> (5, 32, 32), as ``BENCH_TINY`` shrinks the flagship
recipe. Tolerance: max |d| <= 1e-5 (float32, inputs in [0, 1]) for the
deterministic and elementwise members; 1e-4 of the range for the composed
pipeline (a 1e-5 warp difference passes through gamma and the blur).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu import transforms as J
from viscy_tpu_torch import transforms as T

from _torch_port_draws import jax_draws, run_jax_compose

STACK = (8, 48, 48)
PATCH = (5, 32, 32)


def production(ns, keys=("source", "target")):
    """The flagship VSCyto3D augmentation (bench.py) from namespace ``ns``."""
    return ns.Compose(
        [
            ns.BatchedRandAffined(
                keys=list(keys), prob=0.8, rotate_range=[3.14, 0, 0], shear_range=[0.0, 0.05, 0.05],
                scale_range=[[0.7, 1.3], [0.5, 1.5], [0.5, 1.5]],
            ),
            ns.BatchedCenterSpatialCropd(keys=list(keys), roi_size=list(PATCH)),
            ns.BatchedRandAdjustContrastd(keys=["source"], prob=0.5, gamma=(0.8, 1.2)),
            ns.BatchedRandScaleIntensityd(keys=["source"], prob=0.5, factors=0.5),
            ns.BatchedRandGaussianNoised(keys=["source"], prob=0.5, mean=0.0, std=0.3),
            ns.BatchedRandGaussianSmoothd(
                keys=["source"], prob=0.5, sigma_x=(0.25, 0.75), sigma_y=(0.25, 0.75),
                sigma_z=(0.25, 0.75),
            ),
        ]
    )


def _batch(seed, c_source=1, c_target=2):
    rng = np.random.default_rng(seed)
    return {
        "source": rng.random((2, c_source, *STACK), np.float32),
        "target": rng.random((2, c_target, *STACK), np.float32),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_production_aug_with_jax_draws_matches_jax(seed):
    batch = _batch(seed)
    jc, tc = production(J), production(T)
    assert [type(t).__name__ for t in jc] == [type(t).__name__ for t in tc]
    assert tc.transforms[0].crop_size == PATCH  # affine + center crop fused
    want, draws = run_jax_compose(jc, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(seed))
    got = tc({k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    for k in ("source", "target"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (2, batch[k].shape[1], *PATCH)
        span = float(w.max() - w.min())
        assert np.abs(got[k].numpy() - w).max() <= 1e-4 * span, k


@pytest.mark.parametrize(
    "make",
    [
        lambda ns: ns.BatchedRandAdjustContrastd(keys=["source"], prob=0.5, gamma=(0.8, 1.2)),
        lambda ns: ns.BatchedRandAdjustContrastd(keys=["source"], prob=1.0, gamma=(0.5, 2.0),
                                                 invert_image=True, retain_stats=True),
        lambda ns: ns.BatchedRandScaleIntensityd(keys=["source"], prob=0.5, factors=0.5),
        lambda ns: ns.BatchedRandGaussianNoised(keys=["source", "target"], prob=0.9, std=0.3),
        lambda ns: ns.BatchedRandGaussianSmoothd(keys=["source"], prob=0.9, sigma_z=(0.25, 0.75),
                                                 sigma_y=(0.25, 0.75), sigma_x=(0.25, 0.75)),
        lambda ns: ns.BatchedRandAffined(keys=["source", "target"], prob=0.8,
                                         rotate_range=[3.14, 0, 0], shear_range=[0.0, 0.05, 0.05],
                                         scale_range=[[0.7, 1.3], [0.5, 1.5], [0.5, 1.5]]),
        lambda ns: ns.BatchedRandAffined(keys=["source"], prob=1.0, rotate_range=0.3,
                                         shear_range=[0.05] * 6, translate_range=0.1,
                                         scale_range=(0.9, 1.1), isotropic_scale=True,
                                         padding_mode="border"),
    ],
    ids=["contrast", "contrast-invert-retain", "scale", "noise", "smooth", "affine",
         "affine-6-facet-border"],
)
def test_member_with_jax_draws_matches_jax(make):
    batch = _batch(3)
    jt, tt = make(J), make(T)
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    draws = jax_draws(jt, jdata, key)
    want = jt(jdata, key)
    got = tt({k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    for k in batch:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)


def test_smooth_crop_fusion_matches_jax():
    """[smooth, center crop] fuses into a halo blur (both packages)."""
    batch = _batch(4)
    make = lambda ns: ns.Compose([
        ns.BatchedRandGaussianSmoothd(keys=["source"], prob=1.0),
        ns.BatchedCenterSpatialCropd(keys=["source", "target"], roi_size=[6, 30, 30]),
    ])
    jc, tc = make(J), make(T)
    assert tc.transforms[0]._post_crop == (6, 30, 30) and tc.transforms[1].keys == ("target",)
    want, draws = run_jax_compose(jc, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(2))
    got = tc({k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    for k in batch:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0)


def test_generator_draws_are_reproducible_and_in_range():
    batch = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    tc = production(T)
    a = tc(batch, torch.Generator().manual_seed(0))
    b = tc(batch, torch.Generator().manual_seed(0))
    for k in batch:
        assert torch.equal(a[k], b[k]) and a[k].shape[-3:] == PATCH
    affine = tc.transforms[0]
    d = affine.draw(batch, torch.Generator().manual_seed(1))
    assert d["mask"].dtype == torch.bool and d["shear"].shape == (2, 6)
    assert (d["shear"][:, 3:] == 0).all() and (d["shear"][:, 0] == 0).all()
    assert ((d["scale"][:, 0] >= 0.7) & (d["scale"][:, 0] <= 1.3)).all()
    with pytest.raises(ValueError):
        tc(batch)
    with pytest.raises(ValueError):
        tc(batch, draws=[{}])
