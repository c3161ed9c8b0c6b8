"""The port's affine warp (plain version; the kernel computes the same
function, see test_torch_port_kernels.py) against viscy_tpu.

- against ``viscy_tpu.ops.warp`` (``chunked_affine_warp``,
  ``compose_affine_3d``): max |d| <= 1e-5 (float32; inputs in [0, 1], so
  the difference is a few ulps of the coordinates and the lerp);
- against the TPU kernel ``affine_warp_3d_pallas`` (interpret mode) within
  that kernel's separable-approximation bound, as tests/test_pallas_warp.py
  measures it: max |d| < 5e-2 and mean |d| < 5e-3 of the input range on a
  smooth volume, and the zero-padding mask identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.ops import warp as jw
from viscy_tpu.ops.pallas.warp3d import affine_warp_3d_pallas, estimate_kz
from viscy_tpu_torch.ops import warp as tw
from viscy_tpu_torch.ops import warp3d

B, C = 3, 2
IN = (8, 40, 36)
OUT = (6, 32, 30)


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        rotation=np.stack([rng.uniform(-3.14, 3.14, B), rng.uniform(-0.2, 0.2, B), np.zeros(B)], -1).astype(f32),
        scale=rng.uniform(0.6, 1.5, (B, 3)).astype(f32),
        shear=rng.uniform(-0.05, 0.05, (B, 6)).astype(f32),
        translate=rng.uniform(-3, 3, (B, 3)).astype(f32),
    )


def test_compose_affine_matches_jax():
    d = _draws()
    want = np.asarray(jw.compose_affine_3d(**{k: jnp.asarray(v) for k, v in d.items()}))
    got = tw.compose_affine_3d(**{k: torch.from_numpy(v) for k, v in d.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tw.compose_affine_3d(batch=2).numpy(), np.asarray(jw.compose_affine_3d(batch=2)))


@pytest.mark.parametrize("mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("offset", ["none", "tuple", "per-sample"])
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
def test_plain_warp_matches_jax(mode, offset, flip):
    rng = np.random.default_rng(1)
    vol = rng.random((B, C, *IN), np.float32)
    mats = np.array(jw.compose_affine_3d(**{k: jnp.asarray(v) for k, v in _draws(2).items()}))
    off = {"none": None, "tuple": (0.5, 0.0, -0.5),
           "per-sample": rng.uniform(-3, 3, (B, 3)).astype(np.float32)}[offset]
    signs = np.where(rng.random((B, 3)) < 0.5, -1.0, 1.0).astype(np.float32) if flip else None
    j = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v
    t = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    want = np.asarray(jw.chunked_affine_warp(jnp.asarray(vol), jnp.asarray(mats), OUT, out_offset=j(off),
                                             padding_mode=mode, flip_signs=j(signs)))
    got = warp3d.affine_warp_3d(torch.from_numpy(vol), torch.from_numpy(mats), OUT, mode, t(off), t(signs))
    assert got.shape == (B, C, *OUT) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5
    # the sampler alone, on the JAX grid
    grids = jw.affine_grid_3d(jnp.asarray(mats), IN, OUT, out_offset=j(off), flip_signs=j(signs))
    np.testing.assert_allclose(
        tw.affine_grid_3d(torch.from_numpy(mats), IN, OUT, t(off), t(signs)).numpy(), np.asarray(grids),
        atol=2e-5, rtol=0,
    )
    want_s = np.asarray(jw.batched_trilinear_sample(jnp.asarray(vol), grids, mode))
    got_s = tw.batched_trilinear_sample(torch.from_numpy(vol), torch.from_numpy(np.asarray(grids)), mode)
    assert np.abs(got_s.numpy() - want_s).max() <= 1e-6


def test_plain_warp_against_pallas_kernel_within_its_bound():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(3)
    vol = gaussian_filter(rng.random((B, C, *IN)).astype(np.float32), (0, 0, 1.5, 2, 2))
    rot = np.stack([rng.uniform(-3.14, 3.14, B), np.zeros(B), np.zeros(B)], -1).astype(np.float32)
    scale = rng.uniform(0.6, 1.5, (B, 3)).astype(np.float32)
    mats = np.array(jw.compose_affine_3d(rotation=jnp.asarray(rot), scale=jnp.asarray(scale)))
    out = (6, 32, 32)
    kz = estimate_kz([(-3.14, 3.14), (0, 0), (0, 0)], None, [(0.6, 1.5)] * 3, IN, out)
    want = np.asarray(affine_warp_3d_pallas(jnp.asarray(vol), jnp.asarray(mats), out, kz=kz, interpret=True))
    got = warp3d.affine_warp_3d(torch.from_numpy(vol), torch.from_numpy(mats), out).numpy()
    d = np.abs(got - want)
    span = float(vol.max() - vol.min())
    assert d.max() < 0.05 * span
    assert d.mean() < 0.005 * span
    np.testing.assert_array_equal(got == 0, want == 0)


def test_warp_wrapper_checks_its_inputs():
    vol = torch.rand(2, 1, 4, 6, 6)
    mats = tw.compose_affine_3d(batch=2)
    with pytest.raises(ValueError):
        warp3d.affine_warp_3d(vol[0], mats)
    with pytest.raises(ValueError):
        warp3d.affine_warp_3d(vol, mats[:1])
    with pytest.raises(ValueError):
        warp3d.affine_warp_3d(vol, mats, padding_mode="wrap")
    with pytest.raises(RuntimeError, match="cuda"):
        warp3d.affine_warp_3d(vol.to("meta"), mats.to("meta"))
    before = warp3d.launches
    torch.testing.assert_close(warp3d.affine_warp_3d(vol, mats), vol)  # identity map
    assert warp3d.launches == before
