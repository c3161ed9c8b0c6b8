"""The port's remaining intensity transforms against viscy_tpu.transforms:
percentile rescale, histogram shift, inversion (batched and per call),
noise per call (dict and array), sharpen, local pixel shuffling and the
array variants of the intensity members.

Inputs are numpy-seeded (2, C, 8, 48, 48) stacks in [0, 1]; every random
member takes the draws the JAX member made, read off the same keys
(tests/_torch_port_draws.py). Tolerance: max |d| <= 1e-5 (float32), the
bound of the elementwise and deterministic members.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu import transforms as J
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.transforms.intensity import interp, percentile

from _torch_port_draws import jax_draws, run_jax_compose

STACK = (8, 48, 48)
ATOL = 1e-5


def _batch(seed, c_source=1, c_target=2):
    rng = np.random.default_rng(seed)
    return {"source": rng.random((2, c_source, *STACK), np.float32),
            "target": rng.random((2, c_target, *STACK), np.float32)}


def _check(make, batch, key=7):
    """``make(ns)`` in both packages on ``batch``; random members take the
    JAX draws."""
    jt, tt = make(J), make(T)
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    tdata = {k: torch.from_numpy(v) for k, v in batch.items()}
    if getattr(jt, "is_random", False):
        k = jax.random.PRNGKey(key)
        draws = jax_draws(jt, jdata, k)
        want, got = jax.jit(jt.__call__)(jdata, k), tt(tdata, draws=draws)
    else:
        draws, want, got = None, jax.jit(jt.__call__)(jdata), tt(tdata)
    for name in batch:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape and got[name].dtype == torch.float32, name
        np.testing.assert_allclose(got[name].numpy(), w, atol=ATOL, rtol=0, err_msg=name)
    return draws


MEMBERS = {
    "percentiles-channel": lambda ns: ns.BatchedScaleIntensityRangePercentilesd(
        keys=["source", "target"], lower=1.0, upper=99.0, b_min=0.0, b_max=1.0),
    "percentiles-sample-clip": lambda ns: ns.BatchedScaleIntensityRangePercentilesd(
        keys=["target"], lower=5.0, upper=95.0, b_min=-1.0, b_max=1.0, clip=True, channel_wise=False),
    "histogram-shift": lambda ns: ns.BatchedRandHistogramShiftd(keys=["source", "target"], prob=0.7),
    "histogram-shift-tuple": lambda ns: ns.BatchedRandHistogramShiftd(
        keys=["source"], num_control_points=(5, 15), prob=1.0),
    "invert": lambda ns: ns.BatchedRandInvertIntensityd(keys=["source", "target"], prob=0.5),
    "invert-per-call": lambda ns: ns.RandInvertIntensityd(keys=["source", "target"], prob=0.9),
    "noise-per-call": lambda ns: ns.RandGaussianNoiseTensord(keys=["source", "target"], prob=0.9, std=0.3),
    "noise-per-call-fixed-std": lambda ns: ns.RandGaussianNoiseTensord(
        keys=["source"], prob=0.9, mean=0.1, std=0.2, sample_std=False),
    "sharpen": lambda ns: ns.BatchedRandSharpend(keys=["source"], prob=0.7),
    "sharpen-narrow": lambda ns: ns.BatchedRandSharpend(keys=["source", "target"], prob=1.0, alpha=(1.0, 3.0),
                                                        sigma=0.6),
    "pixel-shuffle": lambda ns: ns.BatchedRandLocalPixelShufflingd(keys=["source", "target"], prob=0.8,
                                                                   num_blocks=20),
    "pixel-shuffle-odd-block": lambda ns: ns.BatchedRandLocalPixelShufflingd(keys=["source"], prob=1.0,
                                                                             block_size=3),
}


@pytest.mark.parametrize("make", MEMBERS.values(), ids=MEMBERS.keys())
def test_member_with_jax_draws_matches_jax(make):
    _check(make, _batch(1))


@pytest.mark.parametrize("seed", range(4))
def test_draw_dependent_branches_are_taken(seed):
    """Over these seeds the JAX draws take both branches of every mask, and
    the odd block's shift reaches -(bs // 2) - 1 (floor division)."""
    key = jax.random.PRNGKey(seed)
    data = {k: jnp.asarray(v) for k, v in _batch(seed).items()}
    d = jax_draws(MEMBERS["pixel-shuffle-odd-block"](J), data, key)
    assert d["shifts"].min() >= -2 and d["shifts"].max() <= 1
    _check(MEMBERS["pixel-shuffle-odd-block"], _batch(seed), key=seed)
    _check(MEMBERS["invert-per-call"], _batch(seed), key=seed)


def test_shuffle_shift_range_follows_floor_division():
    t = T.BatchedRandLocalPixelShufflingd(keys=["source"], prob=1.0, block_size=3)
    d = t.draw({"source": torch.zeros(4096, 1, 1, 3, 3)}, torch.Generator().manual_seed(0))
    assert sorted(d["shifts"].unique().tolist()) == [-2, -1, 0, 1]


def test_pixel_shuffle_refuses_a_frame_the_cells_do_not_tile():
    t = T.BatchedRandLocalPixelShufflingd(keys=["source"], prob=1.0, block_size=7)
    with pytest.raises(ValueError, match="do not tile"):
        t({"source": torch.zeros(1, 1, 2, 48, 48)}, torch.Generator().manual_seed(0))


def test_histogram_shift_on_the_knots_matches_jax():
    """Voxels whose unit intensity sits exactly on a control point take the
    segment to its right (``searchsorted(right=True)``), as ``jnp.interp``."""
    n = 6
    knots = np.append(np.arange(n - 1, dtype=np.float32) * (np.float32(1) / np.float32(n - 1)), np.float32(1))
    vals = np.resize(knots, 2 * 1 * 8 * 48 * 48).reshape(2, 1, *STACK).astype(np.float32)
    make = lambda ns: ns.BatchedRandHistogramShiftd(keys=["source"], num_control_points=n, prob=1.0)
    _check(make, {"source": vals})
    x = torch.tensor([[0.0, 0.2, 0.5, 1.0, -1.0, 2.0]])
    xp = torch.tensor([0.0, 0.2, 1.0])
    fp = torch.tensor([[0.0, 0.5, 1.0]])
    got = interp(x, xp, fp)
    want = np.interp(x[0].numpy(), xp.numpy(), fp[0].numpy())
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-7)


@pytest.mark.parametrize("q", [0.0, 1.0, 37.5, 99.0, 100.0])
def test_percentile_matches_jnp_percentile(q):
    x = np.random.default_rng(2).normal(size=(3, 2, 1237)).astype(np.float32)
    want = np.asarray(jnp.percentile(jnp.asarray(x), q, axis=-1))
    np.testing.assert_array_equal(percentile(torch.from_numpy(x), q).numpy(), want)
    x[1, 0, 5] = np.nan
    assert np.isnan(percentile(torch.from_numpy(x), q)[1, 0]) and not np.isnan(percentile(torch.from_numpy(x), q)[0, 0])


def test_percentile_takes_inputs_beyond_2_to_the_24():
    """``torch.quantile`` refuses rows over 2**24 elements; a (23, 1024,
    1024) FOV has 24.1 M. The order statistics from ``sort`` take it."""
    n = 2**24 + 3
    x = torch.from_numpy(np.random.default_rng(3).random(n, dtype=np.float32))
    pos = np.float32(np.float32(99.0) / np.float32(100.0)) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    part = np.partition(x.numpy(), (lo, hi))
    w = np.float32(pos - np.floor(pos))
    want = part[lo] * np.float32(1 - w) + part[hi] * w
    assert float(percentile(x, 99.0)) == pytest.approx(float(want), abs=1e-7)


ARRAY = {
    "contrast": (lambda ns: ns.BatchedRandAdjustContrast(prob=0.7, gamma=(0.8, 1.2)),
                 lambda ns: ns.BatchedRandAdjustContrastd("img", prob=0.7, gamma=(0.8, 1.2))),
    "noise": (lambda ns: ns.BatchedRandGaussianNoise(prob=0.7, std=0.2),
              lambda ns: ns.BatchedRandGaussianNoised("img", prob=0.7, std=0.2)),
    "smooth": (lambda ns: ns.BatchedRandGaussianSmooth(prob=0.9),
               lambda ns: ns.BatchedRandGaussianSmoothd("img", prob=0.9)),
    "scale": (lambda ns: ns.BatchedRandScaleIntensity(factors=0.4, prob=0.9),
              lambda ns: ns.BatchedRandScaleIntensityd("img", factors=0.4, prob=0.9)),
    "percentiles": (lambda ns: ns.BatchedScaleIntensityRangePercentiles(lower=2, upper=98, b_min=0, b_max=1),
                    None),
    "noise-tensor": (lambda ns: ns.RandGaussianNoiseTensor(prob=1.0, std=0.2),
                     lambda ns: ns.RandGaussianNoiseTensord("img", prob=1.0, std=0.2)),
}


@pytest.mark.parametrize("make,dict_form", ARRAY.values(), ids=ARRAY.keys())
def test_array_variant_matches_jax(make, dict_form):
    x = _batch(4)["target"]
    jt, tt = make(J), make(T)
    key = jax.random.PRNGKey(11)
    if dict_form is None:
        want, got = jax.jit(jt.__call__)(jnp.asarray(x)), tt(torch.from_numpy(x))
    else:
        draws = jax_draws(dict_form(J), {"img": jnp.asarray(x)}, key)
        want, got = jax.jit(jt.__call__)(jnp.asarray(x), key), tt(torch.from_numpy(x), draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_intensity_pipeline_with_jax_draws_matches_jax():
    """The new members in one ``Compose``, draws split as JAX splits them."""
    make = lambda ns: ns.Compose([
        ns.BatchedRandHistogramShiftd(keys=["source"], prob=0.8),
        ns.BatchedRandSharpend(keys=["source"], prob=0.8, alpha=(1.0, 2.0)),
        ns.BatchedRandLocalPixelShufflingd(keys=["source", "target"], prob=0.8, num_blocks=10),
        ns.BatchedRandInvertIntensityd(keys=["source"], prob=0.5),
        ns.BatchedScaleIntensityRangePercentilesd(keys=["source"], lower=1, upper=99, b_min=0, b_max=1),
    ])
    batch = _batch(5)
    want, draws = run_jax_compose(make(J), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(3))
    got = make(T)({k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    for k in batch:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)


def test_generator_draws_are_reproducible_and_in_range():
    batch = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    for make in MEMBERS.values():
        t = make(T)
        if not t.is_random:
            continue
        a = t(batch, torch.Generator().manual_seed(0))
        b = t(batch, torch.Generator().manual_seed(0))
        for k in batch:
            assert torch.equal(a[k], b[k])
    d = MEMBERS["histogram-shift"](T).draw(batch, torch.Generator().manual_seed(1))
    assert d["jitter"].shape == (2, 10) and d["jitter"].abs().max() <= 0.5 / 9
    d = MEMBERS["sharpen"](T).draw(batch, torch.Generator().manual_seed(1))
    assert ((d["alpha"] >= 10) & (d["alpha"] <= 30)).all()
