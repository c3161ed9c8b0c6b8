"""The port's remaining spatial transforms against viscy_tpu.transforms:
elastic deformation, Z shift, weighted and tiled crops, zoom (every
``jax.image.resize`` rule), Z reduction, channel stacking, decollation and
the spatial array variants.

Inputs are numpy-seeded (2, C, 8, 48, 48) stacks in [0, 1]; random members
take the draws the JAX member made (tests/_torch_port_draws.py).
Tolerances: crops, Z reduction, stacking and decollation bit for bit;
elastic, zoom and Z shift max |d| <= 1e-5 of the output's range (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu import transforms as J
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.transforms.crop import window_sums

from _torch_port_draws import jax_draws

STACK = (8, 48, 48)


def _batch(seed, c_source=1, c_target=2, mask=False):
    rng = np.random.default_rng(seed)
    out = {"source": rng.random((2, c_source, *STACK), np.float32),
           "target": rng.random((2, c_target, *STACK), np.float32)}
    if mask:
        out["fg_mask"] = (rng.random((2, c_target, *STACK)) > 0.6).astype(np.float32)
    return out


def _run(make, batch, key=5):
    jt, tt = make(J), make(T)
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    tdata = {k: torch.from_numpy(v) for k, v in batch.items()}
    if getattr(jt, "is_random", False):
        k = jax.random.PRNGKey(key)
        draws = jax_draws(jt, jdata, k)
        return jax.jit(jt.__call__)(jdata, k), tt(tdata, draws=draws), draws
    return jt(jdata), tt(tdata), None


def _assert_range_close(got, want, rel=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    span = float(want.max() - want.min()) or 1.0
    assert np.abs(got.numpy().astype(np.float64) - want).max() <= rel * span


ELASTIC = {
    "reflection": lambda ns: ns.BatchedRand3DElasticd(keys=["source", "target"], sigma_range=(1.0, 2.0),
                                                      magnitude_range=(1.0, 3.0), prob=0.7),
    "zeros-wide": lambda ns: ns.BatchedRand3DElasticd(keys=["source", "target", "fg_mask"], sigma_range=(2.0, 4.0),
                                                      magnitude_range=(5.0, 9.0), prob=1.0, padding_mode="zeros"),
    "border-narrow": lambda ns: ns.BatchedRand3DElasticd(keys=["source"], sigma_range=(0.1, 0.3),
                                                         magnitude_range=(0.5, 1.0), prob=1.0,
                                                         padding_mode="border"),
}


@pytest.mark.parametrize("make", ELASTIC.values(), ids=ELASTIC.keys())
def test_elastic_with_jax_draws_matches_jax(make):
    batch = _batch(1, mask=True)
    want, got, draws = _run(make, batch)
    for k in batch:
        _assert_range_close(got[k], want[k])
    t = make(T)
    r = t._radius
    assert r == max(1, int(t.sigma_range[1] * 3) | 1) // 2


def test_elastic_smoothing_is_the_grouped_box_convolution():
    """``avg_pool3d`` with the padding counted equals JAX's zero-padded
    grouped convolution with taps 1 / (2r + 1), three passes per axis."""
    jt = ELASTIC["zeros-wide"](J)
    tt = ELASTIC["zeros-wide"](T)
    field = np.random.default_rng(2).normal(size=(2, 3, *STACK)).astype(np.float32)
    want = np.asarray(jt._smooth(jnp.asarray(field)))
    got = tt.smooth(torch.from_numpy(field)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("max_shift,cval", [(3, 0.0), (6, -1.0)])
def test_z_shift_with_jax_draws_matches_jax(max_shift, cval):
    make = lambda ns: ns.BatchedRandZStackShiftd(keys=["source", "target"], max_shift=max_shift, prob=0.8,
                                                 cval=cval)
    for key in (1, 2, 3):
        want, got, draws = _run(make, _batch(3), key)
        for k in ("source", "target"):
            _assert_range_close(got[k], want[k])


@pytest.mark.parametrize("size", [(4, 16, 16), (8, 40, 24), (1, 48, 48)], ids=["small", "wide", "flat-full-yx"])
def test_weighted_crop_with_jax_draws_is_bit_exact(size):
    batch = _batch(4)
    batch["weight"] = batch["target"][:, :1].copy()
    batch["weight"][1] = 0.0  # all-zero weights draw uniformly
    make = lambda ns: ns.BatchedRandWeightedCropd(keys=["source", "target"], w_key="weight", spatial_size=size)
    want, got, draws = _run(make, batch)
    for k in ("source", "target"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="exceeds"):
        T.BatchedRandWeightedCropd(["source"], "weight", (9, 8, 8))(
            {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())


def test_weighted_crop_draws_follow_the_weights():
    """The port's own draws: a weight map that is 0 outside one 10 x 10
    block puts every crop over it."""
    w = torch.zeros(64, 1, 4, 48, 48)
    w[..., 30:40, 5:15] = 1.0
    t = T.BatchedRandWeightedCropd(keys=["weight"], w_key="weight", spatial_size=(2, 10, 10))
    d = t.draw({"weight": w}, torch.Generator().manual_seed(0))
    vx = 48 - 10 + 1
    ys, xs = d["index"] // vx, d["index"] % vx
    assert ((ys >= 21) & (ys <= 39) & (xs <= 14)).all() and (ys == 30).any()
    assert d["z_starts"].min() >= 0 and d["z_starts"].max() <= 2


def test_weighted_crop_draws_beside_a_zero_region_of_wide_range_weights():
    """The port's own draws where the integral image rounds: weights over
    twelve orders of magnitude with a zero quadrant, whose window sums come
    out slightly below 0 before the clamp. The draw must not raise and
    must never put a crop wholly on the zero quadrant."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(np.exp(rng.normal(0.0, 6.0, (16, 1, 2, 48, 48))).astype(np.float32))
    w[..., 24:, 24:] = 0.0
    raw = window_sums(w.sum(dim=(1, 2)), 8, 8)
    assert (raw[:, 24:, 24:] < 0).any()
    t = T.BatchedRandWeightedCropd(keys=["weight"], w_key="weight", spatial_size=(2, 8, 8))
    d = t.draw({"weight": w}, torch.Generator().manual_seed(3))
    vx = 48 - 8 + 1
    ys, xs = d["index"] // vx, d["index"] % vx
    assert not ((ys >= 24) & (xs >= 24)).any()


@pytest.mark.parametrize("roi,n", [((4, 16, 16), 5), ((8, 24, 48), 2), ((2, 48, 48), 4)])
def test_tiled_crop_samples_are_bit_exact(roi, n):
    batch = _batch(5)
    jt = J.TiledSpatialCropSamplesd(keys=["source", "target"], roi_size=roi, num_samples=n)
    tt = T.TiledSpatialCropSamplesd(keys=["source", "target"], roi_size=roi, num_samples=n)
    want = jt({k: jnp.asarray(v) for k, v in batch.items()})
    got = tt({k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        for k in batch:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    with pytest.raises(ValueError):
        T.TiledSpatialCropSamplesd(keys=["source"], roi_size=(8, 48, 48), num_samples=2)(
            {"source": torch.zeros(1, 1, *STACK)})


ZOOM = [
    ((1.0, 0.5, 0.5), "trilinear", False),
    ((1.0, 0.5, 0.5), "trilinear", True),
    ((1.5, 1.3, 0.7), "bilinear", True),
    ((1.0, 0.6, 0.6), "bicubic", True),
    ((0.5, 2.0, 2.0), "bicubic", False),
    ((1.0, 0.33, 1.7), "area", False),
    ((1.0, 0.75, 1.25), "nearest", False),
    ((0.5, 1.5, 0.7), "nearest-exact", False),
    (0.5, "lanczos3", True),
]


@pytest.mark.parametrize("scale,mode,antialias", ZOOM, ids=[f"{m}-{a}-{s}" for s, m, a in ZOOM])
def test_zoom_matches_jax_image_resize(scale, mode, antialias):
    make = lambda ns: ns.BatchedZoomd(keys=["source", "target"], scale_factor=scale, mode=mode, antialias=antialias)
    want, got, _ = _run(make, _batch(6))
    for k in ("source", "target"):
        _assert_range_close(got[k], want[k])
    jz, tz = J.BatchedZoom(scale, mode, antialias=antialias), T.BatchedZoom(scale, mode, antialias=antialias)
    x = _batch(7)["target"].astype(np.float32)
    _assert_range_close(tz(torch.from_numpy(x)), jz(jnp.asarray(x)))


def test_zoom_refuses_an_unknown_method():
    with pytest.raises(ValueError):
        T.BatchedZoom(0.5, "bogus")


@pytest.mark.parametrize("strategy", ["mip", "center"])
def test_z_reduction_is_bit_exact(strategy):
    batch = _batch(8)
    batch["labelfree"] = np.array([True, False])
    for labelfree in (None, "labelfree"):
        make = lambda ns: ns.BatchedChannelWiseZReductiond(keys=["source", "target"], default_strategy=strategy,
                                                           labelfree_key=labelfree)
        want, got, _ = _run(make, batch)
        for k in ("source", "target"):
            assert got[k].shape == (2, batch[k].shape[1], 1, 48, 48)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        T.BatchedChannelWiseZReduction("median")


def test_stack_channels_and_decollate_are_bit_exact():
    rng = np.random.default_rng(9)
    per = {c: rng.random((1, *STACK), np.float32) for c in ("Phase", "Nuclei", "Membrane")}
    groups = dict(source=["Phase"], target=["Nuclei", "Membrane"])
    want = J.StackChannelsd(**groups)({k: jnp.asarray(v) for k, v in per.items()})
    got = T.StackChannelsd(**groups)({k: torch.from_numpy(v) for k, v in per.items()})
    host = T.StackChannelsd(**groups)(per)
    for k in ("source", "target"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(host[k], np.asarray(want[k]))
    batched = {c: rng.random((2, 1, *STACK), np.float32) for c in per}
    want = J.BatchedStackChannelsd(**groups)({k: jnp.asarray(v) for k, v in batched.items()})
    got = T.BatchedStackChannelsd(**groups)({k: torch.from_numpy(v) for k, v in batched.items()})
    assert got["target"].shape == (2, 2, *STACK)
    for k in ("source", "target"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    data = dict(_batch(10), label="x")
    want = J.Decollated()({k: jnp.asarray(v) if k != "label" else v for k, v in data.items()})
    got = T.Decollated()({k: torch.from_numpy(v) if k != "label" else v for k, v in data.items()})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["label"] == w["label"] == "x"
        for k in ("source", "target"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    only = T.Decollated(keys=["source"])({k: torch.from_numpy(v) for k, v in _batch(10).items()})
    assert only[0]["source"].shape == (1, *STACK) and only[0]["target"].shape == (2, 2, *STACK)
    parts = T.Decollate()(torch.from_numpy(data["target"]))
    assert [p.shape for p in parts] == [(2, *STACK)] * 2


def test_decollated_takes_a_single_key_name():
    """The JAX ``Decollated("source")`` iterates the string's letters and
    raises; the port takes the name as the one key."""
    data = _batch(11)
    with pytest.raises(KeyError):
        J.Decollated("source")({k: jnp.asarray(v) for k, v in data.items()})
    got = T.Decollated("source")({k: torch.from_numpy(v) for k, v in data.items()})
    assert got[1]["source"].shape == (1, *STACK)


SPATIAL_ARRAY = {
    "center-crop": (lambda ns: ns.BatchedCenterSpatialCrop(roi_size=(4, 30, 30)), None),
    "rand-crop": (lambda ns: ns.BatchedRandSpatialCrop(roi_size=(4, 30, 30)),
                  lambda ns: ns.BatchedRandSpatialCropd("img", roi_size=(4, 30, 30))),
    "flip": (lambda ns: ns.BatchedRandFlip(spatial_axes=(0, 1, 2), prob=0.5),
             lambda ns: ns.BatchedRandFlipd("img", spatial_axes=(0, 1, 2), prob=0.5)),
}


@pytest.mark.parametrize("make,dict_form", SPATIAL_ARRAY.values(), ids=SPATIAL_ARRAY.keys())
def test_spatial_array_variant_is_bit_exact(make, dict_form):
    x = _batch(12)["target"]
    jt, tt = make(J), make(T)
    if dict_form is None:
        want, got = jt(jnp.asarray(x)), tt(torch.from_numpy(x))
    else:
        key = jax.random.PRNGKey(13)
        draws = jax_draws(dict_form(J), {"img": jnp.asarray(x)}, key)
        want, got = jt(jnp.asarray(x), key), tt(torch.from_numpy(x), draws=draws)
        assert tt.is_random and tt(torch.from_numpy(x), torch.Generator()).shape == np.asarray(want).shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def params():
    from _torch_port_transform_fit import mini_params

    return mini_params()


def test_batched_device_pipeline_fits_like_the_jax_trainer(params, tmp_path, monkeypatch):
    """``viscy-torch fit`` with the shipped host weighted crop and every new
    batched member on the device (flip, affine, elastic, Z shift, histogram
    shift, sharpen, pixel shuffling, inversion, percentiles, contrast,
    noise), ``fg_mask`` joining the spatial members and feeding
    ``SpotlightLoss``: with the JAX trainer's draws, two steps land within
    2e-3 of range of the JAX trainer's (r > 0.9999)."""
    from _torch_port_transform_fit import CHANNELS, assert_steps_match, fit_both, fit_config, tiny_plate

    src, both = {"keys": ["source"]}, {"keys": ["source", "target"]}
    members = [
        ("BatchedRandFlipd", dict(both, prob=0.5)),
        ("BatchedRandAffined", dict(both, prob=0.8, rotate_range=[3.14, 0.0, 0.0],
                                    scale_range=[[1.0, 1.2], [0.8, 1.2], [0.8, 1.2]])),
        ("BatchedRand3DElasticd", dict(both, prob=0.8, sigma_range=[1.0, 2.0], magnitude_range=[1.0, 2.0])),
        ("BatchedRandZStackShiftd", dict(both, prob=0.8, max_shift=1)),
        ("BatchedRandHistogramShiftd", dict(src, prob=0.8)),
        ("BatchedRandSharpend", dict(src, prob=0.8, alpha=[0.5, 1.0])),
        ("BatchedRandLocalPixelShufflingd", dict(src, prob=0.8, num_blocks=4)),
        ("BatchedRandInvertIntensityd", dict(src, prob=0.5)),
        ("BatchedScaleIntensityRangePercentilesd", dict(src, lower=1, upper=99, b_min=0, b_max=1)),
        ("BatchedRandAdjustContrastd", dict(src, prob=0.5, gamma=[0.8, 1.2])),
        ("BatchedRandGaussianNoised", dict(src, prob=0.5, std=0.1)),
    ]
    crop = {"class_path": "viscy_tpu.data.host_transforms.HostRandWeightedCropd",
            "init_args": {"keys": CHANNELS + ["weight", "fg_mask_Nucleus", "fg_mask_Membrane"], "w_key": "weight",
                          "spatial_size": [5, 32, 32], "num_samples": 2}}
    augs = [crop] + [{"class_path": f"viscy_transforms.{n}", "init_args": kw} for n, kw in members]
    plate = tiny_plate(tmp_path / "plate.zarr", with_mask=True)
    spot = {"class_path": "viscy_utils.losses.SpotlightLoss", "init_args": {}}
    cfg = fit_config(tmp_path / "run", plate, augs, loss=spot, fg_mask_key="fg_mask")
    jtrainer, trainer, tmod, seen = fit_both(tmp_path, params, cfg, monkeypatch)
    assert seen == ["train"] * 2
    assert_steps_match(jtrainer, trainer, tmod)
