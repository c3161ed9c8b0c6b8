"""The port's host transforms (the classes behind the MONAI names of
``viscy_tpu_torch.transforms``) and its normalization helpers against
viscy_tpu, bit for bit: the same numpy-seeded per-channel (1, 8, 48, 48)
samples and the same ``numpy.random.Generator`` in both packages give the
same draws and the same arrays; then the MONAI-named host pipeline through
``viscy-torch fit`` against the JAX trainer's two steps."""

import numpy as np
import pytest

from viscy_tpu import transforms as J
from viscy_tpu.data import host_transforms as JH
from viscy_tpu.preprocess import normalize as jpn
from viscy_tpu.training import normalize as jtn
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.data import host_transforms as TH
from viscy_tpu_torch.preprocess import normalize as tpn
from viscy_tpu_torch.training import normalize as ttn

STACK = (8, 48, 48)
KEYS = ["Phase3D", "Nucleus", "Membrane"]


def _sample(seed):
    rng = np.random.default_rng(seed)
    out = {k: rng.random((1, *STACK), np.float32) for k in KEYS}
    out["weight"] = out["Nucleus"]
    out["norm_meta"] = {"Phase3D": {"fov_statistics": {"mean": 0.5}}}
    return out


def _same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


HOST = {
    "center-crop": lambda ns: ns.CenterSpatialCropd(keys=KEYS, roi_size=(4, 30, 60)),
    "rand-crop": lambda ns: ns.RandSpatialCropd(keys=KEYS, roi_size=(5, 20, 31)),
    "flip": lambda ns: ns.RandFlipd(keys=KEYS, spatial_axes=(0, 1, 2), prob=0.5),
    "weighted-crop": lambda ns: ns.RandWeightedCropd(keys=KEYS, w_key="weight", spatial_size=(4, 16, 16),
                                                     num_samples=3),
    "percentiles": lambda ns: ns.ScaleIntensityRangePercentilesd(keys=KEYS, lower=1, upper=99, b_min=0, b_max=1),
    "percentiles-channel-clip": lambda ns: ns.ScaleIntensityRangePercentilesd(
        keys=KEYS, lower=10, upper=90, b_min=-1, b_max=1, clip=True, channel_wise=True),
    "normalize": lambda ns: ns.NormalizeIntensityd(keys=KEYS),
    "contrast": lambda ns: ns.RandAdjustContrastd(keys=KEYS, prob=0.9, gamma=(0.7, 1.5)),
    "contrast-scalar-gamma": lambda ns: ns.RandAdjustContrastd(keys=KEYS[:1], prob=1.0, gamma=0.8),
    "scale": lambda ns: ns.RandScaleIntensityd(keys=KEYS, factors=0.3, prob=0.9),
    "scale-range": lambda ns: ns.RandScaleIntensityd(keys=KEYS, factors=(-0.1, 0.4), prob=1.0),
    "noise": lambda ns: ns.RandGaussianNoised(keys=KEYS, prob=0.9, std=0.2),
    "noise-fixed-std": lambda ns: ns.RandGaussianNoised(keys=KEYS[:2], prob=1.0, mean=0.1, std=0.2,
                                                        sample_std=False),
    "smooth": lambda ns: ns.RandGaussianSmoothd(keys=KEYS, prob=0.9),
    "smooth-3d": lambda ns: ns.RandGaussianSmoothd(keys=KEYS[1:], prob=1.0, sigma_z=(0.5, 1.0)),
    "affine": lambda ns: ns.RandAffined(keys=KEYS, prob=0.9, rotate_range=(3.14, 0.0, 0.0),
                                        scale_range=(0.1, 0.2, 0.2), shear_range=(0.1, 0.1, 0.1)),
    "affine-pair-ranges": lambda ns: ns.RandAffined(keys=KEYS[:1], prob=1.0, rotate_range=((-0.5, 0.5),),
                                                    scale_range=((0.0, 0.3), 0.1, (-0.2, 0.0))),
    "to-device": lambda ns: ns.ToDeviced(keys=KEYS, device="cuda"),
}


@pytest.mark.parametrize("make", HOST.values(), ids=HOST.keys())
def test_host_transform_is_bit_exact_under_the_same_generator(make):
    jt, tt = make(J), make(T)
    assert type(tt).__name__ == type(jt).__name__ and isinstance(tt, TH.HostTransform)
    for seed in range(3):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        _same(tt(_sample(seed), rt), jt(_sample(seed), rj))
        assert rt.random() == rj.random()  # both consumed the same draws


def test_monai_names_resolve_lazily_to_the_host_classes():
    for name, target in T._HOST_ALIASES.items():
        assert getattr(T, name) is getattr(TH, target)
        assert J._HOST_ALIASES[name] == target
    assert set(TH.__all__) - {"HostTransform"} == set(JH.__all__) | {"HostNormalizeIntensityd",
                                                                      "HostScaleIntensityRangePercentilesd"}
    with pytest.raises(AttributeError):
        T.RandZoomd  # noqa: B018


def test_the_reference_choices_are_kept():
    """Where the JAX host transforms depart from MONAI, the port does too."""
    assert T.RandAdjustContrastd(keys=KEYS, gamma=0.8).gamma == J.RandAdjustContrastd(keys=KEYS, gamma=0.8).gamma \
        == (0.8, 1.6)
    s = _sample(3)
    sheared = T.RandAffined(keys=KEYS, prob=1.0, shear_range=(0.5, 0.5, 0.5))(s, np.random.default_rng(0))
    plain = T.RandAffined(keys=KEYS, prob=1.0)(s, np.random.default_rng(0))
    _same(sheared, plain)  # shear_range is accepted and not used
    rot = T.RandAffined(keys=["Phase3D"], prob=1.0, rotate_range=(1.0, 0.0, 0.0))
    out = rot({"Phase3D": np.broadcast_to(_sample(4)["Phase3D"][:, :1], (1, *STACK)).copy()},
              np.random.default_rng(1))["Phase3D"]
    assert np.array_equal(out[:, 0], out[:, 5])  # a rotation about Z moves no voxel across Z


@pytest.mark.parametrize("seed", range(3))
def test_normalize_helpers_are_bit_exact(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(3.0, 2.0, (40, 56)).astype(np.float32)
    img[3, 4] = np.nan
    np.testing.assert_array_equal(tpn.zscore(img), jpn.zscore(img))
    np.testing.assert_array_equal(ttn.zscore(img, 1.5, 2.0), jtn.zscore(img, 1.5, 2.0))
    np.testing.assert_array_equal(tpn.unzscore(img, 0.3, 1.7), jpn.unzscore(img, 0.3, 1.7))
    # a supplied mean or std of 0 counts as not supplied, in both
    np.testing.assert_array_equal(tpn.zscore(img, 0.0, 2.0), jpn.zscore(img, 0.0, 2.0))
    np.testing.assert_array_equal(tpn.zscore(img, 0.0, 2.0), tpn.zscore(img, np.nanmean(img), 2.0))
    clean = np.nan_to_num(img)
    np.testing.assert_array_equal(ttn.hist_clipping(clean, 5, 95), jtn.hist_clipping(clean, 5, 95))
    for kw in (dict(), dict(kernel_size=9, clip_limit=0.02), dict(kernel_size=(10, 7), clip_limit=0.0, nbins=64)):
        np.testing.assert_array_equal(tpn.hist_adapteq_2d(clean, **kw), jpn.hist_adapteq_2d(clean, **kw))
    np.testing.assert_array_equal(ttn.hist_adapteq_2D(clean, 8, 0.03), jtn.hist_adapteq_2D(clean, 8, 0.03))
    np.testing.assert_array_equal(tpn.hist_adapteq_2D(clean), jpn.hist_adapteq_2D(clean))
    for bad in (dict(min_percentile=60, max_percentile=40), dict(min_percentile=1, max_percentile=101)):
        with pytest.raises(ValueError):
            tpn.hist_clipping(clean, **bad)
    with pytest.raises(ValueError):
        tpn.hist_adapteq_2d(clean, clip_limit=1.5)


MONAI_PIPELINE = [
    ("RandWeightedCropd", {"keys": KEYS + ["weight"], "w_key": "weight", "spatial_size": [5, 44, 44],
                           "num_samples": 2}),
    ("RandSpatialCropd", {"keys": KEYS, "roi_size": [5, 40, 40]}),
    ("RandAffined", {"keys": KEYS, "prob": 0.8, "rotate_range": [3.14, 0.0, 0.0], "scale_range": [0.0, 0.1, 0.1]}),
    ("CenterSpatialCropd", {"keys": KEYS, "roi_size": [5, 32, 32]}),
    ("RandFlipd", {"keys": KEYS, "spatial_axes": [1, 2], "prob": 0.5}),
    ("RandAdjustContrastd", {"keys": KEYS[:1], "prob": 0.5, "gamma": [0.8, 1.2]}),
    ("RandScaleIntensityd", {"keys": KEYS[:1], "factors": 0.3, "prob": 0.5}),
    ("RandGaussianNoised", {"keys": KEYS[:1], "prob": 0.5, "std": 0.1}),
    ("RandGaussianSmoothd", {"keys": KEYS[:1], "prob": 0.5}),
    ("ScaleIntensityRangePercentilesd", {"keys": KEYS[:1], "lower": 1, "upper": 99, "b_min": 0, "b_max": 1}),
    ("NormalizeIntensityd", {"keys": KEYS[1:]}),
    ("ToDeviced", {"keys": KEYS, "device": "cuda"}),
]


@pytest.fixture(scope="module")
def params():
    from _torch_port_transform_fit import mini_params

    return mini_params()


def test_monai_named_host_pipeline_fits_like_the_jax_trainer(params, tmp_path, monkeypatch):
    """``viscy-torch fit`` of a config naming every augmentation by its
    MONAI name (``viscy_transforms.RandAffined``, ...; all twelve aliases):
    the host pipeline gives both packages the same batches, so two steps
    land within 2e-3 of range of the JAX trainer's (r > 0.9999)."""
    from _torch_port_transform_fit import assert_steps_match, fit_both, fit_config, tiny_plate

    assert {name for name, _ in MONAI_PIPELINE} == set(T._HOST_ALIASES)
    augs = [{"class_path": f"viscy_transforms.{name}", "init_args": kw} for name, kw in MONAI_PIPELINE]
    plate = tiny_plate(tmp_path / "plate.zarr")
    cfg = fit_config(tmp_path / "run", plate, augs)
    jtrainer, trainer, tmod, seen = fit_both(tmp_path, params, cfg, monkeypatch)
    assert seen == ["train"] * 2
    assert_steps_match(jtrainer, trainer, tmod)
