"""The port's dynacell pixel and mask tiers against the JAX package on the
CPU: segmentation, ``spectral.py``, ``metrics.py``, the GLCM helpers and
``instance_metrics.py``, on seeded nucleus-like volumes.

Tolerances:

- segmentation, instances, CP features, GLCM, the crops, the per-cell
  similarities and instance AP: bit-identical (host numpy and scipy in
  both; ``._ndimage``, the filters and distance transform the port runs on
  a CUDA device, is held against scipy on the CPU bit for bit);
- PCC, and ``ssim3d`` itself: relative 1e-8 against JAX as it runs (both
  float64). Inside ``compute_pixel_metrics`` JAX min-max normalizes the
  volumes in float32 first: its SSIM, NRMSE and PSNR hold within 1e-6 of
  the port's and within 1e-8 in float64;
- spectral PCC, band-limited PCC, the multiband score, FSC resolution and
  the power spectrum: relative 1e-8 against JAX's source evaluated in
  float64 (``numpy_float64``). JAX as it runs computes them in float32
  (numpy 2 keeps float32 through the casts, the ``complex64`` FFT and the
  means and dots), and its float32 radial bin ids put a voxel that sits on a
  bin edge (``k / df`` an exact integer, as at ``k = 0.25``, ``df = 1/24``)
  in the lower bin: against it the continuous metrics hold within 1e-3 and
  an FSC resolution within one bin.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import viscy_tpu.apps.dynacell.eval.instance_metrics as jinst
import viscy_tpu.apps.dynacell.eval.metrics as jm
import viscy_tpu.apps.dynacell.eval.segmentation as jseg
import viscy_tpu.apps.dynacell.eval.spectral as js
import viscy_tpu.evaluation.feature as jfeat
import viscy_tpu_torch.apps.dynacell.eval.instance_metrics as tinst
import viscy_tpu_torch.apps.dynacell.eval.metrics as tm
import viscy_tpu_torch.apps.dynacell.eval.segmentation as tseg
import viscy_tpu_torch.apps.dynacell.eval.spectral as ts
import viscy_tpu_torch.evaluation.feature as tfeat
from _torch_port_helpers import numpy_float64

CPU = dict(device="cpu")
REL = 1e-8


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-300)


def nuclei(shape, n: int, seed: int, noise: float = 0.03) -> np.ndarray:
    """Seeded float32 volume (or image) of ``n`` blurred ellipsoidal nuclei
    with Gaussian noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.float32)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    for _ in range(n):
        centre = [rng.uniform(0, s) for s in shape]
        radii = [rng.uniform(1.5, 3.0) if (len(shape) == 3 and a == 0) else rng.uniform(4.0, 7.0)
                 for a in range(len(shape))]
        r2 = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, centre, radii))
        img += (r2 <= 1.0) * rng.uniform(0.6, 1.0)
    img = ndimage.gaussian_filter(img, 1.0)
    return (img + noise * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def vols():
    """(gt, prediction) pairs: a deep 3-D stack, a thin one and a 2-D image."""
    out = {}
    for name, shape, n in (("deep", (12, 48, 56), 14), ("thin", (4, 40, 48), 10), ("flat", (40, 48), 6)):
        gt = nuclei(shape, n, seed=len(name))
        pred = (ndimage.gaussian_filter(gt, 0.7) + 0.05 * np.random.default_rng(9).standard_normal(shape))
        out[name] = (gt, pred.astype(np.float32))
    return out


# -- segmentation -----------------------------------------------------------------
DEVICES = [None, "cpu"]  # both take scipy: the port's filters run on a CUDA device only


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", ["deep", "thin", "flat"])
@pytest.mark.parametrize("target", ["nucleus", "membrane", "lysosomes", "er"])
def test_semantic_segmentation_is_bit_identical(vols, name, target, device):
    img = vols[name][0]
    got, want = tseg.segment(img, target, device=device), jseg.segment(img, target)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", ["deep", "thin", "flat"])
def test_nucleus_instances_are_bit_identical(vols, name, device):
    for img in vols[name]:
        got = tseg.segment_nucleus_instances(img, [2.0, 0.5, 0.5], backend="native", device=device)
        want = jseg.segment_nucleus_instances(img, [2.0, 0.5, 0.5], backend="native")
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
        assert got.max() > 1
        reused = tseg.segment_nucleus_instances(img, mask=tseg.segment(img, "nucleus"), device=device)
        assert np.array_equal(reused, want)


@pytest.mark.parametrize("shape", [(6, 40, 50), (20, 64, 72), (1, 30, 30), (3, 2, 9), (40, 60)])
def test_device_filters_equal_scipy(shape):
    """:mod:`._ndimage` against scipy on the CPU: bit for bit."""
    from viscy_tpu_torch.apps.dynacell.eval import _ndimage as nd

    rng = np.random.default_rng(sum(shape))
    x = ndimage.gaussian_filter(rng.random(shape), 1.5)
    for thr in (0.45, 0.5, 0.55):
        for mask in (x > thr, x < thr):
            np.testing.assert_array_equal(nd.binary_fill_holes(mask), ndimage.binary_fill_holes(mask))
            if mask.any() and not mask.all():
                np.testing.assert_array_equal(nd.distance_transform_edt(mask, "cpu"),
                                              ndimage.distance_transform_edt(mask))
    only = np.ones(shape, bool)
    only.flat[0] = False
    np.testing.assert_array_equal(nd.distance_transform_edt(only, "cpu"), ndimage.distance_transform_edt(only))
    for dtype in (np.float32, np.float64):
        a = x.astype(dtype)
        t = torch.from_numpy(a)
        for sigma in (1.0, 0.5):
            np.testing.assert_array_equal(nd.gaussian_filter(t, sigma).numpy(), ndimage.gaussian_filter(a, sigma))
        for size in (11, 5, 4, 1):
            np.testing.assert_array_equal(nd.maximum_filter(t, size).numpy(), ndimage.maximum_filter(a, size=size))
            np.testing.assert_array_equal(nd.minimum_filter(t, size).numpy(), ndimage.minimum_filter(a, size=size))
        np.testing.assert_array_equal(nd.white_tophat(t, 5).numpy(), ndimage.white_tophat(a, size=5))
        for ax in range(len(shape)):
            np.testing.assert_array_equal(nd.sobel(t, ax).numpy(), ndimage.sobel(a, axis=ax, mode="reflect"))
        np.testing.assert_array_equal(nd.laplace(t).numpy(), ndimage.laplace(a, mode="reflect"))


def test_the_watershed_floods_across_the_x_faces_as_scipy_does():
    """scipy's ``watershed_ift`` takes flat-index neighbours (``+-1`` along X
    with no bound per axis), so a voxel on the last column neighbours the
    next row's first: here two mask components that touch only at a
    corner get one seed's label, in JAX and in the port alike. The port
    keeps it to keep JAX's bits (``ROADMAP.md`` Queue 3)."""
    mask = np.array([[False, True], [True, False]])
    cost = np.array([[2.0, 1.0], [2.0, 3.0]])
    seeds = np.array([[0, 0], [1, 0]], np.int32)
    want = jseg.watershed(cost, seeds, mask=mask)
    assert np.array_equal(want, [[0, 1], [1, 0]])
    assert np.array_equal(tseg.watershed(cost, seeds, mask=mask), want)
    assert ndimage.label(mask)[1] == 2


def test_multi_otsu_and_the_refusals():
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.normal(0, 0.1, 500), rng.normal(1, 0.1, 500), rng.normal(2, 0.1, 500)])
    assert tseg.multi_otsu_thresholds(vals) == jseg.multi_otsu_thresholds(vals)
    assert tseg.multi_otsu_thresholds(np.ones(9)) == jseg.multi_otsu_thresholds(np.ones(9))
    with pytest.raises(ValueError, match="Unsupported target_name"):
        tseg.segment(vals.reshape(30, 50), "golgi")
    for call in (lambda: tseg.segment(vals.reshape(30, 50), "nucleus", backend="cellpose"),
                 lambda: tseg.segment_nucleus_instances(vals.reshape(30, 50), backend="cellpose"),
                 lambda: tseg.prepare_segmentation_model({"segmentation": {"backend": "cellpose"}})):
        with pytest.raises(NotImplementedError, match="cellpose"):
            call()
    assert tseg.prepare_segmentation_model({"segmentation": {"backend": "native"}}) is None


# -- spectral ---------------------------------------------------------------------
SPACING = {"deep": [2.0, 0.5, 0.5], "thin": [2.0, 0.5, 0.5], "flat": [0.5, 0.5]}
SPCC_KW = [dict(), dict(weighting="wiener"), dict(weighting="snr_squared", nbins_low=2),
           dict(weighting="log_snr", taper_low=3, smooth=True), dict(cutoff=0.6, apodization="none"),
           dict(noise_floor=1e-3, bin_delta=2.0)]


@pytest.mark.parametrize("name", ["deep", "flat"])
@pytest.mark.parametrize("kw", SPCC_KW, ids=lambda kw: ",".join(kw) or "default")
def test_spectral_pcc(vols, name, kw):
    gt, pred = vols[name]
    got = ts.spectral_pcc(pred, gt, SPACING[name], **kw, **CPU)
    with numpy_float64(js):
        want = js.spectral_pcc(pred.astype(np.float64), gt.astype(np.float64), SPACING[name], **kw)
    assert _rel(got, want) <= REL, (got, want)
    assert _rel(got, js.spectral_pcc(pred, gt, SPACING[name], **kw)) <= 1e-3


@pytest.mark.parametrize("name", ["deep", "flat"])
def test_power_spectrum_noise_floor_and_band_pcc(vols, name):
    gt, pred = vols[name]
    sp = SPACING[name]
    r, p = ts.radial_power_spectrum(gt, sp, **CPU)
    with numpy_float64(js):
        rj, pj = js.radial_power_spectrum(gt.astype(np.float64), sp)
        nf = js.estimate_gt_noise_floor(np.where(gt > 0.2, gt, 0).astype(np.float64), sp)
        band = js.band_limited_pcc(pred.astype(np.float64), gt.astype(np.float64), sp, k_lo=0.1, k_hi=0.6)
    np.testing.assert_array_equal(r, rj)
    # the DC bin of a mean-centred image is rounding noise: held to REL of the peak bin
    np.testing.assert_allclose(p, pj, rtol=REL, atol=REL * pj.max())
    assert _rel(ts.estimate_gt_noise_floor(np.where(gt > 0.2, gt, 0), sp, **CPU), nf) <= REL
    assert _rel(ts.band_limited_pcc(pred, gt, sp, k_lo=0.1, k_hi=0.6, **CPU), band) <= REL
    assert ts.band_limited_pcc(pred, gt, sp, k_lo=50.0, k_hi=60.0, **CPU) == 0.0
    w = {k: f(r, p, 0.5 * p.mean()) for k, f in ts._WEIGHTING_FNS.items()}
    with numpy_float64(js):
        for k, f in js._WEIGHTING_FNS.items():
            np.testing.assert_allclose(w[k][1:], f(rj, pj, 0.5 * pj.mean())[1:], rtol=REL, atol=0)


@pytest.mark.parametrize("name", ["deep", "thin", "flat"])
@pytest.mark.parametrize("corrected", [True, False])
def test_multiband_ev_score(vols, name, corrected):
    gt, pred = vols[name]
    sp = SPACING[name]
    got, got_d = ts.multiband_ev_score(pred, gt, sp, noise_corrected=corrected, **CPU)
    with numpy_float64(js):
        want, want_d = js.multiband_ev_score(pred.astype(np.float64), gt.astype(np.float64), sp,
                                             noise_corrected=corrected)
    assert _rel(got, want) <= REL and got_d.keys() == want_d.keys()
    for band, d in want_d.items():
        if isinstance(d, dict):
            assert got_d[band]["n_keep"] == d["n_keep"]
            for k in ("EV", "score", "sigma2", "var"):
                assert abs(got_d[band][k] - d[k]) <= REL * max(abs(d[k]), 1e-12), (band, k)
    assert _rel(got, js.multiband_ev_score(pred, gt, sp, noise_corrected=corrected)[0]) <= 1e-3
    tiny = np.arange(9.0).reshape(3, 3)
    assert ts.trimmed_mad_sigma2(tiny, **CPU) == pytest.approx(js.trimmed_mad_sigma2(tiny), rel=1e-15)


def _bin_width(shape, spacing, halves: bool) -> float:
    """The radial bin width (cycles / unit) of an FSC over ``shape``."""
    shape, spacing = list(shape), list(spacing)
    if halves:
        shape[-2:] = [s // 2 for s in shape[-2:]]
        spacing[-2:] = [2 * d for d in spacing[-2:]]
    return min(1.0 / (n * d) for n, d in zip(shape, spacing))


@pytest.mark.parametrize("name", ["deep", "thin", "flat"])
def test_fsc_resolution(vols, name):
    gt, pred = vols[name]
    sp = SPACING[name]
    for p in (pred, None):
        got = ts.fsc_resolution(gt, p, sp, **CPU)
        with numpy_float64(js):
            want = js.fsc_resolution(gt.astype(np.float64), None if p is None else p.astype(np.float64), sp)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=REL), k
        raw = js.fsc_resolution(gt, p, sp)
        df = _bin_width(gt.shape, sp, p is None)
        for k in raw:  # JAX's float32 bins: the crossing within one bin
            assert got[k] == raw[k] or abs(1 / got[k] - 1 / raw[k]) <= df * (1 + 1e-6), (k, got, raw)


# -- pixel metrics ------------------------------------------------------------------
@pytest.mark.parametrize("name", ["deep", "thin"])
def test_compute_pixel_metrics(vols, name):
    gt, pred = vols[name]
    kw = dict(spacing=SPACING[name], fsc_kwargs={}, spectral_pcc_kwargs={}, multiband_ev=True)
    got = tm.compute_pixel_metrics(pred, gt, **kw, **CPU)
    with numpy_float64(js, jm):
        want = jm.compute_pixel_metrics(pred.astype(np.float64), gt.astype(np.float64), **kw)
    raw = jm.compute_pixel_metrics(pred, gt, **kw)
    assert list(got) == list(want) == list(raw)
    for k in want:
        assert _rel(got[k], want[k]) <= REL, k
    assert _rel(got["PCC"], raw["PCC"]) <= REL  # float64 in JAX as it runs, too
    # JAX min-max normalizes in float32 before its float64 SSIM and MSE
    for k in ("SSIM", "NRMSE", "PSNR"):
        assert _rel(got[k], raw[k]) <= 1e-6, k
    assert list(tm.compute_pixel_metrics(pred, gt, **CPU)) == ["PCC", "SSIM", "NRMSE", "PSNR"]
    mask = gt > 0.3
    assert _rel(tm.pcc(gt, pred, mask=mask, **CPU), jm.pcc(gt, pred, mask=mask)) <= REL
    assert np.isnan(tm.pcc(gt, pred, mask=np.zeros_like(mask), **CPU))


@pytest.mark.parametrize("shape,win", [((3, 20, 24), 7), ((4, 9, 30), 7), ((2, 40, 40), 5), ((30, 26), 7)])
@pytest.mark.parametrize("variant", ["plain", "masked", "scale_invariant"])
def test_ssim3d_reflect_edges_thinner_than_the_window(shape, win, variant):
    """The window clips per axis to the array (an even 4 or 2 is scipy's
    asymmetric [i - s//2, i + s - 1 - s//2]); the boundary is ``reflect``."""
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape)
    y = 0.7 * x + 0.3 * rng.random(shape)
    kw = dict(win_size=win)
    if variant != "plain":
        kw["mask"] = x > 0.3
    if variant == "scale_invariant":
        kw["scale_invariant"] = True
    got = tm.ssim3d(x, y, **kw, **CPU)
    want = jm.ssim3d(x, y, **kw)
    assert _rel(got, want) <= REL
    size = tuple(min(win, s) for s in shape)
    t = tm.uniform_filter(tm.on(x, tm.resolve_device("cpu")), size).numpy()
    np.testing.assert_allclose(t, ndimage.uniform_filter(x, size), rtol=1e-12, atol=1e-15)


# -- host tiers: bit-identical --------------------------------------------------------
@pytest.fixture(scope="module")
def labelled(vols):
    gt, pred = vols["deep"]
    return gt, pred, jseg.segment_nucleus_instances(gt)


def test_evaluate_segmentations_is_bit_identical(vols):
    gt, pred = vols["deep"]
    a, b = tseg.segment(pred, "nucleus"), tseg.segment(gt, "nucleus")
    assert tm.evaluate_segmentations(a, b) == jm.evaluate_segmentations(a, b)
    assert tm.evaluate_segmentations(a, np.zeros_like(a)) == jm.evaluate_segmentations(a, np.zeros_like(a))
    with pytest.raises(ValueError, match="Shape mismatch"):
        tm.evaluate_segmentations(a, b[:1])


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("glcm", [None, {"enabled": True}, {"enabled": True, "levels": 16, "distances": [1, 2]}])
def test_cp_regionprops_is_bit_identical(labelled, glcm, device):
    gt, pred, labels = labelled
    for img in (gt, pred):
        got = tm.cp_regionprops(img, labels, glcm_cfg=glcm, device=device)
        want = jm.cp_regionprops(img, labels, glcm_cfg=glcm)
        assert got.shape == want.shape and got.shape[0] == len(np.unique(labels)) - 1
        np.testing.assert_array_equal(got, want)
    empty = tm.cp_regionprops(gt, np.zeros(gt.shape, np.int32), glcm_cfg=glcm)
    assert empty.shape == jm.cp_regionprops(gt, np.zeros(gt.shape, np.int32), glcm_cfg=glcm).shape
    assert tm.active_cp_feature_names(True) == jm.active_cp_feature_names(True)


def test_per_cell_similarity_is_bit_identical(labelled):
    gt, pred, labels = labelled
    holes = np.where(labels == 3, 0, labels)  # a label id missing from the sequence
    for lab in (labels, holes):
        for metrics in (("pcc",), ("pcc", "ssim"), ("ssim",)):
            got = tm.per_cell_similarity(pred, gt, lab, metrics=metrics)
            want = jm.per_cell_similarity(pred, gt, lab, metrics=metrics)
            assert list(got) == list(want)
            np.testing.assert_array_equal(np.array(list(got.values())), np.array(list(want.values())))
    got = tm.per_cell_similarity(pred, gt, labels, metrics=("pcc", "ssim"), reduce=("median",), z_slab=slice(2, 9))
    want = jm.per_cell_similarity(pred, gt, labels, metrics=("pcc", "ssim"), reduce=("median",), z_slab=slice(2, 9))
    assert list(got) == list(want)
    np.testing.assert_array_equal(np.array(list(got.values())), np.array(list(want.values())))
    with pytest.raises(ValueError, match="cell_similarity.metrics"):
        tm.per_cell_similarity(pred, gt, labels, metrics=("mse",))


@pytest.mark.parametrize("patch", [16, 24, 64])
def test_build_crops_is_bit_identical(labelled, patch):
    gt, pred, labels = labelled
    for img in (gt, pred):
        got, want = tm.build_crops(img, labels, patch), jm.build_crops(img, labels, patch)
        assert len(got) == len(want) == len(np.unique(labels)) - 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape == (patch, patch)
            np.testing.assert_array_equal(a, b)
    got = tm.build_crops(gt, labels, patch, z_slab=slice(3, 8))
    want = jm.build_crops(gt, labels, patch, z_slab=slice(3, 8))
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    from viscy_tpu_torch.apps.dynacell.eval.features import RandomProjectionExtractor

    rp = RandomProjectionExtractor(patch, dim=8, seed=3)
    np.testing.assert_array_equal(tm.features_from_crops(got, rp), jm.features_from_crops(want, rp))
    np.testing.assert_array_equal(tm.deep_features(gt, labels, rp, patch), jm.deep_features(gt, labels, rp, patch))
    assert tm.features_from_crops([], rp).shape == (0, 0)


@pytest.mark.parametrize("offset", [(0, 1), (1, 0), (2, 2), (1, -1), (0, -3)])
def test_glcm_helpers_are_bit_identical(offset):
    img = np.random.default_rng(abs(offset[0] * 7 + offset[1])).integers(0, 32, (21, 17)).astype(np.uint8)
    got, want = tfeat._glcm(img, offset, levels=32), jfeat._glcm(img, offset, levels=32)
    np.testing.assert_array_equal(got, want)
    assert tfeat._glcm_props(got) == jfeat._glcm_props(want)


def test_glcm_of_a_crop_as_narrow_as_the_offset():
    """JAX's ``_glcm`` slices its second view to ``w + min(0, dx) or w``: for
    a crop exactly |dx| wide the end 0 becomes w, the two views differ in
    shape and ``np.stack`` raises, so a one-pixel-wide cell fails JAX's CP
    features with GLCM. The port counts no pair for that offset."""
    img = np.random.default_rng(0).integers(0, 32, (7, 1)).astype(np.uint8)
    with pytest.raises(ValueError, match="same shape"):
        jfeat._glcm(img, (1, -1), levels=32)
    assert not tfeat._glcm(img, (1, -1), levels=32).any()
    np.testing.assert_array_equal(tfeat._glcm(img, (1, 0), levels=32), jfeat._glcm(img, (1, 0), levels=32))
    labels = np.zeros((9, 12), np.int32)
    labels[2:8, 5] = 1  # one column wide
    labels[1:5, 1:4] = 2
    with pytest.raises(ValueError, match="same shape"):
        jm.cp_regionprops(np.random.default_rng(1).random((9, 12)), labels, glcm_cfg={"enabled": True})
    got = tm.cp_regionprops(np.random.default_rng(1).random((9, 12)), labels, glcm_cfg={"enabled": True})
    want = jm.cp_regionprops(np.random.default_rng(1).random((9, 12)), labels)
    np.testing.assert_array_equal(got[:, :want.shape[1]], want)


def test_instance_average_precision_is_bit_identical(labelled, vols):
    gt, pred, labels = labelled
    pred_labels = jseg.segment_nucleus_instances(pred)
    shifted = np.where(pred_labels > 0, pred_labels + 1000, 0)  # sparse ids
    negative = np.where(pred_labels > 0, pred_labels, -1)  # no background 0
    empty = np.zeros_like(labels)
    for a, b in ((pred_labels, labels), (shifted, labels), (labels, labels), (negative, labels), (empty, labels),
                 (labels, empty), (empty, empty), (pred_labels[5], labels[5])):
        got, want = tinst.instance_average_precision(a, b), jinst.instance_average_precision(a, b)
        assert list(got) == list(want)
        np.testing.assert_array_equal(np.array(list(got.values()), float), np.array(list(want.values()), float))
    assert tinst.instance_average_precision(pred_labels, labels, iou_thresholds=(0.3, 0.7)) == \
        jinst.instance_average_precision(pred_labels, labels, iou_thresholds=(0.3, 0.7))
    assert tinst.instance_average_precision(pred_labels, labels, iou_thresholds=(0.0, 0.5)) == \
        jinst.instance_average_precision(pred_labels, labels, iou_thresholds=(0.0, 0.5))


def test_instance_ap_of_many_fragments_is_bit_identical():
    """A prediction of many small fragments (most overlapping no GT object):
    the port assigns only the overlapping objects; the counts are JAX's."""
    rng = np.random.default_rng(4)
    gt = np.zeros((60, 80), np.int32)
    for k in range(1, 13):
        y, x = rng.integers(0, 52), rng.integers(0, 72)
        gt[y:y + 8, x:x + 8] = k
    frag = ndimage.label(rng.random((60, 80)) > 0.55)[0]
    frag[gt == 5] = 10_000  # one GT object predicted whole
    for pred in (frag, np.where(gt > 0, gt + 7, frag)):
        got, want = tinst.instance_average_precision(pred, gt), jinst.instance_average_precision(pred, gt)
        assert list(got) == list(want)
        np.testing.assert_array_equal(np.array(list(got.values()), float), np.array(list(want.values()), float))
        assert got["n_pred"] > 100
