"""The port's ``decorr.py`` and the compute leg of ``spectral_eval.py``
(``dynacell spectral-eval``) against the JAX package on the CPU, on seeded
blob images and a seeded 6-timepoint plate whose signal fades.

Tolerances:

- every ``decorr`` function and ``evaluate_position``'s every float
  column: relative 1e-8 against JAX's source evaluated in float64
  (``numpy_float64``; JAX casts to float32 at ``decorr.py:222,367,417`` and
  numpy 2 keeps the FFTs of float32 data in ``complex64``); resolutions
  (DCR, FSC, the cutoffs they give) and curve peaks' radii equal;
- against JAX as it runs (float32): within 1e-3 relative, resolutions
  equal on these images (none of their decorrelation peaks is a near tie,
  so JAX's float32 rounding moves no peak by a radius step); of a per-bin
  curve (FRC, DCR) at most a quarter of the bins differ by more (and by at
  most 0.05 of the curve's scale): those where JAX's float32 radii move the
  frequencies on a ring's edge into the next ring (``ROADMAP.md`` Queue 3,
  the dynacell evaluation's float32 fault); so the FRCW spectral PCCs,
  which weigh each ring by that curve, hold within 1e-2 of JAX as it runs;
- the CSV text is ``DataFrame.to_csv(index=False)``'s, the columns in JAX's
  order; ``slices.npz`` bit for bit.
"""

import math

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner
from scipy import ndimage

import viscy_tpu.apps.dynacell.eval.decorr as jd
import viscy_tpu.apps.dynacell.eval.spectral as js
import viscy_tpu.apps.dynacell.eval.spectral_eval as jse
import viscy_tpu_torch.apps.dynacell.eval.decorr as td
import viscy_tpu_torch.apps.dynacell.eval.spectral_eval as tse
from viscy_tpu_torch.apps.dynacell.__main__ import main as dynacell
from viscy_tpu_torch.zarr_io.store import TransformationMeta, open_ome_zarr

from _torch_port_helpers import numpy_float64

CPU = dict(device="cpu")
REL = 1e-8
SP3 = [0.3, 0.1, 0.1]
SP2 = [0.1, 0.1]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def blobs(shape, n: int, seed: int, noise: float = 0.05, sigma: float = 2.0) -> np.ndarray:
    """Seeded float64 image of ``n`` Gaussian blobs with noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros(shape)
    img[tuple(rng.integers(0, s, n) for s in shape)] = rng.uniform(0.5, 1.0, n)
    img = ndimage.gaussian_filter(img, sigma) * 20
    return img + noise * rng.standard_normal(shape)


def _pred(gt: np.ndarray, seed: int) -> np.ndarray:
    return ndimage.gaussian_filter(gt, 0.8) + 0.03 * np.random.default_rng(seed).standard_normal(gt.shape)


@pytest.fixture(scope="module")
def imgs():
    g2, g3 = blobs((64, 72), 30, 1), blobs((10, 48, 40), 40, 3)
    return dict(g2=g2, p2=_pred(g2, 2), g3=g3, p3=_pred(g3, 4))


def _value(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


CASES = {
    "otf_widefield": lambda m, i, **k: m.otf_cutoff(1.3, 0.52),
    "otf_confocal": lambda m, i, **k: m.otf_cutoff(1.3, 0.52, "confocal"),
    "lowpass": lambda m, i, **k: m.apply_lowpass(i["g3"], 0.3, SP3, **k),
    "psnr": lambda m, i, **k: m.psnr(i["g3"], i["p3"], **k),
    "psnr_masked": lambda m, i, **k: m.psnr(i["g3"], i["p3"], data_range=3.0,
                                            mask=i["g3"] > np.percentile(i["g3"], 40), **k),
    "ssim_2d": lambda m, i, **k: m.ssim(i["g2"], i["p2"], **k),
    "ssim_3d": lambda m, i, **k: m.ssim(i["g3"], i["p3"], data_range=2.0, win_size=5, **k),
    "dcr_2d": lambda m, i, **k: m.dcr_curve(i["p2"], SP2, **k)[0],
    "dcr_curves": lambda m, i, **k: m.dcr_curve(i["p2"], SP2, num_radii=60, num_highpass=6, **k)[2],
    "dcr_no_refine": lambda m, i, **k: m.dcr_curve(i["g2"], SP2, refine=False, windowing=False, **k)[0],
    "dcr_3d_xy": lambda m, i, **k: m.dcr_resolution(i["p3"], SP3, **k)["xy"],
    "dcr_3d_z": lambda m, i, **k: m.dcr_resolution(i["p3"], SP3, **k)["z"],
    "frc_one": lambda m, i, **k: m.calculate_frc(i["g2"], **k)["correlation"]["correlation"],
    "frc_no_average": lambda m, i, **k: m.calculate_frc(i["g2"], average=False, disable_hamming=True,
                                                        **k)["correlation"]["correlation"],
    "frc_two": lambda m, i, **k: m.calculate_frc(i["g3"], i["p3"], **k)["correlation"]["correlation"],
    "frc_frequency": lambda m, i, **k: m.calculate_frc(i["g2"], bin_delta=2.0, **k)["correlation"]["frequency"],
    "frc_weights": lambda m, i, **k: m.frc_weights(i["g2"], **k),
    "frcw": lambda m, i, **k: m.spectral_pcc_frcw(i["p2"], i["g2"], SP2, **k),
    "frcw_frozen": lambda m, i, **k: m.spectral_pcc_frcw(i["p2"], i["g2"], SP2,
                                                         frozen_weights=np.linspace(0, 1, 20)[::-1], **k),
    "cutoff_dcr": lambda m, i, **k: m.estimate_cutoff(i["p2"], SP2, **k),
    "cutoff_frc": lambda m, i, **k: m.estimate_cutoff(i["p2"], SP2, method="frc", **k),
    "cutoff_otf": lambda m, i, **k: m.estimate_cutoff(i["p2"], SP2, method="otf", numerical_aperture=1.3,
                                                      wavelength_emission=0.52, **k),
    "bl_pcc": lambda m, i, **k: m.band_limited_pcc(i["p3"], i["g3"], SP3, cutoff=2.0, **k),
    "bl_ssim": lambda m, i, **k: m.band_limited_ssim(i["p3"], i["g3"], SP3, cutoff=2.0, order=3, win_size=5, **k),
}
# equal to JAX's float64 source; DCR resolutions equal to JAX as it runs too
EXACT = {"otf_widefield", "otf_confocal", "dcr_2d", "dcr_no_refine", "dcr_3d_xy", "dcr_3d_z", "frc_frequency",
         "cutoff_dcr", "cutoff_frc", "cutoff_otf"}
# JAX's float32 frequencies: within float32's rounding of the float64 ones
FREQUENCIES = {"frc_frequency", "cutoff_frc"}
# per-bin curves: JAX's float32 radii move a frequency that sits on a ring's edge into the next ring
# (ROADMAP.md Queue 3, the float32 fault), so against JAX as it runs a few bins differ by more than 1e-3
CURVES = {"dcr_curves", "frc_one", "frc_no_average", "frc_two", "frc_weights"}


@pytest.mark.parametrize("name", list(CASES))
def test_decorr_matches_jax_in_float64_and_as_it_runs(imgs, name):
    fn = CASES[name]
    got = np.asarray(_value(fn(td, imgs, **CPU)), np.float64)
    with numpy_float64(jd, js):
        want64 = np.asarray(fn(jd, imgs), np.float64)
    want32 = np.asarray(fn(jd, {k: v.astype(np.float32) for k, v in imgs.items()}), np.float64)
    if name in EXACT:
        assert np.array_equal(got, want64), name
    else:
        assert _rel(got, want64) <= REL, (name, _rel(got, want64))
    if name in FREQUENCIES:
        assert _rel(got, want32) <= 1e-7, name
    elif name in CURVES:
        scale = np.abs(want32).max()
        off = np.abs(got - want32) > 1e-3 * scale
        assert off.mean() <= 0.25 and np.abs(got - want32).max() <= 0.05 * scale, (name, int(off.sum()), off.size)
    elif name in EXACT:
        assert np.array_equal(got, want32), name
    else:
        assert _rel(got, want32) <= 1e-3, (name, _rel(got, want32))


def test_dcr_peaks_and_the_decorrelation_curve_definition(imgs):
    """The peaks' radii are JAX's and their amplitudes within 1e-8; each
    curve value is the cosine of the spectrum and its phase-only copy over
    the frequencies at or below its radius (here summed by sorting, as JAX
    does)."""
    got = td.dcr_curve(imgs["p2"], SP2, **CPU)
    with numpy_float64(jd, js):
        want = jd.dcr_curve(imgs["p2"], SP2)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[3][:, 0], want[3][:, 0])
    assert _rel(got[3][:, 1], want[3][:, 1]) <= REL
    assert got[0] == want[0] and np.isfinite(got[0])
    img = imgs["p2"] - imgs["p2"].mean()
    with numpy_float64(js):
        fk = np.fft.fftn(js._APODIZATION_FNS["tukey"](img))
        r = js.radial_frequencies(img.shape, SP2) / min(0.5 / s for s in SP2)
    fk = np.where(r <= 1, fk, 0)
    for j in (0, 17, 63, 99):
        sel = r <= got[1][j]
        d = np.abs(fk[sel]).sum() / np.sqrt((np.abs(fk) ** 2).sum() * (np.abs(fk[sel]) > 0).sum())
        assert abs(got[2][0, j] - d) <= 1e-12 * d


def test_white_noise_has_no_resolution_and_the_shapes_are_refused():
    noise = np.random.default_rng(5).standard_normal((48, 48))
    res, radii, curves, peaks = td.dcr_curve(noise, **CPU)
    jres = jd.dcr_curve(noise)[0]
    assert res == jres and curves.shape == (11, 100) and peaks.shape == (11, 2) and len(radii) == 100
    for call in (lambda m, **k: m.dcr_curve(np.zeros(8), **k), lambda m, **k: m.dcr_resolution(np.zeros((2,) * 4), **k),
                 lambda m, **k: m.calculate_frc(np.zeros((4, 8, 8)), **k),
                 lambda m, **k: m.otf_cutoff(1.0, 0.5, "lightsheet"),
                 lambda m, **k: m.estimate_cutoff(noise, method="otf", **k),
                 lambda m, **k: m.estimate_cutoff(noise, method="sted", **k)):
        with pytest.raises(ValueError):
            call(jd)
        with pytest.raises(ValueError):
            call(td, **CPU)


# -- spectral_eval -------------------------------------------------------------------------------
T = 6
ZYX = (8, 40, 48)
CFG = {
    "channel": "Nucleus",
    "spacing": SP3,
    "fsc": {},
    "dcr": {"num_radii": 50, "num_highpass": 4},
    "spectral_pcc": {"bin_delta": 1.0, "nbins_low": 1, "tail_fraction": 0.2},
    "bandlimited": {"order": 2, "win_size": 5},
    "optics": {"numerical_aperture": 1.3, "wavelength_emission": 0.52},
}


def fading_series(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(T, Z, Y, X) float64 GT whose signal fades over time under constant
    noise (the DCR amplitude falls, so the reliability weights of the first
    and last five timepoints' levels are neither all 0 nor all 1), a few
    registration zeros at its border, and a prediction of it."""
    base = blobs(ZYX, 240, seed, noise=0.0, sigma=1.0)
    rng = np.random.default_rng(seed + 1)
    gt = np.stack([base * (1.0 - 0.15 * t) + 1.0 + 0.15 * rng.standard_normal(ZYX) for t in range(T)])
    gt[:, :, :2, :] = 0.0
    pred = np.stack([ndimage.gaussian_filter(base, 0.7) * (1.0 - 0.1 * t) + 1.0 for t in range(T)])
    return gt, pred


class _Pos:
    """A position whose ``.data`` is a (T, C, Z, Y, X) array."""

    def __init__(self, data: np.ndarray) -> None:
        self.data = data


@pytest.fixture(scope="module")
def series():
    gt, pred = fading_series(11)
    return gt, pred


def test_evaluate_position_matches_jax_in_float64(series):
    gt, pred = series
    got = tse.evaluate_position("A/1/0", _Pos(gt[:, None]), _Pos(pred[:, None]), 0, 0, SP3, CFG, **CPU)
    with numpy_float64(jse, jd, js):
        want = jse.evaluate_position("A/1/0", _Pos(gt[:, None]), _Pos(pred[:, None]), 0, 0, SP3, CFG)
    assert list(got[0]) == list(want.columns) and len(got) == len(want) == T
    assert want.columns[0] == "timepoint" and want.columns[-1] == "DCR_w"
    w = want["DCR_w"].to_numpy()
    assert w.min() < w.max()  # the weights are not trivial
    exact = [c for c in want.columns if c.startswith(("DCR_", "FSC_")) and c not in ("DCR_A0", "DCR_w")]
    assert {"DCR_XY", "DCR_Z", "DCR_2D", "FSC_XY", "FSC_GT_Z", "DCR_r0"} <= set(exact)
    for c in want.columns:
        col = np.array([r[c] for r in got], np.float64)
        ref = want[c].to_numpy(np.float64)
        if c in exact or c == "timepoint":
            assert np.array_equal(col, ref, equal_nan=True), c
        else:
            assert np.isfinite(ref).all(), c
            assert _rel(col, ref) <= REL, (c, _rel(col, ref))


def _plate(path, gt: np.ndarray, name: str, scale=None):
    plate = open_ome_zarr(path, layout="hcs", mode="w", channel_names=[name])
    for fov, data in (("0", gt), ("1", gt[:, :, ::-1])):
        tf = [TransformationMeta(scale=scale)] if scale else None
        plate.create_position("A", "1", fov).create_image("0", np.ascontiguousarray(data[:, None], np.float32),
                                                          transform=tf)
    return path


def test_compute_writes_jax_columns_csv_text_and_slices(series, tmp_path):
    """``spectral-eval --mode compute`` through the CLI on a two-position GT
    plate and a prediction plate: the store's scale gives the spacing; one
    position selected; ``metrics.csv`` is the text pandas writes for the
    port's rows, with JAX's columns in JAX's order and its values within
    1e-3 of JAX as it runs; ``slices.npz`` equals JAX's."""
    gt, pred = series
    gt_path = _plate(tmp_path / "gt.zarr", gt, "Nucleus", scale=[1.0, 1.0, *SP3])
    pred_path = _plate(tmp_path / "pred.zarr", pred, "Nucleus_prediction")
    cfg = dict(CFG, input_zarr=str(gt_path), pred_zarr=str(pred_path), gt_channel="Nucleus",
               pred_channel="Nucleus_prediction", positions=["A/1/1"], spacing=[1.0, 1.0, 1.0])
    for out, mod in (("port", None), ("jax", jse)):
        c = dict(cfg, output_dir=str(tmp_path / out), mode="compute")
        if mod is None:
            import yaml

            path = tmp_path / "spectral.yml"
            path.write_text(yaml.safe_dump(c))
            r = CliRunner().invoke(dynacell, ["--device", "cpu", "spectral-eval", "-c", str(path)])
            assert r.exit_code == 0, r.output + repr(r.exception)
        else:
            mod.main(c)
    got_dir, want_dir = tmp_path / "port" / "A/1/1", tmp_path / "jax" / "A/1/1"
    assert not (tmp_path / "port" / "A/1/0").exists()
    text = (got_dir / "metrics.csv").read_text()
    got = pd.read_csv(got_dir / "metrics.csv", float_precision="round_trip")
    want = pd.read_csv(want_dir / "metrics.csv", float_precision="round_trip")
    assert list(got.columns) == list(want.columns) and len(got) == T
    assert text == got.to_csv(index=False)
    rows = tse.evaluate_position("A/1/1", open_ome_zarr(gt_path)["A/1/1"], open_ome_zarr(pred_path)["A/1/1"], 0, 0,
                                 SP3, CFG, **CPU)
    assert text == pd.DataFrame(rows).to_csv(index=False) == tse.rows_to_csv(rows)
    for c in want.columns:
        a, b = got[c].to_numpy(np.float64), want[c].to_numpy(np.float64)
        # the FRCW metrics weigh each ring by the one-image FRC, whose float32 rings JAX fills differently
        rel = 1e-2 if "FRCW" in c else 1e-3
        assert np.allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-12), equal_nan=True), c
    with np.load(got_dir / "slices.npz") as g, np.load(want_dir / "slices.npz") as w:
        assert sorted(g.files) == sorted(w.files) == ["gt", "labels", "pred"]
        for k in g.files:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert g["labels"].tolist() == ["t=0", "t=3", "t=5"]


def test_plot_and_all_are_refused_before_any_work(tmp_path):
    cfg = dict(CFG, input_zarr=str(tmp_path / "missing.zarr"), output_dir=str(tmp_path / "out"))
    for mode in ("plot", "all"):
        with pytest.raises(NotImplementedError, match="matplotlib.*Queue 1 item 9"):
            tse.main(dict(cfg, mode=mode), **CPU)
    with pytest.raises(ValueError, match="Unknown mode"):
        tse.main(dict(cfg, mode="draw"), **CPU)
    assert not (tmp_path / "out").exists()


def test_reliability_weights_and_helpers_match_jax():
    for a0 in (np.array([0.5, 0.5, 0.45, 0.4, 0.3, 0.2, 0.1, 0.1]), np.array([0.0, 0.1, 0.2]),
               np.array([0.3, 0.3, 0.3]), np.array([0.5, 0.4, np.nan, 0.1, 0.05, 0.05, 0.0])):
        assert np.array_equal(tse.dcr_reliability_weights(a0), jse.dcr_reliability_weights(a0), equal_nan=True)
    rng = np.random.default_rng(3)
    a, b = rng.random((6, 7)), rng.random((6, 7))
    mask = a > 0.3
    for m in (None, mask):
        assert abs(tse.corr_coef(a, b, None if m is None else torch.as_tensor(m), **CPU) - jse.corr_coef(a, b, m)) \
            <= 1e-12
    assert math.isnan(tse.corr_coef(np.ones(5), np.arange(5.0), **CPU))
    frames = [blobs((32, 40), 10, s) for s in range(3)]
    with numpy_float64(jse, jd, js):
        want = jse.compute_frozen_frcw_weights(frames, {"frcw_nbins_low": 2})
        want_rel = jse.compute_gt_reliability(frames[0], SP2, {"num_radii": 40})
    got = tse.compute_frozen_frcw_weights(frames, {"frcw_nbins_low": 2}, **CPU)
    assert _rel(got, want) <= REL and np.all(got[:2] == 0)
    got_rel = tse.compute_gt_reliability(frames[0], SP2, {"num_radii": 40}, **CPU)
    assert got_rel[1] == want_rel[1] and abs(got_rel[0] - want_rel[0]) <= REL * want_rel[0]
    assert tse.compute_gt_reliability(np.zeros((16, 16)), SP2, {}, **CPU) == (0.0, 0.0)
