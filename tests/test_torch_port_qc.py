"""QC in the port (``viscy_tpu_torch.apps.qc`` and the zattrs models of
``viscy_tpu_torch.apps.airtable_utils.schemas``) against viscy_tpu.

The same seeded plates, written by the port's writer (uncompressed, so the
JAX reader reads them too), are copied and run through
``python -m viscy_tpu.apps.qc.cli run -c`` and
``python -m viscy_tpu_torch.apps.qc.cli run -c ... --device cpu``; every
``.zattrs`` (the plate's and each position's) must be equal as JSON dicts,
and the port's output is read back with the JAX reader. Focus indices are
equal integers; band powers within 1e-5 relative (float32 FFTs). The
models' ``model_dump()`` equals pydantic's for the same input, and an input
pydantic rejects raises ``ValueError`` here.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner
from scipy.ndimage import gaussian_filter

from viscy_tpu.apps.airtable_utils import schemas as jschemas
from viscy_tpu.apps.qc import annotation as jannotation
from viscy_tpu.apps.qc import cli as jcli
from viscy_tpu.apps.qc import config as jconfig
from viscy_tpu.apps.qc import focus as jfocus
from viscy_tpu.zarr_io.store import open_ome_zarr as jopen
from viscy_tpu_torch.apps.airtable_utils import schemas as tschemas
from viscy_tpu_torch.apps.qc import annotation as tannotation
from viscy_tpu_torch.apps.qc import cli as tcli
from viscy_tpu_torch.apps.qc import config as tconfig
from viscy_tpu_torch.apps.qc import focus as tfocus
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

ROOT = Path(__file__).resolve().parents[1]
CHANNELS = ["Phase3D", "GFP"]
OPTICS = dict(NA_det=0.55, lambda_ill=0.532, pixel_size=0.325)
ANNOTATION = {
    "channels_metadata": {
        "Phase3D": {"channel_type": "labelfree", "biological_annotation": None},
        "GFP": {"channel_type": "fluorescence",
                "biological_annotation": {"organelle": "endoplasmic_reticulum", "marker": "SEC61B",
                                          "fluorophore": "eGFP", "unknown_key": 1}},
    },
    "experiment_metadata": {
        "B/2": {"perturbations": [{"name": "ZIKV", "type": "virus", "hours_post": 3, "moi": 5}],
                "time_sampling_minutes": 30},
        "A/1": {"time_sampling_minutes": "12.5", "extra": "dropped"},
    },
}


def _focus_stack(shape, seed: int, best: int) -> np.ndarray:
    """A (Z, Y, X) stack whose slice ``best`` is sharp and the others are
    blurred more the further they are, plus a little noise."""
    rng = np.random.default_rng(seed)
    z, y, x = shape
    sharp = rng.random((y, x)).astype(np.float32)
    stack = np.stack([gaussian_filter(sharp, abs(i - best) * 1.5 + 1e-3) for i in range(z)])
    return (stack + 0.01 * rng.random(shape)).astype(np.float32)


def _plate(path: Path, seed: int = 3) -> Path:
    """Two wells (A/1, B/2), two FOVs each, two timepoints, a focus slice
    that moves with the FOV and the timepoint."""
    plate = build_hcs_plate(path, CHANNELS, zyx_shape=(7, 32, 48), num_timepoints=2, rows=("A", "B"),
                            cols=("1", "2"), fovs=("0", "1"), seed=seed)
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    store = open_ome_zarr(plate, mode="r+")
    for k, (name, pos) in enumerate(store.positions()):
        img = pos["0"]
        for t in range(img.shape[0]):
            for c in range(img.shape[1]):
                img[t, c] = _focus_stack(img.shape[2:], seed * 100 + 10 * k + 2 * t + c, (k + t + c) % 7)
    return plate


def _zattrs(root: Path) -> dict:
    """Every ``.zattrs`` under ``root`` as a dict, by its relative path."""
    return {str(p.relative_to(root)): json.loads(p.read_text()) for p in sorted(root.rglob(".zattrs"))}


# -- the models ---------------------------------------------------------------------------------------


MODEL_CASES = [
    ("Perturbation", dict(name="a", hours_post=3, moi=5, zz=None)),
    ("Perturbation", dict(name="a", hours_post="3")),
    ("Perturbation", dict(name="a", hours_post=True, type="drug")),
    ("Perturbation", dict(name=3, hours_post=1.0)),
    ("Perturbation", dict(name="a", hours_post=None)),
    ("Perturbation", dict(name="a", hours_post="soon")),
    ("Perturbation", dict(name="a", type=None, hours_post=1)),
    ("Perturbation", dict(hours_post=1)),
    ("WellExperimentMetadata", dict(time_sampling_minutes=30, extra=1)),
    ("WellExperimentMetadata", dict(time_sampling_minutes=30, perturbations=None)),
    ("WellExperimentMetadata", dict(perturbations=[{"name": "x", "hours_post": 2}], time_sampling_minutes=1)),
    ("WellExperimentMetadata", dict(perturbations=[{"name": "x"}], time_sampling_minutes=1)),
    ("ChannelAnnotationEntry", dict(channel_type="labelfree", foo=1)),
    ("ChannelAnnotationEntry", dict(channel_type="x")),
    ("ChannelAnnotationEntry", dict(channel_type="fluorescence", biological_annotation={"marker": "m"})),
    ("ChannelAnnotationEntry", dict(channel_type="fluorescence", biological_annotation="m")),
    ("BiologicalAnnotation", dict(marker="m", marker_type="nuclear_dye", organelle="nucleus")),
    ("BiologicalAnnotation", dict(marker="m", marker_type="foo")),
    ("BiologicalAnnotation", dict(marker=None)),
    ("BiologicalAnnotation", dict(marker="m", organelle=5)),
]


@pytest.mark.parametrize("name,data", MODEL_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(MODEL_CASES)])
def test_models_dump_as_pydantic_and_refuse_what_it_refuses(name, data):
    try:
        want = getattr(jschemas, name)(**dict(data)).model_dump()
    except ValueError:
        with pytest.raises(ValueError, match=f"validation error for {name}"):
            getattr(tschemas, name)(**dict(data))
        return
    got = getattr(tschemas, name)(**dict(data)).model_dump()
    assert got == want
    assert list(got) == list(want)  # extra keys after the fields, as pydantic dumps them
    assert json.dumps(got) == json.dumps(want)  # 3 -> 3.0 as in pydantic's float coercion


def test_parse_position_name_matches_jax():
    for name in ("B/1/000000", "A/12", "A/1/0/extra"):
        assert tschemas.parse_position_name(name) == jschemas.parse_position_name(name)


CONFIG_CASES = [
    dict(data_path="/x", num_workers=0, focus_slice=dict(OPTICS, channel_names=["a"])),
    dict(data_path="/x"),
    dict(data_path="/x", focus_slice=dict(OPTICS, channel_names=["a"], device="cuda"), bogus=3),
    dict(data_path="/x", metrics=[dict(OPTICS, channel_names=["a"], kind="other")]),
    dict(data_path="/x", metrics=[dict(OPTICS, channel_names="a")]),
    dict(data_path="/x", num_workers="2", metrics=[dict(OPTICS, channel_names=["a"], midband_fractions=[0.1, 0.3])]),
    dict(data_path="/x", metrics=[dict(OPTICS, channel_names=["a"], midband_fractions=[0.1, 0.2, 0.3])]),
    dict(data_path="/x", num_workers=2.5, metrics=[dict(OPTICS, channel_names=["a"])]),
    dict(data_path=5, metrics=[dict(OPTICS, channel_names=["a"])]),
    dict(data_path="/x", metrics=[dict(OPTICS, channel_names=["a"])], focus_slice=dict(OPTICS, channel_names=["b"]),
         annotation=ANNOTATION),
    dict(data_path="/x", annotation={"channels_metadata": {}}),
]


@pytest.mark.parametrize("data", CONFIG_CASES, ids=[str(i) for i in range(len(CONFIG_CASES))])
def test_qc_config_validates_as_jax(data):
    """Both layouts (the ``focus_slice`` section is appended to ``metrics``),
    ``num_workers >= 1``, the ``device`` key accepted, unknown keys dropped,
    the same ``ValueError`` without a metric or an annotation section."""
    try:
        want = jconfig.QCConfig(**json.loads(json.dumps(data)))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.QCConfig(**json.loads(json.dumps(data)))
        if "needs at least one" in str(e):
            assert str(got.value) == "QCConfig needs at least one metric or annotation section"
        return
    got = tconfig.QCConfig(**json.loads(json.dumps(data)))
    assert got.model_dump() == want.model_dump()
    tm, jm = got.build_metrics(device="cpu"), want.build_metrics()
    assert [(m.channel_names, m.midband_fractions, m.NA_det) for m in tm] == \
        [(m.channel_names, m.midband_fractions, m.NA_det) for m in jm]


def test_the_shipped_qc_config_parses_as_in_jax():
    cfg = yaml.safe_load((ROOT / "configs/qc_run.yml").read_text())
    assert tconfig.QCConfig(**cfg).model_dump() == jconfig.QCConfig(**cfg).model_dump()


# -- focus ----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("shape,best,fractions", [((7, 64, 64), 3, (0.125, 0.25)), ((9, 33, 50), 0, (0.1, 0.4)),
                                                  ((5, 48, 31), 4, (0.125, 0.25))])
def test_focus_index_and_band_power_match_jax(shape, best, fractions):
    """Even and odd extents (``fftfreq``'s negative half), the annulus's two
    radii: the same argmax, band powers within 1e-5 relative."""
    stack = _focus_stack(shape, sum(shape), best)
    want = jfocus.focus_from_transverse_band(stack, midband_fractions=fractions, **OPTICS)
    got = tfocus.focus_from_transverse_band(stack, midband_fractions=fractions, device="cpu", **OPTICS)
    assert got == want == best
    power = tfocus.band_power(stack, midband_fractions=fractions, device="cpu", **OPTICS).numpy()
    y, x = shape[1:]
    fy, fx = np.fft.fftfreq(y, d=OPTICS["pixel_size"]), np.fft.fftfreq(x, d=OPTICS["pixel_size"])
    frr = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    cut = 2 * OPTICS["NA_det"] / OPTICS["lambda_ill"]
    band = (frr > fractions[0] * cut) & (frr < fractions[1] * cut)
    f64 = (np.abs(np.fft.fft2(stack.astype(np.float64), axes=(1, 2))) * band).sum(axis=(1, 2))
    np.testing.assert_allclose(power, f64, rtol=1e-5)


def test_focus_refuses_a_missing_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfocus.FocusSliceMetric(channel_names=["a"], **OPTICS)


# -- the command ----------------------------------------------------------------------------------------


def _config(plate: Path, layout: str) -> dict:
    focus = dict(OPTICS, channel_names=CHANNELS, midband_fractions=[0.125, 0.25], device="cuda")
    cfg = {"data_path": str(plate), "num_workers": 1, "annotation": ANNOTATION}
    if layout == "metrics":
        cfg["metrics"] = [dict(focus, kind="focus_slice")]
    else:
        cfg["focus_slice"] = focus
    return cfg


@pytest.fixture(scope="module")
def seeded_plate(tmp_path_factory):
    return _plate(tmp_path_factory.mktemp("qc") / "plate.zarr")


@pytest.mark.parametrize("layout", ["metrics", "focus_slice"])
def test_qc_command_writes_the_same_zattrs_as_jax(tmp_path, seeded_plate, layout):
    """``run -c`` on two copies of one plate: every ``.zattrs`` equal as
    JSON dicts (focus statistics per FOV and timepoint, the plate's and
    each position's ``channels_metadata``, each well's
    ``experiment_metadata``); ``hours_post: 3`` written as ``3.0``; the
    port's output read back by the JAX reader."""
    stores = {}
    for side, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        plate = shutil.copytree(seeded_plate, tmp_path / f"{side}.zarr")
        cfg = tmp_path / f"{side}.yml"
        cfg.write_text(yaml.safe_dump(_config(plate, layout)))
        result = CliRunner().invoke(main, ["run", "-c", str(cfg), *extra], catch_exceptions=False)
        assert result.exit_code == 0, result.output
        stores[side] = plate
    got, want = _zattrs(stores["torch"]), _zattrs(stores["jax"])
    assert got == want
    fov = got["A/1/0/.zattrs"]["focus_slice"]
    assert set(fov) == set(CHANNELS) and fov["Phase3D"]["per_timepoint"] == {"0": 0, "1": 1}
    assert '"hours_post": 3.0' in (stores["torch"] / "B/2/1/.zattrs").read_text()
    back = jopen(stores["torch"])
    for name, pos in back.positions():
        assert dict(pos.zattrs) == got[f"{name}/.zattrs"]
    assert back.zattrs["channels_metadata"] == got[".zattrs"]["channels_metadata"]


@pytest.mark.parametrize("bad", ["channel", "well"])
def test_annotation_errors_name_the_missing_channel_or_well_as_jax(tmp_path, seeded_plate, bad):
    """A channel or a well the plate lacks: the same ``ValueError`` message,
    raised before anything is written."""
    ann = json.loads(json.dumps(ANNOTATION))
    if bad == "channel":
        ann["channels_metadata"]["Nope"] = {"channel_type": "labelfree"}
    else:
        ann["experiment_metadata"]["Z/9"] = {"time_sampling_minutes": 1.0}
    messages = []
    for side, module, cfg_mod in (("jax", jannotation, jconfig), ("torch", tannotation, tconfig)):
        plate = shutil.copytree(seeded_plate, tmp_path / f"{side}.zarr")
        before = _zattrs(plate)
        with pytest.raises(ValueError) as e:
            module.write_annotation_metadata(plate, cfg_mod.AnnotationConfig(**json.loads(json.dumps(ann))))
        messages.append(str(e.value))
        assert _zattrs(plate) == before
    assert messages[0] == messages[1]
    assert ("Channel 'Nope'" if bad == "channel" else "Well path 'Z/9'") in messages[1]
