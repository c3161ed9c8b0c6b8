"""The released-checkpoint parity harness, the state-dict inventories, the
FOV and Airtable schemas and ``python -m viscy_tpu_torch.apps.cytoland``
against ``viscy_tpu`` on the CPU (weights and inputs seeded with numpy)."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pydantic
import pytest
import torch

import viscy_tpu.training.parity as jp
import viscy_tpu.training.state_dict_inventory as jinv
import viscy_tpu_torch.training.parity as tp
import viscy_tpu_torch.training.state_dict_inventory as tinv
from _torch_port_helpers import NARROW, flax_params
from viscy_tpu.apps.airtable_utils.schemas import DatasetRecord as JDatasetRecord
from viscy_tpu.data.schemas import FOVRecord as JFOVRecord
from viscy_tpu_torch.apps.airtable_utils.schemas import DatasetRecord, parse_channel_fields
from viscy_tpu_torch.data.schemas import FOVRecord
from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(NARROW, encoder_blocks=(1, 1, 1, 1), decoder_conv_blocks=1)


# -- inventories ----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(jinv.RELEASED_ARCHITECTURES))
def test_inventories_equal_jax(name):
    assert tinv.released_inventory(name) == jinv.released_inventory(name)
    assert tinv.RELEASED_ARCHITECTURES[name][1] == jinv.RELEASED_ARCHITECTURES[name][1]


def test_inventories_hold_the_reference_pins():
    """``viscy-models/tests/test_state_dict_compat.py``'s counts."""
    assert len(tinv.unext2_state_dict_inventory(backbone="convnextv2_atto")) == 213
    assert len(tinv.fcmae_state_dict_inventory()) == 222
    assert len(tinv.contrastive_state_dict_inventory()) == 194
    assert tinv.BACKBONES == jinv.BACKBONES


# -- tier 1 -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dryruns():
    return tp.converter_dryruns()


@pytest.mark.parametrize("name", list(tinv.RELEASED_ARCHITECTURES))
def test_every_released_architecture_loads_strictly_into_the_port(name, dryruns):
    """The inventory's names and shapes are the port module's, key for key
    (JAX's report: 273 / 252 / 252 / 194 keys, ``PARITY_r04.json``)."""
    want = {"vscyto3d": 273, "vscyto2d": 252, "fcmae_3d": 252, "dynaclr_contrastive": 194}[name]
    assert dryruns[name] == {"status": "ok", "torch_keys": want, "converted_leaves": want, "uncovered": []}
    fn, kwargs = tinv.RELEASED_ARCHITECTURES[name]
    with torch.device("meta"):
        model = tp._released_model(name, dict(kwargs))
    inventory = fn(**kwargs)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(s) for k, s in inventory.items()}


def test_the_harness_default_model_fits_no_released_inventory():
    """``VSCYTO3D_MODEL_CONFIG`` (an FCMAE at depth 15, said to match the
    fine-tuned VSCyto3D checkpoint) loads neither the inventory's
    ``vscyto3d`` (a UNeXt2 at depth 5, another module tree) nor its
    ``fcmae_3d`` (the same tree at depth 5: the stem and the last decoder
    stage differ in shape); JAX's converter leaves the UNeXt2 keys
    unmatched. The port copies JAX's defaults."""
    from viscy_tpu.training.convert import _FCMAE_RULES, convert_state_dict

    with torch.device("meta"):
        model = FullyConvolutionalMAE(**tp.VSCYTO3D_MODEL_CONFIG)
    keys = set(model.state_dict())
    unext2 = tinv.released_inventory("vscyto3d")
    assert set(unext2) - keys and keys - set(unext2)  # other module names (stem, encoder stages)
    fcmae3d = tinv.released_inventory("fcmae_3d")
    assert set(fcmae3d) == keys
    for inventory in (unext2, fcmae3d):
        with pytest.raises(RuntimeError, match="size mismatch"):
            model.load_state_dict({k: torch.zeros(s) for k, s in inventory.items()}, strict=False, assign=True)
    _, unmatched = convert_state_dict({k: np.zeros(s, np.float32) for k, s in
                                       jinv.released_inventory("vscyto3d").items()}, _FCMAE_RULES, strip_prefix="")
    assert unmatched
    assert tp.VSCYTO3D_MODEL_CONFIG == jp.VSCYTO3D_MODEL_CONFIG
    assert (tp.SOURCE_CHANNEL, tp.TARGET_CHANNELS) == (jp.SOURCE_CHANNEL, jp.TARGET_CHANNELS)


@pytest.fixture(scope="module")
def narrow():
    """A narrow FCMAE with seeded flax params, its bridged state dict and
    the port model holding it."""
    from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE

    x = np.random.default_rng(0).normal(size=(1, 1, 15, 64, 64)).astype(np.float32)
    jm = JFCMAE(**SMALL)
    params = flax_params(jm, 3, jnp.asarray(x))
    model = FullyConvolutionalMAE(**SMALL)
    load_flax_params(model, params)
    return dict(x=x, jm=jm, params=params, model=model, sd=fcmae_state_dict_from_flax(params))


def test_the_audit_passes_a_bridged_state_dict_and_its_load(narrow):
    """The bridge's state dict against the flax tree (norm multiset) and the
    model that loaded it: all shared keys equal in shape and norm. Flax
    builds only the stem branch it runs, so at depth 15 the bridge makes no
    ``encoder.stem.conv2d`` and the audit names those two keys."""
    model = narrow["model"]
    audit = tp.layerwise_weight_audit(narrow["sd"], model, source=narrow["params"])
    assert audit.missing_model_keys == ["encoder.stem.conv2d.bias", "encoder.stem.conv2d.weight"]
    assert not (audit.unmatched_torch_keys or audit.shape_mismatches or audit.norm_mismatches), audit
    assert (audit.n_torch_keys, audit.n_source_leaves, audit.n_model_keys) == (
        len(narrow["sd"]), len(narrow["sd"]), len(model.state_dict()))
    full = {k: v.clone() for k, v in model.state_dict().items()}
    assert tp.layerwise_weight_audit(full, model).ok


def test_the_audit_catches_a_scaled_weight_a_missing_key_and_a_swap(narrow):
    model = narrow["model"]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    key = "encoder.stages.1.blocks.0.mlp.fc1.weight"
    scaled = dict(sd, **{key: sd[key] * 1.01})
    audit = tp.layerwise_weight_audit(scaled, model)
    assert not audit.ok and len(audit.norm_mismatches) == 1 and audit.norm_mismatches[0].startswith(key)
    missing = {k: v for k, v in sd.items() if k != key}
    audit = tp.layerwise_weight_audit(missing, model)
    assert not audit.ok and audit.missing_model_keys == [key] and not audit.norm_mismatches
    extra = dict(sd, **{"encoder.stages.9.weight": torch.zeros(3)})
    assert tp.layerwise_weight_audit(extra, model).unmatched_torch_keys == ["encoder.stages.9.weight"]
    a, b = "encoder.stages.1.blocks.0.mlp.fc1.bias", "encoder.stages.2.blocks.0.mlp.fc2.bias"
    bridged = narrow["sd"]
    swapped = dict(bridged, **{a: bridged[b][: len(bridged[a])], b: bridged[a][: len(bridged[b])]})
    assert tp.layerwise_weight_audit(swapped, source=narrow["params"]).norm_mismatches


# -- tier 2 -----------------------------------------------------------------------------

_FLAX_PATHS = [
    (r"encoder\.stem(\.norm)?", lambda m: "encoder/stem" + ("/norm" if m[1] else "")),
    (r"encoder\.stages\.(\d+)\.downsample\.0", lambda m: f"encoder/stage{m[1]}/downsample_norm"),
    (r"encoder\.stages\.(\d+)\.blocks\.(\d+)", lambda m: f"encoder/stage{m[1]}/block{m[2]}"),
    (r"encoder\.stages\.(\d+)", lambda m: f"encoder/stage{m[1]}"),
    (r"decoder\.decoder_stages\.(\d+)\.conv\.downsample\.0", lambda m: f"decoder/stage{m[1]}/conv/downsample_norm"),
    (r"decoder\.decoder_stages\.(\d+)\.conv\.blocks\.(\d+)", lambda m: f"decoder/stage{m[1]}/conv/block{m[2]}"),
    (r"decoder\.decoder_stages\.(\d+)(\.conv)?", lambda m: f"decoder/stage{m[1]}" + ("/conv" if m[2] else "")),
    (r"(decoder|head)", lambda m: m[1]),
]


def _flax_path(name: str) -> str:
    """The port's module path -> JAX's ``capture_intermediates`` path."""
    if name == "output":
        return "__call__"
    for pattern, path in _FLAX_PATHS:
        m = re.fullmatch(pattern, name)
        if m:
            return path(m) + "/__call__"
    raise KeyError(name)


def _jax_activations(narrow) -> dict:
    """``jp.capture_activations(..., with_arrays=True)``, its forward under
    ``jax.jit`` (op by op it takes the CPU about 10 s)."""
    import jax

    apply = jax.jit(lambda v, x: narrow["jm"].apply(v, x, deterministic=True, capture_intermediates=True))
    _, state = apply({"params": narrow["params"]}, jnp.asarray(narrow["x"]))
    out = {}
    for path, a in jp._flatten_intermediates(state["intermediates"]).items():
        if a is not None:
            a = np.asarray(a)
            out[path] = {"mean": float(a.mean()), "std": float(a.std()), "min": float(a.min()),
                         "max": float(a.max()), "array": a}
    return out


def test_the_ports_activation_npz_passes_jax_compare_activations(narrow, tmp_path):
    acts = tp.capture_activations(narrow["model"], narrow["x"], with_arrays=True)
    assert {"encoder.stem", "encoder.stages.3", "decoder", "head", "output"} <= set(acts)
    assert acts["output"]["shape"] == [1, 2, 15, 64, 64]
    npz = tp.export_activations(acts, tmp_path / "port.npz")
    jacts = _jax_activations(narrow)
    result = jp.compare_activations(jacts, npz, name_map=_flax_path)
    assert set(result) == set(acts)
    assert all(r["status"] == "ok" for r in result.values()), {k: r for k, r in result.items() if r["status"] != "ok"}
    # the port's own comparison reads the same file; a diverged layer shows
    assert all(r["status"] == "ok" for r in tp.compare_activations(acts, npz).values())
    theirs = dict(np.load(npz))
    theirs["decoder"] = theirs["decoder"] + 0.5
    np.savez(tmp_path / "bad.npz", **theirs)
    bad = tp.compare_activations(acts, tmp_path / "bad.npz")
    assert bad["decoder"]["status"] == "diverged" and bad["head"]["status"] == "ok"
    for k, v in acts.items():
        for stat in ("mean", "std", "min", "max"):
            assert np.isclose(v[stat], jacts[_flax_path(k)][stat], rtol=1e-4, atol=1e-4), (k, stat)


# -- tier 3 -----------------------------------------------------------------------------


@pytest.mark.parametrize("noise", [0.0, 5e-3, 0.1])
def test_compare_predictions_equals_jax(noise):
    rng = np.random.default_rng(9)
    ref = rng.normal(size=(2, 3, 16, 16))
    pred = ref + rng.normal(size=ref.shape) * noise
    assert tp.compare_predictions(pred, ref, ["a", "b"]) == jp.compare_predictions(pred, ref, ["a", "b"])
    flat = np.zeros((1, 2, 3, 4, 4))
    assert json.dumps(tp.compare_predictions(flat, flat, ["a", "b"])) == json.dumps(
        jp.compare_predictions(flat, flat, ["a", "b"]))
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.compare_predictions(pred[:1], ref, ["a"])


def _fixture(tmp_path: Path, narrow) -> tuple[Path, Path, Path, float]:
    """A Lightning-layout checkpoint of the narrow model, a one-FOV plate
    with its ``fov_statistics``, and a reference store of JAX's
    ``AugmentedPredictionVSUNet`` prediction from the same weights."""
    from viscy_tpu.apps.cytoland.engine import FcmaeUNet as JFcmaeUNet
    from viscy_tpu.apps.cytoland.prediction import AugmentedPredictionVSUNet as JPredictor
    from viscy_tpu.training.convert import convert_fcmae_state_dict, load_torch_checkpoint
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    ckpt = tmp_path / "model.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in narrow["model"].state_dict().items()},
                "epoch": 3}, ckpt)
    rng = np.random.default_rng(5)
    source = (rng.normal(size=(1, 1, 16, 64, 64)) * 40 + 300).astype(np.float32)
    mean, std = float(source.mean()), float(source.std())
    plate = open_ome_zarr(tmp_path / "data.zarr", mode="w", channel_names=["Phase3D"])
    pos = plate.create_position("A", "1", "0")
    pos.create_image("0", source)
    pos.zattrs["normalization"] = {"Phase3D": {"fov_statistics": {"mean": mean, "std": std}}}
    cfg = dict(SMALL)
    jmodule = JFcmaeUNet(model_config=cfg)
    params = convert_fcmae_state_dict(load_torch_checkpoint(str(ckpt)))
    x = ((source[0, 0] - np.float32(mean)) / np.float32(std))[None, None]
    pred = JPredictor(model=jmodule.model).predict_sliding_windows({"params": params}, x, out_channel=2)[0]
    ref = open_ome_zarr(tmp_path / "ref.zarr", mode="w", channel_names=["Nuclei", "Membrane"])
    ref.create_position("A", "1", "0").create_image("0", pred[[1, 0]][None].astype(np.float32))
    return ckpt, tmp_path / "data.zarr", tmp_path / "ref.zarr", float(pred.max() - pred.min())


def test_run_checkpoint_parity_against_jax_predictions(tmp_path, narrow):
    ckpt, data, ref, span = _fixture(tmp_path, narrow)
    result = tp.run_checkpoint_parity(ckpt, data, ref, model_config=dict(SMALL), device="cpu")
    assert result["pass"], result
    assert result["weight_audit"]["ok"] and result["checkpoint"] == str(ckpt)
    assert set(result["channels"]) == {"Membrane", "Nuclei"}
    for ch in result["channels"].values():
        assert ch["max_abs_diff"] / span <= 2e-3 and ch["pearson_r"] > 0.9999
    # a checkpoint of other weights fails the contract
    other = FullyConvolutionalMAE(**SMALL)
    torch.save({"state_dict": {f"model.{k}": v for k, v in other.state_dict().items()}}, tmp_path / "other.ckpt")
    assert not tp.run_checkpoint_parity(tmp_path / "other.ckpt", data, ref, model_config=dict(SMALL),
                                        device="cpu")["pass"]


def test_the_gated_report_keys_equal_jax(tmp_path, monkeypatch, narrow, dryruns):
    for var in ("VISCY_PARITY_CHECKPOINT", "VISCY_PARITY_DATA", "VISCY_PARITY_REFERENCE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tp, "converter_dryruns", lambda: dryruns)
    got = tp.write_parity_report(tmp_path / "t.json", device="cpu")
    want = json.loads((ROOT / "PARITY_r04.json").read_text())
    assert list(got) == list(want) and got == json.loads((tmp_path / "t.json").read_text())
    assert got["contract"] == want["contract"] and got["status"] == "artifacts_unavailable"
    assert got["missing_artifacts"] == ["checkpoint", "data", "reference"]
    for name, entry in got["converter_dryruns"].items():
        assert entry == want["converter_dryruns"][name]
    # with the three artifacts (here through the environment) the contract runs
    ckpt, data, ref, _ = _fixture(tmp_path, narrow)
    monkeypatch.setenv("VISCY_PARITY_CHECKPOINT", str(ckpt))
    monkeypatch.setenv("VISCY_PARITY_DATA", str(data))
    monkeypatch.setenv("VISCY_PARITY_REFERENCE", str(ref))
    monkeypatch.setattr(tp, "VSCYTO3D_MODEL_CONFIG", dict(SMALL))
    done = tp.write_parity_report(tmp_path / "done.json", device="cpu")
    assert done["status"] == "executed" and done["result"]["pass"]
    assert [k for k in done if k not in ("detail", "missing_artifacts")] == [*list(want)[:3], "status", "result"]


def test_the_command_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch, dryruns, capsys):
    with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
        tp.main(["--output", str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
    monkeypatch.setattr(tp, "converter_dryruns", lambda: dryruns)
    report = tp.main(["--output", str(tmp_path / "p.json"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == report == json.loads((tmp_path / "p.json").read_text())


# -- schemas ----------------------------------------------------------------------------

_FOV_CASES = [
    dict(fov_name="A/1/0", store_path="/p.zarr"),
    dict(fov_name="A/1/0", store_path="/p.zarr", well="A/1", channel_names=("Phase3D", "GFP"), pixel_size_xy_um="0.1",
         interval_minutes=30, hours_post_perturbation_start=True, quality="good", junk=1),
    dict(fov_name="A/1/0"),
    dict(fov_name=3, store_path="/p.zarr"),
    dict(fov_name="A/1/0", store_path="/p.zarr", pixel_size_z_um="thick"),
    dict(fov_name="A/1/0", store_path="/p.zarr", channel_names="Phase3D"),
    dict(fov_name="A/1/0", store_path="/p.zarr", channel_names=["a", 1]),
]

_DATASET_CASES = [
    {},
    dict(dataset="d", well_id="B/1", fov="000000", cell_line=["A549", "HEK"], perturbation="ZIKV", moi="5",
         hours_post_perturbation=24, time_interval_min=30.0, t_shape="3.0", c_shape=True, z_shape=15.0,
         channel_0_name="Phase3D", channel_1_name="raw GFP EX488 EM525-45", channel_1_marker="SEC61B",
         channel_3_name="nuclei_prediction", treatment_concentration_nm=b"10", data_path="/x.zarr"),
    dict(channel_names=["a"], channel_markers={"a": "m"}, channel_0_name="x", channel_0_marker="y"),
    dict(t_shape=3.5),
    dict(t_shape=float("nan")),
    *(dict(t_shape=v) for v in ("1e3", " 3.00 ", "-0.0", "+4", "1_0", "3.", ".0", "0x10", b"7", 1e20, "9" * 25)),
    dict(moi="x"),
    dict(marker=3),
    dict(cell_line="A549"),
    dict(channel_markers={"a": 1}),
    dict(dataset=None),
]


def _validate(cls, data):
    try:
        return cls(**data).model_dump()
    except ValueError as e:  # pydantic's ValidationError is a ValueError
        return type(e).__name__ if isinstance(e, pydantic.ValidationError) else "ValueError"


@pytest.mark.parametrize("case", range(len(_FOV_CASES)))
def test_fov_record_matches_pydantic(case):
    data = _FOV_CASES[case]
    want, got = _validate(JFOVRecord, data), _validate(FOVRecord, data)
    assert got == ("ValueError" if want == "ValidationError" else want)


@pytest.mark.parametrize("case", range(len(_DATASET_CASES)))
def test_dataset_record_matches_pydantic(case):
    data = _DATASET_CASES[case]
    want, got = _validate(JDatasetRecord, data), _validate(DatasetRecord, data)
    assert got == ("ValueError" if want == "ValidationError" else want)
    if isinstance(want, dict):
        j, t = JDatasetRecord(**data), DatasetRecord(**data)
        assert t.to_airtable_fields() == j.to_airtable_fields()
        assert t.to_channels_metadata() == j.to_channels_metadata()
        assert t.to_experiment_metadata() == j.to_experiment_metadata()
        assert t.to_fov_record().model_dump() == j.to_fov_record().model_dump()


def test_a_failed_check_names_the_model_and_the_field():
    with pytest.raises(ValueError, match=r"DatasetRecord\.t_shape"):
        DatasetRecord(t_shape=3.5)
    with pytest.raises(ValueError, match=r"FOVRecord\.store_path: Field required"):
        FOVRecord(fov_name="a")


def test_defaults_are_not_shared_between_instances():
    a, b = DatasetRecord(), DatasetRecord()
    a.cell_line.append("x")
    a.channel_markers["k"] = "v"
    assert b.cell_line == [] and b.channel_markers == {}
    f, g = FOVRecord(fov_name="a", store_path="p"), FOVRecord(fov_name="b", store_path="p")
    f.channel_names.append("c")
    assert g.channel_names == []


def test_from_airtable_record_matches_jax():
    record = {"id": "rec7", "fields": {
        "dataset": "exp", "well_id": "C/3", "fov": "001", "cell_type": {"name": "A549"},
        "cell_line": [{"name": "A549"}, "HEK"], "marker": {"name": "SEC61B"}, "organelle": {"name": "ER"},
        "perturbation": {"name": "DENV"}, "hours_post_perturbation": 12, "moi": 0.5, "time_interval_min": 15,
        "channel_0_name": "Phase3D", "channel_1_name": "GFP EX488 EM525", "channel_1_marker": {"name": "SEC61B"},
        "microscope": {"name": "mantis"}, "hours post treatment": 3, "t_shape": 4, "x_shape": 2048,
        "pixel_size_xy_um": 0.1, "unknown_field": "ignored"}}
    j, t = JDatasetRecord.from_airtable_record(record), DatasetRecord.from_airtable_record(record)
    assert t.model_dump() == j.model_dump()
    assert t.to_airtable_fields() == j.to_airtable_fields()
    assert t.to_fov_record().model_dump() == j.to_fov_record().model_dump()


@pytest.mark.parametrize("name", ["raw GFP EX488 EM525-45", "Phase3D", "nuclei_prediction", "BF_2", "dic",
                                  "mCherry EX561EM600", "DAPI", "Retardance", "VS_membrane"])
def test_parse_channel_fields_matches_jax(name):
    from viscy_tpu.apps.airtable_utils.schemas import parse_channel_fields as j

    assert parse_channel_fields(name) == j(name)


# -- entry point ------------------------------------------------------------------------


def test_python_m_cytoland_is_the_viscy_torch_cli(monkeypatch, capsys):
    """``python -m viscy_tpu_torch.apps.cytoland --help`` prints what
    ``viscy-torch --help`` prints (both run in process here)."""
    import runpy

    from viscy_tpu_torch.training import cli

    def run(fn) -> tuple[int, str]:
        monkeypatch.setattr(sys, "argv", ["viscy-torch", "--help"])
        with pytest.raises(SystemExit) as done:
            fn()
        return done.value.code, capsys.readouterr().out

    app = run(lambda: runpy.run_module("viscy_tpu_torch.apps.cytoland", run_name="__main__"))
    want = run(cli.main)
    assert app == want and want[0] == 0 and "fit" in want[1] and "predict" in want[1]
