"""The rest of dynacell's evaluation tail in the port against the JAX
package on the CPU: whole-cell segmentation, ``evaluation.py`` (pixel
metrics and the plate-against-plate rows with their cache), the
comparison tables of ``report`` and ``reporting.py``, the manifests and
their compose hook, and ``rewrite_zarr``.

Tolerances: segmentation labels, table and report text, manifest fields
and rewritten stores identical; pixel metrics relative 1e-5 (JAX computes
MAE, MSE and SSIM in float32, the port MAE and MSE in float64), the POD
counts identical.
"""

import json
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from click.testing import CliRunner
from scipy import ndimage

import viscy_tpu.apps.dynacell.eval.segmentation_whole_cell as jwc
import viscy_tpu_torch.apps.dynacell.eval.segmentation_whole_cell as twc
from viscy_tpu_torch.apps.dynacell import evaluation as tev
from viscy_tpu_torch.apps.dynacell import manifests as tman
from viscy_tpu_torch.apps.dynacell import reporting as trep
from viscy_tpu_torch.apps.dynacell.__main__ import main as dynacell
from viscy_tpu_torch.apps.dynacell.eval import _ndimage as nd
from viscy_tpu_torch.apps.dynacell.eval import tables as ttab
from viscy_tpu_torch.apps.dynacell.eval.segmentation import segment_nucleus_instances
from viscy_tpu_torch.zarr_io.store import TransformationMeta, open_ome_zarr

CPU = dict(device="cpu")


# -- whole-cell segmentation ------------------------------------------------------------------
def cells_volume(shape, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded float32 (nucleus, membrane) images: ``n`` ellipsoidal nuclei,
    a membrane shell at 1.6-1.8 times each radius, blurred, with noise."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape], indexing="ij")
    nuc, mem = np.zeros(shape), np.zeros(shape)
    for _ in range(n):
        c = [rng.uniform(0.15 * s, 0.85 * s) for s in shape]
        r = [rng.uniform(1.5, 2.5) if (len(shape) == 3 and a == 0) else rng.uniform(4.0, 6.0)
             for a in range(len(shape))]
        d2 = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grids, c, r))
        nuc = np.maximum(nuc, rng.uniform(0.6, 1.0) * (d2 <= 1.0))
        mem = np.maximum(mem, 0.7 * ((d2 > 2.6) & (d2 <= 3.3)))
    nuc = ndimage.gaussian_filter(nuc, 0.8) + 0.03 * rng.standard_normal(shape)
    mem = ndimage.gaussian_filter(mem, 0.8) + 0.03 * rng.standard_normal(shape)
    return nuc.astype(np.float32), mem.astype(np.float32)


WHOLE_CELL = {
    "3d": ((6, 80, 88), 9, dict(spacing_zyx=(1.0, 0.5, 0.5))),
    "2d": ((96, 80), 8, dict(spacing_zyx=(1.0, 0.5, 0.5), min_cell_um=3.0)),
    "3d_no_carve": ((5, 64, 64), 6, dict(spacing_zyx=(1.0, 0.5, 0.5), carve_nucleus=False, close_um=1.5)),
}


@pytest.mark.parametrize("case", list(WHOLE_CELL))
def test_segment_whole_cell_bit_for_bit(case, monkeypatch):
    """The port's labels equal JAX's on the host path, and on the device
    path (the closing, the Gaussian and the distance transform through
    ``._ndimage``, run here on CPU tensors) too."""
    shape, n, kw = WHOLE_CELL[case]
    nuc, mem = cells_volume(shape, n, seed=len(case) + n)
    seeds = segment_nucleus_instances(nuc, min_distance=3)
    assert seeds.max() >= 3
    want = jwc.segment_whole_cell(mem, nuc, seeds, **kw)
    assert want.dtype == np.int32 and len(np.unique(want)) > 3 and (want[seeds > 0] == 0).all() == kw.get(
        "carve_nucleus", True)
    got = twc.segment_whole_cell(mem, nuc, seeds, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    monkeypatch.setattr(twc.nd, "on_card", lambda device: device is not None)
    got_dev = twc.segment_whole_cell(mem, nuc, seeds, device="cpu", **kw)
    assert np.array_equal(got_dev, want)


def test_plane_closing_and_slice_index_match_scipy_and_jax():
    x = torch.from_numpy(np.random.default_rng(4).random((3, 21, 17), np.float32))
    size = 7
    got = nd.minimum_filter(nd.maximum_filter(x, size, (1, 2)), size, (1, 2)).numpy()
    want = np.stack([ndimage.grey_closing(p, size=(size, size)) for p in x.numpy()])
    assert np.array_equal(got, want)
    vol = np.random.default_rng(5).random((9, 10, 10)).astype(np.float32)
    vol[6] *= 3
    for kw in ({}, {"selection": "sharpest"}, {"fraction": 0.5}):
        assert twc.slice_index(vol, **kw) == jwc.slice_index(vol, **kw)
    with pytest.raises(ValueError, match="slice_selection"):
        twc.slice_index(vol, selection="middle")
    with pytest.raises(ValueError, match="shape mismatch"):
        twc.segment_whole_cell(vol, vol[:4], vol.astype(np.int32))


# -- evaluation.py ---------------------------------------------------------------------------------
def _plates(tmp: Path) -> tuple[Path, Path]:
    rng = np.random.default_rng(8)
    target = open_ome_zarr(tmp / "target.zarr", layout="hcs", mode="w", channel_names=["Nucleus", "Labels"])
    pred = open_ome_zarr(tmp / "pred.zarr", layout="hcs", mode="w", channel_names=["Nucleus_pred", "Labels_pred"])
    for fov in ("0", "1"):
        t = rng.random((2, 1, 5, 32, 40), np.float32)
        labels = np.zeros((2, 1, 5, 32, 40), np.float32)
        labels[:, :, :, 4:12, 5:15], labels[:, :, :, 18:28, 20:30] = 1, 2
        target.create_position("A", "1", fov).create_image("0", np.concatenate([t, labels], axis=1))
        p = (t + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
        plabels = np.roll(labels, 2, axis=-1)
        plabels[:, :, :, 0:3, 0:3] = 3
        pred.create_position("A", "1", fov).create_image("0", np.concatenate([p, plabels], axis=1))
    extra = rng.random((1, 2, 5, 32, 40), np.float32)
    pred.create_position("A", "1", "9").create_image("0", extra)  # a FOV the target plate lacks
    return tmp / "pred.zarr", tmp / "target.zarr"


def _jax_rows(df) -> list[dict]:
    return [dict(r) for r in df.to_dict(orient="records")]


def test_evaluate_plates_rows_and_cache_match_jax(tmp_path):
    """The tidy rows in JAX's order and values; the port reads JAX's cache
    files (hits: the same numbers bit for bit) and a second port run hits
    its own."""
    from viscy_tpu.apps.dynacell import evaluation as jev

    pred, target = _plates(tmp_path)
    pairs, labels = [("Nucleus_pred", "Nucleus")], [("Labels_pred", "Labels")]
    want = _jax_rows(jev.evaluate_plates(pred, target, pairs, instance_label_pairs=labels))
    got = tev.evaluate_plates(pred, target, pairs, instance_label_pairs=labels, csv_path=tmp_path / "rows.csv", **CPU)
    assert [(r["fov"], r["t"], r["channel"], r["metric"]) for r in got] == \
        [(r["fov"], r["t"], r["channel"], r["metric"]) for r in want]
    assert len(got) == len(want) == 2 * 2 * (4 + 6) and {r["fov"] for r in got} == {"A/1/0", "A/1/1"}
    for g, w in zip(got, want):
        if g["metric"].startswith("pod_"):
            assert g["value"] == w["value"], g
        else:
            assert abs(g["value"] - w["value"]) <= 1e-5 * max(abs(w["value"]), 0.1), (g, w)
    csv_rows = pd.read_csv(tmp_path / "rows.csv", float_precision="round_trip")
    assert list(csv_rows.columns) == list(tev.COLUMNS) and csv_rows["value"].tolist() == [r["value"] for r in got]

    cache = tmp_path / "cache"
    jev.evaluate_plates(pred, target, pairs, cache_dir=cache, instance_label_pairs=labels)
    files = sorted(p.name for p in cache.iterdir())
    assert len(files) == 2 * 2 * 2
    hits = tev.evaluate_plates(pred, target, pairs, cache_dir=cache, instance_label_pairs=labels, **CPU)
    assert [r["value"] for r in hits] == [r["value"] for r in want]  # JAX's numbers, read from its files
    (cache2 := tmp_path / "cache2").mkdir()
    first = tev.evaluate_plates(pred, target, pairs, cache_dir=cache2, **CPU)
    stamps = {p: p.stat().st_mtime_ns for p in cache2.iterdir()}
    again = tev.evaluate_plates(pred, target, pairs, cache_dir=cache2, **CPU)
    assert again == first and {p: p.stat().st_mtime_ns for p in cache2.iterdir()} == stamps


def test_pixel_metrics_match_jax_and_skip_ssim_below_the_window():
    from viscy_tpu.apps.dynacell import evaluation as jev

    rng = np.random.default_rng(2)
    for shape, has_ssim in (((1, 6, 30, 34), True), ((1, 4, 16, 30), False), ((2, 3, 21, 21), True)):
        p, t = rng.random(shape, np.float32), rng.random(shape, np.float32)
        got, want = tev.pixel_metrics(p, t, **CPU), jev.pixel_metrics(p, t)
        assert list(got) == list(want) and ("ssim" in got) == has_ssim
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 0.1), k


# -- report and reporting.py ----------------------------------------------------------------------
def _eval_dir(root: Path, name: str, seed: int, tiers=("pixel", "mask"), fovs=("A/1/0", "A/1/1")) -> Path:
    rng = np.random.default_rng(seed)
    d = root / name
    d.mkdir(parents=True)
    keys = [(f, t) for f in fovs for t in range(2)]
    cols = {"pixel": ["PCC", "SSIM", "NRMSE", "PSNR", "Spectral_PCC"], "mask": ["Dice", "IoU", "mAP", "Recall"]}
    for tier in tiers:
        frame = pd.DataFrame({"FOV": [k[0] for k in keys], "Timepoint": [k[1] for k in keys],
                              **{c: rng.random(len(keys)) * (30 if c == "PSNR" else 1) for c in cols[tier]}})
        if tier == "mask":
            frame.loc[1, "mAP"] = np.nan
        frame.to_csv(d / f"{tier}_metrics.csv", index=False)
    return d


@pytest.fixture()
def eval_dirs(tmp_path):
    return {"unext2": _eval_dir(tmp_path, "a", 1), "fnet3d": _eval_dir(tmp_path, "b", 2, tiers=("pixel",)),
            "celldiff": _eval_dir(tmp_path, "c", 3, fovs=("A/1/0",)), "empty": (tmp_path / "none")}


@pytest.mark.parametrize("metrics", [None, ["PSNR", "Dice", "NRMSE", "mAP", "Missing"], ["SSIM", "IoU"]])
def test_comparison_tables_are_jax_text(eval_dirs, metrics):
    from viscy_tpu.apps.dynacell.eval import tables as jtab

    want = jtab.comparison_table(eval_dirs, metrics=metrics)
    got = ttab.comparison_table(eval_dirs, metrics=metrics)
    assert got.index == list(want.index) and got.columns == list(want.columns)
    assert ttab.to_markdown(got) == jtab.to_markdown(want)
    assert ttab.to_markdown(got, bold_best=False) == jtab.to_markdown(want, bold_best=False)
    assert ttab.to_latex(got) == jtab.to_latex(want)
    assert ttab.to_latex(got, caption="Models", label="tab:m") == jtab.to_latex(want, caption="Models", label="tab:m")
    assert got.to_csv() == want.to_csv()


def test_a_model_without_any_asked_metric_breaks_jax_report_not_the_ports(eval_dirs):
    """JAX reduces a results dir that has CSVs but none of the metrics asked
    with ``df[[]].agg(["mean", "std"])``, which raises in pandas
    (``tables.py:88``): a report asking for a mask metric fails when one
    model was scored on the pixel tier only. The port leaves that model
    out, as JAX leaves out a model without any results."""
    from viscy_tpu.apps.dynacell.eval import tables as jtab

    with pytest.raises(ValueError, match="No objects to concatenate"):
        jtab.comparison_table(eval_dirs, metrics=["IoU"])
    got = ttab.comparison_table(eval_dirs, metrics=["IoU"])
    assert got.index == ["unext2", "celldiff"] and got.columns == ["IoU"]
    want = jtab.comparison_table({k: v for k, v in eval_dirs.items() if k in got.index}, metrics=["IoU"])
    assert ttab.to_latex(got) == jtab.to_latex(want) and got.to_csv() == want.to_csv()


def test_tables_refuse_an_unkeyed_merge_as_jax_does(tmp_path):
    from viscy_tpu.apps.dynacell.eval import tables as jtab

    d = _eval_dir(tmp_path, "a", 4)
    pd.DataFrame({"PCC": [0.5]}).to_csv(d / "feature_metrics.csv", index=False)
    with pytest.raises(ValueError, match="missing key columns"):
        jtab.load_and_aggregate(d, ["PCC"])
    with pytest.raises(ValueError, match="missing key columns"):
        ttab.load_and_aggregate(d, ["PCC"])
    with pytest.raises(NotImplementedError, match="matplotlib"):
        ttab.metric_comparison_barplot({"a": d})


def test_report_writes_jax_tables_then_refuses_the_barplot(eval_dirs, tmp_path):
    cfg = {"results_dirs": {k: str(v) for k, v in eval_dirs.items()}, "metrics": ["PCC", "SSIM", "Dice", "mAP"],
           "figure_format": "png"}
    paths = {}
    for side in ("port", "jax"):
        c = dict(cfg, out_dir=str(tmp_path / side))
        paths[side] = tmp_path / f"{side}.yml"
        paths[side].write_text(yaml.safe_dump(c))
    r = CliRunner().invoke(dynacell, ["report", "-c", str(paths["port"])])
    assert isinstance(r.exception, NotImplementedError) and "matplotlib" in str(r.exception)
    assert "Queue 1 item 9" in str(r.exception)
    from viscy_tpu.apps.dynacell.__main__ import main as jdynacell

    r = CliRunner().invoke(jdynacell, ["report", "-c", str(paths["jax"])])
    assert r.exit_code == 0, r.output
    for name in ("comparison.md", "comparison.tex", "comparison.csv"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text(), name
    assert not list((tmp_path / "port").glob("comparison_barplot*"))


def test_reporting_summaries_match_jax():
    from viscy_tpu.apps.dynacell import reporting as jrep

    rng = np.random.default_rng(6)
    rows = {m: [dict(fov=f"A/1/{f}", t=t, channel=ch, metric=k, value=float(rng.random()))
                for f in range(3) for t in range(2) for ch in ("Nuclei", "Membrane") for k in ("pearson", "ssim")
                if not (m == "fnet" and ch == "Membrane")] for m in ("unext2", "fnet")}
    rows["unext2"][0]["value"] = float("nan")
    for m, r in rows.items():
        want = jrep.summarize_metrics(pd.DataFrame(r))
        got = trep.summarize_metrics(r)
        assert [(g["channel"], g["metric"], g["count"]) for g in got] == \
            list(zip(want["channel"], want["metric"], want["count"]))
        for k in ("mean", "std", "median"):
            np.testing.assert_allclose([g[k] for g in got], want[k].to_numpy(), rtol=1e-12)
    for metric in ("pearson", "ssim"):
        want = jrep.comparison_table({m: pd.DataFrame(r) for m, r in rows.items()}, metric=metric)
        got = trep.comparison_table(rows, metric=metric)
        assert trep.to_markdown(got) == jrep.to_markdown(want)
        assert trep.to_markdown(got, floatfmt=".2f") == jrep.to_markdown(want, floatfmt=".2f")


# -- manifests and the compose hook ---------------------------------------------------------------
MANIFEST = {
    "name": "a549", "version": "1", "spacing": {"z": 0.29, "y": 0.1, "x": 0.1},
    "channels": {"source": "Phase3D", "auxiliary": ["DAPI"]},
    "targets": {
        "er": {"target_channel": "SEC61B", "gene": "SEC61B",
               "stores": {"train": "/data/er/train.zarr", "test": "/data/er/test.zarr",
                          "gt_cache_dir": "/data/er/cache"}},
        "nucleus": {"target_channel": "H2B", "stores": {"train": "/data/nuc/train.zarr",
                                                         "test": "/data/nuc/test.zarr"}},
    },
}


@pytest.fixture()
def roots(tmp_path, monkeypatch):
    root = tmp_path / "manifests"
    (root / "a549").mkdir(parents=True)
    (root / "a549" / "manifest.yaml").write_text(yaml.safe_dump(MANIFEST))
    monkeypatch.delenv("DYNACELL_MANIFEST_ROOTS", raising=False)
    return root


def _fields(resolved) -> dict:
    keys = ("manifest_path", "data_path_train", "data_path_test", "source_channel", "target_channel",
            "cell_segmentation_path", "gt_cache_dir")
    return {**{k: getattr(resolved, k) for k in keys}, "spacing": resolved.spacing.as_list()}


def test_manifest_resolution_and_its_three_errors(roots, tmp_path, monkeypatch):
    from viscy_tpu.apps.dynacell import manifests as jman

    for target in ("er", "nucleus"):
        got = tman.resolve_dataset_ref(tman.DatasetRef(dataset="a549", target=target), [roots])
        want = jman.resolve_dataset_ref(jman.DatasetRef(dataset="a549", target=target), [roots])
        assert _fields(got) == _fields(want)
        assert isinstance(got.data_path_train, Path) and got.spacing.as_list() == [0.29, 0.1, 0.1]
    monkeypatch.setenv("DYNACELL_MANIFEST_ROOTS", os.pathsep.join([str(tmp_path / "elsewhere"), str(roots)]))
    assert tman.discover_manifest_roots() == jman.discover_manifest_roots() == [tmp_path / "elsewhere", roots]
    assert _fields(tman.resolve_dataset_ref(tman.dataset_ref_from_dict({"dataset": "a549", "target": "er"}))) == \
        _fields(jman.resolve_dataset_ref(jman.dataset_ref_from_dict({"dataset": "a549", "target": "er"})))
    errors = {"roots": (tman.NoManifestRootsError, jman.NoManifestRootsError, RuntimeError),
              "dataset": (tman.ManifestNotFoundError, jman.ManifestNotFoundError, LookupError),
              "target": (tman.TargetNotFoundError, jman.TargetNotFoundError, LookupError)}
    for case, (terr, jerr, base) in errors.items():
        assert issubclass(terr, base)
        if case == "roots":
            monkeypatch.delenv("DYNACELL_MANIFEST_ROOTS")
        ref = {"dataset": "hek293" if case == "dataset" else "a549", "target": "golgi" if case == "target" else "er"}
        with pytest.raises(jerr) as want:
            jman.resolve_dataset_ref(jman.DatasetRef(**ref), None if case == "roots" else [roots])
        with pytest.raises(terr) as got:
            tman.resolve_dataset_ref(tman.DatasetRef(**ref), None if case == "roots" else [roots])
        assert str(got.value) == str(want.value)
    assert tman.dataset_ref_from_dict({"dataset": "a549"}) is None and tman.dataset_ref_from_dict("x") is None


def test_manifest_validation_without_pydantic(roots, tmp_path):
    from viscy_tpu.apps.dynacell import manifests as jman

    bad = [
        dict(MANIFEST, spacing={"z": 1.0, "y": 0.1}),
        dict(MANIFEST, targets={"er": {"stores": {"train": "a", "test": "b"}}}),
        dict(MANIFEST, channels={"source": 3}),
        dict(MANIFEST, spacing={"z": "thick", "y": 0.1, "x": 0.1}),
    ]
    for i, m in enumerate(bad):
        path = tmp_path / f"bad{i}.yaml"
        path.write_text(yaml.safe_dump(m))
        with pytest.raises(ValueError):
            jman.load_manifest(path)
        with pytest.raises(ValueError, match="validation error for"):
            tman.load_manifest(path)
    good = tman.load_manifest(roots / "a549" / "manifest.yaml")
    assert good.source_channel == "Phase3D" and good.targets["er"].stores.cell_segmentation is None
    assert tman.get_target(good, "er").gene == "SEC61B"
    with pytest.raises(tman.TargetNotFoundError):
        tman.get_target(good, "golgi")
    split = {"split_version": "v1", "random_seed": 3, "train": {"fovs": ["a", "b"], "count": 2},
             "test": {"fovs": ["c"], "count": 2}}
    (tmp_path / "split.yaml").write_text(yaml.safe_dump(split))
    for load in (jman.load_splits, tman.load_splits):
        with pytest.raises(ValueError, match="declares count=2 but has 1 FOVs"):
            load(tmp_path / "split.yaml")
    split["test"]["count"] = 1
    (tmp_path / "split.yaml").write_text(yaml.safe_dump(split))
    assert tman.load_splits(tmp_path / "split.yaml").random_seed == jman.load_splits(tmp_path / "split.yaml").random_seed
    collection = {"name": "c", "description": "d", "provenance": {"created_at": "now", "created_by": "me"},
                  "experiments": [{"name": "e", "data_path": "/p.zarr", "pixel_size_xy_um": 0.1,
                                   "channels": [{"name": "Phase3D", "marker": "phase"}]}]}
    (tmp_path / "collection.yaml").write_text(yaml.safe_dump(collection))
    got, want = tman.load_collection(tmp_path / "collection.yaml"), jman.load_collection(tmp_path / "collection.yaml")
    assert got.experiments[0].channels[0].model_dump() == want.experiments[0].channels[0].model_dump()
    assert got.experiments[0].data_path == want.experiments[0].data_path and got.provenance.record_ids == []


def test_compose_hook_splices_the_manifest_as_jax(roots, tmp_path, monkeypatch):
    from viscy_tpu.apps.dynacell._compose_hook import dynacell_ref_resolver as jresolver
    from viscy_tpu.training.compose import load_composed_config as jcompose
    from viscy_tpu_torch.apps.dynacell._compose_hook import dynacell_ref_resolver
    from viscy_tpu_torch.training.compose import load_composed_config

    monkeypatch.setenv("DYNACELL_MANIFEST_ROOTS", str(roots))
    leaf = {"launcher": {"mode": "predict"}, "benchmark": {"dataset_ref": {"dataset": "a549", "target": "er"}},
            "data": {"init_args": {"batch_size": 4}}}
    path = tmp_path / "leaf.yml"
    path.write_text(yaml.safe_dump(leaf))
    got = load_composed_config(path, resolver=dynacell_ref_resolver)
    assert got == jcompose(path, resolver=jresolver)
    assert got["data"]["init_args"]["data_path"] == "/data/er/test.zarr" and got["benchmark"]["spacing"] == [
        0.29, 0.1, 0.1]
    partial = dict(leaf, benchmark={"dataset_ref": {"dataset": "a549"}})
    assert dynacell_ref_resolver(partial) == partial
    conflict = dict(leaf, data={"init_args": {"source_channel": "Brightfield"}})
    with pytest.raises(ValueError, match="conflicts with explicit data.init_args"):
        dynacell_ref_resolver(conflict)
    monkeypatch.setattr("sys.argv", ["dynacell"])
    with pytest.raises(ValueError, match="Cannot infer mode"):
        dynacell_ref_resolver({k: v for k, v in leaf.items() if k != "launcher"})
    monkeypatch.setattr("sys.argv", ["dynacell", "fit", "-c", "x.yml"])
    fit = dynacell_ref_resolver({k: v for k, v in leaf.items() if k != "launcher"})
    assert fit["data"]["init_args"]["data_path"] == "/data/er/train.zarr"


# -- preprocess ----------------------------------------------------------------------------------
def test_rewrite_zarr_keeps_data_and_scale(tmp_path):
    from viscy_tpu.zarr_io.store import open_ome_zarr as jopen
    from viscy_tpu_torch.apps.dynacell.preprocess import load_preprocess_config, rewrite_zarr

    src = open_ome_zarr(tmp_path / "src.zarr", layout="hcs", mode="w", channel_names=["Phase3D", "GFP"])
    rng = np.random.default_rng(7)
    data = {}
    for fov, scale in (("0", [1.0, 1.0, 0.29, 0.1, 0.1]), ("1", [1.0, 1.0, 0.5, 0.2, 0.2])):
        data[fov] = rng.random((2, 2, 5, 24, 20)).astype(np.float32)
        src.create_position("B", "3", fov).create_image("0", data[fov], transform=[TransformationMeta(scale=scale)])
    for version, shards in (("0.5", None), ("0.4", None), ("0.5", (1, 1, 1, 2, 2))):
        out = tmp_path / f"out_{version}_{shards is not None}.zarr"
        rewrite_zarr(tmp_path / "src.zarr", out, chunks=(1, 1, 2, 8, 8), shards_ratio=shards, version=version)
        new = open_ome_zarr(out)
        assert new.channel_names == ["Phase3D", "GFP"]
        jnew = jopen(out)
        for fov in ("0", "1"):
            pos = new[f"B/3/{fov}"]
            assert np.array_equal(pos["0"][:], data[fov]) and pos["0"].chunks == (1, 1, 2, 8, 8)
            assert pos.scale == src[f"B/3/{fov}"].scale
            assert np.array_equal(np.asarray(jnew[f"B/3/{fov}"]["0"][:]), data[fov])
            assert list(jnew[f"B/3/{fov}"].scale) == pos.scale
    cfg = tmp_path / "pp.yml"
    cfg.write_text(json.dumps({"chunks": [1, 1, 2, 8, 8]}))
    assert load_preprocess_config(cfg) == {"chunks": [1, 1, 2, 8, 8]}
    with pytest.raises(FileNotFoundError):
        load_preprocess_config(tmp_path / "missing.yml")
