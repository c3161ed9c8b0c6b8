"""The port's ``dynacell`` evaluation end to end against the JAX package on
the CPU, on 48^2 plates: ``evaluate`` (every output file), the GT cache,
``StaleCacheError``, the final-metrics cache, ``precompute-gt`` and
``evaluate-grouped`` through the port's command line.

The plates are written with the port's writer (uncompressed; the JAX
writer's default, blosc, the port refuses by name). JAX's run has its
``as_completed`` keep submission order, so the CSVs compare row for row,
and its pixel metrics run their float64 evaluation (see
``test_torch_port_dynacell_pixel.py``) and its probe to the optimum.
Columns compare as the tolerances of the pixel and feature tests state:
mask and CP columns and the embeddings exactly, the pixel and feature-space
metrics within 1e-8 (a rank-deficient FID within its rounding bound), the
probe AUROCs within 1e-3. A separate test shows JAX's unordered results.
"""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

import viscy_tpu.apps.dynacell.eval.metrics as jm
import viscy_tpu.apps.dynacell.eval.pipeline as jpipe
import viscy_tpu.apps.dynacell.eval.runtime as jruntime
import viscy_tpu.apps.dynacell.eval.spectral as js
import viscy_tpu_torch.apps.dynacell.eval.linear_probe as tlp
from viscy_tpu_torch.apps.dynacell.__main__ import main as dynacell
from viscy_tpu_torch.apps.dynacell.eval import pipeline as tpipe
from viscy_tpu_torch.apps.dynacell.eval.cache import StaleCacheError, cache_paths, load_manifest
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

from _torch_port_helpers import numpy_float64
from test_torch_port_dynacell_features import OptimalLogistic

REL = 1e-8
FOVS = ("0", "1", "2")


def _nuclei_frame(rng, n: int = 9) -> np.ndarray:
    yy, xx = np.mgrid[:48, :48]
    img = np.zeros((48, 48), np.float32)
    for _ in range(n):
        cy, cx = rng.uniform(5, 43, 2)
        r = rng.uniform(3.0, 5.0)
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r**2)).astype(np.float32)
    return img


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    """GT and prediction plates (the prediction the GT plus seeded noise),
    3 FOVs of (T=2, C=1, Z=2, 48, 48), nine nuclei a frame; a second GT
    channel name for the identity check."""
    root = tmp_path_factory.mktemp("plates")
    rng = np.random.default_rng(0)
    frames = {fov: np.stack([_nuclei_frame(rng) for _ in range(2)]) for fov in FOVS}
    paths = {}
    for side, noise in (("gt", 0.02), ("pred", 0.08)):
        plate = open_ome_zarr(root / f"{side}.zarr", layout="hcs", mode="w-", channel_names=["Nuclei"])
        for fov in FOVS:
            data = np.broadcast_to(frames[fov][:, None, None], (2, 1, 2, 48, 48)).astype(np.float32).copy()
            data += noise * rng.standard_normal(data.shape).astype(np.float32)
            plate.create_position("A", "1", fov).create_image("0", data)
        paths[side] = root / f"{side}.zarr"
    return paths


def _config(plates, out: Path, **overrides) -> dict:
    cfg = {
        "io": {"pred_path": str(plates["pred"]), "gt_path": str(plates["gt"]), "pred_channel_name": "Nuclei",
               "gt_channel_name": "Nuclei", "gt_cache_dir": str(out / "cache_gt"),
               "pred_cache_dir": str(out / "cache_pred")},
        "target_name": "nucleus",
        "spacing": [2.0, 0.5, 0.5],
        "compute_feature_metrics": True,
        "compute_instance_ap": True,
        "cell_similarity": {"metrics": ["pcc", "ssim"], "reduce": ["mean", "median"]},
        "pixel_metrics": {"spectral_pcc": {}, "fsc": {}, "multiband_ev": True},
        "feature_metrics": {"patch_size": 16, "cp": {"glcm": {"enabled": True}},
                            "dinov3": {"type": "random_projection", "dim": 8, "seed": 3},
                            "dynaclr": {"type": "random_projection", "dim": 8, "seed": 7}},
        "save": {"save_dir": str(out / "eval_out")},
        "runtime": {"executor": "serial"},
    }
    cfg.update(overrides)
    return cfg


@pytest.fixture
def jax_ordered(monkeypatch):
    """JAX's run with its results in submission order, its pixel metrics in
    float64, and its probe solved to the optimum (``OptimalLogistic``:
    sklearn's lbfgs stops short on a column a MAD of 0 scaled to 1e11, see
    ``test_torch_port_dynacell_features.py``); the port's probe to tol
    1e-10."""
    import sklearn.linear_model

    orig = jpipe.compute_pixel_metrics

    def pixel64(prediction, target, **kw):
        with numpy_float64(js, jm):
            return orig(np.asarray(prediction, np.float64), np.asarray(target, np.float64), **kw)

    monkeypatch.setattr(jpipe, "as_completed", lambda fs: list(fs))
    monkeypatch.setattr(jpipe, "compute_pixel_metrics", pixel64)
    monkeypatch.setattr(sklearn.linear_model, "LogisticRegression", OptimalLogistic)
    monkeypatch.setattr(tlp, "PROBE_TOL", 1e-10)


def _run_cli(*args) -> str:
    r = CliRunner().invoke(dynacell, ["--device", "cpu", *args], catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def _write(cfg: dict, path: Path) -> str:
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def _read_csv(path: Path) -> tuple[list[str], list[list[str]]]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _num(s: str) -> float:
    return float("nan") if s == "" else float(s)


def _fid_bound(column: str) -> float:
    """Per-(FOV, t) FIDs of nine cells in 8 to 22 dimensions are rank
    deficient: their zero eigenvalues are rounding, up to sqrt(eps lam) each
    (lam below 1e3 here), 22 of them at most."""
    return 2 * 22 * np.sqrt(np.finfo(float).eps * 1e3) if column.endswith("_FID") and \
        not column.startswith("Dataset_") else 0.0


def _close(column: str, got: float, want: float) -> bool:
    if np.isnan(want) or np.isnan(got):
        return np.isnan(want) and np.isnan(got)
    if "AUROC" in column or "Indistinguishability" in column:
        return abs(got - want) <= 1e-3 * (2 if "Indistinguishability" in column else 1)
    return abs(got - want) <= max(REL * abs(want), _fid_bound(column), 1e-15)


def _compare_csv(got_path: Path, want_path: Path, exact: bool = False) -> None:
    gh, grows = _read_csv(got_path)
    wh, wrows = _read_csv(want_path)
    assert gh == wh, (got_path.name, gh, wh)
    assert len(grows) == len(wrows)
    for g, w in zip(grows, wrows):
        for col, a, b in zip(gh, g, w):
            if col in ("FOV", "feature_type", "pair", "source", "skipped_reason") or exact:
                assert a.replace("/port/", "/") == b.replace("/jax/", "/"), (got_path.name, col, a, b)
            else:
                assert _close(col, _num(a), _num(b)), (got_path.name, col, a, b)


def _compare_outputs(got: Path, want: Path) -> None:
    _compare_csv(got / "mask_metrics.csv", want / "mask_metrics.csv", exact=True)
    _compare_csv(got / "pixel_metrics.csv", want / "pixel_metrics.csv")
    _compare_csv(got / "feature_metrics.csv", want / "feature_metrics.csv")
    for tier in ("mask", "pixel", "feature"):
        g = np.load(got / f"{tier}_metrics.npy", allow_pickle=True).tolist()
        w = np.load(want / f"{tier}_metrics.npy", allow_pickle=True).tolist()
        assert [list(r) for r in g] == [list(r) for r in w]
        for rg, rw in zip(g, w):
            for k in rw:
                if isinstance(rw[k], str):
                    assert rg[k] == rw[k]
                else:
                    assert _close(k, float(rg[k]), float(rw[k])), (tier, k, rg[k], rw[k])
    assert json.loads((got / "cp_selected_feature_mask.json").read_text()) == \
        json.loads((want / "cp_selected_feature_mask.json").read_text())
    names = sorted(p.name for p in (want / "embeddings").iterdir())
    assert names == sorted(p.name for p in (got / "embeddings").iterdir()) and len(names) == 6
    for name in names:
        with np.load(got / "embeddings" / name) as a, np.load(want / "embeddings" / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["embeddings", "fov", "timepoint"]
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k])
    timing = lambda p: {tuple(r[:3]) for r in _read_csv(p / "timings.csv")[1]}  # noqa: E731
    assert timing(got) == timing(want)


def test_evaluate_equals_jax_and_the_caches(plates, tmp_path, jax_ordered):
    want_cfg = _config(plates, tmp_path / "jax")
    jpipe.evaluate_model(want_cfg)
    cfg = _config(plates, tmp_path / "port")
    assert "evaluated: 6 pixel rows, 6 mask rows, 6 feature rows" in _run_cli("evaluate", "-c",
                                                                                _write(cfg, tmp_path / "e.yml"))
    got, want = tmp_path / "port" / "eval_out", tmp_path / "jax" / "eval_out"
    _compare_outputs(got, want)
    pixel = _read_csv(got / "pixel_metrics.csv")
    assert pixel[0][:2] == ["FOV", "Timepoint"] and [r[0] for r in pixel[1]] == [f"A/1/{f}" for f in FOVS
                                                                              for _ in range(2)]
    # the port's cache holds JAX's files, layout and manifest
    for side in ("gt", "pred"):
        port_files = sorted(p.relative_to(tmp_path / "port").as_posix().split("/", 1)[1]
                            for p in (tmp_path / "port" / f"cache_{side}").rglob("*.npy"))
        jax_files = sorted(p.relative_to(tmp_path / "jax").as_posix().split("/", 1)[1]
                           for p in (tmp_path / "jax" / f"cache_{side}").rglob("*.npy"))
        assert port_files == jax_files and port_files
        for rel in port_files:
            np.testing.assert_array_equal(np.load(tmp_path / "port" / f"cache_{side}" / rel),
                                          np.load(tmp_path / "jax" / f"cache_{side}" / rel))
        pm, jmf = load_manifest(cache_paths(tmp_path / "port" / f"cache_{side}")), \
            load_manifest(cache_paths(tmp_path / "jax" / f"cache_{side}"))
        assert pm["artifacts"].keys() == jmf["artifacts"].keys()
        for k, v in jmf["artifacts"].items():
            assert pm["artifacts"][k]["params"] == v["params"] and pm["artifacts"][k]["positions"] == v["positions"]
    # the final-metrics cache: a second evaluate returns the saved rows and writes nothing
    assert tpipe._final_metrics_cache_valid(cfg)
    stamp = {p: p.stat().st_mtime_ns for p in got.iterdir() if p.is_file()}
    pixel_rows, mask_rows, _ = tpipe.evaluate_model(cfg, device="cpu")
    assert len(pixel_rows) == len(mask_rows) == 6
    assert all(p.stat().st_mtime_ns == m for p, m in stamp.items())
    assert not tpipe._final_metrics_cache_valid({**cfg, "force_recompute": {"final_metrics": True}})
    # a re-run that misses the final cache reuses every cached GT mask, instance and feature
    gt_cache = tmp_path / "port" / "cache_gt"
    mtimes = {p: p.stat().st_mtime_ns for p in gt_cache.rglob("*.npy")}
    tpipe.evaluate_predictions(cfg, device="cpu")
    assert all(p.stat().st_mtime_ns == m for p, m in mtimes.items())
    # the cache's identity: another GT plate raises
    bad = _config(plates, tmp_path / "port")
    bad["io"]["gt_path"] = str(plates["pred"])
    with pytest.raises(StaleCacheError, match="gt.plate_path"):
        tpipe.evaluate_predictions(bad, device="cpu")
    # require_complete_cache with a missing artifact raises
    strict = _config(plates, tmp_path / "strict")
    strict["io"]["require_complete_cache"] = True
    with pytest.raises(StaleCacheError, match="require_complete_cache"):
        tpipe.evaluate_predictions(strict, device="cpu")


def test_precompute_gt_then_evaluate_hits_the_cache(plates, tmp_path, jax_ordered):
    cfg = _config(plates, tmp_path)
    cfg["build"] = {"masks": True, "instances": True, "cp_features": True, "deep_features": True}
    out = _run_cli("precompute-gt", "-c", _write(cfg, tmp_path / "pre.yml"))
    counts = json.loads(out)
    assert counts == jpipe.precompute_gt_artifacts(_config(plates, tmp_path / "jax", build=cfg["build"]))
    assert counts == {"masks": 3, "instances": 3, "cp_features": 6, "deep_features": 12}
    cache = tmp_path / "cache_gt"
    mtimes = {p: p.stat().st_mtime_ns for p in cache.rglob("*.np*")}
    _run_cli("evaluate", "-c", _write(cfg, tmp_path / "e.yml"))
    assert all(p.stat().st_mtime_ns == m for p, m in mtimes.items())
    # the JAX package's evaluate reads the port's GT cache, and the port JAX's
    jpipe.evaluate_model(_config(plates, tmp_path, save={"save_dir": str(tmp_path / "jax_out")}))
    assert all(p.stat().st_mtime_ns == m for p, m in mtimes.items())
    _compare_outputs(tmp_path / "eval_out", tmp_path / "jax_out")
    cfg["io"].pop("gt_cache_dir")
    with pytest.raises(ValueError, match="gt_cache_dir"):
        tpipe.precompute_gt_artifacts(cfg, device="cpu")


def test_evaluate_grouped_and_the_cross_condition_probe(plates, tmp_path, jax_ordered):
    cfg = _config(plates, tmp_path / "port", conditions={"mock": {}, "denv": {}})
    cfg["feature_metrics"]["cp"]["glcm"]["enabled"] = False
    assert "evaluated conditions: ['mock', 'denv']" in _run_cli("evaluate-grouped", "-c",
                                                                _write(cfg, tmp_path / "g.yml"))
    jcfg = _config(plates, tmp_path / "jax", conditions={"mock": {}, "denv": {}})
    jcfg["feature_metrics"]["cp"]["glcm"]["enabled"] = False
    jpipe.evaluate_predictions_grouped(jcfg)
    got, want = tmp_path / "port" / "eval_out", tmp_path / "jax" / "eval_out"
    _compare_csv(got / "eval_denv" / "cross_condition_probe.csv", want / "eval_denv" / "cross_condition_probe.csv")
    assert not (got / "eval_mock" / "cross_condition_probe.csv").exists()
    header, rows = _read_csv(got / "eval_denv" / "cross_condition_probe.csv")
    assert len(rows) == 8 and {r[header.index("source")] for r in rows} == {"pred", "gt"}
    out = tmp_path / "probe.csv"
    _run_cli("cross-condition-probe", "-d", str(got / "eval_mock"), "-d", str(got / "eval_denv"), "-o", str(out),
             "--n-splits", "3")
    from viscy_tpu.apps.dynacell.eval.cross_condition import run

    run([want / "eval_mock", want / "eval_denv"], tmp_path / "jprobe.csv", n_splits=3)
    _compare_csv(out, tmp_path / "jprobe.csv")


def test_cli_routes_and_refuses(tmp_path):
    out = _run_cli("--help")
    for sub in ("evaluate", "evaluate-grouped", "precompute-gt", "cross-condition-probe", "fit", "predict", "report"):
        assert sub in out
    for sub in ("report", "spectral-eval", "simulate-beads", "spectral-diagnostic", "spectral-plot-combined",
                "shading-analysis"):
        r = CliRunner().invoke(dynacell, [sub, "-c", "x.yml"])
        assert isinstance(r.exception, NotImplementedError) and sub in str(r.exception), sub
    r = CliRunner().invoke(dynacell, ["fit", "-c", "missing.yml"])  # viscy-torch fit checks its config
    assert r.exit_code != 0 and "missing.yml" in str(r.exception) + r.output
    cfg = _write({"save": {"save_dir": str(tmp_path / "out")}}, tmp_path / "c.yml")
    r = CliRunner().invoke(dynacell, ["evaluate", "-c", cfg])  # the card by default: refused without one
    assert isinstance(r.exception, RuntimeError) and "torch.cuda.is_available() is False" in str(r.exception)


def test_jax_results_come_back_in_hash_order(plates, tmp_path, monkeypatch):
    """JAX's serial executor finishes every future at submit and
    ``as_completed`` yields them from a set: in the order of the futures'
    hashes, that is of their object ids. With hashes that rise in submission
    order JAX lists the last FOV first; the port keeps the plate's order."""
    import concurrent.futures

    class Rising(concurrent.futures.Future):
        count = 0

        def __init__(self):
            super().__init__()
            Rising.count += 1
            self.key = Rising.count

        def __hash__(self):
            return self.key

    monkeypatch.setattr(jruntime, "Future", Rising)
    cfg = _config(plates, tmp_path, compute_feature_metrics=False, compute_instance_ap=False,
                  pixel_metrics={}, cell_similarity=None)
    pixel, _, _ = jpipe.evaluate_predictions(cfg)
    assert [r["FOV"] for r in pixel][::2] == [f"A/1/{f}" for f in reversed(FOVS)]
    pixel, _, _ = tpipe.evaluate_predictions(cfg, device="cpu")
    assert [r["FOV"] for r in pixel][::2] == [f"A/1/{f}" for f in FOVS]


def test_jax_serial_timings_repeat_the_earlier_fovs(plates, tmp_path):
    """JAX's serial FOVs all log into the main thread's timing list, and each
    result hands back the whole list so far, which the run appends again:
    in ``timings.csv`` the k-th (from 0) of N FOVs appears N - k + 1 times.
    The port gives each FOV its own log: once (a mask row per timepoint)."""
    from collections import Counter

    cfg = _config(plates, tmp_path, compute_feature_metrics=False, compute_instance_ap=False, pixel_metrics={},
                  cell_similarity=None, runtime={"executor": "serial"})
    jpipe.evaluate_predictions({**cfg, "save": {"save_dir": str(tmp_path / "jax")}})
    tpipe.evaluate_predictions({**cfg, "save": {"save_dir": str(tmp_path / "port")}}, device="cpu")
    for side, want in (("jax", {f"A/1/{f}": 2 * (len(FOVS) - i + 1) for i, f in enumerate(FOVS)}),
                       ("port", {f"A/1/{f}": 2 for f in FOVS})):
        rows = _read_csv(tmp_path / side / "timings.csv")[1]
        counts = Counter((r[0], r[2]) for r in rows)
        assert {pos: counts[(pos, "mask")] for pos in want} == want, side
