"""The port's config-driven DynaCLR subcommands (``evaluate-smoothness``,
``compare-models``, ``mmd-analysis``, ``prepare-eval-configs``,
``check-evals``, ``inspect-batches``) and ``training/cli_utils.py`` against
viscy_tpu's, on the CPU.

Both CLIs run through click's runner on copies of one seeded store (the
port's with ``--device cpu``). Text that both write from the same numbers
(the markdown tables, the pipe tables of ``compare-models -c``, the
configs and manifests) is held equal; the CSVs equal in their header,
strings and integers, their floats within 1e-9 relative (smoothness: the
same float64 distances by another route) or 1e-5 (MMD: JAX sums its
float32 kernels in float32, the port in float64), the permutation
p-values equal (the permutations are numpy's, drawn alike).
"""

import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from click.testing import CliRunner

from viscy_tpu.apps.dynaclr import cli as jcli
from viscy_tpu.apps.dynaclr import mmd_suite as jmmd
from viscy_tpu.apps.dynaclr import smoothness_benchmark as jsm
from viscy_tpu.training import cli_utils as jcu
from viscy_tpu_torch.apps.dynaclr import cli as tcli
from viscy_tpu_torch.apps.dynaclr import mmd_suite as tmmd
from viscy_tpu_torch.apps.dynaclr import smoothness_benchmark as tsm
from viscy_tpu_torch.training import cli_utils as tcu
from viscy_tpu_torch.training.callbacks.embedding_writer import write_embedding_dataset
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

import _torch_port_helpers  # noqa: F401  (one torch thread a worker)

D = 16


def _store(path, seed, n_fov=3, n_tracks=8, n_t=6, experiment=None):
    """Tracks drifting around a condition offset: 2 markers, 3
    conditions, hours post perturbation."""
    rng = np.random.default_rng(seed)
    offsets = rng.normal(size=(3, D))
    feats, index = [], []
    for f in range(n_fov):
        for tr in range(n_tracks):
            cond = (f + tr) % 3
            x = offsets[cond] * 0.6 + rng.normal(size=D)
            for t in range(n_t):
                x = x + rng.normal(size=D) * 0.2
                feats.append(x.copy())
                row = dict(fov_name=f"A/1/{f}", track_id=tr, t=t, id=100 * f + 10 * tr + t,
                           marker=f"m{tr % 2}", perturbation=f"cond{cond}", hours_post_perturbation=float(t) * 1.5)
                if experiment is not None:
                    row["experiment"] = experiment
                index.append(row)
    write_embedding_dataset(path, np.asarray(feats, np.float32), index)
    return path


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same stores twice, under ``j/`` and ``t/`` (the file names, and so
    every output name, alike)."""
    tmp = tmp_path_factory.mktemp("suites")
    for side in ("j", "t"):
        (tmp / side).mkdir()
        _store(tmp / side / "emb.zarr", 0)
        _store(tmp / side / "noisy.zarr", 1)
        _store(tmp / side / "exp_a.zarr", 2, experiment="exp_a")
        _store(tmp / side / "exp_b.zarr", 3, experiment="exp_b")
    return tmp


def _both(tmp, args_of, check_output=True):
    """Run both CLIs with ``args_of(side)``; their outputs."""
    runner = CliRunner()
    j = runner.invoke(jcli.main, args_of("j"), catch_exceptions=False)
    t = runner.invoke(tcli.main, ["--device", "cpu", *args_of("t")], catch_exceptions=False)
    assert j.exit_code == 0 and t.exit_code == 0, (j.output, t.output)
    out_j, out_t = j.output.replace(str(tmp / "j"), "@"), t.output.replace(str(tmp / "t"), "@")
    if check_output:
        assert out_t == out_j
    return out_j, out_t


def _csv_close(got_path, want_path, rel, exact=("p_value",)):
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if want[c].dtype.kind == "f" or got[c].dtype.kind == "f":
            g, w = g.astype(float), w.astype(float)
            assert np.array_equal(np.isnan(g), np.isnan(w)), c
            ok = ~np.isnan(w)
            if c in exact:
                np.testing.assert_array_equal(g[ok], w[ok], err_msg=c)
            else:
                np.testing.assert_allclose(g[ok], w[ok], rtol=rel, atol=1e-12, err_msg=c)
        else:
            assert [str(v) for v in g] == [str(v) for v in w], c


def _write(path, cfg: dict):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


# -- cli_utils --------------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(5))
def test_format_markdown_table_matches_jax(case):
    data, kw = [
        ({"smoothness_score": 0.12345, "n_steps": 40, "label": "a_b"}, {}),
        ({"x": 1.0}, dict(title="Summary", headers=["Name", "Number"])),
        ([{"model": "m1", "score": 0.5, "n": 3}, {"model": "m2", "score": float("nan"), "n": 4}], dict(title="T")),
        ([{"model": "m1", "score": 0.5}, {"model": "m2"}], dict(headers=["model", "score"])),
        ([], dict(title="empty")),
    ][case]
    assert tcu.format_markdown_table(data, **kw) == jcu.format_markdown_table(data, **kw)


def test_load_config_and_sections_match_jax(tmp_path):
    (tmp_path / "base.yml").write_text(yaml.safe_dump({"shared": 1, "a": {"x": 1, "y": {"z": 2}}}))
    (tmp_path / "c.yml").write_text(yaml.safe_dump({"base": ["base.yml"], "a": {"y": {"w": 3}}, "b": [1, 2],
                                                    "_anchor": 0}))
    path = tmp_path / "c.yml"
    assert tcu.load_config(path) == jcu.load_config(path)
    for section, default in (("a", None), (None, "a"), (None, "missing"), (None, None)):
        assert tcu.load_config_section(path, section, default) == jcu.load_config_section(path, section, default)
    for mod in (tcu, jcu):
        with pytest.raises(KeyError, match="not found"):
            mod.load_config_section(path, "nope")
        with pytest.raises(TypeError, match="mapping"):
            mod.load_config_section(path, "b")
    np.testing.assert_array_equal(tcu.to_numpy(torch.arange(3)), jcu.to_numpy(torch.arange(3)))


def test_csv_text_is_pandas_text():
    rows = [{"a": 1, "b": 0.1, "c": "x,y", "d": float("nan")}, {"a": 2, "b": 1e-20, "c": 'q"', "e": True}]
    assert tcu.rows_to_csv(rows) == pd.DataFrame(rows).to_csv(index=False)


# -- evaluate-smoothness and compare-models -----------------------------------------------------


@pytest.mark.parametrize("group_by", ["perturbation", None])
def test_evaluate_smoothness_matches_jax(stores, group_by):
    tmp = stores

    def args(side):
        cfg = {"models": [{"path": str(tmp / side / "emb.zarr"), "label": "base"},
                          {"path": str(tmp / side / "noisy.zarr"), "label": "noisy"}],
               "evaluation": {"output_dir": str(tmp / side / f"smooth_{group_by}"), "group_by": group_by,
                              "save_distributions": True, "save_plots": False}}
        return ["evaluate-smoothness", "-c", _write(tmp / side / f"smooth_{group_by}.yml", cfg)]

    _both(tmp, args)
    j, t = tmp / "j" / f"smooth_{group_by}", tmp / "t" / f"smooth_{group_by}"
    names = sorted(p.name for p in j.iterdir())
    assert sorted(p.name for p in t.iterdir()) == names
    for name in names:
        if name.endswith(".csv"):
            _csv_close(t / name, j / name, 1e-9)
            assert (t / name).read_text().splitlines()[0] == (j / name).read_text().splitlines()[0]
        else:
            np.testing.assert_allclose(np.load(t / name), np.load(j / name), rtol=1e-12)


def test_compare_models_live_and_from_result_files_match_jax(stores):
    tmp = stores
    _both(tmp, lambda side: ["compare-models", "--embeddings", str(tmp / side / "emb.zarr"), "--embeddings",
                             str(tmp / side / "noisy.zarr"), "--output", str(tmp / side / "live.md")])
    assert (tmp / "t" / "live.md").read_text() == (tmp / "j" / "live.md").read_text()
    # -c over the saved stats CSVs (JAX's, for both), in each output format
    src = tmp / "j" / "smooth_src"
    shutil.rmtree(src, ignore_errors=True)
    jsm.evaluate_smoothness(jsm.SmoothnessEvalConfig(
        models=[{"path": str(tmp / "j" / "emb.zarr"), "label": "base"},
                {"path": str(tmp / "j" / "noisy.zarr"), "label": "noisy"}], output_dir=str(src), save_plots=False))
    results = [{"path": str(src / "base_emb_smoothness_stats.csv"), "label": "base"},
               {"path": str(src / "noisy_noisy_smoothness_stats.csv"), "label": "noisy"},
               {"path": str(src / "missing.csv"), "label": "gone"}]
    for fmt in ("markdown", "csv", "json"):
        def args(side):
            cfg = {"result_files": results, "comparison": {"output_path": str(tmp / side / f"cmp.{fmt}"),
                                                           "output_format": fmt,
                                                           "metrics": ["smoothness_score", "dynamic_range",
                                                                       "n_steps", "not_a_metric"]}}
            return ["compare-models", "-c", _write(tmp / side / f"cmp_{fmt}.yml", cfg)]

        _both(tmp, args)
        got, want = (tmp / "t" / f"cmp.{fmt}").read_text(), (tmp / "j" / f"cmp.{fmt}").read_text()
        if fmt == "json":  # pandas' JSON writer rounds to 10 digits; the port writes json.dumps
            for label, row in json.loads(want).items():
                for k, v in row.items():
                    assert json.loads(got)[label][k] == pytest.approx(v, rel=1e-8), (label, k)
        elif fmt == "csv":  # pandas' C parser reads some numbers 1 ulp off; the port reads them exactly
            assert got.splitlines()[0] == want.splitlines()[0]
            _csv_close(tmp / "t" / "cmp.csv", tmp / "j" / "cmp.csv", 1e-15)
        else:
            assert got == want, fmt


def test_the_smoothness_configs_validate_and_refuse_plots(tmp_path):
    good = dict(models=[{"path": "a", "label": "b"}], output_dir=str(tmp_path / "out"))
    cfg = tsm.SmoothnessEvalConfig(**good)
    want = jsm.SmoothnessEvalConfig(**good)
    for name in ("distance_metric", "time_offsets", "save_distributions", "use_optimized", "verbose", "group_by"):
        assert getattr(cfg, name) == getattr(want, name), name
    assert want.save_plots is True and cfg.save_plots is False  # the port's departure
    with pytest.raises(NotImplementedError, match="matplotlib"):
        tsm.evaluate_smoothness(tsm.SmoothnessEvalConfig(**good, save_plots=True), device="cpu")
    assert not (tmp_path / "out").exists()  # refused before any work
    for bad, field in ((dict(good, models=[]), "models"), (dict(good, distance_metric="l1"), "distance_metric"),
                       (dict(good, models=[{"label": "x"}]), "path")):
        with pytest.raises(ValueError, match=field):
            tsm.SmoothnessEvalConfig(**bad)
    cmp = tsm.CompareModelsConfig(result_files=[{"path": "a", "label": "b"}])
    assert cmp.metrics == jsm.CompareModelsConfig(result_files=[{"path": "a", "label": "b"}]).metrics
    with pytest.raises(ValueError, match="output_format"):
        tsm.CompareModelsConfig(result_files=[{"path": "a", "label": "b"}], output_format="xml")


# -- mmd-analysis -----------------------------------------------------------------------------


MMD = {"n_permutations": 50, "max_cells": 60, "min_cells": 5, "seed": 3}
COMPARISONS = [{"cond_a": "cond0", "cond_b": "cond1", "label": "c0_c1"},
               {"cond_a": "cond0", "cond_b": "cond2", "label": "c0_c2"}]


@pytest.mark.parametrize("mode,extra", [
    ("per_experiment", {}),
    ("per_experiment", {"temporal_bin_size": 3.0, "mmd": dict(MMD, share_bandwidth_from="c0_c1"),
                        "map_settings": {"enabled": True, "null_size": 200}}),
    ("per_experiment", {"obs_filter": {"marker": "m1"}, "mmd": dict(MMD, balance_samples=True),
                        "embedding_key": None}),
    ("combined", {}),
    ("combined", {"temporal_bins": [0.0, 4.0, 9.0]}),
    ("pooled", {}),
])
def test_mmd_analysis_matches_jax(stores, mode, extra):
    tmp = stores
    tag = f"{mode}_{len(extra)}_{'_'.join(sorted(extra))}"

    def args(side):
        cfg = {"output_dir": str(tmp / side / f"mmd_{tag}"), "group_by": "perturbation", "mmd": MMD,
               "save_plots": False, **extra}
        if mode == "per_experiment":
            cfg.update(input_path=str(tmp / side / "emb.zarr"), comparisons=COMPARISONS)
        else:
            cfg["input_paths"] = [str(tmp / side / "exp_a.zarr"), str(tmp / side / "exp_b.zarr")]
            if mode == "pooled":
                cfg["comparisons"] = COMPARISONS
        return ["mmd-analysis", "-c", _write(tmp / side / f"mmd_{tag}.yml", cfg), "--mode", mode]

    _both(tmp, args)
    got, want = tmp / "t" / f"mmd_{tag}" / f"mmd_{mode}.csv", tmp / "j" / f"mmd_{tag}" / f"mmd_{mode}.csv"
    _csv_close(got, want, 1e-5)
    assert len(pd.read_csv(want)) >= 2


def test_the_mmd_configs_validate_and_refuse_plots(stores, tmp_path):
    raw = dict(input_path=str(stores / "t" / "emb.zarr"), comparisons=COMPARISONS, output_dir=str(tmp_path / "o"))
    cfg, want = tmmd.MMDEvalConfig(**raw), jmmd.MMDEvalConfig(**raw)
    for name in ("n_permutations", "max_cells", "min_cells", "seed", "balance_samples", "share_bandwidth_from"):
        assert getattr(cfg.mmd, name) == getattr(want.mmd, name), name
    for name in ("enabled", "distance", "null_size", "seed"):
        assert getattr(cfg.map_settings, name) == getattr(want.map_settings, name), name
    assert cfg.group_by == want.group_by and want.save_plots is True and cfg.save_plots is False
    with pytest.raises(ValueError, match="mutually exclusive"):
        tmmd.MMDEvalConfig(**raw, temporal_bin_size=1.0, temporal_bins=[0.0, 1.0])
    with pytest.raises(ValueError, match="comparisons"):
        tmmd.MMDEvalConfig(**{k: v for k, v in raw.items() if k != "comparisons"})
    (tmp_path / "plots.yml").write_text(yaml.safe_dump(dict(raw, save_plots=True)))
    with pytest.raises(NotImplementedError, match="matplotlib"):
        CliRunner().invoke(tcli.main, ["--device", "cpu", "mmd-analysis", "-c", str(tmp_path / "plots.yml")],
                           catch_exceptions=False)
    assert not (tmp_path / "o").exists()


# -- the evaluation pipeline, inspect-batches ---------------------------------------------------


def test_prepare_eval_configs_and_check_evals_match_jax(stores):
    tmp = stores

    def args(side):
        cfg = {"training_config": "configs/dynaclr_fit.yml", "output_dir": str(tmp / side / "pipeline"),
               "label_columns": ["state"], "group_column": "perturbation", "mmd_permutations": 100}
        return ["prepare-eval-configs", "-c", _write(tmp / side / "eval.yml", cfg)]

    _both(tmp, args)
    for name in ("predict.yaml", "smoothness.yaml", "mmd.yaml", "linear_classifiers.yaml", "eval.yaml",
                 "manifest.json"):
        got, want = ((tmp / s / "pipeline" / "configs" / name).read_text().replace(str(tmp / s), "@")
                     for s in ("t", "j"))
        assert got == want, name
    (tmp / "t" / "pipeline" / "mmd" / "mmd.csv").write_text("x\n")
    (tmp / "j" / "pipeline" / "mmd" / "mmd.csv").write_text("x\n")
    _both(tmp, lambda side: ["check-evals", "--output-dir", str(tmp / side / "pipeline"), "--output-dir",
                             str(tmp / side / "nothing")])


def test_inspect_batches_matches_jax(tmp_path):
    plate = tmp_path / "plate.zarr"
    build_hcs_plate(plate, ["Phase3D", "Nucleus"], zyx_shape=(3, 32, 32), num_timepoints=1, rows=("A",),
                    cols=("1",), fovs=("0", "1", "2", "3"), seed=5)
    cfg = {"data": {"class_path": "viscy_data.HCSDataModule",
                    "init_args": {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": ["Nucleus"],
                                  "z_window_size": 1, "batch_size": 2, "num_workers": 0, "yx_patch_size": [32, 32],
                                  "split_ratio": 0.5}}}
    path = _write(tmp_path / "data.yml", cfg)
    j, t = _both(tmp_path, lambda side: ["inspect-batches", "-c", path, "--num-batches", "2"], check_output=False)
    parse = lambda out: [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert len(parse(t)) == 2
    assert parse(t) == parse(j)
