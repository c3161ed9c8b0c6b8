"""The port's dataset-level linear probe and DynaCLR's linear-classifier
pipelines (``run-linear-classifiers``, ``cross-validate-datasets``) against
viscy_tpu's, on the CPU.

- The splits: ``train_test_split`` (stratified) and ``GroupShuffleSplit``
  rows equal to sklearn's at several row counts, and their ``ValueError``
  messages equal.
- The probe: the port's objective (liblinear's or lbfgs's, evaluated on
  both solutions) at or below JAX's plus 1e-6 relative, probabilities within
  1e-3, metrics equal on seeded data; liblinear's multi-class refusal with
  sklearn's words.
- The two subcommands through click's runner on copies of the same seeded
  stores (the port's with ``--device cpu``): their CSVs equal to JAX's,
  numbers within 1e-6 relative, ``trained_at`` aside.
- A JAX pipeline with PCA and a liblinear intercept carried across:
  ``predict_proba`` within 1e-12.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from click.testing import CliRunner
from sklearn.metrics import average_precision_score, classification_report, roc_auc_score
from sklearn.model_selection import GroupShuffleSplit, train_test_split

from viscy_tpu.apps.dynaclr import cli as jcli
from viscy_tpu.evaluation import linear_classifier as jlc
from viscy_tpu.evaluation.anndata_lite import AnnDataLite as JAnnData
from viscy_tpu_torch.apps.dynaclr import cli as tcli
from viscy_tpu_torch.apps.dynaclr.linear_classifiers import cross_validation as tcv
from viscy_tpu_torch.evaluation import linear_classifier as tlc
from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite, Frame
from viscy_tpu_torch.training.callbacks.embedding_writer import write_embedding_dataset
from viscy_tpu_torch.training.convert import linear_pipeline_from_jax

import _torch_port_helpers  # noqa: F401  (one torch thread a worker)

D = 12
N_EXP = 4
SHIFT = 10.0


# -- the splits and the metrics ------------------------------------------------------------------


@pytest.mark.parametrize("n", [15, 37, 101, 240])
@pytest.mark.parametrize("train_size", [0.5, 0.8])
def test_the_splits_draw_sklearns_rows(n, train_size):
    rng = np.random.default_rng(n)
    y = np.asarray([f"c{i}" for i in rng.integers(0, 3, n)], dtype=object)
    y[:6] = ["c0", "c0", "c1", "c1", "c2", "c2"]
    want = train_test_split(np.arange(n), train_size=train_size, stratify=y, shuffle=True, random_state=n)
    got = tlc.train_test_split_rows(y, train_size, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    groups = np.asarray([f"A/1/{i % 7}" for i in rng.permutation(n)], dtype=object)
    want = next(GroupShuffleSplit(n_splits=1, train_size=train_size, random_state=n).split(y, y, groups=groups))
    for g, w in zip(tlc.group_shuffle_split(groups, train_size, n), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("y,train_size", [(["a", "a", "b", "b", "c"], 0.8), (["a", "b"] * 3, 0.2),
                                          (["a", "b"] * 4 + ["c"] * 2, 0.8), (["a", "b"] * 3, 0.05)])
def test_the_split_errors_are_sklearns(y, train_size):
    y = np.asarray(y, dtype=object)
    with pytest.raises(ValueError) as want:
        train_test_split(np.arange(len(y)), train_size=train_size, stratify=y, shuffle=True, random_state=0)
    with pytest.raises(ValueError) as got:
        tlc.train_test_split_rows(y, train_size, 0)
    assert str(got.value) == str(want.value)


def test_the_report_auroc_and_average_precision_are_sklearns():
    rng = np.random.default_rng(3)
    y = np.asarray([f"k{i}" for i in rng.integers(0, 3, 200)], dtype=object)
    pred = np.where(rng.random(200) < 0.7, y, "k1").astype(object)
    pred[:3] = "k9"  # a label never true: precision defined, recall 0 by zero_division
    want = classification_report(y, pred, output_dict=True, zero_division=0)
    got = tlc.classification_report(y, pred)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k] == pytest.approx(v, rel=1e-12)
        else:
            assert got[k] == pytest.approx(v, rel=1e-12)
    proba = rng.dirichlet(np.ones(3), 200)
    proba[:40] = np.round(proba[:40], 1)  # ties
    proba /= proba.sum(axis=1, keepdims=True)
    assert tlc.roc_auc(y, proba) == pytest.approx(roc_auc_score(y, proba, multi_class="ovr", average="macro"),
                                                  rel=1e-12)
    yb = np.where(y == "k0", "pos", "neg").astype(object)
    score = np.round(proba[:, 0], 2)
    assert tlc.roc_auc(yb, score) == pytest.approx(roc_auc_score(yb, score), rel=1e-12)
    pos = (yb == "pos").astype(int)
    assert tlc.average_precision(pos, score) == pytest.approx(average_precision_score(pos, score), rel=1e-12)
    with pytest.raises(ValueError):
        tlc.roc_auc(np.asarray(["a"] * 4, dtype=object), np.arange(4.0))


# -- the probe ------------------------------------------------------------------------------------


def _labelled(seed, n=240, k=2):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, n)
    X = rng.normal(size=(n, D))
    X[:, :k] += SHIFT * np.eye(k)[codes]  # separable: both solvers rank every row alike
    y = np.asarray([f"c{c}" for c in codes], dtype=object)
    fov = np.asarray([f"A/{i % 3}/{i % 8}" for i in range(n)], dtype=object)
    return X.astype(np.float32), y, fov


def _objective(pipe_coef, pipe_intercept, x, y, solver):
    classes, codes = np.unique(y, return_inverse=True)
    w = torch.as_tensor(np.concatenate([pipe_coef, pipe_intercept[:, None]], axis=1), dtype=torch.float64)
    return float(tlc.logistic_objective(w, torch.as_tensor(x, dtype=torch.float64), codes, len(classes), solver))


@pytest.mark.parametrize("k,solver,grouped,pca", [(2, "liblinear", False, None), (2, "liblinear", True, 6),
                                                  (3, "lbfgs", False, None), (2, "lbfgs", True, None),
                                                  (3, "lbfgs", True, 0.7)])
def test_the_probe_matches_jax(k, solver, grouped, pca):
    """Both fits on the same split: the port's objective, evaluated at both
    solutions on the same training rows, is at or below JAX's (+1e-6
    relative); probabilities within 1e-3; every metric equal."""
    X, y, fov = _labelled(k * 10 + grouped, k=k)
    params = dict(max_iter=1000, class_weight="balanced", solver=solver)
    groups = fov if grouped else None
    kw = dict(use_pca=pca is not None, n_pca_components=pca, classifier_params=params, groups=groups)
    jp, jm, jv = jlc.train_linear_classifier_anndata(JAnnData(X=X, obs=pd.DataFrame({"task": y})), "task", **kw)
    tp, tm, tv = tlc.train_linear_classifier_anndata(AnnDataLite(X, Frame({"task": y})), "task", device="cpu", **kw)
    assert list(tm) == list(jm)
    for key, want in jm.items():
        assert tm[key] == pytest.approx(want, rel=1e-12), key
    np.testing.assert_array_equal(tv["y_val"], jv["y_val"])
    assert tv["classes"] == jv["classes"]
    np.testing.assert_allclose(tv["y_val_proba"], jv["y_val_proba"], atol=1e-3)
    np.testing.assert_allclose(tp.predict_proba(X), jp.predict_proba(X), atol=1e-3)
    # the training rows as the port transforms them (JAX's scaler and PCA keep float32: within 1e-4)
    tr = (tlc.group_shuffle_split(fov, 0.8, 42) if grouped else tlc.train_test_split_rows(y, 0.8, 42))[0]
    xs = tp.transform(X)[tr]
    np.testing.assert_allclose(xs, jp.transform(X)[tr], atol=1e-4)
    clf = jp.classifier
    mine = _objective(tp.coef, tp.intercept, xs, y[tr], solver)
    theirs = _objective(clf.coef_, clf.intercept_, xs, y[tr], solver)
    assert mine <= theirs * (1 + 1e-6)
    assert tp.objective == pytest.approx(mine, rel=1e-12)


def test_liblinear_refuses_three_classes_with_sklearns_words():
    X, y, _ = _labelled(5, k=3)
    kw = dict(classifier_params=dict(solver="liblinear"))
    with pytest.raises(ValueError) as want:
        jlc.train_linear_classifier_anndata(JAnnData(X=X, obs=pd.DataFrame({"task": y})), "task", **kw)
    with pytest.raises(ValueError) as got:
        tlc.train_linear_classifier_anndata(AnnDataLite(X, Frame({"task": y})), "task", device="cpu", **kw)
    assert str(got.value) == str(want.value) == tlc.LIBLINEAR_MULTICLASS


def test_a_jax_pipeline_with_pca_and_a_liblinear_intercept_carries_across(tmp_path):
    X, y, _ = _labelled(7)
    jp, _, _ = jlc.train_linear_classifier_anndata(
        JAnnData(X=X, obs=pd.DataFrame({"task": y})), "task", use_pca=True, n_pca_components=5,
        classifier_params=dict(solver="liblinear"))
    assert jp.pca is not None and jp.classifier.intercept_[0] != 0
    port = linear_pipeline_from_jax(jp, device="cpu")
    port.save(tmp_path / "p.npz")
    back = tlc.LinearClassifierPipeline.load(tmp_path / "p.npz", device="cpu")
    Xq = np.random.default_rng(8).normal(size=(50, D))  # float64: sklearn keeps float32 inputs in float32
    np.testing.assert_allclose(back.predict_proba(Xq), jp.predict_proba(Xq), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(back.predict(Xq), jp.predict(Xq))


# -- the two subcommands --------------------------------------------------------------------------


def _experiment(root, exp, seed):
    """One experiment's store (2 FOVs x 8 tracks x 6 frames, two markers)
    and its annotation CSV: ``infected`` from the condition (a missing and an
    unknown cell among them), ``state`` of three classes."""
    rng = np.random.default_rng(seed)
    centres = np.random.default_rng(99).normal(size=(3, D)) * 8.0  # separable: every solver ranks rows alike
    feats, index, ann = [], [], []
    for f in range(2):
        for tr in range(8):
            cond, state = (tr + f) % 2, (tr + seed) % 3
            x = centres[state] + 12.0 * cond * np.eye(D)[D - 1] + rng.normal(size=D) * 0.6
            for t in range(6):
                x = x + rng.normal(size=D) * 0.15
                feats.append(x.copy())
                cid = 1000 * seed + 100 * f + 10 * tr + t
                index.append(dict(fov_name=f"B/{f}/0", track_id=tr, t=t, id=cid, experiment=exp,
                                  marker=f"m{tr % 2}"))
                ann.append(dict(fov_name=f"B/{f}/0", id=cid, t=t, track_id=tr,
                                infected="yes" if cond else "no", state=f"s{state}"))
    ann[3]["infected"], ann[9]["infected"] = "unknown", ""
    write_embedding_dataset(root / "combined" / f"{exp}.zarr", np.asarray(feats, np.float32), index)
    shutil.copytree(root / "combined" / f"{exp}.zarr", root / exp / "Phase3D.zarr")
    pd.DataFrame(ann).to_csv(root / f"{exp}.csv", index=False)


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lc")
    for side in ("j", "t"):
        (tmp / side / "combined").mkdir(parents=True)
        for i in range(N_EXP):
            _experiment(tmp / side, f"exp{i}", i)
    return tmp


def _csv_close(got_path, want_path, rel=1e-6, skip=()):
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        if c in skip:
            continue
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if want[c].dtype.kind in "fi" and got[c].dtype.kind in "fi":
            g, w = g.astype(float), w.astype(float)
            assert np.array_equal(np.isnan(g), np.isnan(w)), c
            np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=rel, atol=1e-12, err_msg=c)
        elif c == "temporal_metrics":
            for a, b in zip(g, w):
                assert isinstance(a, str) == isinstance(b, str)
                if isinstance(b, str):
                    a, b = json.loads(a), json.loads(b)
                    assert a.keys() == b.keys()
                    for k in b:
                        assert [x is None for x in a[k]] == [x is None for x in b[k]], k
                        np.testing.assert_allclose([x for x in a[k] if x is not None],
                                                   [x for x in b[k] if x is not None], rtol=rel, err_msg=k)
        else:
            assert [str(v) for v in g] == [str(v) for v in w], c


def _lc_config(root, **extra):
    cfg = dict(embeddings_path=str(root / "combined"), output_dir=str(root / "lc_out"),
               annotations=[dict(experiment=f"exp{i}", path=str(root / f"exp{i}.csv")) for i in range(N_EXP)],
               tasks=[dict(task="infected"), dict(task="state", marker_filters=["m0", None])],
               split_groups_by=["fov_name", "track_id"], publish_dir=str(root / "registry"), **extra)
    path = root / "lc.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("solver", ["liblinear", "lbfgs"])
def test_run_linear_classifiers_matches_jax(experiments, solver):
    """JAX's defaults (liblinear) train the binary task per marker and skip
    the three-class one; with lbfgs both train. The port writes the same
    ``metrics_summary.csv``, ``.npz`` pipelines named in the manifest and the
    published ``v{n}`` with ``latest``, then raises at the figures."""
    runner = CliRunner()
    extra = {} if solver == "liblinear" else dict(solver="lbfgs", use_pca=True, n_pca_components=6)
    for side in ("j", "t"):
        shutil.rmtree(experiments / side / "lc_out", ignore_errors=True)
    j = runner.invoke(jcli.main, ["run-linear-classifiers", "-c", _lc_config(experiments / "j", **extra)],
                      catch_exceptions=False)
    assert j.exit_code == 0, j.output
    with pytest.raises(NotImplementedError, match=r"summary_infected\.pdf.*Queue 1 item 9"):
        runner.invoke(tcli.main, ["--device", "cpu", "run-linear-classifiers", "-c",
                                  _lc_config(experiments / "t", **extra)], catch_exceptions=False)
    jout, tout = experiments / "j" / "lc_out", experiments / "t" / "lc_out"
    _csv_close(tout / "metrics_summary.csv", jout / "metrics_summary.csv")
    rows = pd.read_csv(tout / "metrics_summary.csv")
    want_tasks = ["infected", "infected"] + ([] if solver == "liblinear" else ["state", "state"])
    assert rows["task"].tolist() == want_tasks
    jman, tman = (json.loads((d / "pipelines" / "manifest.json").read_text()) for d in (jout, tout))
    assert [p["path"].replace(".joblib", ".npz") for p in jman["pipelines"]] == [p["path"] for p in tman["pipelines"]]
    for p in tman["pipelines"]:
        assert (tout / "pipelines" / p["path"]).exists()
    latest = experiments / "t" / "registry" / "latest"
    assert latest.is_symlink() and (latest / "manifest.json").exists()
    assert sorted(p.name for p in latest.iterdir()) == sorted([p["path"] for p in tman["pipelines"]] + ["manifest.json"])


def _cv_config(root, out, **extra):
    datasets = [dict(name=f"exp{i}", embeddings_dir=str(root / f"exp{i}"), annotations=str(root / f"exp{i}.csv"))
                for i in range(N_EXP)]
    cfg = dict(models={"model_a": dict(datasets=datasets)}, output_dir=str(root / out), channels=["Phase3D"],
               n_bootstrap=1, min_class_samples=60, marker="Phase3D", **extra)
    path = root / f"{out}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("solver", ["liblinear", "lbfgs"])
def test_cross_validate_datasets_matches_jax(experiments, solver):
    """Both tasks over four datasets: with liblinear the three-class folds
    are rows with sklearn's error, as in JAX; ``min_class_samples`` makes
    some leave-one-out pools unsafe. The three CSVs equal JAX's."""
    runner = CliRunner()
    extra = {} if solver == "liblinear" else dict(solver="lbfgs")
    out = f"cv_{solver}"
    j = runner.invoke(jcli.main, ["cross-validate-datasets", "-c", _cv_config(experiments / "j", out, **extra)],
                      catch_exceptions=False)
    t = runner.invoke(tcli.main, ["--device", "cpu", "cross-validate-datasets", "-c",
                                  _cv_config(experiments / "t", out, **extra)], catch_exceptions=False)
    assert j.exit_code == 0 and t.exit_code == 0, (j.output, t.output)
    jout, tout = experiments / "j" / out, experiments / "t" / out
    for name in ("cv_results.csv", "cv_summary.csv", "cv_recommended_subsets.csv"):
        _csv_close(tout / name, jout / name)
    res = pd.read_csv(tout / "cv_results.csv")
    assert (res["impact"] == "unsafe").any()
    errors = res["error"].dropna().unique().tolist() if "error" in res else []
    assert errors == ([tlc.LIBLINEAR_MULTICLASS] if solver == "liblinear" else [])


def test_cv_refuses_the_report_and_raises_on_a_missing_store(experiments, tmp_path):
    runner = CliRunner()
    cfg = _cv_config(experiments / "t", "cv_report")
    with pytest.raises(NotImplementedError, match="matplotlib"):
        runner.invoke(tcli.main, ["--device", "cpu", "cross-validate-datasets", "-c", cfg, "--report"],
                      catch_exceptions=False)
    assert not (experiments / "t" / "cv_report").exists()  # refused before any work
    # a fold whose test store cannot be read: JAX writes the error into the row; the port raises
    pool = [dict(embeddings=str(experiments / "t" / f"exp{i}" / "Phase3D.zarr"),
                 annotations=str(experiments / "t" / f"exp{i}.csv")) for i in (1, 2)]
    missing = dict(embeddings=str(tmp_path / "nowhere.zarr"), annotations=str(experiments / "t" / "exp0.csv"))
    with pytest.raises(FileNotFoundError):
        tcv._train_and_evaluate(dict(solver="lbfgs"), "m", "infected", "Phase3D", pool, missing, "exp0", 42,
                                device="cpu")


def test_jax_pca_is_randomized_and_not_repeatable_where_the_ports_is_exact():
    """``PCA(n_components)`` without a ``random_state``: above 500 rows and
    columns, with fewer than 10 x n_features rows and few components,
    sklearn's ``auto`` solver is randomized, so JAX's probe projects onto
    other components on each run. The port's PCA is the exact SVD: the
    same bits every run."""
    rng = np.random.default_rng(11)
    X = (rng.normal(size=(520, 40)) @ rng.normal(size=(40, 60)) + rng.normal(size=(520, 60))).astype(np.float32)
    y = np.asarray([f"c{i % 2}" for i in range(520)], dtype=object)
    kw = dict(use_pca=True, n_pca_components=5, classifier_params=dict(solver="liblinear"))
    j1, j2 = (jlc.train_linear_classifier_anndata(JAnnData(X=X, obs=pd.DataFrame({"task": y})), "task", **kw)[0]
              for _ in range(2))
    assert j1.pca._fit_svd_solver == "randomized"
    assert not np.array_equal(j1.pca.components_, j2.pca.components_)
    t1, t2 = (tlc.train_linear_classifier_anndata(AnnDataLite(X, Frame({"task": y})), "task", device="cpu", **kw)[0]
              for _ in range(2))
    assert np.array_equal(t1.pca_components, t2.pca_components)
    _, _, vt = np.linalg.svd((X - X.mean(0)) / X.std(0), full_matrices=False)
    np.testing.assert_allclose(np.abs(t1.pca_components), np.abs(vt[:5]), atol=1e-5)


def test_cv_rows_keep_the_order_of_submission_with_workers(experiments):
    """JAX collects the rows of ``n_workers > 1`` as they complete; the
    port keeps the order of submission, so the CSV is the serial run's."""
    outs = []
    for workers in (1, 3):
        out = f"cv_workers{workers}"
        cfg = _cv_config(experiments / "t", out, solver="lbfgs", n_workers=workers, task="infected")
        tcv.cross_validate(yaml.safe_load(Path(cfg).read_text()), device="cpu")
        outs.append((experiments / "t" / out / "cv_results.csv").read_text())
    assert outs[0] == outs[1]
