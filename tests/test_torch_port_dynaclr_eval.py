"""The port's DynaCLR evaluation tail (the MLP embedder, embedding tracking
and ``python -m viscy_tpu_torch.apps.dynaclr.cli``) against viscy_tpu's, on
the CPU.

- MLP embedder: from JAX's initial params (carried by
  ``mlp_state_dict_from_flax``) and the same numpy draws, every epoch's
  validation loss within 1e-4 relative and accuracy within one row.
- Tracking: the links and the accuracy equal JAX's.
- The CLI: each ported subcommand through click's runner on copies of the
  same small store (the port's with ``--device cpu``), its printed result
  against the JAX CLI's (numbers to 1e-6 relative unless stated) and what it
  wrote into the store.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
from click.testing import CliRunner

from viscy_tpu.apps.dynaclr import cli as jcli
from viscy_tpu.apps.dynaclr import mlp_embedder as jmlp
from viscy_tpu.apps.dynaclr import tracking as jtrack
from viscy_tpu.evaluation import anndata_lite as jad
from viscy_tpu_torch.apps.dynaclr import cli as tcli
from viscy_tpu_torch.apps.dynaclr import mlp_embedder as tmlp
from viscy_tpu_torch.apps.dynaclr import tracking as ttrack
from viscy_tpu_torch.evaluation.anndata_lite import Frame, read_anndata_zarr
from viscy_tpu_torch.training.callbacks.embedding_writer import write_embedding_dataset
from viscy_tpu_torch.training.convert import mlp_state_dict_from_flax

N_FOV, N_TRACKS, N_T, D = 2, 6, 5, 12


def _template_rows(path):
    from viscy_tpu_torch.apps.dynaclr.pseudotime.io import load_template_flavor

    return load_template_flavor(path)[0].template


def _cells(seed=0):
    """Tracks drifting around 3 class centres: features, projections, the
    index rows and a label CSV's rows."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(3, D)) * 2
    feats, index, labels = [], [], []
    for f in range(N_FOV):
        for tr in range(N_TRACKS):
            c = (f + 2 * tr) % 3
            x = centres[c] + rng.normal(size=D) * 0.4
            y0, x0 = rng.uniform(50, 400, 2)
            for t in range(N_T):
                x = x + rng.normal(size=D) * 0.15
                feats.append(x.copy())
                cid = 1000 * f + 10 * tr + t
                index.append(dict(fov_name=f"/A/1/{f}/", track_id=3 + 7 * tr, t=t, id=cid, parent_track_id=-1,
                                  parent_id=-1, y=round(y0 + 4 * t, 2), x=round(x0 - 3 * t, 2)))
                labels.append(dict(id=cid, state=f"s{c}", condition=f"cond{(tr + f) % 2}", score=float(c) + 0.25))
    feats = np.asarray(feats, np.float32)
    return feats, feats @ rng.normal(size=(D, 4)).astype(np.float32), index, labels


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """Two copies of one store (JAX's and the port's), the label CSV, the
    annotation CSV, and the runner. JAX's numeric writes stay uncompressed."""
    monkeypatch.setattr(jad, "_write_numeric_ts", jad._write_array)
    feats, proj, index, labels = _cells()
    write_embedding_dataset(tmp_path / "base.zarr", feats, index, projections=proj, compute_pca=True,
                            device="cpu")
    pd.DataFrame(labels).to_csv(tmp_path / "labels.csv", index=False)
    ann = pd.DataFrame(index)[["fov_name", "t", "track_id", "y", "x"]].iloc[4:]
    ann["division"] = np.where(ann["t"] == 2, "yes", "no")
    ann.to_csv(tmp_path / "ann.csv", index=False)
    for name in ("j.zarr", "t.zarr"):
        shutil.copytree(tmp_path / "base.zarr", tmp_path / name)
    return tmp_path, CliRunner()


def _both(stores, args: list[str], jstore="j.zarr", tstore="t.zarr"):
    tmp, runner = stores
    ja = [str(a).replace("{S}", str(tmp / jstore)).replace("{D}", str(tmp / "j_out")) for a in args]
    ta = [str(a).replace("{S}", str(tmp / tstore)).replace("{D}", str(tmp / "t_out")) for a in args]
    j = runner.invoke(jcli.main, ja, catch_exceptions=False)
    t = runner.invoke(tcli.main, ["--device", "cpu", *ta], catch_exceptions=False)
    assert j.exit_code == 0 and t.exit_code == 0, (j.output, t.output)
    return j.output, t.output


def _json(out: str):
    return json.loads(out[out.index(next(c for c in out if c in "[{")):])


def _close(a, b, rel=1e-6, path=""):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _close(a[k], b[k], rel, f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, rel, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=rel, abs=1e-12) or (np.isnan(a) and np.isnan(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def knn_preservation(X: np.ndarray, emb: np.ndarray, k: int = 10) -> float:
    """The mean share of each row's k nearest rows in ``X`` that are among
    its k nearest in ``emb``."""
    def nearest(a):
        d = ((a[:, None].astype(np.float64) - a[None]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        return np.argsort(d, axis=1, kind="stable")[:, :k]

    a, b = nearest(X), nearest(emb)
    return float(np.mean([len(set(r) & set(s)) / k for r, s in zip(a, b)]))


def _append_labels(stores):
    _both(stores, ["append-obs", "--embeddings", "{S}", "--csv", str(stores[0] / "labels.csv")])


# -- the MLP embedder and tracking ----------------------------------------------------------------------------


def test_mlp_embedder_trains_as_jax_from_its_initial_params(tmp_path):
    feats, _, _, labels = _cells(1)
    y = np.asarray([r["state"] for r in labels])
    model = jmlp._build(D, (16, 8), 3)
    params = model.init(jax.random.PRNGKey(42), jnp.zeros((1, D)))["params"]
    _, want = jmlp.train_mlp_embedder(feats, y, hidden_dims=(16, 8), epochs=4, batch_size=16, seed=42)
    ckpt, got = tmlp.train_mlp_embedder(feats, y, hidden_dims=(16, 8), epochs=4, batch_size=16, seed=42,
                                        init_state=mlp_state_dict_from_flax(params), output_path=tmp_path / "m",
                                        device="cpu")
    n_val = int(len(feats) * 0.2)
    for w, g in zip(want["history"], got["history"]):
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-4)
        assert abs(g["val_acc"] - w["val_acc"]) <= 1 / n_val + 1e-6
    assert ckpt["classes"] == ["s0", "s1", "s2"]
    reps = tmlp.apply_mlp_embedder(feats, tmp_path / "m", device="cpu")
    assert reps.shape == (len(feats), 8) and np.allclose(np.linalg.norm(reps, axis=1), 1, atol=1e-5)
    (tmp_path / "j.msgpack").write_bytes(b"")
    (tmp_path / "j.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="msgpack"):
        tmlp.load_mlp_embedder(tmp_path / "j", device="cpu")


def test_the_mlp_bridge_reproduces_jaxs_encode_and_logits():
    import torch

    model = jmlp._build(D, (16, 8), 3)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, D)))["params"]
    x = np.random.default_rng(2).normal(size=(9, D)).astype(np.float32)
    port = tmlp._build(D, (16, 8), 3)
    port.load_state_dict(mlp_state_dict_from_flax(params))
    with torch.no_grad():
        for encode in (False, True):
            want = np.asarray(model.apply({"params": params}, jnp.asarray(x), encode=encode))
            np.testing.assert_allclose(port(torch.from_numpy(x), encode=encode).numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gate", [50.0, 8.0])
def test_tracking_links_match_jax(gate):
    feats, _, index, _ = _cells(2)
    df = pd.DataFrame(index)
    frame = Frame({k: (df[k].to_numpy().astype(object) if df[k].dtype == object else df[k].to_numpy())
                   for k in df.columns})
    want = jtrack.link_by_embedding(feats, df, spatial_gate=gate)
    got = ttrack.link_by_embedding(feats, frame, spatial_gate=gate, device="cpu")
    np.testing.assert_array_equal(got["linked_prev_row"], want["linked_prev_row"].to_numpy())
    assert ttrack.tracking_accuracy(got) == jtrack.tracking_accuracy(want)


# -- the CLI --------------------------------------------------------------------------------------------------


def test_info_append_obs_and_split(stores):
    tmp, _ = stores
    j, t = _both(stores, ["info", "--embeddings", "{S}"])
    assert _json(t) == _json(j)
    j, t = _both(stores, ["append-obs", "--embeddings", "{S}", "--csv", str(tmp / "labels.csv"), "--columns",
                          "state,score", "--prefix", "gt_"])
    assert _json(t) == _json(j)
    jo, to = jad.read_anndata_zarr(tmp / "j.zarr").obs, read_anndata_zarr(tmp / "t.zarr").obs
    assert to.names == list(jo.columns)
    for c in to.names:
        assert [str(v) for v in to[c]] == [str(v) for v in jo[c].to_numpy()], c
    j, t = _both(stores, ["split-embeddings", "--embeddings", "{S}", "--column", "fov_name", "--output-dir", "{D}"])
    assert t.replace(str(tmp / "t_out"), "") == j.replace(str(tmp / "j_out"), "")
    for part in ("A/1/0", "A/1/1"):
        jp, tp = jad.read_anndata_zarr(tmp / "j_out" / part), read_anndata_zarr(tmp / "t_out" / part)
        np.testing.assert_array_equal(tp.X, jp.X)
        np.testing.assert_array_equal(tp.obsm["X_projections"], jp.obsm["X_projections"])


def test_annotations_and_the_waiting_subcommands(stores):
    tmp, runner = stores
    j, t = _both(stores, ["append-annotations", "--embeddings", "{S}", "--csv", str(tmp / "ann.csv")])
    assert _json(t) == _json(j)
    jo, to = jad.read_anndata_zarr(tmp / "j.zarr").obs, read_anndata_zarr(tmp / "t.zarr").obs
    assert [str(v) for v in to["division"]] == [str(v) for v in jo["division"].to_numpy()]
    for name, args in (("apply-classifier", ["--embeddings", "x"]), ("align-pseudotime", []),
                       ("evaluate-pseudotime", [])):
        with pytest.raises(NotImplementedError, match=name):
            runner.invoke(tcli.main, ["--device", "cpu", name, *args], catch_exceptions=False)
    # ported now: run-linear-classifiers needs the experiment and marker columns (JAX's error, word for word) ...
    (tmp / "lc.yml").write_text(f"embeddings_path: {tmp / 't.zarr'}\noutput_dir: {tmp / 'lc'}\n")
    with pytest.raises(ValueError) as want:
        runner.invoke(jcli.main, ["run-linear-classifiers", "-c", str(tmp / "lc.yml")], catch_exceptions=False)
    with pytest.raises(ValueError) as got:
        runner.invoke(tcli.main, ["--device", "cpu", "run-linear-classifiers", "-c", str(tmp / "lc.yml")],
                      catch_exceptions=False)
    assert str(got.value) == str(want.value)
    # ... and build-pseudotime-template builds JAX's template from the store and a tracks CSV
    tracks = pd.DataFrame(_cells()[2])[["fov_name", "track_id", "t", "parent_track_id"]]
    tracks["fov_name"] = tracks["fov_name"].str.strip("/")  # as the store keeps it
    tracks["infection_state"] = np.where((tracks["track_id"] % 2 == 1) & (tracks["t"] >= 2), "infected", "uninfected")
    tracks.to_csv(tmp / "tracks.csv", index=False)
    j, t = _both(stores, ["build-pseudotime-template", "--embeddings", "{S}", "--tracks-csv", str(tmp / "tracks.csv"),
                          "--pca-components", "4", "--output", "{D}"])
    assert t.replace("t_out", "") == j.replace("j_out", "")
    np.testing.assert_allclose(_template_rows(tmp / "t_out"), _template_rows(tmp / "j_out"),
                               atol=1e-6)
    # ported now: a config without the tracking benchmark's fields is refused by name
    (tmp / "not_tracking.yml").write_text("output_dir: out\n")
    with pytest.raises(ValueError, match="TrackingAccuracyConfig.models: Field required"):
        runner.invoke(tcli.main, ["evaluate-tracking-accuracy", "-c", str(tmp / "not_tracking.yml")],
                      catch_exceptions=False)
    res = runner.invoke(tcli.main, ["combined-dim-reduction", "--embeddings", str(tmp / "t.zarr"), "--method", "umap"])
    assert res.exit_code != 0 and "refused" in res.output


@pytest.mark.parametrize("method", ["pca", "umap", "phate"])
def test_reduce_dimensionality_matches_jax(stores, method):
    """UMAP at this size: 500 epochs, whose chaos turns pow's last bit into
    O(1) (see the reductions tests), so each layout is scored by the share of
    every point's 10 nearest input neighbours among its 10 nearest in the
    layout, and the two shares agree within 0.05."""
    tmp, _ = stores
    j, t = _both(stores, ["reduce-dimensionality", "--embeddings", "{S}", "--method", method, "--components", "2"])
    assert t.replace("t.zarr", "") == j.replace("j.zarr", "")
    key = method.upper()
    want, got = jad.read_anndata_zarr(tmp / "j.zarr").obsm[key], read_anndata_zarr(tmp / "t.zarr").obsm[key]
    assert got.shape == want.shape == (N_FOV * N_TRACKS * N_T, 2)
    if method == "umap":
        X = read_anndata_zarr(tmp / "t.zarr").X
        assert abs(knn_preservation(X, got) - knn_preservation(X, want)) <= 0.05
        return
    got = got * np.sign((got * want).sum(0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.ptp(want))


def test_dimred_combined_and_mlp_subcommands(stores):
    tmp, _ = stores
    j, t = _both(stores, ["dimred", "--embeddings", "{S}", "--components", "3", "--output", "{D}.npy"])
    np.testing.assert_allclose(np.load(tmp / "t_out.npy"), np.load(tmp / "j_out.npy"), rtol=0, atol=1e-4)
    assert t.replace("t_out", "") == j.replace("j_out", "")
    j, t = _both(stores, ["combined-dim-reduction", "--embeddings", "{S}", "--components", "3"])
    np.testing.assert_allclose(read_anndata_zarr(tmp / "t.zarr").obsm["PCA"],
                               jad.read_anndata_zarr(tmp / "j.zarr").obsm["PCA"], rtol=0, atol=1e-4)
    _append_labels(stores)
    j, t = _both(stores, ["train-mlp-embedder", "--embeddings", "{S}", "--label-column", "state", "--output", "{D}/m",
                          "--hidden-dims", "16,8", "--epochs", "3"])
    assert 0.0 <= _json(t)["val_acc"] <= 1.0 and list(_json(t)) == list(_json(j))
    j, t = _both(stores, ["apply-mlp-embedder", "--embeddings", "{S}", "--model", "{D}/m", "--key", "MLP"])
    assert t.replace("t.zarr", "") == j.replace("j.zarr", "")
    reps = read_anndata_zarr(tmp / "t.zarr").obsm["MLP"]
    assert reps.shape == (N_FOV * N_TRACKS * N_T, 8)


def test_probe_smoothness_mmd_and_tracking_subcommands(stores):
    tmp, _ = stores
    _append_labels(stores)
    for args in (["cross-validate", "--embeddings", "{S}", "--label-column", "state", "--splits", "3"],
                 ["probe-classifiers", "--embeddings", "{S}", "--label-columns", "state,condition", "--splits", "3"],
                 ["smoothness", "--embeddings", "{S}"],
                 ["smoothness", "--embeddings", "{S}", "--distance-metric", "euclidean"],
                 ["evaluate-tracking-accuracy", "--embeddings", "{S}", "--spatial-gate", "30"]):
        j, t = _both(stores, args)
        _close(_json(t), _json(j), rel=1e-6)
    # MMD: JAX sums float32 kernels in float32 (1e-6 absolute; p-values as the metrics tests count them)
    j, t = _both(stores, ["mmd", "--embeddings", "{S}", "--group-column", "condition", "--group-a", "cond0",
                          "--group-b", "cond1", "--permutations", "50"])
    jr, tr = _json(j), _json(t)
    assert list(tr) == list(jr) and all(abs(tr[k] - jr[k]) <= 1e-6 for k in ("mmd2", "null_mean", "null_std"))
    j, t = _both(stores, ["compute-mmd", "--embeddings", "{S}", "--group-column", "state", "--permutations", "30",
                          "--output", "{D}.csv"])
    jr, tr = _json(j), _json(t)
    assert [(r["group_a"], r["group_b"]) for r in tr] == [(r["group_a"], r["group_b"]) for r in jr]
    assert all(abs(a["mmd2"] - b["mmd2"]) <= 1e-6 for a, b in zip(tr, jr))
    jc, tc = pd.read_csv(tmp / "j_out.csv"), pd.read_csv(tmp / "t_out.csv")
    assert list(tc.columns) == list(jc.columns)
    np.testing.assert_allclose(tc["mmd2"], jc["mmd2"], rtol=0, atol=1e-6)
    assert np.asarray([r["mmd2"] for r in tr]) == pytest.approx(tc["mmd2"].to_numpy(), rel=1e-15)


def test_classifier_subcommands(stores):
    tmp, runner = stores
    _append_labels(stores)
    j, t = _both(stores, ["train-classifier", "--embeddings", "{S}", "--label-column", "state", "--output",
                          "{D}.probe"])
    _close(_json(t), _json(j), rel=1e-6)
    j, t = _both(stores, ["append-predictions", "--embeddings", "{S}", "--classifier", "{D}.probe", "--task", "state"])
    assert t == j
    jo, to = jad.read_anndata_zarr(tmp / "j.zarr").obs, read_anndata_zarr(tmp / "t.zarr").obs
    assert [str(v) for v in to["predicted_state"]] == [str(v) for v in jo["predicted_state"].to_numpy()]
    res = runner.invoke(tcli.main, ["--device", "cpu", "append-predictions", "--embeddings", str(tmp / "t.zarr"),
                                    "--classifier", str(tmp / "j_out.probe")])
    assert isinstance(res.exception, NotImplementedError) and "pickled JAX" in str(res.exception)


def test_fit_and_predict_delegate_to_viscy_torch(tmp_path, monkeypatch):
    """``fit`` and ``predict`` run ``viscy-torch``'s subcommand on the config
    and checkpoint given, as the JAX CLI runs ``viscy``'s."""
    from viscy_tpu_torch.training import cli as vcli

    calls = []
    monkeypatch.setattr(vcli, "run_subcommand", lambda *a: calls.append(a))
    cfg = tmp_path / "c.yml"
    cfg.write_text("{}")
    runner = CliRunner()
    for args in (["fit", "-c", str(cfg)], ["predict", "-c", str(cfg), "--ckpt_path", "last"]):
        assert runner.invoke(tcli.main, args, catch_exceptions=False).exit_code == 0
    assert calls == [("fit", str(cfg), None), ("predict", str(cfg), "last")]
