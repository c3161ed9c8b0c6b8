"""The port's DTW pseudotime package and host kernel H2 against viscy_tpu's,
on the CPU.

- H2 (``csrc/dtw.cpp``, built here with g++ by ``ops/_build.py``): the
  accumulated cost bit for bit against JAX's ``dtw_accumulated_cost`` and
  the port's plain Python loop, in both ``subsequence`` modes; a failing
  build raises.
- DBA, ``build_template``, ``subsequence_align``, ``dtw_align_tracks`` and
  ``evaluate_embedding`` on the same seeded tracks: templates within 1e-10,
  warp paths equal; lineage anchoring, signals and population metrics equal.
- Template stores written by either package read by the other.
- The CLI: ``build-pseudotime-template`` against JAX's; ``align-pseudotime``
  and ``evaluate-pseudotime`` refused by name (parquet).
"""

import numpy as np
import pandas as pd
import pytest
from click.testing import CliRunner

from viscy_tpu.apps.dynaclr import cli as jcli
from viscy_tpu.apps.dynaclr.pseudotime import _legacy as jleg
from viscy_tpu.apps.dynaclr.pseudotime import alignment as jal
from viscy_tpu.apps.dynaclr.pseudotime import dtw_alignment as jdtw
from viscy_tpu.apps.dynaclr.pseudotime import dtw_core as jcore
from viscy_tpu.apps.dynaclr.pseudotime import evaluation as jev
from viscy_tpu.apps.dynaclr.pseudotime import io as jio
from viscy_tpu.apps.dynaclr.pseudotime import metrics as jmet
from viscy_tpu.apps.dynaclr.pseudotime import signals as jsig
from viscy_tpu.evaluation.anndata_lite import AnnDataLite as JAnnData
from viscy_tpu_torch.apps.dynaclr import cli as tcli
from viscy_tpu_torch.apps.dynaclr.pseudotime import _legacy as tleg
from viscy_tpu_torch.apps.dynaclr.pseudotime import alignment as tal
from viscy_tpu_torch.apps.dynaclr.pseudotime import dtw_alignment as tdtw
from viscy_tpu_torch.apps.dynaclr.pseudotime import dtw_core as tcore
from viscy_tpu_torch.apps.dynaclr.pseudotime import evaluation as tev
from viscy_tpu_torch.apps.dynaclr.pseudotime import io as tio
from viscy_tpu_torch.apps.dynaclr.pseudotime import metrics as tmet
from viscy_tpu_torch.apps.dynaclr.pseudotime import signals as tsig
from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite, Frame
from viscy_tpu_torch.ops import _build
from viscy_tpu_torch.training.callbacks.embedding_writer import write_embedding_dataset

import _torch_port_helpers  # noqa: F401  (one torch thread a worker)

D = 16


def _frame(df: pd.DataFrame) -> Frame:
    return Frame({c: df[c].to_numpy(dtype=object) if df[c].dtype.kind in "OT" or str(df[c].dtype) == "str"
                  else df[c].to_numpy() for c in df.columns})


def _tracks(seed=1, n_fov=2, n_tracks=12, n_t=15):
    """Tracks on a random walk; three in four turn infected at a per-track
    onset, the features shifting after it; some tracks are children of the
    one before. ``(features, tracks table, store obs)``."""
    rng = np.random.default_rng(seed)
    shift = rng.normal(size=D) * 2
    rows, feats = [], []
    for f in range(n_fov):
        for tr in range(n_tracks):
            onset = int(rng.integers(4, 11)) if tr % 4 else None
            x = rng.normal(size=D)
            for t in range(n_t):
                x = x + rng.normal(size=D) * 0.2
                feats.append(x + (shift if onset is not None and t >= onset else 0))
                rows.append(dict(fov_name=f"A/1/{f}", track_id=tr, t=t, parent_track_id=tr - 1 if tr % 3 == 2 else -1,
                                 infection_state="infected" if onset is not None and t >= onset else "uninfected",
                                 organelle_state="remodel" if (t + tr) % 5 == 0 else "normal"))
    df = pd.DataFrame(rows)
    return np.asarray(feats, np.float32), df, df[["fov_name", "track_id", "t"]]


@pytest.fixture(scope="module")
def data():
    X, df, obs = _tracks()
    jad, tad = JAnnData(X=X, obs=obs.copy()), AnnDataLite(X, _frame(obs))
    j_aligned, t_aligned = jal.align_tracks(df, 30.0), tal.align_tracks(_frame(df), 30.0)
    kw = dict(pca_n_components=5, propagate_columns=["infection_state", "organelle_state"])
    jt = jdtw.build_template({"ds": jad}, {"ds": j_aligned}, **kw)
    tt = tdtw.build_template({"ds": tad}, {"ds": t_aligned}, device="cpu", **kw)
    return dict(X=X, df=df, jad=jad, tad=tad, j_aligned=j_aligned, t_aligned=t_aligned, jt=jt, tt=tt)


# -- H2 -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("subsequence", [False, True])
@pytest.mark.parametrize("shape", [(1, 1), (7, 19), (20, 20), (33, 5)])
def test_h2_equals_jax_and_the_plain_loop_bit_for_bit(shape, subsequence):
    cost = np.random.default_rng(shape[0] * shape[1]).random(shape) * 3
    cost[0, -1] = cost[-1, 0] = 0.0  # ties along the borders
    before = tcore.launches["dtw_dp"]
    got = tcore.dtw_accumulated_cost(cost, subsequence=subsequence)
    assert tcore.launches["dtw_dp"] == before + 1
    want = jcore.dtw_accumulated_cost(cost, subsequence=subsequence)
    plain = tcore.dtw_accumulated_cost_plain(cost, subsequence=subsequence)
    assert got.tobytes() == want.tobytes() == plain.tobytes()
    assert np.array_equal(tcore.dtw_best_path(got, subsequence=subsequence),
                          jcore.dtw_best_path(want, subsequence=subsequence))


def test_a_failing_h2_build_raises(monkeypatch, tmp_path):
    """No fallback: with no host compiler the build raises by name, and a
    source that does not compile raises with the compiler's output."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tcore.dtw_accumulated_cost(np.ones((3, 3)))
    monkeypatch.delenv("CXX")
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "dtw.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", bad)
    with pytest.raises(RuntimeError, match="failed for dtw"):
        tcore.dtw_accumulated_cost(np.ones((3, 3)))


# -- DTW, DBA, templates, alignment -------------------------------------------------------------


def test_pairs_subsequences_and_dba_match_jax():
    rng = np.random.default_rng(4)
    seqs = [np.cumsum(rng.normal(size=(int(rng.integers(6, 14)), 5)), axis=0) for _ in range(60)]
    for a, b in zip(seqs[:10], seqs[10:20]):
        jp, jc = jcore.dtw_align_pair(a, b)
        tp, tc = tcore.dtw_align_pair(a, b)
        assert np.array_equal(tp, jp) and tc == jc
        jp, jc = jcore.subsequence_align(a[:4], b)
        tp, tc = tcore.subsequence_align(a[:4], b)
        assert np.array_equal(tp, jp) and tc == jc
    for init in ("medoid", "first"):  # 60 sequences: the medoid's 50 candidates drawn by default_rng
        want = jcore.dba(seqs, max_iter=5, init=init)
        got = tcore.dba(seqs, max_iter=5, init=init)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_lineage_anchoring_matches_jax(data):
    df = data["df"]

    def norm(lineages):
        return [(fov, [int(t) for t in tracks]) for fov, tracks in lineages]

    for both in (True, False):
        assert norm(tal.identify_lineages(_frame(df), both)) == norm(jal.identify_lineages(df, both))
    j, t = data["j_aligned"], data["t_aligned"]
    assert t.names == list(j.columns)
    for c in j.columns:
        np.testing.assert_array_equal(np.asarray(t[c]).astype(str), j[c].to_numpy().astype(str), err_msg=c)
    jf = jal.filter_tracks(df, fov_pattern="1/1", min_timepoints=10)
    tf = tal.filter_tracks(_frame(df), fov_pattern="1/1", min_timepoints=10)
    np.testing.assert_array_equal(tf["track_id"], jf["track_id"].to_numpy())


@pytest.mark.parametrize("variant", ["components", "threshold", "crop", "no_pca"])
def test_build_template_matches_jax(data, variant):
    kw = {"components": dict(pca_n_components=5, propagate_columns=["infection_state"]),
          "threshold": dict(pca_n_components=None, pca_variance_threshold=0.6),
          "crop": dict(pca_n_components=4, crop_window=3, dba_init="first"),
          "no_pca": dict(pca_n_components=None)}[variant]
    jt = jdtw.build_template({"ds": data["jad"]}, {"ds": data["j_aligned"]}, **kw)
    tt = tdtw.build_template({"ds": data["tad"]}, {"ds": data["t_aligned"]}, device="cpu", **kw)
    np.testing.assert_allclose(tt.template, jt.template, rtol=0, atol=1e-10)
    assert tt.template_cell_ids == jt.template_cell_ids and tt.n_input_tracks == jt.n_input_tracks
    np.testing.assert_allclose(tt.time_calibration, jt.time_calibration, rtol=1e-12)
    if jt.pca is None:
        assert tt.pca is None and tt.explained_variance is None
    else:
        assert tt.pca.n_components_ == jt.pca.n_components_
        assert tt.explained_variance == pytest.approx(jt.explained_variance, rel=1e-10)
    for name, (m, s) in jt.zscore_params.items():
        np.testing.assert_allclose(tt.zscore_params[name][0], m, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tt.zscore_params[name][1], s, rtol=1e-12)
    if jt.template_labels:
        for col, classes in jt.template_labels.items():
            assert list(tt.template_labels[col]) == list(classes)
            for cls, frac in classes.items():
                np.testing.assert_allclose(tt.template_labels[col][cls], frac, rtol=1e-12, equal_nan=True)


def test_label_propagation_takes_a_late_class_over_fewer_tracks_as_jax_does():
    """A class first seen after other positions were filled gets no zeros
    for the tracks before it: here ``late`` appears only in the second of
    two identical tracks, so at every position the classes' fractions sum
    to more than 1 (1/2 + 1), in JAX and in the port."""
    X = np.tile(np.linspace(0, 1, 5)[:, None], (2, D)).astype(np.float32) + np.arange(D) * 0.01
    obs = pd.DataFrame(dict(fov_name=["A/1/0"] * 10, track_id=[0] * 5 + [1] * 5, t=list(range(5)) * 2))
    tracks = obs.assign(t_perturb=2, t_relative_minutes=(obs["t"] - 2) * 30.0,
                        state=["early"] * 5 + ["late"] * 5)
    kw = dict(pca_n_components=None, propagate_columns=["state"], dba_init="first")
    jt = jdtw.build_template({"d": JAnnData(X=X, obs=obs)}, {"d": tracks}, **kw)
    tt = tdtw.build_template({"d": AnnDataLite(X, _frame(obs))}, {"d": _frame(tracks)}, device="cpu", **kw)
    for t in (jt, tt):
        total = t.template_labels["state"]["early"] + t.template_labels["state"]["late"]
        np.testing.assert_allclose(total, 1.5)
    np.testing.assert_array_equal(tt.template_labels["state"]["late"], jt.template_labels["state"]["late"])


@pytest.mark.parametrize("subsequence", [True, False])
def test_dtw_align_tracks_matches_jax(data, subsequence):
    jr = jdtw.dtw_align_tracks(data["jad"], data["df"], data["jt"], "ds", subsequence=subsequence)
    tr = tdtw.dtw_align_tracks(data["tad"], _frame(data["df"]), data["tt"], "ds", subsequence=subsequence,
                               device="cpu")
    assert [r.cell_uid for r in tr] == [r.cell_uid for r in jr]
    for a, b in zip(tr, jr):
        assert np.array_equal(a.warping_path, b.warping_path)
        np.testing.assert_allclose(a.pseudotime, b.pseudotime, rtol=1e-12)
        assert a.dtw_cost == pytest.approx(b.dtw_cost, rel=1e-10)
        assert a.path_skew == b.path_skew
        np.testing.assert_array_equal(a.warping_speed, b.warping_speed)
        np.testing.assert_array_equal(a.alignment_region, b.alignment_region)
        for col, classes in b.propagated_labels.items():
            for cls, vals in classes.items():
                np.testing.assert_allclose(a.propagated_labels[col][cls], vals, rtol=1e-12, equal_nan=True)
    groups_j, groups_t = jdtw.classify_response_groups(jr), tdtw.classify_response_groups(tr)
    for k in groups_j:
        assert [r.cell_uid for r in groups_t[k]] == [r.cell_uid for r in groups_j[k]]
    jdf, tdf = jdtw.alignment_results_to_dataframe(jr), tdtw.alignment_results_to_dataframe(tr)
    assert tdf.names == list(jdf.columns)
    for c in jdf.columns:
        if jdf[c].dtype.kind == "f":
            np.testing.assert_allclose(tdf[c], jdf[c].to_numpy(), rtol=1e-10, equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(np.asarray(tdf[c]).astype(str), jdf[c].to_numpy().astype(str), err_msg=c)
    assert tdtw.extract_dtw_pseudotime(tr).names == list(jdtw.extract_dtw_pseudotime(jr).columns)


def test_evaluate_embedding_matches_jax(data):
    jr = jdtw.dtw_align_tracks(data["jad"], data["df"], data["jt"], "ds")
    tr = tdtw.dtw_align_tracks(data["tad"], _frame(data["df"]), data["tt"], "ds", device="cpu")
    jdf, tdf = jdtw.alignment_results_to_dataframe(jr), tdtw.alignment_results_to_dataframe(tr)
    state = data["df"].set_index(["fov_name", "track_id", "t"])["infection_state"]
    jdf["infection_state"] = state.loc[list(zip(jdf.fov_name, jdf.track_id, jdf.t))].to_numpy()
    jdf.loc[::17, "infection_state"] = ""  # blank annotations are left out on both sides
    tdf["infection_state"] = jdf["infection_state"].to_numpy(dtype=object)
    want, got = jev.evaluate_embedding(jdf), tev.evaluate_embedding(tdf)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, nan_ok=True), k
    jpt, tpt = jev.per_timepoint_auc(jdf), tev.per_timepoint_auc(tdf)
    np.testing.assert_allclose(tpt["auc"], jpt["auc"].to_numpy(), rtol=1e-12, equal_nan=True)


def test_template_stores_cross_both_ways(data, tmp_path):
    tio.save_template_zarr(tmp_path / "t.zarr", data["tt"], attrs={"source": "port"})
    jio.save_template_zarr(tmp_path / "j.zarr", data["jt"], attrs={"source": "jax"})
    for path in ("t.zarr", "j.zarr"):
        jr, jattrs = jio.load_template_flavor(tmp_path / path)
        tr, tattrs = tio.load_template_flavor(tmp_path / path)
        assert tattrs == jattrs
        np.testing.assert_array_equal(tr.template, jr.template)
        np.testing.assert_array_equal(tr.pca.components_, jr.pca.components_)
        np.testing.assert_array_equal(tr.time_calibration, jr.time_calibration)
        assert tr.template_cell_ids == jr.template_cell_ids
        for col, classes in jr.template_labels.items():
            for cls, v in classes.items():
                np.testing.assert_array_equal(tr.template_labels[col][cls], v)
        assert tio.read_tau_event_band(tmp_path / path) == jio.read_tau_event_band(tmp_path / path)
        # a loaded template aligns alike on both sides
        a = tdtw.dtw_align_tracks(data["tad"], _frame(data["df"]), tr, "ds", device="cpu")
        b = jdtw.dtw_align_tracks(data["jad"], data["df"], jr, "ds")
        assert all(np.array_equal(x.warping_path, y.warping_path) for x, y in zip(a, b))
    res = tdtw.resample_template_to_frame_interval(data["tt"], 15.0)
    want = jdtw.resample_template_to_frame_interval(data["jt"], 15.0)
    np.testing.assert_allclose(res.template, want.template, atol=1e-10)
    assert res.template_id == want.template_id


def test_signals_and_population_metrics_match_jax(data):
    df, jad, tad = data["j_aligned"], data["jad"], data["tad"]
    tdf = data["t_aligned"]
    j = jsig.extract_annotation_signal(df, "organelle_state", "remodel")
    t = tsig.extract_annotation_signal(tdf, "organelle_state", "remodel")
    np.testing.assert_array_equal(t["signal"], j["signal"].to_numpy())
    jd = jsig.extract_embedding_distance(jad, df)
    td = tsig.extract_embedding_distance(tad, tdf)
    np.testing.assert_allclose(td["signal"], jd["signal"].to_numpy(), rtol=1e-12, equal_nan=True)
    preds = np.where(np.arange(tad.n_obs) % 3 == 0, "remodel", "normal").astype(object)
    jad.obs["predicted_organelle_state"], tad.obs["predicted_organelle_state"] = preds, preds
    jp = jsig.extract_prediction_signal(jad, df, "organelle_state")
    tp = tsig.extract_prediction_signal(tad, tdf, "organelle_state")
    np.testing.assert_array_equal(tp["signal"], jp["signal"].to_numpy())
    bins = np.arange(-300, 301, 60.0)
    for signal_type, jx, tx in (("fraction", j, t), ("continuous", jd, td)):
        jpop = jmet.aggregate_population(jx, bins, signal_type=signal_type)
        tpop = tmet.aggregate_population(tx, bins, signal_type=signal_type)
        assert tpop.names == list(jpop.columns)
        for c in jpop.columns:
            np.testing.assert_allclose(tpop[c], jpop[c].to_numpy(float), rtol=1e-10, equal_nan=True, err_msg=c)
        kw = dict(baseline_window=(-300, 0), min_cells_per_bin=1)
        want, got = jmet.find_onset_time(jpop, **kw), tmet.find_onset_time(tpop, **kw)
        assert got[0] == want[0] and np.allclose(got[1:], want[1:], rtol=1e-10, equal_nan=True)
        assert tmet.find_half_max_time(tpop) == pytest.approx(jmet.find_half_max_time(jpop), nan_ok=True)
        for k, v in jmet.find_peak_metrics(jpop).items():
            assert tmet.find_peak_metrics(tpop)[k] == pytest.approx(v, rel=1e-10, nan_ok=True), k
        jt_, tt_ = jmet.compute_track_timing(jx, signal_type=signal_type), tmet.compute_track_timing(
            tx, signal_type=signal_type)
        assert tt_.names == list(jt_.columns)
        for c in jt_.columns:
            if jt_[c].dtype.kind in "fi":
                np.testing.assert_allclose(np.asarray(tt_[c], float), jt_[c].to_numpy(float), rtol=1e-12, err_msg=c)
            else:
                assert [str(v) for v in tt_[c]] == [str(v) for v in jt_[c]], c
    timing = pd.DataFrame(dict(marker=["a"] * 4 + ["b"] * 4, onset_minutes=[1.0, 2, 3, 4, 5, 6, 7, 9],
                               total_positive_minutes=[30.0, 60, 30, 90, 120, 30, 60, 60]))
    res, ctrl = {"a": dict(n_positive=5, n_cells=20)}, {"a": dict(n_positive=1, n_cells=30)}
    want = jmet.run_statistical_tests(res, timing, ctrl)
    got = tmet.run_statistical_tests(res, _frame(timing), ctrl)
    np.testing.assert_allclose(got["p_value"], want["p_value"].to_numpy(), rtol=1e-12)
    assert list(got["test"]) == want["test"].tolist()


def test_legacy_pseudotime_matches_jax(data):
    X, obs = data["X"].astype(np.float64), data["df"][["fov_name", "track_id", "t"]]
    want = jleg.compute_pseudotime(X, obs)
    got = tleg.compute_pseudotime(X, _frame(obs))
    np.testing.assert_allclose(got["pseudotime"], want["pseudotime"].to_numpy(), rtol=1e-12)
    np.testing.assert_allclose(got["dtw_cost"], want["dtw_cost"].to_numpy(), rtol=1e-12)


# -- the CLI --------------------------------------------------------------------------------------


def test_build_pseudotime_template_matches_jax_and_the_parquet_commands_are_refused(tmp_path):
    X, df, obs = _tracks(seed=3, n_tracks=8)
    write_embedding_dataset(tmp_path / "emb.zarr", X, [dict(r, id=i) for i, r in
                                                        enumerate(obs.to_dict("records"))])
    df.to_csv(tmp_path / "tracks.csv", index=False)
    runner = CliRunner()
    args = ["build-pseudotime-template", "--embeddings", str(tmp_path / "emb.zarr"), "--tracks-csv",
            str(tmp_path / "tracks.csv"), "--pca-components", "6", "--propagate-columns", "infection_state"]
    j = runner.invoke(jcli.main, [*args, "--output", str(tmp_path / "j.zarr")], catch_exceptions=False)
    t = runner.invoke(tcli.main, ["--device", "cpu", *args, "--output", str(tmp_path / "t.zarr")],
                      catch_exceptions=False)
    assert j.exit_code == 0 and t.exit_code == 0, (j.output, t.output)
    assert t.output.replace("t.zarr", "") == j.output.replace("j.zarr", "")
    jr, _ = jio.load_template_flavor(tmp_path / "j.zarr")
    tr, _ = tio.load_template_flavor(tmp_path / "t.zarr")
    np.testing.assert_allclose(tr.template, jr.template, atol=1e-6)  # float32 in the store
    for name in ("align-pseudotime", "evaluate-pseudotime"):
        with pytest.raises(NotImplementedError, match=rf"{name}.*parquet.*Queue 1 item 10"):
            runner.invoke(tcli.main, ["--device", "cpu", name], catch_exceptions=False)
