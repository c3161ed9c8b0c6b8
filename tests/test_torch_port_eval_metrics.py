"""The port's evaluation metrics (``viscy_tpu_torch.evaluation``: clustering,
distance, embedding_map, smoothness, mmd, linear_classifier, lca,
annotation, zarr_utils) against viscy_tpu's on numpy-seeded inputs, on
the CPU.

Tolerances: distances, ranks, kNN accuracy, DBSCAN labels, NMI / ARI,
track displacements, APs, smoothness statistics and folds to 1e-12 or
exactly; MMD to 1e-6 absolute (JAX sums float32 kernels in float32, the
port in float64: the port is within 1e-12 of a float64 numpy reference);
the logistic probe's coefficients to 1e-5 of an sklearn refit at ``tol =
1e-10``, and JAX's default-``tol`` pipeline by predictions (disagreements
counted), probabilities (1e-2) and metrics.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import StratifiedKFold
from sklearn.preprocessing import StandardScaler

from viscy_tpu.evaluation import annotation as jann
from viscy_tpu.evaluation import clustering as jclu
from viscy_tpu.evaluation import distance as jdist
from viscy_tpu.evaluation import embedding_map as jmap
from viscy_tpu.evaluation import lca as jlca
from viscy_tpu.evaluation import linear_classifier as jlin
from viscy_tpu.evaluation import mmd as jmmd
from viscy_tpu.evaluation import smoothness as jsmooth
from viscy_tpu.evaluation import zarr_utils as jzarr
from viscy_tpu.evaluation.anndata_lite import AnnDataLite as JAnnData
from viscy_tpu_torch.evaluation import annotation as tann
from viscy_tpu_torch.evaluation import clustering as tclu
from viscy_tpu_torch.evaluation import distance as tdist
from viscy_tpu_torch.evaluation import embedding_map as tmap
from viscy_tpu_torch.evaluation import lca as tlca
from viscy_tpu_torch.evaluation import linear_classifier as tlin
from viscy_tpu_torch.evaluation import mmd as tmmd
from viscy_tpu_torch.evaluation import smoothness as tsmooth
from viscy_tpu_torch.evaluation import zarr_utils as tzarr
from viscy_tpu_torch.evaluation.anndata_lite import AnnDataLite, Frame, read_anndata_zarr
from viscy_tpu_torch.training.callbacks.embedding_writer import write_embedding_dataset
from viscy_tpu_torch.training.convert import linear_pipeline_from_jax

CPU = dict(device="cpu")


def _tracks(n_fov=2, n_tracks=6, n_t=5, d=8, seed=0):
    """Drifting tracks around 3 class centres: (features, pandas index, Frame)."""
    rng = np.random.default_rng(seed)
    rows, feats = [], []
    centres = rng.normal(size=(3, d)) * 2
    for f in range(n_fov):
        for tr in range(n_tracks):
            c = (f + tr) % 3
            x = centres[c] + rng.normal(size=d) * 0.5
            for t in range(n_t):
                x = x + rng.normal(size=d) * 0.2
                feats.append(x.copy())
                rows.append(dict(fov_name=f"A/1/{f}", track_id=10 + tr, t=t, id=1000 * f + 10 * tr + t,
                                 y=float(50 * tr + 3 * t), x=float(40 * f + 2 * t), label=f"c{c}", cond=tr % 2))
    df = pd.DataFrame(rows)
    frame = Frame({k: (df[k].to_numpy().astype(object) if df[k].dtype == object else df[k].to_numpy())
                   for k in df.columns})
    return np.asarray(feats, np.float32), df, frame


# -- clustering -----------------------------------------------------------------------------------------------


def test_knn_accuracy_distances_and_ranks_match_jax():
    X, df, _ = _tracks()
    y = df["label"].to_numpy()
    assert tclu.knn_accuracy(X, y, k=5, **CPU) == jclu.knn_accuracy(X, y, k=5)
    for metric in ("cosine", "euclidean", "sqeuclidean"):  # float64 inputs: scipy keeps float32 in float32
        np.testing.assert_allclose(tclu.pairwise_distance_matrix(X, metric, **CPU),
                                   jclu.pairwise_distance_matrix(X.astype(np.float64), metric), rtol=1e-9, atol=1e-12)
    d = np.round(np.random.default_rng(1).random((7, 9)), 3)
    np.testing.assert_array_equal(tclu.rank_nearest_neighbors(d, **CPU), jclu.rank_nearest_neighbors(d))
    tied = np.asarray([[0.2, 0.1, 0.1, 0.3]])  # stable here; np.argsort may order the tie either way
    np.testing.assert_array_equal(tclu.rank_nearest_neighbors(tied, normalize=False, **CPU), [[2.0, 0.0, 1.0, 3.0]])
    m = np.arange(16.0).reshape(4, 4)
    np.testing.assert_array_equal(tclu.compare_time_offset(m, 2), jclu.compare_time_offset(m, 2))


@pytest.mark.parametrize("eps,min_samples", [(1.2, 4), (2.0, 5), (0.9, 3)])
def test_dbscan_labels_and_scores_match_sklearn(eps, min_samples):
    rng = np.random.default_rng(int(eps * 10))
    X = np.concatenate([rng.normal(size=(40, 2)) * 0.5, rng.normal(size=(40, 2)) * 0.5 + 3,
                        rng.uniform(-3, 6, size=(15, 2))])
    want = jclu.dbscan_clustering(X, eps=eps, min_samples=min_samples)
    got = tclu.dbscan_clustering(X, eps=eps, min_samples=min_samples, **CPU)
    np.testing.assert_array_equal(got, want)
    ann = np.repeat(["a", "b", "n"], [40, 40, 15])
    for method in ("nmi", "ari"):
        assert tclu.clustering_evaluation(X, ann, method, eps, min_samples, **CPU) == pytest.approx(
            jclu.clustering_evaluation(X, ann, method, eps, min_samples), rel=1e-12, abs=1e-15)


def test_nmi_and_ari_special_cases_match_sklearn():
    from sklearn.metrics import adjusted_rand_score, normalized_mutual_info_score

    cases = [([0, 0, 1, 1], [1, 1, 0, 0]), ([0, 0, 0], [0, 0, 0]), ([0, 1, 2], [0, 0, 0]),
             ([0, 0, 1, 2, 2, 2], [1, 1, 0, -1, 0, 0])]
    for a, b in cases:
        a, b = np.asarray(a), np.asarray(b)
        assert tclu._nmi(a, b) == pytest.approx(normalized_mutual_info_score(a, b), rel=1e-12, abs=1e-15)
        assert tclu._ari(a, b) == pytest.approx(adjusted_rand_score(a, b), rel=1e-12, abs=1e-15)


# -- distance, mAP, smoothness --------------------------------------------------------------------------------


def test_track_displacement_and_cosine_drift_match_jax():
    X, df, frame = _tracks()
    jds, tds = {"features": X, "index": df}, {"features": X, "index": frame}
    for metric in ("cosine", "euclidean"):
        want = jdist.compute_track_displacement(jds, metric)
        got = tdist.compute_track_displacement(tds, metric, **CPU)
        assert sorted(got) == sorted(want)
        for tau in want:
            np.testing.assert_allclose(got[tau], want[tau], rtol=1e-12, atol=1e-15)
    wt, ws = jdist.calculate_cosine_similarity_cell(jds, "A/1/1", 12)
    tt, ts = tdist.calculate_cosine_similarity_cell(tds, "A/1/1", 12, **CPU)
    np.testing.assert_array_equal(tt, wt)
    np.testing.assert_allclose(ts, ws, rtol=1e-6)  # JAX computes the float32 features in float32


def test_average_precision_map_and_the_permutation_null_match_jax():
    X, df, frame = _tracks()
    y = df["label"].to_numpy()
    np.testing.assert_allclose(tmap.average_precision_per_sample(X, y, **CPU), jmap.average_precision_per_sample(X, y),
                               rtol=1e-12)
    want, got = jmap.mean_average_precision(X, y, "euclidean"), tmap.mean_average_precision(X, y, "euclidean", **CPU)
    assert got.keys() == want.keys() and all(got[k] == pytest.approx(want[k], rel=1e-12) for k in want)
    meta = df.assign(perturbation=np.where(df["cond"] == 0, "mock", "drug"))
    want = jmap.compute_embedding_map(meta, X, "mock", "drug", null_size=2000, seed=3)
    got = tmap.compute_embedding_map({"perturbation": meta["perturbation"].to_numpy()}, X, "mock", "drug",
                                     null_size=2000, seed=3, **CPU)
    assert got["mean_average_precision"] == pytest.approx(want["mean_average_precision"], rel=1e-12)
    assert got["p_value"] == want["p_value"]


def test_smoothness_matches_jax():
    X, df, frame = _tracks(n_fov=3, n_tracks=8, n_t=6)
    for metric in ("cosine", "euclidean"):
        want, wd = jsmooth.compute_embeddings_smoothness(X, df, metric, return_distributions=True)
        got, gd = tsmooth.compute_embeddings_smoothness(X, frame, metric, return_distributions=True, **CPU)
        assert list(got) == list(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k
        for k in wd:
            np.testing.assert_allclose(gd[k], wd[k], rtol=1e-12)
    pairs = tsmooth.random_pairs(len(X))
    again = tsmooth.compute_embeddings_smoothness(X, frame, pairs=pairs, **CPU)
    assert again == tsmooth.compute_embeddings_smoothness(X, frame, **CPU)


# -- MMD ------------------------------------------------------------------------------------------------------


def test_mmd_matches_jax_and_a_float64_reference():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(120, 12)).astype(np.float32)
    Y = (rng.normal(size=(100, 12)) + 0.15).astype(np.float32)
    bw = jmmd.median_heuristic(X, Y)
    assert tmmd.median_heuristic(X, Y, **CPU) == pytest.approx(bw, rel=1e-12)
    np.testing.assert_allclose(tmmd.gaussian_rbf_kernel(X, Y, bw, **CPU), jmmd.gaussian_rbf_kernel(X, Y, bw),
                               rtol=1e-6)
    pool = np.concatenate([X, Y]).astype(np.float64)
    k = np.exp(-((pool[:, None] - pool[None]) ** 2).sum(-1) / (2 * bw))
    n = len(X)

    def ref(kk, n):
        m = len(kk) - n
        return ((kk[:n, :n].sum() - np.trace(kk[:n, :n])) / (n * (n - 1))
                + (kk[n:, n:].sum() - np.trace(kk[n:, n:])) / (m * (m - 1)) - 2 * kk[:n, n:].mean())

    got = tmmd.compute_mmd_unbiased(X, Y, bw, **CPU)
    assert abs(got - ref(k, n)) <= 1e-7 * np.abs(k).max()  # the kernel's float32 exp
    assert abs(got - jmmd.compute_mmd_unbiased(X, Y, bw)) <= 1e-6
    want = jmmd.mmd_permutation_test(X, Y, n_permutations=300, seed=4)
    res = tmmd.mmd_permutation_test(X, Y, n_permutations=300, seed=4, chunk=64, **CPU)
    assert list(res) == list(want) and res["bandwidth"] == pytest.approx(want["bandwidth"], rel=1e-12)
    for key in ("mmd2", "null_mean", "null_std"):
        assert abs(res[key] - want[key]) <= 1e-6, key
    # the p-values may differ only by permutations whose statistic lies within 1e-6 of the observed one
    perms = tmmd.draw_permutations(len(pool), 300, 4)
    null = np.asarray([ref(k[np.ix_(p, p)], n) for p in perms])
    near = int((np.abs(null - res["mmd2"]) <= 1e-6).sum())
    assert abs(res["p_value"] - want["p_value"]) * 300 <= near
    same = tmmd.mmd_permutation_test(X, Y, bandwidth=bw, permutations=perms, **CPU)
    assert same["p_value"] == res["p_value"] and same["null_mean"] == pytest.approx(res["null_mean"], rel=1e-12)


# -- the linear probe -----------------------------------------------------------------------------------------


def _probe_data(k, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [60, 90, 40][:k]
    X = rng.normal(size=(sum(sizes), 10)) + np.repeat(np.eye(k, 10) * 1.5, sizes, 0)
    return X, np.repeat(np.array(["a", "b", "c"][:k]), sizes)


@pytest.mark.parametrize("k", [2, 3])
def test_logistic_probe_matches_sklearn_and_the_jax_pipeline(k):
    X, y = _probe_data(k)
    Xv, yv = _probe_data(k, seed=1)
    ref = LogisticRegression(class_weight="balanced", tol=1e-10, max_iter=10000).fit(
        StandardScaler().fit_transform(X), y)
    tight, _ = tlin.train_linear_classifier(X, y, tol=1e-10, **CPU)
    assert np.abs(tight.coef - ref.coef_).max() <= 1e-5 * np.abs(ref.coef_).max()
    assert np.abs(tight.intercept - ref.intercept_).max() <= 1e-5 * max(np.abs(ref.intercept_).max(), 1)
    jp, jm = jlin.train_linear_classifier(X, y, Xv, yv)
    tp, tm = tlin.train_linear_classifier(X, y, Xv, yv, **CPU)
    disagree = int((tp.predict(Xv) != jp.predict(Xv)).sum())
    proba_j, proba_t = jp.predict_proba(Xv), tp.predict_proba(Xv)
    margin = np.abs(proba_j.max(1) - np.sort(proba_j, 1)[:, -2])
    assert disagree <= int((margin < 1e-2).sum()), disagree  # only rows near the decision boundary
    assert np.abs(proba_t - proba_j).max() <= 1e-2
    for key in jm:
        assert abs(tm[key] - jm[key]) <= disagree / len(yv) + 1e-12, key


def test_folds_cross_validation_lca_and_saving(tmp_path):
    y = np.random.default_rng(5).integers(0, 4, 103)
    for (a, b), (c, d) in zip(StratifiedKFold(5, shuffle=True, random_state=42).split(np.zeros(103), y),
                              tlin.stratified_kfold(y, 5, 42)):
        np.testing.assert_array_equal(c, a)
        np.testing.assert_array_equal(d, b)
    X, y = _probe_data(3)
    want, got = jlin.cross_validate_classifier(X, y, 4, seed=7), tlin.cross_validate_classifier(X, y, 4, seed=7, **CPU)
    assert all(got[k] == pytest.approx(want[k], abs=1e-12) for k in want)
    index = pd.DataFrame({"fov_name": np.where(np.arange(len(y)) % 3 == 0, "B/1/0", "A/1/0")})
    _, jm = jlca.fit_logistic_regression(X, y, ["A/1/0"], index)
    _, tm = tlca.fit_logistic_regression(X, y, ["A/1/0"], Frame({"fov_name": index["fov_name"].to_numpy()}), **CPU)
    assert tm.keys() == jm.keys() and tm["val_accuracy"] == pytest.approx(jm["val_accuracy"], abs=0.02)
    pipe, _ = tlin.train_linear_classifier(X, y, **CPU)
    pipe.save(tmp_path / "probe")
    back = tlin.LinearClassifierPipeline.load(tmp_path / "probe", **CPU)
    np.testing.assert_array_equal(back.predict_proba(X), pipe.predict_proba(X))
    assert back.classes == ["a", "b", "c"]
    jp, _ = jlin.train_linear_classifier(X, y)
    jp.save(tmp_path / "jax.pkl")
    with pytest.raises(NotImplementedError, match="pickled JAX"):
        tlin.LinearClassifierPipeline.load(tmp_path / "jax.pkl", **CPU)
    jp.pca = None
    carried = linear_pipeline_from_jax(pickle.loads(pickle.dumps(jp)), **CPU)
    np.testing.assert_allclose(carried.predict_proba(X), jp.predict_proba(X), rtol=0, atol=1e-12)
    assert list(carried.predict(X)) == list(jp.predict(X))


def test_predict_with_classifier_matches_jax():
    X, y = _probe_data(2)
    obs = pd.DataFrame({"fov_name": np.where(np.arange(len(y)) % 2, "A/1/0", "B/2/1")})
    jp, _ = jlin.train_linear_classifier(X, y)
    jad = jlin.predict_with_classifier(JAnnData(X=X, obs=obs.copy()), jp, "state", include_wells=["A/1"])
    tad = tlin.predict_with_classifier(AnnDataLite(X=X, obs=Frame({"fov_name": obs["fov_name"].to_numpy()})),
                                       linear_pipeline_from_jax(jp, **CPU), "state", include_wells=["A/1"])
    want = jad.obs["predicted_state"].to_numpy()
    got = tad.obs["predicted_state"]
    assert [str(v) for v in got] == [str(v) for v in want]
    np.testing.assert_allclose(tad.obsm["predicted_state_proba"], jad.obsm["predicted_state_proba"], atol=1e-12)
    assert tad.uns["predicted_state_classes"] == jad.uns["predicted_state_classes"]


# -- annotations and store edits ------------------------------------------------------------------------------


def _ann_csv(path, df, dup=False):
    ann = df[["fov_name", "t", "track_id", "y", "x"]].copy()
    ann["fov_name"] = "/" + ann["fov_name"]
    ann["state"] = np.where(ann["t"] % 2 == 0, "interphase", "mitosis")
    ann["score"] = np.arange(len(ann)) * 0.5
    if dup:  # a mitosis frame: the key again at another position
        extra = ann.iloc[[3, 8]].copy()
        extra["y"] += 2.0
        extra["state"] = "daughter"
        ann = pd.concat([extra, ann]).reset_index(drop=True)
    ann = ann.iloc[5:]  # some cells unannotated
    ann.to_csv(path, index=False)


@pytest.mark.parametrize("dup", [False, True])
def test_load_annotation_matches_jax(tmp_path, dup):
    X, df, frame = _tracks()
    _ann_csv(tmp_path / "ann.csv", df, dup)
    for name in ("state", "score"):
        want = jann.load_annotation(df.drop(columns=["id"]).copy(), tmp_path / "ann.csv", name)
        got = tann.load_annotation(Frame({k: frame[k] for k in frame.names if k != "id"}), tmp_path / "ann.csv", name)
        assert list(pd.isna(want)) == list(~tzarr.notna(got))
        keep = ~pd.isna(want).to_numpy()
        assert [str(v) for v in got[keep]] == [str(v) for v in want.to_numpy()[keep]]
    with pytest.raises(KeyError):
        tann.load_annotation_anndata(AnnDataLite(X=X, obs=frame), tmp_path / "ann.csv", "missing")


def test_merge_and_append_match_jax(tmp_path):
    X, df, frame = _tracks()
    csv = df[["id", "label", "cond"]].iloc[::2].copy()
    csv = pd.concat([csv, csv.iloc[:3].assign(label="dup")])
    csv.to_csv(tmp_path / "lab.csv", index=False)
    jdf, jstats = jzarr.merge_csv_into_obs(df.copy(), tmp_path / "lab.csv", "id", ["label", "cond"], "gt_")
    tfr, tstats = tzarr.merge_csv_into_obs(frame, tmp_path / "lab.csv", "id", ["label", "cond"], "gt_")
    assert tstats == jstats
    np.testing.assert_array_equal(tfr["gt_cond"], jdf["gt_cond"].to_numpy())
    assert [str(v) for v in tfr["gt_label"]] == [str(v) for v in jdf["gt_label"].to_numpy()]
    write_embedding_dataset(tmp_path / "e.zarr", X, frame)
    tzarr.append_to_embedding_dataset(tmp_path / "e.zarr", obsm={"Z": X[:, :3]}, obs=tfr, uns={"note": "n", "k": [1, 2]})
    tzarr.append_to_embedding_dataset(tmp_path / "e.zarr", obsm={"Z": X[:, :2]})
    back = read_anndata_zarr(tmp_path / "e.zarr")
    np.testing.assert_array_equal(back.obsm["Z"], X[:, :2])
    assert back.uns["note"] == "n" and list(back.uns["k"]) == [1, 2]
    assert [str(v) for v in back.obs["gt_label"]] == [str(v) for v in jdf["gt_label"].to_numpy()]
    with pytest.raises(FileNotFoundError):
        tzarr.append_to_embedding_dataset(tmp_path, obsm={"Z": X})


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    X, df, frame = _tracks()
    for call in (lambda: tclu.knn_accuracy(X, df["label"].to_numpy()), lambda: tmmd.median_heuristic(X, X),
                 lambda: tsmooth.compute_embeddings_smoothness(X, frame),
                 lambda: tlin.train_linear_classifier(X, df["label"].to_numpy())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
