"""The port's dynacell feature tier against the JAX package on the CPU:
``feature_select``, ``feature_metrics``, ``linear_probe`` and the two model
extractors with weights carried across, plus the refusals and JAX's
process-salted projection seed.

Tolerances:

- feature selection: bit-identical (the keep mask and the kept columns);
- FID, KID, precision / recall / F1 (bootstrap means and stds), MIND and
  the median cosine: relative 1e-8, all float64. JAX's FID sums the square
  roots of ``eig(S1 S2)``; the port's of ``eigh(sqrt(S1) S2 sqrt(S1))``.
  With fewer cells than features the zero eigenvalues of either come out as
  rounding of size ``eps * lam_max``, so the two FIDs are held to
  ``2 (d - r) sqrt(eps * lam_max(S1 S2))`` there (``r`` the rank);
- GroupKFold's folds and ``roc_auc_score``: equal to sklearn's; the probe
  AUROC within 1e-3 of JAX's when both solvers run to ``tol = 1e-10``
  (both stop at 1e-4 by default);
- deep features from carried weights: within 2e-3 of the range and a
  Pearson r above 0.9999 of JAX's float32 forward, the bound the port's
  model tests hold ConvNeXt and ViT forwards to.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score as sk_auc
from sklearn.model_selection import GroupKFold

import viscy_tpu.apps.dynacell.eval.feature_metrics as jfm
import viscy_tpu.apps.dynacell.eval.feature_select as jsel
import viscy_tpu.apps.dynacell.eval.features as jfeat
import viscy_tpu.apps.dynacell.eval.linear_probe as jlp
import viscy_tpu_torch.apps.dynacell.eval.feature_metrics as tfm
import viscy_tpu_torch.apps.dynacell.eval.feature_select as tsel
import viscy_tpu_torch.apps.dynacell.eval.features as tfeat
import viscy_tpu_torch.apps.dynacell.eval.linear_probe as tlp
from viscy_tpu.models.contrastive.encoder import ContrastiveEncoder as JEncoder
from viscy_tpu.models.foundation.vit import DinoViT as JViT
from viscy_tpu_torch.training.convert import contrastive_state_dict_from_flax, dinovit_state_dict_from_flax

from _torch_port_helpers import assert_rel_close, seeded_params

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")
REL = 1e-8
ENCODER = dict(backbone="convnext_test", in_channels=1, in_stack_depth=1, stem_kernel_size=[1, 4, 4],
               stem_stride=[1, 4, 4], embedding_dim=32, projection_dim=16)
VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2)


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-300)


def _cohorts(n_pred: int, n_gt: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(d, d)) / np.sqrt(d)
    gt = rng.normal(size=(n_gt, d)) @ mix
    pred = 0.9 * (rng.normal(size=(n_pred, d)) @ mix) + 0.15
    return pred, gt


# -- feature selection ---------------------------------------------------------------
def test_select_features_is_bit_identical():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(120, 6))
    X = np.column_stack([base, base[:, 0] * 2 + 1e-3 * rng.normal(size=120), np.ones(120),
                         rng.integers(0, 2, 120), np.round(base[:, 1], 1), -base[:, 2] + 0.01 * rng.normal(size=120)])
    gt, pred = X[:60], X[60:] + 0.1
    got, want = tsel.select_features(gt, pred), jsel.select_features(gt, pred)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0 < want[2].sum() < X.shape[1]
    np.testing.assert_array_equal(tsel.variance_threshold(X, 0.2, 0.1), jsel.variance_threshold(X, 0.2, 0.1))
    np.testing.assert_array_equal(tsel.correlation_threshold(X, 0.5), jsel.correlation_threshold(X, 0.5))


# -- feature metrics ------------------------------------------------------------------
@pytest.mark.parametrize("n,d", [(150, 12), (60, 24)], ids=["wide-cohort", "narrow-cohort"])
def test_compute_feature_similarity(n, d):
    pred, gt = _cohorts(n, n, d, seed=d)
    kw = dict(kid_subsets=12, kid_subset_size=40, prc_bootstrap_subsets=8, mind_num_projections=64, rng_seed=5)
    got = tfm.compute_feature_similarity(pred, gt, "CP", **kw, **CPU)
    want = jfm.compute_feature_similarity(pred, gt, "CP", **kw)
    assert list(got) == list(want)
    for k in want:
        assert _rel(got[k], want[k]) <= REL, (k, got[k], want[k])
    got = tfm.compute_feature_similarity_pairwise(pred, gt, "DINOv3", kid_subsets=6, kid_subset_size=32, **CPU)
    want = jfm.compute_feature_similarity_pairwise(pred, gt, "DINOv3", kid_subsets=6, kid_subset_size=32)
    assert list(got) == list(want)
    for k in want:
        assert _rel(got[k], want[k]) <= REL, k
    empty = tfm.compute_feature_similarity(np.empty((0, d)), gt, "X", **CPU)
    assert list(empty) == list(jfm.compute_feature_similarity(np.empty((0, d)), gt, "X"))
    assert all(np.isnan(v) for v in empty.values())


def test_rank_deficient_fid_does_not_depend_on_the_solvers_rounding():
    """Fewer cells than features: permuting the features (the same FID in
    exact arithmetic) changes each solver's rounding of the zero
    eigenvalues. The port counts them as 0, so its two FIDs agree to
    rounding (as the card's and the CPU's do); JAX's differ by the
    noise's square roots (5e-9 here)."""
    pred, gt = _cohorts(40, 30, 64, seed=3)
    perm = np.random.default_rng(4).permutation(64)
    port = [tfm.frechet_distance(p, g, **CPU) for p, g in ((pred, gt), (pred[:, perm], gt[:, perm]))]
    assert _rel(*port) <= 1e-12
    jax = [jfm.frechet_distance(p, g) for p, g in ((pred, gt), (pred[:, perm], gt[:, perm]))]
    assert _rel(*jax) > 1e-10


def test_fid_against_jax_eigvals_form():
    """Full rank: within 1e-8. Fewer cells than features: within the
    rounding bound of the zero eigenvalues."""
    pred, gt = _cohorts(200, 180, 16, seed=1)
    assert _rel(tfm.frechet_distance(pred, gt, **CPU), jfm.frechet_distance(pred, gt)) <= REL
    pred, gt = _cohorts(40, 30, 64, seed=2)
    s12 = np.cov(pred, rowvar=False) @ np.cov(gt, rowvar=False)
    lam_max = float(np.abs(np.linalg.eigvals(s12)).max())
    rank = min(pred.shape[0], gt.shape[0]) - 1
    bound = 2 * (64 - rank) * np.sqrt(np.finfo(float).eps * lam_max)
    assert abs(tfm.frechet_distance(pred, gt, **CPU) - jfm.frechet_distance(pred, gt)) <= bound
    assert np.isnan(tfm.frechet_distance(pred[:1], gt, **CPU))


def test_kid_prc_and_mind_pieces():
    pred, gt = _cohorts(90, 70, 10, seed=4)
    got = tfm.kid_metric(pred, gt, kid_subsets=15, kid_subset_size=50, rng_seed=1, **CPU)
    want = jfm.kid_metric(pred, gt, kid_subsets=15, kid_subset_size=50, rng_seed=1)
    assert _rel(got[0], want[0]) <= REL and _rel(got[1], want[1]) <= REL
    assert np.isnan(tfm.kid_metric(pred[:10], gt, **CPU)[0])  # subsets below 16 rows
    assert tfm.precision_recall_f1(pred, gt, 5, **CPU) == jfm.precision_recall_f1(pred, gt, 5)
    assert np.isnan(tfm.precision_recall_f1(pred[:5], gt, 5, **CPU)[0])
    for a, b in ((pred, gt), (gt, pred), (pred[:70], gt)):  # unequal sizes: common quantiles
        assert _rel(tfm.mind_metric(a, b, 100, 3, **CPU), jfm.mind_metric(a, b, 100, 3)) <= REL


# -- linear probe -----------------------------------------------------------------------
def test_group_kfold_and_roc_auc_equal_sklearn():
    rng = np.random.default_rng(0)
    groups = np.asarray([f"B/{i % 7}/{i % 3}" for i in rng.integers(0, 40, 300)])
    for k in (2, 3, 5):
        want = list(GroupKFold(n_splits=k).split(np.zeros(300), groups=groups))
        got = tlp.group_kfold(groups, k)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError, match="n_splits=30"):
        tlp.group_kfold(groups, 30)
    y = rng.integers(0, 2, 300)
    for score in (rng.normal(size=300), np.round(rng.normal(size=300), 1), y + rng.normal(size=300)):
        assert tlp.roc_auc_score(y, score) == sk_auc(y, score)
    assert np.isnan(tlp.roc_auc_score(np.ones(5), np.arange(5.0)))
    X = rng.normal(size=(50, 4))
    np.testing.assert_array_equal(tlp.MADScaler().fit_transform(X), jlp.MADScaler().fit_transform(X))


@pytest.fixture
def tight_sklearn(monkeypatch):
    """Both probes' solvers run to tol 1e-10 (JAX's sklearn, the port's
    ``PROBE_TOL``)."""
    import functools

    import sklearn.linear_model

    monkeypatch.setattr(sklearn.linear_model, "LogisticRegression",
                        functools.partial(sklearn.linear_model.LogisticRegression, tol=1e-10, max_iter=10000))
    monkeypatch.setattr(tlp, "PROBE_TOL", 1e-10)


def _probe_data(seed: int, n: int = 240, d: int = 8, shift: float = 0.35):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (rng.random(n) < 0.45).astype(np.int8)
    X[y == 1, :3] += shift
    fov = np.asarray([f"A/1/{i}" for i in rng.integers(0, 9, n)])
    return X, y, fov


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fov_stratified_auroc_against_jax(seed, tight_sklearn):
    X, y, fov = _probe_data(seed)
    got = tlp.fov_stratified_auroc(X, y, fov, n_splits=5, **CPU)
    want = jlp.fov_stratified_auroc(X, y, fov, n_splits=5)
    assert got["n_folds"] == want["n_folds"] == 5
    assert abs(got["auroc_mean"] - want["auroc_mean"]) <= 1e-3
    assert abs(got["auroc_std"] - want["auroc_std"]) <= 1e-3
    a, b = tlp.paired_auroc(X[:100], X[100:], fov[:100], fov[100:], **CPU), \
        jlp.paired_auroc(X[:100], X[100:], fov[:100], fov[100:])
    assert a["n_folds"] == b["n_folds"] and abs(a["auroc_mean"] - b["auroc_mean"]) <= 1e-3


class OptimalLogistic:
    """sklearn's balanced L2 logistic regression (C = 1) solved to its
    optimum: scipy's BFGS on the columns scaled to unit magnitude, the
    penalty carried over. A stand-in for ``LogisticRegression`` with
    ``fit`` and ``predict_proba``."""

    def __init__(self, **_):
        pass

    def fit(self, X, y):
        from scipy.optimize import minimize

        self.classes_, codes = np.unique(y, return_inverse=True)
        col = np.abs(X).max(0)
        col[col == 0] = 1
        Xs = X / col
        sw = (len(codes) / (2 * np.bincount(codes)))[codes]

        def f(v):
            z = Xs @ v[:-1] + v[-1]
            p = 1 / (1 + np.exp(-z))
            loss = (sw * (np.logaddexp(0, z) - codes * z)).sum() / sw.sum()
            g = np.append(Xs.T @ (sw * (p - codes)), (sw * (p - codes)).sum()) / sw.sum()
            g[:-1] += v[:-1] / col**2 / sw.sum()
            return loss + 0.5 / sw.sum() * ((v[:-1] / col) ** 2).sum(), g

        v = minimize(f, np.zeros(X.shape[1] + 1), jac=True, method="BFGS", options={"gtol": 1e-12, "maxiter": 10000}).x
        self.coef_, self.intercept_ = (v[:-1] / col)[None], v[-1:]
        return self

    def predict_proba(self, X):
        p = 1 / (1 + np.exp(-(X @ self.coef_[0] + self.intercept_[0])))
        return np.stack([1 - p, p], axis=1)


def test_a_zero_mad_column_stalls_jax_probe_not_the_ports():
    """A column whose MAD is 0 on a training fold is scaled by the 1e-12
    floor to ~1e11. sklearn's solvers (JAX's probe uses lbfgs) stop near
    the start on such a fold; the port's L-BFGS, on columns scaled to unit
    magnitude, reaches the optimum."""
    from sklearn.linear_model import LogisticRegression

    from viscy_tpu_torch.evaluation.linear_classifier import fit_logistic_regression

    X, y, _ = _probe_data(5, n=40, d=4, shift=1.0)
    X[:, 1] = np.where(np.arange(40) % 3 == 0, X[:, 1], 0.0)  # mostly 0: MAD 0
    Xs = tlp.MADScaler().fit_transform(X)
    assert np.abs(Xs).max() > 1e10

    def objective(coef, b):
        z = Xs @ coef + b
        sw = (len(y) / (2 * np.bincount(y)))[y]
        return float((sw * (np.logaddexp(0, z) - y * z)).sum() / sw.sum() + 0.5 / sw.sum() * (coef**2).sum())

    lbfgs = LogisticRegression(class_weight="balanced", tol=1e-10, max_iter=2000).fit(Xs, y)
    best = OptimalLogistic().fit(Xs, y)
    coef, b = fit_logistic_regression(torch.from_numpy(Xs), y.astype(np.int64), 2, "balanced", max_iter=2000,
                                      tol=1e-10)
    optimum = objective(best.coef_[0], best.intercept_[0])
    assert abs(objective(coef[0], b[0]) - optimum) <= 1e-10
    assert objective(lbfgs.coef_[0], lbfgs.intercept_[0]) > optimum + 1e-2
    col = np.abs(Xs).max(0)
    np.testing.assert_allclose(coef[0] * col, best.coef_[0] * col, atol=1e-5)


def test_probe_edge_cases():
    X, y, fov = _probe_data(4, n=60)
    with pytest.warns(UserWarning, match="unique FOV"):
        out = tlp.fov_stratified_auroc(X, y, np.zeros(60), **CPU)
    assert np.isnan(out["auroc_mean"]) and out["n_folds"] == 1
    empty = tlp.paired_auroc(np.empty((0, 8)), X, [], fov, **CPU)
    assert empty["n_folds"] == 0 and np.isnan(empty["auroc_mean"]) and np.isnan(empty["auroc_std"])
    assert tlp.indistinguishability(0.5) == 1.0 and tlp.indistinguishability(0.0) == 0.0


# -- extractors ---------------------------------------------------------------------------
def _crops(n: int, seed: int, sizes=(16, 20, 12)) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.random((sizes[i % 3], sizes[(i + 1) % 3])).astype(np.float32) for i in range(n)]


def _jax_contrastive(tmp_path: Path, seed: int):
    """A JAX extractor built from seeded flax variables (no Orbax) and the
    port's checkpoint file of the same weights."""
    jmod = JEncoder(**{k: tuple(v) if isinstance(v, list) else v for k, v in ENCODER.items()})
    x = jnp.zeros((1, 1, 1, 32, 32), jnp.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))
    params = seeded_params(shapes["params"], seed)
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.normal(0, 0.1, s.shape) if p[-1].key == "mean" else rng.uniform(0.5, 1.5, s.shape))
        .astype(np.float32), shapes.get("batch_stats", {}))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}

    def apply_fn(v, batch):  # features.py's own apply for type: contrastive
        return jmod.apply(v, jnp.asarray(batch)[:, :, None])[0]

    ckpt = tmp_path / "dynaclr.pt"
    torch.save(contrastive_state_dict_from_flax(params, stats), ckpt)
    return jfeat.JaxEncoderExtractor(apply_fn, variables, 32, batch_cap=4), ckpt


def test_contrastive_extractor_with_carried_weights(tmp_path):
    jx, ckpt = _jax_contrastive(tmp_path, seed=11)
    cfg = {"feature_metrics": {"patch_size": 32, "dynaclr": {"type": "contrastive", "checkpoint": str(ckpt),
                                                             "model_config": ENCODER}}}
    ext = tfeat.load_eval_models(cfg, **CPU).extractors["dynaclr"]
    ext.batch_cap = 4  # three chunks, the last short
    crops = _crops(10, 0, sizes=(32, 40, 24))
    got, want = ext.extract_features_batch(crops), jx.extract_features_batch(crops)
    assert got.shape == want.shape == (10, 128)
    assert_rel_close(got, want, 2e-3, 0.9999)
    np.testing.assert_array_equal(ext.stack(crops)[:, 0, :24, :24], np.stack([c[:24, :24] for c in crops]))
    # a viscy-torch fit checkpoint of a ContrastiveModule (model.-prefixed, an auxiliary head dropped)
    state = torch.load(ckpt)
    fit_ckpt = tmp_path / "epoch=0-step=1"
    torch.save({"state_dict": {**{f"model.{k}": v for k, v in state.items()},
                               "model.aux_heads.cls.weight": torch.zeros(2, 2)}, "step": 1, "epoch": 0}, fit_ckpt)
    cfg["feature_metrics"]["dynaclr"]["checkpoint"] = str(fit_ckpt)
    again = tfeat.load_eval_models(cfg, **CPU).extractors["dynaclr"]
    again.batch_cap = 4
    np.testing.assert_array_equal(again.extract_features_batch(crops), got)


def test_dino_extractor_with_carried_weights(tmp_path):
    jmod = JViT(**VIT)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    params = seeded_params(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))["params"], 7)

    def apply_fn(v, batch):  # features.py's own apply for type: dino
        return jmod.apply(v, jnp.transpose(jnp.repeat(jnp.asarray(batch), 3, axis=1), (0, 2, 3, 1)))["cls"]

    jx = jfeat.JaxEncoderExtractor(apply_fn, {"params": jax.tree_util.tree_map(jnp.asarray, params)}, 32)
    ckpt = tmp_path / "dino.pt"
    torch.save(dinovit_state_dict_from_flax(params), ckpt)
    cfg = {"feature_metrics": {"patch_size": 32, "dinov3": {"type": "dino", "checkpoint": str(ckpt),
                                                            "model_config": VIT}}}
    ext = tfeat.load_eval_models(cfg, **CPU).extractors["dinov3"]
    crops = _crops(5, 1, sizes=(32, 40, 28))
    got, want = ext.extract_features_batch(crops), jx.extract_features_batch(crops)
    assert got.shape == want.shape == (5, 64)
    assert_rel_close(got, want, 2e-3, 0.9999)


def test_refusals_and_a_failing_backbone_raises(tmp_path):
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    spec = {"type": "contrastive", "checkpoint": str(orbax), "model_config": ENCODER}
    with pytest.raises(ValueError, match="Orbax"):
        tfeat.load_eval_models({"feature_metrics": {"dynaclr": spec}}, **CPU)
    missing = {"feature_metrics": {"dinov3": {"type": "dino", "checkpoint": str(tmp_path / "none.pt"),
                                              "model_config": VIT}}}
    with pytest.raises(FileNotFoundError):
        tfeat.load_eval_models(missing, **CPU)
    assert jfeat.load_eval_models(missing).extractors == {}  # JAX logs and skips it
    wrong = tmp_path / "wrong.pt"
    torch.save({"layernorm.weight": torch.ones(3)}, wrong)
    missing["feature_metrics"]["dinov3"]["checkpoint"] = str(wrong)
    with pytest.raises(RuntimeError, match="state_dict"):
        tfeat.load_eval_models(missing, **CPU)
    with pytest.raises(ValueError, match="unknown feature backbone"):
        tfeat.load_eval_models({"feature_metrics": {"celldino": {"type": "resnet"}}}, **CPU)
    with pytest.raises(NotImplementedError, match="cellpose"):
        tfeat.load_eval_models({"segmentation": {"backend": "cellpose"}}, **CPU)


def test_random_projection_extractor_equals_jax():
    crops = _crops(6, 2, sizes=(16, 16, 16))
    got = tfeat.RandomProjectionExtractor(16, dim=8, seed=4).extract_features_batch(crops)
    np.testing.assert_array_equal(got, jfeat.RandomProjectionExtractor(16, dim=8, seed=4).extract_features_batch(crops))
    cfg = {"feature_metrics": {"patch_size": 16, "dynaclr": {"type": "random_projection", "dim": 8, "seed": 7}}}
    a = tfeat.load_eval_models(cfg, **CPU).extractors["dynaclr"]
    b = jfeat.load_eval_models(cfg).extractors["dynaclr"]
    np.testing.assert_array_equal(a._w, b._w)


_SEEDS = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("jfeatures", "viscy_tpu/apps/dynacell/eval/features.py")
j = importlib.util.module_from_spec(spec)  # JAX's module alone: its package imports flax
sys.modules["jfeatures"] = j
spec.loader.exec_module(j)
import viscy_tpu_torch.apps.dynacell.eval.features as t
cfg = {"feature_metrics": {"patch_size": 4, "dinov3": {"type": "random_projection", "dim": 2}}}
print(float(j.load_eval_models(cfg).extractors["dinov3"]._w.sum()),
      float(t.load_eval_models(cfg, device="cpu").extractors["dinov3"]._w.sum()))
"""


def test_default_projection_seed_is_stable_across_processes():
    """JAX seeds the projection with ``hash(kind) % 997``, salted per
    process: two ``PYTHONHASHSEED`` give two embeddings. The port's
    ``crc32(kind) % 997`` gives one."""
    out = []
    for seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": seed, "PYTHONPATH": f"{ROOT}:{os.environ.get('PYTHONPATH', '')}"}
        r = subprocess.run([sys.executable, "-c", _SEEDS], capture_output=True, text=True, env=env, timeout=120,
                           cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        out.append([float(v) for v in r.stdout.split()[-2:]])
    (j1, t1), (j2, t2) = out
    assert j1 != j2 and t1 == t2
    assert tfeat.default_projection_seed("dinov3") == __import__("zlib").crc32(b"dinov3") % 997


def test_a_nan_cp_row_is_left_out_where_jax_raises():
    """A cell whose values are constant after the robust clip has NaN
    skewness and kurtosis. JAX's FID feeds the NaN covariance to
    ``np.linalg.eigvals``, which raises; the port leaves the row (and its
    pair) out and scores the rest as JAX scores them."""
    pred, gt = _cohorts(40, 40, 6, seed=9)
    bad = pred.copy()
    bad[[3, 17], 2] = np.nan
    with pytest.raises(np.linalg.LinAlgError):
        jfm.compute_feature_similarity_pairwise(bad, gt, "CP", kid_subsets=4, kid_subset_size=16)
    kw = dict(kid_subsets=4, kid_subset_size=16)
    got = tfm.compute_feature_similarity_pairwise(bad, gt, "CP", **kw, **CPU)
    keep = np.ones(40, bool)
    keep[[3, 17]] = False
    want = jfm.compute_feature_similarity_pairwise(pred[keep], gt[keep], "CP", **kw)
    for k in want:
        assert _rel(got[k], want[k]) <= REL, k
    got = tfm.compute_feature_similarity(bad, gt, "CP", **kw, prc_bootstrap_subsets=3, mind_num_projections=8, **CPU)
    want = jfm.compute_feature_similarity(pred[keep], gt[keep], "CP", **kw, prc_bootstrap_subsets=3,
                                          mind_num_projections=8)
    for k in want:
        assert _rel(got[k], want[k]) <= REL, k
