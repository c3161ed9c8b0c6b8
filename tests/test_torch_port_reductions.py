"""The port's PCA, UMAP and PHATE (``viscy_tpu_torch.evaluation``) against
viscy_tpu's on numpy-seeded inputs, on the CPU (``device="cpu"``).

Tolerances: the fuzzy graph, ``find_ab_params``, the spectral start and a
layout run from the same start and draws agree to rounding in float64
(1e-12 or exactly); PHATE's kernel, diffusion time, landmark path (given
JAX's k-means labels), SMACOF and whole fit to 1e-6 of the range (the
float32 output's rounding), up to one sign per component; PCA to 1e-4 of
the range where sklearn is exact (JAX computes in float32), and to 1e-3
where sklearn is randomized.
"""

import numpy as np
import pytest
import scipy.sparse.csgraph as csgraph
import torch
from sklearn.cluster import MiniBatchKMeans
from sklearn.manifold import SpectralEmbedding, smacof
from sklearn.neighbors import NearestNeighbors

from viscy_tpu.evaluation import dimensionality_reduction as jdr
from viscy_tpu.evaluation import phate_native as jphate
from viscy_tpu.evaluation import umap_native as jumap
from viscy_tpu_torch.evaluation import _ops
from viscy_tpu_torch.evaluation import dimensionality_reduction as tdr
from viscy_tpu_torch.evaluation import phate_native as tphate
from viscy_tpu_torch.evaluation import umap_native as tumap

from _torch_port_helpers import rel_err


def _chain(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Points along a noisy line (a connected kNN graph)."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) + np.linspace(0, 6, n)[:, None] * rng.normal(size=d)


def _signed(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return got * np.sign((got * want).sum(axis=0))


# -- the kNN self-distance ------------------------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 768])
def test_sklearn_brute_force_self_distance_is_a_residue_and_the_ports_is_zero(d):
    """Above 15 features sklearn's brute-force kNN forms ``|x|^2 - 2x.y +
    |y|^2``: a point's distance to itself is a positive rounding residue for
    many rows, which JAX's UMAP then takes as ``rho`` (a JAX fault, Queue 3).
    The port's is exactly 0, and the other distances agree to 1e-12."""
    X = np.random.default_rng(d).normal(size=(200, d)) * 3 + 1
    dist, idx = NearestNeighbors(n_neighbors=10).fit(X).kneighbors(X)
    assert (idx[:, 0] == np.arange(200)).all()
    residues = int((dist[:, 0] > 0).sum())
    assert residues > 20, residues  # the fault shows at these shapes
    td, ti = _ops.exact_knn(torch.from_numpy(X), torch.from_numpy(X), 10)
    assert (td[:, 0] == 0).all() and (ti[:, 0] == torch.arange(200)).all()
    np.testing.assert_array_equal(ti.numpy(), idx)
    np.testing.assert_allclose(td.numpy()[:, 1:], dist[:, 1:], rtol=1e-12)


def test_the_fuzzy_graph_matches_jax_once_its_self_residue_is_zeroed(monkeypatch):
    """At 32 features JAX's graph differs from the port's only through the
    self-distance residue: with JAX's kNN self-distances set to 0 the two
    graphs agree entry for entry to 1e-12."""
    X = _chain(150, 32)
    knn = jumap._knn

    def zeroed(data, n_neighbors, metric):
        d, i = knn(data, n_neighbors, metric)
        d[i == np.arange(len(data))[:, None]] = 0.0
        return d, i

    monkeypatch.setattr(jumap, "_knn", zeroed)
    want = jumap.fuzzy_simplicial_set(X, 15)
    got = tumap.fuzzy_simplicial_set(X, 15, device="cpu")
    np.testing.assert_array_equal(got.row, want.row)
    np.testing.assert_array_equal(got.col, want.col)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-12, atol=1e-15)


# -- UMAP -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,k", [(120, 8, 15), (90, 12, 10)])
def test_fuzzy_graph_ab_and_spectral_start_match_jax(n, d, k):
    X = _chain(n, d, seed=n)
    want, got = jumap.fuzzy_simplicial_set(X, k), tumap.fuzzy_simplicial_set(X, k, device="cpu")
    assert csgraph.connected_components(want)[0] == 1
    np.testing.assert_array_equal(got.row, want.row)
    np.testing.assert_array_equal(got.col, want.col)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-12, atol=1e-15)
    assert tumap.find_ab_params(1.0, 0.1) == jumap.find_ab_params(1.0, 0.1)
    assert tumap.find_ab_params(2.0, 0.5) == jumap.find_ab_params(2.0, 0.5)
    np.testing.assert_array_equal(tumap._spectral_init(got, 2, 42), jumap._spectral_init(want, 2, 42))
    sk = SpectralEmbedding(n_components=3, affinity="precomputed", random_state=7).fit_transform(want.tocsr())
    np.testing.assert_allclose(tumap.spectral_layout(want, 3, 7), sk, rtol=0, atol=1e-12)


def _layout_inputs(n_epochs):
    X = _chain(150, 8)
    g = jumap.fuzzy_simplicial_set(X, 15)
    w = g.data.copy()
    w[w < w.max() / n_epochs] = 0.0
    keep = w > 0
    return jumap._spectral_init(g, 2, 42), g.row[keep], g.col[keep], w[keep]


def test_the_whole_layout_matches_jax_bit_for_bit_at_b_one():
    """500 epochs from JAX's start and draws, at ``b = 1`` (every pow is
    exact): the port's ``index_add_`` and summation order reproduce
    ``np.add.at`` bit for bit."""
    init, head, tail, w = _layout_inputs(500)
    want = jumap._optimize_layout(init, head, tail, w, 500, 1.58, 1.0, 1.0, 5, 3)
    got = tumap.optimize_layout(init, head, tail, w, 500, 1.58, 1.0, 1.0, 5, 3, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_the_layout_at_the_fitted_b_matches_jax_before_its_chaos_grows():
    """At the fitted ``b`` numpy's pow (AVX-512) and torch's differ in the
    last bit, and the layout's SGD (clipped repulsion at tiny distances)
    grows that to O(1) within about 20 epochs: the first 5 epochs agree to
    1e-12, and the drawn negatives passed explicitly give the same layout as
    the default draws."""
    init, head, tail, w = _layout_inputs(5)
    a, b = jumap.find_ab_params()
    want = jumap._optimize_layout(init, head, tail, w, 5, a, b, 1.0, 5, 3)
    got = tumap.optimize_layout(init, head, tail, w, 5, a, b, 1.0, 5, 3, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    negs = tumap.draw_negatives(tumap.epoch_schedule(w, 5), 150, 5, 3)
    again = tumap.optimize_layout(init, head, tail, w, 5, a, b, 1.0, 5, 3, negatives=negs, device="cpu")
    np.testing.assert_array_equal(again, got)


def test_umap_fit_and_transform_match_jax():
    X = _chain(100, 6, seed=4)
    j = jumap.NativeUMAP(n_epochs=5, n_neighbors=12, random_state=1).fit(X)
    t = tumap.NativeUMAP(n_epochs=5, n_neighbors=12, random_state=1, device="cpu").fit(X)
    np.testing.assert_allclose(t.embedding_, j.embedding_, rtol=0, atol=1e-6 * np.abs(j.embedding_).max())
    Y = X[:9] + 0.03
    np.testing.assert_allclose(t.transform(Y), j.transform(Y), rtol=0, atol=1e-6 * np.abs(j.embedding_).max())
    assert tumap.NativeUMAP(device="cpu", n_epochs=3).fit_transform(X[:4]).shape == (4, 2)  # random start


# -- PHATE ----------------------------------------------------------------------------------------------------


def test_alpha_decay_kernel_and_diffusion_time_match_jax():
    X = _chain(200, 10, seed=2)
    a, eps = jphate._alpha_decay_kernel(X, None, 5, 40.0, "euclidean")
    aff, idx, teps = tphate._alpha_decay(torch.from_numpy(X), torch.from_numpy(X), 5, 40.0, "euclidean")
    rows = np.repeat(np.arange(200), idx.shape[1])
    got = np.zeros((200, 200))
    got[rows, idx.numpy().ravel()] = aff.numpy().ravel()
    # exp(-(d / eps)^40) multiplies the rounding of d / eps by 40 (d / eps)^40: 1e-10 relative
    np.testing.assert_allclose(got, a.toarray(), rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(teps.numpy(), eps, rtol=1e-13)
    j = jphate.NativePHATE(n_pca=None).fit(X)
    t = tphate.NativePHATE(n_pca=None, device="cpu").fit(X)
    assert t.t_ == j.t_
    np.testing.assert_allclose(_signed(t.embedding_, j.embedding_), j.embedding_, rtol=0,
                               atol=1e-6 * np.ptp(j.embedding_))


def test_phate_landmarks_given_jax_labels_and_transform_match_jax():
    X = _chain(300, 12)
    j = jphate.NativePHATE(n_pca=5, n_landmark=60).fit(X)
    t = tphate.NativePHATE(n_pca=5, n_landmark=60, device="cpu").fit(X, labels=j._labels)
    assert t.t_ == j.t_
    tol = 1e-6 * np.ptp(j.embedding_)
    np.testing.assert_allclose(_signed(t.embedding_, j.embedding_), j.embedding_, rtol=0, atol=tol)
    Y = X[:7] + 0.05
    jt, tt = j.transform(Y), t.transform(Y)
    np.testing.assert_allclose(tt * np.sign((t.embedding_ * j.embedding_).sum(0)), jt, rtol=0, atol=tol)
    np.testing.assert_allclose(t._p_nm.numpy(), j._p_nm, rtol=1e-10, atol=1e-15)


def test_smacof_matches_sklearn_from_the_same_start():
    rng = np.random.default_rng(3)
    P = rng.normal(size=(40, 6))
    d = np.sqrt(((P[:, None] - P[None]) ** 2).sum(-1))
    init = rng.normal(size=(40, 2))
    want, stress, n_iter = smacof(d, n_components=2, init=init, n_init=1, max_iter=300, metric=True,
                                  normalized_stress=False, return_n_iter=True)
    got, tstress, titer = tphate.smacof(torch.from_numpy(d), torch.from_numpy(init), max_iter=300)
    assert titer == n_iter
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())
    assert tstress == pytest.approx(stress, rel=1e-10)


def test_minibatch_kmeans_inertia_is_within_five_percent_of_sklearns():
    X = _chain(1500, 8, seed=9)
    sk = MiniBatchKMeans(n_clusters=40, random_state=42, n_init=3, batch_size=1024).fit(X)
    labels, inertia = tphate.minibatch_kmeans(X, 40, device="cpu")
    assert labels.shape == (1500,) and len(np.unique(labels)) > 30
    assert inertia <= 1.05 * sk.inertia_, (inertia, sk.inertia_)
    recomputed = sum(((X[labels == c] - X[labels == c].mean(0)) ** 2).sum() for c in np.unique(labels))
    assert recomputed <= inertia * (1 + 1e-9)


# -- PCA and dispatch -----------------------------------------------------------------------------------------


@pytest.mark.parametrize("shape,whiten", [((400, 30), False), ((400, 30), True), ((200, 300), False)])
def test_pca_matches_jax_where_sklearn_is_exact(shape, whiten):
    """(400, 30): ``covariance_eigh``; (200, 300): ``full``. JAX computes in
    float32, the port in float64."""
    X = np.random.default_rng(1).normal(size=shape).astype(np.float32) * np.linspace(3, 0.5, shape[1])
    want, wratio = jdr.compute_pca(X, 5, whiten=whiten)
    got, ratio = tdr.compute_pca(X, 5, whiten=whiten, device="cpu")
    err, _ = rel_err(got, want)
    assert err <= 1e-4, err
    np.testing.assert_allclose(ratio, wratio, rtol=1e-4)


def test_pca_against_sklearns_randomized_solver():
    """(600, 100) with 5 components: sklearn picks ``randomized``; the port's
    exact scores agree with it to 1e-3 of the range on well-separated
    components."""
    X = np.random.default_rng(2).normal(size=(600, 100)) * np.r_[np.linspace(10, 6, 5), np.ones(95)]
    want, _ = jdr.compute_pca(X, 5)
    got, _ = tdr.compute_pca(X, 5, device="cpu")
    err, _ = rel_err(got, want)
    assert err <= 1e-3, err


def test_reduce_features_dispatch_and_the_device_default():
    X = _chain(60, 6, seed=8)
    np.testing.assert_array_equal(tdr.reduce_features(X, "pca", 3, device="cpu"), tdr.compute_pca(X, 3, device="cpu")[0])
    assert tdr.reduce_features(X, "umap", 2, device="cpu", n_epochs=3).shape == (60, 2)
    assert tdr.reduce_features(X, "phate", 2, device="cpu", n_pca=None).shape == (60, 2)
    with pytest.raises(ValueError, match="unknown reduction"):
        tdr.reduce_features(X, "tsne", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdr.compute_pca(X)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tumap.NativeUMAP()
