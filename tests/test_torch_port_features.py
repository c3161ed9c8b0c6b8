"""``viscy_tpu_torch.evaluation.feature`` (engineered single-cell features)
and ``annotation.convert`` against ``viscy_tpu`` on the CPU.

The port keeps JAX's operation order, so every feature is held bit for bit
(``_glcm`` counts pairs with ``np.bincount``: the same integer counts as
JAX's ``np.add.at``). Inputs are seeded with numpy; JAX's own cases
(``tests/test_evaluation.py``) are repeated on both packages."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

import _torch_port_helpers  # noqa: F401  (one torch thread share per xdist worker)
import viscy_tpu.evaluation.anndata_lite as jad
import viscy_tpu.evaluation.feature as jf
import viscy_tpu_torch.evaluation.feature as tf
from viscy_tpu.evaluation.annotation import convert as jconvert
from viscy_tpu_torch.evaluation.anndata_lite import Frame, read_anndata_zarr
from viscy_tpu_torch.evaluation.annotation import convert as tconvert


def _same_row(want: pd.DataFrame, got: Frame) -> None:
    assert got.names == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        w = want[c].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(got[c], w, err_msg=c)
        else:
            assert got[c].tolist() == w.tolist(), c


def _jax_case() -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_evaluation.py::test_cell_features_full``'s patch: a
    square and an elongated label."""
    rng = np.random.default_rng(0)
    img = rng.random((64, 64)).astype(np.float32)
    mask = np.zeros((64, 64), np.int16)
    mask[10:30, 10:30] = 1
    mask[40:60, 20:25] = 2
    return img, mask


def _seeded_cell(seed: int, side: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """A blurred blob with noise and a label mask of two ellipses."""
    rng = np.random.default_rng(seed)
    y, x = np.indices((side, side))
    c = side / 2 + rng.normal(0, 4, 2)
    r2 = ((y - c[0]) / rng.uniform(18, 30)) ** 2 + ((x - c[1]) / rng.uniform(18, 30)) ** 2
    img = (np.exp(-r2) * rng.uniform(200, 900) + rng.normal(100, 15, (side, side))).astype(np.float32)
    mask = np.zeros((side, side), np.int32)
    mask[r2 <= 1.0] = 1
    mask[(((y - 20) / 6.0) ** 2 + ((x - 100) / 12.0) ** 2) <= 1.0] = 3
    return img, mask


@pytest.mark.parametrize("case", ["jax", "seed1", "seed2"])
@pytest.mark.parametrize("with_mask", [True, False])
def test_cell_features_match_jax(case, with_mask):
    img, mask = _jax_case() if case == "jax" else _seeded_cell(int(case[-1]))
    mask = mask if with_mask else None
    want = jf.CellFeatures(img, mask).compute_all_features()
    got = tf.CellFeatures(img, mask).compute_all_features()
    _same_row(want, got)
    assert ("area" in got) == with_mask


def test_each_feature_group_matches_jax():
    img, mask = _seeded_cell(3, side=96)
    j, t = jf.CellFeatures(img, mask), tf.CellFeatures(img, mask)
    for name in ("compute_intensity_features", "compute_texture_features", "compute_morphology_features",
                 "compute_symmetry_descriptor"):
        getattr(j, name)()
        getattr(t, name)()
    for group in ("intensity_features", "texture_features", "morphology_features", "symmetry_descriptor"):
        assert getattr(t, group) == getattr(j, group), group
    for name in ("_compute_kurtosis", "_compute_skewness", "_compute_iqr", "_compute_area",
                 "_compute_intensity_localization", "_compute_radial_intensity_gradient"):
        assert getattr(t, name)() == getattr(j, name)(), name
    with pytest.raises(AssertionError, match="required"):
        tf.CellFeatures(img).compute_morphology_features()
    with pytest.raises(AssertionError, match="empty"):
        tf.CellFeatures(img, np.zeros_like(mask)).compute_morphology_features()


def _shapes() -> dict[str, np.ndarray]:
    """``test_cell_features_shape_discrimination``'s circle and bar, and a
    seeded label image of several blobs."""
    circle = np.zeros((65, 65), np.int16)
    y, x = np.indices(circle.shape)
    circle[(y - 32) ** 2 + (x - 32) ** 2 <= 20**2] = 1
    bar = np.zeros((65, 65), np.int16)
    bar[30:35, 5:60] = 1
    rng = np.random.default_rng(7)
    blobs = np.zeros((80, 80), np.int16)
    for lab in (2, 5, 9):
        cy, cx, ry, rx = rng.uniform(15, 65), rng.uniform(15, 65), rng.uniform(3, 10), rng.uniform(3, 10)
        yy, xx = np.indices(blobs.shape)
        blobs[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = lab
    return {"circle": circle, "bar": bar, "blobs": blobs}


@pytest.mark.parametrize("name", ["circle", "bar", "blobs"])
def test_region_props_and_zernike_match_jax(name):
    mask = _shapes()[name]
    assert tf._region_props(mask) == jf._region_props(mask)
    image = mask.astype(float) * np.random.default_rng(1).uniform(0.5, 1.5, mask.shape)
    for radius, degree in ((32, 8), (20, 6)):
        np.testing.assert_array_equal(tf._zernike_moments(image, radius, degree),
                                      jf._zernike_moments(image, radius, degree))
    np.testing.assert_array_equal(tf._zernike_moments(np.zeros((9, 9)), 4), jf._zernike_moments(np.zeros((9, 9)), 4))


def test_shape_discrimination_as_jax_asserts():
    s = _shapes()
    assert tf._region_props(s["circle"])[0]["eccentricity"] < 0.2 < 0.9 < tf._region_props(s["bar"])[0]["eccentricity"]
    z0 = tf._zernike_moments(s["circle"].astype(float), 32)
    np.testing.assert_allclose(z0, tf._zernike_moments(np.rot90(s["circle"]).astype(float), 32), atol=1e-6)


@pytest.mark.parametrize("offset", [(0, 1), (-1, 1), (-1, 0), (-1, -1), (2, -3)])
def test_glcm_counts_by_bincount_equal_jax(offset):
    u8 = np.random.default_rng(4).integers(0, 256, (40, 33)).astype(np.uint8)
    np.testing.assert_array_equal(tf._glcm(u8, offset), jf._glcm(u8, offset))
    assert tf._glcm_props(tf._glcm(u8, offset)) == jf._glcm_props(jf._glcm(u8, offset))


@pytest.mark.parametrize("fn", ["compute_intensity_features", "compute_texture_features"])
def test_compute_functions_match_jax(fn):
    patch = _seeded_cell(5, side=64)[0][None, None]
    assert getattr(tf, fn)(patch) == getattr(jf, fn)(patch)


def test_compute_patch_features_matches_jax():
    img, mask = _seeded_cell(6, side=64)
    _same_row(jf.compute_patch_features(img[None], mask), tf.compute_patch_features(img[None], mask))
    _same_row(jf.compute_patch_features(img[None]), tf.compute_patch_features(img[None]))


def _tracks(seed: int = 0, n_tracks: int = 12, frames: int = 9) -> pd.DataFrame:
    """Seeded random walks, rows shuffled, unique ``t`` per track; short
    tracks (1 and 2 rows) and string ids among them."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n_tracks):
        n = {0: 1, 1: 2}.get(k, frames)
        t0 = int(rng.integers(0, 4))
        xy = np.cumsum(rng.normal(0, 3, (n, 2)), axis=0) + rng.uniform(50, 500, 2)
        for i in range(n):
            rows.append({"track_id": f"trk{k}" if k % 4 == 3 else k, "t": t0 + 2 * i if k == 5 else t0 + i,
                         "y": xy[i, 0], "x": xy[i, 1]})
    df = pd.DataFrame(rows).sample(frac=1.0, random_state=seed).reset_index(drop=True)
    return df


def _columns(df: pd.DataFrame) -> dict[str, np.ndarray]:
    return {k: np.asarray(df[k].tolist(), dtype=object) if df[k].dtype == object else df[k].to_numpy()
            for k in df.columns}


def test_dynamic_features_of_jax_case_match_jax():
    straight = pd.DataFrame({"track_id": ["a"] * 5, "t": range(5), "x": np.arange(5.0), "y": np.zeros(5)})
    turn = pd.DataFrame({"track_id": ["b"] * 5, "t": range(5), "x": [0.0, 1, 2, 2, 2], "y": [0.0, 0, 0, 1, 2]})
    df = pd.concat([straight, turn])
    want, got = jf.DynamicFeatures(df).to_df(), tf.DynamicFeatures(_columns(df)).to_df()
    _same_row(want, got)
    assert got["directional_persistence"][0] == pytest.approx(1.0)
    assert got["mean_angular_velocity"][0] == pytest.approx(0.0)
    assert got["max_angular_velocity"][1] > 1.0


@pytest.mark.parametrize("source", ["frame", "dict", "csv"])
def test_dynamic_features_of_seeded_tracks_match_jax(source, tmp_path):
    df = _tracks(3)
    df["track_id"] = df["track_id"].astype(str)  # one type a column, as a CSV holds it
    want = jf.DynamicFeatures(df).to_df()
    if source == "csv":
        df.to_csv(tmp_path / "tracks.csv", index=False)
        table = tmp_path / "tracks.csv"
    else:
        table = _columns(df) if source == "dict" else Frame(_columns(df))
    dyn = tf.DynamicFeatures(table)
    _same_row(want, dyn.to_df())
    _same_row(jf.DynamicFeatures(df).compute_all_features("5"), dyn.compute_all_features("5"))


def test_dynamic_features_with_integer_ids_match_jax():
    df = _tracks(4)
    df = df[df["track_id"].map(lambda v: isinstance(v, int))].astype({"track_id": np.int64})
    _same_row(jf.DynamicFeatures(df).to_df(), tf.DynamicFeatures(_columns(df)).to_df())


def test_a_repeated_t_is_ordered_stably_where_pandas_may_not():
    """JAX sorts a track with ``sort_values("t")``, which is not stable: with
    a repeated ``t`` the rows of that frame may come in either order, and the
    path length and speeds change with it. The port sorts stably (the rows'
    order within a frame), so its features are those of the stable order;
    JAX's equal them exactly when pandas' order is the stable one."""
    rng = np.random.default_rng(11)
    t = np.repeat(np.arange(5), 2)[rng.permutation(10)]
    df = pd.DataFrame({"track_id": np.zeros(10, np.int64), "t": t, "y": rng.normal(0, 5, 10),
                       "x": rng.normal(0, 5, 10)})
    got = tf.DynamicFeatures(_columns(df)).to_df()
    stable = df.iloc[np.argsort(t, kind="stable")].reset_index(drop=True)
    ref = jf.DynamicFeatures(stable.assign(t=np.arange(10))).to_df()  # distinct t: no sort ambiguity
    dt = np.diff(stable["t"].to_numpy()).astype(float)
    step = np.hypot(np.diff(stable["x"]), np.diff(stable["y"]))
    assert got["total_distance"][0] == ref["total_distance"][0] == float(step.sum())
    assert got["max_velocity"][0] == float((step / np.maximum(dt, 1e-10)).max())
    pandas_order = df.sort_values("t").index.to_numpy()
    want = jf.DynamicFeatures(df).to_df()
    jax_ref = jf.DynamicFeatures(df.loc[pandas_order].reset_index(drop=True).assign(t=np.arange(10))).to_df()
    assert want["total_distance"][0] == jax_ref["total_distance"][0]
    if (pandas_order != np.argsort(t, kind="stable")).any():  # pandas' quicksort moved a tie (it does here)
        assert want["total_distance"][0] != got["total_distance"][0]
    else:
        _same_row(want, got)


def test_one_track_id_in_several_fovs_is_one_track_in_both():
    """Rows are picked by ``track_id`` alone, in JAX as in the port: track 0
    of two FOVs is one track whose rows interleave by ``t``."""
    a = pd.DataFrame({"fov_name": "A/1/0", "track_id": 0, "t": [0, 1, 2], "y": [0.0, 1, 2], "x": [0.0, 0, 0]})
    b = pd.DataFrame({"fov_name": "B/2/0", "track_id": 0, "t": [3, 4], "y": [50.0, 51], "x": [50.0, 50]})
    df = pd.concat([a, b], ignore_index=True)
    want, got = jf.DynamicFeatures(df).to_df(), tf.DynamicFeatures(_columns(df)).to_df()
    _same_row(want, got)
    assert len(got) == 1 and got["total_distance"][0] > 70


def _embeddings(n: int = 40, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    index = pd.DataFrame({"fov_name": [f"/A/1/{i % 3}" for i in range(n)], "track_id": np.arange(n) // 4,
                          "t": np.arange(n) % 4, "id": np.arange(n), "y": rng.uniform(0, 100, n).round(2),
                          "x": rng.uniform(0, 100, n).round(2)})
    return {"features": rng.normal(size=(n, 16)).astype(np.float32), "index": index,
            "projections": rng.normal(size=(n, 8)).astype(np.float32)}


def _same_store(got, want) -> None:
    np.testing.assert_array_equal(got.X, want.X)
    assert got.obs.names == want.obs.names
    for c in want.obs.names:
        assert got.obs[c].tolist() == want.obs[c].tolist(), c
    assert got.obs.index.tolist() == want.obs.index.tolist()
    assert sorted(got.obsm) == sorted(want.obsm)
    for k in want.obsm:
        np.testing.assert_array_equal(got.obsm[k], want.obsm[k])


def test_convert_a_dict_and_a_store_equal_jax(tmp_path, monkeypatch):
    """``convert`` of a dict (written to a store first) and of a store, read
    back equal to JAX's output; the port removes its temporary store where
    JAX leaves ``<output>.tmp_embeddings`` behind, so JAX's second convert of
    a dict to the same output raises even with ``overwrite``."""
    monkeypatch.setattr(jad, "_write_numeric_ts", jad._write_array)  # JAX's numeric arrays uncompressed
    emb = _embeddings()
    tdict = dict(emb, index=Frame({k: np.asarray(v.tolist(), dtype=object) if v.dtype == object else v.to_numpy()
                                  for k, v in emb["index"].items()}))
    assert jconvert(emb, tmp_path / "j.zarr") is None
    got = tconvert(tdict, tmp_path / "t.zarr", return_anndata=True)
    _same_store(got, read_anndata_zarr(tmp_path / "j.zarr"))
    assert (tmp_path / "j.tmp_embeddings").exists() and not (tmp_path / "t.tmp_embeddings").exists()
    with pytest.raises(FileExistsError):
        jconvert(emb, tmp_path / "j.zarr", overwrite=True)
    with pytest.raises(FileExistsError):
        tconvert(tdict, tmp_path / "t.zarr")
    tconvert(tdict, tmp_path / "t.zarr", overwrite=True)
    # a store: the port's written store converted by both
    jconvert(tmp_path / "t.zarr", tmp_path / "j2.zarr")
    got2 = tconvert(tmp_path / "t.zarr", tmp_path / "t2.zarr", return_anndata=True)
    _same_store(got2, read_anndata_zarr(tmp_path / "j2.zarr"))
    _same_store(got2, got)
