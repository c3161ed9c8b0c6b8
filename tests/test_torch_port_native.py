"""Host kernel H1 (``viscy_tpu_torch/csrc/crop_norm.cpp`` through
``viscy_tpu_torch.native``) against ``viscy_tpu.native`` on the CPU: built
with the host compiler here, bit for bit against JAX's kernel and the plain
PyTorch version, the bounds check, a failed build raising, and the pushdown
crop of the cached fit running through it with JAX's batches."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_port_helpers  # noqa: F401  (one torch thread share per xdist worker)
import viscy_tpu.native as jn
import viscy_tpu_torch.native as tn
from viscy_tpu_torch.ops import _build

CHANNELS = ["Phase3D", "Nucleus", "Membrane"]


def _case(seed: int = 0, shape=(3, 12, 64, 64), n: int = 8, patch=(5, 32, 32)):
    rng = np.random.default_rng(seed)
    vol = rng.random(shape).astype(np.float32) * 3 - 1
    hi = np.asarray(shape[1:]) - np.asarray(patch) + 1
    origins = np.stack([rng.integers(0, h, n) for h in hi], axis=1).astype(np.int64)
    return vol, origins, patch


STATS = {
    "stats": (np.array([0.5, 0.3, 0.1], np.float32), np.array([0.2, 0.4, 1.7], np.float32)),
    "std0": (np.array([0.5, -0.3, 0.1], np.float32), np.array([0.2, 0.0, 0.4], np.float32)),
    "none": (None, None),
}


@pytest.mark.parametrize("stats", list(STATS))
@pytest.mark.parametrize("n_threads", [0, 1, 3])
def test_float32_crop_equals_jax_kernel_and_the_plain_version(stats, n_threads):
    """f32 with statistics, with a std of 0 (that channel copied unchanged),
    and without statistics; the thread count does not move a bit."""
    assert jn.native_available()  # JAX's own kernel, not its fallback
    vol, origins, patch = _case(1)
    means, stds = STATS[stats]
    got = tn.batched_crop_normalize(vol, origins, patch, means, stds, n_threads=n_threads)
    want = jn.batched_crop_normalize(vol, origins, patch, means, stds)
    assert got.dtype == want.dtype == np.float32 and got.shape == (8, 3, *patch)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == tn.batched_crop_normalize_plain(vol, origins, patch, means, stds).tobytes()
    if stats == "std0":
        z0, y0, x0 = origins[0]
        np.testing.assert_array_equal(got[0, 1], vol[1, z0:z0 + 5, y0:y0 + 32, x0:x0 + 32])


@pytest.mark.parametrize("n_threads", [0, 2])
def test_uint16_stays_uint16_and_equals_jax(n_threads):
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 65535, (2, 6, 32, 32), dtype=np.uint16)
    origins = np.array([[0, 0, 0], [2, 8, 4], [1, 16, 16]], np.int64)
    got = tn.batched_crop_normalize(vol, origins, (4, 16, 16), n_threads=n_threads)
    want = jn.batched_crop_normalize(vol, origins, (4, 16, 16))
    assert got.dtype == want.dtype == np.uint16
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == tn.batched_crop_normalize_plain(vol, origins, (4, 16, 16)).tobytes()
    # with statistics a uint16 volume is normalized in float32, as in JAX
    m, s = np.array([100.0, 7.0], np.float32), np.array([50.0, 3.0], np.float32)
    norm = tn.batched_crop_normalize(vol, origins, (4, 16, 16), m, s)
    assert norm.dtype == np.float32 and norm.tobytes() == jn.batched_crop_normalize(vol, origins, (4, 16, 16), m,
                                                                                    s).tobytes()


def test_other_dtypes_and_layouts_are_cast_as_jax_casts_them():
    vol, origins, patch = _case(2, shape=(2, 7, 20, 24), n=3, patch=(3, 8, 8))
    for v in (vol.astype(np.float64), np.asfortranarray(vol), vol.astype(np.int16)):
        got = tn.batched_crop_normalize(v, origins, patch)
        assert got.dtype == np.float32 and got.tobytes() == jn.batched_crop_normalize(v, origins, patch).tobytes()


@pytest.mark.parametrize("origin", [[0, 0, 5], [-1, 0, 0], [1, 0, 0], [0, 1, 0]])
def test_the_bounds_check(origin):
    vol = np.zeros((1, 4, 8, 8), np.float32)
    for fn in (tn.batched_crop_normalize, tn.batched_crop_normalize_plain, jn.batched_crop_normalize):
        with pytest.raises(ValueError, match="out of bounds"):
            fn(vol, np.array([origin]), (4, 8, 8))


def test_each_call_counts_one_launch():
    vol, origins, patch = _case(3)
    before = tn.launches["crop_norm"]
    tn.batched_crop_normalize(vol, origins, patch)
    tn.batched_crop_normalize(vol.astype(np.uint16), origins, patch)
    tn.batched_crop_normalize_plain(vol, origins, patch)
    assert tn.launches["crop_norm"] == before + 2


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A source that does not compile, or no host compiler: the wrapper
    raises (JAX falls back to numpy, ``viscy_tpu/native/__init__.py:50-52``)."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "crop_norm.cpp").write_text('extern "C" void crop_u16( { broken\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    vol, origins, patch = _case(4)
    with pytest.raises(RuntimeError, match="failed for crop_norm"):
        tn.batched_crop_normalize(vol, origins, patch)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no-such-compiler-here"):
        tn.batched_crop_normalize(vol, origins, patch)
    assert not hasattr(tn, "native_available")


def test_jax_fallback_differs_from_jax_kernel():
    """JAX's numpy fallback divides where its kernel (and the port)
    multiplies by the reciprocal: thousands of elements differ in the last
    bit; at a std of 0 the fallback gives inf / nan where the kernel copies."""
    vol = np.random.default_rng(0).random((3, 12, 64, 64)).astype(np.float32)
    origins = _case(0)[1]
    means, stds = np.array([0.5, 0.3, 0.1], np.float32), np.array([0.2, 0.4, 1.0], np.float32)
    kernel = jn.batched_crop_normalize(vol, origins, (5, 32, 32), means, stds)
    fallback = jn._numpy_crop_normalize(vol, origins, (5, 32, 32), means, stds)
    differ = kernel != fallback
    assert differ[:, :2].sum() > 1000 and not differ[:, 2].any()  # std 1: both exact
    np.testing.assert_allclose(kernel, fallback, rtol=2e-7, atol=0)  # one ulp apart
    assert tn.batched_crop_normalize(vol, origins, (5, 32, 32), means, stds).tobytes() == kernel.tobytes()
    zero = np.array([0.2, 0.0, 1.0], np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        fb = jn._numpy_crop_normalize(vol, origins, (5, 32, 32), means, zero)
    assert not np.isfinite(fb[:, 1]).all()
    assert np.isfinite(jn.batched_crop_normalize(vol, origins, (5, 32, 32), means, zero)).all()


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr
    from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

    path = tmp_path_factory.mktemp("native") / "plate.zarr"
    build_hcs_plate(path, CHANNELS, zyx_shape=(8, 48, 48), num_timepoints=1, rows=("A",), cols=("1",),
                    fovs=("0", "1", "2"), seed=5)
    for i, (_, pos) in enumerate(open_ome_zarr(path, mode="r+").positions()):
        pos.zattrs["normalization"] = {ch: {"fov_statistics": {"mean": 0.1 * i, "std": 0.3}} for ch in CHANNELS}
    return path


def _cached_dm(pkg: str, path, num_workers: int):
    from viscy_tpu.data import hcs as jhcs
    from viscy_tpu.data.host_transforms import HostRandWeightedCropd as JCrop
    from viscy_tpu_torch.data import hcs as thcs
    from viscy_tpu_torch.data.host_transforms import HostRandWeightedCropd as TCrop

    crop = (JCrop if pkg == "jax" else TCrop)(keys=CHANNELS + ["weight"], w_key="weight", spatial_size=[5, 24, 24],
                                              num_samples=2)
    mod = jhcs if pkg == "jax" else thcs
    return mod.HCSDataModule(path, source_channel="Phase3D", target_channel=["Nucleus", "Membrane"], z_window_size=5,
                             batch_size=4, num_workers=num_workers, yx_patch_size=(24, 24), augmentations=[crop],
                             caching=True, seed=11)


@pytest.mark.parametrize("num_workers", [0, 3])
def test_the_cached_fit_crops_through_h1_with_jax_batches(plate, num_workers):
    """``caching: true`` with the weighted crop the only host transform:
    the port's pushdown crop runs H1 once an item, and every train batch
    equals JAX's bit for bit (JAX's pushdown runs its own kernel)."""
    jdm, tdm = _cached_dm("jax", plate, num_workers), _cached_dm("torch", plate, num_workers)
    jdm.setup("fit")
    tdm.setup("fit")
    ds = tdm.train_dataset
    assert ds.pushdown_crop is not None and ds._preloaded[0].flags["C_CONTIGUOUS"]
    before = tn.launches["crop_norm"]
    for epoch in (0, 1):
        jdm.set_epoch(epoch)
        tdm.set_epoch(epoch)
        want, got = list(jdm.train_dataloader()), list(tdm.train_dataloader())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in ("source", "target"):
                assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
    assert tn.launches["crop_norm"] - before == 2 * len(ds)


def test_a_preload_h1_does_not_take_keeps_the_per_patch_copies(plate):
    """JAX's condition: a non-contiguous preload (or uint16 without
    ``keep_dtype``) takes the per-patch copies, as in JAX."""
    tdm = _cached_dm("torch", plate, 0)
    tdm.setup("fit")
    ds = tdm.train_dataset
    want = ds.get_item_with_epoch(0, 0)
    ds._preloaded = [np.asfortranarray(v) for v in ds._preloaded]
    before = tn.launches["crop_norm"]
    got = ds.get_item_with_epoch(0, 0)
    assert tn.launches["crop_norm"] == before
    for g, w in zip(got, want):
        assert np.array_equal(g["source"], w["source"]) and np.array_equal(g["target"], w["target"])
