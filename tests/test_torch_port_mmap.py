"""The port's memory-mapped fit data (``data/mmap_cache.py``) and FOV
selection (``data/select.py``) against viscy_tpu's.

``stage_to_mmap`` stages the plate's channels bit for bit, into the JAX
cache directory's name (the same fingerprint) under ``SLURM_JOB_ID`` when
set; a complete cache is reused, a partial one rebuilt. ``MmappedDataset``
items and ``MmappedDataModule`` host batches (train over two epochs, val;
weighted crop; 0 and 2 loader threads; ``include_fov_names``) equal JAX's
bit for bit. ``exclude_fov_names`` raises and says why. ``filter_fovs``
and ``SelectWell`` select what JAX's select."""

import logging

import numpy as np
import pytest

from viscy_tpu.data import mmap_cache as jmm
from viscy_tpu.data import select as jselect
from viscy_tpu.data.host_transforms import HostRandWeightedCropd as JCrop
from viscy_tpu.transforms.normalize import NormalizeSampled as JNormalize
from viscy_tpu.zarr_io.store import open_ome_zarr as j_open
from viscy_tpu_torch.data import mmap_cache as tmm
from viscy_tpu_torch.data import select as tselect
from viscy_tpu_torch.data.host_transforms import HostRandWeightedCropd as TCrop
from viscy_tpu_torch.transforms import NormalizeSampled
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

CHANNELS = ["Phase3D", "Nucleus", "Membrane"]
INCLUDE = ["A/1/0", "A/2/0", "A/2/1"]


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    path = tmp_path_factory.mktemp("mmap") / "plate.zarr"
    build_hcs_plate(path, CHANNELS, zyx_shape=(7, 36, 36), num_timepoints=2, rows=("A",), cols=("1", "2"),
                    fovs=("0", "1"), seed=12, norm_meta=True)
    return path


def test_staging_is_bit_exact_reused_and_rebuilt(plate, tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    channels = ["Membrane", "Phase3D"]
    views, cache = tmm.stage_to_mmap(plate, channels, tmp_path / "port", include_fov_names=INCLUDE)
    jviews, jcache = jmm.stage_to_mmap(plate, channels, tmp_path / "jax", include_fov_names=INCLUDE)
    assert cache.parent == tmp_path / "port" / "4242" and cache.name == jcache.name
    src = open_ome_zarr(plate)
    assert len(views) == len(jviews) == 3
    for name, v, jv in zip(INCLUDE, views, jviews):
        want = src[name]["0"].oindex[:, [2, 0]]
        assert v.dtype == np.float32 and np.array_equal(v, want) and np.array_equal(v, jv)
    with caplog.at_level(logging.INFO, logger="viscy_tpu_torch"):
        again, cache2 = tmm.stage_to_mmap(plate, channels, tmp_path / "port", include_fov_names=INCLUDE)
    assert cache2 == cache and "Reusing" in caplog.text and np.array_equal(again[2], views[2])
    (cache / ".done").unlink()  # a crash before the marker leaves a partial cache
    with caplog.at_level(logging.WARNING, logger="viscy_tpu_torch"):
        rebuilt, _ = tmm.stage_to_mmap(plate, channels, tmp_path / "port", include_fov_names=INCLUDE)
    assert "Rebuilding" in caplog.text and (cache / ".done").exists() and np.array_equal(rebuilt[0], views[0])


def test_mmapped_dataset_items_equal_jax(plate, tmp_path):
    views, _ = tmm.stage_to_mmap(plate, CHANNELS, tmp_path)
    positions = [p for _, p in open_ome_zarr(plate).positions()]
    jpositions = [p for _, p in j_open(plate).positions()]
    got, want = tmm.MmappedDataset(views, positions), jmm.MmappedDataset(views, jpositions)
    assert len(got) == len(want) == 8
    for i in (0, 5):
        g, w = got[i], want[i]
        assert np.array_equal(g["source"], w["source"]) and g["norm_meta"] == w["norm_meta"]


def _dm(pkg, plate, scratch, num_workers, **kw):
    crop = (JCrop if pkg == "jax" else TCrop)(keys=CHANNELS + ["weight"], w_key="weight",
                                              spatial_size=[5, 24, 24], num_samples=2)
    norm = (JNormalize if pkg == "jax" else NormalizeSampled)(keys=CHANNELS, level="fov_statistics")
    mod = jmm if pkg == "jax" else tmm
    return mod.MmappedDataModule(plate, source_channel="Phase3D", target_channel=["Nucleus", "Membrane"],
                                 z_window_size=5, batch_size=4, num_workers=num_workers, yx_patch_size=(24, 24),
                                 normalizations=[norm], augmentations=[crop], seed=3, scratch_dir=scratch, **kw)


def _same(got, want, path="batch"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert [tuple(i) for i in got] == [tuple(i) for i in want], path


@pytest.mark.parametrize("num_workers", [0, 2])
def test_host_batches_equal_jax(plate, tmp_path, num_workers):
    jdm = _dm("jax", plate, tmp_path / "jax", num_workers, include_fov_names=INCLUDE)
    tdm = _dm("torch", plate, tmp_path / "port", num_workers, include_fov_names=INCLUDE)
    for dm in (jdm, tdm):
        dm.prepare_data()
        dm.setup("fit")
    assert len(tdm.train_dataset) == len(jdm.train_dataset) == 2 * 2 * 3
    for epoch in (0, 1):
        jdm.set_epoch(epoch)
        tdm.set_epoch(epoch)
        want, got = list(jdm.train_dataloader()), list(tdm.train_dataloader())
        assert len(got) == len(want) == 6 and got[0]["source"].shape == (4, 1, 5, 24, 24)
        for g, w in zip(got, want):
            _same(g, w)
    want, got = list(jdm.val_dataloader()), list(tdm.val_dataloader())
    assert len(got) == len(want) == 3  # 1 FOV x 2 timepoints x 3 windows, 2 windows a batch
    for g, w in zip(got, want):
        _same(g, w)


def test_exclude_fov_names_is_refused(plate, tmp_path):
    with pytest.raises(ValueError, match="exclude_fov_names.*another FOV's volume"):
        _dm("torch", plate, tmp_path, 0, exclude_fov_names=["A/1/1"])


def test_fov_selection_equals_jax(plate):
    tplate, jplate = open_ome_zarr(plate), j_open(plate)
    for include, exclude, n in [(None, None, 4), (INCLUDE, None, 3), (None, ["A/2/0"], 3), (INCLUDE, ["A/1/0"], 2)]:
        got = ["/".join(p.path.parts[-3:]) for p in tselect.filter_fovs(tplate, include, exclude)]
        want = ["/".join(p.path.parts[-3:]) for p in jselect.filter_fovs(jplate, include, exclude)]
        assert got == want and len(got) == n

    class T(tselect.SelectWell):
        _include_wells = ["A/2"]
        _exclude_fovs = ["A/2/1"]

    class J(jselect.SelectWell):
        _include_wells = ["A/2"]
        _exclude_fovs = ["A/2/1"]

    assert len(T()._filter_fit_fovs(tplate)) == len(J()._filter_fit_fovs(jplate)) == 1
    T._include_wells = J._include_wells = ["B/9"]
    for cls, p in ((T, tplate), (J, jplate)):
        with pytest.raises(ValueError, match="No FOVs left"):
            cls()._filter_fit_fovs(p)
