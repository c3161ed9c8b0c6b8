"""The port's HCS data path (HCSDataModule, SlidingWindowDataset, the
threaded DataLoader, HostRandWeightedCropd) against viscy_tpu's on one
synthetic plate written by the port and read by both packages.

Host batches are compared bit for bit: train (weighted crop, widened Z
window, shuffled), val and predict, with 0 and 2 loader threads, over two
epochs, and the RAM-preloaded pushdown crop. A plate without the target
channels is predicted from its source channels alone (the JAX datamodule
raises there). The device transform: its on-device NormalizeSampled bit
for bit; with the flip and the affine (the JAX draws handed in) to 1e-5 of
the range, the repo's bound for the warp against JAX's
(test_torch_port_flip_crop.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.data import hcs as jhcs
from viscy_tpu.data.host_transforms import HostRandWeightedCropd as JCrop
from viscy_tpu.transforms import BatchedRandAffined as JAffine
from viscy_tpu.transforms import BatchedRandFlipd as JFlip
from viscy_tpu.transforms.normalize import NormalizeSampled as JNormalize
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.data import hcs as thcs
from viscy_tpu_torch.data.host_transforms import HostRandWeightedCropd as TCrop
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_draws import run_jax_compose

CHANNELS = ["Phase3D", "Nucleus", "Membrane"]
KEYS = CHANNELS + ["weight"]


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    path = tmp_path_factory.mktemp("hcs") / "plate.zarr"
    build_hcs_plate(path, CHANNELS, zyx_shape=(8, 40, 40), num_timepoints=2, rows=("A",), cols=("1", "2"),
                    fovs=("0", "1"), seed=3)
    # per-FOV statistics that differ between FOVs and channels
    for i, (_, pos) in enumerate(open_ome_zarr(path, mode="r+").positions()):
        pos.zattrs["normalization"] = {
            ch: {"fov_statistics": {"mean": 0.1 * i + 0.05 * c, "std": 0.2 + 0.01 * i}}
            for c, ch in enumerate(CHANNELS)
        }
    return path


def _dm(pkg, path, num_workers=0, caching=False, flip_affine=True, fg_mask_key=None):
    keys = KEYS + (["fg_mask_Nucleus", "fg_mask_Membrane"] if fg_mask_key else [])
    crop = (JCrop if pkg == "jax" else TCrop)(keys=keys, w_key="weight", spatial_size=[5, 24, 24], num_samples=2)
    aug = [crop]
    if flip_affine:
        flip, affine = (JFlip, JAffine) if pkg == "jax" else (T.BatchedRandFlipd, T.BatchedRandAffined)
        aug += [
            flip(keys=["source", "target"], prob=0.5),
            affine(keys=["source", "target"], prob=0.5, rotate_range=[3.14, 0.0, 0.0],
                   scale_range=[[1.0, 1.3], [0.75, 1.3], [0.75, 1.3]]),
        ]
    norm = (JNormalize if pkg == "jax" else T.NormalizeSampled)(keys=CHANNELS, level="fov_statistics")
    mod = jhcs if pkg == "jax" else thcs
    return mod.HCSDataModule(path, source_channel="Phase3D", target_channel=["Nucleus", "Membrane"],
                             z_window_size=5, batch_size=4, num_workers=num_workers, yx_patch_size=(24, 24),
                             normalizations=[norm], augmentations=aug, caching=caching, seed=11,
                             fg_mask_key=fg_mask_key)


def _assert_same(got, want, path="batch"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert [tuple(x) for x in got] == [tuple(x) for x in want], path


def _batches(dm, stage, epoch=0):
    if stage == "train":
        dm.set_epoch(epoch)
        return list(dm.train_dataloader())
    return list(dm.val_dataloader() if stage == "val" else dm.predict_dataloader())


@pytest.mark.parametrize("num_workers", [0, 2])
def test_train_and_val_batches_equal_jax_over_two_epochs(plate, num_workers):
    jdm, tdm = _dm("jax", plate, num_workers), _dm("torch", plate, num_workers)
    jdm.setup("fit")
    tdm.setup("fit")
    assert tdm.train_dataset.z_window_size == jdm.train_dataset.z_window_size == 6  # widened for the Z scale
    assert len(tdm.train_dataset) == len(jdm.train_dataset) == 3 * 2 * 3
    epochs = []
    for epoch in (0, 1):
        want, got = _batches(jdm, "train", epoch), _batches(tdm, "train", epoch)
        assert len(got) == len(want) == 9 and got[0]["source"].shape == (4, 1, 5, 24, 24)
        for g, w in zip(got, want):
            _assert_same(g, w)
        epochs.append(got[0]["source"])
    assert not np.array_equal(*epochs)  # the epoch reseeds shuffle and crops
    want, got = _batches(jdm, "val"), _batches(tdm, "val")
    assert len(got) == len(want) == 1 * 2 * 4 // 2
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_predict_batches_equal_jax(plate):
    jdm, tdm = _dm("jax", plate, 2), _dm("torch", plate, 2)
    jdm.setup("predict")
    tdm.setup("predict")
    want, got = _batches(jdm, "predict"), _batches(tdm, "predict")
    assert len(got) == len(want) == 4 * 2 * 4 // 4
    for g, w in zip(got, want):
        _assert_same(g, w)
        assert g["source"].shape == (4, 1, 5, 40, 40)


def test_predict_reads_the_source_alone_from_a_plate_without_targets(plate, tmp_path):
    source_only = build_hcs_plate(tmp_path / "phase.zarr", ["Phase3D"], zyx_shape=(8, 40, 40), num_timepoints=2,
                                  rows=("A",), cols=("1", "2"), fovs=("0", "1"), seed=3, norm_meta=True)
    tdm = _dm("torch", source_only, 2)
    tdm.normalizations = [T.NormalizeSampled(keys=["Phase3D"], level="fov_statistics")]
    tdm.setup("predict")
    got = _batches(tdm, "predict")
    jdm = _dm("jax", plate, 2)
    jdm.setup("predict")
    want = _batches(jdm, "predict")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == ["index", "norm_meta", "source"]
        assert [tuple(x) for x in g["index"]] == [tuple(x) for x in w["index"]]
        for src, (img, t, z) in zip(g["source"], g["index"]):
            raw = open_ome_zarr(source_only)[img.strip("/").rsplit("/", 1)[0]]["0"][t, :1, z : z + 5]
            mean, std = np.float32(0.5), np.float32(1 / np.sqrt(12))
            np.testing.assert_array_equal(src, (raw - mean) / (std + np.float32(1e-8)))
        assert g["source"].shape == (4, 1, 5, 40, 40)


def test_preloaded_pushdown_crop_equals_jax(plate):
    jdm, tdm = _dm("jax", plate, caching=True, flip_affine=False), _dm("torch", plate, caching=True, flip_affine=False)
    jdm.setup("fit")
    tdm.setup("fit")
    assert tdm.train_dataset.pushdown_crop is not None
    for g, w in zip(_batches(tdm, "train", 1), _batches(jdm, "train", 1)):
        _assert_same(g, w)


def test_device_transform_with_jax_draws_matches_jax(plate):
    """NormalizeSampled on the device with per-sample statistics, then the
    flip and the affine with the JAX draws, then the shape check. (The
    affine's trilinear sums round differently in the two packages: 7.4e-6
    absolute on this batch, whose range is about 5.)"""
    jdm, tdm = _dm("jax", plate), _dm("torch", plate)
    jdm.setup("fit")
    tdm.setup("fit")
    batch = next(iter(tdm.train_dataloader()))
    jbatch = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in batch.items() if k != "index"})
    key = jax.random.PRNGKey(5)
    want = jdm.device_transform(jbatch, key, "train")
    _, draws = run_jax_compose(jdm._device_compose, jdm._apply_device_normalizations(jbatch), key)
    tbatch = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), jbatch)
    normalized = tdm._apply_device_normalizations(tbatch)
    jnormalized = jdm._apply_device_normalizations(jbatch)
    got = tdm.device_transform(tbatch, draws=draws, stage="train")
    for k in ("source", "target"):
        np.testing.assert_array_equal(normalized[k].numpy(), np.asarray(jnormalized[k]))
        w = np.asarray(want[k])
        assert got[k].shape == w.shape
        assert np.abs(got[k].numpy() - w).max() <= 1e-5 * float(w.max() - w.min()), k
    with pytest.raises(ValueError, match="does not match expected"):
        tdm.device_transform({k: torch.zeros(1, n, 5, 20, 20) for k, n in (("source", 1), ("target", 2))},
                             torch.Generator(), "train")


def test_fg_mask_route_equals_jax(plate, tmp_path):
    """``fg_mask_key``: the masks of the target channels ride with the
    weighted crop (their ``fg_mask_<channel>`` keys listed in its keys) and
    stack into ``fg_mask``, as in JAX; the spatial device transforms take
    the mask key (the intensity ones do not)."""
    import shutil

    from viscy_tpu_torch.preprocess.stats import generate_fg_masks, generate_normalization_metadata

    masked = tmp_path / "masked.zarr"
    shutil.copytree(plate, masked)
    generate_normalization_metadata(masked, num_workers=1, grid_spacing=4, compute_otsu=True)
    generate_fg_masks(masked, ["Nucleus", "Membrane"])
    jdm, tdm = _dm("jax", masked, fg_mask_key="fg_mask"), _dm("torch", masked, fg_mask_key="fg_mask")
    for dm in (jdm, tdm):
        dm.setup("fit")
    got, want = _batches(tdm, "train", 1), _batches(jdm, "train", 1)
    assert got[0]["fg_mask"].shape == (4, 2, 5, 24, 24)
    for g, w in zip(got, want):
        _assert_same(g, w)
    patched = thcs.HCSDataModule(masked, "Phase3D", ["Nucleus", "Membrane"], 5, fg_mask_key="fg_mask",
                                 augmentations=[T.BatchedRandFlipd(keys=["source", "target"]),
                                                T.BatchedRandGaussianNoised(keys=["source"])])
    flip, noise = patched._device_augmentations
    assert flip.keys == ("source", "target", "fg_mask") and flip.allow_missing_keys
    assert noise.keys == ("source",)
