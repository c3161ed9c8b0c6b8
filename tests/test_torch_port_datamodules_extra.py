"""The concatenated and combined, CTMC-v1, cell-division and classification
datamodules, ``ChannelDropout`` and ``parse_channel_name`` in the port
against viscy_tpu.

Plates are written by the port's ``build_hcs_plate`` (uncompressed, which
the JAX reader reads too); the same files go to both packages and every
batch must be bit-identical (``np.array_equal``): loaders run with
``num_workers=0``, so the cell-division negatives are drawn in the same
order. ``ChannelDropout`` is handed the JAX transform's draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from viscy_tpu.data import cell_classification as jcls
from viscy_tpu.data import cell_division_triplet as jdiv
from viscy_tpu.data import channel_dropout as jdrop
from viscy_tpu.data import channel_utils as jch
from viscy_tpu.data import combined as jcomb
from viscy_tpu.data import ctmc_v1 as jctmc
from viscy_tpu.data import hcs as jhcs
from viscy_tpu.data import host_transforms as jhost
from viscy_tpu_torch.data import cell_classification as tcls
from viscy_tpu_torch.data import cell_division_triplet as tdiv
from viscy_tpu_torch.data import channel_dropout as tdrop
from viscy_tpu_torch.data import channel_utils as tch
from viscy_tpu_torch.data import combined as tcomb
from viscy_tpu_torch.data import ctmc_v1 as tctmc
from viscy_tpu_torch.data import hcs as thcs
from viscy_tpu_torch.data import host_transforms as thost
from viscy_tpu_torch.data._tracks import read_csv
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

import _torch_port_helpers  # noqa: F401  (one torch thread per test worker)

CHANNELS = ["Phase3D", "Nucleus", "Membrane"]


def _same(got, want, where="") -> None:
    """Nested batches equal leaf for leaf, dtypes included."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and np.array_equal(g, w), where


def _batches(loader, epoch: int | None = None) -> list:
    if epoch is not None:
        loader.set_epoch(epoch)
    return list(loader)


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    root = tmp_path_factory.mktemp("plates")
    a = build_hcs_plate(root / "a.zarr", CHANNELS, zyx_shape=(6, 24, 24), num_timepoints=1, rows=("A",),
                        cols=("1", "2"), fovs=("0", "1"), seed=1, norm_meta=True)
    b = build_hcs_plate(root / "b.zarr", CHANNELS, zyx_shape=(6, 24, 24), num_timepoints=1, rows=("B",),
                        cols=("1",), fovs=("0", "1", "2"), seed=2, norm_meta=True)
    return a, b


def _hcs(ns, path, batch_size=2, crop: int | None = None):
    augs = []
    if crop:
        host = jhost if ns is jhcs else thost
        augs = [host.HostRandWeightedCropd(keys=CHANNELS, w_key="Nucleus",
                                           spatial_size=[4, 16, 16], num_samples=crop)]
    return ns.HCSDataModule(data_path=path, source_channel=["Phase3D"], target_channel=["Nucleus", "Membrane"],
                            z_window_size=4, batch_size=batch_size, num_workers=0, yx_patch_size=(16, 16),
                            augmentations=augs, seed=3)


def _both(make):
    return make(jhcs, jcomb), make(thcs, tcomb)


@pytest.mark.parametrize("kind", ["Concat", "BatchedConcat", "CachedConcat"])
def test_concat_datamodules_batches_equal_jax(plates, kind):
    """Train batches of two epochs and the validation batches, bit for bit;
    the device transform is the first child's."""
    a, b = plates

    def make(hcs, comb):
        return getattr(comb, f"{kind}DataModule")([_hcs(hcs, a), _hcs(hcs, b)], batch_size=3)

    jdm, tdm = _both(make)
    for dm in (jdm, tdm):
        dm.setup("fit")
    assert len(tdm.train_dataset) == len(jdm.train_dataset)
    for epoch in (0, 1):
        jdm.set_epoch(epoch)
        tdm.set_epoch(epoch)
        _same(list(tdm.train_dataloader()), list(jdm.train_dataloader()), f"train{epoch}")
    _same(list(tdm.val_dataloader()), list(jdm.val_dataloader()), "val")
    batch = {k: torch.from_numpy(v) for k, v in next(iter(tdm.val_dataloader())).items() if k in ("source", "target")}
    got = tdm.device_transform(batch, None, "predict")
    assert all(torch.equal(got[k], v) for k, v in tdm.data_modules[0].device_transform(batch, None,
                                                                                          "predict").items())


def test_concat_refuses_inconsistent_patches_per_stack(plates):
    a, b = plates
    jdm, tdm = _both(lambda hcs, comb: comb.ConcatDataModule([_hcs(hcs, a, crop=2), _hcs(hcs, b)]))
    for dm in (jdm, tdm):
        with pytest.raises(ValueError, match="Inconsistent patches per stack"):
            dm.setup("fit")
    # with two patches a stack in both children, a batch holds batch_size // 2 stacks
    jdm, tdm = _both(lambda hcs, comb: comb.ConcatDataModule([_hcs(hcs, a, crop=2), _hcs(hcs, b, crop=2)],
                                                             batch_size=4))
    for dm in (jdm, tdm):
        dm.setup("fit")
    got, want = list(tdm.train_dataloader()), list(jdm.train_dataloader())
    assert got[0]["source"].shape[0] == 4
    _same(got, want, "train")


@pytest.mark.parametrize("mode", ["min_size", "max_size_cycle", "sequential"])
def test_combined_datamodule_modes_equal_jax(plates, mode):
    """The children's loaders iterated together (train loaders of 1 and 2
    batches), two epochs; validation sequential."""
    a, b = plates
    jdm, tdm = _both(lambda hcs, comb: comb.CombinedDataModule([_hcs(hcs, a, 1), _hcs(hcs, b, 1)], train_mode=mode))
    for dm in (jdm, tdm):
        dm.setup("fit")
    for epoch in (0, 1):
        jdm.set_epoch(epoch)
        tdm.set_epoch(epoch)
        jl, tl = jdm.train_dataloader(), tdm.train_dataloader()
        assert len(tl) == len(jl)
        _same(list(tl), list(jl), f"{mode}{epoch}")
    _same(list(tdm.val_dataloader()), list(jdm.val_dataloader()), "val")
    assert tdm._combined([None, None], "sequential") is None and len(list(tcomb.CombineMode)) == 4


def test_batched_concat_dataset_groups_by_child():
    class _List:
        def __init__(self, values):
            self.values = values

        def __len__(self):
            return len(self.values)

        def __getitem__(self, i):
            return {"x": np.float32(self.values[i])}

    class _Batched(_List):
        def __getitems__(self, idx):
            return {"x": np.asarray([self.values[i] for i in idx], np.float32)}

    jds, tds = (ns.BatchedConcatDataset([_List([0, 1, 2]), _Batched([10, 11])]) for ns in (jcomb, tcomb))
    _same(tds.__getitems__([4, 0, 3, 2, -1]), jds.__getitems__([4, 0, 3, 2, -1]))
    with pytest.raises(NotImplementedError):
        tds[0]


NAMES = ["raw GFP EX488 EM525-45", "Phase3D", "mCherry_EX561_EM600-37.5", "DAPI", "BF", "Retardance",
         "raw tomato EM590", "nothing here", "GFP phase"]


@pytest.mark.parametrize("name", NAMES)
def test_parse_channel_name_matches_jax(name):
    assert dataclasses.asdict(tch.parse_channel_name(name)) == dataclasses.asdict(jch.parse_channel_name(name))


@pytest.mark.parametrize("prob", [0.2, 0.9, 1.0])
def test_channel_dropout_with_jax_draws(prob):
    """Two keys: each its own draws (JAX folds the key with the key's
    position); a random channel per sample survives even at p = 1."""
    x = np.random.default_rng(0).normal(size=(6, 4, 2, 5, 5)).astype(np.float32) + 2
    data = {"anchor": x, "positive": x[::-1].copy()}
    key = jax.random.PRNGKey(int(prob * 10))
    want = jdrop.ChannelDropout(keys=["anchor", "positive"], dropout_prob=prob)(
        {k: jnp.asarray(v) for k, v in data.items()}, key)
    draws = {}
    for i, k in enumerate(("anchor", "positive")):
        kk = jax.random.fold_in(key, i)
        draws[k] = {"drop_uniform": torch.from_numpy(np.array(jax.random.uniform(kk, (6, 4)))),
                    "keep_idx": torch.from_numpy(np.array(jax.random.randint(jax.random.fold_in(kk, 1), (6,), 0,
                                                                               4)))}
    t = tdrop.ChannelDropout(keys=["anchor", "positive"], dropout_prob=prob)
    got = t({k: torch.from_numpy(v) for k, v in data.items()}, draws=draws)
    _same({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()})
    drawn = t({k: torch.from_numpy(v) for k, v in data.items()}, torch.Generator().manual_seed(0))["anchor"]
    assert bool((drawn.reshape(6, 4, -1).abs().sum(-1) > 0).any(dim=1).all())


def test_ctmc_v1_pairs_equal_jax(tmp_path):
    """(t, t + 1) pairs over two plates, with a random host transform seeded
    by (seed, epoch, index)."""
    paths = [build_hcs_plate(tmp_path / f"{n}.zarr", ["DIC"], zyx_shape=(3, 16, 16), num_timepoints=4, rows=("A",),
                             cols=("1",), fovs=fovs, seed=s) for n, fovs, s in (("tr", ("0", "1"), 4),
                                                                                  ("va", ("0",), 5))]

    def make(ns, host):
        norm = [host.HostRandScaleIntensityd(keys=["source", "target"], factors=0.5, prob=0.7)]
        return ns.CTMCv1DataModule(*paths, channel="DIC", batch_size=2, num_workers=0, normalizations=norm, seed=6)

    jdm, tdm = make(jctmc, jhost), make(tctmc, thost)
    for dm in (jdm, tdm):
        dm.setup("fit")
    assert len(tdm.train_dataset) == 6 and len(tdm.val_dataset) == 3
    _same(list(tdm.train_dataloader()), list(jdm.train_dataloader()), "train")
    _same(list(tdm.val_dataloader()), list(jdm.val_dataloader()), "val")
    _same(tdm.train_dataset.get_item_with_epoch(2, 3), jdm.train_dataset.get_item_with_epoch(2, 3), "epoch3")
    with pytest.raises(NotImplementedError):
        tdm.setup("predict")


def test_cell_division_triplets_equal_jax(tmp_path):
    """Fit batches (the negatives' tracks and frames from one seeded
    Generator per dataset, drawn in read order) and predict batches with
    their ``index``."""
    rng = np.random.default_rng(7)
    for i in range(5):
        np.save(tmp_path / f"track_{i}.npy", rng.normal(size=(int(rng.integers(3, 6)), 2, 3, 8, 8)).astype(np.float32))

    def make(ns):
        return ns.CellDivisionTripletDataModule(tmp_path, batch_size=3, num_workers=0, split_ratio=0.6, seed=8)

    jdm, tdm = make(jdiv), make(tdiv)
    for dm in (jdm, tdm):
        dm.setup("fit")
    for epoch in (0, 1):
        _same(_batches(tdm.train_dataloader(), epoch), _batches(jdm.train_dataloader(), epoch), f"train{epoch}")
    _same(list(tdm.val_dataloader()), list(jdm.val_dataloader()), "val")
    for dm in (jdm, tdm):
        dm.setup("predict")
    got, want = list(tdm.predict_dataloader()), list(jdm.predict_dataloader())
    _same(got, want, "predict")
    assert set(got[0]) == {"anchor", "index"} and isinstance(got[0]["index"]["track"][0], str)
    with pytest.raises(FileNotFoundError):
        tdiv.CellDivisionTripletDataModule(tmp_path / "none").setup("fit")


def _annotations(tmp_path, float_yx: bool, with_t: bool) -> tuple:
    path = build_hcs_plate(tmp_path / "cls.zarr", ["Phase", "GFP"], zyx_shape=(6, 48, 48), num_timepoints=2,
                           rows=("A",), cols=("1",), fovs=("0", "1"), seed=9, norm_meta=True)
    rng = np.random.default_rng(10)
    n = 14
    yx = np.concatenate([rng.integers(8, 40, (n - 3, 2)), [[2, 20], [20, 46], [47, 3]]]).astype(np.float64)
    if float_yx:
        yx = yx + rng.uniform(0, 0.9, yx.shape)
    cols = {"fov_name": [f"A/1/{i % 2}" for i in range(n)], "y": yx[:, 0], "x": yx[:, 1],
            "state": rng.integers(0, 3, n)}
    if with_t:
        cols["t"] = rng.integers(0, 2, n)
    ann = tmp_path / "ann.csv"
    pd.DataFrame(cols).to_csv(ann, index=False)
    return path, ann


@pytest.mark.parametrize("float_yx,with_t", [(False, True), (True, False)], ids=["int-yx", "float-yx-no-t"])
def test_classification_batches_equal_jax(tmp_path, float_yx, with_t):
    """Border cells dropped, the centered Z window, the seeded split, int32
    labels, a host transform per channel key; fit, validation and test."""
    path, ann = _annotations(tmp_path, float_yx, with_t)

    def make(ns, host):
        norm = [host.HostRandScaleIntensityd(keys=["Phase", "GFP"], factors=0.3, prob=0.8)]
        return ns.ClassificationDataModule(path, ann, ["Phase", "GFP"], z_window_size=3, yx_patch_size=(16, 16),
                                           label_column="state", batch_size=4, num_workers=0, split_ratio=0.7,
                                           normalizations=norm, seed=11)

    jdm, tdm = make(jcls, jhost), make(tcls, thost)
    for dm in (jdm, tdm):
        dm.setup("fit")
    assert len(tdm.train_dataset) + len(tdm.val_dataset) == 11
    for epoch in (0, 1):
        jdm.set_epoch(epoch)
        tdm.set_epoch(epoch)
        got = list(tdm.train_dataloader())
        _same(got, list(jdm.train_dataloader()), f"train{epoch}")
    assert got[0]["label"].dtype == np.int32 and got[0]["source"].shape == (4, 2, 3, 16, 16)
    _same(list(tdm.val_dataloader()), list(jdm.val_dataloader()), "val")
    for dm in (jdm, tdm):
        dm.setup("test")
    _same(list(tdm.test_dataloader()), list(jdm.test_dataloader()), "test")
    _same(list(tdm.predict_dataloader()), list(jdm.predict_dataloader()), "predict")


def test_classification_reads_csv_as_pandas_and_refuses_parquet(tmp_path):
    path, ann = _annotations(tmp_path, True, False)
    frame, df = read_csv(ann), pd.read_csv(ann)
    assert frame.names == list(df.columns)
    for c in df.columns:
        numeric = pd.api.types.is_numeric_dtype(df[c])
        assert frame[c].dtype == (df[c].dtype if numeric else object), c
        if frame[c].dtype == np.float64:  # pandas' fast parser may round the last bit otherwise
            np.testing.assert_allclose(frame[c], df[c], rtol=4e-16, err_msg=c)
        else:
            assert frame[c].tolist() == df[c].tolist(), c
    (tmp_path / "ann.parquet").write_bytes(b"PAR1")
    dm = tcls.ClassificationDataModule(path, tmp_path / "ann.parquet", ["Phase"], z_window_size=3)
    with pytest.raises(NotImplementedError, match="parquet"):
        dm.setup("fit")
