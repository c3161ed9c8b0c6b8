"""The port's triplet dataset and datamodule against viscy_tpu.data.triplet.

A small seeded plate (5 FOVs of (3, 3, 8, 96, 96), zarr v2 uncompressed,
per-FOV normalization statistics) and one tracking CSV per FOV, with float
``y`` / ``x`` (truncated by ``astype(int)``) and track ids 2, 10, 11 and
100, so the string order of ``global_track_id`` differs from the numeric
one. Both packages read the same files. Tolerances: track tables,
windows, norm meta and the predict index bit-identical; the device
transform, with the JAX draws handed to the port, within 1e-6 of the range
(1e-5 with the bench affine's warp).
"""

import csv

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from viscy_tpu import transforms as J
from viscy_tpu.data import triplet as jtrip
from viscy_tpu.data.utils import scatter_channels
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.data import _tracks
from viscy_tpu_torch.data import triplet as ttrip
from viscy_tpu_torch.evaluation.anndata_lite import Frame
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_helpers import rel_err
from _torch_port_draws import run_jax_compose

CHANNELS = ["Phase3D", "GFP", "RFP"]
SOURCE = ["RFP", "Phase3D"]  # not the plate's order
TRACK_IDS = (2, 10, 11, 100)


def _write_tracks(path, rng, n_t=3, duplicate_t=False):
    rows = []
    for tid in TRACK_IDS:
        y, x = rng.uniform(10, 86, 2)
        for t in range(n_t):
            rows.append([tid, t, tid * 10 + t, -1, -1, 4, f"{y + rng.uniform(-3, 3):.3f}",
                         f"{x + rng.uniform(-3, 3):.3f}"])
    if duplicate_t:
        rows.append([TRACK_IDS[0], 1, 999, -1, -1, 4, "40.0", "40.0"])
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["track_id", "t", "id", "parent_track_id", "parent_id", "z", "y", "x"])
        w.writerows(rows)


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    root = tmp_path_factory.mktemp("triplet")
    path = build_hcs_plate(root / "plate.zarr", CHANNELS, zyx_shape=(8, 96, 96), num_timepoints=3,
                           rows=("A",), cols=("1",), fovs=("0", "1", "2", "3", "4"), seed=3)
    rng = np.random.default_rng(5)
    store = open_ome_zarr(path, mode="r+")
    for name, pos in store.positions():
        pos.zattrs["normalization"] = {
            ch: {"fov_statistics": {"mean": float(rng.uniform(0.3, 0.6)), "std": float(rng.uniform(0.2, 0.4))},
                 "timepoint_statistics": {"0": {"mean": 0.5, "std": 0.3}}}
            for ch in CHANNELS
        }
        _write_tracks(root / "tracks" / name / "tracks.csv", rng)
    return path, root / "tracks"


def _kwargs(plate, **kw):
    path, tracks = plate
    out = dict(data_path=str(path), tracks_path=str(tracks), source_channel=SOURCE, z_range=(2, 7),
               initial_yx_patch_size=(32, 32), final_yx_patch_size=(24, 24), batch_size=4, split_ratio=0.6,
               seed=7)
    out.update(kw)
    return out


def _pair(plate, j_augs=(), t_augs=(), **kw):
    norm = lambda ns: [ns.NormalizeSampled(keys=SOURCE, level="fov_statistics")]
    jdm = jtrip.TripletDataModule(normalizations=norm(J), augmentations=list(j_augs), **_kwargs(plate, **kw))
    tdm = ttrip.TripletDataModule(normalizations=norm(T), augmentations=list(t_augs), **_kwargs(plate, **kw))
    return jdm, tdm


def _same_table(got: Frame, want: pd.DataFrame) -> None:
    assert len(got) == len(want)
    for col in want.columns:
        assert got[col].tolist() == want[col].tolist(), col


def _same_batch(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("_norm_meta"):
            for ch in w:
                assert set(got[k][ch]) == set(w[ch]) == {"fov_statistics"}
                for stat, v in w[ch]["fov_statistics"].items():
                    g = got[k][ch]["fov_statistics"][stat]
                    assert g.dtype == v.dtype == np.float32
                    np.testing.assert_array_equal(g, v)
        elif k == "index":
            assert got[k] == w
            assert [list(d) for d in got[k]] == [list(d) for d in w]
        else:
            assert got[k].dtype == w.dtype == np.float32
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_track_csv_reads_as_pandas_astype_int(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text(",track_id,t,y,x\n0,10,0,12.9,-3.7\n1,2,1,7.0,1e2\n2,100,2,-0.5,8\n")
    got = _tracks.read_tracks_csv(p)
    want = pd.read_csv(p).astype(int)
    assert got.names == list(want.columns) == ["Unnamed: 0", "track_id", "t", "y", "x"]
    _same_table(got, want)
    keys = np.asarray(["A/1/0_10", "A/1/0_2", "A/1/0_10", "A/1/0_100", "A/1/0_2"], dtype=object)
    frame = pd.DataFrame({"k": keys, "i": np.arange(5)})
    want_order = pd.concat([g for _, g in frame.groupby("k")])["i"].tolist()
    assert _tracks.group_order(keys).tolist() == want_order == [0, 2, 3, 1, 4]


@pytest.mark.parametrize("interval", ["any", 1])
def test_anchors_and_tracks_match_jax(plate, interval):
    jdm, tdm = _pair(plate, time_interval=interval)
    jdm.setup("fit")
    tdm.setup("fit")
    for split in ("train_dataset", "val_dataset"):
        jd, td = getattr(jdm, split), getattr(tdm, split)
        _same_table(td.tracks, jd.tracks)
        _same_table(td.valid_anchors, jd.valid_anchors)
        assert len(td) == len(jd) > 0
    if interval == 1:  # the group order is not the table's
        assert tdm.train_dataset.valid_anchors["global_track_id"][0].endswith("_10")


@pytest.mark.parametrize("negative", [True, False], ids=["negative", "no_negative"])
@pytest.mark.parametrize("interval", ["any", 1])
def test_windows_and_norm_meta_match_jax_over_two_epochs(plate, negative, interval):
    jdm, tdm = _pair(plate, time_interval=interval, return_negative=negative)
    jdm.setup("fit")
    tdm.setup("fit")
    n = 0
    for epoch in (0, 1):
        jdm.set_epoch(epoch)
        tdm.set_epoch(epoch)
        jl, tl = jdm.train_dataloader(), tdm.train_dataloader()
        assert len(tl) == len(jl) >= 2
        for jb, tb in zip(jl, tl, strict=True):
            _same_batch(tb, jb)
            n += 1
    assert n >= 4
    for jb, tb in zip(jdm.val_dataloader(), tdm.val_dataloader(), strict=True):
        _same_batch(tb, jb)


def test_predict_index_and_windows_match_jax(plate):
    jdm, tdm = _pair(plate, initial_yx_patch_size=(24, 24), batch_size=16)
    jdm.setup("predict")
    tdm.setup("predict")
    jbatches, tbatches = list(jdm.predict_dataloader()), list(tdm.predict_dataloader())
    # the JAX loader drops the last len % batch_size cells; the port embeds every cell
    n = len(tdm.predict_dataset)
    assert n % 16 and sum(len(b["index"]) for b in jbatches) == n - n % 16
    assert len(tbatches) == len(tdm.predict_dataloader()) == len(jbatches) + 1 >= 3
    assert sum(len(b["index"]) for b in tbatches) == n and len(tbatches[-1]["index"]) == n % 16
    for jb, tb in zip(jbatches, tbatches):
        assert set(tb) == {"anchor", "anchor_norm_meta", "index"}
        _same_batch(tb, jb)
    tail = jdm.predict_dataset.__getitems__(list(range(n - n % 16, n)))
    _same_batch(tbatches[-1], tail)
    batches = list(zip(jbatches, tbatches))
    assert list(batches[0][1]["index"][0]) == ["fov_name", "track_id", "t", "id", "parent_track_id", "parent_id",
                                               "z", "y", "x"]
    # predict_cells selects (fov_name, track_id) pairs in the order given
    kw = dict(predict_cells=True, include_fov_names=["A/1/3", "A/1/0"], include_track_ids=[100, 2])
    jdm, tdm = _pair(plate, **kw)
    jdm.setup("predict")
    tdm.setup("predict")
    _same_table(tdm.predict_dataset.valid_anchors, jdm.predict_dataset.valid_anchors)
    assert len(tdm.predict_dataset) > 0


def _view_draws(jdm, batch, key, stage):
    """The JAX device transform's output per view and the port draws of each
    view's members, read off the keys it splits."""
    use_aug = stage == "train" or (stage == "val" and jdm.augment_validation)
    compose = jdm._with_final_crop(jdm._aug_compose if use_aug else jdm._norm_compose)
    keys = jax.random.split(key, 3)
    outs, draws = {}, {}
    for i, view in enumerate(ttrip.VIEWS):
        if view in batch:
            sample = scatter_channels(SOURCE, jax.numpy.asarray(batch[view]), batch[f"{view}_norm_meta"])
            out, draws[view] = run_jax_compose(compose, sample, keys[i])
            outs[view] = np.concatenate([np.asarray(out[c]) for c in SOURCE], axis=1)
    return outs, draws


def _device_batch(batch):
    to = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    return {k: ({c: {lv: {s: to(a) for s, a in st.items()} for lv, st in m.items()} for c, m in v.items()}
                if k.endswith("_norm_meta") else to(v)) for k, v in batch.items()}


@pytest.mark.parametrize("affine", [False, True], ids=["shipped", "bench_affine"])
def test_device_transform_with_jax_draws_matches_jax(plate, affine):
    """The shipped config's flip and contrast (within 1e-6 of the range), and
    the same with the bench recipe's affine first (its warp runs as the
    card's kernel's plain version here): within 1e-5 of the range, the
    warp's bound in test_torch_port_flip_crop.py (the two grids sum their
    products in different orders)."""

    def augs(ns):
        out = [ns.BatchedRandFlipd(keys=SOURCE, prob=0.5),
               ns.BatchedRandAdjustContrastd(keys=["Phase3D"], gamma=(0.8, 1.2), prob=0.5)]
        if affine:
            out.insert(0, ns.BatchedRandAffined(keys=SOURCE, prob=0.8, rotate_range=[3.14, 0.0, 0.0],
                                                scale_range=[[0.9, 1.1]] * 3,
                                                shear_range=[0.05, 0.05, 0.0, 0.05, 0.0, 0.05]))
        return out

    jdm, tdm = _pair(plate, j_augs=augs(J), t_augs=augs(T))
    jdm.setup("fit")
    batch = next(iter(jdm.train_dataloader()))
    key = jax.random.PRNGKey(11)
    for stage in ("train", "predict"):
        want, draws = _view_draws(jdm, batch, key, stage)
        jout = jdm.device_transform(batch, key, stage=stage)
        got = tdm.device_transform(_device_batch(batch), None, stage, draws=draws)
        assert set(got) == set(jout) == {"anchor", "positive", "negative"}
        for view, w in want.items():
            np.testing.assert_allclose(np.asarray(jout[view]), w, atol=1e-6, rtol=0)
            assert got[view].shape == w.shape == (4, 2, 5, 24, 24)
            err, _ = rel_err(got[view].numpy(), w)
            assert err <= (1e-5 if affine and stage == "train" else 1e-6), (stage, view, err)
    # the port's own draws: one generator, views in order, reproducible
    a = tdm.device_transform(_device_batch(batch), torch.Generator().manual_seed(3), "train")
    b = tdm.device_transform(_device_batch(batch), torch.Generator().manual_seed(3), "train")
    for view in ttrip.VIEWS:
        torch.testing.assert_close(a[view], b[view], rtol=0, atol=0)
    assert not torch.equal(a["anchor"], a["positive"])  # same windows, own draws


def test_device_aug_chunk_matches_unchunked_normalize(plate):
    _, tdm = _pair(plate, augment_validation=False)
    _, tdm_c = _pair(plate, augment_validation=False, device_aug_chunk=3)  # -> chunks of 2
    tdm.setup("fit")
    batch = _device_batch(next(iter(tdm.train_dataloader())))
    assert tdm_c._chunk(4) == 2
    full = tdm.device_transform(batch, None, "val")
    chunked = tdm_c.device_transform(batch, None, "val")
    for view in ttrip.VIEWS:
        torch.testing.assert_close(chunked[view], full[view], rtol=0, atol=0)
    assert not any(k.endswith("_norm_meta") for k in full)


def test_loader_length_and_short_batch(plate):
    _, tdm = _pair(plate, batch_size=5)
    tdm.setup("fit")
    n = len(tdm.train_dataset)
    loader = tdm.train_dataloader()
    assert len(loader) == n // 5 and sum(1 for _ in loader) == n // 5
    big = ttrip._BatchedTripletLoader(tdm.val_dataset, 10**6, shuffle=True)
    (only,) = list(big)
    assert len(big) == 1 and only["anchor"].shape[0] == len(tdm.val_dataset)


def test_refusals_match_jax(plate, tmp_path):
    path, tracks = plate
    jdm, tdm = _pair(plate, z_range=(2, 9))
    for dm in (jdm, tdm):
        with pytest.raises(ValueError, match="exceeds image with Z=8"):
            dm.setup("fit")
    bad = tmp_path / "bad"
    for name in ("A/1/0", "A/1/1", "A/1/2", "A/1/3", "A/1/4"):
        (bad / name).mkdir(parents=True)
        (bad / name / "t.csv").write_text((tracks / name / "tracks.csv").read_text())
    (bad / "A/1/2/t.csv").write_text("track_id,t,y,x\n1,0,40.5,40\n2,0,,41\n")
    jdm, tdm = _pair(plate, tracks_path=str(bad))
    with pytest.raises(Exception, match="(?i)non-finite|NA"):
        jdm.setup("fit")
    with pytest.raises(ValueError, match="missing value"):
        tdm.setup("fit")
    (bad / "A/1/2/t.csv").unlink()
    for dm in _pair(plate, tracks_path=str(bad)):
        with pytest.raises(FileNotFoundError, match="No tracks CSV for FOV A/1/2"):
            dm.setup("fit")
    # predict_cells without (fov_name, track_id) pairs: JAX selects no cell, the port refuses
    jdm, tdm = _pair(plate, predict_cells=True)
    jdm.setup("predict")
    assert len(jdm.predict_dataset) == 0 and list(jdm.predict_dataloader()) == []
    with pytest.raises(ValueError, match="predict_cells=True.*include_fov_names"):
        tdm.setup("predict")


def test_a_track_with_a_repeated_frame_gives_extra_positives_in_both(tmp_path):
    """A fault of the JAX datamodule, copied: the positive is an inner merge
    on (track, t + interval), so a track with two rows at one frame yields
    two positives for its anchor and a positive batch longer than the
    anchor batch."""
    path = build_hcs_plate(tmp_path / "p.zarr", CHANNELS, zyx_shape=(8, 96, 96), num_timepoints=3,
                           rows=("A",), cols=("1",), fovs=("0", "1"), seed=1)
    for name in ("A/1/0", "A/1/1"):
        _write_tracks(tmp_path / "tracks" / name / "t.csv", np.random.default_rng(2), duplicate_t=True)
    kw = dict(data_path=str(path), tracks_path=str(tmp_path / "tracks"), source_channel=SOURCE, z_range=(2, 7),
              initial_yx_patch_size=(32, 32), batch_size=4, split_ratio=0.5, time_interval=1)
    sizes = []
    for mod in (jtrip, ttrip):
        dm = mod.TripletDataModule(**kw)
        dm.setup("fit")
        ds = dm.train_dataset
        first = [i for i in range(len(ds)) if str(ds.valid_anchors["global_track_id"][i]).endswith("_2")
                 and int(ds.valid_anchors["t"][i]) == 0]
        b = ds.__getitems__(first)
        sizes.append((b["anchor"].shape[0], b["positive"].shape[0]))
    assert sizes[0] == sizes[1] == (1, 2)
