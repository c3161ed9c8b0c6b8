"""The port's HCSPredictionWriter against a numpy assembly with viscy_tpu's
``blend_in``, and the trainer's prefetching batch iterator against the
plain loop.

Seeded per-window predictions of two FOVs x two timepoints, Z windows of 5
over a 9-slice stack (five overlapping windows each), go through the
writer's device blend (tensors, ``DeviceFovAssembler``) and its host blend
(numpy windows, the assembly buffers); the store, read back with the
port's reader and with tensorstore, equals the numpy assembly bit for bit.
"""

import numpy as np
import pytest
import torch

from viscy_tpu.training.callbacks.prediction_writer import blend_in as j_blend_in
from viscy_tpu.zarr_io import store as jstore
from viscy_tpu_torch.data.typing import HCSStackIndex
from viscy_tpu_torch.training.callbacks.prediction_writer import HCSPredictionWriter
from viscy_tpu_torch.training.trainer import BatchPrefetcher
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

FOVS = ["A/1/0", "B/2/1"]
Z, WIN, YX = 9, 5, (6, 7)


class _DM:
    source_channel = ["Phase3D"]
    target_channel = ["Nucleus", "Membrane"]
    z_window_size = WIN


class _Trainer:
    _active_datamodule = _DM()


def _windows(seed=0):
    """(index, prediction) of every window, in the loader's order."""
    rng = np.random.default_rng(seed)
    return [
        (HCSStackIndex(f"/{fov}/0", t, z), rng.normal(0.0, 1.0, (2, WIN, *YX)).astype(np.float32))
        for fov in FOVS
        for t in range(2)
        for z in range(Z - WIN + 1)
    ]


def _numpy_assembly(windows):
    out = {}
    for (img, t, z), pred in windows:
        fov = "/".join(img.strip("/").split("/")[:3])
        buf = out.setdefault((fov, t), np.zeros((2, Z, *YX), np.float32))
        zs = slice(z, z + WIN)
        buf[:, zs] = j_blend_in(buf[:, zs], pred, zs)
    return out


@pytest.mark.parametrize("device_blend", [True, False], ids=["device-blend", "host-blend"])
@pytest.mark.parametrize("batch", [1, 3])
def test_written_store_equals_the_numpy_assembly(tmp_path, device_blend, batch):
    windows = _windows()
    writer = HCSPredictionWriter(tmp_path / "pred.zarr", device_blend=device_blend)
    writer.on_predict_start(_Trainer(), None)
    for i in range(0, len(windows), batch):
        chunk = windows[i : i + batch]
        preds = np.stack([p for _, p in chunk])
        writer.write_on_batch_end(_Trainer(), None, torch.from_numpy(preds) if device_blend else preds,
                                  {"index": [idx for idx, _ in chunk]}, i)
    writer.on_predict_end(_Trainer(), None)
    want = _numpy_assembly(windows)
    for reader in (open_ome_zarr, jstore.open_ome_zarr):
        plate = reader(tmp_path / "pred.zarr")
        assert plate.channel_names == ["Nucleus", "Membrane"]
        assert [n for n, _ in plate.positions()] == FOVS
        for fov in FOVS:
            img = plate[fov]["0"]
            assert img.shape == (2, 2, Z, *YX) and img.dtype == np.float32
            for t in range(2):
                np.testing.assert_array_equal(img[t], want[(fov, t)])



def test_positions_keep_the_arrival_order_when_flushes_finish_out_of_order(tmp_path, monkeypatch):
    """The device blend writes each finished FOV on a pool of flush threads;
    a slow first FOV must not let a later one become the store's first
    position."""
    import time

    windows = _windows(2)
    writer = HCSPredictionWriter(tmp_path / "pred.zarr", flush_workers=4)
    write = writer._write_device_slab

    def slow_first_fov(key, slab, ranges):
        if key[0].strip("/").startswith(FOVS[0]):
            time.sleep(0.5)
        write(key, slab, ranges)

    monkeypatch.setattr(writer, "_write_device_slab", slow_first_fov)
    writer.on_predict_start(_Trainer(), None)
    for i, (idx, pred) in enumerate(windows):
        writer.write_on_batch_end(_Trainer(), None, torch.from_numpy(pred[None]), {"index": [idx]}, i)
    writer.on_predict_end(_Trainer(), None)
    plate = open_ome_zarr(tmp_path / "pred.zarr")
    assert [n for n, _ in plate.positions()] == FOVS
    want = _numpy_assembly(windows)
    for fov in FOVS:
        for t in range(2):
            np.testing.assert_array_equal(plate[fov]["0"][t], want[(fov, t)])

def test_uint16_output_records_its_scaling(tmp_path):
    windows = _windows(1)[: Z - WIN + 1]  # one (fov, t)
    writer = HCSPredictionWriter(tmp_path / "pred.zarr", output_dtype="uint16")
    writer.on_predict_start(_Trainer(), None)
    for i, (idx, pred) in enumerate(windows):
        writer.write_on_batch_end(_Trainer(), None, torch.from_numpy(pred[None]), {"index": [idx]}, i)
    writer.on_predict_end(_Trainer(), None)
    pos = open_ome_zarr(tmp_path / "pred.zarr")[FOVS[0]]
    q = pos["0"][0]
    assert q.dtype == np.uint16
    want = _numpy_assembly(windows)[(FOVS[0], 0)]
    for c, label in enumerate(["Nucleus", "Membrane"]):
        s = pos.zattrs["prediction_scaling"][label]["0"]
        back = s["lo"] + q[c].astype(np.float64) / 65535 * (s["hi"] - s["lo"])
        assert np.abs(back - want[c]).max() <= (s["hi"] - s["lo"]) / 65535


def test_existing_store_channel_collision_raises(tmp_path):
    plate = open_ome_zarr(tmp_path / "pred.zarr", layout="hcs", mode="w", channel_names=["Nucleus"])
    plate.create_position("A", "1", "0").create_zeros("0", (1, 1, Z, *YX), np.float32)
    writer = HCSPredictionWriter(tmp_path / "pred.zarr")
    writer.on_predict_start(_Trainer(), None)
    with pytest.raises(FileExistsError, match="Nucleus"):
        idx, pred = _windows()[0]
        writer.write_on_batch_end(_Trainer(), None, torch.from_numpy(pred[None]), {"index": [idx]}, 0)


class _Loader:
    """Host batches of numpy arrays, a nested norm_meta and an index list,
    with a batch of another shape in the middle."""

    def __init__(self, n=5):
        self.n = n

    def __iter__(self):
        rng = np.random.default_rng(0)
        for i in range(self.n):
            b = 3 if i == 2 else 2
            yield {
                "source": rng.random((b, 1, 4, 8, 8), np.float32),
                "fg_mask": rng.random((b, 2, 4, 8, 8)) > 0.5,
                "norm_meta": {"Phase3D": {"fov_statistics": {"mean": rng.random(b, np.float32)}}},
                "index": [HCSStackIndex("/A/1/0/0", 0, j) for j in range(b)],
            }


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got == want


@pytest.mark.parametrize("limit", [None, 3])
def test_prefetcher_yields_the_plain_loop_batches_in_order(limit):
    plain = list(_Loader())[:limit]
    feed = BatchPrefetcher(_Loader(), torch.device("cpu"), limit=limit)
    got = list(feed)
    assert len(got) == len(plain) == feed.batches and feed.wait_s >= 0.0
    for g, w in zip(got, plain):
        _same(g, w)


def test_prefetcher_stops_early_and_raises_loader_errors():
    feed = BatchPrefetcher(_Loader(50), torch.device("cpu"))
    for i, _ in enumerate(feed):
        if i == 1:
            break
    assert feed.batches == 2

    def broken():
        yield {"x": np.zeros(1)}
        raise RuntimeError("zarr chunk missing")

    with pytest.raises(RuntimeError, match="zarr chunk missing"):
        list(BatchPrefetcher(broken(), torch.device("cpu")))
