"""``viscy-torch precompute`` against viscy_tpu's ``precompute_normalized``.

Both read one plate the port wrote (two FOVs, two timepoints, per-FOV
statistics that differ by FOV and channel, one channel without any) and
write a new store; the port's, written through the CLI, equals JAX's bit
for bit, FOV by FOV, and carries the same identity normalization metadata.
Writing over an existing store raises, as on the JAX side."""

import numpy as np
import pytest
import yaml

from viscy_tpu.preprocess.precompute import precompute_normalized as j_precompute
from viscy_tpu.zarr_io.store import open_ome_zarr as j_open
from viscy_tpu_torch.preprocess.precompute import precompute_normalized
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

CHANNELS = ["Phase3D", "Nucleus", "Membrane"]


def test_precompute_equals_jax_bit_for_bit(tmp_path):
    plate = build_hcs_plate(tmp_path / "plate.zarr", CHANNELS, zyx_shape=(3, 20, 24), num_timepoints=2,
                            rows=("A",), cols=("1",), fovs=("0", "1"), seed=9, max_value=7.0)
    for i, (_, pos) in enumerate(open_ome_zarr(plate, mode="r+").positions()):
        pos.zattrs["normalization"] = {
            ch: {"fov_statistics": {"mean": 3.3 * (i + 1) + 0.7 * c, "std": 1.9 + 0.13 * i + 0.01 * c}}
            for c, ch in enumerate(CHANNELS[:2])  # Membrane has no statistics: (x - 0) / (1 + 1e-8)
        }
    channels = ["Membrane", "Phase3D", "Nucleus"]
    want_path = j_precompute(plate, tmp_path / "jax.zarr", channels)
    cfg = {"precompute": {"data_path": str(plate), "output_path": str(tmp_path / "port.zarr"),
                          "channel_names": channels}}
    (tmp_path / "pc.yml").write_text(yaml.safe_dump(cfg))
    assert cli.main(["precompute", "-c", str(tmp_path / "pc.yml")]) is None
    want, got = j_open(want_path), open_ome_zarr(tmp_path / "port.zarr")
    assert got.channel_names == want.channel_names == channels
    names = [n for n, _ in want.positions()]
    assert [n for n, _ in got.positions()] == names == ["A/1/0", "A/1/1"]
    for name in names:
        w, g = np.asarray(want[name]["0"][:]), got[name]["0"][:]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (2, 3, 3, 20, 24)
        assert np.array_equal(g, w), name
        assert dict(got[name].zattrs["normalization"]) == dict(want[name].zattrs["normalization"])
    raw = open_ome_zarr(plate)["A/1/1"]["0"][1, 0]  # Phase3D, the output's channel 1
    stats = open_ome_zarr(plate)["A/1/1"].zattrs["normalization"]["Phase3D"]["fov_statistics"]
    expect = (raw.astype(np.float32) - stats["mean"]) / (stats["std"] + 1e-8)
    assert np.array_equal(got["A/1/1"]["0"][1, 1], expect)
    with pytest.raises(FileExistsError):
        precompute_normalized(plate, tmp_path / "port.zarr", channels)
