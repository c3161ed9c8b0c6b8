"""The port's ``viscy preprocess`` (generate_normalization_metadata,
otsu_threshold, generate_fg_masks) against viscy_tpu's on copies of one
synthetic plate: every statistic in the plate's and the FOVs' zattrs to
1e-6 relative, the Otsu thresholds too, the foreground masks bit for bit."""

import shutil

import numpy as np
import pytest

from viscy_tpu.preprocess import stats as jstats
from viscy_tpu.zarr_io import store as jstore
from viscy_tpu_torch.preprocess import stats as tstats
from viscy_tpu_torch.zarr_io import store as tstore
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate


def _assert_close(got, want, path="normalization"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=path)


@pytest.mark.parametrize("sharded", [False, True])
def test_normalization_metadata_and_masks_equal_jax(tmp_path, sharded):
    src = build_hcs_plate(tmp_path / "src.zarr", ["Phase3D", "Nucleus"], zyx_shape=(4, 64, 64), num_timepoints=2,
                          rows=("A",), cols=("1", "2"), fovs=("0",), seed=9, sharded=sharded)
    shutil.copytree(src, tmp_path / "jax.zarr")
    shutil.copytree(src, tmp_path / "port.zarr")
    kw = dict(num_workers=2, grid_spacing=8, compute_otsu=True, otsu_grid_spacing=4)
    jstats.generate_normalization_metadata(tmp_path / "jax.zarr", **kw)
    tstats.generate_normalization_metadata(tmp_path / "port.zarr", **kw)
    jstats.generate_fg_masks(tmp_path / "jax.zarr", ["Nucleus"])
    tstats.generate_fg_masks(tmp_path / "port.zarr", ["Nucleus"])
    jplate, tplate = jstore.open_ome_zarr(tmp_path / "jax.zarr"), tstore.open_ome_zarr(tmp_path / "port.zarr")
    _assert_close(tplate.zattrs["normalization"], jplate.zattrs["normalization"])
    for (name, jp), (_, tp) in zip(jplate.positions(), tplate.positions()):
        _assert_close(tp.zattrs["normalization"], jp.zattrs["normalization"], name)
        assert "otsu_threshold" in tp.zattrs["normalization"]["Nucleus"]["fov_statistics"]
        mask = tp["fg_mask"][:]
        assert mask.dtype == np.uint8 and mask[:, 0].all()  # a channel without a threshold is all foreground
        np.testing.assert_array_equal(mask, jp["fg_mask"][:])
    with pytest.raises(FileExistsError):
        tstats.generate_fg_masks(tmp_path / "port.zarr", ["Nucleus"])


def test_otsu_threshold_equals_jax():
    rng = np.random.default_rng(4)
    values = np.concatenate([rng.normal(0.2, 0.05, 3000), rng.normal(0.7, 0.1, 1000)])
    assert tstats.otsu_threshold(values) == jstats.otsu_threshold(values)
    assert tstats.otsu_threshold(np.full(10, 0.3)) == 0.3
