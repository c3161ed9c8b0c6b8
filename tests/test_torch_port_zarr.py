"""The port's OME-Zarr reader and writer (viscy_tpu_torch.zarr_io) against
tensorstore through viscy_tpu.zarr_io, in both directions: port-written
zarr v2 and v3 stores (sharded and not, every codec the port writes) read
by tensorstore, tensorstore-written ``"none"`` plates read by the port;
blosc stores refused by name; the synthetic plate factories equal for one
seed. Every comparison is bit for bit."""

import json

import numpy as np
import pytest

from viscy_tpu.zarr_io import store as jstore
from viscy_tpu.zarr_io.synthetic import build_hcs_plate as j_build
from viscy_tpu_torch.zarr_io import store as tstore
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate as t_build

SHAPE = (2, 3, 5, 7, 9)
CHUNKS = (1, 1, 2, 4, 4)
CASES = [("0.4", False, c) for c in ("none", "zlib", "gzip", "bz2")] + [
    ("0.5", s, c) for s in (False, True) for c in ("none", "gzip")
]


def _data(seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).random(SHAPE) * 1000).astype(dtype)


def _write_partial(img, data):
    """Whole-chunk, partial-chunk and orthogonal writes; returns what the
    array then holds (unwritten regions at the fill value 0)."""
    img[:, :, :4] = data[:, :, :4]
    img.oindex[1, [2, 0], 4] = data[1, [2, 0], 4]
    want = data.copy()
    want[0, :, 4] = 0
    want[1, 1, 4] = 0
    return want


@pytest.mark.parametrize("version,shard,comp", CASES, ids=[f"v{v}-{'shard' if s else 'flat'}-{c}" for v, s, c in CASES])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_port_written_store_reads_back_through_tensorstore(tmp_path, version, shard, comp, dtype):
    path = tmp_path / "p.zarr"
    plate = tstore.open_ome_zarr(path, layout="hcs", mode="w", channel_names=["a", "b", "c"], version=version)
    img = plate.create_position("A", "1", "0").create_zeros("0", SHAPE, dtype, chunks=CHUNKS, shard=shard,
                                                            compressor=comp)
    want = _write_partial(img, _data(dtype=dtype))
    assert np.array_equal(img[:], want)
    jplate = jstore.open_ome_zarr(path, mode="r")
    jpos = jplate["A/1/0"]
    assert jpos.channel_names == ["a", "b", "c"] and jplate.channel_names == ["a", "b", "c"]
    jimg = jpos["0"]
    assert jimg.dtype == np.dtype(dtype) and jimg.shape == SHAPE
    assert np.array_equal(jimg[:], want)
    assert np.array_equal(jimg.oindex[1, [2, 1], 3:5], want[1][[2, 1]][:, 3:5])
    assert [n for n, _ in jplate.positions()] == ["A/1/0"]
    assert jpos.metadata["multiscales"] == tstore.open_ome_zarr(path)["A/1/0"].metadata["multiscales"]
    img.resize((3, *SHAPE[1:]))  # growth is metadata only: the new frame reads as fill
    grown = jstore.open_ome_zarr(path, mode="r")["A/1/0"]["0"]
    assert grown.shape == (3, *SHAPE[1:]) and not grown[2].any()


@pytest.mark.parametrize("version,shard", [("0.4", False), ("0.5", False), ("0.5", True)])
def test_tensorstore_written_store_reads_in_the_port(tmp_path, version, shard):
    """Tensorstore's own chunk keys (v2 ``.``; v3 ``c/...``), its shard
    index at the end with the crc32c, inner chunks it never wrote, and
    missing chunks as fill."""
    path = tmp_path / "j.zarr"
    plate = jstore.open_ome_zarr(path, layout="hcs", mode="w", channel_names=["a", "b", "c"], version=version)
    pos = plate.create_position("B", "2", "1")
    img = pos.create_zeros("0", SHAPE, np.float32, chunks=CHUNKS, shard=shard, compressor="none")
    want = _write_partial(img, _data(1))
    pos.zattrs["normalization"] = {"a": {"fov_statistics": {"mean": 0.5}}}
    tpos = tstore.open_ome_zarr(path)["B/2/1"]
    timg = tpos["0"]
    assert timg.shape == SHAPE and timg.dtype == np.float32
    assert np.array_equal(timg[:], want)
    assert np.array_equal(timg.oindex[:, [2, 0], 1:4, 2:7, ::2], want[:, [2, 0]][:, :, 1:4, 2:7, ::2])
    assert np.array_equal(timg[1, 2, -1], want[1, 2, -1])
    assert tpos.zattrs["normalization"]["a"]["fov_statistics"]["mean"] == 0.5
    if shard:
        files = [p for p in (path / "B/2/1/0").rglob("*") if p.is_file() and p.name != "zarr.json"]
        assert files and all(p.relative_to(path / "B/2/1/0").parts[0] == "c" for p in files)


def test_shard_index_crc_is_checked(tmp_path):
    path = tmp_path / "j.zarr"
    plate = jstore.open_ome_zarr(path, layout="hcs", mode="w", channel_names=["a"], version="0.5")
    img = plate.create_position("A", "1", "0").create_zeros("0", (1, 1, 2, 4, 4), np.float32, chunks=(1, 1, 1, 4, 4),
                                                            shard=True, compressor="none")
    img[:] = np.ones((1, 1, 2, 4, 4), np.float32)
    (shard,) = [p for p in (path / "A/1/0/0").rglob("*") if p.is_file() and p.name != "zarr.json"]
    raw = bytearray(shard.read_bytes())
    raw[-5] ^= 0xFF  # one byte of the index
    shard.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        tstore.open_ome_zarr(path)["A/1/0"]["0"][:]
    assert tstore.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


@pytest.mark.parametrize("version,codec", [("0.4", "zstd"), ("0.4", "lz4"), ("0.5", "zstd")])
def test_blosc_stores_raise_a_named_error(tmp_path, version, codec):
    path = tmp_path / "z.zarr"
    plate = jstore.open_ome_zarr(path, layout="hcs", mode="w", channel_names=["a"], version=version)
    plate.create_position("A", "1", "0").create_zeros("0", (1, 1, 1, 4, 4), np.float32, compressor=codec)[:] = np.ones((1, 1, 1, 4, 4), np.float32)
    with pytest.raises(tstore.UnsupportedCodecError, match=f"blosc-{codec}.*rewrite"):
        tstore.open_ome_zarr(path)["A/1/0"]["0"]


@pytest.mark.parametrize("name", ["zstd", "lz4"])
def test_jax_compressor_presets_are_refused_with_the_list(tmp_path, name):
    plate = tstore.open_ome_zarr(tmp_path / "p.zarr", layout="hcs", mode="w", channel_names=["a"])
    pos = plate.create_position("A", "1", "0")
    with pytest.raises(ValueError, match="available: \\['bz2', 'gzip', 'none', 'zlib'\\]"):
        pos.create_zeros("0", (1, 1, 1, 4, 4), np.float32, compressor=name)


def test_v2_slash_separator_and_edge_chunks(tmp_path):
    """A zarr v2 array with ``dimension_separator: "/"`` written by the port's
    chunk code reads in tensorstore; edge chunks are stored at full size."""
    path = tmp_path / "s.zarr"
    plate = tstore.open_ome_zarr(path, layout="hcs", mode="w", channel_names=["a"])
    img = plate.create_position("A", "1", "0").create_zeros("0", (1, 1, 3, 5, 6), np.float32, chunks=(1, 1, 2, 4, 4))
    meta_path = path / "A/1/0/0/.zarray"
    meta = json.loads(meta_path.read_text())
    meta["dimension_separator"] = "/"
    meta_path.write_text(json.dumps(meta))
    data = _data(2)[:1, :1, :3, :5, :6]
    tstore.open_ome_zarr(path, mode="r+")["A/1/0"]["0"][:] = data
    assert (path / "A/1/0/0/0/0/1/1/1").stat().st_size == 2 * 4 * 4 * 4
    assert np.array_equal(jstore.open_ome_zarr(path)["A/1/0"]["0"][:], data)
    assert img.shape == (1, 1, 3, 5, 6)


@pytest.mark.parametrize("sharded", [False, True])
def test_synthetic_plates_equal_for_one_seed(tmp_path, sharded):
    kw = dict(zyx_shape=(4, 8, 8), num_timepoints=1, rows=("A",), cols=("1", "2"), fovs=("0", "1"), seed=7,
              sharded=sharded, norm_meta=True)
    j_build(tmp_path / "j.zarr", **kw)
    t_build(tmp_path / "t.zarr", **kw)
    jplate, tplate = jstore.open_ome_zarr(tmp_path / "j.zarr"), tstore.open_ome_zarr(tmp_path / "t.zarr")
    jpos, tpos = list(jplate.positions()), list(tplate.positions())
    assert [n for n, _ in jpos] == [n for n, _ in tpos] == ["A/1/0", "A/1/1", "A/2/0", "A/2/1"]
    for (_, jp), (_, tp) in zip(jpos, tpos):
        assert np.array_equal(jp["0"][:], tp["0"][:])
        assert jp.zattrs["normalization"] == tp.zattrs["normalization"]
        assert jp.channel_names == tp.channel_names
    assert jplate.zattrs["plate"] == tplate.zattrs["plate"]


def test_round_trip_of_a_plate_is_bit_exact(tmp_path):
    """Write, read back with the port, rewrite into a second store through
    the port, and read that with tensorstore: the same bits throughout."""
    data = _data(3)
    a = tstore.open_ome_zarr(tmp_path / "a.zarr", layout="hcs", mode="w", channel_names=["x", "y", "z"])
    a.create_position("A", "1", "0").create_image("0", data, chunks=(1, 1, 1, 7, 9))
    read = tstore.open_ome_zarr(tmp_path / "a.zarr")["A/1/0"]["0"][:]
    b = tstore.open_ome_zarr(tmp_path / "b.zarr", layout="hcs", mode="w", channel_names=["x", "y", "z"],
                             version="0.5")
    b.create_position("A", "1", "0").create_zeros("0", read.shape, read.dtype, chunks=(1, 1, 2, 4, 4), shard=True,
                                                  compressor="gzip")[:] = read
    assert np.array_equal(read, data)
    assert np.array_equal(jstore.open_ome_zarr(tmp_path / "b.zarr")["A/1/0"]["0"][:], data)
