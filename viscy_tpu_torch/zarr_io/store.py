"""OME-Zarr (NGFF v0.4 / v0.5) HCS plate IO in numpy (counterpart of
``viscy_tpu/zarr_io/store.py``).

The JAX package reads and writes through tensorstore; the port reads and
writes the same stores with plain JSON metadata and chunk files decoded
here, with nothing beyond the standard library and numpy:

- zarr v2 (``.zarray``, ``dimension_separator`` ``.`` or ``/``) and zarr
  v3 (``zarr.json``, ``default`` or ``v2`` chunk keys), v3 sharded
  (``sharding_indexed`` with its index at either end, the index checked by
  its crc32c);
- missing chunks (and empty inner chunks of a shard) read as
  ``fill_value``; edge chunks are stored at full chunk size;
- codecs: uncompressed, ``zlib``, ``gzip`` and ``bz2`` (v2), ``gzip``
  (v3). A blosc, zstd or lz4 array raises :class:`UnsupportedCodecError`
  naming the codec.

``create_zeros`` writes uncompressed unless asked: uniform-noise float32
chunks (what the synthetic plates hold) shrink by about 10 % under zlib
level 1 and write several times slower (``tools/zarr_codec_rates.py``
measures every preset).
"""

from __future__ import annotations

import bz2
import contextlib
import gzip
import json
import math
import os
import shutil
import struct
import threading
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from itertools import product
from pathlib import Path
from typing import Iterator, Literal, Sequence

import numpy as np

__all__ = [
    "COMPRESSORS",
    "ImageArray",
    "Plate",
    "Position",
    "TransformationMeta",
    "UnsupportedCodecError",
    "crc32c",
    "open_ome_zarr",
]

_AXES_5D = [
    {"name": "T", "type": "time"},
    {"name": "C", "type": "channel"},
    {"name": "Z", "type": "space", "unit": "micrometer"},
    {"name": "Y", "type": "space", "unit": "micrometer"},
    {"name": "X", "type": "space", "unit": "micrometer"},
]

# writer presets: name -> (v2 compressor, v3 bytes->bytes codec); None where
# that zarr version has no such codec
COMPRESSORS: dict[str, tuple[dict | None, dict | None]] = {
    "none": (None, None),
    "zlib": ({"id": "zlib", "level": 1}, None),
    "gzip": ({"id": "gzip", "level": 1}, {"name": "gzip", "configuration": {"level": 1}}),
    "bz2": ({"id": "bz2", "level": 1}, None),
}
DEFAULT_COMPRESSOR = "none"
_REWRITE_HINT = (
    "rewrite the plate uncompressed or with zlib/gzip/bz2, e.g. "
    "viscy_tpu.zarr_io.store.Position.create_zeros(..., compressor='none') "
    "where tensorstore is installed"
)


class UnsupportedCodecError(ValueError):
    """A store uses a codec this reader cannot decode (blosc, zstd, lz4...)."""


# -- crc32c (Castagnoli), table-driven --------------------------------------------


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data`` (the zarr v3 ``crc32c`` codec's checksum)."""
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- JSON metadata ---------------------------------------------------------------


@dataclass
class TransformationMeta:
    """Coordinate transformation metadata (OME-NGFF ``coordinateTransformations``)."""

    type: str = "scale"
    scale: Sequence[float] = field(default_factory=lambda: [1.0] * 5)

    def to_dict(self) -> dict:
        if self.type == "identity":
            return {"type": "identity"}
        return {"type": self.type, self.type: list(self.scale)}


def _read_json(path: Path) -> dict:
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Cannot serialize {type(o)}")


def _write_json(path: Path, data: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{uuid.uuid4().hex}")
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, default=_json_default)
    os.replace(tmp, path)


def _detect_version(group_path: Path) -> Literal["0.4", "0.5"]:
    """zarr v2 (``.zgroup``) -> NGFF 0.4, v3 (``zarr.json``) -> NGFF 0.5."""
    return "0.5" if (group_path / "zarr.json").exists() else "0.4"


class _Attrs:
    """Mutable dict-like view of a group's user attributes, persisted on write."""

    def __init__(self, group_path: Path, version: str) -> None:
        self._path = group_path
        self._version = version

    def _file(self) -> Path:
        return self._path / ("zarr.json" if self._version == "0.5" else ".zattrs")

    def asdict(self) -> dict:
        raw = _read_json(self._file())
        return raw.get("attributes", {}) if self._version == "0.5" else raw

    def __getitem__(self, key: str):
        return self.asdict()[key]

    def get(self, key: str, default=None):
        return self.asdict().get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self.asdict()

    def __iter__(self):
        return iter(self.asdict())

    def keys(self):
        return self.asdict().keys()

    def items(self):
        return self.asdict().items()

    def __setitem__(self, key: str, value) -> None:
        d = self.asdict()
        d[key] = value
        self._replace(d)

    def update(self, other: dict) -> None:
        d = self.asdict()
        d.update(other)
        self._replace(d)

    def _replace(self, d: dict) -> None:
        if self._version == "0.5":
            raw = _read_json(self._file())
            raw.setdefault("zarr_format", 3)
            raw.setdefault("node_type", "group")
            raw["attributes"] = d
            _write_json(self._file(), raw)
        else:
            _write_json(self._file(), d)


def _make_group(path: Path, version: str) -> None:
    path.mkdir(parents=True, exist_ok=True)
    if version == "0.5":
        f = path / "zarr.json"
        if not f.exists():
            _write_json(f, {"zarr_format": 3, "node_type": "group", "attributes": {}})
    else:
        f = path / ".zgroup"
        if not f.exists():
            _write_json(f, {"zarr_format": 2})


def _default_chunks(shape: Sequence[int]) -> list[int]:
    """One ZYX slab per (t, c), Z halved until a chunk is at most 64 MiB."""
    shape = list(shape)
    chunks = [1] * (len(shape) - 3) + list(shape[-3:])
    while np.prod(chunks[-3:]) * 4 > 64 * 2**20 and chunks[-3] > 1:
        chunks[-3] = max(1, chunks[-3] // 2)
    return chunks


# -- codecs ----------------------------------------------------------------------


def _unsupported(name: str, where: Path):
    return UnsupportedCodecError(
        f"{where}: codec {name!r} cannot be decoded here (available: raw, zlib, "
        f"gzip, bz2); {_REWRITE_HINT}"
    )


def _v2_codec(comp: dict | None, where: Path):
    """(decode, encode) byte functions of a zarr v2 ``compressor``."""
    if comp is None:
        return (lambda b: b), (lambda b: b)
    cid = comp.get("id")
    level = int(comp.get("level", 1))
    if cid == "zlib":
        return zlib.decompress, (lambda b: zlib.compress(b, level))
    if cid == "gzip":
        return gzip.decompress, (lambda b: gzip.compress(b, level, mtime=0))
    if cid == "bz2":
        return bz2.decompress, (lambda b: bz2.compress(b, max(1, level)))
    name = f"blosc-{comp.get('cname')}" if cid == "blosc" else cid
    raise _unsupported(name, where)


def _v3_bytes_codecs(codecs: list[dict], where: Path):
    """Split a v3 codec chain (after its array->bytes codec) into
    (endian, decode, encode, crc) where crc says a trailing crc32c is
    present."""
    endian = "little"
    decs, encs = [], []
    crc = False
    for c in codecs:
        name = c["name"]
        conf = c.get("configuration", {}) or {}
        if name == "bytes":
            endian = conf.get("endian", "little")
        elif name == "gzip":
            level = int(conf.get("level", 1))
            decs.append(gzip.decompress)
            encs.append(lambda b, level=level: gzip.compress(b, level, mtime=0))
        elif name == "crc32c":
            crc = True
        elif name == "blosc":
            raise _unsupported(f"blosc-{conf.get('cname')}", where)
        else:
            raise _unsupported(name, where)

    def decode(b: bytes) -> bytes:
        for d in reversed(decs):
            b = d(b)
        return b

    def encode(b: bytes) -> bytes:
        for e in encs:
            b = e(b)
        return b

    return endian, decode, encode, crc


def _fill_value(raw, dtype: np.dtype):
    if raw is None:
        return dtype.type(0)
    if isinstance(raw, str):
        if raw.startswith("0x"):
            return np.frombuffer(int(raw, 16).to_bytes(dtype.itemsize, "big"), dtype.newbyteorder(">"))[0]
        return dtype.type({"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[raw])
    return dtype.type(raw)


def _fill_json(value, dtype: np.dtype):
    if dtype.kind == "f":
        if np.isnan(value):
            return "NaN"
        if np.isinf(value):
            return "Infinity" if value > 0 else "-Infinity"
        return float(value)
    if dtype.kind == "b":
        return bool(value)
    return int(value)


_EMPTY = 2**64 - 1


class _ZArray:
    """One zarr array on disk: its metadata and chunk (shard) codecs."""

    def __init__(self, array_dir: Path, version: str) -> None:
        self.dir = Path(array_dir)
        self.version = version
        self._lock = threading.Lock()
        where = self.dir
        if self.version == "0.5":
            meta = _read_json(self.dir / "zarr.json")
            if meta.get("node_type") != "array":
                raise FileNotFoundError(f"no zarr v3 array at {self.dir}")
            self.meta = meta
            self.shape = tuple(meta["shape"])
            grid = meta["chunk_grid"]
            if grid["name"] != "regular":
                raise UnsupportedCodecError(f"{where}: chunk grid {grid['name']!r} is not supported")
            self.file_chunks = tuple(grid["configuration"]["chunk_shape"])
            enc = meta.get("chunk_key_encoding", {"name": "default"})
            sep = (enc.get("configuration") or {}).get(
                "separator", "/" if enc["name"] == "default" else "."
            )
            self._key_prefix = "c" + sep if enc["name"] == "default" else ""
            self._sep = sep
            codecs = list(meta["codecs"])
            if any(c["name"] == "transpose" for c in codecs):
                raise _unsupported("transpose", where)
            self.sharded = codecs[0]["name"] == "sharding_indexed"
            dtype = np.dtype(meta["data_type"])
            if self.sharded:
                conf = codecs[0]["configuration"]
                self.chunks = tuple(conf["chunk_shape"])
                inner = _v3_bytes_codecs(conf["codecs"], where)
                idx = _v3_bytes_codecs(conf.get("index_codecs", []), where)
                self._index_crc = idx[3]
                self._index_at_end = conf.get("index_location", "end") == "end"
                endian, self._decode, self._encode, _ = inner
                if any(s % c for s, c in zip(self.file_chunks, self.chunks)):
                    raise ValueError(f"{where}: shard shape {self.file_chunks} not a multiple of {self.chunks}")
            else:
                self.chunks = self.file_chunks
                endian, self._decode, self._encode, _ = _v3_bytes_codecs(codecs, where)
            self.dtype = dtype.newbyteorder("<" if endian == "little" else ">")
            self.fill = _fill_value(meta.get("fill_value"), dtype)
            self.order = "C"
        else:
            meta = _read_json(self.dir / ".zarray")
            if not meta:
                raise FileNotFoundError(f"no zarr v2 array at {self.dir}")
            self.meta = meta
            self.shape = tuple(meta["shape"])
            self.chunks = self.file_chunks = tuple(meta["chunks"])
            if meta.get("filters"):
                raise _unsupported(meta["filters"][0].get("id", "filter"), where)
            self.dtype = np.dtype(meta["dtype"])
            self.fill = _fill_value(meta.get("fill_value"), self.dtype)
            self.order = meta.get("order", "C")
            self._sep = meta.get("dimension_separator", ".")
            self._key_prefix = ""
            self.sharded = False
            self._decode, self._encode = _v2_codec(meta.get("compressor"), where)

    # -- chunk files ----------------------------------------------------------
    def _key(self, cidx: Sequence[int]) -> Path:
        if not cidx:
            return self.dir / (self._key_prefix + "0" if self.version == "0.4" else "c")
        return self.dir / (self._key_prefix + self._sep.join(str(int(i)) for i in cidx))

    def _decode_chunk(self, raw: bytes) -> np.ndarray:
        data = np.frombuffer(self._decode(raw), self.dtype)
        return data.reshape(self.chunks, order=self.order)

    def _encode_chunk(self, chunk: np.ndarray) -> bytes:
        chunk = np.asarray(chunk, self.dtype)
        return self._encode(chunk.tobytes(order=self.order))

    @property
    def _per_shard(self) -> tuple[int, ...]:
        """Inner chunks along each dimension of a shard."""
        return tuple(s // c for s, c in zip(self.file_chunks, self.chunks))

    def _read_shard_index(self, fd: int, size: int, n: int, path: Path) -> np.ndarray:
        nbytes = 16 * n + (4 if self._index_crc else 0)
        raw = os.pread(fd, nbytes, size - nbytes if self._index_at_end else 0)
        if len(raw) != nbytes:
            raise ValueError(f"{path}: shard index truncated")
        if self._index_crc:
            body, tail = raw[:-4], raw[-4:]
            if crc32c(body) != struct.unpack("<I", tail)[0]:
                raise ValueError(f"{path}: shard index crc32c mismatch")
            raw = body
        return np.frombuffer(raw, "<u8").reshape(n, 2)

    def read_chunks(self, cidxs: list[tuple[int, ...]]) -> dict[tuple, np.ndarray | None]:
        """Decoded inner chunks (None where absent, i.e. fill)."""
        if not self.sharded:
            out = {}
            for c in cidxs:
                try:
                    with open(self._key(c), "rb") as f:
                        out[c] = self._decode_chunk(f.read())
                except FileNotFoundError:
                    out[c] = None
            return out
        by_shard: dict[tuple, list[tuple]] = {}
        ratio = per = self._per_shard
        for c in cidxs:
            by_shard.setdefault(tuple(i // r for i, r in zip(c, ratio)), []).append(c)
        out = {}
        for sidx, members in by_shard.items():
            path = self._key(sidx)
            try:
                fd = os.open(path, os.O_RDONLY)
            except FileNotFoundError:
                out.update({c: None for c in members})
                continue
            try:
                index = self._read_shard_index(fd, os.fstat(fd).st_size, math.prod(per), path)
                for c in members:
                    local = tuple(i - s * r for i, s, r in zip(c, sidx, ratio))
                    off, nb = index[np.ravel_multi_index(local, per)]
                    if off == _EMPTY and nb == _EMPTY:
                        out[c] = None
                    else:
                        out[c] = self._decode_chunk(os.pread(fd, int(nb), int(off)))
            finally:
                os.close(fd)
        return out

    def _write_file(self, path: Path, payload: bytes) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{uuid.uuid4().hex}")
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)

    def write_chunks(self, chunks: dict[tuple, np.ndarray]) -> None:
        """Encode and store whole inner chunks (read-modify-write of the
        shard for a sharded array)."""
        if not self.sharded:
            for c, data in chunks.items():
                self._write_file(self._key(c), self._encode_chunk(data))
            return
        ratio = per = self._per_shard
        n = math.prod(per)
        by_shard: dict[tuple, dict] = {}
        for c, data in chunks.items():
            by_shard.setdefault(tuple(i // r for i, r in zip(c, ratio)), {})[c] = data
        for sidx, members in by_shard.items():
            every = [tuple(s * r + i for s, r, i in zip(sidx, ratio, loc)) for loc in np.ndindex(*per)]
            missing = [c for c in every if c not in members]
            old = self.read_chunks(missing) if missing else {}
            blobs, index = [], np.full((n, 2), _EMPTY, np.uint64)
            offset = 16 * n + (4 if self._index_crc else 0) if not self._index_at_end else 0
            for k, c in enumerate(every):
                data = members.get(c, old.get(c))
                if data is None:
                    continue
                blob = self._encode_chunk(data)
                index[k] = (offset, len(blob))
                blobs.append(blob)
                offset += len(blob)
            if not blobs:
                self._key(sidx).unlink(missing_ok=True)
                continue
            raw_index = index.astype("<u8").tobytes()
            if self._index_crc:
                raw_index += struct.pack("<I", crc32c(raw_index))
            body = b"".join(blobs)
            payload = body + raw_index if self._index_at_end else raw_index + body
            self._write_file(self._key(sidx), payload)

    def set_shape(self, shape: Sequence[int]) -> None:
        self.meta["shape"] = [int(s) for s in shape]
        _write_json(self.dir / ("zarr.json" if self.version == "0.5" else ".zarray"), self.meta)
        self.shape = tuple(int(s) for s in shape)


# -- indexing ----------------------------------------------------------------------


def _normalize_key(key, shape: tuple[int, ...], orthogonal: bool):
    """Per-dimension index arrays and the dimensions an integer drops."""
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        i = next(j for j, k in enumerate(key) if k is Ellipsis)
        fill = len(shape) - (len(key) - 1)
        key = key[:i] + (slice(None),) * fill + key[i + 1 :]
    if len(key) > len(shape):
        raise IndexError(f"too many indices ({len(key)}) for shape {shape}")
    key = key + (slice(None),) * (len(shape) - len(key))
    arrays, dropped, n_lists = [], [], 0
    for d, (k, n) in enumerate(zip(key, shape)):
        if isinstance(k, slice):
            arrays.append(np.arange(*k.indices(n)))
        elif isinstance(k, (int, np.integer)):
            i = int(k) + (n if k < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {k} out of range for axis {d} of size {n}")
            arrays.append(np.array([i]))
            dropped.append(d)
        else:
            idx = np.asarray(k, dtype=np.int64).reshape(-1)
            idx = np.where(idx < 0, idx + n, idx)
            if ((idx < 0) | (idx >= n)).any():
                raise IndexError(f"index {k} out of range for axis {d} of size {n}")
            arrays.append(idx)
            n_lists += 1
    if n_lists > 1 and not orthogonal:
        raise IndexError("more than one index list: use .oindex for orthogonal indexing")
    return arrays, tuple(dropped)


def _chunk_groups(idx: np.ndarray, chunk: int):
    """(chunk id, positions in the selection, offsets inside the chunk)."""
    cid = idx // chunk
    out = []
    for c in np.unique(cid):
        pos = np.nonzero(cid == c)[0]
        local = idx[pos] - c * chunk
        # contiguous runs become slices: no fancy-index copy
        if pos[-1] - pos[0] + 1 == pos.size and local[-1] - local[0] + 1 == local.size and (np.diff(local) == 1).all():
            out.append((int(c), slice(int(pos[0]), int(pos[-1]) + 1), slice(int(local[0]), int(local[-1]) + 1)))
        else:
            out.append((int(c), pos, local))
    return out


def _block(parts: Sequence) -> tuple:
    """An index tuple from per-dim slices or index arrays (``np.ix_`` for
    the arrays, which need the outer product)."""
    if all(isinstance(p, slice) for p in parts):
        return tuple(parts)
    lists = [np.arange(p.start, p.stop) if isinstance(p, slice) else p for p in parts]
    return np.ix_(*lists)


_POOL = ThreadPoolExecutor(max_workers=max(4, min(16, os.cpu_count() or 4)), thread_name_prefix="zarr-io")


class ImageArray:
    """A (T, C, Z, Y, X) image array: numpy reads and writes of a zarr array,
    ``oindex`` for orthogonal selections, ``resize`` to grow it."""

    def __init__(self, array: _ZArray, path: str) -> None:
        self._z = array
        self.path = path

    @property
    def shape(self) -> tuple[int, ...]:
        return self._z.shape

    @property
    def dtype(self) -> np.dtype:
        return self._z.dtype.newbyteorder("=")

    @property
    def chunks(self) -> tuple[int, ...]:
        return self._z.chunks

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def frames(self) -> int:
        return self.shape[0]

    @property
    def channels(self) -> int:
        return self.shape[1]

    @property
    def slices(self) -> int:
        return self.shape[2]

    @property
    def height(self) -> int:
        return self.shape[3]

    @property
    def width(self) -> int:
        return self.shape[4]

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self[:]
        return out.astype(dtype) if dtype is not None else out

    def __getitem__(self, key) -> np.ndarray:
        return self._read(key, orthogonal=False)

    def __setitem__(self, key, value) -> None:
        self._write(key, value, orthogonal=False)

    @property
    def oindex(self) -> "_OIndex":
        return _OIndex(self)

    def _plan(self, key, orthogonal):
        arrays, dropped = _normalize_key(key, self.shape, orthogonal)
        groups = [_chunk_groups(a, c) for a, c in zip(arrays, self._z.chunks)]
        return arrays, dropped, groups

    def _read(self, key, orthogonal: bool) -> np.ndarray:
        arrays, dropped, groups = self._plan(key, orthogonal)
        out = np.empty([a.size for a in arrays], self.dtype)
        combos = list(product(*groups))

        def fetch(batch):
            got = self._z.read_chunks([tuple(g[0] for g in combo) for combo in batch])
            for combo in batch:
                chunk = got[tuple(g[0] for g in combo)]
                dst = _block([g[1] for g in combo])
                if chunk is None:
                    out[dst] = self._z.fill
                else:
                    out[dst] = chunk[_block([g[2] for g in combo])]

        if len(combos) <= 2:
            fetch(combos)
        else:
            # one task per group of chunks sharing a shard file keeps each
            # shard index read once; unsharded arrays take one chunk a task
            batches = _batch_by_file(combos, self._z)
            for f in [_POOL.submit(fetch, b) for b in batches]:
                f.result()
        return out.reshape([a.size for d, a in enumerate(arrays) if d not in dropped])

    def _write(self, key, value, orthogonal: bool) -> None:
        arrays, dropped, groups = self._plan(key, orthogonal)
        full = [a.size for a in arrays]
        value = np.asarray(value)
        kept = [n for d, n in enumerate(full) if d not in dropped]
        value = np.broadcast_to(value, kept).reshape(full)
        z = self._z
        combos = list(product(*groups))

        def store(batch):
            todo, need_old = {}, []
            for combo in batch:
                cidx = tuple(g[0] for g in combo)
                covered = all(
                    _covers(g[2], c, n - ci * c)
                    for g, c, n, ci in zip(combo, z.chunks, z.shape, cidx)
                )
                if not covered:
                    need_old.append(cidx)
                todo[cidx] = combo
            old = z.read_chunks(need_old) if need_old else {}
            chunks = {}
            for cidx, combo in todo.items():
                base = old.get(cidx)
                chunk = np.full(z.chunks, z.fill, z.dtype) if base is None else base.copy()
                chunk[_block([g[2] for g in combo])] = value[_block([g[1] for g in combo])]
                chunks[cidx] = chunk
            with z._lock if z.sharded else contextlib.nullcontext():
                z.write_chunks(chunks)

        batches = _batch_by_file(combos, z)
        if len(batches) <= 1:
            for b in batches:
                store(b)
        else:
            for f in [_POOL.submit(store, b) for b in batches]:
                f.result()

    def resize(self, shape: Sequence[int]) -> None:
        """Grow the array (metadata only: new regions read as fill)."""
        if len(shape) != len(self.shape) or any(n < o for n, o in zip(shape, self.shape)):
            raise ValueError(f"resize only grows the array: {self.shape} -> {tuple(shape)}")
        self._z.set_shape(shape)


def _covers(local, chunk: int, in_bounds: int) -> bool:
    """Does a selection of chunk-local offsets cover the chunk's in-bounds part?"""
    n = min(chunk, in_bounds)
    if isinstance(local, slice):
        return local.start == 0 and local.stop >= n
    return np.array_equal(np.unique(local), np.arange(n))


def _batch_by_file(combos: list, z: _ZArray) -> list[list]:
    if not z.sharded:
        return [[c] for c in combos]
    ratio = z._per_shard
    groups: dict[tuple, list] = {}
    for combo in combos:
        sidx = tuple(g[0] // r for g, r in zip(combo, ratio))
        groups.setdefault(sidx, []).append(combo)
    return list(groups.values())


class _OIndex:
    """Orthogonal (outer) indexing: ``arr.oindex[t_slice, [c0, c2], z_slice]``."""

    def __init__(self, arr: ImageArray) -> None:
        self._arr = arr

    def __getitem__(self, key) -> np.ndarray:
        return self._arr._read(key, orthogonal=True)

    def __setitem__(self, key, value) -> None:
        self._arr._write(key, value, orthogonal=True)


def _create_array(
    array_dir: Path,
    shape: Sequence[int],
    dtype,
    chunks: Sequence[int] | None,
    version: str,
    shard: bool = False,
    compressor: str = DEFAULT_COMPRESSOR,
) -> _ZArray:
    dtype = np.dtype(dtype)
    chunks = [int(c) for c in chunks] if chunks is not None else _default_chunks(shape)
    if compressor not in COMPRESSORS:
        raise ValueError(
            f"Unknown compressor {compressor!r}; available: {sorted(COMPRESSORS)} "
            "(blosc presets such as 'zstd' and 'lz4' are not available in this package)"
        )
    comp_v2, comp_v3 = COMPRESSORS[compressor]
    if array_dir.exists():
        shutil.rmtree(array_dir)
    array_dir.mkdir(parents=True)
    fill = _fill_json(dtype.type(0), dtype)
    if version == "0.5":
        if compressor != "none" and comp_v3 is None:
            raise ValueError(f"compressor {compressor!r} has no zarr v3 codec; use 'none' or 'gzip'")
        bytes_codec = {"name": "bytes", "configuration": {"endian": "little"}}
        codecs: list = [bytes_codec] + ([comp_v3] if comp_v3 else [])
        grid = chunks
        if shard:
            codecs = [{
                "name": "sharding_indexed",
                "configuration": {
                    "chunk_shape": chunks,
                    "codecs": codecs,
                    "index_codecs": [bytes_codec, {"name": "crc32c"}],
                    "index_location": "end",
                },
            }]
            grid = [c * 2 if c < s else s for c, s in zip(chunks, shape)]
            grid = [g if g % c == 0 else c * math.ceil(g / c) for g, c in zip(grid, chunks)]
        meta = {
            "zarr_format": 3,
            "node_type": "array",
            "shape": [int(s) for s in shape],
            "data_type": dtype.name,
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": grid}},
            "chunk_key_encoding": {"name": "default", "configuration": {"separator": "/"}},
            "fill_value": fill,
            "codecs": codecs,
            "attributes": {},
        }
        _write_json(array_dir / "zarr.json", meta)
    else:
        meta = {
            "zarr_format": 2,
            "shape": [int(s) for s in shape],
            "chunks": chunks,
            "dtype": dtype.str,
            "compressor": comp_v2,
            "fill_value": fill,
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        }
        _write_json(array_dir / ".zarray", meta)
    return _ZArray(array_dir, version)


class Position:
    """One field of view (NGFF image group) holding multiscale image arrays."""

    def __init__(self, path: Path, version: str, mode: str = "r") -> None:
        self._path = Path(path)
        self._version = version
        self._mode = mode
        self._arrays: dict[str, ImageArray] = {}

    @property
    def zattrs(self) -> _Attrs:
        return _Attrs(self._path, self._version)

    @property
    def metadata(self) -> dict:
        return self.zattrs.asdict()

    @property
    def name(self) -> str:
        return self._path.name

    @property
    def path(self) -> Path:
        return self._path

    @property
    def channel_names(self) -> list[str]:
        omero = self.zattrs.get("omero", {})
        return [c["label"] for c in omero.get("channels", [])]

    def get_channel_index(self, name: str) -> int:
        names = self.channel_names
        try:
            return names.index(name)
        except ValueError:
            raise ValueError(f"Channel {name!r} not found in {names}") from None

    def get_axis_index(self, name: str) -> int:
        ms = self.zattrs.get("multiscales", [{}])[0]
        for i, ax in enumerate(ms.get("axes", _AXES_5D)):
            if ax["name"].lower() == name.lower():
                return i
        raise ValueError(f"Axis {name!r} not found")

    @property
    def scale(self) -> list[float]:
        """The scale of the first (full-resolution) dataset; 1.0 per axis
        without one."""
        ms = self.zattrs.get("multiscales", [{}])[0]
        datasets = ms.get("datasets", [])
        if datasets:
            for tf in datasets[0].get("coordinateTransformations", []):
                if tf.get("type") == "scale":
                    return tf["scale"]
        return [1.0] * 5

    def _meta_name(self) -> str:
        return "zarr.json" if self._version == "0.5" else ".zarray"

    def array_keys(self) -> list[str]:
        ms = self.zattrs.get("multiscales", [{}])[0]
        keys = [d["path"] for d in ms.get("datasets", [])]
        if keys:
            return keys
        meta = self._meta_name()
        return sorted(p.name for p in self._path.iterdir() if (p / meta).exists())

    def __contains__(self, key: str) -> bool:
        return (self._path / str(key) / self._meta_name()).exists()

    def __getitem__(self, key: str) -> ImageArray:
        key = str(key)
        if key not in self._arrays:
            rel = "/".join(self._path.parts[-3:])
            self._arrays[key] = ImageArray(_ZArray(self._path / key, self._version), f"{rel}/{key}")
        return self._arrays[key]

    @property
    def data(self) -> ImageArray:
        return self["0"]

    def create_image(
        self,
        key: str,
        data: np.ndarray,
        chunks: Sequence[int] | None = None,
        transform: list[TransformationMeta] | None = None,
        shard: bool = False,
    ) -> ImageArray:
        arr = self.create_zeros(key, data.shape, data.dtype, chunks=chunks, transform=transform, shard=shard)
        arr[:] = data
        return arr

    def create_zeros(
        self,
        key: str,
        shape: Sequence[int],
        dtype,
        chunks: Sequence[int] | None = None,
        transform: list[TransformationMeta] | None = None,
        shard: bool = False,
        compressor: str = DEFAULT_COMPRESSOR,
    ) -> ImageArray:
        if self._mode == "r":
            raise PermissionError("Position opened read-only")
        key = str(key)
        z = _create_array(self._path / key, shape, dtype, chunks, self._version, shard, compressor)
        self._register_dataset(key, transform)
        rel = "/".join(self._path.parts[-3:])
        img = ImageArray(z, f"{rel}/{key}")
        self._arrays[key] = img
        return img

    def _register_dataset(self, key: str, transform: list[TransformationMeta] | None) -> None:
        attrs = self.zattrs
        d = attrs.asdict()
        ms = d.setdefault(
            "multiscales",
            [{"version": "0.4", "axes": _AXES_5D, "datasets": [], "name": ""}],
        )
        datasets = ms[0].setdefault("datasets", [])
        if not any(ds["path"] == key for ds in datasets):
            tforms = (
                [t.to_dict() for t in transform]
                if transform
                else [{"type": "scale", "scale": [1.0] * 5}]
            )
            datasets.append({"path": key, "coordinateTransformations": tforms})
        attrs._replace(d)

    def append_channel(self, name: str, resize_arrays: bool = True) -> None:
        """Add a channel label (and grow every array along C by one)."""
        attrs = self.zattrs
        d = attrs.asdict()
        d.setdefault("omero", {"channels": []})["channels"].append({"label": name})
        attrs._replace(d)
        if resize_arrays:
            for key in self.array_keys():
                arr = self[key]
                shape = list(arr.shape)
                shape[1] += 1
                arr.resize(shape)

    def set_channel_names(self, names: Sequence[str]) -> None:
        attrs = self.zattrs
        d = attrs.asdict()
        d["omero"] = {"channels": [{"label": n} for n in names]}
        attrs._replace(d)

class Plate:
    """HCS plate (NGFF ``plate`` layout): rows / columns / FOVs of Positions."""

    def __init__(self, path: Path, version: str, mode: str = "r") -> None:
        self._path = Path(path)
        self._version = version
        self._mode = mode
        self._channel_names: list[str] | None = None

    @property
    def zattrs(self) -> _Attrs:
        return _Attrs(self._path, self._version)

    @property
    def path(self) -> Path:
        return self._path

    @property
    def version(self) -> str:
        return self._version

    @property
    def metadata(self) -> dict:
        return self.zattrs.asdict()

    @property
    def channel_names(self) -> list[str]:
        if self._channel_names is None:
            for _, pos in self.positions():
                self._channel_names = pos.channel_names
                break
            else:
                self._channel_names = []
        return self._channel_names

    def get_channel_index(self, name: str) -> int:
        return self.channel_names.index(name)

    def wells(self) -> Iterator[tuple[str, Path]]:
        for well in self.zattrs.get("plate", {}).get("wells", []):
            yield well["path"], self._path / well["path"]

    def positions(self) -> Iterator[tuple[str, Position]]:
        """``(row/col/fov, Position)`` for every FOV of the plate."""
        for well_name, well_path in self.wells():
            images = _Attrs(well_path, self._version).get("well", {}).get("images", [])
            for img in images:
                fov = img["path"]
                yield f"{well_name}/{fov}", Position(well_path / fov, self._version, self._mode)

    def __getitem__(self, key: str) -> Position:
        pos_path = self._path / key
        if not pos_path.exists():
            raise KeyError(key)
        return Position(pos_path, self._version, self._mode)

    def __contains__(self, key: str) -> bool:
        return (self._path / key).exists()

    def create_position(self, row: str, col: str, fov: str) -> Position:
        if self._mode == "r":
            raise PermissionError("Plate opened read-only")
        row, col, fov = str(row), str(col), str(fov)
        _make_group(self._path / row, self._version)
        well_path = self._path / row / col
        _make_group(well_path, self._version)
        pos_path = well_path / fov
        _make_group(pos_path, self._version)
        attrs = self.zattrs
        d = attrs.asdict()
        plate = d.setdefault(
            "plate",
            {"version": "0.4", "wells": [], "rows": [], "columns": [], "acquisitions": [{"id": 0}]},
        )
        wp = f"{row}/{col}"
        if not any(w["path"] == wp for w in plate["wells"]):
            plate["wells"].append(
                {
                    "path": wp,
                    "rowIndex": _index_of(plate, "rows", row),
                    "columnIndex": _index_of(plate, "columns", col),
                }
            )
        attrs._replace(d)
        well_attrs = _Attrs(well_path, self._version)
        wd = well_attrs.asdict()
        well = wd.setdefault("well", {"images": [], "version": "0.4"})
        if not any(i["path"] == fov for i in well["images"]):
            well["images"].append({"path": fov, "acquisition": 0})
        well_attrs._replace(wd)
        pos = Position(pos_path, self._version, self._mode)
        if self._channel_names:
            pos.set_channel_names(self._channel_names)
        return pos

    def set_channel_names(self, names: Sequence[str]) -> None:
        self._channel_names = list(names)


def _index_of(plate: dict, key: str, name: str) -> int:
    entries = plate.setdefault(key, [])
    for i, e in enumerate(entries):
        if e["name"] == name:
            return i
    entries.append({"name": name})
    return len(entries) - 1


def open_ome_zarr(
    store_path: str | Path,
    layout: Literal["hcs", "fov", "auto"] = "auto",
    mode: Literal["r", "r+", "a", "w", "w-"] = "r",
    channel_names: Sequence[str] | None = None,
    version: Literal["0.4", "0.5"] = "0.4",
) -> Plate | Position:
    """Open or create an OME-Zarr store.

    ``layout``: "hcs" (plate), "fov" (one image group) or "auto" (from the
    metadata when reading). ``mode``: "r" read-only, "r+"/"a" read-write
    ("a" creates a missing store), "w" overwrite, "w-" create new.
    ``channel_names`` is required when creating; ``version`` is the NGFF
    version of a new store: "0.4" (zarr v2) or "0.5" (zarr v3).
    """
    store_path = Path(store_path)
    exists = store_path.exists() and any(
        (store_path / f).exists() for f in (".zgroup", ".zattrs", "zarr.json")
    )
    if mode == "w" and store_path.exists():
        shutil.rmtree(store_path)
        exists = False
    if mode == "w-" and exists:
        raise FileExistsError(store_path)
    if mode in ("w", "w-") or (mode == "a" and not exists):
        if channel_names is None:
            raise ValueError("channel_names required when creating a store")
        _make_group(store_path, version)
        if layout in ("hcs", "auto"):
            attrs = _Attrs(store_path, version)
            d = attrs.asdict()
            d["plate"] = {
                "version": "0.4",
                "wells": [],
                "rows": [],
                "columns": [],
                "acquisitions": [{"id": 0}],
            }
            attrs._replace(d)
            plate = Plate(store_path, version, mode="a")
            plate.set_channel_names(channel_names)
            return plate
        pos = Position(store_path, version, mode="a")
        pos.set_channel_names(channel_names)
        return pos
    if not exists:
        raise FileNotFoundError(store_path)
    ver = _detect_version(store_path)
    is_plate = "plate" in _Attrs(store_path, ver)
    if layout == "hcs" and not is_plate:
        raise ValueError(f"{store_path} is not an HCS plate")
    eff_mode = "r" if mode == "r" else "a"
    if is_plate and layout in ("hcs", "auto"):
        plate = Plate(store_path, ver, mode=eff_mode)
        if channel_names:
            plate.set_channel_names(channel_names)
        return plate
    return Position(store_path, ver, mode=eff_mode)
