"""A minimal AnnData container and AnnData-zarr IO in numpy (counterpart of
``viscy_tpu/evaluation/anndata_lite.py``).

The embedding stores of DynaCLR follow the on-disk AnnData zarr v2
element specification, as the JAX module writes it:

- ``encoding-type`` / ``encoding-version`` attributes on every element;
- dataframes (``obs``, ``var``) as groups of column arrays with
  ``_index`` and ``column-order``, string columns as categoricals
  (``codes`` int32 and ``categories``, sorted as pandas sorts them);
- string arrays in the numcodecs ``vlen-utf8`` encoding (a uint32 count,
  then per element a uint32 byte length and the UTF-8 bytes);
- numeric arrays as one uncompressed chunk (``compressor: null``).

The JAX module writes ``X`` and ``obsm`` through tensorstore with its
default compressor (blosc); the port writes them uncompressed, which the
JAX reader reads on its pure-Python path. Reading a blosc-compressed
array raises :class:`~viscy_tpu_torch.zarr_io.store.UnsupportedCodecError`
(the card's machine has no blosc). Dataframes are :class:`Frame`\\ s:
named numpy columns and a string index, no pandas.
"""

from __future__ import annotations

import json
import shutil
import struct
from pathlib import Path
from typing import Any

import numpy as np

from viscy_tpu_torch.zarr_io.store import ImageArray, _unsupported, _ZArray

__all__ = ["AnnDataLite", "Frame", "read_anndata_zarr", "write_anndata_zarr"]

_ARRAY_ATTRS = {"encoding-type": "array", "encoding-version": "0.2.0"}


class Frame:
    """A dataframe without pandas: equal-length numpy columns by name, in
    order, and a string ``index`` (``"0"``, ``"1"``, ... unless given)."""

    def __init__(self, columns: dict[str, Any] | None = None, index=None, n_rows: int | None = None) -> None:
        self.columns = {str(k): np.asarray(v) for k, v in (columns or {}).items()}
        lengths = {len(v) for v in self.columns.values()}
        if index is not None:
            lengths.add(len(index))
        if n_rows is not None:
            lengths.add(n_rows)
        if len(lengths) > 1:
            raise ValueError(f"columns and index of unequal length: {sorted(lengths)}")
        n = lengths.pop() if lengths else 0
        self.index = (np.arange(n) if index is None else np.asarray(index)).astype(str).astype(object)

    @classmethod
    def from_records(cls, records: list[dict]) -> "Frame":
        """Columns from a list of dicts (``pd.DataFrame(records)``): the keys
        in order of first appearance; integers as int64, other numbers as
        float64, booleans as bool, the rest as strings."""
        names: dict[str, None] = {}
        for r in records:
            names.update(dict.fromkeys(r))
        columns = {}
        for name in names:
            if any(name not in r for r in records):
                raise ValueError(f"index records lack the key {name!r} in some rows")
            columns[name] = _infer_column([r[name] for r in records])
        return cls(columns, n_rows=len(records))

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __setitem__(self, name: str, values) -> None:
        values = np.asarray(values)
        if len(values) != len(self):
            raise ValueError(f"column {name!r} has {len(values)} rows for {len(self)}")
        self.columns[name] = values

    @property
    def names(self) -> list[str]:
        return list(self.columns)

    def reset_index(self) -> "Frame":
        """The same columns under the index ``"0"``, ``"1"``, ..."""
        return Frame(self.columns, n_rows=len(self))

    def take(self, rows) -> "Frame":
        """The rows at ``rows`` (indices or a boolean mask), in that order."""
        rows = np.asarray(rows)
        if rows.dtype != bool:
            rows = rows.astype(np.int64)
        return Frame({k: v[rows] for k, v in self.columns.items()}, index=self.index[rows])

    @staticmethod
    def concat(frames: list["Frame"]) -> "Frame":
        """Rows of ``frames`` one after another (``pd.concat``, which raises
        on an empty list, as here)."""
        if not frames:
            raise ValueError("No objects to concatenate")
        names = frames[0].names
        if any(f.names != names for f in frames[1:]):
            raise ValueError(f"frames with different columns: {[f.names for f in frames]}")
        return Frame({k: np.concatenate([f[k] for f in frames]) for k in names},
                     index=np.concatenate([f.index for f in frames]))


def _infer_column(values: list) -> np.ndarray:
    if values and all(isinstance(v, (bool, np.bool_)) for v in values):
        return np.asarray(values, dtype=bool)
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_)) for v in values):
        return np.asarray(values, dtype=np.int64)
    if all(isinstance(v, (int, float, np.integer, np.floating)) for v in values):
        return np.asarray(values, dtype=np.float64)
    return np.asarray([str(v) for v in values], dtype=object)


class AnnDataLite:
    """The slice of ``anndata.AnnData`` the embedding tools use: ``X``,
    ``obs``, ``var``, ``obsm``, ``uns``; the embedding dataset's legacy keys
    (``ds["features"]``, ``ds["index"]``, ``ds["projections"]``,
    ``ds["PCA"]``) and ``obsm`` names index it too."""

    def __init__(
        self,
        X: np.ndarray,
        obs: Frame | None = None,
        var: Frame | None = None,
        obsm: dict[str, np.ndarray] | None = None,
        uns: dict[str, Any] | None = None,
    ) -> None:
        self.X = np.asarray(X)
        n = self.X.shape[0]
        self.obs = obs if obs is not None else Frame(n_rows=n)
        if len(self.obs) != n:
            raise ValueError(f"obs has {len(self.obs)} rows for X with {n}")
        self.var = var if var is not None else Frame(n_rows=self.X.shape[1])
        self.obsm = dict(obsm or {})
        self.uns = dict(uns or {})

    @property
    def n_obs(self) -> int:
        return self.X.shape[0]

    _LEGACY_KEYS = {
        "features": lambda a: a.X,
        "index": lambda a: a.obs,
        "projections": lambda a: a.obsm.get("X_projections"),
        "PCA": lambda a: a.obsm.get("X_pca"),
    }

    def __getitem__(self, key: str):
        if key in self._LEGACY_KEYS:
            value = self._LEGACY_KEYS[key](self)
            if value is not None:
                return value
        if key in self.obsm:
            return self.obsm[key]
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        try:
            self[key]
        except (KeyError, TypeError):
            return False
        return True

    def __iter__(self):
        """The dataset's keys, as the JAX container lists them:
        ``features``, ``index``, ``projections`` and ``PCA`` where present,
        then the other ``obsm`` names."""
        yield "features"
        yield "index"
        if "X_projections" in self.obsm:
            yield "projections"
        if "X_pca" in self.obsm:
            yield "PCA"
        for k in self.obsm:
            if k not in ("X_projections", "X_pca"):
                yield k

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def write_zarr(self, path: str | Path, overwrite: bool = True) -> Path:
        return write_anndata_zarr(path, self, overwrite=overwrite)


# -- zarr v2 primitives ---------------------------------------------------------
def _write_json(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1, sort_keys=True))


def _init_group(path: Path, attrs: dict | None = None) -> None:
    _write_json(path / ".zgroup", {"zarr_format": 2})
    if attrs:
        _write_json(path / ".zattrs", attrs)


def _vlen_utf8_encode(strings: np.ndarray) -> bytes:
    items = [str(s).encode("utf-8") for s in np.asarray(strings, dtype=object).ravel()]
    out = [struct.pack("<I", len(items))]
    for b in items:
        out += [struct.pack("<I", len(b)), b]
    return b"".join(out)


def _vlen_utf8_decode(buf: bytes) -> np.ndarray:
    (count,) = struct.unpack_from("<I", buf, 0)
    off, items = 4, []
    for _ in range(count):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        items.append(buf[off : off + n].decode("utf-8"))
        off += n
    return np.asarray(items, dtype=object)


def _write_array(path: Path, arr, attrs: dict | None = None) -> None:
    """One zarr v2 array in one uncompressed chunk: strings (object or str
    dtype) through the ``vlen-utf8`` codec, everything else as raw
    little-endian bytes."""
    path.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(arr)
    shape = list(arr.shape)
    chunks = [max(1, s) for s in shape] or [1]
    meta = {"zarr_format": 2, "shape": shape, "chunks": chunks, "compressor": None, "order": "C",
            "dimension_separator": "."}
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        meta.update(dtype="|O", filters=[{"id": "vlen-utf8"}], fill_value=0)
        payload = _vlen_utf8_encode(arr)
    else:
        a = np.ascontiguousarray(arr)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        meta.update(dtype=a.dtype.str if a.dtype.kind != "b" else "|b1", filters=None, fill_value=None)
        payload = a.tobytes()
    _write_json(path / ".zarray", meta)
    if attrs:
        _write_json(path / ".zattrs", attrs)
    (path / ".".join(["0"] * max(1, len(shape)))).write_bytes(payload)


def _read_array(path: Path) -> np.ndarray:
    """One zarr v2 array: ``vlen-utf8`` strings (one chunk), or a numeric
    array through the port's zarr reader (raw, zlib, gzip, bz2; blosc
    raises ``UnsupportedCodecError``)."""
    meta = json.loads((path / ".zarray").read_text())
    shape = tuple(meta["shape"])
    filters = meta.get("filters") or []
    if any(f.get("id") == "vlen-utf8" for f in filters):
        key = ".".join(["0"] * max(1, len(shape)))
        return _vlen_utf8_decode((path / key).read_bytes()).reshape(shape)
    if filters:
        raise _unsupported(filters[0].get("id", "filter"), path)
    z = _ZArray(path, "0.4")
    if not shape:
        raw = z._decode((path / "0").read_bytes())
        return np.frombuffer(raw, z.dtype)[:1].reshape(()).copy()
    return ImageArray(z, str(path))[...]


# -- write ---------------------------------------------------------------------
def _write_dataframe(path: Path, frame: Frame) -> None:
    _init_group(path, {"encoding-type": "dataframe", "encoding-version": "0.2.0",
                       "column-order": frame.names, "_index": "_index"})
    _write_array(path / "_index", frame.index, attrs=_ARRAY_ATTRS)
    for name, values in frame.columns.items():
        if values.dtype.kind in "ifub":
            _write_array(path / name, values, attrs=_ARRAY_ATTRS)
            continue
        # strings -> categorical: sorted categories and int32 codes
        categories, codes = np.unique(values.astype(str), return_inverse=True)
        grp = path / name
        _init_group(grp, {"encoding-type": "categorical", "encoding-version": "0.2.0", "ordered": False})
        _write_array(grp / "codes", codes.astype(np.int32), attrs=_ARRAY_ATTRS)
        _write_array(grp / "categories", categories.astype(object), attrs=_ARRAY_ATTRS)


def write_anndata_zarr(path: str | Path, adata: AnnDataLite, overwrite: bool = True) -> Path:
    """Write ``adata`` as an AnnData zarr store at ``path`` (an existing
    store is replaced, or raises without ``overwrite``)."""
    path = Path(path)
    if path.exists():
        if not overwrite:
            raise FileExistsError(f"{path} already exists")
        shutil.rmtree(path)
    _init_group(path, {"encoding-type": "anndata", "encoding-version": "0.1.0"})
    _write_array(path / "X", np.asarray(adata.X, np.float32), attrs=_ARRAY_ATTRS)
    _write_dataframe(path / "obs", adata.obs)
    _write_dataframe(path / "var", adata.var)
    _init_group(path / "obsm", {"encoding-type": "dict", "encoding-version": "0.1.0"})
    for key, arr in adata.obsm.items():
        _write_array(path / "obsm" / key, np.asarray(arr, np.float32), attrs=_ARRAY_ATTRS)
    _init_group(path / "uns", {"encoding-type": "dict", "encoding-version": "0.1.0"})
    for key, value in adata.uns.items():
        if isinstance(value, str):
            _write_array(path / "uns" / key, np.asarray(value, dtype=object).reshape(()),
                         attrs={"encoding-type": "string", "encoding-version": "0.2.0"})
        else:
            _write_array(path / "uns" / key, np.asarray(value), attrs=_ARRAY_ATTRS)
    return path


# -- read ----------------------------------------------------------------------
def _read_dataframe(path: Path) -> Frame:
    attrs = json.loads((path / ".zattrs").read_text()) if (path / ".zattrs").exists() else {}
    index_key = attrs.get("_index", "_index")
    cols = attrs.get("column-order")
    if cols is None:
        cols = sorted(p.name for p in path.iterdir() if p.is_dir() and p.name != index_key)
    index = _read_array(path / index_key) if (path / index_key).exists() else None
    columns = {}
    for col in cols:
        sub = path / col
        if (sub / ".zarray").exists():
            columns[col] = _read_array(sub)
        elif (sub / ".zgroup").exists():
            codes = _read_array(sub / "codes").astype(np.int64)
            categories = np.append(_read_array(sub / "categories").astype(str).astype(object), "nan")
            columns[col] = categories[codes]  # code -1 (missing) reads "nan", as pandas' astype(str)
    return Frame(columns, index=index)


def read_anndata_zarr(path: str | Path) -> AnnDataLite:
    """Read an AnnData zarr store (the port's, the JAX module's with
    uncompressed arrays, or the ``anndata`` package's with a codec the port
    decodes)."""
    path = Path(path)
    X = _read_array(path / "X")
    obs = _read_dataframe(path / "obs") if (path / "obs").exists() else None
    var = _read_dataframe(path / "var") if (path / "var").exists() else None
    obsm = {}
    if (path / "obsm").exists():
        for sub in sorted((path / "obsm").iterdir()):
            if (sub / ".zarray").exists():
                obsm[sub.name] = _read_array(sub)
    uns = {}
    if (path / "uns").exists():
        for sub in sorted((path / "uns").iterdir()):
            if (sub / ".zarray").exists():
                val = _read_array(sub)
                uns[sub.name] = val.item() if val.shape == () else val
    return AnnDataLite(X=X, obs=obs, var=var, obsm=obsm, uns=uns)
