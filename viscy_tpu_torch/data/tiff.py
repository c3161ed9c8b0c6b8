"""A baseline TIFF codec in numpy: one grayscale page, uncompressed strips.

The card's machine has neither imageio, PIL nor tifffile, so the port reads
and writes the Cell Tracking Challenge's ``.tif`` frames and masks itself.
The scope is what those files are:

- one image file directory (one page), one sample a pixel
  (``SamplesPerPixel`` 1, ``PhotometricInterpretation`` 1, black is zero);
- ``uint8``, ``uint16``, ``int32`` or ``float32`` samples
  (``BitsPerSample`` and ``SampleFormat``);
- strips (not tiles), in either byte order (``II`` or ``MM``);
- no compression (``Compression`` 1) and no predictor.

Anything else raises ``UnsupportedTiffError`` naming the tag and its
value, as the OME-Zarr store refuses a codec it lacks
(``viscy_tpu_torch/zarr_io/store.py``). The writer writes little-endian
strips of at most 64 KiB, the baseline tags in ascending order.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ["UnsupportedTiffError", "read_tiff", "write_tiff"]

# tag numbers (TIFF 6.0)
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = 273, 277, 278, 279
PLANAR, PREDICTOR, TILE_WIDTH, SAMPLE_FORMAT = 284, 317, 322, 339
NAMES = {COMPRESSION: "Compression", PHOTOMETRIC: "PhotometricInterpretation", SAMPLES: "SamplesPerPixel",
         PLANAR: "PlanarConfiguration", PREDICTOR: "Predictor", TILE_WIDTH: "TileWidth",
         BITS: "BitsPerSample", SAMPLE_FORMAT: "SampleFormat"}
COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT T.4", 4: "CCITT T.6", 5: "LZW", 6: "old JPEG", 7: "JPEG",
                8: "Adobe Deflate", 32773: "PackBits", 32946: "Deflate", 34925: "LZMA", 50000: "Zstd"}
# field type -> struct code (one value)
_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d"}
# (BitsPerSample, SampleFormat) -> dtype
_DTYPES = {(8, 1): np.uint8, (16, 1): np.uint16, (32, 2): np.int32, (32, 3): np.float32}
_STRIP_BYTES = 1 << 16


class UnsupportedTiffError(ValueError):
    """A TIFF outside the codec's scope (see the module docstring)."""


def _refuse(path, tag: int, value) -> None:
    what = f" ({COMPRESSIONS[value]})" if tag == COMPRESSION and value in COMPRESSIONS else ""
    raise UnsupportedTiffError(
        f"{path}: TIFF tag {NAMES.get(tag, tag)} = {value}{what} is not supported by viscy_tpu_torch's TIFF codec "
        "(baseline, one grayscale page, uncompressed strips; the card's machine has no imageio, PIL or tifffile)")


def _ifd(buf: bytes, offset: int, order: str) -> tuple[dict[int, tuple], int]:
    (n,) = struct.unpack_from(order + "H", buf, offset)
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from(order + "HHI4s", buf, offset + 2 + 12 * i)
        if typ not in _TYPES:
            raise UnsupportedTiffError(f"TIFF tag {tag} has field type {typ}, which baseline TIFF does not define")
        code = _TYPES[typ]
        size = struct.calcsize(order + code) * count
        data = raw[:size] if size <= 4 else buf[struct.unpack(order + "I", raw)[0]:][:size]
        if typ == 2:
            tags[tag] = (data.rstrip(b"\0").decode("latin-1"),)
        else:
            vals = struct.unpack(order + code * count, data)
            if typ in (5, 10):
                vals = tuple(vals[i] / vals[i + 1] for i in range(0, len(vals), 2))
            tags[tag] = vals
    (nxt,) = struct.unpack_from(order + "I", buf, offset + 2 + 12 * n)
    return tags, nxt


def read_tiff(path: str | Path) -> np.ndarray:
    """The one page of a baseline grayscale TIFF as a (rows, columns) array
    of its sample type, in native byte order."""
    buf = Path(path).read_bytes()
    if buf[:4] == b"II*\0":
        order = "<"
    elif buf[:4] == b"MM\0*":
        order = ">"
    elif buf[:4] in (b"II+\0", b"MM\0+"):
        raise UnsupportedTiffError(f"{path}: a BigTIFF, which viscy_tpu_torch's TIFF codec does not read")
    else:
        raise UnsupportedTiffError(f"{path}: not a TIFF (header {buf[:4]!r})")
    tags, nxt = _ifd(buf, struct.unpack_from(order + "I", buf, 4)[0], order)
    if nxt:
        raise UnsupportedTiffError(f"{path}: more than one page, which viscy_tpu_torch's TIFF codec does not read")
    get = lambda tag, default=None: tags.get(tag, (default,))[0]
    for tag, allowed, default in ((COMPRESSION, (1,), 1), (PHOTOMETRIC, (1,), 1), (SAMPLES, (1,), 1),
                                  (PLANAR, (1,), 1), (PREDICTOR, (1,), 1)):
        if get(tag, default) not in allowed:
            _refuse(path, tag, get(tag))
    if TILE_WIDTH in tags:
        _refuse(path, TILE_WIDTH, get(TILE_WIDTH))
    bits, fmt = get(BITS, 1), get(SAMPLE_FORMAT, 1)
    if (bits, fmt) not in _DTYPES:
        _refuse(path, BITS if fmt in (1, 2, 3) else SAMPLE_FORMAT, f"{bits} (SampleFormat {fmt})")
    dtype = np.dtype(_DTYPES[bits, fmt]).newbyteorder(order)
    rows, cols = get(LENGTH), get(WIDTH)
    data = b"".join(buf[o:o + n] for o, n in zip(tags[STRIP_OFFSETS], tags[STRIP_BYTES]))
    need = rows * cols * dtype.itemsize
    if len(data) < need:
        raise ValueError(f"{path}: strips hold {len(data)} bytes for a {rows} x {cols} {dtype.name} image")
    return np.frombuffer(data[:need], dtype=dtype).reshape(rows, cols).astype(dtype.newbyteorder("="))


def write_tiff(path: str | Path, image: np.ndarray) -> None:
    """Write a 2-D ``uint8``, ``uint16``, ``int32`` or ``float32`` array as a
    little-endian baseline TIFF of uncompressed strips."""
    image = np.asarray(image)
    key = {np.dtype(v): k for k, v in _DTYPES.items()}.get(image.dtype.newbyteorder("="))
    if image.ndim != 2 or key is None:
        raise UnsupportedTiffError(f"{path}: viscy_tpu_torch's TIFF codec writes 2-D uint8, uint16, int32 or "
                                   f"float32 images, not {image.dtype} of shape {image.shape}")
    bits, fmt = key
    rows, cols = image.shape
    data = np.ascontiguousarray(image, dtype=image.dtype.newbyteorder("<")).tobytes()
    row_bytes = cols * image.itemsize
    per_strip = max(1, min(rows, _STRIP_BYTES // max(row_bytes, 1)))
    starts = list(range(0, rows, per_strip))
    counts = [(min(s + per_strip, rows) - s) * row_bytes for s in starts]
    entries = [(WIDTH, 4, [cols]), (LENGTH, 4, [rows]), (BITS, 3, [bits]), (COMPRESSION, 3, [1]),
               (PHOTOMETRIC, 3, [1]), (STRIP_OFFSETS, 4, None), (SAMPLES, 3, [1]), (ROWS_PER_STRIP, 4, [per_strip]),
               (STRIP_BYTES, 4, counts), (PLANAR, 3, [1]), (SAMPLE_FORMAT, 3, [fmt])]
    ifd_size = 2 + 12 * len(entries) + 4
    arrays_at = 8 + ifd_size  # out-of-line tag values follow the IFD, then the strips
    out_of_line = 4 * len(starts) if len(starts) > 1 else 0
    data_at = arrays_at + 2 * out_of_line
    offsets = [data_at + s * row_bytes for s in starts]
    ifd = struct.pack("<H", len(entries))
    extra = b""
    for tag, typ, vals in entries:
        vals = offsets if tag == STRIP_OFFSETS else vals
        packed = struct.pack("<" + _TYPES[typ] * len(vals), *vals)
        if len(packed) <= 4:
            ifd += struct.pack("<HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHII", tag, typ, len(vals), arrays_at + len(extra))
            extra += packed
    ifd += struct.pack("<I", 0)
    Path(path).write_bytes(b"II*\0" + struct.pack("<I", 8) + ifd + extra + data)
