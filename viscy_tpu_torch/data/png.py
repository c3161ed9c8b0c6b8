"""Reader of grayscale PNG label images (counterpart of the
``PIL.Image.open`` call of ``viscy_tpu/data/sliding_window.py``'s
``MaskTestDataset``), in ``zlib`` and numpy: the card's machine has no PIL.

It takes what CellPose-style mask files are: colour type 0 (grayscale) at
8 or 16 bits (16-bit samples big-endian), not interlaced, with any of the
five scanline filters, as PIL writes ``Image.fromarray(int16_array)``. A
palette, colour or alpha image, an interlaced one, or another bit depth
raises a ``ValueError`` that names it. Every chunk's CRC is checked.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPES = {2: "RGB", 3: "palette", 4: "grayscale + alpha", 6: "RGBA"}


def _chunks(data: bytes, path) -> list[tuple[bytes, bytes]]:
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    out, i = [], 8
    while i + 12 <= len(data):
        (n,) = struct.unpack(">I", data[i : i + 4])
        kind, body = data[i + 4 : i + 8], data[i + 8 : i + 8 + n]
        (crc,) = struct.unpack(">I", data[i + 8 + n : i + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: {kind!r} chunk is truncated or fails its CRC")
        out.append((kind, body))
        if kind == b"IEND":
            return out
        i += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path) -> np.ndarray:
    """The (height, stride) image bytes of filtered scanlines (a filter-type
    byte before each row)."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} image bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:  # None
            row = cur.copy()
        elif kind == 1:  # Sub: a running sum of each byte lane, modulo 256
            row = (np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8).ravel()
        elif kind == 2:  # Up
            row = cur + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one bpp before it
            row = bytearray(cur.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"{path}: unknown scanline filter type {kind} in row {y}")
        out[y] = row
        prev = out[y]
    return out


def read_png(path: str | Path) -> np.ndarray:
    """The (H, W) samples of a grayscale PNG: ``uint8`` at 8 bits, ``uint16``
    at 16."""
    data = Path(path).read_bytes()
    chunks = _chunks(data, path)
    if chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError(f"{path}: the first chunk is not a 13-byte IHDR")
    width, height, depth, colour, compression, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if colour != 0:
        kind = _COLOUR_TYPES.get(colour, f"colour type {colour}")
        raise ValueError(f"{path}: a {kind} PNG; label images must be grayscale (colour type 0)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: a {depth}-bit grayscale PNG; only 8- and 16-bit are read")
    if interlace != 0:
        raise ValueError(f"{path}: an interlaced (Adam7) PNG; only non-interlaced images are read")
    if compression != 0 or filt != 0:
        raise ValueError(f"{path}: compression method {compression} / filter method {filt} are not PNG's")
    bpp = depth // 8
    raw = zlib.decompress(b"".join(body for kind, body in chunks if kind == b"IDAT"))
    img = _unfilter(raw, height, width * bpp, bpp, path)
    if depth == 8:
        return img
    return img.view(">u2").astype(np.uint16)


def read_label_png(path: str | Path) -> np.ndarray:
    """A mask image as ``MaskTestDataset`` hands it on: ``np.int16``, as
    ``np.asarray(PIL.Image.open(path), np.int16)`` gives it."""
    return read_png(path).astype(np.int16)
