"""The port's PNG label reader (``viscy_tpu_torch/data/png.py``) against PIL,
which the JAX ``MaskTestDataset`` reads masks with.

Files PIL wrote (``Image.fromarray`` of int16 and uint8 label images: 16-
and 8-bit grayscale, PIL's own filter choice per row) and files written
here with one scanline filter for every row (each of the five types, 8 and
16 bits, several IDAT chunks) decode to PIL's values, as ``np.int16``. A
palette, colour, alpha, interlaced or 4-bit image, a bad chunk CRC and a
file that is not a PNG raise by name."""

import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from viscy_tpu_torch.data.png import read_label_png, read_png


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind: int, row: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
        out[i] = (x - pred) & 0xFF
    return bytes([kind]) + bytes(out)


def encode_png(img: np.ndarray, filt: int, colour: int = 0, interlace: int = 0, idat_parts: int = 3) -> bytes:
    """A grayscale PNG of ``img`` (uint8 or big-endian uint16) with every
    row under filter ``filt``, the IDAT stream split in ``idat_parts``."""
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).tobytes()
    stride, bpp = w * img.dtype.itemsize, img.dtype.itemsize
    prev = bytes(stride)
    raw = b""
    for y in range(h):
        row = rows[y * stride : (y + 1) * stride]
        raw += _filter_row(filt, row, prev, bpp)
        prev = row
    z = zlib.compress(raw, 6)
    step = -(-len(z) // idat_parts)
    idats = b"".join(_chunk(b"IDAT", z[i : i + step]) for i in range(0, len(z), step))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + idats + _chunk(b"IEND", b"")


def _labels(dtype, seed=0, shape=(29, 47)):
    rng = np.random.default_rng(seed)
    hi = 255 if dtype == np.uint8 else 40000
    img = rng.integers(0, hi, shape).astype(dtype)
    img[3:15, 5:30] = 9  # flat blocks and edges exercise every predictor branch
    img[:, 40:] = np.arange(shape[0])[:, None] * 3
    return img


@pytest.mark.parametrize("dtype", [np.int16, np.uint8], ids=["16-bit", "8-bit"])
def test_files_pil_wrote_read_as_pil_reads_them(tmp_path, dtype):
    hi = 255 if dtype == np.uint8 else 30000
    img = (_labels(np.uint16) % hi).astype(dtype)
    path = tmp_path / "img_p001_z3_cp_masks.png"
    with warnings.catch_warnings():  # PIL deprecates writing int16 ("I") images
        warnings.simplefilter("ignore", DeprecationWarning)
        Image.fromarray(img).save(path)
    got = read_label_png(path)
    want = np.asarray(Image.open(path), np.int16)
    assert got.dtype == np.int16 and np.array_equal(got, want)
    assert np.array_equal(got, img.astype(np.int16))


@pytest.mark.parametrize("filt", range(5), ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint8], ids=["16-bit", "8-bit"])
def test_every_scanline_filter_reads_as_pil_reads_it(tmp_path, filt, dtype):
    img = _labels(dtype, seed=filt)
    path = tmp_path / "m.png"
    path.write_bytes(encode_png(img, filt))
    want = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.dtype == dtype and np.array_equal(got, want) and np.array_equal(got, img)
    assert np.array_equal(read_label_png(path), np.asarray(Image.open(path), np.int16))


@pytest.mark.parametrize(
    "colour,depth,interlace,match",
    [(3, 8, 0, "palette"), (2, 8, 0, "RGB"), (4, 8, 0, "grayscale \\+ alpha"), (6, 8, 0, "RGBA"),
     (0, 8, 1, "interlaced"), (0, 4, 0, "4-bit")],
)
def test_refuses_what_is_not_a_grayscale_label_image(tmp_path, colour, depth, interlace, match):
    body = encode_png(_labels(np.uint8), 0, colour=colour, interlace=interlace)
    if depth != 8:  # rewrite the IHDR's bit depth (and its CRC)
        ihdr = struct.pack(">IIBBBBB", 47, 29, depth, colour, 0, 0, interlace)
        body = body[:8] + _chunk(b"IHDR", ihdr) + body[8 + 25 :]
    path = tmp_path / "bad.png"
    path.write_bytes(body)
    with pytest.raises(ValueError, match=match):
        read_png(path)


def test_refuses_a_bad_crc_and_a_file_that_is_not_a_png(tmp_path):
    body = bytearray(encode_png(_labels(np.uint8), 1))
    body[-20] ^= 0xFF  # inside the last IDAT chunk
    (tmp_path / "crc.png").write_bytes(bytes(body))
    with pytest.raises(ValueError, match="CRC"):
        read_png(tmp_path / "crc.png")
    (tmp_path / "text.png").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "text.png")
