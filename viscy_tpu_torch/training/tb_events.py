"""TensorBoard event files written by hand (counterpart of tensorboardX's
``SummaryWriter`` in ``viscy_tpu/training/trainer.py``'s ``CSVLogger``):
the card's machine has neither tensorboardX nor tensorboard.

A file ``events.out.tfevents.<unix seconds>.<host>`` holds TFRecords: a
little-endian uint64 length, its masked CRC-32C, the payload, the
payload's masked CRC-32C. The first payload is an ``Event`` with
``file_version = "brain.Event:2"``; each scalar is an ``Event`` (wall time,
step) whose ``Summary`` holds one ``Value`` (tag, ``simple_value``), the
protobuf fields tensorboardX writes for ``add_scalar``; each image one
``Value`` (tag, ``image``: height, width, colorspace 3 and an RGB PNG), as
``add_image`` writes it.
"""

from __future__ import annotations

import socket
import struct
import time
import zlib
from pathlib import Path

import numpy as np

from viscy_tpu_torch.zarr_io.store import crc32c

FILE_VERSION = "brain.Event:2"


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC-32C: rotated right by 15 bits plus a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _len_field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def png_rgb(image: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG (no filter, zlib)."""
    h, w, _ = image.shape
    raw = b"".join(b"\x00" + np.ascontiguousarray(image[r]).tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def image_uint8(image) -> np.ndarray:
    """An (H, W, 3) image as tensorboardX's ``add_image`` stores it: uint8
    as it is, anything else scaled by 255 and clipped to [0, 255]."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return (image.astype(np.float32) * 255).clip(0, 255).astype(np.uint8)


def event_bytes(wall_time: float, step: int, file_version: str | None = None,
                scalar: tuple[str, float] | None = None, image: tuple[str, np.ndarray] | None = None) -> bytes:
    """A serialized ``Event``: wall_time (1, double), step (2, varint; left
    out at 0, as protobuf leaves out defaults), file_version (3) or a
    summary (5) of one value: a scalar (tag 1, simple_value 2, float) or an
    image (tag 1, image 4: height 1, width 2, colorspace 3, PNG 4)."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step:
        out += b"\x10" + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        out += _len_field(5, _len_field(1, _len_field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)))
    if image is not None:
        tag, pixels = image
        h, w, _ = pixels.shape
        img = b"\x08" + _varint(h) + b"\x10" + _varint(w) + b"\x18" + _varint(3) + _len_field(4, png_rgb(pixels))
        out += _len_field(5, _len_field(1, _len_field(1, tag.encode()) + _len_field(4, img)))
    return out


def record_bytes(payload: bytes) -> bytes:
    """``payload`` framed as one TFRecord."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


class EventFileWriter:
    """Scalars into a new event file under ``log_dir``, flushed after each
    call (a reader sees every value logged so far)."""

    def __init__(self, log_dir: str | Path) -> None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = log_dir / f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}"
        self._file = open(self.path, "ab")
        self._file.write(record_bytes(event_bytes(now, 0, file_version=FILE_VERSION)))
        self._file.flush()

    def add_scalars(self, values: dict[str, float], step: int, wall_time: float | None = None) -> None:
        wall_time = time.time() if wall_time is None else wall_time
        self._file.write(b"".join(
            record_bytes(event_bytes(wall_time, step, scalar=(tag, float(v)))) for tag, v in values.items()
        ))
        self._file.flush()

    def add_image(self, tag: str, image, step: int, wall_time: float | None = None) -> None:
        """An (H, W, 3) image (see :func:`image_uint8`)."""
        wall_time = time.time() if wall_time is None else wall_time
        self._file.write(record_bytes(event_bytes(wall_time, step, image=(tag, image_uint8(image)))))
        self._file.flush()

    def close(self) -> None:
        self._file.close()
