"""HCS prediction writer (counterpart of
``viscy_tpu/training/callbacks/prediction_writer.py``).

Streams sliding-window predictions into an HCS OME-Zarr store: creates or
extends the plate, appends the prediction channels, grows arrays on
demand, and blends overlapping Z windows with linear feathering
(:func:`blend_in`). With predictions on the device (the trainer hands them
over when ``wants_device_predictions``), the blend runs there
(:class:`DeviceFovAssembler`) and the host fetches one (C, Z, Y, X) slab
per (FOV, t); flushes (fetch, conversion, chunk writes) run on a worker
pool, so they overlap the next FOV's forwards.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from viscy_tpu_torch.training.callbacks.base import Callback
from viscy_tpu_torch.zarr_io.store import DEFAULT_COMPRESSOR, Position, open_ome_zarr

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["DeviceFovAssembler", "HCSPredictionWriter", "blend_in"]


def blend_in(old_stack: np.ndarray, new_stack: np.ndarray, z_slice: slice) -> np.ndarray:
    """Blend a new (C, Z, Y, X) Z-slab into the existing one: the first
    ``z_slice.start`` overlapping slices ramp linearly from old to new;
    ``new_stack`` itself when ``z_slice.start == 0``."""
    if z_slice.start == 0:
        return new_stack
    depth = z_slice.stop - z_slice.start
    samples = min(z_slice.start + 1, depth)
    factors = np.array([min(i + 1, samples) for i in reversed(range(depth))], dtype=np.float32)
    factors = factors[np.newaxis, :, np.newaxis, np.newaxis]
    return old_stack * (factors - 1) / factors + new_stack / factors


class DeviceFovAssembler:
    """Blend overlapping Z-window predictions into a device-resident slab.

    One float32 accumulator per (FOV, t), allocated with Z headroom at its
    first window and updated in place: window ``j`` of depth ``cz`` at
    ``z_start`` gets weight ``1 / min(cz - j, z_start + 1)``, in
    :func:`blend_in`'s float order (``old * (f - 1) / f + new / f``), so
    the slab equals the host blend bit for bit.

    ``fetch_dtype``: ``"float32"`` (the default), ``"float16"`` (cast at
    fetch) or ``"uint16"`` (each channel scaled affinely to [0, 65535] at
    fetch; the (lo, hi) ranges are returned for the writer to record).
    """

    GROW = 8  # Z headroom beyond the first window's depth

    def __init__(self, fetch_dtype: str = "float32") -> None:
        if fetch_dtype not in ("float32", "float16", "uint16"):
            raise ValueError(f"Unsupported fetch_dtype {fetch_dtype!r}")
        self.fetch_dtype = fetch_dtype
        self._acc: dict[tuple, tuple[torch.Tensor, int]] = {}

    def add(self, key: tuple, pred: torch.Tensor, z_start: int) -> None:
        """Blend one (C, cz, Y, X) window into the slab of ``key``."""
        cz = int(pred.shape[1])
        need = int(z_start) + cz
        entry = self._acc.get(key)
        if entry is None:
            acc = torch.zeros((pred.shape[0], need + self.GROW, *pred.shape[-2:]), dtype=torch.float32,
                              device=pred.device)
            used = 0
        else:
            acc, used = entry
            if need > acc.shape[1]:
                grown = torch.zeros((acc.shape[0], max(need + self.GROW, 2 * acc.shape[1]), *acc.shape[-2:]),
                                    dtype=torch.float32, device=acc.device)
                grown[:, : acc.shape[1]] = acc
                acc = grown
        samples = float(min(int(z_start) + 1, cz))
        factors = torch.clamp_max(torch.arange(cz, 0, -1, dtype=torch.float32, device=acc.device), samples)
        factors = factors.reshape(1, cz, 1, 1)
        old = acc[:, z_start:need]
        old.copy_(old * (factors - 1) / factors + pred.to(torch.float32) / factors)
        self._acc[key] = (acc, max(need, used))

    def keys(self) -> list[tuple]:
        return list(self._acc)

    def pop(self, key: tuple) -> tuple[torch.Tensor, int]:
        """Remove and return ``(buffer, used depth)`` of ``key``, unfetched."""
        return self._acc.pop(key)

    def convert(self, entry) -> tuple[np.ndarray, np.ndarray | None]:
        """``(slab, ranges)``: the used depth of a popped buffer on the host
        in ``fetch_dtype``; ranges are per-channel (lo, hi) for uint16."""
        acc, used = entry
        acc = acc[:, :used]
        if self.fetch_dtype == "float32":
            return acc.cpu().numpy(), None
        if self.fetch_dtype == "float16":
            return acc.to(torch.float16).cpu().numpy(), None
        lo = acc.amin(dim=(1, 2, 3), keepdim=True)
        hi = acc.amax(dim=(1, 2, 3), keepdim=True)
        q = torch.round((acc - lo) * (65535.0 / torch.clamp_min(hi - lo, 1e-12)))
        # uint16 has no torch kernels everywhere: go through int32
        q = q.to(torch.int32).cpu().numpy().astype(np.uint16)
        return q, torch.stack([lo.flatten(), hi.flatten()], dim=1).cpu().numpy()


class HCSPredictionWriter(Callback):
    """Write per-window predictions into an HCS OME-Zarr store.

    The JAX writer's options; ``compressor`` defaults to the port's
    ``"none"`` (the JAX writer's ``"lz4"`` is blosc, which this package
    does not write)."""

    def __init__(
        self,
        output_store: str,
        overwrite: bool = False,
        write_input: bool = False,
        write_interval: Literal["batch"] = "batch",
        assemble_fovs: bool = True,
        flush_workers: int = 2,
        device_blend: bool = True,
        output_dtype: Literal["float32", "float16", "uint16"] = "float32",
        compressor: str = DEFAULT_COMPRESSOR,
    ) -> None:
        if output_dtype not in ("float32", "float16", "uint16"):
            raise ValueError(f"Unsupported output_dtype {output_dtype!r}")
        if output_dtype != "float32" and write_input:
            raise ValueError("write_input requires output_dtype='float32'")
        self.output_store = Path(output_store)
        self.overwrite = overwrite
        self.write_input = write_input
        self.device_blend = device_blend
        self.output_dtype = output_dtype
        self.compressor = compressor
        # blend windows into a RAM buffer per (fov, t) and write it once
        # when the FOV is complete (not a read-modify-write per window)
        self.assemble_fovs = assemble_fovs
        self.flush_workers = max(1, int(flush_workers))
        self._plate = None
        self._positions: dict[str, Position] = {}
        self._pool: ThreadPoolExecutor | None = None
        self._flush_pool: ThreadPoolExecutor | None = None
        self._pending: list = []
        self._flush_pending: list = []
        self._assembly: dict[tuple, np.ndarray] = {}
        self._device_assembler: DeviceFovAssembler | None = None
        self._datamodule = None
        self._channel_offset = 0
        self._channels: list[str] = []
        # seconds the predict loop waited on flushes, and flush time in all
        self.flush_wait_s = 0.0
        self.flush_s = 0.0

    @property
    def wants_device_predictions(self) -> bool:
        """Ask the trainer for device tensors: the blend runs on the device."""
        return self.device_blend

    def on_predict_start(self, trainer, module) -> None:
        self._datamodule = getattr(trainer, "_active_datamodule", None) or getattr(module, "datamodule", None)
        self._source_channels: list[str] = []
        self._target_channels: list[str] = []
        self._z_window_size = 1
        # one writer thread keeps window blends of an FOV in order; flushes
        # of complete FOVs run on their own pool
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._flush_pool = ThreadPoolExecutor(max_workers=self.flush_workers)
        self._pending = []
        self._flush_pending = []
        self._resize_lock = threading.Lock()
        self._time_lock = threading.Lock()
        self.flush_wait_s = self.flush_s = 0.0

    def _ensure_store(self, dm) -> None:
        if self._plate is not None:
            return
        self._source_channels = list(getattr(dm, "source_channel", []))
        self._target_channels = list(getattr(dm, "target_channel", []))
        self._z_window_size = getattr(dm, "z_window_size", 1)
        channels = list(self._target_channels)
        if self.write_input:
            channels = self._source_channels + channels
        if self.output_store.exists() and not self.overwrite:
            # an existing store: a channel collision raises, missing
            # channels are appended
            self._plate = open_ome_zarr(self.output_store, mode="r+")
            existing = self._plate.channel_names
            for ch in channels:
                if ch in existing:
                    raise FileExistsError(
                        f"Channel {ch} already exists in {self.output_store}; pass overwrite=True to replace."
                    )
            for _, pos in self._plate.positions():
                for ch in channels:
                    if ch not in pos.channel_names:
                        pos.append_channel(ch, resize_arrays=True)
            self._plate.set_channel_names(existing + [c for c in channels if c not in existing])
            self._channel_offset = len(existing)
        else:
            self._plate = open_ome_zarr(
                self.output_store, layout="hcs", mode="w" if self.overwrite else "w-", channel_names=channels
            )
            self._channel_offset = 0
        self._channels = channels

    @property
    def _np_dtype(self):
        return {"float32": np.float32, "float16": np.float16, "uint16": np.uint16}[self.output_dtype]

    def _z_padding(self, cz: int) -> int:
        # a single-slice output sits at the window's center slice
        return self._z_window_size // 2 if cz == 1 else max(0, (self._z_window_size - cz) // 2)

    def write_on_batch_end(self, trainer, module, prediction, batch, batch_idx) -> None:
        self._ensure_store(getattr(trainer, "_active_datamodule", None) or self._datamodule)
        indices = batch["index"]
        if not isinstance(indices, list):
            indices = [indices]
        if self._try_device_blend(prediction, indices):
            return
        if isinstance(prediction, torch.Tensor):
            prediction = prediction.detach().cpu().numpy()
        preds = np.asarray(prediction, np.float32)
        sources = batch.get("source") if self.write_input else None
        for i, idx in enumerate(indices):
            img_name, t, z = str(idx[0]), int(idx[1]), int(idx[2])
            src = None
            if sources is not None:
                s = sources[i]
                src = np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s, np.float32)
            self._pending.append(self._pool.submit(self._write_sample, preds[i], img_name, t, z, src))
        self._drain(max_pending=64)

    def _try_device_blend(self, prediction, indices) -> bool:
        """Blend a tensor prediction with the device assembler (the 3-D
        sliding-window geometry: output as deep as the window, depth > 1)."""
        if not self.device_blend or self.write_input or not isinstance(prediction, torch.Tensor):
            return False
        cz = int(prediction.shape[-3])
        if self._z_padding(cz) != 0 or cz <= 1:
            return False
        if self._device_assembler is None:
            self._device_assembler = DeviceFovAssembler(self.output_dtype)
        asm = self._device_assembler
        pred_idx = tuple(range(self._channel_offset, self._channel_offset + int(prediction.shape[1])))
        for i, idx in enumerate(indices):
            img_name, t, z = str(idx[0]), int(idx[1]), int(idx[2])
            # the store's positions in the order the FOVs arrive, not in the flush threads' order
            self._get_position(img_name)
            key = (img_name, t, pred_idx)
            for other in [k for k in asm.keys() if k != key]:
                self._submit_device_flush(other)
            asm.add(key, prediction[i], z)
        # each pending flush holds a whole slab on the device until fetched
        while len(self._flush_pending) > 2 * self.flush_workers:
            self._wait(self._flush_pending.pop(0))
        self._drain(max_pending=2)
        return True

    def _wait(self, future) -> None:
        import time

        t0 = time.perf_counter()
        future.result()
        self.flush_wait_s += time.perf_counter() - t0

    def _timed(self, fn, *args) -> None:
        import time

        t0 = time.perf_counter()
        fn(*args)
        with self._time_lock:
            self.flush_s += time.perf_counter() - t0

    def _submit_device_flush(self, key: tuple) -> None:
        asm = self._device_assembler
        entry = asm.pop(key)

        def job() -> None:
            slab, ranges = asm.convert(entry)
            self._write_device_slab(key, slab, ranges)

        self._flush_pending.append(self._flush_pool.submit(self._timed, job))

    def _write_device_slab(self, key: tuple, slab: np.ndarray, ranges) -> None:
        img_name, t, pred_idx = key
        pos = self._get_position(img_name)
        img = self._ensure_image(pos, t, slab.shape[1], slab.shape[-2:], self._channel_offset + len(self._channels))
        img.oindex[t, list(pred_idx), slice(0, slab.shape[1])] = slab
        if ranges is not None:
            with self._resize_lock:
                attrs = pos.zattrs
                d = attrs.asdict()
                scaling = d.setdefault("prediction_scaling", {})
                for ci, (lo, hi) in zip(pred_idx, ranges):
                    label = self._channels[ci - self._channel_offset]
                    scaling.setdefault(label, {})[str(t)] = {
                        "lo": float(lo),
                        "hi": float(hi),
                        "formula": "value = lo + uint16 / 65535 * (hi - lo)",
                    }
                attrs._replace(d)

    def _drain(self, max_pending: int = 0) -> None:
        """Bound the write queue; raise background write errors promptly."""
        while len(self._pending) > max_pending:
            self._pending.pop(0).result()
        for q in (self._pending, self._flush_pending):
            for f in [f for f in q if f.done()]:
                q.remove(f)
                f.result()

    def _get_position(self, img_name: str) -> Position:
        # "/A/1/0/0" (FOV path + array key) -> "A/1/0"
        parts = [p for p in img_name.split("/") if p]
        fov = "/".join(parts[:3]) if len(parts) >= 3 else "/".join(parts)
        with self._resize_lock:
            if fov not in self._positions:
                if fov in self._plate:
                    pos = self._plate[fov]
                else:
                    pos = self._plate.create_position(*fov.split("/"))
                self._positions[fov] = pos
            return self._positions[fov]

    def _ensure_image(self, pos: Position, t: int, z_stop: int, shape_yx, n_total_ch: int):
        """Create or grow a position's image, under the lock (the window
        thread and the flush threads may grow the same array)."""
        with self._resize_lock:
            if "0" not in pos:
                pos.create_zeros("0", (t + 1, n_total_ch, z_stop, *shape_yx), self._np_dtype,
                                 compressor=self.compressor)
            img = pos["0"]
            if img.shape[0] <= t or img.shape[2] < z_stop:
                img.resize((max(t + 1, img.shape[0]), img.shape[1], max(z_stop, img.shape[2]), *img.shape[-2:]))
            return img

    def _write_sample(self, pred: np.ndarray, img_name: str, t: int, z_start: int, source) -> None:
        pos = self._get_position(img_name)
        cz = pred.shape[-3]
        z_padding = self._z_padding(cz)
        z_index = z_start + z_padding
        z_slice = slice(z_index, z_index + cz)
        img = self._ensure_image(pos, t, z_slice.stop, pred.shape[-2:], self._channel_offset + len(self._channels))
        offset = self._channel_offset + (len(self._source_channels) if self.write_input else 0)
        if source is not None:
            center = source.shape[-3] // 2
            for c in range(source.shape[0]):
                img[t, self._channel_offset + c, z_index] = source[c, center]
        pred_idx = list(range(offset, offset + pred.shape[0]))
        if z_padding == 0 and cz > 1:
            if self.assemble_fovs:
                key = (img_name, t, tuple(pred_idx))
                for other in [k for k in self._assembly if k != key]:
                    # a complete FOV: flush it while this one blends
                    self._flush_pending.append(
                        self._flush_pool.submit(self._timed, self._flush_assembly, other, self._assembly.pop(other))
                    )
                buf = self._assembly.get(key)
                if buf is None or buf.shape[1] < z_slice.stop:
                    grown = np.zeros((pred.shape[0], z_slice.stop, *pred.shape[-2:]), np.float32)
                    if buf is not None:
                        grown[:, : buf.shape[1]] = buf
                    self._assembly[key] = buf = grown
                buf[:, z_slice] = blend_in(buf[:, z_slice], pred, z_slice)
                return
            pred = blend_in(img.oindex[t, pred_idx, z_slice], pred, z_slice)
        img.oindex[t, pred_idx, z_slice] = pred

    def _flush_assembly(self, key: tuple, buf: np.ndarray) -> None:
        img_name, t, pred_idx = key
        pos = self._get_position(img_name)
        img = self._ensure_image(pos, t, buf.shape[1], buf.shape[-2:], self._channel_offset + len(self._channels))
        img.oindex[t, list(pred_idx), slice(0, buf.shape[1])] = buf

    def on_predict_end(self, trainer, module) -> None:
        if self._pool is not None:
            # the queued window blends fill the assembly buffers: finish
            # them, then flush what is left
            self._drain(max_pending=0)
            for key in list(self._assembly):
                self._flush_pending.append(
                    self._flush_pool.submit(self._timed, self._flush_assembly, key, self._assembly.pop(key))
                )
            if self._device_assembler is not None:
                for key in self._device_assembler.keys():
                    self._submit_device_flush(key)
                self._device_assembler = None
            while self._flush_pending:
                self._wait(self._flush_pending.pop(0))
            self._pool.shutdown(wait=True)
            self._flush_pool.shutdown(wait=True)
            self._pool = self._flush_pool = None
        self._plate = None
        self._positions.clear()
