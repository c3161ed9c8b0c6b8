#!/usr/bin/env python3
"""Write and read rates of the port's zarr writer presets (viscy_tpu_torch.zarr_io).

    python3 tools/zarr_codec_rates.py [--slices 8] [--out DIR]

For each compressor preset ("none", "zlib", "gzip", "bz2") and zarr
version (v2; v3 where the preset has a codec, sharded and not), writes a
(1, 1, slices, 1024, 1024) float32 array in (1, 1, 1, 1024, 1024) chunks
and reads it back, on two inputs: U[0, 1) noise (what the synthetic plates
hold) and a smooth image quantized to 12 bits (closer to a microscope's).
Prints MB/s (uncompressed bytes over wall seconds, the chunk threads
included) and the compression ratio, one line each, and the host's CPU
count. Runs on the CPU only; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from viscy_tpu_torch.zarr_io.store import COMPRESSORS, open_ome_zarr  # noqa: E402


def inputs(slices: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    noise = rng.random((1, 1, slices, 1024, 1024), dtype=np.float32)
    y, x = np.mgrid[0:1024, 0:1024].astype(np.float32) / 1024
    smooth = np.stack([np.sin(6 * x + z) * np.cos(4 * y - z) for z in range(slices)])
    smooth = np.round((smooth + 1) * 2047) / 4095  # 12-bit levels
    return {"uniform noise": noise, "smooth 12-bit": smooth[None, None].astype(np.float32)}


def du(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--out", default=None, help="directory for the stores (default: a temporary one)")
    args = ap.parse_args()
    print(f"host CPUs: {os.cpu_count()}", flush=True)
    base = Path(args.out or tempfile.mkdtemp(prefix="codec-rates-"))
    try:
        for label, data in inputs(args.slices).items():
            for comp in COMPRESSORS:
                for version, shard in (("0.4", False), ("0.5", False), ("0.5", True)):
                    if version == "0.5" and comp != "none" and COMPRESSORS[comp][1] is None:
                        continue
                    path = base / f"{comp}-{version}-{int(shard)}.zarr"
                    plate = open_ome_zarr(path, layout="hcs", mode="w", channel_names=["c"], version=version)
                    pos = plate.create_position("A", "1", "0")
                    t0 = time.perf_counter()
                    img = pos.create_zeros("0", data.shape, data.dtype, chunks=(1, 1, 1, 1024, 1024),
                                           shard=shard, compressor=comp)
                    img[:] = data
                    t1 = time.perf_counter()
                    back = open_ome_zarr(path)["A/1/0"]["0"][:]
                    t2 = time.perf_counter()
                    if not np.array_equal(back, data):
                        raise AssertionError(f"{comp} v{version} round trip differs")
                    mb = data.nbytes / 1e6
                    kind = "v3 sharded" if shard else ("v3" if version == "0.5" else "v2")
                    print(f"{label:14s} {comp:5s} {kind:10s}: write {mb / (t1 - t0):8.1f} MB/s, read "
                          f"{mb / (t2 - t1):8.1f} MB/s, ratio {data.nbytes / du(path / 'A/1/0/0'):.3f}",
                          flush=True)
                    shutil.rmtree(path)
    finally:
        if args.out is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()
