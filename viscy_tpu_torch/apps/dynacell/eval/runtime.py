"""Runtime plumbing of the evaluation pipeline (counterpart of
``viscy_tpu/apps/dynacell/eval/runtime.py``): the CPU budget, the per-FOV
executor, the device lock and the region timings written to
``timings.csv``.

FOV workers overlap zarr reads and host metrics; every call into a model or
a large device computation takes :data:`device_serialization_lock`, so one
card serves many FOV threads one call at a time.
"""

from __future__ import annotations

import csv
import os
import threading
import time
from concurrent.futures import Executor, Future, ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

__all__ = [
    "available_cpus",
    "resolve_runtime",
    "make_fov_executor",
    "device_serialization_lock",
    "region_timer",
    "get_timings",
    "reset_timings",
    "extend_timings",
    "dump_timings_csv",
]

#: serializes device work (model forwards, volume metrics) across FOV workers
device_serialization_lock = threading.Lock()

_timings_local = threading.local()


def available_cpus() -> int:
    """CPU budget: the SLURM allocation when there is one, else the CPUs this
    process may run on."""
    slurm = os.environ.get("SLURM_CPUS_PER_TASK") or os.environ.get("SLURM_CPUS_ON_NODE")
    if slurm:
        try:
            return max(1, int(slurm))
        except ValueError:
            pass
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:
        return max(1, os.cpu_count() or 1)


def resolve_runtime(runtime_cfg: dict | None) -> dict:
    """The runtime config normalized: executor kind and worker count."""
    cfg = dict(runtime_cfg or {})
    executor = cfg.get("executor", "serial")
    workers = cfg.get("workers")
    if workers is None:
        workers = 1 if executor == "serial" else min(4, available_cpus())
    return {"executor": executor, "workers": int(workers)}


class _SerialExecutor(Executor):
    """Runs each submitted call at once, in the caller's thread."""

    def submit(self, fn, /, *args, **kwargs):
        f: Future = Future()
        try:
            f.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 - the future carries it to .result()
            f.set_exception(e)
        return f


def make_fov_executor(runtime: dict) -> Executor:
    """Executor for per-FOV work: serial, or a bounded thread pool."""
    if runtime["executor"] == "serial" or runtime["workers"] <= 1:
        return _SerialExecutor()
    return ThreadPoolExecutor(max_workers=runtime["workers"], thread_name_prefix="fov")


def reset_timings() -> None:
    _timings_local.rows = []


def get_timings() -> list[tuple[str, int | None, str, float]]:
    return list(getattr(_timings_local, "rows", []))


def extend_timings(rows) -> None:
    if not hasattr(_timings_local, "rows"):
        _timings_local.rows = []
    _timings_local.rows.extend(rows)


@contextmanager
def region_timer(region: str, pos_name: str | None = None, t: int | None = None):
    """Add the wall-clock seconds of the block to this thread's timing log."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if not hasattr(_timings_local, "rows"):
            _timings_local.rows = []
        _timings_local.rows.append((pos_name or "", t, region, time.perf_counter() - t0))


def dump_timings_csv(path: str | Path, rows=None) -> None:
    rows = get_timings() if rows is None else rows
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["position", "t", "region", "seconds"])
        for pos, t, region, sec in rows:
            w.writerow([pos, "" if t is None else t, region, f"{sec:.4f}"])
