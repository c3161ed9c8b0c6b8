"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries land in ``viscy_tpu_torch/build/`` under a name
that carries a hash of the source, so an edited source rebuilds and a
stale library is never loaded; nvcc's output is kept beside it as
``<library>.log``. Nothing here runs at import time: the first
call to :func:`load` builds, and :func:`build_all` builds every source at
once, one ``nvcc`` process per source, all started together. Builds hold a
lock: a :func:`load` in one thread while another builds waits, then finds
the library on disk.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_building = threading.Lock()


@dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already on disk
    log: str  # nvcc's output, ``-Xptxas -v`` register/smem/spill lines included
    cached: bool = False  # the library and its log come from an earlier build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is required")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".log")


def build_all(names: list[str] | None = None) -> list[BuildResult]:
    """Compile the named sources (default: every ``csrc/*.cu``) in parallel.

    Raises ``RuntimeError`` with nvcc's output if any build fails.
    """
    with _building:
        return _build_all(names)


def _build_all(names: list[str] | None) -> list[BuildResult]:
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            jobs.append((name, lib, None, None, 0.0))
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc, time.perf_counter()))
    results = []
    failures = []
    for name, lib, tmp, proc, t0 in jobs:
        if proc is None:
            log_path = _log_path(lib)
            log = log_path.read_text() if log_path.exists() else ""
            results.append(BuildResult(name, lib, 0.0, log, cached=True))
            continue
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        _log_path(lib).write_text(log)
        os.replace(tmp, lib)
        results.append(BuildResult(name, lib, seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (result,) = build_all([name])
        lib = ctypes.CDLL(str(result.path))
        _loaded[name] = lib
    return lib
