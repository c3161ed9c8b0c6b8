"""Build and load the port's kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds); each ``csrc/<name>.cpp`` (a host kernel) compiles the same
way with the host compiler (``g++ -O3 -shared -fPIC -std=c++17``). Libraries land in ``viscy_tpu_torch/build/`` under a name
that carries a hash of the source, so an edited source rebuilds and a
stale library is never loaded; the compiler's output is kept beside it
as ``<library>.log``. Nothing here runs at import time: the first
call to :func:`load` builds, and :func:`build_all` builds every source at
once, one compiler process per source, all started together. Builds hold a
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
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}
_building = threading.Lock()


@dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already on disk
    log: str  # the compiler's output (nvcc's with its ``-Xptxas -v`` register/smem/spill lines)
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


def _host_compiler() -> str:
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if found:
        return found
    raise RuntimeError(f"{name} (the host C++ compiler; CXX names another) not found on PATH; host kernels need one")


def _source(name: str) -> Path:
    for suffix in (".cu", ".cpp"):
        if (CSRC / f"{name}{suffix}").exists():
            return CSRC / f"{name}{suffix}"
    raise FileNotFoundError(CSRC / f"{name}.cu")


def _flags(src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS


def _target(name: str) -> tuple[Path, Path]:
    src = _source(name)
    digest = hashlib.sha1(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".log")


def build_all(names: list[str] | None = None) -> list[BuildResult]:
    """Compile the named sources (default: every ``csrc/*.cu`` and
    ``csrc/*.cpp``) in parallel.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    with _building:
        return _build_all(names)


def _build_all(names: list[str] | None) -> list[BuildResult]:
    names = names or sorted(p.stem for p in [*CSRC.glob("*.cu"), *CSRC.glob("*.cpp")])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            jobs.append((name, lib, None, None, 0.0))
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        compiler = _nvcc() if src.suffix == ".cu" else _host_compiler()
        cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
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
            failures.append(f"{Path(proc.args[0]).name} failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        _log_path(lib).write_text(log)
        os.replace(tmp, lib)
        results.append(BuildResult(name, lib, seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), building it
    first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (result,) = build_all([name])
        lib = ctypes.CDLL(str(result.path))
        _loaded[name] = lib
    return lib
