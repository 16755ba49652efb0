"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface
(``<name>_launch``), compiled for ``sm_90a`` at first use into ``build/cuda/``
at the repository root.  The file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a stale library is never loaded.
Several sources build in parallel: one nvcc process each, all started
together (:func:`build`).

Nothing here runs at import: the CPU tests import every module, and the
machine they run on has no nvcc.

Every failure to build or load raises :class:`CudaBuildError`, a
``RuntimeError``.  The file-system and loader calls on this path raise
``OSError``, which the hybrid router counts as an outage of its accelerator
route; a kernel that cannot build is a broken installation, not an outage,
and must never send the node quietly to the CPU oracle.

Build events go to the listeners of :func:`add_listener` (the device
attribution of ``ops/ed25519.py``): ``("cache_hit", name, 0.0)`` for a
library already on disk, ``("cache_miss", name, 0.0)`` for one that must be
built, and ``("build", name, seconds)`` for each nvcc run that succeeded.
A listener never changes the outcome of a build: what it raises is dropped.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ptxas's register/spill/local-memory report per source, from the last build
# in this process (empty when the library was already built).
ptxas_reports: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_listeners: List[Callable[[str, str, float], None]] = []


class CudaBuildError(RuntimeError):
    """A CUDA source did not build, or its library did not load."""


def add_listener(fn: Callable[[str, str, float], None]) -> None:
    """Call ``fn(event, source name, seconds)`` on every build event."""
    _listeners.append(fn)


def _emit(event: str, name: str, seconds: float = 0.0) -> None:
    for fn in _listeners:
        try:
            fn(event, name, seconds)
        except Exception:  # noqa: BLE001 - attribution never breaks a build
            pass


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(candidate):
            path = candidate
    if path is None:
        raise CudaBuildError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, one nvcc
    process per source, all in parallel; raise listing every failure."""
    try:
        _build(names)
    except OSError as exc:
        raise CudaBuildError(f"CUDA build failed: {exc!r}") from exc


def _build(names: Iterable[str]) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = time.monotonic()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            _emit("cache_hit", name)
            continue
        _emit("cache_miss", name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_reports[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        # Seconds from the start of the parallel build to this source's end.
        _emit("build", name, time.monotonic() - started)
    if failures:
        raise CudaBuildError("CUDA build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as exc:
                raise CudaBuildError(f"cannot load the {name} kernels: {exc}") from exc
            _libs[name] = lib
        return lib
