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
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

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


class CudaBuildError(RuntimeError):
    """A CUDA source did not build, or its library did not load."""


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
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
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
