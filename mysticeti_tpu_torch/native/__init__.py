"""Native (C++) data-plane helpers with transparent build + pure-Python fallback.

The port's copy of ``mysticeti_tpu.native``: ``mysticeti_native.cpp`` here is
its own copy of the C++ source, built into this directory, never loaded from
the JAX package.

``native`` resolves to the compiled ``_native`` module, or ``None`` when no
toolchain is available — callers keep a Python fallback path (the extension
is an acceleration, never a hard dependency), and every call site branches on
``native is None``.  ``active_functions()`` says which path a run took, so a
measurement on the card can refuse to time the fallback unannounced.

The extension is built on first import with ``g++ -O2 -std=c++17 -shared
-fPIC ... -lz`` into this directory; set ``MYSTICETI_NO_NATIVE=1`` to disable
both the build and the import (pins tests to the fallback path).

A failed build is remembered: a marker file keyed by the source sha256 is
written next to ``_native.so`` so a fleet of processes doesn't re-run the
doomed ``g++`` invocation (and re-log the warning) on every boot.  Editing
the source invalidates the marker.
"""
from __future__ import annotations

import hashlib
import importlib
import logging
import os
import shutil
import subprocess
import sysconfig
import tempfile

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mysticeti_native.cpp")
_SO = os.path.join(_DIR, "_native.so")
_FAIL_MARKER = os.path.join(_DIR, "_native.buildfail")


def _src_fingerprint() -> str:
    with open(_SRC, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _read_marker() -> str:
    try:
        with open(_FAIL_MARKER, "r", encoding="ascii") as fh:
            return fh.read().strip()
    except OSError:
        return ""


def _write_marker(fingerprint: str) -> None:
    try:
        with open(_FAIL_MARKER, "w", encoding="ascii") as fh:
            fh.write(fingerprint)
    except OSError:  # read-only dir: the retry cost returns, nothing breaks
        pass


def _clear_marker() -> None:
    try:
        os.unlink(_FAIL_MARKER)
    except OSError:
        pass


def _build(fingerprint: str = "") -> bool:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        if fingerprint:
            _write_marker(fingerprint)
        return False
    include = sysconfig.get_path("include")
    # Build to a temp file then atomically rename: concurrent processes
    # (e.g. a validator fleet booting) race benignly.
    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
        os.close(fd)
    except OSError:  # read-only install dir: fall back to pure Python
        return False
    cmd = [
        gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
        f"-I{include}", _SRC, "-o", tmp, "-lz",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
        if proc.returncode != 0:
            log.warning("native build failed: %s", proc.stderr.decode()[-500:])
            os.unlink(tmp)
            if fingerprint:
                _write_marker(fingerprint)
            return False
        os.replace(tmp, _SO)
        _clear_marker()
        return True
    except Exception as exc:  # toolchain quirks must never break the node
        log.warning("native build error: %r", exc)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if fingerprint:
            _write_marker(fingerprint)
        return False


def _import():
    try:
        return importlib.import_module("mysticeti_tpu_torch.native._native")
    except ImportError as exc:
        log.warning("native import failed: %r", exc)
        return None


def _load():
    if os.environ.get("MYSTICETI_NO_NATIVE"):
        return None
    if not os.path.exists(_SRC):
        # Source-less deploy: a prebuilt .so may still match this interpreter.
        return _import() if os.path.exists(_SO) else None
    stale = not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC)
    if stale:
        fingerprint = _src_fingerprint()
        if _read_marker() == fingerprint:
            # This exact source already failed to build on this box; the
            # warning was logged when the marker was written.
            log.debug("native build previously failed for this source; "
                      "skipping retry (remove %s to force)", _FAIL_MARKER)
            return None
        if not _build(fingerprint):
            return None
    mod = _import()
    if mod is None and not stale and _build(_src_fingerprint()):
        # A fresh-looking .so can still target another ABI/arch (e.g. the
        # checkout moved between interpreters); one rebuild fixes that.
        mod = _import()
    return mod


native = _load()


def active_functions() -> tuple:
    """Sorted names of the native functions resolved in this process.

    Empty when the extension is absent (no toolchain, build failure, or
    ``MYSTICETI_NO_NATIVE=1``) — the source of the ``mysticeti_native_active``
    info series, so a measurement can record which path it actually took.
    """
    if native is None:
        return ()
    return tuple(sorted(
        name for name in dir(native)
        if not name.startswith("_") and callable(getattr(native, name))
    ))
