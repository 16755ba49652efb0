"""Logging: env-filterable levels + the virtual-time per-authority formatter.

The port's copy of ``mysticeti_tpu.tracing``:

* env-filter levels a la ``RUST_LOG``:
  ``MYSTICETI_LOG="info"`` or ``MYSTICETI_LOG="verifier_service=debug,warning"``
  — bare token sets the package root level, ``module=level`` tokens set
  per-module levels (module names relative to ``mysticeti_tpu_torch``).
* the simulator formatter: when a log record is emitted inside a
  deterministic virtual-time loop the timestamp printed is the VIRTUAL time,
  and the emitting validator's authority index (a contextvar set per
  simulated node task) prefixes the line
  (:class:`~mysticeti_tpu_torch.runtime.simulated.DeterministicLoop`).
"""
from __future__ import annotations

import asyncio
import contextvars
import logging
import os
import sys
from typing import Optional

# Which authority (validator index) the current task belongs to.
current_authority: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "mysticeti_authority", default=None
)

PACKAGE = "mysticeti_tpu_torch"

_LEVELS = {
    "trace": logging.DEBUG,  # python has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL + 10,
}


# Lazy module-level cache of the virtual-time loop class: the import stays
# deferred (runtime.simulated imports the package's types), and caching it
# spares every log record a sys.modules lookup.
_DeterministicLoop = None


def _virtual_loop_class():
    global _DeterministicLoop
    if _DeterministicLoop is None:
        from .runtime.simulated import DeterministicLoop

        _DeterministicLoop = DeterministicLoop
    return _DeterministicLoop


class SimAwareFormatter(logging.Formatter):
    """``[  12.345s A3] level module: msg`` under a virtual-time loop,
    wall-clock otherwise."""

    def format(self, record: logging.LogRecord) -> str:
        virtual = _virtual_loop_class()
        stamp = None
        try:
            loop = asyncio.get_running_loop()
            if isinstance(loop, virtual):
                stamp = f"{loop.time():9.3f}s"
        except RuntimeError:
            pass
        if stamp is None:
            stamp = self.formatTime(record, "%H:%M:%S")
        authority = current_authority.get()
        who = f" A{authority}" if authority is not None else ""
        module = record.name
        if module.startswith(PACKAGE + "."):
            module = module[len(PACKAGE) + 1 :]
        return (
            f"[{stamp}{who}] {record.levelname.lower():<7} {module}: "
            f"{record.getMessage()}"
        )


# Child loggers whose level the last applied spec set; reset before the next
# spec is applied so stale per-module levels never leak across re-installs.
_touched_modules: set = set()


def setup_logging(
    spec: Optional[str] = None, stream=None, force: bool = False
) -> None:
    """Install the handler/levels from ``spec`` (default: $MYSTICETI_LOG).

    No-op when the env var is unset and no spec given (library mode: stay
    silent).
    """
    if spec is None:
        spec = os.environ.get("MYSTICETI_LOG")
    if not spec:
        return
    root = logging.getLogger(PACKAGE)
    if root.handlers and not force:
        return
    for h in list(root.handlers):
        root.removeHandler(h)
    # Reset per-module levels a PREVIOUS spec installed: child logger levels
    # outlive the handler swap.
    for name in _touched_modules:
        logging.getLogger(name).setLevel(logging.NOTSET)
    _touched_modules.clear()
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(SimAwareFormatter())
    root.addHandler(handler)
    root.propagate = False
    base_level = logging.INFO
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if "=" in token:
            module, _, level = token.partition("=")
            name = f"{PACKAGE}.{module.strip()}"
            logging.getLogger(name).setLevel(
                _LEVELS.get(level.strip().lower(), logging.INFO)
            )
            _touched_modules.add(name)
        else:
            base_level = _LEVELS.get(token.lower(), logging.INFO)
    root.setLevel(base_level)


def logger(name: str) -> logging.Logger:
    """Module logger factory: ``logger(__name__)``."""
    return logging.getLogger(name)
