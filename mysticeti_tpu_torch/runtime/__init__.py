"""Runtime clocks: the part of ``mysticeti_tpu.runtime`` the verifier needs.

The port has no deterministic virtual-time loop yet, so the clock is the
running asyncio loop's (monotonic) clock, or ``time.monotonic`` outside one,
and the wall clock is ``time.time``.
"""
from __future__ import annotations

import asyncio
import time


def now() -> float:
    """Monotonic runtime clock."""
    try:
        return asyncio.get_running_loop().time()
    except RuntimeError:
        return time.monotonic()


def timestamp_utc() -> float:
    """Wall-clock seconds."""
    return time.time()


__all__ = ["now", "timestamp_utc"]
