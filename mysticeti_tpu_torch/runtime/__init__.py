"""Runtime clock: the part of ``mysticeti_tpu.runtime`` the verifier needs.

The port has no deterministic virtual-time loop yet, so the clock is the
running asyncio loop's (monotonic) clock, or ``time.monotonic`` outside one.
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


__all__ = ["now"]
