"""Runtime clocks: the part of ``mysticeti_tpu.runtime`` the verifier needs.

The port has no deterministic virtual-time loop yet, so the clock is the
running asyncio loop's (monotonic) clock, or ``time.monotonic`` outside one,
and the wall clock is ``time.time``; ``is_simulated`` is always False.
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


def is_simulated() -> bool:
    """True when running under the deterministic virtual-time loop.

    The port has no such loop yet, so this returns False; the JAX package's
    ``runtime.is_simulated`` checks for its ``DeterministicLoop``.  Callers
    keep the check so the port's simulator can switch their real-thread hops
    off when it arrives."""
    return False


__all__ = ["is_simulated", "now", "timestamp_utc"]
