"""Runtime facade: one import surface for real-asyncio and simulated execution.

The port's copy of ``mysticeti_tpu.runtime``.  Capability parity with
``mysticeti-core/src/runtime/`` (mod.rs:4-14, tokio.rs, simulated.rs): node
code calls ``runtime.sleep/now/timestamp_utc/spawn`` and works unchanged under
(a) the production asyncio loop and (b) the deterministic virtual-time loop
(:mod:`mysticeti_tpu_torch.runtime.simulated`) — because the simulator IS an
asyncio event loop whose clock is virtual, every asyncio primitive (Event,
Queue, Future, call_later) is automatically deterministic under it.
"""
from __future__ import annotations

import asyncio
import time
from typing import Coroutine

from .simulated import DeterministicLoop, SimulatedClock


async def sleep(seconds: float) -> None:
    await asyncio.sleep(seconds)


def now() -> float:
    """Monotonic runtime clock (virtual under simulation)."""
    try:
        return asyncio.get_running_loop().time()
    except RuntimeError:
        return time.monotonic()


def timestamp_utc() -> float:
    """Wall-clock seconds (virtual-offset under simulation)."""
    loop = None
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        pass
    if isinstance(loop, DeterministicLoop):
        return loop.utc_time()
    return time.time()


def spawn(coro: Coroutine) -> asyncio.Task:
    return asyncio.get_running_loop().create_task(coro)


def is_simulated() -> bool:
    """True when running under the deterministic virtual-time loop.  Code on
    real-thread boundaries (executor dispatch) uses this to minimize loop
    round-trips: while a real thread works, the virtual clock leaps timers,
    so every extra hop skews a sim's virtual/real time ratio."""
    try:
        return isinstance(asyncio.get_running_loop(), DeterministicLoop)
    except RuntimeError:
        return False


__all__ = [
    "sleep",
    "now",
    "timestamp_utc",
    "spawn",
    "is_simulated",
    "DeterministicLoop",
    "SimulatedClock",
]
