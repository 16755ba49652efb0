"""Monitored lock: measures wait/hold time per labeled section.

The port's copy of ``mysticeti_tpu.utils.lock``.

Capability parity with ``mysticeti-core/src/lock.rs`` (:9-41) — an
instrumented lock that *measures* contention rather than preventing it.  The
single-owner core-task design means consensus state needs no lock at all
(core_task.py); this exists for auxiliary shared state (and, like the
reference's, mostly as an observability tool).
"""
from __future__ import annotations

import asyncio
import time
from typing import Optional


class MonitoredLock:
    """asyncio.Lock wrapper feeding utilization-timer metrics.

    Usage::

        lock = MonitoredLock("block_cache", metrics)
        async with lock:
            ...
    """

    def __init__(self, name: str, metrics=None) -> None:
        self.name = name
        self.metrics = metrics
        self._lock = asyncio.Lock()
        self._acquired_at = 0.0
        self.wait_total_s = 0.0
        self.hold_total_s = 0.0

    async def __aenter__(self) -> "MonitoredLock":
        start = time.monotonic()
        await self._lock.acquire()
        waited = time.monotonic() - start
        self.wait_total_s += waited
        self._acquired_at = time.monotonic()
        if self.metrics is not None:
            self.metrics.utilization_timer_us.labels(
                f"lock_wait/{self.name}"
            ).inc(int(waited * 1e6))
        return self

    async def __aexit__(self, *exc) -> None:
        held = time.monotonic() - self._acquired_at
        self.hold_total_s += held
        if self.metrics is not None:
            self.metrics.utilization_timer_us.labels(
                f"lock_hold/{self.name}"
            ).inc(int(held * 1e6))
        self._lock.release()
