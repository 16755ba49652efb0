"""Core-task seams: for now only the data-plane offload.

The port's copy of ``mysticeti_tpu.core_task``, trimmed to
``DataPlaneOffload``; the single-owner ``CoreTaskDispatcher`` comes with the
port's consensus core.
"""
from __future__ import annotations

import asyncio
from typing import Optional


class DataPlaneOffload:
    """Routes batched native data-plane calls off the event loop.

    The native batch helpers (block_digests, decode_block, the frame
    codecs) release the GIL around their heavy work — but calling them ON
    the event loop still serializes that work with consensus scheduling.
    This single-worker executor moves whole-frame decode+digest batches to
    a side thread; the decoded blocks return to the caller on the loop, so
    only the CPU burn moves off-loop.

    One worker, deliberately: batches stay ordered per submission site, and
    the GIL-holding portions (Python object construction) never contend
    with a second offload thread.  Stage wall time is observable two ways,
    mirroring verify_pipeline's stage gauges:
    ``utilization_timer{proc="offload:<stage>"}`` (busy µs, measured IN the
    worker thread so executor queue wait is excluded) and the
    ``dataplane_offload_seconds{stage}`` histogram.

    ``active()`` is False under ``runtime.is_simulated()`` (seeded sims take
    the caller's inline path: thread handoff timing is not virtualizable).
    It is also False without the native extension: the pure-Python fallback
    gains nothing from a thread hop (the GIL is held throughout), so
    ``MYSTICETI_NO_NATIVE=1`` pins the fully-inline pure path.
    """

    # Below this many payload bytes the executor round-trip costs more than
    # the GIL-released hashing saves; small frames stay inline.
    MIN_BATCH_BYTES = 16 * 1024

    def __init__(self, metrics=None) -> None:
        self.metrics = metrics
        self._executor = None
        self._active: Optional[bool] = None

    def active(self) -> bool:
        if self._active is None:
            # Evaluated lazily on first use (inside the running loop): the
            # loop flavor cannot change mid-run.
            from .native import native as _native
            from .runtime import is_simulated

            self._active = _native is not None and not is_simulated()
        return self._active

    def should_offload(self, total_bytes: int) -> bool:
        return self.active() and total_bytes >= self.MIN_BATCH_BYTES

    def _ensure_executor(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dataplane-offload"
            )
        return self._executor

    async def run(self, stage: str, fn, *args):
        """Run ``fn(*args)`` on the offload worker; awaitable result."""
        loop = asyncio.get_running_loop()
        metrics = self.metrics

        def work():
            if metrics is None:
                return fn(*args)
            from time import perf_counter

            t0 = perf_counter()
            try:
                with metrics.utilization_timer(f"offload:{stage}"):
                    return fn(*args)
            finally:
                metrics.dataplane_offload_seconds.labels(stage).observe(
                    perf_counter() - t0
                )

        return await loop.run_in_executor(self._ensure_executor(), work)

    def stop(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
