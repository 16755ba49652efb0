"""Host attribution plane: loop-lag probe, GIL/blocking-call monitor.

The port's copy of ``mysticeti_tpu.hostattr``.  The runtime half of the
per-subsystem accountant (``profiling.py``): where the sampler says *which
code* owns host CPU, this module says *what that costs the event loop* —

* :class:`LoopLagProbe` — measures asyncio scheduling lag by the classic
  sleep-overshoot probe: schedule a callback ``interval`` out, measure how
  late it actually ran.  The delta histogram
  (``mysticeti_loop_lag_seconds``) is the node's direct "is the core owner
  responsive" signal; its p99 rides a gauge, the ``/health`` diagnosis, and
  the ``loop-lag`` SLO watchdog kind.
* :class:`HostMonitor` — bundles the probe with the blocking-call detector:
  the core task dispatcher (``core_task.py``) reports every synchronous
  command's wall duration here, and any hold beyond the threshold
  (``MYSTICETI_BLOCKING_CALL_MS``, default 50) is flagged at runtime — the
  dynamic twin of the ``async-blocking`` lint rule — as a series increment,
  a flight-recorder event, and (through the health probe) a
  ``blocking-call`` SLO alert.

Deterministic-sim discipline: under the virtual-time loop the probe never
starts (sleeps are exact by construction — lag would measure the host, not
the node) and the dispatcher skips duration measurement, so a seeded sim
reports all-zero host state byte-identically.
"""
from __future__ import annotations

import asyncio
import os
from collections import deque
from typing import Optional

from .tracing import logger
from .utils.tasks import spawn_logged

log = logger(__name__)

DEFAULT_BLOCKING_CALL_MS = 50.0


def _percentile(values, pct: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(pct / 100.0 * len(ordered)))
    return ordered[idx]


class LoopLagProbe:
    """Scheduled-vs-actual callback delta over a bounded ring.

    One coroutine, one short sleep per interval: the overshoot beyond the
    requested interval is exactly the time the loop spent running other
    callbacks (or a blocking call) instead of this one.
    """

    def __init__(
        self,
        interval_s: float = 0.25,
        metrics=None,
        window: int = 256,
    ) -> None:
        self.interval_s = interval_s
        self.metrics = metrics
        self._lags: deque = deque(maxlen=window)
        self._task: Optional[asyncio.Task] = None

    def start(self) -> "LoopLagProbe":
        from .runtime import is_simulated

        if self._task is not None or is_simulated():
            # Virtual time: sleeps complete exactly on schedule, so the
            # probe would only add loop churn to seeded runs.
            return self
        self._task = spawn_logged(self._run(), log, name="loop-lag-probe")
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            scheduled = loop.time() + self.interval_s
            await asyncio.sleep(self.interval_s)
            lag = max(0.0, loop.time() - scheduled)
            self._lags.append(lag)
            if self.metrics is not None:
                self.metrics.mysticeti_loop_lag_seconds.observe(lag)
                self.metrics.mysticeti_loop_lag_p99_seconds.set(
                    self.percentile(99)
                )

    def percentile(self, pct: float) -> float:
        return _percentile(list(self._lags), pct)

    def sample_count(self) -> int:
        return len(self._lags)


class HostMonitor:
    """The node's host-condition monitor: loop lag + blocking-call census.

    All mutation happens on the event-loop thread (the dispatcher reports
    from its own loop task; the health probe samples from its loop task),
    so no lock is needed — mirroring ``VerifyPipeline``'s discipline.
    """

    def __init__(
        self,
        metrics=None,
        recorder=None,
        blocking_threshold_ms: Optional[float] = None,
    ) -> None:
        if blocking_threshold_ms is None:
            blocking_threshold_ms = float(
                os.environ.get("MYSTICETI_BLOCKING_CALL_MS", "")
                or DEFAULT_BLOCKING_CALL_MS
            )
        self.blocking_threshold_ms = blocking_threshold_ms
        self.metrics = metrics
        self.recorder = recorder
        self.loop_lag = LoopLagProbe(metrics=metrics)
        self._blocking_total = 0
        self._worst_since_drain_ms = 0.0
        self._last_blocking: Optional[dict] = None

    # -- lifecycle --

    def start(self) -> "HostMonitor":
        self.loop_lag.start()
        return self

    def stop(self) -> None:
        self.loop_lag.stop()

    # -- the blocking-call detector (called by CoreTaskDispatcher) --

    def note_command(self, site: str, seconds: float) -> None:
        """One synchronous core command ran for ``seconds`` wall time on
        the core owner task.  Beyond the threshold it is a detected
        blocking call: counted, flight-recorded, and surfaced to the SLO
        watchdog through :meth:`drain_worst_blocking_ms`."""
        ms = seconds * 1000.0
        if ms < self.blocking_threshold_ms:
            return
        self._blocking_total += 1
        if ms > self._worst_since_drain_ms:
            self._worst_since_drain_ms = ms
        self._last_blocking = {"site": site, "ms": round(ms, 3)}
        if self.metrics is not None:
            self.metrics.mysticeti_blocking_calls_total.labels(site).inc()
            self.metrics.mysticeti_blocking_call_last_ms.set(round(ms, 3))
        if self.recorder is not None:
            self.recorder.record(
                "blocking-call",
                site=site,
                ms=round(ms, 3),
                threshold_ms=self.blocking_threshold_ms,
            )
        log.warning(
            "blocking call on core owner: %s held the loop %.1f ms "
            "(threshold %.0f ms)", site, ms, self.blocking_threshold_ms,
        )

    def drain_worst_blocking_ms(self) -> float:
        """Worst blocking hold since the last drain (the health probe's
        per-sample watchdog value); resets so the alert re-arms after a
        clean sample."""
        worst = self._worst_since_drain_ms
        self._worst_since_drain_ms = 0.0
        return worst

    @property
    def blocking_total(self) -> int:
        return self._blocking_total

    # -- the /health diagnosis block --

    def state(self) -> dict:
        from .profiling import active_accountant

        accountant = active_accountant()
        convoy = 0.0
        if accountant is not None:
            report_meta = accountant.report()
            convoy = report_meta["gil_convoy_ratio"]
        return {
            "loop_lag_p50_s": round(self.loop_lag.percentile(50), 6),
            "loop_lag_p99_s": round(self.loop_lag.percentile(99), 6),
            "loop_lag_samples": self.loop_lag.sample_count(),
            "blocking_calls": self._blocking_total,
            "last_blocking": self._last_blocking,
            "blocking_threshold_ms": self.blocking_threshold_ms,
            "gil_convoy_ratio": convoy,
        }


__all__ = ["HostMonitor", "LoopLagProbe", "DEFAULT_BLOCKING_CALL_MS"]
