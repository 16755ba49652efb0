"""Always-on flight recorder: the seconds that led up to the incident.

The port's copy of ``mysticeti_tpu.flight_recorder``.

When an SLO alert or a chaos safety failure fires, the metrics say *that*
something broke and the spans say where committed blocks spent their time —
but neither holds the recent *event sequence*: which connections churned,
which breaker tripped, what the GC deleted, what the node adopted.  This
module is the bounded black box that does:

* :class:`FlightRecorder` — a fixed-capacity in-memory ring of structured
  events, one per node, recorded from the consensus hot paths at edge
  granularity (block lifecycle edges, breaker/pin transitions, SLO alerts,
  GC/checkpoint actions, sync decisions, connection churn, and the host
  attribution plane's ``blocking-call`` detections — hostattr.py flags a
  synchronous hold of the core owner past the threshold — never per
  message).  The ring is lock-disciplined (``_ring_lock``) because dumps
  may be requested from the metrics endpoint or a signal path while the
  loop records.
* Dump triggers, all writing the SAME canonical JSON document atomically
  (tmp + rename):
  - orderly shutdown / SIGTERM — ``Validator.stop`` dumps to the path from
    ``MYSTICETI_FLIGHT_RECORDER`` (``%p`` expands to the pid, ``%a`` to the
    authority);
  - ``GET /debug/flight-recorder`` on the metrics endpoint returns the
    document live (``metrics.serve_metrics``);
  - SLO alert transitions — the health watchdog calls :meth:`on_alert`,
    which records the alert and writes a debounced ``<path>.alert`` dump so
    a flapping threshold cannot turn the recorder into a disk hose.

Events are clocked by the RUNTIME clock and recorded on the loop thread, so
under the deterministic simulator a seeded run produces a byte-identical
dump every run.  Production dumps additionally carry a wall-clock stamp;
simulated ones deliberately do not (virtual time IS the sim's wall time).
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Deque, List, Optional

from .runtime import is_simulated, now as runtime_now
from .tracing import logger

log = logger(__name__)

ENV_FLIGHT_RECORDER = "MYSTICETI_FLIGHT_RECORDER"

# Ring capacity: at edge granularity (commits batched per handle_commit,
# transitions, churn) a busy node records a few events per second, so 4096
# holds many minutes of history in ~1 MB — enough to cover any alert's
# debounce window plus the run-up.
DEFAULT_CAPACITY = 4096

# Minimum seconds between alert-triggered dumps (runtime-clocked).
ALERT_DEBOUNCE_S = 30.0


def path_from_env(authority: Optional[int] = None) -> Optional[str]:
    """The dump path from ``MYSTICETI_FLIGHT_RECORDER`` (``%p`` -> pid,
    ``%a`` -> authority index), or None when the operator did not ask for
    on-disk dumps (the ring still records — the debug route serves it).
    ``%a`` matters for the in-process testbed, where every validator shares
    one pid and a bare ``%p`` path would leave only the last-stopped
    node's dump."""
    path = os.environ.get(ENV_FLIGHT_RECORDER)
    if not path:
        return None
    path = path.replace("%p", str(os.getpid()))
    if authority is not None:
        path = path.replace("%a", str(authority))
    return path


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


class FlightRecorder:
    """Bounded ring of recent structured events for one node."""

    def __init__(
        self,
        authority: Optional[int] = None,
        capacity: int = DEFAULT_CAPACITY,
        dump_path: Optional[str] = None,
        metrics=None,
        alert_debounce_s: float = ALERT_DEBOUNCE_S,
    ) -> None:
        self.authority = authority
        self.capacity = max(1, capacity)
        self.dump_path = dump_path
        self.metrics = metrics
        self.alert_debounce_s = alert_debounce_s
        self._ring_lock = threading.Lock()
        # Guarded by _ring_lock: the loop thread records while the metrics
        # endpoint / a signal path snapshots.
        self._flight_ring: Deque[dict] = deque(maxlen=self.capacity)
        self.recorded = 0
        self.dropped = 0
        # Dump ledger: {trigger, file, t} per on-disk dump (basenames only —
        # dumps must stay byte-identical across same-seed sims run in
        # different temp dirs).
        self.dumps: List[dict] = []
        self._last_alert_dump_t: Optional[float] = None

    # -- recording (hot-ish path: edges only, one dict + one lock) --

    def record(self, kind: str, **fields) -> None:
        entry = {"t": round(runtime_now(), 6), "kind": kind}
        for key, value in fields.items():
            if value is not None:
                entry[key] = value
        with self._ring_lock:
            if len(self._flight_ring) == self._flight_ring.maxlen:
                self.dropped += 1
            self._flight_ring.append(entry)
            self.recorded += 1

    def on_alert(
        self, kind: str, authority, stage: str, value: float, detail: str
    ) -> None:
        """SLO watchdog hook: record the alert edge and (when a dump path is
        configured) write a debounced ``<path>.alert`` dump — the forensic
        ring AT the degraded transition, not minutes later."""
        self.record(
            "slo-alert", alert=kind, indicted=authority, stage=stage,
            value=round(float(value), 6), detail=detail,
        )
        if not self.dump_path:
            return
        t = runtime_now()
        if (
            self._last_alert_dump_t is not None
            and t - self._last_alert_dump_t < self.alert_debounce_s
        ):
            return
        self._last_alert_dump_t = t
        self.dump("slo-alert", path=self.dump_path + ".alert")

    # -- snapshots / dumps --

    def events(self, last: Optional[int] = None) -> List[dict]:
        with self._ring_lock:
            events = list(self._flight_ring)
        return events[-last:] if last else events

    def snapshot(self) -> dict:
        """The dump document (also served by ``/debug/flight-recorder``)."""
        with self._ring_lock:
            events = list(self._flight_ring)
            recorded, dropped = self.recorded, self.dropped
        doc = {
            "authority": self.authority,
            "capacity": self.capacity,
            "recorded": recorded,
            "dropped": dropped,
            "events": events,
            "dumps": list(self.dumps),
        }
        if not is_simulated():
            import time as _time

            doc["generated_unix"] = round(_time.time(), 3)
        return doc

    def snapshot_bytes(self) -> bytes:
        return _canonical(self.snapshot())

    def dump(self, trigger: str, path: Optional[str] = None) -> Optional[str]:
        """Atomic dump (tmp + rename) to ``path`` or the configured path.
        Returns the written path, or None when neither is set.  Never
        raises: the recorder is a diagnostic, not a failure mode."""
        path = path or self.dump_path
        if not path:
            return None
        try:
            tmp = f"{path}.tmp"
            with open(tmp, "wb") as f:
                f.write(self.snapshot_bytes())
                f.write(b"\n")
            os.replace(tmp, path)
        except OSError:
            log.exception("flight-recorder dump to %s failed", path)
            return None
        self.dumps.append(
            {
                "trigger": trigger,
                "file": os.path.basename(path),
                "t": round(runtime_now(), 6),
            }
        )
        if self.metrics is not None:
            self.metrics.flight_recorder_dumps_total.labels(trigger).inc()
        log.info("flight recorder dumped (%s) to %s", trigger, path)
        return path
