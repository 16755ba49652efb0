"""Always-on flight recorder: the seconds that led up to the incident.

The port's copy of ``mysticeti_tpu.flight_recorder``, cut to the ring that
``NetworkSyncer`` (and the block store, committers and commit observer when
one is wired) records into.  The JAX module's dump triggers — the
``MYSTICETI_FLIGHT_RECORDER`` path rule and ``Validator.stop``'s shutdown
dump, the health watchdog's debounced ``on_alert`` dump, the metrics
endpoint's ``/debug/flight-recorder`` route and the chaos engine's dump, with
``flight_recorder_dumps_total`` — come back with the modules that fire them.

When an SLO alert or a chaos safety failure fires, the metrics say *that*
something broke and the spans say where committed blocks spent their time —
but neither holds the recent *event sequence*: which connections churned,
which breaker tripped, what the node adopted.  :class:`FlightRecorder` is the
bounded black box that does: a fixed-capacity in-memory ring of structured
events, one per node, recorded from the consensus hot paths at edge
granularity (block lifecycle edges, sync decisions, connection churn, leader
timeouts — never per message).  The ring is lock-disciplined
(``_ring_lock``) because a reader on another thread may snapshot it while
the loop records.

Events are clocked by the RUNTIME clock and recorded on the loop thread, so
under the deterministic simulator a seeded run records the same events every
run.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Deque, List, Optional

from .runtime import now as runtime_now

# Ring capacity: at edge granularity (commits batched per handle_commit,
# transitions, churn) a busy node records a few events per second, so 4096
# holds many minutes of history in ~1 MB.
DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """Bounded ring of recent structured events for one node."""

    def __init__(
        self, authority: Optional[int] = None, capacity: int = DEFAULT_CAPACITY
    ) -> None:
        self.authority = authority
        self.capacity = max(1, capacity)
        self._ring_lock = threading.Lock()
        # Guarded by _ring_lock: the loop thread records while a reader
        # snapshots.
        self._flight_ring: Deque[dict] = deque(maxlen=self.capacity)
        self.recorded = 0
        self.dropped = 0

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

    def events(self, last: Optional[int] = None) -> List[dict]:
        with self._ring_lock:
            events = list(self._flight_ring)
        return events[-last:] if last else events
