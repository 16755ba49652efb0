"""Node-level orchestration: the parts of ``net_sync`` the syncer tier needs.

The port's copy of ``mysticeti_tpu.net_sync``, trimmed to the asyncio
signal primitives a :class:`~mysticeti_tpu_torch.syncer.Syncer` is driven
with: :class:`Notify` and :class:`AsyncSignals` (syncer.rs:24-52).  The
``NetworkSyncer`` (connections, the verify-then-add pipeline, timeouts,
cleanup cadence) is not in the port yet.
"""
from __future__ import annotations

import asyncio

from .syncer import SyncerSignals

# Cadence of the node's periodic ``Syncer.cleanup`` (cache eviction, GC and
# the observer's settled floor), virtual under the simulator.
CLEANUP_INTERVAL_S = 10.0


class Notify:
    """Lost-wakeup-free notification (the tokio ``Notify::notified`` shape).

    ``subscribe()`` hands out the CURRENT event object; ``notify()`` sets it
    and installs a fresh one.  A consumer that subscribes BEFORE checking its
    condition can never miss a notification that follows the check — unlike
    the set-then-``call_soon``-clear Event pattern, where a task awaiting
    between set and clear lost the edge.

    ``generation`` counts notifications: the dissemination FrameCache keys
    entries on it, so a frame built before a new block landed can never be
    served after (the key simply stops matching) — cheap whole-cache
    invalidation without a registry of entries.
    """

    __slots__ = ("_event", "generation")

    def __init__(self) -> None:
        self._event = asyncio.Event()
        self.generation = 0

    def subscribe(self) -> asyncio.Event:
        return self._event

    def notify(self) -> None:
        self.generation += 1
        event, self._event = self._event, asyncio.Event()
        event.set()


class AsyncSignals(SyncerSignals):
    """Signals backed by asyncio primitives (syncer.rs:24-52)."""

    def __init__(self) -> None:
        self.block_ready = Notify()
        self.round_notify = Notify()
        self.current_round = 0

    def new_block_ready(self) -> None:
        self.block_ready.notify()

    def new_round(self, round_: int) -> None:
        self.current_round = round_
        self.round_notify.notify()
