"""Deterministic virtual-time asyncio event loop (the DES engine).

The port's copy of ``mysticeti_tpu.runtime.simulated``.

Capability parity with ``mysticeti-core/src/simulator.rs`` (seeded event heap)
+ ``future_simulator.rs`` (futures as simulator events): instead of a custom
executor, this subclasses ``asyncio.BaseEventLoop`` so that

* ``loop.time()`` is virtual: when no callback is ready, the clock JUMPS to the
  next scheduled timer instead of blocking (``_NullSelector.select`` advances
  the clock by the requested timeout);
* all ordinary asyncio machinery — timers, Events, Queues, Tasks — therefore
  executes deterministically in virtual time with zero real-world waiting;
* randomness comes only from the seeded ``random.Random`` owned by the loop
  (``simulator.rs:12-32`` seeded-RNG discipline).

Real sockets are structurally impossible here (the selector refuses
registration), which is exactly the guarantee the reference gets from its
``simulator`` feature flag: simulated runs cannot accidentally touch the OS.
"""
from __future__ import annotations

import asyncio
import random
import selectors
from asyncio import base_events
from typing import Awaitable, Optional

_BASE_UTC = 1_700_000_000.0  # arbitrary fixed epoch for reproducible timestamps


class SimulatedClock:
    __slots__ = ("virtual",)

    def __init__(self) -> None:
        self.virtual = 0.0


class _NullSelector(selectors.BaseSelector):
    """Selector that never blocks: 'waiting' advances virtual time instead."""

    def __init__(self, clock: SimulatedClock) -> None:
        self._clock = clock

    def select(self, timeout: Optional[float] = None):
        if timeout is not None and timeout > 0:
            self._clock.virtual += timeout
        return []

    def register(self, fileobj, events, data=None):  # pragma: no cover
        raise RuntimeError("real I/O is not available inside the simulator")

    def unregister(self, fileobj):  # pragma: no cover
        raise RuntimeError("real I/O is not available inside the simulator")

    def close(self) -> None:
        pass

    def get_map(self):
        return {}


class DeterministicLoop(base_events.BaseEventLoop):
    """Seeded, virtual-time asyncio loop."""

    def __init__(self, seed: int = 0) -> None:
        super().__init__()
        self._clock = SimulatedClock()
        self._selector = _NullSelector(self._clock)
        self.rng = random.Random(seed)
        self.seed = seed
        # Determinism-sanitizer seam (detsan.py): when a DetsanRecorder is
        # attached, every scheduled callback is wrapped so the recorder
        # digests events in EXECUTION order.  None = zero overhead.
        self.detsan = None

    # -- detsan event capture --

    def call_soon(self, callback, *args, context=None):
        if self.detsan is not None:
            callback, args = self.detsan.wrap(self, callback, args)
        return super().call_soon(callback, *args, context=context)

    def call_at(self, when, callback, *args, context=None):
        if self.detsan is not None:
            callback, args = self.detsan.wrap(self, callback, args)
        return super().call_at(when, callback, *args, context=context)

    # -- virtual clock --

    def time(self) -> float:
        return self._clock.virtual

    def utc_time(self) -> float:
        return _BASE_UTC + self._clock.virtual

    # -- plumbing BaseEventLoop expects --

    def _process_events(self, event_list) -> None:
        pass

    def call_soon_threadsafe(self, callback, *args, context=None):
        # Single-threaded simulation: no wakeup pipe needed.
        return self.call_soon(callback, *args, context=context)

    def _write_to_self(self) -> None:
        pass


def run_simulation(
    main: Awaitable,
    seed: int = 0,
    timeout_s: Optional[float] = None,
    detsan=None,
):
    """Run ``main`` to completion on a fresh DeterministicLoop; returns its result.

    ``timeout_s`` bounds *virtual* time: exceeding it raises TimeoutError —
    reproducibly, since everything is seeded.  ``detsan`` attaches a
    :class:`mysticeti_tpu_torch.detsan.DetsanRecorder` that digests every
    executed event for run-twice divergence bisection.
    """
    loop = DeterministicLoop(seed)
    loop.detsan = detsan
    from ..types import StatementBlock

    StatementBlock.enable_decode_memo()
    try:
        asyncio.set_event_loop(loop)
        if timeout_s is not None:
            main = asyncio.wait_for(main, timeout=timeout_s)
        result = loop.run_until_complete(main)
        # The detsan trace certifies the run THROUGH its result.  The
        # straggler sweep below iterates the all_tasks() set, whose order
        # is interpreter address noise, not simulated behavior — recording
        # it would make every run-twice diff 'diverge' during teardown.
        loop.detsan = None
        # Cancel stragglers and let their cancellation run, so no coroutine is
        # destroyed mid-await after the loop closes.
        pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
        for t in pending:
            t.cancel()
        if pending:
            loop.run_until_complete(
                asyncio.gather(*pending, return_exceptions=True)
            )
        return result
    finally:
        StatementBlock.disable_decode_memo()
        asyncio.set_event_loop(None)
        loop.close()
