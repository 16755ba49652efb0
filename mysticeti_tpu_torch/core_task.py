"""Single-owner consensus dispatcher — the L7 concurrency bridge.

The port's copy of ``mysticeti_tpu.core_task``: ``CoreTaskDispatcher`` and
``DataPlaneOffload``.  The dispatcher's ``blocking_monitor`` reports each
command's wall duration to the host attribution plane (``hostattr``).

Capability parity with ``mysticeti-core/src/core_thread/spawned.rs``: all
consensus state mutation is serialized through ONE owner; network tasks submit
``CoreTaskCommand``s over a bounded queue (32) and await oneshot replies
(:15-60,117-152).  In Python the owner is a dedicated asyncio task rather than
an OS thread — the GIL makes a thread pointless for pure-Python state, and the
card dispatch (the actually-parallel part) releases the GIL inside the batched
verifier's executor thread.

The simulator needs no variant (core_thread/simulated.rs): the owner task is
already deterministic under the DeterministicLoop.
"""
from __future__ import annotations

import asyncio
from typing import List, Optional, Sequence, Set

from .syncer import Syncer
from .tracing import logger
from .types import AuthoritySet, BlockReference, RoundNumber, StatementBlock

log = logger(__name__)

CORE_QUEUE_SIZE = 32


class CoreTaskDispatcher:
    # Consecutive COUNTED command failures after which the owner halts —
    # and only when the run spans MORE THAN ONE command type.  A failure
    # counts when no live caller received the exception (ADVICE r5: a
    # client retry-looping one failing command gets its exception back
    # every time — caller churn, not state corruption) OR when the command
    # is INTERNAL (cleanup, get_missing, force_new_block: driven by the
    # node's own periodic tasks, which a remote client cannot make fail —
    # under a poisoned store they supply the halt's second command type
    # within seconds even though their callers are alive and observing).
    # The distinct-type requirement covers the churn the observed split
    # alone cannot: a retry loop whose awaits are CANCELLED (e.g. wait_for
    # timeouts) also reads as unobserved, but it hammers one command;
    # genuine corruption poisons every mutation type.
    MAX_CONSECUTIVE_FAILURES = 16

    def __init__(self, syncer: Syncer, metrics=None,
                 fatal_handler=None) -> None:
        self.syncer = syncer
        self.metrics = metrics
        # Called when the owner dies on a persistent failure.  Merely
        # letting the task die would leave a ZOMBIE: ports held, /metrics
        # stale, every subsequent command awaiting a reply forever.  The
        # default terminates the process (the reference's panic posture);
        # tests inject a recorder.
        self.fatal_handler = fatal_handler or self._default_fatal
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=CORE_QUEUE_SIZE)
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        # Host attribution plane (hostattr.py): when a HostMonitor is
        # attached, every synchronous command's wall duration is reported
        # to its blocking-call detector — the dynamic twin of the
        # async-blocking lint rule.
        self.blocking_monitor = None

    def queue_depth(self) -> int:
        """Commands waiting for the consensus owner — the ingress plane's
        core-congestion tap (a persistently deep queue means intake is
        outrunning the single-owner pipeline)."""
        return self._queue.qsize()

    @property
    def queue_capacity(self) -> int:
        return CORE_QUEUE_SIZE

    @staticmethod
    def _default_fatal() -> None:
        import os
        import signal as _signal

        os.kill(os.getpid(), _signal.SIGTERM)

    def _on_owner_done(self, task: asyncio.Task) -> None:
        if self._stopped or task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            log.critical("consensus owner died: %r — invoking fatal handler",
                         exc)
            self.fatal_handler()

    def start(self) -> "CoreTaskDispatcher":
        self._task = asyncio.ensure_future(self._run())
        self._task.add_done_callback(self._on_owner_done)
        return self

    async def _run(self) -> None:
        # Every consensus mutation flows through here, so timing each command
        # gives the utilization breakdown the reference gets from its
        # UtilizationTimer instrumentation of the core thread
        # (core.rs/core_thread) — scrapeable as utilization_timer{proc=...}.
        timers = self.metrics.utilization_timer if self.metrics else None
        consecutive_failures = 0
        failed_kinds: Set[str] = set()
        dequeued = self.metrics.core_lock_dequeued if self.metrics else None
        # Wall-clock measurement is a host observation: under the
        # virtual-time loop it would read real elapsed time against
        # simulated schedules, so the detector stays off there (evaluated
        # once — the loop flavor cannot change mid-run).
        from .runtime import is_simulated
        from time import perf_counter

        measure_blocking = not is_simulated()
        while True:
            command, args, reply, internal = await self._queue.get()
            if dequeued is not None:
                dequeued.inc()
            try:
                label = getattr(command, "__name__", "other")
                monitor = self.blocking_monitor
                t0 = (
                    perf_counter()
                    if monitor is not None and measure_blocking
                    else 0.0
                )
                if timers is not None:
                    with timers(f"core:{label}"):
                        result = command(*args)
                else:
                    result = command(*args)
                if monitor is not None and measure_blocking:
                    monitor.note_command(
                        f"core:{label}", perf_counter() - t0
                    )
                consecutive_failures = 0
                failed_kinds.clear()
                if reply is not None and not reply.done():
                    reply.set_result(result)
            except Exception as e:  # propagate to the caller, keep the loop alive
                observed = reply is not None and not reply.done()
                if observed:
                    reply.set_exception(e)
                if observed and not internal:
                    # A live caller received (and handles) the exception:
                    # observed EXTERNAL failures are caller churn, not
                    # corruption — they never count toward the fail-stop
                    # halt.  Internal commands count regardless: a remote
                    # client cannot drive them, so their failures are
                    # trustworthy corruption evidence.
                    continue
                # Unobserved (caller cancelled mid-await) or internal: the
                # owner loop must survive a short run — dying on one would
                # wedge every future consensus command fleet-wide, turning
                # one connection teardown into a total liveness failure.
                consecutive_failures += 1
                failed_kinds.add(getattr(command, "__name__", repr(command)))
                log.exception(
                    "core command %s failed (%s)",
                    getattr(command, "__name__", command),
                    "internal" if internal else "no live caller",
                )
                if (
                    consecutive_failures >= self.MAX_CONSECUTIVE_FAILURES
                    and len(failed_kinds) > 1
                ):
                    # EVERY recent command failed: that is not a transient
                    # (a cancelled caller, one malformed batch) but a
                    # persistent fail-stop condition — WAL/state corruption,
                    # a poisoned store.  Running on, on possibly corrupt
                    # state, is the one thing a fail-stop consensus node
                    # must never do; crash loudly instead (ADVICE r4).
                    log.critical(
                        "%d consecutive core command failures — halting the "
                        "consensus owner (fail-stop)",
                        consecutive_failures,
                    )
                    raise

    async def _call(self, fn, *args, internal: bool = False):
        reply: asyncio.Future = asyncio.get_running_loop().create_future()
        if self.metrics is not None:
            self.metrics.core_lock_enqueued.inc()
        await self._queue.put((fn, args, reply, internal))
        return await reply

    # -- commands (core_thread/spawned.rs:26-46) --

    async def add_blocks(
        self, blocks: Sequence[StatementBlock], connected: AuthoritySet
    ) -> List[BlockReference]:
        return await self._call(self.syncer.add_blocks, list(blocks), connected)

    async def force_new_block(
        self, round_: RoundNumber, connected: AuthoritySet,
        genesis: bool = False,
    ) -> bool:
        # internal: driven by the leader-timeout task (or the boot-time
        # genesis kick, which must not be attributed as a leader timeout),
        # not a remote peer.
        return await self._call(
            self.syncer.force_new_block, round_, connected, genesis,
            internal=True,
        )

    async def cleanup(self) -> None:
        # internal: driven by the node's periodic task.  Routed through the
        # syncer so the observer's settled floor moves in the same owner
        # step as the store's GC (see Syncer.cleanup).
        return await self._call(self.syncer.cleanup, internal=True)

    async def apply_snapshot(self, manifest) -> bool:
        """Adopt a snapshot catch-up baseline (storage.py) on the owner —
        commit-chain state and the observer's linearizer move together."""
        return await self._call(self.syncer.apply_snapshot, manifest)

    async def get_missing(self) -> List[Set[BlockReference]]:
        # internal: driven by the synchronizer's periodic task.
        return await self._call(
            lambda: [set(s) for s in self.syncer.core.block_manager.missing_blocks()],
            internal=True,
        )

    async def processed(
        self, references: Sequence[BlockReference]
    ) -> List[bool]:
        """Which references are already stored/pending (dedup gate before the
        expensive signature verification, net_sync.rs:325-336)."""
        return await self._call(
            lambda: [
                self.syncer.core.block_manager.exists_or_pending(r)
                for r in references
            ]
        )

    def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()


class DataPlaneOffload:
    """Routes batched native data-plane calls off the event loop.

    The native batch helpers (block_digests, decode_block, the frame
    codecs) release the GIL around their heavy work — but calling them ON
    the event loop still serializes that work with consensus scheduling.
    This single-worker executor moves whole-frame decode+digest batches to
    a side thread, in front of the :class:`CoreTaskDispatcher` single-owner
    seam: the decoded blocks still cross the owner exactly as before (the
    ingest invariant), only the CPU burn moves off-loop.

    One worker, deliberately: batches stay ordered per submission site, and
    the GIL-holding portions (Python object construction) never contend
    with a second offload thread.  Stage wall time is observable two ways,
    mirroring verify_pipeline's stage gauges:
    ``utilization_timer{proc="offload:<stage>"}`` (busy µs, measured IN the
    worker thread so executor queue wait is excluded) and the
    ``dataplane_offload_seconds{stage}`` histogram.

    Determinism: ``active()`` is False under ``runtime.is_simulated()`` —
    seeded sims take the caller's inline path and stay byte-identical
    (thread handoff timing is not virtualizable).  It is also False without
    the native extension: the pure-Python fallback gains nothing from a
    thread hop (the GIL is held throughout), so ``MYSTICETI_NO_NATIVE=1``
    pins the fully-inline pure path.
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
            # Evaluated lazily on first use (inside the running loop, like
            # the dispatcher's measure_blocking): the loop flavor cannot
            # change mid-run.
            from .native import native as _native
            from .runtime import is_simulated

            self._active = _native is not None and not is_simulated()
        return self._active

    def should_offload(self, total_bytes: int) -> bool:
        return self.active() and total_bytes >= self.MIN_BATCH_BYTES

    def _ensure_executor(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            # The prefix feeds profiling.thread_class_of → "offload" in the
            # host-attribution thread taxonomy.
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
