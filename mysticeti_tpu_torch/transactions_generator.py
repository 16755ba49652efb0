"""Open-loop benchmark transaction generator, with overload modes.

The port's copy of ``mysticeti_tpu.transactions_generator``.

Capability parity with ``mysticeti-core/src/transactions_generator.rs``:

* seeded RNG, fixed transaction size (default 512 B), target tx/s (:29-45)
* 100 ms ticks producing evenly-sized batches, submitted to the block handler
  (:47-101)
* each transaction is prefixed with an 8-byte submission timestamp + 8-byte
  nonce; ``extract_timestamp`` recovers it for end-to-end latency metrics
  (:103-108)

Ingress-plane additions (the OVERLOAD artifact's load clients):

* **overload schedule** — ``overload_schedule=[(t_offset_s, multiplier),...]``
  scales the offered rate over the run (1x -> 5x ramps), so one generator can
  drive a saturation sweep without restarts.
* **closed loop** — ``closed_loop=True`` consumes the typed
  :class:`~mysticeti_tpu_torch.ingress.SubmitResult` the ingress plane returns
  from ``submit``: on SHED the generator honors ``retry_after_ms`` before
  submitting again and re-offers the shed tail from a bounded retry queue
  (overflow is counted on ``client_drops``, never silent).  Legacy handlers
  returning ``None`` keep the pure open-loop behavior.

Clocks are the RUNTIME clock (``runtime.timestamp_utc`` for the embedded
stamps, the loop clock for pacing): identical to wall time in production,
virtual under the deterministic simulator — which is what makes the seeded
overload sim's offered load and shed schedule byte-identical across runs.
"""
from __future__ import annotations

import asyncio
import random
import struct
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple

from .runtime import now as runtime_now, timestamp_utc

TRANSACTION_SIZE_DEFAULT = 512
TICK_S = 0.1

# Closed loop: retry-queue bound in ticks of offered load; beyond it the
# client itself drops (and counts) — a shed backlog must not grow without
# limit on the client either.
RETRY_QUEUE_TICKS = 10


def parse_overload_schedule(text: str) -> List[Tuple[float, float]]:
    """Parse ``"0:1,30:3,60:5"`` (``t_offset_s:multiplier`` pairs) — the
    ``MYSTICETI_OVERLOAD_SCHEDULE`` env format the node CLI accepts."""
    schedule: List[Tuple[float, float]] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        t, _, mult = part.partition(":")
        schedule.append((float(t), float(mult)))
    return sorted(schedule)


class TransactionGenerator:
    def __init__(
        self,
        submit: Callable[[List[bytes]], object],
        seed: int,
        tps: int,
        transaction_size: int = TRANSACTION_SIZE_DEFAULT,
        initial_delay_s: float = 0.0,
        ready: Optional[Callable[[], bool]] = None,
        overload_schedule: Optional[Sequence[Tuple[float, float]]] = None,
        closed_loop: bool = False,
        finality_sample_every: int = 0,
        metrics=None,
    ) -> None:
        assert transaction_size >= 16, "needs room for timestamp + nonce"
        self.submit = submit
        self.rng = random.Random(seed)
        self.tps = tps
        self.transaction_size = transaction_size
        self.initial_delay_s = initial_delay_s
        self.ready = ready
        self.overload_schedule = sorted(overload_schedule or [])
        self.closed_loop = closed_loop
        self.metrics = metrics
        self._task: Optional[asyncio.Task] = None
        # Offered-load accounting (the OVERLOAD artifact's client ledger).
        self.submitted = 0
        self.accepted = 0
        self.shed_observed = 0
        self.retries = 0
        self.client_drops = 0
        self._retry_queue: Deque[bytes] = deque()
        self._hold_until = 0.0
        # CLIENT-observed finality (finality.py): sampled submit stamps
        # closed when commit notifications echo the ingress keys back.
        # Same content-based sampling stride as the server tracker, so
        # both sides measure the same transactions.  Loop-thread only.
        self.finality = None
        if finality_sample_every > 0:
            from .finality import ClientFinalityRecorder

            self.finality = ClientFinalityRecorder(
                sample_every=finality_sample_every
            )

    def make_batch(self, count: int) -> List[bytes]:
        now = timestamp_utc()
        ts = struct.pack("<d", now)
        pad = b"\x00" * (self.transaction_size - 16)
        return [
            ts + struct.pack("<Q", self.rng.getrandbits(64)) + pad
            for _ in range(count)
        ]

    @staticmethod
    def extract_timestamp(transaction: bytes) -> float:
        """First 8 bytes = float64 submission time (transactions_generator.rs:103-108)."""
        if len(transaction) < 8:
            return 0.0
        return struct.unpack("<d", transaction[:8])[0]

    def multiplier(self, elapsed_s: float) -> float:
        """Offered-load multiplier at ``elapsed_s`` into the run: the last
        schedule entry whose offset has passed (1.0 before the first)."""
        current = 1.0
        for t, mult in self.overload_schedule:
            if elapsed_s >= t:
                current = mult
            else:
                break
        return current

    def stats(self) -> dict:
        out = {
            "submitted": self.submitted,
            "accepted": self.accepted,
            "shed_observed": self.shed_observed,
            "retries": self.retries,
            "client_drops": self.client_drops,
            "retry_queue": len(self._retry_queue),
        }
        if self.finality is not None:
            p = self.finality.percentiles()
            out["client_finality_p50_s"] = round(p["p50_s"], 6)
            out["client_finality_p99_s"] = round(p["p99_s"], 6)
            out["client_finality_samples"] = p["samples"]
        return out

    def note_commit_notification(self, keys, info=None) -> None:
        """Commit-notification feed (an ingress-plane sink or the gateway
        subscription stream): close client-observed finality for sampled
        keys this client submitted.  ``info`` (leader round, commit
        timestamp) is accepted for sink-signature compatibility."""
        if self.finality is None:
            return
        self.finality.note_finalized(keys)
        if self.metrics is not None:
            p = self.finality.percentiles()
            self.metrics.mysticeti_client_finality_p50_seconds.set(p["p50_s"])
            self.metrics.mysticeti_client_finality_p99_seconds.set(p["p99_s"])

    def start(self) -> asyncio.Task:
        self._task = asyncio.get_event_loop().create_task(self._run())
        return self._task

    def _offer(self, batch: List[bytes]) -> None:
        """One submission, honoring the closed-loop contract when armed."""
        if self.finality is not None:
            from .ingress import ingress_key

            for tx in batch:
                # note_submitted keeps the FIRST stamp on retries, so the
                # sample covers the whole client-experienced wait.
                self.finality.note_submitted(ingress_key(tx))
        result = self.submit(batch)
        self.submitted += len(batch)
        if self.metrics is not None:
            self.metrics.mysticeti_client_submitted_total.inc(len(batch))
        if result is None or not self.closed_loop:
            # Open loop (or a legacy handler with no verdict): fire and
            # forget, exactly the pre-ingress behavior.
            if result is not None:
                self.accepted += getattr(result, "accepted", len(batch))
                self.shed_observed += getattr(result, "shed", 0)
            return
        accepted = getattr(result, "accepted", len(batch))
        shed = getattr(result, "shed", 0)
        self.accepted += accepted
        self.shed_observed += shed
        if shed:
            retry_ms = getattr(result, "retry_after_ms", 0)
            self._hold_until = runtime_now() + max(retry_ms, 1) / 1000.0
            # The plane admits a PREFIX and sheds the tail (admission funds
            # in order; lane/pool caps reject in order), so the shed tail is
            # the batch's last `shed` transactions.  Duplicates are not
            # worth re-offering, but they cannot appear here: this client
            # never re-generates a nonce, and retried txs that were ADMITTED
            # are not in the tail.
            tail = batch[len(batch) - shed:]
            room = RETRY_QUEUE_TICKS * max(1, int(self.tps * TICK_S)) - len(
                self._retry_queue
            )
            if room < len(tail):
                self.client_drops += len(tail) - max(0, room)
                tail = tail[: max(0, room)]
            self._retry_queue.extend(tail)

    async def _run(self) -> None:
        # Offered load is pointless against a node that cannot process it yet:
        # wait for the verifier's one-time warmup (JAX trace/compile, possibly
        # minutes when several processes share a host) before the clock-driven
        # initial delay, so submission timestamps measure steady state and not
        # a warmup backlog.
        if self.ready is not None:
            while not self.ready():
                await asyncio.sleep(0.5)
        if self.initial_delay_s:
            await asyncio.sleep(self.initial_delay_s)
        start = runtime_now()
        while True:
            tick_started = runtime_now()
            per_tick = max(
                1, int(self.tps * self.multiplier(tick_started - start) * TICK_S)
            )
            if self.closed_loop and tick_started < self._hold_until:
                # Shed backoff: generate nothing new this tick (the retry
                # queue holds what the plane told us to re-offer later).
                pass
            else:
                batch: List[bytes] = []
                if self._retry_queue:
                    n_retry = min(len(self._retry_queue), per_tick)
                    batch.extend(
                        self._retry_queue.popleft() for _ in range(n_retry)
                    )
                    self.retries += n_retry
                batch.extend(self.make_batch(per_tick - len(batch)))
                self._offer(batch)
            elapsed = runtime_now() - tick_started
            await asyncio.sleep(max(0.0, TICK_S - elapsed))

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
