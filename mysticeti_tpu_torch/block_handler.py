"""Pluggable application handlers driven by the core on block arrival/proposal.

The port's copy of ``mysticeti_tpu.block_handler``.

Capability parity with ``mysticeti-core/src/block_handler.rs``:

* ``BlockHandler`` interface {handle_blocks, handle_proposal, state, recover_state,
  cleanup} (block_handler.rs:26-40)
* ``BenchmarkFastPathBlockHandler`` (:53-221) — pulls generated transactions from a
  queue (bounded by SOFT_MAX_PROPOSED_PER_BLOCK), registers own shares, tallies
  fast-path votes via TransactionAggregator, emits VoteRange replies, records
  certification latency metrics.
* ``TestBlockHandler`` (:224-333) — votes immediately and emits one fresh
  transaction per invocation; tracks proposed locators for test assertions.
* ``SimpleBlockHandler`` (:335-395) — production-style: shares raw tx bytes pushed
  by the application, acknowledging each via callback.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from .committee import Committee, QUORUM, TransactionAggregator
from .log import TransactionLog
from .runtime import now as runtime_now
from .serde import Reader, Writer
from .types import (
    AuthorityIndex,
    BaseStatement,
    BlockReference,
    Share,
    StatementBlock,
    TransactionLocator,
)

MAX_PROPOSED_PER_BLOCK = 10000


def _soft_max_from_env() -> int:
    raw = os.environ.get("MYSTICETI_MAX_BLOCK_TX")
    if raw is None:
        return MAX_PROPOSED_PER_BLOCK
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"MYSTICETI_MAX_BLOCK_TX must be an integer, got {raw!r}"
        ) from None
    if not 1 <= value <= MAX_PROPOSED_PER_BLOCK:
        raise ValueError(
            f"MYSTICETI_MAX_BLOCK_TX={value} out of range [1,"
            f" {MAX_PROPOSED_PER_BLOCK}] (the block_handler.rs SOFT_MAX regime"
            " caps proposals at the hard per-block maximum)"
        )
    return value


# Proposal drain cap (block_handler.rs SOFT_MAX equivalent).  Env-tunable:
# shrinking it raises the block rate at a given load, which reproduces the
# per-node block-arrival (and therefore signature-verification) rate of a
# large WAN committee on a small local fleet — the verification-bound regime
# of BASELINE configs #4/#5.
SOFT_MAX_PROPOSED_PER_BLOCK = _soft_max_from_env()


class BlockHandler:
    """Interface only; see module docstring."""

    def handle_blocks(
        self, blocks: Sequence[StatementBlock], require_response: bool
    ) -> List[BaseStatement]:
        raise NotImplementedError

    def handle_proposal(self, block: StatementBlock) -> None:
        raise NotImplementedError

    def state(self) -> bytes:
        raise NotImplementedError

    def recover_state(self, state: bytes, watermark_round=None) -> None:
        """``watermark_round`` bounds the Byzantine-oracle leniency after
        recovery (TransactionAggregator.with_state): pass the highest round
        durably replayed alongside the snapshot."""
        raise NotImplementedError

    def cleanup(self) -> None:
        pass


class _LoggingAggregator(TransactionAggregator):
    """TransactionAggregator whose processed-hook appends to a TransactionLog
    (committee.rs:297-312 handler seam with the log.rs sink).

    Duplicate/unknown observations count on
    ``mysticeti_transaction_dedup_total{kind}`` — previously they were log
    lines (or a raise) only, so a fleet absorbing duplicate floods was
    indistinguishable from one that never saw them."""

    def __init__(
        self, log: Optional[TransactionLog], metrics=None
    ) -> None:
        super().__init__(QUORUM, track_processed=log is None)
        self._log = log
        self._metrics = metrics

    def _count_dedup(self, kind: str) -> None:
        if self._metrics is not None:
            self._metrics.mysticeti_transaction_dedup_total.labels(kind).inc()

    def transaction_processed(self, k: TransactionLocator) -> None:
        if self._log is not None:
            self._log.log(k)
        else:
            super().transaction_processed(k)

    def transaction_processed_range(self, block, start: int, end: int) -> None:
        if self._log is not None:
            self._log.log_range(block, start, end)
        else:
            super().transaction_processed_range(block, start, end)

    def duplicate_transaction(self, k, from_) -> None:
        self._count_dedup("duplicate")
        if self._log is None:
            super().duplicate_transaction(k, from_)

    def unknown_transaction(self, k, from_) -> None:
        self._count_dedup("unknown")
        if self._log is None:
            super().unknown_transaction(k, from_)


class BenchmarkFastPathBlockHandler(BlockHandler):
    """The benchmark fast path (block_handler.rs:53-221).

    Transactions arrive from the generator through ``submit``; ``handle_blocks``
    drains them (bounded) into Share statements and tallies votes; certification
    latency is recorded against ``transaction_time`` stamps made at proposal.
    """

    def __init__(
        self,
        committee: Committee,
        authority: AuthorityIndex,
        certified_log_path: Optional[str] = None,
        block_store=None,
        metrics=None,
        transaction_time: Optional[Dict[BlockReference, float]] = None,
        ingress=None,
    ) -> None:
        log = TransactionLog.start(certified_log_path) if certified_log_path else None
        self.transaction_votes = _LoggingAggregator(log, metrics=metrics)
        # Keyed per OWN proposal block: all shares of a block are drained
        # at one moment, so one stamp covers the whole run.
        self.transaction_time: Dict[BlockReference, float] = (
            transaction_time if transaction_time is not None else {}
        )
        self._time_lock = threading.Lock()
        self.committee = committee
        self.authority = authority
        self.block_store = block_store
        self.metrics = metrics
        self._queue: Deque[List[bytes]] = deque()
        self._queue_lock = threading.Lock()
        # Legacy-path deferral accounting: length of the already-counted
        # deferred remainder sitting at the FRONT of the queue (appendleft
        # puts it there), so a batch re-truncated across several proposals
        # counts each transaction's deferral once, not once per proposal.
        self._deferred_counted = 0
        self.pending_transactions = 0
        self.consensus_only = "CONSENSUS_ONLY" in os.environ
        # Ingress plane (ingress.IngressPlane): when wired, submissions run
        # through the admission-controlled mempool (dedup, fairness lanes,
        # typed shedding) and proposals drain weighted-round-robin from it.
        # None = the legacy unbounded direct queue.
        self.ingress = ingress

    # -- ingestion from the generator / gateway --

    def submit(self, transactions: List[bytes]):
        """Submit transactions for proposal.  With an ingress plane wired,
        returns its typed :class:`~mysticeti_tpu_torch.ingress.SubmitResult`
        (ACK/QUEUED/SHED) — closed-loop clients consume it; legacy callers
        may ignore the return value (the pre-ingress contract returned
        None)."""
        if self.ingress is not None:
            return self.ingress.submit("local", transactions)
        with self._queue_lock:
            self._queue.append(transactions)
        return None

    def _proposal_budget(self) -> int:
        cap = SOFT_MAX_PROPOSED_PER_BLOCK
        if self.ingress is not None and self.ingress.max_per_proposal:
            cap = min(
                max(1, self.ingress.max_per_proposal), MAX_PROPOSED_PER_BLOCK
            )
        return cap - self.pending_transactions

    def _receive_with_limit(self) -> Optional[List[bytes]]:
        """Drain up to the SOFT_MAX budget, SLICING oversize submissions: the
        generator submits 100 ms chunks (tps/10 transactions each), and
        admitting a whole chunk because the budget had one slot left would
        let every block overshoot the cap by the chunk size — turning the
        block_handler.rs SOFT_MAX semantics (a per-block transaction cap)
        into a no-op whenever tps/10 > SOFT_MAX.  The unconsumed remainder
        stays queued for the next proposal — visible on
        ``mysticeti_ingress_shed_total{soft_cap_deferred}`` (deferred, not
        lost; previously this truncation was silent)."""
        budget = self._proposal_budget()
        if budget <= 0:
            return None
        if self.ingress is not None:
            received = self.ingress.drain(budget)
            if not received:
                return None
            self.pending_transactions += len(received)
            return received
        with self._queue_lock:
            if not self._queue:
                return None
            received = self._queue.popleft()
            already_counted = self._deferred_counted
            self._deferred_counted = 0
            if len(received) > budget:
                remainder = len(received) - budget
                self._queue.appendleft(received[budget:])
                # Only transactions ENTERING deferral count: the front batch
                # may itself be a previously-deferred (and counted)
                # remainder, and re-counting it every proposal would inflate
                # the series past the number of offered transactions.
                newly = remainder - max(0, already_counted - budget)
                self._deferred_counted = remainder
                if newly > 0 and self.metrics is not None:
                    self.metrics.mysticeti_ingress_shed_total.labels(
                        "soft_cap_deferred"
                    ).inc(newly)
                received = received[:budget]
        self.pending_transactions += len(received)
        return received

    # -- BlockHandler --

    def handle_blocks(self, blocks, require_response):
        response: List[BaseStatement] = []
        if require_response:
            while (received := self._receive_with_limit()) is not None:
                response.extend(Share(tx) for tx in received)
        # transaction_time stamps are local to this process (own proposals),
        # so certify latency is an interval on the runtime clock — monotonic
        # in production (an NTP step must not dent the latency channels) and
        # virtual under the DeterministicLoop simulator.
        now = runtime_now()
        for block in blocks:
            if self.consensus_only:
                continue
            processed = self.transaction_votes.process_block(
                block, response if require_response else None, self.committee
            )
            if self.metrics is not None and processed:
                # Certification arrives as ranges; every offset of a run was
                # proposed together so they share ONE submission timestamp
                # (transaction_time is keyed per own block).
                import numpy as np

                lat_values, lat_counts = [], []
                with self._time_lock:
                    for rng in processed:
                        created = self.transaction_time.get(rng.block)
                        if created is None:
                            continue
                        lat_values.append(max(0.0, now - created))
                        lat_counts.append(
                            rng.offset_end_exclusive
                            - rng.offset_start_inclusive
                        )
                if lat_values:
                    self.metrics.observe_latency_batch(
                        "owned", np.repeat(lat_values, lat_counts)
                    )
                    # Exact-percentile channel (metrics.rs:60): one sample
                    # per certified RANGE (all offsets of a run share one
                    # submission stamp) — bounds the cost at load; the
                    # per-tx-weighted distribution lives in latency_s{owned}.
                    certified = self.metrics.transaction_certified_latency
                    for v in lat_values:
                        certified.observe(v)
        if self.metrics is not None:
            self.metrics.block_handler_pending_certificates.set(
                len(self.transaction_votes)
            )
        return response

    def handle_proposal(self, block: StatementBlock) -> None:
        n_shared = sum(
            1 for st in block.statements if isinstance(st, Share)
        )
        self.pending_transactions -= n_shared
        if n_shared:
            # One stamp per OWN proposal: every share of the block was
            # drained at the same moment, so per-transaction stamps (a dict
            # entry per tx) carried no information — only cost.  Runtime
            # clock: every reader measures an interval in this same process.
            with self._time_lock:
                self.transaction_time[block.reference] = runtime_now()
        if not self.consensus_only:
            from .committee import shared_ranges

            for rng in shared_ranges(block):
                self.transaction_votes.register(rng, self.authority, self.committee)

    def state(self) -> bytes:
        return self.transaction_votes.state()

    def recover_state(self, state: bytes, watermark_round=None) -> None:
        self.transaction_votes.with_state(state, watermark_round)

    # Stamps are per OWN PROPOSAL BLOCK (not per tx), so residency is cheap
    # (~blocks/s * window entries).  The window must comfortably exceed the
    # worst-case certify/commit latency the metrics can express (buckets run
    # to 90 s): a shorter window silently censors exactly the slow samples
    # the latency channels exist to expose — degraded runs would read
    # healthy.
    TRANSACTION_TIME_RETENTION_S = 120.0

    def cleanup(self) -> None:
        cutoff = runtime_now() - self.TRANSACTION_TIME_RETENTION_S
        with self._time_lock:
            # Mutate IN PLACE: the commit observer shares this dict
            # (validator.py wires handler.transaction_time into
            # TestCommitObserver) — rebinding would freeze the observer on
            # the pre-cleanup object and silence its latency channels.
            stale = [
                k for k, v in self.transaction_time.items() if v < cutoff
            ]
            for k in stale:
                del self.transaction_time[k]


class TestBlockHandler(BlockHandler):
    """Immediately votes and generates one new transaction per call
    (block_handler.rs:224-333)."""

    __test__ = False  # not a pytest class

    def __init__(
        self,
        last_transaction: int,
        committee: Committee,
        authority: AuthorityIndex,
        metrics=None,
    ) -> None:
        self.last_transaction = last_transaction
        self.transaction_votes = TransactionAggregator(QUORUM)
        self.committee = committee
        self.authority = authority
        self.proposed: List[TransactionLocator] = []
        self.metrics = metrics
        # Out-of-band payloads (e.g. reconfig committee-change transactions,
        # reconfig.py) planted by a harness; drained ahead of the generated
        # counter transaction on the next proposal.
        self.pending_inject: Deque[bytes] = deque()

    def inject(self, payload: bytes) -> None:
        """Queue an arbitrary transaction payload for the next own proposal."""
        self.pending_inject.append(payload)

    def is_certified(self, locator: TransactionLocator) -> bool:
        return self.transaction_votes.is_processed(locator)

    @staticmethod
    def make_transaction(i: int) -> bytes:
        return i.to_bytes(8, "little")

    def handle_blocks(self, blocks, require_response):
        response: List[BaseStatement] = []
        if require_response:
            for block in blocks:
                if block.author() == self.authority:
                    # Own blocks can resurface during recovery; keep the
                    # transaction counter monotone (block_handler.rs:268-281).
                    for st in block.statements:
                        if isinstance(st, Share):
                            self.last_transaction += 1
            while self.pending_inject:
                response.append(Share(self.pending_inject.popleft()))
            self.last_transaction += 1
            response.append(Share(self.make_transaction(self.last_transaction)))
        for block in blocks:
            self.transaction_votes.process_block(
                block, response if require_response else None, self.committee
            )
        return response

    def handle_proposal(self, block: StatementBlock) -> None:
        from .committee import shared_ranges

        for locator, _ in block.shared_transactions():
            self.proposed.append(locator)
        for rng in shared_ranges(block):
            self.transaction_votes.register(rng, self.authority, self.committee)

    def state(self) -> bytes:
        w = Writer()
        w.bytes(self.transaction_votes.state())
        w.u64(self.last_transaction)
        return w.finish()

    def recover_state(self, state: bytes, watermark_round=None) -> None:
        r = Reader(state)
        self.transaction_votes.with_state(r.bytes(), watermark_round)
        self.last_transaction = r.u64()
        r.expect_done()


class SimpleBlockHandler(BlockHandler):
    """Production-style: share raw transaction bytes pushed by the application;
    acknowledge each once drained into a proposal (block_handler.rs:335-395)."""

    def __init__(self) -> None:
        self._queue: Deque[Tuple[bytes, Optional[Callable[[], None]]]] = deque()
        self._lock = threading.Lock()

    def submit(self, tx_bytes: bytes, done: Optional[Callable[[], None]] = None) -> None:
        with self._lock:
            self._queue.append((tx_bytes, done))

    def handle_blocks(self, blocks, require_response):
        if not require_response:
            return []
        response: List[BaseStatement] = []
        while len(response) < MAX_PROPOSED_PER_BLOCK:
            with self._lock:
                if not self._queue:
                    break
                tx_bytes, done = self._queue.popleft()
            response.append(Share(tx_bytes))
            if done is not None:
                done()
        return response

    def handle_proposal(self, block: StatementBlock) -> None:
        pass

    def state(self) -> bytes:
        return b""

    def recover_state(self, state: bytes, watermark_round=None) -> None:
        pass
