"""Commit observers: consume committed leaders, produce ordered sub-dags.

The port's copy of ``mysticeti_tpu.commit_observer``.

Capability parity with ``mysticeti-core/src/commit_observer.rs``:

* ``CommitObserver`` interface {handle_commit, aggregator_state} (:23-32)
* ``TestCommitObserver`` (:42-198) — benchmark observer: linearizes commits,
  tallies committed transactions through a TransactionAggregator, records the
  benchmark-defining latency metrics (latency_s{shared}, latency_squared_s,
  benchmark_duration), tracks committed leaders.
* ``SimpleCommitObserver`` (:200-290) — production observer: forwards sub-dags
  to an application queue; on recovery re-sends commits above the consumer's
  ``last_sent_height``.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

from . import spans
from .block_store import BlockStore
from .committee import Committee, QUORUM, TransactionAggregator
from .consensus.linearizer import CommittedSubDag, Linearizer
from .runtime import now as runtime_now
from .state import CommitObserverRecoveredState
from .types import BlockReference, StatementBlock


def _trace_committed(tracer, t0: float, committed, authority) -> None:
    """Shared by both observers: one ``finalize`` span per sequenced sub-dag
    (anchored at its leader) and the close of every sequenced block's
    ``proposal_wait`` span (opened when the block entered the DAG)."""
    t1 = tracer.now()
    for commit in committed:
        tracer.record_span(
            "finalize", commit.anchor, t0, t1=t1, authority=authority
        )
        for block in commit.blocks:
            tracer.end_span(
                "proposal_wait", block.reference, authority=authority, t=t1
            )


class CommitObserver:
    # Flight recorder (flight_recorder.py), wired post-construction by the
    # node assembly: one "commit" edge per handle_commit batch — the block
    # lifecycle signal the incident ring keeps, at commit (not per-block)
    # granularity.
    recorder = None
    # Ingress plane (ingress.IngressPlane), wired post-construction like the
    # recorder: the committed sequence feeds gateway commit notifications
    # and the admission controller's progress signal.
    ingress = None

    def _record_committed(
        self, committed: List[CommittedSubDag], t_commit: Optional[float] = None
    ) -> None:
        if self.recorder is not None and committed:
            last = committed[-1]
            self.recorder.record(
                "commit",
                height=last.height,
                sub_dags=len(committed),
                anchor=spans.format_ref(last.anchor),
            )
        if self.ingress is not None and committed:
            # t_commit = the observer's entry time (the commit decision);
            # note_committed's own clock supplies the finalize time.
            self.ingress.note_committed(committed, t_commit=t_commit)

    def handle_commit(
        self, committed_leaders: List[StatementBlock]
    ) -> List[CommittedSubDag]:
        raise NotImplementedError

    def aggregator_state(self) -> bytes:
        raise NotImplementedError

    # -- storage lifecycle seams (storage.py; default: forward to the
    #    linearizer both concrete observers own) --

    def note_gc_round(self, gc_round: int) -> None:
        """The store's retired floor moved: references below it are settled
        and must stop the linearizer's DFS (they are no longer on disk)."""
        interpreter = getattr(self, "commit_interpreter", None)
        if interpreter is not None:
            interpreter.set_gc_round(gc_round)

    def adopt_snapshot(self, manifest) -> None:
        """Snapshot catch-up: adopt a remote commit baseline — the
        linearizer resumes sequencing at ``manifest.commit_height + 1``.
        The transaction aggregator is deliberately NOT transferred
        (application-level, per-node); commits below the baseline are
        outside this node's observation window."""
        interpreter = getattr(self, "commit_interpreter", None)
        if interpreter is not None:
            interpreter.adopt_snapshot(
                manifest.commit_height,
                manifest.committed_refs,
                manifest.gc_round,
            )
        votes = getattr(self, "transaction_votes", None)
        if votes is not None and hasattr(votes, "relax_below"):
            # The observer aggregator only learns shares when their block is
            # processed in a commit — and every commit at or below the
            # adopted height was skipped.  Those sub-dags reach up to the
            # adopted leader's round, so the leniency watermark must too
            # (the handler's stays at the lower GC floor: it handled every
            # RECEIVED block, which covers [floor, frontier]).
            watermark = manifest.gc_round
            if manifest.last_committed_leader is not None:
                watermark = max(watermark, manifest.last_committed_leader.round)
            votes.relax_below(watermark)


class TestCommitObserver(CommitObserver):
    """Benchmark/test observer (commit_observer.rs:42-198)."""

    __test__ = False  # not a pytest class

    def __init__(
        self,
        block_store: BlockStore,
        committee: Committee,
        # Interface parity with commit_observer.rs (which computes shared-tx
        # latency from this map); HERE latency comes from the 8-byte
        # timestamp the generator embeds in each transaction, so the map —
        # keyed per own proposal block since round 4 — is accepted but
        # never read.
        transaction_time: Optional[Dict[BlockReference, float]] = None,
        metrics=None,
        handler=None,
        recovered_state: Optional[CommitObserverRecoveredState] = None,
    ) -> None:
        self.commit_interpreter = Linearizer(block_store)
        self.transaction_votes = handler or TransactionAggregator(QUORUM)
        self.committee = committee
        self.committed_leaders: List[BlockReference] = []
        # Measurement window opens at the FIRST committed benchmark tx, not at
        # node boot: tps = count / benchmark_duration must not be diluted by
        # warmup (kernel builds, INITIAL_DELAY) that precedes any load.  The
        # reference gets the same effect by scraping duration from the load
        # client rather than the node (protocol/mod.rs:57-67).
        self._bench_t0: float | None = None
        self.transaction_time = transaction_time if transaction_time is not None else {}
        self.metrics = metrics
        self.consensus_only = "CONSENSUS_ONLY" in os.environ
        if recovered_state is not None:
            self._recover_committed(recovered_state)

    def _recover_committed(self, recovered: CommitObserverRecoveredState) -> None:
        if recovered.state is not None:
            self.transaction_votes.with_state(
                recovered.state,
                self.commit_interpreter.block_store.highest_round(),
            )
        else:
            assert not recovered.sub_dags
        self.commit_interpreter.recover_state(recovered)

    def handle_commit(self, committed_leaders):
        # transaction_time stamps (shared with the block handler) are on the
        # runtime clock (monotonic in production, virtual under the
        # simulator), same-process: certificate intervals read the same
        # source.  Generator-embedded stamps are wall-clock by design
        # (cross-process) and are read with time.time() at the batch-metrics
        # call below.
        now = runtime_now()
        tracer = spans.active()
        committed = self.commit_interpreter.handle_commit(committed_leaders)
        stamps: List[bytes] = []
        for commit in committed:
            self.committed_leaders.append(commit.anchor)
            for block in commit.blocks:
                if not self.consensus_only:
                    certified = self.transaction_votes.process_block(
                        block, None, self.committee
                    )
                    if certified and self.metrics is not None:
                        # Certificates completing during commit processing
                        # (metrics.rs:59 certificate_committed_latency):
                        # one sample per range, stamped at proposal.
                        channel = self.metrics.certificate_committed_latency
                        for rng in certified:
                            created = self.transaction_time.get(rng.block)
                            if created is not None:
                                channel.observe(max(0.0, now - created))
                if self.metrics is not None:
                    stamps.append(block.shared_transaction_stamps())
        if committed and self.metrics is not None:
            # meta_creation_time_ns is stamped with runtime.timestamp_utc()
            # (virtual time under the simulator) — the comparison clock must
            # be the same source, NOT wall time.
            from .runtime import timestamp_utc

            now_utc = timestamp_utc()
            self.metrics.commit_round.set(committed[-1].anchor.round)
            self.metrics.sub_dags_per_commit_count.observe(len(committed))
            for commit in committed:
                self.metrics.committed_leaders_total.labels(
                    str(commit.anchor.authority), "committed"
                ).inc()
                self.metrics.blocks_per_commit_count.observe(len(commit.blocks))
                for block in commit.blocks:
                    created = block.meta_creation_time_ns
                    if created:
                        self.metrics.block_commit_latency.observe(
                            max(0.0, now_utc - created / 1e9)
                        )
        heads = b"".join(stamps)
        if heads:
            # Wall clock on purpose: the generator's embedded submission
            # stamps are wall-clock floats shared across processes.
            self._update_metrics_batch(heads, time.time())
        if tracer is not None:
            _trace_committed(
                tracer,
                now,
                committed,
                self.commit_interpreter.block_store.authority,
            )
        self._record_committed(committed, t_commit=now)
        return committed

    def _update_metrics_batch(self, heads: bytes, now: float) -> None:
        """Benchmark metrics (commit_observer.rs:104-140): latency measured
        from the 8-byte float64 submission timestamp the generator prefixes
        to each tx.  ``heads`` is the pre-concatenated stamp bytes
        (``shared_transaction_stamps``); everything from here is one
        vectorized pass — per-transaction Python objects dominated the
        engine profile at load, twice (prometheus observes; then locator
        construction + double iteration)."""
        import numpy as np

        # Loop clock, not the wall: virtual under the simulator, so the
        # benchmark-duration counter advances deterministically in a seeded
        # sim instead of absorbing host scheduling.
        if self._bench_t0 is None:
            self._bench_t0 = runtime_now()
        elapsed = runtime_now() - self._bench_t0
        delta = int(elapsed) - int(self.metrics.benchmark_duration._value.get())
        if delta > 0:
            self.metrics.benchmark_duration.inc(delta)
        ts = np.frombuffer(heads, "<f8")
        latencies = np.maximum(0.0, now - ts)
        latencies[ts == 0.0] = 0.0  # unstamped txs count as zero latency
        self.metrics.observe_latency_batch("shared", latencies)
        self.metrics.transaction_committed_latency.observe_many(latencies)

    def aggregator_state(self) -> bytes:
        return self.transaction_votes.state()


class SimpleCommitObserver(CommitObserver):
    """Production observer: forward sub-dags to the application
    (commit_observer.rs:200-290)."""

    def __init__(
        self,
        block_store: BlockStore,
        sender: Callable[[CommittedSubDag], None],
        last_sent_height: int = 0,
        recovered_state: Optional[CommitObserverRecoveredState] = None,
        metrics=None,
    ) -> None:
        self.block_store = block_store
        self.commit_interpreter = Linearizer(block_store)
        self.sender = sender
        self.metrics = metrics
        if recovered_state is not None:
            self._recover_committed(last_sent_height, recovered_state)

    def _recover_committed(
        self, last_sent_height: int, recovered: CommitObserverRecoveredState
    ) -> None:
        self.commit_interpreter.recover_state(recovered)
        for commit_data in recovered.sub_dags:
            if commit_data.height > last_sent_height:
                self.sender(
                    CommittedSubDag.new_from_commit_data(commit_data, self.block_store)
                )

    def handle_commit(self, committed_leaders):
        tracer = spans.active()
        now = runtime_now()
        t0 = tracer.now() if tracer is not None else 0.0
        committed = self.commit_interpreter.handle_commit(committed_leaders)
        for commit in committed:
            self.sender(commit)
        if tracer is not None:
            _trace_committed(tracer, t0, committed, self.block_store.authority)
        self._record_committed(committed, t_commit=now)
        return committed

    def aggregator_state(self) -> bytes:
        return b""
