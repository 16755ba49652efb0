"""Syncer: drives the Core on block arrival and leader timeouts, emits signals.

The port's copy of ``mysticeti_tpu.syncer``.

Capability parity with ``mysticeti-core/src/syncer.rs``:

* ``Signals`` {new_block_ready, new_round} (:24-52) — wake the dissemination
  streams / reset the leader-timeout clock.
* ``Syncer.add_blocks`` (:72-93) — feed core, signal round advance, maybe propose.
* ``Syncer.force_new_block`` (:95-108) — leader-timeout path, bypasses the
  ready gate.
* ``try_new_block`` (:110-167) — ready-gate -> propose -> signal -> commit ->
  observer -> persist commit + aggregator state.
"""
from __future__ import annotations

from typing import List, Sequence

from . import spans
from .commit_observer import CommitObserver
from .core import Core
from .tracing import logger
from .types import AuthoritySet, BlockReference, RoundNumber, StatementBlock

log = logger(__name__)


class SyncerSignals:
    """Interface; the asyncio node wires these to Event/condition primitives."""

    def new_block_ready(self) -> None:
        pass

    def new_round(self, round_: RoundNumber) -> None:
        pass


class Syncer:
    def __init__(
        self,
        core: Core,
        commit_period: int,
        signals: SyncerSignals,
        commit_observer: CommitObserver,
        metrics=None,
    ) -> None:
        self.core = core
        self.force_new_block_flag = False
        self.commit_period = commit_period
        self.signals = signals
        self.commit_observer = commit_observer
        self.metrics = metrics

    def add_blocks(
        self, blocks: Sequence[StatementBlock], connected_authorities: AuthoritySet
    ) -> List[BlockReference]:
        previous_round = self.core.current_round()
        missing_references = self.core.add_blocks(blocks)
        new_round = self.core.current_round()
        if new_round > previous_round:
            self.signals.new_round(new_round)
            if self.metrics is not None:
                self.metrics.threshold_clock_round.set(new_round)
        self.try_new_block(connected_authorities)
        return missing_references

    def force_new_block(
        self, round_: RoundNumber, connected_authorities: AuthoritySet,
        genesis: bool = False,
    ) -> bool:
        if self.core.last_proposed() < round_:
            if self.metrics is not None:
                self.metrics.leader_timeout_total.inc()
                if not genesis:
                    # Attribute the stall: the timeout fired because the
                    # leader(s) of the round being abandoned never showed —
                    # counted per authority so fleet health can name the
                    # validator whose slots keep timing out.  The boot-time
                    # genesis kick reaches here too and indicts nobody.
                    for leader in self.core.leaders(max(1, round_ - 1)):
                        channel = (
                            self.metrics.mysticeti_health_leader_timeout_total
                        )
                        channel.labels(str(leader)).inc()
            self.force_new_block_flag = True
            self.try_new_block(connected_authorities)
            return True
        return False

    def cleanup(self) -> None:
        """Periodic maintenance on the consensus owner: the core's cache
        eviction (the JAX package's GC floor comes with its storage
        lifecycle, not in the port yet)."""
        self.core.cleanup()

    def try_new_block(self, connected_authorities: AuthoritySet) -> None:
        if self.force_new_block_flag or self.core.ready_new_block(
            self.commit_period, connected_authorities
        ):
            if self.core.try_new_block() is None:
                return
            self.signals.new_block_ready()
            self.force_new_block_flag = False

            if self.core.epoch_closed():
                return  # no commits needed once the epoch is safe to close

            tracer = spans.active()
            t_commit = tracer.now() if tracer is not None else 0.0
            while True:
                newly_committed = self.core.try_commit()
                if newly_committed:
                    log.debug(
                        "committed %d leaders up to round %d",
                        len(newly_committed),
                        max(b.round() for b in newly_committed),
                    )
                committed_subdags = self.commit_observer.handle_commit(
                    newly_committed
                )
                self.core.handle_committed_subdag(
                    committed_subdags, self.commit_observer.aggregator_state()
                )
                if tracer is not None:
                    # One span per decided leader: decision + observer +
                    # commit/state persistence.
                    for block in newly_committed:
                        tracer.record_span(
                            "commit", block.reference, t_commit,
                            authority=self.core.authority,
                        )
                # Reconfiguration makes try_commit slot-sequential (one
                # decided leader per pass, so an epoch switch lands between
                # slots); drain the remaining decidable slots here.  With
                # the knob off a pass decides everything at once and this
                # loop runs exactly once — the seed behavior.
                if self.core.reconfig is None or not newly_committed:
                    break
