"""Composition of base committers: multi-leader x pipelining, longest-decided-prefix.

The port's copy of ``mysticeti_tpu.consensus.universal_committer``.

Capability parity with ``mysticeti-core/src/consensus/universal_committer.rs``:

* ``try_commit`` (:30-90) — scan rounds from high to low across all committers
  (reverse order), direct rule first, fall back to the indirect rule with the
  already-decided higher-round sequence; return the longest decided prefix in
  increasing round order, stopping at the first undecided leader.
* ``get_leaders`` (:95-101) — all leaders for a round (syncer proposal gating).
* ``UniversalCommitterBuilder`` (:125-184) — pipeline stages (one committer per
  round offset 0..wave_length) x number_of_leaders (leader offsets).
"""
from __future__ import annotations

from typing import List, Optional

from . import AuthorityRound, DEFAULT_WAVE_LENGTH, DIRECT, INDIRECT, LeaderStatus
from .base_committer import BaseCommitter, BaseCommitterOptions
from ..block_store import BlockStore
from ..committee import Committee
from ..decisions import DecisionLedger, DecisionTrace
from ..types import AuthorityIndex, RoundNumber


class UniversalCommitter:
    def __init__(
        self,
        block_store: BlockStore,
        committers: List[BaseCommitter],
        metrics=None,
    ) -> None:
        self.block_store = block_store
        self.committers = committers
        self._metrics = metrics
        # Why each slot decided the way it did — exports
        # mysticeti_commit_decision_total{rule,outcome} (which replaced the
        # old per-authority direct-commit/indirect-skip committed_leaders
        # labels) and serves /debug/consensus.
        self.ledger = DecisionLedger(metrics=metrics)

    def try_commit(self, last_decided: AuthorityRound) -> List[LeaderStatus]:
        """Idempotent scan for newly decidable leaders (universal_committer.rs:30-90)."""
        highest_known_round = self.block_store.highest_round()
        # Direct decision for round R needs blocks at R+2.
        # [(status, decision, trace)] in increasing round order
        leaders: List[tuple] = []
        stop = False
        for round_ in range(max(0, highest_known_round - 2), last_decided.round - 1, -1):
            if stop:
                break
            for committer in reversed(self.committers):
                leader = committer.elect_leader(round_)
                if leader is None:
                    continue
                if leader == last_decided:
                    stop = True
                    break
                trace = DecisionTrace()
                status = committer.try_direct_decide(leader, trace=trace)
                decision = DIRECT
                if not status.is_decided():
                    status = committer.try_indirect_decide(
                        leader, (s for s, _, _ in leaders), trace=trace
                    )
                    decision = INDIRECT
                leaders.insert(0, (status, decision, trace))
        # Longest decided prefix, excluding genesis.  Only the emitted prefix
        # is recorded in the ledger: the core advances its cursor past it, so
        # those slots are never rescanned (exactly one record per slot),
        # while decided slots above the first undecided WILL be rescanned on
        # a later call and must not be recorded yet.
        out: List[LeaderStatus] = []
        undecided: List[AuthorityRound] = []
        emitting = True
        for status, decision, trace in leaders:
            if status.round == 0:
                continue
            if not status.is_decided():
                emitting = False
                undecided.append(status.authority_round)
                continue
            if not emitting:
                continue
            out.append(status)
            self.ledger.record_decision(
                status, decision, trace, highest_known_round - status.round
            )
        self.ledger.note_undecided(undecided)
        return out

    def get_leaders(self, round_: RoundNumber) -> List[AuthorityIndex]:
        return [
            leader.authority
            for committer in self.committers
            if (leader := committer.elect_leader(round_)) is not None
        ]


class UniversalCommitterBuilder:
    def __init__(self, committee: Committee, block_store: BlockStore, metrics=None) -> None:
        self.committee = committee
        self.block_store = block_store
        self.metrics = metrics
        self.wave_length = DEFAULT_WAVE_LENGTH
        self.number_of_leaders = 1
        self.pipeline = False

    def with_wave_length(self, wave_length: int) -> "UniversalCommitterBuilder":
        self.wave_length = wave_length
        return self

    def with_number_of_leaders(self, n: int) -> "UniversalCommitterBuilder":
        self.number_of_leaders = n
        return self

    def with_pipeline(self, pipeline: bool) -> "UniversalCommitterBuilder":
        self.pipeline = pipeline
        return self

    def build(self) -> UniversalCommitter:
        committers = []
        pipeline_stages = self.wave_length if self.pipeline else 1
        for round_offset in range(pipeline_stages):
            for leader_offset in range(self.number_of_leaders):
                committers.append(
                    BaseCommitter(
                        self.committee,
                        self.block_store,
                        BaseCommitterOptions(
                            wave_length=self.wave_length,
                            leader_offset=leader_offset,
                            round_offset=round_offset,
                        ),
                    )
                )
        return UniversalCommitter(self.block_store, committers, self.metrics)
