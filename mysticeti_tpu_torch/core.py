"""The single-owner consensus state machine: ingest blocks, propose, commit, persist.

The port's copy of ``mysticeti_tpu.core``.

Capability parity with ``mysticeti-core/src/core.rs``:

* ``Core.open`` — genesis bootstrap or WAL recovery (core.rs:69-161)
* ``add_blocks`` — BlockManager gate, threshold clock, pending queue, handler run
  (core.rs:171-207)
* ``run_block_handler`` — handler statements become a persisted Payload pending
  entry (core.rs:209-225)
* ``try_new_block`` — drain pending up to the clock round, include-compression,
  sign, persist own block with the next-entry cursor, optional fsync
  (core.rs:227-328)
* ``try_commit`` -> UniversalCommitter + epoch-change trigger (core.rs:368-385)
* ``ready_new_block`` — leader-aware proposal gating (core.rs:401-450)
* ``handle_committed_subdag`` — epoch observation + state/commit WAL records
  (core.rs:452-490)
* ``cleanup`` (core.rs:387-395)

Single-writer discipline: exactly one owner task/thread may call the mutating
methods; everything else reads through the BlockStore (core_thread/spawned.rs).
"""
from __future__ import annotations

from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

from . import spans
from .block_manager import BlockManager
from .block_store import (
    BlockStore,
    BlockWriter,
    CommitData,
    OwnBlockData,
    WAL_ENTRY_COMMIT,
    WAL_ENTRY_PAYLOAD,
    WAL_ENTRY_STATE,
)
from .committee import Committee
from .config import Parameters
from .consensus import AuthorityRound, LeaderStatus
from .consensus.linearizer import CommittedSubDag
from .consensus.universal_committer import UniversalCommitter, UniversalCommitterBuilder
from .crypto import Signer
from .epoch_close import EpochManager
from .serde import Writer
from .state import CoreRecoveredState, Include, MetaStatement, Payload, encode_payload
from .threshold_clock import ThresholdClockAggregator
from .tracing import logger
from .types import (
    AuthorityIndex,
    AuthoritySet,
    BlockReference,
    RoundNumber,
    Share,
    StatementBlock,
)
from .wal import POSITION_MAX, WalPosition, WalSyncer, WalWriter

log = logger(__name__)


class CoreOptions:
    __slots__ = ("fsync",)

    def __init__(self, fsync: bool = False) -> None:
        self.fsync = fsync

    @classmethod
    def test(cls) -> "CoreOptions":
        return cls(fsync=False)

    @classmethod
    def production(cls) -> "CoreOptions":
        return cls(fsync=True)


class Core:
    def __init__(
        self,
        block_handler,
        authority: AuthorityIndex,
        committee: Committee,
        parameters: Parameters,
        recovered: CoreRecoveredState,
        wal_writer: WalWriter,
        options: Optional[CoreOptions] = None,
        signer: Optional[Signer] = None,
        metrics=None,
    ) -> None:
        """Equivalent of ``Core::open`` (core.rs:69-161).

        The JAX package's ``storage`` lifecycle (checkpoint cadence, GC
        floor, snapshot catch-up) is not in the port yet: this core evicts
        its cache and keeps an unbounded log."""
        block_store: BlockStore = recovered.block_store
        pending = recovered.pending
        threshold_clock = ThresholdClockAggregator(0, metrics)
        writer = BlockWriter(wal_writer, block_store)

        # Commit-anchored reconfiguration (reconfig.py): the committee given
        # here is the epoch-0 genesis REGISTRY; a recovered epoch chain
        # (checkpoint/snapshot soft tail) re-derives the current epoch's
        # committee before anything below touches stake arithmetic.
        # reconfig.py and execution.py are not in the port yet: these two
        # branches raise ModuleNotFoundError naming the missing module, and
        # the default Parameters never reach them.
        self.reconfig = None
        if parameters.reconfig:
            from .reconfig import EpochChain, ReconfigState

            committee.epoch_tolerant = True
            self.reconfig = ReconfigState(
                committee, EpochChain.from_bytes(recovered.epoch_chain)
            )
            committee = self.reconfig.committee

        # Deterministic execution plane (execution.py): account/transfer
        # state machine folded over the committed sequence.  A recovered
        # state (checkpoint/snapshot soft tail) restores the exact root the
        # node crashed out of; replayed commits below it are skipped by the
        # fold's height guard.
        self.execution = None
        if parameters.execution:
            from .execution import ExecutionState

            self.execution = ExecutionState(metrics=metrics)
            self.execution.recover(recovered.exec_state)

        if recovered.last_own_block is not None:
            # Recovery: replay pending includes into the clock (core.rs:89-95).
            for _, meta in pending:
                if isinstance(meta, Include):
                    threshold_clock.add_block(meta.reference, committee)
            last_own_block = recovered.last_own_block
            if metrics is not None:
                # WAL-recovered boot (vs genesis bootstrap): the chaos tier
                # asserts crash-restart actually drove this path.
                metrics.crash_recovery_total.inc()
        else:
            assert not pending
            own_genesis, other_genesis = committee.genesis_blocks(authority)
            assert own_genesis.author() == authority
            for block in other_genesis:
                threshold_clock.add_block(block.reference, committee)
                position = writer.insert_block(block)
                pending.append((position, Include(block.reference)))
            threshold_clock.add_block(own_genesis.reference, committee)
            last_own_block = OwnBlockData(next_entry=POSITION_MAX, block=own_genesis)
            writer.insert_own_block(last_own_block)

        if recovered.state is not None:
            block_handler.recover_state(
                recovered.state, watermark_round=block_store.highest_round()
            )

        self.block_manager = BlockManager(block_store, len(committee), metrics)
        # A store recovered from a WAL that holds a snapshot baseline lacks
        # everything below its floor; the manager must never park on those
        # references.
        self.block_manager.gc_floor = recovered.gc_round
        self.pending: Deque[Tuple[WalPosition, MetaStatement]] = pending
        self.last_own_block: OwnBlockData = last_own_block
        self.block_handler = block_handler
        self.authority = authority
        self.threshold_clock = threshold_clock
        self.committee = committee
        last = recovered.last_committed_leader
        self.last_decided_leader = (
            AuthorityRound(last.authority, last.round) if last else AuthorityRound(0, 0)
        )
        self.wal_writer = wal_writer
        self.block_store = block_store
        self.metrics = metrics
        self.options = options or CoreOptions.test()
        self.signer = signer
        self.epoch_manager = EpochManager()
        self.rounds_in_epoch = parameters.rounds_in_epoch
        self.store_retain_rounds = parameters.store_retain_rounds
        self.leader_liveness_horizon = parameters.leader_liveness_horizon_rounds
        # Authorities the sync layer scored content-silent (live connection,
        # own blocks only ever recovered via relays/fetch — the withholder
        # shape).  Maintained by NetworkSyncer._score_missing; membership
        # checks only, so plain-set mutation from the net loop is safe.
        self.content_silent: Set[AuthorityIndex] = set()
        # leader -> last leader_round whose liveness skip was counted (the
        # metric counts skipped SLOTS, not readiness polls).
        self._leader_skip_marked: Dict[AuthorityIndex, RoundNumber] = {}
        self.parameters = parameters
        # Called on every epoch switch with (new_committee, records): the
        # sync layer re-derives peer/relay/verifier state, the chaos checker
        # audits cross-node boundary agreement.  Registered post-construction
        # by the node assembly; fired on the consensus owner only.
        self.epoch_listeners: List = []
        # Called per folded commit with the ExecutionResult: the ingress
        # plane closes execute-phase finality and pushes gateway EXECUTED
        # notifications, the chaos checker audits cross-node root agreement.
        # Registered post-construction; fired on the consensus owner only.
        self.execution_listeners: List = []
        # Historical-committee memo for committee_for_epoch (catch-up
        # validates every pre-boundary block against its own epoch).
        self._epoch_committees: Dict[int, Committee] = {}
        self.committer: UniversalCommitter = self._build_committer()

        if self.reconfig is not None or self.execution is not None:
            # Crash landing between a boundary commit's WAL entry and the
            # next checkpoint: the replayed commits (everything after the
            # checkpoint baseline) are re-scanned so the node re-derives the
            # exact epoch — and the exact execution root — it crashed out
            # of.
            for commit in recovered.recovered_commits:
                blocks = [
                    b
                    for b in (
                        block_store.get_block(ref) for ref in commit.sub_dag
                    )
                    if b is not None
                ]
                if self.reconfig is not None:
                    transition = self.reconfig.observe_commit(
                        commit.height, commit.leader.round, blocks
                    )
                    if transition is not None:
                        self._switch_epoch(transition)
                if self.execution is not None:
                    self.execution.observe_commit(commit.height, blocks)
        if self.reconfig is not None:
            if metrics is not None:
                metrics.mysticeti_epoch.set(self.committee.epoch)
                metrics.mysticeti_committee_digest_info.labels(
                    self.reconfig.digest().hex()[:16]
                ).set(self.committee.epoch)

        if recovered.unprocessed_blocks:
            # Blocks after the last state snapshot re-run through the handler
            # (core.rs:152-158).
            self.run_block_handler(recovered.unprocessed_blocks)

    def _build_committer(self) -> UniversalCommitter:
        return (
            UniversalCommitterBuilder(self.committee, self.block_store, self.metrics)
            .with_wave_length(self.parameters.wave_length)
            .with_number_of_leaders(self.parameters.number_of_leaders)
            .with_pipeline(self.parameters.enable_pipelining)
            .build()
        )

    def _switch_epoch(self, transition) -> None:
        """Apply an epoch transition on the consensus owner: swap the
        committee every stake/quorum computation reads, rebuild the commit
        rule over it, and notify the sync/health/verifier listeners.  Called
        at a deterministic committed-sequence point (observe_commit), so
        every honest node performs the identical switch."""
        self.committee = transition.committee
        self.committer = self._build_committer()
        if hasattr(self.block_handler, "committee"):
            self.block_handler.committee = self.committee
        for record in transition.records:
            log.info(
                "epoch %d: boundary height=%d round=%d digest=%s stakes=%s",
                record.epoch, record.boundary_height, record.boundary_round,
                record.digest.hex()[:16], list(record.stakes),
            )
        if self.metrics is not None:
            self.metrics.mysticeti_epoch.set(self.committee.epoch)
            self.metrics.mysticeti_epoch_transitions_total.inc(
                len(transition.records)
            )
            self.metrics.mysticeti_committee_digest_info.labels(
                transition.records[-1].digest.hex()[:16]
            ).set(self.committee.epoch)
        for listener in self.epoch_listeners:
            listener(self.committee, transition.records)

    def committee_for_epoch(self, epoch: int) -> Committee:
        """Structural-validation committee for a block stamped ``epoch``.

        A historical block's threshold clock must be judged by ITS epoch's
        stake arithmetic — catch-up replays pre-boundary rounds long after
        the switch, and those include sets were built against the old
        quorum.  Epochs this node has not derived (including claimed
        future ones) fall back to the CURRENT committee: an author cannot
        buy lenient validation by stamping an epoch nobody has reached."""
        if self.reconfig is None or epoch == self.committee.epoch:
            return self.committee
        cached = self._epoch_committees.get(epoch)
        if cached is None:
            cached = self.reconfig.committee_for_epoch(epoch)
            if cached is None:
                return self.committee
            self._epoch_committees[epoch] = cached
        return cached

    # -- ingestion (core.rs:171-207) --

    def add_blocks(self, blocks: Sequence[StatementBlock]) -> List[BlockReference]:
        """Returns first-seen missing references needed to process the input."""
        writer = BlockWriter(self.wal_writer, self.block_store)
        processed, missing_references = self.block_manager.add_blocks(blocks, writer)
        tracer = spans.active()
        t_added = tracer.now() if tracer is not None else 0.0
        result = []
        for position, block in sorted(processed, key=lambda pb: pb[1].round()):
            self.threshold_clock.add_block(block.reference, self.committee)
            self.pending.append((position, Include(block.reference)))
            result.append(block)
            if tracer is not None:
                tracer.end_span(
                    "dag_add", block.reference,
                    authority=self.authority, t=t_added,
                )
                # Closed by the commit observer when the block is sequenced.
                tracer.begin_span(
                    "proposal_wait", block.reference,
                    authority=self.authority, t=t_added,
                )
        self.run_block_handler(result)
        return list(missing_references)

    def run_block_handler(self, processed: Sequence[StatementBlock]) -> None:
        statements = self.block_handler.handle_blocks(
            processed, require_response=not self.epoch_changing()
        )
        position = self.wal_writer.write(WAL_ENTRY_PAYLOAD, encode_payload(statements))
        self.pending.append((position, Payload(tuple(statements))))

    # -- proposal (core.rs:227-328) --

    def try_new_block(self) -> Optional[StatementBlock]:
        clock_round = self.threshold_clock.get_round()
        if clock_round <= self.last_proposed():
            return None

        # Take pending entries up to (not including) the first include at or past
        # the clock round (core.rs:240-251).
        first_include_index = len(self.pending)
        for i, (_, meta) in enumerate(self.pending):
            if isinstance(meta, Include) and meta.reference.round >= clock_round:
                first_include_index = i
                break
        taken = [self.pending.popleft() for _ in range(first_include_index)]

        # Include-compression: skip references already transitively covered by
        # the includes taken into this block (core.rs:253-278).
        references_in_block: Set[BlockReference] = set()
        references_in_block.update(self.last_own_block.block.includes)
        for _, meta in taken:
            if isinstance(meta, Include):
                block = self.block_store.get_block(meta.reference)
                if block is not None:
                    references_in_block.update(block.includes)

        includes: List[BlockReference] = [self.last_own_block.block.reference]
        statements: List = []
        for _, meta in taken:
            if isinstance(meta, Include):
                if meta.reference not in references_in_block:
                    includes.append(meta.reference)
            else:
                if not self.epoch_changing():
                    statements.extend(meta.statements)
        # Group shares into ONE contiguous run (relative order preserved on
        # both sides).  Every share RUN costs every observer a VoteRange
        # statement in its next block (committee.shared_ranges): when handler
        # calls interleave shares with votes across payload entries, the runs
        # fragment and per-block vote statements blow up to O(committee²) in
        # vote-heavy workloads — measured 360 VoteRanges/block at 20
        # authorities vs 19 with grouping.  Offsets inside the proposal are
        # assigned after this reordering, so locators stay self-consistent.
        if statements:
            shares = [s for s in statements if isinstance(s, Share)]
            if shares:
                statements = shares + [
                    s for s in statements if not isinstance(s, Share)
                ]

        assert includes
        from .runtime import timestamp_utc

        t_propose = spans.SpanTracer.now()
        block = StatementBlock.build(
            self.authority,
            clock_round,
            includes,
            statements,
            meta_creation_time_ns=int(timestamp_utc() * 1e9),
            epoch_marker=1 if self.epoch_changing() else 0,
            epoch=self.committee.epoch,
            signer=self.signer,
        )
        assert block.includes[0].authority == self.authority

        if self.metrics is not None:
            # Proposal-shape channels (metrics.rs:64-66): size from the
            # cached canonical bytes (computed by build), tx = Share runs,
            # votes = Vote/VoteRange statements.
            shares = sum(1 for s in statements if isinstance(s, Share))
            self.metrics.proposed_block_size_bytes.observe(
                len(block.to_bytes())
            )
            self.metrics.proposed_block_transaction_count.observe(shares)
            self.metrics.proposed_block_vote_count.observe(
                len(statements) - shares
            )
        tracer = spans.active()
        if tracer is not None:
            # The journey's t=0 (tools/fleet_trace.py): the author built and
            # signed the block here — every peer's transit/receive measures
            # from this edge once traces are merged.
            tracer.record_span(
                "propose", block.reference, t_propose,
                authority=self.authority,
            )
            # Own blocks skip receive/verify/dag_add; their pipeline starts
            # at the wait for commit.
            tracer.begin_span(
                "proposal_wait", block.reference, authority=self.authority
            )
        self.threshold_clock.add_block(block.reference, self.committee)
        self.block_handler.handle_proposal(block)
        next_entry = self.pending[0][0] if self.pending else POSITION_MAX
        self.last_own_block = OwnBlockData(next_entry=next_entry, block=block)
        BlockWriter(self.wal_writer, self.block_store).insert_own_block(
            self.last_own_block
        )
        if self.options.fsync:
            self.wal_writer.sync()
        # pending() is constantly False under the sim (walf() forces
        # synchronous writes), so this durability drain cannot skew a
        # seeded run.
        elif self.wal_writer.pending():  # lint: ignore[sim-taint]
            # Durability floor for OWN proposals: the async
            # append queue parks acknowledged entries in process memory, so
            # without this drain a plain process crash (OOM/SIGKILL) after
            # broadcast could lose the proposal and let the restarted node
            # equivocate at the same round.  flush() lands the bytes in the
            # page cache (the reference's synchronous-writev posture) BEFORE
            # the caller signals new_block_ready to the dissemination
            # streams; only OS/power failure retains a loss window, same as
            # the reference.  No fsync: that stays the syncer thread's job.
            # Cost: this blocks the owner until the drain thread lands the
            # queue — the pending() gate makes it free when already caught
            # up, and under backlog it repays, once per round, the same
            # bytes synchronous mode would have paid inline per append.
            self.wal_writer.flush()
        log.debug(
            "proposed block round=%d includes=%d statements=%d",
            block.round(),
            len(block.includes),
            len(block.statements),
        )
        return block

    # -- commit (core.rs:368-385) --

    def try_commit(self) -> List[StatementBlock]:
        sequence = self.committer.try_commit(self.last_decided_leader)
        if self.reconfig is not None and sequence:
            # Slot-sequential commit under reconfiguration: cap each batch at
            # the FIRST committed leader.  A change transaction anywhere in
            # that commit's sub-dag switches the committee, and every later
            # slot must be decided under the post-switch stake arithmetic —
            # a node that decided a whole multi-leader batch with the old
            # committee while a slower peer split it across the boundary
            # would diverge.  The syncer loops until a pass decides nothing,
            # so throughput is unchanged.
            for i, status in enumerate(sequence):
                if status.kind == LeaderStatus.COMMIT:
                    sequence = sequence[: i + 1]
                    break
        if sequence:
            self.last_decided_leader = sequence[-1].into_decided_author_round()
        if self.last_decided_leader.round > self.rounds_in_epoch:
            self.epoch_manager.epoch_change_begun()
        return [s.block for s in sequence if s.kind == LeaderStatus.COMMIT]

    def ready_new_block(self, period: int, connected_authorities: AuthoritySet) -> bool:
        """Leader-aware proposal gating (core.rs:401-450): propose when the previous
        round's (connected) leaders have been received, or there are none."""
        quorum_round = self.threshold_clock.get_round()
        if quorum_round <= max(self.last_decided_leader.round, period - 1):
            return False
        leader_round = quorum_round - 1
        leaders = self.committer.get_leaders(leader_round)
        if not leaders:
            return True
        connected_leaders = [
            l for l in leaders if connected_authorities.contains(l)
        ]
        if self.leader_liveness_horizon > 0:
            # Leader liveness scoring (docs/adversary.md): a leader whose
            # blocks have not been ACCEPTED locally for more than the
            # horizon is not worth gating the proposal on — a Byzantine
            # authority that signs invalidly (or withholds from us) would
            # otherwise tax every one of its slots with a full leader
            # timeout.  The timeout task stays as the universal backstop,
            # and the commit rule is untouched: the slot is still decided
            # (skip) by 2f+1 non-links, exactly as on a timeout.  An
            # authority that resumes producing acceptable blocks re-enters
            # the wait set as soon as its last-seen round catches back up.
            live = []
            for leader in connected_leaders:
                seen = self.block_store.last_seen_by_authority(leader)
                lagging = leader_round - seen > self.leader_liveness_horizon
                if lagging or leader in self.content_silent:
                    # Once per (leader, round): readiness is polled on
                    # every dispatcher event, so a bare inc() here would
                    # count polls (thousands per skipped slot), not skips.
                    if (
                        self.metrics is not None
                        and self._leader_skip_marked.get(leader) != leader_round
                    ):
                        self._leader_skip_marked[leader] = leader_round
                        self.metrics.mysticeti_leader_wait_skipped_total.labels(
                            str(leader)
                        ).inc()
                else:
                    live.append(leader)
            connected_leaders = live
        if not connected_leaders:
            return True
        return self.block_store.all_blocks_exists_at_authority_round(
            connected_leaders, leader_round
        )

    # -- commit persistence (core.rs:452-490) --

    def handle_committed_subdag(
        self, committed: List[CommittedSubDag], state: bytes
    ) -> List[CommitData]:
        commit_data = []
        for commit in committed:
            for block in commit.blocks:
                self.epoch_manager.observe_committed_block(block, self.committee)
            commit_data.append(
                CommitData(
                    leader=commit.anchor,
                    sub_dag=[b.reference for b in commit.blocks],
                    height=commit.height,
                )
            )
            if self.reconfig is not None:
                # Scan this commit's sub-dag (in linearized order) for
                # finalized committee changes; the switch happens HERE —
                # before any later slot is decided (try_commit is slot-sequential
                # under reconfig, so `committed` holds at most one commit).
                transition = self.reconfig.observe_commit(
                    commit.height, commit.anchor.round, commit.blocks
                )
                if transition is not None:
                    self._switch_epoch(transition)
            if self.execution is not None:
                # Fold the sub-dag into the account state machine and
                # advance the root chain before the commit is persisted.
                result = self.execution.observe_commit(
                    commit.height, commit.blocks
                )
                if result is not None:
                    for listener in self.execution_listeners:
                        listener(result)
        self.write_state()
        self.write_commits(commit_data, state)
        return commit_data

    def write_state(self) -> None:
        self.wal_writer.write(WAL_ENTRY_STATE, self.block_handler.state())

    def write_commits(self, commits: List[CommitData], state: bytes) -> None:
        w = Writer()
        w.u32(len(commits))
        for c in commits:
            c.encode(w)
        w.bytes(state)
        self.wal_writer.write(WAL_ENTRY_COMMIT, w.finish())

    # -- maintenance --

    def cleanup(self) -> None:
        self.block_store.cleanup(
            max(0, self.last_decided_leader.round - self.store_retain_rounds)
        )
        self.block_handler.cleanup()

    def wal_syncer(self) -> WalSyncer:
        return self.wal_writer.syncer()

    # -- accessors --

    def leaders(self, round_: RoundNumber) -> List[AuthorityIndex]:
        return self.committer.get_leaders(round_)

    def current_round(self) -> RoundNumber:
        return self.threshold_clock.get_round()

    def last_proposed(self) -> RoundNumber:
        return self.last_own_block.block.round()

    def last_own_block_value(self) -> StatementBlock:
        return self.last_own_block.block

    def epoch_closed(self) -> bool:
        return self.epoch_manager.closed()

    def epoch_changing(self) -> bool:
        return self.epoch_manager.changing()

    def epoch_closing_time(self) -> int:
        return self.epoch_manager.closing_time()
