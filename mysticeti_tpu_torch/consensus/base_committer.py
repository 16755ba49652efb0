"""The bare-bones decision rules for one (leader_offset, round_offset) view of the DAG.

The port's copy of ``mysticeti_tpu.consensus.base_committer``.

Capability parity with ``mysticeti-core/src/consensus/base_committer.rs``:

* ``BaseCommitterOptions`` {wave_length, leader_offset, round_offset} (:22-31)
* wave/leader-round/decision-round arithmetic (:71-86)
* ``elect_leader`` (:91-102)
* support/vote/certificate predicates via DAG traversal with a memoized vote
  cache (:109-180)
* ``decide_leader_from_anchor`` (:184-224) — commit iff a certified link to the
  anchor exists, else skip; panics if >1 certified leader block (BFT break)
* direct rule ``try_direct_decide`` (:323-357) — skip on 2f+1 blames in the voting
  round, commit on 2f+1 certificates in the decision round
* indirect rule ``try_indirect_decide`` (:294-318) — decide from the first
  committed anchor >= one wave later; stop at the first undecided anchor.

All methods are idempotent, read-only queries over the block store.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from . import AuthorityRound, DEFAULT_WAVE_LENGTH, LeaderStatus, MINIMUM_WAVE_LENGTH
from ..block_store import BlockStore
from ..committee import Committee, QUORUM, StakeAggregator
from ..types import AuthorityIndex, BlockReference, RoundNumber, StatementBlock


@dataclass
class BaseCommitterOptions:
    wave_length: int = DEFAULT_WAVE_LENGTH
    leader_offset: int = 0
    round_offset: int = 0


class BaseCommitter:
    def __init__(
        self,
        committee: Committee,
        block_store: BlockStore,
        options: Optional[BaseCommitterOptions] = None,
    ) -> None:
        self.committee = committee
        self.block_store = block_store
        self.options = options or BaseCommitterOptions()
        assert self.options.wave_length >= MINIMUM_WAVE_LENGTH

    # -- wave arithmetic (base_committer.rs:71-86) --

    def wave_number(self, round_: RoundNumber) -> int:
        return max(0, round_ - self.options.round_offset) // self.options.wave_length

    def leader_round(self, wave: int) -> RoundNumber:
        return wave * self.options.wave_length + self.options.round_offset

    def decision_round(self, wave: int) -> RoundNumber:
        wl = self.options.wave_length
        return wave * wl + wl - 1 + self.options.round_offset

    def elect_leader(self, round_: RoundNumber) -> Optional[AuthorityRound]:
        wave = self.wave_number(round_)
        if self.leader_round(wave) != round_:
            return None
        return AuthorityRound(
            self.committee.elect_leader(round_, self.options.leader_offset), round_
        )

    # -- DAG predicates (base_committer.rs:109-180) --

    def find_support(
        self, author_round: AuthorityRound, from_block: StatementBlock
    ) -> Optional[BlockReference]:
        """Which block at (author, round) does ``from_block`` support?

        The *first* include matching (author, round) wins — ordered includes define
        support, and any descendant including ``from_block`` inherits its choice.
        """
        if from_block.round() < author_round.round:
            return None
        target = (author_round.authority, author_round.round)
        for include in from_block.includes:
            if include.author_round() == target:
                return include
            # Weak links may point below the target round; skip them.
            if include.round <= author_round.round:
                continue
            inner = self.block_store.get_block(include)
            assert inner is not None, "whole sub-dag must be stored by now"
            support = self.find_support(author_round, inner)
            if support is not None:
                return support
        return None

    def is_vote(self, potential_vote: StatementBlock, leader_block: StatementBlock) -> bool:
        ar = AuthorityRound(leader_block.author(), leader_block.round())
        return self.find_support(ar, potential_vote) == leader_block.reference

    def is_certificate(
        self,
        potential_certificate: StatementBlock,
        leader_block: StatementBlock,
        all_votes: Dict[BlockReference, bool],
        trace=None,
    ) -> bool:
        """2f+1 stake of ``potential_certificate``'s includes vote for the leader.

        ``all_votes`` memoizes per-reference vote checks; it is only valid for one
        ``leader_block`` (base_committer.rs:149-151).  ``trace`` (an optional
        :class:`~mysticeti_tpu_torch.decisions.DecisionTrace`) captures the vote
        tally — the best one seen, whether or not quorum was reached — as a
        side channel; it never affects the decision.
        """
        aggregator = StakeAggregator(QUORUM)
        for reference in potential_certificate.includes:
            vote = all_votes.get(reference)
            if vote is None:
                if reference.round <= leader_block.round():
                    # Cannot vote for the leader (includes point strictly
                    # down-round, so no path from here reaches a block that
                    # links the leader).  Also the reference may simply not
                    # be stored: a snapshot-rejoiner's first proposal
                    # carries its pre-crash pending includes — settled
                    # history the rest of the fleet long GC'd (the
                    # BlockManager admits such blocks by treating sub-floor
                    # includes as satisfied; this walk must tolerate the
                    # same shape instead of asserting).
                    all_votes[reference] = False
                    continue
                block = self.block_store.get_block(reference)
                assert block is not None, "whole sub-dag must be stored by now"
                vote = self.is_vote(block, leader_block)
                all_votes[reference] = vote
            if vote and aggregator.add(reference.authority, self.committee):
                if trace is not None:
                    trace.note_certificates(aggregator)
                return True
        if trace is not None:
            trace.note_certificates(aggregator)
        return False

    # -- decisions --

    def decide_leader_from_anchor(
        self, anchor: StatementBlock, leader: AuthorityRound, trace=None
    ) -> LeaderStatus:
        """Commit the target leader iff it has a certificate among the anchor's
        ancestors at the target's decision round (base_committer.rs:184-224)."""
        if trace is not None:
            trace.note_anchor(AuthorityRound(anchor.author(), anchor.round()))
        leader_blocks = self.block_store.get_blocks_at_authority_round(
            leader.authority, leader.round
        )
        wave = self.wave_number(leader.round)
        decision_round = self.decision_round(wave)
        potential_certificates = self.block_store.linked_to_round(anchor, decision_round)

        certified: List[StatementBlock] = []
        for leader_block in leader_blocks:
            all_votes: Dict[BlockReference, bool] = {}
            if any(
                self.is_certificate(pc, leader_block, all_votes, trace=trace)
                for pc in potential_certificates
            ):
                certified.append(leader_block)
        if len(certified) > 1:
            raise RuntimeError(
                f"More than one certified block at wave {wave} from leader {leader!r}"
            )
        if certified:
            return LeaderStatus.commit(certified[0])
        return LeaderStatus.skip(leader)

    def enough_leader_blame(
        self, voting_round: RoundNumber, leader: AuthorityIndex, trace=None
    ) -> bool:
        """2f+1 stake of voting-round blocks with no include from the leader
        (base_committer.rs:228-249)."""
        aggregator = StakeAggregator(QUORUM)
        quorum = False
        for voting_block in self.block_store.get_blocks_by_round(voting_round):
            if all(inc.authority != leader for inc in voting_block.includes):
                if aggregator.add(voting_block.author(), self.committee):
                    quorum = True
                    break
        if trace is not None:
            trace.note_blames(aggregator)
        return quorum

    def enough_leader_support(
        self, decision_round: RoundNumber, leader_block: StatementBlock, trace=None
    ) -> bool:
        """2f+1 stake of decision-round blocks that are certificates
        (base_committer.rs:253-289)."""
        decision_blocks = self.block_store.get_blocks_by_round(decision_round)
        total = self.committee.get_total_stake(b.author() for b in decision_blocks)
        if total < self.committee.quorum_threshold():
            return False
        aggregator = StakeAggregator(QUORUM)
        all_votes: Dict[BlockReference, bool] = {}
        quorum = False
        for decision_block in decision_blocks:
            # The trace tallies the outer aggregator (decision-round authors
            # whose blocks certify the leader), not the per-block vote walks.
            if self.is_certificate(decision_block, leader_block, all_votes):
                if aggregator.add(decision_block.author(), self.committee):
                    quorum = True
                    break
        if trace is not None:
            trace.note_certificates(aggregator)
        return quorum

    def try_indirect_decide(
        self, leader: AuthorityRound, leaders: Iterable[LeaderStatus], trace=None
    ) -> LeaderStatus:
        """Decide from the first committed anchor at least one wave later
        (base_committer.rs:294-318).  ``leaders`` is the (higher-round) decided
        sequence so far, in increasing round order."""
        for anchor in leaders:
            if leader.round + self.options.wave_length > anchor.round:
                continue
            if anchor.kind == LeaderStatus.COMMIT:
                return self.decide_leader_from_anchor(anchor.block, leader, trace=trace)
            if anchor.kind == LeaderStatus.UNDECIDED:
                break
        return LeaderStatus.undecided(leader)

    def try_direct_decide(self, leader: AuthorityRound, trace=None) -> LeaderStatus:
        """The fast path (base_committer.rs:323-357)."""
        voting_round = leader.round + 1
        if self.enough_leader_blame(voting_round, leader.authority, trace=trace):
            return LeaderStatus.skip(leader)

        wave = self.wave_number(leader.round)
        decision_round = self.decision_round(wave)
        supported = [
            block
            for block in self.block_store.get_blocks_at_authority_round(
                leader.authority, leader.round
            )
            if self.enough_leader_support(decision_round, block, trace=trace)
        ]
        if len(supported) > 1:
            raise RuntimeError(
                f"More than one certified block for {leader!r}"
            )
        if supported:
            return LeaderStatus.commit(supported[0])
        return LeaderStatus.undecided(leader)

    def __repr__(self) -> str:
        return (
            f"Committer-L{self.options.leader_offset}-R{self.options.round_offset}"
        )
