"""Offline whole-DAG re-interpretation: the fast-path safety oracle.

The port's counterpart of ``mysticeti_tpu.finalization_interpreter``: the
same semantics and the same result, in the same order, with each block's
voters a bitmask per transaction (a transaction interned to an integer) in
place of a ``StakeAggregator`` per pair.  The DAG's every block carries the
voter sets of its whole history, so the work grows with blocks times
transactions: the JAX package's form takes minutes on one node's 34 rounds
of a 10-validator fleet, which the epoch phase of ``chip_smoke.py`` must
read on every node.

Capability parity with ``mysticeti-core/src/finalization_interpreter.rs``
(:13-148): recompute, from the stored DAG alone, which transactions are
finalized (certified by a quorum of certifying blocks) and which blocks certify
them.  Used by the simulation safety test to cross-check the online
TransactionAggregator/commit pipeline against an independent implementation.

Semantics: a block votes for a transaction if it shares it, votes for it
explicitly, or (transitively) includes a block that voted; a block whose
accumulated voter stake reaches quorum *certifies* the transaction (unless the
block carries the epoch-change marker); a transaction is *finalized* once
certifying blocks from a quorum of distinct authors exist.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from .block_store import BlockStore
from .committee import QUORUM, Committee
from .types import (
    AuthoritySet,
    BlockReference,
    Share,
    StatementBlock,
    TransactionLocator,
    Vote,
    VoteRange,
)


class FinalizationInterpreter:
    def __init__(self, block_store: BlockStore, committee: Committee) -> None:
        self.block_store = block_store
        self.committee = committee
        # per block: transaction id -> bitmask of the authorities whose votes
        # it has seen (its own and, transitively, its parents')
        self.transaction_voters: Dict[BlockReference, Dict[int, int]] = {}
        # per transaction id: bitmask of the authors of its certifying blocks
        self.certificate_authors: Dict[int, int] = {}
        self.transaction_certificates: Dict[
            TransactionLocator, Set[BlockReference]
        ] = {}
        self.finalized_transactions: Set[TransactionLocator] = set()
        self._ids: Dict[TransactionLocator, int] = {}
        self._locators: List[TransactionLocator] = []
        self._quorum: Dict[int, bool] = {}  # bitmask -> its stake reaches QUORUM

    def finalized_tx_certifying_blocks(
        self,
    ) -> List[Tuple[TransactionLocator, Set[BlockReference]]]:
        for round_ in range(self.block_store.highest_round() + 1):
            for block in self.block_store.get_blocks_by_round(round_):
                self._process(block)
        return [
            (tx, blocks)
            for tx, blocks in self.transaction_certificates.items()
            if tx in self.finalized_transactions
        ]

    def _id(self, locator: TransactionLocator) -> int:
        tx = self._ids.get(locator)
        if tx is None:
            tx = self._ids[locator] = len(self._locators)
            self._locators.append(locator)
        return tx

    def _is_quorum(self, mask: int) -> bool:
        reached = self._quorum.get(mask)
        if reached is None:
            stake = sum(self.committee.get_stake(a) for a in AuthoritySet(mask).present())
            reached = self._quorum[mask] = self.committee.threshold_predicate(QUORUM)(stake)
        return reached

    def _process(self, block: StatementBlock) -> None:
        if block.reference in self.transaction_voters:
            return
        voters: Dict[int, int] = {}
        self.transaction_voters[block.reference] = voters
        author = 1 << block.author()

        for offset, statement in enumerate(block.statements):
            if isinstance(statement, Vote):
                if statement.accept:
                    self._vote(block, voters, self._id(statement.locator), author)
            elif isinstance(statement, VoteRange):
                for locator in statement.range.locators():
                    self._vote(block, voters, self._id(locator), author)
            elif isinstance(statement, Share):
                self._vote(
                    block,
                    voters,
                    self._id(TransactionLocator(block.reference, offset)),
                    author,
                )

        for parent_ref in block.includes:
            parent = self.block_store.get_block(parent_ref)
            assert parent is not None, "whole DAG must be stored"
            self._process(parent)
            # Inherit every vote visible through the parent.
            for tx, mask in self.transaction_voters[parent_ref].items():
                self._vote(block, voters, tx, mask)

    def _vote(
        self, block: StatementBlock, voters: Dict[int, int], tx: int, mask: int
    ) -> None:
        before = voters.get(tx, 0)
        after = voters[tx] = before | mask
        if (
            after != before
            and self._is_quorum(after)
            and not self._is_quorum(before)
            and not block.epoch_changed()
        ):
            # ``block`` certifies this transaction.
            locator = self._locators[tx]
            self.transaction_certificates.setdefault(locator, set()).add(
                block.reference
            )
            authors = self.certificate_authors.get(tx, 0) | (1 << block.author())
            self.certificate_authors[tx] = authors
            if self._is_quorum(authors):
                self.finalized_transactions.add(locator)
