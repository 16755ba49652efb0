"""Expand committed leaders into ordered sub-DAGs of their uncommitted causal history.

The port's copy of ``mysticeti_tpu.consensus.linearizer``.

Capability parity with ``mysticeti-core/src/consensus/linearizer.rs``:

* ``CommittedSubDag`` {anchor, blocks, timestamp_ms, height} (:17-27), buildable
  from persisted ``CommitData`` (:45-65), sorted by round (:68-70).
* ``Linearizer`` (:91-166) — DFS collection of not-yet-committed causal history
  from each committed leader; monotone height counter; recovery from the commit
  observer's persisted state (:108-121).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Set

from ..block_store import BlockStore, CommitData
from ..state import CommitObserverRecoveredState
from ..types import BlockReference, StatementBlock


@dataclass
class CommittedSubDag:
    anchor: BlockReference
    blocks: List[StatementBlock]
    timestamp_ms: int
    height: int

    @staticmethod
    def new_from_commit_data(
        commit_data: CommitData, block_store: BlockStore
    ) -> "CommittedSubDag":
        blocks = []
        leader_block = None
        for ref in commit_data.sub_dag:
            block = block_store.get_block(ref)
            assert block is not None, "commit-data block must be stored"
            if ref == commit_data.leader:
                leader_block = block
            blocks.append(block)
        assert leader_block is not None, "leader block must be in the sub-dag"
        return CommittedSubDag(
            commit_data.leader,
            blocks,
            leader_block.meta_creation_time_ns // 1_000_000,
            commit_data.height,
        )

    def sort(self) -> None:
        self.blocks.sort(key=lambda b: b.round())

    def __repr__(self) -> str:
        refs = ", ".join(repr(b.reference) for b in self.blocks)
        return f"{self.anchor!r}@{self.height}({refs})"


class Linearizer:
    def __init__(self, block_store: BlockStore) -> None:
        self.block_store = block_store
        self.committed: Set[BlockReference] = set()
        self.last_height = 0
        # Recovered floor: a WAL that holds a snapshot baseline (written by
        # the JAX package's storage lifecycle) lacks all history below it,
        # so the DFS treats references strictly below it like
        # already-committed blocks.
        self.gc_round = 0

    def recover_state(self, recovered: CommitObserverRecoveredState) -> None:
        assert not self.committed and self.last_height == 0
        self.last_height = recovered.base_height
        self.committed.update(recovered.base_committed)
        self.gc_round = max(self.gc_round, recovered.gc_round)
        for commit in recovered.sub_dags:
            assert commit.height > self.last_height
            self.last_height = commit.height
            self.committed.update(commit.sub_dag)
            assert commit.leader in self.committed

    def collect_sub_dag(self, leader_block: StatementBlock) -> CommittedSubDag:
        to_commit: List[StatementBlock] = []
        timestamp_ms = leader_block.meta_creation_time_ns // 1_000_000
        leader_ref = leader_block.reference
        assert leader_ref not in self.committed
        self.committed.add(leader_ref)
        buffer = [leader_block]
        while buffer:
            block = buffer.pop()
            to_commit.append(block)
            for reference in block.includes:
                if reference in self.committed or reference.round < self.gc_round:
                    continue
                inner = self.block_store.get_block(reference)
                assert inner is not None, "whole sub-dag must be stored by now"
                self.committed.add(reference)
                buffer.append(inner)
        self.last_height += 1
        return CommittedSubDag(leader_ref, to_commit, timestamp_ms, self.last_height)

    def handle_commit(
        self, committed_leaders: List[StatementBlock]
    ) -> List[CommittedSubDag]:
        out = []
        for leader_block in committed_leaders:
            sub_dag = self.collect_sub_dag(leader_block)
            sub_dag.sort()
            out.append(sub_dag)
        return out
