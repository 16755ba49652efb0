"""Causal-completeness gate: park blocks whose parents are missing, release on arrival.

The port's copy of ``mysticeti_tpu.block_manager``.

Capability parity with ``mysticeti-core/src/block_manager.rs``:

* ``add_blocks`` (block_manager.rs:48-136) — accepts blocks whose whole causal
  history is stored, persisting them through the ``BlockWriter``; otherwise parks
  them in ``blocks_pending`` with reverse edges in ``block_references_waiting``.
  Returns (newly processed [(position, block)], first-seen missing references).
* ``missing_blocks`` (:138) — per-authority sets of references the synchronizer
  should fetch.
* ``exists_or_pending`` (:142-144).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Sequence, Set, Tuple

from .block_store import BlockStore, BlockWriter
from .types import BlockReference, StatementBlock
from .wal import WalPosition


class BlockManager:
    def __init__(self, block_store: BlockStore, num_authorities: int, metrics=None) -> None:
        self.blocks_pending: Dict[BlockReference, StatementBlock] = {}
        self.block_references_waiting: Dict[BlockReference, Set[BlockReference]] = {}
        self.missing: List[Set[BlockReference]] = [set() for _ in range(num_authorities)]
        self.block_store = block_store
        self._metrics = metrics
        # Recovered floor (a WAL that holds a snapshot baseline): includes
        # strictly below it are treated as satisfied — the blocks are not
        # on disk here, so parking/fetching on them would wait forever.
        self.gc_floor = 0

    def add_blocks(
        self, blocks: Sequence[StatementBlock], block_writer: BlockWriter
    ) -> Tuple[List[Tuple[WalPosition, StatementBlock]], Set[BlockReference]]:
        # Ascending round order avoids spurious missing references when a batch
        # contains both parent and child (block_manager.rs:56-58).
        queue: Deque[StatementBlock] = deque(sorted(blocks, key=lambda b: b.round()))
        newly_processed: List[Tuple[WalPosition, StatementBlock]] = []
        missing_references: Set[BlockReference] = set()
        while queue:
            block = queue.popleft()
            reference = block.reference
            if reference.round < self.gc_floor:
                # Settled history: consensus has permanently moved past this
                # round and the store retired it.  Re-ingesting (a straggler
                # re-delivering an ancient block, a far-behind peer's stale
                # proposal) would re-vote and re-include blocks every healthy
                # aggregator already certified-and-retired — drop it.
                continue
            if self.block_store.block_exists(reference) or reference in self.blocks_pending:
                continue

            processed = True
            for include in block.includes:
                if include.round < self.gc_floor:
                    continue  # settled below the GC floor: never park on it
                if self.block_store.block_exists(include):
                    continue
                processed = False
                # Report an unseen parent only the first time anyone waits on it
                # and it is not itself parked here (block_manager.rs:80-88).
                if (
                    include not in self.block_references_waiting
                    and include not in self.blocks_pending
                ):
                    missing_references.add(include)
                self.block_references_waiting.setdefault(include, set()).add(reference)
                if include not in self.blocks_pending:
                    self.missing[include.authority].add(include)
            self.missing[reference.authority].discard(reference)

            if not processed:
                self.blocks_pending[reference] = block
                if self._metrics is not None:
                    self._metrics.blocks_suspended.inc()
                continue

            position = block_writer.insert_block(block)
            newly_processed.append((position, block))

            # Release any parked blocks that were waiting on this one and now
            # have all parents stored (block_manager.rs:112-131).
            waiting = self.block_references_waiting.pop(reference, None)
            if waiting:
                for waiting_ref in waiting:
                    parked = self.blocks_pending[waiting_ref]
                    if all(
                        inc not in self.block_references_waiting
                        for inc in parked.includes
                    ):
                        queue.appendleft(self.blocks_pending.pop(waiting_ref))

        return newly_processed, missing_references

    def missing_blocks(self) -> List[Set[BlockReference]]:
        return self.missing

    def exists_or_pending(self, reference: BlockReference) -> bool:
        # Sub-floor references read as settled so the dedup gate drops their
        # re-deliveries BEFORE paying signature verification.
        if reference.round < self.gc_floor:
            return True
        return self.block_store.block_exists(reference) or reference in self.blocks_pending
