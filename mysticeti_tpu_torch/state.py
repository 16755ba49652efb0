"""Crash-recovery state folding: WAL replay -> core + commit-observer state.

The port's copy of ``mysticeti_tpu.state``.

Capability parity with ``mysticeti-core/src/state.rs``:

* ``CoreRecoveredState``  (state.rs:13-20) — block store, last own block, pending
  proposal queue, handler state snapshot, blocks to re-run through the handler,
  last committed leader.
* ``CommitObserverRecoveredState`` (commit_observer.rs) — committed sub-dags +
  committed-transaction aggregator state.
* ``RecoveredStateBuilder`` (state.rs:23-95) — folds the five WAL entry kinds:
  block/payload entries accumulate into the pending queue; an own-block entry
  drops every pending entry before its ``next_entry`` cursor (those were consumed
  by that proposal, state.rs:49-54); a state snapshot clears the unprocessed-block
  replay list (state.rs:56-59); commit entries track commit history + state.

``MetaStatement`` (core.rs:61-65) lives here so both ``core`` and this module can
use it without a cycle: Include(reference) | Payload(list-of-statements).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple, Union

from collections import deque

from .block_store import CommitData, OwnBlockData
from .serde import Reader, Writer
from .types import (
    BaseStatement,
    BlockReference,
    StatementBlock,
    decode_statement,
    encode_statements,
)
from .wal import WalPosition


@dataclass(frozen=True)
class Include:
    """Pending reference to another authority's block (core.rs:63)."""

    reference: BlockReference


@dataclass(frozen=True)
class Payload:
    """Pending own statements produced by the block handler (core.rs:64)."""

    statements: Tuple[BaseStatement, ...]


MetaStatement = Union[Include, Payload]


def encode_payload(statements) -> bytes:
    w = Writer()
    w.u32(len(statements))
    encode_statements(w, statements)
    return w.finish()


def decode_payload(data: bytes) -> Tuple[BaseStatement, ...]:
    r = Reader(data)
    statements = tuple(decode_statement(r) for _ in range(r.u32()))
    r.expect_done()
    return statements


@dataclass
class CoreRecoveredState:
    """Everything ``Core.open`` needs to resume exactly where the crash left off."""

    block_store: object  # BlockStore (untyped to avoid cycle)
    last_own_block: Optional[OwnBlockData]
    pending: Deque[Tuple[WalPosition, MetaStatement]]
    state: Optional[bytes]
    unprocessed_blocks: List[StatementBlock]
    last_committed_leader: Optional[BlockReference]
    # Commit baseline (storage.py): the commit chain as of the end of
    # replay, from a snapshot-adoption entry plus every replayed commit,
    # and how many WAL bytes the replay read.
    commit_height: int = 0
    chain_digest: bytes = b""
    gc_round: int = 0
    replayed_bytes: int = 0
    # Reconfiguration (reconfig.py): the serialized epoch chain from the
    # recovering checkpoint/snapshot, plus the commits replayed AFTER that
    # baseline — Core re-scans them so a crash between a boundary commit and
    # the next checkpoint still reboots into the right epoch.
    epoch_chain: bytes = b""
    recovered_commits: List[CommitData] = field(default_factory=list)
    # Execution plane (execution.py): the serialized account state from the
    # recovering checkpoint/snapshot; Core re-folds the post-baseline
    # ``recovered_commits`` on top so the node reboots onto the exact root
    # it crashed out of.
    exec_state: bytes = b""


@dataclass
class CommitObserverRecoveredState:
    sub_dags: List[CommitData] = field(default_factory=list)
    state: Optional[bytes] = None
    # Checkpoint/snapshot baseline: the linearizer resumes at ``base_height``
    # with ``base_committed`` already sequenced and everything below
    # ``gc_round`` settled (storage.py).  ``sub_dags`` then carries only the
    # commits replayed AFTER the baseline.
    base_height: int = 0
    base_committed: List[BlockReference] = field(default_factory=list)
    gc_round: int = 0


class RecoveredStateBuilder:
    """Folds WAL replay entries in log order (state.rs:23-95)."""

    def __init__(self) -> None:
        # position -> raw meta statement; kept sorted by insertion (wal order).
        self._pending: Dict[WalPosition, MetaStatement] = {}
        self._last_own_block: Optional[OwnBlockData] = None
        self._state: Optional[bytes] = None
        self._unprocessed_blocks: List[StatementBlock] = []
        self._last_committed_leader: Optional[BlockReference] = None
        self._committed_sub_dags: List[CommitData] = []
        self._committed_state: Optional[bytes] = None
        # Commit chain state (storage.py): folded from a snapshot baseline
        # plus every replayed commit entry.
        self._commit_height = 0
        self._chain_digest = b"\x00" * 32
        self._gc_round = 0
        self._base_height = 0
        self._base_committed: List[BlockReference] = []
        self._replayed_bytes = 0
        self._epoch_chain = b""
        self._exec_state = b""

    def snapshot(self, manifest) -> None:
        """Fold a persisted snapshot-adoption entry (WAL_ENTRY_SNAPSHOT): the
        node adopted a remote commit baseline mid-run; recovery must resume
        from the SAME baseline, and every commit folded before the adoption
        sits below it (the observer must not re-deliver them)."""
        self._last_committed_leader = manifest.last_committed_leader
        self._commit_height = manifest.commit_height
        self._chain_digest = manifest.chain_digest
        self._gc_round = max(self._gc_round, manifest.gc_round)
        self._base_height = manifest.commit_height
        self._base_committed = list(manifest.committed_refs)
        self._committed_sub_dags = []
        if manifest.epoch_chain:
            self._epoch_chain = manifest.epoch_chain
        if manifest.exec_state:
            self._exec_state = manifest.exec_state

    def note_replayed(self, replayed_bytes: int) -> None:
        self._replayed_bytes = replayed_bytes

    def block(self, pos: WalPosition, block: StatementBlock) -> None:
        self._pending[pos] = Include(block.reference)
        self._unprocessed_blocks.append(block)

    def payload(self, pos: WalPosition, payload: bytes) -> None:
        self._pending[pos] = Payload(decode_payload(payload))

    def own_block(self, own: OwnBlockData) -> None:
        # Drop pending entries the proposal already consumed (state.rs:49-54);
        # next_entry == POSITION_MAX drops everything.
        self._pending = {
            pos: st for pos, st in self._pending.items() if pos >= own.next_entry
        }
        self._unprocessed_blocks.append(own.block)
        self._last_own_block = own

    def state(self, state: bytes) -> None:
        self._state = state
        self._unprocessed_blocks.clear()

    def commit_data(self, commits: List[CommitData], committed_state: bytes) -> None:
        from .storage import fold_leader_digest

        for commit in commits:
            self._last_committed_leader = commit.leader
            if self._committed_sub_dags:
                assert commit.height > self._committed_sub_dags[-1].height
            self._committed_sub_dags.append(commit)
            self._commit_height = commit.height
            self._chain_digest = fold_leader_digest(
                self._chain_digest, commit.leader
            )
        self._committed_state = committed_state

    def build(
        self, block_store
    ) -> Tuple[CoreRecoveredState, CommitObserverRecoveredState]:
        pending: Deque[Tuple[WalPosition, MetaStatement]] = deque(
            sorted(self._pending.items())
        )
        core = CoreRecoveredState(
            block_store=block_store,
            last_own_block=self._last_own_block,
            pending=pending,
            state=self._state,
            unprocessed_blocks=self._unprocessed_blocks,
            last_committed_leader=self._last_committed_leader,
            commit_height=self._commit_height,
            chain_digest=self._chain_digest,
            gc_round=self._gc_round,
            replayed_bytes=self._replayed_bytes,
            epoch_chain=self._epoch_chain,
            recovered_commits=list(self._committed_sub_dags),
            exec_state=self._exec_state,
        )
        observer = CommitObserverRecoveredState(
            sub_dags=self._committed_sub_dags,
            state=self._committed_state,
            base_height=self._base_height,
            base_committed=self._base_committed,
            gc_round=self._gc_round,
        )
        return core, observer
