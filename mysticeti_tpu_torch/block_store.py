"""Round-indexed block store over the WAL, with recovery replay.

The port's copy of ``mysticeti_tpu.block_store``.

Capability parity with ``mysticeti-core/src/block_store.rs``:

* index: round -> {(authority, digest) -> IndexEntry}, loaded/unloaded cache states
  (block_store.rs:28-47)
* ``BlockStore.open`` — WAL replay feeding a ``RecoveredStateBuilder`` (block_store.rs:50-116)
* DAG queries: ``get_blocks_by_round`` (:129), ``get_blocks_at_authority_round`` (:134),
  existence checks (:146-178), ancestry ``linked`` / ``linked_to_round`` (:284-327)
* dissemination cursors ``get_own_blocks`` / ``get_others_blocks`` (:220-240,434-476)
* cache eviction ``cleanup`` -> ``unload_below_round`` (:207-218,374-396)
* ``BlockWriter`` write-through (:38-41,504-518); ``OwnBlockData`` framing
  {next_entry, block} (:521-550); serializable ``CommitData`` (:552-573)
* WAL entry tags (:496-502)

Design notes: a single ``threading.RLock`` replaces the reference's parking_lot
RwLock — mutation comes only from the consensus owner task, readers may be the
metrics reporter or the dissemination tasks.  ``IndexEntry`` is a ``(position,
block-or-None)`` tuple rather than an enum; ``None`` means unloaded (read back
through the WAL mmap on demand).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .serde import Reader, Writer
from .tracing import logger
from .types import (
    AuthorityIndex,
    BlockReference,
    RoundNumber,
    Share,
    StatementBlock,
    TransactionLocator,
)
from .wal import HEADER_SIZE, Tag, WalPosition, WalReader, WalWriter

log = logger(__name__)

WAL_ENTRY_BLOCK: Tag = 1
WAL_ENTRY_PAYLOAD: Tag = 2
WAL_ENTRY_OWN_BLOCK: Tag = 3
WAL_ENTRY_STATE: Tag = 4
# Commit entry carries both the linearizer's incremental state and the committed
# transaction-aggregator state (block_store.rs:500-502).
WAL_ENTRY_COMMIT: Tag = 5
# Snapshot catch-up adoption (storage.py): the node adopted a remote commit
# baseline mid-run; the persisted SnapshotManifest re-seeds the commit chain
# on the next recovery so the adopted prefix survives a crash.
WAL_ENTRY_SNAPSHOT: Tag = 6

_OWN_BLOCK_HEADER_SIZE = 8  # u64 next_entry (block_store.rs:526)

# IndexEntry: (wal position, loaded block or None)
IndexEntry = Tuple[WalPosition, Optional[StatementBlock]]


@dataclass
class OwnBlockData:
    """Own proposal + the WAL cursor past consumed pending entries (block_store.rs:521-550)."""

    next_entry: WalPosition
    block: StatementBlock

    def to_bytes(self) -> bytes:
        return self.next_entry.to_bytes(8, "little") + self.block.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "OwnBlockData":
        next_entry = int.from_bytes(data[:_OWN_BLOCK_HEADER_SIZE], "little")
        block = StatementBlock.from_bytes(data[_OWN_BLOCK_HEADER_SIZE:])
        return OwnBlockData(next_entry, block)

    def write_to_wal(self, writer: WalWriter) -> WalPosition:
        header = self.next_entry.to_bytes(8, "little")
        return writer.writev(WAL_ENTRY_OWN_BLOCK, (header, self.block.to_bytes()))


@dataclass
class CommitData:
    """Serializable CommittedSubDag: anchor + all block refs + height (block_store.rs:552-573)."""

    leader: BlockReference
    sub_dag: List[BlockReference]
    height: int

    def encode(self, w: Writer) -> None:
        self.leader.encode(w)
        w.u32(len(self.sub_dag))
        for ref in self.sub_dag:
            ref.encode(w)
        w.u64(self.height)

    @staticmethod
    def decode(r: Reader) -> "CommitData":
        leader = BlockReference.decode(r)
        sub_dag = [BlockReference.decode(r) for _ in range(r.u32())]
        return CommitData(leader, sub_dag, r.u64())


class BlockStore:
    """The DAG index.  Cheap to share (all methods take the internal lock)."""

    def __init__(
        self,
        authority: AuthorityIndex,
        num_authorities: int,
        wal_reader: WalReader,
        metrics=None,
    ) -> None:
        self._lock = threading.RLock()
        self._index: Dict[
            RoundNumber, Dict[Tuple[AuthorityIndex, bytes], IndexEntry]
        ] = {}
        self._own_blocks: Dict[RoundNumber, bytes] = {}
        self._highest_round: RoundNumber = 0
        self._authority = authority
        self._last_seen_by_authority: List[RoundNumber] = [0] * num_authorities
        self._last_own_block: Optional[BlockReference] = None
        self._wal_reader = wal_reader
        self._metrics = metrics
        # Equivocation detection (docs/adversary.md): per-authority count of
        # EXTRA digests observed live at an (authority, round) the index
        # already holds — the generalized form of the post-crash own-block
        # double-proposal handling below.  Detection fires on LIVE inserts
        # only (replay re-observes history already counted pre-crash) and
        # once per distinct conflicting digest (the index key existing means
        # this copy was already seen).  ``recorder`` (an optional
        # FlightRecorder) gets the event edge; the counter is
        # mysticeti_equivocation_detected_total{authority}.
        self.recorder = None
        self.equivocations_detected: Dict[AuthorityIndex, int] = {}

    # -- recovery (block_store.rs:50-116) --

    @classmethod
    def open(
        cls,
        authority: AuthorityIndex,
        wal_reader: WalReader,
        wal_writer: WalWriter,
        committee,
        metrics=None,
    ):
        """Replay the WAL, building the index and the recovered core/observer state.

        Returns ``(CoreRecoveredState, CommitObserverRecoveredState)``; the block
        store itself rides inside the core state (state.rs:72-94).

        The JAX package's checkpoints (a replay that starts past byte zero)
        are not in the port yet: replay starts at byte zero.
        """
        from .state import RecoveredStateBuilder

        store = cls(authority, len(committee), wal_reader, metrics)
        builder = RecoveredStateBuilder()
        replayed_end: WalPosition = 0
        for pos, tag, payload in wal_reader.iter_from(
            0, wal_writer.position()
        ):
            replayed_end = pos + HEADER_SIZE + len(payload)
            if tag == WAL_ENTRY_BLOCK:
                block = StatementBlock.from_bytes(payload)
                builder.block(pos, block)
            elif tag == WAL_ENTRY_PAYLOAD:
                builder.payload(pos, payload)
                continue
            elif tag == WAL_ENTRY_OWN_BLOCK:
                own = OwnBlockData.from_bytes(payload)
                builder.own_block(own)
                block = own.block
            elif tag == WAL_ENTRY_STATE:
                builder.state(payload)
                continue
            elif tag == WAL_ENTRY_COMMIT:
                r = Reader(payload)
                commits = [CommitData.decode(r) for _ in range(r.u32())]
                committed_state = r.bytes()
                r.expect_done()
                builder.commit_data(commits, committed_state)
                continue
            elif tag == WAL_ENTRY_SNAPSHOT:
                from .storage import SnapshotManifest

                builder.snapshot(SnapshotManifest.from_bytes(payload))
                continue
            else:
                raise ValueError(f"unknown wal tag {tag} at position {pos}")
            store._add_unloaded(
                block.reference, pos, proposed=tag == WAL_ENTRY_OWN_BLOCK
            )
            wal_writer.note_round(block.reference.round, pos)
        builder.note_replayed(replayed_end)
        if replayed_end < wal_writer.position():
            # Torn tail (crash mid-write): replay stopped at the tear.  The
            # torn bytes must be truncated away before the first new append —
            # writing past them would leave an unreplayable gap that silently
            # loses every subsequent entry on the NEXT recovery.
            log.warning(
                "torn WAL tail: replay stopped at %d, discarding %d trailing "
                "bytes", replayed_end, wal_writer.position() - replayed_end,
            )
            wal_writer.truncate_to(replayed_end)
            wal_reader.cleanup()  # drop any mapping that covers the old size
        return builder.build(store)

    # -- writes --

    def insert_block(
        self, block: StatementBlock, position: WalPosition,
        proposed: bool = False,
    ) -> None:
        equivocated = False
        with self._lock:
            self._highest_round = max(self._highest_round, block.round())
            self._add_own_index(block.reference, proposed)
            self._update_last_seen(block.reference)
            entries = self._index.setdefault(block.round(), {})
            key = (block.author(), block.digest())
            if key not in entries and any(
                a == block.author() for (a, _) in entries
            ):
                # A SECOND distinct digest from this authority at this
                # round: equivocation, observed the moment the conflicting
                # copy lands in the DAG (valid signature and all — only
                # the index can see a double proposal).
                equivocated = True
                author = block.author()
                self.equivocations_detected[author] = (
                    self.equivocations_detected.get(author, 0) + 1
                )
            entries[key] = (position, block)
        if equivocated:
            log.warning(
                "equivocation detected: authority %d proposed a second "
                "block at round %d", block.author(), block.round(),
            )
            if self._metrics is not None:
                self._metrics.mysticeti_equivocation_detected_total.labels(
                    str(block.author())
                ).inc()
            if self.recorder is not None:
                self.recorder.record(
                    "equivocation-detected",
                    authority=block.author(),
                    round=block.round(),
                )

    def _add_unloaded(
        self, reference: BlockReference, position: WalPosition,
        proposed: bool = False,
    ) -> None:
        self._highest_round = max(self._highest_round, reference.round)
        self._add_own_index(reference, proposed)
        self._update_last_seen(reference)
        self._index.setdefault(reference.round, {})[
            (reference.authority, reference.digest)
        ] = (position, None)

    def _add_own_index(
        self, reference: BlockReference, proposed: bool = False
    ) -> None:
        """``proposed`` marks OUR proposal write path (``insert_own_block``
        and OWN_BLOCK replay) as opposed to a peer-delivered or fetched copy
        of an own-authority block."""
        if reference.authority != self._authority:
            return
        last = self._last_own_block.round if self._last_own_block else 0
        if reference.round > last:
            self._last_own_block = reference
        prev = self._own_blocks.get(reference.round)
        if prev is not None:
            if prev != reference.digest:
                # Post-crash equivocation: with fsync=false a torn WAL tail
                # can lose our own last proposal; after restart we re-propose
                # that round and may ALSO receive the lost block back from
                # peers (it sits in their causal histories).  The block we
                # actually PROPOSED must win the dissemination index — our
                # subsequent blocks build on it, and serving the stale copy
                # from get_own_blocks would push every post-restart proposal
                # through the slow missing-parent path.  Either way this is
                # a warning, never a raise: consensus tolerates the
                # equivocation like any other Byzantine double-proposal,
                # whereas crashing here would turn a recovered node into a
                # crash loop.
                if proposed:
                    self._own_blocks[reference.round] = reference.digest
                    if (
                        self._last_own_block is not None
                        and self._last_own_block.round == reference.round
                    ):
                        self._last_own_block = reference
                log.warning(
                    "own-block conflict at round %d (pre-crash proposal lost "
                    "to a torn WAL?); keeping the %s digest",
                    reference.round,
                    "re-proposed" if proposed else "first-indexed",
                )
            return
        self._own_blocks[reference.round] = reference.digest

    def _update_last_seen(self, reference: BlockReference) -> None:
        if reference.authority < len(self._last_seen_by_authority):
            if reference.round > self._last_seen_by_authority[reference.authority]:
                self._last_seen_by_authority[reference.authority] = reference.round

    # -- entry loading --

    def _load(self, entry: IndexEntry) -> StatementBlock:
        position, block = entry
        if block is not None:
            return block
        if self._metrics is not None:
            self._metrics.block_store_loaded_blocks.inc()
        tag, payload = self._wal_reader.read(position)
        if tag == WAL_ENTRY_BLOCK:
            return StatementBlock.from_bytes(payload)
        if tag == WAL_ENTRY_OWN_BLOCK:
            return OwnBlockData.from_bytes(payload).block
        raise ValueError(f"index entry at {position} has non-block tag {tag}")

    # -- queries --

    def get_block(self, reference: BlockReference) -> Optional[StatementBlock]:
        with self._lock:
            entry = self._index.get(reference.round, {}).get(
                (reference.authority, reference.digest)
            )
        return self._load(entry) if entry is not None else None

    def block_exists(self, reference: BlockReference) -> bool:
        with self._lock:
            return (reference.authority, reference.digest) in self._index.get(
                reference.round, {}
            )

    def get_blocks_by_round(self, round_: RoundNumber) -> List[StatementBlock]:
        with self._lock:
            entries = list(self._index.get(round_, {}).values())
        return [self._load(e) for e in entries]

    def get_blocks_at_authority_round(
        self, authority: AuthorityIndex, round_: RoundNumber
    ) -> List[StatementBlock]:
        with self._lock:
            entries = [
                e
                for (a, _), e in self._index.get(round_, {}).items()
                if a == authority
            ]
        return [self._load(e) for e in entries]

    def block_exists_at_authority_round(
        self, authority: AuthorityIndex, round_: RoundNumber
    ) -> bool:
        with self._lock:
            return any(a == authority for (a, _) in self._index.get(round_, {}))

    def all_blocks_exists_at_authority_round(
        self, authorities: Sequence[AuthorityIndex], round_: RoundNumber
    ) -> bool:
        with self._lock:
            present = {a for (a, _) in self._index.get(round_, {})}
        return all(a in present for a in authorities)

    def get_transaction(self, locator: TransactionLocator) -> Optional[bytes]:
        block = self.get_block(locator.block)
        if block is None or locator.offset >= len(block.statements):
            return None
        st = block.statements[locator.offset]
        return st.transaction if isinstance(st, Share) else None

    def len_expensive(self) -> int:
        with self._lock:
            return sum(len(m) for m in self._index.values())

    def highest_round(self) -> RoundNumber:
        with self._lock:
            return self._highest_round

    def last_seen_by_authority(self, authority: AuthorityIndex) -> RoundNumber:
        with self._lock:
            return self._last_seen_by_authority[authority]

    def last_own_block_ref(self) -> Optional[BlockReference]:
        with self._lock:
            return self._last_own_block

    @property
    def authority(self) -> AuthorityIndex:
        """The owning validator's index (immutable; set at open)."""
        return self._authority

    # -- dissemination cursors (block_store.rs:220-240,434-476) --

    def get_own_blocks(
        self, from_excluded: RoundNumber, limit: int
    ) -> List[StatementBlock]:
        with self._lock:
            rounds = sorted(r for r in self._own_blocks if r > from_excluded)[:limit]
            entries = [
                self._index[r][(self._authority, self._own_blocks[r])] for r in rounds
            ]
        return [self._load(e) for e in entries]

    def get_others_blocks(
        self, from_excluded: RoundNumber, authority: AuthorityIndex, limit: int
    ) -> List[StatementBlock]:
        with self._lock:
            entries: List[IndexEntry] = []
            for r in sorted(r for r in self._index if r > from_excluded):
                if len(entries) >= limit:
                    break
                for (a, _), e in self._index[r].items():
                    if a == authority:
                        entries.append(e)
            entries = entries[:limit]
        return [self._load(e) for e in entries]

    # -- ancestry (block_store.rs:284-327) --

    def linked(self, later: StatementBlock, earlier: StatementBlock) -> bool:
        """Is ``earlier`` an ancestor of ``later``?  Round-by-round frontier walk."""
        parents = [later]
        for r in range(later.round() - 1, earlier.round() - 1, -1):
            parent_refs = {inc for p in parents for inc in p.includes}
            parents = [
                b for b in self.get_blocks_by_round(r) if b.reference in parent_refs
            ]
        return earlier in parents

    def linked_to_round(
        self, later: StatementBlock, earlier_round: RoundNumber
    ) -> List[StatementBlock]:
        """All ancestors of ``later`` at ``earlier_round`` reachable via includes."""
        parents = [later]
        for r in range(later.round() - 1, earlier_round - 1, -1):
            parent_refs = {inc for p in parents for inc in p.includes}
            parents = [
                b for b in self.get_blocks_by_round(r) if b.reference in parent_refs
            ]
            if not parents:
                break
        return parents

    # -- cache eviction (block_store.rs:207-218,374-396) --

    def cleanup(self, threshold_round: RoundNumber) -> int:
        if threshold_round == 0:
            return 0
        unloaded = 0
        with self._lock:
            for round_, m in self._index.items():
                if round_ > threshold_round:
                    continue
                for key, (pos, block) in m.items():
                    if block is not None:
                        m[key] = (pos, None)
                        unloaded += 1
        self._wal_reader.cleanup()
        if self._metrics is not None and unloaded:
            self._metrics.block_store_unloaded_blocks.inc(unloaded)
        return unloaded

    def close(self) -> None:
        """Release the WAL reader (mmap + fd).  Crash-restart simulation
        reopens the same path many times in one process; without this every
        restart would leak a descriptor and a mapping for the sim's whole
        lifetime."""
        self._wal_reader.close()


class BlockWriter:
    """Write-through of blocks to WAL + index (block_store.rs:504-518).

    The reference implements this as a trait on ``(&mut WalWriter, &BlockStore)``;
    here it is a tiny binding object constructed wherever both halves are in hand.
    """

    __slots__ = ("wal_writer", "block_store")

    def __init__(self, wal_writer: WalWriter, block_store: BlockStore) -> None:
        self.wal_writer = wal_writer
        self.block_store = block_store

    def insert_block(self, block: StatementBlock) -> WalPosition:
        pos = self.wal_writer.write(WAL_ENTRY_BLOCK, block.to_bytes())
        self.block_store.insert_block(block, pos)
        self.wal_writer.note_round(block.round(), pos)
        return pos

    def insert_own_block(self, data: OwnBlockData) -> WalPosition:
        pos = data.write_to_wal(self.wal_writer)
        self.block_store.insert_block(data.block, pos, proposed=True)
        self.wal_writer.note_round(data.block.round(), pos)
        return pos
