"""Storage lifecycle plane: the parts the consensus core reaches.

The port's copy of ``mysticeti_tpu.storage``, trimmed to what the block
store, the recovery fold and the snapshot catch-up wire payload need: the
file-name and magic constants, the committed-leader digest chain
(:func:`fold_leader_digest`) and :class:`SnapshotManifest`.  The segmented
WAL, commit-anchored checkpoints, DAG garbage collection and
``StorageLifecycle`` are not in the port yet: a node of the port runs on the
single-file ``walf`` log (no rolling, no checkpoints, unbounded log).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .serde import Reader, SerdeError, Writer
from .types import BlockReference

MANIFEST_NAME = "MANIFEST.json"
SEGMENT_PREFIX = "wal."
CHECKPOINT_PREFIX = "checkpoint."
CHECKPOINT_KEEP = 2  # newest N checkpoint files survive pruning

CHECKPOINT_MAGIC = 0x31504B43  # b"CKP1" little-endian
SNAPSHOT_MAGIC = 0x31504E53  # b"SNP1" little-endian

ZERO_DIGEST = b"\x00" * 32


def fold_leader_digest(digest: bytes, leader: BlockReference) -> bytes:
    """One step of the committed-leader digest chain:
    ``d_h = BLAKE2b-256(d_{h-1} || leader_ref_bytes)``.

    A 32-byte rolling commitment to the whole committed-leader sequence —
    two nodes agreeing on the chain digest at height ``h`` agree on every
    anchor up to ``h`` (the snapshot catch-up prefix-consistency handle)."""
    import hashlib

    w = Writer()
    leader.encode(w)
    h = hashlib.blake2b(digest_size=32)
    h.update(digest)
    h.update(w.finish())
    return h.digest()


def _write_opt_ref(w: Writer, ref: Optional[BlockReference]) -> None:
    if ref is None:
        w.u8(0)
    else:
        w.u8(1)
        ref.encode(w)


def _read_opt_ref(r: Reader) -> Optional[BlockReference]:
    return BlockReference.decode(r) if r.u8() else None


# Snapshot catch-up manifest (wire payload, tags 9/10/11)


@dataclass
class SnapshotManifest:
    """The commit baseline a far-behind peer adopts: everything needed to
    resume committing at ``commit_height + 1`` once the block window above
    ``gc_round`` has been streamed in."""

    commit_height: int
    last_committed_leader: Optional[BlockReference]
    gc_round: int
    chain_digest: bytes
    committed_refs: List[BlockReference] = field(default_factory=list)
    # Reconfiguration: the serving node's epoch chain — a rejoiner absent
    # across one or more boundaries re-derives the CURRENT committee from
    # this before processing the post-baseline block stream.  Soft tail
    # (omitted when empty), so pre-reconfig manifests stay byte-identical
    # and decode fine both ways.
    epoch_chain: bytes = b""
    # Execution plane: the serving node's account state at the baseline —
    # the rejoiner lands on the fleet's exact root.  Second soft tail with
    # the same ordering rule as Checkpoint.exec_state.
    exec_state: bytes = b""

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u32(SNAPSHOT_MAGIC).u32(1)
        w.u64(self.commit_height).u64(self.gc_round)
        _write_opt_ref(w, self.last_committed_leader)
        w.fixed(self.chain_digest)
        w.u32(len(self.committed_refs))
        for ref in self.committed_refs:
            ref.encode(w)
        if self.exec_state:
            w.bytes(self.epoch_chain)
            w.bytes(self.exec_state)
        elif self.epoch_chain:
            w.bytes(self.epoch_chain)
        return w.finish()

    @staticmethod
    def from_bytes(data: bytes) -> "SnapshotManifest":
        r = Reader(data)
        if r.u32() != SNAPSHOT_MAGIC:
            raise SerdeError("bad snapshot manifest magic")
        version = r.u32()
        if version != 1:
            raise SerdeError(f"unsupported snapshot manifest version {version}")
        commit_height = r.u64()
        gc_round = r.u64()
        leader = _read_opt_ref(r)
        chain_digest = r.fixed(32)
        refs = [BlockReference.decode(r) for _ in range(r.u32())]
        epoch_chain = r.bytes() if not r.done() else b""
        exec_state = r.bytes() if not r.done() else b""
        r.expect_done()
        return SnapshotManifest(
            commit_height=commit_height,
            last_committed_leader=leader,
            gc_round=gc_round,
            chain_digest=chain_digest,
            committed_refs=refs,
            epoch_chain=epoch_chain,
            exec_state=exec_state,
        )
