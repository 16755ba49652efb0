"""Commit-anchored epoch reconfiguration: dynamic committee membership.

The port's copy of ``mysticeti_tpu.reconfig``.

The committed leader sequence of an uncertified DAG is a total order every
honest node derives identically, which makes it a natural reconfiguration
anchor (the Mysticeti paper notes this; the reference implementation never
built it).  This module is the pure machinery:

* ``CommitteeChange`` — an add/remove/reweight transaction that rides the
  committed sequence as an ordinary ``Share`` payload prefixed with
  ``RECONFIG_MAGIC``.
* ``committee_digest`` — canonical 32-byte digest of (epoch, stakes, keys);
  two nodes in the same epoch with different digests have diverged.
* ``apply_change`` — pure committee derivation (epoch + 1); invalid changes
  (activating an active member, removing an inactive one, reweighting to the
  current stake) are deterministic no-ops, which makes duplicate transactions
  idempotent without any extra bookkeeping.
* ``EpochRecord`` / ``EpochChain`` — the durable epoch history: each record
  pins (epoch, boundary commit height, boundary leader round, digest, stake
  vector).  The chain rides checkpoints and snapshot manifests as a soft
  serialization tail, so crash recovery and cross-boundary catch-up both
  reboot into the right epoch.
* ``ReconfigState`` — the per-node state machine owned by the consensus
  core: scans each committed sub-dag (in linearized order, one commit at a
  time) for change transactions and produces :class:`EpochTransition`\\ s.

Membership model — stable indices
---------------------------------
The full *potential* membership is registered at genesis; every authority
keeps its index, key, and genesis block forever.  An ADD activates a
registered member (stake 0 → s), a REMOVE deactivates one (stake → 0, index
retained), a REWEIGHT changes a positive stake.  The active set is exactly
the positive-stake set: zero-stake members contribute nothing to quorum or
validity thresholds and are provably unelectable under the stake-weighted
leader PRF (the accumulator never advances past them).  Keeping indices
stable means ``BlockReference.authority`` and every persisted structure stay
valid across epochs.  Registering *new* keys after genesis is out of scope
(see docs/reconfiguration.md trust notes).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .committee import Authority, Committee
from .serde import Reader, SerdeError, Writer
from .types import Share, StatementBlock

# Share-payload prefix marking a committee-change transaction.  8 bytes so an
# accidental collision with benchmark payloads (8-byte little-endian counters
# and stamped random bytes) is vanishingly unlikely, and the first byte 0xFF
# is unreachable for any counter below 2**63.
RECONFIG_MAGIC = b"\xffRECONF\x01"

CHANGE_ADD = 0  # activate a registered authority: stake 0 -> stake
CHANGE_REMOVE = 1  # deactivate: stake -> 0 (index and key retained)
CHANGE_REWEIGHT = 2  # change a positive stake to another positive stake

_KIND_NAMES = {CHANGE_ADD: "add", CHANGE_REMOVE: "remove", CHANGE_REWEIGHT: "reweight"}


@dataclass(frozen=True)
class CommitteeChange:
    """One membership/stake change riding the committed sequence."""

    kind: int
    authority: int
    stake: int = 0

    def __post_init__(self) -> None:
        if self.kind not in _KIND_NAMES:
            raise ValueError(f"unknown change kind {self.kind}")
        if self.kind in (CHANGE_ADD, CHANGE_REWEIGHT) and self.stake <= 0:
            raise ValueError(f"{_KIND_NAMES[self.kind]} requires positive stake")
        if self.stake < 0:
            raise ValueError("stake must be non-negative")

    def to_bytes(self) -> bytes:
        w = Writer()
        w.fixed(RECONFIG_MAGIC)
        w.u8(self.kind)
        w.u64(self.authority)
        w.u64(self.stake)
        return w.finish()

    @staticmethod
    def from_bytes(data: bytes) -> "CommitteeChange":
        r = Reader(data)
        magic = r.fixed(len(RECONFIG_MAGIC))
        if magic != RECONFIG_MAGIC:
            raise SerdeError("not a reconfiguration transaction")
        kind = r.u8()
        authority = r.u64()
        stake = r.u64()
        r.expect_done()
        return CommitteeChange(kind, authority, stake)

    def describe(self) -> str:
        return f"{_KIND_NAMES[self.kind]}(authority={self.authority}, stake={self.stake})"


def parse_reconfig_tx(payload: bytes) -> Optional[CommitteeChange]:
    """Decode a Share payload into a change, or None for ordinary
    transactions.  A payload that carries the magic but fails to decode is
    treated as ordinary data (a garbled change must not fork honest nodes on
    whether to error — ignoring it is the deterministic choice)."""
    if not payload.startswith(RECONFIG_MAGIC):
        return None
    try:
        return CommitteeChange.from_bytes(payload)
    except (SerdeError, ValueError):
        return None


def committee_digest(committee: Committee) -> bytes:
    """Canonical digest of one epoch's committee: blake2b-256 over
    (epoch, count, per-authority (key, stake)) in index order.  Hostnames and
    election strategy are deployment-local and excluded."""
    h = hashlib.blake2b(b"mysticeti-tpu/committee", digest_size=32)
    h.update(committee.epoch.to_bytes(8, "little"))
    h.update(len(committee).to_bytes(4, "little"))
    for a in committee.authorities:
        h.update(a.public_key.bytes)
        h.update(a.stake.to_bytes(8, "little"))
    return h.digest()


def change_is_valid(committee: Committee, change: CommitteeChange) -> bool:
    """Is ``change`` applicable to ``committee``?  Validity against the
    *current* committee is what makes duplicate submissions idempotent: the
    first application flips the state the duplicate's validity depends on."""
    if not committee.known_authority(change.authority):
        return False
    current = committee.get_stake(change.authority)
    if change.kind == CHANGE_ADD:
        return current == 0
    if change.kind == CHANGE_REMOVE:
        if current == 0:
            return False
        # Never deactivate the last active member: an empty active set has
        # no quorum and the fleet would halt unrecoverably.
        return sum(1 for a in committee.authorities if a.stake > 0) > 1
    # CHANGE_REWEIGHT
    return current > 0 and change.stake != current


def apply_change(committee: Committee, change: CommitteeChange) -> Optional[Committee]:
    """Derive the next epoch's committee, or None when the change is a
    no-op.  Pure: keys, hostnames, and election strategy carry over; only the
    targeted stake and the epoch number move."""
    if not change_is_valid(committee, change):
        return None
    stakes = [a.stake for a in committee.authorities]
    stakes[change.authority] = 0 if change.kind == CHANGE_REMOVE else change.stake
    return committee.with_stakes(stakes, committee.epoch + 1)


@dataclass(frozen=True)
class EpochRecord:
    """One epoch boundary: the commit that finalized the change and the
    committee it produced (as its full stake vector — keys are stable, so
    stakes + the genesis registry reproduce the committee exactly)."""

    epoch: int
    boundary_height: int  # commit height whose sub-dag carried the change
    boundary_round: int  # that commit's anchor (leader) round
    digest: bytes  # committee_digest of the epoch's committee
    stakes: Tuple[int, ...]

    def encode(self, w: Writer) -> None:
        w.u64(self.epoch).u64(self.boundary_height).u64(self.boundary_round)
        w.fixed(self.digest)
        w.u32(len(self.stakes))
        for s in self.stakes:
            w.u64(s)

    @staticmethod
    def decode(r: Reader) -> "EpochRecord":
        epoch, height, round_ = r.u64(), r.u64(), r.u64()
        digest = r.fixed(32)
        stakes = tuple(r.u64() for _ in range(r.u32()))
        return EpochRecord(epoch, height, round_, digest, stakes)


class EpochChain:
    """The ordered epoch history since genesis (epoch 0 is implicit: the
    genesis committee itself).  Serialized into checkpoints and snapshot
    manifests so recovery and catch-up re-derive the same epoch."""

    __slots__ = ("records",)

    def __init__(self, records: Sequence[EpochRecord] = ()) -> None:
        self.records: List[EpochRecord] = list(records)
        self._check()

    def _check(self) -> None:
        prev_epoch, prev_height = 0, -1
        for rec in self.records:
            if rec.epoch != prev_epoch + 1:
                raise SerdeError(
                    f"epoch chain not contiguous: {rec.epoch} after {prev_epoch}"
                )
            if rec.boundary_height < prev_height:
                raise SerdeError("epoch chain boundary heights must not decrease")
            prev_epoch, prev_height = rec.epoch, rec.boundary_height

    @property
    def epoch(self) -> int:
        return self.records[-1].epoch if self.records else 0

    @property
    def last_height(self) -> int:
        """Highest commit height already folded into the chain; commits at or
        below it must not be re-scanned (crash replay re-delivers them)."""
        return self.records[-1].boundary_height if self.records else 0

    def append(self, record: EpochRecord) -> None:
        self.records.append(record)
        self._check()

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u32(len(self.records))
        for rec in self.records:
            rec.encode(w)
        return w.finish()

    @staticmethod
    def from_bytes(data: bytes) -> "EpochChain":
        if not data:
            return EpochChain()
        r = Reader(data)
        records = [EpochRecord.decode(r) for _ in range(r.u32())]
        r.expect_done()
        return EpochChain(records)

    def derive_committee(self, genesis: Committee) -> Committee:
        """Rebuild the current epoch's committee from the genesis registry +
        the last record's stake vector.  The vector length must match the
        registered membership (stable-index model)."""
        if not self.records:
            return genesis
        last = self.records[-1]
        if len(last.stakes) != len(genesis):
            raise SerdeError(
                f"epoch chain stake vector has {len(last.stakes)} entries for a"
                f" {len(genesis)}-member registry"
            )
        committee = genesis.with_stakes(list(last.stakes), last.epoch)
        if committee_digest(committee) != last.digest:
            raise SerdeError(
                f"epoch {last.epoch} digest mismatch: chain record does not"
                " describe this genesis registry"
            )
        return committee


@dataclass(frozen=True)
class EpochTransition:
    """The outcome of folding one or more finalized changes: the committee to
    switch to and the record(s) appended to the chain."""

    committee: Committee
    records: Tuple[EpochRecord, ...]


class ReconfigState:
    """Per-node reconfiguration state machine, owned by the consensus core
    (single-owner discipline: only the core task mutates it).

    ``observe_commit`` is called once per committed sub-dag, in linearized
    order.  It scans the sub-dag's blocks (in their committed order) for
    change transactions and folds every valid one; each application is its
    own epoch.  Because every honest node sees the same committed sequence
    and the fold is pure, all nodes derive identical chains."""

    def __init__(self, genesis: Committee, chain: Optional[EpochChain] = None) -> None:
        if genesis.epoch != 0:
            raise ValueError("reconfiguration requires an epoch-0 genesis committee")
        self.genesis = genesis
        self.chain = chain if chain is not None else EpochChain()
        self.committee = self.chain.derive_committee(genesis)

    @property
    def epoch(self) -> int:
        return self.chain.epoch

    def digest(self) -> bytes:
        return committee_digest(self.committee)

    def committee_for_epoch(self, epoch: int) -> Optional[Committee]:
        """The committee a given epoch ran under, rebuilt from the chain's
        stake vector (stable-index model).  Historical blocks must be
        structurally judged by THEIR epoch's quorum arithmetic — catch-up
        replays pre-boundary rounds long after the switch, and the old
        quorum is what their include sets were built against.  Returns
        None for epochs this chain has not derived (including claimed
        FUTURE epochs: a lying author gets the current committee's rules,
        not lenient ones)."""
        if epoch == 0:
            return self.genesis
        for rec in self.chain.records:
            if rec.epoch == epoch:
                return self.genesis.with_stakes(list(rec.stakes), epoch)
        return None

    def scan_blocks(
        self, blocks: Sequence[StatementBlock]
    ) -> List[CommitteeChange]:
        """Change transactions in committed-block order (duplicates and
        ordinary payloads included/excluded as-is; validity is judged at
        fold time against the then-current committee)."""
        changes: List[CommitteeChange] = []
        for block in blocks:
            for st in block.statements:
                if isinstance(st, Share):
                    change = parse_reconfig_tx(st.transaction)
                    if change is not None:
                        changes.append(change)
        return changes

    def observe_commit(
        self,
        height: int,
        anchor_round: int,
        blocks: Sequence[StatementBlock],
    ) -> Optional[EpochTransition]:
        """Fold one committed sub-dag.  Heights at or below the chain's last
        boundary were already folded (checkpoint recovery replays them) and
        are skipped wholesale."""
        if height <= self.chain.last_height and self.chain.records:
            return None
        applied: List[EpochRecord] = []
        for change in self.scan_blocks(blocks):
            derived = apply_change(self.committee, change)
            if derived is None:
                continue
            self.committee = derived
            record = EpochRecord(
                epoch=derived.epoch,
                boundary_height=height,
                boundary_round=anchor_round,
                digest=committee_digest(derived),
                stakes=tuple(a.stake for a in derived.authorities),
            )
            self.chain.append(record)
            applied.append(record)
        if not applied:
            return None
        return EpochTransition(self.committee, tuple(applied))

    def adopt_chain(self, chain_bytes: bytes) -> Optional[EpochTransition]:
        """Adopt a longer epoch chain from a snapshot manifest (cross-boundary
        catch-up: the rejoiner was absent for the boundary commits, so the
        manifest's chain is its only source of the epoch history).  Returns a
        transition when the adopted chain extends ours; a shorter or equal
        chain is ignored (we are already at or past it)."""
        remote = EpochChain.from_bytes(chain_bytes)
        if remote.epoch <= self.epoch:
            return None
        if self.chain.records and (
            remote.records[: len(self.chain.records)] != self.chain.records
        ):
            raise SerdeError(
                "snapshot epoch chain does not extend the local chain"
            )
        committee = remote.derive_committee(self.genesis)
        new_records = tuple(remote.records[len(self.chain.records):])
        self.chain = remote
        self.committee = committee
        return EpochTransition(committee, new_records)
