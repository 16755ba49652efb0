"""Committee: stake table, thresholds, leader election, vote aggregation.

The port's copy of ``mysticeti_tpu.committee``, trimmed to what block
verification needs.  Capability parity with ``mysticeti-core/src/committee.rs``:

* ``Committee`` with validity (>1/3) and quorum (>2/3) stake thresholds
  (committee.rs:25-30,56-81) and genesis block construction (committee.rs:98-114).
* Deterministic stake-weighted leader election (committee.rs:149-180) — our own
  blake2b-PRF weighted sampling without replacement; CONSENSUS-CRITICAL: every
  validator must compute the identical leader, so the scheme below is part of the
  protocol definition, not an implementation detail.
* ``StakeAggregator`` over quorum/validity thresholds (committee.rs:256-330).
"""
from __future__ import annotations

import hashlib
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from . import crypto
from .serde import Reader, Writer
from .types import (
    AuthorityIndex,
    AuthoritySet,
    Epoch,
    MAX_COMMITTEE_SIZE,
    StatementBlock,
)

Stake = int

QUORUM = "quorum"
VALIDITY = "validity"

ROUND_ROBIN = "round_robin"
STAKE_WEIGHTED = "stake_weighted"


class Authority:
    """One committee member: stake + verifying key + hostname (committee.rs:197-218)."""

    __slots__ = ("stake", "public_key", "hostname")

    def __init__(self, stake: Stake, public_key: crypto.PublicKey, hostname: str = "") -> None:
        self.stake = stake
        self.public_key = public_key
        self.hostname = hostname


class Committee:
    """The validator set for one epoch (committee.rs:24-30).

    ``leader_election`` selects round-robin (the reference's cfg(test) strategy,
    committee.rs:140-146 — used by the committer gold suite) or the production
    stake-weighted scheme.
    """

    def __init__(
        self,
        authorities: Sequence[Authority],
        epoch: Epoch = 0,
        leader_election: str = STAKE_WEIGHTED,
        epoch_tolerant: bool = False,
    ) -> None:
        if not authorities:
            raise ValueError("committee must not be empty")
        if len(authorities) > MAX_COMMITTEE_SIZE:
            raise ValueError(f"committee larger than {MAX_COMMITTEE_SIZE}")
        if any(a.stake < 0 for a in authorities):
            raise ValueError("stakes must be non-negative")
        # Stable-index membership (reconfig.py): stake 0 marks a registered
        # but INACTIVE authority — it keeps its index, key, and genesis block
        # but contributes nothing to thresholds and is unelectable.  At
        # least one member must be active or no quorum exists at all.
        if all(a.stake == 0 for a in authorities):
            raise ValueError("at least one authority must have positive stake")
        self.authorities: Tuple[Authority, ...] = tuple(authorities)
        self.epoch = epoch
        self.leader_election = leader_election
        # Epoch-tolerant committees accept blocks stamped with OTHER epoch
        # numbers (reconfiguration: honest peers straddle a boundary for a
        # few rounds, and a rejoiner catches up through older epochs' blocks).
        # Signatures still bind blocks to this registry's keys, so tolerance
        # never admits another deployment's blocks.
        self.epoch_tolerant = epoch_tolerant
        self.total_stake: Stake = sum(a.stake for a in authorities)
        # is_valid: amount > total/3 ; is_quorum: amount > 2*total/3 (committee.rs:56-57,120-127)
        self._validity_floor = self.total_stake // 3
        self._quorum_floor = 2 * self.total_stake // 3

    # -- constructors --

    @classmethod
    def new_test(cls, stakes: Sequence[Stake], epoch: Epoch = 0) -> "Committee":
        """Test committee with dummy keys + round-robin election (committee.rs:36-39)."""
        dummy = crypto.Signer.dummy().public_key
        return cls(
            [Authority(s, dummy) for s in stakes], epoch, leader_election=ROUND_ROBIN
        )

    @classmethod
    def new_for_benchmarks(
        cls,
        size: int,
        epoch: Epoch = 0,
        stakes: Optional[Sequence[Stake]] = None,
    ) -> "Committee":
        """Equal-stake committee with deterministic per-index keys
        (committee.rs:190-193).  ``stakes`` overrides the per-index stakes
        (churn scenarios register a joiner at stake 0)."""
        if stakes is not None and len(stakes) != size:
            raise ValueError("stakes must have one entry per authority")
        return cls(
            [
                Authority(1 if stakes is None else stakes[i], s.public_key)
                for i, s in enumerate(cls.benchmark_signers(size))
            ],
            epoch,
            leader_election=STAKE_WEIGHTED,
        )

    def with_stakes(
        self, stakes: Sequence[Stake], epoch: Epoch
    ) -> "Committee":
        """Derive another epoch's committee over the SAME registry: keys,
        hostnames, and election strategy carry over; only stakes and the
        epoch number change.  Derived committees are epoch-tolerant (their
        whole point is to live through a boundary)."""
        if len(stakes) != len(self.authorities):
            raise ValueError("stakes must have one entry per authority")
        return Committee(
            [
                Authority(stake, a.public_key, a.hostname)
                for stake, a in zip(stakes, self.authorities)
            ],
            epoch,
            leader_election=self.leader_election,
            epoch_tolerant=True,
        )

    @staticmethod
    def benchmark_signers(size: int) -> List[crypto.Signer]:
        return [crypto.Signer.from_seed(i.to_bytes(32, "little")) for i in range(size)]

    # -- YAML round-trip (committee.rs:34 committee.yaml via Print trait) --

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "leader_election": self.leader_election,
            "authorities": [
                {
                    "stake": a.stake,
                    "public_key": a.public_key.bytes.hex(),
                    "hostname": a.hostname,
                }
                for a in self.authorities
            ],
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "Committee":
        return cls(
            [
                Authority(
                    a["stake"],
                    crypto.PublicKey(bytes.fromhex(a["public_key"])),
                    a.get("hostname", ""),
                )
                for a in raw["authorities"]
            ],
            epoch=raw.get("epoch", 0),
            leader_election=raw.get("leader_election", STAKE_WEIGHTED),
        )

    def dump(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def load(cls, path: str) -> "Committee":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    # -- thresholds --

    def validity_threshold(self) -> Stake:
        return self._validity_floor + 1

    def quorum_threshold(self) -> Stake:
        return self._quorum_floor + 1

    def is_valid(self, amount: Stake) -> bool:
        return amount > self._validity_floor

    def is_quorum(self, amount: Stake) -> bool:
        return amount > self._quorum_floor

    def threshold_predicate(self, kind: str) -> Callable[[Stake], bool]:
        if kind == QUORUM:
            return self.is_quorum
        if kind == VALIDITY:
            return self.is_valid
        raise ValueError(f"unknown threshold kind {kind}")

    # -- lookups --

    def __len__(self) -> int:
        return len(self.authorities)

    def known_authority(self, authority: AuthorityIndex) -> bool:
        return 0 <= authority < len(self.authorities)

    def accepts_epoch(self, epoch: Epoch) -> bool:
        """Block-verification epoch gate (types.verify_structure): exact
        match by default; epoch-tolerant committees (reconfiguration) accept
        any epoch number — keys are stable across stake changes, so the
        signature check still rejects foreign blocks."""
        return epoch == self.epoch or self.epoch_tolerant

    def is_active(self, authority: AuthorityIndex) -> bool:
        """Positive stake == active member of this epoch (stable-index
        membership: stake 0 marks a registered-but-retired/not-yet-joined
        authority)."""
        return (
            self.known_authority(authority)
            and self.authorities[authority].stake > 0
        )

    def active_authorities(self) -> List[AuthorityIndex]:
        return [i for i, a in enumerate(self.authorities) if a.stake > 0]

    def active_count(self) -> int:
        return sum(1 for a in self.authorities if a.stake > 0)

    def get_stake(self, authority: AuthorityIndex) -> Stake:
        return self.authorities[authority].stake

    def get_public_key(self, authority: AuthorityIndex) -> crypto.PublicKey:
        return self.authorities[authority].public_key

    def public_key_bytes(self) -> List[bytes]:
        """Every authority's raw 32-byte key, in index order — the committee
        table the batch verifier keys on."""
        return [a.public_key.bytes for a in self.authorities]

    def authority_indexes(self) -> range:
        return range(len(self.authorities))

    def get_total_stake(self, authorities: Iterable[AuthorityIndex]) -> Stake:
        return sum(self.authorities[a].stake for a in authorities)

    # -- genesis (committee.rs:98-114) --

    def genesis_blocks(self, for_authority: AuthorityIndex):
        own = StatementBlock.new_genesis(for_authority, self.epoch)
        others = [
            StatementBlock.new_genesis(a, self.epoch)
            for a in self.authority_indexes()
            if a != for_authority
        ]
        return own, others

    # -- leader election --

    def elect_leader(self, round_: int, offset: int = 0) -> AuthorityIndex:
        """Leader for (round, offset) (committee.rs:137-146)."""
        if self.leader_election == ROUND_ROBIN:
            return (round_ + offset) % len(self.authorities)
        return self.elect_leader_stake_based(round_, offset)

    def elect_leader_stake_based(self, round_: int, offset: int) -> AuthorityIndex:
        """Deterministic stake-weighted election without replacement
        (semantics of committee.rs:149-180; our own PRF, documented protocol rule):

        draws 0..=offset each pick one authority with probability proportional to
        stake among those not yet drawn, using ``blake2b(b"leader" || round || draw)``
        as the randomness.  Distinct offsets in the same round therefore always yield
        distinct leaders.
        """
        if offset >= len(self.authorities):
            raise ValueError("offset must be < committee size")
        if round_ == 0:
            return 0
        remaining: List[Tuple[AuthorityIndex, Stake]] = [
            (i, a.stake) for i, a in enumerate(self.authorities)
        ]
        total = self.total_stake
        chosen = 0
        for draw in range(offset + 1):
            seed = hashlib.blake2b(
                b"mysticeti-tpu/leader"
                + round_.to_bytes(8, "little")
                + draw.to_bytes(8, "little"),
                digest_size=16,
            ).digest()
            point = int.from_bytes(seed, "little") % total
            acc = 0
            for j, (idx, stake) in enumerate(remaining):
                acc += stake
                if point < acc:
                    chosen = idx
                    total -= stake
                    remaining.pop(j)
                    break
        return chosen


class StakeAggregator:
    """Accumulates distinct authority votes until a stake threshold
    (committee.rs:256-330).  ``kind`` is "quorum" or "validity"."""

    __slots__ = ("kind", "votes", "stake")

    def __init__(self, kind: str = QUORUM) -> None:
        self.kind = kind
        self.votes = AuthoritySet()
        self.stake: Stake = 0

    def add(self, vote: AuthorityIndex, committee: Committee) -> bool:
        if self.votes.insert(vote):
            self.stake += committee.get_stake(vote)
        return committee.threshold_predicate(self.kind)(self.stake)

    def is_reached(self, committee: Committee) -> bool:
        return committee.threshold_predicate(self.kind)(self.stake)

    def clear(self) -> None:
        self.votes.clear()
        self.stake = 0

    def copy(self) -> "StakeAggregator":
        """Independent copy — required by RangeMap fragment splitting."""
        dup = StakeAggregator(self.kind)
        dup.votes = self.votes.copy()
        dup.stake = self.stake
        return dup

    def voters(self):
        return self.votes.present()

    # state snapshot encoding (for WAL persistence of aggregator state)
    def encode(self, w: Writer) -> None:
        w.u8(0 if self.kind == QUORUM else 1)
        w.u64(self.stake)
        w.bytes(self.votes.bits.to_bytes(64, "little"))

    @staticmethod
    def decode(r: Reader) -> "StakeAggregator":
        kind = QUORUM if r.u8() == 0 else VALIDITY
        agg = StakeAggregator(kind)
        agg.stake = r.u64()
        agg.votes = AuthoritySet(int.from_bytes(r.bytes(), "little"))
        return agg
