"""Committee: stake table, thresholds, leader election, vote aggregation.

The port's copy of ``mysticeti_tpu.committee``.  Capability parity with
``mysticeti-core/src/committee.rs``:

* ``Committee`` with validity (>1/3) and quorum (>2/3) stake thresholds
  (committee.rs:25-30,56-81) and genesis block construction (committee.rs:98-114).
* Deterministic stake-weighted leader election (committee.rs:149-180) — our own
  blake2b-PRF weighted sampling without replacement; CONSENSUS-CRITICAL: every
  validator must compute the identical leader, so the scheme below is part of the
  protocol definition, not an implementation detail.
* ``StakeAggregator`` over quorum/validity thresholds (committee.rs:256-330).
* ``TransactionAggregator`` — the per-transaction fast-path vote/certification
  engine over locator ranges (committee.rs:363-482), backed by ``RangeMap``.
* ``VoteRangeBuilder`` — run-length compression of accept votes (committee.rs:498-524).
"""
from __future__ import annotations

import hashlib
import struct
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import crypto
from .range_map import RangeMap
from .serde import Reader, Writer
from .types import (
    AuthorityIndex,
    AuthoritySet,
    BlockReference,
    Epoch,
    MAX_COMMITTEE_SIZE,
    Share,
    StatementBlock,
    TransactionLocator,
    TransactionLocatorRange,
    Vote,
    VoteRange,
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


class TransactionAggregator:
    """Fast-path vote/certification engine over transaction locator ranges
    (committee.rs:363-482).

    ``pending`` maps a sharing block's reference to a RangeMap of offset ranges →
    StakeAggregator.  When a range reaches the threshold it is removed and reported
    processed.  ``handler`` hooks mirror ProcessedTransactionHandler
    (committee.rs:297-312): by default a set of processed locators that panics on
    votes for unknown transactions and on duplicate shares (the reference's
    HashSet impl, committee.rs:314-330).
    """

    def __init__(self, kind: str = QUORUM, track_processed: bool = True) -> None:
        self.kind = kind
        self.pending: Dict[BlockReference, RangeMap] = {}
        self.track_processed = track_processed
        self.processed: Set[TransactionLocator] = set()
        # Set by with_state: the processed set is NOT part of the snapshot
        # (same as the reference, committee.rs:352-362), so after recovery
        # votes/shares for pre-snapshot transactions are EXPECTED, not
        # Byzantine — the duplicate/unknown oracles cannot assert what they
        # did not persist.  Leniency is scoped by round: only locators whose
        # sharing block's round is <= the recovery watermark (the highest
        # round the restored state could have known about) bypass the
        # oracles; anything first shared above the watermark is strictly
        # checked for the aggregator's whole remaining life.
        self.recovered = False
        self.recovered_watermark: Optional[int] = None
        # Native hot core (native/mysticeti_native.cpp VoteAggregator): the
        # per-offset Python objects (locator tuples, StakeAggregator
        # instances, set hashing) dominate the engine profile at load, so the
        # sweep/tally/processed-set state lives in C++ when the extension is
        # available.  Pure-Python `pending`/`processed` above are the
        # fallback; MYSTICETI_NO_NATIVE=1 pins it.
        from .native import native as _native

        self._nat = None
        self._nat_mod = _native
        if _native is not None and hasattr(_native, "va_new"):
            self._nat = _native.va_new(track_processed, 0 if kind == QUORUM else 1)
            self._refs: Dict[bytes, BlockReference] = {}
            self._nat_committee: Optional[Committee] = None

    @staticmethod
    def _key(block: BlockReference) -> bytes:
        return struct.pack("<QQ", block.authority, block.round) + block.digest

    def _nat_bind(self, committee: Committee) -> None:
        if self._nat_committee is not committee:
            threshold = (
                committee.quorum_threshold()
                if self.kind == QUORUM
                else committee.validity_threshold()
            )
            self._nat_mod.va_bind(
                self._nat,
                [committee.get_stake(a) for a in committee.authority_indexes()],
                threshold,
            )
            self._nat_committee = committee

    def _raise_violations(self, viol_ranges, block, vote, hook) -> None:
        """Feed native violation ranges through the overridable handler hook
        offset-by-offset, deferring exceptions to the end — exact parity with
        the pure path's sweep (every violating offset observes the hook; the
        first collected exception is raised after the map update completed)."""
        violations: List[Exception] = []
        for s, e in viol_ranges:
            for off in range(s, e):
                try:
                    hook(TransactionLocator(block, off), vote)
                except Exception as exc:  # noqa: BLE001 - deferred, re-raised
                    violations.append(exc)
        if violations:
            raise violations[0]

    # handler hooks — overridable by subclasses
    def transaction_processed(self, k: TransactionLocator) -> None:
        # The native core records certified intervals itself; the Python set
        # only backs the fallback path.
        if self.track_processed and self._nat is None:
            self.processed.add(k)

    def transaction_processed_range(
        self, block: "BlockReference", start: int, end: int
    ) -> None:
        """Range form of the processed hook: certification happens in
        contiguous runs (often thousands of offsets at default block caps),
        and building a locator object per offset was a top engine cost at
        fleet saturation.  Subclasses that only need per-offset semantics
        keep overriding ``transaction_processed``."""
        if (
            type(self).transaction_processed
            is TransactionAggregator.transaction_processed
            and (not self.track_processed or self._nat is not None)
        ):
            # Base hook would no-op per offset (the native core keeps its
            # own intervals): skip the per-offset loop entirely.  A subclass
            # override of the singular hook still sees every offset.
            return
        for off in range(start, end):
            self.transaction_processed(TransactionLocator(block, off))

    def _pre_snapshot(self, k: TransactionLocator) -> bool:
        """True when the locator may predate the recovered snapshot — the
        oracles cannot assert what the snapshot did not persist."""
        return (
            self.recovered
            and (
                self.recovered_watermark is None
                or k.block.round <= self.recovered_watermark
            )
        )

    def duplicate_transaction(self, k: TransactionLocator, from_: AuthorityIndex) -> None:
        if (
            self.track_processed
            and not self._pre_snapshot(k)
            and k not in self.processed
        ):
            raise RuntimeError(f"duplicate transaction {k} from {from_}")

    def unknown_transaction(self, k: TransactionLocator, from_: AuthorityIndex) -> None:
        if (
            self.track_processed
            and not self._pre_snapshot(k)
            and k not in self.processed
        ):
            raise RuntimeError(f"vote for unknown transaction {k} from {from_}")

    def is_processed(self, k: TransactionLocator) -> bool:
        if self._nat is not None:
            return self._nat_mod.va_is_processed(
                self._nat, self._key(k.block), k.offset
            )
        return k in self.processed

    # -- core operations (committee.rs:364-425) --

    def register(
        self,
        locator_range: TransactionLocatorRange,
        vote: AuthorityIndex,
        committee: Committee,
    ) -> None:
        """A block shared these transactions; start aggregation with the author's
        implicit self-vote.

        Handler violations (duplicate shares) are collected during the sweep and
        raised only after the RangeMap update completes — raising mid-sweep would
        leave ``pending`` partially mutated, and unlike the reference (which aborts
        the process on these panics) a Python caller may catch and continue, so the
        aggregator must stay internally consistent."""
        if self._nat is not None:
            block = locator_range.block
            key = self._key(block)
            self._refs[key] = block
            self._nat_bind(committee)
            viol_ranges = self._nat_mod.va_register(
                self._nat,
                key,
                locator_range.offset_start_inclusive,
                locator_range.offset_end_exclusive,
                vote,
            )
            self._raise_violations(
                viol_ranges, block, vote, self.duplicate_transaction
            )
            return
        range_map = self.pending.setdefault(locator_range.block, RangeMap())
        violations: List[Exception] = []

        def mutate(sub_start: int, sub_end: int, agg):
            if agg is not None:
                for off in range(sub_start, sub_end):
                    try:
                        self.duplicate_transaction(
                            TransactionLocator(locator_range.block, off), vote
                        )
                    except Exception as e:  # noqa: BLE001 - deferred, re-raised below
                        violations.append(e)
                return agg
            new_agg = StakeAggregator(self.kind)
            new_agg.add(vote, committee)
            return new_agg

        range_map.mutate_range(
            locator_range.offset_start_inclusive,
            locator_range.offset_end_exclusive,
            mutate,
        )
        if violations:
            raise violations[0]

    def vote(
        self,
        locator_range: TransactionLocatorRange,
        vote: AuthorityIndex,
        committee: Committee,
        processed_out: List[TransactionLocatorRange],
    ) -> None:
        """Tally a vote range; newly certified runs are appended to
        ``processed_out`` as RANGES (certification is contiguous — a range
        per certified run instead of a locator per offset keeps the
        default-cap fast path out of O(transactions) Python loops)."""
        if self._nat is not None:
            block = locator_range.block
            key = self._key(block)
            self._nat_bind(committee)
            certified, viol_ranges, retired = self._nat_mod.va_vote(
                self._nat,
                key,
                locator_range.offset_start_inclusive,
                locator_range.offset_end_exclusive,
                vote,
            )
            if retired:
                self._refs.pop(key, None)
            for s, e in certified:
                self.transaction_processed_range(block, s, e)
                processed_out.append(TransactionLocatorRange(block, s, e))
            self._raise_violations(
                viol_ranges, block, vote, self.unknown_transaction
            )
            return
        range_map = self.pending.get(locator_range.block)
        if range_map is None:
            for loc in locator_range.locators():
                self.unknown_transaction(loc, vote)
            return
        violations: List[Exception] = []

        def mutate(sub_start: int, sub_end: int, agg):
            if agg is None:
                # Deferred like register(): keep the sweep atomic wrt `pending`.
                for off in range(sub_start, sub_end):
                    try:
                        self.unknown_transaction(
                            TransactionLocator(locator_range.block, off), vote
                        )
                    except Exception as e:  # noqa: BLE001 - deferred, re-raised below
                        violations.append(e)
                return None
            if agg.add(vote, committee):
                self.transaction_processed_range(
                    locator_range.block, sub_start, sub_end
                )
                processed_out.append(
                    TransactionLocatorRange(
                        locator_range.block, sub_start, sub_end
                    )
                )
                return None  # certified: drop from pending
            return agg

        range_map.mutate_range(
            locator_range.offset_start_inclusive,
            locator_range.offset_end_exclusive,
            mutate,
        )
        if range_map.is_empty():
            del self.pending[locator_range.block]
        if violations:
            raise violations[0]

    def process_block(
        self,
        block: StatementBlock,
        response: Optional[List[object]],
        committee: Committee,
    ) -> List[TransactionLocatorRange]:
        """Tally one block's shares and votes (committee.rs:450-482).

        Shares register new aggregations (and, if ``response`` is given, emit our own
        VoteRange replies into it); Vote/VoteRange statements are tallied; returns
        the locator RANGES newly certified by this block.
        """
        processed: List[TransactionLocatorRange] = []
        for rng in shared_ranges(block):
            self.register(rng, block.author(), committee)
            if response is not None:
                response.append(VoteRange(rng))
        for st in block.statements:
            if isinstance(st, Vote):
                if st.accept:
                    self.vote(
                        TransactionLocatorRange(st.locator.block, st.locator.offset,
                                                st.locator.offset + 1),
                        block.author(), committee, processed,
                    )
                else:
                    raise NotImplementedError("reject votes not implemented (parity: committee.rs:470)")
            elif isinstance(st, VoteRange):
                self.vote(st.range, block.author(), committee, processed)
        return processed

    def __len__(self) -> int:
        if self._nat is not None:
            return self._nat_mod.va_pending_len(self._nat)
        return len(self.pending)

    def is_empty(self) -> bool:
        return len(self) == 0

    # -- state snapshot (committee.rs:352-362), our own encoding --

    def state(self) -> bytes:
        if self._nat is not None:
            if hasattr(self._nat_mod, "va_state"):
                # Snapshot serialized entirely in C++ — the per-commit state
                # write is the engine's top cost at deep pending backlogs
                # (O(pending) every commit); _nat_state below is the
                # byte-identical reference encoder it is differential-tested
                # against.
                return self._nat_mod.va_state(self._nat)
            return self._nat_state()
        w = Writer()
        w.u32(len(self.pending))
        for block_ref in sorted(self.pending):
            rm = self.pending[block_ref]
            block_ref.encode(w)
            w.u32(len(rm))
            for s, e, agg in rm.items():
                w.u64(s).u64(e)
                agg.encode(w)
        return w.finish()

    def _nat_state(self) -> bytes:
        # Byte-identical to the pure-Python encoder: the native sweep splits
        # ranges exactly like RangeMap.mutate_range, so the item lists match.
        items = self._nat_mod.va_items(self._nat)
        by_ref = sorted(
            (self._refs[key], ranges) for key, ranges in items
        )
        w = Writer()
        w.u32(len(by_ref))
        for block_ref, ranges in by_ref:
            block_ref.encode(w)
            w.u32(len(ranges))
            for s, e, stake, kind, mask in ranges:
                w.u64(s).u64(e)
                w.u8(kind).u64(stake)
                w.bytes(mask)
        return w.finish()

    def relax_below(self, watermark_round: int) -> None:
        """Snapshot catch-up (storage.py): the node adopted a remote commit
        baseline, so every block below the adopted floor is history it will
        NEVER process — votes and shares referencing that history are
        expected, not Byzantine.  Raises (never lowers) the pre-snapshot
        leniency watermark; locators first shared above it stay strictly
        checked, exactly as after a with_state recovery."""
        if not self.recovered:
            self.recovered = True
            self.recovered_watermark = watermark_round
        elif (
            self.recovered_watermark is not None
            and watermark_round > self.recovered_watermark
        ):
            # None means unbounded leniency (pure reference parity) — never
            # narrow it here.
            self.recovered_watermark = watermark_round

    def with_state(
        self, state: bytes, watermark_round: Optional[int] = None
    ) -> None:
        """Restore from a snapshot.  ``watermark_round`` bounds the Byzantine-
        oracle leniency (see ``_pre_snapshot``): the caller should pass the
        highest round durably replayed alongside the snapshot (e.g.
        ``BlockStore.highest_round()``) so locators first shared ABOVE it stay
        strictly checked.  When omitted the leniency is unbounded (pure
        reference-parity behavior): the snapshot alone cannot bound what was
        processed before it — completed transactions may sit at rounds above
        any still-pending entry — so no safe round bound is derivable."""
        if len(self):
            raise RuntimeError("with_state requires an empty aggregator")
        self.recovered = True
        self.recovered_watermark = watermark_round
        r = Reader(state)
        for _ in range(r.u32()):
            block_ref = BlockReference.decode(r)
            rm = RangeMap()
            n = r.u32()
            for _ in range(n):
                s, e = r.u64(), r.u64()
                if self._nat is not None:
                    kind = r.u8()
                    stake = r.u64()
                    mask = r.bytes()
                    key = self._key(block_ref)
                    self._refs[key] = block_ref
                    self._nat_mod.va_load(self._nat, key, s, e, stake, kind, mask)
                else:
                    agg = StakeAggregator.decode(r)
                    rm.mutate_range(s, e, lambda a, b, _old, agg=agg: agg)
            if self._nat is None:
                self.pending[block_ref] = rm
        r.expect_done()


def shared_ranges(block: StatementBlock) -> List[TransactionLocatorRange]:
    """Contiguous runs of Share statements in a block as locator ranges
    (types.rs shared_ranges equivalent used by committee.rs:455); run-length
    compression delegated to VoteRangeBuilder so there is one copy of that logic."""
    runs = getattr(block, "_share_runs", None)
    if runs is None:
        # Locally built block: walk the statements.  Wire-decoded blocks
        # carry spans precomputed by the native decoder — re-walking 10k+
        # statements per block here was a top interpreter cost at load.
        builder = VoteRangeBuilder()
        collected: List[Tuple[int, int]] = []
        for i, st in enumerate(block.statements):
            if isinstance(st, Share):
                done = builder.add(i)
                if done is not None:
                    collected.append(done)
        tail = builder.finish()
        if tail is not None:
            collected.append(tail)
        runs = collected
    return [TransactionLocatorRange(block.reference, s, e) for s, e in runs]


class VoteRangeBuilder:
    """Run-length compression of vote offsets (committee.rs:498-524)."""

    __slots__ = ("_start", "_end")

    def __init__(self) -> None:
        self._start: Optional[int] = None
        self._end = 0

    def add(self, offset: int) -> Optional[Tuple[int, int]]:
        """Feed the next offset; returns a completed (start, end) run when the new
        offset is not contiguous with the current run."""
        if self._start is None:
            self._start, self._end = offset, offset + 1
            return None
        if self._end == offset:
            self._end = offset + 1
            return None
        result = (self._start, self._end)
        self._start, self._end = offset, offset + 1
        return result

    def finish(self) -> Optional[Tuple[int, int]]:
        if self._start is None:
            return None
        return (self._start, self._end)
