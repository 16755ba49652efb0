"""Deterministic chaos engine: seeded fault injection over the virtual-time sim.

The port's copy of ``mysticeti_tpu.chaos``.  The reproduction's headline
claim (arXiv 2310.14821) is that commits stay safe and low-latency under
crash faults and partitions — but the sim tier only exercised static
partition/heal, and the WAL recovery path
(``core.py``/``validator.init_storage``) was never driven mid-simulation.
This module closes that gap with four pieces:

* :class:`FaultPlan` — a declarative, JSON-serializable plan: per-link
  message drop/duplicate/delay probabilities (:class:`LinkFault`), timed
  (a)symmetric partitions (:class:`PartitionFault`), and crash-restarts of
  whole validators (:class:`CrashFault`), optionally with a torn WAL tail.
* :class:`ChaosEngine` — executes a plan against a fleet on the
  :class:`~mysticeti_tpu_torch.runtime.simulated.DeterministicLoop`.  The timed
  schedule is resolved up-front from the plan alone (:func:`resolve_schedule`)
  and per-message coin flips come from a dedicated ``random.Random`` seeded by
  the plan, so a same-seed re-run produces a byte-identical fault schedule
  AND byte-identical fault log (:meth:`ChaosEngine.fault_log_bytes`).
* :class:`SafetyChecker` — cross-node, cross-restart commit auditor: every
  committed sub-dag is recorded by (authority, height); two anchors at the
  same height — on different nodes, or on one node before and after a
  crash — raise :class:`SafetyViolation` the moment they are observed.
* :class:`ChaosSimHarness` — an N-validator fleet over
  :class:`~mysticeti_tpu_torch.simulated_network.SimulatedNetwork` whose per-node
  WALs survive crash-restart: :meth:`ChaosSimHarness.restart` rebuilds the
  validator from the SAME WAL path, driving the full
  ``BlockStore.open`` -> ``Core`` recovery path under fire.

Partitions are injected as directed BLACKHOLES (messages dropped while the
connections stay up) rather than severed links: that is the nastier fault —
no closure event tells either side anything happened — and it composes
cleanly with concurrent crashes and asymmetric (one-way) cuts.  The severed
flavor remains available directly on ``SimulatedNetwork.partition``.

``python -m mysticeti_tpu_torch chaos --plan plan.json`` replays a plan from
JSON (cli.py); the JAX package's ``docs/fault-injection.md`` documents the
schema and guarantees.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .adversary import AdversaryEngine, AdversarySpec
from .block_handler import TestBlockHandler
from .commit_observer import TestCommitObserver
from .committee import Committee
from .config import Parameters
from .core import Core, CoreOptions
from .flight_recorder import FlightRecorder
from .health import FleetHealthMonitor, HealthProbe, SLOThresholds
from .metrics import Metrics
from .net_sync import NetworkSyncer
from .simulated_network import SimulatedNetwork
from .tracing import logger
from .types import BlockReference, Share
from .utils.tasks import spawn_logged

log = logger(__name__)


# ---------------------------------------------------------------------------
# Fault plan (declarative, JSON round-trippable)


@dataclass(frozen=True)
class LinkFault:
    """Probabilistic per-message faults on matching links inside a window.

    ``src``/``dst`` of ``None`` match any sender/receiver; ``end_s`` of
    ``None`` means "until the end of the run".  The first matching fault in
    plan order wins for a given (src, dst, t).  ``duplicate_p`` re-delivers a
    copy after an extra ``delay_extra_s`` draw — duplicates are always late
    (an on-time duplicate is indistinguishable from the original in-order
    delivery and would test nothing).
    """

    drop_p: float = 0.0
    duplicate_p: float = 0.0
    delay_p: float = 0.0
    delay_extra_s: Tuple[float, float] = (0.05, 0.25)
    src: Optional[int] = None
    dst: Optional[int] = None
    start_s: float = 0.0
    end_s: Optional[float] = None

    def matches(self, src: int, dst: int, t: float) -> bool:
        if self.src is not None and self.src != src:
            return False
        if self.dst is not None and self.dst != dst:
            return False
        if t < self.start_s:
            return False
        return self.end_s is None or t < self.end_s

    def to_dict(self) -> dict:
        return {
            "drop_p": self.drop_p,
            "duplicate_p": self.duplicate_p,
            "delay_p": self.delay_p,
            "delay_extra_s": list(self.delay_extra_s),
            "src": self.src,
            "dst": self.dst,
            "start_s": self.start_s,
            "end_s": self.end_s,
        }

    @staticmethod
    def from_dict(d: dict) -> "LinkFault":
        return LinkFault(
            drop_p=float(d.get("drop_p", 0.0)),
            duplicate_p=float(d.get("duplicate_p", 0.0)),
            delay_p=float(d.get("delay_p", 0.0)),
            delay_extra_s=tuple(d.get("delay_extra_s", (0.05, 0.25))),
            src=d.get("src"),
            dst=d.get("dst"),
            start_s=float(d.get("start_s", 0.0)),
            end_s=None if d.get("end_s") is None else float(d["end_s"]),
        )


@dataclass(frozen=True)
class PartitionFault:
    """Timed blackhole partition between two groups.

    ``symmetric=True`` drops both directions; ``False`` drops only
    ``group_a -> group_b`` (the asymmetric cut: A's blocks vanish while A
    still hears everything — the failure mode static partition tests miss).
    """

    start_s: float
    end_s: float
    group_a: Tuple[int, ...]
    group_b: Tuple[int, ...]
    symmetric: bool = True

    def directed_pairs(self) -> List[Tuple[int, int]]:
        pairs = [(a, b) for a in self.group_a for b in self.group_b]
        if self.symmetric:
            pairs += [(b, a) for a in self.group_a for b in self.group_b]
        return sorted(set(pairs))

    def to_dict(self) -> dict:
        return {
            "start_s": self.start_s,
            "end_s": self.end_s,
            "group_a": list(self.group_a),
            "group_b": list(self.group_b),
            "symmetric": self.symmetric,
        }

    @staticmethod
    def from_dict(d: dict) -> "PartitionFault":
        return PartitionFault(
            start_s=float(d["start_s"]),
            end_s=float(d["end_s"]),
            group_a=tuple(int(a) for a in d["group_a"]),
            group_b=tuple(int(b) for b in d["group_b"]),
            symmetric=bool(d.get("symmetric", True)),
        )


@dataclass(frozen=True)
class CrashFault:
    """Crash-restart of a whole validator.

    At ``at_s`` the node's links break, its tasks are torn down, and its WAL
    is closed; ``downtime_s`` later it is rebuilt FROM THE SAME WAL via the
    ``BlockStore.open`` recovery path and rejoins the fleet.
    ``torn_tail_bytes > 0`` truncates that many bytes off the WAL after the
    crash, simulating a tear mid-entry (loss of the last un-synced write):
    replay must stop cleanly at the tear and recovery truncates the torn
    bytes before the first new append.
    """

    node: int
    at_s: float
    downtime_s: float
    torn_tail_bytes: int = 0

    def to_dict(self) -> dict:
        return {
            "node": self.node,
            "at_s": self.at_s,
            "downtime_s": self.downtime_s,
            "torn_tail_bytes": self.torn_tail_bytes,
        }

    @staticmethod
    def from_dict(d: dict) -> "CrashFault":
        return CrashFault(
            node=int(d["node"]),
            at_s=float(d["at_s"]),
            downtime_s=float(d["downtime_s"]),
            torn_tail_bytes=int(d.get("torn_tail_bytes", 0)),
        )


@dataclass
class FaultPlan:
    """The whole declarative scenario; ``seed`` drives BOTH the simulator's
    loop RNG and the engine's per-message fault draws.  ``adversaries``
    (adversary.py) declares Byzantine behavior alongside the benign faults
    — one plan, one seed, one byte-identical schedule."""

    seed: int = 0
    link_faults: List[LinkFault] = field(default_factory=list)
    partitions: List[PartitionFault] = field(default_factory=list)
    crashes: List[CrashFault] = field(default_factory=list)
    adversaries: List[AdversarySpec] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "link_faults": [f.to_dict() for f in self.link_faults],
            "partitions": [p.to_dict() for p in self.partitions],
            "crashes": [c.to_dict() for c in self.crashes],
            "adversaries": [a.to_dict() for a in self.adversaries],
        }

    def to_json(self) -> str:
        return _canonical_json(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "FaultPlan":
        return FaultPlan(
            seed=int(d.get("seed", 0)),
            link_faults=[LinkFault.from_dict(f) for f in d.get("link_faults", [])],
            partitions=[
                PartitionFault.from_dict(p) for p in d.get("partitions", [])
            ],
            crashes=[CrashFault.from_dict(c) for c in d.get("crashes", [])],
            adversaries=[
                AdversarySpec.from_dict(a) for a in d.get("adversaries", [])
            ],
        )

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        return FaultPlan.from_dict(json.loads(text))


def _canonical_json(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def resolve_schedule(plan: FaultPlan) -> List[dict]:
    """The plan's timed events, resolved up-front from the plan ALONE.

    Purely a function of the plan (no RNG, no sim state), so it is trivially
    byte-identical across runs — the determinism the fault LOG then extends
    to the per-message draws.  Events at equal times keep a stable total
    order via their sequence number.
    """
    events: List[dict] = []
    for p in plan.partitions:
        events.append(
            {"t": p.start_s, "kind": "partition_start", **p.to_dict()}
        )
        events.append({"t": p.end_s, "kind": "partition_end", **p.to_dict()})
    for c in plan.crashes:
        events.append({"t": c.at_s, "kind": "crash", **c.to_dict()})
        events.append(
            {"t": c.at_s + c.downtime_s, "kind": "restart", "node": c.node}
        )
    events.sort(key=lambda e: (e["t"], e["kind"], _canonical_json(e)))
    for seq, event in enumerate(events):
        event["seq"] = seq
    return events


def schedule_bytes(plan: FaultPlan) -> bytes:
    return _canonical_json(resolve_schedule(plan)).encode()


# ---------------------------------------------------------------------------
# Safety checker


class SafetyViolation(AssertionError):
    """Two different leader anchors committed at the same height."""


class SafetyChecker:
    """Cross-node, cross-restart commit auditor.

    Commits are recorded by (authority, height) as they happen — including
    re-observations after a WAL-replay restart, which MUST agree with what
    the node committed before crashing.  :meth:`check` then asserts the
    global invariant: at every height, all nodes that committed it committed
    the same anchor (prefix consistency of committed leader sequences).
    """

    def __init__(self) -> None:
        self._anchors: Dict[int, Dict[int, BlockReference]] = {}
        # Snapshot catch-up: per-authority adopted baseline height.  Heights
        # inside the adopted prefix were committed by the FLEET while the
        # node was away — a gap wholly below the baseline is the expected
        # catch-up shape, not a linearizer-order violation.  The adopted
        # anchor itself is recorded, so cross-node consistency still covers
        # the baseline height.
        self._adopted: Dict[int, int] = {}
        # First mid-run violation, re-raised by check(): an observe() raise
        # inside a node's accept pipeline is logged there, not propagated,
        # so the end-of-run audit must still fail the scenario.
        self._violation: Optional[SafetyViolation] = None
        # Byzantine scenarios (adversary.py): declared adversaries are
        # excluded from the HONEST consistency invariant — a node that
        # actively lies forfeits its own-commit guarantees — and any
        # divergence that involves one is recorded here, attributed by
        # name, instead of failing the scenario.  Honest-honest divergence
        # still raises: that is the safety property under attack.
        self.adversaries: Set[int] = set()
        self.adversary_divergence: List[dict] = []
        # Epoch reconfiguration (reconfig.py): per-authority epoch records
        # — epoch -> (boundary_height, digest).  All honest nodes that
        # cross a boundary must derive the SAME boundary for the same
        # epoch; a disagreement is a safety violation of the same class as
        # a commit fork (the committees diverge, then everything does).
        self._epochs: Dict[int, Dict[int, Tuple[int, bytes]]] = {}
        # Execution plane (execution.py): per-authority state-root chain —
        # height -> chained root after folding that commit.  Every honest
        # node must derive the SAME root at every shared height; a
        # disagreement means the replicated state machine diverged — the
        # exact failure class execution-backed finality exists to rule out,
        # and strictly stronger evidence than an anchor fork (same inputs,
        # different outputs).
        self._state_roots: Dict[int, Dict[int, bytes]] = {}
        # Committed-throughput accounting: transactions (Share statements)
        # AND blocks in each node's committed sub-dags, keyed observer ->
        # block author, counted once per height (a WAL-replay
        # re-observation of an already-recorded height adds nothing).
        # Per-author so the scenario matrix can compare HONEST-AUTHORED
        # throughput against the clean twin — a Byzantine node's own
        # unsequenced load is its own loss, not a liveness failure.
        # Blocks are the liveness gate's unit: the sim's TestBlockHandler
        # mints one Share per handle_blocks BATCH, so relayed/fetched
        # delivery (which coalesces batches) under attack suppresses load
        # GENERATION — a generator artifact the block count is blind to.
        self.committed_tx: Dict[int, Dict[int, int]] = {}
        self.committed_blocks: Dict[int, Dict[int, int]] = {}

    def mark_adversary(self, authority: int) -> None:
        self.adversaries.add(authority)

    def _note_adversary_divergence(self, **fields) -> None:
        self.adversary_divergence.append(dict(fields))
        log.warning("adversary-attributed commit divergence: %s", fields)

    def note_adopted(
        self, authority: int, height: int, leader: Optional[BlockReference]
    ) -> None:
        """The authority adopted a snapshot baseline at ``height``."""
        self._adopted[authority] = max(self._adopted.get(authority, 0), height)
        if leader is not None and height > 0:
            mine = self._anchors.setdefault(authority, {})
            prev = mine.get(height)
            if prev is not None and prev != leader:
                if authority in self.adversaries:
                    self._note_adversary_divergence(
                        kind="adopt-conflict", adversary=authority,
                        height=height,
                    )
                    mine[height] = leader
                    return
                violation = SafetyViolation(
                    f"authority {authority} adopted anchor {leader!r} at "
                    f"height {height} but had committed {prev!r}"
                )
                if self._violation is None:
                    self._violation = violation
                raise violation
            mine[height] = leader

    def note_epoch(self, authority: int, records) -> None:
        """Record epoch boundaries an authority derived (EpochRecord list
        from a switch, a recovery re-scan, or a snapshot chain adoption).
        A node re-deriving a DIFFERENT boundary for an epoch it already
        crossed — e.g. before and after a crash — raises immediately."""
        mine = self._epochs.setdefault(authority, {})
        for rec in records:
            entry = (rec.boundary_height, bytes(rec.digest))
            prev = mine.get(rec.epoch)
            if prev is not None and prev != entry:
                if authority in self.adversaries:
                    self._note_adversary_divergence(
                        kind="epoch-self-conflict", adversary=authority,
                        epoch=rec.epoch,
                    )
                    mine[rec.epoch] = entry
                    continue
                violation = SafetyViolation(
                    f"authority {authority} derived epoch {rec.epoch} twice "
                    f"with different boundaries: {prev!r} then {entry!r}"
                )
                if self._violation is None:
                    self._violation = violation
                raise violation
            mine[rec.epoch] = entry

    def epoch_of(self, authority: int) -> int:
        mine = self._epochs.get(authority)
        return max(mine) if mine else 0

    def note_state_root(self, authority: int, height: int, root: bytes) -> None:
        """Record the state root an authority derived by folding the commit
        at ``height`` through the execution state machine.  A node
        re-deriving a DIFFERENT root for a height it already executed —
        e.g. across a crash-restart replay or a snapshot adoption — raises
        immediately: determinism broke on ONE node before it could fork
        the fleet."""
        mine = self._state_roots.setdefault(authority, {})
        root = bytes(root)
        prev = mine.get(height)
        if prev is not None and prev != root:
            if authority in self.adversaries:
                self._note_adversary_divergence(
                    kind="state-root-self-conflict", adversary=authority,
                    height=height,
                )
                mine[height] = root
                return
            violation = SafetyViolation(
                f"authority {authority} executed height {height} twice with "
                f"different roots: {prev.hex()[:16]} then {root.hex()[:16]}"
            )
            if self._violation is None:
                self._violation = violation
            raise violation
        mine[height] = root

    def executed_height(self, authority: int) -> int:
        mine = self._state_roots.get(authority)
        return max(mine) if mine else 0

    def state_root_at(self, authority: int, height: int) -> Optional[bytes]:
        return self._state_roots.get(authority, {}).get(height)

    def observe(self, authority: int, committed) -> None:
        """Record a node's freshly committed sub-dags (List[CommittedSubDag])."""
        mine = self._anchors.setdefault(authority, {})
        for commit in committed:
            if commit.height not in mine:
                blocks = getattr(commit, "blocks", None) or ()
                by_author = self.committed_tx.setdefault(authority, {})
                blocks_by_author = self.committed_blocks.setdefault(
                    authority, {}
                )
                for block in blocks:
                    author = block.author()
                    blocks_by_author[author] = (
                        blocks_by_author.get(author, 0) + 1
                    )
                    shares = sum(
                        1 for st in block.statements if isinstance(st, Share)
                    )
                    if shares:
                        by_author[author] = by_author.get(author, 0) + shares
            prev = mine.get(commit.height)
            if prev is not None and prev != commit.anchor:
                if authority in self.adversaries:
                    self._note_adversary_divergence(
                        kind="self-conflict", adversary=authority,
                        height=commit.height,
                    )
                    mine[commit.height] = commit.anchor
                    continue
                violation = SafetyViolation(
                    f"authority {authority} committed two anchors at height "
                    f"{commit.height}: {prev!r} then {commit.anchor!r}"
                )
                if self._violation is None:
                    self._violation = violation
                raise violation
            mine[commit.height] = commit.anchor

    def committed_height(self, authority: int) -> int:
        mine = self._anchors.get(authority)
        return max(mine) if mine else 0

    def sequence(self, authority: int) -> List[BlockReference]:
        """The node's committed anchors in height order; raises on gaps
        (a hole means commits were observed out of linearizer order).  A
        gap lying wholly below the authority's adopted snapshot baseline is
        the legal catch-up shape (see :meth:`note_adopted`)."""
        mine = self._anchors.get(authority, {})
        adopted = self._adopted.get(authority, 0)
        out: List[BlockReference] = []
        expect = 1
        for height in sorted(mine):
            if height != expect and height - 1 > adopted:
                raise SafetyViolation(
                    f"authority {authority} has a commit gap at height "
                    f"{expect} (next observed: {height})"
                )
            out.append(mine[height])
            expect = height + 1
        return out

    def check(self) -> None:
        """Global prefix consistency: same anchor at every shared height.

        With declared adversaries the invariant is audited over HONEST
        nodes (that is the paper's guarantee: safety among the correct
        f+1..n); an adversary node whose own commit stream diverges from
        the honest golden sequence is recorded in
        :attr:`adversary_divergence`, attributed by name — evidence, not a
        scenario failure."""
        if self._violation is not None:
            raise self._violation
        golden: Dict[int, Tuple[BlockReference, int]] = {}
        for authority in sorted(self._anchors):
            if authority in self.adversaries:
                continue
            self.sequence(authority)  # per-node contiguity
            for height, anchor in self._anchors[authority].items():
                prev = golden.get(height)
                if prev is None:
                    golden[height] = (anchor, authority)
                elif prev[0] != anchor:
                    raise SafetyViolation(
                        f"fork at height {height}: authority {prev[1]} "
                        f"committed {prev[0]!r}, authority {authority} "
                        f"committed {anchor!r}"
                    )
        for authority in sorted(self.adversaries & set(self._anchors)):
            try:
                self.sequence(authority)
            except SafetyViolation:
                self._note_adversary_divergence(
                    kind="gap", adversary=authority
                )
            for height, anchor in self._anchors[authority].items():
                prev = golden.get(height)
                if prev is not None and prev[0] != anchor:
                    self._note_adversary_divergence(
                        kind="fork", adversary=authority, height=height,
                    )
        # Epoch-boundary agreement (reconfig.py): every honest node that
        # crossed epoch E derived the same (boundary height, committee
        # digest) — prefix consistency extended across reconfigurations.
        golden_epochs: Dict[int, Tuple[Tuple[int, bytes], int]] = {}
        for authority in sorted(self._epochs):
            if authority in self.adversaries:
                continue
            for epoch, entry in self._epochs[authority].items():
                prev = golden_epochs.get(epoch)
                if prev is None:
                    golden_epochs[epoch] = (entry, authority)
                elif prev[0] != entry:
                    raise SafetyViolation(
                        f"epoch fork at epoch {epoch}: authority {prev[1]} "
                        f"derived {prev[0]!r}, authority {authority} "
                        f"derived {entry!r}"
                    )
        for authority in sorted(self.adversaries & set(self._epochs)):
            for epoch, entry in self._epochs[authority].items():
                prev = golden_epochs.get(epoch)
                if prev is not None and prev[0] != entry:
                    self._note_adversary_divergence(
                        kind="epoch-fork", adversary=authority, epoch=epoch,
                    )
        # Execution state-root agreement (execution.py): every honest node
        # that folded the commit at height H derived the same chained root
        # — identical committed inputs produced identical replicated state.
        # A disagreement here with AGREEING anchors is the worst failure
        # this harness can detect: consensus held, determinism did not.
        golden_roots: Dict[int, Tuple[bytes, int]] = {}
        for authority in sorted(self._state_roots):
            if authority in self.adversaries:
                continue
            for height, root in self._state_roots[authority].items():
                prev = golden_roots.get(height)
                if prev is None:
                    golden_roots[height] = (root, authority)
                elif prev[0] != root:
                    raise SafetyViolation(
                        f"state-root fork at height {height}: authority "
                        f"{prev[1]} derived {prev[0].hex()[:16]}, authority "
                        f"{authority} derived {root.hex()[:16]}"
                    )
        for authority in sorted(self.adversaries & set(self._state_roots)):
            for height, root in self._state_roots[authority].items():
                prev = golden_roots.get(height)
                if prev is not None and prev[0] != root:
                    self._note_adversary_divergence(
                        kind="state-root-fork", adversary=authority,
                        height=height,
                    )


class _CheckedCommitObserver(TestCommitObserver):
    """TestCommitObserver that feeds every commit to the SafetyChecker."""

    def __init__(self, checker: SafetyChecker, authority: int, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._checker = checker
        self._checked_authority = authority

    def handle_commit(self, committed_leaders):
        committed = super().handle_commit(committed_leaders)
        self._checker.observe(self._checked_authority, committed)
        return committed

    def adopt_snapshot(self, manifest):
        super().adopt_snapshot(manifest)
        self._checker.note_adopted(
            self._checked_authority,
            manifest.commit_height,
            manifest.last_committed_leader,
        )


# ---------------------------------------------------------------------------
# Harness: an N-validator sim fleet whose nodes survive crash-restart


class _SimNodeNetwork:
    """Adapter giving NetworkSyncer the TcpNetwork surface over the sim."""

    def __init__(self, queue: asyncio.Queue) -> None:
        self.connections = queue

    async def stop(self) -> None:
        pass


class ChaosSimHarness:
    """N validators over :class:`SimulatedNetwork` with per-node WAL files.

    Unlike the plain sim-test fleets, nodes here are individually crashable:
    :meth:`crash` tears a node down (links break first — a dead node stops
    talking mid-protocol — then tasks, then the WAL), and :meth:`restart`
    rebuilds the validator from the same WAL path, driving the full
    ``BlockStore.open`` -> ``Core`` recovery path, and reconnects it.
    """

    def __init__(
        self,
        n: int,
        wal_dir: str,
        parameters: Optional[Parameters] = None,
        committee: Optional[Committee] = None,
        verifier_factory=None,
        with_metrics: bool = False,
        slo: Optional[SLOThresholds] = None,
        health_interval_s: float = 1.0,
        per_node_parameters: Optional[Dict[int, Parameters]] = None,
        latency_ranges=None,
        adversaries: Optional[Set[int]] = None,
        absent: Optional[Set[int]] = None,
    ) -> None:
        self.n = n
        self.wal_dir = wal_dir
        # Epoch reconfiguration (reconfig.py): ``absent`` authorities are
        # registered in the committee (stable-index membership) but not
        # BUILT at start — :meth:`join` boots one mid-run, typically after
        # a committed ADD change activated its stake; ``retired`` tracks
        # clean departures (:meth:`retire`) so the health plane never
        # flags them as stragglers.
        self.absent: Set[int] = set(absent or ())
        self.retired: Set[int] = set()
        self.committee = committee or Committee.new_test([1] * n)
        self.signers = Committee.benchmark_signers(n)
        self.parameters = parameters or Parameters(leader_timeout_s=1.0)
        # Mixed-version drills (scenarios.py): individual nodes may run
        # with different Parameters (soft wire tags on/off, storage knobs)
        # — exactly the rolling-upgrade skew a real fleet lives through.
        self.per_node_parameters = per_node_parameters or {}
        # (authority, committee, metrics) -> BlockVerifier, or None for the
        # AcceptAll default (chaos scenarios that are not about the verifier
        # keep the sim fully single-threaded, hence bit-reproducible).
        self.verifier_factory = verifier_factory
        # One Metrics per authority, SHARED across restarts, so counters like
        # crash_recovery_total accumulate over the node's whole life.
        self.metrics: List[Optional[Metrics]] = [
            Metrics() if with_metrics else None for _ in range(n)
        ]
        self.checker = SafetyChecker()
        for adversary in sorted(adversaries or ()):
            self.checker.mark_adversary(adversary)
        self.sim_net = SimulatedNetwork(n, latency_ranges=latency_ranges)
        self.nodes: List[Optional[NetworkSyncer]] = [None] * n
        self.down: Set[int] = set()
        # Flight recorders: one ring per authority, SURVIVING restarts like
        # the probes (the forensic window must span the crash) — memory-only
        # here; ``run_chaos_sim`` dumps every live node's ring the moment
        # the SafetyChecker fails.
        self.recorders: Dict[int, FlightRecorder] = {
            a: FlightRecorder(authority=a, metrics=self.metrics[a])
            for a in range(n)
        }
        # Health plane: one probe per authority, SURVIVING restarts (rate
        # state and the alert stream span a node's whole life); a central
        # loop-clocked monitor samples them so same-seed runs produce a
        # byte-identical health timeline.
        self.probes: Dict[int, HealthProbe] = (
            {
                a: HealthProbe(
                    a, n, metrics=self.metrics[a], slo=slo,
                    recorder=self.recorders[a],
                )
                for a in range(n)
            }
            if slo is not None
            else {}
        )
        self.health_monitor: Optional[FleetHealthMonitor] = (
            FleetHealthMonitor(self.probes.get, n, interval_s=health_interval_s)
            if slo is not None
            else None
        )

    def _wal_path(self, authority: int) -> str:
        return os.path.join(self.wal_dir, f"wal-{authority}")

    def parameters_for(self, authority: int) -> Parameters:
        return self.per_node_parameters.get(authority, self.parameters)

    def _build_node(self, authority: int) -> NetworkSyncer:
        from .storage import open_store

        parameters = self.parameters_for(authority)
        recovered, observer_recovered, wal_writer, lifecycle = open_store(
            authority, self._wal_path(authority), self.committee,
            parameters, self.metrics[authority],
        )
        handler = TestBlockHandler(
            last_transaction=authority * 1_000_000,
            committee=self.committee,
            authority=authority,
        )
        core = Core(
            block_handler=handler,
            authority=authority,
            committee=self.committee,
            parameters=parameters,
            recovered=recovered,
            wal_writer=wal_writer,
            options=CoreOptions.test(),
            signer=self.signers[authority],
            metrics=self.metrics[authority],
            storage=lifecycle,
        )
        observer = _CheckedCommitObserver(
            self.checker,
            authority,
            core.block_store,
            self.committee,
            recovered_state=observer_recovered,
        )
        recorder = self.recorders[authority]
        observer.recorder = recorder
        if lifecycle is not None:
            lifecycle.recorder = recorder
        # Equivocation detection (block_store.py) flows to the same ring:
        # a double-proposal observed seconds before a safety incident is
        # exactly the forensic edge the recorder exists for.  Commit-rule
        # decision skips/flips (decisions.py) join it — a Byzantine run's
        # skipped slots arrive pre-explained.
        core.block_store.recorder = recorder
        core.committer.ledger.recorder = recorder
        verifier = (
            self.verifier_factory(
                authority, self.committee, self.metrics[authority]
            )
            if self.verifier_factory is not None
            else None
        )
        node = NetworkSyncer(
            core,
            observer,
            _SimNodeNetwork(self.sim_net.node_connections[authority]),
            parameters=parameters,
            block_verifier=verifier,
            metrics=self.metrics[authority],
            recorder=recorder,
        )
        probe = self.probes.get(authority)
        if probe is not None:
            probe.attach(
                core=core,
                net_syncer=node,
                block_verifier=verifier,
                commit_observer=observer,
            )
        if core.reconfig is not None:
            # Feed the epoch audit: boundaries already re-derived by this
            # boot (recovery re-scan / checkpoint chain), then every future
            # switch via the listener.
            if core.reconfig.chain.records:
                self.checker.note_epoch(authority, core.reconfig.chain.records)
            core.epoch_listeners.append(
                lambda committee, records, a=authority: self.checker.note_epoch(
                    a, records
                )
            )
        if core.execution is not None:
            # Feed the state-root audit: heights already re-folded by this
            # boot (recovery re-scan over the post-checkpoint commits),
            # then every future fold via the listener.  A crash-restarted
            # node thus re-asserts the SAME roots it derived before the
            # crash — the self-conflict arm of note_state_root.
            if core.execution.last_height > 0:
                self.checker.note_state_root(
                    authority, core.execution.last_height, core.execution.root
                )
            core.execution_listeners.append(
                lambda result, a=authority: self.checker.note_state_root(
                    a, result.height, result.root
                )
            )
        return node

    async def start(self) -> None:
        for authority in range(self.n):
            if authority in self.absent:
                self.down.add(authority)
                continue
            node = self._build_node(authority)
            self.nodes[authority] = node
            await node.start()
        await self.sim_net.connect_all()
        for authority in sorted(self.absent):
            # Links to an absent node are severed immediately (peers see
            # closure, exactly like a pre-start crash); join() restores
            # them through the ordinary restart path.
            self.sim_net.crash(authority)
        if self.health_monitor is not None:
            for authority in self.absent:
                self.health_monitor.note_retired(authority)
            self.health_monitor.start()

    async def crash(self, authority: int, torn_tail_bytes: int = 0) -> None:
        node = self.nodes[authority]
        assert node is not None, f"authority {authority} is already down"
        self.down.add(authority)
        self.recorders[authority].record(
            "crash", torn_tail_bytes=torn_tail_bytes
        )
        probe = self.probes.get(authority)
        if probe is not None:
            probe.detach()  # sampled as {"down": true} until restart
        self.sim_net.crash(authority)
        await node.stop()
        # Close the WAL cleanly (drains the async appender): the baseline
        # crash model is "durable up to the last acknowledged append".  The
        # torn tail below then simulates the STRONGER loss — a write cut
        # mid-entry — on top of it.
        node.core.wal_writer.close()
        node.core.block_store.close()
        self.nodes[authority] = None
        if torn_tail_bytes > 0:
            # The tear lands where appends land: the active segment of a
            # segmented WAL, the file itself for a single-file log.
            from .storage import active_wal_file

            target = active_wal_file(self._wal_path(authority))
            size = os.path.getsize(target)
            with open(target, "r+b") as f:
                f.truncate(max(0, size - torn_tail_bytes))

    async def restart(self, authority: int) -> NetworkSyncer:
        assert authority in self.down, f"authority {authority} is not down"
        self.recorders[authority].record("restart")
        node = self._build_node(authority)  # WAL replay happens here
        self.nodes[authority] = node
        await node.start()
        self.down.discard(authority)
        await self.sim_net.restart(authority)
        return node

    # -- epoch reconfiguration (reconfig.py) --

    async def join(self, authority: int) -> NetworkSyncer:
        """First boot of an ``absent`` authority mid-run: a fresh epoch-0
        start from an empty WAL.  The joiner discovers the current
        committee by replaying the committed sequence — or, far behind,
        by adopting a snapshot manifest whose epoch chain carries every
        boundary it slept through."""
        assert authority in self.absent, f"authority {authority} not absent"
        self.recorders[authority].record("join")
        node = self._build_node(authority)
        self.nodes[authority] = node
        await node.start()
        self.down.discard(authority)
        self.absent.discard(authority)
        if self.health_monitor is not None:
            self.health_monitor.note_joined(authority)
        await self.sim_net.restart(authority)
        return node

    async def retire(self, authority: int) -> None:
        """Clean departure (a committed REMOVE change): stop the node and
        keep it gone.  Deliberately NOT a crash — no crash event is
        recorded, the health plane marks the authority retired (not down),
        and no restart ever follows."""
        node = self.nodes[authority]
        assert node is not None, f"authority {authority} is already down"
        self.retired.add(authority)
        self.down.add(authority)
        self.recorders[authority].record("retire")
        probe = self.probes.get(authority)
        if probe is not None:
            probe.detach()
        if self.health_monitor is not None:
            self.health_monitor.note_retired(authority)
        self.sim_net.crash(authority)
        await node.stop()
        node.core.wal_writer.close()
        node.core.block_store.close()
        self.nodes[authority] = None

    def submit_change(self, via: int, change) -> None:
        """Plant a committee-change transaction on ``via``'s block handler:
        it rides the next own proposal as an ordinary Share and takes
        effect when the committed sequence orders it."""
        node = self.nodes[via]
        assert node is not None, f"authority {via} is down"
        node.core.block_handler.inject(change.to_bytes())

    def inject(self, via: int, payload: bytes) -> None:
        """Plant an arbitrary transaction payload on ``via``'s block handler
        (the execution-plane workload rides the same next-own-proposal path
        as committee changes)."""
        node = self.nodes[via]
        assert node is not None, f"authority {via} is down"
        node.core.block_handler.inject(payload)

    async def stop(self) -> None:
        if self.health_monitor is not None:
            self.health_monitor.stop()
        for node in self.nodes:
            if node is None:
                continue
            await node.stop()
            node.core.wal_writer.close()
            node.core.block_store.close()
        self.sim_net.close()

    # -- commit accessors (all via the checker: restart-proof) --

    def committed_height(self, authority: int) -> int:
        return self.checker.committed_height(authority)

    def sequences(self) -> Dict[int, List[BlockReference]]:
        out: Dict[int, List[BlockReference]] = {}
        for a in range(self.n):
            try:
                out[a] = self.checker.sequence(a)
            except SafetyViolation:
                if a not in self.checker.adversaries:
                    raise
                # An adversary's own gap is attributed evidence (already in
                # adversary_divergence via check()), not a report failure.
                out[a] = []
        return out



# ---------------------------------------------------------------------------
# The engine


class ChaosEngine:
    """Executes a :class:`FaultPlan` against a :class:`ChaosSimHarness`.

    Acts as BOTH the timed-event scheduler (partitions, crash-restarts) and
    the :class:`SimulatedNetwork` fault injector (per-message drop /
    duplicate / delay draws from a plan-seeded RNG).  Every injected fault
    is appended to a log whose canonical-JSON serialization
    (:meth:`fault_log_bytes`) is byte-identical across same-seed runs —
    message order is deterministic under the DeterministicLoop, and the
    draws consume a dedicated ``Random`` in that order.
    """

    def __init__(self, harness: ChaosSimHarness, plan: FaultPlan) -> None:
        self.harness = harness
        self.plan = plan
        self.events = resolve_schedule(plan)
        self._link_rng = random.Random((plan.seed << 1) ^ 0x5EEDFA17)
        self._blocked: Set[Tuple[int, int]] = set()
        self._log: List[dict] = []
        self._task: Optional[asyncio.Task] = None
        # Byzantine layer (adversary.py): adversary nodes' outbound traffic
        # is rewritten BEFORE the benign link faults, on its own plan-seeded
        # RNG, so composing attacks with drops/partitions never shifts the
        # benign draw sequence of an adversary-free plan.
        self.adversary: Optional[AdversaryEngine] = (
            AdversaryEngine(
                plan.adversaries, harness.signers, harness.n, seed=plan.seed
            )
            if plan.adversaries
            else None
        )

    # -- lifecycle --

    def start(self) -> "ChaosEngine":
        self.harness.sim_net.fault_injector = self
        self._task = spawn_logged(self._run(), log, name="chaos-engine")
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        self.harness.sim_net.fault_injector = None

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        for event in self.events:
            delay = event["t"] - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            await self._execute(event)

    async def _execute(self, event: dict) -> None:
        kind = event["kind"]
        if kind == "partition_start":
            fault = PartitionFault.from_dict(event)
            self._blocked.update(fault.directed_pairs())
            self._record(kind, pairs=len(fault.directed_pairs()))
        elif kind == "partition_end":
            fault = PartitionFault.from_dict(event)
            self._blocked.difference_update(fault.directed_pairs())
            self._record(kind, pairs=len(fault.directed_pairs()))
        elif kind == "crash":
            node = event["node"]
            height = self.harness.committed_height(node)
            await self.harness.crash(
                node, torn_tail_bytes=event.get("torn_tail_bytes", 0)
            )
            self._count_fault(node, "crash")
            self._record(
                kind, node=node, committed_height=height,
                torn_tail_bytes=event.get("torn_tail_bytes", 0),
            )
        elif kind == "restart":
            node = event["node"]
            await self.harness.restart(node)
            self._count_fault(node, "restart")
            self._record(
                kind, node=node,
                committed_height=self.harness.committed_height(node),
            )

    # -- fault injector surface (SimulatedNetwork._pump) --

    def filter_batch(self, src: int, dst: int, batch: list) -> List[tuple]:
        if (src, dst) in self._blocked:
            self._count_fault(dst, "blackhole")
            self._record("blackhole", src=src, dst=dst, n=len(batch))
            return []
        t = asyncio.get_event_loop().time()
        groups = (
            self.adversary.transform(src, dst, batch, t)
            if self.adversary is not None
            else [(0.0, batch)]
        )
        out: List[tuple] = []
        for base_delay, messages in groups:
            for extra, sub in self._apply_link_faults(src, dst, messages, t):
                out.append((base_delay + extra, sub))
        return out

    def _apply_link_faults(
        self, src: int, dst: int, batch: list, t: float
    ) -> List[tuple]:
        rule = next(
            (f for f in self.plan.link_faults if f.matches(src, dst, t)), None
        )
        if rule is None:
            return [(0.0, batch)]
        rng = self._link_rng
        on_time: List = []
        extra_groups: List[tuple] = []
        dropped = duplicated = delayed = 0
        for message in batch:
            if rule.drop_p > 0.0 and rng.random() < rule.drop_p:
                dropped += 1
                continue
            if rule.delay_p > 0.0 and rng.random() < rule.delay_p:
                extra_groups.append(
                    (rng.uniform(*rule.delay_extra_s), [message])
                )
                delayed += 1
            else:
                on_time.append(message)
            if rule.duplicate_p > 0.0 and rng.random() < rule.duplicate_p:
                extra_groups.append(
                    (rng.uniform(*rule.delay_extra_s), [message])
                )
                duplicated += 1
        if dropped or duplicated or delayed:
            for kind, count in (
                ("drop", dropped), ("duplicate", duplicated), ("delay", delayed),
            ):
                if count:
                    self._count_fault(dst, kind, count)
            self._record(
                "link_faults", src=src, dst=dst,
                dropped=dropped, duplicated=duplicated, delayed=delayed,
            )
        return [(0.0, on_time)] + extra_groups

    # -- bookkeeping --

    def _record(self, kind: str, **fields) -> None:
        entry = {"t": asyncio.get_event_loop().time(), "kind": kind}
        entry.update(fields)
        self._log.append(entry)

    def _count_fault(self, node: int, kind: str, count: int = 1) -> None:
        metrics = self.harness.metrics[node]
        if metrics is not None:
            metrics.chaos_faults_total.labels(kind).inc(count)

    @property
    def fault_log(self) -> List[dict]:
        return list(self._log)

    def fault_log_bytes(self) -> bytes:
        return _canonical_json(self._log).encode()

    def fault_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for entry in self._log:
            if entry["kind"] == "link_faults":
                for key in ("dropped", "duplicated", "delayed"):
                    counts[key] = counts.get(key, 0) + entry[key]
            else:
                counts[entry["kind"]] = counts.get(entry["kind"], 0) + 1
        return counts


# ---------------------------------------------------------------------------
# One-call runner (tests + the `chaos` CLI subcommand)


@dataclass
class ChaosReport:
    """Everything a scenario needs to assert on (or a human to read)."""

    sequences: Dict[int, List[BlockReference]]
    fault_log: List[dict]
    fault_log_bytes: bytes
    schedule_bytes: bytes
    fault_counts: Dict[str, int]
    crash_events: List[dict]
    # Health plane (present when the scenario ran with an SLO config): the
    # deterministic fleet timeline, its canonical bytes, and every watchdog
    # alert — the run ships with its own diagnosis.
    health_timeline: List[dict] = field(default_factory=list)
    health_timeline_bytes: bytes = b""
    slo_alerts: List[dict] = field(default_factory=list)
    # Flight recorders: every node's canonical event-ring dump (byte-
    # identical across same-seed runs).  On a safety FAILURE the sim never
    # reaches this report — the rings land on disk instead
    # (``flight-recorder-<authority>.json`` next to the WALs).
    recorder_dumps: Dict[int, bytes] = field(default_factory=dict)
    # Byzantine layer (adversary.py): the injected attack schedule (ledger),
    # what the honest fleet detected (per-node counter census), and any
    # commit divergence attributed to a declared adversary.  All canonical
    # — byte-identical across same-seed runs.
    attack_log: List[dict] = field(default_factory=list)
    attack_log_bytes: bytes = b""
    attack_counts: Dict[str, int] = field(default_factory=dict)
    detections: Dict[int, dict] = field(default_factory=dict)
    adversary_divergence: List[dict] = field(default_factory=list)
    # Committed Share statements / blocks, observer -> block author ->
    # count (height-deduped): the scenario matrix's committed-throughput
    # numerators, per-author so honest-authored load is separable.  The
    # liveness gate uses BLOCKS (the protocol's own unit — Share counts
    # also reflect the test generator's batch-shaped minting).
    committed_tx: Dict[int, Dict[int, int]] = field(default_factory=dict)
    committed_blocks: Dict[int, Dict[int, int]] = field(default_factory=dict)
    # Epoch reconfiguration: the final epoch each authority reached, and
    # the audited boundary table (epoch -> [boundary_height, digest hex])
    # agreed by the honest fleet — empty when the scenario never
    # reconfigured.
    epochs: Dict[int, int] = field(default_factory=dict)
    epoch_boundaries: Dict[int, List] = field(default_factory=dict)
    # Execution plane: each authority's highest executed height and the root
    # it derived there, plus the honest fleet's agreed root chain
    # (height -> root hex; the per-height agreement itself is the
    # SafetyChecker's job — a state-root fork raises before this report is
    # built).  Empty when the scenario never ran the execution plane.
    executed: Dict[int, List] = field(default_factory=dict)
    state_root_chain: Dict[int, str] = field(default_factory=dict)

    @staticmethod
    def _from_authors(
        table: Dict[int, Dict[int, int]], authors: Set[int]
    ) -> Dict[int, int]:
        return {
            observer: sum(
                count
                for author, count in by_author.items()
                if author in authors
            )
            for observer, by_author in table.items()
        }

    def committed_tx_from(self, authors: Set[int]) -> Dict[int, int]:
        """observer -> committed Shares authored by ``authors``."""
        return self._from_authors(self.committed_tx, authors)

    def committed_blocks_from(self, authors: Set[int]) -> Dict[int, int]:
        """observer -> committed blocks authored by ``authors``."""
        return self._from_authors(self.committed_blocks, authors)

    def schedule_digest(self) -> str:
        return hashlib.sha256(self.fault_log_bytes).hexdigest()

    def attack_digest(self) -> str:
        return hashlib.sha256(self.attack_log_bytes).hexdigest()

    def detections_bytes(self) -> bytes:
        return _canonical_json(
            {str(a): d for a, d in sorted(self.detections.items())}
        ).encode()


def _labeled_counter_census(counter) -> Dict[str, float]:
    """Non-zero label->value census of a prometheus counter.  Only the
    ``_total`` samples enter (the ``_created`` companion carries a wall
    timestamp and would break same-seed byte-identity)."""
    out: Dict[str, float] = {}
    for family in counter.collect():
        for sample in family.samples:
            if not sample.name.endswith("_total") or not sample.value:
                continue
            key = ",".join(
                f"{k}={v}" for k, v in sorted(sample.labels.items())
            ) or "_"
            out[key] = sample.value
    return {k: out[k] for k in sorted(out)}


def collect_detections(harness: ChaosSimHarness) -> Dict[int, dict]:
    """Per-node detection census: what each (metrics-carrying) node's
    honest path caught and attributed.  The metrics objects survive
    crash-restarts, so the census spans each node's whole life."""
    detections: Dict[int, dict] = {}
    for authority in range(harness.n):
        metrics = harness.metrics[authority]
        if metrics is None:
            continue
        node: dict = {}
        for name, counter in (
            ("equivocation", metrics.mysticeti_equivocation_detected_total),
            ("invalid_blocks", metrics.mysticeti_invalid_blocks_total),
            ("malformed", metrics.mysticeti_malformed_frames_total),
        ):
            census = _labeled_counter_census(counter)
            if census:
                node[name] = census
        if node:
            detections[authority] = node
    return detections


def run_chaos_sim(
    plan: FaultPlan,
    n: int,
    duration_s: float,
    wal_dir: str,
    parameters: Optional[Parameters] = None,
    verifier_factory=None,
    with_metrics: bool = False,
    extra_fault=None,
    slo: Optional[SLOThresholds] = None,
    per_node_parameters: Optional[Dict[int, Parameters]] = None,
    latency_ranges=None,
    committee: Optional[Committee] = None,
    detsan=None,
    absent: Optional[Set[int]] = None,
) -> Tuple[ChaosReport, ChaosSimHarness]:
    """Run one chaos scenario to completion on a fresh DeterministicLoop.

    Returns the report plus the (stopped) harness so callers can inspect
    per-node metrics.  ``extra_fault(harness) -> awaitable`` is an optional
    test hook scheduled alongside the plan (e.g. killing an injected
    verifier backend mid-run).  ``detsan`` attaches a
    :class:`mysticeti_tpu_torch.detsan.DetsanRecorder` to the loop so two
    runs of the same plan can be diffed event-by-event
    (``python -m mysticeti_tpu_torch.tools.detsan``).
    Raises :class:`SafetyViolation` if any committed prefix ever diverged.
    """
    from .runtime.simulated import run_simulation

    if plan.adversaries:
        if committee is None:
            # Byzantine scenarios verify REAL signatures end-to-end: the
            # default new_test committee shares one dummy key across all
            # authorities, which would reject every honest block.  The
            # benchmark committee's per-index keys match the harness
            # signers.
            committee = Committee.new_for_benchmarks(n)
        if verifier_factory is None:
            # An adversary plan with the AcceptAll default would make
            # `invalid_sig` a silent no-op (tampered blocks accepted and
            # committed, the detection counter never fires) — exactly what
            # a CLI `chaos --plan` replay of a Byzantine plan would hit.
            # Default to the sim re-sign oracle: exact Ed25519 semantics,
            # deterministic, sim-priced.
            from .scenarios import oracle_verifier_factory

            verifier_factory = oracle_verifier_factory(n)
    harness = ChaosSimHarness(
        n,
        wal_dir,
        parameters=parameters,
        committee=committee,
        verifier_factory=verifier_factory,
        with_metrics=with_metrics,
        slo=slo,
        per_node_parameters=per_node_parameters,
        latency_ranges=latency_ranges,
        adversaries={spec.node for spec in plan.adversaries},
        absent=absent,
    )
    engine = ChaosEngine(harness, plan)

    async def main() -> ChaosReport:
        await harness.start()
        engine.start()
        extra = (
            spawn_logged(extra_fault(harness), log, name="chaos-extra-fault")
            if extra_fault is not None
            else None
        )
        await asyncio.sleep(duration_s)
        engine.stop()
        if extra is not None:
            extra.cancel()
        await harness.stop()
        try:
            harness.checker.check()
        except SafetyViolation:
            # The flight recorder's reason to exist: the moment commit
            # safety fails, every LIVE node's event ring is dumped next to
            # the WALs (crashed nodes have no live ring to preserve — their
            # last dumpable state is whatever a restart rebuilt).
            for a in range(harness.n):
                if a in harness.down:
                    continue
                harness.recorders[a].dump(
                    "safety-failure",
                    path=os.path.join(wal_dir, f"flight-recorder-{a}.json"),
                )
            raise
        monitor = harness.health_monitor
        adversary = engine.adversary
        return ChaosReport(
            sequences=harness.sequences(),
            fault_log=engine.fault_log,
            fault_log_bytes=engine.fault_log_bytes(),
            schedule_bytes=schedule_bytes(plan),
            fault_counts=engine.fault_counts(),
            crash_events=[e for e in engine.fault_log if e["kind"] == "crash"],
            health_timeline=monitor.timeline if monitor else [],
            health_timeline_bytes=(
                monitor.timeline_bytes() if monitor else b""
            ),
            slo_alerts=monitor.alert_stream() if monitor else [],
            recorder_dumps={
                a: harness.recorders[a].snapshot_bytes()
                for a in range(harness.n)
            },
            attack_log=adversary.ledger.entries if adversary else [],
            attack_log_bytes=(
                adversary.ledger.ledger_bytes() if adversary else b""
            ),
            attack_counts=adversary.ledger.counts() if adversary else {},
            detections=collect_detections(harness),
            adversary_divergence=list(harness.checker.adversary_divergence),
            committed_tx={
                observer: dict(by_author)
                for observer, by_author in harness.checker.committed_tx.items()
            },
            committed_blocks={
                observer: dict(by_author)
                for observer, by_author in
                harness.checker.committed_blocks.items()
            },
            epochs={
                a: harness.checker.epoch_of(a)
                for a in range(harness.n)
                if harness.checker.epoch_of(a) > 0
            },
            epoch_boundaries={
                epoch: [height, digest.hex()]
                for table in harness.checker._epochs.values()
                for epoch, (height, digest) in table.items()
            },
            executed={
                a: [
                    harness.checker.executed_height(a),
                    (
                        harness.checker.state_root_at(
                            a, harness.checker.executed_height(a)
                        )
                        or b""
                    ).hex(),
                ]
                for a in range(harness.n)
                if harness.checker.executed_height(a) > 0
            },
            state_root_chain={
                height: root.hex()
                for a, table in sorted(harness.checker._state_roots.items())
                if a not in harness.checker.adversaries
                for height, root in table.items()
            },
        )

    return run_simulation(main(), seed=plan.seed, detsan=detsan), harness
