"""Declarative resilience scenario matrix (the Byzantine evaluation flywheel).

The port's copy of ``mysticeti_tpu.scenarios``.  One :class:`Scenario`
composes the adversary plane (adversary.py), the benign chaos plane
(chaos.py), the storage lifecycle plane (snapshot catch-up rejoin), a
geo-latency WAN profile, and mixed-version soft-tag skew into a single
seeded, reproducible run — the committee-consensus measurement shape of
arXiv 2302.00418 (vary the committee and the adversary mix, pin per-scenario
artifacts) applied to the chaos tier.

Every scenario runs TWICE on the same seed: the attacked run and a clean
twin (same committee, same network profile, same per-node parameters —
only the faults and adversaries removed), so the committed-throughput
ratio compares like with like.  The verdict is a pure function of the two
seeded runs:

* **safety** — zero :class:`~mysticeti_tpu_torch.chaos.SafetyViolation` among
  honest nodes; adversary-attributed divergence is recorded, not fatal;
* **liveness** — honest committed throughput (honest-authored blocks in
  the honest commit prefix) >= ``min_ratio`` x the clean twin's;
* **detection** — every injected behavior is detected on its surface
  (equivocation / invalid-signature / malformed counters) or, for the
  silence-shaped attacks (withhold, lag) whose only honest-side signal is
  absence, accounted in the attack ledger;
* **reproducibility** — the attack schedule, detection ledger, and
  committed sequences are canonical bytes (digests in the verdict), so a
  same-seed re-run is byte-identical.

``python -m mysticeti_tpu_torch scenarios`` runs one scenario or the whole
matrix; ``python -m mysticeti_tpu_torch.tools.scenario_matrix`` writes the
matrix verdicts in the JAX package's ``SCENARIO_rNN.json`` shape.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .adversary import AdversarySpec
from .chaos import (
    ChaosReport,
    CrashFault,
    FaultPlan,
    LinkFault,
    PartitionFault,
    SafetyViolation,
    run_chaos_sim,
)
from .committee import Committee
from .config import Parameters, StorageParameters, SynchronizerParameters
from .reconfig import (
    CHANGE_ADD,
    CHANGE_REMOVE,
    CHANGE_REWEIGHT,
    CommitteeChange,
)
from .tracing import logger

log = logger(__name__)

# WAN profile: three regions, intra-region fast, cross-region an ocean away.
WAN_INTRA_RANGE = (0.005, 0.015)
WAN_INTER_RANGE = (0.080, 0.160)


def wan_latency_ranges(
    regions: List[int],
) -> Dict[Tuple[int, int], Tuple[float, float]]:
    """Per-directed-link latency ranges from a region assignment (node ->
    region index): intra-region links draw from WAN_INTRA_RANGE, cross-
    region from WAN_INTER_RANGE."""
    n = len(regions)
    out: Dict[Tuple[int, int], Tuple[float, float]] = {}
    for a in range(n):
        for b in range(n):
            if a == b:
                continue
            out[(a, b)] = (
                WAN_INTRA_RANGE if regions[a] == regions[b] else WAN_INTER_RANGE
            )
    return out


@dataclass(frozen=True)
class ChurnEvent:
    """One scheduled membership change in a reconfig scenario.

    At ``at_s`` (virtual seconds) a :class:`CommitteeChange` is planted on
    authority ``via``'s block handler; it rides the committed sequence and
    takes effect at the commit-anchored epoch boundary every honest node
    derives from it.  ``follow_delay_s`` later, the harness performs the
    matching topology act: for ADD, :meth:`ChaosSimHarness.join` boots the
    (previously absent) authority, which discovers the new committee by
    snapshot catch-up or replay; for REMOVE, :meth:`ChaosSimHarness.retire`
    cleanly departs the node — the delay lets the change commit first, so a
    departing leader keeps its slots live until the boundary retires them.
    """

    at_s: float
    kind: int  # CHANGE_ADD / CHANGE_REMOVE / CHANGE_REWEIGHT
    authority: int
    stake: int = 0
    via: int = 0
    follow_delay_s: float = 2.0

    def to_dict(self) -> dict:
        return {
            "at_s": self.at_s,
            "kind": {
                CHANGE_ADD: "add",
                CHANGE_REMOVE: "remove",
                CHANGE_REWEIGHT: "reweight",
            }.get(self.kind, str(self.kind)),
            "authority": self.authority,
            "stake": self.stake,
            "via": self.via,
            "follow_delay_s": self.follow_delay_s,
        }


@dataclass(frozen=True)
class Scenario:
    """One declarative matrix entry.  Everything the run needs is here (or
    derived deterministically from it), so ``to_dict`` IS the scenario's
    reproduction recipe."""

    name: str
    description: str
    nodes: int
    duration_s: float
    seed: int = 0
    adversaries: Tuple[AdversarySpec, ...] = ()
    link_faults: Tuple[LinkFault, ...] = ()
    partitions: Tuple[PartitionFault, ...] = ()
    crashes: Tuple[CrashFault, ...] = ()
    # Honest committed throughput must stay >= this fraction of the clean
    # twin's (same seed, faults and adversaries removed).
    min_ratio: float = 0.8
    leader_timeout_s: float = 0.5
    # Geo profile: region index per node (() = uniform sim default).
    regions: Tuple[int, ...] = ()
    # Uniform link profile: one-way latency range for EVERY directed link
    # (None = the sim default 50-100 ms).  The default's ±33% jitter is far
    # above real WAN links; stable-link scenarios pin e.g. (0.08, 0.10) so
    # the measured Byzantine throughput tax is the protocol's, not the
    # jitter lottery's.  Ignored when ``regions`` is set.
    latency: Optional[Tuple[float, float]] = None
    # Storage lifecycle: arm segmented WAL + checkpoints + snapshot
    # catch-up with sim-scaled knobs (the churn-rejoin scenarios).
    snapshot_catchup: bool = False
    catchup_threshold_commits: int = 25
    # Helper relay streams (net_sync content-silence/equivocation-gap
    # scoring): the dissemination layer's Byzantine countermeasure — on by
    # default for the matrix; the mixed-version drill turns it off so the
    # old-version half genuinely predates the feature.
    helper_relays: bool = True
    # Mixed-version skew: these nodes additionally run every soft wire tag
    # (timestamped frames, helper streams) the rest of the fleet does not —
    # the rolling-upgrade drill.
    new_version_nodes: Tuple[int, ...] = ()
    # Epoch reconfiguration (reconfig.py): arm Parameters.reconfig, seed the
    # committee with these genesis stakes (() = all ones; a stake-0 entry is
    # a registered-but-inactive authority awaiting a committed ADD), keep
    # ``absent`` authorities unbooted until a churn event joins them, and
    # drive the ``churn`` schedule in BOTH twins — membership change is part
    # of the workload, not a fault, so the clean twin churns identically
    # and the throughput ratio compares like with like.
    reconfig: bool = False
    stakes: Tuple[int, ...] = ()
    absent: Tuple[int, ...] = ()
    churn: Tuple[ChurnEvent, ...] = ()
    # Reconfig gate: the honest fleet must reach at least this epoch by the
    # end of the attacked run (0 = no gate).
    min_epoch: int = 0
    # Execution plane (execution.py): arm Parameters.execution and drive a
    # deterministic account/transfer workload in BOTH twins (execution is
    # workload, not a fault) — every honest node must derive the SAME state
    # root at every shared height or the SafetyChecker fails the run.
    # Each injection batch is self-contained (CREATE a fresh account, then
    # nonce-ordered TRANSFERs out of it in the same proposal), so batches
    # commute across the committed interleaving and rejects stay
    # deterministic.
    execution: bool = False
    exec_interval_s: float = 0.5

    def plan(self) -> FaultPlan:
        return FaultPlan(
            seed=self.seed,
            link_faults=list(self.link_faults),
            partitions=list(self.partitions),
            crashes=list(self.crashes),
            adversaries=list(self.adversaries),
        )

    def clean_plan(self) -> FaultPlan:
        return FaultPlan(seed=self.seed)

    def base_parameters(self) -> Parameters:
        storage = (
            StorageParameters(
                segment_bytes=16 * 1024,
                checkpoint_interval=5,
                gc_depth=30,
                snapshot_catchup=True,
                catchup_threshold_commits=self.catchup_threshold_commits,
            )
            if self.snapshot_catchup
            else StorageParameters()
        )
        return Parameters(
            leader_timeout_s=self.leader_timeout_s,
            reconfig=self.reconfig,
            execution=self.execution,
            # Sim profile: rounds run ~0.1 s, so a 4-round liveness horizon
            # reacts to a silent leader within half a second (the
            # production default of 8 assumes real-network round times).
            leader_liveness_horizon_rounds=4,
            storage=storage,
            synchronizer=SynchronizerParameters(
                disseminate_others_blocks=self.helper_relays,
                # More relay paths per authority: an equivocation variant's
                # arrival is the MIN over its helpers' push paths, and the
                # race it must win (against the children referencing it) is
                # decided in ~half a sim latency draw.
                maximum_helpers_per_authority=4,
            ),
        )

    def per_node_parameters(self) -> Dict[int, Parameters]:
        if not self.new_version_nodes:
            return {}
        base = self.base_parameters()
        upgraded = dataclasses.replace(
            base,
            synchronizer=dataclasses.replace(
                base.synchronizer,
                timestamp_frames=True,
                disseminate_others_blocks=True,
            ),
        )
        return {node: upgraded for node in self.new_version_nodes}

    def latency_ranges(self):
        if self.regions:
            return wan_latency_ranges(list(self.regions))
        if self.latency is not None:
            return {
                (a, b): tuple(self.latency)
                for a in range(self.nodes)
                for b in range(self.nodes)
                if a != b
            }
        return None

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "description": self.description,
            "nodes": self.nodes,
            "duration_s": self.duration_s,
            "seed": self.seed,
            "min_ratio": self.min_ratio,
            "leader_timeout_s": self.leader_timeout_s,
            "regions": list(self.regions),
            "latency": list(self.latency) if self.latency else None,
            "helper_relays": self.helper_relays,
            "snapshot_catchup": self.snapshot_catchup,
            "catchup_threshold_commits": self.catchup_threshold_commits,
            "new_version_nodes": list(self.new_version_nodes),
            "plan": self.plan().to_dict(),
        }
        if self.reconfig:
            # Emitted only for reconfig scenarios so frozen-committee
            # verdict documents stay byte-identical.
            out.update(
                reconfig=True,
                stakes=list(self.stakes),
                absent=list(self.absent),
                churn=[event.to_dict() for event in self.churn],
                min_epoch=self.min_epoch,
            )
        if self.execution:
            # Emitted only for execution scenarios so pre-r20 verdict
            # documents stay byte-identical.
            out.update(
                execution=True,
                exec_interval_s=self.exec_interval_s,
            )
        return out


# ---------------------------------------------------------------------------
# Churn driver


def _churn_driver(scenario: Scenario):
    """The continuous-churn schedule as a chaos ``extra_fault`` hook.

    Runs in BOTH twins (membership change is workload, not attack).  All
    sleeps are virtual time on the :class:`DeterministicLoop`, so the
    schedule is part of the seeded reproduction recipe and same-seed runs
    are byte-identical."""
    events = sorted(scenario.churn, key=lambda e: (e.at_s, e.authority))

    async def driver(harness) -> None:
        now = 0.0
        for event in events:
            if event.at_s > now:
                await asyncio.sleep(event.at_s - now)
                now = event.at_s
            harness.submit_change(
                event.via,
                CommitteeChange(
                    kind=event.kind,
                    authority=event.authority,
                    stake=event.stake,
                ),
            )
            if event.follow_delay_s > 0.0:
                # Let the change ride a proposal and COMMIT before acting on
                # the topology: an ADDed joiner then catches up across the
                # boundary it slept through, and a REMOVEd (possibly
                # leader) node keeps its slots live until the boundary
                # retires them.
                await asyncio.sleep(event.follow_delay_s)
                now += event.follow_delay_s
            if event.kind == CHANGE_ADD and event.authority in harness.absent:
                await harness.join(event.authority)
            elif (
                event.kind == CHANGE_REMOVE
                and harness.nodes[event.authority] is not None
            ):
                await harness.retire(event.authority)

    return driver


# ---------------------------------------------------------------------------
# Execution workload driver


def _exec_driver(scenario: Scenario):
    """Deterministic execution workload as a chaos ``extra_fault`` hook.

    Every ``exec_interval_s`` of virtual time, each live non-adversary node
    plants one SELF-CONTAINED transaction batch on its own block handler:
    CREATE a fresh per-(node, batch) account, TRANSFER out of it twice in
    nonce order, plus one deliberate overdraft (a deterministic typed
    reject folded into the root like any other verdict).  Batches touch
    disjoint accounts, so any committed interleaving applies identically —
    the state-root chain is a pure function of the committed sequence, and
    the SafetyChecker's per-height audit has real state to bite on."""
    from .execution import ExecTx, OP_CREATE, OP_TRANSFER

    async def driver(harness) -> None:
        batch = 0
        while True:
            await asyncio.sleep(scenario.exec_interval_s)
            batch += 1
            for authority in range(scenario.nodes):
                if (
                    authority in harness.checker.adversaries
                    or harness.nodes[authority] is None
                ):
                    continue
                account = f"acct-{authority}-{batch}".encode()
                sink = f"sink-{authority}".encode()
                for tx in (
                    ExecTx(OP_CREATE, account, amount=1000),
                    ExecTx(OP_TRANSFER, account, nonce=1, amount=300,
                           dest=sink),
                    ExecTx(OP_TRANSFER, account, nonce=2, amount=300,
                           dest=b"treasury"),
                    # Overdraft on purpose: 400 left, 500 asked — the typed
                    # reject is part of the deterministic workload.
                    ExecTx(OP_TRANSFER, account, nonce=3, amount=500,
                           dest=sink),
                ):
                    harness.inject(authority, tx.to_bytes())

    return driver


def _compose_drivers(drivers):
    async def driver(harness) -> None:
        await asyncio.gather(*(d(harness) for d in drivers))

    return driver


# ---------------------------------------------------------------------------
# Verdicts


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _sequence_bytes(sequences: Dict[int, list]) -> bytes:
    doc = {
        str(a): [
            f"{ref.authority}:{ref.round}:{ref.digest.hex()}" for ref in seq
        ]
        for a, seq in sorted(sequences.items())
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def _detection_verdicts(
    scenario: Scenario, report: ChaosReport
) -> Dict[str, dict]:
    """Per-adversary detection verdict: which surface caught it.

    ``equivocate`` / ``invalid_sig`` / ``mangle`` have first-class honest-
    side counters; ``withhold`` and ``lag`` are silence-shaped (the honest
    signal is blocks NOT arriving) so their verdict is the attack ledger's
    accounting plus the scenario-level liveness bar."""
    verdicts: Dict[str, dict] = {}
    adversary_nodes = {spec.node for spec in scenario.adversaries}
    for spec in scenario.adversaries:
        key = f"{spec.behavior}:{spec.node}"
        injected = report.attack_counts.get(key, 0)
        detected = 0
        if spec.behavior == "equivocate":
            for a, census in report.detections.items():
                if a in adversary_nodes:
                    continue
                detected += census.get("equivocation", {}).get(
                    f"authority={spec.node}", 0
                )
        elif spec.behavior == "invalid_sig":
            for a, census in report.detections.items():
                if a in adversary_nodes:
                    continue
                detected += census.get("invalid_blocks", {}).get(
                    f"authority={spec.node},reason=signature", 0
                )
        elif spec.behavior == "mangle":
            for a, census in report.detections.items():
                if a in adversary_nodes:
                    continue
                detected += census.get("invalid_blocks", {}).get(
                    f"authority={spec.node},reason=malformed", 0
                )
        verdicts[key] = {
            "behavior": spec.behavior,
            "node": spec.node,
            "injected": injected,
            "detected": int(detected),
            "surface": (
                "ledger"
                if spec.behavior in ("withhold", "lag")
                else spec.behavior
            ),
            "ok": injected > 0
            and (spec.behavior in ("withhold", "lag") or detected > 0),
        }
    return verdicts


def run_scenario(
    scenario: Scenario,
    wal_root: str,
    real_crypto: bool = False,
    device=None,
    backend=None,
    verifier: Optional[str] = None,
) -> dict:
    """Attacked run + clean twin -> the scenario's verdict document.

    ``verifier`` is the kind of :func:`verifier_factory` every node's
    collector verifies through (default the sim re-sign oracle);
    ``cuda-only`` is genuine Ed25519 verification through the port's
    kernels, over one ``TorchSignatureVerifier`` on ``device`` (default
    ``cuda``, which raises without a card; ``"cpu"`` runs the kernels'
    plain versions), or over ``backend`` when given.  ``real_crypto`` is
    the JAX signature's name for ``verifier="cuda-only"``."""
    committee = Committee.new_for_benchmarks(
        scenario.nodes, stakes=list(scenario.stakes) or None
    )
    kind = _kind(verifier, real_crypto)
    kwargs = dict(
        parameters=scenario.base_parameters(),
        per_node_parameters=scenario.per_node_parameters() or None,
        latency_ranges=scenario.latency_ranges(),
        committee=committee,
        with_metrics=True,
        verifier_factory=verifier_factory(
            kind, committee, device=device, backend=backend
        ),
        absent=set(scenario.absent) or None,
    )
    # The churn schedule and the execution workload run in BOTH twins:
    # membership change and state-machine load are part of the workload,
    # so the clean baseline reconfigures and executes identically.
    drivers = []
    if scenario.churn:
        drivers.append(_churn_driver(scenario))
    if scenario.execution:
        drivers.append(_exec_driver(scenario))
    churn = _compose_drivers(drivers) if drivers else None
    attacked_dir = os.path.join(wal_root, f"{scenario.name}-attacked")
    clean_dir = os.path.join(wal_root, f"{scenario.name}-clean")
    os.makedirs(attacked_dir, exist_ok=True)
    os.makedirs(clean_dir, exist_ok=True)
    safety_ok, safety_error = True, None
    report = None
    try:
        report, harness = run_chaos_sim(
            scenario.plan(), scenario.nodes, scenario.duration_s,
            attacked_dir, extra_fault=churn, **kwargs,
        )
    except SafetyViolation as exc:
        safety_ok, safety_error = False, str(exc)
    clean_report, _ = run_chaos_sim(
        scenario.clean_plan(), scenario.nodes, scenario.duration_s,
        clean_dir, extra_fault=churn, **kwargs,
    )
    adversary_nodes = {spec.node for spec in scenario.adversaries}
    honest_nodes = set(range(scenario.nodes)) - adversary_nodes
    clean_leaders = min(
        (len(seq) for a, seq in clean_report.sequences.items()),
        default=0,
    )

    # Honest-AUTHORED committed load on BOTH sides of the ratio: the clean
    # twin's denominator also excludes the (would-be) adversary indices'
    # contributions, so the comparison is like with like — a Byzantine
    # node's own unsequenced transactions are its loss, not the fleet's.
    # Crash-churned nodes are likewise excluded as OBSERVERS (not as
    # authors): a snapshot-rejoiner adopts a baseline and skips settled
    # history BY DESIGN, so its observation window is structurally
    # smaller — its verdict is the explicit catch-up gate below plus the
    # SafetyChecker's adopted-prefix audit, not the throughput min.
    # Churned authorities are excluded the same way: a retired node's
    # committed height freezes at departure and a joiner's observation
    # window starts late — both structural, both gated explicitly below.
    crashed_nodes = (
        {c.node for c in scenario.crashes}
        | set(scenario.absent)
        | {e.authority for e in scenario.churn if e.kind == CHANGE_REMOVE}
    )

    def _honest_min(table: Dict[int, int]) -> int:
        return min(
            (
                table.get(a, 0)
                for a in range(scenario.nodes)
                if a not in adversary_nodes and a not in crashed_nodes
            ),
            default=0,
        )

    clean_tx = _honest_min(clean_report.committed_tx_from(honest_nodes))
    clean_blocks = _honest_min(
        clean_report.committed_blocks_from(honest_nodes)
    )
    verdict: dict = {
        "scenario": scenario.to_dict(),
        "safety_ok": safety_ok,
        "safety_error": safety_error,
        "clean_committed_leaders": clean_leaders,
        "clean_committed_tx": clean_tx,
        "clean_committed_blocks": clean_blocks,
    }
    if report is None:
        verdict.update(
            passed=False, committed_tx=0, committed_blocks=0,
            throughput_ratio=0.0, tx_ratio=0.0,
        )
        return verdict
    honest = {
        a: seq for a, seq in report.sequences.items()
        if a not in adversary_nodes
    }
    committed_leaders = min((len(seq) for seq in honest.values()), default=0)
    committed_tx = _honest_min(report.committed_tx_from(honest_nodes))
    committed = _honest_min(report.committed_blocks_from(honest_nodes))
    # Committed throughput = honest-authored BLOCKS sequenced by the honest
    # prefix: leader-slot skips for silent adversaries cost leader-timeout
    # waits, but honest authorities' blocks still commit under later
    # leaders — exactly what "throughput under attack" should measure.
    # Blocks, not Shares: the sim's TestBlockHandler mints one Share per
    # handle_blocks BATCH, and attacked delivery (relays, fetch) coalesces
    # batches — the Share count under attack under-reports because less
    # load was GENERATED, a test-generator artifact.  The tx ratio rides
    # along as context.
    ratio = committed / clean_blocks if clean_blocks else 0.0
    tx_ratio = committed_tx / clean_tx if clean_tx else 0.0
    detections = _detection_verdicts(scenario, report)
    detections_ok = all(v["ok"] for v in detections.values())
    # Churn gate: every crashed node must have COMMITTED PAST its at-crash
    # height by the end of the run — the explicit rejoin evidence standing
    # in for its excluded observer-min slot (prefix consistency at shared
    # heights is the SafetyChecker's job, including adopted baselines).
    rejoins = [
        {
            "node": event["node"],
            "committed_at_crash": event["committed_height"],
            "committed_final": harness.checker.committed_height(
                event["node"]
            ),
        }
        for event in report.crash_events
    ]
    for rejoin in rejoins:
        rejoin["caught_up"] = (
            rejoin["committed_final"] > rejoin["committed_at_crash"]
        )
    rejoins_ok = all(r["caught_up"] for r in rejoins)
    # Reconfig gate: the honest fleet reached the scheduled epoch (every
    # boundary's height+digest consistency is the SafetyChecker's job —
    # an epoch fork raises, failing safety_ok above), and every joiner
    # actually landed commits on the post-boundary committee.
    reconfig_ok = True
    if scenario.reconfig:
        max_epoch = max(report.epochs.values(), default=0)
        joiner_commits = {
            a: harness.checker.committed_height(a)
            for a in sorted(scenario.absent)
        }
        reconfig_ok = max_epoch >= scenario.min_epoch and all(
            h > 0 for h in joiner_commits.values()
        )
        verdict.update(
            epochs={str(a): e for a, e in sorted(report.epochs.items())},
            epoch_boundaries={
                str(e): b for e, b in sorted(report.epoch_boundaries.items())
            },
            max_epoch=max_epoch,
            min_epoch=scenario.min_epoch,
            joiner_commits={str(a): h for a, h in joiner_commits.items()},
            clean_epochs={
                str(a): e
                for a, e in sorted(clean_report.epochs.items())
            },
            reconfig_ok=reconfig_ok,
        )
    # Execution gate: every steady honest node folded real state (the
    # per-height root agreement itself is the SafetyChecker's job — a
    # state-root fork already failed safety_ok above).  The agreed root
    # chain's digest is the artifact's determinism pin: same-seed runs
    # must reproduce it byte-for-byte.
    execution_ok = True
    if scenario.execution:
        steady = [
            a
            for a in range(scenario.nodes)
            if a not in adversary_nodes and a not in crashed_nodes
        ]
        executed_heights = {
            a: report.executed.get(a, [0, ""])[0] for a in steady
        }
        chain_bytes = json.dumps(
            {str(h): r for h, r in sorted(report.state_root_chain.items())},
            sort_keys=True,
            separators=(",", ":"),
        ).encode()
        execution_ok = bool(report.state_root_chain) and all(
            h > 0 for h in executed_heights.values()
        )
        verdict.update(
            execution={
                "executed_heights": {
                    str(a): h for a, h in sorted(executed_heights.items())
                },
                "chain_length": len(report.state_root_chain),
                "final_root": report.state_root_chain.get(
                    max(report.state_root_chain, default=0), ""
                ),
                "root_chain_digest": _digest(chain_bytes),
                "execution_ok": execution_ok,
            }
        )
    passed = (
        safety_ok
        and detections_ok
        and rejoins_ok
        and reconfig_ok
        and execution_ok
        and ratio >= scenario.min_ratio
        and committed > 0
    )
    verdict.update(
        passed=passed,
        rejoins=rejoins,
        committed_tx=committed_tx,
        committed_blocks=committed,
        committed_leaders=committed_leaders,
        throughput_ratio=round(ratio, 4),
        tx_ratio=round(tx_ratio, 4),
        detections=detections,
        attack_counts=report.attack_counts,
        adversary_divergence=report.adversary_divergence,
        fault_counts=report.fault_counts,
        digests={
            "schedule": report.schedule_digest(),
            "attacks": report.attack_digest(),
            "detections": _digest(report.detections_bytes()),
            "sequences": _digest(_sequence_bytes(report.sequences)),
            "fault_log": _digest(report.fault_log_bytes),
        },
    )
    return verdict


class SimResignOracleVerifier:
    """Exact Ed25519 verification semantics at sim cost: Ed25519 signing is
    deterministic (RFC 8032), and the sim holds every benchmark signer —
    so the correct signature for a digest is *recomputed once per distinct
    block* (memoized fleet-wide) and every node's check is a byte compare.
    A tampered signature (adversary ``invalid_sig``) mismatches exactly as
    under real verification; an equivocating variant, re-signed with the
    real key, matches exactly.  Sim-only by construction (requires the
    private keys); the real-crypto path is :func:`verifier_factory`'s
    kernel kinds (``run_scenario(..., real_crypto=True)``)."""

    def __init__(self, committee) -> None:
        from .block_validator import SignatureVerifier

        # Compose rather than subclass so this module stays import-light.
        self._base = SignatureVerifier()
        signers = Committee.benchmark_signers(len(committee))
        self._signer_by_pk = {
            signer.public_key.bytes: signer for signer in signers
        }
        self._memo: Dict[Tuple[bytes, bytes], bytes] = {}

    def verify_signatures(self, public_keys, digests, signatures):
        out = []
        for pk, digest, sig in zip(public_keys, digests, signatures):
            pk, digest = bytes(pk), bytes(digest)
            expected = self._memo.get((pk, digest))
            if expected is None:
                signer = self._signer_by_pk.get(pk)
                if signer is None:
                    out.append(False)
                    continue
                expected = signer.sign(digest)
                self._memo[(pk, digest)] = expected
            out.append(bytes(sig) == expected)
        return out

    def verify_signatures_async(self, public_keys, digests, signatures):
        from .block_validator import DeferredDispatch

        return DeferredDispatch(
            self.verify_signatures, public_keys, digests, signatures
        )

    def __getattr__(self, name):
        # warmup / resolved_backend / padded_batch: the host-oracle
        # defaults.  (verify_signatures* above never reach here.)
        return getattr(self._base, name)


def oracle_verifier_factory(n: int):
    """A scenario-scoped verifier factory: ONE shared re-sign memo across
    the fleet (the point — each distinct block pays one signing), one
    collector per node."""
    oracle_cell: list = []

    def factory(authority, committee, metrics):
        from .block_validator import BatchedSignatureVerifier

        if not oracle_cell:
            oracle_cell.append(SimResignOracleVerifier(committee))
        return BatchedSignatureVerifier(
            committee, oracle_cell[0], max_delay_s=0.002, metrics=metrics
        )

    return factory


ORACLE_KIND = "sim-oracle"
# validator.ACCELERATOR_KIND / HYBRID_KIND, named here so that this module
# does not import the node assembly.
ACCELERATOR_KIND = "cuda-only"
HYBRID_KIND = "cuda"


def _kind(verifier: Optional[str], real_crypto: bool) -> str:
    """The one verifier kind of a run: ``verifier`` (default the sim
    re-sign oracle), or ``cuda-only`` for the JAX signature's
    ``real_crypto=True``; naming two different kinds raises."""
    if real_crypto and verifier not in (None, ACCELERATOR_KIND):
        raise ValueError(f"real_crypto names {ACCELERATOR_KIND!r}, verifier {verifier!r}")
    return ACCELERATOR_KIND if real_crypto else (verifier or ORACLE_KIND)


def verifier_factory(kind: str, committee, device=None, backend=None):
    """A scenario-scoped verifier factory for a verifier ``kind``.

    ``sim-oracle`` is :func:`oracle_verifier_factory`; ``accept`` verifies
    nothing.  The signature kinds put each node's collector (the oracle
    factory's, same 0.002 s window, so a run verdict for verdict equal to
    the oracle's commits the same sequences) over ONE backend shared by
    the fleet and across restarts: ``cpu`` the CPU oracle (the JAX
    package's real-crypto factory), ``cuda-only`` the port's
    ``TorchSignatureVerifier`` on ``device`` over the committee's key
    table, ``cuda`` that behind the hybrid router; ``-agg`` turns on the
    collector's threshold aggregation.  The backend is made and warmed
    here, before the simulation (``backend`` supplies it instead), so a
    kernel kind without a card raises at once."""
    from .block_validator import (
        AcceptAllBlockVerifier,
        BatchedSignatureVerifier,
        CpuSignatureVerifier,
        HybridSignatureVerifier,
        TorchSignatureVerifier,
    )

    if kind == ORACLE_KIND:
        return oracle_verifier_factory(len(committee))
    if kind == "accept":
        return lambda authority, committee, metrics: AcceptAllBlockVerifier()
    aggregate = kind.endswith("-agg")
    base = kind[: -len("-agg")] if aggregate else kind
    if base not in ("cpu", HYBRID_KIND, ACCELERATOR_KIND):
        raise ValueError(f"unknown verifier kind {kind!r}")
    if backend is None:
        if base == "cpu":
            backend = CpuSignatureVerifier()
        else:
            backend = TorchSignatureVerifier(
                committee_keys=committee.public_key_bytes(), device=device
            )
            if base == HYBRID_KIND:
                backend = HybridSignatureVerifier(tpu=backend)
            backend.warmup()

    def factory(authority, committee, metrics):
        return BatchedSignatureVerifier(
            committee, backend, max_delay_s=0.002, metrics=metrics,
            aggregate=aggregate,
        )

    return factory


# ---------------------------------------------------------------------------
# The matrix


def default_matrix() -> List[Scenario]:
    """The resilience matrix: >= 5 distinct scenarios composing adversary
    mixes with the chaos / storage / health planes.  Durations are sized
    for the slow tier (~2 sim-runs per scenario on the pure-Python
    Ed25519 fallback); the tier-1 acceptance sim is the byzantine-at-f
    entry at a shorter duration (tests/test_adversary.py)."""
    n = 10
    return [
        Scenario(
            name="byzantine-at-f",
            description=(
                "f=3 of 10 authorities concurrently equivocate, withhold "
                "to < quorum, and sign invalidly — the paper's fault "
                "budget, all attack classes live at once"
            ),
            nodes=n,
            duration_s=20.0,
            seed=7,
            leader_timeout_s=0.3,
            adversaries=(
                AdversarySpec(node=7, behavior="equivocate"),
                AdversarySpec(node=8, behavior="withhold"),
                AdversarySpec(node=9, behavior="invalid_sig"),
            ),
        ),
        Scenario(
            name="byzantine-partition",
            description=(
                "equivocator + invalid signer + frame mangler riding a "
                "timed asymmetric partition: active attack during (and "
                "after) a benign network fault"
            ),
            nodes=n,
            duration_s=16.0,
            seed=21,
            adversaries=(
                AdversarySpec(node=8, behavior="equivocate"),
                AdversarySpec(node=9, behavior="invalid_sig"),
                AdversarySpec(
                    node=7, behavior="mangle", params=(("mangle_p", 0.25),)
                ),
            ),
            partitions=(
                PartitionFault(
                    start_s=3.0, end_s=6.0, group_a=(0, 1),
                    group_b=tuple(range(2, n)), symmetric=False,
                ),
            ),
            min_ratio=0.6,
        ),
        Scenario(
            name="churn-snapshot-rejoin",
            description=(
                "a node crashes long enough that its history is GC'd "
                "fleet-wide and rejoins via the snapshot stream WHILE an "
                "equivocator attacks — catch-up under fire"
            ),
            nodes=5,
            duration_s=40.0,
            seed=13,
            adversaries=(AdversarySpec(node=4, behavior="equivocate"),),
            crashes=(CrashFault(node=3, at_s=3.0, downtime_s=22.0),),
            snapshot_catchup=True,
            catchup_threshold_commits=25,
            # During the outage the live committee is EXACTLY quorum (4 of
            # 5, one of them the equivocator), so every cross-half variant
            # relay sits on the round critical path — the scenario's heart
            # is the rejoin gate + safety under attack; the ratio floor
            # accepts the zero-margin phase's round-rate cost.
            min_ratio=0.5,
        ),
        Scenario(
            name="wan-geo-profile",
            description=(
                "three-region WAN latency profile (5-15 ms intra, "
                "80-160 ms inter) with a lagging leader and a withholder "
                "— grey failures at geographic latency"
            ),
            nodes=9,
            duration_s=12.0,
            seed=31,
            leader_timeout_s=2.0,
            regions=(0, 0, 0, 1, 1, 1, 2, 2, 2),
            adversaries=(
                AdversarySpec(
                    node=7, behavior="lag", params=(("lag_s", 1.6),)
                ),
                AdversarySpec(node=8, behavior="withhold"),
            ),
            min_ratio=0.6,
        ),
        Scenario(
            name="mixed-version-skew",
            description=(
                "half the fleet runs every soft wire tag (timestamped "
                "frames, helper streams) the other half predates, under "
                "an invalid signer and link loss — the rolling-upgrade "
                "drill"
            ),
            nodes=n,
            duration_s=12.0,
            seed=42,
            adversaries=(AdversarySpec(node=9, behavior="invalid_sig"),),
            link_faults=(
                LinkFault(drop_p=0.02, start_s=0.0),
            ),
            helper_relays=False,
            new_version_nodes=(0, 2, 4, 6, 8),
            # The clean twin strips the 2% link loss, and the OLD half
            # recovers dropped blocks only via reactive fetch (no helper
            # relays — that is the drill's point), so the floor prices the
            # benign-loss recovery cost; the drill's verdict is interop
            # (soft tags ignored cleanly both ways) + detection + safety.
            min_ratio=0.5,
        ),
    ]


def reconfig_matrix() -> List[Scenario]:
    """The continuous-churn scenario family (epoch reconfiguration plane):
    dynamic membership driven through the committed sequence, in every
    case with the identical churn schedule in the clean twin.  Stable-
    index membership: all ten authorities are registered at genesis; an
    absent joiner starts at stake 0 and a committed ADD activates it."""
    n = 10
    return [
        Scenario(
            name="reconfig-continuous-churn",
            description=(
                "three epoch transitions under attack: a stake reweight, "
                "an ADD that a genesis-absent authority joins through the "
                "snapshot stream (its manifest carries the epoch chain), "
                "and a REMOVE that cleanly retires a live node — all "
                "while an equivocator attacks"
            ),
            nodes=n,
            duration_s=24.0,
            seed=18,
            leader_timeout_s=0.3,
            adversaries=(AdversarySpec(node=7, behavior="equivocate"),),
            snapshot_catchup=True,
            catchup_threshold_commits=25,
            reconfig=True,
            stakes=(1, 1, 1, 1, 1, 1, 1, 1, 1, 0),
            absent=(9,),
            churn=(
                ChurnEvent(
                    at_s=3.0, kind=CHANGE_REWEIGHT, authority=2, stake=3
                ),
                ChurnEvent(
                    at_s=7.0,
                    kind=CHANGE_ADD,
                    authority=9,
                    stake=1,
                    follow_delay_s=3.0,
                ),
                ChurnEvent(at_s=13.0, kind=CHANGE_REMOVE, authority=8),
            ),
            min_epoch=3,
            min_ratio=0.5,
        ),
        Scenario(
            name="reconfig-departing-leader",
            description=(
                "a frequently-elected leader is REMOVEd mid-run and "
                "departs cleanly after the boundary retires its slots, "
                "while a withholder attacks — commit cadence must carry "
                "across the committee switch without a liveness stall"
            ),
            nodes=n,
            duration_s=14.0,
            seed=77,
            leader_timeout_s=0.3,
            adversaries=(AdversarySpec(node=6, behavior="withhold"),),
            reconfig=True,
            churn=(
                ChurnEvent(
                    at_s=5.0,
                    kind=CHANGE_REMOVE,
                    authority=1,
                    follow_delay_s=2.5,
                ),
            ),
            min_epoch=1,
            min_ratio=0.5,
        ),
        Scenario(
            name="reconfig-cross-boundary-rejoin",
            description=(
                "a genesis-absent authority sleeps through TWO boundaries "
                "(a reweight, then a REMOVE) before its own ADD lands; it "
                "then boots from an empty WAL and must land on the "
                "epoch-3 committee via the snapshot epoch chain, under an "
                "invalid-signing adversary"
            ),
            nodes=n,
            duration_s=26.0,
            seed=5,
            leader_timeout_s=0.3,
            adversaries=(AdversarySpec(node=6, behavior="invalid_sig"),),
            snapshot_catchup=True,
            catchup_threshold_commits=25,
            reconfig=True,
            stakes=(1, 1, 1, 1, 1, 1, 1, 1, 1, 0),
            absent=(9,),
            churn=(
                ChurnEvent(
                    at_s=3.0, kind=CHANGE_REWEIGHT, authority=3, stake=2
                ),
                ChurnEvent(at_s=6.0, kind=CHANGE_REMOVE, authority=8),
                ChurnEvent(
                    at_s=11.0,
                    kind=CHANGE_ADD,
                    authority=9,
                    stake=1,
                    follow_delay_s=3.0,
                ),
            ),
            min_epoch=3,
            min_ratio=0.5,
        ),
    ]


def execution_matrix() -> List[Scenario]:
    """The execution-plane scenario family: the deterministic
    account/transfer state machine folding the committed sequence under the
    adversary matrix and under epoch churn.  Every honest node must derive
    the same state-root chain (the SafetyChecker's per-height audit) and
    the verdict pins the chain digest so same-seed runs must reproduce it
    byte-for-byte."""
    n = 10
    return [
        Scenario(
            name="execution-byzantine-at-f",
            description=(
                "the byzantine-at-f adversary mix (equivocate + withhold + "
                "invalid_sig at f=3 of 10) with the execution state "
                "machine live: honest state roots must agree at every "
                "shared height — consensus-level attacks must never "
                "diverge replicated state"
            ),
            nodes=n,
            duration_s=16.0,
            seed=7,
            leader_timeout_s=0.3,
            adversaries=(
                AdversarySpec(node=7, behavior="equivocate"),
                AdversarySpec(node=8, behavior="withhold"),
                AdversarySpec(node=9, behavior="invalid_sig"),
            ),
            execution=True,
            min_ratio=0.5,
        ),
        Scenario(
            name="execution-epoch-churn",
            description=(
                "execution workload across two epoch transitions (a stake "
                "reweight and a clean REMOVE) under an equivocator: the "
                "state-root chain must carry across committee switches "
                "unbroken"
            ),
            nodes=n,
            duration_s=18.0,
            seed=18,
            leader_timeout_s=0.3,
            adversaries=(AdversarySpec(node=7, behavior="equivocate"),),
            reconfig=True,
            execution=True,
            churn=(
                ChurnEvent(
                    at_s=4.0, kind=CHANGE_REWEIGHT, authority=2, stake=3
                ),
                ChurnEvent(
                    at_s=9.0,
                    kind=CHANGE_REMOVE,
                    authority=8,
                    follow_delay_s=2.5,
                ),
            ),
            min_epoch=2,
            min_ratio=0.5,
        ),
    ]


def scenario_by_name(name: str) -> Scenario:
    matrix = default_matrix() + reconfig_matrix() + execution_matrix()
    for scenario in matrix:
        if scenario.name == name:
            return scenario
    raise KeyError(
        f"unknown scenario {name!r} "
        f"(known: {', '.join(s.name for s in matrix)})"
    )


def run_reconfig_matrix(
    scenarios: Optional[List[Scenario]] = None,
    wal_root: Optional[str] = None,
    real_crypto: bool = False,
    device=None,
    verifier: Optional[str] = None,
) -> dict:
    """Run the continuous-churn family and aggregate the RECONFIG artifact
    document (the JAX package's ``RECONFIG_rNN.json`` shape; the verifier
    as :func:`run_scenario` takes it)."""
    doc = run_matrix(
        scenarios if scenarios is not None else reconfig_matrix(),
        wal_root=wal_root,
        real_crypto=real_crypto,
        device=device,
        verifier=verifier,
    )
    doc["kind"] = "mysticeti-reconfig-matrix"
    doc["metric"] = "reconfig"
    return doc


def _matrix_label(kind: str) -> str:
    """The matrix document's verifier field: the JAX package's two labels,
    or the kind's name for the other kinds."""
    if kind == ORACLE_KIND:
        return "sim-resign-oracle"
    return "real-crypto" if kind == ACCELERATOR_KIND else kind


def run_matrix(
    scenarios: Optional[List[Scenario]] = None,
    wal_root: Optional[str] = None,
    real_crypto: bool = False,
    device=None,
    verifier: Optional[str] = None,
) -> dict:
    """Run the matrix and aggregate the artifact document (``real_crypto``,
    ``device`` and ``verifier`` as :func:`run_scenario` takes them)."""
    import tempfile

    kind = _kind(verifier, real_crypto)

    scenarios = scenarios if scenarios is not None else default_matrix()
    own_root = wal_root is None
    wal_root = wal_root or tempfile.mkdtemp(prefix="scenario-matrix-")
    results = []
    for scenario in scenarios:
        log.info("scenario %s: running", scenario.name)
        verdict = run_scenario(
            scenario, wal_root, device=device, verifier=kind
        )
        log.info(
            "scenario %s: %s (ratio %.2f)", scenario.name,
            "PASS" if verdict["passed"] else "FAIL",
            verdict.get("throughput_ratio", 0.0),
        )
        results.append(verdict)
    if own_root:
        import shutil

        shutil.rmtree(wal_root, ignore_errors=True)
    return {
        "kind": "mysticeti-scenario-matrix",
        "metric": "scenario_matrix",
        "verifier": _matrix_label(kind),
        "scenarios": results,
        "passed": sum(1 for r in results if r["passed"]),
        "failed": sum(1 for r in results if not r["passed"]),
        "all_pass": all(r["passed"] for r in results),
    }
