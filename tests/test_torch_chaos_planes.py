"""The port's chaos harness under the other planes: counterparts of the
reference's chaos tests of the reconfiguration plane
(``tests/test_reconfig.py``: churn across two boundaries, a snapshot rejoin
across an epoch boundary, a crash-restart re-deriving its epoch), of the
health plane (``tests/test_health.py``: SLO alerts naming a partitioned
and a crashed authority) and of the flight recorder
(``tests/test_fleet_trace.py``: a safety failure dumps every live node, and
same-seed dumps are byte-identical), all run on the port.
"""
import asyncio
import json

import pytest

from mysticeti_tpu_torch.chaos import CrashFault, FaultPlan, run_chaos_sim
from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.config import Parameters, StorageParameters
from mysticeti_tpu_torch.health import SLOThresholds
from mysticeti_tpu_torch.reconfig import (
    CHANGE_ADD,
    CHANGE_REMOVE,
    CHANGE_REWEIGHT,
    CommitteeChange,
)


# ---------------------------------------------------------------------------
# Epoch reconfiguration under the chaos harness (tests/test_reconfig.py)


def _sim_parameters(snapshot_catchup=False, threshold=10):
    storage = (
        StorageParameters(
            segment_bytes=16 * 1024,
            checkpoint_interval=5,
            gc_depth=30,
            snapshot_catchup=True,
            catchup_threshold_commits=threshold,
        )
        if snapshot_catchup
        else StorageParameters()
    )
    return Parameters(
        leader_timeout_s=0.3,
        reconfig=True,
        leader_liveness_horizon_rounds=4,
        storage=storage,
    )


def _driver(events):
    """events: [(at_s, coroutine-factory(harness))] in virtual time."""

    async def run(harness):
        now = 0.0
        for at_s, action in events:
            if at_s > now:
                await asyncio.sleep(at_s - now)
                now = at_s
            await action(harness)

    return run


def _submit(change):
    async def action(harness):
        harness.submit_change(0, change)

    return action


@pytest.mark.chaos
@pytest.mark.reconfig
def test_churn_two_transitions_byte_identical_same_seed(tmp_path):
    """Reweight + remove under load: every live node reaches epoch 2, the
    retired authority stops cleanly, boundary (height, digest) agree
    fleet-wide (the checker's cross-epoch audit), and a same-seed replay is
    byte-identical through both transitions."""
    n = 6
    plan = FaultPlan(seed=18)
    events = [
        (2.0, _submit(CommitteeChange(CHANGE_REWEIGHT, 1, 3))),
        (5.0, _submit(CommitteeChange(CHANGE_REMOVE, 4))),
        (7.0, lambda harness: harness.retire(4)),
    ]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    report, harness = run_chaos_sim(
        plan, n, 10.0, str(tmp_path / "a"),
        parameters=_sim_parameters(),
        committee=Committee.new_for_benchmarks(n),
        extra_fault=_driver(events),
    )
    replay, _ = run_chaos_sim(
        plan, n, 10.0, str(tmp_path / "b"),
        parameters=_sim_parameters(),
        committee=Committee.new_for_benchmarks(n),
        extra_fault=_driver(events),
    )

    live = [a for a in range(n) if a != 4]
    assert all(report.epochs.get(a) == 2 for a in live), report.epochs
    # The departing authority saw at least the boundary that removed it.
    assert report.epochs.get(4, 0) >= 1
    assert set(report.epoch_boundaries) == {1, 2}
    # Everyone kept committing after the second boundary.
    assert all(len(report.sequences[a]) > 0 for a in live)

    # Byte-identical same-seed replay, across both epoch boundaries.
    assert report.sequences == replay.sequences
    assert report.epochs == replay.epochs
    assert report.epoch_boundaries == replay.epoch_boundaries
    assert report.fault_log_bytes == replay.fault_log_bytes


@pytest.mark.chaos
@pytest.mark.reconfig
def test_snapshot_rejoin_across_epoch_boundary(tmp_path):
    """A registered-at-zero-stake authority sleeps through its own ADD
    boundary, then boots from an empty WAL: it must adopt a snapshot whose
    epoch chain carries the boundary, land on the current committee, and
    commit a sequence that is exactly a window of the fleet's."""
    n = 6
    plan = FaultPlan(seed=7)
    events = [
        (3.0, _submit(CommitteeChange(CHANGE_ADD, 5, 1))),
        (7.0, lambda harness: harness.join(5)),
    ]
    report, harness = run_chaos_sim(
        plan, n, 14.0, str(tmp_path),
        parameters=_sim_parameters(snapshot_catchup=True),
        committee=Committee.new_for_benchmarks(n, stakes=[1, 1, 1, 1, 1, 0]),
        extra_fault=_driver(events),
        absent={5},
    )

    assert all(report.epochs.get(a) == 1 for a in range(n)), report.epochs
    joiner = report.sequences[5]
    assert joiner, "joiner never committed"
    height = harness.checker.committed_height(5)
    # Prefix consistency across the adopted baseline: the joiner's observed
    # window is exactly the fleet's sequence ending at its height.
    reference_node = max(range(5), key=harness.checker.committed_height)
    assert harness.checker.committed_height(reference_node) >= height
    reference = report.sequences[reference_node]
    assert joiner == reference[height - len(joiner):height]
    # Far behind at join time, the window is a strict suffix: the commits
    # below the adopted baseline were never replayed block-by-block.
    assert len(joiner) < height


@pytest.mark.chaos
@pytest.mark.reconfig
def test_crash_restart_rederives_epoch_from_wal(tmp_path):
    """Crash a node after a boundary commit lands in its WAL but (with the
    checkpoint cadence at 5 commits) possibly before any checkpoint covers
    it: the restart must re-derive the same epoch from replayed commits and
    rejoin the post-boundary committee."""
    n = 6
    plan = FaultPlan(seed=23, crashes=[CrashFault(node=3, at_s=4.0, downtime_s=3.0)])
    events = [(2.0, _submit(CommitteeChange(CHANGE_REWEIGHT, 1, 3)))]
    report, harness = run_chaos_sim(
        plan, n, 11.0, str(tmp_path),
        parameters=_sim_parameters(),
        committee=Committee.new_for_benchmarks(n),
        extra_fault=_driver(events),
    )

    # Every node — including the restarted one — derived the boundary, and
    # the checker's cross-epoch audit (inside run_chaos_sim) saw identical
    # (height, digest) for it everywhere.
    assert all(report.epochs.get(a) == 1 for a in range(n)), report.epochs
    assert set(report.epoch_boundaries) == {1}
    # The restarted node kept committing after recovery.
    crashed_seq = report.sequences[3]
    longest = max(report.sequences.values(), key=len)
    assert crashed_seq == longest[: len(crashed_seq)]
    assert len(crashed_seq) > 0


# ---------------------------------------------------------------------------
# The health plane's chaos acceptance path (tests/test_health.py)


def _chaos_scenario(tmp_dir):
    from mysticeti_tpu_torch.chaos import (
        CrashFault,
        FaultPlan,
        PartitionFault,
        run_chaos_sim,
    )

    plan = FaultPlan(
        seed=7,
        partitions=[
            PartitionFault(
                start_s=4.0, end_s=14.0, group_a=(2,),
                group_b=(0, 1, 3, 4, 5, 6), symmetric=True,
            )
        ],
        crashes=[CrashFault(node=5, at_s=6.0, downtime_s=6.0)],
    )
    slo = SLOThresholds(
        max_round_stall_s=5.0, max_commit_stall_s=6.0,
        max_authority_lag_rounds=8,
    )
    return run_chaos_sim(plan, 7, 20.0, tmp_dir, slo=slo, with_metrics=True)


def test_chaos_sim_alerts_name_stalled_authority_and_stage(tmp_path):
    """The acceptance scenario: a seeded blackhole partition of authority 2
    plus a crash-restart of authority 5.  The SLO watchdog must NAME both —
    every healthy observer raises authority-lag alerts against 2 (stage
    receive) during the partition and against 5 during its downtime — and
    the health timeline must be byte-identical across two same-seed runs."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    report, harness = _chaos_scenario(str(tmp_path / "a"))

    assert report.health_timeline, "health plane produced no samples"
    lag_alerts = [
        a for a in report.slo_alerts if a["kind"] == "authority-lag"
    ]
    named = {a["authority"] for a in lag_alerts}
    assert 2 in named, report.slo_alerts  # the partitioned authority
    assert 5 in named, report.slo_alerts  # the crashed authority
    assert all(a["stage"] == "receive" for a in lag_alerts)
    # The partitioned node saw its OWN pipeline stall too (round + commit).
    own = {
        (a["kind"], a["observer"])
        for a in report.slo_alerts
        if a["authority"] is None
    }
    assert ("round-stall", 2) in own
    assert ("commit-stall", 2) in own
    # Observers are the healthy nodes; the victim never indicts itself as a
    # peer-lag straggler.
    assert all(
        a["observer"] != a["authority"] for a in lag_alerts
    )
    # Down node recorded as down in the timeline during its outage.
    mid = [
        e for e in report.health_timeline if 7.0 <= e["t"] <= 11.0
    ]
    assert mid and all(e["nodes"]["5"].get("down") for e in mid)
    # Alerts are counted on the per-node metrics too.
    text = harness.metrics[0].expose().decode()
    assert 'mysticeti_health_slo_alerts_total{authority="2"' in text

    # Determinism: same plan, same seed -> byte-identical timeline + alerts.
    report_b, _ = _chaos_scenario(str(tmp_path / "b"))
    assert report.health_timeline_bytes == report_b.health_timeline_bytes
    assert report.slo_alerts == report_b.slo_alerts


# ---------------------------------------------------------------------------
# The flight recorder under chaos (tests/test_fleet_trace.py)


@pytest.mark.tracing
def test_chaos_safety_failure_dumps_every_live_node(tmp_path):
    """The moment the SafetyChecker fails, run_chaos_sim writes a valid
    flight-recorder dump for every live node before re-raising."""
    from mysticeti_tpu_torch.chaos import FaultPlan, SafetyViolation, run_chaos_sim
    from mysticeti_tpu_torch.types import BlockReference

    async def poison(harness):
        await asyncio.sleep(2.0)
        fake = BlockReference(9, 99, b"\xff" * 32)
        # A forged anchor at height 1 for authority 0: global prefix
        # consistency must fail at the end-of-run audit.
        harness.checker._anchors.setdefault(0, {})[1] = fake

    with pytest.raises(SafetyViolation):
        run_chaos_sim(
            FaultPlan(seed=5), 4, 6.0, str(tmp_path), extra_fault=poison
        )
    for a in range(4):
        path = tmp_path / f"flight-recorder-{a}.json"
        assert path.exists(), f"no dump for live node {a}"
        doc = json.loads(path.read_text())
        assert doc["authority"] == a
        assert any(e["kind"] == "commit" for e in doc["events"])


@pytest.mark.tracing
def test_chaos_recorder_dumps_byte_identical_same_seed(tmp_path):
    from mysticeti_tpu_torch.chaos import CrashFault, FaultPlan, run_chaos_sim

    plan = FaultPlan(
        seed=11, crashes=[CrashFault(node=2, at_s=3.0, downtime_s=1.5)]
    )
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    report_a, _ = run_chaos_sim(plan, 4, 8.0, str(tmp_path / "a"))
    report_b, _ = run_chaos_sim(plan, 4, 8.0, str(tmp_path / "b"))
    assert report_a.recorder_dumps == report_b.recorder_dumps
    assert set(report_a.recorder_dumps) == {0, 1, 2, 3}
    crashed = json.loads(report_a.recorder_dumps[2])
    kinds = [e["kind"] for e in crashed["events"]]
    assert "crash" in kinds and "restart" in kinds
