"""The port's execution plane under the chaos harness and the sanitizer:
counterparts of ``tests/test_execution.py``'s seeded multi-node sims (the
adversary mix never diverges honest roots, same-seed runs are
byte-identical, crash-restart re-derives the same chain, a snapshot
rejoiner lands on the fleet root) and its detsan test (a planted
wall-clock leak in the fold is bisected), run on the port.
"""
import asyncio
import dataclasses
import time

import pytest

from mysticeti_tpu_torch.config import Parameters, StorageParameters
from mysticeti_tpu_torch.execution import OP_CREATE, OP_TRANSFER, ExecTx, ExecutionState
from mysticeti_tpu_torch.types import Share

pytestmark = pytest.mark.execution


def _block(*txs):
    class _Block:
        def __init__(self, statements):
            self.statements = statements

    return _Block([Share(tx.to_bytes()) for tx in txs])


def _fold(state, height, *txs):
    return state.observe_commit(height, [_block(*txs)])


# -- seeded multi-node sims ---------------------------------------------------


def _exec_scenario(**overrides):
    from mysticeti_tpu_torch.scenarios import scenario_by_name

    return dataclasses.replace(
        scenario_by_name("execution-byzantine-at-f"), **overrides
    )


@pytest.mark.chaos
def test_execution_under_byzantine_at_f_roots_agree(tmp_path):
    """The 10-node acceptance sim: equivocate + withhold + invalid_sig at
    f=3 with the execution workload live.  Every honest node folds real
    state and the SafetyChecker's per-height state-root audit holds — a
    fork would have raised, failing the verdict's safety gate."""
    from mysticeti_tpu_torch.scenarios import run_scenario

    verdict = run_scenario(_exec_scenario(duration_s=5.0), str(tmp_path))
    assert verdict["safety_ok"], verdict.get("safety_error")
    assert verdict["passed"], verdict
    execution = verdict["execution"]
    assert execution["execution_ok"]
    assert execution["chain_length"] > 0
    heights = execution["executed_heights"]
    assert len(heights) == 7  # the honest, non-crashed cohort
    assert all(h > 0 for h in heights.values())
    # Every honest node executed up to (near) the shared frontier.
    assert max(heights.values()) - min(heights.values()) <= 2


@pytest.mark.chaos
def test_execution_sim_byte_identical_across_same_seed_runs(tmp_path):
    """Same seed, same scenario: the agreed state-root CHAIN (height ->
    root, every honest node) reproduces byte-for-byte, pinned by the
    verdict's chain digest — execution is a pure function of the seed."""
    from mysticeti_tpu_torch.chaos import run_chaos_sim
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.scenarios import (
        _exec_driver,
        oracle_verifier_factory,
    )

    scenario = _exec_scenario(
        nodes=5, duration_s=3.5, adversaries=(), min_ratio=0.0
    )

    def once(tag):
        # Honest plan: the oracle verifier needs per-index keys, which the
        # adversary path would have defaulted for us (run_chaos_sim).
        report, harness = run_chaos_sim(
            scenario.plan(),
            scenario.nodes,
            scenario.duration_s,
            str(tmp_path / tag),
            parameters=scenario.base_parameters(),
            latency_ranges=scenario.latency_ranges(),
            committee=Committee.new_for_benchmarks(scenario.nodes),
            with_metrics=True,
            verifier_factory=oracle_verifier_factory(scenario.nodes),
            extra_fault=_exec_driver(scenario),
        )
        return report, harness

    first, harness_a = once("a")
    second, harness_b = once("b")
    assert first.state_root_chain  # real state was folded
    assert first.state_root_chain == second.state_root_chain
    assert first.executed == second.executed
    assert first.sequences == second.sequences
    # The harness-level account tables agree node-for-node too.
    for a in range(scenario.nodes):
        exec_a = harness_a.nodes[a].core.execution
        exec_b = harness_b.nodes[a].core.execution
        assert exec_a.to_bytes() == exec_b.to_bytes()


@pytest.mark.chaos
def test_execution_crash_restart_rederives_identical_roots(tmp_path):
    """A node crashing mid-chain recovers its execution state from the
    checkpoint + WAL tail and re-derives the SAME roots: the checker's
    self-conflict arm (note_state_root on rebuild) would raise if the
    recovered chain disagreed with what the node reported pre-crash."""
    from mysticeti_tpu_torch.chaos import CrashFault, FaultPlan, run_chaos_sim
    from mysticeti_tpu_torch.scenarios import Scenario, _exec_driver

    scenario = Scenario(
        name="exec-crash",
        description="crash-restart execution recovery",
        nodes=4,
        duration_s=14.0,
        seed=23,
        execution=True,
    )
    plan = FaultPlan(
        seed=23, crashes=[CrashFault(node=1, at_s=5.0, downtime_s=2.0)]
    )
    params = Parameters(
        leader_timeout_s=1.0,
        execution=True,
        storage=StorageParameters(
            segment_bytes=16 * 1024, checkpoint_interval=5, gc_depth=20
        ),
    )
    report, harness = run_chaos_sim(
        plan,
        4,
        scenario.duration_s,
        str(tmp_path),
        parameters=params,
        with_metrics=True,
        extra_fault=_exec_driver(scenario),
    )
    crashed_at = report.crash_events[0]["committed_height"]
    assert harness.metrics[1].crash_recovery_total._value.get() == 1.0
    # The restarted node kept executing past its crash point...
    restarted = harness.nodes[1].core.execution
    assert restarted.last_height > crashed_at
    # ...and at every height the checker saw from BOTH node 1 and node 0,
    # the roots agree (the per-height audit in check() already enforced
    # this across the whole fleet without raising).
    shared = 0
    for height in report.state_root_chain:
        mine = harness.checker.state_root_at(1, height)
        theirs = harness.checker.state_root_at(0, height)
        if mine is not None and theirs is not None:
            assert mine == theirs
            shared += 1
    assert shared > 0


@pytest.mark.chaos
@pytest.mark.storage
def test_execution_snapshot_rejoiner_lands_on_fleet_root(tmp_path):
    """A rejoiner whose history was GC'd fleet-wide adopts the execution
    state off the snapshot manifest and lands on the fleet's exact root —
    then keeps folding live commits onto the same chain."""
    from mysticeti_tpu_torch.chaos import CrashFault, FaultPlan, run_chaos_sim
    from mysticeti_tpu_torch.scenarios import Scenario, _exec_driver

    scenario = Scenario(
        name="exec-snapshot",
        description="snapshot rejoiner execution adoption",
        nodes=4,
        duration_s=45.0,
        seed=13,
        execution=True,
    )
    params = Parameters(
        leader_timeout_s=1.0,
        execution=True,
        storage=StorageParameters(
            segment_bytes=16 * 1024,
            checkpoint_interval=5,
            gc_depth=20,
            snapshot_catchup=True,
            catchup_threshold_commits=50,
        ),
    )
    plan = FaultPlan(
        seed=13, crashes=[CrashFault(node=3, at_s=3.0, downtime_s=30.0)]
    )
    report, harness = run_chaos_sim(
        plan,
        4,
        scenario.duration_s,
        str(tmp_path),
        parameters=params,
        with_metrics=True,
        extra_fault=_exec_driver(scenario),
    )
    node3 = harness.nodes[3]
    assert node3.core.storage.snapshots_adopted == 1
    rejoined = node3.core.execution
    crashed_at = report.crash_events[0]["committed_height"]
    # It genuinely skipped history (adopted a baseline past the crash)
    # and kept executing on the fleet chain.
    assert rejoined.last_height > crashed_at
    for height in report.state_root_chain:
        mine = harness.checker.state_root_at(3, height)
        theirs = harness.checker.state_root_at(0, height)
        if mine is not None and theirs is not None:
            assert mine == theirs
    # The rejoiner's post-adoption roots entered the agreed chain.
    assert harness.checker.executed_height(3) > crashed_at


# -- planted nondeterminism: the sanitizer must bite --------------------------


def test_detsan_run_twice_catches_wallclock_leak_in_exec_fold():
    """The dynamic twin: an execution fold whose pacing leaks wall clock
    diverges between same-seed runs and the detsan bisector names the
    first diverging event; the deterministic twin is event-identical."""
    from mysticeti_tpu_torch.detsan import run_twice

    def fold_main(leaky):
        async def main():
            state = ExecutionState()
            _fold(state, 1, ExecTx(OP_CREATE, b"a", amount=1000))
            for height in range(2, 10):
                if leaky:
                    jitter = (time.perf_counter_ns() % 997) / 1e5
                else:
                    jitter = 0.0
                await asyncio.sleep(0.01 + jitter)
                _fold(
                    state,
                    height,
                    ExecTx(
                        OP_TRANSFER,
                        b"a",
                        nonce=height - 1,
                        amount=1,
                        dest=b"sink",
                    ),
                )
            return state.root

        return main()

    clean = run_twice(lambda: fold_main(False), seed=7)
    assert clean.identical, clean.to_dict()
    leaky = run_twice(lambda: fold_main(True), seed=7)
    assert not leaky.identical
    assert leaky.first_divergence is not None
