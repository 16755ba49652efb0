"""The port's seeded overload simulation against the JAX package's:
counterparts of ``tests/test_ingress.py``'s two overload sims (graceful
degradation at 3x offered load, full shed accounting, fairness, a
byte-identical shed schedule) run on the port, then the report and the
``overload`` subcommand's output held to the JAX package's.
"""
import dataclasses

import pytest

from mysticeti_tpu_torch.ingress import (
    SHED_DUPLICATE,
    OverloadScenario,
    run_overload_sim,
)

pytestmark = pytest.mark.ingress


def _scenario(mult, seed=11, **over):
    defaults = dict(
        seed=seed,
        nodes=10,
        duration_s=10.0,
        base_tps=300,
        max_per_proposal=30,
        mempool_max_transactions=600,
        multiplier_schedule=[(0.0, mult)],
        clients_per_node=3,
        duplicate_flood=True,
    )
    defaults.update(over)
    return OverloadScenario(**defaults)


@pytest.mark.slow
def test_overload_sim_ten_nodes_graceful_degradation():
    """The full acceptance scenario at 10 nodes (slow tier twin of the
    8-node tier-1 run below — same assertions, bigger committee)."""
    _assert_overload(nodes=10)


def test_overload_sim_graceful_degradation_tier1():
    _assert_overload(nodes=10, duration_s=8.0)


def _assert_overload(**over):
    r1 = run_overload_sim(_scenario(1.0, **over))
    r3 = run_overload_sim(_scenario(3.0, **over))
    r3b = run_overload_sim(_scenario(3.0, **over))

    # Graceful degradation: committed throughput at 3x offered stays within
    # the stated band of the 1x run (>= 80%) — no collapse past saturation.
    assert r3.committed_tx >= 0.8 * r1.committed_tx, (
        r1.committed_tx,
        r3.committed_tx,
    )
    # Overload actually happened and every rejection is accounted for.
    assert r3.shed_by_reason, "3x offered load must shed"
    assert r3.shed_mode_entered
    assert r3.offered_tx > r3.admitted_tx
    assert sum(r3.shed_by_reason.values()) + r3.admitted_tx == r3.offered_tx
    # Dedup under duplicate flood.
    assert r3.shed_by_reason.get(SHED_DUPLICATE, 0) > 0
    # Fairness: no client lane starved on the overloaded node.
    drained = {
        lane: s["drained"]
        for lane, s in r3.lane_stats.items()
        if lane.startswith("client-")
    }
    assert len(drained) == 3
    assert min(drained.values()) > 0
    assert min(drained.values()) >= 0.5 * max(drained.values()), drained
    # Seeded determinism: the shed schedule is byte-identical across
    # same-seed runs, and so is everything downstream of it.
    assert r3.shed_log_bytes == r3b.shed_log_bytes
    assert r3.shed_schedule_digest == r3b.shed_schedule_digest
    assert r3.committed_tx == r3b.committed_tx
    assert r3.commit_heights == r3b.commit_heights
    # Commit safety survived overload on every node (prefix consistency is
    # audited inside run_overload_sim by the chaos SafetyChecker).
    assert all(h > 0 for h in r3.commit_heights.values())


def test_overload_report_equals_the_jax_packages():
    """One seeded 3x overload run on each package (closed-loop clients, a
    duplicate flood, a multiplier ramp): every field of the report is
    equal, the shed log's bytes and the finality percentiles included."""
    from mysticeti_tpu import ingress as J

    over = dict(nodes=6, duration_s=5.0, closed_loop=True,
                multiplier_schedule=[(0.0, 1.0), (2.0, 3.0)])
    port = run_overload_sim(_scenario(3.0, seed=5, **over))
    jax = J.run_overload_sim(J.OverloadScenario(**dataclasses.asdict(
        _scenario(3.0, seed=5, **over))))
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert port.shed_by_reason and port.committed_tx > 0


def test_overload_cli_output_equals_the_jax_clis(tmp_path, capsys):
    import json

    from mysticeti_tpu.cli import main as jax_main
    from mysticeti_tpu_torch.cli import main

    args = ["overload", "--nodes", "4", "--duration", "4", "--seed", "3",
            "--schedule", "0:1,2:3", "--closed-loop"]
    assert jax_main(args + ["--report-out", str(tmp_path / "jax.json")]) == 0
    want = capsys.readouterr().out
    assert main(args + ["--report-out", str(tmp_path / "port.json")]) == 0
    got = capsys.readouterr().out
    assert got.replace("port.json", "jax.json") == want
    assert "shed schedule digest:" in got
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
