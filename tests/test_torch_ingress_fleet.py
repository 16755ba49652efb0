"""The ingress slice end to end: the port's fleet against the JAX package's.

A 4-validator fleet over each package's ``SimulatedNetwork``, every node
wired as the JAX package's ``Validator`` wires its ingress plane (an
``IngressPlane`` behind a ``BenchmarkFastPathBlockHandler`` and the commit
observer, attached to the core, the ``NetworkSyncer`` and a batching
collector over the CPU oracle, a synchronous WAL) and driven by one
closed-loop ``TransactionGenerator`` a node under a 1x -> 3x schedule, is
built from each package by the same code below: committed sequences, shed
schedules and their digests, generator stats and the finality percentiles
must be equal.  Also: the collector's ``health_state`` equals the JAX
package's, and ``chip_smoke``'s ingress phase runs at n = 4 on the ``cpu``
kind and holds its checks across two runs of one seed.
"""
import asyncio
import importlib
import os

import pytest

import chip_smoke

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")
N = 4

pytestmark = pytest.mark.ingress


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _collector(pkg, committee):
    bv = _mod(pkg, "block_validator")
    return bv.BatchedSignatureVerifier(committee, bv.CpuSignatureVerifier(), max_delay_s=0.005)


class _SimNodeNetwork:
    def __init__(self, queue):
        self.connections = queue

    async def stop(self):
        pass


def _scenario(pkg):
    return _mod(pkg, "ingress").OverloadScenario(
        seed=3, nodes=N, duration_s=5.0, base_tps=300,
        multiplier_schedule=[(0.0, 1.0), (2.5, 3.0)], closed_loop=True, transaction_size=512,
        max_per_proposal=30, mempool_max_transactions=400, leader_timeout_s=1.0)


async def _fleet(pkg, wal_dir):
    """Run the 4-node fleet for the scenario's duration; return its
    readings."""
    committee = _mod(pkg, "committee").Committee.new_for_benchmarks(N)
    signers = _mod(pkg, "committee").Committee.benchmark_signers(N)
    scenario = _scenario(pkg)
    params = scenario.ingress_parameters()
    parameters = _mod(pkg, "config").Parameters(leader_timeout_s=scenario.leader_timeout_s)
    sim_net = _mod(pkg, "simulated_network").SimulatedNetwork(N)
    nodes, planes, generators = [], [], []
    for a in range(N):
        metrics = _mod(pkg, "metrics").Metrics()
        writer, reader = _mod(pkg, "wal").walf(os.path.join(wal_dir, f"{pkg}-wal-{a}"),
                                               async_writes=False)
        recovered, observer_recovered = _mod(pkg, "block_store").BlockStore.open(
            a, reader, writer, committee, metrics=metrics)
        plane = _mod(pkg, "ingress").IngressPlane(params, authority=a, metrics=metrics)
        handler = _mod(pkg, "block_handler").BenchmarkFastPathBlockHandler(
            committee, a, metrics=metrics, ingress=plane)
        core_mod = _mod(pkg, "core")
        core = core_mod.Core(
            block_handler=handler, authority=a, committee=committee, parameters=parameters,
            recovered=recovered, wal_writer=writer, options=core_mod.CoreOptions.test(),
            signer=signers[a], metrics=metrics)
        observer = _mod(pkg, "commit_observer").TestCommitObserver(
            core.block_store, committee, transaction_time=handler.transaction_time,
            metrics=metrics, recovered_state=observer_recovered)
        collector = _collector(pkg, committee)
        node = _mod(pkg, "net_sync").NetworkSyncer(
            core, observer, _SimNodeNetwork(sim_net.node_connections[a]), parameters=parameters,
            block_verifier=collector, metrics=metrics)
        observer.ingress = plane
        plane.attach(core=core, net_syncer=node, block_verifier=collector)
        generator = _mod(pkg, "transactions_generator").TransactionGenerator(
            submit=handler.submit, seed=scenario.seed * 1000 + a * 16, tps=scenario.base_tps,
            transaction_size=scenario.transaction_size,
            overload_schedule=list(scenario.multiplier_schedule), closed_loop=True,
            finality_sample_every=params.finality_sample_every, metrics=metrics)
        plane.add_commit_sink(
            lambda height, keys, info, g=generator: g.note_commit_notification(keys, info))
        nodes.append(node)
        planes.append(plane)
        generators.append(generator)
    for node in nodes:
        await node.start()
    await sim_net.connect_all()
    for plane in planes:
        plane.start()
    for generator in generators:
        generator.start()
    await asyncio.sleep(scenario.duration_s)
    for generator in generators:
        generator.stop()
    for plane in planes:
        plane.stop()
    signals = [sorted(plane._signals()) for plane in planes]
    for node in nodes:
        await node.stop()
        node.core.wal_writer.close()
        node.core.block_store.close()
    sim_net.close()
    merged = _mod(pkg, "ingress")._merged_finality
    return {
        "sequences": [[(r.authority, r.round, r.digest)
                       for r in node.syncer.commit_observer.committed_leaders] for node in nodes],
        "shed_logs": [plane.shed_log_bytes() for plane in planes],
        "digests": [plane.shed_schedule_digest() for plane in planes],
        "health": [plane.health_state() for plane in planes],
        "lanes": [plane.mempool.lane_stats() for plane in planes],
        "generators": [generator.stats() for generator in generators],
        "server_finality": merged([plane.finality for plane in planes]),
        "client_finality": merged([generator.finality for generator in generators]),
        "signals": signals,
    }


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    wal_dir = str(tmp_path_factory.mktemp("ingress-fleet"))
    return {pkg: _mod(pkg, "runtime.simulated").run_simulation(_fleet(pkg, wal_dir), seed=3)
            for pkg in PACKAGES}


def test_fleet_commits_the_jax_packages_sequences(fleets):
    port, jax = fleets["mysticeti_tpu_torch"], fleets["mysticeti_tpu"]
    assert port["sequences"] == jax["sequences"]
    assert min(len(seq) for seq in port["sequences"]) >= 10


def test_fleet_sheds_on_the_jax_packages_schedule(fleets):
    """Overload shed (the 3x step is above what 30 transactions a block
    lets through) and every node's shed log, digest, lanes and health
    state, and the collector's occupancy signal, equal the JAX package's."""
    port, jax = fleets["mysticeti_tpu_torch"], fleets["mysticeti_tpu"]
    for key in ("shed_logs", "digests", "health", "lanes", "generators", "signals"):
        assert port[key] == jax[key], key
    assert any(h["shed_by_reason"] for h in port["health"])
    assert all("verify_occupancy" in signals for signals in port["signals"])


def test_fleet_finality_equals_the_jax_packages(fleets):
    port, jax = fleets["mysticeti_tpu_torch"], fleets["mysticeti_tpu"]
    assert port["server_finality"] == jax["server_finality"]
    assert port["client_finality"] == jax["client_finality"]
    assert port["server_finality"]["completed"] == port["client_finality"]["completed"] > 0


def _depth_rule(pipeline_class, fixed_cost_s: float) -> int:
    """The adaptive pipeline depth ``VerifyPipeline.depth()`` gives for a
    measured fixed dispatch cost: 2 below 5 ms, 3 below 50 ms, else 4."""
    if fixed_cost_s >= pipeline_class.DEEP_FIXED_COST_S:
        return pipeline_class.MAX_DEPTH
    if fixed_cost_s >= pipeline_class.MID_FIXED_COST_S:
        return (pipeline_class.MIN_DEPTH + pipeline_class.MAX_DEPTH) // 2
    return pipeline_class.MIN_DEPTH


def test_collector_health_state_equals_the_jax_packages():
    """``BatchedSignatureVerifier.health_state`` on the CPU oracle, before
    and after a verify run, equals the JAX package's in every field but
    ``pipeline_depth``.  That one follows a wall-clock EMA of the
    collector's dispatch cost (a cold dispatch can cross the 5 ms step in
    either package), so each package's depth is held to its own
    ``VerifyPipeline.depth()`` rule at its collector's measured EMA."""
    def state(pkg):
        committee = _mod(pkg, "committee").Committee.new_for_benchmarks(N)
        signers = _mod(pkg, "committee").Committee.benchmark_signers(N)
        types = _mod(pkg, "types")
        collector = _collector(pkg, committee)
        before = collector.health_state()
        genesis = [types.StatementBlock.new_genesis(a).reference for a in range(N)]
        blocks = [types.StatementBlock.build(a, 1, genesis, [types.Share(b"tx")],
                                             signer=signers[a]) for a in range(N)]
        verdicts = asyncio.run(collector.verify_blocks(blocks))
        after = collector.health_state()
        pipeline_class = _mod(pkg, "verify_pipeline").VerifyPipeline
        assert before["pipeline_depth"] == _depth_rule(pipeline_class, 0.0)
        assert collector._dispatch_ema_s > 0
        assert after["pipeline_depth"] == _depth_rule(pipeline_class, collector._dispatch_ema_s)
        stripped = [{k: v for k, v in s.items() if k != "pipeline_depth"} for s in (before, after)]
        return stripped, verdicts

    port, jax = state("mysticeti_tpu_torch"), state("mysticeti_tpu")
    assert port == jax
    assert port[1] == [True] * N


INGRESS_SMALL = dict(
    chip_smoke.INGRESS_10, n=4, virtual_s=6.0, fault_one_in=6,
    scenario=dict(chip_smoke.INGRESS_10["scenario"], nodes=4, duration_s=6.0, base_tps=300,
                  multiplier_schedule=((0.0, 1.0), (3.0, 3.0)), max_per_proposal=40,
                  mempool_max_transactions=600))


def test_ingress_phase_in_small_on_the_cpu_kind():
    """``chip_smoke.ingress_run`` of ``INGRESS_SMALL`` with the ``cpu`` kind,
    twice: the ingress phase's checks hold across the two runs (equal
    sequences, sheds, digests, generator stats and finality; offered =
    admitted + shed; no transaction committed twice; shed mode only in the
    3x step; sampled keys closed on both sides; the families equal the
    planes' counts), every forged copy is rejected and counted, and the
    verdicts are accounted for."""
    first = chip_smoke.ingress_run("cpu", INGRESS_SMALL)
    second = chip_smoke.ingress_run("cpu", INGRESS_SMALL)
    reading = chip_smoke.ingress_checks(first, second, INGRESS_SMALL)
    chip_smoke.forged_checks(first)
    chip_smoke.card_checks(first)
    assert reading["shed_mode_entered"] and sum(map(sum, (
        s.values() for s in reading["shed"]))) > 0
    assert reading["server_finality"]["completed"] > 0
