"""The port's ``Metrics`` against what the port writes and the JAX package's.

A port ``Core`` built with a ``Metrics()`` used to die in its constructor
(``ThresholdClockAggregator`` reads ``quorum_receive_latency``): every
consensus test passed ``metrics=None``.  These tests run the consensus core
with metrics on, walk every port module for the metric attributes it reads,
and hold each family's name, type, help, labels and buckets to the JAX
package's.
"""
import ast
import asyncio
import importlib
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")
# The port's kernel-build families stand where the JAX package counts its
# compiles and compile-cache hits (ops.ed25519.install_device_attribution);
# the generator's submitted count is the client side of overload_bench's
# offered = admitted + shed; the receive path's splits (thread CPU, device
# seconds, collector and offload waits) and the native hashing's fan-out
# are the port's own.
PORT_ONLY = {
    "mysticeti_cuda_builds_total", "mysticeti_cuda_build_seconds_total",
    "mysticeti_cuda_build_cache_hits_total", "mysticeti_cuda_build_cache_misses_total",
    "mysticeti_client_submitted_total",
    "verify_pipeline_stage_cpu_seconds_total", "verify_device_seconds_total",
    "verify_collector_wait_seconds_total", "dataplane_offload_queue_seconds_total",
    "dataplane_offload_cpu_seconds_total", "dataplane_digest_frames_total",
}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


async def _commit_rounds(pkg, tmp_dir, steps):
    """Four syncers of a test committee over one shared ``Metrics()`` (core,
    handler, observer and syncer all recording), each 50 ms step delivering
    every node's new own blocks to every peer; a node whose round stalled
    for 4 steps forces a proposal (the leader-timeout path).  Returns the
    committed sequences and the registry."""
    Committee = _mod(pkg, "committee").Committee
    types = _mod(pkg, "types")
    metrics = _mod(pkg, "metrics").Metrics()
    committee = Committee.new_test([1] * 4)
    signers = Committee.benchmark_signers(4)
    everyone = types.AuthoritySet()
    for a in range(4):
        everyone.insert(a)
    syncers = []
    for a in range(4):
        writer, reader = _mod(pkg, "wal").walf(f"{tmp_dir}/{pkg}-wal-{a}")
        recovered, _ = _mod(pkg, "block_store").BlockStore.open(
            a, reader, writer, committee, metrics=metrics)
        handler = _mod(pkg, "block_handler").TestBlockHandler(
            last_transaction=a * 1_000_000, committee=committee, authority=a, metrics=metrics)
        core_mod = _mod(pkg, "core")
        core = core_mod.Core(
            block_handler=handler, authority=a, committee=committee,
            parameters=_mod(pkg, "config").Parameters(), recovered=recovered,
            wal_writer=writer, options=core_mod.CoreOptions.test(), signer=signers[a],
            metrics=metrics)
        observer = _mod(pkg, "commit_observer").TestCommitObserver(
            core.block_store, committee, metrics=metrics)
        syncers.append(_mod(pkg, "syncer").Syncer(
            core, 3, _mod(pkg, "net_sync").AsyncSignals(), observer, metrics))
    for s in syncers:
        s.force_new_block(1, everyone.copy())
    cursors = [[0] * 4 for _ in range(4)]
    seen = [(0, 0)] * 4  # (round, step it was first seen)
    for step in range(steps):
        await asyncio.sleep(0.05)
        for a, s in enumerate(syncers):
            if s.signals.current_round != seen[a][0]:
                seen[a] = (s.signals.current_round, step)
            elif step - seen[a][1] >= 4:
                s.force_new_block(s.signals.current_round + 1, everyone.copy())
                seen[a] = (s.signals.current_round, step)
        for dst in range(4):
            for src in range(4):
                if src == dst:
                    continue
                blocks = syncers[src].core.block_store.get_own_blocks(cursors[src][dst], 100)
                if blocks:
                    cursors[src][dst] = max(b.round() for b in blocks)
                    syncers[dst].add_blocks(
                        [types.StatementBlock.from_bytes(b.to_bytes()) for b in blocks],
                        everyone.copy())
    for s in syncers:
        s.cleanup()
        s.core.wal_writer.close()
    return [list(s.commit_observer.committed_leaders) for s in syncers], metrics


# Wall-clock readings: busy time, and the commit latency of transactions
# (the observer reads ``time.time()`` against the submission stamps, which
# come from other processes in a real run).
WALL_CLOCK = {"utilization_timer", "latency_s", "latency_squared_s"}


def _samples(metrics, names, wall_clock=WALL_CLOCK):
    """Every sample of the families in ``names``, except wall-clock readings
    (``wall_clock``, the ``_created`` stamps)."""
    out = {}
    for family in metrics.registry.collect():
        if family.name not in names or family.name in wall_clock:
            continue
        for s in family.samples:
            if not s.name.endswith("_created"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def test_a_consensus_round_with_metrics_records_what_the_jax_package_records(tmp_path):
    """The port's ``Core`` / ``Syncer`` / ``CommitObserver`` run with a
    ``Metrics()`` (the constructor used to raise) and commit the JAX
    package's sequences; every sample of every family both registries hold
    is equal, and the consensus families moved."""
    got = {}
    for pkg in PACKAGES:
        run = _mod(pkg, "runtime.simulated").run_simulation
        got[pkg] = run(_commit_rounds(pkg, str(tmp_path), 30), seed=4)
    port_seq, port_metrics = got["mysticeti_tpu_torch"]
    jax_seq, jax_metrics = got["mysticeti_tpu"]
    key = [[(r.authority, r.round, r.digest) for r in seq] for seq in port_seq]
    assert key == [[(r.authority, r.round, r.digest) for r in seq] for seq in jax_seq]
    assert min(len(seq) for seq in port_seq) >= 5
    shared = ({f.name for f in port_metrics.registry.collect()}
              & {f.name for f in jax_metrics.registry.collect()})
    port = _samples(port_metrics, shared)
    assert port == _samples(jax_metrics, shared)
    get = port_metrics.registry.get_sample_value
    assert get("threshold_clock_round") > 5 and get("commit_round") > 5
    assert get("leader_timeout_total") > 0
    assert sum(v for (name, _), v in port.items()
               if name == "committed_leaders_total") == sum(len(s) for s in port_seq)
    assert sum(v for (name, _), v in port.items()
               if name == "mysticeti_commit_decision_total") > 0
    for channel in ("quorum_receive_latency", "proposed_block_size_bytes",
                    "blocks_per_commit_count", "sub_dags_per_commit_count"):
        assert getattr(port_metrics, channel).count == getattr(jax_metrics, channel).count > 0


def _is_metrics(node, aliases=()):
    return ((isinstance(node, ast.Name) and node.id in ("metrics", "_metrics", *aliases))
            or (isinstance(node, ast.Attribute) and node.attr in ("metrics", "_metrics")))


def _metric_reads(path):
    """``metrics.x`` / ``self.metrics.x`` / ``self._metrics.x`` reads in a
    source file, and ``m.x`` where the file binds ``m = self.metrics``
    (comments and strings are not attribute reads)."""
    tree = ast.parse(path.read_text())
    aliases = {target.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
               and _is_metrics(node.value) for target in node.targets
               if isinstance(target, ast.Name)}
    return {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and _is_metrics(node.value, aliases)}


def test_every_metric_the_port_reads_resolves_on_Metrics():
    from mysticeti_tpu_torch.metrics import Metrics

    metrics = Metrics()
    reads = {}
    for path in sorted((ROOT / "mysticeti_tpu_torch").rglob("*.py")):
        for name in _metric_reads(path):
            reads.setdefault(name, []).append(str(path.relative_to(ROOT)))
    missing = {name: where for name, where in reads.items() if not hasattr(metrics, name)}
    assert not missing, missing
    # The walk sees the families of the consensus core, the network plane,
    # the storage lifecycle and the ingress and finality planes.
    assert {"quorum_receive_latency", "threshold_clock_round", "committed_leaders_total",
            "blocks_suspended", "mysticeti_invalid_blocks_total", "core_lock_enqueued",
            "dissemination_encode_reuse_total", "wal_size_bytes",
            "observe_latency_batch", "wal_segments", "wal_reclaimed_bytes_total",
            "checkpoint_last_commit_index", "crash_recovery_total"} <= set(reads)
    ingress_families = {
        "mysticeti_ingress_admitted_total", "mysticeti_ingress_admitted_rate",
        "mysticeti_ingress_mempool_transactions", "mysticeti_ingress_mempool_bytes",
        "mysticeti_ingress_shed_mode", "mysticeti_ingress_gateway_clients",
        "mysticeti_ingress_shed_total", "mysticeti_e2e_finality_seconds",
        "mysticeti_e2e_finality_p50_seconds", "mysticeti_e2e_finality_p99_seconds",
        "mysticeti_client_finality_p50_seconds", "mysticeti_client_finality_p99_seconds"}
    assert ingress_families <= set(reads)
    assert {"mysticeti_tpu_torch/ingress.py", "mysticeti_tpu_torch/finality.py",
            "mysticeti_tpu_torch/transactions_generator.py"} == {
        where for name in ingress_families - {"mysticeti_ingress_shed_total"}
        for where in reads[name]}
    # The observability plane's families, each read by the module that
    # writes it: the health probe and the critical path (health.py), the
    # host monitor (hostattr.py), the accountant (profiling.py) and the
    # flight recorder's dumps (flight_recorder.py).
    observability = {
        "mysticeti_tpu_torch/health.py": {
            "mysticeti_health_round_advance_rate", "mysticeti_health_commit_rate",
            "mysticeti_health_frontier_skew_rounds", "mysticeti_health_authority_lag_rounds",
            "mysticeti_health_verifier_breaker_open", "mysticeti_health_verifier_pinned",
            "mysticeti_health_wal_backlog", "mysticeti_health_status",
            "mysticeti_health_slo_alerts_total", "commit_critical_path_seconds"},
        "mysticeti_tpu_torch/hostattr.py": {
            "mysticeti_loop_lag_seconds", "mysticeti_loop_lag_p99_seconds",
            "mysticeti_blocking_calls_total", "mysticeti_blocking_call_last_ms"},
        "mysticeti_tpu_torch/profiling.py": {
            "mysticeti_cpu_seconds_total", "mysticeti_cpu_us_per_leader",
            "mysticeti_gil_convoy_ratio"},
        "mysticeti_tpu_torch/flight_recorder.py": {"flight_recorder_dumps_total"},
    }
    for module, families in observability.items():
        assert families <= set(reads), (module, families - set(reads))
        assert all(reads[name] == [module] for name in families), {
            name: reads[name] for name in families}
    # The Byzantine and chaos planes' families, each read by its writer.
    assert reads["chaos_faults_total"] == ["mysticeti_tpu_torch/chaos.py"]
    assert reads["mysticeti_detsan_wallclock_reads_total"] == ["mysticeti_tpu_torch/detsan.py"]


def test_each_family_equals_the_jax_packages():
    """Name, type, help, labels and buckets of every family the port
    registers, and the set of exact-percentile channels."""
    from prometheus_client.metrics import MetricWrapperBase

    port = _mod("mysticeti_tpu_torch", "metrics").Metrics()
    jax = _mod("mysticeti_tpu", "metrics").Metrics()
    families = {name: m for name, m in vars(port).items() if isinstance(m, MetricWrapperBase)}
    assert len(families) >= 60
    for name, fam in families.items():
        if name in PORT_ONLY:
            continue
        want = getattr(jax, name)
        assert (fam._name, fam._type, fam._documentation, fam._labelnames) == (
            want._name, want._type, want._documentation, want._labelnames), name
        assert getattr(fam, "_upper_bounds", None) == getattr(want, "_upper_bounds", None), name
    # A family that a registered collector reads at each scrape (the native
    # hashing's frame counts) is no attribute: take it from the registry.
    attributes = {m._name for m in families.values()}
    collected = {f"{f.name}_total" if f.type == "counter" else f.name
                 for f in port.registry.collect() if f.name not in attributes}
    assert (set(families) | collected) - set(vars(jax)) == PORT_ONLY
    channels = {name for name, m in vars(port).items()
                if isinstance(m, _mod("mysticeti_tpu_torch", "metrics").PreciseHistogram)}
    assert channels == set(jax._precise)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_observe_latency_batch_equals_the_jax_packages(n):
    """The vectorized ``latency_s`` / ``latency_squared_s`` observe gives the
    JAX package's buckets, sum and squares (boundary samples included)."""
    values = np.random.default_rng(n).uniform(0.0, 100.0, n)
    values[: n // 10] = 0.5  # on a bucket's upper bound
    got = {}
    for pkg in PACKAGES:
        metrics = _mod(pkg, "metrics").Metrics()
        metrics.observe_latency_batch("owned", values)
        metrics.observe_latency_batch("owned", values[: n // 2])
        got[pkg] = _samples(metrics, {"latency_s", "latency_squared_s"}, wall_clock=())
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]


@pytest.mark.parametrize("n", [10, 250])
def test_precise_channel_reservoir_equals_the_jax_packages(n):
    """A channel past its ``max_samples`` keeps the JAX package's reservoir
    (its seeded Algorithm R, one value at a time and batched), count and
    sum."""
    values = np.random.default_rng(n).uniform(0.0, 10.0, n)
    got = {}
    for pkg in PACKAGES:
        channel = _mod(pkg, "metrics").PreciseHistogram(max_samples=64)
        for v in values[: n // 2]:
            channel.observe(float(v))
        channel.observe_many(values[n // 2:])
        got[pkg] = (list(channel.samples), channel.count, channel.sum)
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    assert len(got["mysticeti_tpu"][0]) == min(n, 64)


def test_chaos_and_detsan_families_count_what_the_jax_packages_count(tmp_path):
    """``chaos_faults_total{kind}`` over a seeded chaos run (crash, restart,
    drops, a blackhole partition) and ``mysticeti_detsan_wallclock_reads_total
    {site}`` under a tripwire hold the JAX package's samples, node by node."""
    got = {}
    for pkg in PACKAGES:
        chaos = _mod(pkg, "chaos")
        plan = chaos.FaultPlan(
            seed=4, link_faults=[chaos.LinkFault(drop_p=0.05, duplicate_p=0.02, delay_p=0.02)],
            partitions=[chaos.PartitionFault(start_s=1.0, end_s=2.0, group_a=(0,),
                                             group_b=(1, 2, 3))],
            crashes=[chaos.CrashFault(node=3, at_s=0.5, downtime_s=1.0)])
        (tmp_path / pkg).mkdir()
        _, harness = chaos.run_chaos_sim(plan, 4, 3.0, str(tmp_path / pkg), with_metrics=True)
        nodes = [_samples(m, {"chaos_faults"}) for m in harness.metrics]
        detsan, metrics = _mod(pkg, "detsan"), _mod(pkg, "metrics").Metrics()
        namespace = {"__name__": f"{pkg}._families_probe"}
        exec("import time\ndef read():\n    return time.monotonic()\n", namespace)

        async def main():
            return namespace["read"]()

        with detsan.Tripwire(metrics=metrics, strict=False):
            _mod(pkg, "runtime.simulated").run_simulation(main())
        reads = {labels: v for (name, labels), v in
                 _samples(metrics, {"mysticeti_detsan_wallclock_reads"}).items()}
        got[pkg] = (nodes, {tuple((k, v.replace(pkg, "PKG")) for k, v in labels): value
                            for labels, value in reads.items()})
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    nodes, reads = got["mysticeti_tpu_torch"]
    kinds = {dict(labels)["kind"] for node in nodes for (_, labels) in node}
    assert {"crash", "restart", "drop", "blackhole"} <= kinds
    assert list(reads.values()) == [1.0]
