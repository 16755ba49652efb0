"""The port's orchestrator core (``measurement``, ``benchmark``, ``faults``,
``hostmon``) against the JAX package's.

Counterparts of ``tests/test_orchestrator.py``: the scrape parser, the
collection's aggregation and its save / load, the host sampler, the search
state machine and both fault schedules, each run on the port and held to the
JAX package's result on the same input.  The reference's local-fleet test
(:184) is in ``test_torch_orchestrator_local.py`` (it boots node processes,
so it has a file, and under ``--dist loadfile`` a worker, of its own); its
``observe_latency_batch`` test (:259) is held by
``test_torch_metrics_families.py::test_observe_latency_batch_equals_the_jax_packages``.
"""
import importlib
import math
import os
import struct
import time

import pytest

from mysticeti_tpu_torch.orchestrator import (
    CrashRecoverySchedule,
    FaultsType,
    LoadType,
    Measurement,
    MeasurementsCollection,
    ParametersGenerator,
)

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")

SCRAPE = """
# HELP latency_s end-to-end tx latency
latency_s_bucket{workload="shared",le="0.1"} 5.0
latency_s_bucket{workload="shared",le="0.5"} 85.0
latency_s_bucket{workload="shared",le="+Inf"} 100.0
latency_s_sum{workload="shared"} 31.5
latency_s_count{workload="shared"} 100
latency_squared_s_total{workload="shared"} 13.5
latency_s_sum{workload="owned"} 1.0
latency_s_count{workload="owned"} 3
benchmark_duration_total 50.0
"""


def _orch(pkg, name):
    return importlib.import_module(f"{pkg}.orchestrator.{name}")


def _node_scrape(pkg, seed):
    """A node's real exposition: the package's own ``Metrics`` after a seeded
    run of latencies and a benchmark duration."""
    import numpy as np

    metrics = importlib.import_module(f"{pkg}.metrics").Metrics()
    rng = np.random.default_rng(seed)
    metrics.observe_latency_batch("shared", rng.gamma(2.0, 0.2, size=200 + seed))
    metrics.observe_latency_batch("owned", rng.gamma(2.0, 0.1, size=7))
    metrics.benchmark_duration.inc(10.0 + seed)
    return metrics.expose().decode()


def _fields(m):
    return (m.benchmark_duration_s, m.buckets, m.sum_s, m.count, m.squared_sum_s)


def test_measurement_from_prometheus():
    m = Measurement.from_prometheus(SCRAPE, "shared")
    assert m.count == 100
    assert m.sum_s == 31.5
    assert m.squared_sum_s == 13.5
    assert m.benchmark_duration_s == 50.0
    assert m.tps() == pytest.approx(2.0)
    assert m.avg_latency_s() == pytest.approx(0.315)
    assert m.stdev_latency_s() == pytest.approx((13.5 / 100 - 0.315**2) ** 0.5)
    assert m.buckets["0.5"] == 85.0


@pytest.mark.parametrize("workload", ["shared", "owned", "absent"])
@pytest.mark.parametrize("source", ["fixture", "port", "jax"])
def test_measurement_from_prometheus_equals_the_jax_packages(source, workload):
    """The same text (the fixture, or a node exposition from either
    package's ``Metrics``) reads the same through both parsers."""
    text = SCRAPE if source == "fixture" else _node_scrape(
        {"port": "mysticeti_tpu_torch", "jax": "mysticeti_tpu"}[source], 3)
    got = [_orch(pkg, "measurement").Measurement.from_prometheus(text, workload)
           for pkg in PACKAGES]
    assert _fields(got[0]) == _fields(got[1])
    for name in ("tps", "avg_latency_s", "stdev_latency_s"):
        assert getattr(got[0], name)() == getattr(got[1], name)()
    if source != "fixture" and workload == "shared":
        assert got[1].count == 203 and got[1].benchmark_duration_s == 13.0


def _aggregates(c):
    return (c.benchmark_duration(), c.aggregate_tps(), c.aggregate_average_latency_s(),
            c.aggregate_stdev_latency_s(), c.host_summary(), c.health_summary(),
            c.display_summary())


def test_measurements_collection_aggregation(tmp_path):
    c = MeasurementsCollection({"nodes": 2})
    for node in ("0", "1"):
        c.add(node, Measurement.from_prometheus(SCRAPE, "shared"))
    assert c.aggregate_tps() == pytest.approx(2.0)  # max per-node view: 100 tx / 50 s
    assert c.aggregate_average_latency_s() == pytest.approx(0.315)
    path = str(tmp_path / "m.json")
    c.save(path)
    loaded = MeasurementsCollection.load(path)
    assert loaded.aggregate_tps() == pytest.approx(2.0)
    assert "tps" in loaded.display_summary()


def _filled_collection(pkg):
    """Four scrapers over three ticks of both packages' node expositions,
    host samples in both shapes and a health timeline."""
    measurement = _orch(pkg, "measurement")
    c = measurement.MeasurementsCollection({"nodes": 4, "load": 400})
    for tick in range(3):
        for node in range(4):
            text = _node_scrape(PACKAGES[node % 2], 2 * tick + node)
            m = measurement.Measurement.from_prometheus(text, "shared")
            m.timestamp_s = float(tick)
            c.add(str(node), m)
        c.add_host_sample({"timestamp_s": 10.0 * tick, "cpu_pct": 20.0 + tick,
                           "load_1m": 1.5 * tick, "net_bytes_recv": 2**20 * tick,
                           "net_bytes_sent": 2**21 * tick,
                           "per_process": {"node-0": {"cpu_pct": None if tick == 0 else 9.5}}})
        c.add_health_sample({"status": "ok" if tick < 2 else "degraded",
                             "quorum_participation": 1.0 - 0.1 * tick,
                             "commit_skew_rounds": tick, "unreachable": ["3"] if tick else [],
                             "slo_alert_totals": {"loop-lag": float(tick)},
                             "straggler_score": {"2": 0.5 * tick}})
    c.add_host_sample({"timestamp_s": 40.0, "hosts": {"host-0": {"load_1m": 0.42},
                                                      "host-1": {"load_1m": 0.3}}})
    return c


def test_collection_aggregates_and_files_equal_the_jax_packages(tmp_path):
    port, jax = _filled_collection("mysticeti_tpu_torch"), _filled_collection("mysticeti_tpu")
    assert _aggregates(port) == _aggregates(jax)
    assert port.aggregate_tps() > 0 and math.isfinite(port.aggregate_average_latency_s())
    paths = [str(tmp_path / f"{i}.json") for i in range(2)]
    port.save(paths[0])
    jax.save(paths[1])
    with open(paths[0]) as a, open(paths[1]) as b:
        assert a.read() == b.read()
    # Each package loads the other's file to the same aggregates.
    crossed = [_orch(PACKAGES[1], "measurement").MeasurementsCollection.load(paths[1]),
               _orch(PACKAGES[0], "measurement").MeasurementsCollection.load(paths[0])]
    assert _aggregates(crossed[0]) == _aggregates(crossed[1]) == _aggregates(port)


def test_host_sampler_and_summary(tmp_path):
    """node_exporter-equivalent host series: the sampler observes this
    process, the collection aggregates and round-trips it through save/load."""
    from mysticeti_tpu_torch.orchestrator.hostmon import HostSampler, parse_remote_sample

    sampler = HostSampler()
    pids = {"node-0": os.getpid()}
    first = sampler.sample(pids)
    assert first["per_process"]["node-0"]["cpu_pct"] is None  # no interval yet
    assert first["per_process"]["node-0"]["rss_mb"] > 0
    time.sleep(0.05)
    second = sampler.sample(pids)
    assert second["per_process"]["node-0"]["cpu_pct"] is not None
    assert second["mem_available_mb"] > 0

    c = MeasurementsCollection({"nodes": 1})
    c.add("0", Measurement.from_prometheus(SCRAPE, "shared"))
    c.add_host_sample(first)
    c.add_host_sample(second)
    summary = c.host_summary()
    assert summary["samples"] == 2
    assert "cpu_pct_avg" in summary
    assert summary["per_process_cpu_pct_avg"]["node-0"] >= 0
    path = str(tmp_path / "m.json")
    c.save(path)
    loaded = MeasurementsCollection.load(path)
    assert loaded.host_summary()["samples"] == 2
    assert "host cpu" in loaded.display_summary()

    # Dead pid: sampled gracefully (skipped), no crash.
    gone = sampler.sample({"node-1": 2**22 + 12345})
    assert "node-1" not in gone["per_process"]

    # Remote (ssh) sample parsing.
    parsed = parse_remote_sample(
        "0.42 0.30 0.20 1/123 4567\n"
        "MemTotal:       16384000 kB\n"
        "MemAvailable:    8192000 kB\n"
    )
    assert parsed["load_1m"] == pytest.approx(0.42)
    assert parsed["mem_available_mb"] == pytest.approx(8000.0)
    assert parse_remote_sample("garbage") is None

    # SshRunner nests per-host samples under "hosts"; the summary flattens.
    remote = MeasurementsCollection({"nodes": 2})
    remote.add_host_sample(
        {"timestamp_s": 1.0, "hosts": {"host-0": parsed, "host-1": parsed}}
    )
    rs = remote.host_summary()
    assert rs["samples"] == 1
    assert rs["load_1m_max"] == pytest.approx(0.42)


@pytest.mark.parametrize("text", [
    "0.42 0.30 0.20 1/123 4567\nMemTotal:       16384000 kB\nMemAvailable:    8192000 kB\n",
    "7.5 6 5.25 3/900 1\nMemAvailable: 1024 kB\n",
    "garbage", "", "1 2\n",
])
def test_parse_remote_sample_equals_the_jax_packages(text):
    got = [_orch(pkg, "hostmon").parse_remote_sample(text) for pkg in PACKAGES]
    for g in got:
        if g is not None:
            g.pop("timestamp_s")
    assert got[0] == got[1]


def _collection(load, tps, latency, pkg="mysticeti_tpu_torch"):
    measurement = _orch(pkg, "measurement")
    c = measurement.MeasurementsCollection()
    m = measurement.Measurement(
        benchmark_duration_s=10.0,
        count=int(tps * 10),
        sum_s=latency * tps * 10,
        squared_sum_s=latency * latency * tps * 10,
    )
    c.add("0", m)
    return c


def test_search_generator_doubles_then_bisects():
    gen = ParametersGenerator(4, LoadType.search(100, max_iterations=10), duration_s=1)
    p1 = gen.next_parameters()
    assert p1.load == 100
    gen.register_result(p1, _collection(100, tps=100, latency=0.2))  # sustained
    p2 = gen.next_parameters()
    assert p2.load == 200  # doubled
    gen.register_result(p2, _collection(200, tps=200, latency=0.2))
    p3 = gen.next_parameters()
    assert p3.load == 400
    # breaking point: tps collapses below 2/3 of offered
    gen.register_result(p3, _collection(400, tps=100, latency=0.3))
    p4 = gen.next_parameters()
    assert p4.load == 300  # bisect between 200 and 400
    gen.register_result(p4, _collection(300, tps=295, latency=0.25))
    assert gen.max_sustainable_load() == 300


def _probe_sequence(pkg, capacity, start, max_iterations, spike_at=None):
    """Drive a package's search generator against a fleet that sustains
    ``capacity`` tx/s (latency 0.2 s, 5x that from ``spike_at`` tx/s up)
    and return every probe's parameters and the verdict."""
    benchmark = _orch(pkg, "benchmark")
    gen = benchmark.ParametersGenerator(
        4, benchmark.LoadType.search(start, max_iterations=max_iterations), duration_s=30.0)
    probes = []
    while (p := gen.next_parameters()) is not None:
        probes.append(p.to_dict())
        latency = 1.1 if spike_at is not None and p.load >= spike_at else 0.2
        c = _collection(p.load, min(p.load, capacity) if p.load <= capacity else capacity / 2,
                        latency, pkg)
        probes[-1]["out_of_capacity"] = gen.out_of_capacity(p, c)
        gen.register_result(p, c)
        assert len(probes) <= 50
    return probes, gen.max_sustainable_load()


@pytest.mark.parametrize("capacity,start,iterations,spike_at", [
    (300, 100, 10, None), (12345, 100, 7, None), (90, 100, 5, None),
    (5000, 1000, 3, None), (10**6, 10, 12, 1280), (1000, 1000, 7, None),
])
def test_search_probe_sequence_equals_the_jax_packages(capacity, start, iterations, spike_at):
    port = _probe_sequence("mysticeti_tpu_torch", capacity, start, iterations, spike_at)
    jax = _probe_sequence("mysticeti_tpu", capacity, start, iterations, spike_at)
    assert port == jax
    assert len(port[0]) <= iterations


def test_out_of_capacity_latency_spike():
    gen = ParametersGenerator(4, LoadType.search(100), duration_s=1)
    p = gen.next_parameters()
    gen.register_result(p, _collection(100, tps=100, latency=0.1))
    p2 = gen.next_parameters()
    spiked = _collection(200, tps=200, latency=0.9)  # > 5x previous latency
    assert gen.out_of_capacity(p2, spiked)


def test_fixed_generator():
    gen = ParametersGenerator(4, LoadType.fixed([50, 100]), duration_s=1)
    loads = []
    while (p := gen.next_parameters()) is not None:
        loads.append(p.load)
        gen.register_result(p, _collection(p.load, p.load, 0.1))
    assert loads == [50, 100]


def test_crash_recovery_schedule():
    sched = CrashRecoverySchedule(FaultsType.crash_recovery(3), committee_size=10)
    killed, booted = set(), []
    for _ in range(6):
        k, b = sched.update()
        killed.update(k)
        booted.extend(b)
    assert killed, "some nodes must die"
    assert all(n >= 7 for n in killed), "only the fault budget tail dies"
    assert booted, "crash-recovery must also boot nodes back"


def test_permanent_schedule():
    sched = CrashRecoverySchedule(FaultsType.permanent(2), committee_size=4)
    k, b = sched.update()
    assert k == [2, 3] and b == []
    assert sched.update() == ([], [])


@pytest.mark.parametrize("kind,faults,committee", [
    ("crash_recovery", 3, 10), ("crash_recovery", 1, 4), ("crash_recovery", 9, 10),
    ("crash_recovery", 6, 7), ("permanent", 2, 4), ("permanent", 12, 10), ("none", 3, 10),
    ("crash_recovery", 0, 10),
])
def test_fault_schedules_equal_the_jax_packages(kind, faults, committee):
    steps = []
    for pkg in PACKAGES:
        f = _orch(pkg, "faults")
        ftype = f.FaultsType(kind, faults, 30.0)
        sched = f.CrashRecoverySchedule(ftype, committee)
        steps.append((ftype.describe(), ftype.to_dict(),
                      [sched.update() for _ in range(24)], sorted(sched.dead)))
    assert steps[0] == steps[1]


def test_benchmark_duration_starts_at_first_commit(tmp_path, monkeypatch):
    """tps = count / benchmark_duration must not be diluted by pre-load
    warmup: the duration counter opens at the FIRST committed benchmark tx
    (reference scrapes duration from the load client, protocol/mod.rs:57-67)."""
    from mysticeti_tpu_torch.block_store import BlockStore
    from mysticeti_tpu_torch.commit_observer import TestCommitObserver
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.wal import walf

    committee = Committee.new_test([1] * 4)
    _w, reader = walf(str(tmp_path / "wal"))
    store = BlockStore(0, len(committee), reader)
    metrics = Metrics()
    observer = TestCommitObserver(store, committee, metrics=metrics)

    t = [1000.0]
    monkeypatch.setattr("mysticeti_tpu_torch.commit_observer.time.monotonic", lambda: t[0])

    # 300 s of warmup pass with no commits: duration must stay 0.
    t[0] += 300.0
    tx = struct.pack("<d", 0.0) + b"\0" * 24
    observer._update_metrics_batch(tx[:8], now=0.0)
    assert metrics.benchmark_duration._value.get() == 0.0

    # 20 s into the loaded phase the counter reflects loaded time only.
    t[0] += 20.0
    observer._update_metrics_batch(tx[:8], now=0.0)
    assert metrics.benchmark_duration._value.get() == 20.0


def test_parameters_describe_equal_the_jax_packages():
    got = []
    for pkg in PACKAGES:
        b, f = _orch(pkg, "benchmark"), _orch(pkg, "faults")
        params = [b.BenchmarkParameters(10, 30000, 12.0),
                  b.BenchmarkParameters(4, 100, 60.0, f.FaultsType.permanent(1)),
                  b.BenchmarkParameters(7, 5, 1.5, f.FaultsType.crash_recovery(2, 15.0))]
        got.append([(p.describe(), p.to_dict()) for p in params])
    assert got[0] == got[1]
