"""The port's fleet health plane (``mysticeti_tpu_torch.health``) against the
JAX package's.

Counterparts of ``tests/test_health.py``'s probe / watchdog units, the
commit critical path from the span stream, the cluster aggregation and the
fleet monitor; ``tests/test_ingress.py::test_health_probe_embeds_ingress_state``;
the ``/health`` half of
``tests/test_native_dataplane.py::test_native_active_metric_and_health_field``.
Seeded parities, each fed identical inputs made with numpy from a seed: the
probe's snapshots, alerts, gauges and recorder events over one fake-node
sequence; ``cluster_snapshot_from_texts`` over the same scrape texts; the
flight recorder's dump bytes under the simulator; and a 4-node fleet with a
crash, built from each package by the same code, whose ``FleetHealthMonitor``
timelines and alert streams must be byte-equal once the verifier block's
``backend`` and ``pipeline_depth`` are stripped.  Last, ``chip_smoke``'s
health phase at n = 4 on the ``cpu`` kind.
"""
import asyncio
import importlib
import json
import os

import numpy as np
import pytest

import chip_smoke
from mysticeti_tpu_torch.health import (
    ALERT_STAGES,
    CriticalPathAnalyzer,
    FleetHealthMonitor,
    HealthProbe,
    SLOThresholds,
    cluster_snapshot,
    cluster_snapshot_from_texts,
    node_health_from_series,
)
from mysticeti_tpu_torch.metrics import Metrics, serve_metrics
from mysticeti_tpu_torch.spans import SpanTracer
from mysticeti_tpu_torch.types import BlockReference

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")

pytestmark = pytest.mark.perf


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- stubs --------------------------------------------------------------------


class _FakeWal:
    def __init__(self):
        self.backlog = False

    def pending(self):
        return self.backlog


class _FakeStore:
    def __init__(self, last_seen):
        self.last_seen = last_seen

    def last_seen_by_authority(self, a):
        return self.last_seen.get(a, 0)


class _FakeCore:
    def __init__(self, authority=0, n=4):
        self.authority = authority
        self.round = 0
        self.wal_writer = _FakeWal()
        self.block_store = _FakeStore({a: 0 for a in range(n)})

    def current_round(self):
        return self.round


class _FakeObserver:
    class _Interp:
        last_height = 0

    def __init__(self):
        self.commit_interpreter = self._Interp()


def _probe(slo=None, n=4, metrics=None):
    clock = {"t": 0.0}
    probe = HealthProbe(0, n, metrics=metrics, slo=slo or SLOThresholds(),
                        clock=lambda: clock["t"])
    core = _FakeCore(0, n)
    observer = _FakeObserver()
    probe.attach(core=core, net_syncer=None, commit_observer=observer)
    return probe, core, observer, clock


async def _scrape(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    payload = await reader.read()
    writer.close()
    head, _, body = payload.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0].decode(), body


def _serve_and_scrape(path, **routes):
    async def go():
        server = await serve_metrics(Metrics(), "127.0.0.1", 0, **routes)
        try:
            return await _scrape(server.sockets[0].getsockname()[1], path)
        finally:
            server.close()
            await server.wait_closed()

    return asyncio.run(go())


# -- probe / watchdog units (tests/test_health.py) ----------------------------


def test_slo_thresholds_json_round_trip():
    slo = SLOThresholds(
        min_commit_rate=1.5, max_round_stall_s=7.0, max_commit_stall_s=9.0,
        max_authority_lag_rounds=12, max_breaker_open_fraction=0.25, min_participation=0.8)
    assert SLOThresholds.from_dict(json.loads(json.dumps(slo.to_dict()))) == slo


def test_probe_rates_and_frontier():
    probe, core, observer, clock = _probe()
    s0 = probe.sample()
    assert s0["round"] == 0 and s0["status"] == "ok"
    # One second later: 4 rounds and 2 commits happened; peer 2 lags.
    clock["t"] = 1.0
    core.round = 4
    observer.commit_interpreter.last_height = 2
    core.block_store.last_seen = {1: 4, 2: 1, 3: 6}
    s1 = probe.sample()
    assert s1["round_advance_rate"] > 0
    assert s1["commit_rate"] > 0
    assert s1["authority_lag_rounds"] == {"1": 0, "2": 3, "3": 0}
    assert s1["frontier_skew_rounds"] == 2  # peer 3 is at round 6, we at 4
    assert s1["round_stall_s"] == 0.0


def test_watchdog_round_stall_fires_once_and_clears():
    probe, core, observer, clock = _probe(slo=SLOThresholds(max_round_stall_s=5.0))
    probe.sample()
    clock["t"] = 6.0
    s = probe.sample()
    assert s["status"] == "degraded"
    assert [a.kind for a in probe.alerts] == ["round-stall"]
    assert probe.alerts[0].stage == "receive"
    assert probe.alerts[0].observer == 0
    # Still stalled: no duplicate alert (transition semantics).
    clock["t"] = 8.0
    probe.sample()
    assert len(probe.alerts) == 1
    # The round advances: the alert clears, a later stall re-fires.
    clock["t"] = 9.0
    core.round = 3
    assert probe.sample()["status"] == "ok"
    clock["t"] = 20.0
    probe.sample()
    assert [a.kind for a in probe.alerts] == ["round-stall", "round-stall"]


def test_watchdog_commit_rate_floor_does_not_collide_with_stall():
    """min_commit_rate has its own alert kind: sharing commit-stall's firing
    key would let the healthy stall check clear it every tick and the rate
    alert re-fire per sample."""
    probe, core, observer, clock = _probe(slo=SLOThresholds(
        max_round_stall_s=0.0, max_commit_stall_s=100.0, min_commit_rate=5.0))
    probe.sample()
    for t in (1.0, 2.0, 3.0):
        clock["t"] = t
        core.round += 1  # rounds move; commits crawl below the floor
        observer.commit_interpreter.last_height += 1
        probe.sample()
    kinds = [a.kind for a in probe.alerts]
    assert kinds == ["commit-rate"], kinds  # fired exactly once
    assert probe.alerts[0].stage == "commit"


def test_watchdog_authority_lag_names_the_straggler():
    probe, core, observer, clock = _probe(
        slo=SLOThresholds(max_round_stall_s=0.0, max_authority_lag_rounds=5))
    core.round = 10
    core.block_store.last_seen = {1: 10, 2: 2, 3: 9}
    probe.sample()
    assert len(probe.alerts) == 1
    alert = probe.alerts[0]
    assert alert.kind == "authority-lag" and alert.authority == 2
    assert alert.stage == "receive"
    assert "authority 2" in alert.detail


def test_probe_gauges_and_alert_counter():
    metrics = Metrics()
    probe, core, observer, clock = _probe(slo=SLOThresholds(max_round_stall_s=1.0),
                                          metrics=metrics)
    core.round = 7
    core.block_store.last_seen = {1: 7, 2: 5, 3: 7}
    probe.sample()
    clock["t"] = 2.0
    probe.sample()  # the round stalled for 2 s: an alert and the degraded gauge
    text = metrics.expose().decode()
    assert "mysticeti_health_round_advance_rate" in text
    assert 'mysticeti_health_authority_lag_rounds{authority="2"} 2.0' in text
    assert "mysticeti_health_status 0.0" in text
    assert ('mysticeti_health_slo_alerts_total{authority="",kind="round-stall"'
            ',stage="receive"} 1.0') in text


def test_diagnosis_and_health_route():
    probe, core, observer, clock = _probe(slo=SLOThresholds(max_round_stall_s=1.0))
    probe.sample()
    doc = probe.diagnosis()
    assert doc["status"] == "ok" and doc["authority"] == 0
    assert doc["signals"]["round"] == 0
    status, body = _serve_and_scrape("/health", health_probe=probe)
    assert "200" in status
    assert json.loads(body)["status"] == "ok"
    # Degrade: the route turns 503 — a readiness gate, not just a document.
    clock["t"] = 5.0
    probe.sample()
    status, body = _serve_and_scrape("/health", health_probe=probe)
    assert "503" in status
    assert json.loads(body)["status"] == "degraded"


def test_flight_recorder_route_and_the_scrape_fallback():
    """``/debug/flight-recorder`` serves the recorder's canonical document;
    without a recorder (or a probe) the path falls through to the scrape."""
    from mysticeti_tpu_torch.flight_recorder import FlightRecorder

    recorder = FlightRecorder(authority=3)
    recorder.record("connect", peer=1)
    status, body = _serve_and_scrape("/debug/flight-recorder", flight_recorder=recorder)
    doc = json.loads(body)
    assert "200" in status and doc["authority"] == 3
    assert [e["kind"] for e in doc["events"]] == ["connect"]
    status, body = _serve_and_scrape("/debug/flight-recorder")
    assert "200" in status and b"mysticeti_health_status" in body
    status, body = _serve_and_scrape("/health")
    assert b"# HELP" in body


# -- commit critical-path attribution ----------------------------------------


def _ref(authority, round_, tag):
    return BlockReference(authority, round_, bytes([tag]).ljust(32, b"\x00"))


def test_critical_path_attribution_from_span_stream():
    metrics = Metrics()
    tracer = SpanTracer()
    analyzer = CriticalPathAnalyzer(metrics=metrics, authority=0)
    tracer.add_sink(analyzer.on_span)
    leader = _ref(3, 7, 1)
    # The pipeline chain as the instrumentation records it, receive
    # dominating (authority 3 was slow reaching us).
    tracer.record_span("receive", leader, 0.0, t1=2.0, authority=0)
    tracer.record_span("verify", leader, 2.0, t1=2.1, authority=0)
    tracer.record_span("dag_add", leader, 2.1, t1=2.2, authority=0)
    tracer.record_span("proposal_wait", leader, 2.2, t1=2.5, authority=0)
    tracer.record_span("finalize", leader, 2.5, t1=2.6, authority=0)
    # Another node's track must not pollute this analyzer.
    tracer.record_span("receive", leader, 0.0, t1=9.0, authority=1)
    assert analyzer.leaders_attributed == 0  # no commit span yet
    tracer.record_span("commit", leader, 2.5, t1=2.55, authority=0)
    assert analyzer.leaders_attributed == 1
    top = analyzer.top_blocking()
    assert top[0]["stage"] == "receive" and top[0]["authority"] == 3
    assert top[0]["leaders"] == 1 and top[0]["blocked_s"] == pytest.approx(2.0)
    text = metrics.expose().decode()
    assert 'commit_critical_path_seconds_count{stage="receive"} 1.0' in text
    assert 'commit_critical_path_seconds_count{stage="commit"} 1.0' in text
    # Non-pipeline stages never enter the attribution index.
    tracer.record_span("verify_dispatch", _ref(1, 1, 2), 0.0, t1=1.0, authority=0)
    assert _ref(1, 1, 2) not in analyzer._stages


# -- cluster aggregation ------------------------------------------------------


def _node_text(round_, commit_round, committed, lags, alerts=0):
    lines = [
        f"threshold_clock_round {round_}",
        f"commit_round {commit_round}",
        "mysticeti_health_commit_rate 2.5",
        "mysticeti_health_round_advance_rate 4.0",
        "mysticeti_health_status 1",
    ]
    for a, count in committed.items():
        lines.append(f'committed_leaders_total{{authority="{a}",status="committed"}} {count}')
    for a, lag in lags.items():
        lines.append(f'mysticeti_health_authority_lag_rounds{{authority="{a}"}} {lag}')
    if alerts:
        lines.append('mysticeti_health_slo_alerts_total{kind="round-stall",'
                     f'authority="",stage="receive"}} {alerts}')
    return "\n".join(lines) + "\n"


def test_cluster_snapshot_participation_skew_stragglers():
    texts = {
        "0": _node_text(20, 18, {0: 5, 1: 4, 2: 6}, {"1": 0, "2": 1, "3": 9}),
        "1": _node_text(20, 12, {0: 5, 1: 4, 2: 6}, {"0": 0, "2": 2, "3": 11}),
        "2": None,  # unreachable this tick
    }
    snap = cluster_snapshot_from_texts(texts, 4, slo=SLOThresholds(min_participation=0.9))
    assert snap["unreachable"] == ["2"]
    assert snap["quorum_participation"] == 0.75  # 3 of 4 authorities committed
    assert snap["commit_skew_rounds"] == 6
    assert snap["straggler_score"]["3"] == 11  # worst view wins
    assert snap["status"] == "degraded"
    assert any(r.startswith("unreachable") for r in snap["degraded_reasons"])
    assert "participation" in snap["degraded_reasons"]


def test_cluster_snapshot_green_path():
    texts = {str(i): _node_text(20, 18, {a: 3 for a in range(4)}, {}) for i in range(4)}
    snap = cluster_snapshot_from_texts(texts, 4)
    assert snap["status"] == "ok" and snap["degraded_reasons"] == []
    assert snap["quorum_participation"] == 1.0
    assert snap["commit_rate_by_node"]["0"] == 2.5


def test_node_health_counts_alerts():
    view = node_health_from_series([
        ("mysticeti_health_slo_alerts_total", {"kind": "authority-lag", "authority": "2"}, 3.0),
        ("mysticeti_health_slo_alerts_total", {"kind": "round-stall", "authority": ""}, 1.0),
    ])
    assert view["slo_alerts"] == {"authority-lag": 3.0, "round-stall": 1.0}
    snap = cluster_snapshot({"0": view}, 4)
    assert snap["slo_alert_totals"] == {"authority-lag": 3.0, "round-stall": 1.0}
    # Cumulative alert history alone does not mark the fleet degraded.
    assert snap["status"] == "ok" and snap["degraded_reasons"] == []


def test_fleet_monitor_report_and_down_nodes():
    probes = {}
    clock = {"t": 0.0}
    for a in range(3):
        p = HealthProbe(a, 3, slo=SLOThresholds(max_authority_lag_rounds=5),
                        clock=lambda: clock["t"])
        core = _FakeCore(a, 3)
        core.round = 10
        core.block_store.last_seen = {b: 10 for b in range(3)}
        p.attach(core=core, commit_observer=_FakeObserver())
        probes[a] = p
    probes[2].detach()  # node 2 is down
    monitor = FleetHealthMonitor(probes.get, 3, interval_s=1.0)
    entry = monitor.tick()
    assert entry["nodes"]["2"] == {"down": True}
    assert "wal_backlog" not in entry["nodes"]["0"]  # volatile key stripped
    report = monitor.fleet_report()
    assert report["down"] == ["2"]
    assert report["status"] == "degraded"


# -- the ingress and native blocks --------------------------------------------


def test_health_probe_embeds_ingress_state():
    from mysticeti_tpu_torch.ingress import IngressParameters, IngressPlane

    plane = IngressPlane(IngressParameters())
    plane.submit("c", [bytes([i]) * 64 for i in range(3)])
    probe = HealthProbe(0, 4, clock=lambda: 0.0)
    probe.attach(core=_FakeCore(), ingress=plane)
    snapshot = probe.sample()
    assert snapshot["ingress"]["mempool_transactions"] == 3
    assert "admitted_rate_tx_s" in snapshot["ingress"]
    assert snapshot["ingress"] == plane.health_state()


def test_health_host_block_names_the_native_functions():
    """The ``/health`` half of the native data plane's metric-and-health
    test: the host block lists the functions the port's extension resolved."""
    from mysticeti_tpu_torch.hostattr import HostMonitor
    from mysticeti_tpu_torch.native import active_functions

    probe = HealthProbe(0, 4, clock=lambda: 0.0)
    probe.attach(core=_FakeCore(), host_monitor=HostMonitor())
    probe.sample()
    status, body = _serve_and_scrape("/health", health_probe=probe)
    assert "200" in status
    assert json.loads(body)["signals"]["host"]["native_active"] == list(active_functions())


# -- seeded parities against the JAX package ----------------------------------


class _FakeVerifier:
    def __init__(self):
        self.state = {"breaker_open": False, "pinned_backend": None, "backend": "fake",
                      "pipeline_inflight": 0, "pipeline_depth": 2}

    def health_state(self):
        return dict(self.state)


class _FakeSyncer:
    def __init__(self):
        self.connected_authorities = set()


class _FakeIngress:
    def __init__(self):
        self.finality = {"samples": 0, "p99_s": 0.0, "completed": 0}

    def health_state(self):
        return {"shed_mode": False, "finality": dict(self.finality)}


def _probe_sequence(pkg, seed, steps=60, n=5):
    """One probe of ``pkg`` over a fake node driven by a numpy-seeded walk
    (rounds, commits, peers' last rounds, WAL backlog, breaker and pin
    flips, connections, blocking holds, loop lags, finality p99), every SLO
    armed; returns the snapshots, the alerts, the diagnosis, the recorder's
    events (without their wall-clock stamps) and the health gauges'
    samples."""
    rng = np.random.default_rng(seed)
    metrics = _mod(pkg, "metrics").Metrics()
    recorder = _mod(pkg, "flight_recorder").FlightRecorder(authority=0, metrics=metrics)
    monitor = _mod(pkg, "hostattr").HostMonitor(metrics=metrics, recorder=recorder,
                                                  blocking_threshold_ms=50.0)
    clock = {"t": 0.0}
    health = _mod(pkg, "health")
    slo = health.SLOThresholds(
        min_commit_rate=0.8, max_round_stall_s=3.0, max_commit_stall_s=4.0,
        max_authority_lag_rounds=6, max_breaker_open_fraction=0.2, max_loop_lag_s=0.05,
        max_blocking_call_ms=80.0, max_finality_p99_s=1.5)
    probe = health.HealthProbe(0, n, metrics=metrics, slo=slo, clock=lambda: clock["t"],
                               recorder=recorder)
    core, observer = _FakeCore(0, n), _FakeObserver()
    verifier, syncer, ingress = _FakeVerifier(), _FakeSyncer(), _FakeIngress()
    probe.attach(core=core, net_syncer=syncer, block_verifier=verifier,
                 commit_observer=observer, ingress=ingress, host_monitor=monitor)
    snapshots = []
    for _ in range(steps):
        clock["t"] = round(clock["t"] + float(rng.uniform(0.2, 1.5)), 6)
        core.round += int(rng.integers(0, 4))
        observer.commit_interpreter.last_height += int(rng.integers(0, 2))
        core.block_store.last_seen = {a: max(0, core.round - int(rng.integers(0, 9)))
                                      for a in range(1, n)}
        core.wal_writer.backlog = bool(rng.random() < 0.2)
        verifier.state["breaker_open"] = bool(rng.random() < 0.15)
        verifier.state["pinned_backend"] = "cpu" if rng.random() < 0.1 else None
        syncer.connected_authorities = set(range(int(rng.integers(1, n + 1))))
        for _hold in range(int(rng.integers(0, 3))):
            monitor.note_command(f"core:cmd{int(rng.integers(0, 3))}",
                                 float(rng.uniform(0.0, 0.12)))
        for _lag in range(int(rng.integers(0, 4))):
            monitor.loop_lag._lags.append(round(float(rng.uniform(0.0, 0.08)), 6))
        completed = int(rng.integers(0, 50))
        ingress.finality = {"samples": completed, "completed": completed,
                            "p99_s": round(float(rng.uniform(0.5, 2.0)), 6)}
        snapshots.append(probe.sample())
    families = {name for name in vars(metrics) if name.startswith("mysticeti_health")
                or name in ("mysticeti_blocking_calls_total", "mysticeti_blocking_call_last_ms",
                            "flight_recorder_dumps_total")}
    samples = {}
    for family in metrics.registry.collect():
        if any(family.name.startswith(f) or f.startswith(family.name) for f in families):
            for s in family.samples:
                if not s.name.endswith("_created"):
                    samples[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return {"snapshots": json.dumps(snapshots, sort_keys=True).encode(),
            "alerts": [a.to_dict() for a in probe.alerts],
            "diagnosis": json.dumps(probe.diagnosis(), sort_keys=True).encode(),
            # A recorder stamps events on the runtime clock: wall time here.
            "events": [{k: v for k, v in e.items() if k != "t"} for e in recorder.events()],
            "samples": samples}


@pytest.mark.parametrize("seed", [0, 7])
def test_probe_snapshots_and_alerts_equal_the_jax_packages(seed):
    got = {pkg: _probe_sequence(pkg, seed) for pkg in PACKAGES}
    port, jax = got["mysticeti_tpu_torch"], got["mysticeti_tpu"]
    assert port == jax
    kinds = {a["kind"] for a in port["alerts"]}
    assert {"authority-lag", "blocking-call", "loop-lag", "breaker-open"} <= kinds, kinds
    assert all(a["stage"] == ALERT_STAGES[a["kind"]] for a in port["alerts"])
    assert any(e["kind"] == "slo-alert" for e in port["events"])


def _scrape_texts(seed, nodes=6, n=7):
    """Per-node ``/metrics`` texts (one unreachable) over every series
    ``node_health_from_series`` reads, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    texts = {}
    for k in range(nodes):
        if rng.random() < 0.15:
            texts[str(k)] = None
            continue
        lines = [f"threshold_clock_round {int(rng.integers(10, 90))}",
                 f"commit_round {int(rng.integers(5, 80))}",
                 f"mysticeti_epoch {int(rng.integers(0, 3))}",
                 f"mysticeti_health_commit_rate {rng.uniform(0, 9):.6f}",
                 f"mysticeti_health_round_advance_rate {rng.uniform(0, 12):.6f}",
                 f"mysticeti_health_frontier_skew_rounds {int(rng.integers(-3, 9))}",
                 f"mysticeti_health_status {int(rng.random() < 0.8)}",
                 f"mysticeti_loop_lag_p99_seconds {rng.uniform(0, 0.4):.6f}",
                 f"mysticeti_e2e_finality_p50_seconds {rng.uniform(0, 2):.6f}",
                 f"mysticeti_e2e_finality_p99_seconds {rng.uniform(0, 9):.6f}",
                 "# HELP some_family a comment line"]
        for a in range(n):
            if rng.random() < 0.8:
                lines.append(f'committed_leaders_total{{authority="{a}",status='
                             f'"{"committed" if rng.random() < 0.9 else "skipped"}"}} '
                             f'{int(rng.integers(0, 30))}')
            lines.append(f'mysticeti_health_authority_lag_rounds{{authority="{a}"}} '
                         f'{int(rng.integers(0, 15))}')
        for kind in ("authority-lag", "round-stall", "loop-lag"):
            if rng.random() < 0.4:
                lines.append(f'mysticeti_health_slo_alerts_total{{authority="",kind="{kind}",'
                             f'stage="receive"}} {int(rng.integers(1, 4))}')
        for sub in ("core", "verifier-pack", "event-loop-idle", "mesh-parse", "wal"):
            for tc in ("loop", "aux"):
                lines.append(f'mysticeti_cpu_seconds_total{{subsystem="{sub}",'
                             f'thread_class="{tc}"}} {rng.uniform(0, 5):.6f}')
        texts[str(k)] = "\n".join(lines) + "\n"
    return texts


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cluster_snapshot_from_texts_equals_the_jax_packages(seed):
    texts = _scrape_texts(seed)
    out = {}
    for pkg in PACKAGES:
        health = _mod(pkg, "health")
        slo = health.SLOThresholds(min_participation=0.9, max_loop_lag_s=0.2,
                                   max_finality_p99_s=4.0)
        out[pkg] = json.dumps(health.cluster_snapshot_from_texts(
            texts, 7, slo=slo, retired={"6"}), sort_keys=True).encode()
    assert out["mysticeti_tpu_torch"] == out["mysticeti_tpu"]
    assert json.loads(out["mysticeti_tpu"])["reachable"]


def _recorder_run(pkg, tmp_dir, seed):
    """Under ``pkg``'s simulator: a recorder with a dump path records a
    seeded mix of events and alerts (the alert dumps debounced at 2 virtual
    s) and dumps once at the end; returns the snapshot bytes, the dump
    files' bytes and the dump counter's samples."""
    rng = np.random.default_rng(seed)
    plan = [(float(rng.uniform(0.1, 1.0)), int(rng.integers(0, 3))) for _ in range(40)]

    async def main():
        metrics = _mod(pkg, "metrics").Metrics()
        recorder = _mod(pkg, "flight_recorder").FlightRecorder(
            authority=2, capacity=25, dump_path=os.path.join(tmp_dir, "fr.json"),
            metrics=metrics, alert_debounce_s=2.0)
        for i, (gap, what) in enumerate(plan):
            await asyncio.sleep(gap)
            if what == 0:
                recorder.record("connect", peer=i % 4, note=None)
            elif what == 1:
                recorder.on_alert("authority-lag", i % 4, "receive", gap * 10, f"alert {i}")
            else:
                recorder.record("commit", height=i)
        recorder.dump("shutdown")
        files = {name: open(os.path.join(tmp_dir, name), "rb").read()
                 for name in sorted(os.listdir(tmp_dir))}
        samples = {tuple(s.labels.items()): s.value
                   for family in metrics.flight_recorder_dumps_total.collect()
                   for s in family.samples if s.name.endswith("_total")}
        return recorder.snapshot_bytes(), files, samples, len(recorder.dumps)

    return _mod(pkg, "runtime.simulated").run_simulation(main(), seed=seed)


def test_flight_recorder_dumps_equal_the_jax_packages(tmp_path):
    got = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = _recorder_run(pkg, str(d), seed=5)
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    snapshot, files, samples, dumps = got["mysticeti_tpu_torch"]
    assert set(files) == {"fr.json", "fr.json.alert"}
    assert sum(samples.values()) == dumps > 2  # debounced, but more than once
    assert json.loads(snapshot)["dropped"] > 0  # the ring wrapped


# -- a 4-node fleet with a crash, from each package by the same code ----------

FLEET = dict(n=4, virtual_s=9.0, crash=(2, 2.5, 3.0), seed=11, lag_rounds=5)


async def _health_fleet(pkg, wal_dir):
    """Four ``NetworkSyncer``s of ``pkg`` over its ``SimulatedNetwork``, each
    with a collector over the CPU oracle, a ``HostMonitor`` on its
    dispatcher and a ``HealthProbe`` (with a flight recorder that dumps on
    alerts) that outlives its restarts; node 2 crashes and reboots from its
    WAL; a ``FleetHealthMonitor`` ticks every virtual second."""
    from test_torch_net_sync import build_node

    n, (down, at, downtime) = FLEET["n"], FLEET["crash"]
    Committee = _mod(pkg, "committee").Committee
    committee = Committee.new_for_benchmarks(n)
    signers = Committee.benchmark_signers(n)
    parameters = _mod(pkg, "config").Parameters(leader_timeout_s=1.0)
    sim_net = _mod(pkg, "simulated_network").SimulatedNetwork(n)
    health = _mod(pkg, "health")
    bv = _mod(pkg, "block_validator")
    metrics = [_mod(pkg, "metrics").Metrics() for _ in range(n)]
    recorders = [_mod(pkg, "flight_recorder").FlightRecorder(
        authority=a, metrics=metrics[a], dump_path=os.path.join(wal_dir, f"fr-{a}.json"))
        for a in range(n)]
    slo = health.SLOThresholds(max_authority_lag_rounds=FLEET["lag_rounds"])
    probes = {a: health.HealthProbe(a, n, metrics=metrics[a], slo=slo, recorder=recorders[a])
              for a in range(n)}
    nodes = [None] * n

    def build(a):
        collector = bv.BatchedSignatureVerifier(committee, bv.CpuSignatureVerifier(),
                                                max_delay_s=0.005)
        node = build_node(pkg, committee, signers, a, wal_dir, sim_net, parameters, collector)
        monitor = _mod(pkg, "hostattr").HostMonitor(metrics=metrics[a],
                                                    recorder=recorders[a]).start()
        node.dispatcher.blocking_monitor = monitor
        probes[a].attach(core=node.core, net_syncer=node, block_verifier=collector,
                         commit_observer=node.syncer.commit_observer, host_monitor=monitor)
        nodes[a] = node
        return node

    for a in range(n):
        await build(a).start()
    await sim_net.connect_all()
    monitor = health.FleetHealthMonitor(probes.get, n, interval_s=1.0).start()
    await asyncio.sleep(at)
    sim_net.crash(down)
    probes[down].detach()
    await nodes[down].stop()
    nodes[down].core.wal_writer.close()
    nodes[down].core.block_store.close()
    await asyncio.sleep(downtime)
    await build(down).start()
    await sim_net.restart(down)
    await asyncio.sleep(FLEET["virtual_s"] - at - downtime)
    monitor.stop()
    for node in nodes:
        await node.stop()
        node.core.wal_writer.close()
        node.core.block_store.close()
    sim_net.close()
    return {"timeline": chip_smoke.strip_volatile_verifier(monitor.timeline),
            "alerts": monitor.alert_stream_bytes(), "report": monitor.fleet_report(),
            "dumps": [len(r.dumps) for r in recorders],
            "dumps_total": [sum(s.value for f in m.flight_recorder_dumps_total.collect()
                                for s in f.samples if s.name.endswith("_total"))
                            for m in metrics]}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    out = {}
    for pkg in PACKAGES:
        d = str(tmp_path_factory.mktemp(pkg))
        out[pkg] = _mod(pkg, "runtime.simulated").run_simulation(_health_fleet(pkg, d),
                                                                 seed=FLEET["seed"])
    return out


def test_fleet_timelines_equal_the_jax_packages(fleets):
    port, jax = fleets["mysticeti_tpu_torch"], fleets["mysticeti_tpu"]
    assert json.dumps(port["timeline"], sort_keys=True) == json.dumps(jax["timeline"],
                                                                      sort_keys=True)
    assert port["alerts"] == jax["alerts"]
    assert port["dumps"] == jax["dumps"] and port["dumps_total"] == jax["dumps_total"]


def test_fleet_monitor_names_the_crashed_node(fleets):
    port = fleets["mysticeti_tpu_torch"]
    down, at, downtime = FLEET["crash"]
    outage = [e for e in port["timeline"] if at < e["t"] < at + downtime]
    assert outage and all(e["nodes"][str(down)] == {"down": True} for e in outage)
    alerts = json.loads(port["alerts"])
    named = {a["observer"] for a in alerts if a["kind"] == "authority-lag"
             and a["authority"] == down and at < a["t"] <= at + downtime}
    assert named == set(range(FLEET["n"])) - {down}
    assert all(a["stage"] == ALERT_STAGES[a["kind"]] for a in alerts)
    # Debounced at 30 s, a 9 s run dumps at most once a recorder.
    assert port["dumps"] == [min(1, sum(a["observer"] == o for a in alerts))
                             for o in range(FLEET["n"])]
    assert port["dumps"] == port["dumps_total"]
    for entry in port["timeline"]:
        for snap in entry["nodes"].values():
            if "host" in snap:
                assert snap["host"]["loop_lag_samples"] == 0
                assert snap["host"]["blocking_calls"] == 0


# -- chip_smoke's health phase at n = 4 on the cpu kind -----------------------

# health-sim-10 in small: 4 nodes for 9 virtual s, one forged copy in 6
# block-carrying batches, node 3 down from 2 s to 5 s.
HEALTH_SIM_SMALL = dict(chip_smoke.HEALTH_SIM_10, n=4, virtual_s=9.0, fault_one_in=6,
                        crashes=((3, 2.0, 3.0, 0),))
# health-tcp-10 in small: 4 nodes for 5 wall s at 300 tx/s a node.
HEALTH_TCP_SMALL = dict(chip_smoke.HEALTH_TCP_10, n=4, wall_s=5.0, min_commits=1,
                        scenario=dict(chip_smoke.HEALTH_TCP_10["scenario"], nodes=4,
                                      base_tps=300))


def test_health_sim_half_in_small_on_the_cpu_kind():
    """``chip_smoke.health_sim_run`` of ``HEALTH_SIM_SMALL`` on the ``cpu``
    kind twice: the sim half's checks hold across the two runs (node 3 down
    in every tick of its outage, every live observer naming it, host blocks
    all-zero, the alert dumps equal the dump counter, the timelines and
    alert streams byte-equal)."""
    config = HEALTH_SIM_SMALL
    first = chip_smoke.health_sim_run("cpu", config)
    second = chip_smoke.health_sim_run("cpu", config)
    reading = chip_smoke.health_sim_checks(first, second, config)
    assert reading["lag_alerts"] >= config["n"] - 1
    chip_smoke.forged_checks(first)
    chip_smoke.card_checks(first)


def test_health_tcp_half_in_small_on_the_cpu_kind():
    """``chip_smoke.health_tcp_run`` of ``HEALTH_TCP_SMALL`` on the ``cpu``
    kind: four ingress nodes over loopback TCP with the whole observability
    plane; every ``/health``, ``/metrics`` and ``/debug/flight-recorder``
    scrape parses, the cluster snapshot counts every node reachable, and
    the accountant's ticks resolve to registered subsystems."""
    config = HEALTH_TCP_SMALL
    result = chip_smoke.health_tcp_run("cpu", config)
    reading = chip_smoke.health_tcp_checks(result, config, "CpuSignatureVerifier", card=False)
    assert reading["cluster"]["reachable"] == [str(a) for a in range(config["n"])]
    assert reading["report"]["census_ticks"] > 0
