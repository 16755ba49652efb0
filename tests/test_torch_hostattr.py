"""The port's host attribution plane (``mysticeti_tpu_torch.profiling`` and
``hostattr``) against the JAX package's.

Counterparts of ``tests/test_hostattr.py`` (the registry's totality, now
over ``mysticeti_tpu_torch/``; attribution precedence; thread classes; the
accountant's deterministic report and published series; folded-file
salvage and the flame diff; the blocking-call detector on the port's
``CoreTaskDispatcher``; the loop-lag probe; the clean seeded 10-node sim
with the host SLOs armed, built from the port's nodes) and of
``tests/test_profiling.py`` (the render round trips and the CLI pair,
against ``python -m mysticeti_tpu_torch.tools.mkflamegraph``).  Seeded
parities, fed identical inputs made with numpy from a seed: the
accountant's ``report_bytes()`` and published series from one synthetic
census, and ``flamegraph_svg`` / ``flamegraph_diff_svg`` bytes.
"""
import asyncio
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mysticeti_tpu_torch import profiling
from mysticeti_tpu_torch.core_task import CoreTaskDispatcher
from mysticeti_tpu_torch.flight_recorder import FlightRecorder
from mysticeti_tpu_torch.health import HealthProbe, SLOThresholds
from mysticeti_tpu_torch.hostattr import HostMonitor, LoopLagProbe
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.orchestrator.measurement import iter_series
from mysticeti_tpu_torch.profiling import (
    FRAME_SUBSYSTEMS,
    SUBSYSTEM_NAMES,
    SUBSYSTEMS,
    SubsystemAccountant,
    attribute,
    flamegraph_svg,
    render_file,
    thread_class_of,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mysticeti_tpu_torch")
PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")
MKFLAMEGRAPH = [sys.executable, "-m", "mysticeti_tpu_torch.tools.mkflamegraph"]
FOLDED = "main:run;core:add_blocks;crypto:verify 42\nmain:run;net:decode 13\n"

pytestmark = pytest.mark.perf


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _cli(*args):
    return subprocess.run([*MKFLAMEGRAPH, *map(str, args)], capture_output=True, text=True,
                          timeout=120, cwd=REPO)


# -- the declarative registry -------------------------------------------------


def test_subsystem_mapping_totality():
    """Every module of the port resolves through SUBSYSTEMS — a new module
    cannot silently land its CPU time in "other"."""
    missing = []
    for dirpath, _dirnames, filenames in os.walk(PKG):
        for fn in filenames:
            if fn.endswith(".py") and fn[:-3] not in SUBSYSTEMS:
                missing.append(os.path.join(os.path.relpath(dirpath, REPO), fn))
    assert not missing, f"modules without a SUBSYSTEMS row (add them in profiling.py): {missing}"


def test_registry_extends_the_jax_packages():
    """The port's registry is the JAX package's plus the port's own modules
    (the CUDA wrappers and their build as ``verifier-pack``, the
    entries, the benchmark, the flamegraph CLI, the attribution probe, the
    scenario-matrix probe, the lint's alias, the trace and fleet-health
    tools, the kernel and storage tools, the load and catch-up fleet benches and the
    data-plane, mesh, reconfiguration, finality and execution probes as
    ``tooling``); the overrides, waiting leaves and subsystem names
    are the JAX package's."""
    jax = _mod("mysticeti_tpu", "profiling")
    assert {k: v for k, v in SUBSYSTEMS.items() if k in jax.SUBSYSTEMS} == jax.SUBSYSTEMS
    assert {k: v for k, v in SUBSYSTEMS.items() if k not in jax.SUBSYSTEMS} == {
        "ed25519_cuda": "verifier-pack", "cuda_build": "verifier-pack",
        "entry": "tooling", "bench": "tooling", "mkflamegraph": "tooling",
        "perf_attr": "tooling", "scenario_matrix": "tooling", "lint": "tooling",
        "trace_report": "tooling", "fleet_trace": "tooling", "fleetmon": "tooling",
        "kernel_parity": "tooling", "bench_probe": "tooling", "mesh_scaling": "tooling",
        "bench_trend": "tooling", "wal_inspect": "tooling", "storage_probe": "tooling",
        "commit_explain": "tooling", "maxload_bench": "tooling", "chip_window_ab": "tooling",
        "node_bench": "tooling", "catchup_bench": "tooling", "overload_bench": "tooling",
        "dataplane_ab": "tooling", "mesh_ab": "tooling", "reconfig_matrix": "tooling",
        "finality_bench": "tooling", "execution_bench": "tooling"}
    assert FRAME_SUBSYSTEMS == jax.FRAME_SUBSYSTEMS
    assert profiling.WAITING_LEAVES == jax.WAITING_LEAVES
    assert SUBSYSTEM_NAMES == jax.SUBSYSTEM_NAMES
    assert profiling._PKG_DIR == PKG


def test_attribute_precedence():
    # A parked leaf is idle, regardless of what is above it.
    assert attribute([("selectors", "select", False), ("core_task", "_run", True)]) == (
        "event-loop-idle")
    # The GC override beats the module map anywhere in the stack: a wal
    # append inside retire_below is GC cost.
    assert attribute([("wal", "append", True), ("storage", "retire_below", True),
                      ("core_task", "_run", True)]) == "gc"
    # The leaf-most in-package frame decides; third-party frames are charged
    # to whichever package module called into them.
    assert attribute([("numpy_core", "dot", False), ("serde", "parse_block", True),
                      ("net_sync", "handle", True)]) == "mesh-parse"
    assert attribute([("wal", "fsync", True)]) == "wal"
    # The CUDA wrappers are the verifier hot path.
    assert attribute([("cuda", "synchronize", False), ("ed25519_cuda", "prologue", True),
                      ("ed25519", "dispatch", True)]) == "verifier-pack"
    # Nothing recognizable: other.
    assert attribute([("mystery", "f", False)]) == "other"
    assert attribute([]) == "other"


def test_thread_classes():
    assert thread_class_of("MainThread") == "loop"
    assert thread_class_of("ThreadPoolExecutor-0_0") == "verifier"
    assert thread_class_of("verify-dispatch_3") == "verifier"
    assert thread_class_of("wal-writer") == "wal"
    assert thread_class_of("dataplane-offload_0") == "offload"
    assert thread_class_of("asyncio_0") == "aux"
    assert thread_class_of("mysterious") == "aux"


# -- the accountant -----------------------------------------------------------


def _seeded_census(seed, modules, ticks=200):
    """A reproducible synthetic census over ``modules``: the determinism
    seam's test load."""
    rng = np.random.default_rng(seed)
    censuses = []
    for _ in range(ticks):
        samples = []
        for tc in ("loop", "verifier", "wal"):
            if rng.random() < 0.3:
                samples.append((tc, [("selectors", "select", False)]))
            else:
                samples.append((tc, [(modules[int(rng.integers(len(modules)))], "work", True)]))
        censuses.append(samples)
    return censuses


def test_report_deterministic_from_seeded_census():
    reports = []
    for _ in range(2):
        acct = SubsystemAccountant()
        for census in _seeded_census(42, sorted(SUBSYSTEMS)):
            acct.ingest_census(census, 1.0 / 99.0)
        reports.append(acct.report_bytes())
    assert reports[0] == reports[1]
    doc = json.loads(reports[0])
    assert doc["census_ticks"] == 200
    # Every census module resolved through the registry: fully attributed.
    assert doc["attributed_ratio"] == 1.0
    assert 0.0 < doc["gil_convoy_ratio"] <= 1.0
    assert doc["subsystem_seconds"]


def _mixed_census(seed, ticks=300):
    """A numpy-seeded census of mixed stacks: registry modules, GC and
    decode overrides, parked leaves, third-party frames above package
    frames, unknown modules, several thread names."""
    rng = np.random.default_rng(seed)
    jax = _mod("mysticeti_tpu", "profiling")
    modules = sorted(set(SUBSYSTEMS) & set(jax.SUBSYSTEMS))
    overrides = sorted(FRAME_SUBSYSTEMS)
    leaves = sorted(profiling.WAITING_LEAVES)
    names = ["MainThread", "asyncio_0", "ThreadPoolExecutor-0_0", "wal-writer",
             "dataplane-offload_0", "mysterious"]
    censuses = []
    for _ in range(ticks):
        samples = []
        for _thread in range(int(rng.integers(1, 6))):
            frames = []
            for _f in range(int(rng.integers(0, 5))):
                pick = rng.random()
                if pick < 0.5:
                    frames.append((modules[int(rng.integers(len(modules)))], "f", True))
                elif pick < 0.6:
                    frames.append((*overrides[int(rng.integers(len(overrides)))], True))
                elif pick < 0.7:
                    frames.append((*leaves[int(rng.integers(len(leaves)))], False))
                elif pick < 0.9:
                    frames.append(("numpy_core", "dot", False))
                else:
                    frames.append(("mystery", "g", bool(rng.random() < 0.5)))
            samples.append((thread_class_of(names[int(rng.integers(len(names)))]), frames))
        censuses.append((samples, float(rng.choice([0.01, 1.0 / 99.0, 0.02]))))
    return censuses


@pytest.mark.parametrize("seed", [3, 9])
def test_report_and_series_equal_the_jax_packages(seed):
    got = {}
    for pkg in PACKAGES:
        metrics = _mod(pkg, "metrics").Metrics()
        acct = _mod(pkg, "profiling").SubsystemAccountant()
        acct.bind(metrics, leaders_fn=lambda: 37)
        for i, (census, dt) in enumerate(_mixed_census(seed)):
            acct.ingest_census(census, dt)
            if i % 50 == 0:
                acct.publish()
        acct.publish()
        series = sorted((name, tuple(sorted(labels.items())), value)
                        for name, labels, value in iter_series(metrics.expose().decode())
                        if name.startswith(("mysticeti_cpu", "mysticeti_gil"))
                        and not name.endswith("_created"))
        got[pkg] = (acct.report_bytes(), series)
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    doc = json.loads(got["mysticeti_tpu"][0])
    assert {"other", "gc", "event-loop-idle", "mesh-parse"} <= set(doc["subsystem_seconds"])


def test_accountant_math_and_convoy():
    acct = SubsystemAccountant()
    idle = [("selectors", "select", False)]
    busy = [("wal", "append", True)]
    # Tick 1: one busy thread (no convoy); tick 2: two busy (convoy).
    acct.ingest_census([("loop", busy), ("wal", idle)], 0.01)
    acct.ingest_census([("loop", busy), ("wal", busy)], 0.01)
    doc = acct.report()
    assert doc["census_ticks"] == 2 and doc["convoy_ticks"] == 1
    assert doc["gil_convoy_ratio"] == 0.5
    assert doc["cpu_seconds"]["wal/loop"] == pytest.approx(0.02)
    assert doc["cpu_seconds"]["wal/wal"] == pytest.approx(0.01)
    assert doc["subsystem_seconds"]["event-loop-idle"] == pytest.approx(0.01)
    # "other" time drags the attributed ratio down.
    acct.ingest_census([("loop", [("mystery", "f", False)])], 0.01)
    assert acct.report()["attributed_ratio"] == pytest.approx(0.75)


def test_publish_exports_series():
    metrics = Metrics()
    acct = SubsystemAccountant()
    acct.bind(metrics, leaders_fn=lambda: 100)
    acct.ingest_census([("loop", [("wal", "append", True)])], 0.5)
    acct.publish()
    acct.publish()  # idempotent: deltas, not re-adds
    series = {(name, labels.get("subsystem"), labels.get("thread_class")): value
              for name, labels, value in iter_series(metrics.expose().decode())}
    assert series[("mysticeti_cpu_seconds_total", "wal", "loop")] == pytest.approx(0.5)
    # 0.5 s over 100 leaders = 5000 us a leader.
    assert series[("mysticeti_cpu_us_per_leader", "wal", None)] == pytest.approx(5000.0)


def test_sampler_census_resolves_a_busy_port_thread():
    """The real sampler on a thread spinning in a port module: its ticks
    are charged to that module's subsystem, and the env helpers write the
    folded profile, its SVG and the report."""
    import threading

    from mysticeti_tpu_torch.orchestrator import measurement

    stop = threading.Event()

    def spin():
        text = "a 1\n" * 200
        while not stop.is_set():
            list(measurement.iter_series(text))

    worker = threading.Thread(target=spin, name="mysterious")
    acct = SubsystemAccountant()
    sampler = profiling.SamplingProfiler(hz=200.0, accountant=acct).start()
    worker.start()
    time.sleep(0.5)
    stop.set()
    worker.join()
    sampler.stop()
    doc = acct.report()
    assert doc["cpu_seconds"].get("tooling/aux", 0.0) > 0.0
    assert any("measurement:iter_series" in line for line in sampler.folded())


def test_env_helpers_write_the_profile_and_report(tmp_path, monkeypatch):
    monkeypatch.setenv("MYSTICETI_PROFILE", str(tmp_path / "p-%p.folded"))
    monkeypatch.setenv("MYSTICETI_PERF_REPORT", str(tmp_path / "r-%p.json"))
    monkeypatch.setattr(profiling, "_active", None)
    sampler = profiling.start_from_env()
    assert sampler is not None and profiling.active_accountant() is sampler.accountant
    metrics = Metrics()
    profiling.bind_active(metrics, leaders_fn=lambda: 1)
    time.sleep(0.2)
    profiling.stop_from_env()
    pid = os.getpid()
    assert (tmp_path / f"p-{pid}.folded").exists() and (tmp_path / f"p-{pid}.svg").exists()
    report = json.loads((tmp_path / f"r-{pid}.json").read_text())
    assert report["census_ticks"] > 0 and "native_active" in report
    assert profiling._active is None


# -- folded-file salvage + flame diff -----------------------------------------


def test_load_folded_salvages_tmp(tmp_path):
    # A node killed before its first complete flush leaves only the tmp
    # file; load_folded falls back to it instead of dying.
    path = str(tmp_path / "prof.folded")
    with open(path + ".tmp", "w") as f:
        f.write("a;b 10\nc;d 3\ntorn-line-without-count")
    lines = profiling.load_folded(path)
    assert "a;b 10" in lines
    svg = profiling.flamegraph_svg(lines)  # the torn line is skipped, not fatal
    assert svg.startswith("<svg") and "a" in svg
    with pytest.raises(FileNotFoundError):
        profiling.load_folded(str(tmp_path / "absent.folded"))


def test_render_diff(tmp_path):
    base = tmp_path / "base.folded"
    new = tmp_path / "new.folded"
    base.write_text("main;wal:append 80\nmain;serde:parse 20\n")
    new.write_text("main;wal:append 20\nmain;serde:parse 80\n")
    out = profiling.render_diff(str(base), str(new))
    svg = open(out).read()
    assert svg.startswith("<svg")
    # Both directions of the delta palette: serde grew, wal shrank.
    assert "+60.0 pts" in svg and "-60.0 pts" in svg


def test_mkflamegraph_diff_cli(tmp_path):
    base = tmp_path / "base.folded"
    new = tmp_path / "new.folded"
    base.write_text("main;a 1\n")
    new.write_text("main;a 2\n")
    out = tmp_path / "diff.svg"
    r = _cli("--diff", base, new, out)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(out)
    assert out.exists() and out.read_text().startswith("<svg")
    assert _cli("--diff", base).returncode == 2


def _folded(seed, stacks=60):
    rng = np.random.default_rng(seed)
    frames = ["main:run", "core:add_blocks", "crypto:verify", "net:decode", "wal:append",
              "serde:parse", "<a&b>:x", "ed25519:dispatch"]
    lines = []
    for _ in range(stacks):
        depth = int(rng.integers(1, 7))
        stack = ";".join(frames[int(rng.integers(len(frames)))] for _ in range(depth))
        lines.append(f"{stack} {int(rng.integers(1, 500))}")
    lines.append("torn-line-without-count")
    return lines


@pytest.mark.parametrize("seed", [0, 4])
def test_flamegraph_svg_bytes_equal_the_jax_packages(seed):
    base, new = _folded(seed), _folded(seed + 100)
    got = {pkg: (_mod(pkg, "profiling").flamegraph_svg(new).encode(),
                 _mod(pkg, "profiling").flamegraph_svg(new, title="t", width=640).encode(),
                 _mod(pkg, "profiling").flamegraph_diff_svg(base, new).encode())
           for pkg in PACKAGES}
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    assert got["mysticeti_tpu"][0].startswith(b"<svg")


# -- tests/test_profiling.py --------------------------------------------------


def test_render_file_roundtrip_default_output(tmp_path):
    folded = tmp_path / "node.folded"
    folded.write_text(FOLDED)
    out = render_file(str(folded))
    assert out == str(tmp_path / "node.svg")
    svg = open(out).read()
    assert svg.startswith("<svg")
    assert "crypto:verify" in svg and "net:decode" in svg
    # Tooltips carry sample counts and percentages.
    assert "42 samples" in svg


def test_render_file_explicit_output_and_empty_profile(tmp_path):
    empty = tmp_path / "empty.folded"
    empty.write_text("")
    out = render_file(str(empty), str(tmp_path / "custom.svg"))
    assert out == str(tmp_path / "custom.svg")
    svg = open(out).read()
    # No division by zero; a valid (if trivial) SVG is still produced.
    assert svg.startswith("<svg") and svg.rstrip().endswith("</svg>")


def test_flamegraph_svg_ignores_malformed_lines():
    svg = flamegraph_svg(["not-a-folded-line", "a;b 3", ""])
    assert "a" in svg and "3 samples" in svg


def test_mkflamegraph_cli_roundtrip(tmp_path):
    folded = tmp_path / "node.folded"
    folded.write_text(FOLDED)
    out = tmp_path / "flame.svg"
    proc = _cli(folded, out)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(out)
    assert open(out).read().startswith("<svg")


def test_mkflamegraph_cli_usage_error():
    proc = _cli()
    assert proc.returncode == 2
    assert "Usage" in proc.stderr or "usage" in proc.stderr


# -- the blocking-call detector -----------------------------------------------


class _FakeWal:
    def pending(self):
        return False


class _FakeStore:
    def last_seen_by_authority(self, a):
        return 0


class _FakeCore:
    authority = 0
    wal_writer = _FakeWal()
    block_store = _FakeStore()

    def current_round(self):
        return 0


class _FakeObserver:
    class _Interp:
        last_height = 0

    commit_interpreter = _Interp()


def test_blocking_call_detector_catches_planted_sleep():
    """A planted >= 50 ms synchronous hold on the core owner surfaces as a
    blocking-call SLO alert and a flight-recorder event; fast commands do
    not trip it."""
    metrics = Metrics()
    recorder = FlightRecorder(authority=0)
    monitor = HostMonitor(metrics=metrics, recorder=recorder, blocking_threshold_ms=50.0)
    dispatcher = CoreTaskDispatcher(object())
    dispatcher.blocking_monitor = monitor

    def planted_sleep():
        time.sleep(0.06)
        return "done"

    def fast():
        return "ok"

    async def drive():
        dispatcher.start()
        for _ in range(5):
            assert await dispatcher._call(fast) == "ok"
        assert await dispatcher._call(planted_sleep) == "done"
        dispatcher.stop()

    asyncio.run(drive())
    assert monitor.blocking_total == 1  # the sleep, not the fast commands
    events = [e for e in recorder.events() if e["kind"] == "blocking-call"]
    assert len(events) == 1
    assert events[0]["site"] == "core:planted_sleep"
    assert events[0]["ms"] >= 50.0
    probe = HealthProbe(0, 4, metrics=metrics, slo=SLOThresholds(max_blocking_call_ms=50.0),
                        clock=lambda: 0.0)
    probe.attach(core=_FakeCore(), commit_observer=_FakeObserver(), host_monitor=monitor)
    snapshot = probe.sample()
    assert [a["kind"] for a in snapshot.get("alerts", [])] == ["blocking-call"]
    assert snapshot["host"]["last_blocking"]["site"] == "core:planted_sleep"
    # The drain re-arms the alert: a clean next sample clears it.
    assert not probe.sample().get("alerts")
    text = metrics.expose().decode()
    assert 'mysticeti_blocking_calls_total{site="core:planted_sleep"} 1.0' in text


def test_loop_lag_probe_measures_a_blocked_loop():
    async def drive():
        probe = LoopLagProbe(interval_s=0.01).start()
        await asyncio.sleep(0.05)
        time.sleep(0.08)  # hold the loop: the next callback fires late
        await asyncio.sleep(0.03)
        probe.stop()
        return probe

    probe = asyncio.run(drive())
    assert probe.sample_count() >= 3
    assert probe.percentile(99) >= 0.05  # saw the 80 ms hold


def test_host_monitor_state_shape():
    monitor = HostMonitor(blocking_threshold_ms=50.0)
    state = monitor.state()
    assert state["loop_lag_samples"] == 0
    assert state["blocking_calls"] == 0
    assert state["last_blocking"] is None
    assert state["blocking_threshold_ms"] == 50.0
    assert monitor.drain_worst_blocking_ms() == 0.0
    # A sub-threshold command is not a blocking call.
    monitor.note_command("core:fast", 0.001)
    assert monitor.blocking_total == 0


# -- zero false positives under the clean seeded sim --------------------------


def test_clean_sim_no_host_false_positives(tmp_path):
    """A clean seeded 10-node sim of the port's nodes with the host SLOs
    armed and a ``HostMonitor`` on every probe and every dispatcher raises
    no loop-lag or blocking-call alert: under virtual time the probe and
    the dispatcher's measurement stay off, so the host blocks are
    all-zero."""
    from test_torch_net_sync import build_node

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.simulated_network import SimulatedNetwork

    n = 10
    alerts = []

    async def drive():
        committee = Committee.new_test([1] * n)
        signers = Committee.benchmark_signers(n)
        sim_net = SimulatedNetwork(n)
        nodes = [build_node("mysticeti_tpu_torch", committee, signers, a, str(tmp_path),
                            sim_net, Parameters(leader_timeout_s=1.0)) for a in range(n)]
        slo = SLOThresholds(max_loop_lag_s=0.25, max_blocking_call_ms=50.0)
        probes = []
        for a, node in enumerate(nodes):
            monitor = HostMonitor(blocking_threshold_ms=50.0).start()
            node.dispatcher.blocking_monitor = monitor
            probes.append(HealthProbe(a, n, slo=slo).attach(
                core=node.core, commit_observer=node.syncer.commit_observer,
                host_monitor=monitor))
        for node in nodes:
            await node.start()
        await sim_net.connect_all()
        for _ in range(20):
            await asyncio.sleep(1.0)
            for probe in probes:
                snapshot = probe.sample()
                alerts.extend(snapshot.get("alerts", []))
                host = snapshot["host"]
                assert host["loop_lag_samples"] == 0
                assert host["blocking_calls"] == 0
        for node in nodes:
            await node.stop()
        sim_net.close()
        return nodes

    nodes = run_simulation(drive(), seed=7)
    committed = [len(list(node.syncer.commit_observer.committed_leaders)) for node in nodes]
    assert all(c > 0 for c in committed), committed  # the sim did real work
    assert [a["kind"] for a in alerts if a["kind"] in ("loop-lag", "blocking-call")] == []
