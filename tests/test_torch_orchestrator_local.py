"""A local fleet through the port's ``Orchestrator`` (its own file: it boots
node processes, and under ``--dist loadfile`` a file is one worker's).

Counterpart of ``tests/test_orchestrator.py::test_local_benchmark_end_to_end``
(:184): three ``python -m mysticeti_tpu_torch run`` processes started by
``LocalProcessRunner`` on the ``cpu`` kind (the runner's default,
``cuda-only``, needs a card), one fixed-load run with two scrape cycles.
The fleet is moved to free ports (``config.DEFAULT_PORT_BASE``, which
genesis writes into ``parameters.yaml``): the JAX package's test holds
``benchmark-genesis``'s 1500-1502 while it runs.  Also here: the checks of
``chip_smoke.py``'s orchestrator phase on a healthy run and on each fault
they must catch, and the launch hook the phase puts in the verifier
service.
"""
import asyncio
import os

import pytest

from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.orchestrator import LoadType, MeasurementsCollection, ParametersGenerator
from mysticeti_tpu_torch.orchestrator.logs import analyze_logs
from mysticeti_tpu_torch.orchestrator.orchestrator import Orchestrator
from mysticeti_tpu_torch.orchestrator.plot import plot_latency_throughput
from mysticeti_tpu_torch.orchestrator.runner import LocalProcessRunner
from test_torch_cli import _free_port_base


def test_local_benchmark_end_to_end(tmp_path, monkeypatch):
    """Short real benchmark: 3 local validator subprocesses, two scrape
    cycles, a saved and reloadable collection with tps > 0."""
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", _free_port_base(3))
    results = tmp_path / "results"

    async def main():
        runner = LocalProcessRunner(str(tmp_path / "fleet"), tps_per_node=20, verifier="cpu")
        gen = ParametersGenerator(3, LoadType.fixed([60]), duration_s=14.0)
        orch = Orchestrator(runner, gen, results_dir=str(results), scrape_interval_s=7.0)
        collections = await orch.run_benchmarks()
        assert runner.processes == {} and runner._verifier_service is None
        return collections

    # One retry: subprocess validators at a fixed 14s budget are sensitive to
    # machine load (e.g. concurrent XLA compiles in a full-suite run).
    for attempt in range(2):
        collections = asyncio.run(main())
        assert len(collections) == 1
        c = collections[0]
        if c.scrapers and c.aggregate_tps() > 0:
            break
    assert c.scrapers, "no scrapes succeeded"
    assert c.benchmark_duration() > 0
    assert c.aggregate_tps() > 0, c.display_summary()
    assert c.parameters == {"nodes": 3, "load": 60, "duration_s": 14.0,
                            "faults": {"kind": "none", "faults": 0, "interval_s": 60.0}}
    assert os.path.exists(str(results / "measurements-0.json"))
    # The run ships with its own diagnosis (health plane): the cluster
    # snapshot timeline rode the scrape loop, persisted, and summarizes.
    assert c.health_samples, "no fleet health snapshots recorded"
    snap = c.health_samples[-1]
    assert set(snap["reachable"]) <= {"0", "1", "2"}
    assert "quorum_participation" in snap and "straggler_score" in snap
    # psutil is installed here: the host series rode along.
    assert c.host_samples and c.host_summary()["samples"] == len(c.host_samples)
    reloaded = MeasurementsCollection.load(str(results / "measurements-0.json"))
    assert reloaded.health_samples == c.health_samples
    assert reloaded.health_summary() is not None
    assert reloaded.aggregate_tps() == c.aggregate_tps()
    assert "fleet health" in c.display_summary()
    logs = tmp_path / "fleet"
    analysis = analyze_logs(str(logs))
    assert sorted(analysis.node_crashes) == ["node-0.log", "node-1.log", "node-2.log"]
    assert analysis.total_crashes == 0
    written = plot_latency_throughput(collections, str(results / "latency-throughput"))
    assert written[0].endswith(".txt") and "3 nodes" in open(written[0]).read()


def _service(final, warm=None):
    """The report ``FLEET_HOOK`` makes a verifier service write when it is
    stopped: its launch counts once warm and at the stop."""
    warm = warm if warm is not None else {"prologue": 3, "verify_generic": 1, "verify_keyed": 2,
                                          "prologue_flat": 0}
    return {"pid": 100, "start": 1.0, "end": 20.0, "warm": warm, "final": final,
            "cuda_initialized": True}


def _phase_run(n=4, **over):
    """A collection and a run record as ``chip_smoke.runner_tap`` leaves
    them for a healthy run of ``n`` nodes."""
    import numpy as np

    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.orchestrator import Measurement

    texts = {}
    for a in range(n):
        m = Metrics()
        m.observe_latency_batch("shared", np.array([0.2, 0.4, 0.6]))
        m.benchmark_duration.inc(5.0)
        m.verify_dispatch_batch_size.observe(3)
        texts[a] = m.expose().decode()
    c = MeasurementsCollection({"nodes": n, "load": 400})
    for _tick in range(2):
        for a in range(n):
            c.add(str(a), Measurement.from_prometheus(texts[a], "shared"))
    c.add_health_sample({"reachable": [str(a) for a in range(n)], "status": "ok"})
    run = {"load": 400, "apps_before": ["1, 600 MiB"], "ticks": [["1, 600 MiB"] * 2] * 2,
           "texts": texts, "service_boot_s": 5.0, "wall_s": 14.0,
           "service": _service({"prologue": 3 + n, "verify_generic": 1, "verify_keyed": 2 + n,
                                "prologue_flat": 0})}
    for key, value in over.items():
        run[key] = value
    return c, run


def test_orchestrator_phase_checks(tmp_path):
    """``chip_smoke.orchestrator_run_checks`` passes a healthy run and fails
    each fault the phase must catch."""
    import chip_smoke

    config = dict(chip_smoke.ORCHESTRATOR_10, n=4)
    c, run = _phase_run()
    path = str(tmp_path / "m.json")
    c.save(path)
    reading = chip_smoke.orchestrator_run_checks(c, run, path, config)
    assert reading["service_launches"] == {"prologue": 4, "verify_generic": 0,
                                           "verify_keyed": 4, "prologue_flat": 0}
    assert reading["tps"] == 3 / 5.0 and reading["live_lanes"] == 3.0
    faults = {
        "launched the generic kernel": {"service": _service({
            "prologue": 8, "verify_generic": 2, "verify_keyed": 6})},
        "compute processes on the card": {"ticks": [["1, 600 MiB"] * 3] * 2},
        "not one prologue and one keyed launch": {"service": _service({
            "prologue": 5, "verify_generic": 1, "verify_keyed": 4})},
        "never warmed on the card": {"service": dict(_service({}), warm=None)},
    }
    for message, over in faults.items():
        c, run = _phase_run(**over)
        c.save(path)
        with pytest.raises(chip_smoke.SmokeFailure, match=message):
            chip_smoke.orchestrator_run_checks(c, run, path, config)
    c, run = _phase_run()
    other = str(tmp_path / "other.json")
    MeasurementsCollection({"nodes": 1}).save(other)
    with pytest.raises(chip_smoke.SmokeFailure, match="does not load back equal"):
        chip_smoke.orchestrator_run_checks(c, run, other, config)
    c, run = _phase_run()
    c.scrapers["3"] = c.scrapers["3"][:1]
    c.save(path)
    with pytest.raises(chip_smoke.SmokeFailure, match="scrapes by node"):
        chip_smoke.orchestrator_run_checks(c, run, path, config)


def test_orchestrator_phase_launch_hook(tmp_path):
    """The phase's ``sitecustomize`` (``chip_smoke.FLEET_HOOK``) and
    ``runner_tap``'s reading of it: the runner's ``cleanup`` stops a child
    whose command line names ``verifier-service`` with SIGTERM, the hook
    writes the child's launch report and the child exits 0, and the tap
    keeps the report as its run's ``service``; the site's own
    ``sitecustomize`` further down the path still runs."""
    import sys
    import time

    import chip_smoke
    from mysticeti_tpu_torch.orchestrator.runner import LocalProcessRunner

    hook, site, out, wd = (tmp_path / d for d in ("hook", "site", "out", "wd"))
    for d in (hook, site, out, wd):
        d.mkdir()
    (hook / "sitecustomize.py").write_text(chip_smoke.FLEET_HOOK)
    (site / "sitecustomize.py").write_text(
        f"open({str(out / 'chained')!r}, 'w').close()\n")
    env = dict(os.environ, PYTHONPATH=f"{hook}{os.pathsep}{site}", SMOKE_FLEET_DIR=str(out))
    runner = chip_smoke.runner_tap(LocalProcessRunner)(
        str(wd), verifier="cpu", report_dir=str(out), watch={})

    async def drive():
        child = await asyncio.create_subprocess_exec(
            sys.executable, "-c", "import time; time.sleep(30)", "verifier-service", env=env)
        for _ in range(200):
            if (out / "chained").exists():
                break
            await asyncio.sleep(0.05)
        runner._verifier_service = child
        runner.runs.append({"service_pid": child.pid, "t0": time.monotonic()})
        await runner.cleanup()
        return child

    child = asyncio.run(drive())
    assert (out / "chained").exists()
    assert child.returncode == 0
    service = runner.runs[0]["service"]
    assert service["pid"] == child.pid and service["start"] <= service["end"]
    assert service["warm"] is None and service["final"] == {}
    assert service["cuda_initialized"] is False
    assert runner._verifier_service is None and runner.runs[0]["wall_s"] >= 1.0
