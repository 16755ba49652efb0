"""``chip_smoke.py``'s step 23 off the card: ``fleet_bench_checks`` passes a
healthy reading of each fleet bench and fails each fault it must catch (a
generic launch, a node's CUDA context, a second context on the card, a
batch degraded to the CPU oracle, an invalid block, a broken determinism
digest, a service that never reported, ...); the ``FLEET_HOOK``
``sitecustomize`` reports a verifier service's launches from its warm state
when SIGTERM stops it, and a node's start, in children."""
import copy
import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

WARM = {"prologue": 4, "prologue_flat": 0, "verify_generic": 1, "verify_keyed": 3}
DIGEST = chip_smoke.OVERLOAD_SEEDED["shed_schedule_digest"]


def _fleet(nodes, flushes=120, submitted=0):
    return {"verifier_fallback": 0, "invalid_blocks": 0, "flushes": flushes,
            "dispatched_lanes": 3 * flushes, "submitted": submitted, "scraped_nodes": nodes}


def _service(pid, start, end, served=150):
    return {"pid": pid, "start": start, "end": end, "warm": dict(WARM), "cuda_initialized": True,
            "final": {k: v + (served if k in ("prologue", "verify_keyed") else 0)
                      for k, v in WARM.items()}}


def _run(module, doc, windows):
    """A run of ``module`` as ``run_fleet_tool`` returns it: one verifier
    service a window, the card's processes sampled every 5 s (this script's
    and the tool's, plus each live service)."""
    services = [_service(100 + i, start, end) for i, (start, end) in enumerate(windows)]
    samples = [(t, 2 + sum(1 for s, e in windows if s + 2 <= t <= e)) for t in range(0, 80, 5)]
    return {"name": module.replace("_", "-"), "module": module, "args": [], "port_base": 20000,
            "rc": 0, "out": "", "err": "", "seconds": 80.0, "window": [0.0, 80.0],
            "apps_before": 1, "samples": samples, "doc": doc, "services": services,
            "service_starts": [{"pid": s["pid"]} for s in services], "nodes": 8,
            "node_cuda": []}


def _probe(nodes=4, load=400):
    return {"offered_load_tx_s": load, "tps": 800.0, "avg_latency_s": 0.3,
            "stdev_latency_s": 0.4, "fleet": _fleet(nodes)}


def _search(verifier):
    run = {"verifier": verifier, "nodes": 4, "max_sustainable_load_tx_s": 400,
           "peak_committed_tx_s": 800.0, "probes": [_probe()]}
    return run


def healthy(module):
    if module == "maxload_bench":
        run = dict(_search("cuda-only"), cpu_reference_probe=dict(_probe(load=800),
                                                                  verifier="cpu"),
                   peak_vs_same_window_cpu=0.92)
        return _run(module, {"card": "x", "runs": [run]}, [(10, 30)])
    if module == "chip_window_ab":
        return _run(module, {"card": "x", "backend": "cuda", "tpu_over_cpu": 1.0,
                             "runs": [_search("cpu"), _search("cuda-only")]}, [(40, 60)])
    if module == "node_bench":
        doc = {"card": "x", "runs": [{"verifier": "cuda-only", "nodes": 4, "committed_tx_s": 250.0,
                                      "avg_latency_s": 0.3, "fleet": _fleet(4)}],
               "verifier_saturation": [{"verifier": "cuda-only", "batch": 4096,
                                        "sig_per_sec": 1.2e6, "iterations": 5, "all_valid": True,
                                        "launches": {"prologue": 6, "prologue_flat": 0,
                                                     "verify_generic": 0, "verify_keyed": 6}}]}
        return _run(module, doc, [(10, 40)])
    if module == "catchup_bench":
        doc = {"card": "x", "runs": [{
            "verifier": "cuda-only", "nodes": 7, "steady_tps": 3100.0, "backlog_rounds": 210,
            "reboot_to_metrics_s": 1.2, "reboot_to_first_verify_s": 2.5,
            "reboot_to_caught_up_s": 6.0, "first_verify_measures": "reconnection",
            "catchup_verification": {"direct": 1800, "skipped": 0, "rejected": 0,
                                     "skip_frac": 0.0},
            "health_after_recovery": {"reachable": [str(a) for a in range(7)],
                                      "status": "degraded"},
            "fleet": _fleet(7), "victim_at_finish": dict(_fleet(1, 20), dispatched_lanes=400)}]}
        return _run(module, doc, [(5, 70)])
    seeded = {k: v for k, v in chip_smoke.OVERLOAD_SEEDED.items()
              if k != "shed_schedule_digest"}
    rungs = [{"multiplier": m, "offered_tx_s": 3000 * m, "committed_tx_s": 2900.0,
              "committed_over_offered": round(2900 / (3000 * m), 3), "avg_latency_s": 0.5,
              "admitted_total": 20000,
              "shed_total": {"admission": 9000 * (m - 1), "soft_cap_deferred": 120},
              "seconds": 9.0, "fleet": _fleet(4, submitted=20000 + 9000 * (m - 1))}
             for m in (1, 3)]
    doc = {"card": "x", "verifier": "cuda-only", "nodes": 4, "rungs": rungs,
           "determinism": dict(seeded, byte_identical=True, shed_schedule_digest_run1=DIGEST,
                               shed_schedule_digest_run2=DIGEST),
           "acceptance": {"committed_3x_over_1x": 1.0, "no_collapse": True,
                          "sim_no_collapse": True, "shed_schedule_byte_identical": True}}
    return _run(module, doc, [(5, 25), (30, 50)])


MODULES = ("maxload_bench", "chip_window_ab", "node_bench", "catchup_bench", "overload_bench")


@pytest.mark.parametrize("module", MODULES)
def test_a_healthy_reading_passes(module):
    run = healthy(module)
    reading = chip_smoke.fleet_bench_checks(run)
    services = len(run["services"])
    assert reading["services"] == services
    assert reading["service_launches"] == {"prologue": 150 * services, "prologue_flat": 0,
                                           "verify_generic": 0, "verify_keyed": 150 * services}
    extra = 6 if module == "node_bench" else 0
    assert reading["launches"]["verify_keyed"] == 150 * services + extra
    assert reading["compute_apps"] == {"before": 1, "max": 3, "samples": 16}


def _set(run, path, value):
    target = run
    for key in path[:-1]:
        target = target[key]
    target[path[-1]] = value


FAULTS = [
    ("maxload_bench", ("services", 0, "final", "verify_generic"), 2,
     "launched the generic kernel"),
    ("maxload_bench", ("node_cuda",), [{"pid": 7}], "nodes initialized CUDA"),
    ("maxload_bench", ("samples", 3), (15, 4), "a node or a second service opened a context"),
    ("maxload_bench", ("doc", "runs", 0, "probes", 0, "fleet", "verifier_fallback"), 3,
     "degraded to the CPU oracle"),
    ("maxload_bench", ("doc", "runs", 0, "cpu_reference_probe", "fleet", "invalid_blocks"), 1,
     "invalid blocks"),
    ("maxload_bench", ("doc", "runs", 0, "probes", 0, "tps"), 0.0, "tps 0.0"),
    ("maxload_bench", ("services",), [], "reported their launches"),
    ("maxload_bench", ("services", 0, "final", "verify_keyed"), 200,
     "not one prologue and one keyed launch"),
    ("maxload_bench", ("rc",), 1, "the tool exited 1"),
    ("chip_window_ab", ("doc", "backend"), "cpu", "backend cpu"),
    ("chip_window_ab", ("samples",), [(t, 2) for t in range(0, 80, 5)],
     "never showed the tool's and a verifier service's contexts"),
    ("node_bench", ("doc", "verifier_saturation", 0, "launches", "verify_generic"), 1,
     "saturation cuda-only launched"),
    ("node_bench", ("doc", "verifier_saturation", 0, "all_valid"), False,
     "rejected a valid signature"),
    ("catchup_bench", ("doc", "runs", 0, "reboot_to_caught_up_s"), None, "did not catch up"),
    ("catchup_bench", ("doc", "runs", 0, "catchup_verification", "skipped"), 40, "skipped 40"),
    ("catchup_bench", ("doc", "runs", 0, "health_after_recovery", "reachable"), ["0"],
     "health snapshot after recovery reached"),
    ("overload_bench", ("doc", "determinism", "shed_schedule_digest_run2"), "0" * 64,
     "differs from OVERLOAD_SEEDED"),
    ("overload_bench", ("doc", "determinism", "sim_admitted_3x"), 15684,
     "differs from OVERLOAD_SEEDED"),
    ("overload_bench", ("doc", "rungs", 1, "admitted_total"), 10 ** 6, "offered"),
    ("overload_bench", ("doc", "rungs", 0, "fleet", "submitted"), 20001,
     "against 20001 submitted"),
    ("overload_bench", ("doc", "rungs", 1, "fleet", "submitted"), 0, "against 0 submitted"),
    ("overload_bench", ("doc", "rungs", 1, "shed_total", "admission"), 9000,
     "against 38000 submitted"),
]


@pytest.mark.parametrize("module,path,value,message", FAULTS,
                         ids=[f"{m}:{msg}" for m, _, _, msg in FAULTS])
def test_each_fault_fails_the_step(module, path, value, message):
    run = copy.deepcopy(healthy(module))
    _set(run, path, value)
    with pytest.raises(chip_smoke.SmokeFailure, match=message):
        chip_smoke.fleet_bench_checks(run)


def test_an_overload_collapse_passes_only_as_the_tool_reports_it():
    run = healthy("overload_bench")
    run["rc"] = 3
    with pytest.raises(chip_smoke.SmokeFailure, match="the tool exited 3"):
        chip_smoke.fleet_bench_checks(run)
    run["doc"]["acceptance"]["no_collapse"] = False
    assert chip_smoke.fleet_bench_checks(run)["exit_code"] == 3


def _wait_for(path, seconds=30.0):
    deadline = time.monotonic() + seconds
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    return os.path.exists(path)


def test_fleet_hook_reports_a_service_and_a_node(tmp_path):
    """A child whose command line names ``verifier-service``: the hook
    snapshots the launch counts when ``VerifierServer._calibrate`` returns
    and, on SIGTERM, writes them with the counts then and exits 0.  A
    ``python -m mysticeti_tpu_torch run`` child leaves its start report and
    no CUDA report; the site's own ``sitecustomize`` still runs."""
    hook, site, out = (tmp_path / d for d in ("hook", "site", "out"))
    for d in (hook, site, out):
        d.mkdir()
    (hook / "sitecustomize.py").write_text(chip_smoke.FLEET_HOOK)
    (site / "sitecustomize.py").write_text(
        "import os\n"
        f"open(os.path.join({str(out)!r}, 'chained-%d' % os.getpid()), 'w').close()\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(hook), str(site), REPO]),
               SMOKE_FLEET_DIR=str(out))
    service_code = (
        "import time\n"
        "from mysticeti_tpu_torch import verifier_service as v\n"
        "from mysticeti_tpu_torch.ops import ed25519_cuda as K\n"
        "K.PROLOGUE.launches, K.VERIFY_GENERIC.launches, K.VERIFY_KEYED.launches = 3, 1, 2\n"
        "class Server:\n"
        "    _keys = None\n"
        "v.VerifierServer._calibrate(Server())\n"
        "K.PROLOGUE.launches += 5\n"
        "K.VERIFY_KEYED.launches += 5\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n")
    child = subprocess.Popen([sys.executable, "-c", service_code, "verifier-service"], env=env,
                             cwd=str(tmp_path), stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "ready"
        child.send_signal(signal.SIGTERM)
        assert child.wait(30) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    reports = chip_smoke.fleet_reports(str(out))
    start, = reports["service_starts"]
    report, = reports["services"]
    assert report["pid"] == start["pid"] == child.pid
    assert report["warm"] == {"prologue": 3, "prologue_flat": 0, "verify_generic": 1,
                              "verify_keyed": 2}
    assert report["final"] == {"prologue": 8, "prologue_flat": 0, "verify_generic": 1,
                               "verify_keyed": 7}
    assert report["cuda_initialized"] is False and report["start"] <= report["end"]
    assert (out / f"chained-{child.pid}").exists()
    node = subprocess.run([sys.executable, "-m", "mysticeti_tpu_torch", "run", "--help"],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert node.returncode == 0, node.stderr[-2000:]
    reports = chip_smoke.fleet_reports(str(out))
    assert reports["nodes"] == 1 and reports["node_cuda"] == []
    assert len(list(out.glob("chained-*"))) == 2
    assert json.loads(next(out.glob("node-*.start.json")).read_text())["start"] > 0


def test_the_calibration_rung_is_a_card_fleet():
    """``overload_bench`` at its defaults calibrates first: that rung's
    fleet has a verifier service of its own."""
    run = healthy("overload_bench")
    doc = run["doc"]
    doc["calibration"] = dict(doc["rungs"][0], offered_tx_s=120000)
    with pytest.raises(chip_smoke.SmokeFailure, match="for 3 card fleets"):
        chip_smoke.fleet_bench_checks(run)
    windows = [(5, 25), (30, 50), (55, 75)]
    run["services"] = [_service(100 + i, s, e) for i, (s, e) in enumerate(windows)]
    run["service_starts"] = [{"pid": s["pid"]} for s in run["services"]]
    assert chip_smoke.fleet_bench_checks(run)["services"] == 3
