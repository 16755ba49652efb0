"""``chip_smoke.py``'s step 24 off the card: ``last_tool_checks`` passes a
healthy document of each of the last tools and fails each fault it must
catch (a generic launch, a missing keyed launch, a node's CUDA context, a
batch degraded to the CPU oracle, an invalid block, reuse under the legacy
knob, a zero-copy receiver under it, a fallback arm that ran native, a
joiner that never committed, a missed epoch, a fork, a root the client saw
that no node has, unequal digests, a sim off its seeded constant);
``apps_checks`` bounds the card's contexts by the tool's and its live
services'; ``Beside`` runs its queue from the ``with`` block's start and
hands back results or an error, and a failure beside it kills the tools'
process groups."""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
WARM = {"prologue": 4, "prologue_flat": 0, "verify_generic": 1, "verify_keyed": 3}


def _launches(n):
    return {"prologue": n, "prologue_flat": 0, "verify_generic": 0, "verify_keyed": n}


def _service(pid, start, end, served=300):
    return {"pid": pid, "start": start, "end": end, "warm": dict(WARM), "cuda_initialized": True,
            "final": {k: v + (served if k in ("prologue", "verify_keyed") else 0)
                      for k, v in WARM.items()}}


def _run(module, doc, services=()):
    return {"name": module, "module": module, "args": [], "port_base": 20000, "rc": 0,
            "out": "", "err": "", "seconds": 40.0, "window": [0.0, 40.0], "apps_before": 1,
            "samples": [(t, 2 + len(services)) for t in range(5, 40, 5)], "doc": doc,
            "services": list(services), "service_starts": [{"pid": s["pid"]} for s in services],
            "nodes": 4, "node_cuda": []}


def _fleet_counters(flushes=250):
    return {"verifier_fallback": 0, "invalid_blocks": 0, "flushes": flushes,
            "dispatched_lanes": 3 * flushes, "submitted": 9000, "scraped_nodes": 4}


def healthy(module):
    doc = {"card": CARD, "verifier": "cuda-only"}
    if module == "mesh_ab":
        doc["runs"] = {mode: [{
            "mode": mode, "receivers_attached": 0 if mode == "legacy" else 12,
            "launches": _launches(400),
            "nodes": [{"committed_leaders": 40 + a, "encode_reuse_total": 0 if mode == "legacy"
                       else 30 + a} for a in range(4)]}] for mode in ("legacy", "mesh")}
        doc.update(comparison={"committed_leaders_mean": {"legacy": 41.5, "mesh": 42.0},
                               "mesh_encode_us_per_leader": {"legacy": 90.0, "mesh": 40.0},
                               "critical_path_p50_us": {}},
                   acceptance={"encode_reuse_on_every_node": True}, microbench={"speedup": 4.0})
        return _run(module, doc)
    if module == "dataplane_ab":
        doc["runs"] = {mode: [{"committed_leaders_by_node": {str(a): 50 for a in range(4)},
                               "exit_codes": {str(a): 0 for a in range(4)},
                               "verifier_fallback_by_node": {str(a): 0 for a in range(4)}}]
                       for mode in ("fallback", "native")}
        doc.update(comparison={"committed_leaders_mean": {}, "hotpath_us_per_leader": {},
                               "hotpath_cpu_reduction_pct": 0.0,
                               "native_active": {"fallback": [], "native": ["split_frames"]}},
                   acceptance={}, microbench={"combined_speedup_passes": [2.1, 2.0, 2.2]})
        return _run(module, doc, [_service(90, 1.0, 39.0, served=700)])
    if module == "reconfig_matrix":
        doc["live"] = {"passed": True, "epochs_reached": 2, "joiner_commits": 300,
                       "prefix_consistent": True, "verifier": "cuda-only",
                       "epochs": {str(a): 2 for a in range(4)},
                       "commits": {"0": 300, "1": 300, "2": 200, "3": 300},
                       "launches": _launches(900)}
        return _run(module, doc)
    fleet = {"nodes": 4, "verifier": "cuda-only", "fleet": _fleet_counters()}
    services = [_service(100, 5.0, 30.0)]
    if module == "finality_bench":
        fleet.update(decisions_recorded_all_nodes=True, per_node={}, server={}, client={},
                     cross_check={})
        sim = dict(chip_smoke.FINALITY_SEEDED, verifier="cuda-only", every_slot_explained=True,
                   holes=[], byte_identical=True, duration_s=chip_smoke.SEEDED_SIM_S,
                   launches=_launches(3000))
    else:
        fleet.update(root_agreement={"agree": True, "forks": [], "shared_heights": 16},
                     all_nodes_executed=True, executed_height_min=400, executed_height_max=420,
                     executed_tx_s=35.0, client={"submitted": 500},
                     subscriber={"resume_reply": {"height": 0}, "executed_notifications": 400})
        sim = dict(chip_smoke.EXEC_SEEDED, verifier="cuda-only", passed=True, execution_ok=True,
                   byte_identical=True, duration_s=chip_smoke.SEEDED_SIM_S,
                   launches=_launches(6000))
    doc.update(fleet=fleet, sim=sim, acceptance={})
    return _run(module, doc, services)


MODULES = ("mesh_ab", "dataplane_ab", "reconfig_matrix", "finality_bench", "execution_bench")
EXPECTED = {"mesh_ab": 800, "dataplane_ab": 700, "reconfig_matrix": 900,
            "finality_bench": 3300, "execution_bench": 6300}


def _check(run):
    return chip_smoke.last_tool_checks(run, CARD)


@pytest.mark.parametrize("module", MODULES)
def test_a_healthy_reading_passes(module):
    reading = _check(healthy(module))
    assert reading["launches"] == _launches(EXPECTED[module])


def _set(doc, path, value):
    for key in path[:-1]:
        doc = doc[key]
    doc[path[-1]] = value


FAULTS = [
    ("mesh_ab", ("runs", "legacy", 0, "nodes", 2, "encode_reuse_total"), 3, "encode reuse"),
    ("mesh_ab", ("runs", "legacy", 0, "receivers_attached"), 4, "receivers attached"),
    ("mesh_ab", ("runs", "mesh", 0, "nodes", 1, "encode_reuse_total"), 0, "encode reuse"),
    ("mesh_ab", ("runs", "mesh", 0, "receivers_attached"), 0, "receivers attached"),
    ("mesh_ab", ("runs", "mesh", 0, "nodes", 0, "committed_leaders"), 0, "committed nothing"),
    ("mesh_ab", ("runs", "legacy", 0, "launches", "verify_generic"), 1, "generic"),
    ("mesh_ab", ("runs", "mesh", 0, "launches", "verify_keyed"), 399, "one prologue"),
    ("mesh_ab", ("card",), None, "card"),
    ("dataplane_ab", ("comparison", "native_active", "fallback"), ["split_frames"],
     "native_active"),
    ("dataplane_ab", ("comparison", "native_active", "native"), None, "native_active"),
    ("dataplane_ab", ("runs", "native", 0, "committed_leaders_by_node", "3"), 0,
     "committed leaders"),
    ("dataplane_ab", ("runs", "fallback", 0, "verifier_fallback_by_node", "1"), 2, "degraded"),
    ("dataplane_ab", ("runs", "fallback", 0, "exit_codes", "0"), None, "exit codes"),
    ("reconfig_matrix", ("live", "joiner_commits"), 0, "live leg"),
    ("reconfig_matrix", ("live", "epochs_reached"), 1, "live leg"),
    ("reconfig_matrix", ("live", "prefix_consistent"), False, "live leg"),
    ("reconfig_matrix", ("live", "launches", "verify_generic"), 2, "generic"),
    ("reconfig_matrix", ("verifier",), "cpu", "kind"),
    ("finality_bench", ("fleet", "decisions_recorded_all_nodes"), False, "no decision"),
    ("finality_bench", ("sim", "digest"), "00" * 32, "FINALITY_SEEDED"),
    ("finality_bench", ("sim", "byte_identical"), False, "FINALITY_SEEDED"),
    ("finality_bench", ("sim", "every_slot_explained"), False, "FINALITY_SEEDED"),
    ("finality_bench", ("fleet", "fleet", "verifier_fallback"), 1, "last scrapes"),
    ("finality_bench", ("fleet", "fleet", "invalid_blocks"), 3, "last scrapes"),
    ("finality_bench", ("fleet", "fleet", "flushes"), 301, "for the nodes'"),
    ("finality_bench", ("sim", "launches", "verify_generic"), 1, "generic"),
    ("finality_bench", ("fleet", "verifier"), "cpu", "legs on"),
    ("execution_bench", ("fleet", "root_agreement", "agree"), False, "roots"),
    ("execution_bench", ("fleet", "all_nodes_executed"), False, "roots"),
    ("execution_bench", ("fleet", "subscriber", "resume_reply"), None, "roots"),
    ("execution_bench", ("sim", "root_chain_digest"), "11" * 32, "EXEC_SEEDED"),
    ("execution_bench", ("sim", "chain_length"), 12, "EXEC_SEEDED"),
    ("execution_bench", ("sim", "byte_identical"), False, "EXEC_SEEDED"),
    ("execution_bench", ("sim", "passed"), False, "EXEC_SEEDED"),
]


@pytest.mark.parametrize("module,path,value,message", FAULTS)
def test_each_fault_fails(module, path, value, message):
    run = healthy(module)
    _set(run["doc"], path, value)
    with pytest.raises(chip_smoke.SmokeFailure, match=message):
        _check(run)


@pytest.mark.parametrize("module", MODULES)
def test_run_faults_fail(module):
    run = healthy(module)
    run["node_cuda"] = [{"pid": 7}]
    with pytest.raises(chip_smoke.SmokeFailure, match="initialized CUDA"):
        _check(run)
    run = healthy(module)
    run["rc"] = 1 if module != "reconfig_matrix" else 3
    with pytest.raises(chip_smoke.SmokeFailure, match="exited"):
        _check(run)
    run = healthy(module)
    run["doc"] = None
    with pytest.raises(chip_smoke.SmokeFailure, match="exited"):
        _check(run)


def test_an_exit_code_of_3_passes_where_only_speed_acceptances_fail():
    for module in ("mesh_ab", "dataplane_ab", "finality_bench", "execution_bench"):
        run = healthy(module)
        run["rc"] = 3
        _check(run)


@pytest.mark.parametrize("module", ("finality_bench", "execution_bench"))
def test_service_faults_fail(module):
    run = healthy(module)
    run["services"][0]["final"]["verify_generic"] += 1
    with pytest.raises(chip_smoke.SmokeFailure, match="generic"):
        _check(run)
    run = healthy(module)
    run["services"][0]["warm"] = None
    with pytest.raises(chip_smoke.SmokeFailure, match="never warmed"):
        _check(run)
    run = healthy(module)
    run["services"] = []
    with pytest.raises(chip_smoke.SmokeFailure, match="reported"):
        _check(run)
    run = healthy(module)
    run["service_starts"].append({"pid": 101})
    run["services"].append(_service(101, 6.0, 31.0))
    with pytest.raises(chip_smoke.SmokeFailure, match="for one card fleet"):
        _check(run)


def test_the_dataplane_service_must_launch_keyed_only():
    run = healthy("dataplane_ab")
    run["services"][0]["final"]["verify_generic"] += 1
    with pytest.raises(chip_smoke.SmokeFailure, match="generic"):
        _check(run)
    run = healthy("dataplane_ab")
    run["services"], run["service_starts"] = [], []
    with pytest.raises(chip_smoke.SmokeFailure, match="0 verifier services"):
        _check(run)


def test_the_sims_seeded_constants_hold_at_their_depth_only():
    for module in ("finality_bench", "execution_bench"):
        run = healthy(module)
        run["doc"]["sim"]["duration_s"] = 4.0
        key = "digest" if module == "finality_bench" else "root_chain_digest"
        run["doc"]["sim"][key] = "ab" * 32
        _check(run)


def test_apps_checks_bound_the_cards_contexts():
    run = healthy("finality_bench")
    run["samples"] = [(2.0, 2), (10.0, 3), (31.0, 3), (36.0, 2)]
    chip_smoke.apps_checks(run)
    run["samples"] = [(34.0, 3)]
    with pytest.raises(chip_smoke.SmokeFailure, match="opened a context"):
        chip_smoke.apps_checks(run)
    run["samples"] = [(10.0, 4)]
    with pytest.raises(chip_smoke.SmokeFailure, match="opened a context"):
        chip_smoke.apps_checks(run)


def test_the_step_runs_every_tool_once_and_the_queue_every_run():
    names = [run[0] for run in chip_smoke.LAST_TOOL_RUNS]
    assert {run[1] for run in chip_smoke.LAST_TOOL_RUNS} == set(MODULES)
    assert {run[1] for run in chip_smoke.LAST_TOOL_DEFAULTS} == set(MODULES)
    assert all("cuda-only" in run[3] for run in chip_smoke.LAST_TOOL_RUNS)
    assert sorted(chip_smoke.BESIDE_ORDER) == sorted(
        names + [run[0] for run in chip_smoke.FLEET_BENCH_RUNS])


def test_beside_runs_its_jobs_in_order_while_open(monkeypatch):
    import threading

    monkeypatch.setattr(chip_smoke, "ABORT", threading.Event())
    ran, gate = [], threading.Event()

    def job(name, wait=False):
        ran.append(name)
        if wait:
            assert gate.wait(10)
        return name.upper()

    beside = chip_smoke.Beside([("a", job, ("a", True)), ("b", job, ("b",)), ("c", job, ("c",))])
    chip_smoke.time.sleep(0.1)
    assert ran == []
    with beside:
        for _ in range(100):
            if ran:
                break
            chip_smoke.time.sleep(0.01)
        assert ran == ["a"] and beside.results == {}
        threading.Timer(0.2, gate.set).start()
        assert beside.join() == {"a": "A", "b": "B", "c": "C"} and ran == ["a", "b", "c"]
    assert not chip_smoke.ABORT.is_set()


def test_beside_raises_a_jobs_failure_and_aborts_on_its_own(monkeypatch):
    monkeypatch.setattr(chip_smoke, "ABORT", chip_smoke.threading.Event())

    def fails():
        raise chip_smoke.SmokeFailure("beside")

    with pytest.raises(chip_smoke.SmokeFailure, match="beside"):
        with chip_smoke.Beside([("x", fails, ()), ("y", lambda: 1, ())]) as beside:
            beside.join()
    assert beside.results == {} and chip_smoke.ABORT.is_set()
    monkeypatch.setattr(chip_smoke, "ABORT", chip_smoke.threading.Event())
    started = chip_smoke.threading.Event()

    def runs_until_aborted():
        started.set()
        return chip_smoke.ABORT.wait(30)

    waited = chip_smoke.Beside([("w", runs_until_aborted, ()), ("z", lambda: 1, ())])
    with pytest.raises(RuntimeError, match="the main phase failed"):
        with waited:
            assert started.wait(10)
            raise RuntimeError("the main phase failed")
    assert chip_smoke.ABORT.is_set() and waited.results == {"w": True}


def test_kill_tree_ends_a_child_and_its_children():
    import subprocess
    import time

    parent = subprocess.Popen([sys.executable, "-c",
                               "import subprocess, sys, time; subprocess.Popen([sys.executable, "
                               "'-c', 'import time; time.sleep(60)']); time.sleep(60)"],
                              start_new_session=True)
    time.sleep(1.0)
    child = [int(e) for e in os.listdir("/proc") if e.isdigit()
             and open(f"/proc/{e}/stat").read().rsplit(")", 1)[1].split()[1] == str(parent.pid)]
    assert len(child) == 1
    chip_smoke.kill_tree(parent.pid)
    assert parent.wait(10) != 0
    for _ in range(50):
        try:
            state = open(f"/proc/{child[0]}/stat").read().rsplit(")", 1)[1].split()[0]
        except OSError:
            break
        if state == "Z":
            break
        time.sleep(0.1)
    else:
        raise AssertionError("the grandchild outlived kill_tree")
