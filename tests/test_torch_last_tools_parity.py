"""The port's last five tools against the JAX repository's on the same
inputs, with no fleet: ``dataplane_ab``'s per-leader arithmetic and its
``main`` over fixed fleet documents; ``mesh_ab``'s ``stage_p50s`` over one
trace and its ``main`` over fixed testbed runs; ``finality_bench``'s
gauges, percentile, tolerance, census and fleet record; ``execution_bench``'s
series parser, root cross-check (a forked height, a client root no node
has), spend bundle and parameters patch.  Also: off a card every card kind
raises before a fleet or a validator starts, and the microbench appends
leave the root ``BENCH_TREND.json`` alone.
"""
import argparse
import asyncio
import importlib
import json
import os
import sys
import types

import numpy as np
import pytest

from mysticeti_tpu_torch.orchestrator import runner as port_runner
from mysticeti_tpu_torch.tools import (
    dataplane_ab,
    execution_bench,
    finality_bench,
    mesh_ab,
    node_bench,
    perf_attr,
)
from test_torch_fleet_bench_parity import _exposition, _root_trend, clean_env, jax_tool  # noqa: F401

HOT = ("mesh-encode", "mesh-parse", "digest")


def _perf_doc(mode, rep, windowed=True):
    """A fixed perf_attr fleet document of ``mode``'s ``rep``-th fleet."""
    base = 10.0 if mode == "fallback" else 6.0
    doc = {
        "committed_leaders_by_node": {str(a): 40 + 3 * a + rep for a in range(4)},
        "subsystems": {sub: {"cpu_s": 1.0, "us_per_leader": base * (i + 1) + rep}
                       for i, sub in enumerate(HOT + ("core",))},
        "windowed_us_per_leader_by_node": {
            str(a): {sub: base * (a + 1) + i + rep for i, sub in enumerate(HOT)}
            for a in range(4)} if windowed else {},
        "native_active_by_node": {
            "0": None, "1": [] if mode == "fallback" else ["decode_block", "split_frames"]},
        "exit_codes": {str(a): 0 for a in range(4)},
    }
    if mode == "native" and rep == 1:
        doc["subsystems"]["digest"]["us_per_leader"] = None
    return doc


@pytest.mark.parametrize("windowed", [True, False])
def test_dataplane_arithmetic_equals_the_jax_tools(windowed):
    jax = jax_tool("dataplane_ab")
    for mode in ("fallback", "native"):
        for rep in (0, 1):
            doc = _perf_doc(mode, rep, windowed)
            for sub in HOT + ("core", "absent"):
                assert (dataplane_ab.subsystem_us_per_leader(doc, sub)
                        == jax.subsystem_us_per_leader(doc, sub))
            assert dataplane_ab.hotpath_us_per_leader(doc) == jax.hotpath_us_per_leader(doc)
            assert dataplane_ab.mean_leaders(doc) == jax.mean_leaders(doc)
    empty = {"committed_leaders_by_node": {}}
    assert dataplane_ab.mean_leaders(empty) == jax.mean_leaders(empty) == 0.0
    assert dataplane_ab.HOT_SUBSYSTEMS == jax.HOT_SUBSYSTEMS


def _microbench(i):
    return {"speedups": {"combined_encode_parse_digest": (2.4, 1.9, 2.7)[i % 3]},
            "fallback": {"encode_mb_s": 1.0}, "native": None}


@pytest.mark.parametrize("repeats", [1, 2])
def test_dataplane_main_equals_the_jax_tools(repeats, tmp_path, monkeypatch, clean_env):
    """Both tools' ``main`` over the same fleet documents and microbench
    passes: the same comparison, acceptance and microbench, the fallback arm
    with ``MYSTICETI_NO_NATIVE=1`` in its nodes' environment."""
    jax = jax_tool("dataplane_ab")
    calls = {"jax": [], "port": []}
    passes = {"jax": iter(range(3)), "port": iter(range(3))}

    def jax_run_fleet(args):
        # The JAX tool sets the arm's knobs in this process's environment,
        # which its fleet's nodes inherit.
        no_native = os.environ.get("MYSTICETI_NO_NATIVE")
        mode = "fallback" if no_native == "1" else "native"
        rep = int(os.path.basename(args.working_dir).rsplit("-", 1)[1])
        calls["jax"].append((mode, rep, no_native, os.environ.get("TRANSACTION_SIZE")))
        return _perf_doc(mode, rep)

    def run_fleet(args, env=None):
        mode = "fallback" if (env or {}).get("MYSTICETI_NO_NATIVE") == "1" else "native"
        rep = int(os.path.basename(args.working_dir).rsplit("-", 1)[1])
        calls["port"].append((mode, rep, (env or {}).get("MYSTICETI_NO_NATIVE"),
                              (env or {}).get("TRANSACTION_SIZE")))
        assert args.verifier == "cpu" and args.port_base == 1500
        return _perf_doc(mode, rep)

    fake_node_bench = types.ModuleType("node_bench")
    fake_node_bench.dataplane_bench = lambda: _microbench(next(passes["jax"]))
    fake_node_bench.append_dataplane_trend = lambda row, round_: None
    monkeypatch.setitem(sys.modules, "node_bench", fake_node_bench)
    monkeypatch.setitem(sys.modules, "perf_attr", types.SimpleNamespace(run_fleet=jax_run_fleet))
    monkeypatch.setattr(perf_attr, "run_fleet", run_fleet)
    monkeypatch.setattr(node_bench, "dataplane_bench", lambda: _microbench(next(passes["port"])))
    argv = ["--verifier", "cpu", "--repeats", str(repeats), "--no-trend"]
    rc_jax = jax.main(argv + ["--out", str(tmp_path / "jax.json")])
    rc_port = dataplane_ab.main(argv + ["--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert rc_port == rc_jax
    assert calls["port"] == calls["jax"]
    for key in ("comparison", "acceptance", "microbench", "metric", "round", "committee",
                "duration_s", "tps_per_node", "transaction_size", "repeats"):
        assert got[key] == want[key], key
    assert got["card"] is None and got["verifier"] == "cpu"


def _trace(path):
    """A Chrome trace of ``receive`` / ``transit`` spans over a few blocks
    on two tracks, with a duplicate span and a span without a block."""
    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 2, "args": {"name": "node-0"}}]
    for i in range(7):
        for stage, dur in (("receive", 100 + 37 * i), ("transit", 900 - 51 * i)):
            events.append({"ph": "X", "name": stage, "pid": 1, "tid": 2 + i % 2, "ts": 1000 * i,
                           "dur": dur, "args": {"block": f"A{i}R{i}"}})
    events.append({"ph": "X", "name": "receive", "pid": 1, "tid": 2, "ts": 5, "dur": 5000,
                   "args": {"block": "A0R0"}})
    events.append({"ph": "X", "name": "verify", "pid": 1, "tid": 2, "ts": 5, "dur": 77,
                   "args": {"block": "A0R0"}})
    events.append({"ph": "X", "name": "receive", "pid": 1, "tid": 2, "ts": 5, "dur": 1})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_stage_p50s_equals_the_jax_tools(tmp_path):
    jax = jax_tool("mesh_ab")
    path = _trace(tmp_path / "trace.json")
    assert mesh_ab.stage_p50s(path) == jax.stage_p50s(path)
    assert mesh_ab.stage_p50s(path, ("receive", "verify")) == jax.stage_p50s(
        path, ("receive", "verify"))
    torn = tmp_path / "torn.json"
    torn.write_text(open(path).read()[:-200])
    assert mesh_ab.stage_p50s(str(torn)) == jax.stage_p50s(str(torn))
    assert "note" in mesh_ab.stage_p50s(str(torn))


def _mesh_run(mode, rep, trace):
    nodes = [{"authority": a, "committed_leaders": 30 + a + (5 if mode == "mesh" else 0) + rep,
              "encode_reuse_total": 0 if mode == "legacy" else 10 + a,
              "mesh_encode_us": 900 - 100 * a if mode == "legacy" else 300 + a,
              "net_decode_us": 5, "frames_coalesced_total": 0, "wire_bytes_sent": 0,
              "wire_bytes_received": 0} for a in range(4)]
    return {"mode": mode, "trace": trace, "nodes": nodes}


@pytest.mark.parametrize("repeats", [1, 2])
def test_mesh_main_equals_the_jax_tools(repeats, tmp_path, monkeypatch, clean_env):
    """Both tools' ``main`` over the same testbed runs (ABBA order) and one
    trace: the same comparison and acceptance."""
    jax = jax_tool("mesh_ab")
    trace = _trace(tmp_path / "trace.json")
    order = {"jax": [], "port": []}

    def fake(side):
        async def run_mode(mode, working_dir, committee_size, duration_s, tps, verifier):
            rep = int(os.path.basename(working_dir).rsplit("-", 1)[1])
            order[side].append((mode, rep, committee_size, duration_s, tps, verifier))
            return _mesh_run(mode, rep, trace)
        return run_mode

    fake_node_bench = types.ModuleType("node_bench")
    fake_node_bench.mesh_serialization = lambda: {"speedup": 3.0}
    monkeypatch.setitem(sys.modules, "node_bench", fake_node_bench)
    monkeypatch.setattr(jax, "run_mode", fake("jax"))
    monkeypatch.setattr(mesh_ab, "run_mode", fake("port"))
    monkeypatch.setattr(node_bench, "mesh_serialization", lambda: {"speedup": 3.0})
    args = ["--verifier", "cpu", "--duration", "5", "--repeats", str(repeats),
            "--workdir", str(tmp_path / "w")]
    monkeypatch.setattr(sys, "argv", ["mesh_ab"] + args + ["--out", str(tmp_path / "jax.json")])
    rc_jax = jax.main()
    rc_port = mesh_ab.main(args + ["--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert rc_port == rc_jax and order["port"] == order["jax"]
    for key in ("comparison", "acceptance", "runs", "microbench", "committee", "duration_s",
                "tps_per_node", "verifier"):
        assert got[key] == want[key], key
    assert got["card"] is None


def test_finality_helpers_equal_the_jax_tools():
    jax = jax_tool("finality_bench")
    for pkg in ("mysticeti_tpu", "mysticeti_tpu_torch"):
        for a in range(3):
            text = _exposition(pkg, a)
            assert finality_bench._node_gauges(text) == jax._node_gauges(text)
    assert finality_bench._node_gauges(None) == jax._node_gauges(None)
    assert finality_bench._node_gauges("") == jax._node_gauges("")
    rng = np.random.default_rng(20)
    for n in (0, 1, 2, 5, 16):
        values = [float(x) for x in rng.random(n)]
        for q in (0.5, 0.9, 0.99):
            assert finality_bench._percentile(values, q) == jax._percentile(values, q)
    for a, b, tol in ((0.0, 0.0009, 0.2), (1.0, 1.2, 0.2), (1.0, 1.3, 0.2), (0.5, 0.4, 0.2),
                      (2.0, 0.0, 0.5), (0.0011, 0.0, 0.2)):
        assert finality_bench._within(a, b, tol) == jax._within(a, b, tol)
    records = [{"rule": r, "outcome": o} for r, o in (
        ("direct", "commit"), ("indirect", "skip"), ("direct", "commit"), ("direct", "skip"),
        (None, "undecided"))] + [{}]
    assert finality_bench._outcome_census(records) == jax._outcome_census(records)
    assert finality_bench._outcome_census([]) == jax._outcome_census([])


def test_finality_fleet_record_equals_the_jax_tools(tmp_path, monkeypatch, clean_env):
    """The JAX tool's ``run_fleet_leg`` over a stand-in runner and the port's
    ``fleet_record`` over the same scrapes and ledgers: the same record, the
    port's with the kind it ran and the fleet's counters besides."""
    jax = jax_tool("finality_bench")
    jax_runner = importlib.import_module("mysticeti_tpu.orchestrator.runner")
    texts = [_exposition("mysticeti_tpu_torch", a) for a in range(3)] + [None]
    ledgers = {
        "0": {"recorded": 9, "ledger_digest": "ab", "undecided": ["X1"],
              "records": [{"rule": "direct", "outcome": "commit"}] * 3},
        "1": {"recorded": 0, "records": []},
        "2": None,
    }

    class Runner:
        def __init__(self, working_dir, verifier="cpu"):
            self.parameters = self

        async def configure(self, nodes, load):
            pass

        async def boot_node(self, authority):
            pass

        async def scrape(self, authority):
            return texts[authority]

        def metrics_address(self, authority):
            return ("127.0.0.1", authority)

        async def cleanup(self):
            pass

    async def http_get(host, port, path="/metrics", timeout=5.0):
        doc = ledgers.get(str(port))
        return None if doc is None else json.dumps(doc)

    monkeypatch.setattr(jax_runner, "LocalProcessRunner", Runner)
    monkeypatch.setattr(jax_runner, "_http_get_metrics", http_get)
    args = argparse.Namespace(nodes=4, load=2000, duration=0.0, cross_check_tolerance=0.2,
                              workdir=str(tmp_path))
    want = asyncio.run(jax.run_fleet_leg(args))
    got = finality_bench.fleet_record(texts, {k: v for k, v in ledgers.items()}, args, 0.0,
                                      "cuda-only")
    assert got.pop("verifier") == "cuda-only" and got.pop("fleet")["scraped_nodes"] == 3
    got.pop("window_utc")
    want.pop("window_utc")
    assert got == want


def _exec_exposition(pkg, a):
    Metrics = importlib.import_module(f"{pkg}.metrics").Metrics
    m = Metrics()
    m.mysticeti_execution_height.set(100 + a)
    m.mysticeti_execution_accounts.set(7 * a)
    for result, n in (("applied", 50 + a), ("insufficient_balance", 3), ("bad_nonce", a)):
        m.mysticeti_execution_txs_total.labels(result=result).inc(n)
    for phase, value in (("execute", 0.004 * (a + 1)), ("total", 0.5), ("execute", 0.002)):
        m.mysticeti_e2e_finality_seconds.labels(phase=phase).observe(value)
    m.mysticeti_e2e_finality_p50_seconds.set(0.3)
    m.mysticeti_e2e_finality_p99_seconds.set(0.9 + a)
    return m.expose().decode()


def test_execution_helpers_equal_the_jax_tools(tmp_path):
    jax = jax_tool("execution_bench")
    for pkg in ("mysticeti_tpu", "mysticeti_tpu_torch"):
        for a in range(2):
            text = _exec_exposition(pkg, a)
            assert execution_bench._node_series(text) == jax._node_series(text)
    assert execution_bench._node_series(None) == jax._node_series(None)
    for node in (0, 3):
        account = f"fleet-{node}-7".encode()
        assert ([tx.to_bytes() for tx in execution_bench._spend_bundle(account, node)]
                == [tx.to_bytes() for tx in jax._spend_bundle(account, node)])
    docs = {
        "0": {"execution": {"recent_roots": [{"height": h, "root": f"r{h}"}
                                             for h in range(5, 9)]}},
        "1": {"execution": {"recent_roots": [{"height": h, "root": f"r{h}"}
                                             for h in range(6, 10)]}},
        "2": None,
        "3": {"execution": {}},
    }
    forked = json.loads(json.dumps(docs))
    forked["1"]["execution"]["recent_roots"][1]["root"] = "other"
    cases = [
        (docs, {"7": "r7", "9": "r9", "42": "r42"}),
        (docs, {"6": "unknown"}),
        (forked, {"7": "r7"}),
        ({"0": docs["0"]}, {}),
        ({}, {"1": "r1"}),
    ]
    for debug_docs, client in cases:
        assert (execution_bench._cross_check_roots(debug_docs, client)
                == jax._cross_check_roots(debug_docs, client))
    assert execution_bench._cross_check_roots(docs, {"7": "r7"})["agree"]
    assert not execution_bench._cross_check_roots(forked, {})["agree"]
    assert execution_bench._cross_check_roots(docs, {"6": "unknown"})["forks"] == [
        {"height": 6, "client": "unknown", "roots": {"0": "r6", "1": "r6"}}]


def test_patch_parameters_equals_the_jax_tools(tmp_path):
    from mysticeti_tpu.cli import benchmark_genesis as jax_genesis
    from mysticeti_tpu_torch.cli import benchmark_genesis

    jax = jax_tool("execution_bench")
    jax_genesis(["127.0.0.1"] * 4, str(tmp_path / "jax"))
    benchmark_genesis(["127.0.0.1"] * 4, str(tmp_path / "port"))
    before = (tmp_path / "port" / "parameters.yaml").read_text()
    assert before == (tmp_path / "jax" / "parameters.yaml").read_text()
    jax._patch_parameters(str(tmp_path / "jax" / "parameters.yaml"), 18650)
    execution_bench._patch_parameters(str(tmp_path / "port" / "parameters.yaml"), 18650)
    after = (tmp_path / "port" / "parameters.yaml").read_text()
    assert after == (tmp_path / "jax" / "parameters.yaml").read_text() != before
    from mysticeti_tpu_torch.config import Parameters

    parameters = Parameters.load(str(tmp_path / "port" / "parameters.yaml"))
    assert parameters.execution and parameters.ingress.gateway_port_base == 18650


CARD_RUNS = {
    "mesh_ab": ["--duration", "1", "--repeats", "1"],
    "dataplane_ab": ["--duration", "1", "--repeats", "1"],
    "reconfig_matrix": ["--no-matrix", "--no-determinism"],
    "finality_bench": ["--duration", "1"],
    "execution_bench": ["--duration", "1"],
}


@pytest.mark.parametrize("name", sorted(CARD_RUNS))
def test_card_kinds_raise_before_a_fleet_or_a_validator(name, tmp_path, monkeypatch, clean_env):
    """No card here: the default kind's prewarm raises before any genesis,
    validator or fleet, and nothing is written."""
    from mysticeti_tpu_torch import validator

    module = importlib.import_module(f"mysticeti_tpu_torch.tools.{name}")
    started = []

    async def configure(self, *args, **kwargs):
        started.append(args)

    async def start_benchmarking(*args, **kwargs):
        started.append(args)

    monkeypatch.setattr(port_runner.LocalProcessRunner, "configure", configure)
    monkeypatch.setattr(validator.Validator, "start_benchmarking", start_benchmarking)
    monkeypatch.setattr(perf_attr, "run_fleet", lambda *a, **k: started.append(a))
    monkeypatch.setattr(node_bench, "dataplane_bench", lambda: started.append("bench"))
    before = _root_trend()
    out = tmp_path / "doc.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(CARD_RUNS[name] + ["--out", str(out), "--workdir", str(tmp_path / "w")])
    assert started == [] and not out.exists() and _root_trend() == before


def test_dataplane_trend_appends_skip_off_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_TREND_PATH", str(tmp_path / "trend.json"))
    before = _root_trend()
    comparison = {"hotpath_us_per_leader": {"fallback": 200.0, "native": 100.0},
                  "hotpath_cpu_reduction_pct": 50.0}
    records = dataplane_ab.ab_records(comparison, 20)
    jax_trend = jax_tool("bench_trend")
    assert [r["metric"] for r in records] == [
        "NODE_DATAPLANE.ab_fallback_leaders_per_hotpath_cpu_s",
        "NODE_DATAPLANE.ab_native_leaders_per_hotpath_cpu_s",
        "NODE_DATAPLANE.ab_hotpath_cpu_reduction"]
    assert records == [jax_trend._record(20, "DATAPLANE_r20.json", r["metric"], r["value"],
                                         r["unit"]) for r in records]
    assert [r["value"] for r in records] == [5000.0, 10000.0, 50.0]
    assert not node_bench._append_trend(records)
    assert not (tmp_path / "trend.json").exists() and _root_trend() == before


def test_warmups_apart_counts_the_warm_up_threads_launches(monkeypatch):
    """Launches made inside a ``TorchSignatureVerifier`` warm-up, on its
    thread, count also as warm-up launches; a flush on another thread
    meanwhile does not; ``launches_since`` takes them apart."""
    import contextlib
    import threading
    import types

    import torch

    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.ops import ed25519_cuda as K
    from mysticeti_tpu_torch.tools import launch_counts, launches_since, warmups_since

    # The launch itself is stubbed (no card here); its counting is the real
    # one, and the counts go back to what they were after the test.
    for k in K.KERNELS:
        monkeypatch.setattr(k, "launches", k.launches)
        monkeypatch.setattr(k, "warmup_launches", k.warmup_launches)
    monkeypatch.setattr(K.Kernel, "_function", lambda self: lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    flushed, warming = threading.Event(), threading.Event()
    calls = []

    def verify_signatures(self, pks, digests, sigs):
        # The warm-up's probes: an unknown key (generic), then one a key.
        if len(pks) == 1:
            K.PROLOGUE.launch(None, 1)
            K.VERIFY_GENERIC.launch(None, 1)
            warming.set()
            assert flushed.wait(10)
        else:
            K.PROLOGUE.launch(None, 1)
            K.VERIFY_KEYED.launch(None, 1)
        calls.append(len(pks))
        return [False] * len(pks)

    def flush():
        assert warming.wait(10)
        K.PROLOGUE.launch(None, 1)
        K.VERIFY_KEYED.launch(None, 1)
        flushed.set()

    monkeypatch.setattr(TorchSignatureVerifier, "verify_signatures", verify_signatures)
    verifier = object.__new__(TorchSignatureVerifier)
    verifier._table = type("Table", (), {"neg_combs51": lambda self: None,
                                         "_keys": [bytes(32)] * 4,
                                         "__len__": lambda self: 4})()
    before, warm_before = launch_counts(), launch_counts(warmup=True)
    threads = [threading.Thread(target=verifier.warmup), threading.Thread(target=flush)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert calls == [1, 4]
    assert warmups_since(warm_before) == {"prologue": 2, "prologue_flat": 0,
                                          "verify_generic": 1, "verify_keyed": 1}
    assert launches_since(before) == {"prologue": 3, "prologue_flat": 0,
                                      "verify_generic": 1, "verify_keyed": 2}
    assert launches_since(before, warm_before) == {"prologue": 1, "prologue_flat": 0,
                                                   "verify_generic": 0, "verify_keyed": 1}
