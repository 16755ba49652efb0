"""The port's load and catch-up fleet benches against the JAX repository's
tools on the same inputs, with no fleet: ``maxload_bench._probe_dicts``
over one saved ``MeasurementsCollection``; ``catchup_bench``'s exposition
parsers; ``overload_bench``'s ingress and finality parsers and its
acceptance arithmetic; ``node_bench``'s saturation inputs, its verdicts on
the ``cpu`` kind and on the card kind's plain versions, and its
microbenches' deterministic outputs; the trend index's records of each
new document.  Also: off a card every card kind raises before a fleet
boots and the microbench appends leave the root ``BENCH_TREND.json``
alone; the runner carries the regime's knobs to the service and the nodes
and stops the service with SIGTERM first.
"""
import asyncio
import importlib.util
import json
import os
import signal
import sys

import numpy as np
import pytest

from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.orchestrator import runner as port_runner
from mysticeti_tpu_torch.tools import (
    catchup_bench,
    chip_window_ab,
    maxload_bench,
    node_bench,
    overload_bench,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_TREND = os.path.join(REPO, "BENCH_TREND.json")


def jax_tool(name):
    """The JAX repository's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def clean_env():
    """The tools pin ``INITIAL_DELAY`` and the regime's knobs in
    ``os.environ``: put it back as it was."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _exposition(pkg, a: int) -> str:
    """One node's ``/metrics`` text from ``pkg``'s ``Metrics``: latencies,
    a benchmark duration, verifications under every outcome label, ingress
    sheds by reason and the finality gauges."""
    Metrics = importlib.import_module(f"{pkg}.metrics").Metrics
    m = Metrics()
    m.observe_latency_batch("shared", np.array([0.1, 0.3, 0.5 + a]))
    m.benchmark_duration.inc(4 + a)
    for backend, outcome, n in (("cuda", "accepted", 40), ("cuda", "rejected", 2),
                                ("aggregate", "skipped", 17), ("aggregate", "accepted", 5)):
        m.verified_signatures_total.labels(backend=backend, outcome=outcome).inc(n + a)
    m.mysticeti_ingress_admitted_total.inc(1000 + a)
    m.mysticeti_ingress_shed_total.labels(reason="admission").inc(30 * a)
    m.mysticeti_ingress_shed_total.labels(reason="duplicate").inc(7)
    m.mysticeti_ingress_shed_mode.set(a % 2)
    m.mysticeti_e2e_finality_p50_seconds.set(0.2 + a / 10)
    m.mysticeti_e2e_finality_p99_seconds.set(1.5 - a / 10)
    m.mysticeti_client_finality_p50_seconds.set(0.25)
    m.mysticeti_client_finality_p99_seconds.set(1.0 + a)
    return m.expose().decode()


def _collection(pkg, nodes=4):
    measurement = importlib.import_module(f"{pkg}.orchestrator.measurement")
    c = measurement.MeasurementsCollection({"nodes": nodes, "load": 800, "duration_s": 12.0})
    for tick in range(3):
        for a in range(nodes):
            c.add(str(a), measurement.Measurement.from_prometheus(_exposition(pkg, a + tick)))
        c.add_host_sample({"timestamp_s": 10.0 + tick, "cpu_pct": 40.0 + tick, "load_1m": 2.5,
                           "mem_available_mb": 9000.0, "processes": {
                               "node-0": {"cpu_pct": 90.0 - tick, "rss_mb": 120.0}}})
        c.add_health_sample({"t": 4.0 * tick, "status": "degraded" if tick else "ok",
                             "reachable": [str(a) for a in range(nodes)],
                             "quorum_participation": 1.0 - tick / 10,
                             "commit_skew_rounds": tick, "straggler_score": {"3": tick},
                             "slo_alert_totals": {"loop-lag": float(tick)}})
    return c


def test_probe_dicts_equal_the_jax_tools(tmp_path):
    path = str(tmp_path / "measurements-0.json")
    _collection("mysticeti_tpu_torch").save(path)
    jax_measurement = importlib.import_module("mysticeti_tpu.orchestrator.measurement")
    from mysticeti_tpu_torch.orchestrator.measurement import MeasurementsCollection

    ours = maxload_bench._probe_dicts([MeasurementsCollection.load(path)])
    theirs = jax_tool("maxload_bench")._probe_dicts(
        [jax_measurement.MeasurementsCollection.load(path)])
    assert ours == theirs
    assert set(ours[0]) == {"offered_load_tx_s", "tps", "avg_latency_s", "stdev_latency_s",
                            "host", "health"}


def _stable(samples):
    """Parsed samples less the ``*_created`` timestamps of the registry."""
    return {k: v for k, v in samples.items() if "_created" not in k}


def test_catchup_parsers_equal_the_jax_tools():
    jax = jax_tool("catchup_bench")
    for a in range(3):
        ours_text, jax_text = _exposition("mysticeti_tpu_torch", a), _exposition("mysticeti_tpu", a)
        ours, theirs = catchup_bench.parse_metrics(ours_text), jax.parse_metrics(jax_text)
        # The port's registry names its kernel builds (``mysticeti_cuda_build*``)
        # where the JAX package's names its compile cache; every other sample
        # is the JAX package's, label for label.
        common = set(_stable(ours)) & set(_stable(theirs))
        assert {k: ours[k] for k in common} == {k: theirs[k] for k in common}
        assert {k for k in ours if k.startswith("verified_signatures_total")} == {
            k for k in theirs if k.startswith("verified_signatures_total")}
        assert catchup_bench.parse_metrics(jax_text) == theirs
        counters = catchup_bench.sig_counters(ours)
        assert counters == jax.sig_counters(theirs)
        assert counters == {"direct": 45 + 2 * a, "skipped": 17 + a, "rejected": 2 + a,
                            "skip_frac": round((17 + a) / (62 + 3 * a), 3)}
        for name in ('latency_s_count{workload="shared"}', "benchmark_duration_total",
                     "no_such_series"):
            assert catchup_bench.metric(ours, name) == jax.metric(theirs, name)
    assert catchup_bench.MARGIN_ROUNDS == jax.MARGIN_ROUNDS


def test_overload_parsers_equal_the_jax_tools():
    jax = jax_tool("overload_bench")
    ours_texts = [_exposition("mysticeti_tpu_torch", a) for a in range(4)] + [None]
    jax_texts = [_exposition("mysticeti_tpu", a) for a in range(4)] + [None]
    ingress = overload_bench._parse_ingress(ours_texts)
    assert ingress == jax._parse_ingress(jax_texts) == jax._parse_ingress(ours_texts)
    assert ingress == {"admitted_total": 4006, "shed_total": {"admission": 180, "duplicate": 28},
                       "shed_mode_nodes": 2}
    finality = overload_bench._parse_finality(ours_texts)
    assert finality == jax._parse_finality(jax_texts) == jax._parse_finality(ours_texts)
    assert finality == {"server_p50_s": 0.5, "server_p99_s": 1.5, "client_p50_s": 0.25,
                        "client_p99_s": 4.0}
    assert tuple(overload_bench.MULTIPLIERS) == tuple(jax.MULTIPLIERS)


RUNGS = {
    "holds": [(1, 3000.0), (2, 2900.0), (3, 2800.0), (5, 2500.0)],
    "collapses": [(1, 3000.0), (2, 2600.0), (3, 2100.0), (5, 900.0)],
    "partial": [(1, 3000.0), (3, 2500.0)],
}
DETERMINISM = {"sim_committed_3x_over_1x": 0.91, "byte_identical": True,
               "sim_fully_accounted": True}


@pytest.mark.parametrize("shape", sorted(RUNGS))
def test_overload_acceptance_equals_the_jax_tools(shape, tmp_path, monkeypatch, clean_env):
    """Both tools' ``main`` over the same fixed rungs and determinism leg:
    the same acceptance and exit code."""
    rungs = RUNGS[shape]
    committed = dict(rungs)
    multipliers = [str(m) for m, _ in rungs]

    def run_with(module, argv):
        async def rung(nodes, load, duration, workdir, label, *rest):
            mult = 1 if label == "calibrate" else int(label[:-1])
            return {"offered_tx_s": load, "committed_tx_s": committed[mult]}

        monkeypatch.setattr(module, "run_rung", rung)
        monkeypatch.setattr(module, "run_determinism_leg", lambda: dict(DETERMINISM))
        out = str(tmp_path / f"{module.__name__}.json")
        monkeypatch.setattr(sys, "argv", ["overload_bench", *argv, "--out", out])
        rc = module.main(argv + ["--out", out]) if module is overload_bench \
            else module.main()
        with open(out) as f:
            return rc, json.load(f)

    argv = ["--base-load", "3000", "--multipliers", *multipliers]
    rc, ours = run_with(overload_bench, argv + ["--verifier", "cpu"])
    jax_rc, theirs = run_with(jax_tool("overload_bench"), argv)
    assert (rc, ours["acceptance"]) == (jax_rc, theirs["acceptance"])
    assert ours["acceptance"] == overload_bench.acceptance_of(ours["rungs"], DETERMINISM)
    assert ours["rungs"] == theirs["rungs"] and ours["base_load_tx_s"] == 3000
    assert set(theirs) - {"host"} | {"card"} == set(ours)
    assert ours["verifier"] == "cpu" and ours["card"] is None
    assert rc == (3 if shape == "collapses" else 0)


def test_overload_calibration_sets_the_base_as_the_jax_tool(tmp_path, monkeypatch, clean_env):
    loads = []

    async def rung(nodes, load, duration, workdir, label, verifier="cuda-only"):
        loads.append((label, load, verifier))
        return {"offered_tx_s": load, "committed_tx_s": 2345.6 if label == "calibrate" else 2000.0}

    monkeypatch.setattr(overload_bench, "run_rung", rung)
    monkeypatch.setattr(overload_bench, "run_determinism_leg", lambda: dict(DETERMINISM))
    monkeypatch.setattr(overload_bench, "prewarm", lambda nodes: "cuda")
    out = str(tmp_path / "o.json")
    assert overload_bench.main(["--multipliers", "1", "2", "--out", out]) == 0
    assert loads == [("calibrate", 120000, "cuda-only"), ("1x", 2345, "cuda-only"),
                     ("2x", 4690, "cuda-only")]


def test_saturation_inputs_equal_the_jax_tools(monkeypatch):
    """The JAX tool's saturation batch, captured at its CPU verifier."""
    import mysticeti_tpu.block_validator as jax_bv

    seen = []

    class Recording:
        def verify_signatures(self, pks, msgs, sigs):
            seen.append((list(pks), list(msgs), list(sigs)))
            return [True] * len(sigs)

    monkeypatch.setattr(jax_bv, "CpuSignatureVerifier", Recording)
    row = jax_tool("node_bench").saturation("cpu", batch=48, iters=1)
    keys, pks, msgs, sigs = node_bench.saturation_inputs(48)
    assert seen[0] == (pks, msgs, sigs) and len(seen) == 2
    assert len({pk for pk in pks}) == len(keys) == 8
    assert row["batch"] == 48 and row["verifier"] == "cpu"


@pytest.fixture
def one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_saturation_verdicts_on_cpu_and_on_the_card_kinds_plain_versions(monkeypatch, one_thread):
    """Every verdict true on the ``cpu`` kind and on ``cuda-only`` over the
    kernels' plain versions (``device="cpu"``), and the card kind's launches
    (the wrappers counted here as the card counts them) one prologue and one
    keyed launch a call, generic never."""
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    for kernel, name in ((K.PROLOGUE, "prologue"), (K.VERIFY_GENERIC, "verify_generic"),
                         (K.VERIFY_KEYED, "_verify_keyed")):
        real = getattr(K, name)

        def counted(*args, _real=real, _kernel=kernel, **kwargs):
            _kernel.launches += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(K, name, counted)
    cpu = node_bench.saturation("cpu", batch=16, iters=2)
    card = node_bench.saturation("cuda-only", batch=16, iters=2, device="cpu")
    for row in (cpu, card):
        assert row["all_valid"] and row["iterations"] == 2 and row["batch"] == 16
        assert row["sig_per_sec"] > 0
    assert cpu["launches"] == {k.name: 0 for k in K.KERNELS}
    assert card["launches"] == {"prologue": 3, "prologue_flat": 0, "verify_generic": 0,
                                "verify_keyed": 3}


def _jax_blocks(count, txs):
    from mysticeti_tpu.committee import Committee
    from mysticeti_tpu.types import Share, StatementBlock

    signers = Committee.benchmark_signers(4)
    genesis = [StatementBlock.new_genesis(a).reference for a in range(4)]
    return tuple(
        StatementBlock.build(0, 1 + i, genesis,
                             [Share(bytes(128) + i.to_bytes(4, "little"))] * txs,
                             signer=signers[0]).to_bytes()
        for i in range(count))


def test_microbench_frames_and_counts_equal_the_jax_tools():
    from mysticeti_tpu import network as jax_network
    from mysticeti_tpu_torch import network

    assert node_bench._blocks(5, 3) == _jax_blocks(5, 3)
    assert (network.encode_message(network.Blocks(node_bench._blocks(5, 3)))
            == jax_network.encode_message(jax_network.Blocks(_jax_blocks(5, 3))))
    jax = jax_tool("node_bench")
    ours, theirs = (m.mesh_serialization(peers=3, blocks=5, txs=3, iters=2)
                    for m in (node_bench, jax))
    for key in ("metric", "peers", "blocks_per_frame", "frame_bytes", "iters"):
        assert ours[key] == theirs[key]
    for row in ("per_peer", "encode_once"):
        for key in ("encodes_per_fanout", "alloc_bytes_per_fanout"):
            assert ours[row][key] == theirs[row][key]
    ours, theirs = (m.dataplane_bench(blocks=5, txs=3, iters=2) for m in (node_bench, jax))
    for key in ("metric", "native_active", "blocks_per_frame", "txs_per_block", "frame_bytes",
                "iters"):
        assert ours[key] == theirs[key]
    assert set(ours) == set(theirs)
    for row in ("fallback", "native", "speedups"):
        assert set(ours.get(row, {})) == set(theirs.get(row, {}))
    assert [r["metric"] for r in node_bench.dataplane_records(ours, 19)] == [
        r["metric"] for r in _jax_trend_records(jax, "append_dataplane_trend", theirs)]
    mesh = node_bench.mesh_serialization(peers=3, blocks=5, txs=3, iters=2)
    assert [r["metric"] for r in node_bench.mesh_records(mesh, 19)] == [
        r["metric"] for r in _jax_trend_records(jax, "append_mesh_trend", mesh)]


def _jax_trend_records(jax, append, row):
    """The records the JAX tool's trend append merges, captured."""
    jax_trend = jax_tool("bench_trend")
    captured = []
    saved = sys.modules.get("bench_trend")
    sys.modules["bench_trend"] = jax_trend
    jax_trend.load_index = lambda path: {"records": []}
    jax_trend.merge_index = lambda index, fresh: captured.extend(fresh) or 0
    try:
        getattr(jax, append)(row, 19)
    finally:
        if saved is None:
            sys.modules.pop("bench_trend", None)
        else:
            sys.modules["bench_trend"] = saved
    return captured


def _root_trend():
    with open(ROOT_TREND, "rb") as f:
        return f.read()


def test_microbench_appends_skip_off_a_card(tmp_path, monkeypatch, capsys):
    """Off a card neither append writes anything (the root index stays byte
    for byte); with one, the records land in ``BENCH_TREND_PATH`` with the
    card."""
    from mysticeti_tpu_torch.tools import bench_trend

    before = _root_trend()
    index = str(tmp_path / "trend.json")
    monkeypatch.setenv("BENCH_TREND_PATH", index)
    row = node_bench.mesh_serialization(peers=3, blocks=5, txs=3, iters=2)
    assert node_bench.append_mesh_trend(row, 19) is False
    assert not os.path.exists(index)
    real = node_bench.dataplane_bench
    monkeypatch.setattr(node_bench, "dataplane_bench", lambda: real(blocks=5, txs=3, iters=2))
    assert node_bench.main(["--dataplane-bench", "--round", "19"]) == 0
    assert "not appended" in capsys.readouterr().out
    assert not os.path.exists(index)
    monkeypatch.setattr(node_bench, "card", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert node_bench.append_mesh_trend(row, 19) is True
    assert node_bench.main(["--dataplane-bench", "--round", "19"]) == 0
    records = bench_trend.load_index(index)["records"]
    assert {r["source"] for r in records} == {"MESH_SERIALIZATION_r19.json",
                                              "DATAPLANE_r19.json"}
    assert all(r["card"] == "NVIDIA H100 80GB HBM3, 700.00 W" for r in records)
    assert _root_trend() == before


def _port_doc(name):
    """A port document of each shape the trend index scores."""
    probe = {"offered_load_tx_s": 400, "tps": 812.5, "avg_latency_s": 0.27,
             "stdev_latency_s": 0.45, "fleet": {"verifier_fallback": 0}}
    run = {"verifier": "cuda-only", "nodes": 4, "max_sustainable_load_tx_s": 3200,
           "peak_committed_tx_s": 4100.0, "probes": [probe],
           "cpu_reference_probe": dict(probe, verifier="cpu"), "peak_vs_same_window_cpu": 0.9}
    if name.startswith("MAXLOAD_TAX"):
        return {"metric": "same_window_card_vs_cpu_peak_committed_tx_s", "card": "x",
                "backend": "cuda", "cpu_peak_committed_tx_s": 4000.0,
                "tpu_peak_committed_tx_s": 4100.0, "tpu_over_cpu": 1.025,
                "runs": [dict(run, verifier="cpu"), run]}
    if name.startswith("MAXLOAD"):
        return {"metric": "max_sustainable_load_tx_s", "card": "x",
                "runs": [dict(run, verifier="cpu", peak_committed_tx_s=3900.0), run]}
    return {"metric": "overload_committed_vs_offered", "nodes": 4, "verifier": "cuda-only",
            "card": "x", "rungs": [
                {"multiplier": 1, "offered_tx_s": 3000, "committed_tx_s": 2900.0},
                {"multiplier": 3, "offered_tx_s": 9000, "committed_tx_s": 2700.0}],
            "determinism": {"sim_committed_3x_over_1x": 1.0},
            "acceptance": {"committed_3x_over_1x": 0.931, "no_collapse": True}}


@pytest.mark.parametrize("name", ["MAXLOAD_r19.json", "MAXLOAD_TAX_r19.json",
                                  "OVERLOAD_r19.json"])
def test_trend_records_of_each_document_equal_the_jax_indexs(name, tmp_path):
    from mysticeti_tpu_torch.tools import bench_trend

    path = tmp_path / name
    path.write_text(json.dumps(_port_doc(name)))
    ours = bench_trend.normalize(str(path))
    assert ours == jax_tool("bench_trend").normalize(str(path))
    assert ours and all(r["value"] is not None and r["round"] == 19 for r in ours)
    # The scan tags each record with the card the document names, and
    # leaves a document without one untagged.
    for card in ("x", None):
        path.write_text(json.dumps(dict(_port_doc(name), card=card)))
        index = tmp_path / f"index-{card}.json"
        assert bench_trend.main(["--repo", str(tmp_path), "--out", str(index)]) == 0
        scanned = bench_trend.load_index(str(index))["records"]
        assert [dict(r, card=None) for r in scanned] == [dict(r, card=None) for r in ours]
        assert all(r.get("card") == card for r in scanned)


CARD_RUNS = {
    "maxload_bench": ["--verifiers", "cpu", "cuda-only"],
    "chip_window_ab": [],
    "node_bench": ["--verifiers", "cpu", "cuda"],
    "catchup_bench": ["--verifiers", "cpu", "cuda-agg"],
    "overload_bench": [],
}


@pytest.mark.parametrize("name", sorted(CARD_RUNS))
def test_card_kinds_raise_before_a_fleet_boots(name, tmp_path, monkeypatch, clean_env):
    """No card here: a card kind's prewarm raises before any genesis, and
    nothing is written."""
    module = importlib.import_module(f"mysticeti_tpu_torch.tools.{name}")
    booted = []

    async def configure(self, *args, **kwargs):
        booted.append(args)

    monkeypatch.setattr(port_runner.LocalProcessRunner, "configure", configure)
    before = _root_trend()
    out = tmp_path / "doc.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(CARD_RUNS[name] + ["--out", str(out), "--workdir", str(tmp_path / "w")])
    assert booted == [] and not out.exists() and _root_trend() == before


def test_chip_window_ab_document(tmp_path, monkeypatch, clean_env):
    """The A/B's document around two searches (faked here): the JAX tool's
    keys the trend index scores, the card's line for its platform claim,
    and the regime's knobs in the environment the runners pass on."""
    calls = []

    async def search(verifier, nodes, start_load, duration, iterations, workdir):
        calls.append((verifier, nodes, start_load, duration, iterations))
        assert os.environ["MYSTICETI_MAX_BLOCK_TX"] == "16"
        assert os.environ["MYSTICETI_RETAIN_ROUNDS"] == "100000"
        assert os.environ["MYSTICETI_LEADER_TIMEOUT"] == "0.25"
        return {"verifier": verifier, "peak_committed_tx_s": 4000.0 if verifier == "cpu"
                else 3000.0, "probes": []}

    monkeypatch.setattr(chip_window_ab, "search_one", search)
    monkeypatch.setattr(chip_window_ab, "prewarm", lambda nodes: "cuda")
    out = tmp_path / "tax.json"
    assert chip_window_ab.main(["--card-flavor", "cuda-agg", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert calls == [("cpu", 4, 400, 20.0, 5), ("cuda-agg", 4, 400, 20.0, 5)]
    assert doc["tpu_over_cpu"] == 0.75 and doc["cpu_peak_committed_tx_s"] == 4000.0
    assert doc["backend"] == "cuda" and doc["card"] is None and doc["card_flavor"] == "cuda-agg"
    jax_keys = {"metric", "resolved_platform", "chip_attached", "regime", "window_utc",
                "cpu_peak_committed_tx_s", "tpu_peak_committed_tx_s", "tpu_over_cpu",
                "acceptance", "runs"}
    assert jax_keys - {"resolved_platform", "chip_attached"} | {"card", "backend",
                                                                 "card_flavor"} == set(doc)


def test_no_service_window_is_sized_for_a_nodes_own_context(clean_env, monkeypatch):
    monkeypatch.delenv("MYSTICETI_NO_VERIFIER_SERVICE", raising=False)
    assert maxload_bench.probe_window("cuda-only", 8.0) == 8.0
    assert os.environ["INITIAL_DELAY"] == "1"
    monkeypatch.setenv("MYSTICETI_NO_VERIFIER_SERVICE", "1")
    assert maxload_bench.probe_window("cpu", 8.0) == 8.0
    assert maxload_bench.probe_window("cuda", 8.0) == maxload_bench.NO_SERVICE_MIN_DURATION_S
    assert os.environ["INITIAL_DELAY"] == str(maxload_bench.NO_SERVICE_INITIAL_DELAY_S)
    assert maxload_bench.probe_window("cuda-only", 90.0) == 90.0
    assert catchup_bench.first_verify_measures("cuda-only").endswith("kernel load from the "
                                                                      "build cache")
    monkeypatch.delenv("MYSTICETI_NO_VERIFIER_SERVICE")
    assert "warm verifier service" in catchup_bench.first_verify_measures("cuda-agg")


def test_runner_carries_the_regime_to_the_service_and_the_nodes(tmp_path, monkeypatch,
                                                              clean_env):
    """``LocalProcessRunner`` (children faked): the regime's knobs set in
    the tool's process reach genesis, the verifier service and every node;
    ``cleanup`` stops the service with SIGTERM, and with SIGKILL only when
    it outlives ``SERVICE_STOP_S``."""
    from test_torch_cli import _free_port_base

    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", _free_port_base(3))
    os.environ.update(maxload_bench.regime_env(16), INITIAL_DELAY="1")
    spawned, signals = [], []

    class Child:
        returncode = None
        pid = 4242

        def __init__(self, stubborn):
            self.stubborn = stubborn

        def send_signal(self, sig):
            signals.append(sig)
            if not (self.stubborn and sig == signal.SIGTERM):
                self.returncode = -sig

        async def wait(self):
            while self.returncode is None:
                await asyncio.sleep(0.01)
            return self.returncode

    def run(stubborn):
        async def fake_exec(*argv, env=None, stdout=None, stderr=None, cwd=None):
            spawned.append((argv, env))
            return Child(stubborn and "verifier-service" in argv)

        async def warm(self):
            return None

        monkeypatch.setattr(port_runner.asyncio, "create_subprocess_exec", fake_exec)
        monkeypatch.setattr(port_runner.LocalProcessRunner, "_await_service_warm", warm)
        monkeypatch.setattr(port_runner, "SERVICE_STOP_S", 0.2)
        runner = port_runner.LocalProcessRunner(str(tmp_path / "fleet"), verifier="cuda-only")

        async def main():
            await runner.configure(3, load_tx_s=300)
            for a in range(3):
                await runner.boot_node(a)
            await runner.cleanup()

        asyncio.run(main())
        return runner

    runner = run(stubborn=False)
    assert len(spawned) == 4 and "verifier-service" in spawned[0][0]
    for _argv, env in spawned:
        for key, value in dict(maxload_bench.regime_env(16), INITIAL_DELAY="1").items():
            assert env[key] == value
    assert runner.parameters.store_retain_rounds == 100000
    assert runner.parameters.leader_timeout_s == 0.25
    assert signals.count(signal.SIGKILL) == 3 and signals[-1] == signal.SIGTERM
    signals.clear()
    run(stubborn=True)
    assert signals[-2:] == [signal.SIGTERM, signal.SIGKILL]
