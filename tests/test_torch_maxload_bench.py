"""``python -m mysticeti_tpu_torch.tools.maxload_bench`` on the ``cpu``
and ``accept`` kinds (its own file: it boots node processes, and under
``--dist loadfile`` a file is one worker's): one search iteration of 8 s on
3 validators, the ``accept`` run followed by its same-window ``cpu``
reference probe, moved to free ports.  Each probe's reference fields equal
the JAX tool's ``_probe_dicts`` over the collection the run saved."""
import importlib.util
import json
import os

from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.orchestrator.measurement import MeasurementsCollection
from mysticeti_tpu_torch.tools import maxload_bench
from test_torch_cli import _free_port_base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_probe_dicts(path):
    spec = importlib.util.spec_from_file_location(
        "jax_tool_maxload_bench", os.path.join(REPO, "tools", "maxload_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    from mysticeti_tpu.orchestrator.measurement import MeasurementsCollection as Jax

    return module._probe_dicts([Jax.load(path)])


def test_main_on_the_cpu_and_accept_kinds(tmp_path, monkeypatch):
    saved = dict(os.environ)
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", port_config.DEFAULT_PORT_BASE)
    out, wd = tmp_path / "MAXLOAD_r19.json", tmp_path / "w"
    try:
        # One retry: three validator processes on a fixed 8 s window are
        # sensitive to machine load in a full-suite run.
        for attempt in range(2):
            assert maxload_bench.main([
                "--verifiers", "cpu", "accept", "--nodes", "3", "--iterations", "1",
                "--duration", "8", "--port-base", str(_free_port_base(3)), "--workdir", str(wd),
                "--out", str(out)]) == 0
            doc = json.loads(out.read_text())
            probes = [p for run in doc["runs"] for p in run["probes"]] + [
                doc["runs"][1]["cpu_reference_probe"]]
            if all(p["tps"] > 0 for p in probes):
                break
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert doc["metric"] == "max_sustainable_load_tx_s" and doc["card"] is None
    assert [r["verifier"] for r in doc["runs"]] == ["cpu", "accept"]
    cpu, accept = doc["runs"]
    assert "cpu_reference_probe" not in cpu and cpu["nodes"] == 3
    ref = accept["cpu_reference_probe"]
    assert ref["verifier"] == "cpu" and ref["offered_load_tx_s"] == int(
        accept["peak_committed_tx_s"])
    assert accept["peak_vs_same_window_cpu"] == round(accept["peak_committed_tx_s"] / ref["tps"], 3)
    for run in doc["runs"]:
        assert run["max_sustainable_load_tx_s"] == 400 and len(run["probes"]) == 1
        assert run["peak_committed_tx_s"] == run["probes"][0]["tps"]
    for probe in probes:
        assert probe["tps"] > 0 and probe["avg_latency_s"] > 0
        fleet = probe["fleet"]
        assert fleet["scraped_nodes"] == 3 and fleet["verifier_fallback"] == 0
        assert fleet["invalid_blocks"] == 0
    assert cpu["probes"][0]["fleet"]["flushes"] > 0
    for verifier, probe in (("cpu", cpu["probes"][0]), ("accept", accept["probes"][0])):
        path = str(wd / f"results-{verifier}" / "measurements-0.json")
        ours = {k: v for k, v in probe.items() if k != "fleet"}
        theirs = _jax_probe_dicts(path)
        assert theirs == maxload_bench._probe_dicts([MeasurementsCollection.load(path)])
        assert [ours] == json.loads(json.dumps(theirs))
