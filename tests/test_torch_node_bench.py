"""``python -m mysticeti_tpu_torch.tools.node_bench`` on the ``cpu`` kind
(its own file: it boots node processes): 3 validators at 200 tx/s for 8 s
on free ports, then the saturation of the ``cpu`` oracle at the tool's
4,096-signature batch."""
import json
import os

from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.tools import node_bench
from test_torch_cli import _free_port_base


def test_main_on_the_cpu_kind(tmp_path, monkeypatch):
    saved = dict(os.environ)
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", port_config.DEFAULT_PORT_BASE)
    out = tmp_path / "NODE_BENCH_r19.json"
    try:
        assert node_bench.main([
            "--verifiers", "cpu", "--nodes", "3", "--duration", "8",
            "--port-base", str(_free_port_base(3)), "--workdir", str(tmp_path / "w"),
            "--out", str(out)]) == 0
    finally:
        os.environ.clear()
        os.environ.update(saved)
    doc = json.loads(out.read_text())
    assert doc["metric"] == "committed_tx_per_sec_by_verifier" and doc["card"] is None
    run, = doc["runs"]
    assert run["verifier"] == "cpu" and run["nodes"] == 3 and run["offered_load_tx_s"] == 200
    # The tool's own retry covers a window the fleet's warm-up overran.
    assert run["committed_tx_s"] > 0 and run["avg_latency_s"] > 0
    assert run["log_crashes"] == 0
    assert run["fleet"]["scraped_nodes"] == 3 and run["fleet"]["verifier_fallback"] == 0
    assert run["fleet"]["invalid_blocks"] == 0 and run["fleet"]["flushes"] > 0
    row, = doc["verifier_saturation"]
    assert row["verifier"] == "cpu" and row["batch"] == 4096 and row["iterations"] == 5
    assert row["all_valid"] and row["sig_per_sec"] > 0
    assert set(row["launches"].values()) == {0}
