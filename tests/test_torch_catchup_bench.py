"""``python -m mysticeti_tpu_torch.tools.catchup_bench`` on the ``cpu``
kind (its own file: it boots node processes) at the smallest shape where a
backlog forms here: 4 validators at 400 tx/s, node 3 down 5 s (the tool's
7 at 3,200 tx/s with 45 s down take minutes), on free ports."""
import json
import os

from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.tools import catchup_bench
from test_torch_cli import _free_port_base


def test_main_on_the_cpu_kind(tmp_path, monkeypatch):
    saved = dict(os.environ)
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", port_config.DEFAULT_PORT_BASE)
    out = tmp_path / "CATCHUP_r19.json"
    try:
        for attempt in range(2):
            assert catchup_bench.main([
                "--verifiers", "cpu", "--nodes", "4", "--load", "400", "--down", "5",
                "--port-base", str(_free_port_base(4)), "--workdir", str(tmp_path / "w"),
                "--out", str(out)]) == 0
            doc = json.loads(out.read_text())
            run, = doc["runs"]
            if "error" not in run and run.get("reboot_to_caught_up_s") is not None:
                break
        regime = {k: os.environ.get(k) for k in ("MYSTICETI_MAX_BLOCK_TX",
                                                 "MYSTICETI_RETAIN_ROUNDS",
                                                 "MYSTICETI_LEADER_TIMEOUT", "INITIAL_DELAY")}
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert regime == {"MYSTICETI_MAX_BLOCK_TX": "16", "MYSTICETI_RETAIN_ROUNDS": "100000",
                      "MYSTICETI_LEADER_TIMEOUT": "0.25", "INITIAL_DELAY": "1"}
    assert doc["metric"] == "crash_recovery_catchup_by_verifier" and doc["card"] is None
    assert doc["config"] == dict(doc["config"], nodes=4, offered_load_tx_s=400, down_s=5.0,
                                 max_block_tx=16)
    assert "error" not in run, run
    assert run["steady_tps"] > 0 and run["backlog_rounds"] > 0
    assert run["first_verify_measures"] == catchup_bench.first_verify_measures("cpu")
    for key in ("reboot_to_metrics_s", "reboot_to_first_verify_s", "reboot_to_caught_up_s"):
        assert run[key] is not None and run[key] >= 0
    assert run["reboot_to_metrics_s"] <= run["reboot_to_caught_up_s"]
    sigs = run["catchup_verification"]
    assert sigs["direct"] > 0 and sigs["skipped"] == 0 and sigs["rejected"] == 0
    assert sorted(run["health_after_recovery"]["reachable"]) == ["0", "1", "2", "3"]
    assert run["fleet"]["scraped_nodes"] == 4 and run["fleet"]["verifier_fallback"] == 0
    assert run["fleet"]["invalid_blocks"] == 0
    victim = run["victim_at_finish"]
    assert victim["scraped_nodes"] == 1 and 0 < victim["flushes"] <= victim["dispatched_lanes"]
