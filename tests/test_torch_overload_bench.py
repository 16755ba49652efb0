"""``python -m mysticeti_tpu_torch.tools.overload_bench`` on the ``cpu``
kind (its own file: it boots node processes): 3 validators, the 1x and 3x
rungs of 8 s at 300 tx/s, on free ports; its seeded determinism leg equals
the JAX tool's dict for dict, and ``chip_smoke.OVERLOAD_SEEDED`` is
recomputed from it."""
import importlib.util
import json
import os
import sys

from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.tools import overload_bench
from test_torch_cli import _free_port_base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _jax_leg():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_overload_bench", os.path.join(REPO, "tools", "overload_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.run_determinism_leg()


def test_main_on_the_cpu_kind_and_the_jax_tools_leg(tmp_path, monkeypatch):
    saved = dict(os.environ)
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", port_config.DEFAULT_PORT_BASE)
    out = tmp_path / "OVERLOAD_r19.json"
    try:
        for attempt in range(2):
            rc = overload_bench.main([
                "--verifier", "cpu", "--nodes", "3", "--base-load", "300",
                "--multipliers", "1", "3", "--duration", "8",
                "--port-base", str(_free_port_base(3)), "--workdir", str(tmp_path / "w"),
                "--out", str(out)])
            doc = json.loads(out.read_text())
            if all(r["committed_tx_s"] > 0 for r in doc["rungs"]):
                break
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert rc == (0 if doc["acceptance"]["no_collapse"] else 3)
    assert doc["metric"] == "overload_committed_vs_offered" and doc["card"] is None
    assert doc["verifier"] == "cpu" and doc["base_load_tx_s"] == 300 and doc["calibration"] is None
    assert [r["multiplier"] for r in doc["rungs"]] == [1, 3]
    for rung in doc["rungs"]:
        assert rung["offered_tx_s"] == 300 * rung["multiplier"]
        assert rung["committed_tx_s"] > 0 and rung["avg_latency_s"] > 0
        assert rung["scraped_nodes"] == 3 and rung["fleet"]["scraped_nodes"] == 3
        assert rung["fleet"]["verifier_fallback"] == 0 and rung["fleet"]["invalid_blocks"] == 0
        taken = rung["admitted_total"] + sum(rung["shed_total"].values())
        assert 0 < taken <= rung["offered_tx_s"] * rung["seconds"]
        assert set(rung["finality"]) == {"server_p50_s", "server_p99_s", "client_p50_s",
                                         "client_p99_s"}
    assert doc["acceptance"] == overload_bench.acceptance_of(doc["rungs"], doc["determinism"])
    assert doc["determinism"] == json.loads(json.dumps(_jax_leg()))


def test_overload_seeded_is_the_determinism_legs():
    leg = overload_bench.run_determinism_leg()
    assert leg["byte_identical"] and leg["sim_fully_accounted"]
    assert leg["shed_schedule_digest_run1"] == leg["shed_schedule_digest_run2"]
    assert {"shed_schedule_digest": leg["shed_schedule_digest_run1"],
            **{k: leg[k] for k in chip_smoke.OVERLOAD_SEEDED if k in leg}} == \
        chip_smoke.OVERLOAD_SEEDED
