"""``python -m mysticeti_tpu_torch.tools.finality_bench --verifier sim-oracle``
(the JAX tool's run: its fleet on the ``cpu`` kind, its sim on the re-sign
oracle), in a child under ``chip_smoke.HASH_SEED`` (its own file: it boots
node processes): 4 validators for 8 s at 2,000 tx/s on free ports, the sim
leg at 2 virtual s.  The sim leg equals the JAX tool's leg field for field
and ``chip_smoke.FINALITY_SEEDED`` is recomputed from it; the fleet leg
records decisions on every node with no batch degraded and no invalid
block."""
import json
import os
import subprocess
import sys

from test_torch_cli import _free_port_base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CHILD = r"""
import argparse, importlib.util, json, os, sys, tempfile
spec = importlib.util.spec_from_file_location("jax_finality", os.path.join(REPO, "tools", "finality_bench.py"))
jax = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax)
from mysticeti_tpu_torch.tools import finality_bench
with tempfile.TemporaryDirectory() as d:
    want = jax.run_sim_leg(argparse.Namespace(sim_duration=2.0), os.path.join(d, "jax"))
for attempt in range(2):
    rc = finality_bench.main(["--verifier", "sim-oracle", "--duration", "8", "--sim-duration", "2",
                              "--port-base", str(BASE + 100 * attempt), "--workdir", WORK,
                              "--out", OUT])
    doc = json.load(open(OUT))
    if doc["fleet"]["decisions_recorded_all_nodes"]:
        break
print("RESULT " + json.dumps({"rc": rc, "doc": doc, "jax": want}))
"""


def test_main_and_the_seeded_sim_leg_equal_the_jax_tools(tmp_path):
    base = _free_port_base(4)
    code = (f"REPO = {REPO!r}; BASE = {base}; WORK = {str(tmp_path / 'w')!r}; "
            f"OUT = {str(tmp_path / 'FINALITY.json')!r}\n" + CHILD)
    env = dict(os.environ, PYTHONHASHSEED=chip_smoke.HASH_SEED, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO] + ([os.environ["PYTHONPATH"]]
                                                    if os.environ.get("PYTHONPATH") else [])))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stderr[-3000:]
    result = json.loads(lines[-1][len("RESULT "):])
    doc, jax = result["doc"], result["jax"]
    sim = doc["sim"]
    assert sim.pop("launches") == {"prologue": 0, "prologue_flat": 0, "verify_generic": 0,
                                   "verify_keyed": 0}
    assert sim.pop("verifier") == "sim-oracle"
    assert sim == json.loads(json.dumps(jax))
    assert {k: sim[k] for k in chip_smoke.FINALITY_SEEDED} == chip_smoke.FINALITY_SEEDED
    assert sim["every_slot_explained"] and sim["byte_identical"] and sim["duration_s"] == 2.0
    assert doc["determinism"] == {"byte_identical": True, "digest": sim["digest"]}
    assert doc["verifier"] == "sim-oracle" and doc["card"] is None
    fleet = doc["fleet"]
    assert fleet["verifier"] == "cpu" and fleet["nodes"] == 4 and fleet["load_tx_s"] == 2000
    assert fleet["decisions_recorded_all_nodes"]
    assert fleet["fleet"]["verifier_fallback"] == 0 and fleet["fleet"]["invalid_blocks"] == 0
    assert fleet["fleet"]["scraped_nodes"] == 4 and fleet["server"]["samples"] == 4
    assert all(0 < rec["server_p50_s"] <= rec["server_p99_s"] for rec in fleet["per_node"].values())
    assert result["rc"] == (0 if all(doc["acceptance"].values()) else 3)
    assert set(doc["acceptance"]) == {"every_slot_explained", "client_cross_check",
                                      "decisions_on_every_node"}
