"""``python -m mysticeti_tpu_torch.tools.execution_bench --verifier
sim-oracle`` (the JAX tool's run: its fleet on the ``cpu`` kind, its sim on
the re-sign oracle), in a child under ``chip_smoke.HASH_SEED`` (its own
file: it boots node processes): 4 validators with the execution plane and
the gateways on free ports for 8 s at 1,000 tx/s plus the account workload,
the sim leg at 2 virtual s.  The sim leg equals the JAX tool's leg field for
field and ``chip_smoke.EXEC_SEEDED`` is recomputed from it; the fleet's
roots agree across its nodes and with the client's stream."""
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
spec = importlib.util.spec_from_file_location("jax_execution", os.path.join(REPO, "tools", "execution_bench.py"))
jax = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax)
from mysticeti_tpu_torch.tools import execution_bench
with tempfile.TemporaryDirectory() as d:
    want = jax.run_sim_leg(argparse.Namespace(sim_duration=2.0), os.path.join(d, "jax"))
for attempt in range(2):
    rc = execution_bench.main(["--verifier", "sim-oracle", "--duration", "8", "--sim-duration", "2",
                               "--port-base", str(BASE + 100 * attempt),
                               "--gateway-port-base", str(BASE + 50 + 100 * attempt),
                               "--workdir", WORK, "--out", OUT])
    doc = json.load(open(OUT))
    if doc["fleet"]["root_agreement"]["agree"]:
        break
print("RESULT " + json.dumps({"rc": rc, "doc": doc, "jax": want}))
"""


def test_main_and_the_seeded_sim_leg_equal_the_jax_tools(tmp_path):
    base = _free_port_base(60)
    code = (f"REPO = {REPO!r}; BASE = {base}; WORK = {str(tmp_path / 'w')!r}; "
            f"OUT = {str(tmp_path / 'EXEC.json')!r}\n" + CHILD)
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
    assert {k: sim[k] for k in chip_smoke.EXEC_SEEDED} == chip_smoke.EXEC_SEEDED
    assert sim["passed"] and sim["execution_ok"] and sim["byte_identical"]
    assert doc["determinism"] == {"byte_identical": True,
                                  "root_chain_digest": sim["root_chain_digest"]}
    assert doc["verifier"] == "sim-oracle" and doc["card"] is None
    fleet = doc["fleet"]
    assert fleet["verifier"] == "cpu" and fleet["nodes"] == 4 and fleet["load_tx_s"] == 1000
    agreement = fleet["root_agreement"]
    assert agreement["agree"] and agreement["forks"] == [] and agreement["shared_heights"] > 0
    assert fleet["all_nodes_executed"] and fleet["executed_height_min"] > 0
    assert fleet["subscriber"]["resume_reply"] is not None
    assert fleet["subscriber"]["executed_notifications"] > 0
    client = fleet["client"]
    assert client["submitted"] == client["accepted"] + client["shed"] > 0
    assert fleet["fleet"]["verifier_fallback"] == 0 and fleet["fleet"]["invalid_blocks"] == 0
    assert result["rc"] == 0 and all(doc["acceptance"].values())
