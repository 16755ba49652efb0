"""``chip_smoke.STORAGE_PROBE_SEEDED`` off the card.

The script's tools step holds the card's ``storage_probe --quick --verifier
cuda-only`` on ``chip_smoke.STORAGE_PROBE_SCENARIOS`` to that constant, so
it is recomputed here from the same tool and scenarios on the ``cpu`` kind
(each node's collector over the CPU oracle, the card run's 2 ms window:
verdict for verdict equal runs commit alike), in a child under
``chip_smoke.HASH_SEED`` as the script runs its phases.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mysticeti_tpu_torch.tools.storage_probe import deterministic  # noqa: E402


def test_storage_probe_seeded_equals_the_cpu_kinds_run(tmp_path):
    out = str(tmp_path / "STORAGE.json")
    proc = subprocess.run(
        [sys.executable, "-m", "mysticeti_tpu_torch.tools.storage_probe", "--quick",
         "--verifier", "cpu", "--out", out,
         *(a for name in chip_smoke.STORAGE_PROBE_SCENARIOS for a in ("--scenario", name))],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONHASHSEED=chip_smoke.HASH_SEED))
    assert proc.returncode == 0, proc.stderr[-4000:]
    doc = json.loads(open(out).read())
    assert doc["verifier"] == "cpu"
    assert deterministic(doc) == json.loads(json.dumps(chip_smoke.STORAGE_PROBE_SEEDED))
