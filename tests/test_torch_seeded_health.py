"""``chip_smoke.py``'s health-sim-10 constant off the card.

The whole script holds the card's health-sim-10 run to ``HEALTH_SEEDED`` alone (its
``cpu`` control runs only in the phase's ``_only`` entry), and its
depth was cut to 10 virtual s to make room for the last tools' step, so the
constant is recomputed here from the ``cpu`` kind's run at the cell's full
width and that depth, and the phase's checks must hold on it (their gates
stay reachable).  The run's fetches follow the order of sets of block
references, so it goes in a child under ``chip_smoke.HASH_SEED``, as the
script runs its phases.
"""
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CHILD = textwrap.dedent("""
    import json
    import logging

    logging.disable(logging.CRITICAL)
    import chip_smoke as c

    result = c.health_sim_run("cpu", c.HEALTH_SIM_10)
    c.health_sim_checks(result, None, c.HEALTH_SIM_10)
    print(json.dumps(c.health_sim_counts(result)))
""")


def test_seeded_counts_equal_the_cpu_kinds_run():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONHASHSEED=chip_smoke.HASH_SEED))
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts == json.loads(json.dumps(chip_smoke.HEALTH_SEEDED))
    assert chip_smoke.HEALTH_SIM_10["virtual_s"] == 10.0
