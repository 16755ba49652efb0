"""``chip_smoke.py``'s ingress-10 constant off the card.

The whole script holds the card's ingress-10 run to ``INGRESS_SEEDED`` alone (its
``cpu`` control runs only in the phase's ``_only`` entry), so the constant
is recomputed here from the ``cpu`` kind's run at the cell's full width and
depth, and the phase's checks must hold on it (their gates stay reachable:
the 3x step sheds and the clients retry).  The run's fetches follow the
order of sets of block references, so it goes in a child under
``chip_smoke.HASH_SEED``, as the script runs its phases.
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

    result = c.ingress_run("cpu", c.INGRESS_10)
    c.ingress_checks(result, None, c.INGRESS_10)
    print(json.dumps(c.ingress_counts(result)))
""")


def test_seeded_counts_equal_the_cpu_kinds_run():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONHASHSEED=chip_smoke.HASH_SEED))
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts == json.loads(json.dumps(chip_smoke.INGRESS_SEEDED))
    assert chip_smoke.INGRESS_10["virtual_s"] == 12.0
