"""``chip_smoke.py``'s epoch-10 constant off the card.

The whole script holds the card's epoch-10 run to ``EPOCH_SEEDED`` alone
(its ``cpu`` control runs only in the phase's ``_only`` entry), so the
constant is recomputed here from the ``cpu`` kind's run at the cell's full
width and depth, and the phase's checks must hold on it (both epoch boundaries
land fleet-wide, node 2 boots from its checkpoint past them, the roots agree
and the finalization oracle covers its rounds).  The run's fetches follow the
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

    result = c.epoch_run("cpu", c.EPOCH_10)
    c.epoch_checks(result, None, c.EPOCH_10)
    print(json.dumps(c.epoch_counts(result)))
""")


def test_seeded_counts_equal_the_cpu_kinds_run():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONHASHSEED=chip_smoke.HASH_SEED))
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts == json.loads(json.dumps(chip_smoke.EPOCH_SEEDED))
    assert (chip_smoke.EPOCH_10["n"], chip_smoke.EPOCH_10["virtual_s"]) == (10, 12.0)
