"""``chip_smoke.py``'s consensus-50 and netsync-50 constants off the card.

The whole script holds the card's runs of those two cells to
``CONSENSUS_SEEDED`` and ``NETSYNC_SEEDED`` alone (their ``cpu`` controls
run only in ``consensus_only`` / ``net_sync_only``), so each constant is
recomputed here from the ``cpu`` kind's run at the cell's full size.  The
runs' fetches follow the order of sets of block references, so each goes in
a child under ``chip_smoke.HASH_SEED``, as the script runs its phases.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CHILD = textwrap.dedent("""
    import json
    import logging
    import sys

    logging.disable(logging.CRITICAL)
    import chip_smoke as c

    run, keys = {"consensus": (c.consensus_run, c.CONSENSUS_KEYS),
                 "netsync": (c.netsync_run, c.NETSYNC_KEYS)}[sys.argv[1]]
    result = run("cpu", c.COMMITTEE, c.CONSENSUS_VIRTUAL_S, c.SEED)
    print(json.dumps(c.seeded_counts(result, keys)))
""")


@pytest.mark.parametrize("cell, seeded", [("consensus", chip_smoke.CONSENSUS_SEEDED),
                                          ("netsync", chip_smoke.NETSYNC_SEEDED)])
def test_seeded_counts_equal_the_cpu_kinds_run(cell, seeded):
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, cell], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONHASHSEED=chip_smoke.HASH_SEED))
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts == json.loads(json.dumps(seeded))
    assert min(counts["commits"]) >= chip_smoke.CONSENSUS_MIN_COMMITS
