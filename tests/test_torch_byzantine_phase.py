"""``chip_smoke.py``'s byzantine phase off the card: ``BYZANTINE_SEEDED``
against the JAX package's and the port's runs of byzantine-10, and the
phase's checks on the port's run.

The seeded runs' fetches follow the order of a set of block references, so
both runs go in a child under ``chip_smoke.HASH_SEED``, as the script runs
its phases.  The port's run takes the ``real_crypto`` path with the sim
re-sign oracle as its backend behind ``chip_smoke.VerdictLog``, so the
phase's checks 1, 2, 3 and 5 run on it as they run on the card's.
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

pytestmark = pytest.mark.byzantine

CHILD = textwrap.dedent("""
    import json
    import logging

    logging.disable(logging.CRITICAL)
    import chip_smoke as c
    from mysticeti_tpu import scenarios as J
    from mysticeti_tpu_torch import scenarios as P
    from mysticeti_tpu_torch.committee import Committee

    jax = c.byzantine_run(J, c.BYZANTINE_10)
    committee = Committee.new_for_benchmarks(10)
    log = c.VerdictLog(P.SimResignOracleVerifier(committee))
    port = c.byzantine_run(P, c.BYZANTINE_10, backend=log)
    reading = c.byzantine_checks(port, c.BYZANTINE_10, c.BYZANTINE_SEEDED)
    verdicts = c.verdict_checks(log, committee)
    print(json.dumps({"jax": c.byzantine_counts(jax), "port": c.byzantine_counts(port),
                      "jax_doc": jax["doc"], "port_doc": port["doc"],
                      "dispatches": len(log.dispatches), "reading": reading,
                      "verdicts": verdicts}))
""")


def test_seeded_counts_equal_both_packages_runs_and_the_checks_hold():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=REPO, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONHASHSEED=chip_smoke.HASH_SEED, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    seeded = json.loads(json.dumps(chip_smoke.BYZANTINE_SEEDED))
    assert out["jax"] == seeded
    assert out["port"] == seeded
    assert out["port_doc"] == out["jax_doc"] and out["port_doc"]["passed"]
    assert out["dispatches"] == sum(seeded["flushes"])
    assert out["verdicts"]["mismatches"] == 0
    assert out["verdicts"]["oracle_rejected"] == sum(seeded["rejected"])
    assert out["reading"]["commits"] == seeded["commits"]
