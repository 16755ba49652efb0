"""Resilience scenario-matrix probe -> a ``SCENARIO_rNN.json`` document.

The port's copy of the JAX package's ``tools/scenario_matrix.py``.  Runs the
declarative Byzantine scenario matrix (:mod:`mysticeti_tpu_torch.scenarios`)
— every entry an attacked seeded sim plus a same-seed clean twin — and
writes the per-scenario verdicts:

* **safety** — zero honest-node SafetyChecker violations per scenario;
* **liveness** — honest-authored committed throughput >= the scenario's
  ``min_ratio`` x the clean twin;
* **detection** — every injected attack detected on its counter surface
  (equivocation / invalid-signature / malformed) or accounted in the
  attack ledger (the silence-shaped behaviors);
* **reproducibility** — schedule / attack / detection / sequence digests
  recorded per scenario, so a same-seed re-run is byte-checkable.

A ``--determinism`` pass re-runs the first scenario on the same seed and
asserts the digests match — the artifact then carries the proof, not just
the claim.  Both legs verify every block through ``--verifier``, the
``scenarios`` subcommand's choice: by default ``cuda-only``, the port's
kernels on the card (``--device``, default ``cuda``), which raises without
one; ``sim-oracle`` is the JAX tool's default, the sim re-sign oracle.
``--real-crypto``, the JAX tool's flag, is ``--verifier cuda-only``.

Usage::

    python -m mysticeti_tpu_torch.tools.scenario_matrix [--out build/SCENARIO_r12.json] [--quick]
        [--verifier sim-oracle]

The default ``--out`` lies under the checkout's ``build/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from mysticeti_tpu_torch.cli import DEFAULT_VERIFIER, SIM_VERIFIER_CHOICES
from mysticeti_tpu_torch.scenarios import (
    ACCELERATOR_KIND,
    default_matrix,
    run_matrix,
    run_scenario,
    scenario_by_name,
)
from mysticeti_tpu_torch.tools import build_path, write_json

DEFAULT_OUT = build_path("SCENARIO_r12.json")


def determinism_leg(name: str, quick: bool, verifier: str, device=None) -> dict:
    """Same scenario, same seed, twice, through ``verifier`` on ``device``:
    the digests must be identical."""
    import tempfile

    scenario = scenario_by_name(name)
    if quick:
        scenario = dataclasses.replace(scenario, duration_s=6.0)
    digests = []
    for run in range(2):
        with tempfile.TemporaryDirectory(prefix="scenario-det-") as root:
            verdict = run_scenario(scenario, root, device=device, verifier=verifier)
        digests.append(verdict["digests"])
    return {
        "scenario": name,
        "runs": digests,
        "byte_identical": digests[0] == digests[1],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--quick", action="store_true",
                        help="shortened scenarios (smoke, not acceptance)")
    parser.add_argument("--scenario", default=None,
                        help="run only this named scenario")
    parser.add_argument("--no-determinism", action="store_true",
                        help="skip the same-seed re-run leg")
    verifier = parser.add_mutually_exclusive_group()
    verifier.add_argument("--verifier", choices=SIM_VERIFIER_CHOICES,
                          default=DEFAULT_VERIFIER,
                          help="each node's signature verifier; sim-oracle: "
                          "the sim re-sign oracle (same semantics)")
    verifier.add_argument("--real-crypto", dest="verifier", action="store_const",
                          const=ACCELERATOR_KIND,
                          help=f"--verifier {ACCELERATOR_KIND}: genuine Ed25519 "
                          "verification through the port's kernels on the card")
    parser.add_argument("--device", default=None,
                        help="torch device of the kernel kinds (default cuda; "
                        "cpu runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    scenarios = default_matrix()
    if args.scenario:
        scenarios = [scenario_by_name(args.scenario)]
    if args.quick:
        scenarios = [
            dataclasses.replace(s, duration_s=min(s.duration_s, 8.0))
            for s in scenarios
        ]
    t0 = time.monotonic()
    doc = run_matrix(scenarios, device=args.device, verifier=args.verifier)
    doc.update(
        probe="resilience-scenario-matrix",
        revision="r12",
        quick=bool(args.quick),
        wall_s=round(time.monotonic() - t0, 1),
    )
    for verdict in doc["scenarios"]:
        name = verdict["scenario"]["name"]
        print(
            f"{name:<24} {'PASS' if verdict['passed'] else 'FAIL'}  "
            f"ratio={verdict.get('throughput_ratio', 0.0):.2f}  "
            f"attacks={sum(verdict.get('attack_counts', {}).values())}",
            flush=True,
        )
    if not args.no_determinism:
        print("== determinism leg ==", flush=True)
        doc["determinism"] = determinism_leg(
            scenarios[0].name, args.quick, args.verifier, args.device
        )
        print(f"byte_identical: {doc['determinism']['byte_identical']}")
    write_json(args.out, doc, indent=1, sort_keys=True)
    print(f"wrote {args.out} ({doc['passed']} passed, {doc['failed']} failed)")
    # The determinism leg gates the exit code too: a byte_identical=false
    # run is a regression even when every scenario verdict passes.
    deterministic = (doc.get("determinism") or {}).get("byte_identical", True)
    return 0 if doc["all_pass"] and deterministic else 1


if __name__ == "__main__":
    sys.exit(main())
