"""Epoch-reconfiguration probe -> a ``RECONFIG_rNN.json`` document.

The port's copy of the JAX repository's ``tools/reconfig_matrix.py``.  Three
legs:

* **continuous-churn matrix** — the reconfig scenario family
  (``scenarios.reconfig_matrix``): seeded 10-node sims with live adversaries
  where the committee reweights, a registered-at-zero authority joins via
  snapshot catch-up, and a member departs — every honest node must agree on
  each epoch boundary (height, digest), joiners must commit, and throughput
  must hold against the same-churn clean twin;
* **determinism** — the continuous-churn scenario re-run on the same seed
  must be byte-identical (schedule / attack / detection / sequence digests)
  across BOTH epoch boundaries;
* **live** — a real-socket 4-node localhost testbed under generator load
  performs one add-node epoch (a registered stake-0 validator is activated
  by a committed change, then boots and catches up) and one remove-node
  epoch (an active member is deactivated and retired); every surviving
  validator must land on epoch 2 with prefix-consistent commits.

Every leg verifies through ``--verifier``: by default ``cuda-only``, the
port's kernels on the card (``--device``, default ``cuda``), which raises
without one; ``sim-oracle`` is the JAX tool's run (the sim re-sign oracle in
the sims, the ``cpu`` kind in the live leg).  ``--real-crypto``, the JAX
tool's flag, is ``--verifier cuda-only``.  A card kind builds the kernels in
this process first.  The document adds ``card`` (nvidia-smi's name and power
limit, None without a card) and ``verifier``; the live leg adds the kind its
validators ran, ``launches`` (the kernels' launches in this process
across both boundaries) and apart from them ``warmup_launches`` (the
validators' verifier warm-ups').  The live leg's validators run in ``--workdir``
(emptied first) on ``benchmark-genesis``'s ports, which ``--port-base``
moves.

Usage::

    python -m mysticeti_tpu_torch.tools.reconfig_matrix [--out build/RECONFIG_r18.json] [--quick]
    python -m mysticeti_tpu_torch.tools.reconfig_matrix --no-matrix --no-determinism --verifier cpu
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import shutil
import sys
import tempfile
import time

from mysticeti_tpu_torch.cli import DEFAULT_VERIFIER, SIM_VERIFIER_CHOICES
from mysticeti_tpu_torch.reconfig import CHANGE_ADD, CHANGE_REMOVE, CommitteeChange
from mysticeti_tpu_torch.scenarios import (
    ACCELERATOR_KIND,
    ORACLE_KIND,
    reconfig_matrix,
    run_reconfig_matrix,
    run_scenario,
    scenario_by_name,
)
from mysticeti_tpu_torch.tools import (
    build_path,
    card,
    launch_counts,
    launches_since,
    node_kind,
    warmups_since,
    write_json,
)
from mysticeti_tpu_torch.tools.maxload_bench import card_kind, prewarm, set_port_base

DEFAULT_OUT = build_path("RECONFIG_r18.json")
DEFAULT_WORKDIR = build_path("reconfig-live")

# The live leg's schedule, wall seconds: generator warm-up and steady
# commits; the ADD's commit; the joiner's catch-up; the REMOVE's commit;
# the survivors past the departure.
LIVE_SCHEDULE_S = {"warmup": 6.0, "add": 3.0, "join": 6.0, "remove": 5.0, "retire": 5.0}


def determinism_leg(name: str, verifier: str = ORACLE_KIND, device=None) -> dict:
    """Same churn scenario, same seed, twice: digests must be identical."""
    scenario = scenario_by_name(name)
    digests = []
    for _ in range(2):
        with tempfile.TemporaryDirectory(prefix="reconfig-det-") as root:
            verdict = run_scenario(scenario, root, device=device, verifier=verifier)
        digests.append(verdict["digests"])
    return {
        "scenario": name,
        "runs": digests,
        "byte_identical": digests[0] == digests[1],
    }


# ---------------------------------------------------------------------------
# Live testbed leg: one add-node and one remove-node epoch under load


async def _live_epoch_cycle(working_dir: str, tps: int, verifier: str = ACCELERATOR_KIND,
                            device=None) -> dict:
    from mysticeti_tpu_torch.cli import benchmark_genesis
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters, PrivateConfig
    from mysticeti_tpu_torch.validator import Validator

    n = 4
    add_authority, remove_authority = 3, 2
    schedule = LIVE_SCHEDULE_S
    benchmark_genesis(["127.0.0.1"] * n, working_dir)
    registry = Committee.load(os.path.join(working_dir, "committee.yaml"))
    # Stable-index registration: validator 3's key is in the genesis
    # registry at stake 0 — the ADD activates it, no key onboarding.
    genesis = registry.with_stakes([1, 1, 1, 0], 0)
    parameters = Parameters.load(os.path.join(working_dir, "parameters.yaml"))
    parameters.reconfig = True
    signers = Committee.benchmark_signers(n)

    async def boot(i: int) -> Validator:
        private = PrivateConfig.new_in_dir(
            i, os.path.join(working_dir, f"validator-{i}")
        )
        return await Validator.start_benchmarking(
            i, genesis, parameters, private,
            signer=signers[i], tps=tps, serve_metrics_endpoint=False,
            verifier=verifier, device=device,
        )

    validators: dict = {}
    commits: dict = {}

    def epoch_of(i: int) -> int:
        core = validators[i].core
        return core.reconfig.epoch if core.reconfig is not None else 0

    launches0, warmups0 = launch_counts(), launch_counts(warmup=True)
    try:
        for i in range(n):
            if i != add_authority:
                validators[i] = await boot(i)
        await asyncio.sleep(schedule["warmup"])  # generator warm-up + steady commits

        # Epoch 1: activate the registered stake-0 validator.  The change
        # rides validator 0's next proposal as an ordinary Share.
        validators[0].core.block_handler.submit(
            [CommitteeChange(CHANGE_ADD, add_authority, 1).to_bytes()]
        )
        await asyncio.sleep(schedule["add"])
        # The joiner boots from an empty WAL and catches up block-by-block,
        # re-deriving the boundary from the committed sequence itself.
        validators[add_authority] = await boot(add_authority)
        await asyncio.sleep(schedule["join"])

        # Epoch 2: deactivate an active member, then retire its process.
        validators[0].core.block_handler.submit(
            [CommitteeChange(CHANGE_REMOVE, remove_authority).to_bytes()]
        )
        await asyncio.sleep(schedule["remove"])
        removed_epoch = epoch_of(remove_authority)
        commits[remove_authority] = validators[remove_authority].committed_leaders()
        await validators[remove_authority].stop()
        departed = validators.pop(remove_authority)
        del departed
        await asyncio.sleep(schedule["retire"])

        epochs = {i: epoch_of(i) for i in sorted(validators)}
        epochs[remove_authority] = removed_epoch
        for i in sorted(validators):
            commits[i] = validators[i].committed_leaders()
    finally:
        for v in validators.values():
            await v.stop()
    launches = launches_since(launches0, warmups0)

    survivors = [i for i in range(n) if i != remove_authority]
    sequences = {i: commits.get(i, []) for i in commits}
    longest = max(sequences.values(), key=len, default=[])
    prefix_ok = all(seq == longest[: len(seq)] for seq in sequences.values())
    joiner_commits = len(sequences.get(add_authority, []))
    epochs_reached = min(epochs.get(i, 0) for i in survivors)
    passed = (
        epochs_reached >= 2
        and epochs.get(remove_authority, 0) >= 1
        and joiner_commits > 0
        and prefix_ok
    )
    return {
        "passed": passed,
        "nodes": n,
        "epochs_reached": epochs_reached,
        "epochs": {str(i): e for i, e in sorted(epochs.items())},
        "add_authority": add_authority,
        "remove_authority": remove_authority,
        "joiner_commits": joiner_commits,
        "commits": {str(i): len(seq) for i, seq in sorted(sequences.items())},
        "prefix_consistent": prefix_ok,
        "tps": tps,
        "verifier": verifier,
        "launches": launches,
        "warmup_launches": warmups_since(warmups0),
    }


def live_leg(tps: int, verifier: str = ACCELERATOR_KIND, device=None,
             workdir: str = DEFAULT_WORKDIR) -> dict:
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    return asyncio.run(_live_epoch_cycle(workdir, tps, node_kind(verifier), device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--quick", action="store_true",
                        help="shortened scenarios (smoke, not acceptance: "
                        "short runs may not reach every min_epoch gate)")
    parser.add_argument("--scenario", default=None,
                        help="run only this named scenario")
    parser.add_argument("--no-matrix", action="store_true",
                        help="skip the scenario matrix (run only the other "
                        "legs; a wrapper merges the per-leg documents when "
                        "one wall-clock budget cannot fit all three)")
    parser.add_argument("--no-determinism", action="store_true",
                        help="skip the same-seed re-run leg")
    parser.add_argument("--no-live", action="store_true",
                        help="skip the real-socket 4-node testbed leg")
    parser.add_argument("--tps", type=int, default=20,
                        help="per-validator generator load for the live leg")
    verifier = parser.add_mutually_exclusive_group()
    verifier.add_argument("--verifier", choices=SIM_VERIFIER_CHOICES, default=DEFAULT_VERIFIER,
                          help="every leg's signature verifier; sim-oracle: the JAX "
                          "tool's run (the sim re-sign oracle, cpu in the live leg)")
    verifier.add_argument("--real-crypto", dest="verifier", action="store_const",
                          const=ACCELERATOR_KIND,
                          help=f"--verifier {ACCELERATOR_KIND}: genuine Ed25519 "
                          "verification through the port's kernels on the card")
    parser.add_argument("--device", default=None,
                        help="torch device of the kernel kinds (default cuda; "
                        "cpu runs the kernels' plain versions)")
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR,
                        help="the live leg's working directory (emptied first)")
    parser.add_argument("--port-base", type=int, default=None,
                        help="the live leg's first node port (metrics +1000); "
                        "default benchmark-genesis's 1500")
    args = parser.parse_args(argv)
    set_port_base(args.port_base)
    if card_kind(args.verifier) and args.device != "cpu":
        print("prewarming the kernels...", flush=True)
        prewarm(4, device=args.device or "cuda:0")

    scenarios = reconfig_matrix()
    if args.scenario:
        scenarios = [scenario_by_name(args.scenario)]
    if args.quick:
        scenarios = [
            dataclasses.replace(s, duration_s=min(s.duration_s, 12.0))
            for s in scenarios
        ]
    t0 = time.monotonic()
    if args.no_matrix:
        doc = {
            "kind": "mysticeti-reconfig-matrix",
            "metric": "reconfig",
            "scenarios": [],
            "passed": 0,
            "failed": 0,
            "all_pass": True,
        }
    else:
        doc = run_reconfig_matrix(scenarios, device=args.device, verifier=args.verifier)
    doc.update(
        probe="epoch-reconfig-matrix",
        revision="r18",
        quick=bool(args.quick),
        verifier=args.verifier,
        card=card(),
    )
    for verdict in doc["scenarios"]:
        name = verdict["scenario"]["name"]
        print(
            f"{name:<32} {'PASS' if verdict['passed'] else 'FAIL'}  "
            f"ratio={verdict.get('throughput_ratio', 0.0):.2f}  "
            f"epochs={verdict.get('max_epoch', 0)}",
            flush=True,
        )
    if not args.no_determinism:
        print("== determinism leg ==", flush=True)
        doc["determinism"] = determinism_leg(scenarios[0].name, args.verifier, args.device)
        print(f"byte_identical: {doc['determinism']['byte_identical']}")
    if not args.no_live:
        print("== live testbed leg (4 nodes, add + remove epoch) ==",
              flush=True)
        doc["live"] = live_leg(args.tps, args.verifier, args.device, args.workdir)
        print(
            f"live: {'PASS' if doc['live']['passed'] else 'FAIL'}  "
            f"epochs={doc['live']['epochs']}  "
            f"joiner_commits={doc['live']['joiner_commits']}"
        )
    doc["wall_s"] = round(time.monotonic() - t0, 1)
    write_json(args.out, doc, indent=1, sort_keys=True)
    print(f"wrote {args.out} ({doc['passed']} passed, {doc['failed']} failed)")
    deterministic = (doc.get("determinism") or {}).get("byte_identical", True)
    live_ok = (doc.get("live") or {}).get("passed", True)
    return 0 if doc["all_pass"] and deterministic and live_ok else 1


if __name__ == "__main__":
    sys.exit(main())
