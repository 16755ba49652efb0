"""Storage lifecycle acceptance probe -> a STORAGE document.

The port's copy of the JAX package's ``tools/storage_probe.py``.  Two
deterministic sims on the virtual-time loop (no real network), exercising
the storage plane end-to-end at the scale the acceptance criteria name:

1. **bounded-disk**: a 4-node fleet under load with small segments,
   checkpoints every few commits, and an aggressive GC depth; one node
   crash-restarts mid-run.  Evidence: segments below the GC round are
   deleted while the fleet keeps committing (live bytes << lifetime bytes
   written), and the restarted node boots from a checkpoint, replaying only
   post-checkpoint segments (replay bytes << lifetime WAL bytes).

2. **snapshot-catchup**: a node is absent for >= 1000 rounds (its history
   GC'd fleet-wide, so block-by-block pull from round zero is impossible),
   rejoins via the snapshot stream (wire tags 9/10), and commits the same
   leader sequence as the fleet — asserted at every shared height, plus the
   adopted anchor.  Catch-up wall-clock (virtual and host), blocks, and
   bytes are recorded.

Every node verifies its blocks through ``--verifier``, as the CLI's
``chaos`` does: by default ``cuda-only`` (each node's collector over one
``TorchSignatureVerifier`` on ``--device``, default ``cuda``; raises without
a card); ``sim-oracle`` is the JAX tool's own run (its plans have no
adversaries, so no verifier).  The document adds ``verifier``, ``card`` and
each scenario's kernel ``launches``; :func:`deterministic` is what a seeded
run reproduces on any host.  The default ``--out`` lies under ``build/``.

``--scenario`` runs one scenario alone (the JAX tool always runs both).

Usage::

    python -m mysticeti_tpu_torch.tools.storage_probe [--out build/STORAGE_r08.json] [--quick]
        [--verifier sim-oracle] [--scenario bounded-disk]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from mysticeti_tpu_torch.chaos import CrashFault, FaultPlan, run_chaos_sim
from mysticeti_tpu_torch.cli import DEFAULT_VERIFIER, SIM_ORACLE, SIM_VERIFIER_CHOICES
from mysticeti_tpu_torch.config import Parameters, StorageParameters
from mysticeti_tpu_torch.tools import build_path, card, launch_counts, write_json

DEFAULT_OUT = build_path("STORAGE_r08.json")
NODES = 4
# Per-scenario readings that a seeded run does not reproduce.
VOLATILE = ("wall_s", "launches")


SCENARIOS = {"bounded-disk": "bounded_disk", "snapshot-catchup": "snapshot_catchup"}


def deterministic(doc: dict) -> dict:
    """The scenarios' readings less their wall seconds and launches: the
    commit heights, WAL bytes, the restart's checkpoint, replay start and
    bytes, the adopted anchor and the catch-up's blocks and bytes."""
    return {name: {k: v for k, v in doc[name].items() if k not in VOLATILE}
            for name in SCENARIOS.values() if name in doc}


def verifier_kwargs(verifier: str, device=None) -> dict:
    """``run_chaos_sim``'s verifier arguments for a ``--verifier`` kind, as
    the CLI's ``chaos`` builds them: nothing for ``sim-oracle`` (a plan
    without adversaries then verifies nothing, as in the JAX tool), else
    the benchmark committee and ``scenarios.verifier_factory`` (one backend,
    made and warmed here, for every node and both scenarios)."""
    if verifier == SIM_ORACLE:
        return {}
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.scenarios import verifier_factory

    committee = Committee.new_for_benchmarks(NODES)
    return {"committee": committee,
            "verifier_factory": verifier_factory(verifier, committee, device=device)}


def _require(ok: bool, what: str) -> None:
    """The JAX tool's acceptance assertions, kept under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def _run(plan, duration, wal_dir, parameters, verifier):
    """``run_chaos_sim`` with the launch counts set to 0 first: (report,
    harness, wall seconds, launches)."""
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    for k in K.KERNELS:
        k.reset_counts()
    t0 = time.monotonic()
    report, harness = run_chaos_sim(
        plan, NODES, duration, wal_dir, parameters=parameters, with_metrics=True,
        **verifier)
    return report, harness, time.monotonic() - t0, launch_counts()


def bounded_disk_scenario(quick: bool, verifier: dict) -> dict:
    duration = 20.0 if quick else 60.0
    parameters = Parameters(
        leader_timeout_s=1.0,
        storage=StorageParameters(
            segment_bytes=16 * 1024, checkpoint_interval=10, gc_depth=30
        ),
    )
    plan = FaultPlan(
        seed=8,
        crashes=[CrashFault(node=2, at_s=duration * 0.6, downtime_s=2.0)],
    )
    with tempfile.TemporaryDirectory(prefix="storage-probe-disk-") as wal_dir:
        report, harness, wall, launches = _run(plan, duration, wal_dir, parameters, verifier)
        return _bounded_disk_result(harness, duration, wall, launches)


def _bounded_disk_result(harness, duration, wall, launches) -> dict:
    nodes = {}
    for authority in range(4):
        node = harness.nodes[authority]
        writer = node.core.wal_writer
        metrics = harness.metrics[authority]
        nodes[str(authority)] = {
            "commit_height": harness.committed_height(authority),
            "lifetime_wal_bytes": writer.position(),
            "live_wal_bytes": writer.size_bytes(),
            "live_segments": writer.segment_count(),
            "first_live_offset": writer.first_base(),
            "reclaimed_bytes": metrics.wal_reclaimed_bytes_total._value.get(),
            "last_checkpoint_height": metrics.checkpoint_last_commit_index._value.get(),
            "retired_round": node.core.storage.retired_round,
        }
    restarted = harness.nodes[2].core.storage
    lifetime = harness.nodes[2].core.wal_writer.position()
    result = {
        "virtual_duration_s": duration,
        "wall_s": round(wall, 2),
        "nodes": nodes,
        "launches": launches,
        "restart": {
            "node": 2,
            "recovered_checkpoint_height": restarted.recovered_checkpoint_height,
            "replay_start": restarted.replay_start,
            "replayed_bytes": restarted.replayed_bytes,
            "lifetime_wal_bytes": lifetime,
            "replay_fraction": round(restarted.replayed_bytes / lifetime, 4),
        },
    }
    # Acceptance: disk bounded + checkpoint boot replays only the tail.
    _require(all(n["reclaimed_bytes"] > 0 for n in nodes.values()), "GC never ran")
    _require(all(
        n["live_wal_bytes"] < n["lifetime_wal_bytes"] for n in nodes.values()
    ), "disk not bounded")
    _require(restarted.recovered_checkpoint_height > 0, "restart missed the checkpoint")
    _require(restarted.replayed_bytes * 5 < lifetime, "replay not << lifetime bytes")
    result["pass"] = True
    return result


def snapshot_catchup_scenario(quick: bool, verifier: dict) -> dict:
    # With one node down, every 4th round waits out the 1 s leader timeout,
    # so rounds advance ~2.2/s of virtual time; >= 1000 rounds of absence
    # needs ~480 virtual seconds of downtime.
    downtime = 60.0 if quick else 480.0
    duration = downtime + 60.0
    parameters = Parameters(
        leader_timeout_s=1.0,
        storage=StorageParameters(
            segment_bytes=32 * 1024,
            checkpoint_interval=10,
            gc_depth=40,
            snapshot_catchup=True,
            catchup_threshold_commits=60,
        ),
    )
    plan = FaultPlan(
        seed=21, crashes=[CrashFault(node=3, at_s=4.0, downtime_s=downtime)]
    )
    with tempfile.TemporaryDirectory(prefix="storage-probe-catchup-") as wal_dir:
        report, harness, wall, launches = _run(plan, duration, wal_dir, parameters, verifier)
        return _snapshot_catchup_result(report, harness, quick, downtime, duration, wall,
                                        launches)


def _snapshot_catchup_result(report, harness, quick, downtime, duration, wall, launches) -> dict:
    node3 = harness.nodes[3]
    lifecycle = node3.core.storage
    crash_event = report.crash_events[0]
    anchors_fleet = harness.checker._anchors[0]
    anchors_rejoined = harness.checker._anchors[3]
    rejoined_heights = sorted(anchors_rejoined)
    crashed_at = crash_event["committed_height"]
    resumed_at = min(h for h in rejoined_heights if h > crashed_at)
    shared = sorted(set(anchors_fleet) & set(anchors_rejoined))
    mismatches = [h for h in shared if anchors_fleet[h] != anchors_rejoined[h]]
    served_blocks = sum(
        harness.nodes[a].snapshot_blocks_served
        + sum(
            d.snapshot_blocks_sent
            for d in harness.nodes[a]._disseminators.values()
        )
        for a in range(4)
        if harness.nodes[a] is not None
    )
    served_bytes = sum(
        harness.nodes[a].snapshot_bytes_served
        + sum(
            d.snapshot_bytes_sent
            for d in harness.nodes[a]._disseminators.values()
        )
        for a in range(4)
        if harness.nodes[a] is not None
    )
    adopted_leader_round = (
        lifecycle.last_committed_leader.round
        if lifecycle.last_committed_leader
        else 0
    )
    # Rounds absent, measured on the committed-anchor ROUNDS themselves:
    # first anchor committed after rejoining minus last anchor committed
    # before the crash.
    rounds_absent = (
        anchors_rejoined[resumed_at].round
        - anchors_rejoined[crashed_at].round
    )
    result = {
        "virtual_duration_s": duration,
        "downtime_s": downtime,
        "wall_s": round(wall, 2),
        "launches": launches,
        "crashed_at_height": crashed_at,
        "resumed_at_height": resumed_at,
        "adopted_heights_skipped": resumed_at - crashed_at - 1,
        "rounds_absent": rounds_absent,
        "final_heights": {
            str(a): harness.committed_height(a) for a in range(4)
        },
        "snapshots_adopted": lifecycle.snapshots_adopted,
        "adopted_floor_round": lifecycle.retired_round,
        "adopted_leader_round": adopted_leader_round,
        "snapshot_blocks_served": served_blocks,
        "snapshot_bytes_served": served_bytes,
        "shared_heights_checked": len(shared),
        "prefix_mismatches": len(mismatches),
    }
    _require(lifecycle.snapshots_adopted >= 1, "snapshot never adopted")
    _require(result["rounds_absent"] >= (
        100 if quick else 1000
    ), f"absence too short: {result['rounds_absent']}")
    _require(not mismatches, f"prefix divergence at heights {mismatches[:5]}")
    _require(harness.committed_height(3) > resumed_at + 20, "rejoined node stalled")
    result["pass"] = True
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--quick", action="store_true",
                        help="shortened scenarios (smoke, not acceptance)")
    parser.add_argument("--verifier", choices=SIM_VERIFIER_CHOICES,
                        default=DEFAULT_VERIFIER,
                        help=f"each node's signature verifier; {SIM_ORACLE}: "
                        "the JAX tool's run (no verifier for these plans)")
    parser.add_argument("--device", default=None,
                        help="torch device of the kernel kinds (default cuda; "
                        "cpu runs the kernels' plain versions)")
    parser.add_argument("--scenario", choices=sorted(SCENARIOS), action="append",
                        help="run only this scenario (repeatable; default both)")
    args = parser.parse_args(argv)
    chosen = args.scenario or list(SCENARIOS)
    verifier = verifier_kwargs(args.verifier, args.device)
    artifact = {
        "probe": "storage-lifecycle",
        "revision": "r08",
        "quick": bool(args.quick),
        "verifier": args.verifier,
        "card": card() if verifier and args.device != "cpu" else None,
        "config_defaults": {
            "segment_bytes": StorageParameters().segment_bytes,
            "checkpoint_interval": StorageParameters().checkpoint_interval,
            "gc_depth": StorageParameters().gc_depth,
        },
    }
    if "bounded-disk" in chosen:
        print("== bounded-disk scenario ==", flush=True)
        artifact["bounded_disk"] = bounded_disk_scenario(args.quick, verifier)
        print(json.dumps(artifact["bounded_disk"], indent=1))
    if "snapshot-catchup" in chosen:
        print("== snapshot catch-up scenario ==", flush=True)
        artifact["snapshot_catchup"] = snapshot_catchup_scenario(args.quick, verifier)
        print(json.dumps(artifact["snapshot_catchup"], indent=1))
    write_json(args.out, artifact, indent=1, sort_keys=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
