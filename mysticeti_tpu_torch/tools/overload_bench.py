"""OVERLOAD document generator: graceful degradation under 2-5x overload.

The port's copy of the JAX repository's ``tools/overload_bench.py``.  Rides
the max-load harness (a ``LocalProcessRunner`` fleet + /metrics scrapes) to
measure committed-vs-offered throughput at 1x/2x/3x/5x the 1x-saturation
load, with per-rung shed accounting (``mysticeti_ingress_shed_total``) and a
fleet health diagnosis; then runs the seeded deterministic overload sim
(``ingress.run_overload_sim``) twice at 3x and records the byte-identical
shed-schedule digests.

The acceptance gate: committed tx/s at 3x and 5x offered >= 80% of the
1x-saturation peak (no collapse past saturation).

The rungs' nodes verify through ``--verifier`` (default ``cuda-only``; the
JAX tool's rungs are always ``cpu``).  A card kind builds the kernels in this
process first, and its fleets share one verifier service; without a card
that raises before any fleet boots.  The document carries ``card``
(nvidia-smi's name and power limit, None without a card) where the JAX tool
carried a host note, and each rung adds ``fleet``
(``maxload_bench.fleet_counters`` of the nodes' last scrapes), ``seconds``
(boot to the last scrape).  The fleet's ``submitted`` is what the nodes'
load generators handed their ingress planes, which ``admitted_total`` plus
the intake sheds (``intake_sheds``) equal; the nominal ``offered_tx_s`` is
what the generators were asked for, and where they fall behind it,
``submitted`` shows by how much.

Usage::

    python -m mysticeti_tpu_torch.tools.overload_bench --out build/OVERLOAD_r19.json
    python -m mysticeti_tpu_torch.tools.overload_bench --base-load 3000 --duration 30
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from mysticeti_tpu_torch.cli import VERIFIER_CHOICES
from mysticeti_tpu_torch.orchestrator.runner import LocalProcessRunner
from mysticeti_tpu_torch.tools import build_path, card, write_json
from mysticeti_tpu_torch.tools.maxload_bench import (
    card_kind,
    fleet_counters,
    prewarm,
    set_port_base,
)

DEFAULT_OUT = build_path("OVERLOAD.json")
DEFAULT_WORKDIR = build_path("overload")
MULTIPLIERS = (1, 2, 3, 5)


def _parse_ingress(texts) -> dict:
    """Sum the ingress counters across the fleet's raw /metrics scrapes."""
    from mysticeti_tpu_torch.orchestrator.measurement import iter_series

    shed: dict = {}
    admitted = 0.0
    shed_mode_nodes = 0
    for text in texts:
        if text is None:
            continue
        for name, labels, value in iter_series(text):
            if name == "mysticeti_ingress_shed_total":
                reason = labels.get("reason", "?")
                shed[reason] = shed.get(reason, 0.0) + value
            elif name == "mysticeti_ingress_admitted_total":
                admitted += value
            elif name == "mysticeti_ingress_shed_mode" and value >= 1.0:
                shed_mode_nodes += 1
    return {
        "admitted_total": int(admitted),
        "shed_total": {k: int(v) for k, v in sorted(shed.items())},
        "shed_mode_nodes": shed_mode_nodes,
    }


# The shed reasons that count no submitted transaction: ``soft_cap_deferred``
# re-queues admitted ones for the next proposal and ``notify_backpressure``
# counts lost commit notifications.  Every other reason is a refusal at
# intake.
NOT_INTAKE_SHEDS = ("soft_cap_deferred", "notify_backpressure")


def intake_sheds(shed_total: dict) -> int:
    """The transactions a rung's ``shed_total`` refused at intake."""
    return sum(v for k, v in shed_total.items() if k not in NOT_INTAKE_SHEDS)


_FINALITY_GAUGES = {
    "mysticeti_e2e_finality_p50_seconds": "server_p50_s",
    "mysticeti_e2e_finality_p99_seconds": "server_p99_s",
    "mysticeti_client_finality_p50_seconds": "client_p50_s",
    "mysticeti_client_finality_p99_seconds": "client_p99_s",
}


def _parse_finality(texts) -> dict:
    """Worst-node finality percentiles (server e2e + client-observed) from
    the fleet's raw /metrics scrapes — the per-rung finality columns."""
    from mysticeti_tpu_torch.orchestrator.measurement import iter_series

    out = {key: 0.0 for key in _FINALITY_GAUGES.values()}
    for text in texts:
        if text is None:
            continue
        for name, _labels, value in iter_series(text):
            key = _FINALITY_GAUGES.get(name)
            if key is not None:
                out[key] = max(out[key], value)
    return {k: round(v, 4) for k, v in out.items()}


def rung_record(texts, load: int, started: float, seconds: float) -> dict:
    """A rung's record from its nodes' last ``/metrics`` texts (None =
    unreachable), the same arithmetic as the JAX tool's ``run_rung``."""
    from mysticeti_tpu_torch.health import cluster_snapshot_from_texts
    from mysticeti_tpu_torch.orchestrator.measurement import Measurement

    nodes = len(texts)
    # Every validator observes every committed shared tx, so per-node
    # counts are N views of ONE total: aggregate as max(count) over the
    # common duration (measurement.rs:236-250 semantics), never a sum.
    measurements = [Measurement.from_prometheus(text) for text in texts if text is not None]
    duration_s = max((m.benchmark_duration_s for m in measurements), default=0.0)
    tps = (
        max((m.count for m in measurements), default=0) / duration_s
        if duration_s
        else 0.0
    )
    latencies = [m.avg_latency_s() for m in measurements if m.count]
    rung = {
        "offered_tx_s": load,
        "committed_tx_s": round(tps, 1),
        "committed_over_offered": round(tps / load, 3) if load else None,
        "avg_latency_s": (
            round(sum(latencies) / len(latencies), 4) if latencies else None
        ),
        "scraped_nodes": sum(1 for t in texts if t is not None),
        "window_utc": [round(started, 1), round(time.time(), 1)],
    }
    rung.update(_parse_ingress(texts))
    rung["finality"] = _parse_finality(texts)
    health = cluster_snapshot_from_texts({f"node-{a}": texts[a] for a in range(nodes)}, nodes)
    rung["health"] = {
        "status": health["status"],
        "quorum_participation": health["quorum_participation"],
        "degraded_reasons": health["degraded_reasons"],
    }
    rung["fleet"] = fleet_counters(texts)
    rung["seconds"] = round(seconds, 3)
    return rung


async def run_rung(nodes: int, load: int, duration: float, workdir: str,
                   label: str, verifier: str = "cuda-only") -> dict:
    """One fixed-offered-load fleet run; returns the rung record."""
    os.environ["INITIAL_DELAY"] = "1"
    runner = LocalProcessRunner(os.path.join(workdir, f"fleet-{label}"), verifier=verifier)
    started = time.time()
    await runner.configure(nodes, load)
    try:
        booted = time.monotonic()
        for authority in range(nodes):
            await runner.boot_node(authority)
        await asyncio.sleep(duration)
        texts = [await runner.scrape(a) for a in range(nodes)]
        seconds = time.monotonic() - booted
    finally:
        await runner.cleanup()
    return rung_record(texts, load, started, seconds)


def determinism_scenario(mult):
    """The determinism leg's seeded overload scenario at ``mult`` x."""
    from mysticeti_tpu_torch.ingress import OverloadScenario

    return OverloadScenario(
        seed=11, nodes=6, duration_s=8.0, base_tps=300,
        max_per_proposal=30, mempool_max_transactions=600,
        multiplier_schedule=[(0.0, float(mult))], clients_per_node=3,
        duplicate_flood=True,
    )


def run_determinism_leg() -> dict:
    """The seeded sim twice at 3x (byte-identical shed schedule) + a 1x
    reference — the virtual-time twin of the fleet rungs."""
    from mysticeti_tpu_torch.ingress import run_overload_sim

    r1 = run_overload_sim(determinism_scenario(1))
    r3a = run_overload_sim(determinism_scenario(3))
    r3b = run_overload_sim(determinism_scenario(3))
    return {
        "scenario": determinism_scenario(3).to_dict(),
        "sim_committed_1x": r1.committed_tx,
        "sim_committed_3x": r3a.committed_tx,
        "sim_committed_3x_over_1x": round(r3a.committed_tx / r1.committed_tx, 3),
        "sim_shed_by_reason_3x": r3a.shed_by_reason,
        "sim_offered_3x": r3a.offered_tx,
        "sim_admitted_3x": r3a.admitted_tx,
        "sim_fully_accounted": (
            sum(r3a.shed_by_reason.values()) + r3a.admitted_tx == r3a.offered_tx
        ),
        "shed_schedule_digest_run1": r3a.shed_schedule_digest,
        "shed_schedule_digest_run2": r3b.shed_schedule_digest,
        "byte_identical": r3a.shed_log_bytes == r3b.shed_log_bytes,
        # Client-perceived finality under 3x overload (finality.py): the
        # sim's closed-loop generators vs the server-side trackers.
        "sim_server_finality_3x": r3a.server_finality,
        "sim_client_finality_3x": r3a.client_finality,
    }


def acceptance_of(rungs: list, determinism: dict) -> dict:
    """The gate's readings: committed at 3x and 5x over the 1x peak, no
    collapse, and the determinism leg's verdicts."""
    acceptance = {}
    if rungs:
        by_mult = {r["multiplier"]: r for r in rungs}
        peak_1x = by_mult.get(1, {}).get("committed_tx_s") or 0.0
        for mult in (3, 5):
            rung = by_mult.get(mult)
            if rung and peak_1x:
                acceptance[f"committed_{mult}x_over_1x"] = round(
                    rung["committed_tx_s"] / peak_1x, 3
                )
        acceptance["no_collapse"] = all(
            v >= 0.8 for k, v in acceptance.items() if k.endswith("_over_1x")
        )
    acceptance["sim_no_collapse"] = determinism["sim_committed_3x_over_1x"] >= 0.8
    acceptance["shed_schedule_byte_identical"] = determinism["byte_identical"]
    acceptance["sim_fully_accounted"] = determinism["sim_fully_accounted"]
    return acceptance


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--base-load", type=int, default=0,
                        help="the 1x offered load (tx/s); 0 = calibrate by "
                        "running one saturating rung and taking its "
                        "committed rate as the saturation point")
    parser.add_argument("--calibrate-load", type=int, default=120000,
                        help="offered load of the calibration rung (should "
                        "comfortably exceed the host's saturation point so "
                        "committed = saturation)")
    parser.add_argument("--duration", type=float, default=30.0)
    parser.add_argument("--multipliers", type=int, nargs="+", default=list(MULTIPLIERS))
    parser.add_argument("--verifier", choices=VERIFIER_CHOICES, default="cuda-only",
                        help="the rungs' node verifier kind")
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--skip-fleet", action="store_true",
                        help="determinism/sim leg only (no process fleet)")
    parser.add_argument("--port-base", type=int, default=None,
                        help="first node port (metrics +1000); default "
                        "benchmark-genesis's 1500")
    args = parser.parse_args(argv)
    set_port_base(args.port_base)

    rungs = []
    base = args.base_load
    calibration = None
    if not args.skip_fleet:
        if card_kind(args.verifier):
            print("prewarming the kernels...", flush=True)
            prewarm(args.nodes)
        if base <= 0:
            print(f"calibrating: saturating rung at {args.calibrate_load} tx/s offered...",
                  flush=True)
            calibration = asyncio.run(run_rung(
                args.nodes, args.calibrate_load, args.duration, args.workdir,
                "calibrate", args.verifier,
            ))
            print(json.dumps(calibration), flush=True)
            base = max(200, int(calibration["committed_tx_s"]))
        print(f"1x saturation load: {base} tx/s", flush=True)
        for mult in args.multipliers:
            load = base * mult
            print(f"rung {mult}x: offered {load} tx/s...", flush=True)
            rung = asyncio.run(run_rung(
                args.nodes, load, args.duration, args.workdir, f"{mult}x", args.verifier
            ))
            rung["multiplier"] = mult
            rungs.append(rung)
            print(json.dumps(rung), flush=True)

    print("determinism leg: seeded overload sim x2...", flush=True)
    determinism = run_determinism_leg()
    print(json.dumps(determinism), flush=True)

    acceptance = acceptance_of(rungs, determinism)
    artifact = {
        "metric": "overload_committed_vs_offered",
        "nodes": args.nodes,
        "verifier": args.verifier,
        "card": card(),
        "base_load_tx_s": base,
        "calibration": calibration,
        "rule": (
            "rungs at 1x/2x/3x/5x the 1x-saturation load; acceptance: "
            "committed tx/s at 3x and 5x >= 80% of the 1x peak (no "
            "collapse), every rejection on mysticeti_ingress_shed_total, "
            "seeded sim shed schedule byte-identical across runs"
        ),
        "rungs": rungs,
        "determinism": determinism,
        "acceptance": acceptance,
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    ok = acceptance.get("no_collapse", True) and acceptance[
        "sim_no_collapse"
    ] and acceptance["shed_schedule_byte_identical"]
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
