"""FINALITY document generator: submit→finality SLIs + decision-ledger audit.

The port's copy of the JAX repository's ``tools/finality_bench.py``.  Two
legs, one document:

* **Fleet leg** — a real local fleet (``LocalProcessRunner``, gateway/ingress
  plane on) under closed-loop load.  Scrapes the server-side
  ``mysticeti_e2e_finality_p{50,99}_seconds`` gauges and the
  CLIENT-observed ``mysticeti_client_finality_p{50,99}_seconds`` gauges
  from every node, pulls each node's ``/debug/consensus`` decision
  ledger, and cross-checks the two ends: the client's number is the
  server's ``total`` plus the notification hop, so the percentiles must
  agree within ``--cross-check-tolerance`` (default 20%).
* **Sim leg** — the seeded ``byzantine-at-f`` scenario (10 nodes, f=3
  attacking) run twice with the same seed: every decided leader slot in
  every honest node's ledger must carry an explaining record (slot
  coverage audited against the committer's own leader schedule), and the
  canonical ledgers must be byte-identical across the two runs.

Both legs verify through ``--verifier``: by default ``cuda-only``, the
fleet's nodes behind one verifier service on the card and the sim's
collectors over one ``TorchSignatureVerifier`` in this process
(``scenarios.verifier_factory``); ``sim-oracle`` is the JAX tool's run (its
fleet on the ``cpu`` kind, its sim on the re-sign oracle).  A card kind
builds the kernels in this process first, which raises without a card.  The
document names the kinds it ran (``verifier``, and each leg's), where the
JAX tool writes ``cpu`` whatever ran, and adds ``card`` (nvidia-smi's name
and power limit, None without a card), the fleet's ``fleet`` counters
(``maxload_bench.fleet_counters``) and the sim leg's ``launches`` (the
kernels' launches in this process, from its warm backend).  ``--port-base``
moves ``benchmark-genesis``'s ports.

Usage::

    python -m mysticeti_tpu_torch.tools.finality_bench --out build/FINALITY_r17.json
    python -m mysticeti_tpu_torch.tools.finality_bench --skip-fleet --verifier sim-oracle
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import sys
import time

from mysticeti_tpu_torch.cli import DEFAULT_VERIFIER, SIM_VERIFIER_CHOICES
from mysticeti_tpu_torch.tools import (
    build_path,
    card,
    launch_counts,
    launches_since,
    node_kind,
    write_json,
)
from mysticeti_tpu_torch.tools.maxload_bench import card_kind, prewarm, set_port_base

DEFAULT_OUT = build_path("FINALITY.json")
DEFAULT_WORKDIR = build_path("finality")

FINALITY_GAUGES = (
    "mysticeti_e2e_finality_p50_seconds",
    "mysticeti_e2e_finality_p99_seconds",
    "mysticeti_client_finality_p50_seconds",
    "mysticeti_client_finality_p99_seconds",
)


def _node_gauges(text) -> dict:
    from mysticeti_tpu_torch.orchestrator.measurement import iter_series

    out = {name: 0.0 for name in FINALITY_GAUGES}
    if text:
        for name, _labels, value in iter_series(text):
            if name in out:
                out[name] = value
    return out


def _percentile(values, q):
    from mysticeti_tpu_torch.finality import percentile

    return percentile(list(values), q)


def _within(a: float, b: float, tolerance: float) -> bool:
    """|a-b| within tolerance of the larger (sub-ms values always agree —
    at that scale both ends are measuring scheduler noise)."""
    hi = max(a, b)
    if hi < 1e-3:
        return True
    return abs(a - b) <= tolerance * hi


def _fresh_dir(path: str) -> str:
    # Stale WALs from a previous invocation replay into the new run and
    # the safety checker (rightly) reports the replayed prefix as a commit
    # gap — every leg must start from an empty directory.
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    return path


async def run_fleet_leg(args) -> dict:
    """One closed-loop fleet run; returns the fleet-side record."""
    from mysticeti_tpu_torch.orchestrator.runner import (
        LocalProcessRunner,
        _http_get_metrics,
    )

    os.environ["INITIAL_DELAY"] = "1"
    kind = node_kind(args.verifier)
    runner = LocalProcessRunner(_fresh_dir(os.path.join(args.workdir, "fleet")), verifier=kind)
    started = time.time()
    await runner.configure(args.nodes, args.load)
    ledgers = {}
    try:
        for authority in range(args.nodes):
            await runner.boot_node(authority)
        await asyncio.sleep(args.duration)
        texts = [await runner.scrape(a) for a in range(args.nodes)]
        for authority in range(args.nodes):
            host, port = runner.parameters.metrics_address(authority)
            doc = await _http_get_metrics(host, port, path="/debug/consensus")
            try:
                ledgers[str(authority)] = json.loads(doc) if doc else None
            except ValueError:
                ledgers[str(authority)] = None
    finally:
        await runner.cleanup()
    return fleet_record(texts, ledgers, args, started, kind)


def fleet_record(texts, ledgers: dict, args, started: float, kind: str) -> dict:
    """The fleet leg's record from the nodes' last ``/metrics`` texts and
    their ``/debug/consensus`` documents, the JAX tool's arithmetic."""
    from mysticeti_tpu_torch.tools.maxload_bench import fleet_counters

    per_node = {}
    for authority, text in enumerate(texts):
        gauges = _node_gauges(text)
        ledger = ledgers.get(str(authority)) or {}
        records = ledger.get("records") or []
        per_node[str(authority)] = {
            "server_p50_s": round(gauges["mysticeti_e2e_finality_p50_seconds"], 4),
            "server_p99_s": round(gauges["mysticeti_e2e_finality_p99_seconds"], 4),
            "client_p50_s": round(gauges["mysticeti_client_finality_p50_seconds"], 4),
            "client_p99_s": round(gauges["mysticeti_client_finality_p99_seconds"], 4),
            "decisions_recorded": ledger.get("recorded", 0),
            "decisions_by_outcome": _outcome_census(records),
            "ledger_digest": ledger.get("ledger_digest"),
            "undecided": ledger.get("undecided", []),
        }
    reachable = [rec for rec in per_node.values() if rec["server_p50_s"] > 0]
    server_p50 = _percentile([r["server_p50_s"] for r in reachable], 0.5)
    server_p99 = max((r["server_p99_s"] for r in reachable), default=0.0)
    client_p50 = _percentile(
        [r["client_p50_s"] for r in reachable if r["client_p50_s"] > 0], 0.5
    )
    client_p99 = max((r["client_p99_s"] for r in reachable), default=0.0)
    return {
        "nodes": args.nodes,
        "load_tx_s": args.load,
        "verifier": kind,
        "window_utc": [round(started, 1), round(time.time(), 1)],
        "per_node": per_node,
        "server": {"p50_s": round(server_p50, 4), "p99_s": round(server_p99, 4),
                   "samples": len(reachable)},
        "client": {"p50_s": round(client_p50, 4), "p99_s": round(client_p99, 4)},
        "cross_check": {
            "p50_within_tolerance": _within(server_p50, client_p50, args.cross_check_tolerance),
            "p99_within_tolerance": _within(server_p99, client_p99, args.cross_check_tolerance),
            "tolerance": args.cross_check_tolerance,
        },
        "decisions_recorded_all_nodes": all(
            rec["decisions_recorded"] > 0 for rec in per_node.values()
        ),
        "fleet": fleet_counters(texts),
    }


def _outcome_census(records) -> dict:
    census: dict = {}
    for record in records:
        key = f"{record.get('rule')}-{record.get('outcome')}"
        census[key] = census.get(key, 0) + 1
    return {k: census[k] for k in sorted(census)}


def _audit_ledgers(harness, adversaries) -> dict:
    """Slot-coverage audit over every live honest node: each round between
    a ledger's first and last decided round must carry exactly one record
    per leader the committer elects there — a skipped slot with no record
    would show up as a hole."""
    holes = []
    censuses = {}
    digests = {}
    for authority in range(harness.n):
        if authority in adversaries:
            continue
        node = harness.nodes[authority]
        if node is None:
            continue
        committer = node.core.committer
        records = committer.ledger.records()
        digests[authority] = committer.ledger.digest()
        censuses[authority] = _outcome_census(records)
        if not records:
            holes.append(f"node {authority}: empty ledger")
            continue
        by_round: dict = {}
        for record in records:
            by_round.setdefault(record["round"], []).append(record)
        for round_ in range(records[0]["round"], records[-1]["round"] + 1):
            expected = len(committer.get_leaders(round_))
            got = len(by_round.get(round_, []))
            if got != expected:
                holes.append(
                    f"node {authority}: round {round_} has {got} record(s), "
                    f"committer elects {expected} leader(s)"
                )
    return {"holes": holes, "censuses": censuses, "digests": digests}


def run_sim_leg(args, wal_dir: str) -> dict:
    """The seeded Byzantine sim twice: coverage + byte-identity."""
    import dataclasses

    from mysticeti_tpu_torch.chaos import run_chaos_sim
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.scenarios import kind_backend, scenario_by_name, verifier_factory

    scenario = dataclasses.replace(
        scenario_by_name("byzantine-at-f"), duration_s=args.sim_duration
    )
    adversaries = {spec.node for spec in scenario.adversaries}
    committee = Committee.new_for_benchmarks(scenario.nodes, stakes=list(scenario.stakes) or None)
    # One warm backend for both runs (the oracle kind's factory has none and
    # makes its memo afresh each run): the launches counted are the sims'.
    backend = kind_backend(args.verifier, committee, device=args.device)
    launches0 = launch_counts()

    def run_once(tag: str):
        return run_chaos_sim(
            scenario.plan(), scenario.nodes, scenario.duration_s,
            _fresh_dir(os.path.join(wal_dir, tag)),
            parameters=scenario.base_parameters(),
            latency_ranges=scenario.latency_ranges(),
            with_metrics=True,
            verifier_factory=verifier_factory(args.verifier, committee, backend=backend),
        )

    _report_a, harness_a = run_once("a")
    audit = _audit_ledgers(harness_a, adversaries)
    _report_b, harness_b = run_once("b")
    identical = all(
        harness_a.nodes[a] is not None
        and harness_b.nodes[a] is not None
        and harness_a.nodes[a].core.committer.ledger.ledger_bytes()
        == harness_b.nodes[a].core.committer.ledger.ledger_bytes()
        for a in range(scenario.nodes)
        if a not in adversaries
    )
    skips = sum(
        count
        for census in audit["censuses"].values()
        for key, count in census.items()
        if key.endswith("-skip")
    )
    return {
        "scenario": scenario.name,
        "nodes": scenario.nodes,
        "duration_s": scenario.duration_s,
        "verifier": args.verifier,
        "every_slot_explained": not audit["holes"],
        "holes": audit["holes"],
        "decision_census": {str(a): c for a, c in sorted(audit["censuses"].items())},
        "skips_explained": skips,
        "byte_identical": identical,
        "digest": audit["digests"].get(min(audit["digests"], default=0)),
        "launches": launches_since(launches0),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="finality_bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--load", type=int, default=2000,
                        help="closed-loop offered load, tx/s (keep below "
                        "saturation: finality is an SLI, not a stress test)")
    parser.add_argument("--duration", type=float, default=30.0)
    parser.add_argument("--sim-duration", type=float, default=4.0)
    parser.add_argument("--cross-check-tolerance", type=float, default=0.20)
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--skip-fleet", action="store_true",
                        help="sim leg only (no process fleet)")
    parser.add_argument("--verifier", choices=SIM_VERIFIER_CHOICES, default=DEFAULT_VERIFIER,
                        help="both legs' signature verifier; sim-oracle: the JAX "
                        "tool's run (the re-sign oracle in the sim, cpu in the fleet)")
    parser.add_argument("--device", default=None,
                        help="torch device of the sim's kernel kinds (default "
                        "cuda; cpu runs the kernels' plain versions)")
    parser.add_argument("--port-base", type=int, default=None,
                        help="first node port (metrics +1000); default "
                        "benchmark-genesis's 1500")
    args = parser.parse_args(argv)
    set_port_base(args.port_base)
    if card_kind(args.verifier) and args.device != "cpu":
        print("prewarming the kernels...", flush=True)
        prewarm(args.nodes, device=args.device or "cuda:0")

    fleet = None
    if not args.skip_fleet:
        print(f"fleet leg: {args.nodes} nodes at {args.load} tx/s for "
              f"{args.duration}s...", flush=True)
        fleet = asyncio.run(run_fleet_leg(args))
        print(json.dumps({k: fleet[k] for k in
                          ("server", "client", "cross_check")}), flush=True)

    print("sim leg: seeded byzantine-at-f x2 (ledger audit + "
          "byte-identity)...", flush=True)
    sim = run_sim_leg(args, os.path.join(args.workdir, "sim"))
    print(json.dumps({k: sim[k] for k in
                      ("every_slot_explained", "skips_explained",
                       "byte_identical")}), flush=True)

    acceptance = {
        "every_slot_explained": sim["every_slot_explained"],
    }
    if fleet is not None:
        acceptance["client_cross_check"] = (
            fleet["cross_check"]["p50_within_tolerance"]
            and fleet["cross_check"]["p99_within_tolerance"]
        )
        acceptance["decisions_on_every_node"] = fleet["decisions_recorded_all_nodes"]
    artifact = {
        "metric": "finality",
        "nodes": args.nodes,
        "verifier": args.verifier,
        "card": card(),
        "rule": (
            "server (submit→finalized) and client (submit→notification) "
            "p50/p99 agree within the cross-check tolerance; every decided "
            "leader slot carries a ledger record; seeded Byzantine-sim "
            "ledgers byte-identical across same-seed runs"
        ),
        "server": (fleet or {}).get("server", {}),
        "client": (fleet or {}).get("client", {}),
        "fleet": fleet,
        "sim": sim,
        "determinism": {
            "byte_identical": sim["byte_identical"],
            "digest": sim["digest"],
        },
        "acceptance": acceptance,
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    ok = all(acceptance.values()) and sim["byte_identical"]
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
