"""Fleet health monitor: scrape every node, diagnose, record, render.

The port's copy of the JAX repository's ``tools/fleetmon.py``.  The
fleet-level half of the health plane (``mysticeti_tpu_torch/health.py``):
scrapes every node's ``/metrics`` endpoint on an interval (the same
prometheus parsing the orchestrator's measurement scraper uses), computes
cluster health — quorum participation, per-authority straggler scores,
cross-node commit skew, SLO alert totals — embeds the hostmon weather
snapshot, flushes a JSON health timeline ATOMICALLY every tick (a killed
run keeps its last complete snapshot), and renders a live terminal
dashboard.

Usage:
    # explicit targets
    python -m mysticeti_tpu_torch.tools.fleetmon --targets 127.0.0.1:1600 127.0.0.1:1601 \
        --out fleetmon.json --interval 2 --duration 60

    # or point it at an orchestrator/testbed working directory (reads the
    # metrics addresses from parameters.yaml)
    python -m mysticeti_tpu_torch.tools.fleetmon --fleet-dir benchmark-fleet --out fleetmon.json

``--once`` takes a single snapshot and exits (CI artifact mode);
``--no-dashboard`` suppresses the terminal rendering for headless runs.
Exit status is 0 when the final snapshot is healthy, 3 when degraded —
scriptable as a fleet readiness gate.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from mysticeti_tpu_torch.health import (
    SLOThresholds,
    cluster_snapshot_from_texts,
)
from mysticeti_tpu_torch.orchestrator.runner import _http_get_metrics


def resolve_targets(args) -> List[Tuple[str, int]]:
    if args.targets:
        out = []
        for t in args.targets:
            host, _, port = t.rpartition(":")
            out.append((host or "127.0.0.1", int(port)))
        return out
    if args.fleet_dir:
        from mysticeti_tpu_torch.config import Parameters

        parameters = Parameters.load(
            os.path.join(args.fleet_dir, "parameters.yaml")
        )
        return [
            parameters.metrics_address(a)
            for a in range(len(parameters.identifiers))
        ]
    raise SystemExit("need --targets or --fleet-dir")


async def scrape_all(targets) -> Dict[str, Optional[str]]:
    texts = await asyncio.gather(
        *(_http_get_metrics(host, port) for host, port in targets)
    )
    return {str(i): text for i, text in enumerate(texts)}


async def fetch_recorders(targets) -> Dict[str, Optional[dict]]:
    """Every node's live flight-recorder document (flight_recorder.py) from
    the ``/debug/flight-recorder`` route; None for unreachable nodes or
    pre-r9 nodes without the route."""
    texts = await asyncio.gather(
        *(
            _http_get_metrics(host, port, path="/debug/flight-recorder")
            for host, port in targets
        )
    )
    docs: Dict[str, Optional[dict]] = {}
    for i, text in enumerate(texts):
        doc = None
        if text:
            try:
                parsed = json.loads(text)
                if isinstance(parsed, dict) and "events" in parsed:
                    doc = parsed
            except ValueError:
                pass
        docs[str(i)] = doc
    return docs


def recorder_summary(
    docs: Dict[str, Optional[dict]], last: int = 10
) -> Dict[str, Optional[dict]]:
    """The artifact-embedded view: last N events + dump ledger per node."""
    out: Dict[str, Optional[dict]] = {}
    for node, doc in sorted(docs.items()):
        if doc is None:
            out[node] = None
            continue
        out[node] = {
            "recorded": doc.get("recorded"),
            "dropped": doc.get("dropped"),
            "last_events": (doc.get("events") or [])[-last:],
            "dumps": doc.get("dumps") or [],
        }
    return out


def weather_sample(sampler) -> Optional[dict]:
    if sampler is None:
        return None
    sample = sampler.sample()
    return {
        k: sample[k]
        for k in (
            "cpu_pct", "load_1m", "load_5m", "load_15m", "mem_available_mb",
            "cpu_steal_pct", "switch_interval_s",
        )
        if k in sample
    }


def atomic_write(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def render_dashboard(snapshot: dict, targets, tick: int) -> str:
    """One frame of the terminal dashboard (ANSI home+clear per tick)."""
    lines = [
        f"fleetmon  tick {tick}  status: {snapshot['status'].upper()}"
        f"  participation {snapshot['quorum_participation']:.2f}"
        f"  commit skew {snapshot['commit_skew_rounds']}r"
        f"  max commit round {snapshot['max_commit_round']}",
    ]
    weather = snapshot.get("weather")
    if weather:
        lines.append(
            "weather: "
            + "  ".join(f"{k}={v}" for k, v in sorted(weather.items()))
        )
    lines.append(
        f"{'node':<6}{'state':<12}{'epoch':>7}{'commit/s':>10}"
        f"{'straggler':>12}{'lag p99':>10}{'fin p99':>10}  "
        f"{'top cpu subsystems':<32}"
    )
    stragglers = snapshot.get("straggler_score", {})
    rates = snapshot.get("commit_rate_by_node", {})
    lags = snapshot.get("loop_lag_p99_by_node", {})
    finality = snapshot.get("finality_p99_by_node", {})
    top_subs = snapshot.get("top_cpu_subsystems", {})
    epochs = snapshot.get("epochs_by_node", {})
    for i in range(len(targets)):
        node = str(i)
        if node in snapshot["unreachable"]:
            state = "UNREACHABLE"
        elif node in snapshot.get("degraded_nodes", []):
            state = "degraded"
        elif node in snapshot.get("yellow_nodes", []):
            state = "yellow"
        else:
            state = "ok"
        lag_ms = lags.get(node, 0.0) * 1e3
        fin_ms = finality.get(node, 0.0) * 1e3
        lines.append(
            f"{node:<6}{state:<12}{epochs.get(node, 0):>7}"
            f"{rates.get(node, 0.0):>10.3f}"
            f"{stragglers.get(node, 0):>12}"
            f"{lag_ms:>8.1f}ms"
            f"{fin_ms:>8.0f}ms  "
            f"{','.join(top_subs.get(node, []) or ['-']):<32}"
        )
    # Mixed-epoch readiness warning: nodes disagreeing on the consensus
    # epoch is EXPECTED for the seconds around a reconfiguration boundary
    # but a lagging straggler beyond that — surface it without tripping
    # the red machinery (commit-skew and participation gates own "red").
    distinct_epochs = {e for e in epochs.values()}
    if len(distinct_epochs) > 1:
        by_epoch: Dict[int, List[str]] = {}
        for node, e in sorted(epochs.items()):
            by_epoch.setdefault(int(e), []).append(node)
        lines.append(
            "WARNING mixed epochs: "
            + "  ".join(
                f"epoch {e}: nodes {','.join(nodes)}"
                for e, nodes in sorted(by_epoch.items())
            )
        )
    alerts = snapshot.get("slo_alert_totals", {})
    if alerts:
        lines.append(
            "alerts: "
            + "  ".join(f"{k}={v:.0f}" for k, v in sorted(alerts.items()))
        )
    if snapshot.get("degraded_reasons"):
        lines.append("degraded: " + "; ".join(snapshot["degraded_reasons"]))
    return "\n".join(lines)


async def run(args) -> int:
    targets = resolve_targets(args)
    slo = SLOThresholds(
        min_participation=args.min_participation,
        max_loop_lag_s=args.max_loop_lag,
        # getattr: programmatic callers build a bare Namespace (the
        # fleet-trace test does) and must keep working with old arg sets.
        max_finality_p99_s=getattr(args, "max_finality_p99", 0.0),
    )
    sampler = None
    try:
        from mysticeti_tpu_torch.orchestrator.hostmon import HostSampler

        sampler = HostSampler()
    except ImportError:  # no psutil: timeline rides without weather
        pass
    # Bounded history: run-forever mode must not grow memory (or the
    # per-tick rewrite) without limit — beyond the cap the oldest ticks
    # roll off and the artifact says how many it dropped.
    max_ticks = max(1, args.max_ticks)
    timeline: List[dict] = []
    dropped_ticks = 0
    # The artifact's window is stamped on the wall clock; the timeline's
    # offsets and the --duration stop read the monotonic one.
    started = time.time()
    started_mono = time.monotonic()
    tick = 0
    last_snapshot: Optional[dict] = None
    recorders: Dict[str, Optional[dict]] = {}
    dump_paths: List[str] = []

    def artifact_doc() -> dict:
        return {
            "targets": [f"{h}:{p}" for h, p in targets],
            "interval_s": args.interval,
            "window_utc": [round(started, 1), round(time.time(), 1)],
            "slo": slo.to_dict(),
            "dropped_ticks": dropped_ticks,
            # Flight-recorder summary (flight_recorder.py): the last few
            # incident-ring events per node + each node's dump ledger.
            # Refreshed on the first tick, on every red transition, and at
            # exit — NOT per tick: the debug route returns the FULL ring
            # (up to ~1 MB/node) and polling it continuously would cost
            # megabytes per interval to keep a 10-event slice fresh.
            "flight_recorder": recorder_summary(recorders),
            "flight_recorder_dumps": dump_paths,
            "timeline": timeline,
        }

    async def write_red_dumps() -> None:
        """Preserve every node's full incident ring on disk NOW — the
        operator's first question is "what happened in the seconds before
        red", and that window rolls off the bounded ring."""
        nonlocal recorders
        recorders = await fetch_recorders(targets)
        base = args.out or "fleetmon.json"
        for node, doc in sorted(recorders.items()):
            if doc is None:
                continue
            path = f"{base}.flight-{node}.json"
            atomic_write(path, doc)
            if os.path.basename(path) not in dump_paths:
                dump_paths.append(os.path.basename(path))
            print(f"flight recorder of node {node} dumped to {path}",
                  file=sys.stderr)

    prev_degraded = False
    while True:
        tick += 1
        texts = await scrape_all(targets)
        snapshot = cluster_snapshot_from_texts(texts, len(targets), slo=slo)
        snapshot["t"] = round(time.monotonic() - started_mono, 3)
        weather = weather_sample(sampler)
        if weather is not None:
            snapshot["weather"] = weather
        timeline.append(snapshot)
        if len(timeline) > max_ticks:
            timeline.pop(0)
            dropped_ticks += 1
        last_snapshot = snapshot
        # Yellow (a loop-lag SLO breach: the fleet is committing but some
        # node's event loop runs hot) warns on the dashboard without
        # tripping the red machinery — only "degraded" dumps rings/exits 3.
        degraded_now = snapshot["status"] == "degraded"
        if degraded_now and not prev_degraded and args.dump_on_red:
            # Dump AT the red transition, mid-run included: a fleet that
            # goes red at minute 10 of an hour-long watch must not wait
            # for loop exit (the ring would have rolled past the incident,
            # or a recovery would skip the dump entirely).
            await write_red_dumps()
        elif tick == 1:
            recorders = await fetch_recorders(targets)
        prev_degraded = degraded_now
        if args.out:
            atomic_write(args.out, artifact_doc())
        if not args.no_dashboard:
            frame = render_dashboard(snapshot, targets, tick)
            sys.stdout.write("\x1b[H\x1b[2J" + frame + "\n")
            sys.stdout.flush()
        # A real-time tool: it never runs under the simulator.
        if args.once or (  # lint: ignore[sim-taint]
            args.duration and time.monotonic() - started_mono >= args.duration
        ):
            break
        await asyncio.sleep(args.interval)
    if args.no_dashboard and last_snapshot is not None:
        print(render_dashboard(last_snapshot, targets, tick))
    degraded = not (
        last_snapshot and last_snapshot["status"] in ("ok", "yellow")
    )
    if degraded and args.dump_on_red:
        # Exit while red: refresh the dumps so the gate failure always
        # leaves the freshest rings (idempotent if the transition already
        # dumped this red period).
        await write_red_dumps()
    else:
        recorders = await fetch_recorders(targets)
    if args.out:
        atomic_write(args.out, artifact_doc())
    return 3 if degraded else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="fleetmon", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--targets", nargs="*", default=None,
                        help="metrics endpoints as host:port")
    parser.add_argument("--fleet-dir", default=None,
                        help="orchestrator working dir (reads parameters.yaml)")
    parser.add_argument("--interval", type=float, default=5.0)
    parser.add_argument("--duration", type=float, default=0.0,
                        help="stop after this many seconds (0 = forever)")
    parser.add_argument("--once", action="store_true",
                        help="one snapshot, then exit")
    parser.add_argument("--out", default=None,
                        help="JSON health-timeline path (atomically rewritten "
                        "every tick)")
    parser.add_argument("--min-participation", type=float, default=0.67)
    parser.add_argument("--max-loop-lag", type=float, default=0.25,
                        help="loop-lag p99 (s) past which a node shows "
                        "yellow on the readiness gate (0 disables)")
    parser.add_argument("--max-finality-p99", type=float, default=0.0,
                        help="submit→finalized p99 (s) past which a node "
                        "shows yellow on the readiness gate (0 disables; "
                        "reads mysticeti_e2e_finality_p99_seconds)")
    parser.add_argument("--max-ticks", type=int, default=2880,
                        help="keep at most this many timeline ticks in "
                        "memory/on disk (oldest roll off; default = 4h at "
                        "the 5s interval)")
    parser.add_argument("--no-dashboard", action="store_true")
    parser.add_argument("--dump-on-red", action="store_true",
                        help="when the readiness gate fails, pull "
                        "/debug/flight-recorder from every node and write "
                        "<out>.flight-<node>.json dumps")
    args = parser.parse_args(argv)
    return asyncio.run(run(args))


if __name__ == "__main__":
    raise SystemExit(main())
