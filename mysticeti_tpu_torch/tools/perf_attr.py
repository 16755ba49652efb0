"""One-command host attribution probe: a node-a-process fleet -> PERF_ATTR artifact.

The port's copy of the JAX repository's ``tools/perf_attr.py``.  Boots a
local N-node benchmark fleet through the port's CLI (subprocess nodes, so
each has its own interpreter lock, CUDA context, sampler and /metrics
endpoint), runs it under load with the per-subsystem accountant on
(MYSTICETI_PROFILE + MYSTICETI_PERF_REPORT), scrapes the host attribution
series over /metrics, and reduces everything into one ``PERF_ATTR_rNN.json``
artifact:

* per-subsystem CPU seconds and µs per committed leader,
* loop-lag percentiles and the GIL convoy ratio,
* verifier dispatch occupancy fractions (device-busy / host-pack /
  fetch-wait) and the kernels' build counters
  (``mysticeti_cuda_build*``),
* the batches each node degraded to the CPU oracle
  (``verifier_fallback_total``),
* each node's exit code.

Genesis is ``benchmark-genesis``'s, on its fixed ports (1500+i, metrics
2500+i) unless ``--port-base`` moves them; a port already taken fails the
run before any node starts.

Usage:
    python -m mysticeti_tpu_torch.tools.perf_attr --round 14   # 4 nodes, 45 s, cuda-only
    python -m mysticeti_tpu_torch.tools.perf_attr --committee-size 4 \\
        --duration 60 --verifier cpu --out build/PERF_ATTR_r14.json

The artifact lands under the checkout's ``build/`` (``build/PERF_ATTR.json``,
or ``build/PERF_ATTR_rNN.json`` with ``--round``; a relative ``--out`` is
taken from the repository root), with the host-weather block
(``orchestrator.hostmon``) where psutil is installed, and is folded into the
port's trend index (``tools.bench_trend.append_artifact``,
``build/BENCH_TREND.json``, each record with the card's name and power limit;
skipped where there is no card, and with ``--no-trend``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

from mysticeti_tpu_torch.cli import DEFAULT_VERIFIER
from mysticeti_tpu_torch.config import (
    DEFAULT_METRICS_PORT_OFFSET,
    DEFAULT_PORT_BASE,
    Parameters,
)
from mysticeti_tpu_torch.orchestrator.measurement import iter_series
from mysticeti_tpu_torch.tools import REPO as _REPO
from mysticeti_tpu_torch.tools import build_path, write_json

NODE_COMMAND = (sys.executable, "-m", "mysticeti_tpu_torch")


def _http_get(host: str, port: int, path: str, timeout: float = 3.0):
    try:
        with urllib.request.urlopen(
            f"http://{host}:{port}{path}", timeout=timeout
        ) as resp:
            return resp.read().decode(errors="replace")
    except Exception:  # noqa: BLE001 - unreachable nodes scrape as None
        return None


def scrape_node(host: str, port: int) -> Optional[dict]:
    """One node's attribution view from its /metrics + /health routes."""
    text = _http_get(host, port, "/metrics")
    if text is None:
        return None
    out: dict = {
        "leaders": 0.0,
        "cpu_seconds": {},  # subsystem -> s (summed over thread classes)
        "us_per_leader": {},  # subsystem -> µs (the node's own gauge)
        "loop_lag_p99_s": 0.0,
        "gil_convoy_ratio": 0.0,
        "occupancy": {},
        "build": {},
        "transfer_bytes": {},
        "blocking_calls": 0.0,
        "slo_alerts": {},
        "verifier_fallback": 0.0,
    }
    for name, labels, value in iter_series(text):
        if name == "committed_leaders_total":
            if "commit" in labels.get("status", ""):
                out["leaders"] += value
        elif name == "mysticeti_cpu_seconds_total":
            sub = labels.get("subsystem", "?")
            out["cpu_seconds"][sub] = out["cpu_seconds"].get(sub, 0.0) + value
        elif name == "mysticeti_cpu_us_per_leader":
            out["us_per_leader"][labels.get("subsystem", "?")] = value
        elif name == "mysticeti_loop_lag_p99_seconds":
            out["loop_lag_p99_s"] = value
        elif name == "mysticeti_gil_convoy_ratio":
            out["gil_convoy_ratio"] = value
        elif name == "mysticeti_verify_occupancy_fraction":
            out["occupancy"][labels.get("phase", "?")] = value
        elif name in (
            "mysticeti_cuda_builds_total",
            "mysticeti_cuda_build_seconds_total",
            "mysticeti_cuda_build_cache_hits_total",
            "mysticeti_cuda_build_cache_misses_total",
        ):
            out["build"][name.replace("mysticeti_cuda_", "")] = value
        elif name == "mysticeti_device_transfer_bytes_total":
            out["transfer_bytes"][labels.get("direction", "?")] = value
        elif name == "mysticeti_blocking_calls_total":
            out["blocking_calls"] += value
        elif name == "verifier_fallback_total":
            out["verifier_fallback"] += value
        elif name == "mysticeti_health_slo_alerts_total":
            kind = labels.get("kind", "?")
            out["slo_alerts"][kind] = out["slo_alerts"].get(kind, 0.0) + value
    # /health is served on the node's event loop, so under saturating load
    # it lags far behind the thread-served /metrics route — give it room.
    health = _http_get(host, port, "/health", timeout=10.0)
    if health:
        try:
            doc = json.loads(health)
            out["host"] = (doc.get("signals") or {}).get("host")
        except ValueError:
            pass
    return out


def aggregate(
    scrapes: Dict[str, Optional[dict]],
    reports: Dict[str, Optional[dict]],
) -> dict:
    """Reduce per-node scrapes + shutdown attribution reports into the
    artifact's fleet view (per-node numbers averaged, counters summed)."""
    live = {k: v for k, v in scrapes.items() if v is not None}
    n = max(1, len(live))
    subsystems: Dict[str, dict] = {}
    attributed: List[float] = []
    convoy: List[float] = []
    for node, scrape in sorted(live.items()):
        report = reports.get(node)
        seconds = (
            report["subsystem_seconds"] if report else scrape["cpu_seconds"]
        )
        leaders = scrape["leaders"]
        for sub, cpu_s in seconds.items():
            slot = subsystems.setdefault(
                sub, {"cpu_s": 0.0, "us_per_leader": 0.0, "nodes": 0}
            )
            slot["cpu_s"] += cpu_s
            if leaders > 0 and sub != "event-loop-idle":
                slot["us_per_leader"] += cpu_s * 1e6 / leaders
                slot["nodes"] += 1
        if report:
            attributed.append(report["attributed_ratio"])
            convoy.append(report["gil_convoy_ratio"])
        else:
            convoy.append(scrape["gil_convoy_ratio"])
    for slot in subsystems.values():
        if slot["nodes"]:
            slot["us_per_leader"] = round(
                slot["us_per_leader"] / slot["nodes"], 3
            )
        else:
            slot.pop("us_per_leader", None)
        slot["cpu_s"] = round(slot["cpu_s"], 6)
        slot.pop("nodes", None)
    # event-loop-idle is parked time, not a budget: no per-leader row.
    idle = subsystems.get("event-loop-idle")
    if idle is not None:
        idle.pop("us_per_leader", None)
    lag_p50 = [
        (s.get("host") or {}).get("loop_lag_p50_s", 0.0) for s in live.values()
    ]
    lag_p99 = [s["loop_lag_p99_s"] for s in live.values()]
    occupancy: Dict[str, float] = {}
    for s in live.values():
        for phase, frac in s["occupancy"].items():
            occupancy[phase] = occupancy.get(phase, 0.0) + frac / n
    build: Dict[str, float] = {}
    transfer: Dict[str, float] = {}
    for s in live.values():
        for key, value in s["build"].items():
            build[key] = build.get(key, 0.0) + value
        for direction, value in s["transfer_bytes"].items():
            transfer[direction] = transfer.get(direction, 0.0) + value
    alert_totals: Dict[str, float] = {}
    for s in live.values():
        for kind, count in s["slo_alerts"].items():
            alert_totals[kind] = alert_totals.get(kind, 0.0) + count
    return {
        "subsystems": dict(sorted(subsystems.items())),
        "attributed_ratio": (
            round(sum(attributed) / len(attributed), 6) if attributed else None
        ),
        "loop_lag": {
            "p50_s_mean": round(sum(lag_p50) / n, 6),
            "p99_s_mean": round(sum(lag_p99) / n, 6),
            "p99_s_max": round(max(lag_p99, default=0.0), 6),
        },
        "gil_convoy_ratio": (
            round(sum(convoy) / len(convoy), 6) if convoy else 0.0
        ),
        "device": {
            "occupancy_fractions": {
                k: round(v, 6) for k, v in sorted(occupancy.items())
            },
            "build": {k: round(v, 3) for k, v in sorted(build.items())},
            "transfer_bytes": {
                k: int(v) for k, v in sorted(transfer.items())
            },
        },
        "blocking_calls": int(sum(s["blocking_calls"] for s in live.values())),
        "slo_alert_totals": dict(sorted(alert_totals.items())),
        "committed_leaders_by_node": {
            k: int(v["leaders"]) for k, v in sorted(live.items())
        },
        # Batches a node's collector degraded to the CPU oracle (the port's
        # addition: a card fleet must show none).
        "verifier_fallback_by_node": {
            k: int(v["verifier_fallback"]) for k, v in sorted(live.items())
        },
        # Which native data-plane functions each node resolved.  The
        # shutdown report is authoritative (it is written even when load
        # kept /health from ever answering); the live scrape's host block
        # is the fallback.
        "native_active_by_node": {
            k: (
                (reports.get(k) or {}).get("native_active")
                if (reports.get(k) or {}).get("native_active") is not None
                else (v.get("host") or {}).get("native_active")
            )
            for k, v in sorted(live.items())
        },
    }


def assert_ports_free(parameters: Parameters, committee_size: int) -> None:
    """Fail fast when another fleet holds the fleet's ports: a node that
    cannot bind crashes after genesis, and the scraper would then read
    metrics from the stale process that owns the port."""
    import socket

    busy = []
    for authority in range(committee_size):
        for _, port in (
            parameters.address(authority),
            parameters.metrics_address(authority),
        ):
            with socket.socket() as s:
                # REUSEADDR matches the servers' bind semantics: sockets in
                # TIME_WAIT from the previous fleet are fine, only a live
                # listener must fail the check.
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    busy.append(port)
    if busy:
        raise RuntimeError(
            f"ports already in use (stale fleet?): {sorted(set(busy))}"
        )


def write_genesis(wd: str, committee_size: int,
                  port_base: int = DEFAULT_PORT_BASE) -> Parameters:
    """``benchmark-genesis`` for ``committee_size`` nodes on 127.0.0.1
    through the CLI, its ports moved to ``port_base`` (+i, metrics +1000+i)
    when that is not the default; returns the parameters, their ports
    checked free."""
    subprocess.run(
        [
            *NODE_COMMAND, "benchmark-genesis",
            "--ips", *(["127.0.0.1"] * committee_size),
            "--working-directory", wd,
        ],
        check=True, cwd=_REPO,
    )
    path = os.path.join(wd, "parameters.yaml")
    parameters = Parameters.load(path)
    if port_base != DEFAULT_PORT_BASE:
        for i, identifier in enumerate(parameters.identifiers):
            identifier.port = port_base + i
            identifier.metrics_port = port_base + DEFAULT_METRICS_PORT_OFFSET + i
        parameters.dump(path)
    assert_ports_free(parameters, committee_size)
    return parameters


def run_fleet(args, node_command: Sequence[str] = NODE_COMMAND,
              env: Optional[Dict[str, str]] = None) -> dict:
    """Genesis, ``args.committee_size`` nodes each started as
    ``node_command run ...`` with ``env`` over this process's environment,
    the scrapes and the shutdown reports, reduced by ``aggregate``; the
    document also holds each node's exit code (None where it outlived
    ``args.duration`` + 60 s and was killed)."""
    wd = os.path.abspath(args.working_dir)
    os.makedirs(wd, exist_ok=True)
    parameters = write_genesis(wd, args.committee_size, args.port_base)
    targets = [
        parameters.metrics_address(a) for a in range(args.committee_size)
    ]
    procs = []
    logs = []
    for i in range(args.committee_size):
        node_dir = os.path.join(wd, f"validator-{i}")
        node_env = dict(os.environ, **(env or {}))
        node_env.update(
            MYSTICETI_EXIT_AFTER=str(args.duration),
            MYSTICETI_PROFILE=os.path.join(node_dir, "profile.folded"),
            MYSTICETI_PERF_REPORT=os.path.join(node_dir, "perf_report.json"),
            TPS=str(args.tps),
        )
        log = open(os.path.join(node_dir, "node.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [
                *node_command, "run",
                "--authority", str(i),
                "--committee-path", os.path.join(wd, "committee.yaml"),
                "--parameters-path", os.path.join(wd, "parameters.yaml"),
                "--private-config-path", node_dir,
                "--verifier", args.verifier,
            ],
            cwd=_REPO, env=node_env, stdout=log, stderr=subprocess.STDOUT,
        ))
    scrapes: Dict[str, Optional[dict]] = {}
    # Boot probe: one scrape right after launch, before any INITIAL_DELAY
    # load lands.  It snapshots the counter window start (so cumulative
    # cpu/leader gauges can be re-windowed to the loaded interval) and is
    # usually the only /health capture that succeeds when the load later
    # saturates the event loop.
    first_scrapes: Dict[str, dict] = {}
    deadline = time.monotonic() + args.duration
    exit_codes: Dict[str, Optional[int]] = {}
    try:
        # Two probe passes: the first often lands mid-boot (verifier
        # warmup keeps the loop too busy for /health), so the second is
        # both the /health retry and the real window start — each pass
        # overwrites first_scrapes, carrying any captured host block.
        for _ in range(2):
            time.sleep(min(3.0, max(0.5, args.duration / 8.0)))
            for idx, (host, port) in enumerate(targets):
                scrape = scrape_node(host, port)
                if scrape is None:
                    continue
                prev = first_scrapes.get(str(idx))
                if scrape.get("host") is None and prev is not None:
                    scrape["host"] = prev.get("host")
                first_scrapes[str(idx)] = scrape
                scrapes[str(idx)] = scrape
        # The fleet runs on the host clock, never under the simulator.
        while time.monotonic() < deadline - 1.0:  # lint: ignore[sim-taint]
            time.sleep(min(args.scrape_interval,  # lint: ignore[sim-taint]
                           max(0.5, deadline - time.monotonic() - 1.0)))
            for idx, (host, port) in enumerate(targets):
                scrape = scrape_node(host, port)
                if scrape is not None:
                    prev = scrapes.get(str(idx))
                    if scrape.get("host") is None and prev is not None:
                        # /health can still time out when the loop is
                        # saturated; the host block (native inventory,
                        # thread census) barely moves, so keep the last
                        # one we captured rather than dropping it.
                        scrape["host"] = prev.get("host")
                    scrapes[str(idx)] = scrape  # keep the freshest
    finally:
        for idx, proc in enumerate(procs):
            try:
                exit_codes[str(idx)] = proc.wait(timeout=args.duration + 60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                exit_codes[str(idx)] = None
        for log in logs:
            log.close()
    reports: Dict[str, Optional[dict]] = {}
    for i in range(args.committee_size):
        path = os.path.join(wd, f"validator-{i}", "perf_report.json")
        try:
            with open(path) as f:
                reports[str(i)] = json.load(f)
        except (OSError, ValueError):
            reports[str(i)] = None
    doc = aggregate(scrapes, reports)
    # Re-window the cumulative cpu/leader counters to [boot probe, last
    # scrape]: the node's own us_per_leader gauge averages from process
    # start, so cheap pre-load boot rounds dilute it.
    windowed: Dict[str, Dict[str, float]] = {}
    for key, last in scrapes.items():
        head = first_scrapes.get(key)
        if not last or not head or last is head:
            continue
        dleaders = last["leaders"] - head["leaders"]
        if dleaders <= 0:
            continue
        windowed[key] = {
            sub: round(
                1e6 * (cpu - head["cpu_seconds"].get(sub, 0.0)) / dleaders, 1
            )
            for sub, cpu in last["cpu_seconds"].items()
        }
    doc["windowed_us_per_leader_by_node"] = windowed
    doc.update(
        metric="perf_attr",
        nodes=args.committee_size,
        duration_s=args.duration,
        verifier=args.verifier,
        tps_per_node=args.tps,
        scraped_nodes=len(scrapes),
        reports_written=sum(1 for r in reports.values() if r is not None),
        exit_codes=exit_codes,
    )
    if args.round is not None:
        doc["round"] = args.round
    weather = host_weather()
    if weather is not None:
        doc["weather"] = weather
    return doc


def host_weather() -> Optional[dict]:
    """The host conditions the artifact was measured under (load averages,
    CPU steal, the interpreter's switch interval, free memory, net bytes):
    one ``orchestrator.hostmon.HostSampler`` sample without its per-process
    block, or None on a host without psutil (the artifact rides without)."""
    try:
        from mysticeti_tpu_torch.orchestrator.hostmon import HostSampler

        sample = HostSampler().sample()
    except Exception:  # noqa: BLE001 - no psutil: artifact rides without
        return None
    return {k: v for k, v in sample.items() if k != "per_process"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m mysticeti_tpu_torch.tools.perf_attr", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--committee-size", type=int, default=4)
    parser.add_argument("--duration", type=float, default=45.0)
    parser.add_argument("--tps", type=int, default=100,
                        help="offered load per node (generator tx/s)")
    parser.add_argument("--verifier", default=DEFAULT_VERIFIER)
    parser.add_argument("--working-dir", default=build_path("perf-attr-testbed"))
    parser.add_argument("--scrape-interval", type=float, default=5.0)
    parser.add_argument("--port-base", type=int, default=DEFAULT_PORT_BASE,
                        help="node i listens on BASE+i and serves /metrics "
                        "on BASE+1000+i")
    parser.add_argument("--round", type=int, default=None,
                        help="bench round number (names the artifact "
                        "PERF_ATTR_rNN.json)")
    parser.add_argument("--out", default=None,
                        help="artifact path (default build/PERF_ATTR.json, "
                        "build/PERF_ATTR_rNN.json with --round)")
    parser.add_argument("--no-trend", action="store_true",
                        help="skip the trend index append")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = args.out
    if out is None:
        out = os.path.join("build", (
            f"PERF_ATTR_r{args.round:02d}.json"
            if args.round is not None
            else "PERF_ATTR.json"
        ))
    out = os.path.join(_REPO, out) if not os.path.isabs(out) else out

    doc = run_fleet(args)
    write_json(out, doc, indent=1, sort_keys=True)
    print(f"wrote {out}", file=sys.stderr)
    if not args.no_trend:
        from mysticeti_tpu_torch.tools.bench_trend import append_artifact

        added = append_artifact(out)
        print(f"trend index: {added} new record(s)", file=sys.stderr)

    print(json.dumps(
        {
            "attributed_ratio": doc.get("attributed_ratio"),
            "loop_lag_p99_s_max": doc["loop_lag"]["p99_s_max"],
            "gil_convoy_ratio": doc["gil_convoy_ratio"],
            "occupancy": doc["device"]["occupancy_fractions"],
            "subsystems": {
                k: v.get("us_per_leader")
                for k, v in doc["subsystems"].items()
                if v.get("us_per_leader")
            },
            "exit_codes": doc["exit_codes"],
        },
        indent=1, sort_keys=True,
    ))
    return 0 if all(code == 0 for code in doc["exit_codes"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
