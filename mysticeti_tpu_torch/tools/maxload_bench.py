"""Max-sustainable-load search over a local fleet, per verifier kind.

The port's copy of the JAX repository's ``tools/maxload_bench.py``: runs the
orchestrator's binary search (benchmark.rs:202-271 semantics — double until
out-of-capacity, then bisect; out-of-capacity = avg latency > 5x previous or
tps < 2/3 offered) over the port's ``Orchestrator`` and
``LocalProcessRunner`` with the chosen ``--verifiers`` and records every
probe.

The same host moves its peak between hours, so a lone peak is not evidence.
Every probe embeds the host-weather summary (``orchestrator.hostmon``, where
psutil is installed) and its wall-clock window, and every non-``cpu`` run is
followed at once by a fixed-load ``cpu`` reference probe at that run's peak:
each artifact is a self-contained same-window A/B.

The default kind is ``cuda-only`` (the JAX tool's is ``cpu``): a card kind's
fleet shares one verifier service on the card, which the runner warms
before any node boots.  The kernels are built first in this process
(``prewarm``), so the service's load is a cache hit; without a card that
raises before any fleet boots.  The port adds to the JAX tool's document
``card`` (nvidia-smi's name and power limit, None without a card) and, per
probe, ``fleet``: what the nodes' last scrapes counted of batches degraded
to the CPU oracle, invalid blocks, flushes and their lanes, and the
transactions their load generators submitted (which falls short of the
offered load times the window where the generators cannot keep up).
``--port-base``
moves ``benchmark-genesis``'s fixed ports (1500+i, metrics 2500+i).  Each
search run adds ``out_of_capacity_load_tx_s``: the lowest load a probe ran
out of capacity at, or None where every probe kept up and the search ended
on its iteration cap (its ``max_sustainable_load_tx_s`` is then only a
floor).  ``bench_trend``'s scan reads the document into the port's trend
index, its records tagged with the document's ``card``.

Usage::

    python -m mysticeti_tpu_torch.tools.maxload_bench            # cuda-only
    python -m mysticeti_tpu_torch.tools.maxload_bench --verifiers cpu cuda-only \\
        --out build/MAXLOAD_r19.json
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from typing import Iterable, List, Optional

from mysticeti_tpu_torch.cli import VERIFIER_CHOICES
from mysticeti_tpu_torch.orchestrator.runner import CARD_KIND_PREFIX, LocalProcessRunner
from mysticeti_tpu_torch.tools import build_path, card, write_json

DEFAULT_OUT = build_path("MAXLOAD.json")
DEFAULT_WORKDIR = build_path("maxload")

# Under MYSTICETI_NO_VERIFIER_SERVICE every node of a card kind opens a CUDA
# context of its own: a node process took 12.9-14.8 s from its start to a
# ready verifier on an H100 host (node-proc-10, PERF.md section 5).  The
# load starts after this delay, and the window keeps 30 s of load past it.
NO_SERVICE_INITIAL_DELAY_S = 15
NO_SERVICE_MIN_DURATION_S = 45.0

# The series a fleet's last scrapes are read for (``fleet_counters``).
FLEET_SERIES = {
    "verifier_fallback_total": "verifier_fallback",
    "mysticeti_invalid_blocks_total": "invalid_blocks",
    "verify_dispatch_batch_size_count": "flushes",
    "verify_dispatch_batch_size_sum": "dispatched_lanes",
    "mysticeti_client_submitted_total": "submitted",
}


def card_kind(verifier: str) -> bool:
    """Whether a node of this kind verifies on the card."""
    return verifier.startswith(CARD_KIND_PREFIX)


def probe_window(verifier: str, duration: float) -> float:
    """Pin the nodes' ``INITIAL_DELAY`` for this kind and return its probe
    window: identical delays keep probes comparable, but without the
    verifier service a card kind's nodes each load the kernels first."""
    os.environ["INITIAL_DELAY"] = "1"
    if card_kind(verifier) and os.environ.get("MYSTICETI_NO_VERIFIER_SERVICE"):
        os.environ["INITIAL_DELAY"] = str(NO_SERVICE_INITIAL_DELAY_S)
        duration = max(duration, NO_SERVICE_MIN_DURATION_S)
    return duration


def regime_env(max_block_tx: int) -> dict:
    """The verification-bound regime (catch-up's genesis-time and node
    env): small blocks raise the signature rate per committed tx, the
    retain window keeps sync streams deep (peers must keep a downtime's
    rounds for the rejoiner to fetch), and the short leader timeout keeps
    stalls from hiding verification cost."""
    return {
        "MYSTICETI_MAX_BLOCK_TX": str(max_block_tx),
        "MYSTICETI_RETAIN_ROUNDS": "100000",
        "MYSTICETI_LEADER_TIMEOUT": "0.25",
    }


def set_port_base(base: Optional[int]) -> None:
    """Move ``benchmark-genesis``'s ports (node ``base+i``, metrics
    ``base+1000+i``) for the fleets this process boots."""
    if base is not None:
        from mysticeti_tpu_torch import config

        config.DEFAULT_PORT_BASE = base


def prewarm(nodes: int, device="cuda:0") -> str:
    """Build the kernels and upload the benchmark committee's combs once, in
    this process, so every verifier service of the run loads them from the
    build cache.  Raises without a card.  Returns the backend's device
    type."""
    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee

    backend = TorchSignatureVerifier(
        committee_keys=Committee.new_for_benchmarks(nodes).public_key_bytes(), device=device)
    backend.warmup()
    return backend.resolved_backend()


def fleet_counters(texts: Iterable[Optional[str]]) -> dict:
    """``FLEET_SERIES`` summed over the nodes' ``/metrics`` texts (None =
    unreachable), with how many answered."""
    from mysticeti_tpu_torch.orchestrator.measurement import iter_series

    out = {key: 0.0 for key in FLEET_SERIES.values()}
    scraped = 0
    for text in texts:
        if text is None:
            continue
        scraped += 1
        for name, _labels, value in iter_series(text):
            key = FLEET_SERIES.get(name)
            if key is not None:
                out[key] += value
    out = {k: int(v) for k, v in out.items()}
    out["scraped_nodes"] = scraped
    return out


class ScrapeLog(LocalProcessRunner):
    """The port's ``LocalProcessRunner``, unchanged, keeping each run's last
    ``/metrics`` text a node answered (a run opens at ``configure``)."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.runs: List[dict] = []

    async def configure(self, committee_size: int, load_tx_s: int = 0) -> None:
        self.runs.append({"load": load_tx_s, "texts": {}})
        await super().configure(committee_size, load_tx_s)

    async def scrape(self, authority: int) -> Optional[str]:
        text = await super().scrape(authority)
        if text is not None and self.runs:
            self.runs[-1]["texts"][authority] = text
        return text

    def fleet(self, index: int = -1) -> dict:
        return fleet_counters(self.runs[index]["texts"].values())


def _probe_dicts(collections) -> list:
    probes = []
    for c in collections:
        probe = {
            "offered_load_tx_s": c.parameters["load"],
            "tps": round(c.aggregate_tps(), 1),
            "avg_latency_s": round(c.aggregate_average_latency_s(), 4),
            "stdev_latency_s": round(c.aggregate_stdev_latency_s(), 4),
        }
        host = c.host_summary()
        if host is not None:
            probe["host"] = host
        health = c.health_summary()
        if health is not None:
            # The probe ships with its own diagnosis (health plane): a peak
            # taken while participation dipped or SLO alerts fired is
            # visible in the artifact itself, not just in hindsight.
            probe["health"] = health
        probes.append(probe)
    return probes


def _with_fleets(probes: list, runner: ScrapeLog) -> list:
    for index, probe in enumerate(probes):
        probe["fleet"] = runner.fleet(index)
    return probes


async def run_fixed_probe(verifier: str, nodes: int, load: int,
                          duration: float, workdir: str) -> dict:
    """One fixed-load probe — the same-window reference leg of the A/B."""
    from mysticeti_tpu_torch.orchestrator.benchmark import LoadType, ParametersGenerator
    from mysticeti_tpu_torch.orchestrator.orchestrator import Orchestrator

    duration = probe_window(verifier, duration)
    runner = ScrapeLog(os.path.join(workdir, f"fleet-ref-{verifier}"), verifier=verifier)
    generator = ParametersGenerator(nodes, LoadType.fixed([load]), duration_s=duration)
    orch = Orchestrator(
        runner,
        generator,
        results_dir=os.path.join(workdir, f"results-ref-{verifier}"),
        scrape_interval_s=duration / 3,
    )
    started = time.time()
    collections = await orch.run_benchmarks()
    probes = _with_fleets(_probe_dicts(collections), runner)
    probe = probes[0] if probes else {"error": "reference probe recorded nothing"}
    probe["verifier"] = verifier
    probe["window_utc"] = [round(started, 1), round(time.time(), 1)]
    return probe


async def search_one(verifier: str, nodes: int, start_load: int,
                     duration: float, iterations: int, workdir: str) -> dict:
    from mysticeti_tpu_torch.orchestrator.benchmark import LoadType, ParametersGenerator
    from mysticeti_tpu_torch.orchestrator.orchestrator import Orchestrator

    # The runner blocks until a card kind's verifier service is warm before
    # booting nodes, so one delay serves every kind.
    duration = probe_window(verifier, duration)
    runner = ScrapeLog(os.path.join(workdir, f"fleet-{verifier}"), verifier=verifier)
    generator = ParametersGenerator(
        nodes,
        LoadType.search(start_load, max_iterations=iterations),
        duration_s=duration,
    )
    orch = Orchestrator(
        runner,
        generator,
        results_dir=os.path.join(workdir, f"results-{verifier}"),
        scrape_interval_s=duration / 3,
    )
    started = time.time()
    collections = await orch.run_benchmarks()
    probes = _with_fleets(_probe_dicts(collections), runner)
    peak = max((p["tps"] for p in probes), default=0.0)
    return {
        "verifier": verifier,
        "nodes": nodes,
        "max_sustainable_load_tx_s": generator.max_sustainable_load(),
        "out_of_capacity_load_tx_s": generator.out_of_capacity_load(),
        "peak_committed_tx_s": round(peak, 1),
        "window_utc": [round(started, 1), round(time.time(), 1)],
        "probes": probes,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--start-load", type=int, default=400)
    parser.add_argument("--duration", type=float, default=30.0)
    parser.add_argument("--iterations", type=int, default=7)
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--verifiers", nargs="+", default=["cuda-only"],
                        choices=VERIFIER_CHOICES)
    parser.add_argument("--port-base", type=int, default=None,
                        help="first node port (metrics +1000); default "
                        "benchmark-genesis's 1500")
    args = parser.parse_args(argv)
    set_port_base(args.port_base)

    if any(card_kind(v) for v in args.verifiers):
        print("prewarming the kernels...", flush=True)
        prewarm(args.nodes)

    runs = []
    for verifier in args.verifiers:
        print(f"max-load search verifier={verifier}...", flush=True)
        run = asyncio.run(
            search_one(verifier, args.nodes, args.start_load, args.duration,
                       args.iterations, args.workdir)
        )
        if verifier != "cpu":
            # Same-window reference leg: a cpu probe at THIS run's peak,
            # back-to-back so both legs share the host's current weather.
            ref_load = int(run["peak_committed_tx_s"]) or args.start_load
            print(f"  same-window cpu reference probe at {ref_load} tx/s...", flush=True)
            run["cpu_reference_probe"] = asyncio.run(
                run_fixed_probe("cpu", args.nodes, ref_load, args.duration, args.workdir)
            )
            ref_tps = run["cpu_reference_probe"].get("tps")
            if ref_tps:
                run["peak_vs_same_window_cpu"] = round(run["peak_committed_tx_s"] / ref_tps, 3)
        runs.append(run)
        print(json.dumps(run), flush=True)

    artifact = {
        "metric": "max_sustainable_load_tx_s",
        "card": card(),
        "search_rule": (
            "double until out-of-capacity (latency>5x prev or tps<2/3 "
            "offered), then bisect (benchmark.rs:202-271 semantics)"
        ),
        "ab_rule": (
            "every non-cpu run carries a cpu_reference_probe at its peak "
            "load, run back-to-back in the same weather window; "
            "peak_vs_same_window_cpu is the self-contained A/B ratio"
        ),
        "runs": runs,
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
