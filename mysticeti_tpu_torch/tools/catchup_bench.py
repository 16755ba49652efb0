"""Crash-recovery catch-up race per verifier kind.

The port's copy of the JAX repository's ``tools/catchup_bench.py``.  A
validator rejoining after downtime must verify its whole missed backlog —
deep, multi-author batches arriving as fast as peers can stream them.  This
is the fleet-level regime where signature verification (not the consensus
engine) binds, the regime BASELINE configs #4/#5 describe: the
threshold-aggregate verifier (``-agg``) skips quorum-endorsed interior
blocks (crypto.rs:77-84's layering licenses the skip) and the card batches
the frontier, while the CPU oracle pays for each signature serially.

Reference anchors: crash-recovery faults (orchestrator/src/faults.rs:104-160),
WAL replay recovery (state.rs:23-95), the verifier seam
(block_validator.rs:10-14).

Measured per verifier kind (default ``cpu``, ``cpu-agg`` and ``cuda-agg``;
the JAX tool's third is ``tpu-agg``):
  * reboot_to_metrics_s       — process boot + WAL replay until /metrics serves
  * reboot_to_first_verify_s  — until the first peer block passes verification;
    ``first_verify_measures`` says what that includes: behind a card kind's
    verifier service (which stays up while the node is down) the node's
    reconnection to the warm service, not a kernel build
  * reboot_to_caught_up_s     — until the rebooted node's commit_round reaches
    the live fleet's (within MARGIN_ROUNDS rounds)
  * catchup verification counters — direct vs aggregate-skipped
  * the fleet's health after recovery, and (the port's additions) ``fleet``
    and ``victim_at_finish``: ``maxload_bench.fleet_counters`` of that last
    scrape, over the fleet and over the rebooted node alone (its flushes and
    their lanes since the reboot).

The document carries ``card`` (nvidia-smi's name and power limit, None
without a card) where the JAX tool carried a host note.  A card kind builds
the kernels in this process first; without a card that raises before any
fleet boots.  The regime's knobs are set here and reach genesis, the
verifier service and every node through the runner's environment.

Usage::

    python -m mysticeti_tpu_torch.tools.catchup_bench \\
        --verifiers cpu cpu-agg cuda-only cuda-agg --down 45
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
    regime_env,
    set_port_base,
)

DEFAULT_OUT = build_path("CATCHUP.json")
DEFAULT_WORKDIR = build_path("catchup")
MARGIN_ROUNDS = 20


def parse_metrics(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name_labels, _, rest = line.partition(" ")
        try:
            value = float(rest.split()[0])
        except ValueError:
            continue
        out[name_labels] = value
    return out


def metric(samples: dict, name: str, default=0.0) -> float:
    return samples.get(name, default)


def sig_counters(samples: dict) -> dict:
    direct = skipped = rejected = 0.0
    for key, value in samples.items():
        if not key.startswith("verified_signatures_total{"):
            continue
        if 'outcome="skipped"' in key:
            skipped += value
        elif 'outcome="rejected"' in key:
            rejected += value
        elif 'outcome="accepted"' in key:
            direct += value
    total = direct + skipped
    return {
        "direct": int(direct),
        "skipped": int(skipped),
        "rejected": int(rejected),
        "skip_frac": round(skipped / total, 3) if total else 0.0,
    }


def first_verify_measures(verifier: str) -> str:
    """What ``reboot_to_first_verify_s`` includes for this kind."""
    if not card_kind(verifier):
        return "the rebooted node's boot and its first verification on the host"
    if os.environ.get("MYSTICETI_NO_VERIFIER_SERVICE"):
        return "the rebooted node's own CUDA context and kernel load from the build cache"
    return "the rebooted node's reconnection to the fleet's warm verifier service"


async def scrape_parsed(runner, authority):
    text = await runner.scrape(authority)
    return parse_metrics(text) if text is not None else None


async def wait_for(predicate, timeout_s: float, interval_s: float = 0.5):
    """Poll an async predicate; returns (elapsed_s, value) or (None, None).
    A real fleet's wall clock: the tool never runs under the simulator."""
    started = time.monotonic()
    while time.monotonic() - started < timeout_s:  # lint: ignore[sim-taint]
        value = await predicate()
        if value is not None:
            return time.monotonic() - started, value
        await asyncio.sleep(interval_s)
    return None, None


async def run_one(verifier: str, nodes: int, load: int, down_s: float,
                  workdir: str) -> dict:
    # Pinned (not setdefault) so an ambient INITIAL_DELAY cannot skew one
    # kind's steady window; a card kind's nodes boot behind the warm
    # verifier service, so one delay serves every kind.
    os.environ["INITIAL_DELAY"] = "1"
    runner = LocalProcessRunner(os.path.join(workdir, f"fleet-{verifier}"), verifier=verifier)
    result = {"verifier": verifier, "nodes": nodes,
              "offered_load_tx_s": load, "down_s": down_s,
              "first_verify_measures": first_verify_measures(verifier)}
    await runner.configure(nodes, load)
    for a in range(nodes):
        await runner.boot_node(a)

    # Steady state: commits flowing on node 0.
    async def committing():
        m = await scrape_parsed(runner, 0)
        # Steady = consensus cadence AND transaction flow: opening the
        # window on commit_round alone can catch the pre-generator phase.
        if (
            m
            and metric(m, "commit_round") > 30
            and metric(m, 'latency_s_count{workload="shared"}') > 0
        ):
            return m
        return None

    elapsed, m0 = await wait_for(committing, timeout_s=300, interval_s=1.0)
    if m0 is None:
        await runner.cleanup()
        result["error"] = "fleet never reached steady commits"
        return result
    result["boot_to_steady_s"] = round(elapsed, 1)

    # Fleet commit cadence + tps over a short steady window.
    r_start = metric(m0, "commit_round")
    c_start = metric(m0, 'latency_s_count{workload="shared"}')
    window_t0 = time.monotonic()
    await asyncio.sleep(10)
    # A single transient scrape failure must not abort the whole run —
    # retry briefly instead of calling metric(None, ...).
    _, m0 = await wait_for(lambda: scrape_parsed(runner, 0), timeout_s=30, interval_s=0.5)
    if m0 is None:
        await runner.cleanup()
        result["error"] = "steady-window scrape failed"
        return result
    # Divide by the MEASURED window: scrape retries can stretch it past the
    # nominal 10 s.
    window_s = time.monotonic() - window_t0
    r_now = metric(m0, "commit_round")
    result["steady_rounds_per_s"] = round((r_now - r_start) / window_s, 1)
    result["steady_tps"] = round(
        (metric(m0, 'latency_s_count{workload="shared"}') - c_start) / window_s, 1
    )

    victim = nodes - 1
    await runner.kill_node(victim)
    round_at_kill = r_now
    await asyncio.sleep(down_s)
    _, m0 = await wait_for(lambda: scrape_parsed(runner, 0), timeout_s=30, interval_s=0.5)
    if m0 is None:
        await runner.cleanup()
        result["error"] = "reboot-backlog scrape failed"
        return result
    fleet_round_at_reboot = metric(m0, "commit_round")
    result["backlog_rounds"] = int(fleet_round_at_reboot - round_at_kill)

    t0 = time.monotonic()
    await runner.boot_node(victim)

    async def metrics_up():
        return await scrape_parsed(runner, victim)

    elapsed, mv = await wait_for(metrics_up, timeout_s=120, interval_s=0.25)
    result["reboot_to_metrics_s"] = round(elapsed, 2) if elapsed is not None else None

    async def first_verify():
        m = await scrape_parsed(runner, victim)
        if m is None:
            return None
        c = sig_counters(m)
        return c if (c["direct"] + c["skipped"]) > 0 else None

    elapsed, _ = await wait_for(first_verify, timeout_s=240, interval_s=0.25)
    result["reboot_to_first_verify_s"] = (
        round(time.monotonic() - t0, 2) if elapsed is not None else None
    )

    async def caught_up():
        mv = await scrape_parsed(runner, victim)
        m0 = await scrape_parsed(runner, 0)
        if mv is None or m0 is None:
            return None
        lead = metric(m0, "commit_round")
        own = metric(mv, "commit_round")
        if own > 0 and lead - own <= MARGIN_ROUNDS:
            return mv
        return None

    elapsed, mv = await wait_for(caught_up, timeout_s=600, interval_s=0.5)
    result["reboot_to_caught_up_s"] = (
        round(time.monotonic() - t0, 2) if elapsed is not None else None
    )
    if mv is not None:
        result["catchup_verification"] = sig_counters(mv)
    host = await runner.host_sample()
    if host is not None:
        result["host_after_recovery"] = {
            k: host[k] for k in ("cpu_pct", "load_1m") if k in host
        }
    # Fleet health snapshot at the finish line (health plane): the document
    # says whether the recovered fleet is actually green — participation,
    # stragglers, SLO alerts — not just that the victim's round caught up.
    from mysticeti_tpu_torch.health import cluster_snapshot_from_texts

    texts = {}
    for authority in range(nodes):
        texts[str(authority)] = await runner.scrape(authority)
    result["health_after_recovery"] = cluster_snapshot_from_texts(texts, nodes)
    result["fleet"] = fleet_counters(texts.values())
    result["victim_at_finish"] = fleet_counters([texts[str(victim)]])
    await runner.cleanup()
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 7 nodes so one crash leaves the fleet well above quorum (5): commits
    # keep pace during the downtime and a real backlog accumulates (4 nodes
    # minus one is EXACTLY quorum — the fleet crawls and there is nothing to
    # catch up on).
    parser.add_argument("--nodes", type=int, default=7)
    parser.add_argument("--load", type=int, default=3200)
    parser.add_argument("--down", type=float, default=45.0)
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--max-block-tx", type=int, default=16)
    parser.add_argument("--verifiers", nargs="+", default=["cpu", "cpu-agg", "cuda-agg"],
                        choices=VERIFIER_CHOICES)
    parser.add_argument("--port-base", type=int, default=None,
                        help="first node port (metrics +1000); default "
                        "benchmark-genesis's 1500")
    args = parser.parse_args(argv)
    set_port_base(args.port_base)

    # Genesis-time + node env: the retain window must cover the whole
    # downtime's rounds or peers prune the backlog the victim needs.
    os.environ.update(regime_env(args.max_block_tx))

    if any(card_kind(v) for v in args.verifiers):
        print("prewarming the kernels...", flush=True)
        prewarm(args.nodes)

    runs = []
    for verifier in args.verifiers:
        print(f"catch-up race verifier={verifier}...", flush=True)
        run = asyncio.run(run_one(verifier, args.nodes, args.load, args.down, args.workdir))
        runs.append(run)
        print(json.dumps(run), flush=True)

    artifact = {
        "metric": "crash_recovery_catchup_by_verifier",
        "config": {
            "nodes": args.nodes,
            "offered_load_tx_s": args.load,
            "down_s": args.down,
            "max_block_tx": args.max_block_tx,
            "note": (
                "A rebooted validator must verify its missed backlog in deep"
                " multi-author batches — the fleet-level regime where"
                " signature verification binds (BASELINE #4/#5). Caught-up ="
                f" commit_round within {MARGIN_ROUNDS} rounds of the live"
                " fleet."
            ),
        },
        "card": card(),
        "runs": runs,
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
