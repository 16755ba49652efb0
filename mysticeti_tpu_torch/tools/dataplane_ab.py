"""Same-box A/B of the native data plane: extension vs pure fallback.

The port's copy of the JAX repository's ``tools/dataplane_ab.py``.  Runs the
``perf_attr`` subprocess fleet twice — once with the native extension loaded
(the batched frame encode/parse + digest offload path) and once with
``MYSTICETI_NO_NATIVE=1`` pinning the pure-Python twin everywhere.
``MYSTICETI_NO_NATIVE`` is read at import time, so the mode toggle lives in
the NODE subprocess environment; the two fleets are otherwise identical
(same box, same load, ABBA-interleaved repeats so drift cancels).

Acceptance evidence written to the document:

* committed leaders (fleet mean) — native must be >= the fallback baseline;
* PERF_ATTR-attributed hot-path CPU per committed leader — the
  mesh-encode + mesh-parse + digest subsystem sum must drop >= 25%;
* the ``/health`` host block's ``native_active`` inventory per mode — the
  document records which path each fleet actually measured;
* the data-plane microbench (``node_bench.dataplane_bench``) embedded for
  context — native batched encode+parse+digest must be >= 2x the pure
  per-block path.

The nodes verify through ``--verifier`` (default ``cuda-only``; the JAX
tool's default is ``cpu``).  A card kind builds the kernels in this process
first (``maxload_bench.prewarm``), which raises without a card; each node
opens a CUDA context of its own unless ``MYSTICETI_VERIFIER_SOCKET`` names a
verifier service, which the nodes then share.  The document carries
``card`` (nvidia-smi's name and power limit, None without a card).  The
microbench and the A/B records go to the port's trend index
(``node_bench``'s appends: ``build/BENCH_TREND.json`` or
``BENCH_TREND_PATH``, each record with the card; skipped without a card,
and with ``--no-trend``).  ``--port-base`` moves ``benchmark-genesis``'s
ports.

Usage::

    python -m mysticeti_tpu_torch.tools.dataplane_ab --round 19
    python -m mysticeti_tpu_torch.tools.dataplane_ab --verifier cpu --duration 10 --repeats 1
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from mysticeti_tpu_torch.cli import DEFAULT_VERIFIER, VERIFIER_CHOICES
from mysticeti_tpu_torch.config import DEFAULT_PORT_BASE
from mysticeti_tpu_torch.tools import build_path, card, write_json
from mysticeti_tpu_torch.tools.maxload_bench import card_kind, prewarm

DEFAULT_WORKDIR = build_path("dataplane-ab")

# The attributed subsystems the native path accelerates: whole-frame encode
# (synchronizer/network), whole-frame parse + block decode
# (net_sync/serde/types.from_bytes*), and the digest pair (crypto).
HOT_SUBSYSTEMS = ("mesh-encode", "mesh-parse", "digest")


def run_mode(mode: str, rep: int, args, env=None) -> dict:
    """One fleet run in the given mode, with ``env`` over the nodes'
    environment; returns the perf_attr doc."""
    from mysticeti_tpu_torch.tools import perf_attr

    # run_fleet starts every node with this process's environment and
    # ``env`` over it.  Load starts at the stock INITIAL_DELAY: holding the
    # generators back any longer lets empty rounds race ahead (~10/s idle vs
    # ~2/s loaded on a small host), which pads the committed-leader totals
    # of both arms with cheap leaders and buries the throughput signal.
    env = {"TRANSACTION_SIZE": str(args.tx_size), **(env or {})}
    if mode == "fallback":
        env["MYSTICETI_NO_NATIVE"] = "1"
    fleet_args = argparse.Namespace(
        committee_size=args.committee,
        duration=args.duration,
        tps=args.tps,
        verifier=args.verifier,
        working_dir=os.path.join(args.workdir, f"{mode}-{rep}"),
        scrape_interval=args.scrape_interval,
        round=args.round,
        port_base=args.port_base,
    )
    saved = os.environ.pop("MYSTICETI_NO_NATIVE", None)
    try:
        doc = perf_attr.run_fleet(fleet_args, env=env)
    finally:
        if saved is not None:
            os.environ["MYSTICETI_NO_NATIVE"] = saved
    doc["mode"] = mode
    doc["rep"] = rep
    return doc


def subsystem_us_per_leader(doc: dict, sub: str) -> float:
    """One subsystem's attributed µs per committed leader, fleet-averaged.

    Prefers perf_attr's windowed view (counter deltas between the boot
    probe and the last scrape) — the node's own cumulative gauge counts
    the cheap empty rounds committed before the transaction generators
    start, which dilutes a load A/B.  Falls back to the cumulative gauge
    when no window was captured."""
    windowed = doc.get("windowed_us_per_leader_by_node") or {}
    if windowed:
        return statistics.mean(
            node.get(sub, 0.0) for node in windowed.values()
        )
    return doc["subsystems"].get(sub, {}).get("us_per_leader") or 0.0


def hotpath_us_per_leader(doc: dict) -> float:
    """mesh-encode + mesh-parse + digest attributed µs per committed
    leader, fleet-averaged (the quantity the 25% gate is about)."""
    return sum(subsystem_us_per_leader(doc, sub) for sub in HOT_SUBSYSTEMS)


def mean_leaders(doc: dict) -> float:
    leaders = list(doc["committed_leaders_by_node"].values())
    return statistics.mean(leaders) if leaders else 0.0


def combined_of(bench: dict) -> float:
    """A microbench pass's native-over-fallback encode+parse+digest ratio."""
    return (bench.get("speedups") or {}).get("combined_encode_parse_digest") or 0.0


def native_inventory(docs) -> dict:
    """The first ``native_active`` host block a fleet captured: under
    saturating load a /health scrape can miss."""
    for doc in docs:
        for node in (doc.get("native_active_by_node") or {}).values():
            if node is not None:
                return node
    return None


def comparison_of(runs: dict) -> dict:
    """The JAX tool's comparison block over ``runs`` (mode -> perf_attr
    documents), with ``hotpath_cpu_reduction_pct``."""
    comparison = {
        "committed_leaders_mean": {
            m: round(statistics.mean(mean_leaders(doc) for doc in runs[m]), 1) for m in runs
        },
        "hotpath_us_per_leader": {
            m: round(statistics.mean(hotpath_us_per_leader(doc) for doc in runs[m]), 2)
            for m in runs
        },
        "hotpath_subsystems": {
            m: {
                sub: round(statistics.mean(
                    subsystem_us_per_leader(doc, sub) for doc in runs[m]
                ), 2)
                for sub in HOT_SUBSYSTEMS
            }
            for m in runs
        },
        "native_active": {m: native_inventory(runs[m]) for m in runs},
    }
    fallback_cost = comparison["hotpath_us_per_leader"]["fallback"]
    native_cost = comparison["hotpath_us_per_leader"]["native"]
    comparison["hotpath_cpu_reduction_pct"] = (
        round(100.0 * (1.0 - native_cost / fallback_cost), 1)
        if fallback_cost > 0
        else 0.0
    )
    return comparison


def ab_records(comparison: dict, round_: int) -> list:
    """The NODE_DATAPLANE A/B trend records: leaders per attributed hot-path
    CPU second a mode (the PERF_ATTR budget-row inversion, higher is
    better, so cost creep fires the stock >10% trend gate) and the
    reduction."""
    from mysticeti_tpu_torch.tools import bench_trend

    source = f"DATAPLANE_r{round_:02d}.json"
    fresh = []
    for mode in ("fallback", "native"):
        cost = comparison["hotpath_us_per_leader"][mode]
        if cost > 0:
            fresh.append(bench_trend._record(
                round_, source, f"NODE_DATAPLANE.ab_{mode}_leaders_per_hotpath_cpu_s",
                round(1e6 / cost, 3), "ldr/cpu-s",
            ))
    fresh.append(bench_trend._record(
        round_, source, "NODE_DATAPLANE.ab_hotpath_cpu_reduction",
        comparison["hotpath_cpu_reduction_pct"], "%",
    ))
    return fresh


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dataplane_ab", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--committee", type=int, default=4)
    parser.add_argument("--duration", type=float, default=45.0)
    parser.add_argument("--tps", type=int, default=800)
    parser.add_argument(
        "--tx-size", type=int, default=4096,
        help="transaction payload bytes (TRANSACTION_SIZE in the node env): "
        "the data-plane win scales with frame bytes, so the A/B runs a "
        "byte-heavy load where codec+digest work is a visible fraction of "
        "the hot path",
    )
    parser.add_argument(
        "--verifier", choices=VERIFIER_CHOICES, default=DEFAULT_VERIFIER,
        help="node verifier for both fleets ('accept' lets empty rounds race "
        "and spreads the byte-work over 3-4x the leaders, hiding the "
        "data-plane cost the A/B is about)",
    )
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--scrape-interval", type=float, default=5.0)
    parser.add_argument(
        "--repeats", type=int, default=2,
        help="fleet runs per mode, ABBA-interleaved so same-box drift "
        "cancels",
    )
    parser.add_argument("--round", type=int, default=19)
    parser.add_argument("--out", default=None,
                        help="document path (default build/DATAPLANE_rNN.json)")
    parser.add_argument("--no-trend", action="store_true")
    parser.add_argument("--port-base", type=int, default=DEFAULT_PORT_BASE,
                        help="node i listens on BASE+i and serves /metrics "
                        "on BASE+1000+i")
    args = parser.parse_args(argv)
    out = args.out or build_path(f"DATAPLANE_r{args.round:02d}.json")

    from mysticeti_tpu_torch.native import native

    if native is None:
        print(
            "native extension unavailable: the A/B has no treatment arm",
            file=sys.stderr,
        )
        return 2
    if card_kind(args.verifier):
        print("prewarming the kernels...", flush=True)
        prewarm(args.committee)

    # Microbench first, while the box is quiet: fleet teardown (WAL
    # flush, exiting nodes) contends with timing loops for a while after
    # a run, which skews the per-call speedups on small hosts.  Best of
    # three passes — the classic interference guard for a timing loop on
    # a shared 1-core host; each pass is already iters-averaged inside.
    from mysticeti_tpu_torch.tools.node_bench import (
        _append_trend,
        _report_append,
        append_dataplane_trend,
        dataplane_bench,
    )

    passes = [dataplane_bench() for _ in range(3)]
    microbench = max(passes, key=combined_of)
    microbench["combined_speedup_passes"] = [round(combined_of(b), 2) for b in passes]
    combined = combined_of(microbench)
    print(f"microbench combined speedup: {combined} "
          f"(passes {microbench['combined_speedup_passes']})", flush=True)

    schedule = []
    for i in range(args.repeats):
        pair = ["fallback", "native"] if i % 2 == 0 else ["native", "fallback"]
        schedule += [(mode, i) for mode in pair]
    runs = {"fallback": [], "native": []}
    for mode, rep in schedule:
        print(f"running {mode} fleet rep {rep} ({args.duration:.0f}s)...", flush=True)
        doc = run_mode(mode, rep, args)
        print(json.dumps(
            {
                "mode": mode,
                "leaders": doc["committed_leaders_by_node"],
                "hotpath_us_per_leader": round(hotpath_us_per_leader(doc), 1),
            },
        ), flush=True)
        runs[mode].append(doc)

    comparison = comparison_of(runs)
    reduction_pct = comparison["hotpath_cpu_reduction_pct"]
    acceptance = {
        "committed_leaders_not_worse": (
            comparison["committed_leaders_mean"]["native"]
            >= comparison["committed_leaders_mean"]["fallback"]
        ),
        "hotpath_cpu_reduced_25pct": reduction_pct >= 25.0,
        "microbench_combined_2x": combined >= 2.0,
    }

    artifact = {
        "metric": "native_dataplane_ab",
        "round": args.round,
        "committee": args.committee,
        "duration_s": args.duration,
        "tps_per_node": args.tps,
        "transaction_size": args.tx_size,
        "verifier": args.verifier,
        "card": card(),
        "repeats": args.repeats,
        "note": (
            "same-box ABBA fleets: fallback = MYSTICETI_NO_NATIVE=1 in the "
            "node subprocess env (pure-Python frame codecs + per-block "
            "hashlib digests); native = the extension (batched GIL-free "
            "encode/parse/digest + offload executor).  Wire frames are "
            "byte-identical across modes (golden corpus + parity suite); "
            "only the CPU cost per committed leader moves."
        ),
        "comparison": comparison,
        "acceptance": acceptance,
        "microbench": microbench,
        "runs": runs,
    }
    write_json(out, artifact, indent=1, sort_keys=True)
    print(f"wrote {out}")
    print(json.dumps({"comparison": comparison, "acceptance": acceptance}, indent=1))

    if not args.no_trend:
        appended = append_dataplane_trend(microbench, args.round)
        appended = _append_trend(ab_records(comparison, args.round)) and appended
        _report_append(appended, "NODE_DATAPLANE")

    return 0 if all(acceptance.values()) else 3


if __name__ == "__main__":
    raise SystemExit(main())
