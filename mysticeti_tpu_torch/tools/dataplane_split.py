"""Three-arm split of ``dataplane_ab``: the native codecs with and without
the data-plane offload, against the pure fallback.

``dataplane_ab`` compares the native extension (batched codecs and
digests, with ``core_task.DataPlaneOffload`` moving frames of at least
``MIN_BATCH_BYTES`` to its worker thread) with ``MYSTICETI_NO_NATIVE=1``,
which turns off both.  This tool adds the middle arm: the native codecs
with the offload never taken.  The node code has no switch for that, so
the arm starts every node with a ``sitecustomize`` on ``PYTHONPATH`` (in
the tool's working directory) that raises ``MIN_BATCH_BYTES`` past any
frame.  The arms run at ``dataplane_ab``'s defaults, in the order
``--order`` gives (ABCCBA by default, so drift cancels), on each kind of
``--verifiers``.  A card kind's nodes verify through one verifier service
that the tool starts and warms for them (``MYSTICETI_VERIFIER_SOCKET``).

Each run keeps its leaders a node, the hot path a leader, the offload
worker's CPU seconds (none in the middle arm), ``perf_attr``'s loop lag
and GIL convoy ratio, and the threads' CPU seconds by class.

Usage::

    python -m mysticeti_tpu_torch.tools.dataplane_split
    python -m mysticeti_tpu_torch.tools.dataplane_split --verifiers cpu --duration 10
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from mysticeti_tpu_torch.config import DEFAULT_PORT_BASE
from mysticeti_tpu_torch.tools import REPO, ServiceChild, build_path, card, write_json
from mysticeti_tpu_torch.tools.dataplane_ab import (
    hotpath_us_per_leader,
    mean_leaders,
    run_mode,
)
from mysticeti_tpu_torch.tools.maxload_bench import card_kind, prewarm

DEFAULT_WORKDIR = build_path("dataplane-split")
# dataplane_ab's defaults: 4 nodes, 800 tx/s of 4,096 B, scraped every 5 s.
COMMITTEE, TPS, TX_SIZE, SCRAPE_INTERVAL_S = 4, 800, 4096, 5.0
ARMS = {"A": "native", "B": "native-no-offload", "C": "fallback"}
NO_OFFLOAD_HOOK = '''"""Starts a node with the data-plane offload never taken."""
from mysticeti_tpu_torch.core_task import DataPlaneOffload

DataPlaneOffload.MIN_BATCH_BYTES = 1 << 62
'''


def hook_dir(workdir: str) -> str:
    """A directory holding the no-offload ``sitecustomize``."""
    path = os.path.join(workdir, "no-offload-hook")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "sitecustomize.py"), "w") as f:
        f.write(NO_OFFLOAD_HOOK)
    return path


def arm_env(arm: str, workdir: str) -> dict:
    """The node environment over ``dataplane_ab``'s for one arm."""
    if arm != "native-no-offload":
        return {}
    paths = [hook_dir(workdir), REPO, os.environ.get("PYTHONPATH", "")]
    return {"PYTHONPATH": os.pathsep.join(p for p in paths if p)}


def thread_seconds(fleet_dir: str) -> dict:
    """The sampled CPU seconds of a fleet's nodes by thread class (loop,
    offload, verifier, wal, aux), summed from their shutdown reports."""
    out: dict = {}
    for node in sorted(os.listdir(fleet_dir)):
        path = os.path.join(fleet_dir, node, "perf_report.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            report = json.load(f)
        for key, seconds in report["cpu_seconds"].items():
            thread_class = key.rsplit("/", 1)[1]
            out[thread_class] = round(out.get(thread_class, 0.0) + seconds, 6)
    return dict(sorted(out.items()))


def run_reading(doc: dict, fleet_dir: str) -> dict:
    """What the split keeps of one fleet's ``perf_attr`` document and its
    nodes' reports."""
    subsystems = doc.get("subsystems") or {}
    threads = thread_seconds(fleet_dir)
    return {
        "leaders_mean": round(mean_leaders(doc), 2),
        "leaders_by_node": doc["committed_leaders_by_node"],
        "hotpath_us_per_leader": round(hotpath_us_per_leader(doc), 1),
        "offload_cpu_s": threads.get("offload", 0.0),
        "cpu_s_by_thread_class": threads,
        "cpu_s_by_subsystem": {k: v["cpu_s"] for k, v in subsystems.items()},
        "loop_lag": doc["loop_lag"],
        "gil_convoy_ratio": doc["gil_convoy_ratio"],
        "native_active": bool(any((doc.get("native_active_by_node") or {}).values())),
        "verifier_fallback_by_node": doc["verifier_fallback_by_node"],
        "exit_codes": doc["exit_codes"],
    }


def summary_of(runs: dict) -> dict:
    """Each arm's means over its runs, and its leaders over the fallback's."""
    out = {}
    for arm, readings in runs.items():
        out[arm] = {
            "leaders_mean": round(statistics.mean(r["leaders_mean"] for r in readings), 2),
            "leaders_reps": [r["leaders_mean"] for r in readings],
            "hotpath_us_per_leader": round(statistics.mean(
                r["hotpath_us_per_leader"] for r in readings), 1),
            "offload_cpu_s": round(sum(r["offload_cpu_s"] for r in readings), 3),
            "verifier_cpu_s": round(sum(
                r["cpu_s_by_thread_class"].get("verifier", 0.0) for r in readings), 3),
            "loop_cpu_s": round(sum(
                r["cpu_s_by_thread_class"].get("loop", 0.0) for r in readings), 3),
            "gil_convoy_ratio": round(statistics.mean(
                r["gil_convoy_ratio"] for r in readings), 4),
            "loop_lag_p50_s": round(statistics.mean(
                r["loop_lag"]["p50_s_mean"] for r in readings), 6),
            "loop_lag_p99_s": round(statistics.mean(
                r["loop_lag"]["p99_s_mean"] for r in readings), 6),
        }
    base = out.get("fallback", {}).get("leaders_mean")
    for arm in out.values():
        arm["over_fallback"] = round(arm["leaders_mean"] / base, 3) if base else None
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dataplane_split", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--verifiers", default="cpu,cuda-only",
                        help="comma-separated node kinds, each run through every arm")
    parser.add_argument("--order", default="ABCCBA",
                        help="the arms' order: A native, B native without the offload, "
                        "C fallback")
    parser.add_argument("--duration", type=float, default=45.0)
    parser.add_argument("--round", type=int, default=21)
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--out", default=None,
                        help="document path (default build/DATAPLANE_SPLIT_rNN.json)")
    parser.add_argument("--port-base", type=int, default=DEFAULT_PORT_BASE)
    args = parser.parse_args(argv)
    out = args.out or build_path(f"DATAPLANE_SPLIT_r{args.round:02d}.json")
    args.workdir = os.path.abspath(args.workdir)
    if set(args.order) - set(ARMS):
        parser.error(f"--order takes the letters {''.join(ARMS)}")

    from mysticeti_tpu_torch.native import native
    from mysticeti_tpu_torch.verifier_service import ENV_SOCKET

    if native is None:
        print("native extension unavailable: two arms have nothing to run", file=sys.stderr)
        return 2
    doc = {"metric": "native_dataplane_split", "round": args.round, "card": card(),
           "committee": COMMITTEE, "duration_s": args.duration, "tps_per_node": TPS,
           "transaction_size": TX_SIZE, "order": args.order, "kinds": {}}
    for verifier in args.verifiers.split(","):
        service = None
        saved = os.environ.get(ENV_SOCKET)
        if card_kind(verifier):
            print(f"{verifier}: prewarming the kernels and starting the service...", flush=True)
            prewarm(COMMITTEE)
            service = ServiceChild(os.path.join(args.workdir, f"{verifier}-service"),
                                   COMMITTEE)
            service.start()
            os.environ[ENV_SOCKET] = service.socket
        runs = {ARMS[letter]: [] for letter in dict.fromkeys(args.order)}
        try:
            for rep, letter in enumerate(args.order):
                arm = ARMS[letter]
                fleet = argparse.Namespace(
                    committee=COMMITTEE, duration=args.duration, tps=TPS, tx_size=TX_SIZE,
                    verifier=verifier, scrape_interval=SCRAPE_INTERVAL_S, round=args.round,
                    port_base=args.port_base,
                    workdir=os.path.join(args.workdir, verifier, arm))
                mode = "fallback" if arm == "fallback" else "native"
                print(f"{verifier} {arm} fleet {rep} ({args.duration:.0f} s)...", flush=True)
                doc_run = run_mode(mode, rep, fleet, env=arm_env(arm, args.workdir))
                reading = run_reading(doc_run, os.path.join(fleet.workdir, f"{mode}-{rep}"))
                print(json.dumps({"verifier": verifier, "arm": arm, **reading}), flush=True)
                runs[arm].append(reading)
        finally:
            if service is not None:
                service.stop()
                if saved is None:
                    os.environ.pop(ENV_SOCKET, None)
                else:
                    os.environ[ENV_SOCKET] = saved
        doc["kinds"][verifier] = {"summary": summary_of(runs), "runs": runs}
        print(json.dumps({"verifier": verifier, "summary": doc["kinds"][verifier]["summary"]}),
              flush=True)
    write_json(out, doc, indent=1, sort_keys=True)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
