"""Same-box back-to-back A/B of the broadcast-once mesh data plane.

The port's copy of the JAX repository's ``tools/mesh_ab.py``.  Runs the
in-process 4-node testbed twice over real localhost TCP sockets — first with
``MYSTICETI_MESH_LEGACY=1`` (the pre-broadcast-once path: per-peer encode,
per-frame write+drain, StreamReader receive), then with the broadcast-once
plane (encode-once fan-out, scatter-gather coalescing, zero-copy receive).
Same box, same duration, tag-12 timestamp frames and span tracing on for
both runs.  Writes one JSON document carrying the acceptance evidence:

* per-node committed leaders — the mesh run must be >= the baseline;
* ``dissemination_encode_reuse_total`` — must be > 0 on every node;
* mesh encode CPU (``utilization_timer{net:mesh_encode}``, normalized per
  committed leader) — must be measurably reduced;
* the critical-path stage p50s for ``receive``/``transit`` from the traces
  — must be no worse than baseline;
* the mesh-serialization microbench rung (``node_bench.mesh_serialization``)
  embedded for context.

The validators verify through ``--verifier`` (default ``cuda-only``; the JAX
tool's default is ``cpu``).  A card kind builds the kernels in this process
first (``maxload_bench.prewarm``), which raises without a card.  The port
adds ``card`` (nvidia-smi's name and power limit, None without a card) and,
per run, ``launches`` (the kernels' launches in this process, the
validators' verifier warm-ups apart, in ``warmup_launches``)
and ``receivers_attached`` (connections switched to the zero-copy receiver:
none under the legacy knob).  ``--port-base`` moves ``benchmark-genesis``'s
ports.

Usage::

    python -m mysticeti_tpu_torch.tools.mesh_ab --duration 60 --out build/MESH_r10.json
    python -m mysticeti_tpu_torch.tools.mesh_ab --verifier cpu --duration 10 --repeats 1
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import sys

from mysticeti_tpu_torch.cli import DEFAULT_VERIFIER, VERIFIER_CHOICES
from mysticeti_tpu_torch.tools import (
    build_path,
    card,
    launch_counts,
    launches_since,
    warmups_since,
    write_json,
)
from mysticeti_tpu_torch.tools.maxload_bench import card_kind, prewarm, set_port_base

DEFAULT_OUT = build_path("MESH_r10.json")
DEFAULT_WORKDIR = build_path("mesh-ab")


async def run_mode(mode: str, working_dir: str, committee_size: int,
                   duration_s: float, tps: int, verifier: str) -> dict:
    """One testbed run; returns per-node rows + the trace path."""
    from mysticeti_tpu_torch import spans
    from mysticeti_tpu_torch.cli import benchmark_genesis
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters, PrivateConfig
    from mysticeti_tpu_torch.network import _FrameReceiver
    from mysticeti_tpu_torch.validator import Validator

    os.makedirs(working_dir, exist_ok=True)
    trace_path = os.path.join(working_dir, f"trace-{mode}.json")
    if mode == "legacy":
        os.environ["MYSTICETI_MESH_LEGACY"] = "1"
    else:
        os.environ.pop("MYSTICETI_MESH_LEGACY", None)
    os.environ["MYSTICETI_TRACE"] = trace_path
    os.environ["TPS"] = str(tps)
    os.environ["INITIAL_DELAY"] = "1"

    launches0, warmups0 = launch_counts(), launch_counts(warmup=True)
    attached0 = _FrameReceiver.attached
    spans.start_from_env()
    try:
        ips = ["127.0.0.1"] * committee_size
        benchmark_genesis(ips, working_dir)
        committee = Committee.load(os.path.join(working_dir, "committee.yaml"))
        parameters = Parameters.load(os.path.join(working_dir, "parameters.yaml"))
        # Tag-12 stamps feed the per-link transit stage the critical-path
        # comparison reads.
        parameters.synchronizer.timestamp_frames = True
        signers = Committee.benchmark_signers(committee_size)
        validators = []
        for i in range(committee_size):
            private = PrivateConfig.new_in_dir(i, os.path.join(working_dir, f"validator-{i}"))
            validators.append(
                await Validator.start_benchmarking(
                    i, committee, parameters, private, signer=signers[i],
                    serve_metrics_endpoint=False, verifier=verifier,
                )
            )
        await asyncio.sleep(duration_s)
        nodes = []
        for i, v in enumerate(validators):
            m = v.metrics

            def timer_us(proc):
                return int(m.utilization_timer_us.labels(proc)._value.get())

            nodes.append({
                "authority": i,
                "committed_leaders": len(v.committed_leaders()),
                "encode_reuse_total": int(m.dissemination_encode_reuse_total._value.get()),
                "mesh_encode_us": timer_us("net:mesh_encode"),
                "net_decode_us": timer_us("net:decode"),
                "frames_coalesced_total": int(m.mesh_frames_coalesced_total._value.get()),
                "wire_bytes_sent": int(m.mesh_wire_bytes_total.labels("sent")._value.get()),
                "wire_bytes_received": int(
                    m.mesh_wire_bytes_total.labels("received")._value.get()
                ),
            })
        for v in validators:
            await v.stop()
    finally:
        spans.stop_from_env()
        os.environ.pop("MYSTICETI_MESH_LEGACY", None)
    return {"mode": mode, "trace": trace_path, "nodes": nodes,
            "receivers_attached": _FrameReceiver.attached - attached0,
            "launches": launches_since(launches0, warmups0),
            "warmup_launches": warmups_since(warmups0)}


def stage_p50s(trace_path: str, stages=("receive", "transit")) -> dict:
    """Per-stage p50 duration (µs) across every block chain in the trace —
    the same extraction rule trace_report --critical-path uses."""
    from mysticeti_tpu_torch import spans

    events, note, _ = spans.load_trace_events(trace_path)
    chains = spans.stage_chains(spans.complete_spans(events), tuple(stages))
    durs = {s: [] for s in stages}
    for stage_map in chains.values():
        for stage, (_ts, dur) in stage_map.items():
            durs[stage].append(dur)
    out = {}
    for stage, values in durs.items():
        out[stage] = {
            "n": len(values),
            "p50_us": int(statistics.median(values)) if values else None,
        }
    if note:
        out["note"] = note
    return out


def comparison_of(runs: dict) -> dict:
    """The JAX tool's comparison block over ``runs`` (mode -> runs)."""
    critical_path = {
        mode: [stage_p50s(run["trace"]) for run in mode_runs]
        for mode, mode_runs in runs.items()
    }

    def mean_leaders(mode):
        per_run = [
            statistics.mean(n["committed_leaders"] for n in run["nodes"])
            for run in runs[mode]
        ]
        return round(statistics.mean(per_run), 1)

    def encode_us_per_leader(mode):
        leaders = sum(n["committed_leaders"] for run in runs[mode] for n in run["nodes"])
        encode = sum(n["mesh_encode_us"] for run in runs[mode] for n in run["nodes"])
        return round(encode / max(1, leaders), 2)

    def mean_p50(mode, stage):
        values = [
            rep[stage]["p50_us"]
            for rep in critical_path[mode]
            if rep.get(stage, {}).get("p50_us")
        ]
        return int(statistics.mean(values)) if values else None

    return {
        "committed_leaders_mean": {m: mean_leaders(m) for m in runs},
        "committed_leaders": {
            m: [[n["committed_leaders"] for n in run["nodes"]] for run in runs[m]] for m in runs
        },
        "encode_reuse_total": {
            m: [[n["encode_reuse_total"] for n in run["nodes"]] for run in runs[m]] for m in runs
        },
        "mesh_encode_us_per_leader": {m: encode_us_per_leader(m) for m in runs},
        "critical_path_p50_us": {
            m: {stage: mean_p50(m, stage) for stage in ("receive", "transit")} for m in runs
        },
        "critical_path_per_run": critical_path,
    }


def acceptance_of(runs: dict, comparison: dict) -> dict:
    def p50_not_worse(stage):
        legacy_p50 = comparison["critical_path_p50_us"]["legacy"][stage]
        mesh_p50 = comparison["critical_path_p50_us"]["mesh"][stage]
        if not legacy_p50 or not mesh_p50:
            return True  # stage absent in one trace: nothing to compare
        return mesh_p50 <= legacy_p50 * 1.1  # no worse (10% noise band)

    return {
        "committed_leaders_not_worse": (
            comparison["committed_leaders_mean"]["mesh"]
            >= comparison["committed_leaders_mean"]["legacy"]
        ),
        "encode_reuse_on_every_node": all(
            n["encode_reuse_total"] > 0 for run in runs["mesh"] for n in run["nodes"]
        ),
        "encode_cpu_reduced": (
            comparison["mesh_encode_us_per_leader"]["mesh"]
            < comparison["mesh_encode_us_per_leader"]["legacy"]
        ),
        "receive_p50_not_worse": p50_not_worse("receive"),
        "transit_p50_not_worse": p50_not_worse("transit"),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--committee", type=int, default=4)
    parser.add_argument("--duration", type=float, default=60.0)
    parser.add_argument("--tps", type=int, default=300,
                        help="per-node offered load (tx/s)")
    parser.add_argument("--verifier", choices=VERIFIER_CHOICES, default=DEFAULT_VERIFIER)
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument(
        "--repeats", type=int, default=2,
        help="testbed runs per mode, ABBA-interleaved (legacy, mesh, mesh, "
        "legacy, ...) so same-box drift cancels; a single same-box run "
        "varies by ~10%% on committed leaders, larger than the effect "
        "under test",
    )
    parser.add_argument("--port-base", type=int, default=None,
                        help="first node port (metrics +1000); default "
                        "benchmark-genesis's 1500")
    args = parser.parse_args(argv)
    set_port_base(args.port_base)
    if card_kind(args.verifier):
        print("prewarming the kernels...", flush=True)
        prewarm(args.committee)

    # ABBA interleave: pairs of (legacy, mesh) alternating which goes
    # first, so thermal/contention drift hits both modes symmetrically.
    schedule = []
    for i in range(args.repeats):
        pair = ["legacy", "mesh"] if i % 2 == 0 else ["mesh", "legacy"]
        schedule += [(mode, i) for mode in pair]
    runs = {"legacy": [], "mesh": []}
    for mode, rep in schedule:
        print(f"running {mode} testbed rep {rep} ({args.duration:.0f}s)...", flush=True)
        run = asyncio.run(
            run_mode(
                mode, os.path.join(args.workdir, f"{mode}-{rep}"),
                args.committee, args.duration, args.tps, args.verifier,
            )
        )
        print(json.dumps(run["nodes"], indent=2), flush=True)
        runs[mode].append(run)

    comparison = comparison_of(runs)
    acceptance = acceptance_of(runs, comparison)

    from mysticeti_tpu_torch.tools.node_bench import mesh_serialization

    artifact = {
        "metric": "mesh_broadcast_once_ab",
        "committee": args.committee,
        "duration_s": args.duration,
        "tps_per_node": args.tps,
        "verifier": args.verifier,
        "card": card(),
        "note": (
            "same-box back-to-back: legacy = MYSTICETI_MESH_LEGACY=1 "
            "(per-peer encode, per-frame write+drain, stream receive); "
            "mesh = encode-once fan-out + scatter-gather coalescing + "
            "zero-copy receive.  Wire bytes are counted by the mesh mode "
            "only (the legacy path predates the counters); frames are "
            "byte-identical by the golden-corpus test."
        ),
        "runs": runs,
        "comparison": comparison,
        "acceptance": acceptance,
        "microbench": mesh_serialization(),
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    print(json.dumps(acceptance, indent=2))
    return 0 if all(acceptance.values()) else 3


if __name__ == "__main__":
    sys.exit(main())
