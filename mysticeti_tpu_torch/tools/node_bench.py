"""Node-level verifier comparison: committed tx/s with the ``cpu`` kind vs the card.

The port's copy of the JAX repository's ``tools/node_bench.py``.  Runs the
SAME fixed load through the port's local orchestrator once per
``--verifiers`` kind (default the serial ``cpu`` oracle, the reference's
behaviour, and ``cuda``, the hybrid router over the card's kernels) and
records each run (BASELINE configs #3/#5 measurement semantics: tps =
latency_s_count / benchmark_duration, orchestrator/src/measurement.rs:92-142),
then the saturation of each kind's signature backend alone.

Writes one JSON document (default ``build/NODE_BENCH.json``) with both; the
port adds ``card`` (nvidia-smi's name and power limit, None without a card),
each run's ``fleet`` (``maxload_bench.fleet_counters`` of the nodes' last
scrapes) and each saturation row's ``iterations``, ``all_valid`` (every
verdict of every call) and kernel ``launches`` (this process's, from the
row's first call).  A card kind builds the kernels here first
(``prewarm``); without a card that raises before any fleet boots.

``--mesh-bench`` / ``--dataplane-bench`` run only the mesh-serialization /
native data-plane microbench and fold its records into the port's trend
index (``tools.bench_trend``: ``build/BENCH_TREND.json``, or
``BENCH_TREND_PATH``), each record with the card; where there is no card
the append is skipped, as every port append is.

Usage::

    python -m mysticeti_tpu_torch.tools.node_bench --verifiers cpu cuda
    python -m mysticeti_tpu_torch.tools.node_bench --dataplane-bench --round 19
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from typing import List

from mysticeti_tpu_torch.tools import build_path, card, launch_counts, write_json
from mysticeti_tpu_torch.tools.maxload_bench import (
    ScrapeLog,
    card_kind,
    prewarm,
    probe_window,
    set_port_base,
)

DEFAULT_OUT = build_path("NODE_BENCH.json")
DEFAULT_WORKDIR = build_path("node-bench")


async def run_one(verifier: str, nodes: int, load: int, duration: float,
                  workdir: str) -> dict:
    from mysticeti_tpu_torch.orchestrator.benchmark import LoadType, ParametersGenerator
    from mysticeti_tpu_torch.orchestrator.logs import analyze_logs
    from mysticeti_tpu_torch.orchestrator.orchestrator import Orchestrator

    fleet = os.path.join(workdir, f"fleet-{verifier}")
    results = os.path.join(workdir, f"results-{verifier}")
    # The runner blocks until a card kind's verifier service is warm before
    # booting nodes: identical delays keep the rows comparable.
    duration = probe_window(verifier, duration)
    runner = ScrapeLog(fleet, verifier=verifier)
    generator = ParametersGenerator(nodes, LoadType.fixed([load]), duration_s=duration)
    orch = Orchestrator(runner, generator, results_dir=results, scrape_interval_s=duration / 4)
    collections = await orch.run_benchmarks()
    c = collections[0]
    logs = analyze_logs(fleet)
    return {
        "verifier": verifier,
        "nodes": nodes,
        "offered_load_tx_s": load,
        "duration_s": c.benchmark_duration(),
        "committed_tx_s": round(c.aggregate_tps(), 1),
        "avg_latency_s": round(c.aggregate_average_latency_s(), 4),
        "stdev_latency_s": round(c.aggregate_stdev_latency_s(), 4),
        "log_errors": logs.total_errors,
        "log_crashes": logs.total_crashes,
        "fleet": runner.fleet(0),
    }


def saturation_inputs(batch: int = 4096):
    """The saturation batch: 8 keys from ``random.Random(1)``, then a
    32-byte message a signature, signed in turn by each key."""
    import random

    from mysticeti_tpu_torch.crypto import Signer

    rng = random.Random(1)
    keys = [Signer.from_seed(bytes(rng.randrange(256) for _ in range(32))) for _ in range(8)]
    pks, msgs, sigs = [], [], []
    for i in range(batch):
        k = keys[i % 8]
        m = bytes(rng.getrandbits(8) for _ in range(32))
        pks.append(k.public_key.bytes)
        msgs.append(m)
        sigs.append(k.sign(m))
    return keys, pks, msgs, sigs


def saturation(verifier: str, batch: int = 4096, iters: int = 5, device=None) -> dict:
    """Sustained throughput of the SignatureVerifier backend itself — the
    number that caps a node's verification rate once consensus stops being
    the bottleneck (large committees / per-certificate checks).  ``device``
    is the card kinds' torch device (default ``cuda``; ``cpu`` runs the
    kernels' plain versions)."""
    import time

    from mysticeti_tpu_torch.block_validator import (
        CpuSignatureVerifier,
        TorchSignatureVerifier,
    )

    keys, pks, msgs, sigs = saturation_inputs(batch)
    # Deployed semantics: the signer set is the committee, keys ride as
    # indices into a device-resident table (validator._make_verifier).  The
    # hybrid (``cuda``) routes a saturation-sized batch to the kernel, so
    # the card's backend alone measures both card kinds.
    backend = (
        CpuSignatureVerifier()
        if verifier == "cpu"
        else TorchSignatureVerifier(committee_keys=[k.public_key.bytes for k in keys],
                                    device=device)
    )
    before = launch_counts()
    if not all(backend.verify_signatures(pks, msgs, sigs)):  # warm
        raise RuntimeError(f"saturation: the {verifier} backend rejected a valid signature")
    all_valid = True
    t0 = time.perf_counter()
    for _ in range(iters):
        all_valid &= all(backend.verify_signatures(pks, msgs, sigs))
    elapsed = time.perf_counter() - t0
    after = launch_counts()
    return {
        "verifier": verifier,
        "batch": batch,
        "sig_per_sec": round(batch * iters / elapsed, 1),
        "iterations": iters,
        "all_valid": bool(all_valid),
        "launches": {name: after[name] - before[name] for name in after},
    }


def _blocks(count: int, txs: int) -> tuple:
    """``count`` signed blocks of ``txs`` 132-byte shares by authority 0 of
    the 4-node benchmark committee, serialized."""
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.types import Share, StatementBlock

    signers = Committee.benchmark_signers(4)
    genesis = [StatementBlock.new_genesis(a).reference for a in range(4)]
    return tuple(
        StatementBlock.build(
            0, 1 + i, genesis, [Share(bytes(128) + i.to_bytes(4, "little"))] * txs,
            signer=signers[0],
        ).to_bytes()
        for i in range(count)
    )


def mesh_serialization(peers: int = 9, blocks: int = 50, txs: int = 16,
                       iters: int = 30) -> dict:
    """Mesh-serialization microbench: encode-once fan-out vs per-peer.

    Measures exactly the work ``write_loop`` does when a dissemination
    frame fans out to ``peers`` subscribers: the per-peer path encodes the
    frame once PER PEER; the broadcast-once path encodes once and ships the
    cached payload (``EncodedFrame``).  Reports MB/s of fan-out payload
    production plus allocation volumes — the second number is the
    GC-pressure story the throughput number hides.
    """
    import time

    from mysticeti_tpu_torch.network import Blocks, EncodedFrame, encode_message, frame_payload

    msg = Blocks(_blocks(blocks, txs))
    frame_bytes = len(encode_message(msg))
    shipped = frame_bytes * peers * iters

    def measure(fn, encodes_per_fanout):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        elapsed = time.perf_counter() - t0
        return {
            "mb_per_s": round(shipped / 1e6 / elapsed, 1),
            # Every encoded byte is an allocated byte: the fan-out's
            # allocation volume is encodes x frame size.
            "encodes_per_fanout": encodes_per_fanout,
            "alloc_bytes_per_fanout": encodes_per_fanout * frame_bytes,
            "elapsed_s": round(elapsed, 4),
        }

    def per_peer():
        for _ in range(peers):
            encode_message(msg)

    def encode_once():
        frame = EncodedFrame(msg)
        for _ in range(peers):
            frame_payload(frame)

    per_peer_row = measure(per_peer, peers)
    encode_once_row = measure(encode_once, 1)
    return {
        "metric": "mesh_serialization_fanout",
        "peers": peers,
        "blocks_per_frame": blocks,
        "frame_bytes": frame_bytes,
        "iters": iters,
        "per_peer": per_peer_row,
        "encode_once": encode_once_row,
        "speedup": round(
            encode_once_row["mb_per_s"] / max(per_peer_row["mb_per_s"], 1e-9), 2
        ),
    }


def dataplane_bench(blocks: int = 64, txs: int = 16, iters: int = 40) -> dict:
    """Native data-plane microbench: frame encode / parse / digest, native
    batched vs pure-Python per-block, on one realistic dissemination frame.

    The three stages are the receive/send hot path the native batch helpers
    cover: whole-frame encode (``encode_message`` on a ``Blocks`` fan-out),
    whole-frame parse (``decode_message`` splitting the payload into
    per-block views), and the per-block digest pair (block digest +
    signature pre-hash, batched into ONE native call).  The fallback rows
    force the pure interpreter path in-process by nulling the module-level
    native aliases — same bytes, same objects, so the ratio is the GIL-free
    batching win and nothing else.  Without the extension the native rows
    are absent and the document records fallback-only numbers.
    """
    import time

    import mysticeti_tpu_torch.network as network_mod
    import mysticeti_tpu_torch.types as types_mod
    from mysticeti_tpu_torch import crypto
    from mysticeti_tpu_torch.native import native
    from mysticeti_tpu_torch.network import Blocks, decode_message, encode_message
    from mysticeti_tpu_torch.types import StatementBlock

    parts = _blocks(blocks, txs)
    msg = Blocks(parts)
    payload = encode_message(msg)
    frame_bytes = len(payload)
    total_bytes = sum(len(p) for p in parts)

    def timed(fn):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    def py_digest_per_block():
        for p in parts:
            crypto.blake2b_256(p)
            crypto.blake2b_256(p[:-64])

    saved = (
        network_mod._native_encode_frame,
        network_mod._native_parse_spans,
        types_mod._native_decode,
        types_mod._native_block_digests,
    )
    try:
        network_mod._native_encode_frame = None
        network_mod._native_parse_spans = None
        types_mod._native_decode = None
        types_mod._native_block_digests = None
        fb_encode = timed(lambda: encode_message(msg))
        fb_parse = timed(lambda: decode_message(payload))
        fb_digest = timed(py_digest_per_block)
        fb_decode_many = timed(lambda: StatementBlock.from_bytes_many(parts))
    finally:
        (network_mod._native_encode_frame, network_mod._native_parse_spans,
         types_mod._native_decode, types_mod._native_block_digests) = saved

    def us(seconds):
        return round(seconds * 1e6, 1)

    row = {
        "metric": "native_dataplane",
        "native_active": native is not None,
        "blocks_per_frame": blocks,
        "txs_per_block": txs,
        "frame_bytes": frame_bytes,
        "iters": iters,
        "fallback": {
            "encode_us": us(fb_encode),
            "parse_us": us(fb_parse),
            "digest_per_block_us": us(fb_digest),
            "decode_many_us": us(fb_decode_many),
            "encode_mb_s": round(frame_bytes / 1e6 / fb_encode, 1),
            "parse_mb_s": round(frame_bytes / 1e6 / fb_parse, 1),
            "digest_mb_s": round(total_bytes / 1e6 / fb_digest, 1),
        },
    }
    if native is None:
        return row

    nat_encode = timed(lambda: encode_message(msg))
    nat_parse = timed(lambda: decode_message(payload))
    nat_digest = timed(lambda: native.block_digests(parts))
    nat_digest_per_block = timed(lambda: [native.block_digests([p]) for p in parts])
    nat_decode_many = timed(lambda: StatementBlock.from_bytes_many(parts))
    combined = (fb_encode + fb_parse + fb_digest) / max(
        nat_encode + nat_parse + nat_digest, 1e-12
    )
    row["native"] = {
        "encode_us": us(nat_encode),
        "parse_us": us(nat_parse),
        "digest_batched_us": us(nat_digest),
        "digest_per_block_us": us(nat_digest_per_block),
        "decode_many_us": us(nat_decode_many),
        "encode_mb_s": round(frame_bytes / 1e6 / nat_encode, 1),
        "parse_mb_s": round(frame_bytes / 1e6 / nat_parse, 1),
        "digest_mb_s": round(total_bytes / 1e6 / nat_digest, 1),
    }
    row["speedups"] = {
        "encode": round(fb_encode / nat_encode, 2),
        "parse": round(fb_parse / nat_parse, 2),
        "digest": round(fb_digest / nat_digest, 2),
        # One GIL round-trip per frame vs one per block, both native: the
        # batching win isolated from the C-vs-interpreter win.
        "digest_batched_vs_per_block": round(nat_digest_per_block / nat_digest, 2),
        "decode_many": round(fb_decode_many / nat_decode_many, 2),
        # The acceptance ratio: whole native hot path vs pure per-block.
        "combined_encode_parse_digest": round(combined, 2),
    }
    return row


def dataplane_records(row: dict, round_: int) -> List[dict]:
    """NODE_DATAPLANE trend family: every recorded value is higher-is-better
    (MB/s and speedup ratios), so the stock >10%-below-best regression gate
    applies directly round-over-round."""
    from mysticeti_tpu_torch.tools import bench_trend

    source = f"DATAPLANE_r{round_:02d}.json"
    fresh = []

    def rec(metric, value, unit):
        fresh.append(bench_trend._record(round_, source, f"NODE_DATAPLANE.{metric}", value, unit))

    rec("fallback_encode_mb_s", row["fallback"]["encode_mb_s"], "MB/s")
    rec("fallback_parse_mb_s", row["fallback"]["parse_mb_s"], "MB/s")
    rec("fallback_digest_mb_s", row["fallback"]["digest_mb_s"], "MB/s")
    if row.get("native"):
        rec("native_encode_mb_s", row["native"]["encode_mb_s"], "MB/s")
        rec("native_parse_mb_s", row["native"]["parse_mb_s"], "MB/s")
        rec("native_digest_mb_s", row["native"]["digest_mb_s"], "MB/s")
        sp = row["speedups"]
        rec("encode_speedup", sp["encode"], "x")
        rec("parse_speedup", sp["parse"], "x")
        rec("digest_speedup", sp["digest"], "x")
        rec("digest_batched_vs_per_block", sp["digest_batched_vs_per_block"], "x")
        rec("decode_many_speedup", sp["decode_many"], "x")
        rec("combined_speedup", sp["combined_encode_parse_digest"], "x")
    return fresh


def mesh_records(row: dict, round_: int) -> List[dict]:
    """The MESH_SERIALIZATION family (never mixed with the fleet families —
    a serialization microbench must not gate a fleet search and vice
    versa)."""
    from mysticeti_tpu_torch.tools import bench_trend

    source = f"MESH_SERIALIZATION_r{round_:02d}.json"
    return [
        bench_trend._record(round_, source, "MESH_SERIALIZATION.encode_once_mb_s",
                            row["encode_once"]["mb_per_s"], "MB/s"),
        bench_trend._record(round_, source, "MESH_SERIALIZATION.per_peer_mb_s",
                            row["per_peer"]["mb_per_s"], "MB/s"),
        bench_trend._record(round_, source, "MESH_SERIALIZATION.fanout_speedup",
                            row["speedup"], "x"),
    ]


def _append_trend(fresh: List[dict]) -> bool:
    """Merge ``fresh`` into the port's trend index, each record with the
    card; False (nothing written) where there is no card."""
    from mysticeti_tpu_torch.tools import bench_trend

    line = card()
    if line is None:
        return False
    path = bench_trend._index_path(None)
    index = bench_trend.load_index(path)
    if bench_trend.merge_index(index, [dict(rec, card=line) for rec in fresh]):
        bench_trend.write_index(index, path)
    return True


def append_dataplane_trend(row: dict, round_: int) -> bool:
    return _append_trend(dataplane_records(row, round_))


def append_mesh_trend(row: dict, round_: int) -> bool:
    return _append_trend(mesh_records(row, round_))


def _report_append(appended: bool, family: str) -> None:
    from mysticeti_tpu_torch.tools import bench_trend

    if appended:
        print(f"appended {family} records to {bench_trend._index_path(None)}")
    else:
        print(f"no card: {family} records not appended to the trend index")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--load", type=int, default=200)
    parser.add_argument("--duration", type=float, default=40.0)
    parser.add_argument("--workdir", default=DEFAULT_WORKDIR)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--verifiers", nargs="+", default=["cpu", "cuda"],
                        choices=["accept", "cpu", "cuda", "cuda-only"])
    parser.add_argument(
        "--mesh-bench", action="store_true",
        help="run ONLY the mesh-serialization microbench (encode-once vs "
        "per-peer fan-out) and append it to the trend index under the "
        "MESH_SERIALIZATION family",
    )
    parser.add_argument(
        "--dataplane-bench", action="store_true",
        help="run ONLY the native data-plane microbench (frame encode/parse"
        "/digest, native batched vs pure-Python per-block) and append it to "
        "the trend index under the NODE_DATAPLANE family",
    )
    parser.add_argument(
        "--round", type=int, default=10,
        help="PR round recorded with --mesh-bench/--dataplane-bench trend records",
    )
    parser.add_argument("--port-base", type=int, default=None,
                        help="first node port (metrics +1000); default "
                        "benchmark-genesis's 1500")
    args = parser.parse_args(argv)

    if args.dataplane_bench:
        row = dataplane_bench()
        print(json.dumps(row, indent=2))
        _report_append(append_dataplane_trend(row, args.round), "NODE_DATAPLANE")
        return 0

    if args.mesh_bench:
        row = mesh_serialization()
        print(json.dumps(row, indent=2))
        _report_append(append_mesh_trend(row, args.round), "MESH_SERIALIZATION")
        return 0

    set_port_base(args.port_base)
    if any(card_kind(v) for v in args.verifiers):
        print("prewarming the kernels...", flush=True)
        prewarm(args.nodes)

    runs = []
    for verifier in args.verifiers:
        print(f"running verifier={verifier}...", flush=True)
        for attempt in range(2):
            run = asyncio.run(
                run_one(verifier, args.nodes, args.load, args.duration, args.workdir)
            )
            if run["committed_tx_s"] > 0 or attempt == 1:
                break
            print("no commits (warmup overran the window); retrying", flush=True)
        runs.append(run)
        print(json.dumps(runs[-1]), flush=True)

    saturation_rows = []
    for verifier in args.verifiers:
        if verifier == "accept":
            continue
        print(f"saturation verifier={verifier}...", flush=True)
        saturation_rows.append(saturation(verifier))
        print(json.dumps(saturation_rows[-1]), flush=True)

    artifact = {
        "metric": "committed_tx_per_sec_by_verifier",
        "card": card(),
        "verifier_saturation": saturation_rows,
        "runs": runs,
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
