"""EXEC document generator: execution-backed finality + state-root agreement.

The port's copy of the JAX repository's ``tools/execution_bench.py``.  Two
legs, one document:

* **Fleet leg** — a real local fleet (``LocalProcessRunner``) with the
  execution plane on (``execution: true`` + a gateway listener patched
  into the generated ``parameters.yaml``).  A gateway client per node
  submits the deterministic account/transfer workload (CREATE, two
  nonce-ordered TRANSFERs, one deliberate overdraft per batch — disjoint
  accounts, so batches commute across committed interleavings) while a
  ``want_executed`` subscriber on node 0 records the EXECUTED roots it is
  notified of.  Scrapes ``mysticeti_execution_*`` and the execute-backed
  finality gauges from every node, pulls each node's ``/debug/consensus``
  execution section, and cross-checks per-height state roots across the
  fleet AND against the client-observed notification stream.
* **Sim leg** — the seeded ``execution-byzantine-at-f`` scenario (10
  nodes, f=3 attacking, execution live) run twice with the same seed: the
  verdict must pass (honest state roots agree at every height — a fork
  raises inside the SafetyChecker) and the agreed root-chain digest must
  be byte-identical across the two runs.

Both legs verify through ``--verifier``: by default ``cuda-only``, the
fleet's nodes behind one verifier service on the card and the sim's
collectors over one ``TorchSignatureVerifier`` in this process;
``sim-oracle`` is the JAX tool's run (its fleet on the ``cpu`` kind, its sim
on the re-sign oracle).  A card kind builds the kernels in this process
first, which raises without a card.  The document names the kinds it ran
(``verifier``, and each leg's), where the JAX tool writes ``cpu`` whatever
ran, and adds ``card`` (nvidia-smi's name and power limit, None without a
card), the fleet's ``fleet`` counters (``maxload_bench.fleet_counters``)
and the sim leg's ``launches`` (the kernels' launches in this process).
``--port-base`` moves ``benchmark-genesis``'s ports; the gateways listen on
``--gateway-port-base`` + i, and the clients retry their connection while a
gateway is not listening yet.

Usage::

    python -m mysticeti_tpu_torch.tools.execution_bench --out build/EXEC_r20.json
    python -m mysticeti_tpu_torch.tools.execution_bench --skip-fleet --verifier sim-oracle
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

DEFAULT_OUT = build_path("EXEC.json")
DEFAULT_WORKDIR = build_path("execution")

EXEC_GAUGES = (
    "mysticeti_execution_height",
    "mysticeti_execution_accounts",
    "mysticeti_e2e_finality_p50_seconds",
    "mysticeti_e2e_finality_p99_seconds",
)


def _fresh_dir(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    return path


def _node_series(text) -> dict:
    """Execution gauges + verdict counters + the execute-phase histogram
    (sum/count) from one node's raw /metrics scrape."""
    from mysticeti_tpu_torch.orchestrator.measurement import iter_series

    out = {name: 0.0 for name in EXEC_GAUGES}
    out["txs_by_result"] = {}
    out["execute_phase_sum_s"] = 0.0
    out["execute_phase_count"] = 0.0
    if not text:
        return out
    for name, labels, value in iter_series(text):
        if name in out:
            out[name] = value
        elif name == "mysticeti_execution_txs_total":
            result = labels.get("result", "?")
            out["txs_by_result"][result] = (
                out["txs_by_result"].get(result, 0) + int(value)
            )
        elif name == "mysticeti_e2e_finality_seconds_sum" and (
            labels.get("phase") == "execute"
        ):
            out["execute_phase_sum_s"] = value
        elif name == "mysticeti_e2e_finality_seconds_count" and (
            labels.get("phase") == "execute"
        ):
            out["execute_phase_count"] = value
    return out


def _spend_bundle(account: bytes, node: int):
    """The commuting spend shape from the sim driver
    (``scenarios._exec_driver``): two nonce-ordered transfers plus a
    deliberate overdraft — a deterministic typed reject folded into the
    root like any other verdict (the nonce-3 overdraft check is the FOLD's
    job; admission admits ahead-of-state nonces)."""
    from mysticeti_tpu_torch.execution import OP_TRANSFER, ExecTx

    sink = f"sink-{node}".encode()
    return [
        ExecTx(OP_TRANSFER, account, nonce=1, amount=300, dest=sink),
        ExecTx(OP_TRANSFER, account, nonce=2, amount=300, dest=b"treasury"),
        ExecTx(OP_TRANSFER, account, nonce=3, amount=500, dest=sink),
    ]


async def _open_gateway(host, port, timeout_s: float = 30.0):
    """A connection to a node's gateway, retried while it is not listening
    yet: the JAX tool connects once, 2 s after the boots, which a loaded host
    can outlast."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while True:
        try:
            return await asyncio.open_connection(host, port)
        except OSError:
            if loop.time() >= deadline:
                raise
            await asyncio.sleep(0.2)


async def _exec_client(host, port, node, interval_s, stats, stop):
    """Per-node closed-loop gateway submitter.  Each tick CREATEs a fresh
    account and spends the oldest previously-created one; the ingress
    plane's identity lanes + typed sheds are part of the contract — a
    spend arriving before its CREATE committed sheds as
    ``unknown_account`` and is re-offered next tick."""
    from mysticeti_tpu_torch.execution import OP_CREATE, ExecTx
    from mysticeti_tpu_torch.network import (
        GatewaySubmit,
        _read_frame,
        _write_frame,
        decode_message,
        encode_message,
    )

    async def submit(txs):
        _write_frame(
            writer,
            encode_message(
                GatewaySubmit(b"", 0, tuple(tx.to_bytes() for tx in txs))
            ),
        )
        await writer.drain()
        reply = decode_message(await _read_frame(reader))
        stats["submitted"] += len(txs)
        stats["accepted"] += reply.accepted
        stats["shed"] += reply.shed
        if reply.shed and reply.reason:
            reason = bytes(reply.reason).decode("utf-8", "replace")
            stats["shed_reasons"][reason] = (
                stats["shed_reasons"].get(reason, 0) + reply.shed
            )
        return reply

    reader, writer = await _open_gateway(host, port)
    batch = 0
    unspent = []
    try:
        while not stop.is_set():
            batch += 1
            account = f"fleet-{node}-{batch}".encode()
            await submit([ExecTx(OP_CREATE, account, amount=1000)])
            unspent.append(account)
            # Spend the oldest created account; requeue on a full shed
            # (its CREATE has not committed yet).
            if len(unspent) > 1:
                target = unspent.pop(0)
                reply = await submit(_spend_bundle(target, node))
                if reply.accepted == 0:
                    unspent.insert(0, target)
            await asyncio.sleep(interval_s)
    finally:
        writer.close()


async def _exec_subscriber(host, port, record, stop):
    """want_executed subscriber: records the synthetic resume reply and the
    per-height EXECUTED roots streamed afterwards."""
    from mysticeti_tpu_torch.network import (
        GatewaySubscribeCommits,
        _read_frame,
        _write_frame,
        decode_message,
        encode_message,
    )

    reader, writer = await _open_gateway(host, port)
    try:
        _write_frame(
            writer,
            encode_message(GatewaySubscribeCommits(0, want_executed=1)),
        )
        await writer.drain()
        first = decode_message(await _read_frame(reader))
        record["resume_reply"] = {
            "height": first.height,
            "keys": len(first.keys),
            "root": bytes(first.executed_root).hex(),
        }
        if first.keys:  # not the synthetic reply: a live notification
            record["roots"][str(first.height)] = bytes(first.executed_root).hex()
        while not stop.is_set():
            try:
                note = decode_message(
                    await asyncio.wait_for(_read_frame(reader), timeout=1.0)
                )
            except asyncio.TimeoutError:
                continue
            if note.executed_root:
                record["roots"][str(note.height)] = bytes(note.executed_root).hex()
    finally:
        writer.close()


def _patch_parameters(path: str, gateway_port_base: int) -> None:
    """Arm the execution plane + gateway in the generated parameters.yaml
    (node processes load it at boot)."""
    from mysticeti_tpu_torch.config import Parameters

    parameters = Parameters.load(path)
    parameters.execution = True
    parameters.ingress.gateway_port_base = gateway_port_base
    parameters.dump(path)


def _cross_check_roots(debug_docs: dict, client_roots: dict) -> dict:
    """Per-height state-root agreement across the fleet's /debug windows
    and the client-observed notification stream."""
    by_height: dict = {}
    for authority, doc in debug_docs.items():
        execution = (doc or {}).get("execution") or {}
        for entry in execution.get("recent_roots", []):
            by_height.setdefault(str(entry["height"]), {})[authority] = entry[
                "root"
            ]
    forks = []
    shared = 0
    for height, roots in sorted(by_height.items(), key=lambda kv: int(kv[0])):
        if len(roots) > 1:
            shared += 1
            if len(set(roots.values())) != 1:
                forks.append({"height": int(height), "roots": roots})
        observed = client_roots.get(height)
        if observed is not None and observed not in roots.values():
            forks.append(
                {"height": int(height), "client": observed, "roots": roots}
            )
    return {
        "shared_heights": shared,
        "client_heights_checked": sum(
            1 for h in client_roots if h in by_height
        ),
        "forks": forks,
        "agree": not forks and shared > 0,
    }


async def run_fleet_leg(args) -> dict:
    from mysticeti_tpu_torch.orchestrator.runner import (
        LocalProcessRunner,
        _http_get_metrics,
    )
    from mysticeti_tpu_torch.tools.maxload_bench import fleet_counters

    os.environ["INITIAL_DELAY"] = "1"
    workdir = _fresh_dir(os.path.join(args.workdir, "fleet"))
    kind = node_kind(args.verifier)
    runner = LocalProcessRunner(workdir, verifier=kind)
    started = time.time()
    await runner.configure(args.nodes, args.load)
    _patch_parameters(
        os.path.join(workdir, "parameters.yaml"), args.gateway_port_base
    )
    client_stats = {
        "submitted": 0, "accepted": 0, "shed": 0, "shed_reasons": {},
    }
    subscription = {"resume_reply": None, "roots": {}}
    debug_docs = {}
    stop = asyncio.Event()
    tasks = []
    try:
        for authority in range(args.nodes):
            await runner.boot_node(authority)
        await asyncio.sleep(2.0)  # gateways listening
        for authority in range(args.nodes):
            tasks.append(
                asyncio.ensure_future(  # lint: ignore[task-orphan] — gathered below
                    _exec_client(
                        "127.0.0.1",
                        args.gateway_port_base + authority,
                        authority,
                        args.exec_interval,
                        client_stats,
                        stop,
                    )
                )
            )
        tasks.append(
            asyncio.ensure_future(  # lint: ignore[task-orphan] — gathered below
                _exec_subscriber(
                    "127.0.0.1", args.gateway_port_base, subscription, stop
                )
            )
        )
        await asyncio.sleep(args.duration)
        stop.set()
        await asyncio.gather(*tasks, return_exceptions=True)
        texts = [await runner.scrape(a) for a in range(args.nodes)]
        for authority in range(args.nodes):
            host, port = runner.parameters.metrics_address(authority)
            doc = await _http_get_metrics(host, port, path="/debug/consensus")
            try:
                debug_docs[str(authority)] = json.loads(doc) if doc else None
            except ValueError:
                debug_docs[str(authority)] = None
    finally:
        stop.set()
        for task in tasks:
            task.cancel()
        await runner.cleanup()

    per_node = {}
    executed_heights = []
    applied_rates = []
    for authority, text in enumerate(texts):
        series = _node_series(text)
        execution = (debug_docs.get(str(authority)) or {}).get("execution") or {}
        height = int(series["mysticeti_execution_height"])
        executed_heights.append(height)
        applied = series["txs_by_result"].get("applied", 0)
        applied_rates.append(applied / args.duration)
        phase_count = series["execute_phase_count"]
        per_node[str(authority)] = {
            "executed_height": height,
            "accounts": int(series["mysticeti_execution_accounts"]),
            "txs_by_result": series["txs_by_result"],
            "final_root": execution.get("root"),
            "execute_phase_mean_s": round(series["execute_phase_sum_s"] / phase_count, 5)
            if phase_count
            else None,
            "finality_p50_s": round(series["mysticeti_e2e_finality_p50_seconds"], 4),
            "finality_p99_s": round(series["mysticeti_e2e_finality_p99_seconds"], 4),
        }
    agreement = _cross_check_roots(debug_docs, subscription["roots"])
    return {
        "nodes": args.nodes,
        "load_tx_s": args.load,
        "verifier": kind,
        "window_utc": [round(started, 1), round(time.time(), 1)],
        "client": dict(client_stats),
        "subscriber": {
            "resume_reply": subscription["resume_reply"],
            "executed_notifications": len(subscription["roots"]),
        },
        "per_node": per_node,
        "executed_height_min": min(executed_heights, default=0),
        "executed_height_max": max(executed_heights, default=0),
        "executed_tx_s": round(max(applied_rates, default=0.0), 1),
        "root_agreement": agreement,
        "all_nodes_executed": all(h > 0 for h in executed_heights),
        "fleet": fleet_counters(texts),
    }


def run_sim_leg(args, wal_dir: str) -> dict:
    import dataclasses

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.scenarios import kind_backend, run_scenario, scenario_by_name

    scenario = dataclasses.replace(
        scenario_by_name("execution-byzantine-at-f"),
        duration_s=args.sim_duration,
    )
    # One warm backend for both runs and their twins, so the launches
    # counted are the sims'.
    backend = kind_backend(args.verifier, Committee.new_for_benchmarks(
        scenario.nodes, stakes=list(scenario.stakes) or None), device=args.device)
    launches0 = launch_counts()
    first = run_scenario(scenario, _fresh_dir(os.path.join(wal_dir, "a")),
                         backend=backend, verifier=args.verifier)
    second = run_scenario(scenario, _fresh_dir(os.path.join(wal_dir, "b")),
                          backend=backend, verifier=args.verifier)
    execution = first.get("execution", {})
    twin = second.get("execution", {})
    return {
        "scenario": scenario.name,
        "nodes": scenario.nodes,
        "duration_s": scenario.duration_s,
        "verifier": args.verifier,
        "passed": bool(first.get("passed")),
        "safety_ok": bool(first.get("safety_ok")),
        "execution_ok": bool(execution.get("execution_ok")),
        "executed_heights": execution.get("executed_heights", {}),
        "chain_length": execution.get("chain_length", 0),
        "final_root": execution.get("final_root"),
        "root_chain_digest": execution.get("root_chain_digest"),
        "byte_identical": (
            bool(execution.get("root_chain_digest"))
            and execution.get("root_chain_digest")
            == twin.get("root_chain_digest")
        ),
        "launches": launches_since(launches0),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="execution_bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--load", type=int, default=1000,
                        help="background benchmark load, tx/s (the exec "
                        "workload rides on top through the gateway)")
    parser.add_argument("--duration", type=float, default=30.0)
    parser.add_argument("--exec-interval", type=float, default=0.25,
                        help="seconds between workload batches per node")
    parser.add_argument("--sim-duration", type=float, default=5.0)
    parser.add_argument("--gateway-port-base", type=int, default=18650)
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
        print(f"fleet leg: {args.nodes} nodes, execution plane on, "
              f"{args.duration}s...", flush=True)
        fleet = asyncio.run(run_fleet_leg(args))
        print(json.dumps({
            "executed_height_max": fleet["executed_height_max"],
            "executed_tx_s": fleet["executed_tx_s"],
            "root_agreement": fleet["root_agreement"]["agree"],
        }), flush=True)

    print("sim leg: seeded execution-byzantine-at-f x2 (root-chain "
          "byte-identity)...", flush=True)
    sim = run_sim_leg(args, os.path.join(args.workdir, "sim"))
    print(json.dumps({k: sim[k] for k in
                      ("passed", "execution_ok", "byte_identical")}),
          flush=True)

    acceptance = {
        "sim_passed": sim["passed"],
        "sim_execution_ok": sim["execution_ok"],
        "sim_byte_identical": sim["byte_identical"],
    }
    if fleet is not None:
        acceptance["fleet_roots_agree"] = fleet["root_agreement"]["agree"]
        acceptance["fleet_all_nodes_executed"] = fleet["all_nodes_executed"]
        acceptance["fleet_resume_reply"] = (
            fleet["subscriber"]["resume_reply"] is not None
        )
    artifact = {
        "metric": "execution",
        "nodes": args.nodes,
        "verifier": args.verifier,
        "card": card(),
        "rule": (
            "every node folds the committed sequence to the same per-height "
            "state root (fleet /debug windows + client EXECUTED stream "
            "cross-checked); execute-phase finality measured on the "
            "e2e histogram; seeded execution-byzantine-at-f root chains "
            "byte-identical across same-seed runs"
        ),
        "fleet": fleet,
        "sim": sim,
        "determinism": {
            "byte_identical": sim["byte_identical"],
            "root_chain_digest": sim["root_chain_digest"],
        },
        "acceptance": acceptance,
    }
    write_json(args.out, artifact, indent=2)
    print(f"wrote {args.out}")
    return 0 if all(acceptance.values()) else 3


if __name__ == "__main__":
    sys.exit(main())
