"""Node binary: genesis, run, dry-run, testbed, verifier-service and the
simulator subcommands.

The port's copy of ``mysticeti_tpu.cli``'s node and simulator commands.
Capability parity with ``mysticeti/src/main.rs``:

* ``benchmark-genesis`` (:36-43,116-156) — emit committee.yaml, parameters.yaml
  and per-authority private configs (key seed + storage dir).
* ``run`` (:44-58,159-185) — start one validator from config files.
* ``dry-run`` (:59-67,229-268) — single-command local validator: generates an
  in-process benchmark config for N authorities and runs one of them.
* ``testbed`` (:68-73,187-227) — N in-process validators on localhost.
* ``verifier-service`` — the shared per-host verifier service
  (verifier_service.py) that nodes reach through ``MYSTICETI_VERIFIER_SOCKET``.
* ``chaos``, ``overload`` and ``scenarios`` — the seeded virtual-time sims
  (chaos.py, ingress.py, scenarios.py).
* ``orchestrator`` and ``fleet`` — the benchmark sweep over a local fleet of
  node processes and the testbed lifecycle over a host pool (orchestrator/).

``--verifier`` selects the signature backend (validator.py): ``cuda`` is the
hybrid router (the CUDA kernels for large batches, the CPU oracle for small
ones), ``cuda-only`` pins every batch to the kernels, ``cpu`` is the serial
OpenSSL oracle, ``accept`` skips signature checks, and ``-agg`` turns on the
collector's threshold-aggregate mode.  The default is ``cuda-only`` (the JAX
CLI's is ``cpu``): a node runs on the card unless it is asked for the CPU, and
without a card, or with a kernel that fails to build, ``run``, ``dry-run`` and
``testbed`` exit non-zero.  ``chaos`` and ``scenarios`` take the same kinds
(each node's collector at the scenarios' 0.002 s window over one backend the
fleet shares, ``scenarios.verifier_factory``) plus ``sim-oracle``, the JAX
CLI's own choice (``chaos``: the sim re-sign oracle for a plan with
adversaries, no verifier for a benign plan; ``scenarios``: the oracle), and
default to ``cuda-only`` as well; ``overload``'s nodes verify nothing, as the
JAX package's do.  ``orchestrator`` takes the node kinds and defaults to
``cuda-only`` too (the JAX CLI's default is ``cpu``): a ``cuda*`` fleet
shares one verifier service on the card, and without a card the sweep
raises before any node starts.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import os
import threading
from typing import Callable, List, Optional

from .committee import Authority, Committee, STAKE_WEIGHTED
from .config import Parameters, PrivateConfig
from .crypto import Signer
from .tracing import logger
from .validator import ACCELERATOR_KIND, Validator

log = logger(__name__)

VERIFIER_CHOICES = ["accept", "cpu", "cuda", "cuda-only", "cpu-agg", "cuda-agg"]
DEFAULT_VERIFIER = ACCELERATOR_KIND
SIM_ORACLE = "sim-oracle"
SIM_VERIFIER_CHOICES = VERIFIER_CHOICES + [SIM_ORACLE]

# The thread ``validator._make_verifier`` warms an accelerator kind in: an
# exception escaping it (a kernel that fails to build or load, a verifier
# service that cannot be reached) stops the node.
WARMUP_THREAD = "verifier-warmup"


@contextlib.contextmanager
def stop_on_warmup_failure(verifier: str, stop: Callable[[], None]):
    """While the block runs, an exception escaping a ``WARMUP_THREAD`` is
    logged and calls ``stop`` (from that thread); the block is expected to
    return soon after, and then raises ``RuntimeError`` from the first such
    exception, so that the command exits non-zero."""
    failures: List[BaseException] = []
    previous_hook = threading.excepthook

    def warmup_hook(hook_args) -> None:
        if hook_args.thread is None or hook_args.thread.name != WARMUP_THREAD:
            previous_hook(hook_args)
            return
        log.error("the %s verifier failed to warm up; stopping", verifier,
                  exc_info=(hook_args.exc_type, hook_args.exc_value,
                            hook_args.exc_traceback))
        failures.append(hook_args.exc_value)
        stop()

    threading.excepthook = warmup_hook
    try:
        yield
    finally:
        threading.excepthook = previous_hook
    if failures:
        raise RuntimeError(f"the {verifier} verifier failed to warm up") from failures[0]


def _benchmark_parameters(ips: List[str]) -> Parameters:
    return Parameters.new_for_benchmarks(ips)


def benchmark_genesis(
    ips: List[str], working_dir: str, node_parameters: Optional[Parameters] = None
) -> None:
    """main.rs:116-156."""
    os.makedirs(working_dir, exist_ok=True)
    committee_size = len(ips)
    signers = Committee.benchmark_signers(committee_size)
    committee = Committee(
        [
            Authority(1, s.public_key, hostname=ip)
            for s, ip in zip(signers, ips)
        ],
        leader_election=STAKE_WEIGHTED,
    )
    committee.dump(os.path.join(working_dir, "committee.yaml"))
    parameters = node_parameters or _benchmark_parameters(ips)
    parameters.dump(os.path.join(working_dir, "parameters.yaml"))
    for i in range(committee_size):
        private_dir = os.path.join(working_dir, f"validator-{i}")
        PrivateConfig.new_in_dir(i, private_dir)
        with open(os.path.join(private_dir, "seed"), "wb") as f:
            f.write(i.to_bytes(32, "little"))


def _apply_storage_overrides(parameters: Parameters, args) -> None:
    """CLI storage-lifecycle + tracing flags override the parameters file
    (run) or the generated genesis (testbed): one knob block, one override
    path."""
    storage = parameters.storage
    if getattr(args, "gc_depth", None) is not None:
        storage.gc_depth = args.gc_depth
    if getattr(args, "segment_bytes", None) is not None:
        storage.segment_bytes = args.segment_bytes
    if getattr(args, "checkpoint_interval", None) is not None:
        storage.checkpoint_interval = args.checkpoint_interval
    if getattr(args, "snapshot_catchup", False):
        storage.snapshot_catchup = True
    if getattr(args, "timestamp_frames", False):
        parameters.synchronizer.timestamp_frames = True
    # Ingress-plane flags (one IngressParameters block, config.py).
    ingress = parameters.ingress
    if getattr(args, "no_ingress", False):
        ingress.enabled = False
    if getattr(args, "gateway_port_base", None) is not None:
        ingress.gateway_port_base = args.gateway_port_base
    if getattr(args, "mempool_max_transactions", None) is not None:
        ingress.mempool_max_transactions = args.mempool_max_transactions
    if getattr(args, "admission_initial", None) is not None:
        ingress.admission_initial_tx_s = float(args.admission_initial)
    if getattr(args, "no_admission", False):
        ingress.admission = False
    # Execution plane (execution.py): the deterministic account/transfer
    # state machine folding the committed sequence.
    if getattr(args, "execution", False):
        parameters.execution = True


async def run_node(
    authority: int,
    committee_path: str,
    parameters_path: str,
    private_dir: str,
    verifier: str = DEFAULT_VERIFIER,
    tps: Optional[int] = None,
    storage_args=None,
) -> None:
    """main.rs:159-185.  Raises when the node dies with an error, and when
    its verifier fails to warm up (the node is stopped first)."""
    from . import spans
    from .profiling import start_from_env, stop_from_env

    # MYSTICETI_PROFILE=<path>.folded: lifetime flamegraph, fed through the
    # per-subsystem accountant (profiling.py); MYSTICETI_PERF_REPORT=
    # <path>.json additionally writes the node's attribution report
    # (per-subsystem CPU seconds, GIL convoy ratio) at shutdown — the input
    # tools/perf_attr.py aggregates.
    start_from_env()
    # MYSTICETI_TRACE=<path>.json: per-block pipeline spans, exported as
    # Chrome trace-event JSON (Perfetto-loadable) at shutdown, with periodic
    # atomic flushes so a SIGKILL'd node still leaves a snapshot.
    spans.start_from_env()
    # MYSTICETI_CPROFILE=<path> (+ optional MYSTICETI_EXIT_AFTER=<s>): exact
    # deterministic profile of the node's event loop, dumped on clean exit —
    # the sampling profiler can't attribute C-extension time and benchmark
    # fleets SIGKILL their nodes, so a timed clean exit is the way to get a
    # trustworthy in-fleet profile.
    cprofile_path = os.environ.get("MYSTICETI_CPROFILE")
    profiler = None
    if cprofile_path:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
    exit_after = float(os.environ.get("MYSTICETI_EXIT_AFTER", "0") or 0)
    # Orderly shutdown on SIGTERM (fleet runners/operators stopping a node):
    # flush the span-trace tail and the last metrics window through
    # Validator.stop instead of dying mid-flush — only SIGKILL loses tails.
    # A verifier that fails to warm up stops the node the same way.
    import signal as _signal

    term = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        with stop_on_warmup_failure(verifier, lambda: loop.call_soon_threadsafe(term.set)):
            committee = Committee.load(committee_path)
            parameters = Parameters.load(parameters_path)
            if storage_args is not None:
                _apply_storage_overrides(parameters, storage_args)
            private = PrivateConfig.new_in_dir(authority, private_dir)
            seed_path = os.path.join(private_dir, "seed")
            with open(seed_path, "rb") as f:
                signer = Signer.from_seed(f.read())
            validator = await Validator.start_benchmarking(
                authority,
                committee,
                parameters,
                private,
                signer=signer,
                tps=tps,
                verifier=verifier,
            )
            try:
                loop.add_signal_handler(_signal.SIGTERM, term.set)
            except (NotImplementedError, RuntimeError):  # non-unix / nested loop
                pass
            completion = asyncio.ensure_future(
                validator.network_syncer.await_completion()
            )
            term_wait = asyncio.ensure_future(term.wait())
            timeout = exit_after if exit_after > 0 else None
            done, pending = await asyncio.wait(
                (completion, term_wait),
                timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED,
            )
            for task in pending:
                task.cancel()
            if completion in done:
                completion.result()  # a node that died with an error must raise
            else:
                # Timed exit or SIGTERM: clean WAL close + network shutdown +
                # telemetry tail flush.
                await validator.stop()
    finally:
        if profiler is not None:
            profiler.disable()
            profiler.dump_stats(
                cprofile_path.replace("%p", str(os.getpid()))
            )
        stop_from_env()
        spans.stop_from_env()


async def testbed(committee_size: int, working_dir: str, duration_s: float,
                  verifier: str = DEFAULT_VERIFIER, storage_args=None) -> List:
    """N in-process validators on localhost (main.rs:187-227).  Raises, once
    every node is stopped, when a node's verifier failed to warm up."""
    from . import spans

    spans.start_from_env()  # one trace for the whole in-process fleet
    failed = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        with stop_on_warmup_failure(verifier, lambda: loop.call_soon_threadsafe(failed.set)):
            ips = ["127.0.0.1"] * committee_size
            benchmark_genesis(ips, working_dir)
            committee = Committee.load(os.path.join(working_dir, "committee.yaml"))
            parameters = Parameters.load(os.path.join(working_dir, "parameters.yaml"))
            if storage_args is not None:
                _apply_storage_overrides(parameters, storage_args)
            signers = Committee.benchmark_signers(committee_size)
            validators = []
            for i in range(committee_size):
                private = PrivateConfig.new_in_dir(
                    i, os.path.join(working_dir, f"validator-{i}")
                )
                validators.append(
                    await Validator.start_benchmarking(
                        i,
                        committee,
                        parameters,
                        private,
                        signer=signers[i],
                        serve_metrics_endpoint=False,
                        verifier=verifier,
                    )
                )
            try:
                await asyncio.wait_for(failed.wait(), duration_s)
            except asyncio.TimeoutError:
                pass
            committed = [v.committed_leaders() for v in validators]
            for v in validators:
                await v.stop()
    finally:
        spans.stop_from_env()
    return committed


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mysticeti-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    g = sub.add_parser("benchmark-genesis", help="emit benchmark configs")
    g.add_argument("--ips", nargs="+", required=True)
    g.add_argument("--working-directory", default="genesis")

    def add_storage_flags(p):
        p.add_argument("--gc-depth", type=int, default=None,
                       help="rounds retained behind the last committed "
                       "leader before WAL segments are deleted (0 = never)")
        p.add_argument("--segment-bytes", type=int, default=None,
                       help="WAL segment roll threshold (<= 0 = legacy "
                       "single-file log: no checkpoints, no GC)")
        p.add_argument("--checkpoint-interval", type=int, default=None,
                       help="commits between durable checkpoints (0 = off)")
        p.add_argument("--snapshot-catchup", action="store_true",
                       help="arm the snapshot catch-up streams (wire tags "
                       "9/10/11): far-behind peers bootstrap from a commit "
                       "baseline + recent block window, not full history")
        p.add_argument("--timestamp-frames", action="store_true",
                       help="stamp block push frames with sender clocks "
                       "(wire tag 12): peers surface per-link transit")
        p.add_argument("--no-ingress", action="store_true",
                       help="disable the admission-controlled ingress plane "
                       "(an unbounded direct queue)")
        p.add_argument("--no-admission", action="store_true",
                       help="keep the bounded mempool but disable the AIMD "
                       "admission controller (pool caps still shed)")
        p.add_argument("--gateway-port-base", type=int, default=None,
                       help="serve the client RPC gateway on port "
                       "BASE+authority (wire tags 13-16; 0/unset = off)")
        p.add_argument("--mempool-max-transactions", type=int, default=None,
                       help="ingress mempool transaction cap (submissions "
                       "beyond it are SHED with a typed reject)")
        p.add_argument("--execution", action="store_true",
                       help="run the deterministic execution plane: fold "
                            "committed transactions through the "
                            "account/transfer state machine and serve the "
                            "EXECUTED notification suffix")
        p.add_argument("--admission-initial", type=float, default=None,
                       help="initial AIMD-admitted rate ceiling, tx/s")

    r = sub.add_parser("run", help="run one validator")
    r.add_argument("--authority", type=int, required=True)
    r.add_argument("--committee-path", required=True)
    r.add_argument("--parameters-path", required=True)
    r.add_argument("--private-config-path", required=True)
    r.add_argument("--verifier", choices=VERIFIER_CHOICES, default=DEFAULT_VERIFIER)
    add_storage_flags(r)

    d = sub.add_parser("dry-run", help="one validator of an N-node local setup")
    d.add_argument("--committee-size", type=int, required=True)
    d.add_argument("--authority", type=int, required=True)
    d.add_argument("--working-directory", default="dryrun")
    d.add_argument("--verifier", choices=VERIFIER_CHOICES, default=DEFAULT_VERIFIER)
    add_storage_flags(d)

    t = sub.add_parser("testbed", help="N in-process validators")
    t.add_argument("--committee-size", type=int, required=True)
    t.add_argument("--working-directory", default="testbed")
    t.add_argument("--duration", type=float, default=30.0)
    t.add_argument("--verifier", choices=VERIFIER_CHOICES, default=DEFAULT_VERIFIER)
    add_storage_flags(t)

    vs = sub.add_parser(
        "verifier-service",
        help="shared per-host verifier service: one warmed card runtime "
        "serving every co-located validator over a unix socket "
        "(set MYSTICETI_VERIFIER_SOCKET on the nodes to use it)",
    )
    vs.add_argument("--socket", required=True, help="unix socket path")
    vs.add_argument("--committee-path", default=None,
                    help="prewarm for this committee while validators boot")
    vs.add_argument("--metrics-port", type=int, default=None,
                    help="expose /metrics + /healthz (queue depth, "
                    "in-flight per connection, dispatch sizes, padding)")
    vs.add_argument("--device", default=None,
                    help="torch device of the backend (default cuda; cpu "
                    "runs the kernels' plain versions)")

    def add_sim_verifier_flags(p, oracle_help):
        p.add_argument("--verifier", choices=SIM_VERIFIER_CHOICES,
                       default=DEFAULT_VERIFIER,
                       help=f"each node's signature verifier; {SIM_ORACLE}: "
                       f"{oracle_help}")
        p.add_argument("--device", default=None,
                       help="torch device of the kernel kinds (default cuda; "
                       "cpu runs the kernels' plain versions)")

    ch = sub.add_parser(
        "chaos",
        help="deterministic chaos sim: replay a FaultPlan from JSON over the "
        "virtual-time simulator (seeded network faults, timed partitions, "
        "crash-restarts with WAL replay) and audit commit safety",
    )
    ch.add_argument("--plan", required=True, help="FaultPlan JSON path")
    ch.add_argument("--nodes", type=int, default=10)
    ch.add_argument("--duration", type=float, default=30.0,
                    help="virtual seconds to simulate")
    ch.add_argument("--working-directory", default=None,
                    help="WAL directory (default: a fresh temp dir)")
    ch.add_argument("--dump-schedule", action="store_true",
                    help="print the resolved fault schedule and exit")
    ch.add_argument("--slo", default=None,
                    help="SLOThresholds JSON path (default: built-in chaos "
                    "thresholds); the run's health timeline + alerts ride "
                    "in the report")
    ch.add_argument("--health-out", default=None,
                    help="write the deterministic health timeline + SLO "
                    "alert stream as JSON")
    add_sim_verifier_flags(ch, "the JAX CLI's choice (the sim re-sign "
                           "oracle for a plan with adversaries, none for a "
                           "benign plan)")

    ov = sub.add_parser(
        "overload",
        help="deterministic overload sim: seeded N-node fleet under an "
        "offered-load multiplier ramp through the admission-controlled "
        "ingress plane; prints committed-vs-offered, the shed ledger, and "
        "the byte-stable shed-schedule digest",
    )
    ov.add_argument("--seed", type=int, default=0)
    ov.add_argument("--nodes", type=int, default=10)
    ov.add_argument("--duration", type=float, default=15.0,
                    help="virtual seconds to simulate")
    ov.add_argument("--base-tps", type=int, default=300,
                    help="per-node offered load at 1x")
    ov.add_argument("--schedule", default="0:3",
                    help="offered-load multiplier ramp, t:mult pairs "
                    "(e.g. '0:1,5:3,10:5')")
    ov.add_argument("--clients", type=int, default=3,
                    help="fairness lanes per node")
    ov.add_argument("--closed-loop", action="store_true",
                    help="clients consume SHED/retry-after verdicts")
    ov.add_argument("--report-out", default=None,
                    help="write the full report JSON here")

    sc = sub.add_parser(
        "scenarios",
        help="declarative resilience scenario matrix: run one named "
        "scenario (or the whole matrix) of composed Byzantine adversary "
        "mixes + benign chaos + storage churn + geo latency + version "
        "skew, each as an attacked run vs a same-seed clean twin",
    )
    sc.add_argument("--list", action="store_true",
                    help="list the matrix scenarios and exit")
    sc.add_argument("--scenario", default=None,
                    help="run only this named scenario (default: the whole "
                    "matrix)")
    sc.add_argument("--duration", type=float, default=None,
                    help="override the scenario's virtual duration")
    sc.add_argument("--seed", type=int, default=None,
                    help="override the scenario's seed")
    sc.add_argument("--working-directory", default=None,
                    help="WAL root (default: a fresh temp dir, removed)")
    sc.add_argument("--out", default=None,
                    help="write the matrix verdict document as JSON")
    add_sim_verifier_flags(sc, "the JAX CLI's choice (the sim re-sign "
                           "oracle)")

    o = sub.add_parser(
        "orchestrator",
        help="run a local benchmark sweep: boot a fleet, scrape, summarize, plot",
    )
    o.add_argument("--settings", help="settings.json path (overrides most flags)")
    o.add_argument("--nodes", type=int, default=4)
    o.add_argument("--loads", type=int, nargs="+", default=[100],
                   help="fixed offered loads (tx/s) to sweep")
    o.add_argument("--search", action="store_true",
                   help="binary-search the max sustainable load instead")
    o.add_argument("--starting-load", type=int, default=100)
    o.add_argument("--max-iterations", type=int, default=7,
                   help="search: probe budget (doubling + bisection runs)")
    o.add_argument("--duration", type=float, default=60.0)
    o.add_argument("--faults", type=int, default=0)
    o.add_argument("--fault-kind", choices=["none", "permanent", "crash-recovery"],
                   default="none")
    o.add_argument("--fault-interval", type=float, default=30.0)
    o.add_argument("--verifier", choices=VERIFIER_CHOICES, default=DEFAULT_VERIFIER)
    o.add_argument("--tps-per-node", type=int, default=None,
                   help="override the generator load split (default: load/nodes)")
    o.add_argument("--working-directory", default="benchmark-fleet")
    o.add_argument("--results-dir", default="benchmark-results")
    o.add_argument("--scrape-interval", type=float, default=10.0)
    o.add_argument("--plot", action="store_true", help="write latency-throughput plot")

    f = sub.add_parser(
        "fleet",
        help="testbed lifecycle over a host pool: deploy/start/stop/destroy/"
        "status/install/update/logs",
    )
    f.add_argument("action", choices=[
        "deploy", "start", "stop", "destroy", "status", "install", "update",
        "logs",
    ])
    f.add_argument("--settings", help="settings.json with the host pool")
    f.add_argument("--hosts", nargs="*", default=None,
                   help="host pool override (user@addr ...)")
    f.add_argument("--count", type=int, default=None,
                   help="deploy: number of instances (default: whole pool)")
    f.add_argument("--region", default="local")
    f.add_argument("--state", default="testbed-state.json",
                   help="inventory state file")
    f.add_argument("--dest", default="downloaded-logs", help="logs: local dir")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from .tracing import setup_logging

    setup_logging()  # honors MYSTICETI_LOG (RUST_LOG-style env filter)
    args = build_parser().parse_args(argv)

    if args.command == "benchmark-genesis":
        benchmark_genesis(args.ips, args.working_directory)
        print(f"genesis written to {args.working_directory}")
        return 0
    if args.command == "run":
        asyncio.run(
            run_node(
                args.authority,
                args.committee_path,
                args.parameters_path,
                args.private_config_path,
                verifier=args.verifier,
                storage_args=args,
            )
        )
        return 0
    if args.command == "dry-run":
        wd = args.working_directory
        ips = ["127.0.0.1"] * args.committee_size
        benchmark_genesis(ips, wd)
        asyncio.run(
            run_node(
                args.authority,
                os.path.join(wd, "committee.yaml"),
                os.path.join(wd, "parameters.yaml"),
                os.path.join(wd, f"validator-{args.authority}"),
                verifier=args.verifier,
                storage_args=args,
            )
        )
        return 0
    if args.command == "testbed":
        committed = asyncio.run(
            testbed(args.committee_size, args.working_directory, args.duration,
                    args.verifier, storage_args=args)
        )
        for i, seq in enumerate(committed):
            print(f"validator {i}: {len(seq)} committed leaders")
        return 0
    if args.command == "verifier-service":
        from .verifier_service import run_service

        keys = None
        if args.committee_path:
            keys = Committee.load(args.committee_path).public_key_bytes()
        run_service(args.socket, keys, metrics_port=args.metrics_port,
                    device=args.device)
        return 0
    if args.command == "chaos":
        return run_chaos(args)
    if args.command == "overload":
        return run_overload(args)
    if args.command == "scenarios":
        return run_scenarios(args)
    if args.command == "orchestrator":
        return run_orchestrator(args)
    if args.command == "fleet":
        return run_fleet(args)
    return 1


def run_chaos(args) -> int:
    """The `chaos` subcommand: replay a FaultPlan from JSON on the
    deterministic simulator, print per-node commit progress, the injected
    fault tally, and the fault-schedule digest (byte-identical across runs
    of the same plan), and fail loudly on any commit-safety violation.
    Every node verifies through ``--verifier`` (the kernel kinds over the
    benchmark committee's keys, so the harness's signers verify)."""
    import json
    import tempfile

    from .chaos import (
        FaultPlan,
        SafetyViolation,
        resolve_schedule,
        run_chaos_sim,
    )

    with open(args.plan, "r", encoding="utf-8") as f:
        plan = FaultPlan.from_json(f.read())
    if args.dump_schedule:
        for event in resolve_schedule(plan):
            print(event)
        return 0
    from .health import SLOThresholds

    if args.slo:
        with open(args.slo, "r", encoding="utf-8") as f:
            slo = SLOThresholds.from_dict(json.load(f))
    else:
        slo = SLOThresholds(
            max_round_stall_s=8.0,
            max_commit_stall_s=10.0,
            max_authority_lag_rounds=15,
        )
    verifier = {}
    if args.verifier != SIM_ORACLE:
        from .scenarios import verifier_factory

        committee = Committee.new_for_benchmarks(args.nodes)
        verifier = dict(
            committee=committee,
            verifier_factory=verifier_factory(
                args.verifier, committee, device=args.device
            ),
        )
    wal_dir = args.working_directory or tempfile.mkdtemp(prefix="chaos-")
    os.makedirs(wal_dir, exist_ok=True)
    try:
        report, _harness = run_chaos_sim(
            plan, args.nodes, args.duration, wal_dir, with_metrics=True,
            slo=slo, **verifier,
        )
    except SafetyViolation as exc:
        print(f"SAFETY VIOLATION: {exc}")
        return 1
    for authority, sequence in sorted(report.sequences.items()):
        print(f"validator {authority}: {len(sequence)} committed leaders")
    faults = ", ".join(
        f"{kind}={count}" for kind, count in sorted(report.fault_counts.items())
    )
    print(f"faults injected: {faults or 'none'}")
    print(f"fault schedule digest: {report.schedule_digest()}")
    if plan.adversaries:
        attacks = ", ".join(
            f"{key}={count}"
            for key, count in sorted(report.attack_counts.items())
        )
        print(f"attacks injected: {attacks or 'none'}")
        print(f"attack ledger digest: {report.attack_digest()}")
        for authority, census in sorted(report.detections.items()):
            for surface, labels in sorted(census.items()):
                tally = ", ".join(
                    f"{label}={int(count)}"
                    for label, count in sorted(labels.items())
                )
                print(f"detected by A{authority} [{surface}]: {tally}")
    for alert in report.slo_alerts:
        who = "node" if alert["authority"] is None else f"A{alert['authority']}"
        print(
            f"SLO alert t={alert['t']:.1f}s {alert['kind']} [{alert['stage']}]"
            f" {who} (observed by A{alert['observer']}): {alert['detail']}"
        )
    print(
        f"health: {len(report.slo_alerts)} SLO alert(s) over "
        f"{len(report.health_timeline)} timeline sample(s)"
    )
    if args.health_out:
        with open(args.health_out, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "slo": slo.to_dict(),
                    "timeline": report.health_timeline,
                    "alerts": report.slo_alerts,
                },
                f, indent=1,
            )
            f.write("\n")
        print(f"health timeline written to {args.health_out}")
    print("safety: OK (identical committed prefixes on all nodes)")
    return 0


def run_scenarios(args) -> int:
    """The `scenarios` subcommand: the resilience matrix (scenarios.py).
    Each scenario prints its verdict line; the exit code is 0 only when
    every scenario run passed (safety + detection + throughput ratio)."""
    import dataclasses
    import json

    from .scenarios import default_matrix, run_matrix, scenario_by_name

    if args.list:
        for scenario in default_matrix():
            print(f"{scenario.name:<24} n={scenario.nodes:<3} "
                  f"{scenario.duration_s:>5.0f}s  {scenario.description}")
        return 0
    if args.scenario:
        selected = [scenario_by_name(args.scenario)]
    else:
        selected = default_matrix()
    overrides = {}
    if args.duration is not None:
        overrides["duration_s"] = args.duration
    if args.seed is not None:
        overrides["seed"] = args.seed
    if overrides:
        selected = [dataclasses.replace(s, **overrides) for s in selected]
    doc = run_matrix(selected, wal_root=args.working_directory,
                     device=args.device, verifier=args.verifier)
    for verdict in doc["scenarios"]:
        name = verdict["scenario"]["name"]
        status = "PASS" if verdict["passed"] else "FAIL"
        detections = verdict.get("detections", {})
        print(
            f"{name:<24} {status}  ratio={verdict.get('throughput_ratio', 0.0):.2f} "
            f"committed={verdict.get('committed_tx', 0)} "
            f"attacks={sum(verdict.get('attack_counts', {}).values())} "
            f"detected={sum(1 for d in detections.values() if d['ok'])}"
            f"/{len(detections)}"
            + ("" if verdict["safety_ok"] else "  SAFETY-VIOLATION")
        )
    print(f"matrix: {doc['passed']} passed, {doc['failed']} failed")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"matrix verdicts written to {args.out}")
    return 0 if doc["all_pass"] else 1


def run_overload(args) -> int:
    """The `overload` subcommand: one seeded overload scenario on the
    deterministic simulator.  Commit safety under overload is audited by
    the chaos SafetyChecker inside the runner."""
    import json

    from .ingress import OverloadScenario, run_overload_sim
    from .transactions_generator import parse_overload_schedule

    scenario = OverloadScenario(
        seed=args.seed,
        nodes=args.nodes,
        duration_s=args.duration,
        base_tps=args.base_tps,
        multiplier_schedule=parse_overload_schedule(args.schedule),
        clients_per_node=args.clients,
        closed_loop=args.closed_loop,
        max_per_proposal=30,
        mempool_max_transactions=600,
    )
    report = run_overload_sim(scenario)
    print(
        f"committed: {report.committed_tx} tx "
        f"({report.committed_tx_s:.1f} tx/s) of {report.offered_tx} offered "
        f"({report.admitted_tx} admitted)"
    )
    for reason, count in sorted(report.shed_by_reason.items()):
        print(f"shed[{reason}]: {count}")
    for lane, stats in sorted(report.lane_stats.items()):
        print(
            f"lane {lane}: drained={stats['drained']} shed={stats['shed']}"
            f" pending={stats['pending']}"
        )
    print(f"shed schedule digest: {report.shed_schedule_digest}")
    print("safety: OK (identical committed prefixes on all nodes)")
    if args.report_out:
        with open(args.report_out, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "scenario": scenario.to_dict(),
                    "committed_tx": report.committed_tx,
                    "committed_tx_s": report.committed_tx_s,
                    "offered_tx": report.offered_tx,
                    "admitted_tx": report.admitted_tx,
                    "shed_by_reason": report.shed_by_reason,
                    "shed_schedule_digest": report.shed_schedule_digest,
                    "lane_stats": report.lane_stats,
                    "commit_heights": report.commit_heights,
                    "generator_stats": report.generator_stats,
                },
                f, indent=1,
            )
            f.write("\n")
        print(f"report written to {args.report_out}")
    return 0


def run_fleet(args) -> int:
    """Testbed lifecycle CLI (orchestrator/src/main.rs testbed commands +
    testbed.rs:21-210): inventory over a static host pool, ssh-backed
    install/update/log-download."""
    from .orchestrator.settings import Settings
    from .orchestrator.ssh import SshManager
    from .orchestrator.testbed import StaticProvider, Testbed

    settings = Settings.load(args.settings) if args.settings else Settings()
    pool = args.hosts if args.hosts is not None else settings.hosts
    if settings.provider != "static":
        provider = settings.make_provider(state_path=args.state)
        if (
            settings.provider in ("rest", "aws")
            and args.action == "deploy"
            and not args.count
        ):
            raise SystemExit(
                f"{settings.provider} provider: `fleet deploy` requires --count"
            )
        # The ssh pool comes from the PROVIDER's live instances (a cloud
        # fleet has no static hosts list); resolved per-action below since
        # listing is async.
        ssh = None
    else:
        provider = StaticProvider(pool, state_path=args.state)
        ssh = SshManager(pool) if pool else None
    # settings.remote_repo's "." default addresses the ssh *runner* (commands
    # run from the checkout); as a clone target it would hit $HOME — keep
    # Testbed's own directory default unless the operator set a real path.
    remote_repo = (
        settings.remote_repo if settings.remote_repo not in ("", ".") else None
    )
    tb = Testbed(
        provider,
        ssh=ssh,
        repo_url=settings.repo_url,
        **({"remote_repo": remote_repo} if remote_repo else {}),
    )

    async def dispatch() -> None:
        if settings.provider in ("rest", "aws") and tb.ssh is None:
            hosts = [i.host for i in await provider.list_instances() if i.host]
            if hosts:
                tb.ssh = SshManager(hosts)
        if args.action == "deploy":
            await tb.deploy(args.count or len(pool), args.region)
        elif args.action == "start":
            await tb.start()
        elif args.action == "stop":
            await tb.stop()
        elif args.action == "destroy":
            await tb.destroy()
        elif args.action == "status":
            await tb.status()
        elif args.action == "install":
            await tb.install()
        elif args.action == "update":
            await tb.update()
        elif args.action == "logs":
            await tb.download_logs(settings.working_dir, args.dest)

    asyncio.run(dispatch())
    return 0


def run_orchestrator(args) -> int:
    """The orchestrator CLI (orchestrator/src/main.rs:36-195 equivalent):
    fixed-load sweep or max-load binary search over a local fleet, with
    summaries, log analysis, and an optional latency-throughput plot."""
    from .orchestrator.benchmark import LoadType, ParametersGenerator
    from .orchestrator.faults import FaultsType
    from .orchestrator.logs import analyze_logs
    from .orchestrator.orchestrator import Orchestrator
    from .orchestrator.plot import plot_latency_throughput
    from .orchestrator.settings import Settings

    if args.settings:
        settings = Settings.load(args.settings)
    else:
        settings = Settings(
            working_dir=args.working_directory,
            results_dir=args.results_dir,
            verifier=args.verifier,
        )
    if args.tps_per_node is not None:
        settings.tps_per_node = args.tps_per_node
    # Otherwise the per-run offered load flows through Runner.configure
    # (parameters.load // nodes) and any settings.json value stays the default.

    if args.fault_kind == "permanent":
        faults = FaultsType.permanent(args.faults)
    elif args.fault_kind == "crash-recovery":
        faults = FaultsType.crash_recovery(args.faults, args.fault_interval)
    else:
        faults = FaultsType.none()

    load_type = (
        LoadType.search(args.starting_load, max_iterations=args.max_iterations)
        if args.search
        else LoadType.fixed(list(args.loads))
    )
    generator = ParametersGenerator(
        args.nodes, load_type, duration_s=args.duration, faults=faults
    )
    runner = settings.make_runner()
    orchestrator = Orchestrator(
        runner,
        generator,
        results_dir=settings.results_dir,
        scrape_interval_s=args.scrape_interval,
    )
    collections = asyncio.run(orchestrator.run_benchmarks())
    for c in collections:
        print(c.display_summary())
    if args.search:
        print(f"max sustainable load: {generator.max_sustainable_load()} tx/s")
    analysis = analyze_logs(settings.working_dir)
    print(analysis.display())
    if args.plot:
        written = plot_latency_throughput(
            collections, os.path.join(settings.results_dir, "latency-throughput")
        )
        for path in written:
            print(f"wrote {path}")
    return 0

