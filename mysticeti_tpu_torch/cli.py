"""Node binary: genesis, run, dry-run, testbed and verifier-service subcommands.

The port's copy of ``mysticeti_tpu.cli``'s node commands.  Capability parity
with ``mysticeti/src/main.rs``:

* ``benchmark-genesis`` (:36-43,116-156) — emit committee.yaml, parameters.yaml
  and per-authority private configs (key seed + storage dir).
* ``run`` (:44-58,159-185) — start one validator from config files.
* ``dry-run`` (:59-67,229-268) — single-command local validator: generates an
  in-process benchmark config for N authorities and runs one of them.
* ``testbed`` (:68-73,187-227) — N in-process validators on localhost.
* ``verifier-service`` — the shared per-host verifier service
  (verifier_service.py) that nodes reach through ``MYSTICETI_VERIFIER_SOCKET``.

``--verifier`` selects the signature backend (validator.py): ``cuda`` is the
hybrid router (the CUDA kernels for large batches, the CPU oracle for small
ones), ``cuda-only`` pins every batch to the kernels, ``cpu`` is the serial
OpenSSL oracle, ``accept`` skips signature checks, and ``-agg`` turns on the
collector's threshold-aggregate mode.  The default is ``cuda-only`` (the JAX
CLI's is ``cpu``): a node runs on the card unless it is asked for the CPU, and
without a card, or with a kernel that fails to build, ``run``, ``dry-run`` and
``testbed`` exit non-zero.
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
    return 1
