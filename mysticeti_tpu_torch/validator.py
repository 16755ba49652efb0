"""Node assembly: storage, handlers, network, syncer — the whole validator.

The port's copy of ``mysticeti_tpu.validator``.  Capability parity with
``mysticeti-core/src/validator.rs``:

* ``Validator.start_benchmarking`` (:78-163) — benchmark fast-path handler +
  open-loop generator + TestCommitObserver + metrics endpoint.
* ``Validator.start_production`` (:165-212) — SimpleBlockHandler (application
  submits raw transactions, acked on proposal) + SimpleCommitObserver
  (sub-dags to a consumer queue with replay above last_sent_height).
* ``init_storage`` (:334-352) — WAL + BlockStore recovery.
* ``CommitConsumer`` (:50-66) — the application-facing commit stream handle.

``verifier=`` selects the signature backend (``_make_verifier``).  Kinds:

* ``"cuda"``      — the hybrid router: each batch goes to the CPU oracle or
  the CUDA kernels by measured cost, behind a circuit breaker (the
  counterpart of ``"tpu"``);
* ``"cuda-only"`` — every batch goes to the CUDA kernels through the
  batching collector (the counterpart of ``"tpu-only"``);
* ``"cpu"``       — the batching collector over the CPU oracle;
* ``"accept"``    — no signature checks (consensus-only escape hatch).

A ``-agg`` suffix on a collector kind (``cuda-agg``, ``cuda-only-agg``,
``cpu-agg``) turns on the collector's threshold-aggregate mode: blocks that
a quorum of accepted in-batch (or earlier) children include skip the
signature dispatch, as the JAX package's ``tpu-agg`` / ``cpu-agg`` do.
On a local card that is measured slower, not faster: on an H100 80GB HBM3
(700 W) a 250-block burst ran through ``cuda-only-agg`` at 0.34-0.45x the
blocks/s of ``cuda-only`` (``chip_smoke.py``'s receive phase), because
both pay one 256-lane launch, which costs the same with 59 live lanes as
with 250, and the aggregate bookkeeping adds 15-33 ms of Python a burst.

With ``MYSTICETI_VERIFIER_SOCKET`` set, both accelerator kinds reach the
card through the host's shared verifier service (verifier_service.py)
instead of in-process kernels: this process then never opens a CUDA
context.  In process, on a host with several cards both accelerator kinds
shard each batch over them (``TorchSignatureVerifier(mesh="auto")``).
The node's accelerator kinds take ``device`` (default ``cuda``, which
raises without a card; ``"cpu"`` runs the kernels' plain versions).
"""
from __future__ import annotations

import asyncio
import os
import threading
from typing import List, Optional, Tuple

from .block_handler import BenchmarkFastPathBlockHandler, SimpleBlockHandler
from .block_validator import (
    AcceptAllBlockVerifier,
    BatchedSignatureVerifier,
    CpuSignatureVerifier,
    HybridSignatureVerifier,
    TorchSignatureVerifier,
)
from .commit_observer import SimpleCommitObserver, TestCommitObserver
from .committee import Committee
from .config import Parameters, PrivateConfig
from .core import Core, CoreOptions
from .crypto import Signer
from .flight_recorder import FlightRecorder, path_from_env
from .health import HealthProbe, SLOThresholds
from .ingress import IngressGateway, IngressPlane
from .metrics import MetricReporter, Metrics, serve_metrics
from .net_sync import NetworkSyncer
from .network import TcpNetwork
from .tracing import current_authority, logger, setup_logging
from .transactions_generator import TransactionGenerator

log = logger(__name__)

ACCELERATOR_KIND = "cuda-only"
HYBRID_KIND = "cuda"


class CommitConsumer:
    """Application handle for consuming committed sub-dags (validator.rs:50-66)."""

    def __init__(self, last_sent_height: int = 0) -> None:
        self.queue: asyncio.Queue = asyncio.Queue()
        self.last_sent_height = last_sent_height

    def send(self, sub_dag) -> None:
        self.queue.put_nowait(sub_dag)


def _make_verifier(kind: str, committee: Committee, metrics=None, device=None):
    """Signature verification is ON by default; "accept" is an explicit
    escape hatch.  ``metrics`` (a ``metrics.Metrics``) reaches the
    collector, the router, the service client and, in process, the device
    attribution.  ``device`` places the in-process accelerator kind's
    tensors (default ``cuda``, which raises without a card; ``"cpu"`` runs
    the kernels' plain versions); a service client has none.

    The returned verifier carries a ``ready`` threading.Event: set once its
    one-time warmup is done (immediately for cpu/accept; after the kernels'
    build and first launches, or the service's HELLO, for the accelerator
    kinds)."""
    ready = threading.Event()
    aggregate = kind.endswith("-agg")
    if aggregate:
        kind = kind[: -len("-agg")]
    # Collection window (ms).  The same small default applies in aggregate
    # mode: a wide window would pace round advance.  Aggregation engages
    # through BACKPRESSURE instead — when the verifier lags the arrival rate
    # (catch-up bursts, a recovering node's backlog), flushes span many
    # rounds from every peer and quorum-endorsed interiors skip their
    # dispatch.
    window_ms = float(os.environ.get("MYSTICETI_VERIFY_WINDOW_MS", "5"))
    depth_env = os.environ.get("MYSTICETI_VERIFY_PIPELINE_DEPTH")
    collector_opts = dict(
        metrics=metrics,
        aggregate=aggregate,
        max_delay_s=window_ms / 1e3,
        pipeline_depth=int(depth_env) if depth_env else None,
    )
    if kind in (HYBRID_KIND, ACCELERATOR_KIND):
        committee_keys = committee.public_key_bytes()
        if os.environ.get("MYSTICETI_VERIFIER_SOCKET"):
            # The host's shared verifier service owns the card: one warmed
            # runtime serving every co-located validator.
            from .verifier_service import RemoteSignatureVerifier

            backend = RemoteSignatureVerifier(committee_keys=committee_keys, metrics=metrics)
        else:
            backend = TorchSignatureVerifier(committee_keys=committee_keys, device=device)
            if metrics is not None:
                from .ops import ed25519

                ed25519.install_device_attribution(metrics)
        if kind == HYBRID_KIND:
            # Small batches take the CPU oracle, sparing them the dispatch
            # latency; "cuda-only" pins every batch to the kernels.
            backend = HybridSignatureVerifier(tpu=backend, metrics=metrics)

        def _warm() -> None:
            # Build the kernels, upload the combs (or HELLO the service) and
            # (hybrid) calibrate both routes off the hot path: blocks
            # arriving meanwhile queue in the batching collector.
            try:
                backend.warmup()
            finally:
                ready.set()

        threading.Thread(target=_warm, daemon=True, name="verifier-warmup").start()
        verifier = BatchedSignatureVerifier(committee, backend, **collector_opts)
    elif kind == "cpu":
        ready.set()
        verifier = BatchedSignatureVerifier(committee, CpuSignatureVerifier(), **collector_opts)
    elif kind == "accept":
        ready.set()
        verifier = AcceptAllBlockVerifier()
    else:
        raise ValueError(f"unknown verifier kind {kind!r}")
    verifier.ready = ready
    return verifier


class Validator:
    # Production health-probe cadence (seconds between samples).
    HEALTH_INTERVAL_S = 5.0

    def __init__(self) -> None:
        self.network_syncer: Optional[NetworkSyncer] = None
        self.metrics: Optional[Metrics] = None
        self.reporter: Optional[MetricReporter] = None
        self.generator: Optional[TransactionGenerator] = None
        self._metrics_server = None
        self.core: Optional[Core] = None
        self.health: Optional[HealthProbe] = None
        self.recorder: Optional[FlightRecorder] = None
        self.ingress: Optional[IngressPlane] = None
        self.gateway: Optional[IngressGateway] = None
        self.host_monitor = None

    def _make_recorder(self, authority: int, lifecycle, observer):
        """The always-on flight recorder: ring in memory unconditionally,
        on-disk dumps when ``MYSTICETI_FLIGHT_RECORDER`` names a path."""
        recorder = FlightRecorder(
            authority=authority,
            dump_path=path_from_env(authority),
            metrics=self.metrics,
        )
        if lifecycle is not None:
            lifecycle.recorder = recorder
        observer.recorder = recorder
        self.recorder = recorder
        return recorder

    def _start_health(self, authority, committee, observer, block_verifier):
        """Wire the fleet health plane: probe + SLO watchdog + (when span
        tracing is active) commit critical-path attribution + the host
        attribution plane (hostattr.py: loop-lag probe, blocking-call
        detector, GIL convoy estimate)."""
        from . import profiling, spans
        from .hostattr import HostMonitor

        probe = HealthProbe(
            authority,
            len(committee),
            metrics=self.metrics,
            slo=SLOThresholds(
                max_round_stall_s=float(
                    os.environ.get("MYSTICETI_SLO_ROUND_STALL_S", "30")
                ),
                max_authority_lag_rounds=int(
                    os.environ.get("MYSTICETI_SLO_AUTHORITY_LAG", "100")
                ),
                max_breaker_open_fraction=0.5,
                max_loop_lag_s=float(
                    os.environ.get("MYSTICETI_SLO_LOOP_LAG_S", "0.25")
                ),
                max_blocking_call_ms=float(
                    os.environ.get("MYSTICETI_SLO_BLOCKING_CALL_MS", "50")
                ),
                max_finality_p99_s=float(
                    os.environ.get("MYSTICETI_SLO_FINALITY_P99_S", "5")
                ),
            ),
            recorder=self.recorder,
        )
        monitor = HostMonitor(
            metrics=self.metrics, recorder=self.recorder
        ).start()
        self.host_monitor = monitor
        if self.network_syncer is not None:
            # Every synchronous core command reports its wall duration to
            # the blocking-call detector (core_task.py).
            self.network_syncer.dispatcher.blocking_monitor = monitor
        probe.attach(
            core=self.core,
            net_syncer=self.network_syncer,
            block_verifier=block_verifier,
            commit_observer=observer,
            host_monitor=monitor,
        )
        # Normalize the sampler's per-subsystem CPU seconds by committed
        # leaders (mysticeti_cpu_us_per_leader) when MYSTICETI_PROFILE has
        # an accountant running.
        interpreter = getattr(observer, "commit_interpreter", None)
        profiling.bind_active(
            self.metrics,
            leaders_fn=(
                (lambda: interpreter.last_height)
                if interpreter is not None
                else None
            ),
        )
        tracer = spans.active()
        if tracer is not None:
            probe.attach_critical_path(tracer)
        self.health = probe.start(self.HEALTH_INTERVAL_S)

    # -- storage (validator.rs:334-352 + the storage lifecycle plane) --

    @staticmethod
    def init_storage(
        authority: int,
        committee: Committee,
        private: PrivateConfig,
        parameters: Optional[Parameters] = None,
        metrics=None,
    ):
        """Segmented WAL + checkpoint-seeded recovery (storage.py): boots
        from the newest valid checkpoint and replays only what follows it.
        Returns ``(recovered, observer_recovered, wal_writer, lifecycle)``."""
        from .storage import open_store

        return open_store(
            authority, private.wal(), committee, parameters, metrics
        )

    # -- benchmarking node (validator.rs:78-163) --

    @classmethod
    async def start_benchmarking(
        cls,
        authority: int,
        committee: Committee,
        parameters: Parameters,
        private: PrivateConfig,
        signer: Optional[Signer] = None,
        tps: Optional[int] = None,
        transaction_size: int = 512,
        verifier: str = ACCELERATOR_KIND,
        serve_metrics_endpoint: bool = True,
        network: Optional[object] = None,
        device=None,
    ) -> "Validator":
        """A benchmarking node.  ``verifier`` defaults to ``cuda-only`` (the
        JAX package's to ``cpu``): the node verifies on the card unless it is
        asked for the CPU; ``device`` is passed to ``_make_verifier``."""
        v = cls()
        setup_logging()
        current_authority.set(authority)
        log.info("starting benchmarking validator %d (verifier=%s)", authority, verifier)
        v.metrics = Metrics()
        (recovered, observer_recovered, wal_writer, lifecycle) = cls.init_storage(
            authority, committee, private, parameters, v.metrics
        )
        # Overload-resilient ingress plane (ingress.py): every submission —
        # generator or gateway client — runs through the admission-controlled
        # mempool; proposals drain weighted-round-robin from it.
        plane = (
            IngressPlane(parameters.ingress, authority=authority,
                         metrics=v.metrics)
            if parameters.ingress.enabled
            else None
        )
        handler = BenchmarkFastPathBlockHandler(
            committee,
            authority,
            certified_log_path=private.certified_transactions_log(),
            block_store=recovered.block_store,
            metrics=v.metrics,
            ingress=plane,
        )
        core = Core(
            block_handler=handler,
            authority=authority,
            committee=committee,
            parameters=parameters,
            recovered=recovered,
            wal_writer=wal_writer,
            # Reference benchmarking uses CoreOptions::default() (fsync=false,
            # validator.rs:247): durability rides the 1 s WAL-sync thread.
            options=CoreOptions(fsync=False),
            signer=signer,
            metrics=v.metrics,
            storage=lifecycle,
        )
        v.core = core
        observer = TestCommitObserver(
            core.block_store,
            committee,
            transaction_time=handler.transaction_time,
            metrics=v.metrics,
            recovered_state=observer_recovered,
        )
        tps = tps if tps is not None else int(os.environ.get("TPS", "10"))
        transaction_size = int(
            os.environ.get("TRANSACTION_SIZE", str(transaction_size))
        )
        recorder = v._make_recorder(authority, lifecycle, observer)
        # Equivocation detection events (block_store.py) ride the ring too,
        # as do decision-skip/flip events from the commit-rule ledger.
        core.block_store.recorder = recorder
        core.committer.ledger.recorder = recorder
        block_verifier = _make_verifier(verifier, committee, v.metrics, device=device)
        # Overload modes (the environment drives these): an offered-load
        # multiplier schedule and a closed loop that consumes the ingress
        # plane's SHED/retry-after verdicts.
        from .transactions_generator import parse_overload_schedule

        schedule_env = os.environ.get("MYSTICETI_OVERLOAD_SCHEDULE")
        v.generator = TransactionGenerator(
            submit=handler.submit,
            seed=authority,
            tps=tps,
            transaction_size=transaction_size,
            initial_delay_s=float(os.environ.get("INITIAL_DELAY", "2")),
            ready=block_verifier.ready.is_set,
            overload_schedule=(
                parse_overload_schedule(schedule_env) if schedule_env else None
            ),
            closed_loop=(
                os.environ.get("MYSTICETI_CLOSED_LOOP", "") == "1"
                and plane is not None
            ),
            # Client-observed finality: armed whenever the server-side
            # tracker runs (or forced via MYSTICETI_CLIENT_FINALITY=1), with
            # the same content-based sampling stride so both sides measure
            # the same transactions.
            finality_sample_every=(
                parameters.ingress.finality_sample_every
                if plane is not None
                and (
                    plane.finality is not None
                    or os.environ.get("MYSTICETI_CLIENT_FINALITY", "") == "1"
                )
                else 0
            ),
            metrics=v.metrics,
        )
        if network is None:
            network = await TcpNetwork.start(
                authority,
                parameters.all_network_addresses(),
                metrics=v.metrics,
                max_latency_s=parameters.network_connection_max_latency_s,
            )
        v.network_syncer = NetworkSyncer(
            core,
            observer,
            network,
            parameters=parameters,
            block_verifier=block_verifier,
            metrics=v.metrics,
            start_wal_sync_thread=True,
            recorder=recorder,
        )
        await v.network_syncer.start()
        v.generator.start()
        v.reporter = MetricReporter(v.metrics).start()
        v._start_health(authority, committee, observer, block_verifier)
        if plane is not None:
            plane.recorder = recorder
            observer.ingress = plane
            plane.attach(
                core=core,
                net_syncer=v.network_syncer,
                block_verifier=block_verifier,
                health=v.health,
            )
            if v.health is not None:
                v.health.attach(ingress=plane)
            if v.generator.finality is not None:
                # The loopback notification path: commit sinks fire on the
                # loop thread, same thread the generator stamps on.
                plane.add_commit_sink(
                    lambda height, keys, info, g=v.generator: (
                        g.note_commit_notification(keys, info)
                    )
                )
            v.ingress = plane.start()
            if parameters.ingress.gateway_port_base:
                v.gateway = await IngressGateway(
                    plane,
                    "0.0.0.0",
                    parameters.ingress.gateway_port_base + authority,
                ).start()
        if serve_metrics_endpoint and parameters.identifiers:
            host, port = parameters.metrics_address(authority)
            v._metrics_server = await serve_metrics(
                v.metrics, "0.0.0.0", port, health_probe=v.health,
                flight_recorder=recorder,
                consensus_debug=v._consensus_debug_doc,
            )
        return v

    def _consensus_debug_doc(self) -> dict:
        """The live ``/debug/consensus`` document: DAG frontier, undecided
        slots, threshold-clock state, and the last-K decision records."""
        core = self.core
        store = core.block_store
        ledger = core.committer.ledger
        state = ledger.state()
        return {
            "authority": core.authority,
            "threshold_clock_round": core.current_round(),
            "last_decided": repr(core.last_decided_leader),
            "highest_round": store.highest_round(),
            "frontier": {
                str(a): store.last_seen_by_authority(a)
                for a in range(len(core.committee))
            },
            "undecided": state["undecided"],
            "recorded": state["recorded"],
            "dropped": state["dropped"],
            "ledger_digest": ledger.digest(),
            "records": ledger.records(64),
            **(
                {"execution": core.execution.state()}
                if core.execution is not None
                else {}
            ),
        }

    # -- production node (validator.rs:165-212) --

    @classmethod
    async def start_production(
        cls,
        authority: int,
        committee: Committee,
        parameters: Parameters,
        private: PrivateConfig,
        signer: Optional[Signer] = None,
        commit_consumer: Optional[CommitConsumer] = None,
        verifier: str = HYBRID_KIND,
        network: Optional[object] = None,
        device=None,
    ) -> Tuple["Validator", SimpleBlockHandler, CommitConsumer]:
        v = cls()
        setup_logging()
        current_authority.set(authority)
        log.info("starting production validator %d (verifier=%s)", authority, verifier)
        v.metrics = Metrics()
        (recovered, observer_recovered, wal_writer, lifecycle) = cls.init_storage(
            authority, committee, private, parameters, v.metrics
        )
        handler = SimpleBlockHandler()
        core = Core(
            block_handler=handler,
            authority=authority,
            committee=committee,
            parameters=parameters,
            recovered=recovered,
            wal_writer=wal_writer,
            options=CoreOptions.production(),
            signer=signer,
            metrics=v.metrics,
            storage=lifecycle,
        )
        v.core = core
        consumer = commit_consumer or CommitConsumer()
        observer = SimpleCommitObserver(
            core.block_store,
            consumer.send,
            last_sent_height=consumer.last_sent_height,
            recovered_state=observer_recovered,
            metrics=v.metrics,
        )
        if network is None:
            network = await TcpNetwork.start(
                authority,
                parameters.all_network_addresses(),
                metrics=v.metrics,
                max_latency_s=parameters.network_connection_max_latency_s,
            )
        recorder = v._make_recorder(authority, lifecycle, observer)
        core.block_store.recorder = recorder
        core.committer.ledger.recorder = recorder
        block_verifier = _make_verifier(verifier, committee, v.metrics, device=device)
        v.network_syncer = NetworkSyncer(
            core,
            observer,
            network,
            parameters=parameters,
            block_verifier=block_verifier,
            metrics=v.metrics,
            start_wal_sync_thread=True,
            recorder=recorder,
        )
        await v.network_syncer.start()
        v.reporter = MetricReporter(v.metrics).start()
        v._start_health(authority, committee, observer, block_verifier)
        return v, handler, consumer

    async def stop(self) -> None:
        if self.generator is not None:
            self.generator.stop()
        if self.gateway is not None:
            await self.gateway.stop()
        if self.ingress is not None:
            self.ingress.stop()
        if self.reporter is not None:
            # Final percentile sweep: an orderly shutdown publishes the tail
            # window instead of losing everything since the last 60 s tick.
            self.reporter.stop(final=True)
        if self.health is not None:
            self.health.stop()
        if self.host_monitor is not None:
            self.host_monitor.stop()
        if self._metrics_server is not None:
            self._metrics_server.close()
        if self.network_syncer is not None:
            await self.network_syncer.stop()
        # Span-trace tail: the periodic flusher runs every few seconds, so a
        # short run stopped between flushes would lose its newest spans.
        from . import spans

        spans.flush_active()
        # Flight-recorder tail: SIGTERM routes here too (the node CLI's
        # handler), so an operator-stopped node always leaves its incident
        # ring on disk when MYSTICETI_FLIGHT_RECORDER is set.
        if self.recorder is not None and self.recorder.dump_path:
            self.recorder.dump("shutdown")
        if self.core is not None:
            self.core.wal_writer.close()
            # Release the WAL reader too (fd + whole-file mmap): embeddings
            # that cycle validators in one process would otherwise leak one
            # of each per stop.
            self.core.block_store.close()

    def committed_leaders(self) -> List:
        observer = self.network_syncer.syncer.commit_observer
        return list(getattr(observer, "committed_leaders", []))
