"""Observability: prometheus series, exact-percentile histograms, busy timers.

The port's copy of ``mysticeti_tpu.metrics``, trimmed to the series the
port's modules write: the batching collector and its staged pipeline
(aggregate mode's ``verified_signatures_total{backend="aggregate"}``
skipped/direct counts included), the hybrid router, the verifier service and
its client, the device attribution of ``ops/ed25519.py``, the mesh transport
(``network.py``: connection latency and send drops, wire bytes, coalesced
frames, malformed frames), the native data plane
(``mysticeti_native_active``, ``dataplane_offload_seconds``), the consensus
core (syncer, core, threshold clock, block manager and store, committers'
decision ledger, commit observer, block handlers, with the exact-percentile
channels and ``observe_latency_batch``), the network plane (the
core-task dispatcher's queue, the synchronizer's fetches and frame cache,
``NetworkSyncer``'s receive path and WAL gauges), the storage lifecycle
(``wal_reclaimed_bytes_total``, ``checkpoint_last_commit_index``), the
reconfiguration and execution planes (``mysticeti_epoch*``,
``mysticeti_committee_digest_info``, ``mysticeti_execution_*``), the
ingress and finality planes (``mysticeti_ingress_*``,
``mysticeti_e2e_finality_*``, ``mysticeti_client_finality_*``), the fleet
health plane (``mysticeti_health_*``, ``commit_critical_path_seconds``),
the host attribution plane (``mysticeti_cpu_seconds_total``,
``mysticeti_cpu_us_per_leader``, ``mysticeti_loop_lag_*``,
``mysticeti_gil_convoy_ratio``, ``mysticeti_blocking_call*``) and the flight
recorder's ``flight_recorder_dumps_total``.  Every
family keeps the JAX package's name, help, labels and buckets, except the
JAX compile and compile-cache families, which become the kernels' build
families (``mysticeti_cuda_build*``, see
``ops.ed25519.install_device_attribution``); the port's own splits of the
receive path (``verify_pipeline_stage_cpu_seconds_total``,
``verify_device_seconds_total``, ``verify_collector_wait_seconds_total``,
``dataplane_offload_queue_seconds_total``,
``dataplane_offload_cpu_seconds_total``, ``dataplane_digest_frames_total``)
have no JAX counterpart.
``serve_metrics`` serves
``/metrics``, ``/healthz``, and with a probe, a recorder or a consensus
document wired ``/health``, ``/debug/flight-recorder`` and
``/debug/consensus``.  ``MetricReporter`` publishes the exact-percentile
channels as the ``histogram_pct`` gauges (stat.rs, metrics.rs:534-601).
"""
from __future__ import annotations

import asyncio
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)
from prometheus_client.core import CounterMetricFamily

from .tracing import logger
from .utils.tasks import spawn_logged

log = logger(__name__)

LATENCY_SEC_BUCKETS = [
    0.1, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 5.0, 10.0, 20.0,
    30.0, 60.0, 90.0,
]
STAGE_BUCKETS = [0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0]
BATCH_BUCKETS = [1, 8, 32, 64, 128, 256, 512, 1024, 4096]

BENCHMARK_DURATION = "benchmark_duration"
LATENCY_S = "latency_s"
LATENCY_SQUARED_S = "latency_squared_s"


# The exact-percentile channels, one ``PreciseHistogram`` attribute each.
PRECISE_CHANNELS = (
    "transaction_certified_latency",
    "certificate_committed_latency",
    "transaction_committed_latency",
    "proposed_block_size_bytes",
    "proposed_block_transaction_count",
    "proposed_block_vote_count",
    "blocks_per_commit_count",
    "sub_dags_per_commit_count",
    "block_commit_latency",
    "quorum_receive_latency",
)


class PreciseHistogram:
    """Exact-percentile histogram over a reporting window (stat.rs:8-100).

    Within a reporting window the buffer is a uniform reservoir sample
    (Algorithm R) of every observation, so a window busier than
    ``max_samples`` still yields representative percentiles instead of
    freezing on its first ``max_samples`` arrivals (the warmup seconds, the
    worst possible sample).  ``count``/``sum`` stay cumulative; the reporter
    reads the percentiles and drains the window each sweep
    (metrics.rs:534-601).
    """

    __slots__ = ("samples", "count", "sum", "max_samples", "_window_count",
                 "_rng", "_np_rng")

    def __init__(self, max_samples: int = 100_000) -> None:
        import random

        self.samples: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.max_samples = max_samples
        self._window_count = 0
        self._rng = random.Random(0xC0FFEE)
        self._np_rng = None  # built lazily on the first batched observe

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self._window_count += 1
        if len(self.samples) < self.max_samples:
            self.samples.append(value)
        else:
            # Reservoir (Algorithm R): keep each of the window's n
            # observations with probability max_samples/n.
            j = self._rng.randrange(self._window_count)
            if j < self.max_samples:
                self.samples[j] = value

    def observe_many(self, values) -> None:
        """Vectorized observe over a numpy array (the commit path hands us
        thousands of samples per batch at load): one sum + one batched
        reservoir step instead of n Python calls."""
        n = len(values)
        if n == 0:
            return
        self.count += n
        self.sum += float(values.sum())
        cap = self.max_samples
        fill = min(cap - len(self.samples), n)
        if fill > 0:
            self.samples.extend(float(v) for v in values[:fill])
            self._window_count += fill
            values = values[fill:]
            n -= fill
        if n <= 0:
            return
        # Algorithm R, batched: the k-th remaining value is the
        # (window_count + k)-th of the window; it replaces a random slot
        # with probability cap / (window_count + k).  Slot draws are one
        # vectorized uniform per batch — a Python randrange per sample
        # measured 7% of a saturated node's core (round-5 profile).
        import numpy as np

        if self._np_rng is None:
            self._np_rng = np.random.default_rng(0xC0FFEE)
        idx = np.arange(self._window_count + 1, self._window_count + n + 1)
        self._window_count += n
        slots = (self._np_rng.random(n) * idx).astype(np.int64)
        hit = slots < cap
        for slot, value in zip(slots[hit], np.asarray(values)[hit]):
            self.samples[slot] = float(value)

    def pcts(self, pcts: Sequence[int]) -> Optional[Dict[int, float]]:
        if not self.samples:
            return None
        ordered = sorted(self.samples)
        out = {}
        for pct in pcts:
            idx = min(len(ordered) - 1, int(len(ordered) * pct / 100))
            out[pct] = ordered[idx]
        return out

    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def clear(self) -> None:
        self.samples.clear()
        self._window_count = 0


class _DigestFramesCollector:
    """``dataplane_digest_frames_total{threads}``, read at each collect from
    the extension's process-wide counts (``native._digest_frame_counts``):
    every ``Metrics`` of a process reports all of the process's frames."""

    @staticmethod
    def collect():
        from .native import native

        family = CounterMetricFamily(
            "dataplane_digest_frames_total",
            "frames the native block_digests hashed in this process, by the "
            "number of threads that hashed them (1 = the serial loop)",
            labels=("threads",),
        )
        if native is not None:  # the pure-Python fallback hashes no frame
            for threads, frames in sorted(native._digest_frame_counts().items()):
                family.add_metric((str(threads),), frames)
        yield family

    describe = collect


class Metrics:
    """Registers every series on a fresh registry."""

    def __init__(self, registry: Optional[CollectorRegistry] = None) -> None:
        self.registry = registry or CollectorRegistry()
        r = self.registry

        def counter(name, doc, labels=()):
            return Counter(name, doc, labelnames=labels, registry=r)

        def gauge(name, doc, labels=()):
            return Gauge(name, doc, labelnames=labels, registry=r)

        def histogram(name, doc, labels=(), buckets=STAGE_BUCKETS):
            return Histogram(name, doc, labelnames=labels, buckets=buckets, registry=r)

        # Benchmark-defining series (metrics.rs:31-33): the commit observer
        # and the block handlers' latency batches.
        self.benchmark_duration = counter(BENCHMARK_DURATION, "benchmark duration, s")
        self.latency_s = histogram(
            LATENCY_S, "end-to-end tx latency", labels=("workload",),
            buckets=LATENCY_SEC_BUCKETS,
        )
        self.latency_squared_s = counter(
            LATENCY_SQUARED_S, "sum of squared latencies", labels=("workload",)
        )
        # Scraped for the reference's inventory (metrics.rs:36-87; PARITY.md),
        # as the JAX package keeps them: no writer in either package.
        self.inter_block_latency_s = histogram(
            "inter_block_latency_s", "inter-block latency", labels=("workload",),
            buckets=LATENCY_SEC_BUCKETS,
        )
        self.ready_new_block = counter(
            "ready_new_block", "proposal readiness reasons", labels=("reason",)
        )
        self.block_store_entries = counter("block_store_entries", "stored blocks")
        self.wal_mappings = gauge("wal_mappings", "live mmap windows")
        self.commit_handler_pending_certificates = gauge(
            "commit_handler_pending_certificates", "pending commit certs"
        )
        self.block_sync_requests_sent = counter(
            "block_sync_requests_sent", "sync requests", labels=("peer",)
        )
        self.connected_nodes = gauge("connected_nodes", "live peer connections")

        # Consensus progress (syncer, commit observer).
        self.committed_leaders_total = counter(
            "committed_leaders_total", "decided leaders", labels=("authority", "status")
        )
        self.leader_timeout_total = counter("leader_timeout_total", "leader timeouts")
        self.threshold_clock_round = gauge("threshold_clock_round", "current round")
        self.commit_round = gauge("commit_round", "last committed round")

        # Block store and WAL (block_store.py; net_sync's WAL syncer thread).
        self.block_store_unloaded_blocks = counter(
            "block_store_unloaded_blocks", "cache evictions"
        )
        self.block_store_loaded_blocks = counter(
            "block_store_loaded_blocks", "wal reloads"
        )
        self.wal_size_bytes = gauge(
            "wal_size_bytes",
            "live write-ahead log bytes across all surviving segments "
            "(storage lifecycle: bounded by GC, not lifetime bytes written)",
        )
        # Storage lifecycle plane (storage.py).
        self.wal_segments = gauge(
            "wal_segments", "live WAL segment files (1 = single-file log)"
        )
        self.wal_reclaimed_bytes_total = counter(
            "wal_reclaimed_bytes_total",
            "WAL bytes deleted by segment garbage collection below the "
            "retired round floor",
        )
        self.checkpoint_last_commit_index = gauge(
            "checkpoint_last_commit_index",
            "commit height anchoring the newest durable checkpoint "
            "(recovery replays only WAL entries after it)",
        )

        # Epoch and committee (core.py).
        self.mysticeti_epoch = gauge(
            "mysticeti_epoch",
            "current consensus epoch (advances when a committed "
            "committee-change transaction derives a new committee)",
        )
        self.mysticeti_epoch_transitions_total = counter(
            "mysticeti_epoch_transitions_total",
            "epoch boundaries crossed since boot (commit-anchored committee "
            "switches, including those re-derived on recovery)",
        )
        self.mysticeti_committee_digest_info = gauge(
            "mysticeti_committee_digest_info",
            "info gauge naming the active committee: value is the epoch, "
            "label carries the committee digest prefix",
            labels=("digest",),
        )

        # Deterministic execution plane (execution.py): the account/transfer
        # state machine folded over the committed sequence.
        self.mysticeti_execution_txs_total = counter(
            "mysticeti_execution_txs_total",
            "execution transactions folded through the state machine by "
            "verdict: applied, or a typed deterministic reject "
            "(bad_nonce, insufficient_balance, unknown_account, "
            "account_exists) — rejects consume the commit slot but not "
            "account state",
            labels=("result",),
        )
        self.mysticeti_execution_height = gauge(
            "mysticeti_execution_height",
            "highest commit height folded through the execution state "
            "machine (trails the committed sequence by at most the "
            "in-flight syncer pass; a growing gap means the fold stalled)",
        )
        self.mysticeti_execution_accounts = gauge(
            "mysticeti_execution_accounts",
            "live accounts in the execution state machine's balance table "
            "(checkpoint tail size scales with this)",
        )

        # Core owner queue (core_task.CoreTaskDispatcher; core_lock_* in
        # metrics.rs:51-53).
        self.core_lock_enqueued = counter(
            "core_lock_enqueued", "commands submitted to the core owner"
        )
        self.core_lock_dequeued = counter(
            "core_lock_dequeued", "commands executed by the core owner"
        )

        # Handlers (block_handler.py).
        self.block_handler_pending_certificates = gauge(
            "block_handler_pending_certificates", "pending fast-path certs"
        )

        # Sync (block_manager, synchronizer, net_sync).
        self.missing_blocks_total = counter("missing_blocks_total", "missing refs seen")
        self.blocks_suspended = counter("blocks_suspended", "parked blocks")
        self.block_sync_requests_failed = counter(
            "block_sync_requests_failed", "refs peers did not have"
        )
        self.block_sync_requests_received = counter(
            "block_sync_requests_received", "sync requests served",
            labels=("peer",),
        )
        self.block_receive_latency = histogram(
            "block_receive_latency",
            "proposal-to-receipt latency of peer blocks",
            labels=("authority",), buckets=LATENCY_SEC_BUCKETS,
        )
        self.add_block_latency = histogram(
            "add_block_latency",
            "proposal-to-acceptance latency of peer blocks",
            labels=("authority",), buckets=LATENCY_SEC_BUCKETS,
        )
        self.dissemination_transit_seconds = histogram(
            "dissemination_transit_seconds",
            "one-way wire transit of block push frames from each peer, "
            "measured from the tag-12 sender timestamp (clamped at zero; "
            "the raw signed value rides in the trace for skew estimation)",
            labels=("peer",),
            buckets=[0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                     5.0],
        )
        # Flight recorder dumps (flight_recorder.py).
        self.flight_recorder_dumps_total = counter(
            "flight_recorder_dumps_total",
            "flight-recorder ring dumps written, by trigger (shutdown, "
            "slo-alert, safety-failure)",
            labels=("trigger",),
        )
        # Encode-once fan-out (synchronizer.FrameCache).
        self.dissemination_encode_reuse_total = counter(
            "dissemination_encode_reuse_total",
            "dissemination frames served from the shared frame cache "
            "instead of being rebuilt per subscriber (N subscribers at one "
            "cursor = 1 build + N-1 reuses)",
        )

        # Mesh transport (network.py): peer RTT, what the sockets carried,
        # the frames the write loop coalesced, and the sends backpressure
        # discarded.
        self.connection_latency = histogram(
            "connection_latency", "peer rtt", labels=("peer",),
            buckets=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0],
        )
        self.mesh_frames_coalesced_total = counter(
            "mesh_frames_coalesced_total",
            "mesh frames that shipped in the same scatter-gather "
            "writelines batch as an earlier frame (one syscall + one "
            "drain for the whole batch)",
        )
        self.mesh_wire_bytes_total = counter(
            "mesh_wire_bytes_total",
            "bytes moved over validator mesh sockets (headers + payloads)",
            labels=("direction",),
        )
        self.connection_send_drops_total = counter(
            "connection_send_drops_total",
            "non-blocking mesh sends discarded because the peer's bounded "
            "send queue was full (backpressure; previously silent)",
            labels=("peer",),
        )
        self.mysticeti_malformed_frames_total = counter(
            "mysticeti_malformed_frames_total",
            "malformed mesh frames (garbage length prefix, oversized "
            "frame, undecodable payload) that severed the delivering "
            "connection, by peer",
            labels=("peer",),
        )
        # Native data plane (native/mysticeti_native.cpp): which native
        # functions resolved in THIS process — an info series (value
        # constant 1) so a measurement can tell which path a run took.  The
        # "any" row is always present: 1 with the extension, 0 on the
        # pure-Python fallback (no toolchain, build failure,
        # MYSTICETI_NO_NATIVE=1).
        self.mysticeti_native_active = gauge(
            "mysticeti_native_active",
            "info series: native data-plane functions resolved (fn=any "
            "summarizes extension presence)",
            labels=("fn",),
        )
        from .native import active_functions

        active = active_functions()
        for fn in active:
            self.mysticeti_native_active.labels(fn).set(1)
        self.mysticeti_native_active.labels("any").set(1 if active else 0)
        # Batched decode+digest batches routed off the event loop
        # (core_task.DataPlaneOffload), timed in the offload worker.
        self.dataplane_offload_seconds = histogram(
            "dataplane_offload_seconds",
            "per-batch time in each data-plane offload stage, measured in "
            "the offload worker thread (queue wait excluded)",
            labels=("stage",),
        )
        # The port's split of the same offload stages (core_task.py, off the
        # simulator): the executor's queue wait before each batch starts,
        # and the worker's thread CPU over the batch.
        self.dataplane_offload_queue_seconds_total = counter(
            "dataplane_offload_queue_seconds_total",
            "seconds data-plane offload batches waited from submission to "
            "their start in the dataplane-offload worker, by stage",
            labels=("stage",),
        )
        self.dataplane_offload_cpu_seconds_total = counter(
            "dataplane_offload_cpu_seconds_total",
            "thread CPU seconds of the dataplane-offload worker over its "
            "batches, by stage (beside dataplane_offload_seconds' wall time)",
            labels=("stage",),
        )
        # Frames native.block_digests hashed, by the threads that hashed
        # them: counted in the extension, read at each collect.
        r.register(_DigestFramesCollector())
        # Signature verifier: the collector (block_validator.py); aggregate
        # mode counts its skipped and direct signatures under
        # backend="aggregate".
        self.verified_signatures_total = counter(
            "verified_signatures_total", "batched signature verifications",
            labels=("backend", "outcome"),
        )
        self.verify_batch_size = histogram(
            "verify_batch_size", "signature batch sizes", buckets=BATCH_BUCKETS,
        )
        self.verify_dispatch_batch_size = histogram(
            "verify_dispatch_batch_size",
            "signatures per ACTUAL backend dispatch (after aggregation "
            "skips; verify_batch_size is the collector flush size)",
            buckets=BATCH_BUCKETS,
        )
        self.verify_padding_wasted_total = counter(
            "verify_padding_wasted_total",
            "padding lanes dispatched (padded bucket size minus actual "
            "signatures)", labels=("backend",),
        )
        self.verify_collector_window_seconds = gauge(
            "verify_collector_window_seconds",
            "collection window the batching collector last armed "
            "(arrival-rate-adaptive, ceilinged by the dispatch-cost window)",
        )
        # The hybrid router (block_validator.HybridSignatureVerifier).
        self.verify_route_total = counter(
            "verify_route_total", "hybrid router decisions", labels=("route",)
        )
        self.verify_route_estimate_error_s = histogram(
            "verify_route_estimate_error_s",
            "|estimated - actual| dispatch time of routed batches",
            buckets=[0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0],
        )
        self.verify_shortcircuit_total = counter(
            "verify_shortcircuit_total",
            "signature batches completed without touching the verifier "
            "service socket (reason: backend-cpu = service advertised a "
            "CPU-only backend, router = cost model chose the in-process "
            "oracle, breaker = circuit open)",
            labels=("reason",),
        )
        self.verifier_fallback_total = counter(
            "verifier_fallback_total",
            "signature batches degraded to the CPU oracle because the "
            "accelerator path was unavailable (circuit breaker open or "
            "dispatch failed)",
        )
        # The verifier service (verifier_service.py) and its client.
        self.verifier_service_queue_depth = gauge(
            "verifier_service_queue_depth",
            "verify requests queued or dispatching in the verifier service",
        )
        self.verifier_service_inflight = gauge(
            "verifier_service_inflight",
            "in-flight verify requests per service client connection",
            labels=("connection",),
        )
        self.verify_wire_bytes_total = counter(
            "verify_wire_bytes_total",
            "bytes moved over the verifier-service socket by this client",
            labels=("direction",),
        )
        self.verifier_reconnect_total = counter(
            "verifier_reconnect_total",
            "verifier-service client connections torn down and retried",
        )

        # Fleet health plane (health.py): consensus-level health signals
        # derived from state the node already has, refreshed by the
        # HealthProbe sampler; the same probe serves the /health diagnosis
        # document next to /healthz.
        self.mysticeti_health_round_advance_rate = gauge(
            "mysticeti_health_round_advance_rate",
            "threshold-clock rounds advanced per second (EMA over probe "
            "samples)",
        )
        self.mysticeti_health_commit_rate = gauge(
            "mysticeti_health_commit_rate",
            "committed sub-dags per second (EMA over probe samples)",
        )
        self.mysticeti_health_frontier_skew_rounds = gauge(
            "mysticeti_health_frontier_skew_rounds",
            "DAG frontier skew: max peer round seen minus own round "
            "(positive = this node is behind the fleet)",
        )
        self.mysticeti_health_authority_lag_rounds = gauge(
            "mysticeti_health_authority_lag_rounds",
            "per-authority frontier lag: own round minus the authority's "
            "last block round seen here (a growing lag names the straggler)",
            labels=("authority",),
        )
        self.mysticeti_health_verifier_breaker_open = gauge(
            "mysticeti_health_verifier_breaker_open",
            "1 while the hybrid verifier circuit breaker is open (degraded "
            "to the CPU oracle)",
        )
        self.mysticeti_health_verifier_pinned = gauge(
            "mysticeti_health_verifier_pinned",
            "1 while short-circuit routing is pinned to the in-process "
            "oracle (service advertised a CPU-only backend)",
        )
        self.mysticeti_health_wal_backlog = gauge(
            "mysticeti_health_wal_backlog",
            "1 while acknowledged WAL appends are still queued in process "
            "memory (the async drain is behind)",
        )
        self.mysticeti_health_status = gauge(
            "mysticeti_health_status",
            "1 when no SLO alert is firing, 0 while degraded (the /health "
            "readiness verdict)",
        )
        self.mysticeti_health_slo_alerts_total = counter(
            "mysticeti_health_slo_alerts_total",
            "SLO watchdog alerts raised, named by kind, the indicted "
            "authority (empty = whole node), and the pipeline stage",
            labels=("kind", "authority", "stage"),
        )
        self.commit_critical_path_seconds = histogram(
            "commit_critical_path_seconds",
            "per committed leader: time each pipeline stage spent on the "
            "receive->verify->dag_add->proposal_wait->commit->finalize "
            "critical path (requires span tracing; see health.py)",
            labels=("stage",),
            buckets=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     5.0, 10.0, 30.0],
        )

        # Host attribution plane (profiling.py accountant + hostattr.py):
        # where host time goes, per subsystem, and what the event loop pays
        # for it.  The cpu-seconds counter is fed by the sampling profiler's
        # census; the loop-lag / blocking-call / convoy series by a started
        # HostMonitor.
        self.mysticeti_cpu_seconds_total = counter(
            "mysticeti_cpu_seconds_total",
            "sampled CPU seconds attributed to each subsystem of the "
            "declarative registry (profiling.SUBSYSTEMS), split by thread "
            "class (loop / verifier / wal / aux)",
            labels=("subsystem", "thread_class"),
        )
        self.mysticeti_cpu_us_per_leader = gauge(
            "mysticeti_cpu_us_per_leader",
            "per-committed-leader normalized subsystem cost: sampled CPU "
            "microseconds per committed leader (the PERF_ATTR budget rows)",
            labels=("subsystem",),
        )
        self.mysticeti_loop_lag_seconds = histogram(
            "mysticeti_loop_lag_seconds",
            "asyncio loop scheduling lag: scheduled-vs-actual callback "
            "delta of the loop-lag probe (hostattr.LoopLagProbe)",
            buckets=[0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.5],
        )
        self.mysticeti_loop_lag_p99_seconds = gauge(
            "mysticeti_loop_lag_p99_seconds",
            "p99 loop scheduling lag over the probe's bounded window (the "
            "loop-lag SLO watchdog input; fleetmon dashboard column)",
        )
        self.mysticeti_gil_convoy_ratio = gauge(
            "mysticeti_gil_convoy_ratio",
            "fraction of census ticks where >=2 threads were runnable at "
            "once — with one interpreter lock, a proxy for GIL convoying",
        )
        self.mysticeti_blocking_calls_total = counter(
            "mysticeti_blocking_calls_total",
            "synchronous core-owner commands that held the event loop past "
            "MYSTICETI_BLOCKING_CALL_MS (the dynamic twin of the "
            "async-blocking lint rule), by command site",
            labels=("site",),
        )
        self.mysticeti_blocking_call_last_ms = gauge(
            "mysticeti_blocking_call_last_ms",
            "duration of the most recent detected blocking call, ms",
        )
        # Staged dispatch pipeline (verify_pipeline.py): how full the window
        # runs and where each dispatch's time goes.
        self.verify_pipeline_inflight = gauge(
            "verify_pipeline_inflight",
            "signature dispatches currently in flight through the staged "
            "verify pipeline (bounded by verify_pipeline_depth)",
        )
        self.verify_pipeline_depth = gauge(
            "verify_pipeline_depth",
            "current bounded in-flight window of the verify pipeline "
            "(occupancy = verify_pipeline_inflight / verify_pipeline_depth)",
        )
        self.verify_pipeline_stage_seconds = histogram(
            "verify_pipeline_stage_seconds",
            "per-dispatch time in each verify pipeline stage",
            labels=("stage",),
        )
        # The port's splits of a collector dispatch (block_validator.py, off
        # the simulator): thread CPU beside the stage seconds, the kernels'
        # device time (traced dispatches only), and the blocks' wait in the
        # collector.
        self.verify_pipeline_stage_cpu_seconds_total = counter(
            "verify_pipeline_stage_cpu_seconds_total",
            "thread CPU seconds of the verify pipeline's stages: pack on the "
            "loop thread, device (the submit call) and fetch (the result "
            "call) in the executor thread that runs them",
            labels=("stage",),
        )
        self.verify_device_seconds_total = counter(
            "verify_device_seconds_total",
            "device seconds of the verify kernels a traced collector "
            "dispatch launched on a CUDA device, from CUDA event pairs around "
            "each launch, read once its result is fetched",
        )
        self.verify_collector_wait_seconds_total = counter(
            "verify_collector_wait_seconds_total",
            "seconds blocks waited in the collector, from verify() to their "
            "flush's submission to the executor (collection window plus "
            "pipeline slot), summed over blocks; its count is "
            "verify_batch_size_sum",
        )
        self.mysticeti_verify_occupancy_fraction = gauge(
            "mysticeti_verify_occupancy_fraction",
            "fraction of cumulative verify-dispatch time in each phase "
            "(device = device-busy, pack = host packing, fetch = "
            "result-wait), from the verify_pipeline stage timers",
            labels=("phase",),
        )
        # Device attribution (ops/ed25519.py install_device_attribution):
        # the kernels' nvcc builds stand where the JAX package counts its
        # compiles and compile-cache hits and misses.
        self.mysticeti_cuda_builds_total = counter(
            "mysticeti_cuda_builds_total",
            "CUDA kernel sources compiled by nvcc in this process (a "
            "climbing counter mid-run means a library went missing)",
        )
        self.mysticeti_cuda_build_seconds_total = counter(
            "mysticeti_cuda_build_seconds_total",
            "cumulative seconds of the nvcc builds, each from the start of "
            "its parallel build",
        )
        self.mysticeti_cuda_build_cache_hits_total = counter(
            "mysticeti_cuda_build_cache_hits_total",
            "kernel libraries found built on disk (loaded instead of "
            "rebuilt)",
        )
        self.mysticeti_cuda_build_cache_misses_total = counter(
            "mysticeti_cuda_build_cache_misses_total",
            "kernel libraries missing on disk (full nvcc build paid)",
        )
        self.mysticeti_device_transfer_bytes_total = counter(
            "mysticeti_device_transfer_bytes_total",
            "bytes moved between host and device on the verifier hot path "
            "(to_device = packed signature blobs, from_device = verdict "
            "fetches)",
            labels=("direction",),
        )
        # Leader timeouts attributed to the stalled slot's authority
        # (syncer.py).
        self.mysticeti_health_leader_timeout_total = counter(
            "mysticeti_health_leader_timeout_total",
            "leader timeouts attributed to the authority whose leader slot "
            "stalled the round",
            labels=("authority",),
        )
        # The block handler's deferred proposals and vote-aggregator dedup.
        self.mysticeti_ingress_shed_total = counter(
            "mysticeti_ingress_shed_total",
            "transactions refused (or deferred) by the ingress plane, by "
            "reason: admission (AIMD rate), mempool_transactions / "
            "mempool_bytes (pool caps), lane_cap (per-client fairness "
            "lane), duplicate (dedup window), notify_backpressure (commit "
            "notifications a slow gateway client lost), soft_cap_deferred "
            "(re-queued for the NEXT proposal — deferred, not lost)",
            labels=("reason",),
        )
        self.mysticeti_ingress_admitted_total = counter(
            "mysticeti_ingress_admitted_total",
            "transactions admitted into the mempool (offered = admitted + "
            "shed, per the typed SubmitResult contract)",
        )
        self.mysticeti_ingress_admitted_rate = gauge(
            "mysticeti_ingress_admitted_rate",
            "current AIMD-admitted transaction rate ceiling (tx/s) — cut "
            "multiplicatively on core congestion, raised additively while "
            "healthy",
        )
        self.mysticeti_ingress_mempool_transactions = gauge(
            "mysticeti_ingress_mempool_transactions",
            "transactions pending in the bounded ingress mempool",
        )
        self.mysticeti_ingress_mempool_bytes = gauge(
            "mysticeti_ingress_mempool_bytes",
            "bytes pending in the bounded ingress mempool",
        )
        self.mysticeti_ingress_shed_mode = gauge(
            "mysticeti_ingress_shed_mode",
            "1 while the admission controller is in shed mode (congestion "
            "detected; transitions land in the flight recorder)",
        )
        self.mysticeti_ingress_gateway_clients = gauge(
            "mysticeti_ingress_gateway_clients",
            "live client connections on the ingress gateway listener",
        )
        self.mysticeti_transaction_dedup_total = counter(
            "mysticeti_transaction_dedup_total",
            "duplicate/unknown transaction observations in the fast-path "
            "vote aggregator (previously log lines only)",
            labels=("kind",),
        )
        # Consensus decision ledger (decisions.py).
        self.mysticeti_commit_decision_total = counter(
            "mysticeti_commit_decision_total",
            "leader-slot decisions recorded by the decision ledger, by the "
            "rule that decided (direct = blames/certificates in the slot's "
            "own wave, indirect = a committed anchor one wave ahead) and "
            "outcome (commit | skip); each decided slot counts exactly once",
            labels=("rule", "outcome"),
        )
        self.mysticeti_decision_rounds_behind = histogram(
            "mysticeti_decision_rounds_behind",
            "how many rounds behind the DAG frontier a leader slot was when "
            "it decided (direct decisions sit near wave_length - 1; large "
            "values mean slots lingered undecided and resolved indirectly)",
            buckets=[2.0, 3.0, 4.0, 6.0, 9.0, 15.0, 30.0, 60.0, 120.0],
        )
        # Recovery and the receive path's attribution (core, block_store,
        # net_sync).
        self.crash_recovery_total = counter(
            "crash_recovery_total",
            "node boots that recovered state by replaying a non-empty WAL",
        )
        self.chaos_faults_total = counter(
            "chaos_faults_total",
            "faults injected by the deterministic chaos engine",
            labels=("kind",),
        )
        self.mysticeti_equivocation_detected_total = counter(
            "mysticeti_equivocation_detected_total",
            "distinct conflicting blocks observed at one (authority, round) "
            "in the DAG index — a double proposal, attributed to the "
            "equivocating authority (includes the benign post-torn-tail "
            "self-equivocation; each extra digest counts once)",
            labels=("authority",),
        )
        self.mysticeti_invalid_blocks_total = counter(
            "mysticeti_invalid_blocks_total",
            "blocks rejected on the receive path, attributed by authority "
            "and reason: signature (verifier rejected the Ed25519 check), "
            "structure (consensus-rule check failed; attributed to the "
            "claimed author), malformed (undecodable block bytes; "
            "attributed to the DELIVERING peer)",
            labels=("authority", "reason"),
        )
        # Determinism sanitizer plane (detsan.py): wall-clock reads reaching
        # package code while the deterministic virtual-time loop is running.
        # MUST stay zero in any healthy sim — a non-zero count is a
        # reproducibility leak, attributed to the reading call-site
        # (module:line).
        self.mysticeti_detsan_wallclock_reads_total = counter(
            "mysticeti_detsan_wallclock_reads_total",
            "un-gated time.monotonic()/time()/perf_counter() reads from "
            "package code under simulation, caught by the detsan tripwire "
            "(strict mode raises WallClockLeak instead), by call-site",
            labels=("site",),
        )
        self.mysticeti_leader_wait_skipped_total = counter(
            "mysticeti_leader_wait_skipped_total",
            "proposal-gating waits skipped because the round's leader had "
            "not produced a locally-accepted block within the liveness "
            "horizon (crashed, withholding, or signing invalidly), by the "
            "leader waited-for",
            labels=("authority",),
        )
        # Utilization timers (metrics.rs:615-666).
        self.utilization_timer_us = counter(
            "utilization_timer", "busy time per section, us", labels=("proc",)
        )

        # Client-perceived finality SLI plane (finality.py): the gateway's
        # 16-byte ingress keys joined across the transaction lifecycle.
        self.mysticeti_e2e_finality_seconds = histogram(
            "mysticeti_e2e_finality_seconds",
            "phase-split end-to-end finality latency for count-sampled "
            "ingress keys: admission (submit -> mempool accept), proposal "
            "(accept -> drained into a block proposal), commit (proposal -> "
            "leader sequence commit), finalize (commit -> observer "
            "finalized), execute (finalized -> execution state machine "
            "folded the commit), notify (finalized/executed -> gateway "
            "notification queued), total (submit -> finalized, or submit -> "
            "EXECUTED when the execution plane is on)",
            labels=("phase",),
            buckets=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     5.0, 10.0, 30.0],
        )
        self.mysticeti_e2e_finality_p50_seconds = gauge(
            "mysticeti_e2e_finality_p50_seconds",
            "rolling p50 of sampled submit -> finalized latency (exact over "
            "the finality tracker's recent-sample window; feeds fleetmon)",
        )
        self.mysticeti_e2e_finality_p99_seconds = gauge(
            "mysticeti_e2e_finality_p99_seconds",
            "rolling p99 of sampled submit -> finalized latency — the "
            "finality-p99 SLO watchdog input and the fleetmon readiness "
            "gate column",
        )
        self.mysticeti_client_finality_p50_seconds = gauge(
            "mysticeti_client_finality_p50_seconds",
            "rolling p50 of CLIENT-observed submit -> commit-notification "
            "latency from closed-loop generators (cross-checks the "
            "server-side series in one artifact)",
        )
        self.mysticeti_client_finality_p99_seconds = gauge(
            "mysticeti_client_finality_p99_seconds",
            "rolling p99 of CLIENT-observed submit -> commit-notification "
            "latency from closed-loop generators",
        )
        # The client side of offered = admitted + shed: what the node's load
        # generator handed its ingress plane.
        self.mysticeti_client_submitted_total = counter(
            "mysticeti_client_submitted_total",
            "transactions the node's load generator submitted to its ingress "
            "(retries included): admitted + shed at intake",
        )

        # Exact-percentile channels (stat.rs), reported as gauges.
        self._precise: Dict[str, PreciseHistogram] = {}
        self._pct_gauge = gauge(
            "histogram_pct", "exact percentiles", labels=("name", "pct")
        )
        for name in PRECISE_CHANNELS:
            self._precise[name] = PreciseHistogram()
            setattr(self, name, self._precise[name])

    def observe_latency_batch(self, workload: str, latencies) -> None:
        """Vectorized ``latency_s.observe`` + ``latency_squared_s.inc`` over a
        numpy array of samples — one bucket-count pass instead of a labels()
        lookup and a 16-bucket walk per transaction (the per-tx path dominated
        the commit observer at load).  Falls back to the plain loop if the
        prometheus_client internals ever change shape.
        """
        import numpy as np

        key = ("latency_batch", workload)
        cached = self.__dict__.get(key)
        if cached is None:
            cached = (
                self.latency_s.labels(workload),
                self.latency_squared_s.labels(workload),
            )
            self.__dict__[key] = cached
        hist, squared = cached
        squared.inc(float(np.square(latencies).sum()))
        try:
            ubs = hist._upper_bounds  # finite bounds + +Inf last
            buckets = hist._buckets
            total = hist._sum
        except AttributeError:  # pragma: no cover - client internals moved
            for v in latencies:
                hist.observe(float(v))
            return
        # le-semantics: first upper bound >= sample (side="left" keeps
        # boundary samples in their bucket, matching observe()).
        idx = np.searchsorted(np.asarray(ubs[:-1]), latencies, side="left")
        counts = np.bincount(idx, minlength=len(ubs))
        for i, c in enumerate(counts):
            if c:
                buckets[i].inc(int(c))
        total.inc(float(latencies.sum()))

    @contextmanager
    def utilization_timer(self, proc: str):
        """Drop-guard busy counter."""
        start = time.monotonic()
        try:
            yield
        finally:
            self.utilization_timer_us.labels(proc).inc(
                int((time.monotonic() - start) * 1e6)
            )

    def report_precise(self) -> None:
        """One reporter sweep: publish exact percentiles, then DRAIN
        (metrics.rs:534-601 — the reference's histogram channel empties per
        sweep, so gauges track the last window; a quiet window keeps the
        previous published value)."""
        for name, hist in self._precise.items():
            pcts = hist.pcts((50, 90, 99))
            if pcts is None:
                continue
            for pct, value in pcts.items():
                self._pct_gauge.labels(name, str(pct)).set(value)
            hist.clear()

    def expose(self) -> bytes:
        return generate_latest(self.registry)


class MetricReporter:
    """Periodic exact-percentile publisher (metrics.rs:534-601, 60 s cadence)."""

    def __init__(self, metrics: Metrics, interval_s: float = 60.0) -> None:
        self.metrics = metrics
        self.interval_s = interval_s
        self._task: Optional[asyncio.Task] = None

    def start(self) -> "MetricReporter":
        self._task = spawn_logged(self._run(), log, name="metric-reporter")
        return self

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            self.metrics.report_precise()

    def stop(self, final: bool = False) -> None:
        """Cancel the periodic task; ``final=True`` publishes one last
        percentile sweep so an orderly shutdown never loses the window that
        accumulated since the previous 60 s tick (short runs lose their
        ENTIRE sample set without it)."""
        if self._task is not None:
            self._task.cancel()
        if final:
            self.metrics.report_precise()


async def serve_metrics(metrics: Metrics, host: str, port: int,
                        health_probe=None, flight_recorder=None,
                        consensus_debug=None):
    """Minimal asyncio HTTP endpoint: ``/metrics`` for the scraper,
    ``/healthz`` (200 + uptime) for liveness probes, and — when a
    :class:`~mysticeti_tpu_torch.health.HealthProbe` is wired — ``/health``,
    the readiness/diagnosis JSON document (503 while an SLO alert is firing,
    so the route doubles as a readiness gate).  With a
    :class:`~mysticeti_tpu_torch.flight_recorder.FlightRecorder` wired,
    ``/debug/flight-recorder`` serves the live event-ring dump (the same
    canonical document the SIGTERM/alert dumps write).  ``consensus_debug``
    is a zero-arg callable returning the live consensus-state document (DAG
    frontier, undecided slots, threshold-clock round, last-K decision
    records) served on ``/debug/consensus``."""
    import json as _json

    started = time.monotonic()

    async def handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request = await reader.readline()  # e.g. b"GET /healthz HTTP/1.1"
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request.split()
            path = parts[1].decode(errors="replace") if len(parts) > 1 else "/"
            status = b"200 OK"
            if path.split("?", 1)[0] == "/healthz":
                body = (
                    '{"status":"ok","uptime_s":%.3f}\n'
                    % (time.monotonic() - started)
                ).encode()
                content_type = b"application/json"
            elif (
                path.split("?", 1)[0] == "/debug/flight-recorder"
                and flight_recorder is not None
            ):
                body = flight_recorder.snapshot_bytes() + b"\n"
                content_type = b"application/json"
            elif (
                path.split("?", 1)[0] == "/debug/consensus"
                and consensus_debug is not None
            ):
                doc = consensus_debug()
                body = (_json.dumps(doc, sort_keys=True) + "\n").encode()
                content_type = b"application/json"
            elif path.split("?", 1)[0] == "/health" and health_probe is not None:
                doc = health_probe.diagnosis()
                body = (_json.dumps(doc, sort_keys=True) + "\n").encode()
                content_type = b"application/json"
                if doc.get("status") != "ok":
                    status = b"503 Service Unavailable"
            else:
                # Anything else serves the scrape.
                body = metrics.expose()
                content_type = b"text/plain; version=0.0.4"
            writer.write(
                b"HTTP/1.1 " + status + b"\r\nContent-Type: " + content_type
                + b"\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode()
                + body
            )
            await writer.drain()
        finally:
            writer.close()

    return await asyncio.start_server(handle, host=host, port=port)
