"""Observability: the verifier's prometheus series, busy timers, /metrics.

The port's copy of ``mysticeti_tpu.metrics``, trimmed to the series the
port's modules write: the batching collector and its staged pipeline, the
hybrid router, the verifier service and its client, and the device
attribution of ``ops/ed25519.py``.  Every family keeps the JAX package's
name, labels and buckets, except the JAX compile and compile-cache families,
which become the kernels' build families (``mysticeti_cuda_build*``, see
``ops.ed25519.install_device_attribution``).  The consensus, storage,
network and ingress families, the exact-percentile histograms and the
native data plane's ``mysticeti_native_active`` gauge wait for the modules
that write them.
"""
from __future__ import annotations

import asyncio
import time
from contextlib import contextmanager
from typing import Optional

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

STAGE_BUCKETS = [0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0]
BATCH_BUCKETS = [1, 8, 32, 64, 128, 256, 512, 1024, 4096]


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

        # Signature verifier: the collector (block_validator.py).
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
        # Utilization timers.
        self.utilization_timer_us = counter(
            "utilization_timer", "busy time per section, us", labels=("proc",)
        )

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

    def expose(self) -> bytes:
        return generate_latest(self.registry)


async def serve_metrics(metrics: Metrics, host: str, port: int):
    """Minimal asyncio HTTP endpoint: ``/healthz`` (200 + uptime) for
    liveness probes, anything else the ``/metrics`` scrape."""
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
            if path.split("?", 1)[0] == "/healthz":
                body = (
                    '{"status":"ok","uptime_s":%.3f}\n'
                    % (time.monotonic() - started)
                ).encode()
                content_type = b"application/json"
            else:
                body = metrics.expose()
                content_type = b"text/plain; version=0.0.4"
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: " + content_type + b"\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode()
                + body
            )
            await writer.drain()
        finally:
            writer.close()

    return await asyncio.start_server(handle, host=host, port=port)
