"""Node assembly: for now only the signature-verifier choice.

The port's counterpart of ``mysticeti_tpu.validator._make_verifier``.  The
rest of the node (storage, core, network, metrics endpoint) is not carried
over yet.  Kinds:

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
"""
from __future__ import annotations

import os
import threading

from .block_validator import (
    AcceptAllBlockVerifier,
    BatchedSignatureVerifier,
    CpuSignatureVerifier,
    HybridSignatureVerifier,
    TorchSignatureVerifier,
)
from .committee import Committee

ACCELERATOR_KIND = "cuda-only"
HYBRID_KIND = "cuda"


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
