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

On a host with several cards both accelerator kinds shard each batch over
them (``TorchSignatureVerifier(mesh="auto")``).  The aggregate kinds
(``-agg``) and the shared verifier service are not carried over.
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


def _make_verifier(kind: str, committee: Committee, device=None):
    """Signature verification is ON by default; "accept" is an explicit
    escape hatch.  ``device`` places the accelerator kind's tensors (default
    ``cuda``, which raises without a card; ``"cpu"`` runs the kernels' plain
    versions).

    The returned verifier carries a ``ready`` threading.Event: set once its
    one-time warmup is done (immediately for cpu/accept; after the kernels'
    build and first launches for the accelerator kind)."""
    ready = threading.Event()
    window_ms = float(os.environ.get("MYSTICETI_VERIFY_WINDOW_MS", "5"))
    depth_env = os.environ.get("MYSTICETI_VERIFY_PIPELINE_DEPTH")
    collector_opts = dict(
        max_delay_s=window_ms / 1e3,
        pipeline_depth=int(depth_env) if depth_env else None,
    )
    if kind in (HYBRID_KIND, ACCELERATOR_KIND):
        backend = TorchSignatureVerifier(
            committee_keys=committee.public_key_bytes(), device=device
        )
        if kind == HYBRID_KIND:
            # Small batches take the CPU oracle, sparing them the dispatch
            # latency; "cuda-only" pins every batch to the kernels.
            backend = HybridSignatureVerifier(tpu=backend)

        def _warm() -> None:
            # Build the kernels, upload the combs and (hybrid) calibrate both
            # routes off the hot path: blocks arriving meanwhile queue in the
            # batching collector.
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
