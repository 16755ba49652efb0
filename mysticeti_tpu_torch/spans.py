"""Per-block span recording: the part of ``mysticeti_tpu.spans`` the verifier
needs.

The batching collector (block_validator.py) records, per dispatched block,
the staged pipeline's sub-stages when a tracer is active:

    verify_pack      host packing of the dispatch
    verify_device    non-blocking submission (kernels queued on the stream)
    verify_fetch     the result fetch (waits for the kernels)
    verify_dispatch  the whole dispatch

Spans are clocked by :func:`mysticeti_tpu_torch.runtime.now`.  The Chrome
trace export, the periodic flusher and the fleet merge are not carried over:
a tracer here keeps its spans in memory (``SpanTracer.events``).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from .runtime import now as runtime_now

STAGES = ("verify_pack", "verify_device", "verify_fetch", "verify_dispatch")


def format_ref(ref) -> str:
    """Stable human-readable block-reference label."""
    return f"A{ref.authority}R{ref.round}#{ref.digest[:4].hex()}"


class SpanTracer:
    """Collects completed (stage, block label, t0, t1) spans; thread-safe."""

    MAX_EVENTS = 1_000_000  # beyond the cap new spans are counted, not kept

    def __init__(self) -> None:
        self.events: List[Tuple[str, str, float, float]] = []
        self.dropped = 0
        self._lock = threading.Lock()

    @staticmethod
    def now() -> float:
        return runtime_now()

    def record_span(self, stage: str, ref, t0: float, t1: Optional[float] = None) -> None:
        """Append a completed span measured by the caller."""
        if stage not in STAGES:
            raise ValueError(f"unregistered span stage {stage!r}")
        if t1 is None:
            t1 = runtime_now()
        with self._lock:
            if len(self.events) >= self.MAX_EVENTS:
                self.dropped += 1
                return
            self.events.append((stage, format_ref(ref), t0, t1))


_active: Optional[SpanTracer] = None


def active() -> Optional[SpanTracer]:
    """The live tracer, or None when tracing is off."""
    return _active


def install(tracer: Optional[SpanTracer]) -> Optional[SpanTracer]:
    """Make ``tracer`` the live one (None turns tracing off); returns the
    previous tracer."""
    global _active
    previous, _active = _active, tracer
    return previous
