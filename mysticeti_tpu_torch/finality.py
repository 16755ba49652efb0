"""Client-perceived finality SLI plane: submit → finalized, phase by phase.

The port's copy of ``mysticeti_tpu.finality``.

The ingress plane (ingress.py) already names every transaction with a 16-byte
BLAKE2b key (``ingress_key``) for dedup and commit notifications.  This
module joins those keys across the transaction lifecycle to measure what a
client actually experiences — the latency-to-finality number the paper
leads with (arXiv 2310.14821) — split into the phases a regression can
hide in:

=============  =====================================================
phase          interval
=============  =====================================================
``admission``  gateway/handler submit → mempool accept
``proposal``   mempool accept → drained into a block proposal
``commit``     proposal inclusion → leader-sequence commit decision
``finalize``   commit decision → commit observer finalized the subdag
``execute``    finalized → execution state machine folded the commit
``notify``     finalized/executed → gateway commit notification queued
``total``      submit → finalized — or submit → EXECUTED when the
               execution plane is on (``execute_expected``): finality
               then means results, not sequencing
=============  =====================================================

Cost is bounded by *content-based count sampling*: a key participates iff
``key_sampled(key, every)`` — a pure function of the key bytes — so every
node samples the SAME transactions without coordination, the sampled set
is deterministic under the seeded simulator, and the per-transaction hot
path cost for unsampled keys is one modulo.

Exports ``mysticeti_e2e_finality_seconds{phase}`` histograms plus rolling
``p50/p99`` gauges (exact percentiles over a bounded recent-sample window,
refreshed from the ingress tick), feeds the ``finality-p99`` SLO watchdog
via :meth:`FinalityTracker.state`, and cross-checks against the
CLIENT-observed numbers the closed-loop ``TransactionGenerator`` records.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, Iterable, List, Optional

import threading

from .runtime import now as runtime_now

# Pending-entry cap: sampled keys awaiting commit.  At sample_every=16 and
# 100k tx/s offered, ~6k sampled keys/s enter; 8192 pending bounds memory
# while surviving multi-second commit latency at that extreme.
DEFAULT_PENDING_CAP = 8192
# Recent-sample window for the exact p50/p99 gauges.
DEFAULT_SAMPLE_WINDOW = 512

PHASES = (
    "admission", "proposal", "commit", "finalize", "execute", "notify",
    "total",
)


def key_sampled(key: bytes, every: int) -> bool:
    """Deterministic content-based sampling decision for one ingress key.

    Uses the key's first two bytes (already uniform — BLAKE2b output) so
    all nodes and the client generators agree on the sampled set without
    coordination.
    """
    if every <= 1:
        return True
    return int.from_bytes(key[:2], "little") % every == 0


def percentile(samples: List[float], q: float) -> float:
    """Exact nearest-rank percentile over a small sample list (0 if empty)."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    rank = min(len(ordered) - 1, max(0, int(q * len(ordered))))
    return ordered[rank]


class FinalityTracker:
    """Per-node submit→finality phase joiner over sampled ingress keys."""

    def __init__(
        self,
        metrics=None,
        sample_every: int = 16,
        pending_cap: int = DEFAULT_PENDING_CAP,
        sample_window: int = DEFAULT_SAMPLE_WINDOW,
        clock=runtime_now,
    ) -> None:
        self.metrics = metrics
        self.sample_every = max(1, sample_every)
        self.pending_cap = max(16, pending_cap)
        self.clock = clock
        self._finality_lock = threading.Lock()
        # Guarded by _finality_lock (lint GUARDED_FIELDS): stamps arrive
        # from the submit path, the proposal drain, and the commit
        # observer, while the ingress tick reads percentiles.
        self._finality_pending: "OrderedDict[bytes, Dict[str, float]]" = (
            OrderedDict()
        )
        self._finality_samples: Deque[float] = deque(maxlen=sample_window)
        self.completed = 0
        self.expired = 0
        # Execution-backed finality: set by the ingress plane when the core
        # runs the execution state machine.  The ``total`` SLI then closes
        # at :meth:`on_execute` (results), not :meth:`on_commit`
        # (sequencing).
        self.execute_expected = False

    def sampled(self, key: bytes) -> bool:
        return key_sampled(key, self.sample_every)

    def _observe(self, phase: str, seconds: float) -> None:
        if self.metrics is not None:
            self.metrics.mysticeti_e2e_finality_seconds.labels(phase).observe(
                max(0.0, seconds)
            )

    # -- lifecycle stamps (all tolerate unknown/unsampled keys) --

    def on_submit(self, key: bytes, t_submit: float, t_admitted: float) -> None:
        """A sampled key was admitted into the mempool."""
        self._observe("admission", t_admitted - t_submit)
        with self._finality_lock:
            self._finality_pending[key] = {
                "submit": t_submit,
                "admitted": t_admitted,
            }
            while len(self._finality_pending) > self.pending_cap:
                self._finality_pending.popitem(last=False)
                self.expired += 1

    def on_proposal(self, key: bytes, t: float) -> None:
        """A sampled key was drained into a block proposal."""
        with self._finality_lock:
            entry = self._finality_pending.get(key)
            if entry is None or "proposal" in entry:
                return
            entry["proposal"] = t
            admitted = entry["admitted"]
        self._observe("proposal", t - admitted)

    def on_commit(self, key: bytes, t_commit: float, t_finalize: float) -> None:
        """A sampled key's transaction was committed (``t_commit`` = the
        commit decision, from the observer's entry clock) and finalized
        (``t_finalize`` = observer completion).  Completes the ``total``
        sample — unless ``execute_expected``, in which case the total
        waits for :meth:`on_execute`; either way the entry stays so later
        execute/notify stamps can close their phases."""
        with self._finality_lock:
            entry = self._finality_pending.get(key)
            if entry is None or "finalize" in entry:
                return
            entry["finalize"] = t_finalize
            submit = entry["submit"]
            upstream = entry.get("proposal", entry["admitted"])
            total = t_finalize - submit
            if not self.execute_expected:
                self._finality_samples.append(max(0.0, total))
                self.completed += 1
        self._observe("commit", t_commit - upstream)
        self._observe("finalize", t_finalize - t_commit)
        if not self.execute_expected:
            self._observe("total", total)

    def on_execute(self, keys: Iterable[bytes], t: float) -> None:
        """Sampled keys' transactions were folded through the execution
        state machine.  With the execution plane on this is where the
        headline ``total`` SLI closes: a client waiting on the EXECUTED
        notification waited for results, not sequencing."""
        phases: List[float] = []
        totals: List[float] = []
        with self._finality_lock:
            for key in keys:
                entry = self._finality_pending.get(key)
                if entry is None or "finalize" not in entry or "execute" in entry:
                    continue
                entry["execute"] = t
                phases.append(t - entry["finalize"])
                total = t - entry["submit"]
                self._finality_samples.append(max(0.0, total))
                self.completed += 1
                totals.append(total)
        for seconds in phases:
            self._observe("execute", seconds)
        for total in totals:
            self._observe("total", total)

    def on_notify(self, keys: Iterable[bytes], t: float) -> None:
        """Sampled keys' commit notifications were queued to a gateway
        subscriber (the last measurable server-side hop)."""
        stamps: List[float] = []
        with self._finality_lock:
            for key in keys:
                entry = self._finality_pending.pop(key, None)
                if entry is None or "finalize" not in entry:
                    continue
                stamps.append(entry.get("execute", entry["finalize"]))
        for done in stamps:
            self._observe("notify", t - done)

    # -- views --

    def samples(self) -> List[float]:
        """The recent completed-total samples (fleet aggregation helper)."""
        with self._finality_lock:
            return list(self._finality_samples)

    def percentiles(self) -> Dict[str, float]:
        with self._finality_lock:
            samples = list(self._finality_samples)
        return {
            "p50_s": percentile(samples, 0.50),
            "p99_s": percentile(samples, 0.99),
            "samples": len(samples),
        }

    def export_gauges(self) -> None:
        """Refresh the rolling percentile gauges (ingress tick cadence)."""
        if self.metrics is None:
            return
        p = self.percentiles()
        self.metrics.mysticeti_e2e_finality_p50_seconds.set(p["p50_s"])
        self.metrics.mysticeti_e2e_finality_p99_seconds.set(p["p99_s"])

    def state(self) -> Dict[str, float]:
        """Health/debug snapshot (feeds ``health_state()`` → the
        ``finality-p99`` watchdog and ``/health``)."""
        p = self.percentiles()
        with self._finality_lock:
            pending = len(self._finality_pending)
        return {
            "samples": p["samples"],
            "completed": self.completed,
            "expired": self.expired,
            "pending": pending,
            "p50_s": round(p["p50_s"], 6),
            "p99_s": round(p["p99_s"], 6),
        }


class ClientFinalityRecorder:
    """Client-side mirror of the tracker for closed-loop generators.

    Lives entirely on the generator's loop thread (no lock): stamps
    sampled keys at submit time and closes them when the commit-sink /
    gateway notification echoes the key back, so client-observed finality
    can cross-check the server-side series in one artifact.
    """

    def __init__(
        self,
        sample_every: int = 16,
        pending_cap: int = DEFAULT_PENDING_CAP,
        sample_window: int = DEFAULT_SAMPLE_WINDOW,
        clock=runtime_now,
    ) -> None:
        self.sample_every = max(1, sample_every)
        self.pending_cap = max(16, pending_cap)
        self.clock = clock
        self._pending: "OrderedDict[bytes, float]" = OrderedDict()
        self._samples: Deque[float] = deque(maxlen=sample_window)
        self.completed = 0
        self.expired = 0

    def note_submitted(self, key: bytes) -> None:
        if not key_sampled(key, self.sample_every):
            return
        # setdefault: a closed-loop retry must keep the FIRST submit time —
        # the client experienced the whole wait.
        self._pending.setdefault(key, self.clock())
        while len(self._pending) > self.pending_cap:
            self._pending.popitem(last=False)
            self.expired += 1

    def note_finalized(self, keys: Iterable[bytes]) -> None:
        now = self.clock()
        for key in keys:
            submitted = self._pending.pop(key, None)
            if submitted is None:
                continue
            self._samples.append(max(0.0, now - submitted))
            self.completed += 1

    def samples(self) -> List[float]:
        return list(self._samples)

    def percentiles(self) -> Dict[str, float]:
        samples = list(self._samples)
        return {
            "p50_s": percentile(samples, 0.50),
            "p99_s": percentile(samples, 0.99),
            "samples": len(samples),
        }
