"""Fleet health plane: why a run was slow, not just that it was.

The port's copy of ``mysticeti_tpu.health``.  The metrics substrate
(:mod:`metrics`) says *how fast* the node is and the span tracer
(:mod:`spans`) says *where* a block's latency went; this module turns both
into a diagnosis:

* :class:`HealthProbe` — per-node consensus health derived from state the
  node already has: round-advance rate and commit-rate EMAs, DAG frontier
  skew (own round vs max peer round), per-authority frontier lag, verifier
  state (circuit breaker, routing pin, pipeline in-flight), WAL append
  backlog.  Exported as ``mysticeti_health_*`` gauges and as a
  readiness/diagnosis JSON document served next to ``/healthz``.
* :class:`SLOThresholds` + the probe's watchdog — declarative thresholds
  (min commit rate, max round-stall seconds, max breaker-open fraction,
  max per-authority lag) raising structured, counted :class:`Alert` events
  that NAME the violating authority and pipeline stage.  Alerts fire on
  threshold *transitions* (degraded edge), not every tick.
* :class:`CriticalPathAnalyzer` — commit critical-path attribution from the
  span stream: per committed leader, which pipeline stage dominated the
  receive -> verify -> dag_add -> proposal_wait -> commit -> finalize chain,
  attributed to the leader's authoring authority.  Exported as the
  ``commit_critical_path_seconds{stage}`` histogram plus a top-blocking
  (stage, authority) table in the diagnosis document
  (the JAX package's ``tools/trace_report.py --critical-path`` computes the
  same offline).
* :func:`cluster_snapshot` — fleet-level health from per-node ``/metrics``
  scrapes (quorum participation, per-authority straggler score, cross-node
  commit skew), from the same scrape texts the JAX package's
  ``tools/fleetmon.py`` and orchestrator read.
* :class:`FleetHealthMonitor` — a loop-clocked central sampler over a set
  of probes (the chaos/sim harnesses): a seeded run produces a
  byte-identical health timeline and alert stream every run.

Everything is clocked by the RUNTIME clock (virtual under the deterministic
simulator), and the probe reads only already-maintained state — no new
bookkeeping on any hot path.
"""
from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .runtime import now as runtime_now
from .spans import PIPELINE_STAGES
from .tracing import logger
from .utils.tasks import spawn_logged

log = logger(__name__)

# Which pipeline stage an alert kind indicts.  round/authority stalls mean
# blocks are not ARRIVING (receive); commit stalls mean the decision rule is
# starved (commit); breaker trouble sits on the verify edge.
ALERT_STAGES = {
    "round-stall": "receive",
    "commit-stall": "commit",
    "commit-rate": "commit",
    "authority-lag": "receive",
    "breaker-open": "verify",
    "low-participation": "receive",
    # Host attribution plane (hostattr.py): a laggy or blocked event loop
    # starves block ingestion first, so both kinds indict the dag_add edge.
    "loop-lag": "dag_add",
    "blocking-call": "dag_add",
    # Finality SLI plane (finality.py): a breaching submit→finalized p99
    # means transactions linger between proposal and the observer, so the
    # finalize edge is where to start looking.
    "finality-p99": "finalize",
}

# Snapshot keys whose values depend on real-thread timing (the WAL drain
# thread races the sampler even under the virtual-time loop); the
# deterministic timeline strips them so seeded runs stay byte-identical.
VOLATILE_KEYS = ("wal_backlog",)

_EMA_ALPHA = 0.3


@dataclass(frozen=True)
class SLOThresholds:
    """Declarative health SLOs.  A zero/None threshold disables its check."""

    min_commit_rate: float = 0.0  # committed sub-dags per second
    max_round_stall_s: float = 10.0
    max_commit_stall_s: float = 0.0
    max_authority_lag_rounds: int = 0
    # Fraction of recent samples with the verifier breaker open (window =
    # BREAKER_WINDOW most recent samples).
    max_breaker_open_fraction: float = 0.0
    # Cluster-level: fraction of authorities that must be participating
    # (frontier lag within max_authority_lag_rounds).
    min_participation: float = 0.0
    # Host attribution plane (hostattr.py): event-loop responsiveness SLOs.
    max_loop_lag_s: float = 0.0  # loop-lag p99 ceiling
    max_blocking_call_ms: float = 0.0  # worst synchronous core-owner hold
    # Finality SLI plane (finality.py): submit→finalized p99 ceiling.
    max_finality_p99_s: float = 0.0

    def to_dict(self) -> dict:
        return {
            "min_commit_rate": self.min_commit_rate,
            "max_round_stall_s": self.max_round_stall_s,
            "max_commit_stall_s": self.max_commit_stall_s,
            "max_authority_lag_rounds": self.max_authority_lag_rounds,
            "max_breaker_open_fraction": self.max_breaker_open_fraction,
            "min_participation": self.min_participation,
            "max_loop_lag_s": self.max_loop_lag_s,
            "max_blocking_call_ms": self.max_blocking_call_ms,
            "max_finality_p99_s": self.max_finality_p99_s,
        }

    @staticmethod
    def from_dict(d: dict) -> "SLOThresholds":
        return SLOThresholds(
            min_commit_rate=float(d.get("min_commit_rate", 0.0)),
            max_round_stall_s=float(d.get("max_round_stall_s", 10.0)),
            max_commit_stall_s=float(d.get("max_commit_stall_s", 0.0)),
            max_authority_lag_rounds=int(d.get("max_authority_lag_rounds", 0)),
            max_breaker_open_fraction=float(
                d.get("max_breaker_open_fraction", 0.0)
            ),
            min_participation=float(d.get("min_participation", 0.0)),
            max_loop_lag_s=float(d.get("max_loop_lag_s", 0.0)),
            max_blocking_call_ms=float(d.get("max_blocking_call_ms", 0.0)),
            max_finality_p99_s=float(d.get("max_finality_p99_s", 0.0)),
        )


@dataclass(frozen=True)
class Alert:
    """One SLO violation, naming the violating authority and stage."""

    t: float
    kind: str
    stage: str
    authority: Optional[int]  # the INDICTED authority (None = whole node)
    observer: int  # the authority whose probe raised it
    value: float
    threshold: float
    detail: str

    def to_dict(self) -> dict:
        return {
            "t": round(self.t, 6),
            "kind": self.kind,
            "stage": self.stage,
            "authority": self.authority,
            "observer": self.observer,
            "value": round(self.value, 6),
            "threshold": self.threshold,
            "detail": self.detail,
        }


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# Commit critical-path attribution (from the span stream)


class CriticalPathAnalyzer:
    """Per committed leader: which (stage, authority) edge blocked the commit.

    Registered as a :class:`~mysticeti_tpu_torch.spans.SpanTracer` sink.  Pipeline
    spans for blocks on this node's track are indexed per block reference;
    the ``commit`` span for a leader closes the chain (``finalize`` and the
    ``proposal_wait`` close are recorded just before it inside the same
    commit pass), so at that moment every stage interval the leader crossed
    is known.  The longest stage is THE critical-path edge, attributed to
    the leader's authoring authority — a slow ``receive`` for leader A3R7
    means authority 3 (or the link to it) held the quorum up.
    """

    MAX_TRACKED = 20_000

    def __init__(self, metrics=None, authority: Optional[int] = None) -> None:
        self.metrics = metrics
        self.authority = authority
        self._stages: Dict[object, Dict[str, float]] = {}
        # (stage, author) -> [leaders attributed, total blocked seconds]
        self._blocking: Dict[Tuple[str, int], List[float]] = {}
        self.leaders_attributed = 0

    def on_span(self, stage, ref, authority, t0, t1) -> None:
        if self.authority is not None and authority != self.authority:
            return
        if stage not in PIPELINE_STAGES:
            return
        if stage == "commit":
            self._finish(ref, t1 - t0)
            return
        entry = self._stages.get(ref)
        if entry is None:
            if len(self._stages) >= self.MAX_TRACKED:
                # FIFO eviction: blocks that never commit must not pin memory.
                self._stages.pop(next(iter(self._stages)))
            entry = self._stages[ref] = {}
        entry[stage] = t1 - t0

    def _finish(self, ref, commit_dur: float) -> None:
        durations = self._stages.pop(ref, {})
        durations["commit"] = commit_dur
        blocking_stage = max(durations, key=lambda s: (durations[s], s))
        if self.metrics is not None:
            channel = self.metrics.commit_critical_path_seconds
            for stage, dur in durations.items():
                channel.labels(stage).observe(max(0.0, dur))
        author = getattr(ref, "authority", None)
        if author is not None:
            slot = self._blocking.setdefault((blocking_stage, author), [0, 0.0])
            slot[0] += 1
            slot[1] += max(0.0, durations[blocking_stage])
        self.leaders_attributed += 1

    def top_blocking(self, n: int = 5) -> List[dict]:
        """Top (stage, authority) pairs by total blocked seconds."""
        ranked = sorted(
            self._blocking.items(), key=lambda kv: (-kv[1][1], kv[0])
        )
        return [
            {
                "stage": stage,
                "authority": authority,
                "leaders": int(count),
                "blocked_s": round(total, 6),
            }
            for (stage, authority), (count, total) in ranked[:n]
        ]


# ---------------------------------------------------------------------------
# Per-node probe + watchdog


class HealthProbe:
    """Derives consensus-level health from state the node already maintains.

    ``attach`` binds (and re-binds, after a crash-restart rebuild) the live
    node objects; ``sample`` takes one loop-clocked reading, refreshes the
    ``mysticeti_health_*`` gauges, and runs the SLO watchdog.  ``start``
    spawns a periodic sampling task for production nodes; deterministic
    harnesses drive :meth:`sample` themselves through a
    :class:`FleetHealthMonitor`.
    """

    BREAKER_WINDOW = 20
    MAX_ALERTS = 10_000

    def __init__(
        self,
        authority: int,
        committee_size: int,
        metrics=None,
        slo: Optional[SLOThresholds] = None,
        clock: Callable[[], float] = runtime_now,
        recorder=None,
    ) -> None:
        self.authority = authority
        self.committee_size = committee_size
        self.metrics = metrics
        self.slo = slo or SLOThresholds()
        self.clock = clock
        # Flight recorder (flight_recorder.py): alert edges and verifier
        # breaker/pin transitions land in the node's event ring; an alert
        # additionally triggers a debounced on-disk dump when the recorder
        # has a path.
        self.recorder = recorder
        self._last_breaker_open: Optional[bool] = None
        self._last_pinned: Optional[bool] = None
        self.alerts: List[Alert] = []
        self.critical_path: Optional[CriticalPathAnalyzer] = None
        self._core = None
        self._net_syncer = None
        self._block_verifier = None
        self._commit_observer = None
        self._ingress = None
        self._host_monitor = None
        self._task: Optional[asyncio.Task] = None
        # Rate state.
        self._last_t: Optional[float] = None
        self._last_round = 0
        self._last_commit_height = 0
        self._round_advance_t: Optional[float] = None
        self._commit_advance_t: Optional[float] = None
        self._round_rate_ema = 0.0
        self._commit_rate_ema = 0.0
        self._breaker_samples: List[int] = []
        # Alert-kind transition state: (kind, authority) currently firing.
        self._firing: set = set()
        self.last_snapshot: Optional[dict] = None

    # -- wiring --

    def attach(
        self,
        core=None,
        net_syncer=None,
        block_verifier=None,
        commit_observer=None,
        ingress=None,
        host_monitor=None,
    ) -> "HealthProbe":
        if core is not None:
            self._core = core
        if net_syncer is not None:
            self._net_syncer = net_syncer
        if block_verifier is not None:
            self._block_verifier = block_verifier
        if commit_observer is not None:
            self._commit_observer = commit_observer
        if ingress is not None:
            self._ingress = ingress
        if host_monitor is not None:
            self._host_monitor = host_monitor
        return self

    def detach(self) -> None:
        """Drop node references (crash): the probe object survives so rate
        state and the alert stream span restarts."""
        self._core = None
        self._net_syncer = None
        self._block_verifier = None
        self._commit_observer = None
        self._ingress = None

    def attach_critical_path(self, tracer) -> "HealthProbe":
        """Subscribe a critical-path analyzer to the span stream."""
        if self.critical_path is None:
            self.critical_path = CriticalPathAnalyzer(
                metrics=self.metrics, authority=self.authority
            )
            tracer.add_sink(self.critical_path.on_span)
        return self

    @property
    def attached(self) -> bool:
        return self._core is not None

    # -- sampling --

    def sample(self) -> dict:
        """One reading: snapshot dict + gauge refresh + watchdog pass."""
        t = self.clock()
        core = self._core
        if core is None:
            return {"down": True}
        round_ = core.current_round()
        commit_height = 0
        if self._commit_observer is not None:
            interpreter = getattr(
                self._commit_observer, "commit_interpreter", None
            )
            if interpreter is not None:
                commit_height = interpreter.last_height
        if self._last_t is None:
            self._round_advance_t = t
            self._commit_advance_t = t
        else:
            dt = t - self._last_t
            if dt > 0:
                self._round_rate_ema += _EMA_ALPHA * (
                    (round_ - self._last_round) / dt - self._round_rate_ema
                )
                self._commit_rate_ema += _EMA_ALPHA * (
                    (commit_height - self._last_commit_height) / dt
                    - self._commit_rate_ema
                )
        if round_ > self._last_round:
            self._round_advance_t = t
        if commit_height > self._last_commit_height:
            self._commit_advance_t = t
        self._last_t = t
        self._last_round = round_
        self._last_commit_height = commit_height

        # Frontier: own round vs what each peer has shown us.  Under epoch
        # reconfiguration (reconfig.py) an INACTIVE authority — cleanly
        # departed, or registered-at-genesis but not yet activated — is
        # retired, not a straggler: it produces no blocks by design, so it
        # is excluded from the lag table (no participation alerts) and
        # listed separately.  With reconfig off every authority has
        # positive stake and nothing changes.
        lags: Dict[int, int] = {}
        retired: List[int] = []
        max_peer_round = round_
        store = core.block_store
        committee = getattr(core, "committee", None)
        for a in range(self.committee_size):
            if a == self.authority:
                continue
            if committee is not None and not committee.is_active(a):
                retired.append(a)
                continue
            seen = store.last_seen_by_authority(a)
            lags[a] = max(0, round_ - seen)
            max_peer_round = max(max_peer_round, seen)
        frontier_skew = max_peer_round - round_

        verifier_state = None
        state_fn = getattr(self._block_verifier, "health_state", None)
        if state_fn is not None:
            verifier_state = state_fn()
        breaker_open = bool(verifier_state and verifier_state["breaker_open"])
        if self.recorder is not None and verifier_state is not None:
            pinned = bool(verifier_state.get("pinned_backend"))
            if self._last_breaker_open is not None and (
                breaker_open != self._last_breaker_open
            ):
                self.recorder.record(
                    "breaker", open=breaker_open
                )
            if self._last_pinned is not None and pinned != self._last_pinned:
                self.recorder.record(
                    "pin", pinned=pinned,
                    backend=verifier_state.get("pinned_backend"),
                )
            self._last_breaker_open = breaker_open
            self._last_pinned = pinned
        self._breaker_samples.append(1 if breaker_open else 0)
        if len(self._breaker_samples) > self.BREAKER_WINDOW:
            self._breaker_samples.pop(0)
        breaker_fraction = sum(self._breaker_samples) / len(
            self._breaker_samples
        )

        connected = (
            len(self._net_syncer.connected_authorities)
            if self._net_syncer is not None
            else None
        )
        # Constant False in virtual time (walf() forces sync writes), so
        # the /health snapshot stays deterministic under the sim.
        wal_backlog = bool(core.wal_writer.pending())  # lint: ignore[sim-taint]

        snapshot = {
            "t": round(t, 6),
            "round": round_,
            "commit_height": commit_height,
            "round_advance_rate": round(self._round_rate_ema, 6),
            "commit_rate": round(self._commit_rate_ema, 6),
            "round_stall_s": round(t - self._round_advance_t, 6),
            "commit_stall_s": round(t - self._commit_advance_t, 6),
            "frontier_skew_rounds": frontier_skew,
            "authority_lag_rounds": {str(a): lag for a, lag in lags.items()},
            "connected_authorities": connected,
            "breaker_open_fraction": round(breaker_fraction, 6),
            "wal_backlog": wal_backlog,
        }
        if getattr(core, "reconfig", None) is not None:
            # Reconfig-only keys, so pre-reconfig timelines stay
            # byte-identical: the node's current epoch plus the retired
            # (zero-stake) authorities excluded from the lag table above.
            snapshot["epoch"] = core.committee.epoch
            if retired:
                snapshot["retired_authorities"] = retired
        if verifier_state is not None:
            snapshot["verifier"] = verifier_state
        if self._ingress is not None:
            # Admission state in the /health diagnosis: a degraded node that
            # is SHEDDING reads differently from one silently drowning —
            # the whole point of the ingress plane (ingress.py).
            snapshot["ingress"] = self._ingress.health_state()
        if self._host_monitor is not None:
            # Host attribution plane (hostattr.py): loop-lag percentiles,
            # blocking-call census, GIL convoy ratio.  All-zero under the
            # sim (the probe and sampler never start in virtual time), so
            # the deterministic timeline stays byte-identical.
            host = dict(self._host_monitor.state())
            # Which native data-plane functions resolved in this process
            # (native/__init__.py): lets an operator — and the A/B
            # harness — tell from /health alone whether a node is running
            # the C extension or the pure-Python fallback.
            from .native import active_functions

            host["native_active"] = list(active_functions())
            snapshot["host"] = host
        alerts = self._watchdog(snapshot, lags)
        snapshot["status"] = "degraded" if self._firing else "ok"
        self._export_gauges(snapshot, lags)
        self.last_snapshot = snapshot
        if alerts:
            snapshot = dict(snapshot)  # timeline entries carry their alerts
            snapshot["alerts"] = [a.to_dict() for a in alerts]
        return snapshot

    def _export_gauges(self, snapshot: dict, lags: Dict[int, int]) -> None:
        m = self.metrics
        if m is None:
            return
        m.mysticeti_health_round_advance_rate.set(
            snapshot["round_advance_rate"]
        )
        m.mysticeti_health_commit_rate.set(snapshot["commit_rate"])
        m.mysticeti_health_frontier_skew_rounds.set(
            snapshot["frontier_skew_rounds"]
        )
        for a, lag in lags.items():
            m.mysticeti_health_authority_lag_rounds.labels(str(a)).set(lag)
        verifier = snapshot.get("verifier")
        m.mysticeti_health_verifier_breaker_open.set(
            1 if (verifier and verifier["breaker_open"]) else 0
        )
        m.mysticeti_health_verifier_pinned.set(
            1 if (verifier and verifier.get("pinned_backend")) else 0
        )
        m.mysticeti_health_wal_backlog.set(1 if snapshot["wal_backlog"] else 0)
        m.mysticeti_health_status.set(1 if not self._firing else 0)

    # -- the SLO watchdog --

    def _watchdog(self, snapshot: dict, lags: Dict[int, int]) -> List[Alert]:
        slo = self.slo
        new: List[Alert] = []

        def check(kind: str, authority, value, threshold, above, detail):
            key = (kind, authority)
            violated = value > threshold if above else value < threshold
            if violated and key not in self._firing:
                self._firing.add(key)
                alert = Alert(
                    t=snapshot["t"],
                    kind=kind,
                    stage=ALERT_STAGES[kind],
                    authority=authority,
                    observer=self.authority,
                    value=float(value),
                    threshold=float(threshold),
                    detail=detail,
                )
                if len(self.alerts) < self.MAX_ALERTS:
                    self.alerts.append(alert)
                    new.append(alert)
                if self.metrics is not None:
                    self.metrics.mysticeti_health_slo_alerts_total.labels(
                        kind,
                        "" if authority is None else str(authority),
                        alert.stage,
                    ).inc()
                if self.recorder is not None:
                    self.recorder.on_alert(
                        kind, authority, alert.stage, alert.value, detail
                    )
            elif not violated:
                self._firing.discard(key)

        if slo.max_round_stall_s > 0:
            check(
                "round-stall", None, snapshot["round_stall_s"],
                slo.max_round_stall_s, True,
                f"round {snapshot['round']} stalled "
                f"{snapshot['round_stall_s']:.1f}s",
            )
        if slo.max_commit_stall_s > 0:
            check(
                "commit-stall", None, snapshot["commit_stall_s"],
                slo.max_commit_stall_s, True,
                f"no commit past height {snapshot['commit_height']} for "
                f"{snapshot['commit_stall_s']:.1f}s",
            )
        if slo.min_commit_rate > 0 and self._last_commit_height > 0:
            # Distinct kind from commit-stall: both would share the firing
            # key otherwise, and the stall check clearing it every healthy
            # tick would make the rate alert re-fire per sample.  Armed only
            # once the node has EVER committed — the EMA warms up from zero,
            # and a boot-time "rate below floor" would mark every run with
            # this threshold degraded; a node that never commits at all is
            # the commit-stall check's case.
            check(
                "commit-rate", None, snapshot["commit_rate"],
                slo.min_commit_rate, False,
                f"commit rate {snapshot['commit_rate']:.3f}/s below floor",
            )
        if slo.max_authority_lag_rounds > 0:
            for a in sorted(lags):
                check(
                    "authority-lag", a, lags[a],
                    slo.max_authority_lag_rounds, True,
                    f"authority {a} last seen "
                    f"{lags[a]} rounds behind round {snapshot['round']}",
                )
        if slo.max_breaker_open_fraction > 0:
            check(
                "breaker-open", None, snapshot["breaker_open_fraction"],
                slo.max_breaker_open_fraction, True,
                "verifier circuit breaker open fraction over threshold",
            )
        monitor = self._host_monitor
        if monitor is not None:
            host = snapshot.get("host") or monitor.state()
            if slo.max_loop_lag_s > 0 and host["loop_lag_samples"] > 0:
                check(
                    "loop-lag", None, host["loop_lag_p99_s"],
                    slo.max_loop_lag_s, True,
                    f"event-loop lag p99 {host['loop_lag_p99_s'] * 1e3:.1f}ms"
                    " over SLO",
                )
            if slo.max_blocking_call_ms > 0:
                # Worst hold SINCE THE LAST SAMPLE: draining re-arms the
                # alert after one clean interval, matching the other
                # transition-edge kinds.
                worst_ms = monitor.drain_worst_blocking_ms()
                last = host.get("last_blocking") or {}
                check(
                    "blocking-call", None, worst_ms,
                    slo.max_blocking_call_ms, True,
                    f"synchronous {last.get('site', '?')} held the core "
                    f"owner {worst_ms:.1f}ms",
                )
        if slo.max_finality_p99_s > 0:
            fin = (snapshot.get("ingress") or {}).get("finality") or {}
            # Armed only once samples exist: an idle node (or one with the
            # tracker disabled) reports p99 = 0, not a breach or an all-clear.
            if fin.get("samples", 0) > 0:
                check(
                    "finality-p99", None, fin["p99_s"],
                    slo.max_finality_p99_s, True,
                    f"submit->finalized p99 {fin['p99_s']:.3f}s over SLO "
                    f"({fin['completed']} sampled tx completed)",
                )
        return new

    # -- diagnosis document (served next to /healthz) --

    def diagnosis(self) -> dict:
        doc = {
            "authority": self.authority,
            "status": "degraded" if self._firing else "ok",
            "attached": self.attached,
            "slo": self.slo.to_dict(),
            "signals": self.last_snapshot,
            "alerts": [a.to_dict() for a in self.alerts[-20:]],
            "alerts_total": len(self.alerts),
        }
        if self.critical_path is not None:
            doc["critical_path"] = {
                "leaders_attributed": self.critical_path.leaders_attributed,
                "top_blocking": self.critical_path.top_blocking(),
            }
        return doc

    # -- periodic sampler (production nodes) --

    def start(self, interval_s: float = 5.0) -> "HealthProbe":
        if self._task is None:
            self._task = spawn_logged(
                self._run(interval_s), log, name="health-probe"
            )
        return self

    async def _run(self, interval_s: float) -> None:
        while True:
            await asyncio.sleep(interval_s)
            try:
                self.sample()
            except Exception:  # noqa: BLE001 - the probe must outlive glitches
                log.exception("health probe sample failed")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


# ---------------------------------------------------------------------------
# Deterministic fleet monitor (sim harnesses)


class FleetHealthMonitor:
    """Central loop-clocked sampler over a fleet of probes.

    One ordered tick across all authorities per interval, so a seeded sim
    produces a byte-identical timeline (:meth:`timeline_bytes`) and alert
    stream every run.  ``probe_of(authority)`` returns the live probe or
    None when the node is down (crashed); down nodes are recorded as such.
    """

    def __init__(
        self,
        probe_of: Callable[[int], Optional[HealthProbe]],
        n: int,
        interval_s: float = 1.0,
    ) -> None:
        self.probe_of = probe_of
        self.n = n
        self.interval_s = interval_s
        self.timeline: List[dict] = []
        self._task: Optional[asyncio.Task] = None
        # Epoch reconfiguration: authorities that departed CLEANLY (or have
        # not activated yet) are "retired", not "down" — expected absence,
        # never a degraded-fleet signal.
        self.retired: Set[int] = set()

    def note_retired(self, authority: int) -> None:
        self.retired.add(authority)

    def note_joined(self, authority: int) -> None:
        self.retired.discard(authority)

    def tick(self) -> dict:
        nodes: Dict[str, dict] = {}
        for authority in range(self.n):
            probe = self.probe_of(authority)
            if probe is None or not probe.attached:
                if authority in self.retired:
                    nodes[str(authority)] = {"retired": True}
                else:
                    nodes[str(authority)] = {"down": True}
                continue
            snapshot = dict(probe.sample())
            for key in VOLATILE_KEYS:
                snapshot.pop(key, None)
            nodes[str(authority)] = snapshot
        entry = {"t": round(runtime_now(), 6), "nodes": nodes}
        self.timeline.append(entry)
        return entry

    def alert_stream(self) -> List[dict]:
        """Every alert raised by any probe, in (t, observer) order."""
        alerts: List[Alert] = []
        for authority in range(self.n):
            probe = self.probe_of(authority)
            if probe is not None:
                alerts.extend(probe.alerts)
        alerts.sort(key=lambda a: (a.t, a.observer, a.kind, str(a.authority)))
        return [a.to_dict() for a in alerts]

    def timeline_bytes(self) -> bytes:
        return _canonical(self.timeline)

    def alert_stream_bytes(self) -> bytes:
        return _canonical(self.alert_stream())

    def fleet_report(self) -> dict:
        """End-of-run verdict: green iff no alerts and every authority is
        within the participation floor at the final sample."""
        alerts = self.alert_stream()
        last = self.timeline[-1] if self.timeline else {"nodes": {}}
        lag_threshold = 0
        participating = self.n
        for authority in range(self.n):
            probe = self.probe_of(authority)
            if probe is not None and probe.slo.max_authority_lag_rounds > 0:
                lag_threshold = probe.slo.max_authority_lag_rounds
                break
        max_lag = 0
        if lag_threshold:
            behind = set()
            for snapshot in last["nodes"].values():
                for a, lag in (snapshot.get("authority_lag_rounds") or {}).items():
                    max_lag = max(max_lag, lag)
                    if lag > lag_threshold:
                        behind.add(a)
            participating = self.n - len(behind)
        down = [
            a for a, snap in last["nodes"].items() if snap.get("down")
        ]
        status = "ok"
        if alerts or down or participating < self.n:
            status = "degraded"
        return {
            "status": status,
            "alerts": alerts,
            "down": down,
            "participation": participating / self.n if self.n else 1.0,
            "max_authority_lag_rounds": max_lag,
            "samples": len(self.timeline),
        }

    # -- lifecycle --

    def start(self) -> "FleetHealthMonitor":
        if self._task is None:
            self._task = spawn_logged(self._run(), log, name="fleet-health")
        return self

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            self.tick()

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


# ---------------------------------------------------------------------------
# Cluster-level health from /metrics scrapes (fleetmon + orchestrator)


def node_health_from_series(series) -> dict:
    """Reduce one node's parsed prometheus series (an iterable of
    ``(name, labels, value)``, e.g. from
    :func:`mysticeti_tpu_torch.orchestrator.measurement.iter_series`) to the
    health-relevant view."""
    out: dict = {
        "round": 0,
        "commit_round": 0,
        "commit_rate": 0.0,
        "round_advance_rate": 0.0,
        "frontier_skew_rounds": 0,
        "status_ok": True,
        "committed_by_authority": {},
        "authority_lag_rounds": {},
        "slo_alerts": {},
        "loop_lag_p99_s": 0.0,
        "finality_p50_s": 0.0,
        "finality_p99_s": 0.0,
        "cpu_subsystems": {},
        "epoch": 0,
    }
    for name, labels, value in series:
        if name == "threshold_clock_round":
            out["round"] = int(value)
        elif name == "commit_round":
            out["commit_round"] = int(value)
        elif name == "mysticeti_epoch":
            out["epoch"] = int(value)
        elif name == "mysticeti_health_commit_rate":
            out["commit_rate"] = value
        elif name == "mysticeti_health_round_advance_rate":
            out["round_advance_rate"] = value
        elif name == "mysticeti_health_frontier_skew_rounds":
            out["frontier_skew_rounds"] = int(value)
        elif name == "mysticeti_health_status":
            out["status_ok"] = value >= 1.0
        elif name == "mysticeti_health_authority_lag_rounds":
            out["authority_lag_rounds"][labels.get("authority", "?")] = int(value)
        elif name == "committed_leaders_total":
            if "commit" in labels.get("status", ""):
                a = labels.get("authority", "?")
                out["committed_by_authority"][a] = (
                    out["committed_by_authority"].get(a, 0.0) + value
                )
        elif name == "mysticeti_health_slo_alerts_total":
            kind = labels.get("kind", "?")
            out["slo_alerts"][kind] = out["slo_alerts"].get(kind, 0.0) + value
        elif name == "mysticeti_loop_lag_p99_seconds":
            out["loop_lag_p99_s"] = value
        elif name == "mysticeti_e2e_finality_p50_seconds":
            out["finality_p50_s"] = value
        elif name == "mysticeti_e2e_finality_p99_seconds":
            out["finality_p99_s"] = value
        elif name == "mysticeti_cpu_seconds_total":
            # Attribution plane (profiling.py): per-subsystem CPU seconds,
            # summed over thread classes for the fleet view.
            sub = labels.get("subsystem", "?")
            out["cpu_subsystems"][sub] = (
                out["cpu_subsystems"].get(sub, 0.0) + value
            )
    return out


def cluster_snapshot(
    nodes: Dict[str, Optional[dict]],
    committee_size: int,
    slo: Optional[SLOThresholds] = None,
    retired: Optional[Set[str]] = None,
) -> dict:
    """Fleet-level health for one scrape tick.

    ``nodes`` maps node id -> :func:`node_health_from_series` output (None =
    unreachable this tick).  Quorum participation counts authorities whose
    blocks reached ANY committed sub-dag; the straggler score per authority
    is the worst frontier lag any node reports for it; cross-node commit
    skew is the spread of committed rounds across the fleet.

    ``retired`` names authorities that departed the committee CLEANLY
    (epoch reconfiguration): they are expected-absent, never counted
    unreachable, and ``committee_size`` should already be the CURRENT
    epoch's active count so quorum participation is judged against the
    committee that actually votes.
    """
    retired = retired or set()
    nodes = {k: v for k, v in nodes.items() if k not in retired}
    reachable = {k: v for k, v in nodes.items() if v is not None}
    commit_rounds = [v["commit_round"] for v in reachable.values()]
    committed_authorities = set()
    stragglers: Dict[str, int] = {}
    alert_totals: Dict[str, float] = {}
    for v in reachable.values():
        for a, count in v["committed_by_authority"].items():
            if count > 0:
                committed_authorities.add(a)
        for a, lag in v["authority_lag_rounds"].items():
            if a in retired:
                continue  # frozen gauge from before the departure
            stragglers[a] = max(stragglers.get(a, 0), lag)
        for kind, count in v["slo_alerts"].items():
            alert_totals[kind] = alert_totals.get(kind, 0.0) + count
    committed_authorities -= set(retired)
    participation = (
        len(committed_authorities) / committee_size if committee_size else 0.0
    )
    snapshot = {
        "reachable": sorted(reachable),
        "unreachable": sorted(k for k, v in nodes.items() if v is None),
        "retired": sorted(retired),
        "epochs_by_node": {
            k: int(v.get("epoch", 0)) for k, v in sorted(reachable.items())
        },
        "quorum_participation": round(participation, 4),
        "commit_skew_rounds": (
            max(commit_rounds) - min(commit_rounds) if commit_rounds else 0
        ),
        "max_commit_round": max(commit_rounds, default=0),
        "straggler_score": dict(sorted(stragglers.items())),
        "commit_rate_by_node": {
            k: round(v["commit_rate"], 4) for k, v in sorted(reachable.items())
        },
        "slo_alert_totals": dict(sorted(alert_totals.items())),
        "degraded_nodes": sorted(
            k for k, v in reachable.items() if not v["status_ok"]
        ),
        # Host attribution plane: per-node loop responsiveness and the
        # top-3 CPU consumers (busy subsystems only — idle is not a cost).
        "loop_lag_p99_by_node": {
            k: round(v.get("loop_lag_p99_s", 0.0), 6)
            for k, v in sorted(reachable.items())
        },
        # Finality SLI plane: per-node rolling submit→finalized percentiles.
        "finality_p99_by_node": {
            k: round(v.get("finality_p99_s", 0.0), 6)
            for k, v in sorted(reachable.items())
        },
        "top_cpu_subsystems": {
            k: [
                sub
                for sub, _ in sorted(
                    (v.get("cpu_subsystems") or {}).items(),
                    key=lambda kv: (-kv[1], kv[0]),
                )
                if sub != "event-loop-idle"
            ][:3]
            for k, v in sorted(reachable.items())
        },
    }
    reasons = []
    if snapshot["unreachable"]:
        reasons.append("unreachable:" + ",".join(snapshot["unreachable"]))
    if snapshot["degraded_nodes"]:
        reasons.append("degraded:" + ",".join(snapshot["degraded_nodes"]))
    # slo_alert_totals are CUMULATIVE counters — informational history, not
    # a live verdict.  Current degradation shows through degraded_nodes
    # (mysticeti_health_status re-arms on recovery); keying status on the
    # totals would leave one transient alert marking the fleet degraded
    # forever.
    if slo is not None and slo.min_participation > 0 and reachable:
        if participation < slo.min_participation:
            reasons.append("participation")
    # Loop-lag and finality-p99 SLO breaches turn the gate YELLOW, not red:
    # the node is answering and committing, but slowly — a warning state,
    # distinct from degraded (fleetmon still exits 0).
    yellow = set()
    if slo is not None and slo.max_loop_lag_s > 0:
        yellow.update(
            k
            for k, lag in snapshot["loop_lag_p99_by_node"].items()
            if lag > slo.max_loop_lag_s
        )
    if slo is not None and slo.max_finality_p99_s > 0:
        yellow.update(
            k
            for k, p99 in snapshot["finality_p99_by_node"].items()
            if p99 > slo.max_finality_p99_s
        )
    yellow = sorted(yellow)
    snapshot["yellow_nodes"] = yellow
    if reasons:
        snapshot["status"] = "degraded"
    elif yellow:
        snapshot["status"] = "yellow"
    else:
        snapshot["status"] = "ok"
    snapshot["degraded_reasons"] = reasons
    return snapshot


def cluster_snapshot_from_texts(
    texts: Dict[str, Optional[str]],
    committee_size: int,
    slo: Optional[SLOThresholds] = None,
    retired: Optional[Set[str]] = None,
) -> dict:
    """Convenience: per-node raw ``/metrics`` text (None = unreachable) ->
    :func:`cluster_snapshot`."""
    from .orchestrator.measurement import iter_series

    nodes = {
        k: None if text is None else node_health_from_series(iter_series(text))
        for k, text in texts.items()
    }
    return cluster_snapshot(nodes, committee_size, slo=slo, retired=retired)
