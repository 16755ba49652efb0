"""Overload-resilient ingress plane: gateway, admission-controlled mempool,
graceful degradation under saturation.

The port's copy of ``mysticeti_tpu.ingress``.

The MAXLOAD artifacts show why ingress policy matters: committed throughput
*collapses* past saturation (r4: 40.3k committed at 57.6k offered) because
transactions entered through ``BenchmarkFastPathBlockHandler.submit`` into an
UNBOUNDED queue with nothing but the per-block SOFT_MAX drain cap — no dedup,
no fairness, no shedding, and no backpressure signal from the core.  This
module is the real ingress plane (the ACE-runtime split between an admission
edge and a finality core):

* :class:`Mempool` — bounded (transaction- AND byte-capped) pool with
  nonce/digest dedup over a count-bounded window and per-client fairness
  lanes drained weighted-round-robin with a priority class.  Overflow is
  **explicitly shed** with a typed reason, never silently queued or dropped.
* :class:`AdmissionController` — AIMD on the admitted rate, closing the loop
  from live core signals the health plane already computes (mempool
  occupancy, core owner queue depth, WAL backlog, verifier pipeline
  occupancy): additive raise per tick while healthy, multiplicative cut on
  congestion, a floor so a transient stall cannot starve ingress forever.
  At 2-5x offered overload the core keeps running at its measured saturation
  point instead of collapsing behind an ever-deeper queue.
* :class:`IngressPlane` — the facade the block handler, validator assembly,
  health probe, and gateway share: ``submit`` returns a typed
  :class:`SubmitResult` (``SHED{retry_after_ms, reason}`` instead of a silent
  drop), ``drain`` feeds proposals, ``tick`` runs the controller, and every
  rejection counts on ``mysticeti_ingress_shed_total{reason}`` and lands in
  a bounded structured shed log (byte-identical across same-seed sims).
* :class:`IngressGateway` — the client-facing RPC listener on the existing
  length-prefixed framing (wire tags 13-16, docs/wire-format.md §5b):
  SUBMIT -> ACK/QUEUED/SHED plus an optional commit-notification stream fed
  from the committed sequence.
* :func:`run_overload_sim` — a seeded, deterministic N-node overload
  scenario on the virtual-time simulator (the chaos tier's shape): offered
  load ramps to a multiple of the 1x rate and the run asserts graceful
  degradation, full shed accounting, and a byte-identical shed schedule.

Everything is clocked by the RUNTIME clock (virtual under the deterministic
simulator) and dedup is count-bounded, not time-bounded, so seeded sims are
bit-reproducible.  Trust notes (client-facing surface!) live in
docs/ingress.md.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .config import IngressParameters
from .network import (
    GATEWAY_ACK,
    GATEWAY_QUEUED,
    GATEWAY_SHED,
    GatewayCommitNotification,
    GatewaySubmit,
    GatewaySubmitReply,
    GatewaySubscribeCommits,
    _read_frame,
    _write_frame,
    decode_message,
    encode_message,
)
from .finality import FinalityTracker
from .runtime import now as runtime_now, timestamp_utc
from .tracing import logger
from .utils.tasks import spawn_logged

log = logger(__name__)

# Shed reasons (the mysticeti_ingress_shed_total{reason} label values).
SHED_ADMISSION = "admission"
SHED_MEMPOOL_TXS = "mempool_transactions"
SHED_MEMPOOL_BYTES = "mempool_bytes"
SHED_LANE_CAP = "lane_cap"
SHED_DUPLICATE = "duplicate"
# Not a rejection: transactions deferred to the NEXT proposal when a drain
# would overshoot the per-block cap (the old silent `_receive_with_limit`
# truncation, now visible).  Counted on the same family so the whole
# admitted-but-not-yet-proposed picture reads off one series.
SHED_SOFT_CAP_DEFERRED = "soft_cap_deferred"
# Execution-plane pre-consensus rejects (execution.py): typed verdicts for
# transactions already doomed against current account state — shed here so
# consensus never pays for them.  The label values ARE the execution
# verdict names (one vocabulary across admission and the fold); the checks
# are advisory (in-flight commits may move the account), so only verdicts
# wrong against CURRENT state are shed — a nonce ahead of the account is
# admitted and left to the deterministic fold.
SHED_BAD_NONCE = "bad_nonce"
SHED_INSUFFICIENT_BALANCE = "insufficient_balance"
SHED_UNKNOWN_ACCOUNT = "unknown_account"
SHED_ACCOUNT_EXISTS = "account_exists"
_EXEC_SHED_REASONS = (
    SHED_BAD_NONCE,
    SHED_INSUFFICIENT_BALANCE,
    SHED_UNKNOWN_ACCOUNT,
    SHED_ACCOUNT_EXISTS,
)

# Floor on any retry-after hint: a zero tells a closed-loop client to spin.
RETRY_AFTER_MIN_MS = 25

# WRR drain chunk per turn (priority lanes get priority_weight chunks): big
# enough to amortize the rotation over a 10k-budget drain, small enough that
# a cycle still visits every lane inside one small-budget proposal.
DRAIN_CHUNK = 32

# Fairness-lane table cap: lane tokens are CLIENT-CHOSEN bytes on an
# unauthenticated listener, so an adversary could otherwise mint unbounded
# bookkeeping (docs/ingress.md trust notes).  Submissions that would create
# a lane beyond the cap are shed as lane_cap.
MAX_LANES = 1024


def ingress_key(transaction: bytes) -> bytes:
    """The 16-byte dedup/notification key of a transaction: BLAKE2b-128 over
    the full canonical bytes (the generator's nonce is inside them, so two
    distinct submissions never collide and a resubmission always does)."""
    return hashlib.blake2b(transaction, digest_size=16).digest()


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


@dataclass(frozen=True)
class SubmitResult:
    """Typed submission verdict — the explicit-shedding contract.

    ``status`` mirrors the gateway wire values (ACK/QUEUED/SHED);
    ``retry_after_ms`` is when the admission controller expects capacity
    (only meaningful on SHED); ``reason`` names the first rejection cause.
    """

    status: int
    accepted: int
    shed: int
    retry_after_ms: int = 0
    reason: str = ""

    @property
    def is_shed(self) -> bool:
        return self.status == GATEWAY_SHED


class _Lane:
    __slots__ = ("queue", "bytes", "priority", "drained", "shed")

    def __init__(self, priority: bool) -> None:
        # (transaction, ingress_key) pairs: the key rides along so the
        # drain can stamp finality-sampled keys without rehashing.
        self.queue: Deque[Tuple[bytes, bytes]] = deque()
        self.bytes = 0
        self.priority = priority
        self.drained = 0
        self.shed = 0


class Mempool:
    """Bounded transaction pool with dedup and per-client fairness lanes.

    ``submit`` never blocks and never silently drops: every transaction is
    either admitted into its lane or returned as shed with a typed reason.
    ``drain`` serves proposals weighted-round-robin across lanes — one full
    cycle gives every non-empty lane a turn before any lane gets a second,
    so no client can starve another regardless of submission rate; priority
    lanes get ``priority_weight`` chunks per turn.

    The aggregate accounting fields are lock-disciplined
    (``_mempool_lock``; the lint's GUARDED_FIELDS covers them): submissions
    may arrive from application threads (SimpleBlockHandler precedent) while
    the core drains on the loop.
    """

    def __init__(self, params: IngressParameters, finality=None) -> None:
        self.params = params
        # Optional FinalityTracker (finality.py): submit/drain stamp the
        # admission and proposal phases for count-sampled keys.
        self._finality = finality
        self._lanes: "OrderedDict[Tuple[str, bool], _Lane]" = OrderedDict()
        self._seen: "OrderedDict[bytes, None]" = OrderedDict()
        self._mempool_lock = threading.Lock()
        self._mempool_count = 0
        self._mempool_bytes = 0

    # -- intake --

    def submit(
        self,
        client: str,
        transactions: List[bytes],
        priority: bool = False,
        t_submit: Optional[float] = None,
    ) -> Tuple[int, Dict[str, int]]:
        """Admit what fits; return ``(accepted, {shed_reason: count})``.

        ``t_submit`` is the caller-observed arrival time (defaults to the
        admission time) for the finality tracker's admission phase."""
        params = self.params
        fin = self._finality
        accepted = 0
        sheds: Dict[str, int] = {}
        sampled_keys: List[bytes] = []
        with self._mempool_lock:
            lane = self._lanes.get((client, priority))
            if lane is None:
                if len(self._lanes) >= MAX_LANES and not self._evict_lane():
                    # Every lane still holds transactions: genuine pressure,
                    # not bookkeeping exhaustion (empty lanes are evicted, so
                    # 1024 cumulative clients can never wedge ingress).
                    sheds[SHED_LANE_CAP] = len(transactions)
                    return 0, sheds
                lane = self._lanes[(client, priority)] = _Lane(priority)
            for tx in transactions:
                # Dedup FIRST: a duplicate is a duplicate even when the pool
                # is full (it is the one verdict a client must not retry).
                key = ingress_key(tx)
                if key in self._seen:
                    sheds[SHED_DUPLICATE] = sheds.get(SHED_DUPLICATE, 0) + 1
                    lane.shed += 1
                    continue
                # Cap sheds do NOT enter the seen window: the retry the
                # SHED{retry_after_ms} contract invites must be admissible
                # later, not misread as a duplicate.
                if self._mempool_count >= params.mempool_max_transactions:
                    sheds[SHED_MEMPOOL_TXS] = (
                        sheds.get(SHED_MEMPOOL_TXS, 0) + 1
                    )
                    lane.shed += 1
                    continue
                if self._mempool_bytes + len(tx) > params.mempool_max_bytes:
                    sheds[SHED_MEMPOOL_BYTES] = (
                        sheds.get(SHED_MEMPOOL_BYTES, 0) + 1
                    )
                    lane.shed += 1
                    continue
                if len(lane.queue) >= params.lane_max_transactions:
                    sheds[SHED_LANE_CAP] = sheds.get(SHED_LANE_CAP, 0) + 1
                    lane.shed += 1
                    continue
                self._seen[key] = None
                if len(self._seen) > params.dedup_window:
                    self._seen.popitem(last=False)
                lane.queue.append((tx, key))
                lane.bytes += len(tx)
                self._mempool_count += 1
                self._mempool_bytes += len(tx)
                accepted += 1
                if fin is not None and fin.sampled(key):
                    sampled_keys.append(key)
        # Stamp outside _mempool_lock: the tracker has its own lock and the
        # lock-order lint wants no nesting between the two planes.
        if sampled_keys:
            t_admitted = fin.clock()
            if t_submit is None:
                t_submit = t_admitted
            for key in sampled_keys:
                fin.on_submit(key, t_submit, t_admitted)
        return accepted, sheds

    def _evict_lane(self) -> bool:
        """Drop the oldest drained-empty lane to make room for a new one
        (holding ``_mempool_lock``).  Gateway connections mint one lane each
        (``conn-{id}``), so without eviction MAX_LANES would be a LIFETIME
        cap — 1024 cumulative connections would permanently shed every new
        client until restart.  Only stats die with an empty lane, never
        transactions."""
        for key, lane in self._lanes.items():
            if not lane.queue:
                del self._lanes[key]
                return True
        return False

    # -- drain (weighted round-robin) --

    def drain(self, budget: int) -> List[bytes]:
        if budget <= 0:
            return []
        fin = self._finality
        out: List[bytes] = []
        sampled_keys: List[bytes] = []
        with self._mempool_lock:
            if self._mempool_count == 0:
                return out
            lanes = list(self._lanes.items())
            # Rotate the visit order so the lane that led this drain goes
            # last in the next one — fairness across drains, not just
            # within one cycle.
            while len(out) < budget:
                progressed = False
                for key, lane in lanes:
                    if not lane.queue:
                        continue
                    chunk = DRAIN_CHUNK * (
                        self.params.priority_weight if lane.priority else 1
                    )
                    take = min(chunk, budget - len(out), len(lane.queue))
                    for _ in range(take):
                        tx, tx_key = lane.queue.popleft()
                        lane.bytes -= len(tx)
                        self._mempool_count -= 1
                        self._mempool_bytes -= len(tx)
                        out.append(tx)
                        if fin is not None and fin.sampled(tx_key):
                            sampled_keys.append(tx_key)
                    lane.drained += take
                    progressed = progressed or take > 0
                    if len(out) >= budget:
                        break
                if not progressed:
                    break
            if lanes:
                first_key = lanes[0][0]
                if first_key in self._lanes:
                    self._lanes.move_to_end(first_key)
        if sampled_keys:
            t = fin.clock()
            for key in sampled_keys:
                fin.on_proposal(key, t)
        return out

    # -- views --

    def pending(self) -> int:
        return self._mempool_count

    def pending_bytes(self) -> int:
        return self._mempool_bytes

    def occupancy(self) -> float:
        """Fraction of the tighter cap in use (the congestion signal)."""
        p = self.params
        by_count = (
            self._mempool_count / p.mempool_max_transactions
            if p.mempool_max_transactions
            else 0.0
        )
        by_bytes = (
            self._mempool_bytes / p.mempool_max_bytes
            if p.mempool_max_bytes
            else 0.0
        )
        return max(by_count, by_bytes)

    def lane_stats(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        with self._mempool_lock:
            for (client, priority), lane in self._lanes.items():
                name = f"{client}/priority" if priority else client
                out[name] = {
                    "pending": len(lane.queue),
                    "drained": lane.drained,
                    "shed": lane.shed,
                    "priority": priority,
                }
        return out


class AdmissionController:
    """AIMD admitted-rate controller over a token bucket.

    ``admit(n)`` spends tokens refilled at the current rate; the unfunded
    tail is shed with a ``retry_after_ms`` hint sized to the deficit.
    ``tick(signals)`` is the AIMD step: a congested core (mempool past the
    high watermark, core owner queue deep, or WAL backlog while the mempool
    is filling) cuts the rate multiplicatively; a drained mempool raises it
    additively; in between the rate holds (hysteresis).  ``tick`` runs on
    the event loop, but ``admit`` rides the submit path, which the mempool
    contract allows from application threads — so the token bucket is
    lock-disciplined like the mempool counters (two concurrent admits must
    not both spend the same tokens and double the admitted rate).
    """

    # Token bucket burst window: enough to absorb one generator tick's batch
    # without the bucket itself becoming a second (jittery) rate limit.
    BURST_S = 0.5
    # Core owner queue fill fraction that reads as congestion.
    CORE_QUEUE_FRACTION = 0.75

    def __init__(
        self,
        params: IngressParameters,
        clock: Callable[[], float] = runtime_now,
    ) -> None:
        self.params = params
        self.clock = clock
        self.rate = float(params.admission_initial_tx_s)
        self.shed_mode = False
        self._lock = threading.Lock()
        self._tokens = self.rate * self.BURST_S
        self._last_refill: Optional[float] = None

    def admit(self, n: int) -> Tuple[int, int]:
        """Fund up to ``n`` transactions; return ``(admitted,
        retry_after_ms)`` where the hint covers the unfunded remainder."""
        if not self.params.admission or n <= 0:
            return n, 0
        now = self.clock()
        with self._lock:
            if self._last_refill is not None:
                self._tokens = min(
                    self.rate * self.BURST_S,
                    self._tokens + (now - self._last_refill) * self.rate,
                )
            self._last_refill = now
            admitted = min(n, int(self._tokens))
            self._tokens -= admitted
        if admitted >= n:
            return n, 0
        deficit = n - admitted
        retry_ms = max(
            RETRY_AFTER_MIN_MS, int(1000.0 * deficit / max(self.rate, 1.0))
        )
        return admitted, retry_ms

    def tick(self, signals: dict) -> List[str]:
        """One AIMD step; returns the congestion reasons (empty = healthy)."""
        p = self.params
        occupancy = signals.get("mempool_occupancy", 0.0)
        congested: List[str] = []
        if occupancy >= p.high_watermark:
            congested.append("mempool")
        depth = signals.get("core_queue_depth")
        capacity = signals.get("core_queue_capacity") or 0
        if depth is not None and capacity:
            if depth >= capacity * self.CORE_QUEUE_FRACTION:
                congested.append("core-queue")
        # A WAL backlog alone is normal at load (the async drain runs a 1 s
        # cadence); combined with a FILLING mempool it means the core is
        # genuinely behind its intake.
        if signals.get("wal_backlog") and occupancy >= p.low_watermark:
            congested.append("wal")
        if (signals.get("verify_occupancy") or 0.0) >= 1.0 and (
            occupancy >= p.low_watermark
        ):
            congested.append("verifier")
        if congested:
            with self._lock:
                self.rate = max(
                    p.admission_min_tx_s,
                    self.rate * p.admission_decrease_factor,
                )
                self._tokens = min(self._tokens, self.rate * self.BURST_S)
            self.shed_mode = True
        elif occupancy <= p.low_watermark:
            with self._lock:
                self.rate = min(
                    p.admission_max_tx_s, self.rate + p.admission_additive_tx_s
                )
            self.shed_mode = False
        return congested


class IngressPlane:
    """The node's ingress facade: mempool + admission + accounting + feeds.

    Wired by the validator assembly: the block handler submits and drains
    through it, the gateway serves clients off it, the health probe embeds
    its state in ``/health``, the flight recorder gets shed-mode
    transitions, and the commit observer feeds it the committed sequence
    for client notifications.
    """

    def __init__(
        self,
        params: Optional[IngressParameters] = None,
        authority: int = 0,
        metrics=None,
        recorder=None,
        clock: Callable[[], float] = runtime_now,
    ) -> None:
        self.params = params or IngressParameters()
        self.authority = authority
        self.metrics = metrics
        self.recorder = recorder
        self.clock = clock
        # Server-side submit→finality phase joiner (finality.py) over
        # count-sampled ingress keys; finality_sample_every=0 disables it.
        self.finality = (
            FinalityTracker(
                metrics=metrics,
                sample_every=self.params.finality_sample_every,
                clock=clock,
            )
            if self.params.finality_sample_every > 0
            else None
        )
        self.mempool = Mempool(self.params, finality=self.finality)
        self.controller = AdmissionController(self.params, clock=clock)
        # Submit-path accounting: submit() is callable from application
        # threads (same contract as Mempool), so the ledger and shed log
        # move under one lock — a log append racing the canonical
        # serialization in shed_log_bytes() would break the byte-identical
        # shed-schedule claim.
        self._accounting_lock = threading.Lock()
        self.admitted_total = 0
        self.shed_by_reason: Dict[str, int] = {}
        self.shed_log: List[dict] = []
        self._shed_log_dropped = 0
        self.commit_height = 0
        self._commit_sinks: List[Callable[[int, List[bytes]], None]] = []
        self._last_shed_mode = False
        self._task: Optional[asyncio.Task] = None
        # Core signal taps (attach()); all optional.
        self._core = None
        self._net_syncer = None
        self._block_verifier = None
        self._health = None
        # Execution plane tap (attach(core=...) when core.execution is on):
        # commit notifications are then DEFERRED until the core has folded
        # the commit through the state machine — one frame carries both the
        # sequencing decision and the executed root.  The buffer only lives
        # between handle_commit and handle_committed_subdag in the same
        # synchronous syncer pass, so it stays tiny.
        self.execution = None
        self._pending_exec: Deque[Tuple[int, List[bytes], dict]] = deque()
        self.executed_height = 0
        self.executed_root = b""

    # -- wiring --

    def attach(
        self,
        core=None,
        net_syncer=None,
        block_verifier=None,
        health=None,
    ) -> "IngressPlane":
        if core is not None:
            self._core = core
            execution = getattr(core, "execution", None)
            if execution is not None:
                self.execution = execution
                self.executed_height = execution.last_height
                self.executed_root = execution.root
                core.execution_listeners.append(self._on_executed)
                if self.finality is not None:
                    # The headline total SLI now closes at EXECUTED.
                    self.finality.execute_expected = True
        if net_syncer is not None:
            self._net_syncer = net_syncer
        if block_verifier is not None:
            self._block_verifier = block_verifier
        if health is not None:
            self._health = health
        return self

    def add_commit_sink(
        self, sink: Callable[[int, List[bytes], dict], None]
    ) -> None:
        """Register a commit-notification consumer (the gateway's
        subscription stream).  Sinks receive
        ``(height, [ingress keys], info)`` per committed sub-dag, where
        ``info`` carries ``leader_round`` and ``committed_ts_ns`` for the
        tag-16 wire suffix; key extraction only runs while at least one
        sink (or the finality tracker) is active."""
        self._commit_sinks.append(sink)

    def remove_commit_sink(self, sink) -> None:
        try:
            self._commit_sinks.remove(sink)
        except ValueError:
            pass

    # -- intake / drain --

    @property
    def max_per_proposal(self) -> int:
        return self.params.max_per_proposal

    def submit(
        self, client: str, transactions: List[bytes], priority: bool = False
    ) -> SubmitResult:
        n = len(transactions)
        if n == 0:
            return SubmitResult(GATEWAY_ACK, 0, 0)
        t_submit = self.clock()
        admitted_n, retry_ms = self.controller.admit(n)
        sheds: Dict[str, int] = {}
        if admitted_n < n:
            sheds[SHED_ADMISSION] = n - admitted_n
        admitted = transactions[:admitted_n]
        if self.execution is not None:
            lanes = self._route_execution(client, admitted, sheds)
        else:
            lanes = [(client, admitted)]
        accepted = 0
        for lane_client, lane_txs in lanes:
            lane_accepted, pool_sheds = self.mempool.submit(
                lane_client, lane_txs, priority=priority, t_submit=t_submit
            )
            accepted += lane_accepted
            for reason, count in pool_sheds.items():
                sheds[reason] = sheds.get(reason, 0) + count
        shed = n - accepted
        with self._accounting_lock:
            self.admitted_total += accepted
        if self.metrics is not None and accepted:
            self.metrics.mysticeti_ingress_admitted_total.inc(accepted)
        reason = ""
        if sheds:
            # Deterministic reason precedence: the most actionable first
            # (admission has a rate-derived retry hint, pool caps a
            # drain-derived one, duplicates none worth retrying).
            for candidate in (
                SHED_ADMISSION,
                SHED_MEMPOOL_TXS,
                SHED_MEMPOOL_BYTES,
                SHED_LANE_CAP,
            ) + _EXEC_SHED_REASONS + (
                SHED_DUPLICATE,
            ):
                if candidate in sheds:
                    reason = candidate
                    break
            if reason != SHED_ADMISSION:
                # Pool-cap sheds free up at drain cadence, not token cadence.
                retry_ms = max(
                    retry_ms,
                    max(
                        RETRY_AFTER_MIN_MS,
                        int(self.params.tick_interval_s * 1000),
                    ),
                )
            self._count_sheds(client, sheds, retry_ms)
        status = GATEWAY_SHED if shed else GATEWAY_ACK
        if not shed and self.mempool.occupancy() >= self.params.queued_watermark:
            status = GATEWAY_QUEUED
        return SubmitResult(status, accepted, shed, retry_ms if shed else 0,
                            reason)

    def _route_execution(
        self, client: str, transactions: List[bytes], sheds: Dict[str, int]
    ) -> List[Tuple[str, List[bytes]]]:
        """Identity-backed fairness lanes + pre-consensus execution shed.

        Execution transactions are re-laned by the ACCOUNT they spend from
        (``acct:<key>``), not by the client-chosen lane token — one identity
        hammering the pool through many connections still competes as one
        lane, and one gateway fronting many identities no longer serializes
        them behind a single token.  Transactions already doomed against
        current account state (bad nonce, overdraft, unknown account,
        CREATE of an existing account) are shed with a typed verdict BEFORE
        consensus sequences them.  Non-execution payloads keep the caller's
        lane untouched.  No locks are held here: ``admission_verdict`` takes
        the execution lock internally and ``Mempool.submit`` is called after
        (lock-order discipline).
        """
        from .execution import parse_exec_tx

        lanes: "OrderedDict[str, List[bytes]]" = OrderedDict()
        for tx in transactions:
            parsed = parse_exec_tx(tx)
            if parsed is None:
                lanes.setdefault(client, []).append(tx)
                continue
            verdict = self.execution.admission_verdict(parsed)
            if verdict is not None:
                sheds[verdict] = sheds.get(verdict, 0) + 1
                continue
            lanes.setdefault(f"acct:{parsed.account.hex()}", []).append(tx)
        return list(lanes.items())

    def drain(self, budget: int) -> List[bytes]:
        return self.mempool.drain(budget)

    def pending(self) -> int:
        return self.mempool.pending()

    def _count_sheds(
        self, client: str, sheds: Dict[str, int], retry_ms: int
    ) -> None:
        t = round(self.clock(), 6)
        for reason in sorted(sheds):
            count = sheds[reason]
            with self._accounting_lock:
                self.shed_by_reason[reason] = (
                    self.shed_by_reason.get(reason, 0) + count
                )
                if len(self.shed_log) < self.params.shed_log_capacity:
                    self.shed_log.append(
                        {
                            "t": t,
                            "client": client,
                            "reason": reason,
                            "n": count,
                            "retry_after_ms": retry_ms,
                        }
                    )
                else:
                    self._shed_log_dropped += count
            if self.metrics is not None:
                self.metrics.mysticeti_ingress_shed_total.labels(reason).inc(
                    count
                )

    def shed_total(self) -> int:
        with self._accounting_lock:
            return sum(self.shed_by_reason.values())

    def shed_log_bytes(self) -> bytes:
        """Canonical shed schedule — byte-identical across same-seed sims."""
        with self._accounting_lock:
            return _canonical(self.shed_log)

    def shed_schedule_digest(self) -> str:
        return hashlib.sha256(self.shed_log_bytes()).hexdigest()

    # -- the AIMD tick --

    def _signals(self) -> dict:
        signals: dict = {"mempool_occupancy": self.mempool.occupancy()}
        syncer = self._net_syncer
        if syncer is not None:
            # backpressure() already includes the core's wal_backlog tap.
            signals.update(syncer.backpressure())
        elif self._core is not None:
            # A known bug once lived here: a real drain thread's queue depth
            # steering virtual-time admission.  It is safe ONLY because
            # sims construct the WAL with async_writes=False (walf), making
            # pending() constantly False in virtual time — that discipline
            # is what the suppression asserts.
            signals["wal_backlog"] = bool(self._core.wal_writer.pending())  # lint: ignore[sim-taint]
        verifier = self._block_verifier
        state_fn = getattr(verifier, "health_state", None)
        if state_fn is not None:
            state = state_fn()
            depth = state.get("pipeline_depth") or 0
            if depth:
                signals["verify_occupancy"] = (
                    (state.get("pipeline_inflight") or 0) / depth
                )
        health = self._health
        if health is not None and health.last_snapshot is not None:
            signals["commit_rate"] = health.last_snapshot.get(
                "commit_rate", 0.0
            )
        return signals

    def tick(self) -> dict:
        """One controller step + gauge refresh; returns the signal dict."""
        signals = self._signals()
        congested = self.controller.tick(signals)
        shed_mode = self.controller.shed_mode
        if shed_mode != self._last_shed_mode:
            log.info(
                "ingress shed mode %s (rate %.0f tx/s%s)",
                "ON" if shed_mode else "off",
                self.controller.rate,
                f"; congested: {','.join(congested)}" if congested else "",
            )
            if self.recorder is not None:
                self.recorder.record(
                    "shed-mode",
                    on=shed_mode,
                    rate=round(self.controller.rate, 1),
                    congested=",".join(congested),
                )
            self._last_shed_mode = shed_mode
        self._export_gauges(shed_mode)
        return signals

    def _export_gauges(self, shed_mode: bool) -> None:
        m = self.metrics
        if m is None:
            return
        m.mysticeti_ingress_admitted_rate.set(round(self.controller.rate, 3))
        m.mysticeti_ingress_mempool_transactions.set(self.mempool.pending())
        m.mysticeti_ingress_mempool_bytes.set(self.mempool.pending_bytes())
        m.mysticeti_ingress_shed_mode.set(1 if shed_mode else 0)
        if self.finality is not None:
            self.finality.export_gauges()

    # -- commit feed (wired via CommitObserver.ingress) --

    def note_committed(self, committed, t_commit: Optional[float] = None) -> None:
        """Feed from the committed sequence: track commit height and, when
        subscribers or the finality tracker exist, extract the committed
        transactions' ingress keys per sub-dag
        (finalization_interpreter.py is the offline oracle the tests
        cross-check this stream against).  ``t_commit`` is the observer's
        commit-decision time for the finality commit phase (defaults to
        now = the finalize time)."""
        from .types import Share

        if not committed:
            return
        self.commit_height = committed[-1].height
        fin = self.finality
        if not self._commit_sinks and fin is None:
            return
        now = self.clock()
        if t_commit is None:
            t_commit = now
        for commit in committed:
            keys: List[bytes] = []
            for block in commit.blocks:
                for st in block.statements:
                    if isinstance(st, Share):
                        keys.append(ingress_key(st.transaction))
            if fin is not None:
                for key in keys:
                    if fin.sampled(key):
                        fin.on_commit(key, t_commit, now)
            if not self._commit_sinks and self.execution is None:
                continue
            # Duck-typed commits (tests) may lack an anchor; default to 0.
            anchor = getattr(commit, "anchor", None)
            info = {
                "leader_round": int(anchor.round) if anchor is not None else 0,
                "committed_ts_ns": int(timestamp_utc() * 1e9),
            }
            if self.execution is not None:
                # Defer: the syncer calls this observer feed BEFORE the core
                # folds the commit through the execution state machine; the
                # _on_executed listener flushes the notification with the
                # executed root attached — same synchronous loop pass,
                # microseconds later, but the client frame then carries
                # RESULTS, not just sequencing.
                self._pending_exec.append((commit.height, keys, info))
                continue
            self._dispatch(commit.height, keys, info)

    def _dispatch(self, height: int, keys: List[bytes], info: dict) -> None:
        for sink in list(self._commit_sinks):
            try:
                sink(height, keys, info)
            except Exception:  # noqa: BLE001 - a dead sink must not stall commits
                log.exception("ingress commit sink failed; removing")
                self.remove_commit_sink(sink)

    def _on_executed(self, result) -> None:
        """Core execution listener: a committed sub-dag was folded.  Closes
        the ``execute`` finality phase for sampled keys and flushes the
        deferred commit notifications with the executed root attached
        (stale buffered heights — possible only across a snapshot jump —
        fall back to the recent-root window)."""
        self.executed_height = result.height
        self.executed_root = result.root
        fin = self.finality
        now = self.clock()
        while self._pending_exec and self._pending_exec[0][0] <= result.height:
            height, keys, info = self._pending_exec.popleft()
            if height == result.height:
                root = result.root
            else:
                root = self.execution.root_at(height) or result.root
            info["executed_height"] = height
            info["executed_root"] = root
            if fin is not None:
                fin.on_execute([k for k in keys if fin.sampled(k)], now)
            self._dispatch(height, keys, info)
        if self.recorder is not None and result.rejected:
            self.recorder.record(
                "exec-reject",
                height=result.height,
                rejected=result.rejected,
                root=result.root.hex()[:16],
            )

    # -- health / diagnosis --

    def health_state(self) -> dict:
        with self._accounting_lock:
            admitted_total = self.admitted_total
            shed_by_reason = dict(sorted(self.shed_by_reason.items()))
        return {
            "admitted_rate_tx_s": round(self.controller.rate, 3),
            "shed_mode": self.controller.shed_mode,
            "mempool_transactions": self.mempool.pending(),
            "mempool_bytes": self.mempool.pending_bytes(),
            "mempool_occupancy": round(self.mempool.occupancy(), 6),
            "admitted_total": admitted_total,
            "shed_by_reason": shed_by_reason,
            "commit_height": self.commit_height,
            **(
                {"finality": self.finality.state()}
                if self.finality is not None
                else {}
            ),
            **(
                {
                    "execution": {
                        "executed_height": self.execution.last_height,
                        "executed_root": self.execution.root.hex(),
                    }
                }
                if self.execution is not None
                else {}
            ),
        }

    # -- lifecycle (production nodes; sims drive tick() via the loop too) --

    def start(self) -> "IngressPlane":
        if self._task is None:
            self._task = spawn_logged(self._run(), log, name="ingress-tick")
        return self

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.params.tick_interval_s)
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the controller must outlive glitches
                log.exception("ingress tick failed")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


# ---------------------------------------------------------------------------
# Client RPC gateway


class IngressGateway:
    """Client-facing listener: SUBMIT -> ACK/QUEUED/SHED + commit stream.

    Rides the mesh's length-prefixed framing and codec (wire tags 13-16)
    but on its OWN listener — gateway tags never appear on the validator
    mesh.  Each connection gets a default fairness lane; a client may name
    its lane via ``GatewaySubmit.client`` (trust notes: docs/ingress.md —
    lane tokens are client-chosen, so per-lane caps bound the damage one
    identity can do, and the listener should face the public only behind
    an authenticating proxy).

    All writes for one connection flow through a single outbound queue so
    submit replies and commit notifications never interleave mid-frame.
    """

    def __init__(self, plane: IngressPlane, host: str, port: int) -> None:
        self.plane = plane
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_seq = 0
        self.connections = 0

    async def start(self) -> "IngressGateway":
        self._server = await asyncio.start_server(
            self._handle, host=self.host, port=self.port
        )
        log.info("ingress gateway listening on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        # Swap before awaiting: a second stop() racing past the await of the
        # first must see None, not close an already-closing server.
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    async def _handle(self, reader, writer) -> None:
        self._conn_seq += 1
        conn_id = self._conn_seq
        default_lane = f"conn-{conn_id}"
        outbound: asyncio.Queue = asyncio.Queue(maxsize=256)
        sink = None
        self.connections += 1
        if self.plane.metrics is not None:
            self.plane.metrics.mysticeti_ingress_gateway_clients.set(
                self.connections
            )

        async def write_loop() -> None:
            while True:
                msg = await outbound.get()
                _write_frame(writer, encode_message(msg))
                await writer.drain()

        writer_task = spawn_logged(
            write_loop(), log, name=f"gateway-writer-{conn_id}"
        )
        try:
            while True:
                frame = await _read_frame(reader)
                msg = decode_message(frame)
                if isinstance(msg, GatewaySubmit):
                    lane = (
                        msg.client.decode("utf-8", errors="replace")
                        if msg.client
                        else default_lane
                    )
                    result = self.plane.submit(
                        lane,
                        list(msg.transactions),
                        priority=bool(msg.priority),
                    )
                    await outbound.put(
                        GatewaySubmitReply(
                            result.status,
                            result.accepted,
                            result.shed,
                            result.retry_after_ms,
                            result.reason.encode(),
                        )
                    )
                elif isinstance(msg, GatewaySubscribeCommits):
                    # A later subscribe on the same connection REPLACES the
                    # filter (wire-format §5b): silently ignoring it would
                    # leave the client processing notifications it asked to
                    # suppress.
                    if sink is not None:
                        self.plane.remove_commit_sink(sink)
                    from_height = msg.from_height
                    # §5b soft extension: only clients that opted in get
                    # the detail suffix — a pre-r17 client would reset the
                    # connection on the longer frame otherwise.
                    want_details = bool(getattr(msg, "want_details", 0))
                    # §5b second-tier extension (r20): want_executed adds
                    # the EXECUTED result suffix (state root per commit)
                    # and IMPLIES the detail suffix on the wire.
                    want_executed = bool(getattr(msg, "want_executed", 0))

                    # Live stream only: from_height FILTERS future
                    # notifications, it does not replay commits that
                    # happened before the subscription (wire-format §5b
                    # documents the gap contract for resuming clients; the
                    # synthetic executed-height notification below pins
                    # where a resuming client's unknown window ends).
                    def sink(height, keys, info, q=outbound, fh=from_height,
                             details=want_details, executed=want_executed):
                        if height <= fh:
                            return
                        root = (
                            info.get("executed_root", b"") if executed else b""
                        )
                        if details or root:
                            note = GatewayCommitNotification(
                                height,
                                tuple(keys),
                                leader_round=int(
                                    info.get("leader_round", 0)
                                ),
                                committed_ts_ns=int(
                                    info.get("committed_ts_ns", 0)
                                ),
                                executed_root=root,
                            )
                        else:
                            note = GatewayCommitNotification(
                                height, tuple(keys)
                            )
                        try:
                            q.put_nowait(note)
                        except asyncio.QueueFull:
                            # A client not reading its notifications loses
                            # them (bounded queue, never the node's
                            # memory); counted, not silent.
                            m = self.plane.metrics
                            if m is not None:
                                m.mysticeti_ingress_shed_total.labels(
                                    "notify_backpressure"
                                ).inc(len(keys))
                            return
                        fin = self.plane.finality
                        if fin is not None:
                            fin.on_notify(
                                [k for k in keys if fin.sampled(k)],
                                fin.clock(),
                            )

                    self.plane.add_commit_sink(sink)
                    if want_executed and self.plane.execution is not None:
                        # Resume-gap fix: an immediate synthetic
                        # notification (no keys) tells the subscriber
                        # exactly where its unknown window ends — the
                        # node's current executed height and root.  A
                        # resuming client diffs this against its own last
                        # known height before trusting the live stream.
                        await outbound.put(
                            GatewayCommitNotification(
                                self.plane.execution.last_height,
                                (),
                                executed_root=self.plane.execution.root,
                            )
                        )
                else:
                    log.warning(
                        "gateway conn %d sent non-gateway message %s; closing",
                        conn_id,
                        type(msg).__name__,
                    )
                    break
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except Exception:  # noqa: BLE001 - malformed client input: drop the conn
            log.warning("gateway conn %d failed; closing", conn_id, exc_info=True)
        finally:
            self.connections -= 1
            if self.plane.metrics is not None:
                self.plane.metrics.mysticeti_ingress_gateway_clients.set(
                    self.connections
                )
            if sink is not None:
                self.plane.remove_commit_sink(sink)
            writer_task.cancel()
            writer.close()


# ---------------------------------------------------------------------------
# Deterministic overload simulation (the OVERLOAD scenario tier)


@dataclass
class OverloadScenario:
    """Declarative seeded overload run on the virtual-time simulator.

    ``multiplier_schedule`` is ``[(t_offset_s, multiplier), ...]`` over
    ``base_tps`` — the offered-load ramp.  The small ``max_per_proposal``
    reproduces saturation in virtual time (the simulator does not model
    host CPU, so per-proposal capacity is the binding resource, exactly as
    SOFT_MAX is on a real fleet)."""

    seed: int = 0
    nodes: int = 10
    duration_s: float = 15.0
    base_tps: int = 150
    multiplier_schedule: List[Tuple[float, float]] = field(
        default_factory=lambda: [(0.0, 1.0)]
    )
    closed_loop: bool = False
    transaction_size: int = 32
    max_per_proposal: int = 50
    mempool_max_transactions: int = 1500
    leader_timeout_s: float = 1.0
    # Fairness: split each node's offered load across this many distinct
    # client lanes (1 = the handler's own "local" lane).
    clients_per_node: int = 1
    # Dedup: when True, every node also hosts a client that re-submits the
    # SAME batch forever — only its first submission is fresh, the rest must
    # shed as duplicates.
    duplicate_flood: bool = False

    def ingress_parameters(self) -> IngressParameters:
        return IngressParameters(
            mempool_max_transactions=self.mempool_max_transactions,
            mempool_max_bytes=self.mempool_max_transactions
            * max(self.transaction_size, 64),
            lane_max_transactions=self.mempool_max_transactions,
            max_per_proposal=self.max_per_proposal,
            admission_initial_tx_s=float(self.base_tps * 4),
            admission_min_tx_s=float(max(self.base_tps // 4, 10)),
            admission_additive_tx_s=float(max(self.base_tps // 10, 5)),
            tick_interval_s=0.5,
        )

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "nodes": self.nodes,
            "duration_s": self.duration_s,
            "base_tps": self.base_tps,
            "multiplier_schedule": [list(m) for m in self.multiplier_schedule],
            "closed_loop": self.closed_loop,
            "transaction_size": self.transaction_size,
            "max_per_proposal": self.max_per_proposal,
            "mempool_max_transactions": self.mempool_max_transactions,
            "leader_timeout_s": self.leader_timeout_s,
            "clients_per_node": self.clients_per_node,
            "duplicate_flood": self.duplicate_flood,
        }


@dataclass
class OverloadReport:
    """What an overload scenario pins: throughput, full shed accounting,
    fairness, and the deterministic shed schedule."""

    committed_tx: int
    committed_tx_s: float
    offered_tx: int
    admitted_tx: int
    shed_by_reason: Dict[str, int]
    shed_log_bytes: bytes
    shed_schedule_digest: str
    lane_stats: Dict[str, dict]
    commit_heights: Dict[int, int]
    generator_stats: Dict[str, dict]
    shed_mode_entered: bool
    # Finality SLI plane (defaults keep older constructors working):
    # fleet-merged server-side submit→finalized and client-observed
    # submit→notification percentiles over the sampled keys.
    server_finality: Dict[str, float] = field(default_factory=dict)
    client_finality: Dict[str, float] = field(default_factory=dict)


def run_overload_sim(scenario: OverloadScenario) -> OverloadReport:
    """Run one seeded overload scenario to completion on a fresh
    DeterministicLoop; commit safety is audited by the chaos tier's
    :class:`~mysticeti_tpu_torch.chaos.SafetyChecker` (prefix consistency across
    the fleet survives overload)."""
    import os
    import shutil
    import tempfile

    from .block_handler import BenchmarkFastPathBlockHandler
    from .block_store import BlockStore
    from .chaos import SafetyChecker, _SimNodeNetwork
    from .commit_observer import TestCommitObserver
    from .committee import Committee
    from .config import Parameters
    from .core import Core, CoreOptions
    from .net_sync import NetworkSyncer
    from .runtime.simulated import run_simulation
    from .simulated_network import SimulatedNetwork
    from .transactions_generator import TransactionGenerator
    from .types import Share
    from .wal import walf

    n = scenario.nodes
    committee = Committee.new_test([1] * n)
    signers = Committee.benchmark_signers(n)
    parameters = Parameters(leader_timeout_s=scenario.leader_timeout_s)
    checker = SafetyChecker()
    share_counts: Dict[int, int] = {a: 0 for a in range(n)}

    class _CountingObserver(TestCommitObserver):
        """Counts committed Share statements per node, feeds the ingress
        commit hook and the cross-node safety audit."""

        def __init__(self, authority, plane, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._authority = authority
            self._plane = plane

        def handle_commit(self, committed_leaders):
            committed = super().handle_commit(committed_leaders)
            for commit in committed:
                for block in commit.blocks:
                    share_counts[self._authority] += sum(
                        1 for st in block.statements if isinstance(st, Share)
                    )
            self._plane.note_committed(committed)
            checker.observe(self._authority, committed)
            return committed

    tmp_dir = tempfile.mkdtemp(prefix="overload-sim-")
    planes: List[IngressPlane] = []
    generators: Dict[str, TransactionGenerator] = {}
    nodes: List[NetworkSyncer] = []
    flood_tasks: List[asyncio.Task] = []
    flood_offered = [0]  # offered-load ledger for the duplicate flooders

    async def _duplicate_flood(plane: IngressPlane, seed: int) -> None:
        """Re-submit one fixed batch forever: everything past the first
        submission must shed as duplicate."""
        import random as _random

        rng = _random.Random(seed)
        batch = [
            rng.getrandbits(64).to_bytes(8, "little")
            * (scenario.transaction_size // 8)
            for _ in range(10)
        ]
        while True:
            plane.submit("flooder", batch)
            flood_offered[0] += len(batch)
            await asyncio.sleep(0.5)

    async def main() -> None:
        sim_net = SimulatedNetwork(n)
        for authority in range(n):
            # Synchronous WAL: the async writer's drain THREAD runs in
            # wall-clock time, and the admission controller observes its
            # progress through the wal_backlog signal — with async writes
            # a seeded virtual-time run would absorb real thread timing
            # and the committed sequence would drift across same-seed runs.
            wal_writer, wal_reader = walf(
                os.path.join(tmp_dir, f"wal-{authority}"), async_writes=False
            )
            recovered, observer_recovered = BlockStore.open(
                authority, wal_reader, wal_writer, committee
            )
            plane = IngressPlane(
                scenario.ingress_parameters(), authority=authority
            )
            handler = BenchmarkFastPathBlockHandler(
                committee, authority, ingress=plane
            )
            core = Core(
                block_handler=handler,
                authority=authority,
                committee=committee,
                parameters=parameters,
                recovered=recovered,
                wal_writer=wal_writer,
                options=CoreOptions.test(),
                signer=signers[authority],
            )
            observer = _CountingObserver(
                authority,
                plane,
                core.block_store,
                committee,
                transaction_time=handler.transaction_time,
                recovered_state=observer_recovered,
            )

            node = NetworkSyncer(
                core,
                observer,
                _SimNodeNetwork(sim_net.node_connections[authority]),
                parameters=parameters,
            )
            plane.attach(core=core, net_syncer=node)
            clients = max(1, scenario.clients_per_node)
            for i in range(clients):
                if clients == 1:
                    submit_fn = handler.submit
                    name = f"a{authority}/local"
                else:
                    submit_fn = (
                        lambda txs, p=plane, c=f"client-{i}": p.submit(c, txs)
                    )
                    name = f"a{authority}/client-{i}"
                generator = TransactionGenerator(
                    submit=submit_fn,
                    seed=scenario.seed * 1000 + authority * 16 + i,
                    tps=max(1, scenario.base_tps // clients),
                    transaction_size=scenario.transaction_size,
                    overload_schedule=list(scenario.multiplier_schedule),
                    closed_loop=scenario.closed_loop,
                    finality_sample_every=(
                        scenario.ingress_parameters().finality_sample_every
                    ),
                )
                generators[name] = generator
                # Client-observed finality: this node's commit stream
                # closes the client's sampled submit stamps (the sim's
                # stand-in for a gateway subscription).
                plane.add_commit_sink(
                    lambda height, keys, info, g=generator: (
                        g.note_commit_notification(keys, info)
                    )
                )
            planes.append(plane)
            nodes.append(node)
        for node in nodes:
            await node.start()
        await sim_net.connect_all()
        for authority, plane in enumerate(planes):
            plane.start()
            if scenario.duplicate_flood:
                flood_tasks.append(
                    spawn_logged(
                        _duplicate_flood(
                            plane, scenario.seed * 7919 + authority
                        ),
                        log,
                        name=f"dup-flood-{authority}",
                    )
                )
        for generator in generators.values():
            generator.start()
        await asyncio.sleep(scenario.duration_s)
        for task in flood_tasks:
            task.cancel()
        for generator in generators.values():
            generator.stop()
        for plane in planes:
            plane.stop()
        for node in nodes:
            await node.stop()
            node.core.wal_writer.close()
            node.core.block_store.close()
        sim_net.close()

    try:
        run_simulation(main(), seed=scenario.seed)
    finally:
        # The per-node WAL segments are scratch: every sim (CLI, bench
        # determinism leg, tier-1 tests) would otherwise leave an
        # overload-sim-* directory in /tmp forever.
        shutil.rmtree(tmp_dir, ignore_errors=True)
    checker.check()
    shed_by_reason: Dict[str, int] = {}
    for plane in planes:
        for reason, count in plane.shed_by_reason.items():
            shed_by_reason[reason] = shed_by_reason.get(reason, 0) + count
    offered = sum(g.submitted for g in generators.values()) + flood_offered[0]
    admitted = sum(p.admitted_total for p in planes)
    committed = share_counts[0]
    return OverloadReport(
        committed_tx=committed,
        committed_tx_s=round(committed / scenario.duration_s, 3),
        offered_tx=offered,
        admitted_tx=admitted,
        shed_by_reason=shed_by_reason,
        shed_log_bytes=planes[0].shed_log_bytes(),
        shed_schedule_digest=planes[0].shed_schedule_digest(),
        lane_stats=planes[0].mempool.lane_stats(),
        commit_heights={
            a: checker.committed_height(a) for a in range(n)
        },
        generator_stats={
            name: gen.stats() for name, gen in sorted(generators.items())
        },
        shed_mode_entered=any(
            entry["reason"] == SHED_ADMISSION
            for plane in planes
            for entry in plane.shed_log
        )
        or any(p.controller.shed_mode for p in planes),
        server_finality=_merged_finality(
            [p.finality for p in planes if p.finality is not None]
        ),
        client_finality=_merged_finality(
            [g.finality for g in generators.values() if g.finality is not None]
        ),
    )


def _merged_finality(trackers) -> Dict[str, float]:
    """Fleet-merged finality percentiles over every tracker's recent
    samples (server planes or client recorders — both expose samples())."""
    from .finality import percentile

    samples: List[float] = []
    completed = 0
    for tracker in trackers:
        samples.extend(tracker.samples())
        completed += tracker.completed
    return {
        "p50_s": round(percentile(samples, 0.50), 6),
        "p99_s": round(percentile(samples, 0.99), 6),
        "samples": len(samples),
        "completed": completed,
    }
