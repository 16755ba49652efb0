"""Commit-rule decision ledger: why every leader slot committed or skipped.

The port's copy of ``mysticeti_tpu.decisions``.

The universal committer used to collapse every decision into a bare
``commit|skip`` counter label — the Byzantine scenarios and the
chaos-debugging workflow could see *that* a leader was skipped but never
*which* blames, certificates, or anchors decided it.  This module is the
"why" plane over the protocol's actual logic:

* :class:`DecisionTrace` — a per-slot collector the committer threads
  through :class:`~mysticeti_tpu_torch.consensus.base_committer.BaseCommitter`'s
  rule predicates: certificate and blame stake tallies with the
  contributing authorities, and the anchor used by an indirect decision.
  The predicates keep their early-return-on-quorum semantics, so the
  recorded contributors are exactly the deterministic prefix that reached
  the threshold.
* :class:`DecisionLedger` — a bounded, lock-disciplined ring of
  :class:`DecisionRecord` dicts, one per DECIDED leader slot (the committer
  only emits the longest decided prefix and the core advances its cursor
  past it, so every slot is recorded exactly once).  Undecided slots are
  tracked as a frontier snapshot per scan; a slot that was undecided on a
  previous scan and decides later is recorded as *flipped* and lands in the
  flight recorder (``decision-flip``), as does every skip
  (``decision-skip``).
* Canonical serialization (:meth:`DecisionLedger.ledger_bytes`) — sorted
  keys, no whitespace, runtime-clocked timestamps — so a seeded sim
  produces a byte-identical ledger every run (pinned by
  tests/test_decisions.py).
* :func:`explain_record` — the human-readable causal explanation
  ``tools/commit_explain.py`` renders for any (authority, round) slot.

Metrics: ``mysticeti_commit_decision_total{rule,outcome}`` (the migrated
``universal_committer.py`` skip/commit counter, now distinguishing
direct from indirect) and ``mysticeti_decision_rounds_behind`` (how far
behind the DAG frontier each slot was when it decided).
"""
from __future__ import annotations

import hashlib
import json
import threading
from collections import deque
from typing import Deque, Iterable, List, Optional, Set, Tuple

from .consensus import AuthorityRound, LeaderStatus
from .runtime import now as runtime_now

# Ring capacity: one record per decided leader slot; a busy fleet decides a
# few slots per second, so 4096 holds many minutes of decision history.
DEFAULT_CAPACITY = 4096


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


class DecisionTrace:
    """Mutable per-slot evidence collector threaded through the rules.

    The committer creates one per evaluated slot; the base committer's
    predicates fill it in as a side channel without changing any decision.
    ``note_certificates`` keeps the highest-stake tally seen — an
    equivocating leader has several candidate blocks and only the (at most
    one) certified tally should explain the slot.
    """

    __slots__ = (
        "blame_stake",
        "blame_authorities",
        "cert_stake",
        "cert_authorities",
        "anchor",
    )

    def __init__(self) -> None:
        self.blame_stake = 0
        self.blame_authorities: List[int] = []
        self.cert_stake = 0
        self.cert_authorities: List[int] = []
        self.anchor: Optional[str] = None

    def note_blames(self, aggregator) -> None:
        self.blame_stake = int(aggregator.stake)
        self.blame_authorities = sorted(int(a) for a in aggregator.voters())

    def note_certificates(self, aggregator) -> None:
        if int(aggregator.stake) >= self.cert_stake:
            self.cert_stake = int(aggregator.stake)
            self.cert_authorities = sorted(
                int(a) for a in aggregator.voters()
            )

    def note_anchor(self, anchor_slot: AuthorityRound) -> None:
        self.anchor = repr(anchor_slot)


def make_record(
    status: LeaderStatus,
    rule: str,
    trace: Optional[DecisionTrace],
    rounds_behind: int,
    t: float,
) -> dict:
    """One canonical ledger entry for a decided (or frontier) slot."""
    ar = status.authority_round
    record = {
        "authority": int(ar.authority),
        "round": int(ar.round),
        "slot": repr(ar),
        "rule": rule,
        "outcome": status.kind,
        "cert_stake": trace.cert_stake if trace else 0,
        "cert_authorities": list(trace.cert_authorities) if trace else [],
        "blame_stake": trace.blame_stake if trace else 0,
        "blame_authorities": list(trace.blame_authorities) if trace else [],
        "anchor": trace.anchor if trace else None,
        "rounds_behind": int(rounds_behind),
        "t": round(t, 6),
    }
    block = status.committed_block()
    if block is not None:
        ref = block.reference
        record["block"] = (
            f"A{ref.authority}R{ref.round}#{ref.digest[:4].hex()}"
        )
    else:
        record["block"] = None
    return record


class DecisionLedger:
    """Bounded ring of decision records for one node's committer."""

    def __init__(
        self,
        metrics=None,
        capacity: int = DEFAULT_CAPACITY,
        clock=runtime_now,
    ) -> None:
        self.metrics = metrics
        self.clock = clock
        self.capacity = max(1, capacity)
        # Flight recorder (flight_recorder.py), wired post-construction by
        # the node assembly exactly like block_store.recorder.
        self.recorder = None
        self._decision_lock = threading.Lock()
        # Guarded by _decision_lock (lint GUARDED_FIELDS): the loop thread
        # records during try_commit while the metrics endpoint serves
        # /debug/consensus and tools snapshot the canonical ledger.
        self._decision_ring: Deque[dict] = deque(maxlen=self.capacity)
        self._undecided_keys: Set[Tuple[int, int]] = set()
        self._undecided_slots: Tuple[str, ...] = ()
        self.recorded = 0
        self.dropped = 0

    # -- recording (loop thread, once per decided slot) --

    def record_decision(
        self,
        status: LeaderStatus,
        rule: str,
        trace: Optional[DecisionTrace],
        rounds_behind: int,
    ) -> dict:
        record = make_record(status, rule, trace, rounds_behind, self.clock())
        with self._decision_lock:
            key = (record["authority"], record["round"])
            flipped = key in self._undecided_keys
            if flipped:
                self._undecided_keys.discard(key)
            record["flipped"] = flipped
            if len(self._decision_ring) == self._decision_ring.maxlen:
                self.dropped += 1
            self._decision_ring.append(record)
            self.recorded += 1
        if self.metrics is not None:
            self.metrics.mysticeti_commit_decision_total.labels(
                rule, record["outcome"]
            ).inc()
            self.metrics.mysticeti_decision_rounds_behind.observe(
                float(rounds_behind)
            )
        recorder = self.recorder
        if recorder is not None:
            if record["outcome"] == LeaderStatus.SKIP:
                recorder.record(
                    "decision-skip",
                    slot=record["slot"],
                    rule=rule,
                    blame_stake=record["blame_stake"],
                    cert_stake=record["cert_stake"],
                    anchor=record["anchor"],
                    flipped=flipped or None,
                )
            elif flipped:
                recorder.record(
                    "decision-flip",
                    slot=record["slot"],
                    rule=rule,
                    outcome=record["outcome"],
                    rounds_behind=record["rounds_behind"],
                )
        return record

    def note_undecided(self, slots: Iterable[AuthorityRound]) -> None:
        """Note the undecided frontier after one try_commit scan (slots
        above the decided prefix that no rule could decide).

        Keys accumulate (union) so a slot that goes undecided → decided
        but unemitted → emitted across several scans still flags as
        flipped; a key is retired only when its slot is recorded.
        """
        slots = list(slots)
        with self._decision_lock:
            self._undecided_keys.update(
                (int(ar.authority), int(ar.round)) for ar in slots
            )
            self._undecided_slots = tuple(repr(ar) for ar in slots)

    # -- views --

    def records(self, last: Optional[int] = None) -> List[dict]:
        with self._decision_lock:
            records = list(self._decision_ring)
        return records[-last:] if last else records

    def lookup(self, authority: int, round_: int) -> Optional[dict]:
        """The newest record for one (authority, round) slot, or None."""
        with self._decision_lock:
            for record in reversed(self._decision_ring):
                if (
                    record["authority"] == authority
                    and record["round"] == round_
                ):
                    return dict(record)
        return None

    def undecided(self) -> List[str]:
        with self._decision_lock:
            return list(self._undecided_slots)

    def ledger_bytes(self) -> bytes:
        """Canonical serialization — byte-identical across same-seed sims."""
        with self._decision_lock:
            return _canonical(list(self._decision_ring))

    def digest(self) -> str:
        return hashlib.sha256(self.ledger_bytes()).hexdigest()

    def state(self) -> dict:
        with self._decision_lock:
            return {
                "recorded": self.recorded,
                "dropped": self.dropped,
                "undecided": list(self._undecided_slots),
            }


def explain_record(record: dict) -> str:
    """Human-readable causal explanation of one decision record (the
    ``tools/commit_explain.py`` renderer; deterministic for pinning)."""
    lines = [
        f"slot {record['slot']} (authority {record['authority']}, "
        f"round {record['round']}): "
        f"{record['outcome'].upper()} via the {record['rule']} rule"
    ]
    outcome = record["outcome"]
    rule = record["rule"]
    if outcome == "commit":
        voters = ",".join(str(a) for a in record["cert_authorities"])
        lines.append(
            f"  certificates: {record['cert_stake']} stake from "
            f"authorities [{voters}] certified the leader block "
            f"{record['block']}"
        )
        if rule == "indirect" and record.get("anchor"):
            lines.append(
                f"  anchor: committed leader {record['anchor']} carries a "
                "certified link to this slot"
            )
    elif outcome == "skip":
        if rule == "direct":
            blamers = ",".join(str(a) for a in record["blame_authorities"])
            lines.append(
                f"  blames: {record['blame_stake']} stake from authorities "
                f"[{blamers}] proposed in the voting round without linking "
                "this leader"
            )
        else:
            lines.append(
                f"  anchor: committed leader {record['anchor']} has no "
                "certified link to any block of this slot "
                f"(best certificate tally: {record['cert_stake']} stake)"
            )
    else:
        lines.append(
            "  undecided: neither 2f+1 blames nor 2f+1 certificates, and "
            "no committed anchor one wave ahead"
        )
    lines.append(
        f"  decided {record['rounds_behind']} rounds behind the DAG "
        f"frontier at t={record['t']:.6f}"
        + (" (flipped from undecided)" if record.get("flipped") else "")
    )
    return "\n".join(lines)
