"""Fault-injection schedules for benchmark runs.

The port's copy of ``mysticeti_tpu.orchestrator.faults``.

Capability parity with ``orchestrator/src/faults.rs``:

* ``FaultsType``: no faults, ``Permanent`` (kill ``faults`` nodes once), or
  ``CrashRecovery`` (cycle kills/boots on an interval) (:14-22).
* ``CrashRecoverySchedule.update`` — steps by thirds of the fault budget:
  kills grow 1/3, 2/3, 3/3 then recover in the same steps (:104-160).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Set, Tuple


@dataclass
class FaultsType:
    kind: str = "none"  # none | permanent | crash_recovery
    faults: int = 0
    interval_s: float = 60.0

    @classmethod
    def none(cls) -> "FaultsType":
        return cls()

    @classmethod
    def permanent(cls, faults: int) -> "FaultsType":
        return cls("permanent", faults)

    @classmethod
    def crash_recovery(cls, faults: int, interval_s: float = 60.0) -> "FaultsType":
        return cls("crash_recovery", faults, interval_s)

    def describe(self) -> str:
        if self.kind == "none" or self.faults == 0:
            return "0 faults"
        if self.kind == "permanent":
            return f"{self.faults} permanent faults"
        return f"{self.faults} crash-recovery faults every {self.interval_s:.0f}s"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "faults": self.faults, "interval_s": self.interval_s}


class CrashRecoverySchedule:
    """Stateful kill/boot stepper (faults.rs:104-160).

    Each ``update`` returns (to_kill, to_boot) node index lists.  The dead set
    grows by thirds of the fault budget until all ``faults`` nodes are down,
    then recovers in the same pattern — exercising WAL recovery under load.
    """

    def __init__(self, faults: FaultsType, committee_size: int) -> None:
        self.faults = faults
        self.committee_size = committee_size
        self.dead: Set[int] = set()
        self._step = 0

    def update(self) -> Tuple[List[int], List[int]]:
        if self.faults.kind == "none" or self.faults.faults == 0:
            return [], []
        budget = min(self.faults.faults, self.committee_size - 1)
        if self.faults.kind == "permanent":
            if self.dead:
                return [], []
            to_kill = list(range(self.committee_size - budget, self.committee_size))
            self.dead.update(to_kill)
            return to_kill, []

        third = max(1, budget // 3)
        killing_phase = (self._step // 3) % 2 == 0
        self._step += 1
        if killing_phase and len(self.dead) < budget:
            start = self.committee_size - budget
            candidates = [
                i
                for i in range(start, self.committee_size)
                if i not in self.dead
            ][:third]
            self.dead.update(candidates)
            return candidates, []
        if not killing_phase and self.dead:
            to_boot = sorted(self.dead)[:third]
            for b in to_boot:
                self.dead.discard(b)
            return [], to_boot
        return [], []
