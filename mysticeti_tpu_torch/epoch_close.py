"""Epoch-close state machine: Open -> BeginChange -> SafeToClose.

The port's copy of ``mysticeti_tpu.epoch_close``.

Capability parity with ``mysticeti-core/src/epoch_close.rs``:

* ``epoch_change_begun`` (:24-29) — entered when the committed-leader round passes
  ``rounds_in_epoch`` (driven from Core.try_commit, core.rs:376-379).
* ``observe_committed_block`` (:31-42) — once committed blocks carrying the epoch
  marker reach quorum stake, the epoch is safe to close; the closing timestamp is
  recorded for the shutdown grace logic (net_sync.rs:466-494).
"""
from __future__ import annotations

import time

from .committee import Committee, QUORUM, StakeAggregator
from .types import StatementBlock

OPEN = 0
BEGIN_CHANGE = 1
SAFE_TO_CLOSE = 2


class EpochManager:
    __slots__ = ("status", "change_aggregator", "epoch_close_time_ms")

    def __init__(self) -> None:
        self.status = OPEN
        self.change_aggregator = StakeAggregator(QUORUM)
        self.epoch_close_time_ms = 0

    def epoch_change_begun(self) -> None:
        if self.status == OPEN:
            self.status = BEGIN_CHANGE

    def observe_committed_block(self, block: StatementBlock, committee: Committee) -> None:
        if not block.epoch_changed():
            return
        is_quorum = self.change_aggregator.add(block.author(), committee)
        if is_quorum and self.status != SAFE_TO_CLOSE:
            # Agreement + total ordering imply we saw BeginChange first.
            assert self.status == BEGIN_CHANGE
            self.status = SAFE_TO_CLOSE
            self.epoch_close_time_ms = int(time.time() * 1000)

    def changing(self) -> bool:
        return self.status != OPEN

    def closed(self) -> bool:
        return self.status == SAFE_TO_CLOSE

    def closing_time(self) -> int:
        return self.epoch_close_time_ms
