"""Threshold clock: round advancement gated on a quorum of previous-round blocks.

The port's copy of ``mysticeti_tpu.threshold_clock``.  Capability parity with
``mysticeti-core/src/threshold_clock.rs``:

* ``threshold_clock_valid_non_genesis`` (threshold_clock.rs:12-35) — a non-genesis
  block is valid iff all includes are from lower rounds AND the authorities of its
  includes at exactly round-1 hold quorum stake.
* ``ThresholdClockAggregator`` (threshold_clock.rs:37-94) — tracks the highest round
  for which we have seen 2f+1 stake of blocks; seeing quorum at the current round
  advances the clock to round+1.
"""
from __future__ import annotations

import time
from typing import Optional

from .committee import Committee, QUORUM, StakeAggregator
from .types import BlockReference, RoundNumber, StatementBlock


def threshold_clock_valid_non_genesis(block: StatementBlock, committee: Committee) -> bool:
    round_number = block.round()
    assert round_number > 0
    for include in block.includes:
        if include.round >= round_number:
            return False
    aggregator = StakeAggregator(QUORUM)
    is_quorum = False
    for include in block.includes:
        if include.round == round_number - 1:
            is_quorum = aggregator.add(include.authority, committee)
    return is_quorum


class ThresholdClockAggregator:
    __slots__ = ("aggregator", "round", "last_quorum_ts", "_observe_quorum_latency")

    def __init__(self, round_: RoundNumber, metrics=None) -> None:
        self.aggregator = StakeAggregator(QUORUM)
        self.round = round_
        self.last_quorum_ts = time.monotonic()
        self._observe_quorum_latency = (
            metrics.quorum_receive_latency.observe if metrics is not None else None
        )

    def add_block(self, block: BlockReference, committee: Committee) -> None:
        if block.round < self.round:
            return  # stale
        if block.round > self.round:
            # Having processed a round-r block implies 2f+1 blocks at r-1 are stored.
            self.aggregator.clear()
            self.aggregator.add(block.authority, committee)
            self.round = block.round
        else:
            if self.aggregator.add(block.authority, committee):
                self.aggregator.clear()
                self.round = block.round + 1
                now = time.monotonic()
                if self._observe_quorum_latency is not None:
                    self._observe_quorum_latency(now - self.last_quorum_ts)
                self.last_quorum_ts = now

    def get_round(self) -> RoundNumber:
        return self.round
