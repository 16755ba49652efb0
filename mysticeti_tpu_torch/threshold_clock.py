"""Threshold clock validity of a non-genesis block.

The port's copy of ``threshold_clock_valid_non_genesis`` from
``mysticeti_tpu.threshold_clock`` (``mysticeti-core/src/threshold_clock.rs:12-35``):
a non-genesis block is valid iff all includes are from lower rounds AND the
authorities of its includes at exactly round-1 hold quorum stake.
"""
from __future__ import annotations

from .committee import Committee, QUORUM, StakeAggregator
from .types import StatementBlock


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
