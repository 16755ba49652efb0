"""Append-only text log of processed transaction locators.

The port's copy of ``mysticeti_tpu.log``.

Capability parity with ``mysticeti-core/src/log.rs``: a ``TransactionLog`` opened
for write that records each certified/committed locator on its own line
(log.rs:10-33).  The reference offloads writes to a blocking tokio pool; here a
buffered writer + explicit flush keeps the consensus owner task non-blocking in
practice (page-cache writes), and the bench harness reads the file back for the
safety cross-checks.
"""
from __future__ import annotations

import io
from typing import Iterable, List

from .types import TransactionLocator


class TransactionLog:
    """File-backed sink usable as a TransactionAggregator handler hook."""

    __slots__ = ("_file", "_last_block", "_last_prefix")

    def __init__(self, path: str) -> None:
        self._file = open(path, "a", buffering=1 << 16)
        self._last_block = None
        self._last_prefix = ""

    @classmethod
    def start(cls, path: str) -> "TransactionLog":
        return cls(path)

    def log(self, locator: TransactionLocator) -> None:
        # Certified locators arrive in per-block runs; hex-encoding the digest
        # once per block (not per transaction) halves this hook's cost at load.
        blk = locator.block
        if blk is not self._last_block:
            self._last_block = blk
            self._last_prefix = f"{blk.authority},{blk.round},{blk.digest.hex()},"
        self._file.write(f"{self._last_prefix}{locator.offset}\n")

    def log_all(self, locators: Iterable[TransactionLocator]) -> None:
        for loc in locators:
            self.log(loc)

    def log_range(self, block, start: int, end: int) -> None:
        """Bulk form: one line per offset, identical format to ``log`` —
        certification arrives in contiguous runs and the per-line method
        call + f-string was measurable at fleet saturation."""
        if start >= end:
            return
        prefix = f"{block.authority},{block.round},{block.digest.hex()},"
        self._last_block = block
        self._last_prefix = prefix
        # map(str, range) keeps the per-offset work in C: a per-line
        # f-string re-rendered the constant prefix 1.4M times per
        # measurement window at saturation.
        self._file.write(
            prefix
            + ("\n" + prefix).join(map(str, range(start, end)))
            + "\n"
        )

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    @staticmethod
    def read_locators(path: str) -> List[TransactionLocator]:
        from .types import BlockReference

        out = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                a, r, d, off = line.strip().split(",")
                out.append(
                    TransactionLocator(
                        BlockReference(int(a), int(r), bytes.fromhex(d)), int(off)
                    )
                )
        return out
