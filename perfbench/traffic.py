"""The one traffic generator: blocks and their frames, from a configuration,
a traffic mix (both plain data files) and the seed.

Blocks form an honest DAG: each round's block of each author includes every
block of the round before (the genesis blocks for round 1).  A seeded share
of blocks (the configuration's ``assumed.forged_share``) carries a forged
signature: a valid signature of its signed digest under another committee
member's key, as a Byzantine member can send; each still costs a verify
lane.  The receiving validator is authority 0.

A mix (``kind`` ``catchup``) is a rejoining validator draining every peer's
backlog of ``backlog_rounds`` rounds of ``tx_per_block`` transactions a
block.  Each peer sends its own blocks in round order, in frames of at most
``frame_blocks`` blocks and ``max_frame_bytes`` bytes.  The receiver's own
blocks do not exist (it was down).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import wire

RECEIVER = 0
META_NS_BASE = 1_700_000_000_000_000_000
ROUND_NS = 66_000_000
# Bytes a frame adds to its blocks: the message tag, the list count, and a
# length prefix a block (docs/wire-format.md §1, §5).
FRAME_HEADER = 1 + 4
FRAME_PER_BLOCK = 4


@dataclass
class Pool:
    raws: List[bytes]
    author: np.ndarray
    round: np.ndarray
    # The generator's own record.  The comparison reads it only to pick the
    # blocks where a wrong accept can occur; their verdicts are the reference's.
    forged: np.ndarray
    committee_size: int
    # Per peer, its frames, each a list of pool indices.
    frames_by_peer: List[List[List[int]]] = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        return sum(len(r) for r in self.raws)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


def build_pool(config: dict, mix: dict, seed: int, keys) -> Pool:
    n = int(config["committee_size"])
    size = int(config["transaction_size"])
    epoch = int(config.get("epoch", 0))
    forged_share = float(config["assumed"]["forged_share"])
    if mix["kind"] != "catchup":
        raise ValueError(f"no generator for traffic of kind {mix['kind']!r}")
    n_tx = int(mix["tx_per_block"])
    rounds = int(mix["backlog_rounds"])
    authors = [a for a in range(n) if a != RECEIVER]
    rng = rng_for(seed, 1)

    n_blocks = rounds * len(authors)
    payload = np.frombuffer(rng.bytes(n_blocks * n_tx * size), np.uint8)
    statements = wire.share_rows(payload.reshape(n_blocks, n_tx, size))
    del payload
    forged = rng.random(n_blocks) < forged_share

    prev = [wire.reference_bytes(a, 0, wire.genesis_digest(a, epoch)) for a in authors]
    raws, author_of, round_of = [], [], []
    for r in range(1, rounds + 1):
        includes = b"".join(prev)
        cur = []
        for a in authors:
            b = len(raws)
            unsigned = wire.unsigned_bytes(
                a, r, includes, len(prev), statements[b].tobytes(), n_tx,
                META_NS_BASE + r * ROUND_NS, epoch)
            signer = keys[(a + 1) % n] if forged[b] else keys[a]
            full, digest, _ = wire.sign_block(unsigned, signer)
            raws.append(full)
            author_of.append(a)
            round_of.append(r)
            cur.append(wire.reference_bytes(a, r, digest))
        prev = cur
    del statements
    pool = Pool(raws, np.array(author_of), np.array(round_of), forged, n)
    pool.frames_by_peer = catchup_frames(pool, int(mix["frame_blocks"]), int(mix["max_frame_bytes"]))
    return pool


def catchup_frames(pool: Pool, frame_blocks: int, max_frame_bytes: int) -> List[List[List[int]]]:
    """Each peer's own blocks in round order, cut into frames."""
    out = []
    for peer in range(pool.committee_size):
        if peer == RECEIVER:
            continue
        frames, cur, cur_bytes = [], [], FRAME_HEADER
        for i in np.flatnonzero(pool.author == peer):
            need = FRAME_PER_BLOCK + len(pool.raws[i])
            if cur and (len(cur) == frame_blocks or cur_bytes + need > max_frame_bytes):
                frames.append(cur)
                cur, cur_bytes = [], FRAME_HEADER
            if FRAME_HEADER + need > max_frame_bytes:
                raise ValueError(f"a block of {len(pool.raws[i])} B does not fit a frame")
            cur.append(int(i))
            cur_bytes += need
        if cur:
            frames.append(cur)
        out.append(frames)
    return out
