"""Plain reference of the block-receive path: what a validator must derive
from a block's wire bytes (``docs/wire-format.md`` §3-4), worked out again
with ``struct``, ``hashlib`` and the plain verifier beside this file.

``identity`` gives (author, round, block digest, signed digest);
``decode`` parses every field strictly and raises ``ValueError`` on any
malformed input; ``structure_ok`` applies the structural rules of §4 with
equal stake; ``verdict`` is the whole accept or reject.
"""
from __future__ import annotations

import hashlib
import struct
from typing import List, Sequence, Tuple

from .ed25519 import Verifier

SIGNATURE_SIZE = 64


def blake2b_256(data) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def identity(raw: bytes) -> Tuple[int, int, bytes, bytes]:
    author, round_ = struct.unpack_from("<QQ", raw, 0)
    return author, round_, blake2b_256(raw), blake2b_256(memoryview(raw)[:-SIGNATURE_SIZE])


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated block")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def _locator(r: _Reader) -> None:
    r.take(48 + 8)


def decode(raw: bytes) -> dict:
    """Every field of the block; statements are counted by kind."""
    r = _Reader(raw)
    author, round_ = r.u64(), r.u64()
    includes: List[Tuple[int, int, bytes]] = []
    for _ in range(r.u32()):
        includes.append((r.u64(), r.u64(), r.take(32)))
    shares = votes = ranges = 0
    bad_range = False
    for _ in range(r.u32()):
        tag = r.u8()
        if tag == 0:
            r.take(r.u32())
            shares += 1
        elif tag == 1:
            _locator(r)
            vote = r.u8()
            if vote == 1:
                if r.u8():
                    _locator(r)
            elif vote != 0:
                raise ValueError("bad vote byte")
            votes += 1
        elif tag == 2:
            r.take(48)
            start, end = r.u64(), r.u64()
            bad_range |= end < start
            ranges += 1
        else:
            raise ValueError("unknown statement tag")
    meta_ns, marker, epoch = r.u64(), r.u8(), r.u64()
    signature = r.take(SIGNATURE_SIZE)
    if r.pos != len(raw):
        raise ValueError("trailing bytes")
    return dict(author=author, round=round_, includes=includes, shares=shares,
                votes=votes, ranges=ranges, bad_range=bad_range, meta_ns=meta_ns,
                epoch_marker=marker, epoch=epoch, signature=signature)


def structure_ok(block: dict, committee_size: int, epoch: int) -> bool:
    """§4's structural rules for an equal-stake committee: epoch, known
    authors, includes of earlier rounds, well-formed ranges, and includes of
    more than two thirds of the authorities at the round before."""
    n, rnd = committee_size, block["round"]
    if block["epoch"] != epoch or block["author"] >= n or rnd == 0 or block["bad_range"]:
        return False
    if any(a >= n or r >= rnd for a, r, _ in block["includes"]):
        return False
    quorum = {a for a, r, _ in block["includes"] if r == rnd - 1}
    return 3 * len(quorum) > 2 * n


class Reference:
    """The verdict on a block, for a committee of public keys (equal stake)."""

    def __init__(self, public_keys: Sequence[bytes], epoch: int = 0) -> None:
        self.public_keys = list(public_keys)
        self.epoch = epoch
        self.verifier = Verifier()

    def verdict(self, raw: bytes) -> bool:
        try:
            block = decode(raw)
        except ValueError:
            return False
        if not structure_ok(block, len(self.public_keys), self.epoch):
            return False
        _, _, _, signed_digest = identity(raw)
        return self.verifier.verify(self.public_keys[block["author"]], block["signature"], signed_digest)
