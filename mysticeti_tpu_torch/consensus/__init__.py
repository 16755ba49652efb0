"""The commit rule: wave-based direct/indirect decisions over the DAG.

The port's copy of ``mysticeti_tpu.consensus``.

Capability parity with ``mysticeti-core/src/consensus/mod.rs``:

* a wave = leader round + voting round(s) + decision round; minimum length 3
  (consensus/mod.rs:19-24)
* ``LeaderStatus``: Commit(block) | Skip(authority_round) | Undecided(authority_round)
  (consensus/mod.rs:30-34) with helpers ``round`` / ``authority`` / ``is_decided``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from ..types import AuthorityIndex, RoundNumber, StatementBlock

DEFAULT_WAVE_LENGTH = 3
MINIMUM_WAVE_LENGTH = 3

DIRECT = "direct"
INDIRECT = "indirect"


@dataclass(frozen=True, order=True)
class AuthorityRound:
    """(authority, round) pair naming a leader slot (types.rs AuthorityRound)."""

    authority: AuthorityIndex
    round: RoundNumber

    def __repr__(self) -> str:
        return f"{chr(ord('A') + self.authority % 26)}{self.round}"


class LeaderStatus:
    """Decision state of one leader slot (consensus/mod.rs:30-34)."""

    __slots__ = ("kind", "block", "authority_round")

    COMMIT = "commit"
    SKIP = "skip"
    UNDECIDED = "undecided"

    def __init__(self, kind: str, block: Optional[StatementBlock], ar: AuthorityRound):
        self.kind = kind
        self.block = block
        self.authority_round = ar

    @classmethod
    def commit(cls, block: StatementBlock) -> "LeaderStatus":
        return cls(cls.COMMIT, block, AuthorityRound(block.author(), block.round()))

    @classmethod
    def skip(cls, ar: AuthorityRound) -> "LeaderStatus":
        return cls(cls.SKIP, None, ar)

    @classmethod
    def undecided(cls, ar: AuthorityRound) -> "LeaderStatus":
        return cls(cls.UNDECIDED, None, ar)

    @property
    def round(self) -> RoundNumber:
        return self.authority_round.round

    @property
    def authority(self) -> AuthorityIndex:
        return self.authority_round.authority

    def is_decided(self) -> bool:
        return self.kind != self.UNDECIDED

    def into_decided_author_round(self) -> AuthorityRound:
        assert self.is_decided()
        return self.authority_round

    def committed_block(self) -> Optional[StatementBlock]:
        return self.block

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, LeaderStatus)
            and self.kind == other.kind
            and self.authority_round == other.authority_round
            and (
                self.block.reference if self.block else None
            ) == (other.block.reference if other.block else None)
        )

    def __repr__(self) -> str:
        return f"{self.kind.capitalize()}({self.authority_round!r})"
