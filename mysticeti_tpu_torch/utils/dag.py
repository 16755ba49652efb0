"""Textual DAG DSL for tests — parity with ``Dag::draw`` (types.rs:766-867).

The port's copy of ``mysticeti_tpu.utils.dag``.

Grammar:  ``"A1 : [A0, B0, C0]; B1 : [A0, B0, C0]"`` — semicolon-separated blocks,
each ``<Authority letter><round> : [<includes>]``.  Authority letters map A→0, B→1, …
References to round-0 names resolve to genesis blocks, which are created implicitly.

Unlike the reference (whose cfg(test) crypto is stubbed to zero digests,
crypto.rs:63-75), blocks built here carry real blake2b digests and dummy signatures,
so the DSL builds blocks in topological order and resolves names to real references.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

from ..types import BaseStatement, BlockReference, StatementBlock

_BLOCK_RE = re.compile(r"^\s*([A-Z])(\d+)\s*:\s*\[(.*)\]\s*$")
_REF_RE = re.compile(r"^\s*([A-Z])(\d+)\s*$")


def _name(authority: int, round_: int) -> str:
    return f"{chr(ord('A') + authority)}{round_}"


class Dag:
    """A named collection of blocks built from the DSL (types.rs:774-867)."""

    def __init__(self, blocks: Dict[str, StatementBlock]) -> None:
        self.blocks = blocks

    @classmethod
    def draw(cls, s: str) -> "Dag":
        specs: List[Tuple[int, int, List[Tuple[int, int]]]] = []
        for part in s.split(";"):
            if not part.strip():
                continue
            m = _BLOCK_RE.match(part)
            if not m:
                raise ValueError(f"bad DSL block: {part!r}")
            authority = ord(m.group(1)) - ord("A")
            round_ = int(m.group(2))
            includes: List[Tuple[int, int]] = []
            body = m.group(3).strip()
            if body:
                for ref in body.split(","):
                    rm = _REF_RE.match(ref)
                    if not rm:
                        raise ValueError(f"bad DSL reference: {ref!r}")
                    includes.append((ord(rm.group(1)) - ord("A"), int(rm.group(2))))
            specs.append((authority, round_, includes))

        built: Dict[str, StatementBlock] = {}

        def ensure(authority: int, round_: int) -> BlockReference:
            name = _name(authority, round_)
            if name in built:
                return built[name].reference
            if round_ == 0:
                blk = StatementBlock.new_genesis(authority)
                built[name] = blk
                return blk.reference
            raise ValueError(f"DSL reference to undefined non-genesis block {name}")

        # Build in round order so includes resolve to already-built blocks.
        for authority, round_, includes in sorted(specs, key=lambda t: t[1]):
            refs = [ensure(a, r) for a, r in includes]
            blk = StatementBlock.build(authority, round_, refs, ())
            built[_name(authority, round_)] = blk
        return cls(built)

    @classmethod
    def draw_block(cls, s: str) -> StatementBlock:
        """Build a single block whose includes may reference genesis blocks."""
        dag = cls.draw(s)
        m = _BLOCK_RE.match(s.split(";")[0])
        assert m is not None
        return dag.blocks[_name(ord(m.group(1)) - ord("A"), int(m.group(2)))]

    def __getitem__(self, name: str) -> StatementBlock:
        return self.blocks[name]

    def all_blocks(self) -> List[StatementBlock]:
        return list(self.blocks.values())

    def __len__(self) -> int:
        return len(self.blocks)
