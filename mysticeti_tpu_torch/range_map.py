"""RangeMap — an ordered map that compacts contiguous key ranges with one value.

The port's copy of ``mysticeti_tpu.range_map``.

Capability parity with ``mysticeti-core/src/range_map.rs:14-180``: maps half-open
``[start, end)`` integer ranges to values, with ``mutate_range`` visiting every
sub-range that overlaps a requested range (splitting existing entries at the
boundaries) and every gap (value ``None``).  Backs the per-block fast-path vote
aggregation in ``TransactionAggregator`` (committee.rs:368-425), where many
contiguous transaction offsets share one ``StakeAggregator``.

Python-idiomatic design rather than a BTreeMap translation: entries live in a flat
sorted list of ``(start, end, value)`` and ``mutate_range`` does a single linear
sweep, rebuilding the overlapped span.  The mutation callback *returns* the new
value (``None`` deletes), instead of mutating an Option in place.
"""
from __future__ import annotations

from bisect import bisect_left, insort
from typing import Callable, Iterator, List, Optional, Tuple, TypeVar

V = TypeVar("V")

MutateFn = Callable[[int, int, Optional[V]], Optional[V]]


def _clone(v: object) -> object:
    """Independent copy for split fragments; immutable values pass through."""
    copy_method = getattr(v, "copy", None)
    return copy_method() if callable(copy_method) else v


class RangeMap:
    __slots__ = ("_entries",)

    def __init__(self) -> None:
        # Sorted, disjoint, non-empty [start, end) -> value entries.
        self._entries: List[Tuple[int, int, object]] = []

    def mutate_range(self, start: int, end: int, f: MutateFn) -> None:
        """Visit every overlapping sub-range and gap of [start, end) with
        ``f(sub_start, sub_end, value_or_None) -> new_value_or_None``.

        ``f`` may be invoked multiple times (once per overlapped fragment), matching
        range_map.rs:33-38.  Returning ``None`` removes the fragment.
        """
        if start >= end:
            return
        out: List[Tuple[int, int, object]] = []
        cursor = start  # next uncovered key within the requested range
        for s, e, v in self._entries:
            if e <= start or s >= end:
                out.append((s, e, v))
                continue
            # Splitting an entry must give each fragment an independent value
            # (range_map.rs clones on split) — otherwise a vote tallied on one
            # fragment would leak into its siblings through the shared aggregator.
            first_fragment = True
            # keep the part of this entry before the requested range
            if s < start:
                out.append((s, start, v))
                first_fragment = False
            ov_start, ov_end = max(s, start), min(e, end)
            # gap between previous fragment and this entry
            if cursor < ov_start:
                nv = f(cursor, ov_start, None)
                if nv is not None:
                    out.append((cursor, ov_start, nv))
            after_v = _clone(v) if e > end else None  # clone BEFORE f mutates v
            nv = f(ov_start, ov_end, v if first_fragment else _clone(v))
            if nv is not None:
                out.append((ov_start, ov_end, nv))
            cursor = ov_end
            # keep the part of this entry after the requested range
            if e > end:
                out.append((end, e, after_v))
        if cursor < end:
            nv = f(cursor, end, None)
            if nv is not None:
                out.append((cursor, end, nv))
        out.sort(key=lambda t: t[0])
        self._entries = out

    def get(self, key: int) -> Optional[object]:
        i = bisect_left(self._entries, (key + 1,)) - 1
        if i >= 0:
            s, e, v = self._entries[i]
            if s <= key < e:
                return v
        return None

    def items(self) -> Iterator[Tuple[int, int, object]]:
        return iter(self._entries)

    def is_empty(self) -> bool:
        return not self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return "RangeMap(" + ", ".join(f"[{s},{e})={v!r}" for s, e, v in self._entries) + ")"
