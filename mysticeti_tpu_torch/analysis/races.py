"""Await-atomicity race rule (``await-atomicity``).

The static twin of the interleave races once hardened by hand: a
coroutine that reads ``self._x``, suspends at an ``await``, and then
writes ``self._x`` has published a stale snapshot — any other coroutine
scheduled in the gap can update the field and have its write silently
discarded when the first coroutine resumes.  On the deterministic loop
the interleaving is seed-stable, which makes these races *reproducible*
but no less wrong: a different seed (or a production loop) picks a
different winner.

What fires
----------
A read of a ``self.<field>`` attribute followed — across at least one
suspension point (``await``, ``async for``, or entering an
``async with``) — by a write to the same field, inside one ``async def``,
when no single acquisition of a ``self.<lock>`` block covers both the
read and the write.  ``self._x += 1`` after an earlier read counts as the
write half (it is itself a read-modify-write).

What does not fire
------------------
- Read and write inside the *same* ``with self._lock:`` /
  ``async with self._lock:`` block (the lock is held across the
  suspension, so no peer can interleave).  Two separate acquisitions of
  the same lock do **not** protect — that is the classic check-then-act.
- Functions (or whole classes) annotated ``# lint: single-owner[...]``
  on the ``def``/``class`` line or the line above: the repo's core-task
  discipline (core_task.py) serializes all consensus mutations through
  one dispatcher, so its handlers never interleave with each other even
  though they await.
- Writes in ``__init__`` / ``__aenter__`` (construction is single
  threaded by contract).
- Fields the function *only* writes after the await (no prior read: a
  blind publish is last-writer-wins by design, not a lost update).

The traversal is linear in source order — branches are treated as
sequential, which errs toward reporting.  Deliberate exceptions take a
``# lint: ignore[await-atomicity]`` with a justification, same as every
other rule in this package.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

RULE_AWAIT_ATOMICITY = "await-atomicity"

_SINGLE_OWNER_RE = re.compile(r"#\s*lint:\s*single-owner(?:\[([a-z0-9_\-]+)\])?")

# Constructors whose instance attributes we treat as locks when looking
# for protecting ``with self.<lock>:`` blocks.  Mirrors
# checker._collect_class_locks but also accepts asyncio primitives: an
# ``async with self._mutex:`` held across the await is exactly the
# protection this rule credits.
_LOCK_CONSTRUCTORS = frozenset(
    {
        "threading.Lock",
        "threading.RLock",
        "threading.Condition",
        "asyncio.Lock",
        "asyncio.Condition",
    }
)

_CONSTRUCTOR_METHODS = frozenset({"__init__", "__aenter__", "__post_init__"})


@dataclass(frozen=True)
class RaceFinding:
    line: int
    col: int
    message: str


def single_owner_lines(source: str) -> Set[int]:
    """Lines carrying a ``# lint: single-owner`` annotation."""
    from .checker import comment_lines

    out: Set[int] = set()
    for i, line in comment_lines(source).items():
        if _SINGLE_OWNER_RE.search(line):
            out.add(i)
    return out


def _is_annotated(node: ast.AST, owner_lines: Set[int]) -> bool:
    line = getattr(node, "lineno", 0)
    return line in owner_lines or (line - 1) in owner_lines


def _class_locks(cls: Optional[ast.ClassDef], aliases: Dict[str, str]) -> Set[str]:
    """Attribute names assigned a lock constructor anywhere in the class."""
    if cls is None:
        return set()
    from .checker import _dotted  # local import: avoid cycle at module load

    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        ctor = _dotted(node.value.func, aliases)
        if ctor not in _LOCK_CONSTRUCTORS:
            continue
        for target in node.targets:
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                locks.add(target.attr)
    return locks


class _CoroutineWalk:
    """Source-order walk of one coroutine body.

    Tracks, per ``self.<field>``:

    - the earliest read: (await_count, lock-block ids held at the read)
    - every write after a later suspension point

    Suspension points bump ``await_count``.  Lock blocks are identified by
    the ``with`` node id so that two acquisitions of the same lock are
    distinct — only a shared id (one contiguous critical section) counts
    as protection.
    """

    def __init__(self, locks: Set[str]) -> None:
        self.locks = locks
        self.await_count = 0
        self.lock_stack: List[int] = []  # id(with-node) per held lock block
        # field -> (await_count at first read, frozenset of lock block ids)
        self.reads: Dict[str, Tuple[int, frozenset]] = {}
        self.findings: List[Tuple[ast.AST, str]] = []
        self._reported: Set[str] = set()

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def _self_field(node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _lock_attr(self, item: ast.withitem) -> bool:
        field = self._self_field(item.context_expr)
        return field is not None and field in self.locks

    def _note_read(self, field: str) -> None:
        # Keep the *latest* read: a re-read after further suspensions means
        # the value in hand is no longer stale relative to those awaits
        # (e.g. a ``while`` condition re-checked after its body's awaits).
        self.reads[field] = (self.await_count, frozenset(self.lock_stack))

    def _note_write(self, node: ast.AST, field: str) -> None:
        prior = self.reads.get(field)
        if prior is None or field in self._reported:
            return
        read_count, read_locks = prior
        if self.await_count <= read_count:
            return  # no suspension between read and write
        if read_locks & frozenset(self.lock_stack):
            return  # one critical section covers both sides
        self._reported.add(field)
        self.findings.append((node, field))

    # -- traversal -------------------------------------------------------

    def walk(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested definitions get their own pass
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr)
            if isinstance(stmt, ast.AsyncWith):
                self.await_count += 1  # __aenter__ suspends
            pushed = 0
            for item in stmt.items:
                if self._lock_attr(item):
                    self.lock_stack.append(id(stmt))
                    pushed += 1
            self.walk(stmt.body)
            for _ in range(pushed):
                self.lock_stack.pop()
            return
        if isinstance(stmt, ast.AsyncFor):
            self._scan_expr(stmt.iter)
            self.await_count += 1
            self.walk(stmt.body)
            self.walk(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.While)):
            # A loop body may run again after its own awaits: re-walk once
            # so a read late in the body pairs with a write early in it.
            before = self.await_count
            if isinstance(stmt, ast.While):
                self._scan_expr(stmt.test)
            else:
                self._scan_expr(stmt.iter)
            self.walk(stmt.body)
            if self.await_count > before:
                self.walk(stmt.body)
            if isinstance(stmt, ast.While):
                # The condition is re-evaluated after the body's awaits;
                # its *last* read happens at the current count, so a
                # ``while self._full(): await ...`` guard followed by an
                # un-suspended write is the correct semaphore shape, not a
                # stale check-then-act.
                self._scan_expr(stmt.test)
            self.walk(stmt.orelse)
            return
        if isinstance(stmt, ast.If):
            self._scan_expr(stmt.test)
            self.walk(stmt.body)
            self.walk(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self.walk(stmt.body)
            for handler in stmt.handlers:
                self.walk(handler.body)
            self.walk(stmt.orelse)
            self.walk(stmt.finalbody)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._assignment(stmt)
            return
        self._scan_expr_reads(stmt)

    def _assignment(self, stmt: ast.stmt) -> None:
        value = getattr(stmt, "value", None)
        if value is not None:
            self._scan_expr(value)
        targets = (
            stmt.targets
            if isinstance(stmt, ast.Assign)
            else [stmt.target]  # AnnAssign / AugAssign
        )
        for target in targets:
            field = self._self_field(target)
            if field is None:
                # Tuple targets, subscripts of fields, etc: reads for the
                # base object, not a whole-field overwrite.
                self._scan_expr_reads(target)
                continue
            # An AugAssign re-reads at write time in one un-suspended step,
            # so it neither loses an update itself nor leaves a stale
            # snapshot behind for a later write to publish: it counts as a
            # write (pairing with an earlier *bound* read — the stale-guard
            # shape) but does not register a read.
            self._note_write(target, field)

    def _scan_expr(self, expr: ast.AST) -> None:
        """Suspension points + field reads in a *persisting* context.

        Only reads whose value can outlive the statement register as the
        stale half of a race: assignment right-hand sides (the value is
        bound) and branch conditions (the decision is taken).  A field read
        as a call argument or receiver (``metrics.set(self.n)``,
        ``self._q.get()``) is consumed in place — it cannot publish a stale
        snapshot later, so it only counts for its awaits.
        """
        for node in ast.walk(expr):
            if isinstance(node, ast.Await):
                self.await_count += 1
                continue
            field = self._self_field(node)
            if field is not None and isinstance(node.ctx, ast.Load):
                self._note_read(field)

    def _scan_expr_reads(self, node: ast.AST) -> None:
        """Count suspension points only (non-persisting read context)."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Await):
                self.await_count += 1


def check_await_atomicity(
    tree: ast.AST, aliases: Dict[str, str], source: str
) -> List[RaceFinding]:
    owner_lines = single_owner_lines(source)
    findings: List[RaceFinding] = []

    def visit(node: ast.AST, cls: Optional[ast.ClassDef]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                if _is_annotated(child, owner_lines):
                    continue  # whole class is single-owner
                visit(child, child)
                continue
            if isinstance(child, ast.AsyncFunctionDef):
                if (
                    child.name not in _CONSTRUCTOR_METHODS
                    and not _is_annotated(child, owner_lines)
                ):
                    walk = _CoroutineWalk(_class_locks(cls, aliases))
                    walk.walk(child.body)
                    for site, field in walk.findings:
                        findings.append(
                            RaceFinding(
                                line=site.lineno,
                                col=site.col_offset,
                                message=(
                                    f"self.{field} is read before an await and "
                                    f"written after it in '{child.name}' with no "
                                    "lock held across the suspension — a peer "
                                    "coroutine scheduled in the gap loses its "
                                    "update; hold one critical section across "
                                    "both sides, or annotate the owner with "
                                    "'# lint: single-owner[...]'"
                                ),
                            )
                        )
            visit(child, cls)

    visit(tree, None)
    findings.sort(key=lambda f: (f.line, f.col))
    return findings
