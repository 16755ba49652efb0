"""Lock-order analysis and guarded-field inference.

Two rules over the package's lock landscape:

``lock-order``
    Build the lock *acquisition graph*: an edge ``A -> B`` whenever a
    ``with self.B:`` is entered while ``self.A`` is already held — either
    by direct syntactic nesting or one call level deep (``self.m()``
    invoked under ``A`` where ``m`` acquires ``B``).  Edges merge across
    the whole package; any cycle is a deadlock-capable ordering and
    fails the gate.  Lock identities are class-qualified
    (``ClassName._lock``) so same-named locks on unrelated classes never
    alias.

``guard-inference``
    Infer which fields a class *intends* to guard: a field written under
    the same ``self.<lock>`` at two or more sites is treated as guarded
    by that lock, and any stray write outside it (construction excluded)
    is reported.  This demotes the hand-maintained ``GUARDED_FIELDS``
    registry in checker.py from the *source of truth* to *confirmed
    annotations*: registry entries keep their stricter any-write
    enforcement (rule ``lock-discipline``), every other field gets the
    inferred discipline automatically, and a registry entry that the
    code no longer exhibits (no guarded write of that field anywhere in
    the package) is flagged as a stale annotation so the registry cannot
    drift from the code it describes.

Both analyses are intentionally intra-class: a lock attribute lives on
``self``, so every acquisition that can nest with it is a method (or a
one-level ``self.`` call) of the same class.  Deliberate exceptions take
``# lint: ignore[lock-order]`` / ``# lint: ignore[guard-inference]``
with a justification, like every rule in this package.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

RULE_LOCK_ORDER = "lock-order"
RULE_GUARD_INFERENCE = "guard-inference"

# ``# lint: holds[_lock]`` on (or directly above) a ``def``: every caller
# holds ``self._lock`` for the duration of the call — the method's writes
# are censused as guarded by it.  The annotation is a *contract*, the
# same demotion as GUARDED_FIELDS: stated in one place, checked
# everywhere the census runs.
_HOLDS_RE = re.compile(r"#\s*lint:\s*holds\[([A-Za-z0-9_,\s]+)\]")

# A field is considered intentionally guarded once this many distinct
# write sites hold the same lock.  One site is ambient (the write may be
# inside the lock for unrelated reasons); two is a pattern.
MIN_GUARDED_SITES = 2

_CONSTRUCTOR_METHODS = frozenset({"__init__", "__post_init__", "__new__"})

_LOCK_CONSTRUCTORS = frozenset(
    {
        "threading.Lock",
        "threading.RLock",
        "threading.Condition",
        "asyncio.Lock",
        "asyncio.Condition",
    }
)


@dataclass(frozen=True)
class LockEdge:
    """``held`` was held when ``acquired`` was taken (class-qualified)."""

    held: str
    acquired: str
    path: str
    line: int


@dataclass(frozen=True)
class GuardFinding:
    line: int
    col: int
    message: str


@dataclass
class FieldWrites:
    """Per (class, field) write census."""

    # lock attr -> number of write sites holding it
    guarded: Dict[str, int] = field(default_factory=dict)
    # (line, col, held locks at the site)
    sites: List[Tuple[int, int, frozenset]] = field(default_factory=list)
    # locks observed held at *any* access of the field (incl. reads and
    # mutating method calls like ``self._ring.append(...)``) — used to
    # confirm GUARDED_FIELDS annotations, not to report strays
    touched: Set[str] = field(default_factory=set)


@dataclass
class ModuleLocks:
    """Everything analyze_paths needs from one module."""

    edges: List[LockEdge] = field(default_factory=list)
    # (class name, field) -> census
    writes: Dict[Tuple[str, str], FieldWrites] = field(default_factory=dict)


def _class_lock_attrs(cls: ast.ClassDef, aliases: Dict[str, str]) -> Set[str]:
    from .checker import _dotted  # local import: avoid cycle at module load

    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        if _dotted(node.value.func, aliases) not in _LOCK_CONSTRUCTORS:
            continue
        for target in node.targets:
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                locks.add(target.attr)
    return locks


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _write_target_attr(node: ast.AST) -> Optional[str]:
    """Resolve a store target to its base ``self.<attr>``.

    ``self._f = v`` and ``self._f[k] = v`` / ``self._f[k][j] += v`` all
    mutate what ``self._f`` guards.
    """
    while isinstance(node, ast.Subscript):
        node = node.value
    return _self_attr(node)


class _MethodWalk:
    """One method: acquisitions, self-calls under locks, field writes."""

    def __init__(
        self, locks: Set[str], assumed_held: Tuple[str, ...] = ()
    ) -> None:
        self.locks = locks
        self.held: List[str] = list(assumed_held)
        # (held-before tuple, acquired, line)
        self.acquisitions: List[Tuple[Tuple[str, ...], str, int]] = []
        # (held tuple, callee name, line)
        self.calls_under: List[Tuple[Tuple[str, ...], str, int]] = []
        # (field, line, col, held frozenset)
        self.writes: List[Tuple[str, int, int, frozenset]] = []
        # (field, held frozenset) for any access while a lock is held
        self.touches: List[Tuple[str, frozenset]] = []
        self.acquired_anywhere: Set[str] = set()

    def walk(self, stmts: Iterable[ast.stmt]) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.ClassDef):
            return  # nested classes analyzed on their own
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A closure does NOT run under the locks held at its
            # definition site — walk it with a fresh stack, but keep its
            # own acquisitions/writes in this method's census (the
            # dispatch-EMA update lives in exactly such a callback).
            sub = _MethodWalk(self.locks)
            sub.walk(stmt.body)
            self.acquisitions.extend(sub.acquisitions)
            self.calls_under.extend(sub.calls_under)
            self.writes.extend(sub.writes)
            self.touches.extend(sub.touches)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                self._scan_expr(item.context_expr)
                attr = _self_attr(item.context_expr)
                if attr is not None and attr in self.locks:
                    self.acquisitions.append((tuple(self.held), attr, stmt.lineno))
                    self.acquired_anywhere.add(attr)
                    self.held.append(attr)
                    pushed += 1
            for sub in stmt.body:
                self._stmt(sub)
            for _ in range(pushed):
                self.held.pop()
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = getattr(stmt, "value", None)
            if value is not None:
                self._scan_expr(value)
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            for target in targets:
                attr = _write_target_attr(target)
                if attr is not None and attr not in self.locks:
                    self.writes.append(
                        (attr, target.lineno, target.col_offset, frozenset(self.held))
                    )
                    if self.held:
                        self.touches.append((attr, frozenset(self.held)))
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            else:
                self._scan_expr(child)

    def _scan_expr(self, expr: ast.AST) -> None:
        if not self.held:
            return
        held = frozenset(self.held)
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                attr = _self_attr(node.func)
                if attr is not None:
                    self.calls_under.append((tuple(self.held), attr, node.lineno))
            attr = _self_attr(node)
            if attr is not None and attr not in self.locks:
                self.touches.append((attr, held))


def holds_annotations(source: str) -> Dict[int, Tuple[str, ...]]:
    """line -> lock attrs named by a ``# lint: holds[...]`` comment."""
    from .checker import comment_lines

    out: Dict[int, Tuple[str, ...]] = {}
    for i, line in comment_lines(source).items():
        m = _HOLDS_RE.search(line)
        if m:
            out[i] = tuple(
                part.strip() for part in m.group(1).split(",") if part.strip()
            )
    return out


def collect_module_locks(
    tree: ast.AST, aliases: Dict[str, str], path: str, source: str = ""
) -> ModuleLocks:
    """Lock acquisition edges + field-write census for one module."""
    out = ModuleLocks()
    holds = holds_annotations(source) if source else {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _class_lock_attrs(cls, aliases)
        method_walks: Dict[str, _MethodWalk] = {}
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            assumed = holds.get(fn.lineno) or holds.get(fn.lineno - 1) or ()
            walk = _MethodWalk(locks, assumed_held=assumed)
            walk.walk(fn.body)
            method_walks[fn.name] = walk
            if fn.name not in _CONSTRUCTOR_METHODS:
                for attr, line, col, held in walk.writes:
                    census = out.writes.setdefault((cls.name, attr), FieldWrites())
                    census.sites.append((line, col, held))
                    for lock in held:
                        census.guarded[lock] = census.guarded.get(lock, 0) + 1
                for attr, held in walk.touches:
                    census = out.writes.setdefault((cls.name, attr), FieldWrites())
                    census.touched.update(held)
        qual = lambda lock: f"{cls.name}.{lock}"  # noqa: E731
        for walk in method_walks.values():
            for held_before, acquired, line in walk.acquisitions:
                for held in held_before:
                    out.edges.append(
                        LockEdge(qual(held), qual(acquired), path, line)
                    )
            # One call level deep: self.m() under A, where m acquires B.
            for held_tuple, callee, line in walk.calls_under:
                target = method_walks.get(callee)
                if target is None:
                    continue
                for acquired in sorted(target.acquired_anywhere):
                    for held in held_tuple:
                        if held != acquired:
                            out.edges.append(
                                LockEdge(qual(held), qual(acquired), path, line)
                            )
    return out


def check_guard_inference(
    module: ModuleLocks, annotated: Dict[str, str]
) -> List[GuardFinding]:
    """Stray unguarded writes to inferred-guarded fields (one module).

    ``annotated`` is the GUARDED_FIELDS registry: those fields already
    carry the stricter lock-discipline enforcement, so inference skips
    them here (the repo-level stale-annotation check covers the reverse
    direction).
    """
    findings: List[GuardFinding] = []
    for (cls_name, attr), census in sorted(module.writes.items()):
        if attr in annotated or not census.guarded:
            continue
        lock, guarded_sites = max(
            census.guarded.items(), key=lambda kv: (kv[1], kv[0])
        )
        if guarded_sites < MIN_GUARDED_SITES:
            continue
        for line, col, held in census.sites:
            if lock in held:
                continue
            others = ", ".join(sorted(held)) or "no lock"
            findings.append(
                GuardFinding(
                    line=line,
                    col=col,
                    message=(
                        f"self.{attr} ({cls_name}) is written under "
                        f"self.{lock} at {guarded_sites} site(s) but here "
                        f"under {others} — a concurrent holder of "
                        f"self.{lock} races this write; guard it, or add "
                        "the field to GUARDED_FIELDS with a justification "
                        "if the discipline is intentional"
                    ),
                )
            )
    findings.sort(key=lambda f: (f.line, f.col))
    return findings


def find_lock_cycles(edges: Iterable[LockEdge]) -> List[List[LockEdge]]:
    """Cycles in the merged acquisition graph (each as its edge list)."""
    graph: Dict[str, Dict[str, LockEdge]] = {}
    for edge in edges:
        graph.setdefault(edge.held, {}).setdefault(edge.acquired, edge)

    cycles: List[List[LockEdge]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()
    visiting: List[str] = []
    done: Set[str] = set()

    def dfs(node: str) -> None:
        if node in done:
            return
        if node in visiting:
            i = visiting.index(node)
            members = visiting[i:]
            key = tuple(sorted(members))
            if key not in seen_cycles:
                seen_cycles.add(key)
                cycle_edges = [
                    graph[members[j]][members[(j + 1) % len(members)]]
                    for j in range(len(members))
                ]
                cycles.append(cycle_edges)
            return
        visiting.append(node)
        for nxt in sorted(graph.get(node, ())):
            dfs(nxt)
        visiting.pop()
        done.add(node)

    for node in sorted(graph):
        dfs(node)
    return cycles


def lock_order_messages(cycles: List[List[LockEdge]]) -> List[Tuple[str, int, str]]:
    """(path, line, message) per cycle, anchored at its first edge."""
    out: List[Tuple[str, int, str]] = []
    for cycle_edges in cycles:
        ring = " -> ".join(e.held for e in cycle_edges)
        ring += f" -> {cycle_edges[0].held}"
        sites = "; ".join(
            f"{e.held} then {e.acquired} at {e.path}:{e.line}" for e in cycle_edges
        )
        anchor = cycle_edges[0]
        out.append(
            (
                anchor.path,
                anchor.line,
                (
                    f"lock acquisition cycle {ring} — two threads entering "
                    "the ring from different edges deadlock; acquire in one "
                    f"global order ({sites})"
                ),
            )
        )
    return out


def stale_annotations(
    modules: Iterable[ModuleLocks], annotated: Dict[str, str]
) -> List[Tuple[str, str, str]]:
    """GUARDED_FIELDS entries with no guarded write anywhere: (field, lock, msg)."""
    observed: Set[Tuple[str, str]] = set()
    written: Set[str] = set()
    for module in modules:
        for (_cls, attr), census in module.writes.items():
            if census.sites:
                written.add(attr)
            for lock in census.guarded:
                observed.add((attr, lock))
            for lock in census.touched:
                observed.add((attr, lock))
    out: List[Tuple[str, str, str]] = []
    for attr, lock in sorted(annotated.items()):
        if (attr, lock) in observed:
            continue
        reason = (
            "is never written under it outside construction"
            if attr in written
            else "is never written at all outside construction"
        )
        out.append(
            (
                attr,
                lock,
                (
                    f"GUARDED_FIELDS annotates self.{attr} with self.{lock} "
                    f"but the field {reason} — the annotation is stale; "
                    "update or remove it so the registry keeps matching the "
                    "code it describes"
                ),
            )
        )
    return out
