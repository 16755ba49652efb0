"""The ``sim-taint`` rule: nondeterminism dataflow into sim-visible state.

The determinism contract of this codebase is that a seeded virtual-time run
(:mod:`mysticeti_tpu_torch.runtime.simulated`) is byte-identical across re-runs.
Twice now a plane shipped with a leak the per-call-site ``wall-clock`` rule
could not see, because the *read* was innocent and the *use* was elsewhere:

* **the ``wal_backlog`` leak**: the ingress admission controller's ``wal_backlog`` signal read
  ``wal_writer.pending()`` — the live progress of a real drain *thread* —
  and a virtual-time sim's shed schedule absorbed host thread timing.
* **the dispatch-EMA leak**: the batched verifier folded a wall-clock dispatch measurement
  into ``self._dispatch_ema_s``, and ``_effective_delay_s`` armed a
  *virtual-time* flush timer from it — the sim's whole commit trajectory
  followed host load.

Both are **taint** bugs: a nondeterminism *source* (wall-clock read, global
RNG, thread-progress observation) flowing into a sim-visible *sink* (a
branch decision, a timer delay, a canonical digest).  This module tracks
that flow intra-module, flow-insensitively, through three channels:

* **locals** within a function (``started = time.monotonic()``),
* **self fields** within a class, to a fixed point across methods
  (``self._ema = _update(self._ema, wall, ...)`` taints every later read),
* **dict keys** module-wide (``signals["wal_backlog"] = ...`` taints
  ``signals.get("wal_backlog")`` in another class of the same module —
  exactly the shape of the ``wal_backlog`` leak).

Reads executed only in real-time mode are *clean*: a source lexically under
``if not runtime.is_simulated():`` (or the ``else`` of ``if
is_simulated():``, or after an ``if is_simulated(): return`` early exit, or
guarded by a local assigned ``not is_simulated()``) never runs inside the
virtual-time loop, so it cannot leak into a sim.  That gating idiom is the
sanctioned escape hatch — the rule exists to force nondeterministic reads
through it.

Like every rule in this package the detector is deliberately syntactic and
idiom-scoped: precision over generality.  Calls propagate taint from
arguments to result (``_update_ema(ema, wall_delta)`` is tainted), but only
three sink shapes fire: ``if``/``while`` decisions, virtual-timer delays
(``call_later``/``call_at``/``sleep``/``wait_for``), and digest feeds.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULE_SIM_TAINT = "sim-taint"

# -- taint sources ------------------------------------------------------------

# Host clock reads: real time observed from inside what may be a virtual-time
# run.  (runtime.now()/timestamp_utc() are the clean equivalents — they read
# the loop clock under simulation.)
WALL_CLOCK_SOURCES = frozenset({
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
})

# Process-global / OS randomness: not derived from the loop's seeded RNG, so
# two same-seed runs draw differently.  Seeded instances (``self._rng.random()``,
# ``loop.rng.choice(...)``) resolve to a different dotted head and stay clean.
UNSEEDED_RANDOM_SOURCES = frozenset({
    "random.random", "random.uniform", "random.randint", "random.randrange",
    "random.choice", "random.choices", "random.sample", "random.shuffle",
    "random.gauss", "random.expovariate", "random.getrandbits",
    "random.betavariate", "random.normalvariate",
    "os.urandom",
    "secrets.token_bytes", "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.randbits", "secrets.randbelow", "secrets.choice",
    "uuid.uuid1", "uuid.uuid4",
})

# Observations of real-thread progress: how far a drain/worker thread has
# gotten is wall-clock state no matter how it is read.  ``pending()`` is the
# WalWriter in-flight census (the ``wal_backlog`` leak's source); ``as_completed`` yields in
# completion order; ``Thread.is_alive`` is the thread's own progress bit.
THREAD_PROGRESS_METHODS = frozenset({"pending", "is_alive"})
THREAD_PROGRESS_CALLS = frozenset({
    "concurrent.futures.as_completed", "futures.as_completed",
})

_SOURCE_KIND = {
    **{name: "wall-clock" for name in WALL_CLOCK_SOURCES},
    **{name: "unseeded-random" for name in UNSEEDED_RANDOM_SOURCES},
    **{name: "thread-progress" for name in THREAD_PROGRESS_CALLS},
}

# -- sinks --------------------------------------------------------------------

# Arming a timer: under the DeterministicLoop the delay IS virtual time, so a
# tainted delay reshapes the whole event schedule.
TIMER_SINK_TAILS = frozenset({"call_later", "call_at", "sleep", "wait_for"})

# Feeding a canonical digest: sims assert byte-identity on these.
DIGEST_SINK_TAILS = frozenset({
    "sha256", "sha512", "sha3_256", "blake2b", "blake2s", "md5",
})


@dataclass(frozen=True)
class Taint:
    """Provenance of one nondeterminism source reaching a value."""

    kind: str       # wall-clock | unseeded-random | thread-progress
    source: str     # dotted call, e.g. "time.monotonic" or ".pending()"
    line: int


@dataclass(frozen=True)
class TaintFinding:
    line: int
    col: int
    message: str
    # The source's line: an inline suppression at the *cause* (one comment
    # at the nondeterministic read) silences every downstream sink finding,
    # instead of one comment per sink.
    source_line: int = 0


def _dotted(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _is_simulated_call(node: ast.AST) -> bool:
    """``is_simulated()`` / ``runtime.is_simulated()`` / ``self._sim()``-free:
    any call whose tail name is ``is_simulated``."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Name):
        return func.id == "is_simulated"
    if isinstance(func, ast.Attribute):
        return func.attr == "is_simulated"
    return False


class _GateClassifier:
    """Classifies condition expressions as real-only / sim-only gates.

    ``real`` — the guarded body only executes outside the simulator
    (``not is_simulated()``, a local assigned from it, ``x and real_flag``).
    ``sim`` — the body only executes *inside* the simulator.
    ``None`` — no verdict.
    """

    def __init__(self) -> None:
        self.real_flags: Set[str] = set()   # locals holding not is_simulated()
        self.sim_flags: Set[str] = set()    # locals holding is_simulated()

    def note_assign(self, node: ast.Assign) -> None:
        value = node.value
        verdict = self.classify(value)
        if verdict is None:
            return
        for target in node.targets:
            if isinstance(target, ast.Name):
                if verdict == "real":
                    self.real_flags.add(target.id)
                    self.sim_flags.discard(target.id)
                else:
                    self.sim_flags.add(target.id)
                    self.real_flags.discard(target.id)

    def classify(self, test: ast.AST) -> Optional[str]:
        if _is_simulated_call(test):
            return "sim"
        if isinstance(test, ast.Name):
            if test.id in self.real_flags:
                return "real"
            if test.id in self.sim_flags:
                return "sim"
            return None
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            inner = self.classify(test.operand)
            if inner == "sim":
                return "real"
            if inner == "real":
                return "sim"
            return None
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            # ``a and not is_simulated()``: body runs only when every
            # conjunct holds, so one real-only conjunct gates the body.
            verdicts = [self.classify(v) for v in test.values]
            if "real" in verdicts:
                return "real"
            if "sim" in verdicts:
                return "sim"
        return None


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    if not stmts:
        return False
    last = stmts[-1]
    return isinstance(last, (ast.Return, ast.Raise, ast.Continue, ast.Break))


class _FunctionFlow(ast.NodeVisitor):
    """One pass over a function body: collects taints and sink hits.

    ``field_taints`` (per class) and ``key_taints`` (per module) are shared
    mutable dicts — the module driver iterates functions to a fixed point so
    cross-method field flow and cross-class dict-key flow both resolve.
    """

    def __init__(
        self,
        aliases: Dict[str, str],
        gates: _GateClassifier,
        field_taints: Dict[str, Taint],
        key_taints: Dict[str, Taint],
        findings: List[TaintFinding],
        emitted: Set[Tuple[int, int, str]],
        func_name: Optional[str] = None,
    ) -> None:
        self.aliases = aliases
        self.gates = gates
        self.field_taints = field_taints
        self.key_taints = key_taints
        self.findings = findings
        self.emitted = emitted
        self.func_name = func_name
        self.local_taints: Dict[str, Taint] = {}
        self._real_only = 0  # depth of real-only gating
        self.changed = False

    # -- taint queries --

    def _source_of_call(self, node: ast.Call) -> Optional[Taint]:
        dotted = _dotted(node.func, self.aliases)
        if dotted in _SOURCE_KIND:
            return Taint(_SOURCE_KIND[dotted], dotted, node.lineno)
        func = node.func
        if isinstance(func, ast.Attribute) and \
                func.attr in THREAD_PROGRESS_METHODS:
            return Taint("thread-progress", f".{func.attr}()", node.lineno)
        return None

    def _taint_of(self, node: ast.AST) -> Optional[Taint]:
        """Taint provenance of an expression, or None if clean."""
        if isinstance(node, ast.Call):
            src = self._source_of_call(node)
            if src is not None:
                return None if self._real_only else src
            if _is_simulated_call(node):
                return None
            # Calls propagate taint from arguments: the EMA-update helper,
            # bool()/min()/max() wrappers, f(x) of a tainted x.
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                t = self._taint_of(arg)
                if t is not None:
                    return t
            # ``self.method()`` where the method returns a tainted value
            # (resolved through the class field/method-taint namespace), or
            # a method call on a tainted object observing tainted state.
            if isinstance(node.func, ast.Attribute):
                return self._taint_of(node.func)
            return None
        if isinstance(node, ast.Name):
            return self.local_taints.get(node.id)
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return self.field_taints.get(node.attr)
            return self._taint_of(node.value)
        if isinstance(node, ast.Subscript):
            key = _const_key(node.slice)
            if key is not None and key in self.key_taints:
                return self.key_taints[key]
            return self._taint_of(node.value)
        if isinstance(node, (ast.BinOp,)):
            return self._taint_of(node.left) or self._taint_of(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._taint_of(node.operand)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                t = self._taint_of(v)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.Compare):
            for v in [node.left] + list(node.comparators):
                t = self._taint_of(v)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.IfExp):
            return (
                self._taint_of(node.body)
                or self._taint_of(node.orelse)
                or self._taint_of(node.test)
            )
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                t = self._taint_of(e)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.Dict):
            for v in node.values:
                if v is None:
                    continue
                t = self._taint_of(v)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.Starred):
            return self._taint_of(node.value)
        if isinstance(node, ast.Await):
            return self._taint_of(node.value)
        if isinstance(node, ast.NamedExpr):
            return self._taint_of(node.value)
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                t = self._taint_of(v)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.FormattedValue):
            return self._taint_of(node.value)
        return None

    # ``x.get("k")`` reads a dict key.
    def _get_call_key_taint(self, node: ast.Call) -> Optional[Taint]:
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "get"
            and node.args
        ):
            key = _const_key(node.args[0])
            if key is not None:
                return self.key_taints.get(key)
        return None

    # -- taint recording --

    def _record_local(self, name: str, taint: Optional[Taint]) -> None:
        if taint is None:
            return
        if self.local_taints.get(name) is None:
            self.local_taints[name] = taint
            self.changed = True

    def _record_field(self, attr: str, taint: Optional[Taint]) -> None:
        if taint is None or self._real_only:
            return
        if self.field_taints.get(attr) is None:
            self.field_taints[attr] = taint
            self.changed = True

    def _record_key(self, key: str, taint: Optional[Taint]) -> None:
        if taint is None or self._real_only:
            return
        if self.key_taints.get(key) is None:
            self.key_taints[key] = taint
            self.changed = True

    # -- emit --

    def _emit(self, node: ast.AST, taint: Taint, sink: str) -> None:
        if self._real_only:
            return
        key = (node.lineno, node.col_offset, sink)
        if key in self.emitted:
            return
        self.emitted.add(key)
        self.findings.append(
            TaintFinding(
                node.lineno,
                node.col_offset,
                f"nondeterministic value ({taint.kind}: {taint.source}, "
                f"line {taint.line}) reaches {sink} — a seeded sim absorbs "
                "host state here; gate the source with "
                "runtime.is_simulated() or derive it from the loop clock",
                source_line=taint.line,
            )
        )

    # -- statements --

    def visit_Assign(self, node: ast.Assign) -> None:
        self.gates.note_assign(node)
        taint = self._taint_of(node.value)
        if taint is None and isinstance(node.value, ast.Call):
            taint = self._get_call_key_taint(node.value)
        for target in node.targets:
            self._assign_target(target, taint)
        self.generic_visit(node)

    def _assign_target(self, target: ast.AST, taint: Optional[Taint]) -> None:
        if isinstance(target, ast.Name):
            if taint is not None:
                self._record_local(target.id, taint)
            else:
                # Re-assignment with a clean value does NOT clear existing
                # taint (flow-insensitive join), matching the fixed point.
                pass
        elif isinstance(target, ast.Attribute):
            if isinstance(target.value, ast.Name) and target.value.id == "self":
                self._record_field(target.attr, taint)
        elif isinstance(target, ast.Subscript):
            key = _const_key(target.slice)
            if key is not None:
                self._record_key(key, taint)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._assign_target(e, taint)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        taint = self._taint_of(node.value)
        self._assign_target(node.target, taint)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._assign_target(node.target, self._taint_of(node.value))
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return) -> None:
        # Return-value flow: a method returning a tainted value taints every
        # ``self.<method>()`` call site — the dispatch-EMA leak reached its timer
        # through ``_effective_delay_s()`` returning the wall-fed EMA.  The
        # method name shares the class field-taint namespace (attribute
        # reads and bound-method reads resolve identically there).
        if node.value is not None and self.func_name is not None:
            self._record_field(self.func_name, self._taint_of(node.value))
        self.generic_visit(node)

    # -- gating / decisions --

    def _check_decision(self, test: ast.AST, node: ast.AST) -> None:
        taint = self._taint_of(test)
        if taint is None and isinstance(test, ast.Call):
            taint = self._get_call_key_taint(test)
        if taint is None:
            # dig for .get("k") reads nested in bool ops / comparisons
            for sub in ast.walk(test):
                if isinstance(sub, ast.Call):
                    taint = self._get_call_key_taint(sub)
                    if taint is not None:
                        break
        if taint is not None:
            self._emit(
                node, taint,
                "a branch decision (sim-visible control flow)",
            )

    def visit_If(self, node: ast.If) -> None:
        verdict = self.gates.classify(node.test)
        if verdict is None:
            self._check_decision(node.test, node)
        self.visit(node.test)
        if verdict == "real":
            self._real_only += 1
            for stmt in node.body:
                self.visit(stmt)
            self._real_only -= 1
            for stmt in node.orelse:
                self.visit(stmt)
        elif verdict == "sim":
            for stmt in node.body:
                self.visit(stmt)
            self._real_only += 1
            for stmt in node.orelse:
                self.visit(stmt)
            self._real_only -= 1
        else:
            for stmt in node.body:
                self.visit(stmt)
            for stmt in node.orelse:
                self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        if self.gates.classify(node.test) is None:
            self._check_decision(node.test, node)
        self.generic_visit(node)

    def _visit_gated_body(self, stmts: Sequence[ast.stmt]) -> None:
        """Visit a statement list honoring ``if is_simulated(): return``
        early exits: statements after a terminal sim-gate are real-only."""
        gated = 0
        for stmt in stmts:
            if (
                isinstance(stmt, ast.If)
                and not stmt.orelse
                and _terminates(stmt.body)
            ):
                verdict = self.gates.classify(stmt.test)
                if verdict == "sim":
                    # sim-mode exits here: the rest is real-only
                    self.visit(stmt)
                    self._real_only += 1
                    gated += 1
                    continue
            self.visit(stmt)
        self._real_only -= gated

    # -- sinks: calls --

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        tail = None
        if isinstance(func, ast.Attribute):
            tail = func.attr
        elif isinstance(func, ast.Name):
            tail = self.aliases.get(func.id, func.id).rsplit(".", 1)[-1]

        if tail in TIMER_SINK_TAILS:
            delay_args: List[ast.AST] = []
            if tail in {"call_later", "call_at", "sleep"} and node.args:
                delay_args.append(node.args[0])
            if tail == "wait_for":
                if len(node.args) > 1:
                    delay_args.append(node.args[1])
                for kw in node.keywords:
                    if kw.arg == "timeout":
                        delay_args.append(kw.value)
            for arg in delay_args:
                taint = self._taint_of(arg)
                if taint is not None:
                    self._emit(
                        node, taint,
                        f"a virtual-time timer delay ({tail}())",
                    )
        if tail in DIGEST_SINK_TAILS or (tail and "digest" in tail):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                taint = self._taint_of(arg)
                if taint is not None:
                    self._emit(
                        node, taint,
                        f"a canonical digest ({tail}())",
                    )
                    break
        self.generic_visit(node)

    # Nested defs get their own flow pass via the module driver; do not
    # descend so their locals stay separate.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass


def _const_key(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _functions_of(tree: ast.Module):
    """Yield (function node, enclosing ClassDef or None), outermost first,
    including nested defs (each analyzed with its own local scope)."""
    def walk(node: ast.AST, cls: Optional[ast.ClassDef]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)
    yield from walk(tree, None)


def check_sim_taint(
    tree: ast.Module, aliases: Dict[str, str]
) -> List[TaintFinding]:
    """Run the sim-taint dataflow over one module to a fixed point."""
    functions = list(_functions_of(tree))
    # Shared propagation state: per-class field taints, module-wide key
    # taints.  Iterate until no new taint or finding appears (bounded: the
    # taint lattice only grows and is finite).
    class_fields: Dict[Optional[ast.ClassDef], Dict[str, Taint]] = {}
    key_taints: Dict[str, Taint] = {}
    findings: List[TaintFinding] = []
    emitted: Set[Tuple[int, int, str]] = set()

    for _ in range(8):  # fixed-point iterations; converges in 2-3 in practice
        changed = False
        for fn, cls in functions:
            gates = _GateClassifier()
            # Seed flag locals from a linear prescan so a gate assigned
            # above its use is recognized regardless of visit order.
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign):
                    gates.note_assign(sub)
            flow = _FunctionFlow(
                aliases,
                gates,
                class_fields.setdefault(cls, {}),
                key_taints,
                findings,
                emitted,
                func_name=fn.name if cls is not None else None,
            )
            # Parameters named like injected clocks stay clean: only
            # in-function sources create taint.
            flow._visit_gated_body(fn.body)
            changed = changed or flow.changed
        if not changed:
            break
    return findings
