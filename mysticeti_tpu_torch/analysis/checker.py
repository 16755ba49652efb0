"""The syntactic AST rules, the analysis driver, and finding/baseline machinery.

The port's copy of ``mysticeti_tpu.analysis.checker``, with the same rules
and the same configuration.  What differs: ``metrics-doc`` reads the
inventory beside ``metrics.py`` (``<package>/docs/observability.md``, the
port's own), the package's own name is never read as a series, and the
per-file cache is ``.lint-cache-torch.json``, so this lint and the JAX
package's, sharing one repository root, keep separate caches.

Thirteen rules total: the eight per-call-site syntactic rules implemented
here, the determinism/concurrency soundness analyses delegated to
:mod:`.detflow` (``sim-taint``), :mod:`.races` (``await-atomicity``) and
:mod:`.lockgraph` (``lock-order``, ``guard-inference``), plus the
``unused-suppression`` hygiene rule.  This module also owns the repo-level
driver (:func:`analyze_paths`): content-hash result caching, the
multiprocessing per-file pass, and the cross-file rules.

Pure stdlib (``ast``, ``json``, ``re``, ``tokenize``); no imports of the
package under analysis, so the checker runs even when optional heavy deps
(jax, numpy, prometheus_client) are absent or broken.

Every rule is deliberately *syntactic* and scoped to this codebase's idioms:
precision over generality.  A rule that cries wolf gets suppressed wholesale
and enforces nothing; each detector below accepts known-good shapes (handles
awaited in-scope, dispatch hidden behind ``run_in_executor``, casts of static
shapes) so that what remains flagged is worth a human look.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULE_ASYNC_BLOCKING = "async-blocking"
RULE_TASK_ORPHAN = "task-orphan"
RULE_LOCK_DISCIPLINE = "lock-discipline"
RULE_JIT_PURITY = "jit-purity"
RULE_WALL_CLOCK = "wall-clock"
RULE_METRICS_LABELS = "metrics-labels"
RULE_SPAN_NAMES = "span-names"
RULE_METRICS_DOC = "metrics-doc"
# Determinism/concurrency soundness plane (detflow.py, races.py,
# lockgraph.py): dataflow and lock-graph rules, not per-call-site syntax.
RULE_SIM_TAINT = "sim-taint"
RULE_AWAIT_ATOMICITY = "await-atomicity"
RULE_LOCK_ORDER = "lock-order"
RULE_GUARD_INFERENCE = "guard-inference"
# Suppression hygiene: an ignore comment must still suppress something.
RULE_UNUSED_SUPPRESSION = "unused-suppression"
# Native extension fallback contract (native/__init__.py): every call into
# the C extension must sit under a `native is None`-aware gate.
RULE_NATIVE_FALLBACK = "native-fallback"

RULES = (
    RULE_ASYNC_BLOCKING,
    RULE_TASK_ORPHAN,
    RULE_LOCK_DISCIPLINE,
    RULE_JIT_PURITY,
    RULE_WALL_CLOCK,
    RULE_METRICS_LABELS,
    RULE_SPAN_NAMES,
    RULE_METRICS_DOC,
    RULE_SIM_TAINT,
    RULE_AWAIT_ATOMICITY,
    RULE_LOCK_ORDER,
    RULE_GUARD_INFERENCE,
    RULE_UNUSED_SUPPRESSION,
    RULE_NATIVE_FALLBACK,
)

# -- rule configuration -------------------------------------------------------

# Rule 1: calls that block the event loop when made directly from a coroutine.
BLOCKING_CALLS = {
    "time.sleep",
    "os.system",
    "os.waitpid",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "socket.create_connection",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
    "requests.request",
}
# Method names that are synchronous accelerator dispatches: a direct call in a
# coroutine stalls consensus for the whole device round-trip (the
# BatchedSignatureVerifier comment: "the device dispatch runs in a worker
# thread so the event loop never blocks").
BLOCKING_METHODS = {"verify_signatures"}

# Rule 2: task spawners whose naked handle swallows exceptions.
SPAWN_NAMES = {"ensure_future", "create_task"}
# Uses of a task handle that constitute supervision: someone will observe the
# task's exception.
_WAITER_SUFFIXES = ("wait", "wait_for", "gather", "shield")

# Rule 3b: shared fields with a designated lock (the comment-documented
# EMA/counter discipline in block_validator.py).  Mutations anywhere but
# ``__init__`` must sit lexically inside ``with self.<lock>:``.
GUARDED_FIELDS: Dict[str, str] = {
    "_dispatch_ema_s": "_lock",
    "cpu_per_sig_s": "_ema_lock",
    "tpu_dispatch_s": "_ema_lock",
    "tpu_per_sig_s": "_ema_lock",
    # Hybrid verifier circuit breaker: tripped/probed/closed from concurrent
    # dispatch threads; shares the EMA lock (same writers, same cadence).
    "_breaker_backoff_s": "_ema_lock",
    "_breaker_gen": "_ema_lock",
    "_breaker_open_until": "_ema_lock",
    "_breaker_probing": "_ema_lock",
    # Backend pin (zero-tax short-circuit routing): pinned/probed/unpinned
    # from concurrent dispatch threads; shares the EMA lock like the breaker.
    "_pinned_backend": "_ema_lock",
    "_pin_backoff_s": "_ema_lock",
    "_pin_next_probe_t": "_ema_lock",
    # Batching collector arrival-rate EMA: read-modify-written under the
    # pending-queue lock alongside the dispatch EMA it modulates.
    "_arrival_gap_ema_s": "_lock",
    "_last_arrival_t": "_lock",
    # RemoteSignatureVerifier's staged-dispatch connection pool: checked
    # out/in from any executor thread; the live-connection count must move
    # with the deque under one lock or the bound drifts.
    "_pool_size": "_pool_lock",
    # Flight-recorder event ring (flight_recorder.py): appended from the
    # loop thread while the metrics endpoint / a signal path snapshots it —
    # any reassignment (resize, swap) must happen under the ring lock.
    "_flight_ring": "_ring_lock",
    # Dissemination frame cache (synchronizer.FrameCache): the encode-once
    # entry table is read/written per push frame and carries the reuse
    # census — every mutation outside __init__ must hold the cache lock.
    # (Named distinctly from network._FrameReceiver._frames, which is
    # single-threaded by design — GUARDED_FIELDS matches globally by
    # attribute name.)
    "_frame_entries": "_frame_lock",
    # Segmented WAL manifest table (storage.py): the segment list is
    # rewritten by the appender on roll/GC/tear-truncation and read by the
    # paired reader, the metrics sampler, and the fsync thread — every
    # reassignment must happen under the table lock or a reader resolves a
    # position against a half-swapped table.
    "_segments": "_seg_lock",
    # Ingress mempool accounting (ingress.Mempool): the pool's aggregate
    # transaction/byte counters move with the lane deques — submissions may
    # arrive from application threads while the core drains on the loop, so
    # every read-modify-write must hold the mempool lock or the caps drift.
    "_mempool_count": "_mempool_lock",
    "_mempool_bytes": "_mempool_lock",
    # Ingress admission token bucket (ingress.AdmissionController): admit()
    # rides the thread-capable submit path while tick() adjusts the rate on
    # the loop — an unguarded spend would let two concurrent admits both
    # read the same balance and double the admitted rate.
    "_tokens": "_lock",
    # Subsystem accountant (profiling.SubsystemAccountant): the sampler
    # thread ingests the census while publish()/report() read from the
    # loop or a shutdown path — every counter mutation must hold the
    # accountant lock or a publish() mid-ingest exports a torn delta.
    "_cpu_seconds": "_acct_lock",
    "_census_ticks": "_acct_lock",
    "_convoy_ticks": "_acct_lock",
    "_runnable_sum": "_acct_lock",
    # Commit-decision ledger (decisions.DecisionLedger): the loop thread
    # appends records during try_commit while the metrics endpoint serves
    # /debug/consensus and tools snapshot the canonical ledger bytes —
    # ring, flip-detection key set, and frontier tuple all move together
    # under the decision lock or a snapshot reads a torn ledger.
    "_decision_ring": "_decision_lock",
    "_undecided_keys": "_decision_lock",
    "_undecided_slots": "_decision_lock",
    # Finality SLI joiner (finality.FinalityTracker): lifecycle stamps
    # arrive from the thread-capable submit path, the loop's proposal
    # drain, and the commit observer while the ingress tick reads
    # percentiles — pending table and sample window share one lock.
    # (ClientFinalityRecorder deliberately uses different field names —
    # it is loop-thread-only and lock-free by design.)
    "_finality_pending": "_finality_lock",
    "_finality_samples": "_finality_lock",
    # Execution account table (execution.ExecutionState): the core's commit
    # fold mutates balances on the loop thread while ingress submit threads
    # probe admission verdicts and checkpoint writers serialize the table —
    # every reassignment/mutation outside __init__ must hold the execution
    # lock or an admission probe reads a half-applied transfer.
    "_exec_accounts": "_exec_lock",
}

# Rule 4: directories whose jitted functions must stay trace-pure.
JIT_PURITY_DIRS = ("ops", "parallel")
JIT_IMPURE_CALLS = {
    "jax.debug.print",
    "jax.debug.breakpoint",
}
JIT_IMPURE_PREFIXES = ("numpy.", "time.")

# Rule 7: span-tracer call surface.  A stage-name typo at an instrumentation
# site silently splits (begin under one name, end under another: the span
# never closes) — every literal stage must come from spans.STAGES, or from
# the port's own spans.PORT_STAGES.
SPAN_CALL_NAMES = {"span", "begin_span", "end_span", "record_span", "record_interval"}

_IGNORE_RE = re.compile(r"#\s*lint:\s*ignore(?!-module)(?:\[([A-Za-z0-9_,\- ]+)\])?")
# Whole-module opt-out for rules whose premise a module structurally
# escapes (e.g. sim-taint on a socket-plane module that can never run
# under the simulator: _NullSelector refuses the registration).  Placed
# at the top of the module with its justification; exempt from
# unused-suppression (it states an architectural fact, not a finding).
_IGNORE_MODULE_RE = re.compile(r"#\s*lint:\s*ignore-module\[([A-Za-z0-9_,\- ]+)\]")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    # Additional lines where an inline suppression also silences this
    # finding (e.g. a sim-taint finding is suppressible at its *source*
    # read, not only at the sink).  Not part of identity.
    also_lines: Tuple[int, ...] = ()

    def fingerprint(self) -> str:
        """Line-independent identity used by the baseline: survives pure
        line-number drift, invalidates when the code itself changes."""
        return f"{self.rule}|{self.path}|{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


def _dotted(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" with the leading segment resolved through import
    aliases (``import numpy as np`` makes ``np.x`` -> "numpy.x")."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _is_lock_ctor(call: ast.AST, aliases: Dict[str, str]) -> bool:
    if not isinstance(call, ast.Call):
        return False
    dotted = _dotted(call.func, aliases)
    return dotted in {"threading.Lock", "threading.RLock"}


def _collect_class_locks(
    cls: ast.ClassDef, aliases: Dict[str, str]
) -> Set[str]:
    """Attribute names assigned a ``threading.Lock()`` anywhere in the class."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value, aliases):
            for target in node.targets:
                if (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    locks.add(target.attr)
    return locks


def _collect_jit_targets(tree: ast.Module, aliases: Dict[str, str]) -> Set[str]:
    """Function names compiled indirectly: ``k = jax.jit(fn)`` and pallas
    kernels (``pl.pallas_call(fn, ...)``)."""
    targets: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, aliases) or ""
        if dotted in {"jax.jit", "jit"} and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                targets.add(arg.id)
        if dotted.endswith("pallas_call") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                targets.add(arg.id)
    return targets


def _is_jit_decorated(fn: ast.AST, aliases: Dict[str, str]) -> bool:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    for deco in fn.decorator_list:
        dotted = _dotted(deco, aliases)
        if dotted in {"jax.jit", "jit"}:
            return True
        if isinstance(deco, ast.Call):
            dotted = _dotted(deco.func, aliases)
            if dotted in {"jax.jit", "jit"}:
                return True
            if dotted in {"functools.partial", "partial"} and deco.args:
                inner = _dotted(deco.args[0], aliases)
                if inner in {"jax.jit", "jit"}:
                    return True
    return False


def collect_metric_labels(tree: ast.Module) -> Dict[str, Tuple[str, ...]]:
    """Declared label tuples per series attribute, from metrics.py's
    ``self.X = counter/gauge/histogram(name, doc, labels=(...))`` idiom (and
    raw prometheus_client constructors with ``labelnames=``)."""
    declared: Dict[str, Tuple[str, ...]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        call = node.value
        func = call.func
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Attribute):
            name = func.attr
        if name not in {
            "counter", "gauge", "histogram", "Counter", "Gauge", "Histogram",
        }:
            continue
        labels: Tuple[str, ...] = ()
        for kw in call.keywords:
            if kw.arg in {"labels", "labelnames"}:
                if isinstance(kw.value, (ast.Tuple, ast.List)) and all(
                    isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in kw.value.elts
                ):
                    labels = tuple(e.value for e in kw.value.elts)
                else:
                    labels = ("<dynamic>",)
        if labels == ("<dynamic>",):
            continue  # computed label list: not statically checkable, skip
        for target in node.targets:
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                declared[target.attr] = labels
            elif isinstance(target, ast.Name):
                declared[target.id] = labels
    return declared


def collect_metric_names(tree: ast.Module) -> Dict[str, int]:
    """Registered series name -> registration line, from metrics.py's
    ``counter/gauge/histogram("name", ...)`` idiom (and raw
    prometheus_client constructors).  The benchmark-defining series are
    registered through module-level string constants
    (``counter(BENCHMARK_DURATION, ...)``) — those names resolve too."""
    consts: Dict[str, str] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if isinstance(node.value, ast.Constant) and isinstance(
            node.value.value, str
        ):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    consts[target.id] = node.value.value
    names: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        fname = None
        if isinstance(func, ast.Name):
            fname = func.id
        elif isinstance(func, ast.Attribute):
            fname = func.attr
        if fname not in {
            "counter", "gauge", "histogram", "Counter", "Gauge", "Histogram",
        }:
            continue
        if not node.args:
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            names.setdefault(first.value, node.lineno)
        elif isinstance(first, ast.Name) and first.id in consts:
            names.setdefault(consts[first.id], node.lineno)
    return names


# Series tokens in the observability doc: a prometheus metric name, possibly
# wildcarded (``mysticeti_health_*`` names the family, not a series).  The
# packages share the prefix — ``mysticeti_tpu`` and ``mysticeti_tpu_torch``
# (as in ``python -m mysticeti_tpu_torch`` or a module path) are never
# series names.
_DOC_SERIES_RE = re.compile(r"\bmysticeti_[a-z0-9_]+\b")
_DOC_SERIES_NOT = frozenset({"mysticeti_tpu", "mysticeti_tpu_torch"})


def check_metrics_doc(
    metric_names: Dict[str, int],
    metrics_path: str,
    doc_text: str,
    doc_path: str,
) -> List[Finding]:
    """The ``metrics-doc`` rule: every series registered in metrics.py must
    appear in the package's docs/observability.md (the doc is the series inventory of
    record), and every ``mysticeti_*`` series the doc names must actually be
    registered (no documenting what was renamed away).  Cross-file, so it
    runs at the repo level rather than per-module."""
    findings: List[Finding] = []
    # Direction 1: registered but undocumented.  Token match (word
    # boundaries) so ``latency_s`` does not ride on ``latency_squared_s``.
    for name in sorted(metric_names):
        if not re.search(rf"\b{re.escape(name)}\b", doc_text):
            findings.append(
                Finding(
                    RULE_METRICS_DOC,
                    metrics_path,
                    metric_names[name],
                    0,
                    f"series '{name}' is registered in metrics.py but "
                    f"missing from {doc_path} (the series inventory of "
                    "record; add a row or drop the series)",
                )
            )
    # Direction 2: documented mysticeti_* series that no longer exist.
    registered = set(metric_names)
    for lineno, line in enumerate(doc_text.splitlines(), start=1):
        for match in _DOC_SERIES_RE.finditer(line):
            token = match.group(0)
            if token.endswith("_") or token in _DOC_SERIES_NOT:
                continue  # family wildcard / the package's own name
            if token not in registered:
                findings.append(
                    Finding(
                        RULE_METRICS_DOC,
                        doc_path,
                        lineno,
                        match.start(),
                        f"doc names series '{token}' which is not "
                        "registered in metrics.py (renamed or removed? "
                        "update the inventory)",
                    )
                )
    return findings


def collect_span_stages(tree: ast.Module, name: str = "STAGES") -> Optional[Tuple[str, ...]]:
    """The central stage registry from spans.py's ``STAGES = ("...", ...)``
    literal-tuple assignment (kept literal precisely so this parse works);
    ``name="PORT_STAGES"`` reads the port's own names the same way."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and target.id == name:
                if isinstance(node.value, (ast.Tuple, ast.List)) and all(
                    isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in node.value.elts
                ):
                    return tuple(e.value for e in node.value.elts)
    return None


def comment_lines(source: str) -> Dict[int, str]:
    """line -> comment text, via the tokenizer: a ``# lint: ...`` pattern
    quoted inside a docstring or message string is prose *about* the
    directive, not the directive — only real comments count."""
    import io
    import tokenize

    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # Unterminated construct mid-file: degrade to the raw-line scan.
        for i, line in enumerate(source.splitlines(), start=1):
            if "#" in line:
                out[i] = line
    return out


def _suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """line -> suppressed rule set (None = all rules)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in comment_lines(source).items():
        m = _IGNORE_RE.search(line)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = {part.strip() for part in m.group(1).split(",") if part.strip()}
    return out


class _FunctionScope:
    """Per-function bookkeeping for the task-orphan and wall-clock rules."""

    __slots__ = (
        "node", "is_async", "spawns", "awaited", "returned", "callbacked",
        "waited", "wall_names",
    )

    def __init__(self, node: Optional[ast.AST], is_async: bool) -> None:
        self.node = node
        self.is_async = is_async
        # (call node, binding) — binding is the assigned name/attr dotted
        # string, "" for a bare-expression spawn, None for compliant shapes.
        self.spawns: List[Tuple[ast.Call, Optional[str]]] = []
        self.awaited: Set[str] = set()
        self.returned: Set[str] = set()
        self.callbacked: Set[str] = set()
        self.waited: Set[str] = set()
        self.wall_names: Set[str] = set()


class _Checker(ast.NodeVisitor):
    def __init__(
        self,
        path: str,
        aliases: Dict[str, str],
        jit_targets: Set[str],
        metric_labels: Optional[Dict[str, Tuple[str, ...]]],
        span_stages: Optional[Tuple[str, ...]] = None,
    ) -> None:
        self.path = path
        self.aliases = aliases
        self.jit_targets = jit_targets
        self.metric_labels = metric_labels
        self.span_stages = span_stages
        self.findings: List[Finding] = []
        self._scopes: List[_FunctionScope] = [_FunctionScope(None, False)]
        self._class_locks: List[Set[str]] = []
        self._held_locks: List[str] = []
        self._method: List[str] = []
        norm = path.replace(os.sep, "/")
        self._jit_dir = any(f"/{d}/" in f"/{norm}" for d in JIT_PURITY_DIRS)

    # -- helpers --

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(rule, self.path, node.lineno, node.col_offset, message)
        )

    def _dot(self, node: ast.AST) -> Optional[str]:
        return _dotted(node, self.aliases)

    @property
    def _scope(self) -> _FunctionScope:
        return self._scopes[-1]

    def _is_spawn(self, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            resolved = self.aliases.get(func.id, func.id)
            return resolved.rsplit(".", 1)[-1] in SPAWN_NAMES
        if isinstance(func, ast.Attribute):
            return func.attr in SPAWN_NAMES
        return False

    # -- scope / class structure --

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_locks.append(_collect_class_locks(node, self.aliases))
        self.generic_visit(node)
        self._class_locks.pop()

    def _visit_function(self, node, is_async: bool) -> None:
        jitted = self._jit_dir and (
            node.name in self.jit_targets or _is_jit_decorated(node, self.aliases)
        )
        self._scopes.append(_FunctionScope(node, is_async))
        self._method.append(node.name)
        held, self._held_locks = self._held_locks, []
        for stmt in node.body:
            self.visit(stmt)
        self._held_locks = held
        self._method.pop()
        scope = self._scopes.pop()
        self._finish_scope(scope)
        if jitted:
            self._check_jit_purity(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_function(node, is_async=False)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_function(node, is_async=True)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # A lambda's value is returned to its caller; ``call_later(...,
        # lambda: ensure_future(c))`` discards the handle, so a spawn that IS
        # the whole lambda body is an orphan.
        body = node.body
        if isinstance(body, ast.Call) and self._is_spawn(body):
            self._scope.spawns.append((body, ""))
            for arg in ast.iter_child_nodes(body):
                self.visit(arg)
        else:
            self.generic_visit(node)

    # -- statement-level contexts for the task-orphan rule --

    def visit_Expr(self, node: ast.Expr) -> None:
        value = node.value
        if isinstance(value, ast.Call) and self._is_spawn(value):
            self._scope.spawns.append((value, ""))
            for child in ast.iter_child_nodes(value):
                self.visit(child)
            return
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        value = node.value
        bindings: List[Optional[str]] = []
        spawn_nodes: List[ast.Call] = []
        if isinstance(value, ast.Call) and self._is_spawn(value):
            spawn_nodes = [value]
        elif isinstance(value, (ast.List, ast.Tuple)):
            spawn_nodes = [
                e for e in value.elts
                if isinstance(e, ast.Call) and self._is_spawn(e)
            ]
        if spawn_nodes:
            target = node.targets[0]
            binding: Optional[str] = None
            if isinstance(target, ast.Name):
                binding = target.id
            elif isinstance(target, ast.Attribute):
                binding = self._dot(target)
            for spawn in spawn_nodes:
                self._scope.spawns.append((spawn, binding))
            for spawn in spawn_nodes:
                for child in ast.iter_child_nodes(spawn):
                    self.visit(child)
            for other in ast.iter_child_nodes(node):
                if other is not value:
                    self.visit(other)
            self._note_wall_assign(node)
            return
        self._note_wall_assign(node)
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return) -> None:
        value = node.value
        if isinstance(value, ast.Call) and self._is_spawn(value):
            self._scope.spawns.append((value, None))  # handed to the caller
            for child in ast.iter_child_nodes(value):
                self.visit(child)
            return
        if isinstance(value, ast.Name):
            self._scope.returned.add(value.id)
        elif isinstance(value, ast.Attribute):
            dotted = self._dot(value)
            if dotted:
                self._scope.returned.add(dotted)
        self.generic_visit(node)

    def visit_Await(self, node: ast.Await) -> None:
        value = node.value
        if self._held_locks:
            self._emit(
                RULE_LOCK_DISCIPLINE,
                node,
                f"await while holding threading lock '{self._held_locks[-1]}' "
                "(blocks the event loop; use the lock only around non-awaiting "
                "critical sections)",
            )
        if isinstance(value, ast.Call) and self._is_spawn(value):
            self._scope.spawns.append((value, None))  # awaited immediately
            for child in ast.iter_child_nodes(value):
                self.visit(child)
            return
        if isinstance(value, ast.Name):
            self._scope.awaited.add(value.id)
        elif isinstance(value, ast.Attribute):
            dotted = self._dot(value)
            if dotted:
                self._scope.awaited.add(dotted)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        lock_attrs = self._class_locks[-1] if self._class_locks else set()
        for item in node.items:
            expr = item.context_expr
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in lock_attrs
            ):
                self._held_locks.append(expr.attr)
                pushed += 1
        for item in node.items:
            self.visit(item)
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self._held_locks.pop()

    # -- calls: blocking-in-async, metrics labels, spawn args, callbacks --

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self._dot(node.func) or ""
        func = node.func

        if isinstance(func, ast.Attribute):
            if func.attr == "add_done_callback":
                owner = self._dot(func.value)
                if owner:
                    self._scope.callbacked.add(owner)
            if func.attr == "labels":
                self._check_metric_labels(node, func)
            if func.attr == "append" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Call) and self._is_spawn(arg):
                    # Appending straight into a task list stores the handle
                    # but nobody ever awaits list members — exceptions are
                    # swallowed until (at best) interpreter shutdown.
                    self._scope.spawns.append((arg, ""))
                    for child in ast.iter_child_nodes(arg):
                        self.visit(child)
                    for other in node.args[1:] + [kw.value for kw in node.keywords]:
                        self.visit(other)
                    self.visit(func.value)
                    return

        self._check_span_name(node)

        if self._scope.is_async:
            self._check_async_blocking(node, dotted)

        tail = dotted.rsplit(".", 1)[-1]
        if tail in _WAITER_SUFFIXES:
            for arg in node.args:
                self._note_waited(arg)

        self._check_wall_clock_call(node)
        self.generic_visit(node)

    def _note_waited(self, arg: ast.AST) -> None:
        if isinstance(arg, ast.Name):
            self._scope.waited.add(arg.id)
        elif isinstance(arg, ast.Attribute):
            dotted = self._dot(arg)
            if dotted:
                self._scope.waited.add(dotted)
        elif isinstance(arg, (ast.List, ast.Tuple, ast.Set)):
            for e in arg.elts:
                self._note_waited(e)
        elif isinstance(arg, ast.Starred):
            self._note_waited(arg.value)

    def _check_async_blocking(self, node: ast.Call, dotted: str) -> None:
        if dotted in BLOCKING_CALLS:
            self._emit(
                RULE_ASYNC_BLOCKING,
                node,
                f"blocking call {dotted}() inside async def "
                f"{self._method[-1] if self._method else '<module>'} "
                "(use asyncio equivalents or run_in_executor)",
            )
            return
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in BLOCKING_METHODS:
            self._emit(
                RULE_ASYNC_BLOCKING,
                node,
                f"synchronous accelerator dispatch .{func.attr}() called "
                "directly from a coroutine (dispatch via run_in_executor so "
                "the event loop never blocks on the device)",
            )

    # -- rule 3b: guarded-field mutation --

    def _check_guarded_target(self, target: ast.AST, node: ast.AST) -> None:
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
            and target.attr in GUARDED_FIELDS
        ):
            return
        if self._method and self._method[-1] == "__init__":
            return
        lock = GUARDED_FIELDS[target.attr]
        if lock not in self._held_locks:
            self._emit(
                RULE_LOCK_DISCIPLINE,
                node,
                f"shared field self.{target.attr} mutated outside its "
                f"designated lock 'self.{lock}' (EMA/counter read-modify-"
                "writes race across threads)",
            )

    # -- rule 5: wall-clock intervals --

    def _note_wall_assign(self, node: ast.Assign) -> None:
        value = node.value
        if (
            isinstance(value, ast.Call)
            and self._dot(value.func) == "time.time"
        ):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self._scope.wall_names.add(target.id)

    def _is_wall_operand(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call) and self._dot(node.func) == "time.time":
            return True
        return isinstance(node, ast.Name) and node.id in self._scope.wall_names

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.Sub) and (
            self._is_wall_operand(node.left) or self._is_wall_operand(node.right)
        ):
            self._emit(
                RULE_WALL_CLOCK,
                node,
                "interval measured with time.time() (wall clock steps under "
                "NTP; use time.monotonic() for durations)",
            )
        self.generic_visit(node)

    def _check_wall_clock_call(self, node: ast.Call) -> None:
        # AugAssign path (``acc -= time.time()``) is rare enough to skip; the
        # assign+subtract idiom above covers this codebase.
        return

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_guarded_target(node.target, node)
        self.generic_visit(node)

    def _visit_assign_guarded(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_guarded_target(target, node)

    # -- rule 4: jit purity --

    def _check_jit_purity(self, fn: ast.AST) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "item" and not node.args:
                self._emit(
                    RULE_JIT_PURITY,
                    node,
                    ".item() inside a jit/pallas kernel forces a host sync "
                    "per element (keep values on device)",
                )
                continue
            dotted = self._dot(func) or ""
            if dotted in JIT_IMPURE_CALLS:
                self._emit(
                    RULE_JIT_PURITY,
                    node,
                    f"{dotted}() inside a jit/pallas kernel (debug prints "
                    "recompile and serialize the kernel; gate behind "
                    "interpret mode)",
                )
            elif any(dotted.startswith(p) for p in JIT_IMPURE_PREFIXES):
                self._emit(
                    RULE_JIT_PURITY,
                    node,
                    f"host call {dotted}() inside a jit/pallas kernel "
                    "(numpy/time run at trace time, not on device — use "
                    "jax.numpy or hoist out of the kernel)",
                )
            elif isinstance(func, ast.Name) and func.id == "print":
                self._emit(
                    RULE_JIT_PURITY,
                    node,
                    "print() inside a jit/pallas kernel executes at trace "
                    "time only (use jax.debug.print in interpret mode if "
                    "needed)",
                )

    # -- rule 7: span stage names --

    def _check_span_name(self, node: ast.Call) -> None:
        if self.span_stages is None:
            return
        func = node.func
        name = None
        if isinstance(func, ast.Attribute):
            name = func.attr
        elif isinstance(func, ast.Name):
            name = func.id
        if name not in SPAN_CALL_NAMES or not node.args:
            return
        first = node.args[0]
        if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
            return  # computed stage: not statically checkable, skip
        if first.value not in self.span_stages:
            self._emit(
                RULE_SPAN_NAMES,
                node,
                f"span stage '{first.value}' is not in the central registry "
                "spans.STAGES (a typo'd stage silently never matches its "
                "begin/end and disappears from traces)",
            )

    # -- rule 6: metrics label arity --

    def _check_metric_labels(self, node: ast.Call, func: ast.Attribute) -> None:
        if self.metric_labels is None:
            return
        owner = func.value
        metric = None
        if isinstance(owner, ast.Attribute):
            metric = owner.attr
        elif isinstance(owner, ast.Name):
            metric = owner.id
        if metric is None or metric not in self.metric_labels:
            return
        declared = self.metric_labels[metric]
        given = len(node.args) + len(node.keywords)
        kw_names = {kw.arg for kw in node.keywords if kw.arg}
        if given != len(declared) or not kw_names.issubset(set(declared)):
            self._emit(
                RULE_METRICS_LABELS,
                node,
                f".labels() arity mismatch for series '{metric}': declared "
                f"{list(declared)} in metrics.py, call passes {given} "
                "label(s)",
            )

    # -- scope wrap-up --

    def _finish_scope(self, scope: _FunctionScope) -> None:
        supervised = scope.awaited | scope.returned | scope.callbacked | scope.waited
        for call, binding in scope.spawns:
            if binding is None:
                continue  # awaited/returned at the spawn site
            if binding and binding in supervised:
                continue
            where = f"bound to '{binding}'" if binding else "with a discarded handle"
            self.findings.append(
                Finding(
                    RULE_TASK_ORPHAN,
                    self.path,
                    call.lineno,
                    call.col_offset,
                    f"fire-and-forget task {where}: the handle is never "
                    "awaited and has no exception-logging done-callback — "
                    "exceptions are silently swallowed (use "
                    "utils.tasks.spawn_logged)",
                )
            )

    # Route Assign through both the spawn tracking above and rule 3b.
    def generic_visit(self, node: ast.AST) -> None:
        if isinstance(node, ast.Assign):
            self._visit_assign_guarded(node)
        super().generic_visit(node)


def _module_ignores(source: str) -> Set[str]:
    out: Set[str] = set()
    for line in comment_lines(source).values():
        m = _IGNORE_MODULE_RE.search(line)
        if m:
            out.update(
                part.strip() for part in m.group(1).split(",") if part.strip()
            )
    return out


@dataclass
class FileAnalysis:
    """Raw per-module analysis: findings before suppression, plus the
    lock census analyze_paths merges for the repo-level rules."""

    path: str
    findings: List[Finding]
    locks: "object"  # lockgraph.ModuleLocks (kept loose for serialization)
    suppressions: Dict[int, Optional[Set[str]]]
    module_ignores: Set[str]


def _collect_native_aliases(tree: ast.Module) -> Set[str]:
    """Module-level names bound to the native extension object via
    ``from .native import native [as X]`` (or the absolute form)."""
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        mod = node.module or ""
        if mod != "native" and not mod.endswith(".native"):
            continue
        for a in node.names:
            if a.name == "native":
                aliases.add(a.asname or a.name)
    return aliases


def _native_gate_polarity(test: ast.expr, alias: str) -> Optional[str]:
    """Which branch of an ``if`` with this test is native-gated for ``alias``.

    Returns ``"body"`` (``alias is not None`` / ``hasattr(alias, ...)``),
    ``"orelse"`` (``alias is None`` — the early-return shape), or ``None``.
    The comparison may sit inside a ``boolop`` conjunction
    (``if native is not None and end > 0:`` — wal.py's idiom); the scan is
    deliberately syntactic, mirroring how the contract is written at every
    existing call site.
    """
    for sub in ast.walk(test):
        if isinstance(sub, ast.Compare) and len(sub.ops) == 1:
            left, op, right = sub.left, sub.ops[0], sub.comparators[0]
            sides = (left, right)
            has_alias = any(
                isinstance(s, ast.Name) and s.id == alias for s in sides
            )
            has_none = any(
                isinstance(s, ast.Constant) and s.value is None for s in sides
            )
            if has_alias and has_none:
                if isinstance(op, (ast.IsNot, ast.NotEq)):
                    return "body"
                if isinstance(op, (ast.Is, ast.Eq)):
                    return "orelse"
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id == "hasattr"
            and sub.args
            and isinstance(sub.args[0], ast.Name)
            and sub.args[0].id == alias
        ):
            return "body"
    return None


# Statement fields holding nested statement lists — skipped by the
# expression scan, recursed into by the block walk.
_STMT_BLOCK_FIELDS = frozenset({"body", "orelse", "finalbody", "handlers"})


def check_native_fallback(tree: ast.Module, path: str) -> List[Finding]:
    """The ``native-fallback`` rule: every ``native.<fn>`` attribute access
    on a module alias of the C extension must sit under a
    ``native is None``-aware branch (or module-level gate) so the
    pure-Python fallback path exists — the contract ``native/__init__.py``
    documents (the extension is an acceleration, never a hard dependency;
    ``MYSTICETI_NO_NATIVE=1`` must always work).

    Scope: direct accesses through a module alias (``from .native import
    native as X`` → ``X.fn``).  Indirection through instance attributes
    (committee.py stores the module on ``self``) is the storing class's
    contract — the assignment itself is still checked here.
    Recognized gates: an enclosing ``if X is not None:`` /
    ``hasattr(X, ...)`` branch, the ``else`` of ``if X is None:``, or the
    statements following an ``if X is None: return/raise/continue`` early
    exit.
    """
    aliases = _collect_native_aliases(tree)
    if not aliases:
        return []
    findings: List[Finding] = []

    def scan_exprs(node: ast.AST, guarded: Set[str]) -> None:
        for field, value in ast.iter_fields(node):
            if field in _STMT_BLOCK_FIELDS:
                continue
            items = value if isinstance(value, list) else [value]
            for item in items:
                if not isinstance(item, ast.AST):
                    continue
                for sub in ast.walk(item):
                    if (
                        isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id in aliases
                        and sub.value.id not in guarded
                    ):
                        findings.append(
                            Finding(
                                RULE_NATIVE_FALLBACK,
                                path,
                                sub.lineno,
                                sub.col_offset,
                                f"native access '{sub.value.id}.{sub.attr}' "
                                f"outside a '{sub.value.id} is None'-aware "
                                "gate — every native call site needs a "
                                "pure-Python fallback branch "
                                "(native/__init__.py contract; gate with "
                                f"'if {sub.value.id} is not None:' or "
                                "hasattr)",
                            )
                        )

    def walk_block(stmts: Sequence[ast.stmt], guarded: Set[str]) -> None:
        flowing = set(guarded)
        for st in stmts:
            if isinstance(st, ast.If):
                scan_exprs(st.test, flowing)
                gates = {
                    a: _native_gate_polarity(st.test, a) for a in aliases
                }
                walk_block(
                    st.body,
                    flowing | {a for a, p in gates.items() if p == "body"},
                )
                walk_block(
                    st.orelse,
                    flowing | {a for a, p in gates.items() if p == "orelse"},
                )
                if st.body and isinstance(
                    st.body[-1], (ast.Return, ast.Raise, ast.Continue,
                                  ast.Break)
                ):
                    # `if X is None: return fallback` — everything after
                    # the early exit runs native-gated.
                    flowing |= {a for a, p in gates.items() if p == "orelse"}
                continue
            scan_exprs(st, flowing)
            for field in ("body", "orelse", "finalbody"):
                sub_block = getattr(st, field, None)
                if sub_block:
                    walk_block(sub_block, flowing)
            for handler in getattr(st, "handlers", ()) or ():
                walk_block(handler.body, flowing)
        return

    walk_block(tree.body, set())
    return findings


def _analyze_module(
    source: str,
    path: str,
    metric_labels: Optional[Dict[str, Tuple[str, ...]]] = None,
    span_stages: Optional[Tuple[str, ...]] = None,
) -> FileAnalysis:
    """Run every per-module rule; suppressions are recorded, not applied."""
    from . import detflow, lockgraph, races

    tree = ast.parse(source, filename=path)
    aliases = _collect_aliases(tree)
    jit_targets = _collect_jit_targets(tree, aliases)
    checker = _Checker(path, aliases, jit_targets, metric_labels, span_stages)
    # Rule 3b must also see module-level and __init__ assigns routed through
    # generic_visit; the NodeVisitor dispatch handles the rest.
    checker.visit(tree)
    findings = list(checker.findings)
    ignores = _module_ignores(source)

    if RULE_SIM_TAINT not in ignores:
        for tf in detflow.check_sim_taint(tree, aliases):
            findings.append(
                Finding(
                    RULE_SIM_TAINT, path, tf.line, tf.col, tf.message,
                    also_lines=(tf.source_line,) if tf.source_line else (),
                )
            )
    if RULE_AWAIT_ATOMICITY not in ignores:
        for rf in races.check_await_atomicity(tree, aliases, source):
            findings.append(
                Finding(RULE_AWAIT_ATOMICITY, path, rf.line, rf.col, rf.message)
            )
    if RULE_NATIVE_FALLBACK not in ignores:
        findings.extend(check_native_fallback(tree, path))
    locks = lockgraph.collect_module_locks(tree, aliases, path, source)
    if RULE_GUARD_INFERENCE not in ignores:
        for gf in lockgraph.check_guard_inference(locks, GUARDED_FIELDS):
            findings.append(
                Finding(RULE_GUARD_INFERENCE, path, gf.line, gf.col, gf.message)
            )

    return FileAnalysis(
        path=path,
        findings=[f for f in findings if f.rule not in ignores],
        locks=locks,
        suppressions=_suppressions(source),
        module_ignores=ignores,
    )


def _apply_suppressions(
    findings: Sequence[Finding],
    suppressions: Dict[int, Optional[Set[str]]],
) -> Tuple[List[Finding], Set[int]]:
    """Drop suppressed findings; return (kept, comment lines that fired).

    A finding is silenced by a matching ignore comment on its own line,
    the line above, or (when the finding carries ``also_lines`` — the
    sim-taint source read) any of those lines or the line above them.
    """
    kept: List[Finding] = []
    used: Set[int] = set()
    for f in findings:
        hit_line: Optional[int] = None
        for anchor in (f.line, *f.also_lines):
            for line in (anchor, anchor - 1):
                if line in suppressions:
                    rules = suppressions[line]
                    if rules is None or f.rule in rules:
                        hit_line = line
                    break
            if hit_line is not None:
                break
        if hit_line is None:
            kept.append(f)
        else:
            used.add(hit_line)
    return kept, used


def _unused_suppression_findings(
    path: str,
    suppressions: Dict[int, Optional[Set[str]]],
    used: Set[int],
) -> List[Finding]:
    out: List[Finding] = []
    for line, rules in sorted(suppressions.items()):
        if line in used:
            continue
        what = "all rules" if rules is None else ", ".join(sorted(rules))
        out.append(
            Finding(
                RULE_UNUSED_SUPPRESSION,
                path,
                line,
                0,
                f"suppression '# lint: ignore[{what}]' no longer matches any "
                "finding — the bug it excused is gone (or the comment "
                "drifted); delete it so suppressions cannot outlive their "
                "justification",
            )
        )
    return out


def analyze_source(
    source: str,
    path: str,
    metric_labels: Optional[Dict[str, Tuple[str, ...]]] = None,
    span_stages: Optional[Tuple[str, ...]] = None,
) -> List[Finding]:
    """Run all per-module rules over one source; returns findings with
    inline ``# lint: ignore[...]`` suppressions already applied and
    unused suppressions reported."""
    fa = _analyze_module(source, path, metric_labels, span_stages)
    kept, used = _apply_suppressions(fa.findings, fa.suppressions)
    kept.extend(_unused_suppression_findings(path, fa.suppressions, used))
    return sorted(kept, key=lambda f: (f.path, f.line, f.col, f.rule))


def analyze_file(
    path: str,
    root: Optional[str] = None,
    metric_labels: Optional[Dict[str, Tuple[str, ...]]] = None,
    span_stages: Optional[Tuple[str, ...]] = None,
) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    rel = os.path.relpath(path, root) if root else path
    return analyze_source(
        source, rel.replace(os.sep, "/"), metric_labels, span_stages
    )


# -- per-file cache + parallel gate -------------------------------------------
#
# The repo gate runs inside tier-1 on every test invocation; with the
# dataflow rules the per-file pass is no longer trivially cheap.  Two
# levers keep it off the critical path: a content-hash cache (a file whose
# bytes and analysis toolchain are unchanged re-uses its raw findings) and
# per-file multiprocessing for the misses.  Raw (pre-suppression)
# results are cached so the repo-level rules and suppression hygiene can
# still run over the merged set.

CACHE_BASENAME = ".lint-cache-torch.json"

_tool_fp_cache: Optional[str] = None


def _tool_fingerprint() -> str:
    """Digest of the analysis package itself: edit a rule, drop the cache."""
    global _tool_fp_cache
    if _tool_fp_cache is None:
        import hashlib

        h = hashlib.sha256()
        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        for name in sorted(os.listdir(pkg_dir)):
            if name.endswith(".py"):
                with open(os.path.join(pkg_dir, name), "rb") as fh:
                    h.update(name.encode())
                    h.update(fh.read())
        _tool_fp_cache = h.hexdigest()
    return _tool_fp_cache


def _entry_key(source: str, context_fp: str) -> str:
    import hashlib

    h = hashlib.sha256()
    h.update(source.encode("utf-8", "surrogatepass"))
    h.update(_tool_fingerprint().encode())
    h.update(context_fp.encode())
    return h.hexdigest()


def _serialize_analysis(fa: FileAnalysis) -> dict:
    locks = fa.locks
    return {
        "findings": [
            [f.rule, f.line, f.col, f.message, list(f.also_lines)]
            for f in fa.findings
        ],
        "edges": [
            [e.held, e.acquired, e.path, e.line] for e in locks.edges
        ],
        "writes": [
            [
                cls,
                attr,
                census.guarded,
                [[line, col, sorted(held)] for line, col, held in census.sites],
                sorted(census.touched),
            ]
            for (cls, attr), census in sorted(locks.writes.items())
        ],
        "suppressions": {
            str(line): (None if rules is None else sorted(rules))
            for line, rules in fa.suppressions.items()
        },
        "module_ignores": sorted(fa.module_ignores),
    }


def _deserialize_analysis(path: str, data: dict) -> FileAnalysis:
    from .lockgraph import FieldWrites, LockEdge, ModuleLocks

    locks = ModuleLocks()
    locks.edges = [
        LockEdge(held, acquired, epath, line)
        for held, acquired, epath, line in data["edges"]
    ]
    for cls, attr, guarded, sites, touched in data["writes"]:
        census = FieldWrites()
        census.guarded = {str(k): int(v) for k, v in guarded.items()}
        census.sites = [
            (line, col, frozenset(held)) for line, col, held in sites
        ]
        census.touched = set(touched)
        locks.writes[(cls, attr)] = census
    return FileAnalysis(
        path=path,
        findings=[
            Finding(rule, path, line, col, message, also_lines=tuple(also))
            for rule, line, col, message, also in data["findings"]
        ],
        locks=locks,
        suppressions={
            int(line): (None if rules is None else set(rules))
            for line, rules in data["suppressions"].items()
        },
        module_ignores=set(data["module_ignores"]),
    )


def _pool_worker(args: Tuple) -> Tuple[str, dict]:
    """Module-level so multiprocessing can pickle it."""
    rel, source, metric_labels, span_stages = args
    fa = _analyze_module(source, rel, metric_labels, span_stages)
    return rel, _serialize_analysis(fa)


def _load_cache(cache_path: str) -> Dict[str, dict]:
    try:
        with open(cache_path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    entries = data.get("entries")
    return entries if isinstance(entries, dict) else {}


def _store_cache(cache_path: str, entries: Dict[str, dict]) -> None:
    tmp = f"{cache_path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"entries": entries}, fh)
        os.replace(tmp, cache_path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames if not d.startswith((".", "__pycache__"))]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def analyze_paths(
    paths: Sequence[str],
    root: Optional[str] = None,
    jobs: Optional[int] = None,
    use_cache: bool = True,
) -> List[Finding]:
    """Analyze every ``.py`` under ``paths``; the metrics-label registry is
    built from the first ``metrics.py`` encountered in the scanned set, and
    the span-stage registry from the first ``spans.py``.

    ``jobs``: worker processes for the per-file pass (``None`` = pick from
    the CPU count; ``1`` = in-process).  ``use_cache``: re-use per-file
    results for unchanged sources from ``<root>/.lint-cache-torch.json``
    (requires ``root``).
    """
    from . import lockgraph

    files = list(_iter_py_files(paths))
    metric_labels: Optional[Dict[str, Tuple[str, ...]]] = None
    span_stages: Optional[Tuple[str, ...]] = None
    metrics_py: Optional[str] = None
    for path in files:
        base = os.path.basename(path)
        if base == "metrics.py" and metric_labels is None:
            metrics_py = path
            with open(path, "r", encoding="utf-8") as fh:
                metric_labels = collect_metric_labels(ast.parse(fh.read()))
        elif base == "spans.py" and span_stages is None:
            with open(path, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            span_stages = collect_span_stages(tree)
            if span_stages is not None:
                span_stages += collect_span_stages(tree, "PORT_STAGES") or ()
        if metric_labels is not None and span_stages is not None:
            break

    def rel(path: str) -> str:
        out = os.path.relpath(path, root) if root else path
        return out.replace(os.sep, "/")

    # Registry changes invalidate per-file results even when the file
    # itself is byte-identical (metrics-labels / span-names look them up).
    context_fp = repr((sorted((metric_labels or {}).items()), span_stages))

    cache_path = (
        os.path.join(root, CACHE_BASENAME) if (root and use_cache) else None
    )
    cached = _load_cache(cache_path) if cache_path else {}

    sources: Dict[str, str] = {}
    keys: Dict[str, str] = {}
    analyses: Dict[str, FileAnalysis] = {}
    misses: List[str] = []
    for path in files:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        r = rel(path)
        sources[r] = source
        keys[r] = _entry_key(source, context_fp)
        entry = cached.get(r)
        if entry is not None and entry.get("key") == keys[r]:
            try:
                analyses[r] = _deserialize_analysis(r, entry["data"])
                continue
            except (KeyError, TypeError, ValueError):
                pass
        misses.append(r)

    if jobs is None:
        jobs = min(8, os.cpu_count() or 1)
    if jobs > 1 and len(misses) >= 4:
        import multiprocessing

        try:
            ctx = multiprocessing.get_context("fork")
        except ValueError:  # platform without fork: spawn re-imports fine
            ctx = multiprocessing.get_context("spawn")
        work = [
            (r, sources[r], metric_labels, span_stages) for r in misses
        ]
        try:
            with ctx.Pool(min(jobs, len(work))) as pool:
                for r, data in pool.map(_pool_worker, work):
                    analyses[r] = _deserialize_analysis(r, data)
            misses = []
        except Exception:
            pass  # pool unavailable (sandbox, recursion): fall through serial
    for r in misses:
        analyses[r] = _analyze_module(
            sources[r], r, metric_labels, span_stages
        )

    if cache_path:
        _store_cache(
            cache_path,
            {
                r: {"key": keys[r], "data": _serialize_analysis(fa)}
                for r, fa in analyses.items()
            },
        )

    findings: List[Finding] = []
    for r in sorted(analyses):
        findings.extend(analyses[r].findings)

    # -- repo-level rules over the merged set ---------------------------------

    # Lock-order: cycles in the package-wide acquisition graph.
    all_edges = [e for fa in analyses.values() for e in fa.locks.edges]
    for path_, line, message in lockgraph.lock_order_messages(
        lockgraph.find_lock_cycles(all_edges)
    ):
        findings.append(Finding(RULE_LOCK_ORDER, path_, line, 0, message))

    # Stale GUARDED_FIELDS annotations, anchored at the registry entry.
    checker_rel = next(
        (
            r
            for r in sorted(analyses)
            if r.endswith("analysis/checker.py")
        ),
        None,
    )
    if checker_rel is not None:
        checker_src = sources[checker_rel].splitlines()
        for attr, _lock, message in lockgraph.stale_annotations(
            [fa.locks for fa in analyses.values()], GUARDED_FIELDS
        ):
            line = next(
                (
                    i
                    for i, text in enumerate(checker_src, start=1)
                    if f'"{attr}"' in text and "GUARDED" not in text
                ),
                1,
            )
            findings.append(
                Finding(RULE_GUARD_INFERENCE, checker_rel, line, 0, message)
            )

    # Repo-level metrics-doc rule: runs whenever the scanned set contains
    # the package metrics.py and the package carries docs/observability.md
    # beside it (the port's series inventory of record).
    if metrics_py is not None:
        package = os.path.dirname(os.path.abspath(metrics_py))
        doc = os.path.join(package, "docs", "observability.md")
        if os.path.exists(doc):
            with open(metrics_py, "r", encoding="utf-8") as fh:
                metric_names = collect_metric_names(ast.parse(fh.read()))
            with open(doc, "r", encoding="utf-8") as fh:
                doc_text = fh.read()
            findings.extend(
                check_metrics_doc(
                    metric_names, rel(metrics_py), doc_text, rel(doc)
                )
            )

    # -- suppression application + hygiene ------------------------------------

    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    for path_ in sorted(set(by_path) | set(analyses)):
        group = by_path.get(path_, [])
        fa = analyses.get(path_)
        suppressions = fa.suppressions if fa is not None else {}
        kept, used = _apply_suppressions(group, suppressions)
        out.extend(kept)
        if fa is not None:
            out.extend(
                _unused_suppression_findings(path_, suppressions, used)
            )
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


# -- baseline -----------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.fingerprint()] = counts.get(f.fingerprint(), 0) + 1
    payload = {
        "comment": (
            "mysticeti-lint baseline: pre-existing findings tolerated at "
            "CI-gate time. Regenerate with `python -m "
            "mysticeti_tpu_torch.analysis --baseline-regen` (or python -m "
            "mysticeti_tpu_torch.tools.lint --baseline-regen) after "
            "deliberate changes; prefer fixing or inline-ignoring over "
            "baselining."
        ),
        "findings": dict(sorted(counts.items())),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=False)
        fh.write("\n")


def new_findings(
    findings: Sequence[Finding], baseline: Dict[str, int]
) -> List[Finding]:
    """Findings beyond the baselined count per fingerprint (zero-new gate)."""
    budget = dict(baseline)
    out: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
        else:
            out.append(f)
    return out
