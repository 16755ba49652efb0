"""The port's lint: counterparts of ``tests/test_static_analysis.py``.

Every test of the reference suite, by the same name, against
``mysticeti_tpu_torch.analysis``: each rule catches its fixture violation and
stays silent on the compliant twin, and the repo gate runs the port's
analyzer over ``mysticeti_tpu_torch/`` (in-process, through ``python -m
mysticeti_tpu_torch.analysis`` and through ``python -m
mysticeti_tpu_torch.tools.lint``) with zero findings and an empty baseline.
Then parity with the JAX package: every fixture source of the reference
suite gives the same findings under both checkers, both give zero findings
on ``mysticeti_tpu/``, and the ``sim-taint`` catch on the state root
(``tests/test_execution.py:776``) holds in the port.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from mysticeti_tpu_torch.analysis import (
    RULES,
    analyze_paths,
    analyze_source,
    load_baseline,
    new_findings,
    write_baseline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mysticeti_tpu_torch")
BASELINE = os.path.join(PKG, "analysis", "baseline.json")


def run(src, path="mysticeti_tpu_torch/example.py", **kw):
    return analyze_source(textwrap.dedent(src), path, **kw)


def rules_of(findings):
    return sorted({f.rule for f in findings})


# -- rule 1: async-blocking ---------------------------------------------------

def test_async_blocking_positive_sleep():
    findings = run(
        """
        import time

        async def handler():
            time.sleep(0.1)
        """
    )
    assert rules_of(findings) == ["async-blocking"]
    assert "time.sleep" in findings[0].message


def test_async_blocking_positive_direct_dispatch():
    findings = run(
        """
        async def flush(verifier, pks, digests, sigs):
            return verifier.verify_signatures(pks, digests, sigs)
        """
    )
    assert rules_of(findings) == ["async-blocking"]
    assert "verify_signatures" in findings[0].message


def test_async_blocking_negative():
    findings = run(
        """
        import asyncio
        import time

        async def handler(loop, verifier, pks, digests, sigs):
            await asyncio.sleep(0.1)

            def _dispatch():
                # sync nested fn: runs in the executor, not the loop
                return verifier.verify_signatures(pks, digests, sigs)

            return await loop.run_in_executor(None, _dispatch)

        def sync_path():
            time.sleep(0.1)  # blocking is fine outside coroutines
        """
    )
    assert findings == []


# -- rule 2: task-orphan ------------------------------------------------------

def test_task_orphan_positive_shapes():
    findings = run(
        """
        import asyncio

        class Node:
            def start_discarded(self):
                asyncio.ensure_future(self._run())

            def start_attr(self):
                self._task = asyncio.ensure_future(self._run())

            def start_appended(self, loop):
                self._tasks.append(loop.create_task(self._run()))

            def start_lambda(self, loop):
                loop.call_later(1.0, lambda: asyncio.ensure_future(self._run()))
        """
    )
    assert [f.rule for f in findings] == ["task-orphan"] * 4


def test_task_orphan_negative_shapes():
    findings = run(
        """
        import asyncio

        class Node:
            def start_supervised(self):
                self._task = asyncio.ensure_future(self._run())
                self._task.add_done_callback(self._on_done)

            async def awaited(self):
                task = asyncio.ensure_future(self._run())
                return await task

            async def raced(self):
                first = asyncio.ensure_future(self._recv())
                second = asyncio.ensure_future(self._closed.wait())
                done, pending = await asyncio.wait({first, second})

            def handed_to_caller(self):
                return asyncio.ensure_future(self._run())

            def via_helper(self, log):
                self._task = spawn_logged(self._run(), log)
        """
    )
    assert findings == []


# -- rule 3: lock-discipline --------------------------------------------------

def test_lock_discipline_positive_await_under_lock():
    findings = run(
        """
        import threading

        class Collector:
            def __init__(self):
                self._lock = threading.Lock()

            async def flush(self):
                with self._lock:
                    await self._dispatch()
        """
    )
    assert rules_of(findings) == ["lock-discipline"]
    assert "await while holding" in findings[0].message


def test_lock_discipline_positive_guarded_field():
    findings = run(
        """
        import threading

        class Hybrid:
            def __init__(self):
                self._ema_lock = threading.Lock()
                self.cpu_per_sig_s = 0.0  # __init__ is exempt

            def observe(self, sample):
                self.cpu_per_sig_s = 0.8 * self.cpu_per_sig_s + 0.2 * sample
        """
    )
    assert rules_of(findings) == ["lock-discipline"]
    assert "cpu_per_sig_s" in findings[0].message


def test_lock_discipline_negative():
    findings = run(
        """
        import asyncio
        import threading

        class Hybrid:
            def __init__(self):
                self._ema_lock = threading.Lock()
                self._alock = asyncio.Lock()
                self.cpu_per_sig_s = 0.0

            def observe(self, sample):
                with self._ema_lock:
                    self.cpu_per_sig_s = 0.8 * self.cpu_per_sig_s + 0.2 * sample

            async def async_section(self):
                async with self._alock:
                    await self._dispatch()
        """
    )
    assert findings == []


# -- rule 4: jit-purity -------------------------------------------------------

_JIT_FIXTURE = """
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np


    @jax.jit
    def kernel(x):
        jax.debug.print("x = {}", x)
        return np.asarray(x) + 1


    @functools.partial(jax.jit, static_argnames=("tile",))
    def tiled(x, tile):
        return jnp.sum(x) + x.item()


    def wrapped_impl(x):
        print(x)
        return x

    wrapped = jax.jit(wrapped_impl)
"""


def test_jit_purity_positive_in_ops():
    findings = run(_JIT_FIXTURE, path="mysticeti_tpu_torch/ops/fake_kernel.py")
    assert [f.rule for f in findings] == ["jit-purity"] * 4
    messages = " ".join(f.message for f in findings)
    assert "jax.debug.print" in messages
    assert ".item()" in messages
    assert "numpy.asarray" in messages
    assert "print()" in messages


def test_jit_purity_negative():
    # Same host-impure code OUTSIDE ops/ and parallel/: other rules own the
    # generic paths; jit purity is scoped to kernel directories.
    assert run(_JIT_FIXTURE, path="mysticeti_tpu_torch/example.py") == []
    # Pure jnp kernels in ops/ are clean.
    clean = run(
        """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def kernel(x):
            return jnp.sum(x * x)
        """,
        path="mysticeti_tpu_torch/ops/fake_kernel.py",
    )
    assert clean == []


# -- rule 5: wall-clock -------------------------------------------------------

def test_wall_clock_positive():
    findings = run(
        """
        import time

        def measure(work):
            started = time.time()
            work()
            return time.time() - started
        """
    )
    assert rules_of(findings) == ["wall-clock"]


def test_wall_clock_negative():
    findings = run(
        """
        import time

        def measure(work):
            started = time.monotonic()
            work()
            return time.monotonic() - started

        def stamp():
            # Timestamping (no interval arithmetic) is the wall clock's job.
            return time.time()
        """
    )
    assert findings == []


# -- rule 6: metrics-labels ---------------------------------------------------

_METRIC_LABELS = {"verified_signatures_total": ("backend", "outcome")}


def test_metrics_labels_positive():
    findings = run(
        """
        class Verifier:
            def count(self, n):
                self.metrics.verified_signatures_total.labels("tpu").inc(n)
        """,
        metric_labels=_METRIC_LABELS,
    )
    assert rules_of(findings) == ["metrics-labels"]
    assert "verified_signatures_total" in findings[0].message


def test_metrics_labels_negative():
    findings = run(
        """
        class Verifier:
            def count(self, n):
                self.metrics.verified_signatures_total.labels("tpu", "accepted").inc(n)
                self.other_series.labels("anything")  # undeclared: skipped
        """,
        metric_labels=_METRIC_LABELS,
    )
    assert findings == []


# -- rule 7: span-names -------------------------------------------------------

_SPAN_STAGES = ("receive", "verify", "commit")


def test_span_names_positive_typo():
    findings = run(
        """
        def trace(tracer, ref):
            tracer.record_span("recieve", ref, 0.0)
            tracer.begin_span("comit", ref)
        """,
        span_stages=_SPAN_STAGES,
    )
    assert rules_of(findings) == ["span-names"]
    assert len(findings) == 2
    assert "recieve" in findings[0].message


def test_span_names_negative():
    findings = run(
        """
        def trace(tracer, ref, stage):
            tracer.record_span("receive", ref, 0.0)
            tracer.begin_span("verify", ref)
            tracer.end_span("commit", ref)
            tracer.end_span(stage, ref)      # computed stage: skipped
            writer.flush("recieve")          # not a span call
        """,
        span_stages=_SPAN_STAGES,
    )
    assert findings == []


def test_span_names_skipped_without_registry():
    findings = run(
        """
        def trace(tracer, ref):
            tracer.record_span("anything-goes", ref, 0.0)
        """
    )
    assert findings == []


def test_span_registry_parsed_from_spans_py():
    """analyze_paths picks the registry up from the real spans.py; it must
    stay a literal tuple so the parse keeps working."""
    import ast

    from mysticeti_tpu_torch.analysis.checker import collect_span_stages
    from mysticeti_tpu_torch.spans import STAGES

    with open(os.path.join(PKG, "spans.py")) as fh:
        parsed = collect_span_stages(ast.parse(fh.read()))
    assert parsed == STAGES


# -- rule 8: metrics-doc ------------------------------------------------------

_METRICS_SRC = """
import ast
from prometheus_client import Counter


class M:
    def __init__(self, r):
        def counter(name, doc, labels=()):
            return Counter(name, doc, labelnames=labels, registry=r)

        self.committed = counter("committed_leaders_total", "x")
        self.health = counter(
            "mysticeti_health_commit_rate", "x", labels=("authority",)
        )
"""


def _doc_findings(doc_text):
    import ast as _ast
    import textwrap as _tw

    from mysticeti_tpu_torch.analysis import check_metrics_doc, collect_metric_names

    names = collect_metric_names(_ast.parse(_tw.dedent(_METRICS_SRC)))
    return check_metrics_doc(
        names, "mysticeti_tpu_torch/metrics.py", _tw.dedent(doc_text),
        "mysticeti_tpu_torch/docs/observability.md",
    )


def test_metrics_doc_clean_when_inventory_matches():
    findings = _doc_findings(
        """
        | `committed_leaders_total` | counter | decided leaders |
        | `mysticeti_health_commit_rate` | gauge | commits/s |
        The `mysticeti_health_*` family is sampled by the probe.
        """
    )
    assert findings == []  # wildcard families never count as series


def test_metrics_doc_flags_registered_but_undocumented():
    findings = _doc_findings(
        "| `mysticeti_health_commit_rate` | gauge | commits/s |\n"
    )
    assert [f.rule for f in findings] == ["metrics-doc"]
    assert "committed_leaders_total" in findings[0].message
    assert findings[0].path == "mysticeti_tpu_torch/metrics.py"
    assert findings[0].line > 0  # anchored at the registration line


def test_metrics_doc_flags_documented_but_unregistered():
    findings = _doc_findings(
        """
        | `committed_leaders_total` | counter | decided leaders |
        | `mysticeti_health_commit_rate` | gauge | commits/s |
        | `mysticeti_health_ghost_series` | gauge | renamed away |
        """
    )
    assert [f.rule for f in findings] == ["metrics-doc"]
    assert "mysticeti_health_ghost_series" in findings[0].message
    assert findings[0].path == "mysticeti_tpu_torch/docs/observability.md"


def test_metrics_doc_token_match_is_word_bounded():
    # `latency_s` must not ride on `latency_squared_s`-style substrings.
    import ast as _ast

    from mysticeti_tpu_torch.analysis import check_metrics_doc, collect_metric_names

    names = collect_metric_names(
        _ast.parse("self.latency_s = counter('latency_s', 'x')")
    )
    findings = check_metrics_doc(
        names, "m.py", "only `latency_s_total_squared_x` here", "d.md"
    )
    assert len(findings) == 1 and "latency_s" in findings[0].message


def test_metrics_doc_repo_gate_inventory_is_complete():
    """The committed tree's inventory: every series registered in the port's
    metrics.py documented in the port's own inventory
    (``mysticeti_tpu_torch/docs/observability.md``), every documented
    mysticeti_* series registered (baseline stays empty, so this is the
    live drift gate)."""
    import ast as _ast

    from mysticeti_tpu_torch.analysis import check_metrics_doc, collect_metric_names

    with open(os.path.join(PKG, "metrics.py")) as fh:
        names = collect_metric_names(_ast.parse(fh.read()))
    assert len(names) > 40  # the real registry, not a parse miss
    with open(os.path.join(PKG, "docs", "observability.md")) as fh:
        doc = fh.read()
    findings = check_metrics_doc(
        names, "mysticeti_tpu_torch/metrics.py", doc,
        "mysticeti_tpu_torch/docs/observability.md",
    )
    assert findings == [], "\n".join(f.render() for f in findings)


# -- rule 9: sim-taint --------------------------------------------------------

# The wal_backlog regression shape: a real drain-thread's progress census flows
# through a module-wide dict key into another class's admission branch.
_WAL_BACKLOG_FIXTURE = """
    class HealthProbe:
        def __init__(self, core):
            self.core = core

        def sample(self):
            signals = {}
            signals["wal_backlog"] = bool(self.core.wal_writer.pending())
            return signals


    class AdmissionController:
        def admit(self, signals):
            if signals.get("wal_backlog"):
                return False
            return True
"""

# The dispatch-EMA regression shape: a wall-clock dispatch measurement folds into a
# field EMA, returns through a helper method, and arms a virtual-time timer.
_DISPATCH_EMA_FIXTURE = """
    import time


    class BatchedVerifier:
        def __init__(self, loop):
            self.loop = loop
            self._dispatch_ema_s = 0.001

        def _observe_dispatch(self, started):
            wall = time.monotonic() - started
            self._dispatch_ema_s = 0.9 * self._dispatch_ema_s + 0.1 * wall

        def _effective_delay_s(self):
            return min(0.05, self._dispatch_ema_s * 4.0)

        def _arm_flush(self):
            self.loop.call_later(self._effective_delay_s(), self._flush)

        def _flush(self):
            pass
"""


def test_sim_taint_catches_pr11_wal_backlog_shape():
    findings = run(_WAL_BACKLOG_FIXTURE)
    assert "sim-taint" in rules_of(findings)
    messages = " ".join(f.message for f in findings)
    assert "thread-progress" in messages
    assert "branch decision" in messages


def test_sim_taint_catches_pr12_dispatch_ema_shape():
    findings = run(_DISPATCH_EMA_FIXTURE)
    assert "sim-taint" in rules_of(findings)
    messages = " ".join(f.message for f in findings)
    assert "wall-clock" in messages
    assert "timer delay" in messages


def test_sim_taint_unseeded_random_into_timer():
    findings = run(
        """
        import asyncio
        import random

        async def retry_pause():
            await asyncio.sleep(random.uniform(0.05, 0.1))
        """
    )
    assert rules_of(findings) == ["sim-taint"]
    assert "unseeded-random" in findings[0].message


def test_sim_taint_negative_gated_and_seeded():
    findings = run(
        """
        import time

        from .runtime import is_simulated, now as runtime_now


        class Calibrator:
            def __init__(self, rng):
                self._rng = rng
                self._cpu_probe = 0.0

            def calibrate(self):
                if not is_simulated():
                    started = time.monotonic()
                    self._cpu_probe = time.monotonic() - started
                if self._cpu_probe > 0.5:
                    return "slow"
                return "fast"

            async def jittered_pause(self, loop):
                # seeded instance RNG: a different dotted head than the
                # module-global random.*
                await __import__("asyncio").sleep(self._rng.uniform(0.01, 0.02))

            def stamp(self):
                return runtime_now()
        """
    )
    assert findings == []


def test_sim_taint_suppression_at_source_silences_all_sinks():
    # One ignore at the nondeterministic READ covers every downstream sink
    # finding (suppression-at-cause, not per-sink).  The unsuppressed twin
    # fires sim-taint (checked above), so an empty sim-taint set here means
    # the single source-line comment silenced them all — and was counted as
    # used (no unused-suppression finding either).
    src = _DISPATCH_EMA_FIXTURE.replace(
        "wall = time.monotonic() - started",
        "wall = time.monotonic() - started  # lint: ignore[sim-taint]",
    )
    rules = rules_of(run(src))
    assert "sim-taint" not in rules
    assert "unused-suppression" not in rules


# -- rule 10: await-atomicity -------------------------------------------------

def test_await_atomicity_positive_rmw_spans_await():
    findings = run(
        """
        class Window:
            async def refill(self):
                budget = self.budget
                await self._fetch()
                self.budget = budget + 1
        """
    )
    assert rules_of(findings) == ["await-atomicity"]
    assert "budget" in findings[0].message


def test_await_atomicity_positive_branch_then_write():
    findings = run(
        """
        class Dispatcher:
            async def maybe_flush(self):
                if self._pending_count >= self.batch_size:
                    batch = await self._drain()
                    self._pending_count = 0
                    return batch
        """
    )
    assert rules_of(findings) == ["await-atomicity"]


def test_await_atomicity_negative_lock_held_across_suspension():
    findings = run(
        """
        import asyncio

        class Window:
            def __init__(self):
                self._lock = asyncio.Lock()

            async def refill(self):
                async with self._lock:
                    budget = self.budget
                    await self._fetch()
                    self.budget = budget + 1
        """
    )
    assert findings == []


def test_await_atomicity_negative_augassign_counter_pair():
    # Each += / -= is its own atomic RMW (no read parked across the await).
    findings = run(
        """
        class Gateway:
            async def _handle(self, conn):
                self.connections += 1
                try:
                    await self._serve(conn)
                finally:
                    self.connections -= 1
        """
    )
    assert findings == []


def test_await_atomicity_negative_while_retest_semaphore():
    # The while condition re-evaluates AFTER the body's await: the read the
    # write pairs with is post-suspension, not parked across it.
    findings = run(
        """
        class Pipeline:
            async def _acquire(self):
                while self._inflight >= self.depth:
                    await self._drained.wait()
                self._inflight += 1
        """
    )
    assert findings == []


def test_await_atomicity_single_owner_annotation():
    src = """
        # lint: single-owner[core_task]
        class CoreState:
            async def advance(self):
                round_ = self.round
                await self._persist()
                self.round = round_ + 1
    """
    assert run(src) == []
    # Without the annotation the same shape fires.
    stripped = src.replace("# lint: single-owner[core_task]", "pass")
    assert rules_of(run(stripped)) == ["await-atomicity"]


# -- rules 11+12: lock-order + guard-inference --------------------------------

def test_lock_order_cycle_detected_across_methods():
    import ast as _ast

    from mysticeti_tpu_torch.analysis.checker import _collect_aliases
    from mysticeti_tpu_torch.analysis.lockgraph import (
        collect_module_locks,
        find_lock_cycles,
        lock_order_messages,
    )

    src = textwrap.dedent(
        """
        import threading

        class Pair:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    with self._a:
                        pass
        """
    )
    tree = _ast.parse(src)
    module = collect_module_locks(
        tree, _collect_aliases(tree), "mysticeti_tpu_torch/example.py", src
    )
    cycles = find_lock_cycles(module.edges)
    assert cycles, "inverted acquisition order must form a cycle"
    messages = lock_order_messages(cycles)
    assert any("Pair._a" in m and "Pair._b" in m for _, _, m in messages)


def test_lock_order_consistent_nesting_is_clean():
    import ast as _ast

    from mysticeti_tpu_torch.analysis.checker import _collect_aliases
    from mysticeti_tpu_torch.analysis.lockgraph import (
        collect_module_locks,
        find_lock_cycles,
    )

    src = textwrap.dedent(
        """
        import threading

        class Pair:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._a:
                    with self._b:
                        pass
        """
    )
    tree = _ast.parse(src)
    module = collect_module_locks(
        tree, _collect_aliases(tree), "mysticeti_tpu_torch/example.py", src
    )
    assert find_lock_cycles(module.edges) == []


def test_guard_inference_flags_stray_unguarded_write():
    findings = run(
        """
        import threading

        class Census:
            def __init__(self):
                self._lock = threading.Lock()
                self.tally = 0

            def bump(self):
                with self._lock:
                    self.tally += 1

            def bump2(self):
                with self._lock:
                    self.tally += 2

            def reset(self):
                self.tally = 0
        """
    )
    assert "guard-inference" in rules_of(findings)
    assert any("tally" in f.message for f in findings)


def test_guard_inference_negative_all_writes_guarded():
    findings = run(
        """
        import threading

        class Census:
            def __init__(self):
                self._lock = threading.Lock()
                self.tally = 0

            def bump(self):
                with self._lock:
                    self.tally += 1

            def reset(self):
                with self._lock:
                    self.tally = 0
        """
    )
    assert findings == []


def test_guard_inference_holds_annotation_covers_callee():
    src = """
        import threading

        class Flusher:
            def __init__(self):
                self._lock = threading.Lock()
                self.dirty = 0

            def mark(self):
                with self._lock:
                    self.dirty += 1

            def mark2(self):
                with self._lock:
                    self.dirty += 2

            def _drain(self):  # lint: holds[_lock]
                self.dirty = 0
    """
    assert run(src) == []
    stripped = src.replace("  # lint: holds[_lock]", "")
    assert "guard-inference" in rules_of(run(stripped))


# -- suppressions and baseline ------------------------------------------------

def test_inline_suppression_matches_rule():
    src = """
        import time

        async def handler():
            time.sleep(0.1)  # lint: ignore[async-blocking]
    """
    assert run(src) == []
    # A suppression naming a DIFFERENT rule does not silence the finding —
    # and the mismatched comment is itself flagged as unused.
    wrong = src.replace("async-blocking", "wall-clock")
    assert rules_of(run(wrong)) == ["async-blocking", "unused-suppression"]


def test_unused_suppression_flagged_and_module_directive_exempt():
    findings = run(
        """
        import asyncio

        async def fine():
            await asyncio.sleep(0.1)  # lint: ignore[async-blocking]
        """
    )
    assert rules_of(findings) == ["unused-suppression"]
    assert "async-blocking" in findings[0].message
    # Module-wide directives document a file-level policy; they are exempt
    # from staleness (their whole point is covering future code too).
    assert run(
        """
        # lint: ignore-module[sim-taint]
        import asyncio

        async def fine():
            await asyncio.sleep(0.1)
        """
    ) == []


def test_suppression_text_inside_strings_is_not_a_directive():
    # Only real COMMENT tokens count: a docstring or f-string mentioning the
    # ignore syntax must neither suppress nor count as unused.
    findings = run(
        '''
        def helper():
            """Write `# lint: ignore[async-blocking]` at the call site."""
            return "# lint: ignore[wall-clock]"
        '''
    )
    assert findings == []


def test_baseline_tolerates_exactly_the_recorded_count(tmp_path):
    src = """
        import time

        async def handler():
            time.sleep(0.1)
    """
    found = run(src)
    path = str(tmp_path / "baseline.json")
    write_baseline(path, found)
    baseline = load_baseline(path)
    assert new_findings(found, baseline) == []
    # A second identical violation exceeds the baselined count.
    doubled = run(
        src
        + """
        async def handler2():
            time.sleep(0.2)
    """
    )
    assert len(new_findings(doubled, baseline)) == 1


# -- the repo gate (tier-1) ---------------------------------------------------

def test_package_has_zero_nonbaselined_findings():
    findings = analyze_paths([PKG], root=REPO)
    fresh = new_findings(findings, load_baseline(BASELINE))
    assert fresh == [], "\n".join(f.render() for f in fresh)


def test_cli_gate_exits_zero():
    """The CI registration: `python -m mysticeti_tpu_torch.analysis` must gate at
    zero new findings on the committed tree."""
    proc = subprocess.run(
        [sys.executable, "-m", "mysticeti_tpu_torch.analysis"],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_json_and_rule_listing():
    proc = subprocess.run(
        [sys.executable, "-m", "mysticeti_tpu_torch.analysis", "--list-rules"],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0
    assert set(proc.stdout.split()) == set(RULES)
    proc = subprocess.run(
        [sys.executable, "-m", "mysticeti_tpu_torch.analysis", "--json"],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0
    assert json.loads(proc.stdout) == []


def test_lint_tool_alias():
    proc = subprocess.run(
        [sys.executable, "-m", "mysticeti_tpu_torch.tools.lint", "--list-rules"],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0
    assert set(proc.stdout.split()) == set(RULES)


# -- CI/editor integration: sarif, changed, cache, parallel -------------------

def test_cli_sarif_format(tmp_path):
    src = textwrap.dedent(
        """
        import time

        async def handler():
            time.sleep(0.1)
        """
    )
    target = tmp_path / "fixture.py"
    target.write_text(src)
    proc = subprocess.run(
        [
            sys.executable, "-m", "mysticeti_tpu_torch.analysis",
            "--no-baseline", "--no-cache", "--format", "sarif", str(target),
        ],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 1  # findings present
    doc = json.loads(proc.stdout)
    assert doc["version"] == "2.1.0"
    run_ = doc["runs"][0]
    assert run_["tool"]["driver"]["name"] == "mysticeti-lint"
    assert {r["id"] for r in run_["tool"]["driver"]["rules"]} == set(RULES)
    (result,) = run_["results"]
    assert result["ruleId"] == "async-blocking"
    region = result["locations"][0]["physicalLocation"]["region"]
    assert region["startLine"] > 1


def test_cli_changed_mode_exits_zero_on_clean_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "mysticeti_tpu_torch.analysis", "--changed"],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=180,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_analyze_paths_cache_roundtrip_and_parallel(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    for i in range(6):
        (pkg / f"mod{i}.py").write_text(textwrap.dedent(
            f"""
            import time

            async def handler{i}():
                time.sleep(0.{i + 1})
            """
        ))
    root = str(tmp_path)
    first = analyze_paths([str(pkg)], root=root, jobs=2)
    assert len(first) == 6
    cache_file = tmp_path / ".lint-cache-torch.json"
    assert cache_file.exists()
    # Warm pass: identical results straight from the cache.
    second = analyze_paths([str(pkg)], root=root, jobs=2)
    assert [f.fingerprint() for f in second] == [
        f.fingerprint() for f in first
    ]
    # Editing one file invalidates exactly its entry.
    (pkg / "mod0.py").write_text("x = 1\n")
    third = analyze_paths([str(pkg)], root=root)
    assert len(third) == 5
    # And disabling the cache still produces the same verdict.
    assert len(analyze_paths([str(pkg)], root=root, use_cache=False)) == 5


# -- rule 14: native-fallback -------------------------------------------------


def test_native_fallback_positive_unguarded_call():
    findings = run(
        """
        from .native import native

        def scan(buf):
            return native.wal_scan(buf)
        """
    )
    assert rules_of(findings) == ["native-fallback"]
    assert "wal_scan" in findings[0].message


def test_native_fallback_positive_aliased_import():
    findings = run(
        """
        from mysticeti_tpu_torch.native import native as _native

        def scan(buf):
            return _native.frame_entry(buf)
        """
    )
    assert rules_of(findings) == ["native-fallback"]


def test_native_fallback_negative_is_not_none_gate():
    findings = run(
        """
        from .native import native

        def scan(buf):
            if native is not None:
                return native.wal_scan(buf)
            return pure_scan(buf)
        """
    )
    assert findings == []


def test_native_fallback_negative_else_of_none_gate():
    findings = run(
        """
        from .native import native as _native

        def scan(buf):
            if _native is None:
                return pure_scan(buf)
            else:
                return _native.wal_scan(buf)
        """
    )
    assert findings == []


def test_native_fallback_negative_early_return_promotion():
    findings = run(
        """
        from .native import native

        def scan(buf):
            if native is None:
                return pure_scan(buf)
            return native.wal_scan(buf)
        """
    )
    assert findings == []


def test_native_fallback_negative_hasattr_and_conjunction_gates():
    findings = run(
        """
        from .native import native as _native

        def scan(buf, end):
            if _native is not None and end > 0:
                return _native.wal_scan(buf, end)
            if hasattr(_native, "frame_entry"):
                return _native.frame_entry(buf)
            return pure_scan(buf)
        """
    )
    assert findings == []


def test_native_fallback_positive_wrong_polarity_branch():
    # The call sits in the None branch: exactly the crash the rule exists for.
    findings = run(
        """
        from .native import native

        def scan(buf):
            if native is None:
                return native.wal_scan(buf)
            return pure_scan(buf)
        """
    )
    assert rules_of(findings) == ["native-fallback"]


def test_native_fallback_inline_suppression():
    findings = run(
        """
        from .native import native

        def scan(buf):
            return native.wal_scan(buf)  # lint: ignore[native-fallback]
        """
    )
    assert findings == []


# -- parity with the JAX package's lint ----------------------------------------

REFERENCE_SUITE = os.path.join(REPO, "tests", "test_static_analysis.py")


def _reference_fixtures():
    """Every fixture source of the reference suite: each multi-line string
    literal of ``tests/test_static_analysis.py`` that parses as a module
    once dedented (the metrics and doc texts do not, or carry no rule)."""
    import ast

    with open(REFERENCE_SUITE) as fh:
        tree = ast.parse(fh.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            src = textwrap.dedent(node.value)
            if "\n" not in src.strip("\n"):
                continue
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out.append((node.lineno, src))
    return sorted(out)


FIXTURES = _reference_fixtures()
_LABELS = {"verified_signatures_total": ("backend", "outcome")}


def _mapped(findings, package):
    return [
        (f.rule, f.path.replace(package, "<pkg>"), f.line, f.col,
         f.message.replace(package, "<pkg>"), f.also_lines)
        for f in findings
    ]


def test_reference_suite_fixtures_found():
    # The walk must see the suite's fixtures, not a parse miss: the jit
    # fixture, the historical leak shapes and the native-fallback shapes.
    assert len(FIXTURES) >= 40, len(FIXTURES)
    assert any("jax.debug.print" in src for _, src in FIXTURES)
    assert any("wal_backlog" in src for _, src in FIXTURES)
    assert any("wal_scan" in src for _, src in FIXTURES)


@pytest.mark.parametrize("line,src", FIXTURES, ids=[f"line{n}" for n, _ in FIXTURES])
def test_fixture_findings_equal_the_jax_lints(line, src):
    """Rule, line, column and message (with the package name mapped) are
    the JAX checker's, at a plain and a kernel-directory path, with and
    without the metrics-label and span-stage registries."""
    from mysticeti_tpu.analysis import analyze_source as jax_analyze

    for sub in ("example.py", "ops/fake_kernel.py"):
        for kw in ({}, {"metric_labels": _LABELS, "span_stages": ("receive", "verify", "commit")}):
            port = analyze_source(src, f"mysticeti_tpu_torch/{sub}", **kw)
            ref = jax_analyze(src, f"mysticeti_tpu/{sub}", **kw)
            assert _mapped(port, "mysticeti_tpu_torch") == _mapped(ref, "mysticeti_tpu"), (
                sub, kw)


def test_both_checkers_find_nothing_in_the_jax_package():
    from mysticeti_tpu.analysis import analyze_paths as jax_analyze_paths

    jax_pkg = os.path.join(REPO, "mysticeti_tpu")
    port = analyze_paths([jax_pkg], root=REPO, use_cache=False)
    ref = jax_analyze_paths([jax_pkg], root=REPO, use_cache=False)
    assert port == [] and ref == [], [f.render() for f in port + ref]


def test_detsan_tool_fixtures_are_the_reference_suites():
    """The detsan tool's static fixtures are the reference suite's
    historical leak shapes, and the port's rule catches both."""
    from mysticeti_tpu_torch.tools import detsan as tool

    def code(src):
        return [line for line in textwrap.dedent(src).splitlines()
                if not line.strip().startswith("#")]

    assert code(tool.WAL_BACKLOG_FIXTURE) == code(_WAL_BACKLOG_FIXTURE)
    assert code(tool.DISPATCH_EMA_FIXTURE) == code(_DISPATCH_EMA_FIXTURE)
    assert tool._fixture_detected(tool.WAL_BACKLOG_FIXTURE)
    assert tool._fixture_detected(tool.DISPATCH_EMA_FIXTURE)
    assert not tool._fixture_detected("def f(x):\n    return x\n")


# -- the sim-taint catch on the state root (tests/test_execution.py:776) ------

_STATE_ROOT_LEAK = """
    import hashlib
    import struct
    import time


    class LeakyExecution:
        def __init__(self):
            self.root = b"\\x00" * 32

        def observe_commit(self, height, deltas):
            stamp = time.monotonic()
            material = self.root + struct.pack("<d", stamp)
            self.root = hashlib.blake2b(
                material, digest_size=32
            ).digest()
            return self.root
"""


def test_sim_taint_catches_wallclock_flow_into_state_root():
    """The exact regression the execution plane must never grow: a
    wall-clock read folded into the state-root digest.  The sim-taint lint
    flags the flow statically — before any sim has to diverge — and gives
    the JAX checker's findings."""
    from mysticeti_tpu.analysis import analyze_source as jax_analyze

    findings = run(_STATE_ROOT_LEAK)
    assert "sim-taint" in rules_of(findings)
    messages = " ".join(f.message for f in findings)
    assert "wall-clock" in messages
    assert "canonical digest" in messages
    ref = jax_analyze(textwrap.dedent(_STATE_ROOT_LEAK), "mysticeti_tpu/example.py")
    assert _mapped(findings, "mysticeti_tpu_torch") == _mapped(ref, "mysticeti_tpu")
