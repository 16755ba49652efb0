"""mysticeti-lint: AST-based invariant checker for this codebase's failure modes.

The port's copy of ``mysticeti_tpu.analysis``: the same fourteen rules with
the same configuration, so one fixture gives the same findings under both
checkers.  It lints ``mysticeti_tpu_torch/`` (the whole package, its
``tools/`` and ``bench.py`` included), reads the port's own series inventory
(``mysticeti_tpu_torch/docs/observability.md``) for ``metrics-doc``, and
keeps its per-file cache in ``.lint-cache-torch.json``.  ``jit-purity``
stays as the JAX package has it: the port has no ``jax.jit`` and no
``pallas_call``, so on the port's tree it finds nothing.

The hardest correctness rules in this repository were, until this package,
encoded only in comments — "the backend label must be captured in the same
thread as the dispatch" (block_validator.py), "EMA read-modify-writes happen
from executor threads; serialize them", "the device dispatch runs in a worker
thread so the event loop never blocks".  This package mechanizes them as
stdlib-``ast`` rules, runnable as ``python -m mysticeti_tpu_torch.analysis``:

* ``async-blocking``   — blocking call (``time.sleep``, sync subprocess/socket
  I/O, a direct ``verify_signatures`` dispatch) inside an ``async def`` body
  without ``run_in_executor``.
* ``task-orphan``      — ``asyncio.ensure_future``/``create_task`` whose handle
  is never awaited and never given an exception-logging done-callback (the
  swallowed-exception pattern); ``utils.tasks.spawn_logged`` is the compliant
  spawner.
* ``lock-discipline``  — ``await`` inside a ``threading.Lock`` ``with`` block
  (deadlocks the event loop), and designated shared EMA/counter fields mutated
  outside their designated lock.
* ``jit-purity``       — host-side impurities (``.item()``, ``np.*`` calls,
  ``print``, ``jax.debug.print``, wall-clock reads) inside ``@jax.jit``-
  compiled or pallas kernel functions under ``ops/`` and ``parallel/``.
* ``wall-clock``       — ``time.time()`` used to measure an interval where
  ``time.monotonic()`` is required (wall clock steps under NTP).
* ``metrics-labels``   — every ``.labels(...)`` call site must match the
  arity/names declared for that series in ``metrics.py``.
* ``span-names``       — every literal stage passed to the span-tracer call
  surface (``span``/``begin_span``/``end_span``/``record_span``/
  ``record_interval``) must come from the central registry ``spans.STAGES``
  or the port's own ``spans.PORT_STAGES`` (a typo'd stage silently never
  matches its begin/end and vanishes from traces).
* ``metrics-doc``      — every series registered in ``metrics.py`` must appear
  in the package's ``docs/observability.md`` (the series inventory of
  record), and every
  ``mysticeti_*`` series the doc names must be registered — the inventory
  cannot drift from the doc in either direction.

Exit status: 0 = no new findings, 1 = new findings (or bad usage: 2).
Deliberate exceptions carry an inline ``# lint: ignore[rule]`` suppression;
legacy debt lives in ``analysis/baseline.json`` (regenerate with
``python -m mysticeti_tpu_torch.analysis --baseline-regen`` or
``python -m mysticeti_tpu_torch.tools.lint --baseline-regen``).  The rule
catalog is the JAX package's ``docs/static-analysis.md``.
"""
from .checker import (
    Finding,
    RULES,
    analyze_file,
    analyze_paths,
    analyze_source,
    check_metrics_doc,
    collect_metric_names,
    load_baseline,
    new_findings,
    write_baseline,
)
from .cli import main

__all__ = [
    "Finding",
    "RULES",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "check_metrics_doc",
    "collect_metric_names",
    "load_baseline",
    "main",
    "new_findings",
    "write_baseline",
]
