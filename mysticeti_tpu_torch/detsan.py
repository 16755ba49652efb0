"""Run-twice determinism sanitizer: the dynamic twin of the ``sim-taint`` lint.

The port's copy of ``mysticeti_tpu.detsan``.  The static rule (the JAX
package's ``analysis.detflow``) proves the *absence* of known nondeterminism
patterns; this module catches the leaks the lint cannot see — C extensions,
dict-iteration drift, an unannotated thread — by executing the same seeded
simulation twice and comparing per-event digests of the scheduler's
behavior:

* :class:`DetsanRecorder` hooks the :class:`DeterministicLoop` callback
  plumbing (``run_simulation(..., detsan=recorder)``) and chains a digest
  over every executed event: ``(event index, virtual time, callback label,
  ready/timer queue depths)``.  The trace is bounded (``cap`` events kept;
  counting and chaining continue past it), so a multi-million-event sim
  costs one hash per event and a fixed amount of memory.

* :func:`find_divergence` compares two recordings.  Because digests are
  *chained*, "runs agree through event i" is monotone in ``i`` — one bit
  flips and stays flipped — so a binary search over the stored prefix
  pinpoints the **first diverging event** in O(log n) digest comparisons,
  naming the callback and virtual time on both sides.

* :class:`Tripwire` is the runtime counterpart of the lint's gate
  discipline: while installed, ``time.monotonic()/time()/perf_counter()``
  (and their ``_ns`` variants) reads from package code **under
  simulation** are counted on ``mysticeti_detsan_wallclock_reads_total``
  and — when :data:`STRICT_ENV` is set (or ``strict=True``) — raise
  :class:`WallClockLeak` at the offending frame, turning a silent
  reproducibility bug into a stack trace.

``python -m mysticeti_tpu_torch.tools.detsan`` drives all three against a
seeded multi-node chaos sim (clean baseline must be byte-identical; a
planted wall-clock leak must be bisected) and emits the ``DETSAN_*.json``
trend artifact.
"""
from __future__ import annotations

import asyncio
import functools
import hashlib
import os
import sys
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

STRICT_ENV = "MYSTICETI_DETSAN_STRICT"
DEFAULT_TRACE_CAP = 262_144


class WallClockLeak(RuntimeError):
    """An un-gated wall-clock read reached package code under simulation."""


# ---------------------------------------------------------------------------
# Event recording


def _callback_label(callback) -> str:
    """Deterministic label for a scheduled callback.

    Must never embed ``id()``/``repr()`` addresses — the label feeds the
    divergence digest, so an address would make every run 'diverge' at
    event 0.  Task steps are named after the coroutine they drive, which
    is what a human needs to locate the diverging code.
    """
    while isinstance(callback, functools.partial):
        callback = callback.func
    owner = getattr(callback, "__self__", None)
    if owner is not None:
        get_coro = getattr(owner, "get_coro", None)
        if get_coro is not None:
            code = getattr(get_coro(), "cr_code", None)
            if code is not None:
                return f"task:{getattr(code, 'co_qualname', code.co_name)}"
        return f"{type(owner).__name__}.{getattr(callback, '__name__', '?')}"
    return getattr(callback, "__qualname__", type(callback).__name__)


@dataclass
class EventRecord:
    """One executed loop event; ``chain`` is the cumulative digest AFTER it."""

    index: int
    vtime: float
    label: str
    chain: str


class DetsanRecorder:
    """Bounded per-event state-digest trace of one simulated run.

    Attach via ``run_simulation(main, seed, detsan=recorder)``; the
    DeterministicLoop wraps every ``call_soon``/``call_at`` callback so
    :meth:`record` fires at *execution* time, in execution order.
    """

    def __init__(self, cap: int = DEFAULT_TRACE_CAP) -> None:
        self.cap = int(cap)
        self.events: List[EventRecord] = []
        self.count = 0
        self._hash = hashlib.sha256(b"mysticeti-detsan-v1")

    # -- hook plumbing (called by DeterministicLoop) --

    def wrap(self, loop, callback, args) -> Tuple[Callable, tuple]:
        def _traced(*call_args):
            self.record(loop, callback)
            return callback(*call_args)

        return _traced, args

    def record(self, loop, callback) -> None:
        label = _callback_label(callback)
        vtime = loop.time()
        ready = len(getattr(loop, "_ready", ()))
        timers = len(getattr(loop, "_scheduled", ()))
        self._hash.update(
            f"{self.count}|{vtime:.9f}|{label}|{ready}|{timers}".encode()
        )
        if len(self.events) < self.cap:
            self.events.append(
                EventRecord(self.count, vtime, label, self._hash.hexdigest()[:16])
            )
        self.count += 1

    @property
    def chain(self) -> str:
        return self._hash.hexdigest()


# ---------------------------------------------------------------------------
# Divergence bisection


@dataclass
class DivergenceReport:
    identical: bool
    events_a: int
    events_b: int
    chain_a: str
    chain_b: str
    first_divergence: Optional[dict] = None
    note: str = ""

    def to_dict(self) -> dict:
        out = {
            "identical": self.identical,
            "events_a": self.events_a,
            "events_b": self.events_b,
            "chain_a": self.chain_a,
            "chain_b": self.chain_b,
        }
        if self.first_divergence is not None:
            out["first_divergence"] = dict(self.first_divergence)
        if self.note:
            out["note"] = self.note
        return out


def find_divergence(a: DetsanRecorder, b: DetsanRecorder) -> DivergenceReport:
    """Compare two recordings; binary-search the first diverging event.

    Chained digests make agreement-through-event-``i`` monotone: once the
    traces differ at some event, every later chain value differs too.  So
    ``events[i].chain == other[i].chain`` is a sorted predicate and the
    first divergence is found with O(log n) comparisons over the stored
    prefix — no full-trace scan, no event re-execution.
    """
    if a.chain == b.chain and a.count == b.count:
        return DivergenceReport(True, a.count, b.count, a.chain, b.chain)

    stored = min(len(a.events), len(b.events))
    if stored and a.events[stored - 1].chain == b.events[stored - 1].chain:
        # Stored prefixes fully agree: the divergence happened past the
        # trace cap (or one run simply outlived the other).  Report the
        # boundary rather than a wrong event.
        return DivergenceReport(
            False, a.count, b.count, a.chain, b.chain,
            first_divergence=None,
            note=(
                f"divergence beyond the {stored} stored events "
                f"(raise cap to localize)"
            ),
        )

    lo, hi = 0, stored - 1  # invariant: divergence at some index <= hi
    while lo < hi:
        mid = (lo + hi) // 2
        if a.events[mid].chain == b.events[mid].chain:
            lo = mid + 1
        else:
            hi = mid
    ea, eb = a.events[lo], b.events[lo]
    return DivergenceReport(
        False, a.count, b.count, a.chain, b.chain,
        first_divergence={
            "index": lo,
            "label_a": ea.label,
            "vtime_a": round(ea.vtime, 9),
            "label_b": eb.label,
            "vtime_b": round(eb.vtime, 9),
        },
    )


def run_twice(
    main_factory: Callable[[], "asyncio.Future"],
    seed: int = 0,
    timeout_s: Optional[float] = None,
    cap: int = DEFAULT_TRACE_CAP,
) -> DivergenceReport:
    """Execute ``main_factory()`` on two fresh seeded loops and diff them.

    ``main_factory`` must build a *new* coroutine per call (a coroutine
    object is single-shot).  A deterministic program yields
    ``identical=True``; anything else names its first diverging event.
    """
    from .runtime.simulated import run_simulation

    recorders = []
    for _ in range(2):
        recorder = DetsanRecorder(cap)
        run_simulation(
            main_factory(), seed=seed, timeout_s=timeout_s, detsan=recorder
        )
        recorders.append(recorder)
    return find_divergence(recorders[0], recorders[1])


# ---------------------------------------------------------------------------
# Wall-clock tripwire


_PATCH_NAMES = (
    "monotonic", "time", "perf_counter",
    "monotonic_ns", "time_ns", "perf_counter_ns",
)
_DEFAULT_PREFIXES = ("mysticeti_tpu_torch",)
_SELF_MODULE = __name__


class Tripwire:
    """Strict-mode detector for un-gated wall-clock reads under simulation.

    While installed, the ``time`` module's clock readers are wrapped: a
    read whose *caller* is package code (``module_prefixes``) executing
    under :func:`~mysticeti_tpu_torch.runtime.is_simulated` is counted per
    call-site (and on ``metrics.mysticeti_detsan_wallclock_reads_total``
    when a metrics object is supplied); in strict mode — ``strict=True``
    or the :data:`STRICT_ENV` environment knob — it raises
    :class:`WallClockLeak` instead, so the leak surfaces as a stack trace
    at the offending line.  Reads outside simulation, and reads from
    third-party code (asyncio, prometheus, the stdlib), pass through
    untouched.  Use as a context manager; install/uninstall is reentrant-
    safe via plain attribute swap.
    """

    def __init__(
        self,
        metrics=None,
        strict: Optional[bool] = None,
        module_prefixes: Tuple[str, ...] = _DEFAULT_PREFIXES,
    ) -> None:
        self.metrics = metrics
        self.strict = (
            bool(os.environ.get(STRICT_ENV)) if strict is None else strict
        )
        self.module_prefixes = tuple(module_prefixes)
        self.reads: Dict[str, int] = {}
        self._originals: Dict[str, Callable] = {}

    @property
    def total_reads(self) -> int:
        return sum(self.reads.values())

    def _flag(self, name: str) -> None:
        # Caller frame of the wrapped time.* function (wrapper is frame 1).
        frame = sys._getframe(2)
        module = frame.f_globals.get("__name__", "")
        if module == _SELF_MODULE or module.startswith(_SELF_MODULE + "."):
            return
        if not module.startswith(self.module_prefixes):
            return
        from .runtime import is_simulated

        if not is_simulated():
            return
        site = f"{module}:{frame.f_lineno}"
        self.reads[site] = self.reads.get(site, 0) + 1
        if self.metrics is not None:
            self.metrics.mysticeti_detsan_wallclock_reads_total.labels(
                site=site
            ).inc()
        if self.strict:
            raise WallClockLeak(
                f"time.{name}() read under simulation at {site}: gate it "
                f"behind `if not is_simulated():` or use runtime.now()/"
                f"timestamp_utc() (virtual under sim)"
            )

    def _make_wrapper(self, name: str, original: Callable) -> Callable:
        tripwire = self

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            tripwire._flag(name)
            return original(*args, **kwargs)

        return wrapper

    def install(self) -> "Tripwire":
        if self._originals:
            return self
        for name in _PATCH_NAMES:
            original = getattr(_time, name, None)
            if original is None:  # pragma: no cover - platform variance
                continue
            self._originals[name] = original
            setattr(_time, name, self._make_wrapper(name, original))
        return self

    def uninstall(self) -> None:
        for name, original in self._originals.items():
            setattr(_time, name, original)
        self._originals.clear()

    def __enter__(self) -> "Tripwire":
        return self.install()

    def __exit__(self, *exc_info) -> None:
        self.uninstall()


__all__ = [
    "DEFAULT_TRACE_CAP",
    "STRICT_ENV",
    "DetsanRecorder",
    "DivergenceReport",
    "EventRecord",
    "Tripwire",
    "WallClockLeak",
    "find_divergence",
    "run_twice",
]
