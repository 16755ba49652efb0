"""Determinism sanitizer driver: run-twice chaos sim + leak bisection.

The port's copy of the JAX package's ``tools/detsan.py``.  The dynamic
half of the determinism plane (the static half is the port's lint,
``python -m mysticeti_tpu_torch.analysis``, and its ``sim-taint`` rule).
One invocation exercises every layer and can write the ``DETSAN_rNN.json``
artifact:

1. **clean** — the seeded N-node chaos sim runs twice under a
   :class:`~mysticeti_tpu_torch.detsan.DetsanRecorder`; the per-event
   digest chains must match exactly (``identical: true``).
2. **planted** — the same sim with a deliberately wall-clock-derived
   timer cadence injected via the chaos ``extra_fault`` seam; the
   bisector must report ``identical: false`` and name the first
   diverging event.
3. **fixtures** — the two historical leak shapes (the ``wal_backlog``
   thread-progress admission signal, and the wall-clock dispatch EMA
   arming a virtual flush timer) are re-checked against the port's
   *static* ``sim-taint`` rule, proving the lint still catches both.
4. **tripwire** — the strict-mode wall-clock tripwire is self-tested:
   counting mode must attribute a read to its call-site (and tick
   ``mysticeti_detsan_wallclock_reads_total``); strict mode must raise
   :class:`~mysticeti_tpu_torch.detsan.WallClockLeak`.

Usage:
    python -m mysticeti_tpu_torch.tools.detsan
    python -m mysticeti_tpu_torch.tools.detsan --out DETSAN.json
    python -m mysticeti_tpu_torch.tools.detsan --nodes 10 --duration 3 --seed 42
    python -m mysticeti_tpu_torch.tools.detsan --append-trend   # fold into build/BENCH_TREND.json

``--append-trend`` folds the artifact (``--out``, else
``build/DETSAN.json``) into the port's trend index, each record with the
card's name and power limit (skipped where there is no card).

Exit code 0 when every section passes, 1 otherwise.
"""
from __future__ import annotations

import argparse
import ast
import asyncio
import os
import sys
import tempfile
import textwrap
import time

from mysticeti_tpu_torch import detsan
from mysticeti_tpu_torch.analysis import checker, detflow
from mysticeti_tpu_torch.chaos import FaultPlan, run_chaos_sim
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.runtime.simulated import run_simulation
from mysticeti_tpu_torch.tools import build_path, write_json

# The artifact ``--append-trend`` folds in when no ``--out`` is given.
DEFAULT_TREND_ARTIFACT = build_path("DETSAN.json")


# ---------------------------------------------------------------------------
# Historical-leak fixtures (mirrored in tests/test_static_analysis.py): the
# exact dataflow shapes that once shipped before being reverted.

WAL_BACKLOG_FIXTURE = textwrap.dedent(
    """
    class HealthProbe:
        def __init__(self, core):
            self.core = core

        def sample(self):
            signals = {}
            # real drain-thread progress observed into a sim-visible signal
            signals["wal_backlog"] = bool(self.core.wal_writer.pending())
            return signals


    class AdmissionController:
        def admit(self, signals):
            if signals.get("wal_backlog"):
                return False
            return True
    """
)

DISPATCH_EMA_FIXTURE = textwrap.dedent(
    """
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
)


def _fixture_detected(source: str) -> bool:
    tree = ast.parse(source)
    aliases = checker._collect_aliases(tree)
    return bool(detflow.check_sim_taint(tree, aliases))


# ---------------------------------------------------------------------------
# The planted leak: host-clock-derived virtual timer cadence, injected
# through the chaos extra_fault seam so the sim itself stays untouched.


async def _planted_leak(harness):
    # The exact bug class detsan exists for: a timer delay derived from the
    # HOST clock inside a virtual-time run.  Two same-seed runs draw
    # different jitter, so their event schedules fork.
    while True:
        jitter = (time.perf_counter_ns() % 997) / 1e5
        await asyncio.sleep(0.05 + jitter)  # lint: ignore[sim-taint] — the planted leak


def _run_recorded(nodes, duration_s, seed, cap, extra_fault=None):
    recorder = detsan.DetsanRecorder(cap)
    with tempfile.TemporaryDirectory(prefix="detsan-wal-") as wal_dir:
        run_chaos_sim(
            FaultPlan(seed=seed),
            nodes,
            duration_s,
            wal_dir,
            extra_fault=extra_fault,
            detsan=recorder,
        )
    return recorder


def _run_twice(nodes, duration_s, seed, cap, extra_fault=None):
    a = _run_recorded(nodes, duration_s, seed, cap, extra_fault)
    b = _run_recorded(nodes, duration_s, seed, cap, extra_fault)
    return detsan.find_divergence(a, b)


# ---------------------------------------------------------------------------
# Tripwire self-test: a synthetic 'package module' reads the wall clock
# under simulation; counting mode must attribute it, strict mode must raise.

_TRIPWIRE_PROBE = textwrap.dedent(
    """
    import time


    def read_clock():
        return time.monotonic()
    """
)


def _tripwire_selftest() -> dict:
    namespace = {"__name__": "mysticeti_tpu_torch._detsan_probe"}
    exec(compile(_TRIPWIRE_PROBE, "<detsan-probe>", "exec"), namespace)
    read_clock = namespace["read_clock"]

    async def main():
        return read_clock()

    metrics = Metrics()
    counting = detsan.Tripwire(metrics=metrics, strict=False)
    with counting:
        run_simulation(main())

    raised = False
    try:
        with detsan.Tripwire(strict=True):
            run_simulation(main())
    except detsan.WallClockLeak:
        raised = True

    return {
        "counted_reads": counting.total_reads,
        "sites": dict(counting.reads),
        "strict_mode_raised": raised,
        "metric": "mysticeti_detsan_wallclock_reads_total",
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=10)
    parser.add_argument("--duration", type=float, default=3.0,
                        help="virtual seconds per run")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--cap", type=int, default=detsan.DEFAULT_TRACE_CAP,
                        help="max stored trace events per run")
    parser.add_argument("--out", default=None,
                        help="write the DETSAN artifact JSON here")
    parser.add_argument("--append-trend", action="store_true",
                        help="fold the artifact into the trend index "
                        "(build/BENCH_TREND.json)")
    args = parser.parse_args(argv)

    print(f"detsan: clean run-twice ({args.nodes} nodes, "
          f"{args.duration}s virtual, seed {args.seed}) ...")
    clean = _run_twice(args.nodes, args.duration, args.seed, args.cap)
    print(f"  identical={clean.identical} events={clean.events_a}")

    print("detsan: planted wall-clock leak run-twice ...")
    planted = _run_twice(
        args.nodes, args.duration, args.seed, args.cap,
        extra_fault=_planted_leak,
    )
    print(f"  identical={planted.identical} "
          f"first_divergence={planted.first_divergence}")

    fixtures = {
        "pr11_wal_backlog": _fixture_detected(WAL_BACKLOG_FIXTURE),
        "pr12_dispatch_ema": _fixture_detected(DISPATCH_EMA_FIXTURE),
    }
    print(f"detsan: static fixtures detected: {fixtures}")

    tripwire = _tripwire_selftest()
    print(f"detsan: tripwire counted={tripwire['counted_reads']} "
          f"strict_raised={tripwire['strict_mode_raised']}")

    passed = (
        clean.identical
        and not planted.identical
        and planted.first_divergence is not None
        and all(fixtures.values())
        and tripwire["counted_reads"] > 0
        and tripwire["strict_mode_raised"]
    )

    artifact = {
        "metric": "detsan",
        "nodes": args.nodes,
        "duration_s": args.duration,
        "seed": args.seed,
        "trace_cap": args.cap,
        "clean": clean.to_dict(),
        "planted": planted.to_dict(),
        "fixtures": fixtures,
        "tripwire": tripwire,
        "passed": passed,
    }

    out = args.out or (DEFAULT_TREND_ARTIFACT if args.append_trend else None)
    if out:
        write_json(os.path.abspath(out), artifact, indent=2)
        print(f"detsan: artifact -> {out}")

    if args.append_trend:
        from mysticeti_tpu_torch.tools.bench_trend import append_artifact

        print(f"detsan: trend index: {append_artifact(os.path.abspath(out))} new record(s)")

    print(f"detsan: {'PASS' if passed else 'FAIL'}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
