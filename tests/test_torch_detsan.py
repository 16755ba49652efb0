"""The port's determinism sanitizer against the JAX package's: counterparts
of ``tests/test_detsan.py`` (recorder, bisector, tripwire, run-twice sims)
run on the port, then a parity of the event chain itself.

These prove the runtime side catches what execution shows — a clean
seeded sim is event-identical across runs, a planted wall-clock leak is
bisected to its first diverging event, and the strict-mode tripwire turns
an un-gated wall-clock read into a stack trace.
"""
import asyncio
import time

import pytest

from mysticeti_tpu_torch import detsan
from mysticeti_tpu_torch.detsan import (
    DetsanRecorder,
    Tripwire,
    WallClockLeak,
    find_divergence,
    run_twice,
)
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.runtime.simulated import run_simulation


class _FakeLoop:
    """Just enough loop surface for DetsanRecorder.record()."""

    def __init__(self):
        self.now = 0.0
        self._ready = []
        self._scheduled = []

    def time(self):
        return self.now


def _tick(recorder, loop, label, vtime):
    def callback():
        pass

    callback.__qualname__ = label
    loop.now = vtime
    recorder.record(loop, callback)


# -- the bisector over synthetic traces ---------------------------------------

def test_find_divergence_identical_traces():
    a, b = DetsanRecorder(), DetsanRecorder()
    loop_a, loop_b = _FakeLoop(), _FakeLoop()
    for i in range(32):
        _tick(a, loop_a, f"cb{i % 5}", i * 0.01)
        _tick(b, loop_b, f"cb{i % 5}", i * 0.01)
    report = find_divergence(a, b)
    assert report.identical
    assert report.events_a == report.events_b == 32
    assert report.first_divergence is None


def test_find_divergence_bisects_first_diverging_event():
    a, b = DetsanRecorder(), DetsanRecorder()
    loop_a, loop_b = _FakeLoop(), _FakeLoop()
    diverge_at = 21
    for i in range(64):
        _tick(a, loop_a, f"cb{i}", i * 0.01)
        if i == diverge_at:
            _tick(b, loop_b, "rogue_timer", i * 0.01 + 0.003)
        else:
            _tick(b, loop_b, f"cb{i}", i * 0.01)
    report = find_divergence(a, b)
    assert not report.identical
    assert report.first_divergence is not None
    assert report.first_divergence["index"] == diverge_at
    assert report.first_divergence["label_a"] == f"cb{diverge_at}"
    assert report.first_divergence["label_b"] == "rogue_timer"
    # Chained digests keep every later event diverged too; the bisector
    # must still name the FIRST one.
    assert a.events[diverge_at + 1].chain != b.events[diverge_at + 1].chain


def test_trace_cap_bounds_storage_but_not_counting():
    recorder = DetsanRecorder(cap=4)
    loop = _FakeLoop()
    for i in range(10):
        _tick(recorder, loop, "cb", i * 0.01)
    assert len(recorder.events) == 4
    assert recorder.count == 10


def test_divergence_past_cap_reports_boundary_not_wrong_event():
    a, b = DetsanRecorder(cap=4), DetsanRecorder(cap=4)
    loop_a, loop_b = _FakeLoop(), _FakeLoop()
    for i in range(8):
        _tick(a, loop_a, f"cb{i}", i * 0.01)
        # identical through the stored prefix; diverges at event 6 (> cap)
        _tick(b, loop_b, f"cb{i}" if i < 6 else "rogue", i * 0.01)
    report = find_divergence(a, b)
    assert not report.identical
    assert report.first_divergence is None
    assert "beyond" in report.note


# -- run-twice over real simulations ------------------------------------------

def _clean_main():
    async def main():
        queue = asyncio.Queue()

        async def producer():
            for i in range(16):
                await asyncio.sleep(0.01)
                await queue.put(i)

        task = asyncio.ensure_future(producer())
        total = 0
        for _ in range(16):
            total += await queue.get()
        await task
        return total

    return main()


def test_run_twice_clean_sim_is_identical():
    report = run_twice(_clean_main, seed=7)
    assert report.identical, report.to_dict()
    assert report.events_a > 0


def test_run_twice_bisects_wall_clock_leak():
    def leaky_main():
        async def main():
            for _ in range(8):
                jitter = (time.perf_counter_ns() % 997) / 1e5
                await asyncio.sleep(0.01 + jitter)

        return main()

    report = run_twice(leaky_main, seed=7)
    assert not report.identical
    assert report.first_divergence is not None
    assert report.first_divergence["index"] >= 0
    assert report.first_divergence["vtime_a"] != report.first_divergence["vtime_b"]


def test_recorder_labels_are_address_free():
    recorder = DetsanRecorder()
    run_simulation(_clean_main(), seed=3, detsan=recorder)
    assert recorder.count > 0
    for event in recorder.events:
        assert "0x" not in event.label, event.label


def test_chaos_sim_run_twice_identical():
    """The acceptance shape: a seeded multi-node chaos sim diffed event-by-
    event (``python -m mysticeti_tpu_torch.tools.detsan`` runs the 10-node
    version; 4 nodes keeps tier-1 fast)."""
    import tempfile

    from mysticeti_tpu_torch.chaos import FaultPlan, run_chaos_sim

    def once():
        recorder = DetsanRecorder()
        with tempfile.TemporaryDirectory() as wal_dir:
            run_chaos_sim(
                FaultPlan(seed=11), 4, 1.0, wal_dir, detsan=recorder
            )
        return recorder

    report = find_divergence(once(), once())
    assert report.identical, report.to_dict()
    assert report.events_a > 100


# -- the wall-clock tripwire ---------------------------------------------------

def _package_probe():
    """A clock reader whose frame claims package provenance (real leaks were
    all fixed, so the tripwire is exercised against a synthetic module)."""
    namespace = {"__name__": "mysticeti_tpu_torch._detsan_test_probe", "time": time}
    exec("def read_clock():\n    return time.monotonic()\n", namespace)
    return namespace["read_clock"]


def test_tripwire_counts_reads_and_ticks_metric():
    read_clock = _package_probe()
    metrics = Metrics()

    async def main():
        return read_clock()

    tripwire = Tripwire(metrics=metrics, strict=False)
    with tripwire:
        run_simulation(main())
    assert tripwire.total_reads == 1
    (site,) = tripwire.reads
    assert site.startswith("mysticeti_tpu_torch._detsan_test_probe:")
    value = metrics.mysticeti_detsan_wallclock_reads_total.labels(
        site=site
    )._value.get()
    assert value == 1.0


def test_tripwire_strict_mode_raises_at_site():
    read_clock = _package_probe()

    async def main():
        return read_clock()

    with pytest.raises(WallClockLeak, match="_detsan_test_probe"):
        with Tripwire(strict=True):
            run_simulation(main())


def test_tripwire_env_knob_enables_strict(monkeypatch):
    monkeypatch.setenv(detsan.STRICT_ENV, "1")
    assert Tripwire().strict
    monkeypatch.delenv(detsan.STRICT_ENV)
    assert not Tripwire().strict


def test_tripwire_ignores_reads_outside_simulation():
    read_clock = _package_probe()
    with Tripwire(strict=True) as tripwire:
        read_clock()  # no running DeterministicLoop: passes through
    assert tripwire.total_reads == 0


def test_tripwire_ignores_third_party_frames():
    async def main():
        # caller module is tests.* / test_detsan, not mysticeti_tpu_torch.*
        return time.monotonic()

    with Tripwire(strict=True) as tripwire:
        run_simulation(main())
    assert tripwire.total_reads == 0


def test_tripwire_uninstall_restores_time_module():
    originals = {name: getattr(time, name) for name in ("monotonic", "time")}
    with Tripwire():
        assert time.monotonic is not originals["monotonic"]
    for name, fn in originals.items():
        assert getattr(time, name) is fn


# -- parity: the two packages' event chains ----------------------------------

def test_chaos_sim_event_chain_equals_the_jax_packages():
    """The same AcceptAll chaos sim (crashes, a torn tail, link faults) on
    each package under a recorder: the same events in the same order, label
    for label, virtual time for virtual time, and the same chain digest."""
    import tempfile

    from mysticeti_tpu import chaos as J
    from mysticeti_tpu import detsan as JD
    from mysticeti_tpu_torch.chaos import CrashFault, FaultPlan, LinkFault, run_chaos_sim

    plan = FaultPlan(seed=3, link_faults=[LinkFault(drop_p=0.05, delay_p=0.05)],
                     crashes=[CrashFault(node=2, at_s=0.8, downtime_s=0.6, torn_tail_bytes=9)])

    def record(recorder, run, plan):
        with tempfile.TemporaryDirectory() as wal_dir:
            run(plan, 4, 3.0, wal_dir, detsan=recorder)
        return recorder

    port = record(DetsanRecorder(), run_chaos_sim, plan)
    jax = record(JD.DetsanRecorder(), J.run_chaos_sim, J.FaultPlan.from_json(plan.to_json()))
    assert port.count == jax.count > 500
    assert [(e.index, e.vtime, e.label) for e in port.events] == \
        [(e.index, e.vtime, e.label) for e in jax.events]
    assert port.chain == jax.chain
    report = find_divergence(port, jax)
    assert report.identical, report.to_dict()


def test_tool_detsan_passes(tmp_path, capsys):
    """``python -m mysticeti_tpu_torch.tools.detsan`` at 4 nodes: the clean
    runs are identical, the planted leak is bisected, the port's lint
    detects both static fixtures, the tripwire counts and raises, and the
    artifact says so."""
    import json

    from mysticeti_tpu_torch.tools import detsan as tool

    out = tmp_path / "detsan.json"
    assert tool.main(["--nodes", "4", "--duration", "1", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["passed"] and doc["clean"]["identical"]
    assert not doc["planted"]["identical"] and doc["planted"]["first_divergence"]
    assert doc["fixtures"] == {"pr11_wal_backlog": True, "pr12_dispatch_ema": True}
    assert doc["tripwire"]["counted_reads"] == 1 and doc["tripwire"]["strict_mode_raised"]
    printed = capsys.readouterr().out
    assert ("detsan: static fixtures detected: "
            "{'pr11_wal_backlog': True, 'pr12_dispatch_ema': True}") in printed
    assert "detsan: PASS" in printed
