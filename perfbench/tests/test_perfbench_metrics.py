"""The metric arithmetic: a window's rate, the tail over all samples, the
frozen bound model against the port's stated kernel bounds, the trace
reduction, and the per-layer readers."""
import pytest

from perfbench import bound, check, run, trace


def _records(rows):
    """rows: (outcome, t) -> Records."""
    r = run.Records()
    for i, (outcome, t) in enumerate(rows):
        pos = r.add(i, (1, 2, bytes(32), bytes(32)))
        if outcome != check.PENDING:
            r.answer(pos, outcome, t)
    return r


def _window(rows=(), t0=10.0, t1=20.0, **kw):
    r = run.Run()
    r.records = _records(rows)
    r.stage1 = kw.pop("stage1", [])
    w = run.window_of(r, t0, t1, kw.pop("counters", {}))
    for k, v in kw.items():
        setattr(w, k, v)
    return w


def test_catchup_rate_counts_answers_inside_the_window_only():
    rows = [(check.ACCEPTED if i % 2 else check.REJECTED, 10.0 + i) for i in range(15)]
    rows.append((check.PENDING, 0.0))
    rows.append((check.ERROR, 11.0))
    w = _window(rows)
    # Verdicts at 10..20 s count (11 of them), later ones, errors and missing do not.
    assert run.end_to_end(w) == {"catchup_blocks_per_s": 11 / 10.0}
    assert w.blocks == 17 and w.failed == 2


def test_bound_model_holds_the_ports_stated_kernel_bounds():
    # chip_smoke.py's kernel phase at 16,384 lanes: prologue 0.00426 ms on
    # every lane, keyed 0.0470 ms on its live lanes (five of its seven
    # classes keep the ok bit: 11,703 of 16,384).
    assert 16384 * bound.PROLOGUE_INT_OPS / bound.INT_OPS_PER_S * 1e3 == pytest.approx(0.00426, abs=5e-6)
    keyed = 11703 * bound.KEYED_INT_OPS / bound.INT_OPS_PER_S * 1e3
    assert keyed == pytest.approx(0.0470, rel=0.005)
    t, by = bound.least_seconds(16384)
    assert by == "operations"
    assert t == pytest.approx(16384 * (bound.PROLOGUE_INT_OPS + bound.KEYED_INT_OPS) / bound.INT_OPS_PER_S)


def test_trace_reduction_busy_kernels_and_labelled_gaps():
    dev = [("kernel", "verify_keyed", 1.0, 1.5), ("kernel", "prologue", 1.4, 1.6),
           ("gpu_memcpy", "Memcpy HtoD", 2.0, 2.1), ("kernel", "verify_keyed", 9.5, 11.0)]
    spans = trace.Spans()
    spans.add("stage1", 0.0, 0.9)
    spans.add("dispatch", 1.7, 1.95)
    spans.add("dispatch", 12.0, 12.5)  # after the window: not counted
    r = trace.reduce(dev, spans, 0.0, 10.0)
    assert r["dispatches"] == 1 and r["dispatch_s"] == pytest.approx(0.25)
    assert r["busy_s"] == pytest.approx(0.6 + 0.1 + 0.5)
    assert r["kernel_s"] == pytest.approx(0.6 + 0.5)
    assert r["device_ops"][0] == ["verify_keyed", pytest.approx(1.0)]
    gaps = dict(r["idle_gaps"])
    assert gaps["stage1"] == pytest.approx(1.0)  # 0 .. 1.0, middle 0.5
    assert gaps["dispatch"] == pytest.approx(0.4)  # 1.6 .. 2.0, middle 1.8
    assert gaps[trace.GAP_IDLE_HOST] == pytest.approx(7.4)  # 2.1 .. 9.5


def test_device_intervals_are_put_on_the_host_clock():
    events = [{"name": trace.SYNC_MARK, "ph": "X", "ts": 1000.0, "dur": 1},
              {"name": "k", "cat": "kernel", "ph": "X", "ts": 3000.0, "dur": 500.0},
              {"name": "cpu_op", "cat": "cpu_op", "ph": "X", "ts": 3000.0, "dur": 5.0}]
    assert trace.device_intervals(events, 50.0) == [("kernel", "k", pytest.approx(50.002), pytest.approx(50.0025))]
    with pytest.raises(RuntimeError):
        trace.device_intervals(events[1:], 50.0)


def test_layer_readers_read_their_quantities_and_nothing_when_absent():
    ctrs = {"lanes_sum": 2560.0, "lanes_count": 10.0, "pack_s": 0.002, "device_s": 0.5, "fetch_s": 0.1}
    w = _window(stage1=[(10.0, 10.1, 0.004, 100)], counters=ctrs,
                trace={"busy_s": 2.5, "kernel_s": 2.0, "device_ops": [], "idle_gaps": [],
                       "dispatches": 8, "dispatch_s": 0.016})
    read = run.load_reader
    assert read("stage1_us_per_block.catchup")(w) == pytest.approx(40.0)
    assert read("lanes_per_flush.catchup")(w) == 256.0
    # The benchmark's dispatch spans, not the program's device stage (which
    # holds the executor's queue wait).
    assert read("dispatch_ms_per_flush.catchup")(w) == pytest.approx(2.0)
    assert read("device_idle_pct.catchup")(w) == pytest.approx(75.0)
    assert read("verify_roofline_pct.catchup")(w) == pytest.approx(100 * bound.least_seconds(2560)[0] / 2.0)
    empty = _window(counters={k: 0.0 for k in ctrs})
    for name in ("stage1_us_per_block.catchup", "lanes_per_flush.catchup", "dispatch_ms_per_flush.catchup",
                 "verify_roofline_pct.catchup", "device_idle_pct.catchup"):
        assert read(name)(empty) is None


def test_every_per_layer_metric_has_a_reader_and_every_cell_its_files():
    import json

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    for cell in bench["workloads"]:
        c = run.load_cell(cell["name"])
        assert c.config["committee_size"] in (10, 50)
        assert c.mix["kind"] == "catchup"
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and c.per_layer
