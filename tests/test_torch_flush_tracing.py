"""The port's spans and counters inside the receive path.

A collector dispatch off the simulator counts its executor queue waits, the
thread CPU of its stages and its blocks' wait in the collector, and with a
tracer records one set of ``flush_*`` spans under one flush id; an offloaded
frame counts its queue wait and CPU and records ``offload_queue`` /
``offload_decode``.  Under the simulator none of it is recorded.  The four
per-block ``verify_*`` spans of a dispatch are one record that reads back as
the per-block events ``record_span`` would have made.
"""
import ast
import asyncio
import time

import numpy as np
import pytest

from mysticeti_tpu_torch import metrics as PM
from mysticeti_tpu_torch import runtime as PR
from mysticeti_tpu_torch import spans as PS
from mysticeti_tpu_torch.analysis import analyze_source
from mysticeti_tpu_torch.analysis.checker import collect_span_stages
from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier, TorchSignatureVerifier
from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.core_task import DataPlaneOffload
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.runtime.simulated import run_simulation
from mysticeti_tpu_torch.types import Share, StatementBlock

N_AUTH = 4


def _blocks():
    committee = Committee.new_for_benchmarks(N_AUTH)
    signers = Committee.benchmark_signers(N_AUTH)
    genesis = [StatementBlock.new_genesis(a).reference for a in range(N_AUTH)]
    blocks = [StatementBlock.build(a, 1, genesis, [Share(b"tx%d" % a)], signer=signers[a])
              for a in range(N_AUTH)]
    blocks[2] = StatementBlock.build(2, 1, genesis, [Share(b"tx")], signer=signers[3])  # forged
    return committee, blocks


@pytest.fixture(scope="module")
def cpu_backend():
    """The committee's ``TorchSignatureVerifier`` on the CPU (the kernels'
    plain versions), warmed once."""
    committee, _ = _blocks()
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes(), device="cpu")
    backend.warmup()
    return backend


class _Traced:
    """A tracer installed and the device attribution on ``metrics`` for the
    block; both undone after."""

    def __init__(self, metrics) -> None:
        self.metrics, self.tracer = metrics, PS.SpanTracer()

    def __enter__(self):
        self.previous = PS.install(self.tracer)
        E.install_device_attribution(self.metrics)
        return self.tracer

    def __exit__(self, *exc) -> None:
        PS.install(self.previous)
        E.install_device_attribution(None)


def _flush_spans(tracer):
    return [e for e in tracer.events if e[1] is None and e[0].startswith("flush_")]


def test_a_cpu_flush_records_one_flush_span_set_and_its_counters(cpu_backend):
    committee, blocks = _blocks()
    metrics = PM.Metrics()
    collector = BatchedSignatureVerifier(committee, cpu_backend, metrics=metrics)
    with _Traced(metrics) as tracer:
        before = time.monotonic()
        assert asyncio.run(collector.verify_blocks(blocks)) == [True, True, False, True]
    flush = _flush_spans(tracer)
    by_name = {}
    for stage, _, _, t0, t1, args in flush:
        by_name.setdefault(stage, []).append((t0, t1, args))
    # One dispatch of one 256-lane chunk: each flush span once, one id.
    assert sorted(by_name) == sorted(PS.FLUSH_STAGES)
    assert all(len(v) == 1 for v in by_name.values())
    ids = {args["flush"] for _, _, _, _, _, args in flush}
    assert len(ids) == 1 and all(args["lanes"] == N_AUTH for *_, args in flush)
    # Each block's verify_dispatch event names the same flush.
    dispatch = [e for e in tracer.events if e[0] == "verify_dispatch"]
    assert len(dispatch) == N_AUTH and {e[5]["flush"] for e in dispatch} == ids
    # In order on one timeline: queue, wire, upload, launch, fetch queue, fetch.
    (q0, q1, _), = by_name["flush_queue"]
    (w0, w1, _), = by_name["flush_wire"]
    (u0, u1, _), = by_name["flush_upload"]
    (l0, l1, _), = by_name["flush_launch"]
    (fq0, fq1, _), = by_name["flush_fetch_queue"]
    (f0, f1, fargs), = by_name["flush_fetch"]
    assert q0 <= q1 <= w0 <= w1 == u0 <= u1 == l0 <= l1 <= fq0 <= fq1 == f0 <= f1

    g = metrics.registry.get_sample_value
    stage = lambda name, s: g(name, {"stage": s})  # noqa: E731
    # The counters come from the spans' own readings.
    assert stage("verify_pipeline_stage_seconds_sum", "queue") == pytest.approx(
        (q1 - q0) + (fq1 - fq0), abs=1e-9)
    assert stage("verify_pipeline_stage_seconds_count", "queue") == 1.0
    assert stage("verify_pipeline_stage_seconds_sum", "fetch") == pytest.approx(f1 - f0, abs=1e-9)
    assert stage("verify_pipeline_stage_cpu_seconds_total", "fetch") == pytest.approx(fargs["cpu_s"], abs=1e-9)
    device = stage("verify_pipeline_stage_seconds_sum", "device")
    assert device >= (w1 - w0) + (u1 - u0) + (l1 - l0)
    phases_cpu = sum(by_name[n][0][2]["cpu_s"] for n in ("flush_wire", "flush_upload", "flush_launch"))
    assert stage("verify_pipeline_stage_cpu_seconds_total", "device") >= phases_cpu - 1e-9
    assert stage("verify_pipeline_stage_cpu_seconds_total", "pack") >= 0.0
    # No kernel runs on the CPU, so no device seconds; each block waited in
    # the collector from its verify() to the submission (flush_queue's start).
    assert g("verify_device_seconds_total") == 0.0
    assert g("verify_batch_size_sum") == N_AUTH
    assert 0.0 < g("verify_collector_wait_seconds_total") <= N_AUTH * (q0 - before)


def test_without_a_tracer_the_counters_still_count(cpu_backend):
    committee, blocks = _blocks()
    metrics = PM.Metrics()
    collector = BatchedSignatureVerifier(committee, cpu_backend, metrics=metrics)
    assert PS.active() is None
    assert asyncio.run(collector.verify_blocks(blocks)) == [True, True, False, True]
    g = metrics.registry.get_sample_value
    assert g("verify_pipeline_stage_seconds_count", {"stage": "queue"}) == 1.0
    assert g("verify_pipeline_stage_cpu_seconds_total", {"stage": "device"}) > 0.0
    assert g("verify_collector_wait_seconds_total") > 0.0


def test_a_dispatch_takes_its_phases_only_with_a_tracer(cpu_backend, monkeypatch):
    committee, blocks = _blocks()
    given = []
    dispatch = E.dispatch_batch_table

    def spy(table, pks, digests, sigs, phases=None):
        given.append(phases)
        return dispatch(table, pks, digests, sigs, phases)

    monkeypatch.setattr(E, "dispatch_batch_table", spy)
    metrics = PM.Metrics()
    verdicts = [True, True, False, True]
    collector = BatchedSignatureVerifier(committee, cpu_backend, metrics=metrics)
    assert asyncio.run(collector.verify_blocks(blocks)) == verdicts
    with _Traced(metrics):
        collector = BatchedSignatureVerifier(committee, cpu_backend, metrics=metrics)
        assert asyncio.run(collector.verify_blocks(blocks)) == verdicts
        # The backend called outside a collector's submit records nothing.
        pks = [committee.get_public_key(b.author()).bytes for b in blocks]
        handle = cpu_backend.verify_signatures_async(
            pks, [b.signed_digest() for b in blocks], [b.signature for b in blocks])
        assert list(handle.result()) == verdicts
    untraced, traced, direct = given
    assert untraced is None and direct is None
    assert [p[0] for p in traced.items] == ["flush_wire", "flush_upload", "flush_launch"]
    assert all(t0 <= t1 and cpu >= 0.0 for _, t0, t1, cpu in traced.items)


def test_only_a_recorded_dispatch_times_its_launches():
    """The untraced dispatch keeps the one launch path: nothing is timed
    without a phase recorder, nor without the attribution."""
    recorder = object()
    assert E._launch_timing(recorder) is None
    with _Traced(PM.Metrics()):
        assert E._launch_timing(None) is None
        assert E._launch_timing(recorder) == []


def test_an_abandoned_or_failed_dispatch_releases_its_timed_launches(monkeypatch):
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    dropped = []
    monkeypatch.setattr(K, "drop_pairs", lambda pairs: dropped.append(list(pairs)))
    patch = E.VerifyDispatch([], events=[(3, 4)])
    handle = E.VerifyDispatch([], [(np.array([0]), patch)], events=[(1, 2)])
    handle.abandon()
    handle.abandon()
    assert dropped == [[(1, 2)], [(3, 4)]]
    failing = E.VerifyDispatch([(1, "not a result")], events=[(5, 6)])
    with pytest.raises(AttributeError):
        failing.result()
    assert dropped[-1] == [(5, 6)]
    failing.abandon()
    assert len(dropped) == 3


def test_an_offloaded_frame_records_its_queue_and_decode():
    _, blocks = _blocks()
    raws = [b.to_bytes() for b in blocks]
    metrics = PM.Metrics()
    offload = DataPlaneOffload(metrics=metrics)
    try:
        with _Traced(metrics) as tracer:
            decoded = asyncio.run(offload.run("decode", StatementBlock.from_bytes_many, raws))
    finally:
        offload.stop()
    assert [b.reference for b in decoded] == [b.reference for b in blocks]
    spans = {e[0]: e for e in tracer.events}
    assert sorted(spans) == ["offload_decode", "offload_queue"]
    _, _, _, q0, q1, qargs = spans["offload_queue"]
    _, _, _, d0, d1, dargs = spans["offload_decode"]
    assert q1 == d0 and qargs == {"frame": 1, "blocks": N_AUTH}
    assert dargs["frame"] == 1 and dargs["blocks"] == N_AUTH and 0.0 <= dargs["cpu_s"]
    g = metrics.registry.get_sample_value
    decode = {"stage": "decode"}
    assert g("dataplane_offload_queue_seconds_total", decode) == pytest.approx(q1 - q0, abs=1e-9)
    assert g("dataplane_offload_cpu_seconds_total", decode) == pytest.approx(dargs["cpu_s"], abs=1e-9)
    assert g("dataplane_offload_seconds_sum", decode) == pytest.approx(d1 - d0, abs=1e-9)


def test_nothing_new_is_recorded_under_the_simulator(cpu_backend):
    committee, blocks = _blocks()
    metrics = PM.Metrics()
    collector = BatchedSignatureVerifier(committee, cpu_backend, metrics=metrics)
    seen = []

    async def main():
        return await collector.verify_blocks(blocks)

    with _Traced(metrics) as tracer:
        tracer.add_sink(lambda *args: seen.append(args[0]))
        assert run_simulation(main(), seed=3) == [True, True, False, True]
    # The per-block spans of an inline dispatch, as the JAX package records
    # them: no device span, no flush id, no flush or offload span.
    names = [e[0] for e in tracer.events]
    assert sorted(set(names)) == ["verify_dispatch", "verify_fetch", "verify_pack"]
    assert all(e[5] is None for e in tracer.events)
    assert sorted(seen) == sorted(names)
    g = metrics.registry.get_sample_value
    assert g("verify_pipeline_stage_seconds_count", {"stage": "queue"}) is None
    for s in ("pack", "device", "fetch"):
        assert g("verify_pipeline_stage_cpu_seconds_total", {"stage": s}) is None
    assert g("verify_collector_wait_seconds_total") == 0.0
    assert g("verify_device_seconds_total") == 0.0


@pytest.mark.parametrize("device", [True, False], ids=["off-sim", "inline"])
def test_a_flush_record_reads_back_as_the_per_block_spans(monkeypatch, device):
    """One record a dispatch gives the events, trace and sink calls that a
    span a block a stage gives."""
    _, blocks = _blocks()
    refs = [b.reference for b in blocks]
    out = {}
    monkeypatch.setattr(PS, "runtime_now", lambda: 100.0)
    monkeypatch.setattr(PR, "timestamp_utc", lambda: 1.7e9)
    for how in ("records", "spans"):
        tracer = PS.SpanTracer()
        seen = out.setdefault(how, [])
        tracer.add_sink(lambda *args, seen=seen: seen.append(args))
        tracer.record_span("receive", refs[0], 99.0, authority=1)
        t_pack, t_dispatch, t_fetch, t1 = 100.0, 101.0, 102.0, 103.0
        extra = {"flush": 7} if device else None
        if how == "records":
            flush = tracer.begin_flush(refs, t_pack, authority=1)
            if device:
                flush.device_done(t_dispatch, t_fetch)
            tracer.record_span("commit", refs[1], 100.5, authority=1)
            flush.done(t_fetch if device else t_dispatch, t_dispatch, t1, extra)
        else:
            for ref in refs:
                tracer.record_span("verify_pack", ref, t_pack, authority=1)
            if device:
                for ref in refs:
                    tracer.record_span("verify_device", ref, t_dispatch, t1=t_fetch, authority=1)
            tracer.record_span("commit", refs[1], 100.5, authority=1)
            for ref in refs:
                tracer.record_span("verify_fetch", ref, t_fetch if device else t_dispatch, t1=t1,
                                   authority=1)
                tracer.record_span("verify_dispatch", ref, t_dispatch, t1=t1, authority=1,
                                   extra=extra)
        out[how + "_trace"] = tracer.chrome_trace()
        out[how + "_events"] = sorted(tracer.events, key=repr)
    assert out["records_trace"] == out["spans_trace"]
    assert out["records_events"] == out["spans_events"]
    assert out["records"] == out["spans"]


def test_the_event_cap_drops_a_flush_whole_and_its_sinks_still_see_it(monkeypatch):
    _, blocks = _blocks()
    refs = [b.reference for b in blocks]
    monkeypatch.setattr(PS.SpanTracer, "MAX_EVENTS", 4 * len(refs) + 1)
    tracer = PS.SpanTracer()
    seen = []
    tracer.add_sink(lambda *args: seen.append(args[0]))
    kept = tracer.begin_flush(refs, 1.0)
    kept.device_done(2.0, 3.0)
    kept.done(3.0, 2.0, 4.0)
    dropped = tracer.begin_flush(refs, 5.0)
    dropped.device_done(6.0, 7.0)
    dropped.done(7.0, 6.0, 8.0)
    tracer.record_interval("flush_queue", 9.0, 9.5, {"flush": 1, "lanes": 4})
    assert len(tracer.events) == 4 * len(refs) + 1
    assert tracer.dropped == 4 * len(refs)
    assert len(seen) == 2 * 4 * len(refs)


def test_a_flush_span_is_exported_with_its_args_and_no_block():
    tracer = PS.SpanTracer()
    tracer.record_interval("flush_fetch", 2.0, 2.5, {"flush": 3, "lanes": 9, "cpu_s": 0.1}, authority=2)
    events = tracer.chrome_trace()["traceEvents"]
    span, = PS.complete_spans(events)
    assert span["name"] == "flush_fetch" and span["tid"] == 2
    assert span["args"] == {"flush": 3, "lanes": 9, "cpu_s": 0.1}
    assert (span["ts"], span["dur"]) == (2_000_000, 500_000)
    # Readers of per-block chains pass over it.
    assert PS.stage_chains([span], stages=PS.PORT_STAGES) == {}


def test_the_span_names_lint_accepts_the_port_stages():
    with open(PS.__file__) as fh:
        tree = ast.parse(fh.read())
    assert collect_span_stages(tree) == PS.STAGES
    assert collect_span_stages(tree, "PORT_STAGES") == PS.PORT_STAGES
    src = ("def f(tracer, ref):\n"
           "    tracer.record_interval('flush_queue', 0.0, 1.0, {})\n"
           "    tracer.record_interval('flush_qeue', 0.0, 1.0, {})\n"
           "    tracer.record_span('verify_pack', ref, 0.0)\n")
    findings = analyze_source(src, "mysticeti_tpu_torch/example.py",
                              span_stages=PS.STAGES + PS.PORT_STAGES)
    assert [(f.rule, f.line) for f in findings] == [("span-names", 3)]
