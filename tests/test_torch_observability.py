"""The port's observability planes against the JAX package's.

* ``spans.SpanTracer``: the same spans under a fixed clock export the same
  Chrome trace, byte for byte on disk, and the trace readers agree.
* ``tracing.setup_logging``: the line format and the env-filter levels.
* ``metrics.Metrics``: every family the port writes has the JAX package's
  name, type, labels and buckets; the build families stand for the JAX
  compile families.
* Device attribution: a CPU dispatch counts exactly the padded arrays' bytes
  each way; the kernels' build counts hits, misses and nvcc runs, and a
  failing build still raises ``CudaBuildError``.
* The batching collector: one flush observes each pipeline stage once,
  publishes occupancy, dispatch shape and verdict counts, and records the
  ``verify_*`` spans.
"""
import asyncio
import io
import json
import logging
import os
import re
import sys

import numpy as np
import pytest

from mysticeti_tpu import metrics as JM
from mysticeti_tpu import spans as JS
from mysticeti_tpu import tracing as JTR
from mysticeti_tpu_torch import metrics as PM
from mysticeti_tpu_torch import spans as PS
from mysticeti_tpu_torch import tracing as PTR
from mysticeti_tpu_torch.ops import cuda_build
from mysticeti_tpu_torch.ops import ed25519 as E


class Ref:
    """A block-reference stand-in (what ``format_ref`` reads)."""

    def __init__(self, authority, round_, digest):
        self.authority, self.round, self.digest = authority, round_, digest


class FixedClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _record(tracer):
    """The same spans on either package's tracer; every clock read comes
    from the patched clock."""
    a, b = Ref(1, 7, bytes(range(32))), Ref(2, 9, b"\xff" * 32)
    tracer.record_span("verify_pack", a, 100.5, t1=100.75, authority=1)
    tracer.record_span("transit", b, 100.2, t1=100.3, authority=2, extra={"peer": 3})
    tracer.record_span("verify_device", a, 101.0)  # t1 from the clock, untracked
    tracer.begin_span("proposal_wait", b, authority=2)
    tracer.begin_span("proposal_wait", b, authority=2)  # keeps its original start
    tracer.end_span("proposal_wait", b, authority=2)
    tracer.end_span("commit", a, authority=1)  # never begun: ignored
    with tracer.span("verify_fetch", a, authority=0):
        pass


@pytest.fixture
def fixed_clocks(monkeypatch):
    from mysticeti_tpu import runtime as JR
    from mysticeti_tpu_torch import runtime as PR

    clock = FixedClock()
    for mod in (JS, PS):
        monkeypatch.setattr(mod, "runtime_now", clock)
    for mod in (JR, PR):
        monkeypatch.setattr(mod, "timestamp_utc", lambda: 1.7e9)
    return clock


def test_chrome_trace_equals_the_jax_package(fixed_clocks, tmp_path):
    traces, sinks = {}, {}
    for name, mod in (("jax", JS), ("port", PS)):
        fixed_clocks.t = 100.0
        tracer = mod.SpanTracer()
        seen = sinks[name] = []
        tracer.add_sink(lambda *args, seen=seen: seen.append((args[0], args[2], args[3], args[4])))
        _record(tracer)
        traces[name] = tracer
    assert traces["port"].chrome_trace() == traces["jax"].chrome_trace()
    assert sinks["port"] == sinks["jax"]
    assert traces["port"].dropped == traces["jax"].dropped
    # The same bytes on disk, and the same readers' view of them.
    for name, tracer in traces.items():
        tracer.write(str(tmp_path / f"{name}.json"))
    port_text = (tmp_path / "port.json").read_text()
    assert port_text == (tmp_path / "jax.json").read_text()
    torn = port_text[: len(port_text) * 2 // 3]
    assert PS.salvage_trace_events(torn) == JS.salvage_trace_events(torn)
    assert PS._salvage_other_data(torn) == JS._salvage_other_data(torn)
    events, note, other = PS.load_trace_events(str(tmp_path / "port.json"))
    assert (events, note, other) == JS.load_trace_events(str(tmp_path / "jax.json"))
    spans = PS.complete_spans(events)
    assert spans == JS.complete_spans(events)
    assert PS.track_names(events) == JS.track_names(events)
    assert PS.stage_chains(spans) == JS.stage_chains(spans)
    assert PS.STAGES == JS.STAGES and PS.PIPELINE_STAGES == JS.PIPELINE_STAGES


def test_span_flusher_and_env_lifecycle(monkeypatch, tmp_path):
    path = tmp_path / "trace-%p.json"
    monkeypatch.setenv(PS.ENV_TRACE, str(path))
    previous = PS.install(None)
    try:
        tracer = PS.start_from_env()
        assert tracer is not None and PS.active() is tracer
        assert PS.start_from_env() is None  # one live tracer
        tracer.record_span("verify_pack", Ref(0, 1, bytes(32)), 1.0, t1=2.0)
        PS.flush_active()
        written = tmp_path / f"trace-{os.getpid()}.json"
        assert [e["name"] for e in PS.complete_spans(json.loads(written.read_text())["traceEvents"])] == ["verify_pack"]
        PS.stop_from_env()
        assert PS.active() is None and tracer._thread is None
    finally:
        PS.install(previous)


def _log_line(mod, spec, name, level, authority=None):
    stream = io.StringIO()
    mod.setup_logging(spec, stream=stream, force=True)
    token = mod.current_authority.set(authority)
    try:
        logging.getLogger(name).log(level, "hello %d", 42)
    finally:
        mod.current_authority.reset(token)
    return stream.getvalue()


@pytest.fixture
def saved_loggers():
    """Both packages' root loggers as they were, restored after the test."""
    roots = [logging.getLogger(mod.PACKAGE) for mod in (PTR, JTR)]
    saved = [(list(r.handlers), r.level, r.propagate) for r in roots]
    yield
    for mod in (PTR, JTR):
        for name in mod._touched_modules:
            logging.getLogger(name).setLevel(logging.NOTSET)
        mod._touched_modules.clear()
    for r, (handlers, level, propagate) in zip(roots, saved):
        for h in list(r.handlers):
            r.removeHandler(h)
        for h in handlers:
            r.addHandler(h)
        r.setLevel(level)
        r.propagate = propagate


def test_setup_logging_format_and_levels(saved_loggers, monkeypatch):
    monkeypatch.delenv("MYSTICETI_LOG", raising=False)
    root = logging.getLogger(PTR.PACKAGE)
    assert PTR.PACKAGE == "mysticeti_tpu_torch"
    line = _log_line(PTR, "warning,verifier_service=debug",
                     "mysticeti_tpu_torch.verifier_service", logging.DEBUG, authority=3)
    assert re.fullmatch(r"\[\d\d:\d\d:\d\d A3\] debug   verifier_service: hello 42\n", line), line
    # The JAX package's formatter prints the same line for its package.
    jline = _log_line(JTR, "warning,verifier_service=debug",
                      "mysticeti_tpu.verifier_service", logging.DEBUG, authority=3)
    assert jline[jline.index("]"):] == line[line.index("]"):]
    # The root level filters other modules; a forced re-install resets
    # the per-module levels of the previous spec.
    assert _log_line(PTR, "warning", "mysticeti_tpu_torch.bench", logging.INFO) == ""
    assert _log_line(PTR, "warning", "mysticeti_tpu_torch.verifier_service", logging.DEBUG) == ""
    line = _log_line(PTR, "info", "mysticeti_tpu_torch.bench", logging.INFO)
    assert re.fullmatch(r"\[\d\d:\d\d:\d\d\] info    bench: hello 42\n", line), line
    # No spec and no MYSTICETI_LOG: library mode, nothing installed.
    before = list(root.handlers)
    PTR.setup_logging(None)
    assert root.handlers == before


# Every family the port's modules write, with the JAX package's definition.
SHARED_FAMILIES = (
    "verified_signatures_total", "verify_batch_size", "verify_dispatch_batch_size",
    "verify_padding_wasted_total", "verify_collector_window_seconds", "verify_route_total",
    "verify_route_estimate_error_s", "verify_shortcircuit_total", "verifier_fallback_total",
    "verifier_service_queue_depth", "verifier_service_inflight", "verify_wire_bytes_total",
    "verifier_reconnect_total", "verify_pipeline_inflight", "verify_pipeline_depth",
    "verify_pipeline_stage_seconds", "mysticeti_verify_occupancy_fraction",
    "mysticeti_device_transfer_bytes_total", "utilization_timer_us",
)
BUILD_FAMILIES = {
    "mysticeti_cuda_builds_total": "mysticeti_jax_compiles_total",
    "mysticeti_cuda_build_seconds_total": "mysticeti_jax_compile_seconds_total",
    "mysticeti_cuda_build_cache_hits_total": "mysticeti_jax_cache_hits_total",
    "mysticeti_cuda_build_cache_misses_total": "mysticeti_jax_cache_misses_total",
}


def _shape(family):
    return (type(family).__name__, family._name, family._labelnames, family._documentation,
            tuple(getattr(family, "_upper_bounds", ())))


def test_metrics_families_equal_the_jax_package():
    port, jax = PM.Metrics(), JM.Metrics()
    for attr in SHARED_FAMILIES:
        assert _shape(getattr(port, attr)) == _shape(getattr(jax, attr)), attr
    for attr, jax_attr in BUILD_FAMILIES.items():
        got, want = getattr(port, attr), getattr(jax, jax_attr)
        assert (type(got).__name__, got._labelnames) == (type(want).__name__, want._labelnames)
        assert got._name == attr[: -len("_total")]
    assert not hasattr(port, "mysticeti_native_active")  # waits for the native data plane
    # The scrape carries the families the collector writes.
    port.verify_pipeline_stage_seconds.labels("pack").observe(0.002)
    with port.utilization_timer("verify:dispatch"):
        pass
    scrape = port.expose().decode()
    assert 'verify_pipeline_stage_seconds_bucket{le="0.005",stage="pack"} 1.0' in scrape
    assert 'utilization_timer_total{proc="verify:dispatch"}' in scrape


def test_serve_metrics_scrape_and_healthz():
    async def main():
        metrics = PM.Metrics()
        metrics.verifier_reconnect_total.inc(3)
        server = await PM.serve_metrics(metrics, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        bodies = {}
        for path in ("/metrics", "/healthz"):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
            await writer.drain()
            bodies[path] = (await reader.read()).decode()
            writer.close()
        server.close()
        await server.wait_closed()
        return bodies

    bodies = asyncio.run(main())
    assert "verifier_reconnect_total 3.0" in bodies["/metrics"]
    assert '"status":"ok"' in bodies["/healthz"]


@pytest.fixture
def attributed():
    metrics = PM.Metrics()
    E.install_device_attribution(metrics)
    try:
        yield metrics
    finally:
        E.install_device_attribution(None)


def _signed(n, keys, seed=5):
    from mysticeti_tpu_torch import crypto

    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for i in range(n):
        signer = keys[i % len(keys)]
        msg = rng.bytes(32)
        pks.append(signer.public_key.bytes)
        msgs.append(msg)
        sigs.append(signer.sign(msg))
    return pks, msgs, sigs


def test_transfer_bytes_of_a_cpu_dispatch_are_the_padded_arrays(attributed):
    from mysticeti_tpu_torch import crypto

    signers = [crypto.Signer.from_seed(bytes([i]) * 32) for i in range(3)]
    table = E.KeyTable([s.public_key.bytes for s in signers], device="cpu")
    # The combs' uploads are set-up, counted once per device apart.
    table.neg_combs51()
    E.base_comb("cpu"), E.base_comb51("cpu")
    moved = attributed.mysticeti_device_transfer_bytes_total
    up, down = moved.labels("to_device"), moved.labels("from_device")
    before = up._value.get()
    pks, msgs, sigs = _signed(100, signers)
    stranger = crypto.Signer.from_seed(b"\x77" * 32)
    pks[5], sigs[5] = stranger.public_key.bytes, stranger.sign(msgs[5])  # a generic-path patch
    out = E.verify_batch_table(table, pks, msgs, sigs)
    assert out.all()
    # One 256-lane indexed chunk (26 words a lane), one 256-lane raw patch
    # chunk (33 words a lane); one byte a verdict lane back, for each.
    assert up._value.get() - before == 256 * 26 * 4 + 256 * 33 * 4
    assert down._value.get() == 256 + 256


def test_build_attribution_counts_hits_misses_and_builds(attributed, monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "cuda")
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "if 'verify_keyed.cu' in args[-1]:\n"
        "    sys.exit(3)\n"
        "open(args[args.index('-o') + 1], 'w').close()\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: str(fake))
    m = attributed
    cuda_build.build(["prologue", "verify_generic"])  # two misses, two builds
    cuda_build.build(["prologue"])  # on disk: a hit
    with pytest.raises(cuda_build.CudaBuildError, match="verify_keyed.cu"):
        cuda_build.build(["verify_keyed"])  # a miss whose nvcc fails
    assert m.mysticeti_cuda_build_cache_misses_total._value.get() == 3
    assert m.mysticeti_cuda_build_cache_hits_total._value.get() == 1
    assert m.mysticeti_cuda_builds_total._value.get() == 2
    assert m.mysticeti_cuda_build_seconds_total._value.get() > 0

    # A broken registry never changes a build's outcome.
    class Broken:
        def __getattr__(self, name):
            raise AttributeError(name)

    E.install_device_attribution(Broken())
    cuda_build.build(["prologue"])
    with pytest.raises(cuda_build.CudaBuildError):
        cuda_build.build(["verify_keyed"])


def _blocks(n_auth=4):
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.types import Share, StatementBlock

    committee = Committee.new_for_benchmarks(n_auth)
    signers = Committee.benchmark_signers(n_auth)
    genesis = [StatementBlock.new_genesis(a).reference for a in range(n_auth)]
    blocks = [StatementBlock.build(a, 1, genesis, [Share(b"tx%d" % a)], signer=signers[a])
              for a in range(n_auth)]
    blocks[2] = StatementBlock.build(2, 1, genesis, [Share(b"tx")], signer=signers[3])  # wrong signer
    return committee, blocks


def test_one_flush_observes_each_stage_and_the_verdicts():
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier, CpuSignatureVerifier

    committee, blocks = _blocks()
    metrics = PM.Metrics()
    collector = BatchedSignatureVerifier(committee, CpuSignatureVerifier(), metrics=metrics)
    assert collector.pipeline.metrics is metrics
    tracer = PS.SpanTracer()
    previous = PS.install(tracer)
    try:
        assert asyncio.run(collector.verify_blocks(blocks)) == [True, True, False, True]
    finally:
        PS.install(previous)
    r = metrics.registry
    for stage in ("pack", "device", "fetch"):
        assert r.get_sample_value("verify_pipeline_stage_seconds_count", {"stage": stage}) == 1.0
        assert r.get_sample_value("verify_pipeline_stage_seconds_sum", {"stage": stage}) >= 0.0
    fractions = [r.get_sample_value("mysticeti_verify_occupancy_fraction", {"phase": p})
                 for p in ("pack", "device", "fetch")]
    assert abs(sum(fractions) - 1.0) < 1e-5
    assert r.get_sample_value("verify_dispatch_batch_size_count") == 1.0
    assert r.get_sample_value("verify_batch_size_sum") == 4.0
    label = {"backend": "CpuSignatureVerifier"}
    assert r.get_sample_value("verified_signatures_total", {**label, "outcome": "accepted"}) == 3.0
    assert r.get_sample_value("verified_signatures_total", {**label, "outcome": "rejected"}) == 1.0
    assert r.get_sample_value("verify_padding_wasted_total", label) == 0.0
    assert r.get_sample_value("verify_collector_window_seconds") > 0
    assert r.get_sample_value("utilization_timer_total", {"proc": "verify:dispatch"}) >= 0
    names = {e["name"] for e in PS.complete_spans(tracer.chrome_trace()["traceEvents"])}
    assert names == set(PS.VERIFY_STAGES)


def test_in_process_make_verifier_wires_attribution_and_stage_timers():
    """The in-process ``cuda-only`` kind on the CPU: ``metrics`` reaches the
    collector and the device attribution, so one flush reports its stage
    seconds, its padding (a 256-lane bucket for 4 signatures) and the bytes
    it moved."""
    from mysticeti_tpu_torch.validator import ACCELERATOR_KIND, _make_verifier

    committee, blocks = _blocks()
    metrics = PM.Metrics()
    try:
        verifier = _make_verifier(ACCELERATOR_KIND, committee, metrics=metrics, device="cpu")
        assert E._attr_metrics is metrics
        assert verifier.ready.wait(300)
        r = metrics.registry
        up0 = r.get_sample_value("mysticeti_device_transfer_bytes_total", {"direction": "to_device"}) or 0
        assert asyncio.run(verifier.verify_blocks(blocks)) == [True, True, False, True]
        assert r.get_sample_value("verify_pipeline_stage_seconds_count", {"stage": "device"}) == 1.0
        up = r.get_sample_value("mysticeti_device_transfer_bytes_total", {"direction": "to_device"})
        assert up - up0 == 256 * 26 * 4
        assert r.get_sample_value("verify_padding_wasted_total",
                                  {"backend": "TorchSignatureVerifier"}) == 252.0
    finally:
        E.install_device_attribution(None)
