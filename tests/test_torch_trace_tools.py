"""The port's trace and fleet-health tools: ``trace_report``, ``fleet_trace``
and ``fleetmon`` under ``mysticeti_tpu_torch/tools/``.

Counterparts of ``tests/test_health.py``'s five ``trace_report`` tests
(:439-:502) and of ``tests/test_fleet_trace.py``'s cases that no other port
test holds (the wire tag 12, the skew estimator, the shared truncated-trace
extraction, the flight recorder's ring, debounce and route, and
``test_fleetmon_dump_on_red``; its ten-node merge is in
``test_torch_fleet_trace_sim.py``, its chaos dumps in
``test_torch_chaos_planes.py``).  Then parity with the JAX repository's
tools on the same inputs: ``trace_report``'s output and ``fleet_trace``'s
summary and merged artifact are byte-equal, and ``fleetmon --once`` against
one fixed exposition gives the JAX tool's snapshot and exit status.
"""
import argparse
import asyncio
import json
import os

import pytest

from mysticeti_tpu_torch.flight_recorder import FlightRecorder
from mysticeti_tpu_torch.metrics import Metrics, serve_metrics
from mysticeti_tpu_torch.network import (
    Blocks,
    SerdeError,
    TimestampedBlocks,
    decode_message,
    encode_message,
)
from mysticeti_tpu_torch.spans import PIPELINE_STAGES, SpanTracer
from mysticeti_tpu_torch.tools import fleet_trace, fleetmon, trace_report
from mysticeti_tpu_torch.types import BlockReference

pytestmark = pytest.mark.tracing


def _ref(authority=3, round_=7, tag=b"\x01"):
    return BlockReference(authority, round_, tag.ljust(32, b"\x00"))


def _write_trace(path, tracer):
    tracer.write(path)
    return path


# -- trace_report: critical path + robustness (tests/test_health.py) ---------


def _committed_leader_trace(path):
    tracer = SpanTracer()
    leader = _ref(3, 7, b"\x01")
    tracer.record_span("receive", leader, 0.0, t1=2.0, authority=0)
    tracer.record_span("verify", leader, 2.0, t1=2.1, authority=0)
    tracer.record_span("dag_add", leader, 2.1, t1=2.2, authority=0)
    tracer.record_span("proposal_wait", leader, 2.2, t1=2.5, authority=0)
    tracer.record_span("commit", leader, 2.5, t1=2.55, authority=0)
    tracer.record_span("finalize", leader, 2.5, t1=2.6, authority=0)
    return _write_trace(path, tracer)


def test_trace_report_critical_path_mode(tmp_path, capsys):
    path = _committed_leader_trace(str(tmp_path / "t.json"))
    assert trace_report.main([path, "--critical-path"]) == 0
    out = capsys.readouterr().out
    assert "1 committed leader observation" in out
    assert "receive" in out and "3" in out  # blocking stage + authority


def test_trace_report_critical_path_no_commits_notes_and_exits_zero(tmp_path, capsys):
    tracer = SpanTracer()
    tracer.record_span("receive", _ref(1, 1, b"\x01"), 0.0, t1=1.0, authority=0)
    path = _write_trace(str(tmp_path / "t.json"), tracer)
    assert trace_report.main([path, "--critical-path"]) == 0
    assert "no committed leaders" in capsys.readouterr().out


def _torn_trace(path):
    tracer = SpanTracer()
    for i in range(5):
        tracer.record_span("commit", _ref(0, i + 1, bytes([i + 1])), float(i),
                           t1=float(i) + 0.5, authority=0)
    tracer.write(path)
    whole = open(path).read()
    # Tear the file mid-event (a SIGKILL landing mid-flush of the .tmp, or a
    # reader racing the writer).
    with open(path, "w") as f:
        f.write(whole[: int(len(whole) * 0.7)])
    return path


def test_trace_report_tolerates_truncated_tail(tmp_path, capsys):
    path = _torn_trace(str(tmp_path / "t.json"))
    assert trace_report.main([path]) == 0
    captured = capsys.readouterr()
    assert "salvaged" in captured.err
    assert "commit" in captured.out


def test_trace_report_empty_trace_exits_zero(tmp_path, capsys):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": []}, f)
    assert trace_report.main([path]) == 0
    assert "no spans" in capsys.readouterr().out


def test_trace_report_missing_file_is_an_error(tmp_path, capsys):
    assert trace_report.main([str(tmp_path / "absent.json")]) == 2


# -- wire format: tag 12, version-skew safe both directions -------------------


def test_timestamped_blocks_roundtrip():
    msg = TimestampedBlocks(
        (b"abc", b"defg"), sent_monotonic_ns=123456789, sent_wall_ns=987654321
    )
    decoded = decode_message(encode_message(msg))
    assert isinstance(decoded, TimestampedBlocks)
    assert isinstance(decoded, Blocks)  # every receive path handles it
    assert decoded.blocks == (b"abc", b"defg")
    assert decoded.sent_monotonic_ns == 123456789
    assert decoded.sent_wall_ns == 987654321


def test_plain_blocks_unchanged_on_wire():
    """New receiver <- old sender: tag 2 frames decode exactly as before."""
    decoded = decode_message(encode_message(Blocks((b"xy",))))
    assert type(decoded) is Blocks
    assert decoded.blocks == (b"xy",)


def test_old_receiver_resets_on_unknown_tag():
    """Old receiver <- new sender: a decoder without the tag 12 branch must
    reject the frame (connection reset), as for every unknown tag."""
    frame = bytearray(encode_message(
        TimestampedBlocks((b"z",), sent_monotonic_ns=1, sent_wall_ns=2)
    ))
    assert frame[0] == 12
    frame[0] = 200
    with pytest.raises(SerdeError):
        decode_message(bytes(frame))


def test_wall_jump_detection():
    """Consecutive frames whose wall delta disagrees with the monotonic delta
    mean the sender's wall clock stepped: the receiver drops that frame's
    transit sample."""
    from mysticeti_tpu_torch.net_sync import WALL_JUMP_TOLERANCE_US
    from mysticeti_tpu_torch.network import wall_jump_us

    t0 = (1_000_000_000, 5_000_000_000)
    steady = (t0[0] + 1_000_000_000, t0[1] + 1_000_000_000)
    assert wall_jump_us(t0, steady) == 0
    slew = (t0[0] + 1_000_000_000, t0[1] + 1_030_000_000)
    assert wall_jump_us(t0, slew) <= WALL_JUMP_TOLERANCE_US
    jumped = (t0[0] + 1_000_000_000, t0[1] + 3_000_000_000)
    assert wall_jump_us(t0, jumped) > WALL_JUMP_TOLERANCE_US
    jumped_back = (t0[0] + 1_000_000_000, t0[1] - 1_000_000_000)
    assert wall_jump_us(t0, jumped_back) > WALL_JUMP_TOLERANCE_US


def test_disseminator_stamps_only_when_knob_on():
    from mysticeti_tpu_torch.config import SynchronizerParameters
    from mysticeti_tpu_torch.synchronizer import BlockDisseminator

    def make(knob):
        return BlockDisseminator(
            connection=None, block_store=None, block_ready=None,
            parameters=SynchronizerParameters(timestamp_frames=knob),
        )

    off = make(False)._blocks_message((b"b",))
    assert type(off) is Blocks
    on = make(True)._blocks_message((b"b",))
    assert isinstance(on, TimestampedBlocks)
    assert on.sent_wall_ns > 0 and on.sent_monotonic_ns > 0


# -- skew estimator: injected offsets recovered ------------------------------


def _synthetic_trace(path, authority, peers, offsets_us, base_delay_us=50_000):
    """One node's trace containing only transit spans: raw transit from peer
    p = base delay + jitter + (own offset - p's offset); one zero-jitter
    frame per link pins the minimum."""
    events = [
        {"args": {"name": f"A{authority}"}, "name": "thread_name",
         "ph": "M", "pid": 1, "tid": authority},
    ]
    for p in peers:
        for i, jitter in enumerate((0, 1_500, 3_000, 700)):
            raw = base_delay_us + jitter + (offsets_us[authority] - offsets_us[p])
            events.append({
                "args": {"block": f"A{p}R{i + 1}#aabbccdd", "src": p, "raw_us": raw},
                "cat": "pipeline", "dur": max(0, raw), "name": "transit", "ph": "X",
                "pid": 1, "tid": authority, "ts": 1_000_000 * (i + 1),
            })
    doc = {"displayTimeUnit": "ms",
           "otherData": {"clock_runtime_us": 0, "clock_wall_us": 0},
           "traceEvents": events}
    with open(path, "w") as f:
        json.dump(doc, f)


_OFFSETS_US = {0: 0, 1: 40_000, 2: -25_000}  # +40 ms, -25 ms against node 0


def _skew_traces(tmp_path):
    paths = []
    for a in range(3):
        path = str(tmp_path / f"trace-{a}.json")
        _synthetic_trace(path, a, [p for p in range(3) if p != a], _OFFSETS_US)
        paths.append(path)
    return paths


def test_skew_estimator_recovers_injected_offsets(tmp_path):
    doc = fleet_trace.merge(_skew_traces(tmp_path))
    skew = doc["skew"]["offsets_us"]
    for a, injected in _OFFSETS_US.items():
        assert abs(skew[str(a)] - injected) <= 2_000, (skew, injected)
    # Corrected link latency lands back on the true delay floor (50 ms).
    for link, row in doc["skew"]["links"].items():
        assert abs(row["latency_min_ms"] - 50.0) <= 2.0, (link, row)


# -- shared stage extraction: truncated multi-node trace ---------------------


def _pipeline_trace_doc():
    events = []
    for a in (0, 1):
        events.append({"args": {"name": f"A{a}"}, "name": "thread_name",
                       "ph": "M", "pid": 1, "tid": a})
    for label, author in (("A0R5#11112222", 0), ("A1R6#33334444", 1)):
        events.append({"args": {"block": label}, "cat": "pipeline", "dur": 10,
                       "name": "propose", "ph": "X", "pid": 1, "tid": author,
                       "ts": 1000})
        for a in (0, 1):
            for i, stage in enumerate(PIPELINE_STAGES):
                if a == author and stage in ("receive", "verify", "dag_add"):
                    continue
                events.append({
                    "args": {"block": label}, "cat": "pipeline",
                    "dur": 100 * (i + 1), "name": stage, "ph": "X",
                    "pid": 1, "tid": a, "ts": 2000 + 1000 * i,
                })
    return {"displayTimeUnit": "ms",
            "otherData": {"clock_runtime_us": 0, "clock_wall_us": 0},
            "traceEvents": events}


def _torn_pipeline_trace(tmp_path):
    full = json.dumps(_pipeline_trace_doc())
    # Tear inside the last event object: both tools must salvage the same
    # complete prefix.
    path = tmp_path / "torn.json"
    path.write_text(full[: full.rfind('{"args"') + 40])
    intact = tmp_path / "full.json"
    intact.write_text(full)
    return str(path), str(intact)


def test_truncated_trace_same_boundaries_in_both_tools(tmp_path):
    """trace_report --critical-path and the fleet merge share one salvage and
    stage-extraction path: a multi-node trace truncated mid-flush yields the
    same committed leaders and per-leader stage sets in both tools."""
    torn, intact = _torn_pipeline_trace(tmp_path)
    events, note = trace_report.load_events(torn)
    assert "truncated" in note
    report_chains = {
        (rec["leader"], rec["track"][1]): set(rec["stages"])
        for rec in trace_report.attribute_critical_paths(trace_report.load_spans(events))
    }
    merged = fleet_trace.merge([torn])
    merge_chains = {}
    for j in merged["journeys"]:
        for a, stages in j["nodes"].items():
            merge_chains[(j["block"], int(a))] = {s for s in stages if s in PIPELINE_STAGES}
    assert set(report_chains) == set(merge_chains)
    for key, stages in report_chains.items():
        assert merge_chains[key] == stages, key
    # And the torn tail really cost something against the intact file.
    assert len(fleet_trace.merge([intact])["journeys"]) >= len(merged["journeys"])


# -- flight recorder unit + dump triggers ------------------------------------


def test_flight_recorder_ring_bounds_and_dump(tmp_path):
    rec = FlightRecorder(authority=3, capacity=4)
    for i in range(7):
        rec.record("evt", i=i)
    assert rec.recorded == 7 and rec.dropped == 3
    events = rec.events()
    assert len(events) == 4 and events[-1]["i"] == 6
    assert rec.events(last=2)[0]["i"] == 5

    path = str(tmp_path / "fr.json")
    written = rec.dump("shutdown", path=path)
    assert written == path and not os.path.exists(path + ".tmp")
    doc = json.loads(open(path).read())
    assert doc["authority"] == 3 and len(doc["events"]) == 4
    assert rec.dumps[0]["trigger"] == "shutdown"
    assert rec.dumps[0]["file"] == "fr.json"  # basenames only (determinism)


def test_flight_recorder_alert_dump_is_debounced(tmp_path):
    path = str(tmp_path / "fr.json")
    rec = FlightRecorder(authority=0, dump_path=path, alert_debounce_s=1e9)
    rec.on_alert("round-stall", None, "receive", 12.0, "stalled")
    assert os.path.exists(path + ".alert")
    os.unlink(path + ".alert")
    rec.on_alert("round-stall", None, "receive", 13.0, "still stalled")
    assert not os.path.exists(path + ".alert")  # inside the debounce window
    assert sum(1 for e in rec.events() if e["kind"] == "slo-alert") == 2


def test_debug_flight_recorder_route(tmp_path):
    async def scenario():
        metrics = Metrics()
        rec = FlightRecorder(authority=7, metrics=metrics)
        rec.record("probe", detail="hello")
        server = await serve_metrics(metrics, "127.0.0.1", 0, flight_recorder=rec)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /debug/flight-recorder HTTP/1.1\r\nHost: t\r\n\r\n")
        await writer.drain()
        payload = await reader.read()
        writer.close()
        server.close()
        await server.wait_closed()
        return payload

    payload = asyncio.run(scenario())
    head, body = payload.split(b"\r\n\r\n", 1)
    assert b"200 OK" in head and b"application/json" in head
    doc = json.loads(body)
    assert doc["authority"] == 7
    assert doc["events"][0]["kind"] == "probe"


# -- fleetmon: flight-recorder embed + --dump-on-red -------------------------


def _fleetmon_args(targets, out, **over):
    args = dict(targets=targets, fleet_dir=None, interval=0.1, duration=0.0, once=True,
                out=out, min_participation=0.0, max_ticks=10, no_dashboard=True,
                dump_on_red=False, max_loop_lag=0.0)
    args.update(over)
    return argparse.Namespace(**args)


def test_fleetmon_dump_on_red(tmp_path):
    async def scenario():
        metrics = Metrics()
        rec = FlightRecorder(authority=0, metrics=metrics)
        rec.record("commit", height=4)
        server = await serve_metrics(metrics, "127.0.0.1", 0, flight_recorder=rec)
        port = server.sockets[0].getsockname()[1]
        args = _fleetmon_args([f"127.0.0.1:{port}", "127.0.0.1:1"],  # node 1 is dead
                              str(tmp_path / "fleetmon.json"), dump_on_red=True)
        rc = await fleetmon.run(args)
        server.close()
        await server.wait_closed()
        return rc

    assert asyncio.run(scenario()) == 3  # the dead node fails the readiness gate
    artifact = json.loads((tmp_path / "fleetmon.json").read_text())
    summary = artifact["flight_recorder"]
    assert summary["0"]["last_events"][-1]["kind"] == "commit"
    assert summary["1"] is None
    dump = tmp_path / "fleetmon.json.flight-0.json"
    assert dump.exists()
    assert artifact["flight_recorder_dumps"] == [dump.name]
    assert json.loads(dump.read_text())["events"][0]["kind"] == "commit"


# -- parity with the JAX repository's tools ----------------------------------


def _run_main(main, argv, capsys):
    rc = main(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _trace_files(tmp_path):
    """Trace files of every shape the tools meet: a committed leader, a
    span-free trace, a torn single-track trace, an intact and a torn
    multi-node pipeline trace, and one node's transit-only trace."""
    files = {"leader": _committed_leader_trace(str(tmp_path / "leader.json")),
             "torn": _torn_trace(str(tmp_path / "torn-one.json"))}
    empty = str(tmp_path / "empty.json")
    with open(empty, "w") as f:
        json.dump({"traceEvents": []}, f)
    files["empty"] = empty
    files["pipeline_torn"], files["pipeline"] = _torn_pipeline_trace(tmp_path)
    files["transit"] = _skew_traces(tmp_path)[1]
    return files


def test_trace_report_output_equals_the_jax_tools(tmp_path, capsys):
    from tools import trace_report as jax_trace_report

    for name, path in _trace_files(tmp_path).items():
        for flags in ([], ["--by-track"], ["--critical-path"]):
            port = _run_main(trace_report.main, [path, *flags], capsys)
            ref = _run_main(jax_trace_report.main, [path, *flags], capsys)
            assert port == ref, (name, flags)
            assert port[0] == 0
    missing = str(tmp_path / "absent.json")
    assert _run_main(trace_report.main, [missing], capsys)[:2] == \
        _run_main(jax_trace_report.main, [missing], capsys)[:2] == (2, "")


def test_fleet_trace_artifact_equals_the_jax_tools(tmp_path, capsys):
    """Summary, waterfall and the ``--out`` artifact's bytes, on the skew
    fixture's three nodes, the pipeline trace intact and torn, and all of
    them together."""
    from tools import fleet_trace as jax_fleet_trace

    files = _trace_files(tmp_path)
    sets = {"skew": _skew_traces(tmp_path), "pipeline": [files["pipeline"]],
            "torn": [files["pipeline_torn"]],
            "all": _skew_traces(tmp_path) + [files["pipeline"], files["leader"]]}
    for name, paths in sets.items():
        outs = []
        for i, main in enumerate((fleet_trace.main, jax_fleet_trace.main)):
            out = str(tmp_path / f"merged-{name}-{i}.json")
            rc, stdout, stderr = _run_main(main, [*paths, "--out", out], capsys)
            with open(out, "rb") as f:
                outs.append((rc, stdout, stderr.replace(out, "<out>"), f.read()))
        assert outs[0] == outs[1], name
        assert outs[0][0] == 0
    for block in ("A0R5", "A9R9"):
        argv = [files["pipeline"], "--block", block]
        assert _run_main(fleet_trace.main, argv, capsys) == \
            _run_main(jax_fleet_trace.main, argv, capsys)


_EXPOSITION = """\
# TYPE threshold_clock_round gauge
threshold_clock_round 41
# TYPE commit_round gauge
commit_round {commit}
# TYPE mysticeti_health_status gauge
mysticeti_health_status {status}
# TYPE mysticeti_health_commit_rate gauge
mysticeti_health_commit_rate 2.5
# TYPE committed_leaders_total counter
committed_leaders_total{{authority="0",status="direct-commit"}} 7
committed_leaders_total{{authority="1",status="direct-commit"}} 6
committed_leaders_total{{authority="2",status="direct-commit"}} 6
# TYPE mysticeti_health_authority_lag_rounds gauge
mysticeti_health_authority_lag_rounds{{authority="1"}} 2
"""


async def _serve_fixed(texts):
    """One HTTP server a text: ``/metrics`` answers the text, every other
    path a 404 (no flight recorder)."""
    servers = []
    for text in texts:
        body = text.encode()

        async def handle(reader, writer, body=body):
            request = await reader.readline()
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            if request.split()[1:2] == [b"/metrics"]:
                head = b"HTTP/1.1 200 OK\r\nContent-Type: text/plain\r\n"
                writer.write(head + b"Content-Length: %d\r\n\r\n" % len(body) + body)
            else:
                writer.write(b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n")
            await writer.drain()
            writer.close()

        servers.append(await asyncio.start_server(handle, "127.0.0.1", 0))
    return servers


@pytest.mark.parametrize("fleet,want_rc", [("healthy", 0), ("degraded", 3), ("down", 3)])
def test_fleetmon_once_snapshot_equals_the_jax_tools(tmp_path, capsys, monkeypatch, fleet,
                                                     want_rc):
    from mysticeti_tpu.orchestrator import hostmon as jax_hostmon
    from mysticeti_tpu_torch.orchestrator import hostmon
    from tools import fleetmon as jax_fleetmon

    class FixedWeather:
        """The host's weather, fixed: both tools embed and print it."""

        def sample(self):
            return {"cpu_pct": 12.5, "load_1m": 0.5, "load_5m": 0.25, "load_15m": 0.125,
                    "mem_available_mb": 2048, "cpu_steal_pct": 0.0, "switch_interval_s": 0.005,
                    "not_weather": 1}

    monkeypatch.setattr(hostmon, "HostSampler", FixedWeather)
    monkeypatch.setattr(jax_hostmon, "HostSampler", FixedWeather)

    statuses = {"healthy": (1, 1, 1), "degraded": (1, 0, 1), "down": (1, 1, 1)}[fleet]
    texts = [_EXPOSITION.format(commit=30 + i, status=s) for i, s in enumerate(statuses)]

    async def scenario():
        servers = await _serve_fixed(texts)
        targets = [f"127.0.0.1:{s.sockets[0].getsockname()[1]}" for s in servers]
        if fleet == "down":
            targets.append("127.0.0.1:1")
        results = []
        try:
            for i, tool in enumerate((fleetmon, jax_fleetmon)):
                out = str(tmp_path / f"fleetmon-{i}.json")
                rc = await tool.run(_fleetmon_args(targets, out, min_participation=0.67))
                printed = capsys.readouterr().out
                with open(out) as f:
                    results.append((rc, printed, json.load(f)))
        finally:
            for s in servers:
                s.close()
                await s.wait_closed()
        return results

    (rc, printed, doc), (jax_rc, jax_printed, jax_doc) = asyncio.run(scenario())
    assert (rc, jax_rc) == (want_rc, want_rc), doc["timeline"][0]
    assert printed == jax_printed
    for d in (doc, jax_doc):
        assert len(d["timeline"]) == 1
        d["timeline"][0].pop("t")
        d.pop("window_utc")
    assert doc == jax_doc
    snapshot = doc["timeline"][0]
    assert snapshot["status"] == ("ok" if want_rc == 0 else "degraded")
    assert len(snapshot["reachable"]) == 3
    assert snapshot["weather"]["load_1m"] == 0.5 and "not_weather" not in snapshot["weather"]
    assert "weather: " in printed
