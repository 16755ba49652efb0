"""``chip_smoke.py``'s step 19 (watch and trace the fleet) on the CPU.

``watch_phase`` runs the port's tools as children (``trace_report`` plain and
with ``--critical-path``, ``fleet_trace --out``, ``trace_report`` over the
metrics step's trace, the lint) over what a traced run leaves: one trace a
node and fleetmon's timeline.  Here the run is four stand-in nodes: each
node's trace is written by the port's ``SpanTracer`` with the pipeline's
spans for three committed leaders and the transit spans between the nodes,
and each node's ``/metrics`` is a fixed exposition that the port's fleetmon
(``--once``) and the phase's own health sample both read.  Then
``watch_checks`` fails each fault it must catch.
"""
import asyncio
import contextlib
import copy
import io
import json
import os

import pytest

import chip_smoke
from mysticeti_tpu_torch.health import cluster_snapshot_from_texts
from mysticeti_tpu_torch.orchestrator import MeasurementsCollection
from mysticeti_tpu_torch.spans import PIPELINE_STAGES, SpanTracer
from mysticeti_tpu_torch.tools import fleet_trace, fleetmon, trace_report
from mysticeti_tpu_torch.types import BlockReference
from test_torch_trace_tools import _fleetmon_args, _serve_fixed

N = 4
CONFIG = dict(chip_smoke.ORCHESTRATOR_10, n=N)
PIDS = {a: 4100 + a for a in range(N)}

EXPOSITION = """\
# TYPE threshold_clock_round gauge
threshold_clock_round 12
# TYPE commit_round gauge
commit_round {commit}
# TYPE mysticeti_health_status gauge
mysticeti_health_status 0
# TYPE committed_leaders_total counter
{leaders}"""


def _texts():
    leaders = "".join(f'committed_leaders_total{{authority="{a}",status="direct-commit"}} 3\n'
                      for a in range(N))
    return [EXPOSITION.format(commit=9 + a % 2, leaders=leaders) for a in range(N)]


def _write_traces(wd):
    """One trace a node: node a proposes its round-r block, receives,
    verifies and adds the others' (with a transit span from their author),
    and commits and finalizes the round's leader."""
    paths = []
    for a in range(N):
        tracer = SpanTracer()
        for r in (1, 2, 3):
            leader = BlockReference(r % N, r, bytes([r % N, r]).ljust(32, b"\x00"))
            t = float(r)
            for author in range(N):
                ref = BlockReference(author, r, bytes([author, r]).ljust(32, b"\x00"))
                if author == a:
                    tracer.record_span("propose", ref, t, t1=t + 0.001, authority=a)
                    continue
                tracer.record_span("transit", ref, t, t1=t + 0.01, authority=a,
                                   extra={"src": author, "raw_us": 10_000 + 100 * (a - author)})
                tracer.record_span("receive", ref, t + 0.01, t1=t + 0.02, authority=a)
                tracer.record_span("verify", ref, t + 0.02, t1=t + 0.03, authority=a)
                tracer.record_span("dag_add", ref, t + 0.03, t1=t + 0.04, authority=a)
            tracer.record_span("proposal_wait", leader, t + 0.04, t1=t + 0.5, authority=a)
            tracer.record_span("commit", leader, t + 0.5, t1=t + 0.55, authority=a)
            tracer.record_span("finalize", leader, t + 0.55, t1=t + 0.6, authority=a)
        path = os.path.join(wd, f"trace-{PIDS[a]}.json")
        tracer.write(path)
        paths.append(path)
    return paths


def _fleetmon_once(wd):
    async def scenario():
        servers = await _serve_fixed(_texts())
        try:
            args = _fleetmon_args(
                [f"127.0.0.1:{s.sockets[0].getsockname()[1]}" for s in servers],
                os.path.join(wd, "fleetmon.json"), interval=2.0, min_participation=0.67,
                max_loop_lag=0.25)
            with contextlib.redirect_stdout(io.StringIO()):
                return await fleetmon.run(args)
        finally:
            for s in servers:
                s.close()
                await s.wait_closed()

    return asyncio.run(scenario())


def _collection():
    texts = {str(a): t for a, t in enumerate(_texts())}
    c = MeasurementsCollection({"nodes": N, "load": 400})
    c.add_health_sample(cluster_snapshot_from_texts(texts, N))
    return c


def _tool(main, *argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _smoke_trace(wd):
    tracer = SpanTracer()
    ref = BlockReference(0, 1, b"\x01".ljust(32, b"\x00"))
    for i, stage in enumerate(("verify_pack", "verify_device", "verify_fetch", "verify_dispatch")):
        tracer.record_span(stage, ref, 0.0, t1=0.001 * (i + 1), authority=0)
    path = os.path.join(wd, "chip_smoke_trace.json")
    tracer.write(path)
    return path


@pytest.fixture
def healthy(tmp_path):
    """The inputs of ``watch_checks`` for a healthy traced run, computed by
    the port's tools in this process (the lint's output stands in)."""
    wd = str(tmp_path)
    paths = _write_traces(wd)
    rc = _fleetmon_once(wd)
    with open(os.path.join(wd, "fleetmon.json")) as f:
        doc = json.load(f)
    run = {"pids": dict(PIDS), "fleetmon_rc": rc, "fleetmon_doc": doc,
           "last_scrape_wall": doc["window_utc"][0] + doc["timeline"][-1]["t"]}
    traces = {}
    for p in paths:
        with open(p) as f:
            traces[p] = json.load(f)
    node0 = os.path.join(wd, f"trace-{PIDS[0]}.json")
    out = os.path.join(wd, "merged.json")
    assert _tool(fleet_trace.main, *paths, "--out", out)[0] == 0
    with open(out) as f:
        merged = json.load(f)
    return {
        "wd": wd, "run": run, "collection": _collection(), "traces": traces,
        "report": _tool(trace_report.main, node0),
        "critical": _tool(trace_report.main, node0, "--critical-path"),
        "merged": merged, "lint": (0, "mysticeti-lint: 0 new finding(s) over 1 path(s)\n", ""),
        "smoke": _tool(trace_report.main, _smoke_trace(wd)),
    }


def _checks(inputs):
    return chip_smoke.watch_checks(
        inputs["run"], inputs["collection"], CONFIG, inputs["traces"], inputs["report"],
        inputs["critical"], inputs["merged"], inputs["lint"], inputs["smoke"])


def test_watch_phase_runs_the_tools_as_children(healthy):
    """The step as the script runs it: the tools and the lint as children
    of this interpreter, on the working directory's files."""
    wd, run = healthy["wd"], dict(healthy["run"])
    run.pop("fleetmon_doc")
    reading = chip_smoke.watch_phase(run, healthy["collection"], CONFIG, wd,
                                     os.path.join(wd, "chip_smoke_trace.json"))
    assert reading["fleetmon_rc"] == 3 and reading["fleetmon_status"] == "degraded"
    assert reading["traces"] == N and set(PIPELINE_STAGES) <= set(reading["stages"])
    assert reading["critical_path_leaders"] == 3  # node 0 observes three leaders
    assert reading["journeys"] == 3 and reading["max_abs_skew_ms"] > 0
    assert "verify_dispatch" in reading["smoke_trace_stages"]
    assert reading["lint"].endswith("0 new finding(s) over 1 path(s)")
    assert reading["lint_s"] > 0


def test_watch_checks_pass_a_healthy_run(healthy):
    reading = _checks(healthy)
    assert reading["fleetmon_rc"] == 3  # the stand-in nodes read degraded
    assert reading["fleetmon_last"] == reading["phase_last"]
    assert reading["traces"] == N and reading["journeys"] == 3
    # The skew fixture: node a's transit from b reads 100 us x (a - b) over
    # a symmetric floor, which min-transit alignment reads as node a's clock
    # 100 us x a ahead of node 0's.
    assert reading["max_abs_skew_ms"] == pytest.approx(0.3, abs=1e-3)


def _fault(inputs, path, value):
    out = copy.deepcopy(inputs)
    target = out
    for key in path[:-1]:
        target = target[key]
    if callable(value):
        target[path[-1]] = value(target[path[-1]])
    else:
        target[path[-1]] = value
    return out


def _drop_journey_commits(merged):
    for j in merged["journeys"]:
        for stages in j["nodes"].values():
            stages.pop("commit", None)
    return merged


FAULTS = {
    "reached": (("run", "fleetmon_doc", "timeline", -1, "reachable"), ["0", "1", "2"]),
    "exited 0 on a last snapshot of status degraded": (("run", "fleetmon_rc"), 0),
    "exited None": (("run", "fleetmon_rc"), None),
    "no fleetmon snapshot within": (
        ("run", "fleetmon_doc", "timeline", -1, "quorum_participation"), 0.5),
    "agrees with it": (("run", "last_scrape_wall"), lambda t: t + 60.0),
    "wrote no timeline": (("run", "fleetmon_doc"), None),
    "trace files": (("run", "pids", 3), 1),
    "do not parse": (("traces",), lambda t: {**t, next(iter(t)): "JSONDecodeError()"}),
    "stage table holds": (("report",), (0, "stage  count\nreceive 1\n", "")),
    "trace_report exited": (("report",), (2, "", "error: cannot read trace")),
    "attributes no committed leader": (("critical",), (0, "no committed leaders in trace", "")),
    "skew table covers": (("merged", "skew", "offsets_us"), lambda o: {"0": 0.0, "1": 1.0}),
    "none a committed leader's": (("merged",), _drop_journey_commits),
    "no transit sample": (("merged", "transit_observations"), 0),
    "wrote no artifact": (("merged",), None),
    "the port's lint exited": (("lint",), (1, "x.py:1:0: wall-clock: ...\n"
                                              "mysticeti-lint: 1 new finding(s)", "")),
    "metrics step's trace": (("smoke",), (0, "no spans in trace\n", "")),
}


@pytest.mark.parametrize("message", sorted(FAULTS))
def test_watch_checks_catch_each_fault(healthy, message):
    path, value = FAULTS[message]
    with pytest.raises(chip_smoke.SmokeFailure, match=message.replace("(", r"\(")):
        _checks(_fault(healthy, path, value))


def test_report_stages_reads_the_stage_column():
    table = "stage      count  p50_ms\nreceive        3   1.000\ncommit 3 2.0\n"
    assert chip_smoke.report_stages(table) == ["receive", "commit"]
    assert chip_smoke.report_stages("no spans in trace") == []
