"""The port's span tracer held to ``tests/test_spans.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``): begin/end pairing, per-authority
tracks, the atomic write and the event cap.  Its ten-node simulation case
(``test_ten_node_sim_trace_report_and_verifier_metrics``) has its
counterpart in ``tests/test_torch_spans_sim.py``.  Beyond the suite, the
same seeded spans (recorded, begun and ended, duplicated and unmatched,
past the cap) must give the JAX package's trace JSON, bar the wall-clock
anchor, and the same completed spans, track names and stage chains when
read back.
"""
import json
import random

import pytest

from mysticeti_tpu import spans as JSP
from mysticeti_tpu import types as JT
from mysticeti_tpu_torch import spans as PSP
from mysticeti_tpu_torch import types as PT
from torch_reference import suite_on_port

globals().update(suite_on_port("test_spans.py", leave_out=(
    "test_ten_node_sim_trace_report_and_verifier_metrics",)))

SIDES = {"jax": (JSP, JT), "port": (PSP, PT)}
STAGES = ("receive", "verify_pack", "verify_dispatch", "dag_add", "commit")


def span_trace(side, seed, path):
    spans, types = SIDES[side]
    rng = random.Random(seed)
    tracer = spans.SpanTracer()
    tracer.MAX_EVENTS = 60
    refs = [types.BlockReference(rng.randrange(4), rng.randrange(1, 30),
                                 bytes([rng.randrange(256)]) * 32) for _ in range(12)]
    t = 0.0
    for _ in range(200):
        t += rng.choice((0.0, 0.0001, 0.003, 0.25))
        stage, ref = rng.choice(STAGES), rng.choice(refs)
        authority = rng.choice((None, 0, 1, 2, 3))
        kind = rng.random()
        if kind < 0.4:
            tracer.record_span(stage, ref, t, t1=t + rng.random() / 10, authority=authority)
        elif kind < 0.75:
            tracer.begin_span(stage, ref, authority=authority, t=t)
        else:
            tracer.end_span(stage, ref, authority=authority, t=t)
    tracer.write(path)
    with open(path) as f:
        written = json.load(f)
    anchor = written.pop("otherData")
    assert set(anchor) == {"clock_runtime_us", "clock_wall_us"}
    events = written["traceEvents"]
    complete = spans.complete_spans(events)
    return (written, tracer.dropped, complete, sorted(spans.track_names(events).items()),
            sorted(spans.stage_chains(complete, STAGES).items()), spans.format_ref(refs[0]))


@pytest.mark.parametrize("seed", range(4))
def test_trace_json_as_the_jax_package(tmp_path, seed):
    port = span_trace("port", seed, str(tmp_path / "port.json"))
    assert port == span_trace("jax", seed, str(tmp_path / "jax.json"))
    assert port[1] > 0  # the cap dropped some
