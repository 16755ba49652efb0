"""The port's verification pipelines held to ``tests/test_verify_pipeline.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``): the receive pipeline's overlap and
in-flight dedup in ``net_sync``, and the staged dispatch pipeline
(``verify_pipeline.VerifyPipeline`` behind ``BatchedSignatureVerifier``):
overlap against the serial baseline, verdicts on the right futures under
interleaved flushes, zero lost futures when the backend dies mid-pipeline,
depth adaptation, and a cancelled flush abandoning its handle; each case
with the reference's own margins and timeouts.

Beyond the suite, the pipeline's depth over a sweep of fixed costs, and
the order and virtual times at which a seeded set of dispatches takes and
leaves its slots (each package's simulator), must equal the JAX package's.
"""
import asyncio
import random

import pytest

from mysticeti_tpu import verify_pipeline as JVP
from mysticeti_tpu.runtime import simulated as JSIM
from mysticeti_tpu_torch import verify_pipeline as PVP
from mysticeti_tpu_torch.runtime import simulated as PSIM
from torch_reference import suite_on_port

globals().update(suite_on_port("test_verify_pipeline.py"))

SIDES = {"jax": (JVP, JSIM), "port": (PVP, PSIM)}


def depth_sweep(vp):
    cost = {"s": 0.0}
    pipeline = vp.VerifyPipeline(fixed_cost_fn=lambda: cost["s"])
    out = []
    for s in (0.0, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.03, 0.05, 0.08, 0.12, 1.0, None):
        cost["s"] = s
        out.append(pipeline.depth())
    out += [vp.VerifyPipeline(depth=d).depth() for d in (0, 1, 3, 7)]
    return out + [vp.VerifyPipeline.MIN_DEPTH, vp.VerifyPipeline.MAX_DEPTH]


def test_depth_as_the_jax_package():
    assert depth_sweep(PVP) == depth_sweep(JVP)


def slot_schedule(side, seed, depth):
    """``n`` dispatches arriving at seeded virtual times, each holding its
    slot for a seeded virtual latency: (dispatch, event, virtual time) in
    the order the slots were taken and left, and the engine's peak."""
    vp, sim = SIDES[side]
    rng = random.Random(seed)
    arrivals = [(rng.choice((0.0, 0.001, 0.01)), rng.choice((0.002, 0.02, 0.1)))
                for _ in range(24)]

    async def main():
        loop = asyncio.get_running_loop()
        pipeline = vp.VerifyPipeline(depth=depth)
        events = []

        async def dispatch(i, latency):
            async with pipeline.slot():
                events.append((i, "in", round(loop.time(), 9), pipeline.inflight))
                await asyncio.sleep(latency)
            events.append((i, "out", round(loop.time(), 9)))

        tasks = []
        for i, (gap, latency) in enumerate(arrivals):
            await asyncio.sleep(gap)
            tasks.append(asyncio.ensure_future(dispatch(i, latency)))
        await asyncio.gather(*tasks)
        return events, pipeline.max_inflight, pipeline.inflight

    return sim.run_simulation(main(), seed=seed)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("seed", range(2))
def test_slots_as_the_jax_package(seed, depth):
    port = slot_schedule("port", seed, depth)
    assert port == slot_schedule("jax", seed, depth)
    events, peak, left = port
    assert peak == depth and left == 0
    assert max(e[3] for e in events if e[1] == "in") == depth
