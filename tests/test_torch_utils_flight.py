"""The port's ``utils/dag``, ``utils/lock`` and ``flight_recorder``, against
the JAX package's.

The DAG DSL strings of the reference's block-manager, block-store,
threshold-clock and types tests parse into the same references; a
``MonitoredLock`` feeds the same ``utilization_timer`` series; a flight
recorder fed the same events on the virtual clock holds the same ring.
"""
import asyncio
import importlib

import pytest

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")

# The DSL strings of tests/test_block_manager.py, test_block_store.py,
# test_threshold_clock.py and test_types.py.
_TC_PREFIX = "A1:[A0,B0,C0]; B1:[A0,B0,C0]; C1:[A0,B0,C0]; "
DAGS = [
    "A1:[A0, B0]; B1:[A0, B0]; B2:[A0, B1]; A2:[A1, B2]",
    "A1:[A0, B0]; B1:[A0, B0]; B2:[A0, B1]; A2:[A1, B1]",
    "A1:[A0, B0]; B1:[A0, B0]; A2:[A1, B1]",
    "A1:[A0,B0,C0]; B1:[A0,B0,C0]; A2:[A1,B1]",
    "A1:[A0,B0,C0]; B1:[A0,B0,C0]; C1:[A0,B0,C0];A2:[A1,B1]; B2:[B1,C1]",
    "A1:[A0,B0,C0]; B1:[A0,B0,C0]; A2:[A1,B1]; B2:[A1,B1]; A3:[A2,B2]",
    "A1:[A0,B0,C0]; B1:[A0,B0,C0]; C1:[A0,B0,C0]; A2:[A1,B1,C1]",
    "A1:[A0,B0,C0]; B1:[A0,B0,C0]",
    "A1:[A0,B0,C0]; B1:[A0,B0,C0,D0]; A2:[A1,B1]",
] + [_TC_PREFIX + dsl for dsl in (
    "A1:[A0, B0]", "A1:[A0, B0, C0]", "A1:[A0, B0, C0, D0]",
    "A2:[A1, B1, C0, D0]", "A2:[A1, B1, C1, D0]",
)]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _refs(dag):
    return {name: (b.reference.authority, b.reference.round, b.reference.digest, b.to_bytes())
            for name, b in dag.blocks.items()}


@pytest.mark.parametrize("dsl", DAGS)
def test_dag_dsl_builds_the_same_blocks(dsl):
    got = {pkg: _refs(_mod(pkg, "utils.dag").Dag.draw(dsl)) for pkg in PACKAGES}
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    block = _mod("mysticeti_tpu_torch", "utils.dag").Dag.draw_block(dsl)
    want = _mod("mysticeti_tpu", "utils.dag").Dag.draw_block(dsl)
    assert block.to_bytes() == want.to_bytes()


@pytest.mark.parametrize("bad", ["A2:[A1]", "A1 [A0]", "A1:[A0, b0]"])
def test_dag_dsl_refuses_what_the_jax_module_refuses(bad):
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            _mod(pkg, "utils.dag").Dag.draw(bad)


def _lock_series(pkg):
    metrics = _mod(pkg, "metrics").Metrics()
    lock = _mod(pkg, "utils.lock").MonitoredLock("block_cache", metrics)

    async def holder(delay):
        async with lock:
            await asyncio.sleep(delay)

    async def main():
        await asyncio.gather(holder(0.02), holder(0.0), holder(0.01))

    asyncio.run(main())
    samples = {
        s.labels["proc"]: s.value
        for family in metrics.registry.collect() if family.name == "utilization_timer"
        for s in family.samples if s.name.endswith("_total")
    }
    return samples, lock


def test_monitored_lock_feeds_the_utilization_timer():
    """Wait and hold time land on ``utilization_timer{proc="lock_wait/…"}``
    and ``{proc="lock_hold/…"}`` in both packages; the waits of the second
    and third holders and the held sleeps show up as time."""
    port, lock = _lock_series("mysticeti_tpu_torch")
    jax, _ = _lock_series("mysticeti_tpu")
    assert sorted(port) == sorted(jax) == ["lock_hold/block_cache", "lock_wait/block_cache"]
    assert port["lock_hold/block_cache"] >= 25_000  # µs: 20 ms + 10 ms held
    assert port["lock_wait/block_cache"] >= 20_000
    assert lock.hold_total_s >= 0.025 and lock.wait_total_s >= 0.02


async def _record(pkg, capacity):
    rec = _mod(pkg, "flight_recorder").FlightRecorder(authority=3, capacity=capacity)
    rec.record("peer-connect", peer=1)
    await asyncio.sleep(0.25)
    rec.record("invalid-block", authority=2, reason="signature", count=1, note=None)
    rec.record("leader-timeout", round=7)
    await asyncio.sleep(1.5)
    rec.record("helper-ask", authority=0, helper=2)
    rec.record("epoch-skew", peer=4, peer_epoch=1, local_epoch=0)
    rec.record("peer-disconnect", peer=1)
    return rec.events(), rec.events(last=2), rec.recorded, rec.dropped, rec.capacity


@pytest.mark.parametrize("capacity", [0, 4, 4096])
def test_flight_recorder_records_the_same_ring(capacity):
    """Same events on each package's virtual clock: the same ring (None
    fields left out, times on the virtual clock), the same last events and
    the same count of events that fell off a full ring."""
    got = {pkg: _mod(pkg, "runtime.simulated").run_simulation(_record(pkg, capacity), seed=1)
           for pkg in PACKAGES}
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    ring, last, recorded, dropped, held = got["mysticeti_tpu_torch"]
    assert held == max(1, capacity) and recorded == 6 and dropped == 6 - min(6, held)
    assert [e["kind"] for e in last] == ["epoch-skew", "peer-disconnect"][-held:]
    assert len(ring) == min(6, held) and ring[-1] == {"t": 1.75, "kind": "peer-disconnect",
                                                      "peer": 1}
    if held >= 6:
        assert ring[1] == {"t": 0.25, "kind": "invalid-block", "authority": 2,
                           "reason": "signature", "count": 1}
