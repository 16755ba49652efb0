"""The port's batching collector (``BatchedSignatureVerifier``) held to
``tests/test_block_validator.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``), each case with its own margins and
timeouts.  Four of its cases meet the port's one intended departure, that
the collector and the hybrid router take no default backend (the entry
points default to the card, so a default would need one):

- ``test_collection_window_adapts_both_directions`` and
  ``test_collection_window_adapts_to_arrival_rate`` have counterparts
  below, with a backend given, that compare the window with the JAX
  package's; ``test_the_collector_takes_no_default_backend`` asserts the
  departure;
- ``test_hybrid_verifier_fixed_threshold_and_default`` and
  ``test_hybrid_never_offloads_to_a_degraded_backend`` are held by
  ``tests/test_torch_hybrid.py::test_router_scenario`` (with a stub
  backend), and ``test_hybrid_entry_points_raise_without_cuda`` there
  asserts the default's departure.

Beyond the suite, the collector's flush sizes, verdicts, windows and
resolution times under one seeded arrival schedule (each package's
virtual-time simulator, so the loop-clocked window is deterministic) must
equal the JAX package's, and the bad-signature case runs through the main
path's own backend, ``TorchSignatureVerifier(device="cpu")``.
"""
import asyncio
import random
import types

import pytest

from mysticeti_tpu import block_validator as JBV
from mysticeti_tpu import committee as JC
from mysticeti_tpu import types as JT
from mysticeti_tpu.runtime import simulated as JSIM
from mysticeti_tpu_torch import block_validator as PBV
from mysticeti_tpu_torch import committee as PC
from mysticeti_tpu_torch import types as PT
from mysticeti_tpu_torch.runtime import simulated as PSIM
from torch_reference import suite_on_port

globals().update(suite_on_port("test_block_validator.py", leave_out=(
    "test_hybrid_verifier_fixed_threshold_and_default",
    "test_collection_window_adapts_both_directions",
    "test_collection_window_adapts_to_arrival_rate",
    "test_hybrid_never_offloads_to_a_degraded_backend",
)))

SIDES = {
    "jax": types.SimpleNamespace(bv=JBV, committee=JC, types=JT, sim=JSIM),
    "port": types.SimpleNamespace(bv=PBV, committee=PC, types=PT, sim=PSIM),
}


def _collector(side, **kwargs):
    committee = side.committee.Committee.new_for_benchmarks(4)
    return side.bv.BatchedSignatureVerifier(committee, side.bv.CpuSignatureVerifier(), **kwargs)


def window_both_directions(side):
    c = _collector(side)
    trace = [c._effective_delay_s()]
    assert trace[0] == c.max_delay_s  # pre-calibration
    for ema in (0.0005, 0.030, 0.100, 10.0):
        c._dispatch_ema_s = ema
        trace.append(c._effective_delay_s())
    assert trace[1] == c.MIN_ADAPTIVE_DELAY_S
    assert abs(trace[2] - 0.006) < 1e-9
    assert abs(trace[3] - 0.020) < 1e-9
    assert trace[4] == c.MAX_ADAPTIVE_DELAY_S
    return trace


def window_arrival_rate(side):
    c = _collector(side)
    ceiling = c.max_delay_s
    trace = [c._effective_delay_s()]
    assert trace[0] == ceiling
    for gap in (0.0005, ceiling, 0.5):
        c._arrival_gap_ema_s = gap
        trace.append(c._effective_delay_s())
    assert trace[1] == ceiling
    assert trace[2] == pytest.approx(ceiling / 2)
    assert trace[3] == c.MIN_ADAPTIVE_DELAY_S
    c._dispatch_ema_s = 0.100
    for gap in (0.002, 0.5):
        c._arrival_gap_ema_s = gap
        trace.append(c._effective_delay_s())
    assert abs(trace[4] - 0.020) < 1e-9
    assert trace[5] == c.MIN_ADAPTIVE_DELAY_S
    return trace


@pytest.mark.parametrize("case", [window_both_directions, window_arrival_rate],
                         ids=lambda f: f.__name__)
def test_collection_window_as_the_jax_package(case):
    assert case(SIDES["port"]) == case(SIDES["jax"])


def test_the_collector_takes_no_default_backend():
    """The intended departure (ROADMAP C): the JAX collector defaults to
    ``TpuSignatureVerifier()``; the port's requires its backend."""
    jax = JBV.BatchedSignatureVerifier.__init__.__defaults__
    assert None in jax  # verifier=None there
    with pytest.raises(TypeError, match="verifier"):
        PBV.BatchedSignatureVerifier(PC.Committee.new_for_benchmarks(4))


# -- one seeded arrival schedule through both collectors ---------------------

# Arrivals come in same-tick groups (a frame's blocks; a group of 10 fills a
# max_batch window), the groups apart by dense, sparse and idle gaps (the
# last past ARRIVAL_GAP_CAP_S).
GROUPS = (1, 1, 1, 2, 3, 10)
GAPS = (0.0005, 0.002, 0.004, 0.02, 0.3, 1.5)


def _schedule(seed, n=96):
    """(gap before the arrival in virtual s, author, forged) a block."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        gap = rng.choice(GAPS)
        for k in range(rng.choice(GROUPS)):
            out.append((gap if k == 0 else 0.0, rng.randrange(4), rng.random() < 0.15))
    return out[:n]


def collector_run(side, seed, max_batch=8, max_delay_s=0.005):
    """Flush sizes, each arrival's verdict and resolution time, and the
    window armed at each timer, over ``_schedule(seed)``."""
    signers = side.committee.Committee.benchmark_signers(4)
    committee = side.committee.Committee.new_for_benchmarks(4)
    calls, windows = [], []

    class Recording(side.bv.CpuSignatureVerifier):
        def verify_signatures(self, pks, digests, sigs):
            calls.append(len(sigs))
            return super().verify_signatures(pks, digests, sigs)

    class Collector(side.bv.BatchedSignatureVerifier):
        def _schedule_flush(self, loop):
            windows.append(self._effective_delay_s())
            super()._schedule_flush(loop)

    async def main():
        loop = asyncio.get_running_loop()
        collector = Collector(committee, Recording(), max_batch=max_batch,
                              max_delay_s=max_delay_s)
        out = {}

        async def one(i, block):
            try:
                await collector.verify(block)
                verdict = True
            except side.types.VerificationError:
                verdict = False
            out[i] = (verdict, round(loop.time(), 9))

        tasks = []
        for i, (gap, author, forged) in enumerate(_schedule(seed)):
            if gap:
                await asyncio.sleep(gap)
            signer = signers[(author + 1) % 4] if forged else signers[author]
            block = side.types.StatementBlock.build(
                author, 1 + i // 4, [], [side.types.Share(bytes([i]))], signer=signer)
            tasks.append(asyncio.ensure_future(one(i, block)))
        await asyncio.gather(*tasks)
        await collector.flush_now()
        return [out[i] for i in range(len(tasks))], collector._arrival_gap_ema_s

    verdicts, gap_ema = side.sim.run_simulation(main(), seed=seed)
    return {"flushes": calls, "verdicts": verdicts, "windows": windows, "gap_ema": gap_ema}


@pytest.mark.parametrize("seed", range(3))
def test_collector_flushes_as_the_jax_package(seed):
    port = collector_run(SIDES["port"], seed)
    assert port == collector_run(SIDES["jax"], seed)
    # The schedule reached both triggers, and both window regimes.
    assert max(port["flushes"]) == 8 and min(port["flushes"]) < 8
    assert len(set(port["windows"])) > 1
    forged = [forged for _, _, forged in _schedule(seed)]
    assert [not v for v, _ in port["verdicts"]] == forged


def test_bad_signature_through_the_main_paths_backend():
    """``test_batch_collector_rejects_bad_signature`` with the port's card
    backend on the CPU (its wrappers take the plain kernels), against the
    JAX collector's verdicts on the same blocks."""

    def run(side, backend):
        signers = side.committee.Committee.benchmark_signers(4)
        committee = side.committee.Committee(
            [side.committee.Authority(1, s.public_key) for s in signers])

        async def main():
            verifier = side.bv.BatchedSignatureVerifier(
                committee, backend(committee), max_batch=10, max_delay_s=0.01)
            good = side.types.StatementBlock.build(0, 1, [], (), signer=signers[0])
            forged = side.types.StatementBlock.build(1, 1, [], (), signer=signers[0])
            results = await asyncio.gather(verifier.verify(good), verifier.verify(forged),
                                           return_exceptions=True)
            return [None if r is None else type(r).__name__ for r in results]

        return asyncio.run(main())

    port = run(SIDES["port"], lambda committee: PBV.TorchSignatureVerifier(
        committee_keys=committee.public_key_bytes(), device="cpu"))
    assert port == [None, "VerificationError"]
    assert port == run(SIDES["jax"], lambda committee: JBV.CpuSignatureVerifier())
