"""The port's deterministic virtual-time loop, against the JAX package's.

The cases of ``tests/test_runtime_sim.py`` on the port's loop; one seeded
program (timers, events, queues, RNG draws, ``runtime`` clocks) on both
packages' loops giving the same event order, virtual times and draws; the
runtime facade under and outside the loop; and the batching collector under
the loop: inline dispatch (no executor hop), an unseeded dispatch EMA, and
flush times and batch sizes that one seed reproduces.
"""
import asyncio
import importlib
import time

import pytest

from mysticeti_tpu_torch import runtime
from mysticeti_tpu_torch.runtime.simulated import _BASE_UTC, DeterministicLoop, run_simulation

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")


def test_virtual_sleep_is_instant_and_exact():
    async def main():
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await asyncio.sleep(3600.0)  # one virtual hour
        return loop.time() - t0

    wall0 = time.monotonic()
    elapsed_virtual = run_simulation(main())
    assert abs(elapsed_virtual - 3600.0) < 1e-6
    assert time.monotonic() - wall0 < 5.0  # no real waiting


def test_timer_ordering_deterministic():
    async def main():
        loop = asyncio.get_running_loop()
        events = []

        async def ticker(name, period, count):
            for _ in range(count):
                await asyncio.sleep(period)
                events.append((round(loop.time(), 6), name))

        await asyncio.gather(ticker("a", 0.3, 5), ticker("b", 0.5, 3))
        return events

    first = run_simulation(main(), seed=1)
    assert first == run_simulation(main(), seed=1)
    assert first[0] == (0.3, "a")
    assert (1.5, "b") in first


def test_asyncio_primitives_work():
    async def main():
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        ev = asyncio.Event()
        results = []

        async def producer():
            for i in range(3):
                await asyncio.sleep(0.1)
                await q.put(i)
            ev.set()

        async def consumer():
            while not (ev.is_set() and q.empty()):
                try:
                    item = await asyncio.wait_for(q.get(), timeout=0.05)
                    results.append((round(loop.time(), 6), item))
                except asyncio.TimeoutError:
                    continue
            return results

        _, res = await asyncio.gather(producer(), consumer())
        return res

    res = run_simulation(main())
    assert [item for _, item in res] == [0, 1, 2]
    assert res[0][0] >= 0.1


def test_seeded_rng_on_loop():
    async def main():
        loop = asyncio.get_running_loop()
        return [loop.rng.randrange(1000) for _ in range(5)]

    assert run_simulation(main(), seed=42) == run_simulation(main(), seed=42)
    assert run_simulation(main(), seed=42) != run_simulation(main(), seed=43)


def test_virtual_timeout():
    async def main():
        await asyncio.sleep(10**6)

    with pytest.raises(asyncio.TimeoutError):
        run_simulation(main(), timeout_s=100.0)


def test_utc_time_offset():
    async def main():
        t0 = runtime.timestamp_utc()
        await asyncio.sleep(12.5)
        return runtime.timestamp_utc() - t0

    assert abs(run_simulation(main()) - 12.5) < 1e-6


def test_runtime_facade_under_and_outside_the_loop():
    async def main():
        loop = asyncio.get_running_loop()
        await runtime.sleep(2.0)
        task = runtime.spawn(asyncio.sleep(0.5, result="spawned"))
        return (isinstance(loop, DeterministicLoop), runtime.is_simulated(), runtime.now(),
                runtime.timestamp_utc(), await task, runtime.now())

    assert run_simulation(main()) == (True, True, 2.0, _BASE_UTC + 2.0, "spawned", 2.5)
    assert not runtime.is_simulated()
    assert abs(runtime.timestamp_utc() - time.time()) < 5.0

    async def real():
        return runtime.is_simulated(), runtime.now()

    simulated, now = asyncio.run(real())
    assert not simulated and abs(now - time.monotonic()) < 5.0


async def _program(pkg):
    """A seeded program over timers, events, queues, RNG draws and the
    runtime clocks; returns what happened, in order."""
    rt = importlib.import_module(f"{pkg}.runtime")
    loop = asyncio.get_running_loop()
    log = []
    q: asyncio.Queue = asyncio.Queue()
    ev = asyncio.Event()

    async def worker(name):
        for _ in range(4):
            await rt.sleep(loop.rng.random())
            log.append((name, "tick", rt.now(), rt.timestamp_utc(), loop.rng.randrange(10**6)))
            await q.put((name, rt.now()))
        if name == "c":
            ev.set()

    async def consumer():
        while not (ev.is_set() and q.empty()):
            try:
                item = await asyncio.wait_for(q.get(), timeout=0.2)
                log.append(("got",) + item + (rt.now(),))
            except asyncio.TimeoutError:
                log.append(("timeout", rt.now()))

    def timer(i):
        log.append(("timer", i, loop.time()))

    for i in range(5):
        loop.call_later(loop.rng.uniform(0.0, 3.0), timer, i)
    await asyncio.gather(*(rt.spawn(worker(n)) for n in "abc"), consumer())
    return log, rt.is_simulated()


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_one_program_on_both_loops_gives_the_same_run(seed):
    jax_run = importlib.import_module("mysticeti_tpu.runtime.simulated").run_simulation
    port, port_sim = run_simulation(_program("mysticeti_tpu_torch"), seed=seed)
    want, want_sim = jax_run(_program("mysticeti_tpu"), seed=seed)
    assert port_sim and want_sim
    assert len(port) > 20
    assert port == want  # order, virtual times, UTC stamps and draws: exact


# -- the collector under the loop ------------------------------------------


class _Recording:
    """A signature backend that records the loop time and batch size of each
    dispatch it is handed, then delegates."""

    def __init__(self, inner):
        self.inner = inner
        self.flushes = []

    def verify_signatures_async(self, public_keys, digests, signatures):
        self.flushes.append((asyncio.get_running_loop().time(), len(signatures)))
        return self.inner.verify_signatures_async(public_keys, digests, signatures)


def _blocks(n_auth, rounds):
    """Signed blocks of a benchmark committee, with two tampered signatures."""
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.types import Share, StatementBlock

    signers = Committee.benchmark_signers(n_auth)
    prev = [StatementBlock.new_genesis(a).reference for a in range(n_auth)]
    raws = []
    for rnd in range(1, rounds + 1):
        refs = []
        for a in range(n_auth):
            block = StatementBlock.build(a, rnd, prev, [Share(bytes([a, rnd]))], signer=signers[a])
            refs.append(block.reference)
            raw = bytearray(block.to_bytes())
            if (rnd, a) in ((1, 2), (3, 0)):
                raw[-1] ^= 1
            raws.append(bytes(raw))
        prev = refs
    return raws


async def _arrivals(collector, raws):
    """The blocks arrive one by one at seeded virtual times; each awaits the
    collector; returns the verdicts in block order."""
    from mysticeti_tpu_torch.types import StatementBlock, VerificationError

    loop = asyncio.get_running_loop()
    verdicts = [None] * len(raws)

    async def arrive(i):
        await asyncio.sleep(loop.rng.uniform(0.0, 0.04))
        try:
            await collector.verify(StatementBlock.from_bytes(raws[i]))
            verdicts[i] = True
        except VerificationError:
            verdicts[i] = False

    await asyncio.gather(*(arrive(i) for i in range(len(raws))))
    return verdicts, collector._dispatch_ema_s


def test_collector_dispatches_inline_under_the_loop(monkeypatch):
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier, TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee

    def no_executor(self, *args, **kwargs):
        raise AssertionError("the collector hopped to an executor under the simulator")

    monkeypatch.setattr(DeterministicLoop, "run_in_executor", no_executor)
    committee = Committee.new_for_benchmarks(4)
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes(), device="cpu")
    raws = _blocks(4, 3)
    runs = []
    for _ in range(2):
        recording = _Recording(backend)
        collector = BatchedSignatureVerifier(committee, recording, max_delay_s=0.02)
        verdicts, ema = run_simulation(_arrivals(collector, raws), seed=11)
        runs.append((verdicts, ema, recording.flushes))
    (verdicts, ema, flushes), second = runs
    want = [not (i in (2, 8)) for i in range(len(raws))]
    assert verdicts == want
    assert ema == 0.0  # wall-clock dispatch times never reach the window
    assert 1 < len(flushes) <= 4 and sum(n for _, n in flushes) == len(raws)
    assert second == runs[0]  # same flush times and batch sizes, same verdicts
