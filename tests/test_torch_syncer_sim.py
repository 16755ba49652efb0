"""The syncer-tier deterministic simulation on the port, against the JAX package.

The harness of ``tests/test_syncer_sim.py`` (N ``Syncer``s in one process,
each new own block delivered to every peer after a seeded latency, leader
timeouts and a relay pump) runs once on each package's loop with the same
seed; the committed-leader sequences must be equal, leader for leader.
Then ``chip_smoke.py``'s consensus phase in small: every delivery verified
through a ``cuda-only`` collector on the CPU (the kernels' plain versions),
one forged copy rejected, and the same run over the ``cpu`` kind giving the
same sequences and own blocks.
"""
import asyncio
import importlib
import tempfile

import pytest

import chip_smoke
from test_torch_core import _open_core

WAVE = 3
LEADER_TIMEOUT_S = 1.0


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


async def _run_syncers(pkg, n, tmp_dir, virtual_seconds):
    """``tests/test_syncer_sim.py``'s ``_run_syncers`` over either package:
    a seeded 100-1800 ms latency per delivery."""
    Committee = _mod(pkg, "committee").Committee
    types = _mod(pkg, "types")
    loop = asyncio.get_event_loop()
    rng = loop.rng
    committee = Committee.new_test([1] * n)
    signers = Committee.benchmark_signers(n)
    everyone = types.AuthoritySet()
    for a in range(n):
        everyone.insert(a)
    syncers = []
    for a in range(n):
        core = _open_core(pkg, committee, a, f"{tmp_dir}/{pkg}", signers[a])
        observer = _mod(pkg, "commit_observer").TestCommitObserver(core.block_store, committee)
        syncers.append(_mod(pkg, "syncer").Syncer(
            core, WAVE, _mod(pkg, "net_sync").AsyncSignals(), observer))
    cursors = [[0] * n for _ in range(n)]

    def relay_from(src):
        for dst in range(n):
            if dst == src:
                continue
            blocks = syncers[src].core.block_store.get_own_blocks(cursors[src][dst], 100)
            if not blocks:
                continue
            cursors[src][dst] = max(b.round() for b in blocks)
            delay = 0.1 + rng.random() * 1.7
            loop.call_later(delay, deliver, dst, [b.to_bytes() for b in blocks])

    def deliver(dst, raws):
        blocks = [types.StatementBlock.from_bytes(r) for r in raws]
        syncers[dst].add_blocks(blocks, everyone.copy())
        relay_from(dst)

    async def leader_timeout(idx):
        syncer = syncers[idx]
        while True:
            waiter = syncer.signals.round_notify.subscribe()
            round_at_start = syncer.signals.current_round
            try:
                await asyncio.wait_for(waiter.wait(), timeout=LEADER_TIMEOUT_S)
            except asyncio.TimeoutError:
                syncer.force_new_block(round_at_start + 1, everyone.copy())
                relay_from(idx)

    async def pump(idx):
        while True:
            await asyncio.sleep(0.25)
            relay_from(idx)

    for idx, s in enumerate(syncers):
        s.force_new_block(1, everyone.copy())
        relay_from(idx)
    tasks = [asyncio.ensure_future(leader_timeout(i)) for i in range(n)] + [
        asyncio.ensure_future(pump(i)) for i in range(n)]
    await asyncio.sleep(virtual_seconds)
    for t in tasks:
        t.cancel()
    return [list(s.commit_observer.committed_leaders) for s in syncers], [
        [b.to_bytes() for b in s.core.block_store.get_own_blocks(0, 10**6)] for s in syncers]


def _sim(pkg, tmp_path, seed, n=4, virtual_seconds=30.0):
    d = tmp_path / f"s{seed}"
    (d / pkg).mkdir(parents=True)
    run = _mod(pkg, "runtime.simulated").run_simulation
    return run(_run_syncers(pkg, n, str(d), virtual_seconds), seed=seed)


@pytest.mark.parametrize("seed", range(10))
def test_randomized_syncers_commit_as_the_jax_package(tmp_path, seed):
    sequences, own = _sim("mysticeti_tpu_torch", tmp_path, seed)
    assert all(len(seq) >= 8 for seq in sequences), [len(s) for s in sequences]
    longest = max(sequences, key=len)
    for seq in sequences:
        assert seq == longest[: len(seq)], f"fork: {seq} vs {longest}"
    want_sequences, want_own = _sim("mysticeti_tpu", tmp_path, seed)
    assert [[(r.authority, r.round, r.digest) for r in seq] for seq in sequences] == [
        [(r.authority, r.round, r.digest) for r in seq] for seq in want_sequences]
    assert own == want_own  # every node's own blocks, byte for byte


def _consensus_in_small(kind, backend=None, metrics=None):
    """``chip_smoke.consensus_sim`` at n = 4 for 1.5 virtual s, one forged
    copy in 6 deliveries, each node's collector with a 100 ms window:
    ``cuda-only`` over ``backend``, or the ``cpu`` kind."""
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    def make_collector(committee):
        if kind == "cpu":
            collector = _make_verifier("cpu", committee)
        else:
            collector = BatchedSignatureVerifier(committee, backend, metrics=metrics)
        collector.max_delay_s = 0.1
        return collector

    with tempfile.TemporaryDirectory(prefix="consensus-") as d:
        return run_simulation(chip_smoke.consensus_sim(4, d, 1.5, make_collector, 6),
                              seed=chip_smoke.SEED)


def test_consensus_phase_in_small_through_the_plain_kernels():
    """``chip_smoke.py``'s consensus phase at n = 4 with a 100 ms collector
    window (16 flushes): every delivery goes through ``cuda-only``
    collectors sharing one ``TorchSignatureVerifier(device="cpu")``, every
    forged copy is rejected and absent from the stores, and the committed
    sequences and own blocks equal the ``cpu`` kind's run of the same seed."""
    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics

    committee = Committee.new_for_benchmarks(4)
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes(), device="cpu")
    metrics = Metrics()
    plain = _consensus_in_small("cuda-only", backend, metrics)
    cpu = _consensus_in_small("cpu")
    reading = chip_smoke.consensus_checks(plain, cpu, min_commits=1)
    assert reading["forged"] == reading["forged_rejected"] > 0
    get = metrics.registry.get_sample_value
    on_backend = sum(
        get("verified_signatures_total", {"backend": "TorchSignatureVerifier", "outcome": o})
        or 0.0 for o in ("accepted", "rejected"))
    assert on_backend == get("verify_dispatch_batch_size_sum") == plain["signatures_verified"]
    assert get("verify_dispatch_batch_size_count") <= 20
