"""Threshold-aggregate verification in the port, against the JAX package.

Counterparts of ``tests/test_threshold_aggregate.py`` on the port's classes
(``ThresholdAggregateVerifier`` and the collector's aggregate mode), then the
port's ``aggregate_verify`` against the JAX package's on seeded random DAG
batches: forged frontier blocks, forged interiors short of quorum, prior
endorsers, and ``defer_unresolved`` both ways must give identical verdict
lists, dispatches and skipped/direct counts (exact: verdicts and counts are
integers).  Then the ``-agg`` kinds of ``_make_verifier``: ``cuda-only-agg``
on the CPU runs the port's own backend (the kernels' plain versions) on the
frontier, through the verifier service (``MYSTICETI_VERIFIER_SOCKET``) the
``-agg`` collector runs over the service client, and without a card the
accelerator kinds raise instead of running on the CPU.
"""
import asyncio
import random

import pytest
import torch

from mysticeti_tpu import block_validator as JBV
from mysticeti_tpu import committee as JC
from mysticeti_tpu import types as JT
from mysticeti_tpu_torch import block_validator as PBV
from mysticeti_tpu_torch import committee as PC
from mysticeti_tpu_torch import types as PT
from mysticeti_tpu_torch.block_validator import (
    BatchedSignatureVerifier,
    CpuSignatureVerifier,
    ThresholdAggregateVerifier,
)
from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.types import Share, StatementBlock
from mysticeti_tpu_torch.validator import _make_verifier


@pytest.fixture
def setup():
    return Committee.new_for_benchmarks(4), Committee.benchmark_signers(4)


class CountingInner(BatchedSignatureVerifier):
    def __init__(self, committee):
        super().__init__(committee, CpuSignatureVerifier(), max_batch=64, max_delay_s=0.001)
        self.seen = []

    async def verify_blocks(self, blocks):
        self.seen.extend(b.reference for b in blocks)
        return await super().verify_blocks(blocks)


class CountingSigVerifier(CpuSignatureVerifier):
    def __init__(self):
        self.dispatched = 0

    def verify_signatures(self, pks, digests, sigs):
        self.dispatched += len(sigs)
        return super().verify_signatures(pks, digests, sigs)


def _forge(blk):
    bad = bytes([blk.signature[0] ^ 1]) + blk.signature[1:]
    return StatementBlock(
        blk.reference, blk.includes, blk.statements, blk.meta_creation_time_ns,
        blk.epoch_marker, blk.epoch, bad, _bytes=None,
    )


def _dag(signers, rounds, per_round=4, forge=()):
    """Rounds of fully-connected blocks; ``forge`` = set of (round, authority)
    whose signature bytes are corrupted after signing."""
    prev = [StatementBlock.new_genesis(a).reference for a in range(per_round)]
    out = []
    for r in range(1, rounds + 1):
        layer = []
        for a in range(per_round):
            blk = StatementBlock.build(a, r, prev, [Share(bytes([r, a]))], signer=signers[a])
            layer.append(_forge(blk) if (r, a) in forge else blk)
        out.extend(layer)
        prev = [b.reference for b in layer]
    return out


def _include_block(signers, author, round_, includes, forge=False):
    blk = StatementBlock.build(
        author, round_, includes, [Share(bytes([round_, author]))], signer=signers[author],
    )
    return _forge(blk) if forge else blk


def _collector(committee, sig, **kw):
    return BatchedSignatureVerifier(
        committee, sig, max_batch=64, max_delay_s=kw.pop("max_delay_s", 0.02), aggregate=True, **kw
    )


def test_interior_blocks_skip_direct_verification(setup):
    committee, signers = setup

    async def main():
        inner = CountingInner(committee)
        agg = ThresholdAggregateVerifier(committee, inner)
        assert all(await agg.verify_blocks(_dag(signers, rounds=5)))
        # Only the frontier (last round, no in-batch endorsers) was
        # signature-verified directly.
        assert len(inner.seen) == 4 and all(ref.round == 5 for ref in inner.seen)
        assert agg.aggregated_total == 16

    asyncio.run(main())


def test_forged_frontier_rejected(setup):
    committee, signers = setup

    async def main():
        agg = ThresholdAggregateVerifier(committee, CountingInner(committee))
        blocks = _dag(signers, rounds=3, forge={(3, 1)})
        results = await agg.verify_blocks(blocks)
        for b, ok in zip(blocks, results):
            assert ok == (not (b.round() == 3 and b.author() == 1)), b.reference

    asyncio.run(main())


def test_forged_interior_without_quorum_rejected(setup):
    """A forged block endorsed by fewer than quorum distinct authorities is
    verified directly and rejected."""
    committee, signers = setup

    async def main():
        agg = ThresholdAggregateVerifier(committee, CountingInner(committee))
        blocks = _dag(signers, rounds=2, forge={(1, 2)})
        forged_ref = next(b.reference for b in blocks if b.round() == 1 and b.author() == 2)
        # Only one round-2 block keeps the forged block in its includes.
        filtered = []
        for b in blocks:
            if b.round() == 2 and b.author() != 0:
                b = StatementBlock.build(
                    b.author(), 2, [r for r in b.includes if r != forged_ref],
                    list(b.statements), signer=signers[b.author()],
                )
            filtered.append(b)
        results = await agg.verify_blocks(filtered)
        by_ref = dict(zip((b.reference for b in filtered), results))
        assert by_ref[forged_ref] is False
        assert sum(results) == len(filtered) - 1

    asyncio.run(main())


def test_collapsed_endorsement_falls_back_to_direct(setup):
    """A block whose endorsers fail verification gets its own direct check
    (valid -> accepted), not a blanket reject."""
    committee, signers = setup

    async def main():
        inner = CountingInner(committee)
        agg = ThresholdAggregateVerifier(committee, inner)
        blocks = _dag(signers, rounds=2, forge={(2, a) for a in range(4)})
        results = await agg.verify_blocks(blocks)
        for b, ok in zip(blocks, results):
            assert ok == (b.round() == 1), b.reference
        assert sum(1 for r in inner.seen if r.round == 1) == 4

    asyncio.run(main())


def test_singletons_bypass_aggregation(setup):
    committee, signers = setup

    async def main():
        inner = CountingInner(committee)
        agg = ThresholdAggregateVerifier(committee, inner)
        assert await agg.verify_blocks([_dag(signers, rounds=1)[0]]) == [True]
        assert agg.aggregated_total == 0 and len(inner.seen) == 1

    asyncio.run(main())


def test_aggregate_verifier_counts_on_metrics(setup):
    """The frame-level wrapper's skipped and direct counts reach
    ``verified_signatures_total{backend="aggregate"}``."""
    committee, signers = setup
    metrics = Metrics()
    agg = ThresholdAggregateVerifier(committee, CountingInner(committee), metrics=metrics)
    assert all(asyncio.run(agg.verify_blocks(_dag(signers, rounds=5))))
    get = metrics.registry.get_sample_value
    assert get("verified_signatures_total", {"backend": "aggregate", "outcome": "skipped"}) == 16
    assert get("verified_signatures_total", {"backend": "aggregate", "outcome": "direct"}) == 4


def test_make_verifier_agg_kinds(monkeypatch):
    """``-agg`` kinds enable COLLECTOR-level aggregation over the kind's
    backend; the plain kinds leave it off."""
    monkeypatch.setattr(PBV.HybridSignatureVerifier, "warmup", lambda self: None)
    monkeypatch.setattr(PBV.TorchSignatureVerifier, "warmup", lambda self: None)
    committee = Committee.new_for_benchmarks(4)
    v = _make_verifier("cpu-agg", committee)
    assert isinstance(v, PBV.BatchedSignatureVerifier) and v.aggregate
    assert isinstance(v.verifier, PBV.CpuSignatureVerifier)
    v = _make_verifier("cuda-agg", committee, device="cpu")
    assert isinstance(v, PBV.BatchedSignatureVerifier) and v.aggregate
    assert isinstance(v.verifier, PBV.HybridSignatureVerifier)
    v = _make_verifier("cuda-only-agg", committee, device="cpu")
    assert v.aggregate and isinstance(v.verifier, PBV.TorchSignatureVerifier)
    for kind in ("cpu", "cuda-only"):
        assert not _make_verifier(kind, committee, device="cpu").aggregate
    with pytest.raises(ValueError):
        _make_verifier("tpu-agg", committee)


def test_collector_aggregation_skips_interior(setup):
    """Blocks arriving concurrently pool in one flush window; only the
    frontier pays a signature dispatch."""
    committee, signers = setup

    async def main():
        sig = CountingSigVerifier()
        metrics = Metrics()
        collector = _collector(committee, sig, metrics=metrics)
        assert all(await collector.verify_blocks(_dag(signers, rounds=5)))
        assert sig.dispatched == 4  # frontier only (round 5)
        assert collector.aggregated_total == 16 and collector.direct_total == 4
        get = metrics.registry.get_sample_value
        assert get("verified_signatures_total",
                   {"backend": "aggregate", "outcome": "skipped"}) == 16

    asyncio.run(main())


def test_collector_aggregation_rejects_forged_frontier(setup):
    committee, signers = setup

    async def main():
        collector = _collector(committee, CountingSigVerifier())
        blocks = _dag(signers, rounds=3, forge={(3, 1)})
        results = await collector.verify_blocks(blocks)
        for b, ok in zip(blocks, results):
            assert ok == (not (b.round() == 3 and b.author() == 1)), b.reference

    asyncio.run(main())


def test_cross_flush_endorsement_skips_late_parent(setup):
    """A block whose quorum of verified children was accepted in EARLIER
    flushes skips its signature dispatch even when it arrives alone; a
    single-author chain's parent never reaches quorum in the index."""
    committee, signers = setup

    async def main():
        sig = CountingSigVerifier()
        collector = _collector(committee, sig)
        blocks = _dag(signers, rounds=3)
        late = next(b for b in blocks if b.round() == 1 and b.author() == 0)
        assert all(await collector.verify_blocks([b for b in blocks if b is not late]))
        dispatched_before = sig.dispatched
        assert await collector.verify_blocks([late]) == [True]
        assert sig.dispatched == dispatched_before  # skipped via the index
        assert collector.aggregated_total >= 1

        solo = CountingSigVerifier()
        c2 = _collector(committee, solo)
        genesis = [StatementBlock.new_genesis(a).reference for a in range(4)]
        parent = StatementBlock.build(1, 1, genesis, [Share(b"p")], signer=signers[1])
        child = StatementBlock.build(1, 2, [parent.reference], [Share(b"c")], signer=signers[1])
        assert all(await c2.verify_blocks([child]))
        before = solo.dispatched
        assert await c2.verify_blocks([parent]) == [True]
        assert solo.dispatched == before + 1  # direct check, no quorum

    asyncio.run(main())


def test_collector_aggregation_single_author_stream_never_skips(setup):
    committee, signers = setup

    async def main():
        sig = CountingSigVerifier()
        collector = _collector(committee, sig)
        prev = [StatementBlock.new_genesis(a).reference for a in range(4)]
        chain = []
        for r in range(1, 9):
            blk = StatementBlock.build(0, r, prev, [Share(bytes([r]))], signer=signers[0])
            chain.append(blk)
            prev = [blk.reference]
        assert all(await collector.verify_blocks(chain))
        assert sig.dispatched == len(chain) and collector.aggregated_total == 0

    asyncio.run(main())


def _spy(sig):
    dispatches = []
    orig = sig.verify_signatures

    def spy(pks, digests, sigs_):
        dispatches.append(len(sigs_))
        return orig(pks, digests, sigs_)

    sig.verify_signatures = spy
    return dispatches


def test_collector_defers_unresolved_to_next_flush(setup):
    """An interior block whose optimistic endorsement collapses rides the
    next window instead of a second serialized dispatch in the same flush."""
    committee, signers = setup

    async def main():
        sig = CountingSigVerifier()
        dispatches = _spy(sig)
        collector = _collector(committee, sig)
        genesis = [StatementBlock.new_genesis(a).reference for a in range(4)]
        b = _include_block(signers, 0, 1, genesis)
        children = [_include_block(signers, a, 2, [b.reference], forge=(a in (2, 3)))
                    for a in (1, 2, 3)]
        assert await collector.verify_blocks([b] + children) == [True, True, False, False]
        assert dispatches == [3, 1]
        assert collector.direct_total == 4

    asyncio.run(main())


def test_collector_force_dispatches_on_second_deferral(setup):
    """A Byzantine author minting fresh forged endorsers every window must
    not park a block in 'maybe' forever."""
    committee, signers = setup

    async def main():
        sig = CountingSigVerifier()
        dispatches = _spy(sig)
        collector = _collector(committee, sig, max_delay_s=10.0)
        collector._effective_delay_s = lambda: 10.0  # flushes only when driven
        genesis = [StatementBlock.new_genesis(a).reference for a in range(4)]
        b = _include_block(signers, 0, 1, genesis)
        wave1 = [_include_block(signers, a, 2, [b.reference], forge=(a in (2, 3)))
                 for a in (1, 2, 3)]
        task = asyncio.ensure_future(collector.verify_blocks([b] + wave1))
        await asyncio.sleep(0.01)
        await collector._flush()
        assert not task.done()
        wave2 = [_include_block(signers, a, 3, [b.reference], forge=True) for a in (2, 3)]
        task2 = asyncio.ensure_future(collector.verify_blocks(wave2))
        await asyncio.sleep(0.01)
        await collector._flush()
        assert await task == [True, True, False, False]
        assert await task2 == [False, False]
        assert dispatches == [3, 2, 1]

    asyncio.run(main())


def test_evicted_endorsement_never_resurrects(setup):
    """Endorsement stake scattered across FIFO evictions never accumulates
    to quorum: the forged block is direct-checked and rejected."""
    committee, signers = setup

    async def main():
        sig = CountingSigVerifier()
        collector = _collector(committee, sig)
        collector.ENDORSEMENT_MAX_ENTRIES = 2  # force aggressive eviction
        genesis = [StatementBlock.new_genesis(a).reference for a in range(4)]
        forged = _include_block(signers, 3, 1, genesis, forge=True)
        wave_a = [_include_block(signers, a, 2, [forged.reference]) for a in (0, 1)]
        assert await collector.verify_blocks(wave_a) == [True, True]
        assert collector._prior_endorsers(forged.reference) == {0, 1}
        assert all(await collector.verify_blocks(_dag(signers, rounds=1)))
        assert collector._prior_endorsers(forged.reference) == frozenset()
        wave_c = [_include_block(signers, 2, 2, [forged.reference])]
        assert await collector.verify_blocks(wave_c) == [True]
        assert collector._prior_endorsers(forged.reference) == {2}
        dispatched_before = sig.dispatched
        assert await collector.verify_blocks([forged]) == [False]
        assert sig.dispatched == dispatched_before + 1

    asyncio.run(main())


def test_same_author_endorsement_counts_once(setup):
    """One author endorsing a ref via the index and in-batch counts once."""
    committee, signers = setup

    async def main():
        collector = _collector(committee, CountingSigVerifier())
        genesis = [StatementBlock.new_genesis(a).reference for a in range(4)]
        forged = _include_block(signers, 3, 1, genesis, forge=True)
        prior = [_include_block(signers, a, 2, [forged.reference]) for a in (0, 1)]
        assert await collector.verify_blocks(prior) == [True, True]
        again = [_include_block(signers, a, 3, [forged.reference]) for a in (0, 1)]
        assert await collector.verify_blocks(again + [forged]) == [True, True, False]

    asyncio.run(main())


# -- the port's aggregate_verify against the JAX package's ------------------

def _random_batch(seed):
    """Seeded random DAG batch, serialized by the JAX package: random include
    subsets, forged blocks (a flipped signature byte, or a wrong signer),
    some forged blocks included by fewer than a quorum, a shuffled order.
    Returns the raw bytes and the prior-endorser index (ref digest ->
    authors)."""
    rng = random.Random(seed)
    n = rng.choice((4, 7))
    rounds = rng.randint(2, 5)
    signers = JC.Committee.benchmark_signers(n)
    prev = [JT.StatementBlock.new_genesis(a).reference for a in range(n)]
    raws, refs_all = [], []
    for r in range(1, rounds + 1):
        layer = []
        for a in range(n):
            k = rng.randint(1, len(prev))
            includes = rng.sample(prev, k)
            forged = rng.random() < 0.2
            signer = signers[(a + 1) % n] if forged and rng.random() < 0.5 else signers[a]
            blk = JT.StatementBlock.build(a, r, includes, [JT.Share(bytes([r, a]))], signer=signer)
            raw = bytearray(blk.to_bytes())
            if forged and signer is signers[a]:
                raw[-1 - rng.randrange(64)] ^= 1 << rng.randrange(8)
            raws.append(bytes(raw))
            layer.append(JT.StatementBlock.from_bytes(bytes(raw)).reference)
        refs_all.extend(layer)
        prev = layer
    prior = {}
    for ref in rng.sample(refs_all, len(refs_all) // 3):
        prior[ref.digest] = set(rng.sample(range(n), rng.randint(1, n)))
    rng.shuffle(raws)
    return n, raws, prior


async def _run_aggregate(side, n, raws, prior, defer):
    types_mod, committee_mod, bv = side
    committee = committee_mod.Committee.new_for_benchmarks(n)
    blocks = [types_mod.StatementBlock.from_bytes(r) for r in raws]
    oracle = bv.CpuSignatureVerifier()
    dispatched = []
    counts = [0, 0]

    async def direct(sub):
        dispatched.append([b.reference.digest for b in sub])
        return oracle.verify_signatures(
            [committee.get_public_key(b.author()).bytes for b in sub],
            [b.signed_digest() for b in sub], [b.signature for b in sub])

    def count(aggregated, direct_n):
        counts[0] += aggregated
        counts[1] += direct_n

    verdicts = await bv.aggregate_verify(
        blocks, committee, direct, count,
        prior_endorsers=lambda ref: prior.get(ref.digest, ()),
        defer_unresolved=defer,
    )
    return verdicts, dispatched, counts


@pytest.mark.parametrize("seed", range(12))
def test_aggregate_verify_equals_the_jax_package(seed):
    n, raws, prior = _random_batch(seed)
    for defer in (False, True):
        for use_prior in (False, True):
            p = prior if use_prior else {}
            got = asyncio.run(_run_aggregate((PT, PC, PBV), n, raws, p, defer))
            want = asyncio.run(_run_aggregate((JT, JC, JBV), n, raws, p, defer))
            assert got == want, (seed, defer, use_prior)


def test_random_batches_cover_every_outcome():
    """The seeded corpus above reaches skips, direct rejects and (with
    deferral) unresolved slots, so the parity is not vacuous."""
    seen = set()
    for seed in range(12):
        n, raws, prior = _random_batch(seed)
        for defer in (False, True):
            verdicts, _, counts = asyncio.run(_run_aggregate((PT, PC, PBV), n, raws, prior, defer))
            seen |= {v for v in verdicts}
            if counts[0]:
                seen.add("skipped")
    assert seen == {True, False, None, "skipped"}


def test_collector_aggregate_mode_equals_the_jax_package():
    """Whole collectors in aggregate mode over their CPU oracles: the same
    verdicts and aggregated/direct counts over a stream of batches (the
    cross-flush index and deferral included)."""
    def run(types_mod, committee_mod, bv, batches, n):
        committee = committee_mod.Committee.new_for_benchmarks(n)
        collector = bv.BatchedSignatureVerifier(
            committee, bv.CpuSignatureVerifier(), max_batch=64, max_delay_s=0.005,
            aggregate=True)

        async def main():
            out = []
            for raws in batches:
                blocks = [types_mod.StatementBlock.from_bytes(r) for r in raws]
                out.append(await collector.verify_blocks(blocks))
            return out

        return asyncio.run(main()), collector.aggregated_total, collector.direct_total

    for seed in (3, 8):
        n, raws, _ = _random_batch(seed)
        half = len(raws) // 2
        batches = [raws[:half], raws[half:]]
        assert run(PT, PC, PBV, batches, n) == run(JT, JC, JBV, batches, n)


def test_cuda_only_agg_on_the_cpu_equals_the_jax_cpu_agg():
    """``cuda-only-agg`` with ``device="cpu"``: the port's own backend (the
    kernels' plain versions) serves the frontier; verdicts and counts equal
    the JAX package's ``cpu-agg`` collector."""
    from mysticeti_tpu.validator import _make_verifier as jax_make_verifier

    n, raws, _ = _random_batch(5)
    port = _make_verifier("cuda-only-agg", PC.Committee.new_for_benchmarks(n), device="cpu")
    assert port.ready.wait(300)
    assert isinstance(port.verifier, PBV.TorchSignatureVerifier) and port.aggregate
    ref = jax_make_verifier("cpu-agg", JC.Committee.new_for_benchmarks(n))
    got = asyncio.run(port.verify_blocks([PT.StatementBlock.from_bytes(r) for r in raws]))
    want = asyncio.run(ref.verify_blocks([JT.StatementBlock.from_bytes(r) for r in raws]))
    assert got == want and False in got
    assert (port.aggregated_total, port.direct_total) == (ref.aggregated_total, ref.direct_total)
    assert port.aggregated_total > 0


def test_cuda_agg_kinds_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    committee = Committee.new_for_benchmarks(4)
    for kind in ("cuda-only-agg", "cuda-agg"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _make_verifier(kind, committee)


@pytest.mark.parametrize("kind", ["cuda-only-agg", "cuda-agg"])
def test_agg_kinds_through_the_verifier_service(tmp_path, monkeypatch, kind):
    """With ``MYSTICETI_VERIFIER_SOCKET`` set the ``-agg`` kinds build the
    aggregate collector over the service client (no card needed here: the
    service's backend is a CPU oracle), and give the JAX package's
    ``cpu-agg`` verdicts and counts."""
    from mysticeti_tpu.validator import _make_verifier as jax_make_verifier
    from mysticeti_tpu_torch.verifier_service import RemoteSignatureVerifier
    from test_torch_service import CountingBackend, _with_server

    n, raws, _ = _random_batch(8)
    committee = PC.Committee.new_for_benchmarks(n)
    ref = jax_make_verifier("cpu-agg", JC.Committee.new_for_benchmarks(n))
    want = asyncio.run(ref.verify_blocks([JT.StatementBlock.from_bytes(r) for r in raws]))

    async def scenario(server):
        monkeypatch.setenv("MYSTICETI_VERIFIER_SOCKET", server.socket_path)
        verifier = _make_verifier(kind, committee)
        assert await asyncio.to_thread(verifier.ready.wait, 30)
        backend = verifier.verifier
        remote = backend.tpu if isinstance(backend, PBV.HybridSignatureVerifier) else backend
        assert verifier.aggregate and isinstance(remote, RemoteSignatureVerifier)
        got = await verifier.verify_blocks([PT.StatementBlock.from_bytes(r) for r in raws])
        return got, verifier.aggregated_total, verifier.direct_total

    got, aggregated, direct = asyncio.run(
        _with_server(tmp_path, committee.public_key_bytes(), CountingBackend(), scenario))
    assert got == want
    assert (aggregated, direct) == (ref.aggregated_total, ref.direct_total) and aggregated > 0
