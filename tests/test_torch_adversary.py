"""The port's Byzantine adversary plane against the JAX package's
(adversary.py, scenarios.py): counterparts of ``tests/test_adversary.py``
run on the port, then parities that feed both packages the same seeded
inputs.

The tier-1 acceptance sim is the seeded 10-node run with f=3 adversaries
concurrently equivocating, withholding, and signing invalidly: all honest
nodes commit a common leader prefix with zero SafetyChecker violations,
every counter-surfaced attack is detected and attributed, and the attack
schedule / detection ledger / committed sequences are byte-identical
across same-seed runs.  The full matrix (clean-twin throughput ratios
included) runs on the slow tier and in
``python -m mysticeti_tpu_torch.tools.scenario_matrix``.
"""
import asyncio
import dataclasses
import json

import pytest

from mysticeti_tpu_torch.adversary import (
    AdversarySpec,
    AttackLedger,
    equivocating_variant,
    tamper_signature,
)
from mysticeti_tpu_torch.block_store import BlockStore, BlockWriter
from mysticeti_tpu_torch.block_validator import (
    BatchedSignatureVerifier,
    CpuSignatureVerifier,
)
from mysticeti_tpu_torch.chaos import FaultPlan, SafetyChecker, run_chaos_sim
from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.flight_recorder import FlightRecorder
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.scenarios import (
    SimResignOracleVerifier,
    Scenario,
    default_matrix,
    oracle_verifier_factory,
    scenario_by_name,
    wan_latency_ranges,
)
from mysticeti_tpu_torch.types import BlockReference, Share, StatementBlock, VerificationError
from mysticeti_tpu_torch.wal import walf

pytestmark = pytest.mark.byzantine


# ---------------------------------------------------------------------------
# Spec / ledger / transform units


def test_adversary_spec_validates_and_roundtrips():
    spec = AdversarySpec(
        node=7, behavior="withhold", start_s=1.0, end_s=9.0,
        params=(("keep", 2.0),),
    )
    assert AdversarySpec.from_dict(spec.to_dict()) == spec
    assert spec.active(1.0) and spec.active(8.9)
    assert not spec.active(0.5) and not spec.active(9.0)
    assert spec.param("keep", 0) == 2.0
    with pytest.raises(ValueError, match="unknown adversary behavior"):
        AdversarySpec(node=0, behavior="teleport")


def test_fault_plan_carries_adversaries_through_json():
    plan = FaultPlan(
        seed=3,
        adversaries=[
            AdversarySpec(node=9, behavior="equivocate"),
            AdversarySpec(node=8, behavior="lag", params=(("lag_s", 0.4),)),
        ],
    )
    again = FaultPlan.from_json(plan.to_json())
    assert again == plan
    assert again.to_json() == plan.to_json()


def test_attack_ledger_bytes_are_canonical():
    async def main():
        ledger = AttackLedger()
        ledger.note("withhold", node=8, dst=1, blocks=2)
        ledger.note("equivocate", node=7, dst=5, blocks=1)
        return ledger

    ledger = asyncio.new_event_loop().run_until_complete(main())
    doc = json.loads(ledger.ledger_bytes())
    assert [e["kind"] for e in doc] == ["withhold", "equivocate"]
    assert ledger.counts() == {"withhold:8": 1, "equivocate:7": 1}


def test_tampered_signature_parses_but_fails_verification():
    """The invalid-signer twin: structure intact, digest self-consistent,
    signature exactly wrong — rejection happens at the verifier."""
    signer = Committee.benchmark_signers(4)[1]
    committee = Committee.new_for_benchmarks(4)
    own, others = committee.genesis_blocks(1)
    includes = [b.reference for b in [own] + others]
    block = StatementBlock.build(
        1, 1, includes, [Share(b"tx")], signer=signer
    )
    twin = StatementBlock.from_bytes(tamper_signature(block.to_bytes()))
    assert twin.author() == 1 and twin.round() == 1
    assert twin.reference.digest != block.reference.digest
    twin.verify_structure(committee)  # structure check passes
    oracle = SimResignOracleVerifier(committee)
    pk = committee.public_key_bytes()[1]
    assert oracle.verify_signatures(
        [pk], [block.signed_digest()], [block.signature]
    ) == [True]
    assert oracle.verify_signatures(
        [pk], [twin.signed_digest()], [twin.signature]
    ) == [False]


def test_equivocating_variant_is_valid_and_distinct():
    signer = Committee.benchmark_signers(4)[2]
    committee = Committee.new_for_benchmarks(4)
    own, others = committee.genesis_blocks(2)
    includes = [b.reference for b in [own] + others]
    block = StatementBlock.build(
        2, 1, includes, [Share(b"tx")], signer=signer
    )
    variant = StatementBlock.from_bytes(
        equivocating_variant(block.to_bytes(), signer)
    )
    assert (variant.author(), variant.round()) == (2, 1)
    assert variant.reference.digest != block.reference.digest
    assert variant.includes == block.includes
    assert variant.statements == block.statements
    variant.verify_structure(committee)
    oracle = SimResignOracleVerifier(committee)
    pk = committee.public_key_bytes()[2]
    assert oracle.verify_signatures(
        [pk], [variant.signed_digest()], [variant.signature]
    ) == [True]


# ---------------------------------------------------------------------------
# Equivocation detection in the honest path (block_store)


def test_block_store_counts_live_equivocation(tmp_path):
    committee = Committee.new_test([1, 1, 1, 1])
    metrics = Metrics()
    w, r = walf(str(tmp_path / "wal"))
    core, _obs = BlockStore.open(0, r, w, committee, metrics=metrics)
    store = core.block_store
    recorder = FlightRecorder(authority=0)
    store.recorder = recorder
    writer = BlockWriter(w, store)
    signer = Committee.benchmark_signers(4)[1]
    first = StatementBlock.build(1, 3, [], [Share(b"a")], signer=signer)
    sibling = StatementBlock.from_bytes(
        equivocating_variant(first.to_bytes(), signer)
    )
    writer.insert_block(first)
    assert store.equivocations_detected == {}
    # Re-inserting the SAME digest is not equivocation (WAL replay shape).
    writer.insert_block(first)
    assert store.equivocations_detected == {}
    writer.insert_block(sibling)
    assert store.equivocations_detected == {1: 1}
    assert metrics.mysticeti_equivocation_detected_total.labels(
        "1"
    )._value.get() == 1.0
    kinds = [e["kind"] for e in recorder.events()]
    assert "equivocation-detected" in kinds
    # A block from a DIFFERENT authority at the same round is not counted.
    other = StatementBlock.build(
        2, 3, [], [Share(b"c")], signer=Committee.benchmark_signers(4)[2]
    )
    writer.insert_block(other)
    assert store.equivocations_detected == {1: 1}


# ---------------------------------------------------------------------------
# SafetyChecker adversary attribution


class _Commit:
    def __init__(self, height, anchor, blocks=()):
        self.height = height
        self.anchor = anchor
        self.blocks = blocks


def test_safety_checker_attributes_adversary_divergence():
    a1 = BlockReference(0, 3, b"a" * 32)
    b1 = BlockReference(1, 3, b"b" * 32)
    checker = SafetyChecker()
    checker.mark_adversary(2)
    checker.observe(0, [_Commit(1, a1)])
    checker.observe(1, [_Commit(1, a1)])
    # The adversary forking against the honest golden sequence is
    # RECORDED, not fatal...
    checker.observe(2, [_Commit(1, b1)])
    checker.check()
    assert checker.adversary_divergence == [
        {"kind": "fork", "adversary": 2, "height": 1}
    ]
    # ...while honest-honest divergence still raises.
    from mysticeti_tpu_torch.chaos import SafetyViolation

    with pytest.raises(SafetyViolation):
        checker.observe(1, [_Commit(2, a1)])
        checker.observe(0, [_Commit(2, b1)])
        checker.check()


def test_safety_checker_counts_committed_blocks_per_author():
    ref = BlockReference(0, 3, b"a" * 32)
    committee = Committee.new_for_benchmarks(4)
    signers = Committee.benchmark_signers(4)
    blocks = [
        StatementBlock.build(a, 1, [], [Share(bytes([a]))], signer=signers[a])
        for a in range(3)
    ]
    checker = SafetyChecker()
    checker.observe(0, [_Commit(1, ref, blocks=blocks)])
    # Height-deduped: a replay re-observation adds nothing.
    checker.observe(0, [_Commit(1, ref, blocks=blocks)])
    assert checker.committed_blocks[0] == {0: 1, 1: 1, 2: 1}
    assert checker.committed_tx[0] == {0: 1, 1: 1, 2: 1}


# ---------------------------------------------------------------------------
# Scenario plumbing


def test_wan_latency_ranges_split_by_region():
    ranges = wan_latency_ranges([0, 0, 1])
    assert ranges[(0, 1)] == (0.005, 0.015)
    assert ranges[(0, 2)] == (0.080, 0.160)
    assert (1, 1) not in ranges


def test_scenario_to_dict_is_a_reproduction_recipe():
    scenario = scenario_by_name("byzantine-at-f")
    doc = scenario.to_dict()
    plan = FaultPlan.from_dict(doc["plan"])
    assert plan == scenario.plan()
    assert {s["behavior"] for s in doc["plan"]["adversaries"]} == {
        "equivocate", "withhold", "invalid_sig",
    }
    names = [s.name for s in default_matrix()]
    assert len(names) == len(set(names)) and len(names) >= 5
    with pytest.raises(KeyError):
        scenario_by_name("nope")


def test_oracle_verifier_matches_real_semantics():
    committee = Committee.new_for_benchmarks(4)
    signers = Committee.benchmark_signers(4)
    block = StatementBlock.build(0, 1, [], [Share(b"x")], signer=signers[0])
    twin = StatementBlock.from_bytes(tamper_signature(block.to_bytes()))
    oracle = SimResignOracleVerifier(committee)
    cpu = CpuSignatureVerifier()
    pk = committee.public_key_bytes()[0]
    for candidate in (block, twin):
        args = ([pk], [candidate.signed_digest()], [candidate.signature])
        assert oracle.verify_signatures(*args) == cpu.verify_signatures(*args)
    # Unknown key -> reject, never a KeyError.
    stranger = Committee.benchmark_signers(8)[7]
    assert oracle.verify_signatures(
        [stranger.public_key.bytes], [block.signed_digest()],
        [block.signature],
    ) == [False]


# ---------------------------------------------------------------------------
# Verifier rejection path under the accelerator seam: an
# invalid-signer batch must reject exactly the tampered records while the
# honest remainder commits, on the CPU oracle and the pipelined dispatch.


def _mixed_batch(n=8):
    committee = Committee.new_for_benchmarks(4)
    signers = Committee.benchmark_signers(4)
    blocks = [
        StatementBlock.build(
            a % 4, 1 + a // 4, [], [Share(bytes([a]))], signer=signers[a % 4]
        )
        for a in range(n)
    ]
    tampered_idx = {1, 4, 6}
    batch = [
        StatementBlock.from_bytes(tamper_signature(b.to_bytes()))
        if i in tampered_idx
        else b
        for i, b in enumerate(blocks)
    ]
    return committee, batch, tampered_idx


@pytest.mark.parametrize("depth", [1, 4])
def test_verifier_rejects_exactly_the_tampered_records(depth):
    """depth=1 is the serial CPU-oracle path; depth=4 exercises the staged
    dispatch pipeline (multiple windows in flight, straggler patching)."""
    committee, batch, tampered_idx = _mixed_batch()

    async def main():
        verifier = BatchedSignatureVerifier(
            committee, CpuSignatureVerifier(), max_batch=2, max_delay_s=0.005,
            pipeline_depth=depth,
        )
        return await asyncio.gather(
            *(verifier.verify(b) for b in batch), return_exceptions=True
        ), verifier

    results, collector = asyncio.run(main())
    for i, result in enumerate(results):
        if i in tampered_idx:
            assert isinstance(result, VerificationError), i
        else:
            assert result is None, (i, result)
    if depth > 1:
        assert collector.pipeline.max_inflight >= 2


# ---------------------------------------------------------------------------
# The tier-1 acceptance sim: 10 nodes, f=3 concurrent attack classes


def _byzantine_at_f(duration_s):
    scenario = scenario_by_name("byzantine-at-f")
    return dataclasses.replace(scenario, duration_s=duration_s)


def _run_attacked(scenario, wal_dir):
    return run_chaos_sim(
        scenario.plan(), scenario.nodes, scenario.duration_s, str(wal_dir),
        parameters=scenario.base_parameters(),
        latency_ranges=scenario.latency_ranges(),
        with_metrics=True,
        verifier_factory=oracle_verifier_factory(scenario.nodes),
    )


@pytest.mark.chaos
def test_byzantine_at_f_commits_safely_with_all_attacks_detected(tmp_path):
    """f=3 of 10 concurrently equivocating / withholding / invalid-signing:
    zero honest SafetyChecker violations, a common honest leader prefix,
    and every attack detected on its surface or accounted in the ledger."""
    scenario = _byzantine_at_f(4.0)
    report, harness = _run_attacked(scenario, tmp_path)

    adversaries = {spec.node for spec in scenario.adversaries}
    honest = {
        a: seq for a, seq in report.sequences.items() if a not in adversaries
    }
    longest = max(honest.values(), key=len)
    for seq in honest.values():
        assert seq == longest[: len(seq)]
    assert min(len(seq) for seq in honest.values()) >= 8

    # Injection happened for every declared behavior...
    for spec in scenario.adversaries:
        assert report.attack_counts.get(f"{spec.behavior}:{spec.node}", 0) > 0
    # ...and every counter-surfaced behavior was detected and ATTRIBUTED
    # by at least one honest node (withhold is silence-shaped: its
    # evidence is the ledger accounting asserted above).
    equivocation_seen = invalid_seen = 0
    for authority, census in report.detections.items():
        if authority in adversaries:
            continue
        equivocation_seen += census.get("equivocation", {}).get(
            "authority=7", 0
        )
        invalid_seen += census.get("invalid_blocks", {}).get(
            "authority=9,reason=signature", 0
        )
    assert equivocation_seen > 0
    assert invalid_seen > 0
    # The invalid signer's blocks never entered any honest DAG — only its
    # round-0 genesis block (constructed locally by every node, never on
    # the wire) can appear in a committed sub-dag...
    for authority, seq in honest.items():
        store_counts = report.committed_blocks.get(authority, {})
        assert store_counts.get(9, 0) <= 1
    # ...and no honest node was flagged as an equivocator.
    for authority, census in report.detections.items():
        for label in census.get("equivocation", {}):
            assert label == "authority=7", (authority, label)


@pytest.mark.chaos
def test_byzantine_sim_is_byte_identical_across_same_seed_runs(tmp_path):
    """Attack schedule, detection ledger, and committed sequences are
    canonical bytes — a same-seed re-run reproduces all three exactly."""
    scenario = Scenario(
        name="det",
        description="determinism twin",
        nodes=5,
        duration_s=3.0,
        seed=17,
        leader_timeout_s=0.3,
        adversaries=(
            AdversarySpec(node=3, behavior="equivocate"),
            AdversarySpec(node=4, behavior="invalid_sig"),
        ),
    )
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    first, _ = _run_attacked(scenario, tmp_path / "a")
    second, _ = _run_attacked(scenario, tmp_path / "b")
    assert first.attack_log_bytes == second.attack_log_bytes
    assert first.attack_log_bytes  # attacks actually fired
    assert first.detections_bytes() == second.detections_bytes()
    assert first.sequences == second.sequences
    assert first.committed_tx == second.committed_tx
    assert first.fault_log_bytes == second.fault_log_bytes


# ---------------------------------------------------------------------------
# The full matrix with clean twins (ratios) rides the slow tier; tier-1
# covers the matrix machinery end-to-end on one short scenario.


@pytest.mark.slow
def test_scenario_matrix_all_pass():
    """The acceptance matrix: >= 5 distinct scenarios, all passing (zero
    safety violations, every attack detected/accounted, honest committed
    throughput >= min_ratio x the same-seed clean twin)."""
    from mysticeti_tpu_torch.scenarios import run_matrix

    doc = run_matrix()
    assert len(doc["scenarios"]) >= 5
    failures = [
        (v["scenario"]["name"], v.get("throughput_ratio"), v["safety_ok"])
        for v in doc["scenarios"]
        if not v["passed"]
    ]
    assert doc["all_pass"], failures


# ---------------------------------------------------------------------------
# Malformed-frame hardening on real sockets (a garbage length
# prefix or undecodable payload severs the delivering connection, counted
# and attributed — never an uncaught decode error in the protocol path).


async def _adversarial_socket(metrics):
    from mysticeti_tpu_torch.network import TcpNetwork

    loop = asyncio.get_event_loop()
    accepted = loop.create_future()

    async def on_conn(reader, writer):
        accepted.set_result((reader, writer))

    server = await asyncio.start_server(on_conn, host="127.0.0.1", port=0)
    port = server.sockets[0].getsockname()[1]
    c_reader, c_writer = await asyncio.open_connection("127.0.0.1", port)
    s_reader, s_writer = await accepted
    net = TcpNetwork(0, [("127.0.0.1", 0), ("127.0.0.1", 0)], metrics)
    peer_task = asyncio.ensure_future(net._run_peer(1, s_reader, s_writer))
    conn = await net.connections.get()
    return server, c_writer, peer_task, conn


@pytest.mark.parametrize(
    "garbage",
    [
        pytest.param((0xFFFFFFFF).to_bytes(4, "little"), id="oversized-prefix"),
        pytest.param((1).to_bytes(4, "little") + b"\xfe", id="unknown-tag"),
        pytest.param(
            (8).to_bytes(4, "little") + b"\x01garbage", id="torn-payload"
        ),
    ],
)
def test_malformed_frame_severs_connection_and_counts(garbage):
    async def main():
        metrics = Metrics()
        server, c_writer, peer_task, conn = await _adversarial_socket(metrics)
        c_writer.write(garbage)
        await c_writer.drain()
        c_writer.write_eof()
        await asyncio.wait_for(peer_task, 5)
        assert metrics.mysticeti_malformed_frames_total.labels(
            "1"
        )._value.get() == 1.0
        c_writer.close()
        server.close()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# Parities: both packages, the same seeded inputs


def _seeded_blocks(pkg, seed, count=12, n=7):
    """``count`` blocks of a benchmark committee of ``n``, authors, rounds,
    includes and payloads drawn from ``seed``, built by ``pkg``."""
    import importlib
    import random

    committee_mod = importlib.import_module(f"{pkg}.committee")
    types = importlib.import_module(f"{pkg}.types")
    signers = committee_mod.Committee.benchmark_signers(n)
    rng = random.Random(seed)
    blocks = []
    for _ in range(count):
        author = rng.randrange(n)
        rnd = rng.randrange(1, 40)
        includes = [
            types.BlockReference(rng.randrange(n), rnd - 1, rng.randbytes(32))
            for _ in range(rng.randrange(0, 5))
        ]
        statements = [types.Share(rng.randbytes(rng.randrange(1, 64)))
                      for _ in range(rng.randrange(0, 4))]
        blocks.append((author, types.StatementBlock.build(
            author, rnd, includes, statements,
            meta_creation_time_ns=rng.getrandbits(63), signer=signers[author],
        ).to_bytes()))
    return blocks, signers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tamper_and_variant_bytes_equal_the_jax_packages(seed):
    """``tamper_signature`` and ``equivocating_variant`` of the same seeded
    blocks give the same bytes in both packages."""
    from mysticeti_tpu import adversary as jax_adversary
    from mysticeti_tpu_torch import adversary as port_adversary

    port_blocks, port_signers = _seeded_blocks("mysticeti_tpu_torch", seed)
    jax_blocks, jax_signers = _seeded_blocks("mysticeti_tpu", seed)
    assert port_blocks == jax_blocks
    for author, raw in port_blocks:
        assert port_adversary.tamper_signature(raw) == jax_adversary.tamper_signature(raw)
        assert port_adversary.equivocating_variant(raw, port_signers[author]) == \
            jax_adversary.equivocating_variant(raw, jax_signers[author])


def test_engine_transform_equals_the_jax_packages():
    """One seeded stream of block batches through both packages'
    ``AdversaryEngine.transform`` (every behavior, the mangler's draws
    included): the same delay groups, message types and payloads, and
    the same attack ledger bytes."""
    import random

    from mysticeti_tpu import adversary as JA
    from mysticeti_tpu import network as JN
    from mysticeti_tpu.committee import Committee as JC
    from mysticeti_tpu_torch import adversary as PA
    from mysticeti_tpu_torch import network as PN

    n = 7
    raws, _ = _seeded_blocks("mysticeti_tpu_torch", 5, count=40, n=n)
    specs = [
        dict(node=1, behavior="equivocate"),
        dict(node=2, behavior="withhold", params=(("keep", 2.0),)),
        dict(node=3, behavior="invalid_sig"),
        dict(node=4, behavior="mangle", params=(("mangle_p", 0.3),)),
        dict(node=5, behavior="lag", params=(("lag_s", 0.4),)),
    ]

    def drive(A, N, signers):
        engine = A.AdversaryEngine([A.AdversarySpec(**s) for s in specs], signers, n, seed=9)
        rng = random.Random(3)
        out = []

        async def main():
            for author, raw in raws:
                dst = rng.choice([a for a in range(n) if a != author])
                kind = rng.randrange(3)
                msg = (N.Blocks((raw,)) if kind == 0 else
                       N.RequestBlocksResponse((raw,)) if kind == 1 else
                       N.TimestampedBlocks((raw,), sent_monotonic_ns=7, sent_wall_ns=8))
                for delay, group in engine.transform(author, dst, [msg], 1.0):
                    out.append((delay, [(type(m).__name__, tuple(bytes(b) for b in m.blocks))
                                        for m in group]))
            return out

        groups = asyncio.new_event_loop().run_until_complete(main())
        return groups, engine.ledger.counts(), [
            {k: v for k, v in e.items() if k != "t"} for e in engine.ledger.entries]

    port = drive(PA, PN, Committee.benchmark_signers(n))
    jax = drive(JA, JN, JC.benchmark_signers(n))
    assert port == jax
    assert set(port[1]) >= {"equivocate:1", "withhold:2", "invalid_sig:3", "mangle:4", "lag:5"}
