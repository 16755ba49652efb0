"""The port's deterministic chaos engine against the JAX package's:
counterparts of ``tests/test_chaos_sim.py`` (crash-restart with WAL replay,
seeded network faults, verifier-path graceful degradation) run on the
port, then parities that feed both packages the same plan.

The acceptance scenario is the 10-node sim with f=3 crash-restarts plus a
timed asymmetric partition: all honest nodes must commit identical leader
prefixes, every restarted node must catch up via WAL replay + sync, and a
same-seed re-run must produce a byte-identical fault schedule AND fault log.
All sims here run on the virtual-time DeterministicLoop — no real I/O, no
real time — and stay tier-1.
"""
import asyncio
import os
import random

import pytest

from mysticeti_tpu_torch.block_validator import (
    BatchedSignatureVerifier,
    HybridSignatureVerifier,
    SignatureVerifier,
)
from mysticeti_tpu_torch.chaos import (
    CrashFault,
    FaultPlan,
    LinkFault,
    PartitionFault,
    SafetyChecker,
    SafetyViolation,
    resolve_schedule,
    run_chaos_sim,
    schedule_bytes,
)
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.network import jittered_backoff
from mysticeti_tpu_torch.types import BlockReference
from mysticeti_tpu_torch.wal import HEADER_SIZE, WalReader


# ---------------------------------------------------------------------------
# Fault plan plumbing


def _full_plan(seed=11):
    return FaultPlan(
        seed=seed,
        link_faults=[
            LinkFault(drop_p=0.02, duplicate_p=0.01, delay_p=0.05,
                      delay_extra_s=(0.05, 0.2)),
        ],
        partitions=[
            PartitionFault(start_s=9.0, end_s=11.5, group_a=(0, 1),
                           group_b=tuple(range(2, 10)), symmetric=False),
        ],
        crashes=[
            CrashFault(node=7, at_s=3.0, downtime_s=3.0),
            CrashFault(node=8, at_s=4.0, downtime_s=3.0),
            CrashFault(node=9, at_s=5.0, downtime_s=3.0, torn_tail_bytes=12),
        ],
    )


def test_fault_plan_json_roundtrip():
    plan = _full_plan()
    again = FaultPlan.from_json(plan.to_json())
    assert again == plan
    assert again.to_json() == plan.to_json()
    # The resolved schedule is a pure function of the plan: byte-identical
    # without running anything, and ordered by (time, kind).
    assert schedule_bytes(again) == schedule_bytes(plan)
    times = [e["t"] for e in resolve_schedule(plan)]
    assert times == sorted(times)


def test_safety_checker_detects_forks_and_gaps():
    class _Commit:
        def __init__(self, height, anchor):
            self.height = height
            self.anchor = anchor

    a1 = BlockReference(0, 3, b"a" * 32)
    a2 = BlockReference(1, 3, b"b" * 32)
    checker = SafetyChecker()
    checker.observe(0, [_Commit(1, a1)])
    checker.observe(1, [_Commit(1, a1)])
    checker.check()
    with pytest.raises(SafetyViolation, match="fork at height 1"):
        checker.observe(2, [_Commit(1, a2)])
        checker.check()
    # A node re-observing the same height after WAL-replay must agree.
    with pytest.raises(SafetyViolation, match="two anchors"):
        checker.observe(0, [_Commit(1, a2)])
    # Gaps in a node's height sequence are a linearizer-order violation.
    checker2 = SafetyChecker()
    checker2.observe(0, [_Commit(1, a1), _Commit(3, a2)])
    with pytest.raises(SafetyViolation, match="gap"):
        checker2.sequence(0)


# ---------------------------------------------------------------------------
# The acceptance scenario


@pytest.mark.chaos
def test_ten_nodes_f3_crash_restart_with_partition(tmp_path):
    """10 nodes, f=3 staggered crash-restarts (overlapping downtime: three
    nodes down at once, exactly quorum left), one torn WAL tail, plus a
    timed asymmetric partition — identical committed prefixes everywhere,
    every restarted node catches up via WAL replay + sync, and a same-seed
    re-run yields a byte-identical fault schedule (and fault log, and
    commits)."""
    plan = _full_plan()
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    report, harness = run_chaos_sim(
        plan, 10, 15.0, str(tmp_path / "a"), with_metrics=True
    )
    replay, _ = run_chaos_sim(
        plan, 10, 15.0, str(tmp_path / "b"), with_metrics=True
    )

    # Byte-identical reproducibility: the resolved schedule trivially, the
    # per-message fault log (every drop/dup/delay draw) and the committed
    # sequences because the whole sim is seeded and single-threaded.
    assert report.schedule_bytes == replay.schedule_bytes
    assert report.fault_log_bytes == replay.fault_log_bytes
    assert report.sequences == replay.sequences

    # Safety: run_chaos_sim already ran checker.check(); assert the prefix
    # property explicitly as well.
    sequences = [report.sequences[a] for a in range(10)]
    longest = max(sequences, key=len)
    for seq in sequences:
        assert seq == longest[: len(seq)]

    # Liveness through the whole scenario (measured ~34 commits in 15 s
    # with this plan; 15 is the 2x-regression tripwire).
    lengths = [len(s) for s in sequences]
    assert all(length >= 15 for length in lengths), lengths

    # Every crashed node committed before its crash, recovered via WAL
    # replay (crash_recovery_total pins the Core recovery path), and caught
    # up well past its at-crash height after restart.
    assert len(report.crash_events) == 3
    for event in report.crash_events:
        node = event["node"]
        assert event["committed_height"] > 0, event
        metrics = harness.metrics[node]
        assert metrics.crash_recovery_total._value.get() == 1.0
        assert (
            harness.checker.committed_height(node)
            >= event["committed_height"] + 5
        ), event

    # Every fault flavor actually fired.
    for kind in ("dropped", "duplicated", "delayed", "blackhole", "crash",
                 "restart", "partition_start", "partition_end"):
        assert report.fault_counts.get(kind, 0) > 0, report.fault_counts


@pytest.mark.chaos
def test_torn_tail_recovery_mid_sim(tmp_path):
    """Crash a node mid-sim and tear its WAL tail: replay must stop cleanly
    at the tear (recovery truncates the torn bytes, leaving a fully
    replayable log) and the restarted node must rejoin and commit."""
    plan = FaultPlan(
        seed=5,
        crashes=[CrashFault(node=2, at_s=4.0, downtime_s=2.0,
                            torn_tail_bytes=10)],
    )
    report, harness = run_chaos_sim(
        plan, 4, 10.0, str(tmp_path), with_metrics=True
    )
    event = report.crash_events[0]
    assert harness.metrics[2].crash_recovery_total._value.get() == 1.0
    # Rejoined and committed past its pre-crash height.
    assert harness.checker.committed_height(2) > event["committed_height"]
    # Recovery truncated the tear before the first post-restart append: the
    # final ACTIVE segment (where the tear landed and appends resumed)
    # replays entry-by-entry to EXACTLY the end of file — no torn bytes left
    # behind, no unreplayable gap.
    from mysticeti_tpu_torch.storage import active_wal_file

    path = active_wal_file(os.path.join(str(tmp_path), "wal-2"))
    reader = WalReader(path)
    end = 0
    for pos, _tag, payload in reader.iter_until():
        end = pos + HEADER_SIZE + len(payload)
    reader.close()
    assert end == os.path.getsize(path)


# ---------------------------------------------------------------------------
# Verifier-path graceful degradation


class ScriptedTpuBackend(SignatureVerifier):
    """Accepts everything (or, with ``inner``, answers as ``inner`` does)
    until ``dead`` is flipped, then raises the outage the remote verifier
    client propagates after its retry budget."""

    def __init__(self, inner=None) -> None:
        self.dead = False
        self.calls = 0
        self.inner = inner

    def verify_signatures(self, public_keys, digests, signatures):
        self.calls += 1
        if self.dead:
            raise ConnectionError("verifier service is down")
        if self.inner is not None:
            return self.inner.verify_signatures(public_keys, digests, signatures)
        return [True] * len(signatures)


class StubCpuBackend(SignatureVerifier):
    def __init__(self, inner=None) -> None:
        self.calls = 0
        self.inner = inner

    def verify_signatures(self, public_keys, digests, signatures):
        self.calls += 1
        if self.inner is not None:
            return self.inner.verify_signatures(public_keys, digests, signatures)
        return [True] * len(signatures)


@pytest.mark.chaos
def test_verifier_outage_degrades_to_cpu_with_zero_failed_blocks(tmp_path):
    """Killing the (injected) accelerator backend mid-run flips every node's
    circuit breaker to CPU fallback — asserted via verifier_fallback_total —
    with zero failed blocks and uninterrupted commit progress.  Both routes
    verify for real through the port's ``cpu`` kind (its
    ``CpuSignatureVerifier``) over the benchmark committee's keys; the
    accelerator route is the scripted one that dies."""
    from mysticeti_tpu_torch.block_validator import CpuSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee

    backends = {}
    kill_heights = {}

    def factory(authority, committee, metrics):
        tpu = ScriptedTpuBackend(CpuSignatureVerifier())
        cpu = StubCpuBackend(CpuSignatureVerifier())
        backends[authority] = (tpu, cpu)
        hybrid = HybridSignatureVerifier(
            tpu=tpu, cpu=cpu, threshold=1, metrics=metrics
        )
        return BatchedSignatureVerifier(committee, hybrid, metrics=metrics)

    async def kill(harness):
        await asyncio.sleep(5.0)
        for authority, (tpu, _cpu) in backends.items():
            tpu.dead = True
            kill_heights[authority] = harness.committed_height(authority)

    report, harness = run_chaos_sim(
        FaultPlan(seed=3), 4, 12.0, str(tmp_path),
        verifier_factory=factory, with_metrics=True, extra_fault=kill,
        committee=Committee.new_for_benchmarks(4),
    )
    for authority in range(4):
        metrics = harness.metrics[authority]
        tpu, cpu = backends[authority]
        # The breaker tripped on the outage...
        assert metrics.verifier_fallback_total._value.get() >= 1.0
        # ...batches kept verifying on the oracle...
        assert cpu.calls > 0
        # ...no block ever failed verification (an outage is not a verdict)...
        assert 'outcome="rejected"' not in metrics.expose().decode()
        # ...and the node kept committing after the kill.
        assert (
            harness.checker.committed_height(authority)
            > kill_heights[authority]
        )
    # Accelerator-routed batches happened before the kill on every node.
    assert all(tpu.calls > 0 for tpu, _ in backends.values())


def test_breaker_opens_falls_back_and_reprobes():
    """Unit: outage trips the breaker (fallback answers the batch), the
    accelerator route stays closed until the probe deadline, and a
    successful probe closes the circuit."""
    clock = {"t": 0.0}
    tpu, cpu = ScriptedTpuBackend(), StubCpuBackend()
    metrics = Metrics()
    hybrid = HybridSignatureVerifier(tpu=tpu, cpu=cpu, threshold=1,
                                     metrics=metrics)
    hybrid._breaker_clock = lambda: clock["t"]
    batch = ([b"k" * 32], [b"d" * 32], [b"s" * 64])

    tpu.dead = True
    assert hybrid.verify_signatures(*batch) == [True]  # fallback answered
    assert hybrid.breaker_open
    assert metrics.verifier_fallback_total._value.get() == 1.0
    assert hybrid.backend_label == "hybrid-cpu"

    # While open (before the probe deadline) the accelerator is not touched.
    calls = tpu.calls
    assert hybrid.verify_signatures(*batch) == [True]
    assert tpu.calls == calls

    # Past the deadline one probe goes through; success closes the circuit.
    tpu.dead = False
    clock["t"] = 100.0
    assert hybrid.verify_signatures(*batch) == [True]
    assert tpu.calls == calls + 1
    assert not hybrid.breaker_open
    assert hybrid.backend_label == "hybrid-tpu"


def test_breaker_backoff_doubles_with_bounded_jitter():
    clock = {"t": 0.0}
    tpu, cpu = ScriptedTpuBackend(), StubCpuBackend()
    tpu.dead = True
    hybrid = HybridSignatureVerifier(tpu=tpu, cpu=cpu, threshold=1)
    hybrid._breaker_clock = lambda: clock["t"]
    batch = ([b"k" * 32], [b"d" * 32], [b"s" * 64])

    expected = 1.0
    for _ in range(8):
        clock["t"] += 1000.0  # always past the probe deadline: probe + fail
        hybrid.verify_signatures(*batch)
        assert hybrid._breaker_backoff_s == min(
            expected, hybrid.BREAKER_MAX_BACKOFF_S
        )
        # The probe deadline is jittered to [0.5, 1.5)x the backoff so a
        # fleet that lost one shared service never re-probes in lockstep.
        wait = hybrid._breaker_open_until - clock["t"]
        assert 0.5 * hybrid._breaker_backoff_s <= wait
        assert wait < 1.5 * hybrid._breaker_backoff_s
        expected = min(expected * 2.0, hybrid.BREAKER_MAX_BACKOFF_S)


def test_breaker_protocol_error_fails_fast():
    """A VerifierProtocolError (committee mismatch) is a configuration bug,
    not an outage: it propagates and must NOT trip the breaker."""
    from mysticeti_tpu_torch.block_validator import VerifierProtocolError

    class RejectingTpu(SignatureVerifier):
        def verify_signatures(self, public_keys, digests, signatures):
            raise VerifierProtocolError("committee mismatch")

    metrics = Metrics()
    hybrid = HybridSignatureVerifier(
        tpu=RejectingTpu(), cpu=StubCpuBackend(), threshold=1, metrics=metrics
    )
    with pytest.raises(VerifierProtocolError):
        hybrid.verify_signatures([b"k" * 32], [b"d" * 32], [b"s" * 64])
    assert not hybrid.breaker_open
    assert metrics.verifier_fallback_total._value.get() == 0.0


def test_breaker_admits_exactly_one_probe():
    """While a probe is in flight, further dispatches keep falling back even
    after the backoff window re-elapses (a hung service must not collect a
    pile of stuck dispatch threads)."""
    clock = {"t": 0.0}
    tpu = ScriptedTpuBackend()
    tpu.dead = True
    hybrid = HybridSignatureVerifier(tpu=tpu, cpu=StubCpuBackend(),
                                     threshold=1)
    hybrid._breaker_clock = lambda: clock["t"]

    def blocks() -> bool:
        # NB: admission is a side effect — the first non-blocked call after
        # the deadline CLAIMS the exclusive probe slot.
        return hybrid._admit_accelerator()[0]

    hybrid.verify_signatures([b"k" * 32], [b"d" * 32], [b"s" * 64])  # trip
    clock["t"] = 1000.0
    assert not blocks()  # the probe slot
    assert blocks()      # exclusive: everyone else blocked
    clock["t"] = 2000.0
    assert blocks()      # still held by the in-flight probe
    hybrid._clear_probe()  # probe path releases on non-outage
    assert not blocks()  # next probe admitted


def test_stale_success_after_trip_does_not_close_breaker():
    """Pipeline depth >= 2: a batch submitted BEFORE the outage can surface
    its success at fetch AFTER a newer failure tripped the circuit (its
    reply was already in the socket buffer).  That stale evidence must not
    re-close the breaker or reset the backoff escalation — the route would
    otherwise flap between dead-backend timeouts all outage long."""
    tpu = ScriptedTpuBackend()
    hybrid = HybridSignatureVerifier(tpu=tpu, cpu=StubCpuBackend(),
                                     threshold=1)
    batch = ([b"k" * 32], [b"d" * 32], [b"s" * 64])
    d0 = hybrid.verify_signatures_async(*batch)  # submitted while healthy
    d1 = hybrid.verify_signatures_async(*batch)  # submitted while healthy
    tpu.dead = True
    assert d1.result() == [True]  # outage at fetch: trips, oracle serves it
    assert hybrid.breaker_open
    backoff = hybrid._breaker_backoff_s
    tpu.dead = False  # d0's reply was buffered pre-outage
    assert d0.result() == [True]  # succeeds on the accelerator route
    assert hybrid.breaker_open, "stale success must not close the circuit"
    assert hybrid._breaker_backoff_s == backoff


def test_non_probe_fetch_failure_keeps_probe_exclusivity():
    """While a probe is in flight, a pre-outage straggler failing at fetch
    trips the breaker again but must NOT release the hung probe's exclusive
    slot — 'a hung probe admits no further victims' has to survive
    concurrent non-probe failures."""
    clock = {"t": 0.0}
    tpu = ScriptedTpuBackend()
    hybrid = HybridSignatureVerifier(tpu=tpu, cpu=StubCpuBackend(),
                                     threshold=1)
    hybrid._breaker_clock = lambda: clock["t"]
    batch = ([b"k" * 32], [b"d" * 32], [b"s" * 64])
    straggler = hybrid.verify_signatures_async(*batch)  # healthy submit
    tpu.dead = True
    hybrid.verify_signatures(*batch)  # trip
    assert hybrid.breaker_open
    clock["t"] = 1000.0
    assert not hybrid._admit_accelerator()[0]  # probe admitted (now hung)
    assert straggler.result() == [True]  # fails at fetch -> oracle serves it
    clock["t"] = 2000.0
    assert hybrid._admit_accelerator()[0], \
        "a non-probe failure must not readmit dispatches past a live probe"


def test_breaker_counts_degraded_batches_not_trips():
    """verifier_fallback_total counts every batch served by the oracle while
    the accelerator path is down, matching its help text."""
    tpu = ScriptedTpuBackend()
    tpu.dead = True
    metrics = Metrics()
    hybrid = HybridSignatureVerifier(tpu=tpu, cpu=StubCpuBackend(),
                                     threshold=1, metrics=metrics)
    hybrid._breaker_clock = lambda: 0.0  # frozen clock: never re-probes
    batch = ([b"k" * 32], [b"d" * 32], [b"s" * 64])
    for _ in range(5):
        hybrid.verify_signatures(*batch)
    assert metrics.verifier_fallback_total._value.get() == 5.0
    assert tpu.calls == 1  # only the tripping dispatch touched the backend


def test_breaker_survives_warmup_outage():
    """An unreachable backend at boot must not kill the warmup thread: the
    hybrid calibrates the oracle, trips the breaker, and serves on CPU."""
    tpu, cpu = ScriptedTpuBackend(), StubCpuBackend()
    tpu.dead = True
    hybrid = HybridSignatureVerifier(tpu=tpu, cpu=cpu, metrics=Metrics())

    def failing_warmup():
        raise ConnectionError("service not up yet")

    tpu.warmup = failing_warmup
    hybrid.warmup()  # must not raise
    assert hybrid.breaker_open
    assert hybrid.cpu_per_sig_s > 0.0  # oracle still calibrated


def test_own_block_reproposal_wins_dissemination_index(tmp_path):
    """After a torn-tail restart, the round we actually RE-PROPOSE must win
    the own-block dissemination index over a peer-delivered copy of the
    lost pre-crash block — our later blocks build on the re-proposal."""
    from mysticeti_tpu_torch.block_store import BlockStore
    from mysticeti_tpu_torch.wal import walf

    writer, reader = walf(str(tmp_path / "wal"))
    store = BlockStore(0, 4, reader)
    lost = BlockReference(0, 5, b"a" * 32)       # pre-crash block, via peer
    reproposed = BlockReference(0, 5, b"b" * 32)  # post-restart proposal
    store._add_own_index(lost)
    store._add_own_index(reproposed, proposed=True)
    assert store._own_blocks[5] == reproposed.digest
    store._add_own_index(lost)  # a late duplicate never demotes the proposal
    assert store._own_blocks[5] == reproposed.digest
    writer.close()
    reader.close()


# ---------------------------------------------------------------------------
# Remote verifier client: bounded retries + backoff


def test_remote_client_bounded_retries_when_service_absent(tmp_path):
    from mysticeti_tpu_torch.verifier_service import RemoteSignatureVerifier

    metrics = Metrics()
    client = RemoteSignatureVerifier(
        socket_path=str(tmp_path / "absent.sock"),
        committee_keys=[b"\x01" * 32],
        metrics=metrics,
        max_attempts=3,
    )
    client.RETRY_BASE_BACKOFF_S = 0.001  # keep the test fast
    with pytest.raises(OSError):
        client.verify_signatures([b"\x01" * 32], [bytes(32)], [bytes(64)])
    # Every failed attempt tore down (or failed to build) a connection.
    assert metrics.verifier_reconnect_total._value.get() == 3.0


def test_breaker_catches_exhausted_remote_retries(tmp_path):
    """Integration: Hybrid(tpu=RemoteSignatureVerifier) against a dead
    service — the client's retry budget exhausts, the breaker catches the
    propagated OSError, and the batch is answered by the oracle."""
    from mysticeti_tpu_torch.verifier_service import RemoteSignatureVerifier

    metrics = Metrics()
    remote = RemoteSignatureVerifier(
        socket_path=str(tmp_path / "dead.sock"),
        committee_keys=[b"\x01" * 32],
        metrics=metrics,
        max_attempts=2,
    )
    remote.RETRY_BASE_BACKOFF_S = 0.001
    hybrid = HybridSignatureVerifier(
        tpu=remote, cpu=StubCpuBackend(), threshold=1, metrics=metrics
    )
    out = hybrid.verify_signatures([b"\x01" * 32], [bytes(32)], [bytes(64)])
    assert out == [True]
    assert hybrid.breaker_open
    assert metrics.verifier_fallback_total._value.get() == 1.0
    assert metrics.verifier_reconnect_total._value.get() == 2.0


def test_remote_client_retry_rides_out_service_restart(tmp_path):
    """A service restart mid-burst is a retry, not an outage: the client's
    bounded backoff bridges the listener gap without surfacing an error."""
    from concurrent.futures import ThreadPoolExecutor

    from mysticeti_tpu_torch import crypto
    from mysticeti_tpu_torch.verifier_service import (
        RemoteSignatureVerifier,
        VerifierServer,
    )

    signer = crypto.Signer.from_seed(b"\x07" * 32)
    keys = [signer.public_key.bytes]
    digest = crypto.blake2b_256(b"retry")
    metrics = Metrics()

    async def main():
        loop = asyncio.get_running_loop()
        pool = ThreadPoolExecutor(max_workers=1)
        client = RemoteSignatureVerifier(
            socket_path=str(tmp_path / "verifier.sock"),
            committee_keys=keys,
            metrics=metrics,
        )

        def call():
            return client.verify_signatures(
                keys, [digest], [signer.sign(digest)]
            )

        server1 = VerifierServer(client.socket_path, committee_keys=keys,
                                 backend=StubCpuBackend())
        await server1.start()
        assert await loop.run_in_executor(pool, call) == [True]
        await server1.stop()
        # Socket gone: the call below must retry through the gap while the
        # replacement server comes up.
        future = loop.run_in_executor(pool, call)
        await asyncio.sleep(0.05)
        server2 = VerifierServer(client.socket_path, committee_keys=keys,
                                 backend=StubCpuBackend())
        await server2.start()
        try:
            assert await future == [True]
        finally:
            await server2.stop()
            pool.shutdown(wait=False)

    asyncio.run(main())
    assert metrics.verifier_reconnect_total._value.get() >= 1.0


# ---------------------------------------------------------------------------
# Dial backoff jitter (network.py)


def test_jittered_backoff_is_seeded_and_bounded():
    a = [jittered_backoff(1.0, random.Random(5)) for _ in range(1)]
    b = [jittered_backoff(1.0, random.Random(5)) for _ in range(1)]
    assert a == b  # seeded: reproducible
    rng = random.Random(9)
    draws = [jittered_backoff(2.0, rng) for _ in range(64)]
    assert all(1.0 <= d < 3.0 for d in draws)  # [0.5, 1.5) x delay
    assert len(set(draws)) > 32  # actually jittered, not constant


# ---------------------------------------------------------------------------
# CLI


def test_chaos_cli_replays_plan_from_json(tmp_path, capsys):
    from mysticeti_tpu_torch.cli import main

    plan = FaultPlan(
        seed=2,
        link_faults=[LinkFault(drop_p=0.05)],
        crashes=[CrashFault(node=1, at_s=2.0, downtime_s=1.5)],
    )
    plan_path = tmp_path / "plan.json"
    plan_path.write_text(plan.to_json())
    rc = main([
        "chaos", "--plan", str(plan_path), "--nodes", "4",
        "--duration", "6", "--working-directory", str(tmp_path / "wals"),
        "--verifier", "sim-oracle",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fault schedule digest:" in out
    assert "safety: OK" in out
    assert "crash=1" in out

    rc = main(["chaos", "--plan", str(plan_path), "--dump-schedule"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "'kind': 'crash'" in out and "'kind': 'restart'" in out


# ---------------------------------------------------------------------------
# Parities: both packages, the same plan


def _plans(pkg):
    import importlib

    chaos = importlib.import_module(f"{pkg}.chaos")
    adversary = importlib.import_module(f"{pkg}.adversary")
    rng = random.Random(4)
    plans = []
    for seed in range(3):
        plans.append(chaos.FaultPlan(
            seed=seed,
            link_faults=[chaos.LinkFault(drop_p=rng.random() / 10, src=rng.randrange(5),
                                         start_s=rng.random(), end_s=5.0 + rng.random())],
            partitions=[chaos.PartitionFault(start_s=rng.uniform(0, 4), end_s=rng.uniform(4, 8),
                                             group_a=(0, 1), group_b=(2, 3, 4),
                                             symmetric=bool(seed % 2))],
            crashes=[chaos.CrashFault(node=rng.randrange(5), at_s=rng.uniform(0, 5),
                                      downtime_s=rng.uniform(0.5, 3),
                                      torn_tail_bytes=rng.randrange(20))
                     for _ in range(2)],
            adversaries=[adversary.AdversarySpec(node=4, behavior="lag", start_s=1.0)],
        ))
    return plans


def test_schedule_bytes_equal_the_jax_packages():
    from mysticeti_tpu import chaos as J

    port_plans, jax_plans = _plans("mysticeti_tpu_torch"), _plans("mysticeti_tpu")
    for port, jax in zip(port_plans + [_full_plan()], jax_plans + [J.FaultPlan.from_json(
            _full_plan().to_json())]):
        assert port.to_json() == jax.to_json()
        assert schedule_bytes(port) == J.schedule_bytes(jax)


def _refs(sequences):
    return {a: [(r.authority, r.round, bytes(r.digest)) for r in seq]
            for a, seq in sequences.items()}


def test_chaos_sim_equals_the_jax_packages(tmp_path):
    """A 7-node run with link faults, an asymmetric partition, three
    crash-restarts (one with a torn WAL tail) and the SLO watchdog, on each
    package: the committed sequences, the fault log, the detections, every
    flight-recorder dump and the health timeline and alerts are equal."""
    from mysticeti_tpu import chaos as J
    from mysticeti_tpu import health as JH
    from mysticeti_tpu_torch.health import SLOThresholds

    plan = FaultPlan(
        seed=19,
        link_faults=[LinkFault(drop_p=0.03, duplicate_p=0.02, delay_p=0.05,
                               delay_extra_s=(0.05, 0.2))],
        partitions=[PartitionFault(start_s=5.0, end_s=7.0, group_a=(0,),
                                   group_b=tuple(range(1, 7)), symmetric=False)],
        crashes=[CrashFault(node=4, at_s=2.0, downtime_s=2.0),
                 CrashFault(node=5, at_s=3.0, downtime_s=2.5, torn_tail_bytes=13),
                 CrashFault(node=6, at_s=6.0, downtime_s=1.5, torn_tail_bytes=40)],
    )
    slo = dict(max_round_stall_s=4.0, max_commit_stall_s=5.0, max_authority_lag_rounds=8)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port, _ = run_chaos_sim(plan, 7, 10.0, str(tmp_path / "port"), with_metrics=True,
                            slo=SLOThresholds(**slo))
    jax, _ = J.run_chaos_sim(J.FaultPlan.from_json(plan.to_json()), 7, 10.0,
                             str(tmp_path / "jax"), with_metrics=True,
                             slo=JH.SLOThresholds(**slo))
    assert _refs(port.sequences) == _refs(jax.sequences)
    assert min(len(seq) for seq in port.sequences.values()) > 0
    assert port.fault_log_bytes == jax.fault_log_bytes
    assert port.fault_counts == jax.fault_counts and port.fault_counts["crash"] == 3
    assert port.detections_bytes() == jax.detections_bytes()
    assert port.recorder_dumps == jax.recorder_dumps
    assert port.health_timeline_bytes == jax.health_timeline_bytes
    assert port.health_timeline
    assert port.slo_alerts == jax.slo_alerts


@pytest.mark.parametrize("adversaries", [False, True], ids=["benign", "byzantine"])
def test_chaos_cli_output_equals_the_jax_clis(tmp_path, capsys, adversaries):
    """``chaos --verifier sim-oracle`` prints what the JAX CLI prints for
    the same plan (the JAX CLI's own verifier: none for the benign plan,
    the sim re-sign oracle for the Byzantine one)."""
    from mysticeti_tpu.cli import main as jax_main
    from mysticeti_tpu_torch.adversary import AdversarySpec
    from mysticeti_tpu_torch.cli import main

    plan = FaultPlan(
        seed=6,
        link_faults=[LinkFault(drop_p=0.05)],
        crashes=[CrashFault(node=1, at_s=1.0, downtime_s=1.0)],
        adversaries=[AdversarySpec(node=3, behavior="invalid_sig")] if adversaries else [],
    )
    plan_path = tmp_path / "plan.json"
    plan_path.write_text(plan.to_json())
    args = ["chaos", "--plan", str(plan_path), "--nodes", "4", "--duration", "3"]
    assert jax_main(args + ["--working-directory", str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out
    assert main(args + ["--working-directory", str(tmp_path / "port"),
                        "--verifier", "sim-oracle"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert ("detected by A0 [invalid_blocks]: authority=3,reason=signature=" in got) == adversaries


def test_chaos_cli_defaults_to_the_card(tmp_path):
    """With no ``--verifier`` the nodes verify on the card: without one,
    ``chaos`` raises before the simulation starts."""
    from mysticeti_tpu_torch.cli import build_parser, main

    assert build_parser().parse_args(["chaos", "--plan", "p"]).verifier == "cuda-only"
    plan_path = tmp_path / "plan.json"
    plan_path.write_text(FaultPlan(seed=1).to_json())
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default kind would run")
    with pytest.raises(RuntimeError):
        main(["chaos", "--plan", str(plan_path), "--nodes", "4", "--duration", "1",
              "--working-directory", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
