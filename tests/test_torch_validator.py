"""The port's node assembly (``mysticeti_tpu_torch.validator``) against the
JAX package's.

Counterparts of ``tests/test_validator.py``'s nine whole-node tests over real
localhost TCP, with the reference's verifier kinds and ``_make_verifier``'s
mapped to the port's ``cuda*`` kinds; a ``cuda-only`` node on
``device="cpu"`` (the kernels' plain versions); the counterpart of
``tests/test_threshold_aggregate.py::test_validators_commit_with_aggregate_verifier``;
a mixed fleet of two JAX and two port validators over loopback; the
``/debug/consensus`` document against the JAX ``Validator``'s for cores both
packages drive through the same steps; ``flight_recorder.path_from_env``;
and the flight-recorder dump at ``Validator.stop``.
"""
import asyncio
import importlib
import json
import os
import socket

import pytest
import torch

from mysticeti_tpu_torch import block_validator as bv
from mysticeti_tpu_torch.cli import benchmark_genesis
from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.config import Parameters
from mysticeti_tpu_torch.validator import CommitConsumer, Validator, _make_verifier

PORT, JAX = "mysticeti_tpu_torch", "mysticeti_tpu"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def _setup(tmp_path, n, pkg=PORT, ports=None):
    """``tests/test_validator.py``'s ``_setup`` over either package."""
    config = _mod(pkg, "config")
    committee_mod = _mod(pkg, "committee")
    ports = ports or _free_ports(2 * n)
    identifiers = [config.Identifier("127.0.0.1", ports[2 * i], ports[2 * i + 1])
                   for i in range(n)]
    parameters = config.Parameters(identifiers=identifiers, leader_timeout_s=0.5)
    signers = committee_mod.Committee.benchmark_signers(n)
    committee = committee_mod.Committee(
        [committee_mod.Authority(1, s.public_key) for s in signers])
    privates = [config.PrivateConfig.new_in_dir(i, str(tmp_path / f"v{i}")) for i in range(n)]
    return committee, parameters, signers, privates


async def _start_all(committee, parameters, signers, privates, n, verifier="accept",
                     validator=Validator, **kwargs):
    return [
        await validator.start_benchmarking(
            i, committee, parameters, privates[i], signer=signers[i], tps=20,
            serve_metrics_endpoint=(i == 0), verifier=verifier, **kwargs)
        for i in range(n)
    ]


async def _wait_commits(validators, minimum, timeout_s):
    async def poll():
        while True:
            if all(len(v.committed_leaders()) >= minimum for v in validators):
                return
            await asyncio.sleep(0.2)

    await asyncio.wait_for(poll(), timeout=timeout_s)


def _refs(seq):
    return [(r.authority, r.round, r.digest) for r in seq]


def _agree(sequences):
    longest = max(sequences, key=len)
    return all(seq == longest[: len(seq)] for seq in sequences)


def test_make_verifier_kinds(monkeypatch):
    """Every ``--verifier`` choice constructs, the JAX package's kinds mapped
    to the port's (``tpu`` -> ``cuda``, ``tpu-only`` -> ``cuda-only``); the
    accelerator kinds place their kernels on ``device``, and with no card
    and no device they raise rather than run on the CPU."""
    monkeypatch.setattr(bv.HybridSignatureVerifier, "warmup", lambda self: None)
    monkeypatch.setattr(bv.TorchSignatureVerifier, "warmup", lambda self: None)
    committee = Committee.new_for_benchmarks(4)

    v = _make_verifier("cuda", committee, device="cpu")
    assert isinstance(v, bv.BatchedSignatureVerifier)
    assert isinstance(v.verifier, bv.HybridSignatureVerifier)
    assert isinstance(v.verifier.tpu, bv.TorchSignatureVerifier)

    v = _make_verifier("cuda-only", committee, device="cpu")
    assert isinstance(v.verifier, bv.TorchSignatureVerifier)
    assert v.verifier.device.type == "cpu"

    v = _make_verifier("cpu", committee)
    assert isinstance(v.verifier, bv.CpuSignatureVerifier)

    assert isinstance(_make_verifier("accept", committee), bv.AcceptAllBlockVerifier)
    for kind in ("gpu", "tpu", "tpu-only"):
        with pytest.raises(ValueError):
            _make_verifier(kind, committee)
    if not torch.cuda.is_available():
        for kind in ("cuda", "cuda-only"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                _make_verifier(kind, committee)


def test_start_benchmarking_defaults_to_the_card(tmp_path):
    """``start_benchmarking``'s kind is ``cuda-only`` unless the caller asks
    for another, as the CLI's is: with no card it raises rather than verify
    on the CPU."""
    import inspect

    default = inspect.signature(Validator.start_benchmarking).parameters["verifier"].default
    assert default == "cuda-only"
    if not torch.cuda.is_available():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asyncio.run(Validator.start_benchmarking(
                0, committee, parameters, privates[0], signer=signers[0],
                serve_metrics_endpoint=False))


def test_validator_commit(tmp_path):
    """4 validators over localhost TCP commit leaders (validator_commit)."""

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = await _start_all(committee, parameters, signers, privates, 4)
        try:
            await _wait_commits(validators, minimum=2, timeout_s=60)
        finally:
            for v in validators:
                await v.stop()
        assert _agree([_refs(v.committed_leaders()) for v in validators])

    asyncio.run(main())


def test_cuda_only_node_on_the_cpu_commits(tmp_path, monkeypatch):
    """A ``cuda-only`` node with its kernels' plain versions
    (``device="cpu"``) among three ``cpu``-kind nodes: it warms up, verifies
    every block through the collector and commits the fleet's sequence."""
    monkeypatch.setenv("MYSTICETI_VERIFY_WINDOW_MS", "300")

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = await _start_all(committee, parameters, signers, privates, 3,
                                      verifier="cpu")
        accelerated = await Validator.start_benchmarking(
            3, committee, parameters, privates[3], signer=signers[3], tps=20,
            serve_metrics_endpoint=False, verifier="cuda-only", device="cpu")
        validators.append(accelerated)
        try:
            await _wait_commits([accelerated], minimum=2, timeout_s=120)
        finally:
            for v in validators:
                await v.stop()
        collector = accelerated.network_syncer.block_verifier
        assert isinstance(collector.verifier, bv.TorchSignatureVerifier)
        assert collector.verifier.device.type == "cpu"
        get = accelerated.metrics.registry.get_sample_value
        assert get("verified_signatures_total",
                   {"backend": "TorchSignatureVerifier", "outcome": "accepted"}) > 0
        assert _agree([_refs(v.committed_leaders()) for v in validators])

    asyncio.run(main())


def test_validator_sync_late_boot(tmp_path):
    """A late-booting node catches up through subscribe/sync (validator_sync)."""

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = await _start_all(committee, parameters, signers, privates, 3)
        try:
            await _wait_commits(validators, minimum=2, timeout_s=60)
            late = await Validator.start_benchmarking(
                3, committee, parameters, privates[3], signer=signers[3],
                tps=20, serve_metrics_endpoint=False, verifier="cpu",
            )
            validators.append(late)
            await _wait_commits([late], minimum=1, timeout_s=60)
        finally:
            for v in validators:
                await v.stop()

    asyncio.run(main())


def test_validator_crash_faults(tmp_path):
    """3 of 4 validators keep committing (validator_crash_faults)."""

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = await _start_all(committee, parameters, signers, privates, 3)
        try:
            await _wait_commits(validators, minimum=2, timeout_s=90)
        finally:
            for v in validators:
                await v.stop()

    asyncio.run(main())


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(-1), timeout=10)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


def test_validator_metrics_endpoint(tmp_path):
    """The /metrics endpoint serves the benchmark-defining series; /health
    and /debug/consensus serve the node's diagnosis and consensus state."""

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = await _start_all(committee, parameters, signers, privates, 4)
        try:
            await _wait_commits(validators, minimum=1, timeout_s=60)
            host, port = parameters.metrics_address(0)
            status, data = await _get(port, "/metrics")
            assert status == 200
            assert b"committed_leaders_total" in data
            assert b"benchmark_duration" in data
            status, data = await _get(port, "/health")
            assert status in (200, 503) and json.loads(data)["authority"] == 0
            status, data = await _get(port, "/debug/consensus")
            doc = json.loads(data)
            assert status == 200 and doc["authority"] == 0
            assert set(doc["frontier"]) == {"0", "1", "2", "3"} and doc["highest_round"] > 0
        finally:
            for v in validators:
                await v.stop()

    asyncio.run(main())


def test_benchmark_genesis_roundtrip(tmp_path):
    wd = str(tmp_path / "genesis")
    benchmark_genesis(["10.0.0.1", "10.0.0.2", "10.0.0.3"], wd)
    committee = Committee.load(os.path.join(wd, "committee.yaml"))
    parameters = Parameters.load(os.path.join(wd, "parameters.yaml"))
    assert len(committee) == 3
    assert len(parameters.identifiers) == 3
    assert parameters.identifiers[1].hostname == "10.0.0.2"
    assert os.path.exists(os.path.join(wd, "validator-0", "seed"))


def test_validator_shutdown_and_start(tmp_path):
    """Stop the whole committee, restart on the SAME ports with the SAME
    WALs, and commits must resume past the pre-restart point."""

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = await _start_all(committee, parameters, signers, privates, 4)
        try:
            await _wait_commits(validators, minimum=2, timeout_s=60)
        finally:
            for v in validators:
                await v.stop()
        before = min(len(v.committed_leaders()) for v in validators)
        assert before >= 2
        await asyncio.sleep(0.5)
        restarted = await _start_all(committee, parameters, signers, privates, 4)
        try:
            await _wait_commits(restarted, minimum=before + 2, timeout_s=60)
        finally:
            for v in restarted:
                await v.stop()

    asyncio.run(main())


def test_production_validators_commit_submitted_txs(tmp_path):
    """Production tier: SimpleBlockHandler ingestion, SimpleCommitObserver ->
    CommitConsumer delivery, submit-ack callbacks (the ``cpu`` kind; the
    port's default is ``cuda``)."""
    n = 4
    committee, parameters, signers, privates = _setup(tmp_path, n)

    async def main():
        started = [
            await Validator.start_production(
                i, committee, parameters, privates[i], signer=signers[i], verifier="cpu")
            for i in range(n)
        ]
        validators = [v for v, _, _ in started]
        handlers = [h for _, h, _ in started]
        consumers = [c for _, _, c in started]
        try:
            acked = []
            payloads = [f"tx-{i}".encode() for i in range(20)]
            for i, p in enumerate(payloads):
                handlers[i % n].submit(p, done=lambda p=p: acked.append(p))

            async def collect(consumer, want, timeout_s=60.0):
                got = set()
                loop = asyncio.get_event_loop()
                deadline = loop.time() + timeout_s
                while len(got) < len(want):
                    remaining = deadline - loop.time()
                    assert remaining > 0, f"only {len(got)}/{len(want)} delivered"
                    sub_dag = await asyncio.wait_for(consumer.queue.get(), timeout=remaining)
                    for block in sub_dag.blocks:
                        for _, tx in block.shared_transactions():
                            if tx in want:
                                got.add(tx)
                return got

            want = set(payloads)
            assert await collect(consumers[0], want) == want
            assert await collect(consumers[1], want) == want
            assert set(acked) == want
        finally:
            for v in validators:
                await v.stop()

    asyncio.run(main())


def test_production_replay_above_last_sent_height(tmp_path):
    """SimpleCommitObserver recovery: a restarted node re-sends exactly the
    committed sub-dags above the consumer's last_sent_height."""
    n = 4
    committee, parameters, signers, privates = _setup(tmp_path, n)

    async def main():
        started = [
            await Validator.start_production(
                i, committee, parameters, privates[i], signer=signers[i], verifier="accept")
            for i in range(n)
        ]
        validators = [v for v, _, _ in started]
        consumers = [c for _, _, c in started]
        try:
            heights = []
            while len(heights) < 5:
                sub_dag = await asyncio.wait_for(consumers[0].queue.get(), 30.0)
                heights.append(sub_dag.height)
        finally:
            for v in validators:
                await v.stop()
        assert heights == sorted(heights)
        resumed = CommitConsumer(last_sent_height=heights[1])
        v0, _, consumer = await Validator.start_production(
            0, committee, parameters, privates[0], signer=signers[0],
            commit_consumer=resumed, verifier="accept")
        try:
            replayed = []
            while len(replayed) < len(heights) - 2:
                sub_dag = await asyncio.wait_for(consumer.queue.get(), 30.0)
                replayed.append(sub_dag.height)
            assert replayed[: len(heights) - 2] == heights[2:]
        finally:
            await v0.stop()

    asyncio.run(main())


def test_validators_commit_with_aggregate_verifier(tmp_path):
    """4 localhost validators with the collector's threshold-aggregate mode
    over the CPU oracle (``cpu-agg``) still commit, and the committed
    sequences stay consistent."""

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = [
            await Validator.start_benchmarking(
                i, committee, parameters, privates[i], signer=signers[i], tps=20,
                serve_metrics_endpoint=False, verifier="cpu-agg")
            for i in range(4)
        ]
        try:
            await _wait_commits(validators, minimum=2, timeout_s=60)
        finally:
            for v in validators:
                await v.stop()
        assert all(v.network_syncer.block_verifier.aggregate for v in validators)
        assert _agree([_refs(v.committed_leaders()) for v in validators])

    asyncio.run(main())


def test_mixed_fleet_of_both_packages_agrees(tmp_path):
    """Two JAX and two port validators, ``cpu`` kind, over loopback TCP with
    one genesis: every node commits, and the committed leader sequences
    agree on their common prefixes."""
    JValidator = _mod(JAX, "validator").Validator
    ports = _free_ports(8)
    port_setup = _setup(tmp_path / "port", 4, PORT, ports)
    jax_setup = _setup(tmp_path / "jax", 4, JAX, ports)

    async def main():
        validators = []
        try:
            for i in range(4):
                validator, (committee, parameters, signers, privates) = (
                    (JValidator, jax_setup) if i < 2 else (Validator, port_setup))
                validators.append(await validator.start_benchmarking(
                    i, committee, parameters, privates[i], signer=signers[i], tps=20,
                    serve_metrics_endpoint=False, verifier="cpu"))
            await _wait_commits(validators, minimum=3, timeout_s=60)
        finally:
            for v in validators:
                await v.stop()
        sequences = [_refs(v.committed_leaders()) for v in validators]
        assert min(len(seq) for seq in sequences) >= 3
        assert _agree(sequences)

    asyncio.run(main())


def _debug_docs(pkg, tmp_dir, rounds=6):
    """Four cores of ``pkg`` exchange every block for ``rounds`` rounds (the
    harness of ``tests/test_torch_core.py``) and commit; returns each
    ``Validator``'s ``/debug/consensus`` document over its core."""
    Committee_ = _mod(pkg, "committee").Committee
    committee = Committee_.new_test([1] * 4)
    signers = Committee_.benchmark_signers(4)
    core_mod = _mod(pkg, "core")
    cores = []
    for a in range(4):
        wal_writer, wal_reader = _mod(pkg, "wal").walf(f"{tmp_dir}/wal-{a}")
        recovered, _ = _mod(pkg, "block_store").BlockStore.open(a, wal_reader, wal_writer,
                                                                committee)
        handler = _mod(pkg, "block_handler").TestBlockHandler(
            last_transaction=a * 1_000_000, committee=committee, authority=a)
        cores.append(core_mod.Core(
            block_handler=handler, authority=a, committee=committee,
            parameters=_mod(pkg, "config").Parameters(), recovered=recovered,
            wal_writer=wal_writer, options=core_mod.CoreOptions.test(), signer=signers[a]))
    blocks = []
    for core in cores:
        core.run_block_handler([])
        blocks.append(core.try_new_block())
    for _ in range(rounds - 1):
        new = []
        for core in cores:
            core.add_blocks(blocks)
            new.append(core.try_new_block())
            core.try_commit()
        blocks = new
    docs = []
    for core in cores:
        shell = _mod(pkg, "validator").Validator()
        shell.core = core
        docs.append(shell._consensus_debug_doc())
        core.wal_writer.close()
    return docs


def test_consensus_debug_doc_equals_the_jax_packages(tmp_path):
    def run(pkg):
        (tmp_path / pkg).mkdir()

        async def main():
            return _debug_docs(pkg, str(tmp_path / pkg))

        return _mod(pkg, "runtime.simulated").run_simulation(main())

    port, jax = run(PORT), run(JAX)
    assert json.dumps(port, sort_keys=True) == json.dumps(jax, sort_keys=True)
    assert port[0]["highest_round"] == 6 and port[0]["records"]


@pytest.mark.parametrize("value", [None, "", "/x/rec-%p-%a.json", "/x/rec.json"])
@pytest.mark.parametrize("authority", [None, 3])
def test_path_from_env_equals_the_jax_packages(monkeypatch, value, authority):
    if value is None:
        monkeypatch.delenv("MYSTICETI_FLIGHT_RECORDER", raising=False)
    else:
        monkeypatch.setenv("MYSTICETI_FLIGHT_RECORDER", value)
    got = _mod(PORT, "flight_recorder").path_from_env(authority)
    assert got == _mod(JAX, "flight_recorder").path_from_env(authority)
    if value and "%" in value:
        assert got == f"/x/rec-{os.getpid()}-{authority if authority is not None else '%a'}.json"


def test_recorder_dump_at_stop(tmp_path, monkeypatch):
    """``MYSTICETI_FLIGHT_RECORDER`` with ``%a``: every node's ``stop``
    leaves its ring on disk, and the reporter's final sweep publishes the
    exact percentiles of the window (proposed block sizes)."""
    monkeypatch.setenv("MYSTICETI_FLIGHT_RECORDER", str(tmp_path / "rec-%a.json"))

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = await _start_all(committee, parameters, signers, privates, 4)
        try:
            await _wait_commits(validators, minimum=2, timeout_s=60)
        finally:
            for v in validators:
                await v.stop()
        return validators

    validators = asyncio.run(main())
    for a, v in enumerate(validators):
        with open(tmp_path / f"rec-{a}.json") as f:
            doc = json.load(f)
        assert doc["authority"] == a and doc["events"]
        assert v.recorder.dumps[-1]["trigger"] == "shutdown"
        get = v.metrics.registry.get_sample_value
        assert get("flight_recorder_dumps_total", {"trigger": "shutdown"}) == 1
        assert get("histogram_pct", {"name": "proposed_block_size_bytes", "pct": "50"}) > 0
