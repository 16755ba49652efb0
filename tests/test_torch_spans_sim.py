"""The ten-node deterministic sim under ``MYSTICETI_TRACE``, read by the
port's ``trace_report`` (its own file: a long test, and under ``--dist
loadfile`` a file is one worker's).

Counterpart of ``tests/test_spans.py::test_ten_node_sim_trace_report_and_
verifier_metrics`` (:163): ten port ``NetworkSyncer``s over the port's
``SimulatedNetwork`` for 8 virtual s yield a valid Chrome trace (every
pipeline stage of a committed block, per-track monotone virtual timestamps,
byte-identical across two same-seed runs and equal to the JAX package's run
of the same seed), ``python -m mysticeti_tpu_torch.tools.trace_report``
prints the per-stage breakdown from it (the JAX tool's output, byte for
byte), and the verifier batch-size, padding and route series are scrapeable
over the port's ``/metrics`` endpoint.
"""
import asyncio
import json
import os

from mysticeti_tpu_torch import crypto, spans
from mysticeti_tpu_torch.block_handler import TestBlockHandler
from mysticeti_tpu_torch.block_store import BlockStore
from mysticeti_tpu_torch.commit_observer import TestCommitObserver
from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.config import Parameters
from mysticeti_tpu_torch.core import Core, CoreOptions
from mysticeti_tpu_torch.net_sync import NetworkSyncer
from mysticeti_tpu_torch.runtime.simulated import run_simulation
from mysticeti_tpu_torch.simulated_network import SimulatedNetwork
from mysticeti_tpu_torch.spans import PIPELINE_STAGES, format_ref
from mysticeti_tpu_torch.tools import trace_report
from mysticeti_tpu_torch.wal import walf


class _SimNodeNetwork:
    def __init__(self, queue):
        self.connections = queue

    async def stop(self):
        pass


def _build_node(committee, signers, authority, tmp_dir, sim_net, parameters):
    wal_writer, wal_reader = walf(os.path.join(tmp_dir, f"wal-{authority}"))
    recovered, observer_recovered = BlockStore.open(authority, wal_reader, wal_writer, committee)
    handler = TestBlockHandler(last_transaction=authority * 1_000_000, committee=committee,
                               authority=authority)
    core = Core(block_handler=handler, authority=authority, committee=committee,
                parameters=parameters, recovered=recovered, wal_writer=wal_writer,
                options=CoreOptions.test(), signer=signers[authority])
    observer = TestCommitObserver(core.block_store, committee,
                                  recovered_state=observer_recovered)
    return NetworkSyncer(core, observer, _SimNodeNetwork(sim_net.node_connections[authority]),
                         parameters=parameters)


async def _run_nodes(n, tmp_dir, virtual_seconds):
    committee = Committee.new_test([1] * n)
    signers = Committee.benchmark_signers(n)
    parameters = Parameters(leader_timeout_s=1.0)
    sim_net = SimulatedNetwork(n)
    nodes = [_build_node(committee, signers, a, tmp_dir, sim_net, parameters)
             for a in range(n)]
    for node in nodes:
        await node.start()
    await sim_net.connect_all()
    await asyncio.sleep(virtual_seconds)
    for node in nodes:
        await node.stop()
    sim_net.close()
    return nodes


def _traced_sim_run(tmp_dir, seed):
    """One traced 10-node sim: (trace bytes, committed leader refs)."""
    tracer = spans.start_from_env()
    assert tracer is not None
    try:
        nodes = run_simulation(_run_nodes(10, tmp_dir, 8.0), seed=seed)
    finally:
        spans.stop_from_env()
    committed = [list(node.syncer.commit_observer.committed_leaders) for node in nodes]
    with open(os.environ["MYSTICETI_TRACE"].replace("%p", str(os.getpid())), "rb") as f:
        return f.read(), committed


def test_ten_node_sim_trace_report_and_verifier_metrics(tmp_path, monkeypatch, capsys):
    import test_spans as ref
    from tools import trace_report as jax_trace_report

    trace_path = tmp_path / "trace-%p.json"
    monkeypatch.setenv("MYSTICETI_TRACE", str(trace_path))
    for d in ("a", "b", "jax"):
        (tmp_path / d).mkdir()
    raw_a, committed = _traced_sim_run(str(tmp_path / "a"), seed=17)
    raw_b, _ = _traced_sim_run(str(tmp_path / "b"), seed=17)

    # Determinism: virtual-clocked spans of a seeded sim are byte-identical,
    # and the JAX package's run of the same seed writes the same bytes.
    assert raw_a == raw_b
    raw_jax, _ = ref._traced_sim_run(str(tmp_path / "jax"), seed=17)
    assert raw_a == raw_jax

    data = json.loads(raw_a)
    events = data["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert xs, "sim produced no spans"

    # Every pipeline stage is present for one mid-sequence committed leader.
    sequences = [seq for seq in committed if seq]
    assert sequences and all(len(s) >= 20 for s in sequences), [len(s) for s in committed]
    leader = sequences[0][len(sequences[0]) // 2]
    label = format_ref(leader)
    stages_for_leader = {e["name"] for e in xs if e["args"]["block"] == label}
    assert set(PIPELINE_STAGES) <= stages_for_leader, (label, sorted(stages_for_leader))

    # Virtual timestamps: non-negative, monotone per authority track.
    last_ts = {}
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert e["ts"] >= last_ts.get(e["tid"], 0), e
        last_ts[e["tid"]] = e["ts"]
    track_names = {e["args"]["name"] for e in events
                   if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {f"A{i}" for i in range(10)} <= track_names

    # trace_report prints a per-stage latency breakdown from the file, the
    # JAX tool's output byte for byte.
    path = str(trace_path).replace("%p", str(os.getpid()))
    for flags in ([], ["--critical-path"]):
        assert trace_report.main([path, *flags]) == 0
        out = capsys.readouterr()
        assert jax_trace_report.main([path, *flags]) == 0
        assert capsys.readouterr() == out
    assert trace_report.main([path]) == 0
    out = capsys.readouterr().out
    for stage in PIPELINE_STAGES:
        assert stage in out, out
    assert "p50_ms" in out and "p99_ms" in out

    # Verifier-path telemetry reaches the /metrics endpoint (real asyncio:
    # the collector, the hybrid router and the HTTP server need threads and
    # sockets the simulator forbids).
    scrape = asyncio.run(_verifier_metrics_scrape())
    assert "verify_dispatch_batch_size" in scrape
    assert 'verify_padding_wasted_total{backend="hybrid-tpu"}' in scrape
    assert 'verify_route_total{route="tpu"}' in scrape
    assert 'verify_route_total{route="cpu"}' in scrape
    assert "verify_batch_size" in scrape


async def _verifier_metrics_scrape() -> str:
    from mysticeti_tpu_torch.block_validator import (
        BatchedSignatureVerifier,
        CpuSignatureVerifier,
        HybridSignatureVerifier,
    )
    from mysticeti_tpu_torch.metrics import Metrics, serve_metrics
    from mysticeti_tpu_torch.types import Share, StatementBlock

    metrics = Metrics()
    committee = Committee.new_for_benchmarks(4)
    signers = Committee.benchmark_signers(4)

    class FakeCard(CpuSignatureVerifier):
        """The CPU oracle pretending to be a bucket-padded accelerator."""

        def padded_batch(self, n):
            return 256 if n <= 256 else n

    # Route 1 (the accelerator): threshold 1 sends the block batch there.
    hybrid = HybridSignatureVerifier(tpu=FakeCard(), cpu=CpuSignatureVerifier(), threshold=1,
                                     metrics=metrics)
    collector = BatchedSignatureVerifier(committee, hybrid, metrics=metrics)
    genesis = [StatementBlock.new_genesis(i) for i in range(4)]
    prev = [g.reference for g in genesis]
    blocks = [StatementBlock.build(a, 1, prev, [Share(bytes([a]))], signer=signers[a])
              for a in range(1, 4)]
    assert all(await collector.verify_blocks(blocks))
    # Route 2 (cpu): a sky-high threshold keeps the batch on the oracle.
    hybrid_cpu = HybridSignatureVerifier(tpu=FakeCard(), cpu=CpuSignatureVerifier(),
                                         threshold=1 << 30, metrics=metrics)
    signer = crypto.Signer.from_seed(bytes(32))
    digest = crypto.blake2b_256(b"route-probe")
    hybrid_cpu.verify_signatures([signer.public_key.bytes], [digest], [signer.sign(digest)])

    server = await serve_metrics(metrics, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /metrics HTTP/1.1\r\nHost: t\r\n\r\n")
    await writer.drain()
    payload = await reader.read()
    writer.close()
    server.close()
    await server.wait_closed()
    return payload.decode()
