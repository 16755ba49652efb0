"""The seeded ten-node sim merged by the port's ``fleet_trace`` (its own
file: a long test, and under ``--dist loadfile`` a file is one worker's).

Counterpart of ``tests/test_fleet_trace.py::test_ten_node_merge_and_dumps_
byte_identical``: same seed, byte-identical raw trace, merged fleet trace
and flight-recorder dumps on every node, with the journeys really stitched
(the author's propose, per-peer transit, every pipeline stage).  Then parity:
the JAX package's run of the same seed writes the same trace and dumps, and
``python -m mysticeti_tpu_torch.tools.fleet_trace --out`` writes the JAX
tool's artifact byte for byte.
"""
import asyncio
import json
import os

import pytest

from mysticeti_tpu_torch import spans
from mysticeti_tpu_torch.block_handler import TestBlockHandler
from mysticeti_tpu_torch.block_store import BlockStore
from mysticeti_tpu_torch.commit_observer import TestCommitObserver
from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.config import Parameters
from mysticeti_tpu_torch.core import Core, CoreOptions
from mysticeti_tpu_torch.flight_recorder import FlightRecorder
from mysticeti_tpu_torch.net_sync import NetworkSyncer
from mysticeti_tpu_torch.runtime.simulated import run_simulation
from mysticeti_tpu_torch.simulated_network import SimulatedNetwork
from mysticeti_tpu_torch.spans import PIPELINE_STAGES, format_ref
from mysticeti_tpu_torch.tools import fleet_trace
from mysticeti_tpu_torch.wal import walf

pytestmark = pytest.mark.tracing


class _SimNodeNetwork:
    def __init__(self, queue):
        self.connections = queue

    async def stop(self):
        pass


def _build_node(committee, signers, authority, tmp_dir, sim_net, parameters, recorder):
    wal_writer, wal_reader = walf(os.path.join(tmp_dir, f"wal-{authority}"))
    recovered, observer_recovered = BlockStore.open(authority, wal_reader, wal_writer, committee)
    handler = TestBlockHandler(last_transaction=authority * 1_000_000, committee=committee,
                               authority=authority)
    core = Core(block_handler=handler, authority=authority, committee=committee,
                parameters=parameters, recovered=recovered, wal_writer=wal_writer,
                options=CoreOptions.test(), signer=signers[authority])
    observer = TestCommitObserver(core.block_store, committee,
                                  recovered_state=observer_recovered)
    observer.recorder = recorder
    return NetworkSyncer(core, observer, _SimNodeNetwork(sim_net.node_connections[authority]),
                         parameters=parameters, recorder=recorder)


async def _run_traced_fleet(n, tmp_dir, virtual_seconds, recorders):
    committee = Committee.new_test([1] * n)
    signers = Committee.benchmark_signers(n)
    parameters = Parameters(leader_timeout_s=1.0)
    parameters.synchronizer.timestamp_frames = True
    sim_net = SimulatedNetwork(n)
    nodes = [_build_node(committee, signers, a, tmp_dir, sim_net, parameters, recorders[a])
             for a in range(n)]
    for node in nodes:
        await node.start()
    await sim_net.connect_all()
    await asyncio.sleep(virtual_seconds)
    for node in nodes:
        await node.stop()
    sim_net.close()
    # Recorder dumps are taken on the virtual loop (is_simulated() gates the
    # wall stamp).
    return nodes, [recorders[a].snapshot_bytes() for a in range(n)]


def _traced_fleet_run(tmp_dir, seed, n=10):
    recorders = [FlightRecorder(authority=a) for a in range(n)]
    assert spans.start_from_env() is not None
    try:
        nodes, dumps = run_simulation(_run_traced_fleet(n, tmp_dir, 8.0, recorders), seed=seed)
    finally:
        spans.stop_from_env()
    committed = [list(node.syncer.commit_observer.committed_leaders) for node in nodes]
    path = os.environ["MYSTICETI_TRACE"].replace("%p", str(os.getpid()))
    with open(path, "rb") as f:
        return f.read(), committed, dumps, path


def test_ten_node_merge_and_dumps_byte_identical(tmp_path, monkeypatch, capsys):
    import test_fleet_trace as ref
    from tools import fleet_trace as jax_fleet_trace

    monkeypatch.setenv("MYSTICETI_TRACE", str(tmp_path / "trace-%p.json"))
    for d in ("a", "b", "jax"):
        (tmp_path / d).mkdir()
    raw_a, committed, dumps_a, path = _traced_fleet_run(str(tmp_path / "a"), seed=23)
    trace_a = tmp_path / "run-a.json"
    trace_a.write_bytes(raw_a)
    raw_b, _, dumps_b, _ = _traced_fleet_run(str(tmp_path / "b"), seed=23)

    assert raw_a == raw_b
    assert dumps_a == dumps_b
    raw_jax, _, dumps_jax, _ = ref._traced_fleet_run(str(tmp_path / "jax"), seed=23)
    assert raw_a == raw_jax and dumps_a == dumps_jax
    # The dumps hold real event streams (commits + connection churn).
    doc = json.loads(dumps_a[0])
    kinds = {e["kind"] for e in doc["events"]}
    assert "commit" in kinds and "peer-connect" in kinds
    assert doc["dropped"] == 0 and doc["recorded"] == len(doc["events"])
    assert "generated_unix" not in doc  # sim dumps carry no wall clock

    merged_a = fleet_trace.merge([str(trace_a)])
    merged_b = fleet_trace.merge([path])
    canon = lambda d: json.dumps(d, sort_keys=True).encode()  # noqa: E731
    assert canon({**merged_a, "inputs": []}) == canon({**merged_b, "inputs": []})

    # Stitching: a committed mid-sequence leader's journey names its author,
    # carries per-peer transit and crosses every pipeline stage.
    sequences = [seq for seq in committed if seq]
    assert sequences and all(len(s) >= 20 for s in sequences)
    leader = sequences[0][len(sequences[0]) // 2]
    label = format_ref(leader)
    journey = next(j for j in merged_a["journeys"] if j["block"] == label)
    assert journey["author"] == leader.authority
    assert journey["fully_stitched"] and journey["propose_anchored"]
    assert journey["transit_ms"], journey
    seen_stages = set()
    for node_stages in journey["nodes"].values():
        seen_stages.update(node_stages)
    assert set(PIPELINE_STAGES) <= seen_stages
    assert merged_a["fully_stitched"] >= 20
    assert merged_a["transit_observations"] > 0
    assert set(merged_a["skew"]["offsets_us"]) == {str(a) for a in range(10)}

    # The tools' artifacts, summaries and waterfalls are byte-equal.
    outs = []
    for i, main in enumerate((fleet_trace.main, jax_fleet_trace.main)):
        out = str(tmp_path / f"merged-{i}.json")
        assert main([str(trace_a), "--out", out]) == 0
        printed = capsys.readouterr()
        assert main([str(trace_a), "--block", label]) == 0
        with open(out, "rb") as f:
            outs.append((printed.out, f.read(), capsys.readouterr().out))
    assert outs[0] == outs[1]
