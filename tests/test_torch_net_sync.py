"""The port's ``NetworkSyncer`` over its ``SimulatedNetwork``, against the
JAX package's.

Whole nodes (core, syncer, dispatcher, disseminators, fetcher, leader
timeouts) on each package's deterministic loop: the reference's harness
(``tests/test_net_sync_sim.py``'s ``_run_nodes``) and the port's copy of it
give the same committed sequences and own blocks for the same seed, with
accept-all and with each package's ``cpu`` kind.  Then the port's
counterparts of the reference's whole-stack tests, with the reference's
thresholds; ``chip_smoke.py``'s ``net_sync`` phase in small through the
plain kernels; and the snapshot tags a node without the storage lifecycle
leaves unanswered.
"""
import asyncio
import importlib
import os
import tempfile

import pytest

import chip_smoke
import test_net_sync_sim as ref

PORT = "mysticeti_tpu_torch"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _SimNodeNetwork:
    """Adapter giving NetworkSyncer the TcpNetwork surface over the sim."""

    def __init__(self, queue):
        self.connections = queue

    async def stop(self):
        pass


def build_node(pkg, committee, signers, authority, tmp_dir, sim_net, parameters,
               block_verifier=None):
    """``tests/test_net_sync_sim.py``'s ``build_node`` over either package."""
    wal_writer, wal_reader = _mod(pkg, "wal").walf(os.path.join(tmp_dir, f"wal-{authority}"))
    recovered, observer_recovered = _mod(pkg, "block_store").BlockStore.open(
        authority, wal_reader, wal_writer, committee)
    handler = _mod(pkg, "block_handler").TestBlockHandler(
        last_transaction=authority * 1_000_000, committee=committee, authority=authority)
    core_mod = _mod(pkg, "core")
    core = core_mod.Core(
        block_handler=handler, authority=authority, committee=committee, parameters=parameters,
        recovered=recovered, wal_writer=wal_writer, options=core_mod.CoreOptions.test(),
        signer=signers[authority])
    observer = _mod(pkg, "commit_observer").TestCommitObserver(
        core.block_store, committee, recovered_state=observer_recovered)
    return _mod(pkg, "net_sync").NetworkSyncer(
        core, observer, _SimNodeNetwork(sim_net.node_connections[authority]),
        parameters=parameters, block_verifier=block_verifier)


async def _run_nodes(pkg, n, tmp_dir, virtual_seconds, fault=None, leaders=1, committee=None,
                     parameters=None, verifier=None):
    """``tests/test_net_sync_sim.py``'s ``_run_nodes`` over either package
    (without its health plane); ``verifier(committee)`` gives each node's
    block verifier (None: accept-all)."""
    Committee = _mod(pkg, "committee").Committee
    if committee is None:
        committee = Committee.new_test([1] * n)
    signers = Committee.benchmark_signers(n)
    if parameters is None:
        parameters = _mod(pkg, "config").Parameters(leader_timeout_s=1.0,
                                                     number_of_leaders=leaders)
    sim_net = _mod(pkg, "simulated_network").SimulatedNetwork(n)
    nodes = [build_node(pkg, committee, signers, a, tmp_dir, sim_net, parameters,
                        verifier(committee) if verifier is not None else None)
             for a in range(n)]
    for node in nodes:
        await node.start()
    await sim_net.connect_all()
    if fault is not None:
        await fault(sim_net, nodes)
    await asyncio.sleep(virtual_seconds)
    for node in nodes:
        await node.stop()
    sim_net.close()
    return nodes


def _sim(pkg, tmp_path, seed, *args, **kwargs):
    d = tmp_path / f"{pkg}-{seed}"
    d.mkdir(parents=True, exist_ok=True)
    run = _mod(pkg, "runtime.simulated").run_simulation
    return run(_run_nodes(pkg, *args[:1], str(d), *args[1:], **kwargs), seed=seed)


def _committed(node):
    return list(node.syncer.commit_observer.committed_leaders)


def _key(nodes):
    """Committed sequences as (authority, round, digest) and every node's
    own blocks as bytes."""
    return ([[(r.authority, r.round, r.digest) for r in _committed(node)] for node in nodes],
            [[b.to_bytes() for b in node.core.block_store.get_own_blocks(0, 1 << 30)]
             for node in nodes])


def _assert_prefix_consistent(sequences):
    """All commit sequences must be prefixes of the longest (safety)."""
    longest = max(sequences, key=len)
    for seq in sequences:
        assert seq == longest[: len(seq)], f"fork: {seq} vs {longest}"


# -- cross-package parity -----------------------------------------------------


@pytest.mark.parametrize("n, virtual_s, seed", [(4, 10.0, 3), (10, 3.0, 5)])
def test_accept_all_nodes_commit_as_the_jax_package(tmp_path, n, virtual_s, seed):
    """The reference harness itself on the JAX package, the port's copy on
    the port: the same committed sequences and own-block bytes."""
    from mysticeti_tpu.runtime.simulated import run_simulation

    (tmp_path / "jax").mkdir()
    want = run_simulation(ref._run_nodes(n, str(tmp_path / "jax"), virtual_s), seed=seed)
    got = _sim(PORT, tmp_path, seed, n, virtual_s)
    sequences, own = _key(got)
    assert min(len(s) for s in sequences) >= 2 * virtual_s
    assert (sequences, own) == _key(want)


def test_cpu_kind_nodes_commit_as_the_jax_package(tmp_path):
    """A committee of the benchmark keys, each node's collector over its
    package's ``cpu`` kind (Ed25519 on every delivered block, inline under
    the simulator): the same sequences and own blocks in both packages."""
    got = {pkg: _key(_sim(pkg, tmp_path, 7, 4, 5.0,
                          committee=_mod(pkg, "committee").Committee.new_for_benchmarks(4),
                          verifier=lambda c, p=pkg: _mod(p, "validator")._make_verifier("cpu", c)))
           for pkg in ("mysticeti_tpu", PORT)}
    assert min(len(s) for s in got[PORT][0]) >= 10
    assert got[PORT] == got["mysticeti_tpu"]


# -- the reference's whole-stack tests, on the port ----------------------------


def test_four_nodes_commit(tmp_path):
    sequences = [_committed(n) for n in _sim(PORT, tmp_path, 3, 4, 30.0)]
    # Measured ~12 leaders a virtual second; 150 catches a 2x regression.
    assert all(len(s) >= 150 for s in sequences), [len(s) for s in sequences]
    _assert_prefix_consistent(sequences)
    lengths = sorted(len(s) for s in sequences)
    assert lengths[-1] - lengths[0] <= 5, lengths


def test_determinism_same_seed(tmp_path):
    a = _sim(PORT, tmp_path / "a", 7, 4, 15.0)
    b = _sim(PORT, tmp_path / "b", 7, 4, 15.0)
    assert _key(a) == _key(b)


def test_one_node_down(tmp_path):
    """3/4 nodes alive is a quorum: progress must continue."""

    async def fault(sim_net, nodes):
        await nodes[3].stop()
        sim_net.isolate(3)

    nodes = _sim(PORT, tmp_path, 11, 4, 40.0, fault=fault)
    sequences = [_committed(n) for n in nodes[:3]]
    assert all(len(s) >= 40 for s in sequences), [len(s) for s in sequences]
    _assert_prefix_consistent(sequences)


def test_partition_heals(tmp_path):
    """A minority partition stalls the cut node; healing lets sync catch it
    up."""

    async def fault(sim_net, nodes):
        async def schedule():
            sim_net.partition([0], [1, 2, 3])
            await asyncio.sleep(10.0)
            await sim_net.heal()

        asyncio.ensure_future(schedule())

    sequences = [_committed(n) for n in _sim(PORT, tmp_path, 13, 4, 60.0, fault=fault)]
    assert all(len(s) >= 100 for s in sequences[1:]), [len(s) for s in sequences]
    _assert_prefix_consistent(sequences)
    assert len(sequences[0]) >= 1, "partitioned node never caught up"


def test_helper_streams_serve_partitioned_authority(tmp_path):
    """With the 0<->3 link severed, node 3 asks its surviving peers to relay
    authority 0's blocks; a helper that is not the author serves the
    stream, and node 3 keeps pace with the fleet."""
    from mysticeti_tpu_torch.config import Parameters, SynchronizerParameters

    parameters = Parameters(leader_timeout_s=1.0,
                            synchronizer=SynchronizerParameters(disseminate_others_blocks=True))
    relayed = {}

    async def fault(sim_net, nodes):
        sim_net.partition([0], [3])

        async def probe():
            await asyncio.sleep(25.0)
            for helper in (1, 2):
                d = nodes[helper]._disseminators.get(3)
                if d is not None:
                    relayed[helper] = d.helper_blocks_sent

        asyncio.ensure_future(probe())

    sequences = [_committed(n) for n in
                 _sim(PORT, tmp_path, 17, 4, 30.0, fault=fault, parameters=parameters)]
    _assert_prefix_consistent(sequences)
    assert sum(relayed.values()) > 0, relayed
    lengths = sorted(len(s) for s in sequences)
    assert lengths[0] >= 100, lengths
    assert lengths[-1] - lengths[0] <= 10, lengths


def test_subscribe_others_message_roundtrip():
    from mysticeti_tpu_torch.network import SubscribeOthersFrom, decode_message, encode_message

    msg = SubscribeOthersFrom(authority=7, round=12345)
    assert decode_message(encode_message(msg)) == msg


def test_multi_leader_whole_stack(tmp_path):
    """number_of_leaders=2 commits at least as fast as one leader, fork-free
    with equal progress."""
    sequences = [_committed(n) for n in _sim(PORT, tmp_path, 23, 4, 30.0, leaders=2)]
    assert all(len(s) >= 150 for s in sequences), [len(s) for s in sequences]
    _assert_prefix_consistent(sequences)
    lengths = sorted(len(s) for s in sequences)
    assert lengths[-1] - lengths[0] <= 5, lengths


async def _run_epoch_nodes(n, tmp_dir, rounds_in_epoch=10):
    """``tests/test_epoch_sim.py``'s ``_run_epoch_nodes`` on the port: each
    node stops itself through the epoch watch and the grace period."""
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.simulated_network import SimulatedNetwork

    committee = Committee.new_test([1] * n)
    signers = Committee.benchmark_signers(n)
    parameters = Parameters(leader_timeout_s=1.0, rounds_in_epoch=rounds_in_epoch,
                            shutdown_grace_period_s=2.0)
    sim_net = SimulatedNetwork(n)
    nodes = [build_node(PORT, committee, signers, a, tmp_dir, sim_net, parameters)
             for a in range(n)]
    for node in nodes:
        await node.start()
    await sim_net.connect_all()
    await asyncio.wait_for(asyncio.gather(*[node.await_completion() for node in nodes]),
                           timeout=300.0)
    sim_net.close()
    return nodes


@pytest.mark.parametrize("seed", [17, 19])
def test_epoch_close_as_the_jax_package(tmp_path, seed):
    """Every node reaches SAFE_TO_CLOSE and shuts itself down; within the
    closed epoch the sequences are exactly equal across nodes, and equal
    to the JAX package's run of ``tests/test_epoch_sim.py``'s harness."""
    import test_epoch_sim
    from mysticeti_tpu.runtime.simulated import run_simulation as jax_run
    from mysticeti_tpu_torch.runtime.simulated import run_simulation

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    nodes = run_simulation(_run_epoch_nodes(4, str(tmp_path / "port")), seed=seed)
    want = jax_run(test_epoch_sim._run_epoch_nodes(4, str(tmp_path / "jax")), seed=seed)
    assert all(node.core.epoch_closed() for node in nodes)
    sequences, own = _key(nodes)
    assert len(sequences[0]) >= 3 and all(seq == sequences[0] for seq in sequences)
    assert (sequences, own) == _key(want)


def test_wal_syncer_thread_and_backpressure(tmp_path):
    """On a real loop with ``start_wal_sync_thread``: the 1 s fsync thread
    sets ``wal_size_bytes`` and ``wal_segments``, and ``backpressure()``
    reads the core queue and the WAL backlog."""
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.net_sync import NetworkSyncer
    from mysticeti_tpu_torch.simulated_network import SimulatedNetwork

    committee = _mod(PORT, "committee").Committee.new_test([1] * 4)
    signers = _mod(PORT, "committee").Committee.benchmark_signers(4)
    metrics = Metrics()

    async def scenario():
        node = build_node(PORT, committee, signers, 0, str(tmp_path), SimulatedNetwork(4),
                          Parameters())
        node = NetworkSyncer(node.core, node.syncer.commit_observer, node.network,
                             parameters=Parameters(), metrics=metrics,
                             start_wal_sync_thread=True)
        await node.start()
        # The drain thread's progress is wall-clock state: under load the
        # genesis proposal's append may still be queued, so drain it first.
        node.core.wal_writer.flush()
        pressure = node.backpressure()
        await asyncio.sleep(1.5)
        await node.stop()
        node._wal_sync_thread.join(timeout=5.0)
        assert not node._wal_sync_thread.is_alive()
        return pressure, node.core.wal_writer.size_bytes()

    pressure, size = asyncio.run(scenario())
    assert pressure == {"core_queue_depth": 0, "core_queue_capacity": 32, "wal_backlog": False}
    get = metrics.registry.get_sample_value
    assert get("wal_size_bytes") == size > 0 and get("wal_segments") == 1.0


# -- chip_smoke's net_sync phase in small --------------------------------------


def _netsync_in_small(kind, backend=None, metrics=None):
    """``chip_smoke.netsync_sim`` at n = 4 for 1.5 virtual s, one forged copy
    in 6 batches that carry blocks, each node's collector with a 50 ms
    window (28 flushes: each plain dispatch costs ~0.5 s of CPU, so the
    config's 5 ms window would take minutes): ``cuda-only`` over
    ``backend``, or the ``cpu`` kind."""
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    def make_collector(committee):
        if kind == "cpu":
            collector = _make_verifier("cpu", committee, metrics=metrics)
        else:
            collector = BatchedSignatureVerifier(committee, backend, metrics=metrics)
        collector.max_delay_s = 0.05
        return collector

    with tempfile.TemporaryDirectory(prefix="netsync-") as d:
        return run_simulation(chip_smoke.netsync_sim(4, d, 1.5, make_collector, 6, metrics),
                              seed=chip_smoke.SEED)


def test_net_sync_phase_in_small_through_the_plain_kernels():
    """Four ``NetworkSyncer``s with ``cuda-only`` collectors sharing one
    ``TorchSignatureVerifier(device="cpu")`` and one ``Metrics``: every
    forged copy is rejected, counted under ``reason="signature"`` and by the
    flight recorders, and in no store; no honest block is rejected; the
    dedup keeps re-deliveries off the verifier; the sequences and own blocks
    equal the ``cpu`` kind's run of the same seed."""
    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics

    committee = Committee.new_for_benchmarks(4)
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes(), device="cpu")
    metrics = Metrics()
    plain = _netsync_in_small("cuda-only", backend, metrics)
    cpu = _netsync_in_small("cpu", metrics=Metrics())
    reading = chip_smoke.netsync_checks(plain, cpu, min_commits=1)
    assert reading["forged"] == reading["forged_rejected"] > 0
    signatures = chip_smoke.netsync_signatures(metrics, plain)
    assert 0 < signatures["on_backend"] <= plain["fresh"] <= plain["received"]
    assert plain["received"] - plain["to_verify"] == signatures["dedup_saved"] > 0


def test_snapshot_tags_without_storage_draw_no_answer_as_the_jax_package(tmp_path):
    """A node whose core has no storage lifecycle: a ``RequestSnapshot`` and
    a ``RequestSnapshotStream`` draw nothing, a ``SnapshotResponse`` is
    dropped (the node keeps serving), and an ``EpochInfo`` from a skewed
    peer is recorded, not answered.  Built with ``snapshot_catchup=True`` it
    constructs, asks with ``RequestSnapshot(0)`` at connect, and adopts no
    manifest (``Core.apply_snapshot`` refuses without storage), so it never
    asks for the stream: the JAX package's node does the same, message for
    message."""
    from mysticeti_tpu_torch.network import RequestSnapshot
    from mysticeti_tpu_torch.storage import SnapshotManifest
    from mysticeti_tpu_torch.types import BlockReference

    manifest = SnapshotManifest(commit_height=500, last_committed_leader=BlockReference(
        2, 900, b"\x07" * 32), gc_round=880, chain_digest=bytes(32)).to_bytes()

    def scenario(pkg, catchup):
        config, network = _mod(pkg, "config"), _mod(pkg, "network")
        committee = _mod(pkg, "committee").Committee.new_test([1] * 4)
        signers = _mod(pkg, "committee").Committee.benchmark_signers(4)
        parameters = config.Parameters(storage=config.StorageParameters(snapshot_catchup=catchup))

        directory = tmp_path / f"{pkg}-{catchup}"
        directory.mkdir()

        async def run():
            sim_net = _mod(pkg, "simulated_network").SimulatedNetwork(4)
            node = build_node(pkg, committee, signers, 0, str(directory), sim_net, parameters)
            node.recorder = _mod(pkg, "flight_recorder").FlightRecorder(authority=0)
            await node.start()
            conn = network.Connection(peer=1)
            await sim_net.node_connections[0].put(conn)
            await asyncio.sleep(0.1)
            hello = [conn.sender.get_nowait() for _ in range(conn.sender.qsize())]
            for msg in (network.RequestSnapshot(0), network.RequestSnapshotStream(0),
                        network.SnapshotResponse(b"\x00" * 9), network.SnapshotResponse(manifest),
                        network.EpochInfo(3, bytes(32))):
                await conn.receiver.put(msg)
            await asyncio.sleep(0.5)
            answered = [type(m).__name__ for m in
                        (conn.sender.get_nowait() for _ in range(conn.sender.qsize()))]
            skew = [{k: v for k, v in e.items() if k != "t"} for e in node.recorder.events()
                    if e["kind"] == "epoch-skew"]
            out = ([type(m).__name__ for m in hello], hello[1:], answered, conn.is_closed(),
                   (node.snapshot_blocks_served, node.snapshot_bytes_served), node.peer_epochs,
                   skew, node.core.commit_height(), node.core.dag_floor())
            await node.stop()
            return out

        return _mod(pkg, "runtime.simulated").run_simulation(run(), seed=1)

    plain = scenario(PORT, False)
    assert plain[:3] == (["SubscribeOwnFrom"], [], [])
    assert plain[3:] == (False, (0, 0), {1: 3},
                         [{"kind": "epoch-skew", "peer": 1, "peer_epoch": 3, "local_epoch": 0}],
                         0, 0)
    asking = scenario(PORT, True)
    assert asking[0] == ["SubscribeOwnFrom", "RequestSnapshot"]
    assert asking[1] == [RequestSnapshot(0)] and asking[2] == []
    assert asking[3:] == plain[3:]
    for catchup, got in ((False, plain), (True, asking)):
        want = scenario("mysticeti_tpu", catchup)
        assert got[0] == want[0] and got[2:] == want[2:]
        assert [m.commit_height for m in got[1]] == [m.commit_height for m in want[1]]
