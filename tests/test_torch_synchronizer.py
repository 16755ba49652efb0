"""The port's synchronizer (``FrameCache``, ``BlockDisseminator``,
``BlockFetcher``) and the ingest batching of its ``NetworkSyncer``.

Counterparts of ``tests/test_mesh_data_plane.py``'s encode-reuse census,
frame-cache identity and bound, and whole-frame ingest batching, against the
port; then the frames a port disseminator pushes and answers, held byte for
byte to the JAX disseminator's over the same store.
"""
import asyncio
import importlib
import os

import pytest

from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.net_sync import Notify
from mysticeti_tpu_torch.network import Blocks, Connection, EncodedFrame
from mysticeti_tpu_torch.synchronizer import BlockDisseminator, FrameCache
from mysticeti_tpu_torch.types import Share, StatementBlock
from test_torch_consensus import _Dag

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def test_encode_reuse_census(tmp_path):
    """N subscribers at one cursor: 1 build, N-1 reuses, identical frame
    object on every queue; a new block (generation bump) forces a rebuild."""
    committee = Committee.new_test([1] * 4)
    dag = _Dag("mysticeti_tpu_torch", committee, str(tmp_path))
    last = dag.build(None, 3)  # rounds 1-3 for every authority

    async def main():
        metrics = Metrics()
        cache = FrameCache(metrics)
        notify = Notify()
        n_subs = 5
        conns = [Connection(peer=i + 1) for i in range(n_subs)]
        dissems = [
            BlockDisseminator(c, dag.block_store, notify, metrics=metrics, frame_cache=cache)
            for c in conns
        ]
        for d in dissems:
            d.subscribe_own_from(0)
        frames = [await asyncio.wait_for(c.sender.get(), timeout=2.0) for c in conns]
        for d in dissems:
            d.stop()
        assert all(f is frames[0] for f in frames)
        assert isinstance(frames[0], EncodedFrame)
        assert cache.builds == 1, cache.builds
        assert cache.reuses == n_subs - 1, cache.reuses
        assert metrics.registry.get_sample_value(
            "dissemination_encode_reuse_total") == n_subs - 1
        # A store change bumps the generation: the next frame is rebuilt,
        # never served stale from the cache.
        dag.build(last, 4)
        notify.notify()
        d2 = BlockDisseminator(Connection(peer=9), dag.block_store, notify, metrics=metrics,
                               frame_cache=cache)
        _frame, cursor2, count2 = d2._push_frame("own", None, 3)
        assert cursor2 == 4 and count2 == 1
        assert cache.builds == 2

    asyncio.run(main())
    dag.close()


def test_frame_cache_identity_across_subscribers(tmp_path):
    """The cache returns the same EncodedFrame object (not equal copies)."""
    committee = Committee.new_test([1] * 4)
    dag = _Dag("mysticeti_tpu_torch", committee, str(tmp_path))
    dag.build(None, 2)

    async def main():
        cache = FrameCache()
        notify = Notify()

        def mk():
            return BlockDisseminator(Connection(peer=1), dag.block_store, notify,
                                     frame_cache=cache)

        a = mk()._push_frame("own", None, 0)
        b = mk()._push_frame("own", None, 0)
        assert a[0] is b[0]
        # Different cursors are different frames.
        c = mk()._push_frame("own", None, 1)
        assert c[0] is not a[0] and c[1] == 2
        # Helper streams have their own key space.
        h = mk()._push_frame("others", 2, 0)
        assert h[0] is not a[0] and h[2] > 0

    asyncio.run(main())
    dag.close()


def test_frame_cache_bounded():
    cache = FrameCache()
    for i in range(3 * FrameCache.CAPACITY):
        cache.put(("own", None, i, 100, False, 0), (object(), i, 1))
    assert len(cache._frame_entries) == FrameCache.CAPACITY
    assert cache.builds == 3 * FrameCache.CAPACITY


def test_stamped_frames_expire_from_the_cache():
    """A stamped entry older than ``STAMPED_REUSE_WINDOW_S`` (runtime
    clock) is dropped and rebuilt; an unstamped one is served at any age."""
    from mysticeti_tpu_torch.runtime.simulated import run_simulation

    async def main():
        cache = FrameCache()
        cache.put(("own", None, 0, 100, True, 0), ("stamped", 1, 1))
        cache.put(("own", None, 0, 100, False, 0), ("plain", 1, 1))
        await asyncio.sleep(FrameCache.STAMPED_REUSE_WINDOW_S / 2)
        assert cache.get(("own", None, 0, 100, True, 0),
                         max_age_s=FrameCache.STAMPED_REUSE_WINDOW_S) == ("stamped", 1, 1)
        await asyncio.sleep(FrameCache.STAMPED_REUSE_WINDOW_S)
        assert cache.get(("own", None, 0, 100, True, 0),
                         max_age_s=FrameCache.STAMPED_REUSE_WINDOW_S) is None
        assert cache.get(("own", None, 0, 100, False, 0)) == ("plain", 1, 1)
        return cache.reuses

    assert run_simulation(main(), seed=1) == 2


def test_ingest_whole_frame_batching(tmp_path):
    """A frame of K blocks crosses the core owner exactly twice: one
    processed() dedup command for the whole batch, one add_blocks() for the
    accepted batch — never a per-block hop."""
    from mysticeti_tpu_torch.block_handler import TestBlockHandler
    from mysticeti_tpu_torch.block_store import BlockStore
    from mysticeti_tpu_torch.commit_observer import TestCommitObserver
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.core import Core, CoreOptions
    from mysticeti_tpu_torch.net_sync import NetworkSyncer
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.wal import walf

    committee = Committee.new_test([1] * 4)
    signers = Committee.benchmark_signers(4)

    async def scenario():
        wal_writer, wal_reader = walf(os.path.join(str(tmp_path), "wal-0"))
        recovered, observer_recovered = BlockStore.open(0, wal_reader, wal_writer, committee)
        handler = TestBlockHandler(last_transaction=0, committee=committee, authority=0)
        core = Core(block_handler=handler, authority=0, committee=committee,
                    parameters=Parameters(), recovered=recovered, wal_writer=wal_writer,
                    options=CoreOptions.test(), signer=signers[0])
        observer = TestCommitObserver(core.block_store, committee,
                                      recovered_state=observer_recovered)

        class _Net:
            connections: asyncio.Queue = asyncio.Queue()

            async def stop(self):
                pass

        node = NetworkSyncer(core, observer, _Net())
        calls = {"processed": [], "add_blocks": []}
        real_processed = node.dispatcher.processed
        real_add = node.dispatcher.add_blocks

        async def processed(refs):
            calls["processed"].append(len(refs))
            return await real_processed(refs)

        async def add_blocks(blocks, connected):
            calls["add_blocks"].append(len(blocks))
            return await real_add(blocks, connected)

        node.dispatcher.processed = processed
        node.dispatcher.add_blocks = add_blocks
        await node.start()
        conn = Connection(peer=1)
        await _Net.connections.put(conn)
        await asyncio.sleep(0.1)
        genesis = [StatementBlock.new_genesis(a, committee.epoch).reference for a in range(4)]
        blocks = [StatementBlock.build(a, 1, genesis, [Share(b"t%d" % a)], signer=signers[a],
                                       epoch=committee.epoch)
                  for a in (1, 2, 3)]
        base_processed = len(calls["processed"])
        base_add = len(calls["add_blocks"])
        await conn.receiver.put(Blocks(tuple(b.to_bytes() for b in blocks)))
        await asyncio.sleep(1.0)
        assert calls["processed"][base_processed:] == [3]
        assert calls["add_blocks"][base_add:] == [3]
        await node.stop()

    run_simulation(scenario(), seed=42)


async def _frames(pkg, store, timestamp_frames):
    """Every frame a disseminator of ``pkg`` produces over ``store``: the
    own stream from each cursor, the relay stream of each authority, and
    the answer to a ``RequestBlocks`` with one reference the store lacks."""
    net, sync, net_sync = (_mod(pkg, n) for n in ("network", "synchronizer", "net_sync"))
    types = _mod(pkg, "types")
    params = _mod(pkg, "config").SynchronizerParameters(batch_size=3,
                                                        timestamp_frames=timestamp_frames)
    d = sync.BlockDisseminator(net.Connection(peer=1), store, net_sync.Notify(), params,
                               frame_cache=sync.FrameCache())
    out = []
    for cursor in range(0, 5):
        frame, to_cursor, count = d._push_frame("own", None, cursor)
        out.append((frame.payload if frame is not None else None, to_cursor, count))
        for authority in range(1, 4):
            frame, to_cursor, count = d._push_frame("others", authority, cursor)
            out.append((frame.payload if frame is not None else None, to_cursor, count))
    refs = [b.reference for b in store.get_blocks_by_round(2)]
    refs.append(types.BlockReference(3, 9, bytes(32)))
    await d.send_requested(refs)
    while not d.connection.sender.empty():
        out.append(net.frame_payload(d.connection.sender.get_nowait()))
    return out


@pytest.mark.parametrize("timestamp_frames", [False, True])
def test_disseminator_frames_equal_the_jax_packages(tmp_path, timestamp_frames):
    """The same DAG in both packages: every pushed frame (own and relay
    streams at each cursor, 3 blocks a batch, plain or stamped on the
    virtual clock) and every answer to ``RequestBlocks`` (chunks and
    ``BlockNotFound``) is byte-identical."""
    got = {}
    for pkg in PACKAGES:
        committee = _mod(pkg, "committee").Committee.new_test([1] * 4)
        dag = _Dag(pkg, committee, str(tmp_path))
        dag.build(None, 4)
        run = _mod(pkg, "runtime.simulated").run_simulation
        got[pkg] = run(_frames(pkg, dag.block_store, timestamp_frames), seed=5)
        dag.close()
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    assert sum(1 for item in got["mysticeti_tpu"] if item[0] is not None) >= 15


async def _fetch_rounds(pkg, rounds):
    """A ``BlockFetcher`` of ``pkg`` over six peers (two with measured
    RTTs, one closed) and a dispatcher whose core always misses 120
    references: for ``rounds`` sampling periods, which peer each
    ``RequestBlocks`` chunk went to and how many references it carried."""
    net, sync, types = (_mod(pkg, n) for n in ("network", "synchronizer", "types"))
    metrics = _mod(pkg, "metrics").Metrics()
    rtts = {1: 0.02, 2: 0.2}
    connections = {p: net.Connection(p, latency_getter=(lambda r=rtts[p]: r) if p in rtts else None)
                   for p in range(1, 7)}
    connections[6].close()
    missing = [{types.BlockReference(a, r, bytes([a, r]) * 16) for r in range(1, 41)}
               for a in range(3)]

    class _Dispatcher:
        async def get_missing(self):
            return missing

    params = _mod(pkg, "config").SynchronizerParameters()
    fetcher = sync.BlockFetcher(0, _Dispatcher(), connections, params, metrics).start()
    await asyncio.sleep(params.sample_precision_s * rounds + params.sample_precision_s / 2)
    fetcher.stop()
    sent = []
    for peer, conn in connections.items():
        while not conn.sender.empty():
            msg = conn.sender.get_nowait()
            assert isinstance(msg, net.RequestBlocks)
            sent.append((peer, len(msg.references)))
    return sorted(sent), metrics.registry.get_sample_value("missing_blocks_total")


def test_fetcher_samples_the_same_peers_as_the_jax_package():
    """Under the simulator the fetcher draws its latency-weighted peer from
    the loop's ``rng``: the same seed sends the same chunks (at most 50
    references each) to the same peers in both packages, never to itself
    or a closed connection, and counts every missing reference."""
    got = {pkg: _mod(pkg, "runtime.simulated").run_simulation(_fetch_rounds(pkg, 4), seed=9)
           for pkg in PACKAGES}
    assert got["mysticeti_tpu_torch"] == got["mysticeti_tpu"]
    sent, counted = got["mysticeti_tpu_torch"]
    assert counted == 4 * 120
    assert sum(n for _, n in sent) == 4 * 120 and max(n for _, n in sent) == 50
    assert {peer for peer, _ in sent} <= {1, 2, 3, 4, 5}
