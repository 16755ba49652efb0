"""The port's storage lifecycle (``storage.py``) against the JAX package's.

The port's counterparts of ``tests/test_storage_lifecycle.py``, with the
reference's thresholds: the segmented WAL units, the checkpoint / GC /
recovery sims, snapshot catch-up, and the floor and adoption seams of the
block manager and the linearizer.  The reference's sims run on its
``chaos.run_chaos_sim``; here a crash/restart harness in this file
(``_run_fleet``) does what that one does with crash faults, over either
package.  Then parity: the same seed through both packages gives the same
committed sequences, byte-identical ``wal.*`` segments, ``MANIFEST.json``
and ``checkpoint.*`` files and the same boot readings; and each package's
``open_store`` boots the other's directory, after GC and a torn tail, to
the same recovered state, and a core over it writes the same checkpoint and
snapshot manifest, the JAX package in a child process under another
``PYTHONHASHSEED`` (so a file whose order hangs on ``bytes`` hashing shows).
Last, the GC hold under a snapshot stream, the snapshot tags of a node with
storage, and ``chip_smoke.py``'s ``storage`` phase in small through the
plain kernels.
"""
import asyncio
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import pytest

import chip_smoke

PORT = "mysticeti_tpu_torch"
PACKAGES = ("mysticeti_tpu", PORT)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from mysticeti_tpu_torch.config import Parameters, StorageParameters  # noqa: E402
from mysticeti_tpu_torch.storage import (  # noqa: E402
    MANIFEST_NAME,
    active_wal_file,
    checkpoint_files,
    open_store,
    open_wal,
)
from mysticeti_tpu_torch.wal import HEADER_SIZE, WalError, WalReader, walf  # noqa: E402


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _params(pkg=PORT, **storage_kwargs):
    """``tests/test_storage_lifecycle.py``'s ``_params`` in ``pkg``."""
    config = _mod(pkg, "config")
    defaults = dict(segment_bytes=16 * 1024, checkpoint_interval=5, gc_depth=20)
    defaults.update(storage_kwargs)
    return config.Parameters(leader_timeout_s=1.0, storage=config.StorageParameters(**defaults))


# -- segmented WAL units ------------------------------------------------------


def test_roll_read_iter_and_reopen(tmp_path):
    params = StorageParameters(segment_bytes=2048)
    path = str(tmp_path / "wal")
    w, r = open_wal(path, params)
    positions = [w.writev(1, (bytes([i % 250]) * 100,)) for i in range(50)]
    assert w.segment_count() > 1  # it actually rolled
    for i, p in enumerate(positions):
        tag, payload = r.read(p)
        assert (tag, bytes(payload)) == (1, bytes([i % 250]) * 100)
    assert [e[0] for e in r.iter_until()] == positions
    assert [e[0] for e in r.iter_from(positions[30])] == positions[30:]
    w.close()
    r.close()

    w2, r2 = open_wal(path, params)
    assert [e[0] for e in r2.iter_until()] == positions
    assert w2.write(2, b"post-reopen") == positions[-1] + HEADER_SIZE + 100
    w2.close()
    r2.close()


def test_entries_never_straddle_segments(tmp_path):
    params = StorageParameters(segment_bytes=1024)
    w, r = open_wal(str(tmp_path / "wal"), params)
    for _ in range(20):
        w.write(1, b"x" * 300)
    w.flush()
    for name, _base, size, _mr in w.segments_snapshot():
        # Every segment starts at an entry boundary: a standalone reader on
        # the bare file replays it fully.
        reader = WalReader(os.path.join(str(tmp_path / "wal"), name))
        consumed = 0
        for pos, _tag, payload in reader.iter_until():
            consumed = pos + HEADER_SIZE + len(payload)
        reader.close()
        assert consumed == size, name
    w.close()
    r.close()


def test_single_file_migration(tmp_path):
    path = str(tmp_path / "wal")
    w, r = walf(path)
    p = w.write(7, b"legacy-entry")
    w.sync()
    w.close()
    r.close()
    assert os.path.isfile(path)
    w2, r2 = open_wal(path, StorageParameters(segment_bytes=4096))
    assert os.path.isdir(path)  # migrated in place
    assert r2.read(p) == (7, b"legacy-entry")
    w2.close()
    r2.close()


def test_torn_active_tail_truncated_on_reopen(tmp_path):
    params = StorageParameters(segment_bytes=4096)
    path = str(tmp_path / "wal")
    w, r = open_wal(path, params)
    good = w.write(1, b"good")
    w.write(2, b"to-be-torn" * 10)
    w.sync()
    w.close()
    r.close()
    active = active_wal_file(path)
    with open(active, "r+b") as f:
        f.truncate(os.path.getsize(active) - 8)

    w2, r2 = open_wal(path, params)
    replayed = list(r2.iter_from(0, w2.position()))
    assert [(t, bytes(d)) for _, t, d in replayed] == [(1, b"good")]
    # The recovery contract: truncate at the tear, then appends resume there.
    w2.truncate_to(good + HEADER_SIZE + 4)
    p3 = w2.write(3, b"after")
    assert p3 == good + HEADER_SIZE + 4
    assert [t for _, t, _ in r2.iter_until()] == [1, 3]
    w2.close()
    r2.close()


def test_tear_in_sealed_segment_drops_later_segments(tmp_path):
    params = StorageParameters(segment_bytes=1024)
    path = str(tmp_path / "wal")
    w, r = open_wal(path, params)
    for i in range(12):
        w.write(1, bytes([i]) * 300)
    w.sync()
    segments = w.segments_snapshot()
    assert len(segments) >= 3
    w.close()
    r.close()
    victim = os.path.join(path, segments[1][0])
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 5)

    w2, r2 = open_wal(path, params)
    entries = list(r2.iter_from(0, w2.position()))
    end = entries[-1][0] + HEADER_SIZE + len(entries[-1][2])
    assert end < w2.position()  # replay stops at the tear
    w2.truncate_to(end)
    assert w2.position() == end
    assert w2.segments_snapshot()[-1][0] == segments[1][0]
    assert not os.path.exists(os.path.join(path, segments[2][0]))
    p = w2.write(9, b"resumed")
    assert p == end
    assert [t for _, t, _ in r2.iter_from(p)] == [9]
    w2.close()
    r2.close()


def test_crash_during_roll_orphan_segment_recovered(tmp_path):
    params = StorageParameters(segment_bytes=2048)
    path = str(tmp_path / "wal")
    w, r = open_wal(path, params)
    positions = [w.write(1, b"z" * 150) for _ in range(10)]
    names = [s[0] for s in w.segments_snapshot()]
    w.close()
    r.close()
    # The next segment file was created but the manifest rewrite never
    # happened.
    orphan = os.path.join(path, f"wal.{len(names):06d}")
    open(orphan, "wb").close()
    w2, r2 = open_wal(path, params)
    assert not os.path.exists(orphan) or os.path.getsize(orphan) == 0
    assert [e[0] for e in r2.iter_until()] == positions
    w2.write(1, b"continues")
    w2.close()
    r2.close()


def test_torn_manifest_tmp_is_ignored(tmp_path):
    params = StorageParameters(segment_bytes=2048)
    path = str(tmp_path / "wal")
    w, r = open_wal(path, params)
    positions = [w.write(1, b"m" * 100) for _ in range(5)]
    w.close()
    r.close()
    with open(os.path.join(path, MANIFEST_NAME + ".tmp"), "w") as f:
        f.write('{"version": 1, "segments": [{"nam')
    w2, r2 = open_wal(path, params)
    assert [e[0] for e in r2.iter_until()] == positions
    assert not os.path.exists(os.path.join(path, MANIFEST_NAME + ".tmp"))
    w2.close()
    r2.close()


def test_corrupt_manifest_is_loud(tmp_path):
    params = StorageParameters(segment_bytes=2048)
    path = str(tmp_path / "wal")
    w, r = open_wal(path, params)
    w.write(1, b"x")
    w.close()
    r.close()
    with open(os.path.join(path, MANIFEST_NAME), "w") as f:
        f.write("{broken json")
    with pytest.raises(WalError, match="manifest"):
        open_wal(path, params)


def test_wal_size_bytes_counts_live_segments_only(tmp_path):
    params = StorageParameters(segment_bytes=1024)
    w, r = open_wal(str(tmp_path / "wal"), params)
    for i in range(1, 13):
        p = w.write(1, bytes([i]) * 300)
        w.note_round(i, p)
    w.flush()
    total = w.position()
    assert w.size_bytes() == total
    reclaimed, removed = w.retire_below(6, keep_from_position=total)
    assert removed > 0 and reclaimed > 0
    assert w.size_bytes() == total - reclaimed
    assert w.position() == total  # logical append position is untouched
    w.close()
    r.close()


def test_retire_below_is_prefix_only(tmp_path):
    """A sealed segment still holding live rounds stops garbage collection:
    deleting a later low-round segment past it would punch a hole in the
    base space, which recovery would misread as a mid-log tear."""
    params = StorageParameters(segment_bytes=1024)
    w, r = open_wal(str(tmp_path / "wal"), params)
    positions = [w.write(1, bytes([i]) * 300) for i in range(12)]
    w.flush()
    segs = w.segments_snapshot()
    assert len(segs) >= 4
    w.note_round(100, positions[0])
    w.note_round(1, segs[1][1])
    reclaimed, removed = w.retire_below(50, keep_from_position=w.position())
    assert (reclaimed, removed) == (0, 0)  # blocked by the live prefix
    snapshot = w.segments_snapshot()
    for prev, cur in zip(snapshot, snapshot[1:]):
        assert cur[1] == prev[1] + prev[2]
    w.close()
    r.close()
    w2, r2 = open_wal(str(tmp_path / "wal"), params)
    assert [e[0] for e in r2.iter_until()] == positions
    w2.close()
    r2.close()


def test_gc_crash_between_manifest_and_unlink_recovers(tmp_path):
    """The manifest drops the victims before their files are unlinked, so a
    crash in between leaves orphan files (deleted on recovery), never a
    manifest naming missing files."""
    params = StorageParameters(segment_bytes=1024)
    path = str(tmp_path / "wal")
    w, r = open_wal(path, params)
    for i in range(1, 13):
        p = w.write(1, bytes([i]) * 300)
        w.note_round(i, p)
    w.sync()
    victim_names = [s[0] for s in w.segments_snapshot()[:2]]
    victim_bytes = {name: open(os.path.join(path, name), "rb").read() for name in victim_names}
    _reclaimed, removed = w.retire_below(9, keep_from_position=w.position())
    assert removed >= 2
    survivors = [e[0] for e in r.iter_until()]
    w.close()
    r.close()
    for name, data in victim_bytes.items():
        with open(os.path.join(path, name), "wb") as f:
            f.write(data)
    w2, r2 = open_wal(path, params)
    assert [e[0] for e in r2.iter_until()] == survivors
    for name in victim_names:
        assert not os.path.exists(os.path.join(path, name))  # orphans purged
    w2.close()
    r2.close()


@pytest.mark.parametrize("segment_bytes", [1024, 2048])
def test_segmented_wal_files_equal_the_jax_packages(tmp_path, segment_bytes):
    """The same appends, GC and reopen through both packages' segmented
    writers leave byte-identical segments and manifests."""
    trees = {}
    for pkg in PACKAGES:
        storage = _mod(pkg, "storage")
        params = _mod(pkg, "config").StorageParameters(segment_bytes=segment_bytes)
        path = str(tmp_path / pkg / "wal")
        w, r = storage.open_wal(path, params)
        for i in range(1, 25):
            w.note_round(i, w.write(1 + i % 3, bytes([i]) * (100 + 37 * i)))
        w.sync()
        w.retire_below(8, keep_from_position=w.position())
        w.close()
        r.close()
        w, r = storage.open_wal(path, params)
        w.write(9, b"after reopen")
        w.sync()
        w.close()
        r.close()
        trees[pkg] = _tree(path)
    assert trees[PORT] == trees["mysticeti_tpu"]
    assert len(trees[PORT]) >= 3


# -- the crash/restart harness, over either package ----------------------------


class _Checker:
    """Commits by (authority, height) across restarts, as the JAX package's
    ``chaos.SafetyChecker`` records them: a height seen again (a WAL replay
    after a restart) keeps its anchor, a node's heights are contiguous except
    wholly below an adopted snapshot baseline, and every node commits the
    same anchor at every height it shares with another."""

    def __init__(self):
        self.anchors = {}
        self.adopted = {}
        self.roots = {}
        self.violation = None

    def _set(self, authority, height, anchor):
        mine = self.anchors.setdefault(authority, {})
        prev = mine.get(height)
        if prev is not None and prev != anchor:
            self.violation = self.violation or AssertionError(
                f"authority {authority} committed {prev!r} and {anchor!r} at height {height}")
            raise self.violation
        mine[height] = anchor

    def observe(self, authority, committed):
        for commit in committed:
            self._set(authority, commit.height, commit.anchor)

    def note_root(self, authority, height, root):
        """An execution state root a node folded at ``height`` (its
        ``Core.execution_listeners``): a height folded again after a restart
        must give the same root."""
        prev = self.roots.setdefault(authority, {}).setdefault(height, root)
        if prev != root:
            self.violation = self.violation or AssertionError(
                f"authority {authority} folded two roots at height {height}")
            raise self.violation

    def note_adopted(self, authority, height, leader):
        self.adopted[authority] = max(self.adopted.get(authority, 0), height)
        if leader is not None and height > 0:
            self._set(authority, height, leader)

    def committed_height(self, authority):
        return max(self.anchors.get(authority, {0: None}))

    def sequence(self, authority):
        mine = self.anchors.get(authority, {})
        adopted, expect, out = self.adopted.get(authority, 0), 1, []
        for height in sorted(mine):
            assert height == expect or height - 1 <= adopted, (
                f"authority {authority} has a commit gap at height {expect}")
            out.append(mine[height])
            expect = height + 1
        return out

    def check(self):
        if self.violation is not None:
            raise self.violation
        golden = {}
        for authority in sorted(self.anchors):
            self.sequence(authority)
            for height, anchor in self.anchors[authority].items():
                assert golden.setdefault(height, anchor) == anchor, f"fork at height {height}"
        golden = {}
        for authority in sorted(self.roots):
            for height, root in self.roots[authority].items():
                assert golden.setdefault(height, root) == root, f"roots fork at height {height}"


class _SimNodeNetwork:
    def __init__(self, queue):
        self.connections = queue

    async def stop(self):
        pass


class _Fleet:
    """``n`` validators over ``pkg``'s ``SimulatedNetwork``, each booted by
    ``open_store`` from its own WAL directory, as the JAX package's
    ``chaos.ChaosSimHarness`` builds them: a ``Core`` over the storage
    lifecycle, a ``TestBlockHandler``, a ``TestCommitObserver`` feeding the
    checker, a flight recorder and a ``Metrics`` each that survive
    restarts, and ``make_verifier(authority, committee, metrics)`` (None:
    accept-all).  ``crash`` stops a node, closes its WAL writer and block
    store and tears ``torn_tail_bytes`` off its active segment; ``restart``
    rebuilds it from its directory.  With the reconfiguration plane, as the
    harness does: ``absent`` authorities are registered but not built at
    start, ``join`` boots one from an empty WAL, ``retire`` stops one for
    good, and ``inject`` plants a transaction (a committee change or an
    execution transaction) on a node's block handler; the roots a node's
    execution plane folds go to the checker."""

    def __init__(self, pkg, n, wal_dir, parameters, committee=None, make_verifier=None,
                 absent=()):
        Committee = _mod(pkg, "committee").Committee
        self.pkg, self.n, self.wal_dir, self.parameters = pkg, n, wal_dir, parameters
        self.absent = set(absent)
        self.committee = committee or Committee.new_test([1] * n)
        self.signers = Committee.benchmark_signers(n)
        self.make_verifier = make_verifier
        self.metrics = [_mod(pkg, "metrics").Metrics() for _ in range(n)]
        self.recorders = [_mod(pkg, "flight_recorder").FlightRecorder(authority=a)
                          for a in range(n)]
        self.checker = _Checker()
        self.sim_net = _mod(pkg, "simulated_network").SimulatedNetwork(n)
        self.nodes = [None] * n
        checker = self.checker

        class Observer(_mod(pkg, "commit_observer").TestCommitObserver):
            def handle_commit(self, committed_leaders):
                committed = super().handle_commit(committed_leaders)
                checker.observe(self.checked_authority, committed)
                return committed

            def adopt_snapshot(self, manifest):
                super().adopt_snapshot(manifest)
                checker.note_adopted(self.checked_authority, manifest.commit_height,
                                     manifest.last_committed_leader)

        self._observer = Observer

    def wal_path(self, authority):
        return os.path.join(self.wal_dir, f"wal-{authority}")

    def _build(self, authority):
        pkg, metrics = self.pkg, self.metrics[authority]
        recovered, observer_recovered, wal_writer, lifecycle = _mod(pkg, "storage").open_store(
            authority, self.wal_path(authority), self.committee, self.parameters, metrics)
        handler = _mod(pkg, "block_handler").TestBlockHandler(
            last_transaction=authority * 1_000_000, committee=self.committee, authority=authority)
        core_mod = _mod(pkg, "core")
        core = core_mod.Core(
            block_handler=handler, authority=authority, committee=self.committee,
            parameters=self.parameters, recovered=recovered, wal_writer=wal_writer,
            options=core_mod.CoreOptions.test(), signer=self.signers[authority], metrics=metrics,
            storage=lifecycle)
        observer = self._observer(core.block_store, self.committee,
                                  recovered_state=observer_recovered)
        observer.checked_authority = authority
        lifecycle.recorder = self.recorders[authority]
        if core.execution is not None:
            core.execution_listeners.append(
                lambda result: self.checker.note_root(authority, result.height, result.root))
        verifier = (self.make_verifier(authority, self.committee, metrics)
                    if self.make_verifier is not None else None)
        return _mod(pkg, "net_sync").NetworkSyncer(
            core, observer, _SimNodeNetwork(self.sim_net.node_connections[authority]),
            parameters=self.parameters, block_verifier=verifier, metrics=metrics,
            recorder=self.recorders[authority])

    async def start(self):
        for a in range(self.n):
            if a not in self.absent:
                self.nodes[a] = self._build(a)
                await self.nodes[a].start()
        await self.sim_net.connect_all()
        for a in sorted(self.absent):
            self.sim_net.crash(a)

    async def join(self, authority):
        self.absent.discard(authority)
        await self.restart(authority)

    async def retire(self, authority):
        await self.crash(authority)

    def inject(self, via, payload):
        self.nodes[via].core.block_handler.inject(payload)

    async def crash(self, authority, torn_tail_bytes=0):
        node = self.nodes[authority]
        self.sim_net.crash(authority)
        await node.stop()
        node.core.wal_writer.close()
        node.core.block_store.close()
        self.nodes[authority] = None
        if torn_tail_bytes > 0:
            target = _mod(self.pkg, "storage").active_wal_file(self.wal_path(authority))
            with open(target, "r+b") as f:
                f.truncate(max(0, os.path.getsize(target) - torn_tail_bytes))

    async def restart(self, authority):
        self.nodes[authority] = self._build(authority)
        await self.nodes[authority].start()
        await self.sim_net.restart(authority)

    async def stop(self):
        for node in self.nodes:
            if node is not None:
                await node.stop()
                node.core.wal_writer.close()
                node.core.block_store.close()
        self.sim_net.close()

    def committed_height(self, authority):
        return self.checker.committed_height(authority)


def _run_fleet(pkg, n, duration_s, wal_dir, parameters, crashes=(), seed=0, workload=None,
               **fleet_kwargs):
    """Run ``_Fleet`` for ``duration_s`` virtual seconds on ``pkg``'s
    deterministic loop under ``seed``, with ``crashes`` as (node, at_s,
    downtime_s, torn_tail_bytes): each crash and restart at its virtual time,
    in the order the JAX package's ``chaos.resolve_schedule`` gives them;
    ``workload(fleet)`` (a coroutine function, as the harness's
    ``extra_fault``) runs beside them.  Returns the stopped fleet and the
    crash events with the committed height each node had when it went
    down."""
    events = sorted([(at, "crash", node, torn) for node, at, _down, torn in crashes]
                    + [(at + down, "restart", node, 0) for node, at, down, _torn in crashes])

    async def main():
        fleet = _Fleet(pkg, n, wal_dir, parameters, **fleet_kwargs)
        await fleet.start()
        crash_events = []

        async def schedule():
            loop = asyncio.get_running_loop()
            for t, kind, node, torn in events:
                if t > loop.time():
                    await asyncio.sleep(t - loop.time())
                if kind == "crash":
                    crash_events.append({"node": node,
                                         "committed_height": fleet.committed_height(node)})
                    await fleet.crash(node, torn)
                else:
                    await fleet.restart(node)

        tasks = [asyncio.ensure_future(schedule())]
        if workload is not None:
            tasks.append(asyncio.ensure_future(workload(fleet)))
        await asyncio.sleep(duration_s)
        for task in tasks:
            task.cancel()
        await fleet.stop()
        fleet.checker.check()
        return fleet, crash_events

    return _mod(pkg, "runtime.simulated").run_simulation(main(), seed=seed)


def _tree(directory):
    """Every file under ``directory``: name -> bytes."""
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


# -- checkpoint + GC + recovery through the whole node (deterministic sims) ----


def test_checkpoint_boot_replays_only_the_tail(tmp_path):
    """Disk bounded and an O(recent) boot: segments below the GC floor are
    deleted while the fleet commits, and a crash-restart boots from the
    newest checkpoint, replaying a small fraction of lifetime WAL bytes."""
    fleet, crashes = _run_fleet(PORT, 4, 30.0, str(tmp_path), _params(),
                                crashes=[(2, 20.0, 2.0, 0)], seed=7)
    assert all(fleet.committed_height(a) > 100 for a in range(4))
    for authority in range(4):
        node = fleet.nodes[authority]
        assert node.core.wal_writer.first_base() > 0
        metrics = fleet.metrics[authority]
        assert metrics.wal_reclaimed_bytes_total._value.get() > 0
        assert metrics.checkpoint_last_commit_index._value.get() > 0
        assert node.core.wal_writer.size_bytes() < node.core.wal_writer.position()
        assert len(checkpoint_files(fleet.wal_path(authority))) == 2  # the keep set
    restarted = fleet.nodes[2].core.storage
    assert restarted.recovered_checkpoint_height > 0
    assert restarted.replay_start > 0
    lifetime = fleet.nodes[2].core.wal_writer.position()
    assert restarted.replayed_bytes < lifetime / 5, (restarted.replayed_bytes, lifetime)
    assert fleet.metrics[2].crash_recovery_total._value.get() == 1.0
    assert fleet.committed_height(2) > crashes[0]["committed_height"]


def test_same_seed_storage_chaos_is_byte_identical(tmp_path):
    """Crash-during-roll and crash-during-checkpoint land wherever the seeded
    schedule puts them: same-seed runs give the same sequences and
    byte-identical WAL directories, and every node recovers to a committing
    state."""
    crashes = [(1, 6.0, 2.0, 0), (3, 9.0, 2.0, 11)]
    runs = []
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        runs.append(_run_fleet(PORT, 4, 18.0, str(tmp_path / name), _params(), crashes=crashes,
                               seed=23))
    (fleet, events), (replay, _) = runs
    assert ([fleet.checker.sequence(a) for a in range(4)]
            == [replay.checker.sequence(a) for a in range(4)])
    for a in range(4):
        assert _tree(fleet.wal_path(a)) == _tree(replay.wal_path(a))
    for event in events:
        node = event["node"]
        assert fleet.metrics[node].crash_recovery_total._value.get() == 1.0
        assert fleet.committed_height(node) > event["committed_height"]


def test_corrupt_checkpoint_falls_back_to_previous(tmp_path):
    _run_fleet(PORT, 4, 20.0, str(tmp_path), _params(), seed=5)
    wal_dir = os.path.join(str(tmp_path), "wal-1")
    newest, older = checkpoint_files(wal_dir)[:2]
    with open(newest, "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff\xff")
    from mysticeti_tpu_torch.committee import Committee

    committee = Committee.new_test([1, 1, 1, 1])
    recovered, _obs, wal_writer, lifecycle = open_store(1, wal_dir, committee, _params())
    older_height = int(os.path.basename(older).split(".")[1])
    assert lifecycle.recovered_checkpoint_height == older_height
    assert recovered.commit_height >= older_height  # tail replay catches up
    wal_writer.close()
    recovered.block_store.close()

    # Both checkpoints corrupt and history GC'd: the boot refuses loudly.
    with open(older, "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(WalError, match="checkpoint"):
        open_store(1, wal_dir, committee, _params())


def _served(fleet, authorities):
    return sum(fleet.nodes[a].snapshot_blocks_served
               + sum(d.snapshot_blocks_sent for d in fleet.nodes[a]._disseminators.values())
               for a in authorities)


def test_snapshot_catchup_rejoins_and_commits_fleet_sequence(tmp_path):
    """A node that missed ~200 commit heights (its history GC'd fleet-wide)
    rejoins through the snapshot stream, adopts the fleet's commit baseline
    and commits the same leader sequence at every shared height."""
    params = _params(snapshot_catchup=True, catchup_threshold_commits=50)
    fleet, crashes = _run_fleet(PORT, 4, 45.0, str(tmp_path), params,
                                crashes=[(3, 3.0, 30.0, 0)], seed=13)
    lifecycle = fleet.nodes[3].core.storage
    crashed_at = crashes[0]["committed_height"]
    assert lifecycle.snapshots_adopted == 1
    anchors3 = fleet.checker.anchors[3]
    resumed = min(h for h in sorted(anchors3) if h > crashed_at)
    assert resumed > crashed_at + params.storage.catchup_threshold_commits // 2
    heights = [fleet.committed_height(a) for a in range(4)]
    assert min(heights) > max(heights) - 10
    assert fleet.committed_height(3) > resumed + 50
    anchors0 = fleet.checker.anchors[0]
    shared = set(anchors0) & set(anchors3)
    assert len(shared) > 100
    assert all(anchors0[h] == anchors3[h] for h in shared)
    assert _served(fleet, range(3)) > 0


# -- manifest, floors and adoption units ---------------------------------------


def test_manifest_and_checkpoint_roundtrip_units(tmp_path):
    from mysticeti_tpu_torch.storage import SnapshotManifest, fold_leader_digest
    from mysticeti_tpu_torch.types import BlockReference

    ref = BlockReference(2, 41, b"\x07" * 32)
    digest = fold_leader_digest(b"\x00" * 32, ref)
    manifest = SnapshotManifest(commit_height=41, last_committed_leader=ref, gc_round=21,
                                chain_digest=digest,
                                committed_refs=[ref, BlockReference(0, 40, b"\x01" * 32)])
    assert SnapshotManifest.from_bytes(manifest.to_bytes()) == manifest
    assert fold_leader_digest(b"\x00" * 32, manifest.committed_refs[1]) != digest


def test_block_manager_floor_drops_and_releases(tmp_path):
    from mysticeti_tpu_torch.block_manager import BlockManager
    from mysticeti_tpu_torch.block_store import BlockStore, BlockWriter
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.types import StatementBlock

    committee = Committee.new_test([1, 1, 1, 1])
    w, r = walf(str(tmp_path / "wal"))
    recovered, _ = BlockStore.open(0, r, w, committee)
    store = recovered.block_store
    manager = BlockManager(store, 4)
    writer = BlockWriter(w, store)
    genesis = [StatementBlock.new_genesis(a, committee.epoch)
               for a in committee.authority_indexes()]
    parents = [StatementBlock.build(a, 9, [g.reference for g in genesis], ())
               for a in committee.authority_indexes()]
    orphan = StatementBlock.build(0, 10, [p.reference for p in parents], ())
    processed, missing = manager.add_blocks([orphan], writer)
    assert not processed and missing  # parked, parents requested
    released, _missing2 = manager.set_gc_floor(10, writer)
    assert [b.reference for _pos, b in released] == [orphan.reference]
    assert all(not refs for refs in manager.missing)
    ancient, _ = manager.add_blocks(parents, writer)
    assert ancient == []
    assert manager.exists_or_pending(parents[0].reference)
    w.close()
    r.close()


def test_linearizer_floor_and_adoption():
    from mysticeti_tpu_torch.consensus.linearizer import Linearizer
    from mysticeti_tpu_torch.types import BlockReference

    lin = Linearizer(block_store=None)
    refs = [BlockReference(a, r, bytes([a]) * 32) for a in range(2) for r in (5, 30)]
    lin.committed.update(refs)
    lin.last_height = 3
    lin.set_gc_round(10)
    assert all(r.round >= 10 for r in lin.committed)
    adopt_refs = [BlockReference(1, 40, b"\x09" * 32)]
    lin.adopt_snapshot(90, adopt_refs, 25)
    assert lin.last_height == 90
    assert lin.gc_round == 25
    assert adopt_refs[0] in lin.committed


def test_storage_parameters_unification(tmp_path):
    p = Parameters(enable_cleanup=False, store_retain_rounds=77)
    assert p.storage.enable_cleanup is False
    assert p.storage.retain_rounds == 77
    assert p.enable_cleanup is False and p.store_retain_rounds == 77
    p2 = Parameters(storage=StorageParameters(gc_depth=123, snapshot_catchup=True))
    path = str(tmp_path / "parameters.yaml")
    p2.dump(path)
    raw = open(path).read()
    assert "gc_depth: 123" in raw and "enable_cleanup" not in raw.split("storage:")[0]
    p3 = Parameters.load(path)
    assert p3.storage.gc_depth == 123
    assert p3.storage.snapshot_catchup is True
    assert p3.store_retain_rounds == p3.storage.retain_rounds


def test_relax_below_raises_the_watermark_as_the_jax_package():
    """``TransactionAggregator.relax_below`` on a fresh and on a recovered
    aggregator: the port's watermark equals the JAX package's."""
    got = {}
    for pkg in PACKAGES:
        aggregator = _mod(pkg, "committee").TransactionAggregator()
        states = []
        for watermark in (30, 20, 45):
            aggregator.relax_below(watermark)
            states.append((aggregator.recovered, aggregator.recovered_watermark))
        unbounded = _mod(pkg, "committee").TransactionAggregator()
        unbounded.recovered, unbounded.recovered_watermark = True, None
        unbounded.relax_below(50)
        got[pkg] = states + [(unbounded.recovered, unbounded.recovered_watermark)]
    assert got[PORT] == got["mysticeti_tpu"] == [(True, 30), (True, 30), (True, 45), (True, None)]


# -- parity with the JAX package -----------------------------------------------

# Both parity runs: a node behind by a whole GC window rejoins through the
# snapshot stream, and another crashes with a torn tail and boots from a
# checkpoint.
PARITY = dict(n=4, duration_s=40.0, seed=29,
              crashes=[(3, 3.0, 25.0, 0), (1, 32.0, 2.0, 11)],
              storage=dict(snapshot_catchup=True, catchup_threshold_commits=50))


def _parity_run(pkg, wal_dir):
    """``PARITY`` through ``pkg``: the committed sequences (as tuples), each
    node's boot readings and every node's directory."""
    fleet, _ = _run_fleet(pkg, PARITY["n"], PARITY["duration_s"], wal_dir,
                          _params(pkg, **PARITY["storage"]), crashes=PARITY["crashes"],
                          seed=PARITY["seed"])
    readings = []
    for a in range(PARITY["n"]):
        lifecycle = fleet.nodes[a].core.storage
        readings.append({key: getattr(lifecycle, key) for key in (
            "recovered_checkpoint_height", "replay_start", "replayed_bytes", "snapshots_adopted",
            "commit_height", "retired_round", "checkpoints_written")})
    sequences = [[(r.authority, r.round, r.digest) for r in fleet.checker.sequence(a)]
                 for a in range(PARITY["n"])]
    return {"sequences": sequences, "readings": readings,
            "trees": [_tree(fleet.wal_path(a)) for a in range(PARITY["n"])]}


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """``PARITY`` through both packages in this process.  (Not across
    processes: both packages' ``BlockFetcher`` request missing blocks in the
    iteration order of a set of references, which hangs on the process's
    ``bytes`` hash salt, so a run with fetches is reproducible only under
    one ``PYTHONHASHSEED``.)"""
    base = tmp_path_factory.mktemp("parity")
    out = {"base": base}
    for pkg in PACKAGES:
        (base / pkg).mkdir()
        out[pkg] = _parity_run(pkg, str(base / pkg))
    return out


def test_same_seed_gives_the_jax_packages_sequences_and_files(parity):
    port, jax = parity[PORT], parity["mysticeti_tpu"]
    assert port["sequences"] == jax["sequences"]
    assert min(len(s) for s in port["sequences"]) > 100
    for got, want in zip(port["trees"], jax["trees"]):
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name] == want[name], name
    names = [name for tree in port["trees"] for name in tree]
    assert MANIFEST_NAME in names
    assert sum(n.startswith("checkpoint.") for n in names) == 2 * PARITY["n"]
    assert all("wal.000000" not in tree for tree in port["trees"])  # GC'd everywhere


def test_same_seed_gives_the_jax_packages_boot_readings(parity):
    port, jax = parity[PORT]["readings"], parity["mysticeti_tpu"]["readings"]
    assert port == jax
    assert port[3]["snapshots_adopted"] == 1
    assert port[1]["recovered_checkpoint_height"] > 0 and port[1]["replay_start"] > 0


def _boot(pkg, wal_dir, authority):
    """What ``pkg``'s ``open_store`` recovers from ``wal_dir`` (as plain
    values), then the checkpoint and the snapshot manifest a ``Core`` over
    that state writes, and the directory it leaves."""
    committee = _mod(pkg, "committee").Committee.new_test([1] * PARITY["n"])
    parameters = _params(pkg, **PARITY["storage"])
    core_state, observer, wal_writer, lifecycle = _mod(pkg, "storage").open_store(
        authority, wal_dir, committee, parameters)
    ref = lambda r: None if r is None else (r.authority, r.round, r.digest)  # noqa: E731
    out = {
        "core": (core_state.commit_height, core_state.chain_digest, core_state.gc_round,
                 core_state.replayed_bytes, core_state.replay_start,
                 core_state.checkpoint_height, ref(core_state.last_committed_leader),
                 core_state.state, core_state.last_own_block.to_bytes(),
                 [(p, type(m).__name__) for p, m in core_state.pending],
                 [b.to_bytes() for b in core_state.unprocessed_blocks]),
        "observer": ([(c.height, ref(c.leader), [ref(r) for r in c.sub_dag])
                      for c in observer.sub_dags], observer.state, observer.base_height,
                     [ref(r) for r in observer.base_committed], observer.gc_round),
        "index": [(ref(r), p, own) for r, p, own in
                  core_state.block_store.index_entries_snapshot(0)],
        "lifecycle": (lifecycle.commit_height, lifecycle.chain_digest, lifecycle.retired_round,
                      lifecycle.replay_start, lifecycle.replayed_bytes,
                      lifecycle.recovered_checkpoint_height, lifecycle._kept_checkpoints),
        "wal": (wal_writer.position(), wal_writer.first_base(), wal_writer.size_bytes()),
    }
    core_mod = _mod(pkg, "core")
    core = core_mod.Core(
        block_handler=_mod(pkg, "block_handler").TestBlockHandler(
            last_transaction=authority * 1_000_000, committee=committee, authority=authority),
        authority=authority, committee=committee, parameters=parameters, recovered=core_state,
        wal_writer=wal_writer, options=core_mod.CoreOptions.test(),
        signer=_mod(pkg, "committee").Committee.benchmark_signers(PARITY["n"])[authority],
        storage=lifecycle)
    lifecycle.write_checkpoint(core, observer.state)
    out["manifest"] = lifecycle.build_manifest().to_bytes()
    wal_writer.close()
    core.block_store.close()
    out["tree"] = _tree(wal_dir)
    return out


def _child_boot(wal_dir, authority, out):
    """``_boot`` on the JAX package, pickled to ``out`` (run in a child
    process by ``test_each_package_boots_the_others_directory``)."""
    with open(out, "wb") as f:
        pickle.dump(_boot("mysticeti_tpu", wal_dir, int(authority)), f)


@pytest.mark.parametrize("writer", PACKAGES)
def test_each_package_boots_the_others_directory(parity, tmp_path, writer):
    """A directory ``writer`` left (GC'd, two checkpoints) with 11 bytes torn
    off its active segment: the port's ``open_store`` in this process and
    the JAX package's in a child process under another ``PYTHONHASHSEED``
    recover the same state from copies of it; a ``Core`` over that state
    writes byte-identical checkpoints and snapshot manifests, and both leave
    the same files (so no file hangs on the order of a set)."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_storage_lifecycle as t; t._child_boot(*sys.argv[3:])")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONHASHSEED=str(1 + int.from_bytes(os.urandom(2), "little")))
    for authority in (1, 3):
        copies = {}
        for reader in PACKAGES:
            copies[reader] = str(tmp_path / f"{reader}-{authority}")
            shutil.copytree(os.path.join(str(parity["base"] / writer), f"wal-{authority}"),
                            copies[reader])
            target = active_wal_file(copies[reader])
            with open(target, "r+b") as f:
                f.truncate(os.path.getsize(target) - 11)
        out = str(tmp_path / f"jax-{authority}.pickle")
        subprocess.run([sys.executable, "-c", code, os.path.join(ROOT, "tests"), ROOT,
                        copies["mysticeti_tpu"], str(authority), out],
                       env=env, check=True, timeout=300)
        with open(out, "rb") as f:
            want = pickle.load(f)
        got = _boot(PORT, copies[PORT], authority)
        assert got == want
        assert got["core"][5] > 0 and got["wal"][1] > 0  # a checkpoint boot after GC
        assert f"checkpoint.{got['lifecycle'][0]:012d}" in got["tree"]


# -- the GC hold, and the snapshot tags of a node with storage -----------------


class _PausingConnection:
    """The ``Connection`` surface a ``BlockDisseminator`` streams into: its
    first ``send`` waits on ``release``."""

    def __init__(self, peer):
        self.peer = peer
        self.sent = []
        self.release = asyncio.Event()

    def is_closed(self):
        return False

    async def send(self, msg):
        if not self.sent:
            self.sent.append(msg)
            await self.release.wait()
        else:
            self.sent.append(msg)


def test_gc_pass_under_a_snapshot_stream_leaves_the_window_whole(tmp_path):
    """A node serves its retained window while a GC pass comes due: the pass
    is held off until the stream ends, so every block from the advertised
    floor up to the frontier is streamed; the pass runs after it."""
    from mysticeti_tpu_torch.network import Blocks
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.synchronizer import BlockDisseminator
    from mysticeti_tpu_torch.types import StatementBlock

    async def main():
        fleet = _Fleet(PORT, 4, str(tmp_path), _params(gc_depth=20, snapshot_catchup=True))
        await fleet.start()
        await asyncio.sleep(15.0)  # one periodic cleanup (10 s) behind the frontier
        for node in fleet.nodes:
            await node.stop()
        core = fleet.nodes[0].core
        lifecycle, store = core.storage, core.block_store
        floor = lifecycle.build_manifest().gc_round
        assert lifecycle.gc_target() > floor + 10  # a GC pass is due
        want = {b.reference for r in range(max(1, floor), store.highest_round() + 1)
                for b in store.get_blocks_by_round(r)}
        conn = _PausingConnection(peer=1)
        disseminator = BlockDisseminator(conn, store, None)
        disseminator.stream_snapshot(floor, gc_hold=lifecycle)
        await asyncio.sleep(0.01)
        assert len(conn.sent) == 1  # paused after the first chunk
        core.cleanup()  # the due pass, mid-stream
        held_floor = lifecycle.retired_round
        conn.release.set()
        await disseminator._snapshot_task
        core.cleanup()
        after = lifecycle.retired_round
        await fleet.stop()
        streamed = {StatementBlock.from_bytes(raw).reference
                    for msg in conn.sent if isinstance(msg, Blocks) for raw in msg.blocks}
        return floor, held_floor, after, want, streamed, lifecycle.gc_holds

    floor, held_floor, after, want, streamed, holds = run_simulation(main(), seed=31)
    assert held_floor == floor < after
    assert holds == 0
    assert streamed == want and len(want) > 80


def test_snapshot_tags_with_storage_serve_a_manifest_and_one_stream(tmp_path):
    """A node with the storage lifecycle and ``snapshot_catchup``: a peer
    far behind asks with ``RequestSnapshot(0)`` and gets the manifest the
    lifecycle builds; one ``RequestSnapshotStream`` is served from the
    advertised floor (a lower ``from_round`` cannot widen it) and a second
    draws nothing; a peer close behind gets no answer."""
    from mysticeti_tpu_torch.network import (
        Blocks, Connection, RequestSnapshot, RequestSnapshotStream, SnapshotResponse)
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.storage import SnapshotManifest
    from mysticeti_tpu_torch.types import StatementBlock

    params = _params(gc_depth=20, snapshot_catchup=True, catchup_threshold_commits=50)

    async def main():
        fleet = _Fleet(PORT, 4, str(tmp_path), params)
        await fleet.start()
        await asyncio.sleep(12.0)
        node = fleet.nodes[0]
        conn = Connection(peer=1)
        await fleet.sim_net.node_connections[0].put(conn)
        await asyncio.sleep(0.1)
        while not conn.sender.empty():
            conn.sender.get_nowait()
        height = node.core.commit_height()
        replies = []
        for msg in (RequestSnapshot(height - 10), RequestSnapshot(0),
                    RequestSnapshotStream(0), RequestSnapshotStream(0)):
            await conn.receiver.put(msg)
            await asyncio.sleep(0.5)
            got = []
            while not conn.sender.empty():
                got.append(conn.sender.get_nowait())
            replies.append(got)
        served = node.core.storage.build_manifest()
        await fleet.stop()
        return replies, served

    replies, served = run_simulation(main(), seed=37)
    snapshot = lambda msgs: [m for m in msgs if isinstance(m, SnapshotResponse)]  # noqa: E731
    assert snapshot(replies[0]) == []
    manifest = SnapshotManifest.from_bytes(snapshot(replies[1])[0].manifest)
    assert manifest.commit_height > 50 and manifest.gc_round > 0
    streamed = [StatementBlock.from_bytes(raw) for m in replies[2] if isinstance(m, Blocks)
                for raw in m.blocks]
    rounds = sorted({b.round() for b in streamed})
    assert rounds and rounds[0] == max(1, manifest.gc_round)
    assert snapshot(replies[3]) == [] and served.commit_height >= manifest.commit_height


# -- chip_smoke's storage phase in small ----------------------------------------


# storage-10 in small: 4 nodes for 23 virtual s, one forged copy in 6
# block-carrying batches, node 3 down from 0.5 s to 10.5 s (past the fleet's
# first GC pass at 10 s), node 1 down at 13 s for 1 s with a torn tail.
STORAGE_SMALL = dict(
    chip_smoke.STORAGE_10, n=4, virtual_s=23.0, fault_one_in=6,
    crashes=((3, 0.5, 10.0, 0), (1, 13.0, 1.0, 11)), commits_after_rejoin=2,
    storage=dict(segment_bytes=2048, checkpoint_interval=2, gc_depth=3, snapshot_catchup=True,
                 catchup_threshold_commits=4))


def _storage_in_small(kind, backend=None):
    """``chip_smoke.storage_sim`` of ``STORAGE_SMALL``, each collector with a
    1 s window (a plain dispatch costs ~0.8 s of CPU: 70 flushes, where the
    config's 5 ms window would take thousands): ``cuda-only`` over
    ``backend``, or the ``cpu`` kind."""
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    def make_collector(committee, authority, metrics):
        if kind == "cpu":
            collector = _make_verifier("cpu", committee, metrics=metrics)
        else:
            collector = BatchedSignatureVerifier(committee, backend, metrics=metrics)
        collector.max_delay_s = 1.0
        return collector

    with tempfile.TemporaryDirectory(prefix="storage-") as d:
        return run_simulation(chip_smoke.storage_sim(STORAGE_SMALL, d, make_collector),
                              seed=STORAGE_SMALL["seed"])


def test_storage_phase_in_small_through_the_plain_kernels():
    """``chip_smoke.storage_sim`` at n = 4 with ``cuda-only`` collectors over
    one ``TorchSignatureVerifier(device="cpu")``, and over the ``cpu`` kind:
    the checks of the card's storage phase (a rejoin through the snapshot
    stream, a checkpoint boot after a torn tail, segments reclaimed, every
    forged copy rejected, the snapshot stream's included, the verdicts
    accounted for an incarnation at a time) hold, and the two runs commit
    the same sequences with the same counts."""
    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee

    backend = TorchSignatureVerifier(
        committee_keys=Committee.new_for_benchmarks(STORAGE_SMALL["n"]).public_key_bytes(),
        device="cpu")
    plain = _storage_in_small("cuda-only", backend)
    cpu = _storage_in_small("cpu")
    reading = chip_smoke.storage_checks(plain, cpu, STORAGE_SMALL)
    assert reading["snapshot_forged_rejected"] == 1
    assert reading["catchup"]["flushes"] > 0
    chip_smoke.card_checks(plain)
    # Here, unlike storage-10, the rejoiner's window blocks race: a snapshot
    # chunk and the author's own stream deliver one at once, and the
    # dedup's in-flight set is a connection's (as in the JAX package), so
    # a block may be verified twice, but never more often than distinct
    # peers sent it.
    assert plain["on_card_twice_one_peer"] == 0
