"""The port's WAL, block store and storage helpers, against the JAX package's.

The same writes through both packages give byte-identical WAL files, and
each package reads the other's file, on the native path and on the
pure-Python one (``wal._native`` pinned to None, and a child process under
``MYSTICETI_NO_NATIVE=1``).  ``BlockStore.open`` recovers the same state from
a WAL that the JAX package wrote, and the JAX package from the port's.  The
committed-leader digest chain and ``SnapshotManifest`` round-trip byte for
byte.  Also the port's counterparts of ``tests/test_native.py::
test_writer_reader_roundtrip_both_paths`` and ``tests/test_serde_property.py
::test_wal_replay_prefix_under_truncation``.
"""
import importlib
import os
import random
import subprocess
import sys

import pytest

from mysticeti_tpu_torch import wal as W
from mysticeti_tpu_torch.wal import HEADER_SIZE, walf

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=["native", "python"])
def path_kind(request, monkeypatch):
    """Both packages' WAL on their native framing and scan, or on the
    pure-Python path."""
    if request.param == "python":
        for pkg in PACKAGES:
            monkeypatch.setattr(_mod(pkg, "wal"), "_native", None)
    else:
        for pkg in PACKAGES:
            if _mod(pkg, "wal")._native is None:
                pytest.fail(f"{pkg}'s native extension did not build")
    return request.param


def _writes(rng):
    """A seeded mix of write / writev calls: (tag, parts)."""
    out = [(5, (b"abc", b"def")), (6, (b"",)), (7, (bytes(rng.randrange(256) for _ in range(5000)),))]
    for _ in range(40):
        parts = tuple(bytes(rng.randrange(256) for _ in range(rng.randrange(300)))
                      for _ in range(rng.randrange(1, 4)))
        out.append((rng.randrange(1, 200), parts))
    return out


def _write_all(pkg, path, writes):
    writer, reader = _mod(pkg, "wal").walf(path)
    positions = [writer.writev(tag, parts) if len(parts) > 1 else writer.write(tag, parts[0])
                 for tag, parts in writes]
    writer.sync()
    writer.close()
    reader.close()
    return positions


def _read_all(pkg, path):
    writer, reader = _mod(pkg, "wal").walf(path)
    entries = list(reader.iter_until())
    by_position = [(p,) + tuple(reader.read(p)) for p, _, _ in entries]
    tail = list(reader.iter_from(entries[len(entries) // 2][0])) if entries else []
    writer.close()
    reader.close()
    return entries, by_position, tail


def test_same_writes_give_byte_identical_wal_files(tmp_path, path_kind):
    writes = _writes(random.Random(8))
    files = {}
    for pkg in PACKAGES:
        path = str(tmp_path / f"{pkg}.wal")
        positions = _write_all(pkg, path, writes)
        with open(path, "rb") as f:
            files[pkg] = (positions, f.read())
    assert files["mysticeti_tpu_torch"] == files["mysticeti_tpu"]
    assert len(files["mysticeti_tpu"][1]) == sum(
        HEADER_SIZE + sum(len(p) for p in parts) for _, parts in writes)


@pytest.mark.parametrize("writer_pkg,reader_pkg", [PACKAGES, PACKAGES[::-1]])
def test_each_package_reads_the_others_wal(tmp_path, path_kind, writer_pkg, reader_pkg):
    writes = _writes(random.Random(9))
    path = str(tmp_path / "wal")
    positions = _write_all(writer_pkg, path, writes)
    entries, by_position, tail = _read_all(reader_pkg, path)
    assert [p for p, _, _ in entries] == positions
    assert [(t, bytes(b)) for _, t, b in entries] == [(t, b"".join(parts)) for t, parts in writes]
    assert [(p, t, bytes(b)) for p, t, b in by_position] == [(p, t, bytes(b)) for p, t, b in entries]
    assert tail == _read_all(writer_pkg, path)[2]


def test_reads_with_no_native_in_a_child_process(tmp_path):
    """``MYSTICETI_NO_NATIVE=1`` pins both packages' fallback at import; a
    child reads each package's file with the other package."""
    writes = _writes(random.Random(10))
    for pkg in PACKAGES:
        _write_all(pkg, str(tmp_path / f"{pkg}.wal"), writes)
    child = (
        "import sys, importlib\n"
        "for w, r in (('mysticeti_tpu', 'mysticeti_tpu_torch'), "
        "('mysticeti_tpu_torch', 'mysticeti_tpu')):\n"
        "    mod = importlib.import_module(r + '.wal')\n"
        "    assert mod._native is None, r\n"
        "    writer, reader = mod.walf(sys.argv[1] + '/' + w + '.wal')\n"
        "    print(r, [(p, t, bytes(b).hex()) for p, t, b in reader.iter_until()])\n"
        "    writer.close(); reader.close()\n"
    )
    env = dict(os.environ, MYSTICETI_NO_NATIVE="1", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", child, str(tmp_path)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2
    want = [(p, t, bytes(b).hex()) for p, t, b in
            _read_all("mysticeti_tpu", str(tmp_path / "mysticeti_tpu.wal"))[0]]
    for line in lines:
        assert line.split(" ", 1)[1] == repr(want)


# -- block store recovery across packages ----------------------------------


def _write_store(pkg, path):
    """``tests/test_block_store.py::test_recovery_replay``'s WAL, written by
    ``pkg``: a 4-authority DAG over two rounds, an own block after a payload
    entry, a handler-state entry and a commit entry."""
    bs = _mod(pkg, "block_store")
    types = _mod(pkg, "types")
    serde = _mod(pkg, "serde")
    state = _mod(pkg, "state")
    committee = _mod(pkg, "committee").Committee.new_test([1] * 4)
    w, r = _mod(pkg, "wal").walf(path)
    recovered, _ = bs.BlockStore.open(0, r, w, committee)
    writer = bs.BlockWriter(w, recovered.block_store)
    genesis = [types.StatementBlock.new_genesis(a) for a in range(4)]
    refs = [b.reference for b in genesis]
    for b in genesis:
        writer.insert_block(b)
    r1 = [types.StatementBlock.build(a, 1, refs, (types.Share(bytes([a])),)) for a in range(4)]
    for b in r1:
        writer.insert_block(b)
    a2 = types.StatementBlock.build(0, 2, [b.reference for b in r1], ())
    payload_pos = w.write(bs.WAL_ENTRY_PAYLOAD, state.encode_payload((types.Share(b"tx1"),)))
    writer.insert_own_block(bs.OwnBlockData(next_entry=payload_pos, block=a2))
    w.write(bs.WAL_ENTRY_STATE, b"handler-state")
    cd = bs.CommitData(r1[0].reference, [r1[0].reference], height=1)
    cw = serde.Writer()
    cw.u32(1)
    cd.encode(cw)
    cw.bytes(b"agg-state")
    w.write(bs.WAL_ENTRY_COMMIT, cw.finish())
    w.sync()
    w.close()
    r.close()


def _recover(pkg, path):
    """What ``BlockStore.open`` recovers, as plain values."""
    committee = _mod(pkg, "committee").Committee.new_test([1] * 4)
    w, r = _mod(pkg, "wal").walf(path)
    core, observer = _mod(pkg, "block_store").BlockStore.open(0, r, w, committee)
    store = core.block_store
    blocks = sorted(b.to_bytes() for rnd in range(store.highest_round() + 1)
                    for b in store.get_blocks_by_round(rnd))
    out = {
        "len": store.len_expensive(), "highest": store.highest_round(), "blocks": blocks,
        "own": store.last_own_block_ref().digest,
        "own_data": core.last_own_block.to_bytes(),
        "pending": [(pos, type(st).__name__) for pos, st in core.pending],
        "state": core.state, "unprocessed": [b.to_bytes() for b in core.unprocessed_blocks],
        "last_committed": core.last_committed_leader.digest,
        "sub_dags": [(d.height, d.leader.digest, [x.digest for x in d.sub_dag])
                     for d in observer.sub_dags],
        "observer_state": observer.state,
    }
    w.close()
    r.close()
    return out


@pytest.mark.parametrize("writer_pkg", PACKAGES)
def test_block_store_recovers_the_same_state_from_either_wal(tmp_path, writer_pkg):
    path = str(tmp_path / "wal")
    _write_store(writer_pkg, path)
    port, jax = _recover("mysticeti_tpu_torch", path), _recover("mysticeti_tpu", path)
    assert port == jax
    assert port["len"] == 9 and port["highest"] == 2 and port["state"] == b"handler-state"
    assert [kind for _, kind in port["pending"]] == ["Payload"]


def test_both_packages_write_the_same_store(tmp_path):
    files = {}
    for pkg in PACKAGES:
        _write_store(pkg, str(tmp_path / pkg))
        with open(tmp_path / pkg, "rb") as f:
            files[pkg] = f.read()
    assert files["mysticeti_tpu_torch"] == files["mysticeti_tpu"]


def _append_snapshot(pkg, path):
    """Appends to ``_write_store``'s WAL, through ``pkg``, what the JAX
    package's snapshot catch-up persists: a ``SnapshotManifest`` entry (a
    baseline at height 5 with floor round 2), then one commit above it."""
    bs = _mod(pkg, "block_store")
    serde = _mod(pkg, "serde")
    committee = _mod(pkg, "committee").Committee.new_test([1] * 4)
    w, r = _mod(pkg, "wal").walf(path)
    recovered, _ = bs.BlockStore.open(0, r, w, committee)
    store = recovered.block_store
    r1 = sorted((b.reference for b in store.get_blocks_by_round(1)), key=lambda x: x.authority)
    own = store.last_own_block_ref()
    manifest = _mod(pkg, "storage").SnapshotManifest(
        commit_height=5, last_committed_leader=r1[1], gc_round=2,
        chain_digest=bytes(range(32)), committed_refs=r1)
    w.write(bs.WAL_ENTRY_SNAPSHOT, manifest.to_bytes())
    cw = serde.Writer()
    cw.u32(1)
    bs.CommitData(own, [own], height=6).encode(cw)
    cw.bytes(b"agg-after")
    w.write(bs.WAL_ENTRY_COMMIT, cw.finish())
    w.sync()
    w.close()
    r.close()


class _StateSink:
    """A block handler that takes ``_write_store``'s opaque handler state."""

    def recover_state(self, state, watermark_round=None):
        self.state = state


def _baseline(pkg, path):
    """The commit baseline that ``BlockStore.open`` recovers, and the floors
    that a ``Core`` and a ``Linearizer`` take from it."""
    committee = _mod(pkg, "committee").Committee.new_test([1] * 4)
    w, r = _mod(pkg, "wal").walf(path)
    core, observer = _mod(pkg, "block_store").BlockStore.open(0, r, w, committee)
    node = _mod(pkg, "core").Core(
        block_handler=_StateSink(), authority=0, committee=committee, parameters=_mod(pkg, "config").Parameters(),
        recovered=core, wal_writer=w)
    linearizer = _mod(pkg, "consensus.linearizer").Linearizer(core.block_store)
    linearizer.recover_state(observer)
    out = {
        "commit_height": core.commit_height, "chain_digest": core.chain_digest,
        "gc_round": core.gc_round, "replayed_bytes": core.replayed_bytes,
        "last_committed": core.last_committed_leader.digest,
        "base_height": observer.base_height,
        "base_committed": [x.digest for x in observer.base_committed],
        "observer_gc_round": observer.gc_round,
        "sub_dags": [(d.height, d.leader.digest) for d in observer.sub_dags],
        "manager_floor": node.block_manager.gc_floor,
        "linearizer": (linearizer.gc_round, linearizer.last_height),
    }
    w.close()
    r.close()
    return out


@pytest.mark.parametrize("writer_pkg", PACKAGES)
def test_block_store_recovers_a_snapshot_baseline_from_either_wal(tmp_path, writer_pkg):
    path = str(tmp_path / "wal")
    _write_store(writer_pkg, path)
    _append_snapshot(writer_pkg, path)
    port, jax = _baseline("mysticeti_tpu_torch", path), _baseline("mysticeti_tpu", path)
    assert port == jax
    assert port["commit_height"] == 6 and port["base_height"] == 5
    assert port["gc_round"] == port["observer_gc_round"] == port["manager_floor"] == 2
    assert port["linearizer"] == (2, 6)
    assert [h for h, _ in port["sub_dags"]] == [6]
    assert port["replayed_bytes"] == os.path.getsize(path)


# -- storage helpers --------------------------------------------------------


def test_fold_leader_digest_and_snapshot_manifest_round_trip():
    import mysticeti_tpu.storage as JS
    import mysticeti_tpu.types as JT

    import mysticeti_tpu_torch.storage as S
    import mysticeti_tpu_torch.types as T

    rng = random.Random(12)
    refs = [(rng.randrange(50), rng.randrange(1, 1000), bytes(rng.randrange(256) for _ in range(32)))
            for _ in range(20)]
    chain, jchain = S.ZERO_DIGEST, JS.ZERO_DIGEST
    for a, rnd, d in refs:
        chain = S.fold_leader_digest(chain, T.BlockReference(a, rnd, d))
        jchain = JS.fold_leader_digest(jchain, JT.BlockReference(a, rnd, d))
        assert chain == jchain
    for leader, tails in ((None, {}), (refs[0], {}), (refs[1], {"epoch_chain": b"ep"}),
                          (refs[2], {"epoch_chain": b"ep", "exec_state": b"ex"}),
                          (refs[3], {"exec_state": b"ex"})):
        def manifest(S, T):
            return S.SnapshotManifest(
                commit_height=17, gc_round=3, chain_digest=chain,
                last_committed_leader=T.BlockReference(*leader) if leader else None,
                committed_refs=[T.BlockReference(*r) for r in refs[4:]], **tails)

        raw = manifest(S, T).to_bytes()
        assert raw == manifest(JS, JT).to_bytes()
        assert S.SnapshotManifest.from_bytes(raw) == manifest(S, T)
        assert JS.SnapshotManifest.from_bytes(raw) == manifest(JS, JT)
    with pytest.raises(Exception):
        S.SnapshotManifest.from_bytes(b"\x00" * 16)


# -- the port's counterparts of two reference WAL tests ---------------------


def test_writer_reader_roundtrip_both_paths(tmp_path):
    """The same WAL written with native framing replays identically through
    the native scan and the Python fallback iterator."""
    path = str(tmp_path / "wal")
    writer, reader = walf(path)
    positions = [
        writer.writev(5, (b"abc", b"def")),
        writer.write(6, b""),
        writer.write(7, os.urandom(5000)),
    ]
    entries_native = list(reader.iter_until())
    old = W._native
    assert old is not None
    W._native = None
    try:
        _, reader2 = walf(path)
        entries_python = list(reader2.iter_until())
        reader2.close()
    finally:
        W._native = old
    assert [(p, t, b) for p, t, b in entries_native] == entries_python
    assert [p for p, _, _ in entries_native] == positions
    writer.close()
    reader.close()


hypothesis = pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@pytest.mark.parametrize("use_native", [True, False])
@given(
    entries=st.lists(st.tuples(st.integers(1, 200), st.binary(max_size=300)), max_size=12),
    cut_fraction=st.floats(0.0, 1.0),
)
@settings(max_examples=100, deadline=None)
def test_wal_replay_prefix_under_truncation(tmp_path_factory, use_native, entries, cut_fraction):
    """Crash-recovery contract (wal.rs:270-293): after truncating the file at
    ANY byte, replay yields exactly the entries wholly before the cut."""
    saved_native = W._native
    if not use_native:
        W._native = None
    else:
        assert saved_native is not None
    path = str(tmp_path_factory.mktemp("walprop") / "wal")
    writer, reader = walf(path)
    offsets = []
    for tag, payload in entries:
        offsets.append((writer.write(tag, payload), tag, payload))
    writer.sync()
    size = writer.position()
    writer.close()
    cut = int(size * cut_fraction)
    with open(path, "r+b") as f:
        f.truncate(cut)
    try:
        replayed = list(reader.iter_until())
    finally:
        W._native = saved_native
    expect = [(pos, tag, payload) for pos, tag, payload in offsets
              if pos + HEADER_SIZE + len(payload) <= cut]
    assert replayed == expect
