"""The port's reconfiguration plane (``reconfig.py``) against the JAX package's.

The port's counterparts of the 14 tests of ``tests/test_reconfig.py`` that
run no chaos simulation: the change codec, validity and idempotence of the
fold, the committee digest, the epoch chain, ``ReconfigState``'s fold and
snapshot adoption, the checkpoint and snapshot-manifest soft tails and wire
tag 17.  Each case runs on both packages, on the reference's inputs and on
inputs drawn from a seeded ``numpy`` generator, holds each package to the
reference's assertions and requires the two to give the same bytes: codecs,
digests and epoch chains byte for byte, verdicts and errors alike.
"""
import importlib

import numpy as np
import pytest

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")

pytestmark = pytest.mark.reconfig


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(case):
    """``case(pkg)`` on both packages; the port's result must equal the JAX
    package's.  Returns it."""
    want, got = (case(pkg) for pkg in PACKAGES)
    assert got == want
    return got


def _committee(pkg, stakes):
    return _mod(pkg, "committee").Committee.new_for_benchmarks(len(stakes), stakes=list(stakes))


def _seeded_stakes(seed, count=8, n=5):
    """``count`` stake vectors of ``n`` members, some at stake 0."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        stakes = [int(s) for s in rng.integers(0, 5, size=n)]
        if not any(stakes):
            stakes[0] = 1
        out.append(tuple(stakes))
    return out


def _seeded_changes(pkg, seed, count=40, n=5):
    """``count`` well-formed changes over ``n`` indices (and one beyond)."""
    r = _mod(pkg, "reconfig")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        kind = int(rng.integers(0, 3))
        authority = int(rng.integers(0, n + 1))
        stake = 0 if kind == r.CHANGE_REMOVE else int(rng.integers(1, 6))
        out.append(r.CommitteeChange(kind, authority, stake))
    return out


# -- change transaction codec ---------------------------------------------------


def test_change_codec_roundtrip():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        out = []
        for change in (r.CommitteeChange(r.CHANGE_ADD, 3, 2), r.CommitteeChange(r.CHANGE_REMOVE, 1),
                       r.CommitteeChange(r.CHANGE_REWEIGHT, 0, 7), *_seeded_changes(pkg, 11)):
            raw = change.to_bytes()
            assert raw.startswith(r.RECONFIG_MAGIC)
            assert r.CommitteeChange.from_bytes(raw) == change
            assert r.parse_reconfig_tx(raw) == change
            out.append((raw, change.describe()))
        return out

    assert len(_both(case)) == 43


def test_change_constructor_rejects_nonsense():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        out = []
        for args in ((9, 0, 1), (r.CHANGE_ADD, 0, 0), (r.CHANGE_REWEIGHT, 0, 0),
                     (r.CHANGE_REMOVE, 0, -1), (r.CHANGE_ADD, 0, 1)):
            try:
                r.CommitteeChange(*args)
                out.append(None)
            except ValueError as exc:
                out.append(str(exc))
        assert None not in out[:4] and out[4] is None
        return out

    _both(case)


def test_parse_ignores_ordinary_and_garbled_payloads():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        assert r.parse_reconfig_tx(b"\x01\x00\x00\x00\x00\x00\x00\x00") is None
        assert r.parse_reconfig_tx(b"") is None
        assert r.parse_reconfig_tx(r.RECONFIG_MAGIC + b"\x00") is None
        assert r.parse_reconfig_tx(r.RECONFIG_MAGIC + b"\xff" * 17) is None
        good = r.CommitteeChange(r.CHANGE_ADD, 1, 1).to_bytes()
        assert r.parse_reconfig_tx(good + b"x") is None
        # Seeded bodies behind the magic: garbled, truncated or well formed,
        # each package decides the same.
        rng = np.random.default_rng(5)
        out = []
        for _ in range(200):
            body = rng.integers(0, 256, size=int(rng.integers(0, 20)), dtype=np.uint8).tobytes()
            if len(body) >= 17 and rng.integers(0, 2):
                body = bytes([int(rng.integers(0, 4))]) + body[1:9] + bytes(8)
            change = r.parse_reconfig_tx(r.RECONFIG_MAGIC + body)
            out.append(None if change is None else (change.kind, change.authority, change.stake))
        return out

    assert any(c is not None for c in _both(case))


# -- validity and idempotence of the fold ----------------------------------------


def test_change_validity_rules():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        committee = _committee(pkg, (1, 1, 1, 0))
        valid = r.change_is_valid
        assert valid(committee, r.CommitteeChange(r.CHANGE_ADD, 3, 1))
        assert not valid(committee, r.CommitteeChange(r.CHANGE_ADD, 0, 1))
        assert valid(committee, r.CommitteeChange(r.CHANGE_REMOVE, 0))
        assert not valid(committee, r.CommitteeChange(r.CHANGE_REMOVE, 3))
        assert valid(committee, r.CommitteeChange(r.CHANGE_REWEIGHT, 1, 5))
        assert not valid(committee, r.CommitteeChange(r.CHANGE_REWEIGHT, 1, 1))
        assert not valid(committee, r.CommitteeChange(r.CHANGE_REWEIGHT, 3, 5))
        assert not valid(committee, r.CommitteeChange(r.CHANGE_ADD, 9, 1))
        return [[valid(_committee(pkg, stakes), change) for change in _seeded_changes(pkg, 3)]
                for stakes in _seeded_stakes(3)]

    verdicts = _both(case)
    assert any(any(row) for row in verdicts) and not all(all(row) for row in verdicts)


def test_apply_change_is_idempotent_and_preserves_last_active():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        committee = _committee(pkg, (1, 1, 1, 0))
        add = r.CommitteeChange(r.CHANGE_ADD, 3, 2)
        next_c = r.apply_change(committee, add)
        assert next_c is not None and next_c.epoch == 1 and next_c.get_stake(3) == 2
        assert r.apply_change(next_c, add) is None
        lonely = _committee(pkg, (1, 0, 0, 0))
        assert r.apply_change(lonely, r.CommitteeChange(r.CHANGE_REMOVE, 0)) is None
        # A seeded walk: each valid change derives the next epoch.
        out, current = [], _committee(pkg, (1, 1, 1, 0, 2))
        for change in _seeded_changes(pkg, 7, count=60):
            derived = r.apply_change(current, change)
            if derived is not None:
                current = derived
                out.append((derived.epoch, [a.stake for a in derived.authorities],
                            r.committee_digest(derived)))
        return out

    walk = _both(case)
    assert len(walk) > 5 and walk[-1][0] == len(walk)


def test_committee_digest_is_canonical():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        a, b = _committee(pkg, (1, 1, 1, 0)), _committee(pkg, (1, 1, 1, 0))
        assert r.committee_digest(a) == r.committee_digest(b)
        assert r.committee_digest(a) != r.committee_digest(_committee(pkg, (1, 1, 1, 1)))
        assert r.committee_digest(a) != r.committee_digest(a.with_stakes([1, 1, 1, 0], 1))
        return [r.committee_digest(_committee(pkg, stakes).with_stakes(list(stakes), epoch))
                for epoch, stakes in enumerate(_seeded_stakes(17, count=12))]

    digests = _both(case)
    assert len(set(digests)) == len(digests)


# -- the epoch chain ------------------------------------------------------------


def _record(pkg, epoch, height, stakes):
    r = _mod(pkg, "reconfig")
    committee = _committee(pkg, stakes).with_stakes(list(stakes), epoch)
    return r.EpochRecord(epoch=epoch, boundary_height=height, boundary_round=height * 3,
                         digest=r.committee_digest(committee), stakes=tuple(stakes))


def test_epoch_chain_roundtrip_and_contiguity():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        serde = _mod(pkg, "serde")
        chain = r.EpochChain([_record(pkg, 1, 5, (1, 2, 1, 0)), _record(pkg, 2, 9, (1, 2, 1, 1))])
        again = r.EpochChain.from_bytes(chain.to_bytes())
        assert again.records == chain.records
        assert again.epoch == 2 and again.last_height == 9
        empty = r.EpochChain.from_bytes(b"")
        assert empty.epoch == 0 and empty.last_height == 0
        with pytest.raises(serde.SerdeError, match="not contiguous"):
            r.EpochChain([_record(pkg, 2, 5, (1, 2, 1, 0))])
        with pytest.raises(serde.SerdeError, match="must not decrease"):
            r.EpochChain([_record(pkg, 1, 5, (1, 2, 1, 0)), _record(pkg, 2, 3, (1, 2, 1, 1))])
        rng = np.random.default_rng(23)
        heights = np.cumsum(rng.integers(0, 7, size=10))
        seeded = r.EpochChain([_record(pkg, e + 1, int(h), stakes) for e, (h, stakes)
                               in enumerate(zip(heights, _seeded_stakes(23, count=10)))])
        return chain.to_bytes(), seeded.to_bytes(), empty.to_bytes()

    _both(case)


def test_epoch_chain_derive_committee_checks_digest():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        serde = _mod(pkg, "serde")
        genesis = _committee(pkg, (1, 1, 1, 0))
        derived = r.EpochChain([_record(pkg, 1, 5, (1, 2, 1, 0))]).derive_committee(genesis)
        assert derived.epoch == 1 and derived.get_stake(1) == 2
        with pytest.raises(serde.SerdeError, match="registry") as short:
            r.EpochChain([_record(pkg, 1, 5, (1, 2, 1))]).derive_committee(genesis)
        bogus = r.EpochRecord(1, 5, 15, b"\x13" * 32, (1, 2, 1, 0))
        with pytest.raises(serde.SerdeError, match="digest mismatch") as mismatch:
            r.EpochChain([bogus]).derive_committee(genesis)
        return (r.committee_digest(derived), [a.stake for a in derived.authorities],
                str(short.value), str(mismatch.value))

    _both(case)


# -- ReconfigState: the fold over committed sub-dags ------------------------------


def _change_block(pkg, authority, round_, change, extra_payloads=()):
    types = _mod(pkg, "types")
    statements = [types.Share(p) for p in extra_payloads]
    statements.append(types.Share(change.to_bytes()))
    return types.StatementBlock.build(authority, round_, (), statements)


def test_observe_commit_folds_and_skips_replayed_heights():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        state = r.ReconfigState(_committee(pkg, (1, 1, 1, 0)))
        add = r.CommitteeChange(r.CHANGE_ADD, 3, 1)
        blocks = [_change_block(pkg, 0, 4, add, extra_payloads=[b"ordinary-tx"])]
        transition = state.observe_commit(7, 4, blocks)
        assert transition is not None and transition.committee.epoch == 1
        assert state.epoch == 1 and state.committee.is_active(3)
        assert state.chain.records[-1].boundary_height == 7
        assert state.observe_commit(7, 4, blocks) is None
        assert state.epoch == 1
        assert state.observe_commit(8, 5, [_change_block(pkg, 1, 5, add)]) is None
        both = [_change_block(pkg, 0, 6, r.CommitteeChange(r.CHANGE_REWEIGHT, 0, 3)),
                _change_block(pkg, 1, 6, r.CommitteeChange(r.CHANGE_REMOVE, 2))]
        transition = state.observe_commit(9, 6, both)
        assert transition is not None
        assert [rec.epoch for rec in transition.records] == [2, 3]
        assert state.epoch == 3 and not state.committee.is_active(2)
        # A seeded stream of sub-dags, one change a block.
        seeded = r.ReconfigState(_committee(pkg, (1, 1, 1, 0, 2)))
        changes = _seeded_changes(pkg, 29, count=30)
        for height, change in enumerate(changes, start=10):
            seeded.observe_commit(height, height, [_change_block(pkg, height % 5, height, change)])
        return (state.chain.to_bytes(), state.digest(), seeded.chain.to_bytes(), seeded.digest(),
                [b.to_bytes() for b in both])

    _both(case)


def test_committee_for_epoch_is_epoch_matched():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        state = r.ReconfigState(_committee(pkg, (1, 1, 1, 0)))
        state.observe_commit(3, 2, [_change_block(pkg, 0, 2,
                                                  r.CommitteeChange(r.CHANGE_REWEIGHT, 1, 4))])
        assert state.committee_for_epoch(0).epoch == 0
        assert state.committee_for_epoch(0).get_stake(1) == 1
        assert state.committee_for_epoch(1).get_stake(1) == 4
        assert state.committee_for_epoch(7) is None
        return [None if c is None else r.committee_digest(c)
                for c in (state.committee_for_epoch(e) for e in range(3))]

    _both(case)


def test_adopt_chain_extends_prefix_or_rejects():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        serde = _mod(pkg, "serde")
        genesis = _committee(pkg, (1, 1, 1, 0))
        server = r.ReconfigState(genesis)
        server.observe_commit(5, 3, [_change_block(pkg, 0, 3, r.CommitteeChange(r.CHANGE_ADD, 3, 1))])
        server.observe_commit(9, 6, [_change_block(pkg, 1, 6,
                                                   r.CommitteeChange(r.CHANGE_REWEIGHT, 0, 2))])
        raw = server.chain.to_bytes()
        joiner = r.ReconfigState(genesis)
        transition = joiner.adopt_chain(raw)
        assert transition is not None and joiner.epoch == 2
        assert r.committee_digest(joiner.committee) == r.committee_digest(server.committee)
        assert [rec.epoch for rec in transition.records] == [1, 2]
        assert joiner.adopt_chain(raw) is None
        assert joiner.adopt_chain(b"") is None
        other = r.ReconfigState(genesis)
        other.observe_commit(4, 2, [_change_block(pkg, 2, 2, r.CommitteeChange(r.CHANGE_REMOVE, 2))])
        assert other.epoch == 1
        with pytest.raises(serde.SerdeError, match="does not extend"):
            other.adopt_chain(raw)
        return raw, joiner.chain.to_bytes(), joiner.digest(), other.chain.to_bytes()

    _both(case)


# -- durability soft tails and wire tag 17 ----------------------------------------


def test_snapshot_manifest_epoch_chain_soft_tail():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        storage = _mod(pkg, "storage")

        def manifest(epoch_chain=b""):
            return storage.SnapshotManifest(commit_height=42, last_committed_leader=None,
                                            gc_round=7, chain_digest=b"\x21" * 32,
                                            committed_refs=[], epoch_chain=epoch_chain)

        chain = r.EpochChain([_record(pkg, 1, 5, (1, 2, 1, 0))]).to_bytes()
        carrying = manifest(chain).to_bytes()
        again = storage.SnapshotManifest.from_bytes(carrying)
        assert again.epoch_chain == chain
        assert r.EpochChain.from_bytes(again.epoch_chain).epoch == 1
        legacy = manifest().to_bytes()
        assert not legacy.endswith(chain)
        assert storage.SnapshotManifest.from_bytes(legacy).epoch_chain == b""
        assert len(legacy) < len(carrying)
        return carrying, legacy

    _both(case)


def test_checkpoint_epoch_chain_soft_tail():
    def case(pkg):
        r = _mod(pkg, "reconfig")
        storage = _mod(pkg, "storage")

        def checkpoint(epoch_chain):
            return storage.Checkpoint(
                wal_position=128, commit_height=17, gc_round=3, last_committed_leader=None,
                chain_digest=b"\x05" * 32, committed_state=None, handler_state=None,
                last_own_block=None, pending=[], committed_refs=[], index=[],
                epoch_chain=epoch_chain)

        chain = r.EpochChain([_record(pkg, 1, 5, (1, 2, 1, 0))]).to_bytes()
        carrying = checkpoint(chain).to_bytes()
        again = storage.Checkpoint.from_bytes(carrying)
        assert again.epoch_chain == chain and again.commit_height == 17
        legacy = checkpoint(b"").to_bytes()
        assert storage.Checkpoint.from_bytes(legacy).epoch_chain == b""
        assert len(legacy) < len(carrying)
        return carrying, legacy

    _both(case)


def test_epoch_info_wire_roundtrip():
    def case(pkg):
        network = _mod(pkg, "network")
        out = []
        for epoch, digest in ((3, b"\x11" * 32), (0, bytes(32)), (2**40 + 5, bytes(range(32)))):
            raw = network.encode_message(network.EpochInfo(epoch, digest))
            again = network.decode_message(raw)
            assert isinstance(again, network.EpochInfo)
            assert (again.epoch, again.digest) == (epoch, digest)
            out.append(raw)
        return out

    _both(case)
