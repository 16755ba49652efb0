"""The port's execution plane (``execution.py``) against the JAX package's.

The port's counterparts of ``tests/test_execution.py``'s 16 tests of the
transaction codec, the account state machine, the chained roots, the
durability tails, admission and the metric families, and of its wire-suffix
test (tags 15 and 16).  Each case runs on both packages, holds each to the
reference's assertions and requires the two to give the same bytes: codecs,
roots, ``to_bytes`` and frames byte for byte.  The seeded cases fold the
same transaction stream, drawn from a ``numpy`` generator, through both
packages' ``ExecutionState`` commit by commit.
"""
import importlib
import struct

import numpy as np
import pytest

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")

pytestmark = pytest.mark.execution


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(case):
    """``case(pkg)`` on both packages; the port's result must equal the JAX
    package's.  Returns it."""
    want, got = (case(pkg) for pkg in PACKAGES)
    assert got == want
    return got


def _block(pkg, *txs):
    class _Block:
        def __init__(self, statements):
            self.statements = statements

    return _Block([_mod(pkg, "types").Share(tx.to_bytes()) for tx in txs])


def _fold(pkg, state, height, *txs):
    return state.observe_commit(height, [_block(pkg, *txs)])


def _seeded_stream(pkg, seed, commits=40, accounts=6):
    """``commits`` lists of transactions over ``accounts`` account keys: every
    op, nonces right and wrong, amounts that fit and that overdraw."""
    ex = _mod(pkg, "execution")
    rng = np.random.default_rng(seed)
    keys = [f"acct-{i}".encode() for i in range(accounts)]
    stream = []
    for _ in range(commits):
        txs = []
        for _ in range(int(rng.integers(0, 5))):
            op = int(rng.integers(0, 3))
            account = keys[int(rng.integers(0, accounts))]
            nonce = int(rng.integers(0, 6))
            amount = int(rng.integers(0, 400))
            dest = keys[int(rng.integers(0, accounts))] if op == ex.OP_TRANSFER else b""
            txs.append(ex.ExecTx(op, account, nonce=0 if op == ex.OP_CREATE and rng.integers(0, 2)
                                 else nonce, amount=amount, dest=dest))
        stream.append(txs)
    return stream


def _fold_stream(pkg, state, stream, first_height=1):
    """Fold ``stream`` commit by commit; each result as plain values."""
    out = []
    for height, txs in enumerate(stream, start=first_height):
        result = _fold(pkg, state, height, *txs)
        out.append((result.height, result.root, result.applied, result.rejected, result.verdicts))
    return out


# -- transaction serde ----------------------------------------------------------


def test_exec_tx_roundtrip_all_ops():
    def case(pkg):
        ex = _mod(pkg, "execution")
        out = []
        for tx in (ex.ExecTx(ex.OP_CREATE, b"alice", amount=1000),
                   ex.ExecTx(ex.OP_MINT, b"alice", nonce=3, amount=7),
                   ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=4, amount=40, dest=b"bob"),
                   *(tx for txs in _seeded_stream(pkg, 2, commits=10) for tx in txs)):
            data = tx.to_bytes()
            assert data.startswith(ex.EXEC_MAGIC)
            assert ex.ExecTx.from_bytes(data) == tx
            assert ex.parse_exec_tx(data) == tx
            out.append((data, tx.describe()))
        return out

    assert len(_both(case)) > 10


def test_parse_ordinary_payloads_are_opaque():
    def case(pkg):
        ex = _mod(pkg, "execution")
        payloads = [struct.pack("<QQ", 0, 7) + b"\x00" * 496, b"", b"\x00" * 8,
                    b"ordinary transaction bytes"]
        rng = np.random.default_rng(9)
        payloads += [rng.integers(0, 256, size=int(rng.integers(1, 64)), dtype=np.uint8).tobytes()
                     for _ in range(100)]
        out = [ex.parse_exec_tx(p) for p in payloads]
        assert out[:4] == [None] * 4
        return [None if tx is None else tx.to_bytes() for tx in out]

    _both(case)


def test_parse_garbled_magic_is_opaque_not_an_error():
    def case(pkg):
        ex = _mod(pkg, "execution")
        assert ex.parse_exec_tx(ex.EXEC_MAGIC) is None
        assert ex.parse_exec_tx(ex.EXEC_MAGIC + b"\xff\xff\xff") is None
        valid = ex.ExecTx(ex.OP_MINT, b"a", nonce=1, amount=2).to_bytes()
        assert ex.parse_exec_tx(valid + b"\x00") is None
        rng = np.random.default_rng(4)
        out = []
        for _ in range(200):
            cut = int(rng.integers(0, len(valid) + 3))
            body = bytearray((valid + b"\x07\x07")[len(ex.EXEC_MAGIC):cut + len(ex.EXEC_MAGIC)])
            if body and rng.integers(0, 2):
                body[int(rng.integers(0, len(body)))] = int(rng.integers(0, 256))
            tx = ex.parse_exec_tx(ex.EXEC_MAGIC + bytes(body))
            out.append(None if tx is None else tx.to_bytes())
        return out

    decoded = _both(case)
    assert any(d is None for d in decoded) and any(d is not None for d in decoded)


def test_exec_tx_validation():
    def case(pkg):
        ex = _mod(pkg, "execution")
        out = []
        for args, kwargs in (((9, b"a"), {}), ((ex.OP_CREATE, b""), {}),
                             ((ex.OP_CREATE, b"a" * 65), {}), ((ex.OP_MINT, b"a"), {"dest": b"b"}),
                             ((ex.OP_TRANSFER, b"a"), {"dest": b""}),
                             ((ex.OP_MINT, b"a"), {"nonce": -1}),
                             ((ex.OP_CREATE, b"a" * 64), {})):
            try:
                ex.ExecTx(*args, **kwargs)
                out.append(None)
            except ValueError as exc:
                out.append(str(exc))
        assert None not in out[:6] and out[6] is None
        return out

    _both(case)


# -- apply semantics ------------------------------------------------------------


def test_create_mint_transfer_lifecycle():
    def case(pkg):
        ex = _mod(pkg, "execution")
        st = ex.ExecutionState()
        assert st.root == ex.GENESIS_ROOT and st.last_height == 0
        result = _fold(pkg, st, 1, ex.ExecTx(ex.OP_CREATE, b"alice", amount=100),
                       ex.ExecTx(ex.OP_MINT, b"alice", nonce=1, amount=50),
                       ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=2, amount=40, dest=b"bob"))
        assert result.applied == 3 and result.rejected == 0
        assert st.probe(b"alice") == (110, 3)
        assert st.probe(b"bob") == (40, 0)
        assert st.last_height == 1 and st.root != ex.GENESIS_ROOT
        return st.root, st.to_bytes()

    _both(case)


def test_typed_rejects_consume_nothing_but_count():
    def case(pkg):
        ex = _mod(pkg, "execution")
        st = ex.ExecutionState()
        _fold(pkg, st, 1, ex.ExecTx(ex.OP_CREATE, b"alice", amount=10))
        result = _fold(pkg, st, 2, ex.ExecTx(ex.OP_CREATE, b"alice", amount=5),
                       ex.ExecTx(ex.OP_MINT, b"ghost", nonce=0, amount=5),
                       ex.ExecTx(ex.OP_MINT, b"alice", nonce=9, amount=5),
                       ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=99, dest=b"b"))
        assert result.applied == 0 and result.rejected == 4
        assert dict(result.verdicts) == {ex.REJECT_EXISTS: 1, ex.REJECT_UNKNOWN: 1,
                                         ex.REJECT_BAD_NONCE: 1, ex.REJECT_OVERDRAFT: 1}
        assert st.probe(b"alice") == (10, 1) and st.probe(b"ghost") is None
        assert st.root != ex.GENESIS_ROOT and st.last_height == 2
        return result.verdicts, st.root

    _both(case)


def test_self_transfer_consumes_nonce_only():
    def case(pkg):
        ex = _mod(pkg, "execution")
        st = ex.ExecutionState()
        _fold(pkg, st, 1, ex.ExecTx(ex.OP_CREATE, b"a", amount=10))
        result = _fold(pkg, st, 2, ex.ExecTx(ex.OP_TRANSFER, b"a", nonce=1, amount=5, dest=b"a"))
        assert result.applied == 1 and st.probe(b"a") == (10, 2)
        return st.root

    _both(case)


def test_create_with_nonzero_nonce_rejected():
    def case(pkg):
        ex = _mod(pkg, "execution")
        st = ex.ExecutionState()
        result = _fold(pkg, st, 1, ex.ExecTx(ex.OP_CREATE, b"a", nonce=3, amount=10))
        assert dict(result.verdicts) == {ex.REJECT_BAD_NONCE: 1}
        assert st.probe(b"a") is None
        return st.root

    _both(case)


# -- root chaining --------------------------------------------------------------


def test_root_chain_is_deterministic_across_replicas():
    def case(pkg):
        ex = _mod(pkg, "execution")
        txs = [ex.ExecTx(ex.OP_CREATE, b"a", amount=100),
               ex.ExecTx(ex.OP_TRANSFER, b"a", nonce=1, amount=30, dest=b"b"),
               ex.ExecTx(ex.OP_MINT, b"a", nonce=2, amount=5)]
        a, b = ex.ExecutionState(), ex.ExecutionState()
        for st in (a, b):
            _fold(pkg, st, 1, txs[0])
            _fold(pkg, st, 2, *txs[1:])
        assert a.root == b.root and a.root_at(1) == b.root_at(1)
        assert a.to_bytes() == b.to_bytes()
        seeded = ex.ExecutionState()
        results = _fold_stream(pkg, seeded, _seeded_stream(pkg, 31, commits=80))
        return a.to_bytes(), results, seeded.to_bytes(), seeded.state()

    _, results, _, state = _both(case)
    verdicts = {name for *_, per_commit in results for name, _count in per_commit}
    assert {"applied", "bad_nonce", "insufficient_balance"} <= verdicts
    assert state["accounts"] > 0 and len(state["recent_roots"]) == 16


def test_root_chain_depends_on_order_and_predecessor():
    def case(pkg):
        ex = _mod(pkg, "execution")
        t1 = ex.ExecTx(ex.OP_CREATE, b"a", amount=100)
        t2 = ex.ExecTx(ex.OP_CREATE, b"b", amount=100)
        a, b = ex.ExecutionState(), ex.ExecutionState()
        _fold(pkg, a, 1, t1)
        _fold(pkg, a, 2, t2)
        _fold(pkg, b, 1, t2)
        _fold(pkg, b, 2, t1)
        assert a.root_at(1) != b.root_at(1)
        assert dict(a._exec_accounts) == dict(b._exec_accounts)
        assert a.root != b.root
        return a.root, b.root, a.root_at(1), b.root_at(1), a.root_at(7)

    _both(case)


def test_observe_commit_skips_replayed_heights():
    def case(pkg):
        ex = _mod(pkg, "execution")
        st = ex.ExecutionState()
        _fold(pkg, st, 1, ex.ExecTx(ex.OP_CREATE, b"a", amount=10))
        root = st.root
        assert _fold(pkg, st, 1, ex.ExecTx(ex.OP_MINT, b"a", nonce=1, amount=99)) is None
        assert st.root == root and st.probe(b"a") == (10, 1)
        # A seeded stream folded, then replayed from its middle: nothing moves.
        stream = _seeded_stream(pkg, 12, commits=30)
        _fold_stream(pkg, st, stream, first_height=2)
        before = st.to_bytes()
        replayed = [_fold(pkg, st, height, *txs) for height, txs in enumerate(stream[10:], start=12)]
        assert replayed == [None] * len(replayed) and st.to_bytes() == before
        return before

    _both(case)


# -- durability -----------------------------------------------------------------


def test_to_bytes_recover_roundtrip_is_byte_exact():
    def case(pkg):
        ex = _mod(pkg, "execution")
        st = ex.ExecutionState()
        _fold(pkg, st, 1, ex.ExecTx(ex.OP_CREATE, b"alice", amount=100))
        _fold(pkg, st, 2, ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=30, dest=b"bob"))
        data = st.to_bytes()
        twin = ex.ExecutionState()
        twin.recover(data)
        assert twin.last_height == 2 and twin.root == st.root
        assert twin.probe(b"alice") == (70, 2) and twin.probe(b"bob") == (30, 0)
        assert twin.applied_total == st.applied_total
        assert twin.to_bytes() == data
        nxt = ex.ExecTx(ex.OP_MINT, b"alice", nonce=2, amount=1)
        _fold(pkg, st, 3, nxt)
        _fold(pkg, twin, 3, nxt)
        assert twin.root == st.root
        # A seeded state, recovered by the other package too.
        seeded = ex.ExecutionState()
        _fold_stream(pkg, seeded, _seeded_stream(pkg, 8, commits=50))
        return data, twin.to_bytes(), seeded.to_bytes()

    data, _twin, seeded = _both(case)
    for pkg in PACKAGES:
        other = _mod(pkg, "execution").ExecutionState()
        other.recover(seeded)
        assert other.to_bytes() == seeded


def test_adopt_only_moves_forward():
    def case(pkg):
        ex = _mod(pkg, "execution")
        ahead, behind = ex.ExecutionState(), ex.ExecutionState()
        _fold(pkg, ahead, 1, ex.ExecTx(ex.OP_CREATE, b"a", amount=10))
        _fold(pkg, ahead, 2, ex.ExecTx(ex.OP_MINT, b"a", nonce=1, amount=5))
        _fold(pkg, behind, 1, ex.ExecTx(ex.OP_CREATE, b"a", amount=10))
        assert not ahead.adopt(behind.to_bytes())
        assert not ahead.adopt(ahead.to_bytes())
        assert not ahead.adopt(b"")
        assert behind.adopt(ahead.to_bytes())
        assert behind.last_height == 2 and behind.root == ahead.root
        return behind.to_bytes(), behind.state()

    _both(case)


def test_checkpoint_and_manifest_exec_state_soft_tail():
    def case(pkg):
        ex = _mod(pkg, "execution")
        storage = _mod(pkg, "storage")
        base = dict(commit_height=7, last_committed_leader=None, gc_round=3,
                    chain_digest=b"\x11" * 32)
        plain = storage.SnapshotManifest(**base).to_bytes()
        assert storage.SnapshotManifest(**base, exec_state=b"").to_bytes() == plain
        st = ex.ExecutionState()
        _fold(pkg, st, 7, ex.ExecTx(ex.OP_CREATE, b"a", amount=10))
        carrying = storage.SnapshotManifest(**base, exec_state=st.to_bytes()).to_bytes()
        decoded = storage.SnapshotManifest.from_bytes(carrying)
        assert decoded.exec_state == st.to_bytes() and decoded.epoch_chain == b""
        assert storage.SnapshotManifest.from_bytes(plain).exec_state == b""
        checkpoint = storage.Checkpoint(
            wal_position=64, commit_height=7, gc_round=3, last_committed_leader=None,
            chain_digest=b"\x05" * 32, committed_state=None, handler_state=None,
            last_own_block=None, pending=[], committed_refs=[], index=[],
            exec_state=st.to_bytes()).to_bytes()
        assert storage.Checkpoint.from_bytes(checkpoint).exec_state == st.to_bytes()
        return plain, carrying, checkpoint

    _both(case)


# -- admission (pre-consensus) ---------------------------------------------------


def test_admission_verdict_sheds_only_currently_doomed():
    def case(pkg):
        ex = _mod(pkg, "execution")
        st = ex.ExecutionState()
        _fold(pkg, st, 1, ex.ExecTx(ex.OP_CREATE, b"alice", amount=100))
        verdict = st.admission_verdict
        assert verdict(ex.ExecTx(ex.OP_CREATE, b"alice")) == ex.REJECT_EXISTS
        assert verdict(ex.ExecTx(ex.OP_MINT, b"ghost", nonce=0)) == ex.REJECT_UNKNOWN
        assert verdict(ex.ExecTx(ex.OP_MINT, b"alice", nonce=0, amount=1)) == ex.REJECT_BAD_NONCE
        assert verdict(ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=500, dest=b"b")) \
            == ex.REJECT_OVERDRAFT
        assert verdict(ex.ExecTx(ex.OP_CREATE, b"bob", amount=5)) is None
        assert verdict(ex.ExecTx(ex.OP_MINT, b"alice", nonce=4, amount=1)) is None
        assert verdict(ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=100, dest=b"b")) is None
        # The seeded stream's transactions against a seeded state.
        _fold_stream(pkg, st, _seeded_stream(pkg, 21, commits=20), first_height=2)
        return [verdict(tx) for txs in _seeded_stream(pkg, 22, commits=20) for tx in txs]

    verdicts = _both(case)
    assert None in verdicts and len(set(verdicts)) > 2


def test_metrics_verdict_labels_and_gauges():
    def case(pkg):
        ex = _mod(pkg, "execution")
        metrics = _mod(pkg, "metrics").Metrics()
        st = ex.ExecutionState(metrics=metrics)
        _fold(pkg, st, 1, ex.ExecTx(ex.OP_CREATE, b"a", amount=10),
              ex.ExecTx(ex.OP_MINT, b"a", nonce=9, amount=1))
        counter = metrics.mysticeti_execution_txs_total
        assert counter.labels(ex.APPLIED)._value.get() == 1
        assert counter.labels(ex.REJECT_BAD_NONCE)._value.get() == 1
        assert metrics.mysticeti_execution_height._value.get() == 1
        assert metrics.mysticeti_execution_accounts._value.get() == 1
        _fold_stream(pkg, st, _seeded_stream(pkg, 40, commits=30), first_height=2)
        families = (metrics.mysticeti_execution_txs_total, metrics.mysticeti_execution_height,
                    metrics.mysticeti_execution_accounts)
        return [(f._name, f._documentation, sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                                                   for m in f.collect() for s in m.samples
                                                   if not s.name.endswith("_created")))
                for f in families]

    _both(case)


# -- wire suffixes (tags 15/16) ----------------------------------------------------


def test_subscribe_and_notification_suffix_tiers_roundtrip():
    def case(pkg):
        network = _mod(pkg, "network")
        Subscribe, Note = network.GatewaySubscribeCommits, network.GatewayCommitNotification
        root = b"\xab" * 32
        frames = []
        for msg in (Subscribe(5), Subscribe(5, want_details=1),
                    Subscribe(5, want_details=0, want_executed=1),
                    Subscribe(5, want_details=1, want_executed=1),
                    Note(4, (b"k" * 16,)), Note(4, (b"k" * 16,), 9, 123456789),
                    Note(4, (b"k" * 16,), 0, 0, root), Note(4, (b"k" * 16,), 9, 123456789, root),
                    Note(17, (), executed_root=root)):
            raw = network.encode_message(msg)
            assert network.decode_message(raw) == msg
            frames.append(raw)
        plain = network.encode_message(Subscribe(5))
        assert len(plain) < len(network.encode_message(Subscribe(5, want_executed=1)))
        note = network.encode_message(Note(4, (b"k" * 16,)))
        assert len(note) < len(network.encode_message(Note(4, (b"k" * 16,), executed_root=root)))
        return frames

    _both(case)
