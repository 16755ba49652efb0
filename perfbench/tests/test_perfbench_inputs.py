"""The benchmark's inputs: the frozen wire encoder against the port's own
encoding, the plain reference against RFC 8032 and ``cryptography``, and
the traffic generator's counts and frames."""
import random

import numpy as np
import pytest
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from perfbench import traffic, wire
from perfbench.reference import blocks as refblocks
from perfbench.reference.ed25519 import L, Verifier

from conftest import tiny_config

RFC8032 = [  # (secret key, public key, message, signature), RFC 8032 §7.1 tests 1-3
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("sk,pk,msg,sig", RFC8032)
def test_reference_verifier_passes_the_rfc8032_vectors(sk, pk, msg, sig):
    pk, msg, sig = bytes.fromhex(pk), bytes.fromhex(msg), bytes.fromhex(sig)
    key = Ed25519PrivateKey.from_private_bytes(bytes.fromhex(sk))
    assert key.public_key().public_bytes_raw() == pk
    assert key.sign(msg) == sig
    v = Verifier()
    assert v.verify(pk, sig, msg)
    assert not v.verify(pk, sig, msg + b"\x00")
    assert not v.verify(pk, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:], msg)


def test_reference_verifier_agrees_with_cryptography():
    rng = random.Random(5)
    keys = [Ed25519PrivateKey.from_private_bytes(rng.randbytes(32)) for _ in range(4)]
    pks = [k.public_key().public_bytes_raw() for k in keys]
    v = Verifier()
    for i in range(60):
        a = i % 4
        msg = rng.randbytes(32)
        sig = keys[a].sign(msg)
        case = i % 6
        if case == 1:
            sig = keys[(a + 1) % 4].sign(msg)  # another member's key
        elif case == 2:
            sig = bytes([sig[0] ^ 4]) + sig[1:]  # R altered
        elif case == 3:
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")  # S >= L
        elif case == 4:
            msg = bytes([msg[0] ^ 1]) + msg[1:]
        try:
            keys[a].public_key().verify(sig, msg)
            expected = True
        except Exception:  # noqa: BLE001 - cryptography's InvalidSignature
            expected = False
        assert v.verify(pks[a], sig, msg) == expected, (i, case)
        assert expected == (case in (0, 5))


def _port_block(keys, author, round_, includes, txs, meta_ns):
    from mysticeti_tpu_torch.crypto import Signer
    from mysticeti_tpu_torch.types import BlockReference, Share, StatementBlock

    refs = [BlockReference(a, r, d) for a, r, d in includes]
    return StatementBlock.build(author, round_, refs, [Share(t) for t in txs], meta_ns,
                                signer=Signer(keys[author]))


@pytest.mark.parametrize("n_tx,n_inc", [(0, 1), (3, 4), (16, 10)])
def test_encoder_bytes_equal_the_ports_own_encoding(n_tx, n_inc):
    keys = wire.committee_keys(2**31 + 11, 10)
    rng = np.random.default_rng(n_tx)
    payload = rng.integers(0, 256, size=(n_tx, 512), dtype=np.uint8)
    includes = [(a, 6, bytes(rng.integers(0, 256, 32, dtype=np.uint8))) for a in range(n_inc)]
    inc_bytes = b"".join(wire.reference_bytes(*i) for i in includes)
    unsigned = wire.unsigned_bytes(3, 7, inc_bytes, n_inc, wire.share_rows(payload).tobytes(), n_tx, 123456789)
    full, digest, signed_digest = wire.sign_block(unsigned, keys[3])
    block = _port_block(keys, 3, 7, includes, [p.tobytes() for p in payload], 123456789)
    assert full == block.to_bytes()
    assert digest == block.digest() and signed_digest == block.signed_digest()
    assert refblocks.identity(full) == (3, 7, digest, signed_digest)


def test_genesis_digest_equals_the_ports():
    from mysticeti_tpu_torch.types import StatementBlock

    for a in range(3):
        assert wire.genesis_digest(a) == StatementBlock.new_genesis(a).digest()


def test_pool_blocks_decode_alike_in_the_port_and_the_reference():
    from mysticeti_tpu_torch.types import StatementBlock

    from conftest import TINY_MIX

    config = tiny_config(forged_share=0.3)
    keys = wire.committee_keys(99, 4)
    pool = traffic.build_pool(config, TINY_MIX, 99, keys)
    ref = refblocks.Reference(wire.public_bytes(keys))
    for i, raw in enumerate(pool.raws):
        block = StatementBlock.from_bytes(raw)
        d = refblocks.decode(raw)
        assert (d["author"], d["round"], d["shares"]) == (block.author(), block.round(), 4)
        assert refblocks.identity(raw) == (block.author(), block.round(), block.digest(), block.signed_digest())
        assert ref.verdict(raw) == (not pool.forged[i])
    with pytest.raises(ValueError):
        refblocks.decode(pool.raws[0] + b"\x00")
    with pytest.raises(ValueError):
        refblocks.decode(pool.raws[0][:-1])


def test_catchup_traffic_counts_and_frames():
    config = tiny_config(size=5)
    mix = dict(kind="catchup", tx_per_block=2, backlog_rounds=7, frame_blocks=3, max_frame_bytes=1 << 24)
    pool = traffic.build_pool(config, mix, 4, wire.committee_keys(4, 5))
    assert len(pool.raws) == 7 * 4 and traffic.RECEIVER not in set(pool.author)
    assert len(pool.frames_by_peer) == 4
    for peer, frames in zip((1, 2, 3, 4), pool.frames_by_peer):
        assert [len(f) for f in frames] == [3, 3, 1]
        flat = [i for f in frames for i in f]
        assert all(pool.author[i] == peer for i in flat)
        assert [int(pool.round[i]) for i in flat] == list(range(1, 8))
    # A byte cap splits frames before the block count does.
    def frame_bytes(frame):
        return traffic.FRAME_HEADER + sum(traffic.FRAME_PER_BLOCK + len(pool.raws[i]) for i in frame)

    cap = 2 * frame_bytes([0]) - traffic.FRAME_HEADER
    capped = traffic.catchup_frames(pool, 3, cap)
    assert max(len(f) for frames in capped for f in frames) == 2
    assert all(frame_bytes(f) <= cap for frames in capped for f in frames)


def test_every_seed_gets_the_same_sizes_and_frames():
    config = tiny_config(size=4)
    mix = dict(kind="catchup", tx_per_block=2, backlog_rounds=3, frame_blocks=2, max_frame_bytes=1 << 24)
    pools = [traffic.build_pool(config, mix, s, wire.committee_keys(s, 4)) for s in (1, 2**31 + 5)]
    assert [len(r) for r in pools[0].raws] == [len(r) for r in pools[1].raws]
    assert pools[0].frames_by_peer == pools[1].frames_by_peer
    assert pools[0].raws != pools[1].raws
    with pytest.raises(ValueError):
        traffic.build_pool(config, dict(mix, kind="open_loop"), 1, wire.committee_keys(1, 4))


def test_committee_keys_follow_the_seed():
    a, b = wire.public_bytes(wire.committee_keys(2**31 + 7, 3)), wire.public_bytes(wire.committee_keys(2**31 + 7, 3))
    assert a == b and len(set(a)) == 3
    assert wire.public_bytes(wire.committee_keys(2**31 + 8, 3)) != a
