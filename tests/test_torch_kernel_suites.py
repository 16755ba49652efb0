"""Counterparts, on the kernels' plain versions, of the ``kernel``-marked
reference cases that no other port test holds.

The reference's kernel suites (``test_ed25519_pallas``, ``_fused``,
``_indexed``, ``_keyed``, ``_tpu``, ``test_sha512_tpu``,
``test_scalar_tpu``, ``test_parallel``) run the Pallas interpreter and
XLA, so they stay in the slow tier.  ROADMAP C maps each of their cases to
the port test that holds it; the cases below are the ones that needed a
counterpart.  Each runs the port's plain versions (the CUDA kernels are
held to those by ``chip_smoke.py`` on the card) against the oracle, and
against the JAX package's host code where it has an output without a
kernel.  Verdicts and integers: every comparison is exact.
"""
import hashlib
import random

import numpy as np
import pytest
import torch

from mysticeti_tpu.ops import ed25519 as JE
from mysticeti_tpu_torch import _ed25519_py as PY
from mysticeti_tpu_torch import crypto as PCR
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.ops import field as F
from mysticeti_tpu_torch.ops import scalar as SC
from mysticeti_tpu_torch.ops import sha512 as H
from mysticeti_tpu_torch.types import StatementBlock


def _keypair(rng):
    key = PY.Ed25519PrivateKey.from_private_bytes(bytes(rng.randrange(256) for _ in range(32)))
    return key, key.public_key().public_bytes_raw()


def _oracle(pk, msg, sig):
    try:
        PY.Ed25519PublicKey.from_public_bytes(pk).verify(sig, msg)
        return True
    except (PY.InvalidSignature, ValueError):
        return False


# -- test_ed25519_tpu.py ------------------------------------------------------

def test_field_mul_carry_saturation_regression():
    """:56: a product whose carry ripple lands a full 2^13 on limb 19."""
    e = [3118, 7793, 4844, 2951, 244, 530, 1793, 2089, 4981, 369,
         7492, 2771, 7811, 8145, 3290, 7683, 2110, 4276, 4727, 297]
    f = [6206, 1368, 1220, 7754, 597, 386, 3963, 7916, 5491, 5782,
         3507, 4421, 4725, 3696, 3677, 6152, 1606, 7840, 8029, 388]
    a = torch.tensor([e], dtype=torch.int32)
    b = torch.tensor([f], dtype=torch.int32)
    got = F.limbs_to_int(F.canonical(F.mul(a, b))[0])
    assert got == F.limbs_to_int(a[0]) * F.limbs_to_int(b[0]) % F.P


def test_field_partial_form_chain():
    """:87: 60 rounds of mul(A, A - 2A) keep the limbs in partial form and
    the value right."""
    rng = random.Random(9)
    x = rng.randrange(F.P)
    a = torch.as_tensor(F.int_to_limbs(x)[None])
    max_limb = 0
    for _ in range(60):
        a = F.mul(a, F.sub(a, F.add(a, a)))
        max_limb = max(max_limb, int(a.max()))
        x = (x * ((x - 2 * x) % F.P)) % F.P
    assert max_limb <= (1 << 13) + 64
    assert F.limbs_to_int(F.canonical(a)[0]) == x


# -- test_ed25519_pallas.py and test_ed25519_fused.py -------------------------

def test_non_canonical_r_rejected_on_host():
    """pallas :72: R encoded as y = p + 1 fails the host checks of
    ``pack_batch`` (the JAX package's mask, item for item) and the verify."""
    rng = random.Random(1)
    keys = [_keypair(rng) for _ in range(8)]
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(8)]
    pks = [pk for _, pk in keys]
    sigs = [key.sign(m) for (key, _), m in zip(keys, msgs)]
    sigs[3] = (F.P + 1).to_bytes(32, "little") + sigs[3][32:]
    host_ok = E.pack_batch(pks, msgs, sigs)[-1]
    assert host_ok.tolist() == JE.pack_batch(pks, msgs, sigs)[-1].tolist()
    assert not host_ok[3] and host_ok[[i for i in range(8) if i != 3]].all()
    got = E.verify_batch(pks, msgs, sigs, device="cpu")
    assert got.tolist() == [i != 3 for i in range(8)]


def test_fused_rejects_noncanonical_a_and_r():
    """fused :85: A and R encoded with y = p + 3."""
    rng = random.Random(12)
    key, pk = _keypair(rng)
    msg = bytes(range(32))
    sig = key.sign(msg)
    bad = (F.P + 3).to_bytes(32, "little")
    pks, sigs = [pk, bad, pk], [sig, sig, bad + sig[32:]]
    expect = [_oracle(p, msg, s) for p, s in zip(pks, sigs)]
    assert E.verify_batch(pks, [msg] * 3, sigs, device="cpu").tolist() == expect
    assert expect == [True, False, False]


def test_fused_matches_host_path():
    """fused :102: the fused prologue's verdicts equal the host-hashed
    ``pack_batch`` path's through the plain generic verify."""
    rng = random.Random(13)
    pks, msgs, sigs = [], [], []
    for i in range(16):
        key, pk = _keypair(rng)
        msg = bytes(rng.randrange(256) for _ in range(32))
        sig = key.sign(msg)
        if i % 3 == 2:
            sig = sig[:32] + bytes([sig[32] ^ 255]) + sig[33:]
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
    host = E.verify_impl(*(torch.as_tensor(x) for x in E.pack_batch(pks, msgs, sigs)))
    fused = E.verify_batch(pks, msgs, sigs, device="cpu")
    assert fused.tolist() == host.tolist() == [_oracle(*t) for t in zip(pks, msgs, sigs)]


def test_verify_batch_end_to_end_padding_and_malformed():
    """fused :121: an odd batch size (bucket padding) with malformed lengths
    and an all-zero signature masked off; an empty batch."""
    rng = random.Random(14)
    pks, msgs, sigs, expect = [], [], [], []
    for i in range(37):
        key, pk = _keypair(rng)
        msg = bytes(rng.randrange(256) for _ in range(32))
        sig = key.sign(msg)
        if i == 5:
            sig = sig[:40]
        elif i == 11:
            pk = pk[:10]
        elif i == 20:
            sig = bytes(64)
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
        expect.append(i not in (5, 11, 20))
    assert E.verify_batch(pks, msgs, sigs, device="cpu").tolist() == expect
    assert E.verify_batch([], [], [], device="cpu").shape == (0,)


# -- test_ed25519_indexed.py --------------------------------------------------

def test_indexed_rejects_malformed_lengths():
    """indexed :68: a short message and a short signature in a committee
    batch."""
    rng = random.Random(99)
    keys = [_keypair(rng) for _ in range(6)]
    table = E.KeyTable([pk for _, pk in keys], device="cpu")
    pks, msgs, sigs = [], [], []
    for i in range(8):
        key, pk = keys[i % 6]
        m = bytes(rng.randrange(256) for _ in range(32))
        pks.append(pk)
        msgs.append(m)
        sigs.append(key.sign(m))
    msgs[3] = b"short"
    sigs[5] = sigs[5][:-1]
    got = E.verify_batch_table(table, pks, msgs, sigs)
    assert got.tolist() == [i not in (3, 5) for i in range(8)]


@pytest.mark.parametrize("keys", [[], [b"too-short"]], ids=["empty", "short_key"])
def test_key_table_validation(keys):
    """indexed :79: the JAX package's KeyTable refuses these, and so does
    the port's."""
    with pytest.raises(ValueError):
        JE.KeyTable(keys)
    with pytest.raises(ValueError):
        E.KeyTable(keys, device="cpu")


# -- test_sha512_tpu.py and test_scalar_tpu.py --------------------------------

def test_sha512_96_is_the_ed25519_challenge_shape():
    """sha512 :27: R || A || blake2b-256 block digest, as the collector
    signs it."""
    signer = PCR.Signer.from_seed(b"challenge-shape")
    msgs = []
    for r in range(4):
        block = StatementBlock.build(0, r + 1, [], (), signer=signer)
        msgs.append(block.signature[:32] + signer.public_key.bytes + block.signed_digest())
    assert {len(m) for m in msgs} == {96}
    words = torch.as_tensor(H.pack_messages(msgs).view(np.int32))
    assert H.digest_bytes(H.sha512_96(words)) == [hashlib.sha512(m).digest() for m in msgs]


def test_mod_l_matches_sha512_challenge():
    """scalar :41: sha512_96 digest -> little-endian words -> limbs -> mod L
    is the challenge's int mod L."""
    rng = random.Random(5)
    msgs = [bytes(rng.randrange(256) for _ in range(96)) for _ in range(8)]
    words = torch.as_tensor(H.pack_messages(msgs).view(np.int32))
    le = SC.digest_words_to_le(H.sha512_96(words))
    k = SC.mod_L(SC.words_to_limbs(le, 40))
    assert [SC.limbs_to_int(r) for r in k] == [
        int.from_bytes(hashlib.sha512(m).digest(), "little") % SC.L for m in msgs]


def test_words_to_limbs_roundtrip():
    """scalar :55: 256-bit values through little-endian words and back."""
    rng = random.Random(6)
    values = [rng.getrandbits(256) for _ in range(16)] + [0, (1 << 256) - 1]
    words = torch.as_tensor(np.stack([
        np.frombuffer(v.to_bytes(32, "little"), dtype="<u4").astype(np.int64) for v in values]))
    assert [SC.limbs_to_int(r) for r in SC.words_to_limbs(words, 20)] == values
