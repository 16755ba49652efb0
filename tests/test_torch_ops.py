"""The port's plain ops against python-int math and the JAX package.

Field, scalar and SHA-512 ops are held to python ints and hashlib; the
packers, combs, tile grouping and bucketing to ``mysticeti_tpu.ops.ed25519``
byte for byte; the plain prologue to ``jax.jit(prepare_fused)`` element for
element.  Every comparison is exact (integers and bits: tolerance zero).
"""
import hashlib

import jax
import numpy as np
import pytest
import torch

from mysticeti_tpu.ops import ed25519 as JE
from mysticeti_tpu_torch import _ed25519_py as PY
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.ops import ed25519_cuda as K
from mysticeti_tpu_torch.ops import field as F
from mysticeti_tpu_torch.ops import scalar as SC
from mysticeti_tpu_torch.ops import sha512 as H

P = F.P
L = SC.L


def _limbs(values):
    return torch.as_tensor(np.stack([F.int_to_limbs(v) for v in values]))


def _ints(t):
    return [F.limbs_to_int(row) for row in F.canonical(t)]


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(2026)


def _rand_ints(rng, n, bound):
    return [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]


def test_field_ops_match_python_ints(rng):
    xs = _rand_ints(rng, 12, P) + [0, 1, P - 1]
    ys = _rand_ints(rng, 12, P) + [P - 1, 0, P - 1]
    a, b = _limbs(xs), _limbs(ys)
    assert _ints(F.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert _ints(F.add(a, b)) == [(x + y) % P for x, y in zip(xs, ys)]
    assert _ints(F.sub(a, b)) == [(x - y) % P for x, y in zip(xs, ys)]
    assert _ints(F.neg(a)) == [-x % P for x in xs]
    assert _ints(F.invert(a[:-3])) == [pow(x, P - 2, P) for x in xs[:-3]]
    assert _ints(F.pow22523(a)) == [pow(x, (P - 5) // 8, P) for x in xs]
    assert F.parity(a).tolist() == [x & 1 for x in xs]
    assert F.is_zero(a).tolist() == [x == 0 for x in xs]
    assert F.eq_canonical(a, F.add(a, _limbs([0] * len(xs)))).all()


def test_scalar_ops_match_python_ints(rng):
    digests = [int.from_bytes(rng.bytes(64), "little") for _ in range(10)] + [
        (1 << 512) - 1, 0, L, L - 1]
    words = torch.as_tensor(
        np.array([[(d >> (32 * j)) & 0xFFFFFFFF for j in range(16)] for d in digests],
                 dtype=np.int64))
    k = SC.mod_L(SC.words_to_limbs(words, 40))
    assert [SC.limbs_to_int(r) for r in k] == [d % L for d in digests]
    assert SC.windows4(k).tolist() == [
        [(d % L >> (4 * w)) & 15 for w in range(64)] for d in digests]
    vals = [L - 1, L, L + 1, P - 1, P, 0, (1 << 255) - 1]
    limbs = torch.as_tensor(np.stack([SC._int_to_limbs_np(v, 20) for v in vals]))
    assert SC.lt_L(limbs).tolist() == [v < L for v in vals]
    assert SC.lt_P(limbs).tolist() == [v < P for v in vals]
    w = torch.tensor([0x01020304, 0xA0B0C0D0], dtype=torch.int64)
    assert SC.bswap32(w).tolist() == [0x04030201, 0xD0C0B0A0]


def test_sha512_96_matches_hashlib(rng):
    msgs = [rng.bytes(96) for _ in range(6)]
    words = torch.as_tensor(H.pack_messages(msgs).view(np.int32))
    assert H.digest_bytes(H.sha512_96(words)) == [hashlib.sha512(m).digest() for m in msgs]


def _cases(rng_seed: int, n: int, n_keys: int = 4):
    """Signed 32-byte digests with the seven KERNEL_PARITY case classes."""
    rng = np.random.default_rng(rng_seed)
    keys = [PY.Ed25519PrivateKey.from_private_bytes(rng.bytes(32)) for _ in range(n_keys)]
    raw = [k.public_key().public_bytes_raw() for k in keys]
    classes = ["valid", "corrupt_R", "corrupt_s", "corrupt_msg", "wrong_key",
               "noncanonical_s", "corrupt_pk"]
    pks, msgs, sigs, labels = [], [], [], []
    for i in range(n):
        ki = i % n_keys
        msg = rng.bytes(32)
        sig = keys[ki].sign(msg)
        pk = raw[ki]
        cls = classes[i % len(classes)]
        if cls == "corrupt_R":
            sig = bytes([sig[0] ^ 2]) + sig[1:]
        elif cls == "corrupt_s":
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        elif cls == "corrupt_msg":
            msg = bytes([msg[0] ^ 1]) + msg[1:]
        elif cls == "wrong_key":
            pk = raw[(ki + 1) % n_keys]
        elif cls == "noncanonical_s":
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")
        elif cls == "corrupt_pk":
            pk = bytes([pk[0] ^ 1]) + pk[1:]
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
        labels.append(cls)
    return raw, pks, msgs, sigs, labels


def test_packers_byte_identical_to_jax():
    raw, pks, msgs, sigs, _ = _cases(1, 21)
    # Malformed lengths ride host_ok=False in both.
    pks[3] = pks[3][:31]
    sigs[5] = sigs[5] + b"\x00"
    for got, want in zip(E.pack_bytes(pks, msgs, sigs), JE.pack_bytes(pks, msgs, sigs)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(E.pack_blob(pks, msgs, sigs), JE.pack_blob(pks, msgs, sigs))
    np.testing.assert_array_equal(E.pk_table_words(raw), JE.pk_table_words(raw))
    idx = np.array([i % 5 - 1 for i in range(21)])
    np.testing.assert_array_equal(
        E.pack_blob_indexed(idx, msgs, sigs, num_keys=3),
        JE.pack_blob_indexed(idx, msgs, sigs, num_keys=3),
    )
    long_msgs = [m + b"x" for m in msgs]
    for got, want in zip(E.pack_batch(pks, long_msgs, sigs), JE.pack_batch(pks, long_msgs, sigs)):
        np.testing.assert_array_equal(got, want)


def test_combs_byte_identical_to_jax():
    raw, *_ = _cases(2, 1)
    bad = (P + 5).to_bytes(32, "little")  # non-canonical y: an invalid key
    keys = raw[:3] + [bad]
    got, got_valid = E.build_neg_key_combs(keys)
    want, want_valid = JE.build_neg_key_combs(keys)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got_valid.tolist() == [True, True, True, False]
    from mysticeti_tpu.ops import ed25519_pallas as JP

    np.testing.assert_array_equal(E.base_comb("cpu").numpy(), JP._COMB_T)


@pytest.mark.parametrize("tile,bucket", [(4, 128), (32, 256), (8, 64)])
def test_group_blob_for_tiles_identical_to_jax(tile, bucket):
    rng = np.random.default_rng(tile)
    n, num_keys = 50, 5
    blob = rng.integers(1, 2**31, size=(n, 26), dtype=np.int64).astype(np.uint32)
    blob[:, 24] = rng.integers(0, num_keys, size=n)
    blob[:, 25] = 1
    blob[::11, 25] = 0
    got = E.group_blob_for_tiles(blob, num_keys, tile, bucket)
    want = JE.group_blob_for_tiles(blob, num_keys, tile, bucket)
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_iter_buckets_identical_to_jax():
    assert E.BUCKETS == JE.BUCKETS
    for n in (1, 200, 256, 257, 1000, 1300, 5000, 16384, 20000, 40000):
        assert list(E.iter_buckets(n)) == list(JE.iter_buckets(n))


def test_plain_prologue_equals_jax_prepare_fused():
    raw, pks, msgs, sigs, _ = _cases(3, 14)
    pks[1] = (P + 3).to_bytes(32, "little")  # non-canonical A
    sigs[2] = (P + 1).to_bytes(32, "little") + sigs[2][32:]  # non-canonical R
    msg_words, s_words, host_ok = JE.pack_bytes(pks, msgs, sigs)
    host_ok[4] = False
    want = jax.jit(JE.prepare_fused)(msg_words, s_words, host_ok)
    blob = np.concatenate([msg_words, s_words, host_ok[:, None].astype(np.uint32)], axis=1)
    got = K.prologue(E.to_device_words(blob, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The indexed layout through the key table gives the same seven arrays.
    table = E.KeyTable(raw, device="cpu")
    iblob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(raw))
    known = table.indices_for(pks) >= 0
    got_i = K.prologue(E.to_device_words(iblob, "cpu"), table.words)
    for g, w in zip(got_i[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy()[known], np.asarray(w)[known])
