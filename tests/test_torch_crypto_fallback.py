"""The port's pure-Python Ed25519 oracle and crypto surface held to
``tests/test_crypto_fallback.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``): the RFC 8032 self-test, sign/verify
with its rejections, non-canonical s and point encodings, and the active
backend's ``Signer`` surface.  Beyond it, on the same seeded keys and
messages, the port's fallback must give the JAX package's public keys and
signatures byte for byte, and the same verdict on every mutation of them
(flipped bits in R, s, the message or the key, s + L, y >= p encodings),
and ``crypto``'s seeded signers and digests must match.
"""
import hashlib
import random

import pytest

from mysticeti_tpu import _ed25519_py as JF
from mysticeti_tpu import crypto as JCR
from mysticeti_tpu_torch import _ed25519_py as PF
from mysticeti_tpu_torch import crypto as PCR
from torch_reference import suite_on_port

globals().update(suite_on_port("test_crypto_fallback.py"))

NONCANONICAL_Y = bytes([0xFF] * 31 + [0x7F])


def _cases(seed):
    rng = random.Random(seed)
    sk = hashlib.blake2b(seed.to_bytes(4, "little"), digest_size=32).digest()
    msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 80)))
    return sk, msg, rng


def fallback_trace(f, seed):
    sk, msg, rng = _cases(seed)
    key = f.Ed25519PrivateKey.from_private_bytes(sk)
    pk = key.public_key().public_bytes_raw()
    sig = key.sign(msg)
    variants = [("good", pk, sig, msg)]
    for part, lo, hi in (("R", 0, 32), ("s", 32, 64)):
        flipped = bytearray(sig)
        flipped[rng.randrange(lo, hi)] ^= 1 << rng.randrange(8)
        variants.append((f"flip-{part}", pk, bytes(flipped), msg))
    s = int.from_bytes(sig[32:], "little")
    variants += [
        ("s+L", pk, sig[:32] + (s + f.L).to_bytes(32, "little"), msg),
        ("msg", pk, sig, msg + b"!"),
        ("key", bytes(b ^ (i == 5) for i, b in enumerate(pk)), sig, msg),
        ("y>=p A", NONCANONICAL_Y, sig, msg),
        ("y>=p R", pk, NONCANONICAL_Y + sig[32:], msg),
    ]
    verdicts = []
    for name, raw_pk, raw_sig, raw_msg in variants:
        try:
            f.Ed25519PublicKey.from_public_bytes(raw_pk).verify(raw_sig, raw_msg)
            verdicts.append((name, True))
        except f.InvalidSignature:
            verdicts.append((name, False))
        except ValueError as exc:  # a key that does not decode
            verdicts.append((name, type(exc).__name__))
    return pk, sig, verdicts


@pytest.mark.parametrize("seed", range(6))
def test_fallback_as_the_jax_package(seed):
    port = fallback_trace(PF, seed)
    assert port == fallback_trace(JF, seed)
    verdicts = dict(port[2])
    assert verdicts.pop("good") is True
    assert not any(v is True for v in verdicts.values()), verdicts


def surface_trace(crypto):
    out = []
    for i in range(4):
        signer = crypto.Signer.from_seed(b"surface-%d" % i)
        digest = crypto.blake2b_256(b"payload-%d" % i)
        sig = signer.sign(digest)
        out.append((signer.public_key.bytes, digest, sig, signer.public_key.verify(sig, digest),
                    signer.public_key.verify(sig, crypto.blake2b_256(b"other"))))
    return out


def test_crypto_surface_as_the_jax_package():
    assert surface_trace(PCR) == surface_trace(JCR)
