"""Digests, keys and signatures for the consensus engine (CPU reference path).

Mirrors the capability surface of ``mysticeti-core/src/crypto.rs``:

* 32-byte Blake2b-256 block digests (``crypto.rs:21-22,33-61``).
* Ed25519 signing/verification keyed per authority (``crypto.rs:24-31,174-223``).
* The signature/digest layering subtlety (``crypto.rs:77-84``): the *signature* covers
  the digest computed **without** the signature field, while the *block digest* covers
  everything **including** the signature.  This lets descendants of a certified block
  skip signature verification during sync — the batch verifier exploits the same
  property to drop already-covered items from a batch.

The CPU path here uses ``hashlib.blake2b`` and the ``cryptography`` library's Ed25519
(the correctness oracle) when that package is installed; otherwise the pure-Python
RFC 8032 implementation in :mod:`mysticeti_tpu_torch._ed25519_py` fills in with the same
class surface and the same strict accept/reject semantics.  The CUDA path lives in
``mysticeti_tpu_torch.ops`` and is checked against this module bit-for-bit (accept/reject
parity) by the test suite.
"""
from __future__ import annotations

import hashlib
from typing import Optional

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    HAVE_CRYPTOGRAPHY = True
except ModuleNotFoundError:  # optional fast path absent: pure-Python oracle
    from ._ed25519_py import (  # type: ignore[assignment]
        Ed25519PrivateKey,
        Ed25519PublicKey,
        InvalidSignature,
    )

    HAVE_CRYPTOGRAPHY = False

DIGEST_SIZE = 32
SIGNATURE_SIZE = 64
PUBLIC_KEY_SIZE = 32

BLOCK_DIGEST_NONE = b"\x00" * DIGEST_SIZE
SIGNATURE_NONE = b"\x00" * SIGNATURE_SIZE


def blake2b_256(data: bytes) -> bytes:
    """32-byte Blake2b digest — the reference's BlockDigest hash (crypto.rs:33-61)."""
    return hashlib.blake2b(data, digest_size=DIGEST_SIZE).digest()


class PublicKey:
    """An authority's Ed25519 verifying key (crypto.rs:24)."""

    __slots__ = ("bytes", "_key")

    def __init__(self, raw: bytes) -> None:
        if len(raw) != PUBLIC_KEY_SIZE:
            raise ValueError(f"public key must be {PUBLIC_KEY_SIZE} bytes")
        self.bytes = raw
        self._key: Optional[Ed25519PublicKey] = None

    def _loaded(self) -> Ed25519PublicKey:
        if self._key is None:
            self._key = Ed25519PublicKey.from_public_bytes(self.bytes)
        return self._key

    def verify(self, signature: bytes, message: bytes) -> bool:
        try:
            self._loaded().verify(signature, message)
            return True
        except InvalidSignature:
            return False

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PublicKey) and self.bytes == other.bytes

    def __hash__(self) -> int:
        return hash(self.bytes)

    def __repr__(self) -> str:
        return f"PublicKey({self.bytes.hex()[:8]})"


class Signer:
    """An authority's Ed25519 signing key (crypto.rs:26,199-223).

    Key material is held only by this object; ``dummy_signer`` (crypto.rs:355-357)
    equivalent is ``Signer.dummy()`` used by tests and the DAG DSL.
    """

    __slots__ = ("_key", "public_key")

    def __init__(self, key: Ed25519PrivateKey) -> None:
        self._key = key
        self.public_key = PublicKey(key.public_key().public_bytes_raw())

    @classmethod
    def generate(cls) -> "Signer":
        return cls(Ed25519PrivateKey.generate())

    @classmethod
    def from_seed(cls, seed: bytes) -> "Signer":
        """Deterministic signer from a 32-byte seed (test/genesis tooling)."""
        if len(seed) != 32:
            seed = hashlib.blake2b(seed, digest_size=32).digest()
        return cls(Ed25519PrivateKey.from_private_bytes(seed))

    @classmethod
    def dummy(cls) -> "Signer":
        return cls.from_seed(b"\x00" * 32)

    def sign(self, message: bytes) -> bytes:
        return self._key.sign(message)

    def __repr__(self) -> str:
        return f"Signer({self.public_key.bytes.hex()[:8]})"
