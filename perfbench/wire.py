"""A frozen encoder of the block wire format (``docs/wire-format.md`` §4).

The benchmark builds every block it sends from the seed with this module, so
the program receives bytes only.  Transactions are laid out with numpy, one
array for a whole pool, never one Python object a transaction, which keeps
set-up short.  Signatures are Ed25519 (``cryptography``) over the signed
digest, blake2b-256 of every byte but the signature; the block digest is
blake2b-256 of all of them.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

SHARE_TAG = 0
SIGNATURE_SIZE = 64
ZERO_SIGNATURE = bytes(SIGNATURE_SIZE)


def blake2b_256(data) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def committee_keys(seed: int, size: int) -> list:
    """``size`` Ed25519 signing keys drawn from ``seed``."""
    return [
        Ed25519PrivateKey.from_private_bytes(
            blake2b_256(b"perfbench-key" + struct.pack("<QQ", seed & (2**64 - 1), i))
        )
        for i in range(size)
    ]


def public_bytes(keys) -> list:
    return [k.public_key().public_bytes_raw() for k in keys]


def reference_bytes(authority: int, round_: int, digest: bytes) -> bytes:
    """A BlockReference: u64 authority, u64 round, 32-byte digest."""
    return struct.pack("<QQ", authority, round_) + digest


def share_rows(payload: np.ndarray) -> np.ndarray:
    """(..., n_tx, size) uint8 payloads -> (..., n_tx, 5 + size) Share
    statements: tag 0, u32 little-endian length, the payload."""
    size = payload.shape[-1]
    out = np.empty(payload.shape[:-1] + (5 + size,), np.uint8)
    out[..., 0] = SHARE_TAG
    out[..., 1:5] = np.frombuffer(struct.pack("<I", size), np.uint8)
    out[..., 5:] = payload
    return out


def unsigned_bytes(authority: int, round_: int, includes: bytes, n_includes: int,
                   statements: bytes, n_statements: int, meta_ns: int,
                   epoch: int = 0, epoch_marker: int = 0) -> bytes:
    """Everything of a block but its signature: the signed bytes."""
    return b"".join((
        struct.pack("<QQI", authority, round_, n_includes), includes,
        struct.pack("<I", n_statements), statements,
        struct.pack("<QBQ", meta_ns, epoch_marker, epoch),
    ))


def genesis_digest(authority: int, epoch: int = 0) -> bytes:
    """The digest of an authority's round-0 block (unsigned, empty)."""
    return blake2b_256(unsigned_bytes(authority, 0, b"", 0, b"", 0, 0, epoch) + ZERO_SIGNATURE)


def sign_block(unsigned: bytes, key) -> tuple:
    """(wire bytes, block digest, signed digest) of ``unsigned`` signed by ``key``."""
    h = hashlib.blake2b(unsigned, digest_size=32)
    signed_digest = h.digest()
    signature = key.sign(signed_digest)
    h.update(signature)  # the block digest goes on over the signature
    return unsigned + signature, h.digest(), signed_digest
