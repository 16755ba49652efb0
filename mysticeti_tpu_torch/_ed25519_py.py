"""Pure-Python RFC 8032 Ed25519 — the no-dependency fallback oracle.

Loaded by :mod:`mysticeti_tpu_torch.crypto` when the ``cryptography`` package is
absent.  Exposes the exact class surface ``crypto.py`` consumes from
``cryptography.hazmat.primitives.asymmetric.ed25519`` (``generate``,
``from_private_bytes``, ``sign``, ``public_key``, ``public_bytes_raw``,
``from_public_bytes``, ``verify``) plus ``InvalidSignature``.

Verification is STRICT, matching the OpenSSL/RFC 8032 semantics the CUDA
kernels are held to:

* ``S >= L`` rejected (malleability defense);
* non-canonical point encodings (``y >= p``) of A and R rejected;
* the group equation checked without cofactor: ``[S]B == R + [k]A``.

Scalar multiplication is a plain double-and-add over extended homogeneous
coordinates; verification uses Straus/Shamir simultaneous multiplication so
a verify costs roughly one scalar-mult of point additions.  ~1-3 ms per
operation in CPython — the correctness oracle for tests, not a production
signing path (the batched CUDA kernels are the fast path).
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# Extended homogeneous coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z,
# x*y = T/Z (RFC 8032 §5.1.4).
_Point = Tuple[int, int, int, int]

_IDENTITY: _Point = (0, 1, 1, 0)

_BASE_Y = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int) -> Optional[int]:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BASE: _Point = (
    _recover_x(_BASE_Y, 0),  # type: ignore[assignment]
    _BASE_Y,
    1,
    _recover_x(_BASE_Y, 0) * _BASE_Y % P,  # type: ignore[operator]
)


def _add(p: _Point, q: _Point) -> _Point:
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(s: int, p: _Point) -> _Point:
    q = _IDENTITY
    while s > 0:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _double_mul(s: int, k: int, a: _Point) -> _Point:
    """Straus simultaneous [s]B + [k]A — one shared doubling chain."""
    ba = _add(_BASE, a)
    q = _IDENTITY
    for bit in range(max(s.bit_length(), k.bit_length()) - 1, -1, -1):
        q = _add(q, q)
        sb, kb = (s >> bit) & 1, (k >> bit) & 1
        if sb and kb:
            q = _add(q, ba)
        elif sb:
            q = _add(q, _BASE)
        elif kb:
            q = _add(q, a)
    return q


def _compress(p: _Point) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(raw: bytes) -> Optional[_Point]:
    if len(raw) != 32:
        return None
    enc = int.from_bytes(raw, "little")
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, enc >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _equal(p: _Point, q: _Point) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def _sha512_mod_l(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little") % L


class InvalidSignature(Exception):
    """Raised by ``Ed25519PublicKey.verify`` on rejection (API parity with
    ``cryptography.exceptions.InvalidSignature``)."""


class Ed25519PublicKey:
    __slots__ = ("_raw", "_point")

    def __init__(self, raw: bytes) -> None:
        self._raw = raw
        self._point: Optional[_Point] = None  # decoded lazily, at first verify

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "Ed25519PublicKey":
        if len(raw) != 32:
            raise ValueError("public key must be 32 bytes")
        return cls(bytes(raw))

    def public_bytes_raw(self) -> bytes:
        return self._raw

    def verify(self, signature: bytes, message: bytes) -> None:
        if len(signature) != 64:
            raise InvalidSignature("signature must be 64 bytes")
        if self._point is None:
            point = _decompress(self._raw)
            if point is None:
                raise InvalidSignature("undecodable public key")
            self._point = point
        r_point = _decompress(signature[:32])
        if r_point is None:
            raise InvalidSignature("undecodable R")
        s = int.from_bytes(signature[32:], "little")
        if s >= L:
            raise InvalidSignature("non-canonical S")
        k = _sha512_mod_l(signature[:32], self._raw, message)
        # [S]B == R + [k]A  <=>  [S]B + [k](-A) == R
        x, y, z, t = self._point
        neg_a = (P - x, y, z, P - t)
        if not _equal(_double_mul(s, k, neg_a), r_point):
            raise InvalidSignature("group equation failed")


class Ed25519PrivateKey:
    __slots__ = ("_scalar", "_prefix", "_pk_bytes")

    def __init__(self, seed: bytes) -> None:
        h = hashlib.sha512(seed).digest()
        scalar = int.from_bytes(h[:32], "little")
        scalar &= (1 << 254) - 8
        scalar |= 1 << 254
        self._scalar = scalar
        self._prefix = h[32:]
        self._pk_bytes = _compress(_mul(scalar, _BASE))

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, seed: bytes) -> "Ed25519PrivateKey":
        if len(seed) != 32:
            raise ValueError("private key seed must be 32 bytes")
        return cls(bytes(seed))

    def public_key(self) -> Ed25519PublicKey:
        return Ed25519PublicKey(self._pk_bytes)

    def sign(self, message: bytes) -> bytes:
        r = _sha512_mod_l(self._prefix, message)
        r_bytes = _compress(_mul(r, _BASE))
        k = _sha512_mod_l(r_bytes, self._pk_bytes, message)
        s = (r + k * self._scalar) % L
        return r_bytes + s.to_bytes(32, "little")


def selftest() -> None:
    """RFC 8032 test vector 1 (empty message) — cheap import-time sanity
    guard used by the test suite, not run on import."""
    seed = bytes.fromhex(
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"
    )
    key = Ed25519PrivateKey.from_private_bytes(seed)
    assert key.public_key().public_bytes_raw() == bytes.fromhex(
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
    )
    sig = key.sign(b"")
    assert sig == bytes.fromhex(
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
    )
    key.public_key().verify(sig, b"")


__all__ = [
    "Ed25519PrivateKey",
    "Ed25519PublicKey",
    "InvalidSignature",
    "selftest",
]
