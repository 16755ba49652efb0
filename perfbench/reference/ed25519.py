"""Plain RFC 8032 Ed25519 verification in Python integers.

Strict in the way OpenSSL is: ``S >= L`` is rejected, the public key must
decode (``y < p``, on the curve), and ``[S]B - [k]A`` is encoded and compared
byte for byte with the signature's R, so a non-canonical R never matches.
Both scalar multiplications go through 4-bit combs (64 windows of 16
multiples), the base point's built once and each key's at first use, so a
verification costs 128 point additions and one inversion.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]  # extended (X, Y, Z, T), x = X/Z, y = Y/Z
IDENTITY: Point = (0, 1, 1, 0)


def add(p: Point, q: Point) -> Point:
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def recover_x(y: int, sign: int) -> Optional[int]:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    return P - x if (x & 1) != sign else x


def decompress(raw: bytes) -> Optional[Point]:
    if len(raw) != 32:
        return None
    enc = int.from_bytes(raw, "little")
    y = enc & ((1 << 255) - 1)
    x = recover_x(y, enc >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def compress(p: Point) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def negate(p: Point) -> Point:
    x, y, z, t = p
    return ((P - x) % P, y, z, (P - t) % P)


_BY = 4 * pow(5, P - 2, P) % P
BASE: Point = (recover_x(_BY, 0), _BY, 1, recover_x(_BY, 0) * _BY % P)


def comb(q: Point) -> List[List[Point]]:
    """table[i][j] = j * 16^i * q for 64 windows and j in 0..15."""
    table = []
    step = q
    for _ in range(64):
        row = [IDENTITY, step]
        for _ in range(14):
            row.append(add(row[-1], step))
        table.append(row)
        step = add(row[15], step)  # 16 * step
    return table


def comb_mul(table: List[List[Point]], scalar: int) -> Point:
    acc = IDENTITY
    for i in range(64):
        digit = (scalar >> (4 * i)) & 15
        if digit:
            acc = add(acc, table[i][digit])
    return acc


_BASE_COMB = comb(BASE)


class Verifier:
    """Verifies signatures under a fixed set of public keys."""

    def __init__(self) -> None:
        self._neg_combs: Dict[bytes, Optional[List[List[Point]]]] = {}

    def _neg_comb(self, public_key: bytes):
        if public_key not in self._neg_combs:
            a = decompress(public_key)
            self._neg_combs[public_key] = None if a is None else comb(negate(a))
        return self._neg_combs[public_key]

    def verify(self, public_key: bytes, signature: bytes, message: bytes) -> bool:
        if len(signature) != 64:
            return False
        neg_a = self._neg_comb(public_key)
        if neg_a is None:
            return False
        s = int.from_bytes(signature[32:], "little")
        if s >= L:
            return False
        k = int.from_bytes(hashlib.sha512(signature[:32] + public_key + message).digest(), "little") % L
        return compress(add(comb_mul(_BASE_COMB, s), comb_mul(neg_a, k))) == signature[:32]
