"""Scalar arithmetic mod the Ed25519 group order L, and byte/word plumbing.

The plain PyTorch counterpart of ``mysticeti_tpu.ops.scalar``: the challenge
scalar k = SHA-512(R || A || M) mod L is reduced from the 512-bit digest in
13-bit limbs and sliced into the 4-bit windows the verify ladders consume.

* L = 2^252 + d with d ~ 2^124.6, so 2^260 = -256*d (mod L): the digest
  folds down via three signed multiply-by-256d passes, a bias of 1024*L makes
  the value positive, one Barrett-style quotient q = floor(x / 2^252) < 2^11
  removes the top bits (x == r - q*d mod L), and one conditional subtract of
  L canonicalizes.

Word tensors hold uint32 values in int64 (torch has no full uint32
arithmetic); limb tensors are int32.
"""
from __future__ import annotations

import numpy as np
import torch

RADIX = 13
MASK = (1 << RADIX) - 1

L = (1 << 252) + 27742317777372353535851937790883648493
_DELTA = L - (1 << 252)  # 125 bits
_D256 = _DELTA << 8  # 2^260 mod L == -_D256; 133 bits -> 11 limbs
P = (1 << 255) - 19
U32 = 0xFFFFFFFF


def _int_to_limbs_np(x: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= RADIX
    if x != 0:
        raise ValueError("constant exceeds limb capacity")
    return out


_D256_LIMBS = _int_to_limbs_np(_D256, 11)
_DELTA_LIMBS = _int_to_limbs_np(_DELTA, 10)
_L_LIMBS = _int_to_limbs_np(L, 20)
_L1024_LIMBS = _int_to_limbs_np(1024 * L, 21)


def limbs_to_int(limbs) -> int:
    """Host-side helper: limb vector -> python int."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    return sum(int(v) << (RADIX * i) for i, v in enumerate(np.asarray(limbs).tolist()))


def _carry_once(x: torch.Tensor) -> torch.Tensor:
    """One signed carry pass.  The TOP limb is left raw: it carries the sign
    of the whole value."""
    c = x >> RADIX
    c[..., -1] = 0
    return (x - (c << RADIX)) + torch.nn.functional.pad(c[..., :-1], (1, 0))


def _full_carry(x: torch.Tensor) -> torch.Tensor:
    """Worst-case borrow/carry ripple: width+2 passes."""
    for _ in range(x.shape[-1] + 2):
        x = _carry_once(x)
    return x


def _pad_limbs(x: torch.Tensor, width: int) -> torch.Tensor:
    pad = width - x.shape[-1]
    if pad <= 0:
        return x[..., :width]
    return torch.nn.functional.pad(x, (0, pad))


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, device=like.device)


def _mul_const(x: torch.Tensor, const_limbs: np.ndarray) -> torch.Tensor:
    """x (..., n) signed carried limbs times a small nonneg constant limb
    vector; returns the (..., n + len(const)) UNCARRIED product."""
    n = x.shape[-1]
    out_w = n + len(const_limbs)
    acc = torch.zeros((*x.shape[:-1], out_w), dtype=x.dtype, device=x.device)
    for j, cj in enumerate(const_limbs.tolist()):
        if cj:
            acc[..., j : j + n] += x * cj
    return acc


def _fold_once(x: torch.Tensor, out_width: int) -> torch.Tensor:
    """One signed fold: value(x) == lo + 2^260*hi -> lo - 256d*hi (mod L)."""
    prod = _mul_const(x[..., 20:], _D256_LIMBS)
    res = _pad_limbs(x[..., :20], out_width) - _pad_limbs(prod, out_width)
    return _carry_once(_carry_once(_carry_once(res)))


def geq_const(limbs: torch.Tensor, const_limbs: np.ndarray) -> torch.Tensor:
    """Value compare of unique nonneg limb arrays against a constant:
    batch-shaped bool, True iff value(limbs) >= const."""
    n = limbs.shape[-1]
    ge = torch.zeros(limbs.shape[:-1], dtype=torch.bool, device=limbs.device)
    eq = torch.ones_like(ge)
    for i in reversed(range(n)):
        c = int(const_limbs[i]) if i < len(const_limbs) else 0
        ge = ge | (eq & (limbs[..., i] > c))
        eq = eq & (limbs[..., i] == c)
    return ge | eq


def mod_L(x: torch.Tensor) -> torch.Tensor:
    """Reduce a 512-bit value given as (..., 40) carried int32 limbs mod L;
    returns (..., 20) canonical limbs of the value in [0, L)."""
    x = _fold_once(x, 32)
    x = _fold_once(x, 24)
    x = _fold_once(x, 22)
    x = _full_carry(_pad_limbs(x, 22) + _pad_limbs(_const(_L1024_LIMBS, x), 22))
    # Barrett step: x == q*2^252 + r, 2^252 == -d (mod L)  =>  x == r - q*d.
    q = (x[..., 19] >> 5) + (x[..., 20] << 8) + (x[..., 21] << 21)  # < 2^11
    r = x[..., :20].clone()
    r[..., 19] &= 31
    qd = _pad_limbs(q[..., None] * _const(_DELTA_LIMBS, x), 11)
    qd = _carry_once(_carry_once(qd))
    y = _full_carry(r + _const(_L_LIMBS, x) - _pad_limbs(qd, 20))  # in (0, 2L)
    ge = geq_const(y, _L_LIMBS)
    y = torch.where(ge[..., None], y - _const(_L_LIMBS, x), y)
    return _full_carry(y)


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte-swap uint32 lanes (held in int64)."""
    x = x.to(torch.int64) & U32
    return (
        ((x & 0xFF) << 24)
        | ((x & 0xFF00) << 8)
        | ((x >> 8) & 0xFF00)
        | (x >> 24)
    )


def digest_words_to_le(digest: torch.Tensor) -> torch.Tensor:
    """(..., 16) sha512_96 output words -> (..., 16) little-endian value words
    (the byte-swap of each output word in place)."""
    return bswap32(digest)


def words_to_limbs(words: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """(..., W) uint32 little-endian value words -> (..., n_limbs) int32 limbs."""
    w = words.shape[-1]
    words = words.to(torch.int64) & U32
    out = []
    for m in range(n_limbs):
        bit = RADIX * m
        q, r = bit // 32, bit % 32
        if q >= w:
            out.append(torch.zeros_like(words[..., 0]))
            continue
        v = words[..., q] >> r
        if r + RADIX > 32 and q + 1 < w:
            v = v | (words[..., q + 1] << (32 - r))
        out.append(v & MASK)
    return torch.stack(out, dim=-1).to(torch.int32)


def windows4(limbs: torch.Tensor, n_windows: int = 64) -> torch.Tensor:
    """(..., 20) canonical limbs -> (..., n_windows) 4-bit windows, LSB first."""
    out = []
    for wnd in range(n_windows):
        bit = 4 * wnd
        q, r = bit // RADIX, bit % RADIX
        v = limbs[..., q] >> r
        if r + 4 > RADIX and q + 1 < limbs.shape[-1]:
            v = v | (limbs[..., q + 1] << (RADIX - r))
        out.append(v & 15)
    return torch.stack(out, dim=-1).to(torch.int32)


def lt_L(limbs: torch.Tensor) -> torch.Tensor:
    """value(limbs) < L (s-canonicity: RFC 8032 / OpenSSL reject s >= L)."""
    return ~geq_const(limbs, _int_to_limbs_np(L, limbs.shape[-1]))


def lt_P(limbs: torch.Tensor) -> torch.Tensor:
    """value(limbs) < p (canonical field-element encoding check)."""
    return ~geq_const(limbs, _int_to_limbs_np(P, limbs.shape[-1]))
