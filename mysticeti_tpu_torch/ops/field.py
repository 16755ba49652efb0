"""GF(2^255-19) arithmetic in 20 x 13-bit int32 limbs, on torch tensors.

The plain PyTorch counterpart of ``mysticeti_tpu.ops.field``: the same limb
layout and the same "partial form" invariant at every public function, so the
tests hold it against the JAX module limb for limb.

  limbs[0..18] in [0, 2^13],  limbs[19] in [0, 2^9]   (value < 2^256, may be >= p)

A product of two limbs is <= 2^26 and a 20-term anti-diagonal sum stays below
2^31, so every intermediate fits int32.  The CUDA kernels do not use this
representation (they pick 5 x 51-bit limbs for Hopper's 64-bit multiplier,
csrc/fe51.cuh); these functions are what their plain versions run.

All functions take ``(..., 20)`` int32 tensors on any device.
"""
from __future__ import annotations

import numpy as np
import torch

RADIX = 13
NLIMBS = 20
MASK = (1 << RADIX) - 1  # 8191
P = (1 << 255) - 19
FOLD_260 = 19 << 5  # 2^260 mod p = 608: limb 20+j folds to limb j
FOLD_256 = 38  # 2^256 mod p: top-limb bits >= 9 fold to limb 0

_WORK = 2 * NLIMBS + 2  # product workspace: 39 live limbs + carry headroom

_BIAS_8P = np.array([(1 << RADIX) - 152] + [MASK] * 18 + [(1 << 11) - 1], np.int32)
_P_LIMBS = np.array([(1 << RADIX) - 19] + [MASK] * 18 + [255], np.int32)

_const_cache: dict = {}


def _on(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host constant as a tensor on ``like``'s device (cached per device)."""
    key = (id(arr), like.device)
    t = _const_cache.get(key)
    if t is None:
        t = torch.as_tensor(arr, device=like.device)
        _const_cache[key] = t
    return t


def int_to_limbs(x: int) -> np.ndarray:
    """Host-side: python int (< 2^260) -> limb vector."""
    out = np.zeros(NLIMBS, dtype=np.int32)
    for i in range(NLIMBS):
        out[i] = x & MASK
        x >>= RADIX
    if x != 0:
        raise ValueError("value exceeds 260 bits")
    return out


def limbs_to_int(limbs) -> int:
    """Host-side: limb vector -> python int (no reduction)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    return sum(int(l) << (RADIX * i) for i, l in enumerate(np.asarray(limbs).tolist()))


def constant(x: int, like: torch.Tensor) -> torch.Tensor:
    """``x mod p`` in limb form, on ``like``'s device, broadcastable."""
    return torch.as_tensor(int_to_limbs(x % P), device=like.device)


def _shift_up(c: torch.Tensor) -> torch.Tensor:
    """Move each limb's carry one limb up (the top carry falls off)."""
    return torch.nn.functional.pad(c[..., :-1], (1, 0))


def _carry_once(x: torch.Tensor) -> torch.Tensor:
    """One signed carry pass; remainders land in [0, 2^13).  The carry out of
    the top limb is DROPPED: callers guarantee it is zero."""
    c = x >> RADIX  # arithmetic shift: floor division for negative limbs too
    return (x - (c << RADIX)) + _shift_up(c)


def _add_at(x: torch.Tensor, idx: int, v: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., idx] += v
    return x


def _normalize_top(x: torch.Tensor) -> torch.Tensor:
    """Fold top-limb bits >= 9 (value bits >= 256) into limb 0 with factor 38,
    then one carry pass.  Requires value < 2^269."""
    c = x[..., NLIMBS - 1] >> 9
    x = x.clone()
    x[..., NLIMBS - 1] -= c << 9
    x[..., 0] += FOLD_256 * c
    return _carry_once(x)


def _fold_reduce(wide: torch.Tensor) -> torch.Tensor:
    """Reduce a ``_WORK``-limb non-negative value (limbs < 2^31) to partial form."""
    x = _carry_once(_carry_once(_carry_once(wide)))
    lo = x[..., :NLIMBS] + FOLD_260 * x[..., NLIMBS : 2 * NLIMBS]
    lo = lo.clone()
    lo[..., :2] += FOLD_260 * FOLD_260 * x[..., 2 * NLIMBS :]
    # Carry in a 21-limb workspace so the overflow out of limb 19 is kept,
    # then fold it back (x608).
    lo = _carry_once(_carry_once(torch.nn.functional.pad(lo, (0, 1))))
    top = lo[..., NLIMBS]
    lo = _add_at(lo[..., :NLIMBS], 0, FOLD_260 * top)
    # Limb 19 can still hold exactly 2^13 here; fold its bits >= 13 by hand,
    # since _carry_once would drop them.
    c = lo[..., NLIMBS - 1] >> RADIX
    lo[..., NLIMBS - 1] -= c << RADIX
    lo[..., 0] += FOLD_260 * c
    return _normalize_top(_carry_once(lo))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply: schoolbook product, then fold.

    Limb d of the wide product is sum_i a[i] * b[d - i]: a sliding window
    (``unfold``) over zero-padded b, against a reversed, summed per window."""
    a, b = torch.broadcast_tensors(a, b)
    windows = torch.nn.functional.pad(b, (NLIMBS - 1, _WORK - NLIMBS)).unfold(-1, NLIMBS, 1)
    wide = (windows * a.flip(-1)[..., None, :]).sum(-1, dtype=torch.int32)
    return _fold_reduce(wide)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b in partial form."""
    return _normalize_top(_carry_once(a + b))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p): bias by 8p so the total is positive."""
    x = a + _on(_BIAS_8P, a) - b
    return _normalize_top(_carry_once(_carry_once(x)))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    """a^(2^k): k repeated squarings."""
    for _ in range(k):
        a = square(a)
    return a


def _ladder(z: torch.Tensor):
    """Shared prefix of the inversion / sqrt addition chains: returns
    (z^11, z^(2^250-1))."""
    z2 = square(z)
    z9 = mul(square(square(z2)), z)
    z11 = mul(z9, z2)
    z2_5_0 = mul(square(z11), z9)
    z2_10_0 = mul(pow2k(z2_5_0, 5), z2_5_0)
    z2_20_0 = mul(pow2k(z2_10_0, 10), z2_10_0)
    z2_40_0 = mul(pow2k(z2_20_0, 20), z2_20_0)
    z2_50_0 = mul(pow2k(z2_40_0, 10), z2_10_0)
    z2_100_0 = mul(pow2k(z2_50_0, 50), z2_50_0)
    z2_200_0 = mul(pow2k(z2_100_0, 100), z2_100_0)
    z2_250_0 = mul(pow2k(z2_200_0, 50), z2_50_0)
    return z11, z2_250_0


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) (classic curve25519 chain; 254 squarings)."""
    z11, z2_250_0 = _ladder(z)
    return mul(pow2k(z2_250_0, 5), z11)


def pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252-3), the decompression square-root exponent."""
    _, z2_250_0 = _ladder(z)
    return mul(pow2k(z2_250_0, 2), z)


def _full_carry(x: torch.Tensor) -> torch.Tensor:
    """Enough carry passes for a worst-case full ripple."""
    for _ in range(NLIMBS + 1):
        x = _carry_once(x)
    return x


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Fully reduce partial limbs to the canonical representative in [0, p)."""
    for _ in range(2):
        c = x[..., NLIMBS - 1] >> 8
        x = x.clone()
        x[..., NLIMBS - 1] -= c << 8
        x[..., 0] += 19 * c
        x = _full_carry(x)
    ge_p = (
        (x[..., NLIMBS - 1] == 255)
        & torch.all(x[..., 1 : NLIMBS - 1] == MASK, dim=-1)
        & (x[..., 0] >= (1 << RADIX) - 19)
    )
    return torch.where(ge_p[..., None], x - _on(_P_LIMBS, x), x)


def eq_canonical(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality of field elements given in partial form (bool, batch-shaped)."""
    return torch.all(canonical(a) == canonical(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=-1)


def parity(a: torch.Tensor) -> torch.Tensor:
    """Least significant bit of the canonical representative (the sign bit)."""
    return canonical(a)[..., 0] & 1
