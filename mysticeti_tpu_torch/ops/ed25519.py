"""Batched Ed25519 verification on torch tensors: plain pieces and dispatch.

The counterpart of ``mysticeti_tpu.ops.ed25519``.  It holds:

* the plain PyTorch versions of the device functions on the verify path:
  ``prepare_fused`` / ``indexed_to_msg_words`` (the prologue) and
  ``verify_impl`` (the generic ladder), in 20 x 13-bit limbs (ops/field.py);
* the host packers, the comb builders and the tile grouping, byte-identical
  to the JAX package's;
* ``KeyTable`` (a committee's keys and combs as device tensors) and the
  bucketed dispatch that sends each chunk through the kernels of
  :mod:`.ed25519_cuda`.

Verification rule (cofactorless, OpenSSL/RFC 8032 decoding): reject if
s >= L or A is a non-canonical/invalid encoding; accept iff
encode([s]B - [k]A) == R_bytes, with k = SHA-512(R || A || M) mod L.  The
byte comparison rejects a non-canonical R exactly like OpenSSL's memcmp.

There is no backend switch: a CUDA tensor goes to the kernel, a CPU tensor
to the plain version.  Entry points place their tensors on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import functools
import hashlib
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import field as F
from . import scalar as SC
from . import sha512 as H

P = F.P
L = (1 << 252) + 27742317777372353535851937790883648493  # group order

_D = (-121665 * pow(121666, P - 2, P)) % P
_D2 = (2 * _D) % P
_SQRT_M1 = pow(2, (P - 1) // 4, P)

# Base point B: y = 4/5, x recovered with even sign.
_BY = (4 * pow(5, P - 2, P)) % P

_WINDOWS = 64  # 4-bit windows covering 256 bits


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and there
    is no card: the port never continues on the CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return device


def device_key(device) -> torch.device:
    """``device`` in the form a per-device cache keys on: ``cuda`` and
    ``cuda:0`` are one card, so a CUDA device always carries its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


# ---------------------------------------------------------------------------
# Host attribution plane: device-side counters, host bookkeeping only.

_attr_metrics = None
_attr_listener_installed = False


def _on_build_event(event: str, name: str, seconds: float) -> None:
    m = _attr_metrics
    if m is None:
        return
    if event == "cache_hit":
        m.mysticeti_cuda_build_cache_hits_total.inc()
    elif event == "cache_miss":
        m.mysticeti_cuda_build_cache_misses_total.inc()
    elif event == "build":
        m.mysticeti_cuda_builds_total.inc()
        m.mysticeti_cuda_build_seconds_total.inc(max(0.0, seconds))


def install_device_attribution(metrics) -> bool:
    """Wire the kernels' build events and the transfer byte counters into
    ``metrics`` (a ``metrics.Metrics``); re-calling swaps the target
    registry, ``None`` turns counting off.

    The JAX package counts compile events and its persistent compile
    cache's hits and misses (``mysticeti_jax_compiles_total``,
    ``mysticeti_jax_compile_seconds_total``, ``mysticeti_jax_cache_hits_total``,
    ``mysticeti_jax_cache_misses_total``).  The port compiles nothing at run
    time but the nvcc build of ``ops/cuda_build.py``, so those become:
    ``mysticeti_cuda_build_cache_hits_total`` (a kernel library already on
    disk when it is first needed), ``mysticeti_cuda_build_cache_misses_total``
    (one that must be built), ``mysticeti_cuda_builds_total`` (nvcc runs that
    succeeded) and ``mysticeti_cuda_build_seconds_total`` (their seconds,
    each from the start of its parallel build).  Transfers go to
    ``mysticeti_device_transfer_bytes_total`` (``_note_transfer``).
    Attribution never changes a verdict, and a build failure still raises
    ``CudaBuildError``.  Returns True (the listener is in place)."""
    global _attr_metrics, _attr_listener_installed
    _attr_metrics = metrics
    if not _attr_listener_installed:
        from . import cuda_build

        cuda_build.add_listener(_on_build_event)
        _attr_listener_installed = True
    return True


def _note_transfer(direction: str, nbytes: int) -> None:
    """Count host<->device bytes at the dispatch and fetch seams
    (``to_device``: the padded packed arrays, key tables and combs as
    uploaded; ``from_device``: the verdicts and totals as fetched).  Counted
    whatever the device, so a CPU run reads the bytes a card would move."""
    m = _attr_metrics
    if m is not None and nbytes > 0:
        m.mysticeti_device_transfer_bytes_total.labels(direction).inc(nbytes)


def _recover_x(y: int, sign: int) -> Optional[int]:
    x2 = (y * y - 1) * pow(_D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * _SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
assert _BX is not None

# ---------------------------------------------------------------------------
# Points: 4-tuples of (B, 20) limb tensors (X, Y, Z, T), x=X/Z, y=Y/Z, T=XY/Z.

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _identity_like(ref: torch.Tensor) -> Point:
    zero = torch.zeros_like(ref)
    one = zero.clone()
    one[..., 0] = 1
    return (zero, one, one, zero)


def point_add(p: Point, q: Point) -> Point:
    """Unified addition, add-2008-hwcd-3 for a=-1."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = F.mul(F.sub(y1, x1), F.sub(y2, x2))
    b = F.mul(F.add(y1, x1), F.add(y2, x2))
    c = F.mul(F.mul(t1, F.constant(_D2, t1)), t2)
    d = F.mul(F.add(z1, z1), z2)
    e, f, g, h = F.sub(b, a), F.sub(d, c), F.add(d, c), F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_madd(p: Point, q3) -> Point:
    """Mixed addition with a Niels-form point q3 = (y-x, y+x, 2d*xy), Z=1
    (madd-2008-hwcd)."""
    x1, y1, z1, t1 = p
    q_ymx, q_ypx, q_t2d = q3
    a = F.mul(F.sub(y1, x1), q_ymx)
    b = F.mul(F.add(y1, x1), q_ypx)
    c = F.mul(t1, q_t2d)
    d = F.add(z1, z1)
    e, f, g, h = F.sub(b, a), F.sub(d, c), F.add(d, c), F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_double(p: Point) -> Point:
    """dbl-2008-hwcd for a=-1."""
    x1, y1, z1, _ = p
    a = F.square(x1)
    b = F.square(y1)
    zz = F.square(z1)
    c = F.add(zz, zz)
    h = F.add(a, b)
    e = F.sub(h, F.square(F.add(x1, y1)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_neg(p: Point) -> Point:
    x, y, z, t = p
    return (F.neg(x), y, z, F.neg(t))


def decompress(y_limbs: torch.Tensor, sign: torch.Tensor) -> Tuple[Point, torch.Tensor]:
    """RFC 8032 point decompression (sqrt via the 2^252-3 chain).

    ``y_limbs``: (B, 20); ``sign``: (B,) 0/1 x-parity bit.  Returns
    (point, ok mask)."""
    one = F.constant(1, y_limbs)
    yy = F.square(y_limbs)
    u = F.sub(yy, one)
    v = F.add(F.mul(F.constant(_D, y_limbs), yy), one)
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    x = F.mul(F.mul(u, v3), F.pow22523(F.mul(u, v7)))
    vxx = F.mul(v, F.square(x))
    ok_direct = F.eq_canonical(vxx, u)
    ok_flipped = F.eq_canonical(vxx, F.neg(u))
    x = torch.where(ok_direct[..., None], x, F.mul(x, F.constant(_SQRT_M1, x)))
    ok = ok_direct | ok_flipped
    x_is_zero = F.is_zero(x)
    ok = ok & ~(x_is_zero & (sign == 1))
    flip = (F.parity(x) != sign) & ~x_is_zero
    x = torch.where(flip[..., None], F.neg(x), x)
    point = (x, y_limbs, torch.broadcast_to(one, y_limbs.shape), F.mul(x, y_limbs))
    return point, ok


def _gather_comb(entry: torch.Tensor, idx: torch.Tensor):
    """entry (3, 20, 16) Niels slice of a comb, idx (B,) -> (ymx, ypx, t2d)."""
    sel = entry[..., idx.long()]  # (3, 20, B)
    return tuple(sel[c].T for c in range(3))


def _gather_table(tab: Sequence[Point], idx: torch.Tensor) -> Point:
    """Per-lane select from a 16-entry list of points; idx (B,)."""
    stacked = torch.stack([torch.stack(p, dim=1) for p in tab], dim=1)  # (B,16,4,20)
    sel = stacked[torch.arange(idx.shape[0], device=idx.device), idx.long()]
    return tuple(sel[:, c] for c in range(4))


def _matches_r(res: Point, r_y: torch.Tensor, r_sign: torch.Tensor) -> torch.Tensor:
    """encode(res) == R exactly: canonical affine y against the RAW R limbs
    (a non-canonical R never matches) and x's parity against the sign bit."""
    x, y, z, _ = res
    zinv = F.invert(z)
    x_aff = F.mul(x, zinv)
    y_aff = F.mul(y, zinv)
    return torch.all(F.canonical(y_aff) == r_y, dim=-1) & (F.parity(x_aff) == r_sign)


def verify_impl(
    a_y: torch.Tensor,  # (B, 20) public key y limbs
    a_sign: torch.Tensor,  # (B,)
    r_y: torch.Tensor,  # (B, 20) signature R y limbs (raw, unvalidated)
    r_sign: torch.Tensor,  # (B,)
    s_windows: torch.Tensor,  # (B, 64) 4-bit windows of s, LSB window first
    k_windows: torch.Tensor,  # (B, 64) 4-bit windows of k, LSB window first
    host_ok: torch.Tensor,  # (B,) bool
) -> torch.Tensor:
    """The plain version of the generic verify kernel; returns (B,) bool.

    [k](-A) by a 4-bit windowed ladder over a 16-entry per-lane table, [s]B
    by 64 Niels mixed adds from the fixed-base comb (no doublings).  Only
    lanes with host_ok set are computed (the rest are False either way)."""
    out = torch.zeros_like(host_ok)
    live = torch.nonzero(host_ok).flatten()
    if live.numel() == 0:
        return out
    a_y, a_sign, r_y, r_sign, s_windows, k_windows = (
        t[live] for t in (a_y, a_sign, r_y, r_sign, s_windows, k_windows)
    )
    neg_a, decompress_ok = decompress(a_y, a_sign)
    neg_a = point_neg(neg_a)
    identity = _identity_like(a_y)
    tab = [identity, neg_a]
    for _ in range(2, 16):
        tab.append(point_add(tab[-1], neg_a))
    comb = base_comb(a_y.device)
    acc_a, acc_b = identity, identity
    for i in range(_WINDOWS):
        for _ in range(4):
            acc_a = point_double(acc_a)
        acc_a = point_add(acc_a, _gather_table(tab, k_windows[:, 63 - i]))
        acc_b = point_madd(acc_b, _gather_comb(comb[i], s_windows[:, i]))
    out[live] = _matches_r(point_add(acc_a, acc_b), r_y, r_sign) & decompress_ok
    return out


# ---------------------------------------------------------------------------
# The prologue: raw words in, the seven verify inputs out.


def _parse_point_words(le_words: torch.Tensor):
    """(B, 8) LE words of a 32-byte point encoding -> (y limbs, sign,
    is_canonical)."""
    sign = (le_words[..., 7] >> 31).to(torch.int32)
    masked = le_words.clone()
    masked[..., 7] &= 0x7FFFFFFF
    y_limbs = SC.words_to_limbs(masked, F.NLIMBS)
    return y_limbs, sign, SC.lt_P(y_limbs)


def prepare_fused(
    msg_words: torch.Tensor,  # (B, 24) big-endian words of R || A || M
    s_words: torch.Tensor,  # (B, 8) little-endian words of s
    host_ok: torch.Tensor,  # (B,) bool
):
    """The plain version of the prologue kernel: returns a_y, a_sign, r_y,
    r_sign, s_windows, k_windows, ok (the seven verify inputs).

    Word tensors hold uint32 bits in int32 (or values in int64)."""
    dig = H.sha512_96(msg_words)
    k = SC.mod_L(SC.words_to_limbs(SC.digest_words_to_le(dig), 40))
    k_windows = SC.windows4(k)
    r_y, r_sign, _ = _parse_point_words(SC.bswap32(msg_words[..., :8]))
    a_y, a_sign, a_canonical = _parse_point_words(SC.bswap32(msg_words[..., 8:16]))
    s_limbs = SC.words_to_limbs(s_words, F.NLIMBS)
    s_ok = SC.lt_L(s_limbs)
    s_windows = SC.windows4(s_limbs)
    ok = host_ok & a_canonical & s_ok
    return a_y, a_sign, r_y, r_sign, s_windows, k_windows, ok


def verify_fused_impl(msg_words: torch.Tensor, s_words: torch.Tensor,
                      host_ok: torch.Tensor) -> torch.Tensor:
    """Batched fused verification, (B,) bool, from the three ``pack_bytes``
    arrays as tensors on one device: (B, 24) big-endian R||A||M words, (B,
    8) little-endian s words (uint32 bits, in int32 or int64) and the (B,)
    ok mask.  On a card the prologue and generic kernels; on the CPU their
    plain versions."""
    from . import ed25519_cuda as K

    blob = torch.cat([msg_words.to(torch.int32), s_words.to(torch.int32),
                      host_ok.to(torch.int32)[:, None]], dim=1).contiguous()
    return K.verify_generic(*K.prologue(blob))


def indexed_to_msg_words(blob: torch.Tensor, table: torch.Tensor):
    """Rebuild the prologue inputs from an indexed (B, 26) blob + (K, 8) key
    table: gather the A words by index and splice them between R and M."""
    idx = blob[..., 24].to(torch.int32).clamp(0, table.shape[0] - 1)
    msg_words = torch.cat([blob[..., :8], table[idx.long()], blob[..., 8:16]], dim=-1)
    return msg_words, blob[..., 16:24], blob[..., 25] != 0


def raw_to_msg_words(blob: torch.Tensor):
    """Split a raw (B, 33) blob (pack_blob layout) into the prologue inputs."""
    return blob[..., :24], blob[..., 24:32], blob[..., 32] != 0


# ---------------------------------------------------------------------------
# Host packing (numpy; byte-identical to the JAX package's packers)


def _pack_fixed_rows(items: Sequence[bytes], width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, width) uint8 rows + per-row well-formedness; wrong-length rows
    zero-fill (callers mask them via host_ok)."""
    n = len(items)
    ok = np.fromiter((len(x) == width for x in items), bool, count=n)
    if ok.all():
        return np.frombuffer(b"".join(items), np.uint8).reshape(n, width), ok
    arr = np.zeros((n, width), np.uint8)
    for i in range(n):
        if ok[i]:
            arr[i] = np.frombuffer(items[i], np.uint8)
    return arr, ok


def pack_bytes(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(msg_words (n, 24) big-endian uint32, s_words (n, 8) little-endian
    uint32, host_ok (n,) bool) for 32-byte messages."""
    sig_arr, sig_ok = _pack_fixed_rows(signatures, 64)
    pk_arr, pk_ok = _pack_fixed_rows(public_keys, 32)
    msg_arr, msg_ok = _pack_fixed_rows(messages, 32)
    host_ok = sig_ok & pk_ok & msg_ok
    blob = np.ascontiguousarray(np.concatenate([sig_arr[:, :32], pk_arr, msg_arr], axis=1))
    msg_words = blob.view(">u4").astype(np.uint32)
    s_words = np.ascontiguousarray(sig_arr[:, 32:]).view("<u4").astype(np.uint32)
    return msg_words, s_words, host_ok


def pack_blob(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> np.ndarray:
    """ONE (n, 33) uint32 array: columns 0-23 the big-endian R||A||M words,
    24-31 the little-endian s words, 32 the host_ok flag."""
    msg_words, s_words, host_ok = pack_bytes(public_keys, messages, signatures)
    return np.concatenate([msg_words, s_words, host_ok[:, None].astype(np.uint32)], axis=1)


def pack_flat(grouped: np.ndarray) -> np.ndarray:
    """The flat keyed upload of a GROUPED indexed blob (group_blob_for_tiles
    output, B a multiple of 32): its B x 24 R/M/s words, then the host_ok
    column packed to B/32 words in little bit order.  The key column is
    dropped: every lane of a tile has the tile's key."""
    okmask = np.packbits(grouped[:, 25].astype(bool), bitorder="little").view(np.uint32)
    return np.concatenate([grouped[:, :24].reshape(-1), okmask])


def pk_table_words(public_keys: Sequence[bytes]) -> np.ndarray:
    """(K, 8) uint32 big-endian words of the raw 32-byte A encodings."""
    arr = np.frombuffer(b"".join(public_keys), np.uint8).reshape(len(public_keys), 32)
    return np.ascontiguousarray(arr).view(">u4").astype(np.uint32)


def pack_blob_indexed(
    indices: np.ndarray,
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    host_ok: Optional[np.ndarray] = None,
    num_keys: Optional[int] = None,
) -> np.ndarray:
    """ONE (n, 26) uint32 array: columns 0-7 big-endian R words, 8-15
    big-endian M words, 16-23 little-endian s words, 24 the key index, 25
    the host_ok flag.  Out-of-range indices (including the -1 "unknown key"
    sentinel) are masked host_ok=False."""
    n = len(signatures)
    idx = np.asarray(indices, np.int64)
    ok = np.ones(n, bool) if host_ok is None else np.asarray(host_ok, bool).copy()
    ok &= idx >= 0
    if num_keys is not None:
        ok &= idx < num_keys
    sig_arr, sig_ok = _pack_fixed_rows(signatures, 64)
    msg_arr, msg_ok = _pack_fixed_rows(messages, 32)
    ok &= sig_ok & msg_ok
    rm = np.ascontiguousarray(np.concatenate([sig_arr[:, :32], msg_arr], axis=1))
    rm_words = rm.view(">u4").astype(np.uint32)
    s_words = np.ascontiguousarray(sig_arr[:, 32:]).view("<u4").astype(np.uint32)
    return np.concatenate(
        [
            rm_words,
            s_words,
            np.clip(idx, 0, None).astype(np.uint32)[:, None],
            ok[:, None].astype(np.uint32),
        ],
        axis=1,
    )


def _windows_lsb_first(x: int) -> np.ndarray:
    return np.array([(x >> (4 * w)) & 15 for w in range(_WINDOWS)], dtype=np.int32)


def _ylimbs_and_sign(data32: bytes) -> Tuple[np.ndarray, int, int]:
    """Parse a 32-byte point encoding: (y limbs, sign bit, y-as-int)."""
    enc = int.from_bytes(data32, "little")
    y = enc & ((1 << 255) - 1)
    return F.int_to_limbs(y), enc >> 255, y


def pack_batch(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> Tuple[np.ndarray, ...]:
    """Host-side preparation for messages of any length: k = SHA-512(R||A||M)
    mod L per item on the host, the cheap integer checks, and the seven
    arrays the generic verify consumes."""
    n = len(signatures)
    a_y = np.zeros((n, F.NLIMBS), np.int32)
    a_sign = np.zeros(n, np.int32)
    r_y = np.zeros((n, F.NLIMBS), np.int32)
    r_sign = np.zeros(n, np.int32)
    s_bits = np.zeros((n, _WINDOWS), np.int32)
    k_bits = np.zeros((n, _WINDOWS), np.int32)
    host_ok = np.zeros(n, bool)
    for i, (pk, msg, sig) in enumerate(zip(public_keys, messages, signatures)):
        if len(pk) != 32 or len(sig) != 64:
            continue
        r_bytes, s_bytes = sig[:32], sig[32:]
        s = int.from_bytes(s_bytes, "little")
        if s >= L:
            continue  # non-canonical s: reject (RFC 8032 / OpenSSL)
        limbs, sign, y = _ylimbs_and_sign(pk)
        if y >= P:
            continue  # non-canonical A encoding
        a_y[i], a_sign[i] = limbs, sign
        r_limbs, rs, ry = _ylimbs_and_sign(r_bytes)
        if ry >= P:
            continue  # non-canonical R never matches memcmp semantics
        r_y[i], r_sign[i] = r_limbs, rs
        k = int.from_bytes(hashlib.sha512(r_bytes + pk + msg).digest(), "little") % L
        s_bits[i] = _windows_lsb_first(s)
        k_bits[i] = _windows_lsb_first(k)
        host_ok[i] = True
    return a_y, a_sign, r_y, r_sign, s_bits, k_bits, host_ok


# ---------------------------------------------------------------------------
# Combs: the fixed-base comb and the per-key negated combs (python ints)


def _affine_add(p, q):
    """Host-side python-int Edwards addition (table generation only)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    den1 = pow(1 + _D * x1 * x2 * y1 * y2, P - 2, P)
    den2 = pow(1 - _D * x1 * x2 * y1 * y2, P - 2, P)
    return ((x1 * y2 + x2 * y1) * den1 % P, (y1 * y2 + x1 * x2) * den2 % P)


def _build_base_comb() -> np.ndarray:
    """(64, 16, 4, 20) int32: extended-coordinate entries of v*16^w*B."""
    table = np.zeros((_WINDOWS, 16, 4, F.NLIMBS), np.int32)
    step = (_BX, _BY)  # 16^w * B
    for w in range(_WINDOWS):
        entry = None  # v * step
        for v in range(16):
            x, y = (0, 1) if entry is None else entry
            table[w, v, 0] = F.int_to_limbs(x)
            table[w, v, 1] = F.int_to_limbs(y)
            table[w, v, 2] = F.int_to_limbs(1)
            table[w, v, 3] = F.int_to_limbs(x * y % P)
            entry = _affine_add(entry, step)
        for _ in range(4):
            step = _affine_add(step, step)
    return table


def _build_niels_comb() -> np.ndarray:
    """(64, 3, 20, 16): the fixed-base comb in Niels form (y-x, y+x,
    2d*xy mod p), one 16-entry table per 4-bit window of s."""
    raw = _build_base_comb()
    out = np.zeros((_WINDOWS, 3, F.NLIMBS, 16), np.int32)
    for w in range(_WINDOWS):
        for v in range(16):
            x = F.limbs_to_int(raw[w, v, 0])
            y = F.limbs_to_int(raw[w, v, 1])
            out[w, 0, :, v] = F.int_to_limbs((y - x) % P)
            out[w, 1, :, v] = F.int_to_limbs((y + x) % P)
            out[w, 2, :, v] = F.int_to_limbs(2 * _D * x * y % P)
    return out


def comb51_from13(comb13: np.ndarray) -> np.ndarray:
    """(..., 16, 16) int64 (uint64 bits): Niels combs ``comb13`` (..., 3, 20,
    16) in 5 x 51-bit limbs, one 128-byte line per entry: ymx[5] ypx[5]
    t2d[5] and a zero pad limb.  An exact conversion of values below 2^255
    in 13-bit limbs (every comb entry is canonical, below p); the kernels
    read this layout with fe51.cuh's gn_load51."""
    limbs = np.asarray(comb13, np.int64)
    lines = np.zeros(limbs.shape[:-3] + (16, 16), np.int64)
    mask = (1 << 51) - 1
    for c in range(3):
        for i in range(F.NLIMBS):
            x = limbs[..., c, i, :]  # (..., 16): limb i of every entry
            q, sh = divmod(13 * i, 51)
            lines[..., 5 * c + q] |= (x << sh) & mask
            if sh + 13 > 51 and q + 1 < 5:
                lines[..., 5 * c + q + 1] |= x >> (51 - sh)
    return lines


@functools.lru_cache(maxsize=None)
def _niels_comb_host() -> np.ndarray:
    return _build_niels_comb()


@functools.lru_cache(maxsize=None)
def _comb51_host() -> np.ndarray:
    return comb51_from13(_niels_comb_host())


_base_combs: dict = {}  # (host comb function, torch.device) -> the comb tensor there
_base_comb_lock = threading.Lock()


def _comb_on(host, device) -> torch.Tensor:
    """The comb ``host()`` returns, on ``device``: built once per process,
    uploaded once per device."""
    device = device_key(device)
    with _base_comb_lock:
        t = _base_combs.get((host, device))
        if t is None:
            arr = host()
            t = _base_combs[(host, device)] = torch.as_tensor(arr, device=device)
            _note_transfer("to_device", arr.nbytes)
        return t


def base_comb(device) -> torch.Tensor:
    """The (64, 3, 20, 16) int32 Niels base comb on ``device``."""
    return _comb_on(_niels_comb_host, device)


def base_comb51(device) -> torch.Tensor:
    """The (64, 16, 16) int64 base comb of the verify kernels on ``device``
    (see comb51_from13)."""
    return _comb_on(_comb51_host, device)


def _ext_add(p, q):
    """Python-int extended addition (add-2008-hwcd-3, a=-1)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * _D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _ext_double(p):
    """Python-int dbl-2008-hwcd (a=-1)."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1)
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _decode_point(pk32: bytes) -> Optional[Tuple[int, int]]:
    """RFC 8032 decode to affine (x, y); None when non-canonical or not on
    the curve."""
    enc = int.from_bytes(pk32, "little")
    sign, y = enc >> 255, enc & ((1 << 255) - 1)
    if y >= P:
        return None
    x = _recover_x(y, sign)
    if x is None:
        return None
    return x, y


def build_neg_key_combs(public_keys: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """(K, 64, 3, 20, 16) int32 Niels-form combs of -(v * 16^w * A_j), plus
    a (K,) validity mask.  An invalid key gets identity-only entries and
    valid=False; the keyed dispatch force-rejects its lanes.  All 960 affine
    conversions per key share one modular inversion."""
    K = len(public_keys)
    out = np.zeros((K, _WINDOWS, 3, F.NLIMBS, 16), np.int32)
    valid = np.zeros(K, bool)
    one = F.int_to_limbs(1)
    # v=0 entries are the identity's Niels form (1, 1, 0) for every window.
    out[:, :, 0, :, 0] = one
    out[:, :, 1, :, 0] = one
    for j, pk in enumerate(public_keys):
        dec = _decode_point(bytes(pk))
        if dec is None:
            continue
        valid[j] = True
        x, y = dec
        step = (x, y, 1, x * y % P)  # 16^w * A in extended coords
        entries = []  # (w, v, point)
        for w in range(_WINDOWS):
            entry = step
            for v in range(1, 16):
                entries.append((w, v, entry))
                entry = _ext_add(entry, step)
            for _ in range(4):
                step = _ext_double(step)
        prefix = [1]  # Montgomery batch inversion of every Z
        for _, _, (_, _, z, _) in entries:
            prefix.append(prefix[-1] * z % P)
        inv = pow(prefix[-1], P - 2, P)
        for i in range(len(entries) - 1, -1, -1):
            w, v, (ex, ey, ez, _) = entries[i]
            zi = prefix[i] * inv % P
            inv = inv * ez % P
            xa, ya = ex * zi % P, ey * zi % P
            # Niels form of the NEGATED point (-xa, ya):
            out[j, w, 0, :, v] = F.int_to_limbs((ya + xa) % P)
            out[j, w, 1, :, v] = F.int_to_limbs((ya - xa) % P)
            out[j, w, 2, :, v] = F.int_to_limbs((P - _D2 * xa % P * ya % P) % P)
    return out, valid


def group_blob_for_tiles(
    blob: np.ndarray, num_keys: int, tile: int, bucket: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Rearrange an indexed blob so every ``tile``-lane tile holds one key.

    Returns (grouped (bucket, C), tile_keys (bucket//tile,) int32, positions
    (n,) int32 — the row of each original item in the grouped layout), or
    None when the per-key padding cannot fit the bucket.  Padded lanes are
    zero rows (host_ok=0)."""
    n = blob.shape[0]
    ntiles = bucket // tile
    idx = blob[:, 24].astype(np.int64)
    ok = blob[:, 25] != 0
    # Rejected/unknown lanes carry no constraint; park them under key 0.
    key = np.where(ok, np.clip(idx, 0, num_keys - 1), 0)
    counts = np.bincount(key, minlength=num_keys)
    tiles_per_key = -(-counts // tile)
    if int(tiles_per_key.sum()) > ntiles:
        return None
    tile_starts = np.zeros(num_keys, np.int64)
    np.cumsum(tiles_per_key[:-1] * tile, out=tile_starts[1:])
    order = np.argsort(key, kind="stable")
    csum = np.zeros(num_keys, np.int64)
    np.cumsum(counts[:-1], out=csum[1:])
    rank_sorted = np.arange(n, dtype=np.int64) - np.repeat(csum, counts)
    positions = np.empty(n, np.int64)
    positions[order] = tile_starts[key[order]] + rank_sorted
    grouped = np.zeros((bucket, blob.shape[1]), blob.dtype)
    grouped[positions] = blob
    tile_keys = np.zeros(ntiles, np.int32)
    tile_keys[: int(tiles_per_key.sum())] = np.repeat(np.arange(num_keys), tiles_per_key)
    return grouped, tile_keys, positions.astype(np.int32)


def to_device_words(arr: np.ndarray, device) -> torch.Tensor:
    """A uint32 host array as an int32 tensor with the same bits on
    ``device`` (torch has no general uint32 arithmetic); its bytes count as
    an upload (``_note_transfer``)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    _note_transfer("to_device", arr.nbytes)
    return torch.from_numpy(arr).to(device)


class KeyTable:
    """A committee's keys resident on a device: upload once, verify by index.

    ``words`` is the (K, 8) key table the prologue gathers from, on the
    table's device; ``words_on`` gives a copy on another device (a sharded
    dispatch needs one on every card).  ``indices_for`` maps raw pk bytes to
    rows; unknown keys map to -1.
    ``neg_combs`` lazily builds the per-key negated combs (see
    build_neg_key_combs) in 13-bit limbs, the JAX package's layout that
    ``from_arrays`` carries across; ``neg_combs51`` converts them once to the
    51-bit lines the keyed kernel reads."""

    def __init__(self, public_keys: Sequence[bytes], device=None) -> None:
        if not public_keys:
            raise ValueError("empty key table")
        if any(len(pk) != 32 for pk in public_keys):
            raise ValueError("key table entries must be 32-byte encodings")
        self.device = resolve_device(device)
        self.words = to_device_words(pk_table_words(public_keys), self.device)
        self._words_on = {device_key(self.device): self.words}
        self._words_lock = threading.Lock()
        self._index = {bytes(pk): i for i, pk in enumerate(public_keys)}
        self._keys = [bytes(pk) for pk in public_keys]
        self._neg_combs: Optional[Tuple[torch.Tensor, np.ndarray]] = None
        self._neg_combs51: Optional[torch.Tensor] = None
        self._combs_lock = threading.RLock()  # the build takes seconds: once

    @classmethod
    def from_arrays(cls, words: np.ndarray, combs: np.ndarray, valid: np.ndarray,
                    device=None) -> "KeyTable":
        """A table carried across from the JAX package's arrays, as numpy:
        ``pk_table_words`` words (K, 8), ``build_neg_key_combs`` combs
        (K, 64, 3, 20, 16) and its (K,) valid mask."""
        words = np.asarray(words, np.uint32)
        keys = [row.astype(">u4").tobytes() for row in words]
        combs = np.asarray(combs, np.int32)
        if combs.shape != (len(keys), _WINDOWS, 3, F.NLIMBS, 16):
            raise ValueError(f"comb array of shape {combs.shape} for {len(keys)} keys")
        table = cls(keys, device=device)
        table._neg_combs = (
            torch.as_tensor(combs, device=table.device),
            np.asarray(valid, bool).copy(),
        )
        _note_transfer("to_device", combs.nbytes)
        return table

    def __len__(self) -> int:
        return self.words.shape[0]

    def words_on(self, device) -> torch.Tensor:
        """The (K, 8) key table on ``device``, uploaded once per device."""
        device = device_key(device)
        with self._words_lock:
            words = self._words_on.get(device)
            if words is None:
                words = self._words_on[device] = self.words.to(device)
            return words

    def indices_for(self, public_keys: Sequence[bytes]) -> np.ndarray:
        return np.fromiter(
            (self._index.get(bytes(pk), -1) for pk in public_keys),
            np.int64,
            count=len(public_keys),
        )

    def neg_combs(self) -> Tuple[torch.Tensor, np.ndarray]:
        """(device (K, 64, 3, 20, 16) comb tensor, (K,) host valid mask)."""
        with self._combs_lock:
            if self._neg_combs is None:
                arr, valid = build_neg_key_combs(self._keys)
                self._neg_combs = (torch.as_tensor(arr, device=self.device), valid)
                _note_transfer("to_device", arr.nbytes)
            return self._neg_combs

    def neg_combs51(self) -> torch.Tensor:
        """The device (K, 64, 16, 16) int64 combs of ``neg_combs`` in 51-bit
        lines (comb51_from13), built on first use."""
        with self._combs_lock:
            if self._neg_combs51 is None:
                comb13 = self.neg_combs()[0].cpu().numpy()
                lines = comb51_from13(comb13)
                self._neg_combs51 = torch.as_tensor(lines, device=self.device)
                _note_transfer("to_device", lines.nbytes)
            return self._neg_combs51


# ---------------------------------------------------------------------------
# Bucketed dispatch

# Fixed device batch shapes: every dispatch is padded up to one of these
# (stragglers ride as padding lanes with host_ok=False).
BUCKETS = (256, 1024, 4096, 16384)


def iter_buckets(n: int):
    """Yield (start, count, bucket) chunk descriptors covering n items.

    Rounding up to the next bucket is taken only when the padding stays
    under 25% of that bucket; otherwise the largest bucket that fits is
    dispatched full and the remainder recurses."""
    start = 0
    while start < n:
        rem = n - start
        s = next((c for c in BUCKETS if c >= rem), None)
        g = next((c for c in reversed(BUCKETS) if c <= rem), None)
        if s is not None and (g is None or s - rem <= s // 4):
            yield start, rem, s
            return
        b = g if g is not None else BUCKETS[0]
        count = min(b, rem)
        yield start, count, b
        start += count


def _pad_to(x: np.ndarray, size: int) -> np.ndarray:
    if x.shape[0] == size:
        return np.ascontiguousarray(x)
    widths = [(0, size - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, widths)


class VerifyDispatch:
    """Future-like handle over one batch's in-flight bucket dispatches.

    The kernels were queued on the device's stream when this was built;
    ``result()`` pays ONE copy back to the host per device (``fetch_handles``).
    ``patches`` carries straggler sub-dispatches (unknown-key items through
    the generic kernel): ``(row indices, VerifyDispatch)`` pairs whose
    results overwrite those rows."""

    __slots__ = ("_entries", "_patches")

    def __init__(self, entries, patches=()) -> None:
        self._entries = list(entries)
        self._patches = tuple(patches)

    def result(self) -> np.ndarray:
        out = fetch_handles(self._entries)
        for rows, handle in self._patches:
            out[rows] = handle.result()
        return out


def _to_host(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """Concatenate 1-D tensors that may lie on several devices, with one
    copy to the host per device."""
    by_device: dict = {}
    for t in parts:
        by_device.setdefault(t.device, []).append(t)
    host = {}
    for device, ts in by_device.items():
        whole = torch.cat(ts).cpu().numpy()
        _note_transfer("from_device", whole.nbytes)
        host[device] = iter(np.split(whole, np.cumsum([t.shape[0] for t in ts])[:-1]))
    return np.concatenate([next(host[t.device]) for t in parts])


def fetch_handles(handles) -> np.ndarray:
    """Force ``(count, result)`` chunk entries with one copy to the host per
    device and drop the padding.  A result is a bool tensor, or the list of
    a sharded chunk's per-shard tensors in batch order."""
    if not handles:
        return np.zeros(0, bool)
    parts = [p for _, h in handles for p in (h if isinstance(h, list) else [h])]
    flat = _to_host(parts)
    out = np.empty(sum(count for count, _ in handles), bool)
    src = dst = 0
    for count, h in handles:
        width = sum(t.shape[0] for t in h) if isinstance(h, list) else h.shape[0]
        out[dst : dst + count] = flat[src : src + count]
        src += width
        dst += count
    return out


def dispatch_blob_chunks(blob: np.ndarray, device) -> list:
    """Slice a raw (n, 33) blob into bucket chunks, pad each, and queue the
    prologue and generic kernels for all of them.  Returns [(count, out)]."""
    from . import ed25519_cuda as K

    out = []
    for start, count, b in iter_buckets(blob.shape[0]):
        padded = to_device_words(_pad_to(blob[start : start + count], b), device)
        out.append((count, K.verify_generic(*K.prologue(padded))))
    return out


def dispatch_batch(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    device=None,
) -> VerifyDispatch:
    """Non-blocking batched dispatch for an unknown signer set: pack on the
    host, queue every bucket chunk; the handle fetches on demand.  32-byte
    messages take the prologue kernel; other lengths hash on the host."""
    device = resolve_device(device)
    if not signatures:
        return VerifyDispatch([])
    if all(len(m) == 32 for m in messages):
        return VerifyDispatch(dispatch_blob_chunks(pack_blob(public_keys, messages, signatures), device))
    from . import ed25519_cuda as K

    arrays = pack_batch(public_keys, messages, signatures)
    handles = []
    for start, count, b in iter_buckets(len(signatures)):
        padded = [_pad_to(x[start : start + count], b) for x in arrays]
        _note_transfer("to_device", sum(x.nbytes for x in padded))
        padded = [torch.as_tensor(x, device=device) for x in padded]
        handles.append((count, K.verify_generic(*padded)))
    return VerifyDispatch(handles)


def keyed_chunk_on_device(padded: torch.Tensor, table: KeyTable) -> torch.Tensor:
    """The device work of one keyed chunk: ``padded`` is an uploaded indexed
    blob (pack_blob_indexed layout, a bucket's rows); its key column is the
    lanes' keys, in natural order.  Lanes under an off-curve committee key
    must arrive with ok cleared (``dispatch_indexed_chunks`` clears them)."""
    from . import ed25519_cuda as K

    _a_y, _a_sign, r_y, r_sign, s_w, k_w, ok = K.prologue(padded, table.words)
    keys = padded[:, 24].contiguous()
    return K.verify_keyed_lanes(keys, table.neg_combs51(), r_y, r_sign, s_w, k_w, ok)


def dispatch_indexed_chunks(blob: np.ndarray, table: KeyTable) -> list:
    """Bucket-shaped dispatch of an indexed blob (pack_blob_indexed layout);
    returns fetch_handles entries.  Every chunk takes the prologue and the
    keyed kernel with one key per lane (the blob's key column, no grouping);
    MYSTICETI_KEYED=0 sends them to the generic kernel instead."""
    from . import ed25519_cuda as K

    keyed = os.environ.get("MYSTICETI_KEYED") != "0"
    valid = table.neg_combs()[1] if keyed else None
    handles = []
    for start, count, b in iter_buckets(blob.shape[0]):
        chunk = blob[start : start + count]
        if keyed and not valid.all():
            # Lanes under an off-curve committee key must reject exactly like
            # the generic kernel's decompression failure.
            chunk = chunk.copy()
            chunk[:, 25] &= valid[np.clip(chunk[:, 24].astype(np.int64), 0, len(valid) - 1)]
        padded = to_device_words(_pad_to(chunk, b), table.device)
        if keyed:
            handles.append((count, keyed_chunk_on_device(padded, table)))
        else:
            handles.append((count, K.verify_generic(*K.prologue(padded, table.words))))
    return handles


def dispatch_batch_table(
    table: KeyTable,
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> VerifyDispatch:
    """Non-blocking committee-indexed dispatch on the table's device.  Items
    whose pk is not in the table ride a generic-path patch."""
    if not signatures:
        return VerifyDispatch([])
    if not all(len(m) == 32 for m in messages):
        return dispatch_batch(public_keys, messages, signatures, table.device)
    idx = table.indices_for(public_keys)
    known = idx >= 0
    blob = pack_blob_indexed(idx, messages, signatures, num_keys=len(table))
    handles = dispatch_indexed_chunks(blob, table)
    if known.all():
        return VerifyDispatch(handles)
    stragglers = np.flatnonzero(~known)
    generic = dispatch_batch(
        [public_keys[i] for i in stragglers],
        [messages[i] for i in stragglers],
        [signatures[i] for i in stragglers],
        table.device,
    )
    return VerifyDispatch(handles, [(stragglers, generic)])


def verify_batch(public_keys, messages, signatures, device=None) -> np.ndarray:
    """End-to-end batched verify; one bool per item."""
    return dispatch_batch(public_keys, messages, signatures, device).result()


def verify_batch_table(table: KeyTable, public_keys, messages, signatures) -> np.ndarray:
    """verify_batch against a known signer set."""
    return dispatch_batch_table(table, public_keys, messages, signatures).result()
