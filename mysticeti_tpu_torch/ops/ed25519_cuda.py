"""The CUDA kernels of the verify path, their wrappers and plain versions.

The counterpart of ``mysticeti_tpu.ops.ed25519_pallas``:

==================  =====================================  ==============================
wrapper             CUDA source (csrc/)                    replaces
==================  =====================================  ==============================
``prologue``        prologue.cu                            ops/ed25519.py prepare_fused +
                                                           indexed_to_msg_words (XLA)
``prologue_flat``   prologue.cu                            the XLA steps of
                                                           ed25519_pallas._verify_keyed_flat_jit
``verify_generic``  verify_generic.cu (+ fe51.cuh)         ed25519_pallas._verify_pallas_jit
``verify_keyed``    verify_keyed.cu (+ fe51.cuh)           ed25519_pallas._verify_keyed_pallas_jit
==================  =====================================  ==============================

``verify_keyed`` (the tile form: lanes grouped by key, ``tile`` lanes a
key) is the counterpart of the TPU kernel; ``verify_keyed_lanes`` (one key
per lane, in natural order) runs the same kernel with a tile of one lane,
and is what the committee dispatch launches.  ``verify_keyed_flat``
(``prologue_flat`` + ``verify_keyed``) is the counterpart of
``ed25519_pallas.verify_keyed_flat``.

Every wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for tensors on a CUDA device; there is no fallback from
one to the other.  A launch runs with the tensors' device made current, goes
to that device's current stream, allocates nothing inside the kernel
(outputs come from ``torch.empty`` here), is checked with
``cudaGetLastError`` (a non-zero code raises), and adds one to its kernel's
``launches`` count.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from . import cuda_build
from . import ed25519 as E

# Lanes per key in the tile form (the TPU kernel's tile).
KEYED_TILE = 32

_P, _I = ctypes.c_void_p, ctypes.c_int


class Kernel:
    """One CUDA kernel: its source, what it replaces, its launch count.
    ``source`` names the ``csrc/<source>.cu`` file that defines
    ``<name>_launch`` (default: the kernel's own name)."""

    def __init__(self, name: str, replaces: str, argtypes, source: Optional[str] = None) -> None:
        self.name = name
        self.unit = source or name
        self.source = f"mysticeti_tpu_torch/csrc/{self.unit}.cu"
        self.replaces = replaces
        self.launches = 0
        self._argtypes = argtypes
        self._fn = None
        self._count_lock = threading.Lock()  # collector threads launch concurrently

    def _function(self):
        if self._fn is None:
            fn = getattr(cuda_build.load(self.unit), f"{self.name}_launch")
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, lanes: int, *args) -> None:
        """Launch on ``device``'s current stream with ``device`` made the
        current device (the C launcher uses the calling thread's current
        device); raise if the launch failed.  An empty batch launches
        nothing (a zero-block grid is an error)."""
        if lanes == 0:
            return
        fn = self._function()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        with self._count_lock:
            self.launches += 1

    def reset_counts(self) -> None:
        with self._count_lock:
            self.launches = 0


PROLOGUE = Kernel(
    "prologue", "mysticeti_tpu/ops/ed25519.py:387",
    [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
)
VERIFY_GENERIC = Kernel(
    "verify_generic", "mysticeti_tpu/ops/ed25519_pallas.py:450",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
)
VERIFY_KEYED = Kernel(
    "verify_keyed", "mysticeti_tpu/ops/ed25519_pallas.py:565",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
)
PROLOGUE_FLAT = Kernel(
    "prologue_flat", "mysticeti_tpu/ops/ed25519_pallas.py:606",
    [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    source="prologue",
)
KERNELS = (PROLOGUE, PROLOGUE_FLAT, VERIFY_GENERIC, VERIFY_KEYED)


def build_all() -> None:
    """Compile every kernel source at once (one nvcc per source, in parallel)."""
    cuda_build.build(dict.fromkeys(k.unit for k in KERNELS))


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; raise on a mix or on any
    other device."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, kinds))}")
    kind = next(iter(kinds)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind!r}")
    return kind == "cuda"


def _check(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )


# ---------------------------------------------------------------------------
# Prologue


def _prologue_plain(blob: torch.Tensor, table: Optional[torch.Tensor]):
    if table is None:
        return E.prepare_fused(*E.raw_to_msg_words(blob))
    return E.prepare_fused(*E.indexed_to_msg_words(blob, table))


def _prologue_outputs(n: int, dev: torch.device):
    """Empty (a_y, a_sign, r_y, r_sign, s_w, k_w, ok) for n lanes on dev."""
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.empty((n, 20), **i32), torch.empty(n, **i32), torch.empty((n, 20), **i32),
            torch.empty(n, **i32), torch.empty((n, 64), **i32), torch.empty((n, 64), **i32),
            torch.empty(n, dtype=torch.bool, device=dev))


def prologue(blob: torch.Tensor, table: Optional[torch.Tensor] = None):
    """Wire words -> (a_y, a_sign, r_y, r_sign, s_w, k_w, ok).

    ``blob`` is int32 (uint32 bits): the indexed (B, 26) layout with the
    (K, 8) key ``table``, or the raw (B, 33) layout without one."""
    n = blob.shape[0]
    _check(blob, torch.int32, (n, 33 if table is None else 26), "blob")
    if table is not None:
        _check(table, torch.int32, (table.shape[0], 8), "key table")
    if not _on_cuda(blob, *([] if table is None else [table])):
        return _prologue_plain(blob, table)
    outs = _prologue_outputs(n, blob.device)
    PROLOGUE.launch(
        blob.device, n, blob.data_ptr(), blob.shape[1],
        None if table is None else table.data_ptr(),
        0 if table is None else table.shape[0],
        *(t.data_ptr() for t in outs), n,
    )
    return outs


def _check_lanes(n, r_y, r_sign, s_w, k_w, ok) -> None:
    _check(r_y, torch.int32, (n, 20), "r_y")
    _check(r_sign, torch.int32, (n,), "r_sign")
    _check(s_w, torch.int32, (n, 64), "s_w")
    _check(k_w, torch.int32, (n, 64), "k_w")
    _check(ok, torch.bool, (n,), "ok")


# ---------------------------------------------------------------------------
# Generic verify


def verify_generic(a_y, a_sign, r_y, r_sign, s_w, k_w, ok) -> torch.Tensor:
    """(B,) bool verdicts of the generic ladder (decompress A, [s]B + [k](-A),
    compare with R).  Inputs as ``prologue`` returns them; ``s_w`` and
    ``k_w`` are 4-bit windows (0..15), any such k and s."""
    n = a_y.shape[0]
    _check(a_y, torch.int32, (n, 20), "a_y")
    _check(a_sign, torch.int32, (n,), "a_sign")
    _check_lanes(n, r_y, r_sign, s_w, k_w, ok)
    if not _on_cuda(a_y, a_sign, r_y, r_sign, s_w, k_w, ok):
        return E.verify_impl(a_y, a_sign, r_y, r_sign, s_w, k_w, ok)
    comb = E.base_comb51(a_y.device)
    out = torch.empty(n, dtype=torch.bool, device=a_y.device)
    VERIFY_GENERIC.launch(
        a_y.device, n, comb.data_ptr(), a_y.data_ptr(), a_sign.data_ptr(), r_y.data_ptr(),
        r_sign.data_ptr(), s_w.data_ptr(), k_w.data_ptr(), ok.data_ptr(),
        out.data_ptr(), n,
    )
    return out


def generic_launch_shape():
    """(threads a block, dynamic shared-memory bytes a block) with which the
    generic kernel's launcher launches it (builds the kernel if needed)."""
    fn = cuda_build.load(VERIFY_GENERIC.unit).verify_generic_shape
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = None
    threads, smem = ctypes.c_int(), ctypes.c_int()
    fn(ctypes.byref(threads), ctypes.byref(smem))
    return threads.value, smem.value


# Field (squarings, multiplies) of the formulas in fe51.cuh that every lane
# runs: ge_decompress (without the multiply by sqrt(-1) that about half of
# all keys take), ge_matches (the inversion and the affine x, y).
_DECOMPRESS_OPS = (255, 19)
_MATCH_OPS = (254, 13)


def signed_digits(k_w: np.ndarray) -> np.ndarray:
    """(B, 64) digits in [-8, 8] of the generic kernel's signed recoding of
    the 4-bit windows ``k_w`` (recode_carries / recode_digit); the carry out
    of the top window is dropped."""
    w = np.asarray(k_w, np.int64) & 15
    digits = np.empty_like(w)
    carry = np.zeros(w.shape[0], np.int64)
    for j in range(w.shape[1]):
        t = w[:, j] + carry
        carry = (t > 8).astype(np.int64)
        digits[:, j] = t - 16 * carry
    return digits


def generic_lane_ops(k_w: torch.Tensor, ok: torch.Tensor) -> np.ndarray:
    """(B, 2) field squarings and multiplies each lane of the generic kernel
    does on these inputs (none where ok is clear): decompress A, 8-entry
    table (one cached conversion, then 7 adds of 8 and 7 conversions of 1
    multiply), 64 windows of 4 doublings (4 squarings and 3 multiplies, +1
    for T in the fourth when a non-zero digit or the combine reads it), an add
    of 7 multiplies (+1 in the last window) for each non-zero digit and a
    Niels add of 7; the combine (9) and the compare."""
    nonzero = (signed_digits(k_w.cpu().numpy()) != 0).sum(axis=1)
    sq = _DECOMPRESS_OPS[0] + 64 * 16 + _MATCH_OPS[0]
    mul = _DECOMPRESS_OPS[1] + 1 + 7 * 9 + 64 * (9 + 3 + 7) + 8 * nonzero + 1 + 9 + _MATCH_OPS[1]
    live = ok.cpu().numpy().astype(np.int64)
    return np.stack([sq * live, mul * live], axis=1)


# ---------------------------------------------------------------------------
# Keyed verify


def _limbs13_from51(w5: torch.Tensor) -> torch.Tensor:
    """(B, 5) 51-bit limbs -> (B, 20) int32 13-bit limbs of the same value
    (below 2^255)."""
    limbs = []
    for i in range(20):
        q, sh = divmod(13 * i, 51)
        x = w5[:, q] >> sh
        if sh + 13 > 51 and q + 1 < 5:
            x = x | (w5[:, q + 1] << (51 - sh))
        limbs.append(x & 0x1FFF)
    return torch.stack(limbs, dim=1).to(torch.int32)


def _comb_entries(acomb, key, i: int, v):
    """Niels entries (ymx, ypx, t2d) of comb window ``i`` at entries ``v``
    of the keys ``key``, each (B, 20) limbs; ``acomb`` in either layout."""
    if acomb.dim() == 5:  # 13-bit limbs (K, 64, 3, 20, 16)
        sel = acomb[key, i, :, :, v.long()]  # (B, 3, 20)
        return sel[:, 0], sel[:, 1], sel[:, 2]
    line = acomb[key, i, v.long()]  # (B, 16): ymx[5] ypx[5] t2d[5] pad
    return tuple(_limbs13_from51(line[:, 5 * c : 5 * c + 5]) for c in range(3))


def verify_keyed_plain(keys, acomb, r_y, r_sign, s_w, k_w, ok, tile: int):
    """The plain version of the keyed kernel: 128 Niels mixed adds per lane,
    64 from the base comb and 64 from its key's comb, lane i's key
    ``keys[i // tile]`` (clipped to [0, K)).  ``acomb`` is the 13-bit
    (K, 64, 3, 20, 16) comb or the kernel's 51-bit (K, 64, 16, 16) one.
    Only lanes with ok set are computed."""
    out = torch.zeros_like(ok)
    live = torch.nonzero(ok).flatten()
    if live.numel() == 0:
        return out
    key = keys.long().clamp(0, acomb.shape[0] - 1).repeat_interleave(tile)[live]
    r_y, r_sign, s_w, k_w = (t[live] for t in (r_y, r_sign, s_w, k_w))
    comb = E.base_comb(r_y.device)
    acc = E._identity_like(r_y)
    for i in range(64):
        acc = E.point_madd(acc, E._gather_comb(comb[i], s_w[:, i]))
        acc = E.point_madd(acc, _comb_entries(acomb, key, i, k_w[:, i]))
    out[live] = E._matches_r(acc, r_y, r_sign)
    return out


def keyed_lane_ops(ok: torch.Tensor) -> np.ndarray:
    """(B, 2) field squarings and multiplies each lane of the keyed kernel
    does (none where ok is clear): 128 Niels adds of 7 multiplies and the
    compare."""
    live = ok.cpu().numpy().astype(np.int64)
    return np.stack([_MATCH_OPS[0] * live, (128 * 7 + _MATCH_OPS[1]) * live], axis=1)


def _verify_keyed(keys, acomb, r_y, r_sign, s_w, k_w, ok, tile: int):
    n = r_y.shape[0]
    _check_lanes(n, r_y, r_sign, s_w, k_w, ok)
    if acomb.dim() == 5:
        _check(acomb, torch.int32, (acomb.shape[0], 64, 3, 20, 16), "key combs")
    else:
        _check(acomb, torch.int64, (acomb.shape[0], 64, 16, 16), "key combs")
    if not _on_cuda(keys, acomb, r_y, r_sign, s_w, k_w, ok):
        return verify_keyed_plain(keys, acomb, r_y, r_sign, s_w, k_w, ok, tile)
    if acomb.dim() == 5:
        raise ValueError("the keyed kernel reads 51-bit combs (KeyTable.neg_combs51)")
    comb = E.base_comb51(r_y.device)
    out = torch.empty(n, dtype=torch.bool, device=r_y.device)
    VERIFY_KEYED.launch(
        r_y.device, n, comb.data_ptr(), acomb.data_ptr(), keys.data_ptr(), r_y.data_ptr(),
        r_sign.data_ptr(), s_w.data_ptr(), k_w.data_ptr(), ok.data_ptr(),
        out.data_ptr(), n, tile, acomb.shape[0],
    )
    return out


def verify_keyed(tile_keys, acomb, r_y, r_sign, s_w, k_w, ok, tile: int = KEYED_TILE):
    """(B,) bool verdicts in GROUPED order: lanes [t*tile, (t+1)*tile) are
    verified against key ``tile_keys[t]``'s negated comb ``acomb``
    (``KeyTable.neg_combs51``; the plain version also takes the 13-bit
    ``neg_combs``).  Lanes under an invalid key must arrive with ok cleared."""
    n = r_y.shape[0]
    if tile <= 0 or n % tile != 0:
        raise ValueError(f"batch {n} not a multiple of tile {tile}")
    _check(tile_keys, torch.int32, (n // tile,), "tile_keys")
    return _verify_keyed(tile_keys, acomb, r_y, r_sign, s_w, k_w, ok, tile)


def verify_keyed_lanes(keys, acomb, r_y, r_sign, s_w, k_w, ok):
    """(B,) bool verdicts in natural order: lane i is verified against key
    ``keys[i]`` (int32, clipped to [0, K)); otherwise as ``verify_keyed``."""
    _check(keys, torch.int32, (r_y.shape[0],), "keys")
    return _verify_keyed(keys, acomb, r_y, r_sign, s_w, k_w, ok, 1)


# ---------------------------------------------------------------------------
# Flat keyed upload


def _prologue_flat_plain(flat, table, tile_keys, tile: int):
    """The plain version of ``prologue_flat``: _verify_keyed_flat_jit's
    steps in front of the keyed kernel, on tensors."""
    b = tile_keys.shape[0] * tile
    blob24 = flat[: b * 24].reshape(b, 24)
    okmask = flat[b * 24 :]
    idx = tile_keys.long().repeat_interleave(tile).clamp(0, table.shape[0] - 1)
    msg_words = torch.cat([blob24[:, :8], table[idx], blob24[:, 8:16]], dim=-1)
    lane = torch.arange(b, device=flat.device)
    ok = ((okmask[lane // 32] >> (lane % 32)) & 1) != 0
    return E.prepare_fused(msg_words, blob24[:, 16:24], ok)


def _check_flat(flat, table, tile_keys, tile: int) -> int:
    if tile <= 0:
        raise ValueError(f"tile {tile} must be positive")
    b = tile_keys.shape[0] * tile
    if b % 32 != 0:
        # The ok mask is read as packed 32-lane words; a ragged tail would
        # read another lane's bit.
        raise ValueError(f"batch {b} not a multiple of 32")
    if flat.shape != (b * 24 + b // 32,):
        raise ValueError(f"flat upload of {tuple(flat.shape)} words != {b}*24 + {b}//32")
    _check(flat, torch.int32, (flat.shape[0],), "flat upload")
    _check(table, torch.int32, (table.shape[0], 8), "key table")
    _check(tile_keys, torch.int32, (tile_keys.shape[0],), "tile_keys")
    return b


def prologue_flat(flat, table, tile_keys, tile: int = KEYED_TILE):
    """Flat keyed upload -> (a_y, a_sign, r_y, r_sign, s_w, k_w, ok), in
    grouped order.

    ``flat`` is int32 (uint32 bits): B rows of 24 words (R[8] M[8] s[8]) and
    then B/32 words of the ok bits, lane i at bit i % 32 of word i // 32.
    Lane i's key is ``tile_keys[i // tile]``, its A words ``table[key]``."""
    n = _check_flat(flat, table, tile_keys, tile)
    if not _on_cuda(flat, table, tile_keys):
        return _prologue_flat_plain(flat, table, tile_keys, tile)
    outs = _prologue_outputs(n, flat.device)
    PROLOGUE_FLAT.launch(
        flat.device, n, flat.data_ptr(), table.data_ptr(), table.shape[0],
        tile_keys.data_ptr(), tile, *(t.data_ptr() for t in outs), n,
    )
    return outs


def verify_keyed_flat(flat, table_words, acomb, tile_keys, tile: int = KEYED_TILE):
    """Keyed-tile verification of a grouped flat upload (see
    ``prologue_flat``; ``acomb`` as ``verify_keyed`` takes it); returns (B,)
    bool in GROUPED order (callers un-permute on the host with the
    grouping's positions)."""
    _a_y, _a_sign, r_y, r_sign, s_w, k_w, ok = prologue_flat(flat, table_words, tile_keys, tile)
    return verify_keyed(tile_keys, acomb, r_y, r_sign, s_w, k_w, ok, tile)
