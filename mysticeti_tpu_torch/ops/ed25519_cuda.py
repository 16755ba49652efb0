"""The three CUDA kernels of the verify path, their wrappers and plain versions.

The counterpart of ``mysticeti_tpu.ops.ed25519_pallas``:

=================  =====================================  ==============================
wrapper            CUDA source (csrc/)                    replaces
=================  =====================================  ==============================
``prologue``       prologue.cu                            ops/ed25519.py prepare_fused +
                                                          indexed_to_msg_words (XLA)
``verify_generic`` verify_generic.cu (+ fe51.cuh)         ed25519_pallas._verify_pallas_jit
``verify_keyed``   verify_keyed.cu (+ fe51.cuh)           ed25519_pallas._verify_keyed_pallas_jit
=================  =====================================  ==============================

Every wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for tensors on a CUDA device; there is no fallback from
one to the other.  A launch goes to the current stream, allocates nothing
inside the kernel (outputs come from ``torch.empty`` here), is checked with
``cudaGetLastError`` (a non-zero code raises), and adds one to its kernel's
``launches`` count.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import cuda_build
from . import ed25519 as E

# Lanes per keyed tile: one warp, one CUDA block per committee key tile.
KEYED_TILE = 32

_P, _I = ctypes.c_void_p, ctypes.c_int


class Kernel:
    """One CUDA kernel: its source, what it replaces, its launch count."""

    def __init__(self, name: str, replaces: str, argtypes) -> None:
        self.name = name
        self.source = f"mysticeti_tpu_torch/csrc/{name}.cu"
        self.replaces = replaces
        self.launches = 0
        self.lanes = 0
        self._argtypes = argtypes
        self._fn = None
        self._count_lock = threading.Lock()  # collector threads launch concurrently

    def _function(self):
        if self._fn is None:
            fn = getattr(cuda_build.load(self.name), f"{self.name}_launch")
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, lanes: int, *args) -> None:
        """Launch on ``device``'s current stream; raise if the launch failed.
        An empty batch launches nothing (a zero-block grid is an error)."""
        if lanes == 0:
            return
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._function()(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        with self._count_lock:
            self.launches += 1
            self.lanes += lanes

    def reset_counts(self) -> None:
        with self._count_lock:
            self.launches = 0
            self.lanes = 0


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
KERNELS = (PROLOGUE, VERIFY_GENERIC, VERIFY_KEYED)


def build_all() -> None:
    """Compile all three kernels at once (one nvcc per source, in parallel)."""
    cuda_build.build(k.name for k in KERNELS)


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
    dev = blob.device
    a_y = torch.empty((n, 20), dtype=torch.int32, device=dev)
    a_sign = torch.empty(n, dtype=torch.int32, device=dev)
    r_y = torch.empty((n, 20), dtype=torch.int32, device=dev)
    r_sign = torch.empty(n, dtype=torch.int32, device=dev)
    s_w = torch.empty((n, 64), dtype=torch.int32, device=dev)
    k_w = torch.empty((n, 64), dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    PROLOGUE.launch(
        dev, n, blob.data_ptr(), blob.shape[1],
        None if table is None else table.data_ptr(),
        0 if table is None else table.shape[0],
        a_y.data_ptr(), a_sign.data_ptr(), r_y.data_ptr(), r_sign.data_ptr(),
        s_w.data_ptr(), k_w.data_ptr(), ok.data_ptr(), n,
    )
    return a_y, a_sign, r_y, r_sign, s_w, k_w, ok


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
    compare with R).  Inputs as ``prologue`` returns them."""
    n = a_y.shape[0]
    _check(a_y, torch.int32, (n, 20), "a_y")
    _check(a_sign, torch.int32, (n,), "a_sign")
    _check_lanes(n, r_y, r_sign, s_w, k_w, ok)
    if not _on_cuda(a_y, a_sign, r_y, r_sign, s_w, k_w, ok):
        return E.verify_impl(a_y, a_sign, r_y, r_sign, s_w, k_w, ok)
    comb = E.base_comb(a_y.device)
    out = torch.empty(n, dtype=torch.bool, device=a_y.device)
    VERIFY_GENERIC.launch(
        a_y.device, n, comb.data_ptr(), a_y.data_ptr(), a_sign.data_ptr(), r_y.data_ptr(),
        r_sign.data_ptr(), s_w.data_ptr(), k_w.data_ptr(), ok.data_ptr(),
        out.data_ptr(), n,
    )
    return out


# ---------------------------------------------------------------------------
# Keyed-tile verify


def verify_keyed_plain(tile_keys, acomb, r_y, r_sign, s_w, k_w, ok, tile: int):
    """The plain version of the keyed kernel: 128 Niels mixed adds per lane,
    64 from the base comb and 64 from the lane's key comb.  Only lanes with
    ok set are computed."""
    out = torch.zeros_like(ok)
    live = torch.nonzero(ok).flatten()
    if live.numel() == 0:
        return out
    key = tile_keys.long().clamp(0, acomb.shape[0] - 1).repeat_interleave(tile)[live]
    r_y, r_sign, s_w, k_w = (t[live] for t in (r_y, r_sign, s_w, k_w))
    comb = E.base_comb(r_y.device)
    acc = E._identity_like(r_y)
    for i in range(64):
        acc = E.point_madd(acc, E._gather_comb(comb[i], s_w[:, i]))
        sel = acomb[key, i, :, :, k_w[:, i].long()]  # (B, 3, 20)
        acc = E.point_madd(acc, (sel[:, 0], sel[:, 1], sel[:, 2]))
    out[live] = E._matches_r(acc, r_y, r_sign)
    return out


def verify_keyed(tile_keys, acomb, r_y, r_sign, s_w, k_w, ok, tile: int = KEYED_TILE):
    """(B,) bool verdicts in GROUPED order: lanes [t*tile, (t+1)*tile) are
    verified against key ``tile_keys[t]``'s negated comb ``acomb`` (K, 64, 3,
    20, 16).  Lanes under an invalid key must arrive with ok cleared."""
    n = r_y.shape[0]
    if tile <= 0 or n % tile != 0:
        raise ValueError(f"batch {n} not a multiple of tile {tile}")
    _check(tile_keys, torch.int32, (n // tile,), "tile_keys")
    _check(acomb, torch.int32, (acomb.shape[0], 64, 3, 20, 16), "key combs")
    _check_lanes(n, r_y, r_sign, s_w, k_w, ok)
    if not _on_cuda(tile_keys, acomb, r_y, r_sign, s_w, k_w, ok):
        return verify_keyed_plain(tile_keys, acomb, r_y, r_sign, s_w, k_w, ok, tile)
    if tile > 1024:
        raise ValueError(f"tile {tile} exceeds a CUDA block")
    comb = E.base_comb(r_y.device)
    out = torch.empty(n, dtype=torch.bool, device=r_y.device)
    VERIFY_KEYED.launch(
        r_y.device, n, comb.data_ptr(), acomb.data_ptr(), tile_keys.data_ptr(), r_y.data_ptr(),
        r_sign.data_ptr(), s_w.data_ptr(), k_w.data_ptr(), ok.data_ptr(),
        out.data_ptr(), n, tile, acomb.shape[0],
    )
    return out
