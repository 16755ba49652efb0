"""The CUDA kernels' arithmetic, compiled for the host, against the plain versions.

The kernel sources declare their per-lane functions through an ``HD`` macro
(device functions under nvcc).  Defined as ``static inline`` first, the same
sources compile with a host C++ compiler, so the CPU suite holds the kernels'
arithmetic — the 5 x 51-bit field, SHA-512 and mod L, both ladders — to the
plain PyTorch versions lane for lane.  The launch code (``__global__``
kernels and the C entry points) is nvcc-only; ``chip_smoke.py`` checks it on
the card.  Skips when no host C++ compiler is installed.
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.ops import ed25519_cuda as K

from test_torch_ed25519 import _oracle
from test_torch_ops import _cases

CSRC = pathlib.Path(__file__).resolve().parent.parent / "mysticeti_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstddef>
#define HD static inline
#include "prologue.cu"
#include "verify_generic.cu"
#include "verify_keyed.cu"

extern "C" void host_prologue(const uint32_t* blob, int ncols, const uint32_t* table,
                              int num_keys, int32_t* a_y, int32_t* a_sign, int32_t* r_y,
                              int32_t* r_sign, int32_t* s_w, int32_t* k_w, uint8_t* ok,
                              int n) {
  for (int i = 0; i < n; i++)
    prologue_lane(blob + (size_t)ncols * i, table, num_keys, a_y + 20 * i, a_sign + i,
                  r_y + 20 * i, r_sign + i, s_w + 64 * i, k_w + 64 * i, ok + i);
}

extern "C" void host_generic(const int32_t* comb, const int32_t* a_y, const int32_t* a_sign,
                             const int32_t* r_y, const int32_t* r_sign, const int32_t* s_w,
                             const int32_t* k_w, const uint8_t* ok, uint8_t* out, int n) {
  for (int i = 0; i < n; i++)
    out[i] = ok[i] && verify_generic_lane(comb, a_y + 20 * i, a_sign[i], r_y + 20 * i,
                                          r_sign[i], s_w + 64 * i, k_w + 64 * i);
}

extern "C" void host_keyed(const int32_t* comb, const int32_t* acomb, const int32_t* tile_keys,
                           const int32_t* r_y, const int32_t* r_sign, const int32_t* s_w,
                           const int32_t* k_w, const uint8_t* ok, uint8_t* out, int n,
                           int tile) {
  for (int i = 0; i < n; i++)
    out[i] = ok[i] && verify_keyed_lane(comb, acomb + (size_t)tile_keys[i / tile] * 64 * 3 * 20 * 16,
                                        r_y + 20 * i, r_sign[i], s_w + 64 * i, k_w + 64 * i);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' lane functions")
    work = tmp_path_factory.mktemp("kernel_host")
    (work / "harness.cpp").write_text(HARNESS)
    out = work / "libharness.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
         "-o", str(out), str(work / "harness.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(out))


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _host_prologue(lib, blob: np.ndarray, table=None):
    n = blob.shape[0]
    outs = [np.zeros((n, 20), np.int32), np.zeros(n, np.int32), np.zeros((n, 20), np.int32),
            np.zeros(n, np.int32), np.zeros((n, 64), np.int32), np.zeros((n, 64), np.int32),
            np.zeros(n, np.uint8)]
    lib.host_prologue(_ptr(blob), ctypes.c_int(blob.shape[1]),
                      None if table is None else _ptr(table),
                      ctypes.c_int(0 if table is None else table.shape[0]),
                      *[_ptr(o) for o in outs], ctypes.c_int(n))
    return outs


def _edge_cases():
    """Lanes the random classes rarely hit: non-canonical R and A, x = 0
    with the sign bit set, the identity as a key, an off-curve key."""
    raw, pks, msgs, sigs, _ = _cases(21, 6)
    p = E.P
    off_curve = next(y for y in range(2, 100) if E._recover_x(y, 0) is None)
    pks[1] = (p + 3).to_bytes(32, "little")  # A with y >= p
    sigs[2] = (p + 1).to_bytes(32, "little") + sigs[2][32:]  # R with y >= p
    pks[3] = (1 | 1 << 255).to_bytes(32, "little")  # y = 1, x = 0, sign 1
    pks[4] = (1).to_bytes(32, "little")  # the identity
    pks[5] = off_curve.to_bytes(32, "little")
    return pks, msgs, sigs


def test_prologue_lanes_equal_the_plain_prologue(lib):
    raw, pks, msgs, sigs, _ = _cases(20, 21)
    epks, emsgs, esigs = _edge_cases()
    pks, msgs, sigs = pks + epks, msgs + emsgs, sigs + esigs
    blob = E.pack_blob(pks, msgs, sigs)
    want = K.prologue(E.to_device_words(blob, "cpu"))
    for got, w in zip(_host_prologue(lib, blob), want):
        np.testing.assert_array_equal(got.astype(np.int64), w.numpy().astype(np.int64))
    table = E.KeyTable(raw, device="cpu")
    iblob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(raw))
    words = E.pk_table_words(raw)
    want = K.prologue(E.to_device_words(iblob, "cpu"), table.words)
    for got, w in zip(_host_prologue(lib, iblob, words), want):
        np.testing.assert_array_equal(got.astype(np.int64), w.numpy().astype(np.int64))


def test_generic_lanes_equal_the_plain_ladder_and_the_oracle(lib):
    _, pks, msgs, sigs, _ = _cases(22, 14)
    epks, emsgs, esigs = _edge_cases()
    pks, msgs, sigs = pks + epks, msgs + emsgs, sigs + esigs
    outs = K.prologue(E.to_device_words(E.pack_blob(pks, msgs, sigs), "cpu"))
    want = K.verify_generic(*outs).numpy()
    arrays = [t.numpy().astype(np.uint8) if t.dtype == torch.bool else t.numpy() for t in outs]
    got = np.zeros(len(pks), np.uint8)
    lib.host_generic(_ptr(E.base_comb("cpu").numpy()), *[_ptr(a) for a in arrays],
                     _ptr(got), ctypes.c_int(len(pks)))
    np.testing.assert_array_equal(got.astype(bool), want)
    np.testing.assert_array_equal(want, _oracle(pks, msgs, sigs))


def test_keyed_lanes_equal_the_plain_keyed_verify(lib):
    raw, pks, msgs, sigs, _ = _cases(23, 16, n_keys=3)
    table = E.KeyTable(raw + [(E.P + 3).to_bytes(32, "little")], device="cpu")
    idx = table.indices_for(pks)
    idx[-2:] = 3  # two lanes under the invalid committee key
    blob = E.pack_blob_indexed(idx, msgs, sigs, num_keys=len(table))
    grouped, tile_keys, _ = E.group_blob_for_tiles(blob, len(table), 8, 64)
    outs = K.prologue(E.to_device_words(grouped, "cpu"), table.words)
    acomb, _ = table.neg_combs()
    want = K.verify_keyed(torch.as_tensor(tile_keys), acomb, *outs[2:], tile=8).numpy()
    arrays = [t.numpy().astype(np.uint8) if t.dtype == torch.bool else t.numpy() for t in outs[2:]]
    got = np.zeros(grouped.shape[0], np.uint8)
    lib.host_keyed(_ptr(E.base_comb("cpu").numpy()), _ptr(acomb.numpy()), _ptr(tile_keys),
                   *[_ptr(a) for a in arrays], _ptr(got), ctypes.c_int(grouped.shape[0]),
                   ctypes.c_int(8))
    np.testing.assert_array_equal(got.astype(bool), want)
