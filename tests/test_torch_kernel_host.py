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
import hashlib
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mysticeti_tpu_torch import _ed25519_py as PY
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.ops import ed25519_cuda as K

from test_torch_ed25519 import _oracle
from test_torch_ops import _cases

CSRC = pathlib.Path(__file__).resolve().parent.parent / "mysticeti_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstddef>
#include <vector>
#define HD static inline
static long long fe_sqs, fe_muls;  // the field operations done so far
#define FE_COUNT_SQ() (++fe_sqs)
#define FE_COUNT_MUL() (++fe_muls)
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

extern "C" void host_prologue_flat(const uint32_t* flat, const uint32_t* table, int num_keys,
                                   const int32_t* tile_keys, int tile, int32_t* a_y,
                                   int32_t* a_sign, int32_t* r_y, int32_t* r_sign, int32_t* s_w,
                                   int32_t* k_w, uint8_t* ok, int n) {
  for (int i = 0; i < n; i++)
    prologue_flat_lane(flat + (size_t)24 * i, table, num_keys, tile_keys[i / tile],
                       (flat[(size_t)24 * n + (i >> 5)] >> (i & 31)) & 1u, a_y + 20 * i,
                       a_sign + i, r_y + 20 * i, r_sign + i, s_w + 64 * i, k_w + 64 * i,
                       ok + i);
}

// interleave = 0: each lane's table in a local array (stride 1); otherwise
// the n lanes share one table interleaved by lane, as a block's threads
// share their shared memory on the device (stride n).  ops (n, 2): the
// field squarings and multiplies lane i did.
extern "C" void host_generic(const uint64_t* comb51, const int32_t* a_y, const int32_t* a_sign,
                             const int32_t* r_y, const int32_t* r_sign, const int32_t* s_w,
                             const int32_t* k_w, const uint8_t* ok, uint8_t* out, int n,
                             int interleave, int64_t* ops) {
  std::vector<uint64_t> shared(interleave ? (size_t)n * GENERIC_TAB_BYTES / 8 : 0);
  for (int i = 0; i < n; i++) {
    uint64_t local[GENERIC_TAB_BYTES / 8];
    uint64_t* tab = interleave ? shared.data() + i : local;
    const long long sqs = fe_sqs, muls = fe_muls;
    out[i] = ok[i] && verify_generic_lane(comb51, a_y + 20 * i, a_sign[i], r_y + 20 * i,
                                          r_sign[i], s_w + 64 * i, k_w + 64 * i, tab,
                                          interleave ? n : 1);
    ops[2 * i] = fe_sqs - sqs;
    ops[2 * i + 1] = fe_muls - muls;
  }
}

// digits (n, 64) and top (n,): the signed digits and the carry out of the
// top window.
extern "C" void host_recode(const int32_t* k_w, int32_t* digits, int32_t* top, int n) {
  for (int i = 0; i < n; i++) {
    const uint64_t carries = recode_carries(k_w + 64 * i);
    for (int j = 0; j < 64; j++) digits[64 * i + j] = recode_digit(k_w + 64 * i, carries, j);
    top[i] = (int32_t)(carries >> 63);
  }
}

// Lane i's key is keys[i / tile] (tile = 1: one key per lane), clipped as
// the kernel clips it.
extern "C" void host_keyed(const uint64_t* comb51, const uint64_t* acomb51, const int32_t* keys,
                           const int32_t* r_y, const int32_t* r_sign, const int32_t* s_w,
                           const int32_t* k_w, const uint8_t* ok, uint8_t* out, int n,
                           int tile, int num_keys, int64_t* ops) {
  for (int i = 0; i < n; i++) {
    const long long sqs = fe_sqs, muls = fe_muls;
    out[i] = ok[i] && verify_keyed_lane(comb51, keyed_lane_comb(acomb51, keys, tile, num_keys, i),
                                        r_y + 20 * i, r_sign[i], s_w + 64 * i, k_w + 64 * i);
    ops[2 * i] = fe_sqs - sqs;
    ops[2 * i + 1] = fe_muls - muls;
  }
}

// x (n, 8) little-endian u64 words of 512-bit values -> r (n, 4) = x mod L.
extern "C" void host_mod_l(const uint64_t* x, uint64_t* r, int n) {
  for (int i = 0; i < n; i++) mod_l_512(x + 8 * i, r + 4 * i);
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


def _prologue_outputs(n: int):
    return [np.zeros((n, 20), np.int32), np.zeros(n, np.int32), np.zeros((n, 20), np.int32),
            np.zeros(n, np.int32), np.zeros((n, 64), np.int32), np.zeros((n, 64), np.int32),
            np.zeros(n, np.uint8)]


def _host_prologue(lib, blob: np.ndarray, table=None):
    n = blob.shape[0]
    outs = _prologue_outputs(n)
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


def _digit_cases():
    """Valid signatures whose k puts the recoding's corners on the ladder's
    path: a zero last digit (k = 0 mod 16: the last window adds nothing and
    the combine reads the doubling's T), a carry into the top window (window
    62 at 9 or more), and +8 / -7 digits low down."""
    rng = np.random.default_rng(27)
    key = PY.Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
    pk = key.public_key().public_bytes_raw()
    wants = [lambda k: k % 16 == 0, lambda k: ((k >> 248) & 15) >= 9,
             lambda k: k % 16 == 8, lambda k: k % 256 == 0x98]
    pks, msgs, sigs = [], [], []
    for want in wants:
        while True:
            msg = rng.bytes(32)
            sig = key.sign(msg)
            k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % E.L
            if want(k):
                break
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
    return pks, msgs, sigs


def _mod_l_cases():
    """Edge values of a reduction mod L, then random 512-bit values."""
    L, c = E.L, E.L - (1 << 252)
    xs = [0, 1, L - 1, L, L + 1, 2 * L - 1, 2 * L, 3 * L - 1, (1 << 252) - 1, 1 << 252,
          (1 << 253) - 1, (1 << 256) - 1, 1 << 256, (1 << 512) - 1, (1 << 511),
          ((1 << 512) - 1) // L * L, ((1 << 512) - 1) // L * L - 1, (1 << 448) * L]
    # Around 2^252 k for k up to 2^260: x = 2^252 k is congruent to -c k.
    for k in (1, 2, (1 << 128) - 1, (1 << 259) + 12345, (1 << 260) - 1):
        xs += [(k << 252) - 1, k << 252, (k << 252) + c * k % L, (k << 252) + L - c * k % L]
    xs += [m * L + r for m in (1, 1 << 100, (1 << 259) - 1) for r in (0, 1, L - 1)]
    rng = np.random.default_rng(28)
    xs += [int.from_bytes(rng.bytes(64), "little") for _ in range(400)]
    xs += [int.from_bytes(rng.bytes(64), "little") >> int(rng.integers(0, 512)) for _ in range(100)]
    return [x for x in xs if 0 <= x < 1 << 512]


def test_mod_l_reduction_equals_python_modulo(lib):
    xs = _mod_l_cases()
    # The Barrett quotient of mod_l_512 is exact or one below floor(x / L);
    # both kinds must be among the cases (the second takes the subtract).
    mu = (1 << 512) // E.L
    low = [x // E.L - ((x >> 192) * mu >> 320) for x in xs]
    assert set(low) == {0, 1}
    words = np.array([[(x >> (64 * j)) & ((1 << 64) - 1) for j in range(8)] for x in xs],
                     dtype=np.uint64)
    got = np.zeros((len(xs), 4), np.uint64)
    lib.host_mod_l(_ptr(words), _ptr(got), ctypes.c_int(len(xs)))
    for x, row in zip(xs, got):
        assert sum(int(w) << (64 * j) for j, w in enumerate(row)) == x % E.L, hex(x)


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


def test_prologue_flat_lanes_equal_the_plain_flat_prologue(lib):
    raw, pks, msgs, sigs, _ = _cases(24, 40, n_keys=3)
    epks, emsgs, esigs = _edge_cases()
    table = E.KeyTable(raw + epks[1:], device="cpu")  # edge keys as committee keys
    pks, msgs, sigs = pks + epks[1:], msgs + emsgs[1:], sigs + esigs[1:]
    blob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table))
    blob[::9, 25] = 0
    grouped, tile_keys, _ = E.group_blob_for_tiles(blob, len(table), 8, 128)
    tile_keys[-1] = 99  # an out-of-range key of an empty tile is clipped
    flat = E.pack_flat(grouped)
    want = K.prologue_flat(E.to_device_words(flat, "cpu"), table.words,
                           torch.as_tensor(tile_keys), tile=8)
    got = _prologue_outputs(grouped.shape[0])
    lib.host_prologue_flat(_ptr(flat), _ptr(E.pk_table_words(table._keys)),
                           ctypes.c_int(len(table)), _ptr(tile_keys), ctypes.c_int(8),
                           *[_ptr(o) for o in got], ctypes.c_int(grouped.shape[0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.astype(np.int64), w.numpy().astype(np.int64))
    assert got[-1].any() and not got[-1].all()


def _host_generic(lib, outs, interleave=0):
    """The generic lane on the host over the prologue outputs ``outs``:
    (verdicts, (n, 2) field squarings and multiplies of each lane)."""
    arrays = [t.numpy().astype(np.uint8) if t.dtype == torch.bool else t.numpy() for t in outs]
    n = arrays[0].shape[0]
    got = np.zeros(n, np.uint8)
    ops = np.zeros((n, 2), np.int64)
    lib.host_generic(_ptr(E.base_comb51("cpu").numpy()), *[_ptr(a) for a in arrays],
                     _ptr(got), ctypes.c_int(n), ctypes.c_int(interleave), _ptr(ops))
    return got.astype(bool), ops


def _host_recode(lib, k_w: np.ndarray):
    k_w = np.ascontiguousarray(k_w, np.int32)
    digits = np.zeros_like(k_w)
    top = np.zeros(k_w.shape[0], np.int32)
    lib.host_recode(_ptr(k_w), _ptr(digits), _ptr(top), ctypes.c_int(k_w.shape[0]))
    return digits, top


def _k_of(windows) -> int:
    return sum(int(x) << (4 * j) for j, x in enumerate(windows))


def _lanes_above_2_255(seed: int, n: int):
    """Prologue outputs of ``n`` signature cases, then the same with each k
    replaced by k + m L (m = 8, 9, 15: the top window 8 or more, so the
    recoding carries out of it) or, on every fourth lane, by random 4-bit
    windows."""
    _, pks, msgs, sigs, _ = _cases(seed, n)
    outs = K.prologue(E.to_device_words(E.pack_blob(pks, msgs, sigs), "cpu"))
    rng = np.random.default_rng(seed)
    k_w = []
    for i, row in enumerate(outs[5].numpy()):
        k = _k_of(row) + (8, 9, 15)[i % 3] * E.L
        if i % 4 == 3:
            k = int.from_bytes(rng.bytes(32), "little")
        k_w.append(E._windows_lsb_first(k))
    return outs, (*outs[:5], torch.as_tensor(np.stack(k_w)), outs[6])


@pytest.mark.parametrize("interleave", [0, 1], ids=["local_table", "interleaved_table"])
def test_generic_lanes_equal_the_plain_ladder_and_the_oracle(lib, interleave):
    _, pks, msgs, sigs, _ = _cases(22, 14)
    epks, emsgs, esigs = _edge_cases()
    dpks, dmsgs, dsigs = _digit_cases()
    pks, msgs, sigs = pks + epks + dpks, msgs + emsgs + dmsgs, sigs + esigs + dsigs
    outs = K.prologue(E.to_device_words(E.pack_blob(pks, msgs, sigs), "cpu"))
    want = K.verify_generic(*outs).numpy()
    assert want[-len(dpks):].all()
    got, _ = _host_generic(lib, outs, interleave)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, _oracle(pks, msgs, sigs))


@pytest.mark.parametrize("interleave", [0, 1], ids=["local_table", "interleaved_table"])
def test_generic_lanes_take_k_at_2_255_and_above(lib, interleave):
    """k + m L gives [k](-A) for a key of prime order, so valid signatures
    stay valid; random windows must give the plain version's verdicts."""
    outs, lifted = _lanes_above_2_255(25, 24)
    _, top = _host_recode(lib, lifted[5].numpy())
    assert top.sum() >= 8
    want = K.verify_generic(*lifted).numpy()
    kept = np.arange(len(want)) % 4 != 3  # not the random windows
    np.testing.assert_array_equal(want[kept], K.verify_generic(*outs).numpy()[kept])
    assert want.any()
    got, _ = _host_generic(lib, lifted, interleave)
    np.testing.assert_array_equal(got, want)


def test_signed_recoding_keeps_k_with_digits_in_range(lib):
    rng = np.random.default_rng(26)
    eights = sum(8 << (4 * j) for j in range(40))  # low windows all 8
    fifteens = (1 << 160) - 1  # low windows all 15
    ks = [0, E.L - 1, 1 << 252, eights, eights + (3 << 200), fifteens, fifteens + (5 << 244)]
    # A carry into the top window; and out of it (k >= 2^255).
    ks += [9 << 248, (8 << 252) + (9 << 248), 9 << 252, (1 << 256) - 1]
    ks += [int.from_bytes(rng.bytes(32), "little") % E.L for _ in range(200)]
    ks += [int.from_bytes(rng.bytes(32), "little") for _ in range(50)]
    k_w = np.stack([E._windows_lsb_first(k) for k in ks])
    digits, top = _host_recode(lib, k_w)
    assert digits.min() >= -8 and digits.max() <= 8
    assert digits.min() < 0 and (digits == 8).any()
    assert digits[7, 63] == 1 and top[8:11].all()
    assert not top[:8].any() and not top[11 : 11 + 200].any()  # no carry out of k < L
    for k, row, c in zip(ks, digits, top):
        assert _k_of(row) + (int(c) << 256) == k
    np.testing.assert_array_equal(K.signed_digits(k_w), digits)


def test_lane_op_counts_are_the_bound_model(lib):
    """The squarings and multiplies the bounds in chip_smoke.py are reckoned
    on (generic_lane_ops, keyed_lane_ops) are those the lanes do: exactly,
    but for the multiply by sqrt(-1) some keys' decompression takes."""
    _, pks, msgs, sigs, _ = _cases(22, 14)
    epks, emsgs, esigs = _edge_cases()
    dpks, dmsgs, dsigs = _digit_cases()
    pks, msgs, sigs = pks + epks + dpks, msgs + emsgs + dmsgs, sigs + esigs + dsigs
    outs = K.prologue(E.to_device_words(E.pack_blob(pks, msgs, sigs), "cpu"))
    _, lifted = _lanes_above_2_255(25, 24)
    for lanes in (outs, lifted):
        _, ops = _host_generic(lib, lanes)
        model = K.generic_lane_ops(lanes[5], lanes[6])
        ok = lanes[6].numpy()
        assert not ok.all() and (ops[~ok] == 0).all()
        np.testing.assert_array_equal(ops[:, 0], model[:, 0])
        extra = ops[:, 1] - model[:, 1]
        assert extra.min() >= 0 and extra.max() <= 1
        assert (model[ok, 1] > 1300).all() and len(set(model[ok, 1])) > 1

    raw, pks, msgs, sigs, _ = _cases(23, 16, n_keys=3)
    table = E.KeyTable(raw, device="cpu")
    blob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table))
    grouped, tile_keys, _ = E.group_blob_for_tiles(blob, len(table), 8, 64)
    outs = K.prologue(E.to_device_words(grouped, "cpu"), table.words)
    _, ops = _host_keyed(lib, table, tile_keys, outs)
    np.testing.assert_array_equal(ops, K.keyed_lane_ops(outs[6]))
    outs = K.prologue(E.to_device_words(blob, "cpu"), table.words)
    _, ops = _host_keyed(lib, table, blob[:, 24].astype(np.int32), outs, tile=1)
    np.testing.assert_array_equal(ops, K.keyed_lane_ops(outs[6]))


def test_comb51_holds_the_13_bit_comb_entry_by_entry():
    comb13 = E.base_comb("cpu").numpy()
    comb51 = E.base_comb51("cpu").numpy()
    assert comb51.shape == (64, 16, 16) and comb51.dtype == np.int64
    assert comb51.min() >= 0 and comb51.max() < 1 << 51
    assert not comb51[..., 15].any()  # the pad limb
    for w in range(64):
        for v in range(16):
            for c in range(3):
                want = sum(int(x) << (13 * i) for i, x in enumerate(comb13[w, c, :, v]))
                got = sum(int(x) << (51 * i) for i, x in enumerate(comb51[w, v, 5 * c : 5 * c + 5]))
                assert got % E.P == want % E.P


def _host_keyed(lib, table, keys, outs, tile=8):
    """The keyed lane on the 51-bit combs on the host, lane i under key
    ``keys[i // tile]``: (verdicts, (n, 2) field squarings and multiplies
    of each lane)."""
    keys = np.ascontiguousarray(keys, np.int32)
    arrays = [t.numpy().astype(np.uint8) if t.dtype == torch.bool else t.numpy() for t in outs[2:]]
    n = arrays[0].shape[0]
    got = np.zeros(n, np.uint8)
    ops = np.zeros((n, 2), np.int64)
    lib.host_keyed(_ptr(E.base_comb51("cpu").numpy()), _ptr(table.neg_combs51().numpy()),
                   _ptr(keys), *[_ptr(a) for a in arrays], _ptr(got), ctypes.c_int(n),
                   ctypes.c_int(tile), ctypes.c_int(len(table)), _ptr(ops))
    return got.astype(bool), ops


def test_keyed_lanes_equal_the_plain_keyed_verify(lib):
    raw, pks, msgs, sigs, _ = _cases(23, 16, n_keys=3)
    table = E.KeyTable(raw + [(E.P + 3).to_bytes(32, "little")], device="cpu")
    idx = table.indices_for(pks)
    idx[-2:] = 3  # two lanes under the invalid committee key
    blob = E.pack_blob_indexed(idx, msgs, sigs, num_keys=len(table))
    grouped, tile_keys, _ = E.group_blob_for_tiles(blob, len(table), 8, 64)
    outs = K.prologue(E.to_device_words(grouped, "cpu"), table.words)
    want = K.verify_keyed(torch.as_tensor(tile_keys), table.neg_combs51(), *outs[2:],
                          tile=8).numpy()
    np.testing.assert_array_equal(
        want, K.verify_keyed(torch.as_tensor(tile_keys), table.neg_combs()[0], *outs[2:],
                             tile=8).numpy())
    got, _ = _host_keyed(lib, table, tile_keys, outs)
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_keyed_lanes_take_one_key_per_lane(lib):
    """The lane form: keys mixed lane by lane in natural order, a key of -1
    and one of K (clipped to 0 and K-1), lanes under an invalid committee
    key with ok cleared; against the plain version and the oracle."""
    raw, pks, msgs, sigs, labels = _cases(29, 30, n_keys=3)
    bad = (E.P + 3).to_bytes(32, "little")
    table = E.KeyTable(raw[:2] + [bad] + raw[2:], device="cpu")  # key 2 is invalid
    idx = table.indices_for(pks)
    known = idx >= 0
    valid = np.array([label == "valid" for label in labels])
    first, last = np.flatnonzero((idx == 0) & valid)[0], np.flatnonzero((idx == 3) & valid)[0]
    under_bad = np.flatnonzero(known)[-2:]
    blob = E.pack_blob_indexed(idx, msgs, sigs, num_keys=len(table))  # unknown: ok clear
    blob[under_bad, 24] = 2
    blob[under_bad, 25] = 0  # the dispatch clears ok under an invalid key
    outs = K.prologue(E.to_device_words(blob, "cpu"), table.words)
    keys = blob[:, 24].astype(np.int32)
    keys[first], keys[last] = -1, len(table)
    assert len(set(keys[:8].tolist())) > 2  # keys vary lane by lane
    want = K.verify_keyed_lanes(torch.as_tensor(keys), table.neg_combs51(), *outs[2:]).numpy()
    got, _ = _host_keyed(lib, table, keys, outs, tile=1)
    np.testing.assert_array_equal(got, want)
    oracle = _oracle(pks, msgs, sigs)
    oracle[~known] = False  # unknown keys ride the generic patch, not this kernel
    oracle[under_bad] = False
    np.testing.assert_array_equal(want, oracle)
    assert want[first] and want[last] and want.sum() >= 4
