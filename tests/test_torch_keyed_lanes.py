"""The keyed verify with one key per lane, against the JAX package.

The committee dispatch sends every chunk through the prologue and the keyed
kernel's lane form (``verify_keyed_lanes``), the lanes' keys in natural
order, with no grouping by key; the kernel reads the key combs in 51-bit
lines (``KeyTable.neg_combs51``).  On the CPU the wrappers run their plain
versions; the CUDA lane function is held to those in
``test_torch_kernel_host.py`` and the kernel by ``chip_smoke.py`` on the
card.  Verdicts and limbs are integers and bits: every comparison is exact.
"""
import numpy as np
import pytest
import torch

from mysticeti_tpu import block_validator as JBV
from mysticeti_tpu.ops import ed25519 as JE
from mysticeti_tpu_torch import _ed25519_py as PY
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.ops import ed25519_cuda as K

from test_torch_ed25519 import _oracle, count_calls
from test_torch_ops import _cases

COMMITTEE = 50  # the collector's flush of a 50-key committee never groups
FLUSH = 256


def _entry_value(limbs, bits: int) -> int:
    return sum(int(x) << (bits * i) for i, x in enumerate(limbs))


@pytest.mark.parametrize("source", ["built", "carried"])
def test_neg_combs51_hold_the_13_bit_combs_entry_by_entry(source):
    raw, *_ = _cases(40, 1, n_keys=3)
    keys = raw + [(E.P + 5).to_bytes(32, "little")]  # and an invalid key
    if source == "built":
        table = E.KeyTable(keys, device="cpu")
    else:  # carried across from the JAX package's arrays
        combs, valid = JE.build_neg_key_combs(keys)
        table = E.KeyTable.from_arrays(JE.pk_table_words(keys), combs, valid, device="cpu")
    comb13 = table.neg_combs()[0].numpy()
    comb51 = table.neg_combs51().numpy()
    assert comb51.shape == (len(keys), 64, 16, 16) and comb51.dtype == np.int64
    assert comb51.min() >= 0 and comb51.max() < 1 << 51
    assert not comb51[..., 15].any()  # the pad limb
    for k in range(len(keys)):
        for w in range(0, 64, 7):
            for v in range(16):
                for c in range(3):
                    assert (_entry_value(comb51[k, w, v, 5 * c : 5 * c + 5], 51)
                            == _entry_value(comb13[k, w, c, :, v], 13))
    np.testing.assert_array_equal(comb51, E.comb51_from13(comb13))
    assert table.neg_combs51() is table.neg_combs51()  # built once


@pytest.fixture(scope="module")
def flush():
    """A 256-signature flush of a 50-key committee: signers in random order,
    the seven case classes (the corrupt-pk lanes as tampered signatures of a
    committee key), and the JAX package's verdicts on it."""
    rng = np.random.default_rng(41)
    keys = [PY.Ed25519PrivateKey.from_private_bytes(rng.bytes(32)) for _ in range(COMMITTEE)]
    raw = [k.public_key().public_bytes_raw() for k in keys]
    pks, msgs, sigs = [], [], []
    for j, signer in enumerate(rng.integers(0, COMMITTEE, FLUSH)):
        msg = rng.bytes(32)
        sig = keys[signer].sign(msg)
        cls = j % 7
        if cls == 1:
            sig = bytes([sig[0] ^ 4]) + sig[1:]
        elif cls == 2:
            sig = sig[:33] + bytes([sig[33] ^ 1]) + sig[34:]
        elif cls == 3:
            msg = bytes([msg[0] ^ 1]) + msg[1:]
        elif cls == 4:  # signed by another committee key
            sig = keys[(signer + 1) % COMMITTEE].sign(msg)
        elif cls == 5:
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + E.L).to_bytes(32, "little")
        elif cls == 6:
            sig = sig[:63] + bytes([sig[63] ^ 0x10])
        pks.append(raw[signer])
        msgs.append(msg)
        sigs.append(sig)
    want = np.array(JBV.CpuSignatureVerifier().verify_signatures(pks, msgs, sigs))
    return E.KeyTable(raw, device="cpu"), pks, msgs, sigs, want


@pytest.mark.parametrize("keyed", ["1", "0"], ids=["lane_form", "keyed_off"])
def test_committee_flush_takes_the_lane_form(flush, monkeypatch, keyed):
    """With the keyed path on (the default), the flush takes the lane form
    once and never the generic kernel, though its 50 keys need 50 tiles
    and the bucket holds 8; with MYSTICETI_KEYED=0 the generic kernel."""
    table, pks, msgs, sigs, want = flush
    assert E.group_blob_for_tiles(
        E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table)),
        len(table), K.KEYED_TILE, FLUSH) is None
    monkeypatch.setenv("MYSTICETI_KEYED", keyed)
    calls = count_calls(monkeypatch, "verify_keyed_lanes", "verify_keyed", "verify_generic")
    got = E.verify_batch_table(table, pks, msgs, sigs)
    lane_form = keyed == "1"
    assert calls == {"verify_keyed_lanes": int(lane_form), "verify_keyed": 0,
                     "verify_generic": int(not lane_form)}
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(pks, msgs, sigs))
    assert 0 < got.sum() < len(got)


def test_lane_form_equals_the_tile_form_lane_for_lane():
    """The same lanes through both forms of the kernel's plain version: in
    natural order with one key each, and grouped into 8-lane tiles."""
    raw, pks, msgs, sigs, _ = _cases(42, 40, n_keys=5)
    table = E.KeyTable(raw, device="cpu")
    blob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table))
    outs = K.prologue(E.to_device_words(blob, "cpu"), table.words)
    lanes = K.verify_keyed_lanes(torch.as_tensor(blob[:, 24].astype(np.int32)),
                                 table.neg_combs51(), *outs[2:]).numpy()
    grouped, tile_keys, positions = E.group_blob_for_tiles(blob, len(table), 8, 128)
    gouts = K.prologue(E.to_device_words(grouped, "cpu"), table.words)
    tiles = K.verify_keyed(torch.as_tensor(tile_keys), table.neg_combs51(), *gouts[2:],
                           tile=8).numpy()
    np.testing.assert_array_equal(lanes, tiles[positions])
    assert lanes.any()


def test_keyed_wrappers_check_their_inputs():
    outs = K.prologue(torch.zeros((8, 33), dtype=torch.int32))
    comb51 = torch.zeros((2, 64, 16, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="keys"):
        K.verify_keyed_lanes(torch.zeros(4, dtype=torch.int32), comb51, *outs[2:])
    with pytest.raises(ValueError, match="key combs"):
        K.verify_keyed_lanes(torch.zeros(8, dtype=torch.int32), comb51.to(torch.int32), *outs[2:])
    assert not K.verify_keyed_lanes(torch.zeros(8, dtype=torch.int32), comb51, *outs[2:]).any()


@pytest.mark.kernel
def test_lane_form_equals_pallas_keyed():
    from mysticeti_tpu.ops import ed25519_pallas as JP

    raw, pks, msgs, sigs, _ = _cases(43, 24, n_keys=3)
    table = E.KeyTable(raw, device="cpu")
    blob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table))
    grouped, tile_keys, positions = E.group_blob_for_tiles(blob, len(table), 8, 64)
    combs, _ = JE.build_neg_key_combs(raw)
    want = np.asarray(JP.verify_keyed_blob(
        grouped, JE.pk_table_words(raw), combs, tile_keys, None, tile=8, interpret=True))
    outs = K.prologue(E.to_device_words(blob, "cpu"), table.words)
    got = K.verify_keyed_lanes(torch.as_tensor(blob[:, 24].astype(np.int32)),
                               table.neg_combs51(), *outs[2:]).numpy()
    np.testing.assert_array_equal(got, want[positions])
