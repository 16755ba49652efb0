"""The port's plain verifies against the Ed25519 oracle and the Pallas kernels.

On the CPU the kernel wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held to those by ``chip_smoke.py`` on the card.
Verdicts are bits: every comparison is exact.
"""
import numpy as np
import pytest
import torch

from mysticeti_tpu import crypto as jcrypto
from mysticeti_tpu.ops import ed25519 as JE
from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.ops import ed25519_cuda as K

from test_torch_ops import _cases

RFC8032_VECTORS = [
    ("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb88215"
     "90a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e4"
     "3e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b53"
     "8d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def _oracle(pks, msgs, sigs):
    out = []
    for pk, m, s in zip(pks, msgs, sigs):
        try:
            out.append(jcrypto.PublicKey(pk).verify(s, m))
        except ValueError:
            out.append(False)
    return np.array(out)


def test_rfc8032_vectors_generic():
    pks = [bytes.fromhex(p) for p, _, _ in RFC8032_VECTORS]
    msgs = [bytes.fromhex(m) for _, m, _ in RFC8032_VECTORS]
    sigs = [bytes.fromhex(s) for _, _, s in RFC8032_VECTORS]
    assert E.verify_batch(pks, msgs, sigs, device="cpu").all()
    bad_sigs = [bytes([sigs[0][0] ^ 0x40]) + sigs[0][1:], sigs[1][:40] + b"\x01" + sigs[1][41:], sigs[2]]
    bad_msgs = [msgs[0], msgs[1], msgs[2] + b"x"]
    assert not E.verify_batch(pks, bad_msgs, bad_sigs, device="cpu").any()


def test_generic_and_keyed_match_oracle_on_case_classes():
    raw, pks, msgs, sigs, labels = _cases(7, 14)
    expected = _oracle(pks, msgs, sigs)
    assert set(labels) == {"valid", "corrupt_R", "corrupt_s", "corrupt_msg",
                           "wrong_key", "noncanonical_s", "corrupt_pk"}
    assert expected[[l == "valid" for l in labels]].all()
    assert not expected[[l != "valid" for l in labels]].any()
    # Generic: raw blob -> prologue -> generic ladder.
    np.testing.assert_array_equal(E.verify_batch(pks, msgs, sigs, device="cpu"), expected)
    # Committee path: keyed kernel for known keys, generic patch for the
    # corrupt-pk stragglers.
    table = E.KeyTable(raw, device="cpu")
    np.testing.assert_array_equal(E.verify_batch_table(table, pks, msgs, sigs), expected)


def test_keyed_rejects_lanes_under_an_invalid_committee_key():
    raw, pks, msgs, sigs, _ = _cases(8, 4, n_keys=2)
    bad = (E.P + 2).to_bytes(32, "little")  # non-canonical: the prologue rejects it
    # Canonical but off the curve: only the dispatch's valid mask rejects it.
    # Its comb holds zero entries; a mixed add of one takes any sum to
    # (0 : 0 : Z : 0), which every later add keeps, so a signature with the
    # all-zero R (y = 0, x = 0) would verify under it.
    off_curve = next(y for y in range(2, 100) if E._recover_x(y, 0) is None)
    table = E.KeyTable(raw + [bad, off_curve.to_bytes(32, "little")], device="cpu")
    forged = bytes(64)
    blob = E.pack_blob_indexed(np.array([0, 1, 2, 2, 3]), msgs + [msgs[0]], sigs + [forged],
                               num_keys=4)
    got = E.fetch_handles(E.dispatch_indexed_chunks(blob, table))
    assert got[2:].tolist() == [False, False, False]
    assert got[0] == _oracle(pks[:1], msgs[:1], sigs[:1])[0]


def test_carried_key_table_verifies_like_a_built_one():
    raw, pks, msgs, sigs, _ = _cases(9, 7)
    combs, valid = JE.build_neg_key_combs(raw)
    carried = E.KeyTable.from_arrays(JE.pk_table_words(raw), combs, valid, device="cpu")
    built = E.KeyTable(raw, device="cpu")
    assert torch.equal(carried.words, built.words)
    assert torch.equal(carried.neg_combs()[0], built.neg_combs()[0])
    np.testing.assert_array_equal(
        E.verify_batch_table(carried, pks, msgs, sigs),
        E.verify_batch_table(built, pks, msgs, sigs),
    )


def count_calls(monkeypatch, *names):
    """Wrap the ``ed25519_cuda`` functions ``names``; returns the live
    {name: calls} counts."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(K, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(K, name, counted)
    return calls


def test_keyed_switch_off_takes_the_generic_kernel(monkeypatch):
    raw, pks, msgs, sigs, _ = _cases(10, 3, n_keys=3)
    table = E.KeyTable(raw, device="cpu")
    blob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=3)
    calls = count_calls(monkeypatch, "verify_keyed_lanes", "verify_generic")
    keyed = E.dispatch_indexed_chunks(blob, table)
    assert calls == {"verify_keyed_lanes": 1, "verify_generic": 0}
    monkeypatch.setenv("MYSTICETI_KEYED", "0")
    generic = E.dispatch_indexed_chunks(blob, table)
    assert calls == {"verify_keyed_lanes": 1, "verify_generic": 1}
    np.testing.assert_array_equal(E.fetch_handles(keyed), E.fetch_handles(generic))


def test_wrappers_check_their_inputs():
    blob = torch.zeros((4, 26), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.prologue(blob)  # an indexed blob needs its key table
    with pytest.raises(ValueError):
        K.prologue(blob.to(torch.int64), torch.zeros((2, 8), dtype=torch.int32))
    outs = K.prologue(torch.zeros((8, 33), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.verify_keyed(torch.zeros(1, dtype=torch.int32),
                       torch.zeros((1, 64, 3, 20, 16), dtype=torch.int32), *outs[2:], tile=3)
    assert not K.verify_generic(*outs).any()


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    raw, pks, msgs, sigs, _ = _cases(11, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.KeyTable(raw)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.dispatch_batch(pks, msgs, sigs)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSignatureVerifier(committee_keys=raw)
    assert TorchSignatureVerifier(device="cpu").resolved_backend() == "cpu"


# ---------------------------------------------------------------------------
# Against the Pallas kernels under the interpreter (compile-heavy: tier 2)


@pytest.mark.kernel
def test_plain_generic_equals_pallas_generic():
    from mysticeti_tpu.ops import ed25519_pallas as JP

    _, pks, msgs, sigs, _ = _cases(12, 8)
    msg_words, s_words, host_ok = JE.pack_bytes(pks, msgs, sigs)
    want = np.asarray(JP.verify_fused_pallas(msg_words, s_words, host_ok, tile=8, interpret=True))
    blob = np.concatenate([msg_words, s_words, host_ok[:, None].astype(np.uint32)], axis=1)
    got = K.verify_generic(*K.prologue(E.to_device_words(blob, "cpu"))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.kernel
def test_plain_keyed_equals_pallas_keyed():
    from mysticeti_tpu.ops import ed25519_pallas as JP

    raw, pks, msgs, sigs, _ = _cases(13, 16, n_keys=2)
    table = E.KeyTable(raw, device="cpu")
    blob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=2)
    grouped, tile_keys, _ = E.group_blob_for_tiles(blob, 2, 8, 32)
    combs, _ = JE.build_neg_key_combs(raw)
    want = np.asarray(JP.verify_keyed_blob(
        grouped, JE.pk_table_words(raw), combs, tile_keys, None, tile=8, interpret=True))
    outs = K.prologue(E.to_device_words(grouped, "cpu"), table.words)
    got = K.verify_keyed(torch.as_tensor(tile_keys), table.neg_combs51(), *outs[2:], tile=8)
    np.testing.assert_array_equal(got.numpy(), want)
