"""The flat keyed upload (``verify_keyed_flat``) against the 26-column keyed path.

The flat layout carries a grouped batch as 24 words per signature (R, M, s)
plus one ok bit per lane; the key comes from the lane's tile.  On the CPU
the wrappers run their plain versions; ``prologue_flat``'s CUDA lane
function is held to the plain version in ``test_torch_kernel_host.py`` and
the kernel itself by ``chip_smoke.py`` on the card.  Verdicts and prologue
outputs are integers and bits: every comparison is exact.
"""
import numpy as np
import pytest
import torch

from mysticeti_tpu.ops import ed25519 as JE
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.ops import ed25519_cuda as K

from test_torch_ed25519 import _oracle
from test_torch_ops import _cases

TILE, BUCKET = 8, 64


def _grouped(seed: int, n: int = 40, n_keys: int = 4):
    """A grouped batch of the seven case classes over ``n_keys`` committee
    keys (corrupt-pk lanes carry an unknown key and ride host_ok=False)."""
    raw, pks, msgs, sigs, labels = _cases(seed, n, n_keys=n_keys)
    table = E.KeyTable(raw, device="cpu")
    blob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table))
    grouped, tile_keys, positions = E.group_blob_for_tiles(blob, len(table), TILE, BUCKET)
    return table, grouped, tile_keys, positions, (pks, msgs, sigs, labels)


def test_pack_flat_matches_the_layout_jax_reads():
    _, grouped, *_ = _grouped(30)
    flat = E.pack_flat(grouped)
    okmask = np.packbits(grouped[:, 25].astype(bool), bitorder="little").view(np.uint32)
    np.testing.assert_array_equal(flat, np.concatenate([grouped[:, :24].reshape(-1), okmask]))
    assert flat.shape == (BUCKET * 24 + BUCKET // 32,)


def test_plain_prologue_flat_equals_the_indexed_prologue():
    table, grouped, tile_keys, _, _ = _grouped(31)
    want = K.prologue(E.to_device_words(grouped, "cpu"), table.words)
    got = K.prologue_flat(E.to_device_words(E.pack_flat(grouped), "cpu"), table.words,
                          torch.as_tensor(tile_keys), tile=TILE)
    ok = grouped[:, 25] != 0
    assert ok.any() and not ok.all()
    np.testing.assert_array_equal(got[-1].numpy(), want[-1].numpy())
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy()[ok], w.numpy()[ok])


def test_plain_verify_keyed_flat_equals_the_grouped_keyed_path_and_the_labels():
    table, grouped, tile_keys, positions, (pks, msgs, sigs, labels) = _grouped(32)
    acomb = table.neg_combs51()
    tk = torch.as_tensor(tile_keys)
    outs = K.prologue(E.to_device_words(grouped, "cpu"), table.words)
    want = K.verify_keyed(tk, acomb, *outs[2:], tile=TILE).numpy()
    got = K.verify_keyed_flat(E.to_device_words(E.pack_flat(grouped), "cpu"), table.words,
                              acomb, tk, tile=TILE).numpy()
    np.testing.assert_array_equal(got, want)
    expected = np.array([label == "valid" for label in labels])
    np.testing.assert_array_equal(got[positions], expected)
    np.testing.assert_array_equal(got[positions], _oracle(pks, msgs, sigs))


@pytest.mark.parametrize("case", ["ragged_batch", "short_upload", "long_upload"])
def test_flat_upload_errors_as_jax_raises_them(case):
    table, grouped, tile_keys, _, _ = _grouped(33)
    acomb = table.neg_combs51()
    flat = E.to_device_words(E.pack_flat(grouped), "cpu")
    tk = torch.as_tensor(tile_keys)
    if case == "ragged_batch":  # 7 tiles of 8 lanes: 56 lanes, not a multiple of 32
        tk = tk[:7]
        flat = flat[: 56 * 24 + 1]
        match = "not a multiple of 32"
    elif case == "short_upload":
        flat = flat[:-1]
        match = "flat upload"
    else:
        flat = torch.cat([flat, flat[:1]])
        match = "flat upload"
    with pytest.raises(ValueError, match=match):
        K.verify_keyed_flat(flat, table.words, acomb, tk, tile=TILE)


@pytest.mark.kernel
def test_plain_verify_keyed_flat_equals_pallas_verify_keyed_flat():
    from mysticeti_tpu.ops import ed25519_pallas as JP

    table, grouped, tile_keys, _, (_, _, _, _) = _grouped(34)
    raw = table._keys
    combs, _ = JE.build_neg_key_combs(raw)
    okmask = np.packbits(grouped[:, 25].astype(bool), bitorder="little").view(np.uint32)
    flat = np.concatenate([grouped[:, :24].reshape(-1), okmask])
    want = np.asarray(JP.verify_keyed_flat(flat, JE.pk_table_words(raw), combs, tile_keys,
                                           tile=TILE, interpret=True))
    got = K.verify_keyed_flat(E.to_device_words(flat, "cpu"), table.words, table.neg_combs51(),
                              torch.as_tensor(tile_keys), tile=TILE)
    np.testing.assert_array_equal(got.numpy(), want)
