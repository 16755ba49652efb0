"""The port's sharded dispatch (``parallel.mesh``) on an 8-shard CPU mesh.

The JAX tests shard over 8 virtual CPU devices; the port's mesh repeats the
one CPU device 8 times, so every shard runs the kernels' plain versions.
Verdicts must equal the port's single-device dispatch, the labels the cases
were built with and the JAX package's CPU oracle; the valid count (the
counterpart of the JAX ``psum``) must equal the sum of the verdicts.
"""
import numpy as np
import pytest
import torch

from mysticeti_tpu import block_validator as JBV
from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.parallel import mesh as M

from test_torch_ops import _cases

SHARDS = 8


@pytest.fixture(scope="module")
def cases():
    """40 signatures of the seven classes over 4 committee keys; the
    corrupt-pk lanes carry keys the table does not know (stragglers)."""
    raw, pks, msgs, sigs, labels = _cases(40, 40, n_keys=4)
    return E.KeyTable(raw, device="cpu"), pks, msgs, sigs, np.array([c == "valid" for c in labels])


@pytest.fixture(scope="module")
def mesh():
    return M.make_mesh(devices=["cpu"] * SHARDS)


def _oracle(pks, msgs, sigs):
    return np.array(JBV.CpuSignatureVerifier().verify_signatures(pks, msgs, sigs))


def test_make_mesh_repeats_a_device_and_keeps_the_batch_axis(mesh):
    assert mesh.size == SHARDS and mesh.axis_names == ("batch",)
    assert set(mesh.devices) == {torch.device("cpu")}
    assert M.make_mesh(3, devices=["cpu"] * SHARDS).size == 3


@pytest.mark.parametrize("flavour", ["indexed", "fused", "host_hash"])
def test_sharded_verify_equals_single_device_labels_and_oracle(mesh, cases, flavour):
    table, pks, msgs, sigs, expected = cases
    if flavour == "indexed":
        got, total = M.sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
        single = E.verify_batch_table(table, pks, msgs, sigs)
    elif flavour == "fused":
        got, total = M.sharded_verify_batch_fused(mesh, pks, msgs, sigs)
        single = E.verify_batch(pks, msgs, sigs, device="cpu")
    else:  # sharded_verify_batch hashes on the host (any message length)
        got, total = M.sharded_verify_batch(mesh, pks, msgs, sigs)
        single = E.fetch_handles([(len(sigs), E.verify_impl(*(
            torch.as_tensor(x) for x in E.pack_batch(pks, msgs, sigs))))])
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, _oracle(pks, msgs, sigs))
    np.testing.assert_array_equal(got, expected)
    assert total == int(got.sum()) and 0 < total < len(sigs)


def test_indexed_stragglers_ride_a_sharded_fused_patch(mesh, cases):
    table, pks, msgs, sigs, expected = cases
    stragglers = np.flatnonzero(table.indices_for(pks) < 0)
    assert len(stragglers) > 0
    # Make every straggler a valid signature under its own (unknown) key:
    # only the patch can accept them.
    raw, spks, smsgs, ssigs, _ = _cases(41, len(stragglers) * 7, n_keys=1)
    valid = list(range(0, len(spks), 7))[: len(stragglers)]
    pks, msgs, sigs = list(pks), list(msgs), list(sigs)
    for row, j in zip(stragglers, valid):
        pks[row], msgs[row], sigs[row] = spks[j], smsgs[j], ssigs[j]
    got, total = M.sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
    assert got[stragglers].all()
    np.testing.assert_array_equal(np.delete(got, stragglers), np.delete(expected, stragglers))
    assert total == int(got.sum())


def test_a_batch_that_does_not_divide_over_the_mesh_raises(mesh, cases):
    table, pks, msgs, sigs, _ = cases
    blob = E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        M._cached_indexed_kernel(mesh)(blob[:12], table)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        M.sharded_verify_kernel(mesh)(*(x[:12] for x in E.pack_batch(pks, msgs, sigs)))


def test_torch_verifier_takes_the_mesh_for_digests_only(mesh, cases):
    table, pks, msgs, sigs, expected = cases
    verifier = TorchSignatureVerifier(mesh=mesh, committee_keys=table._keys, device="cpu")
    handle = verifier.verify_signatures_async(pks, msgs, sigs)
    assert isinstance(handle._entries[0][1], list)  # per-shard results
    assert handle.result().tolist() == expected.tolist()
    long_msgs = [m + b"!" for m in msgs]
    handle = verifier.verify_signatures_async(pks, long_msgs, sigs)
    assert not isinstance(handle._entries[0][1], list)  # host hash, one device
    # mesh="auto" never shards on the CPU.
    assert TorchSignatureVerifier(device="cpu")._resolve_mesh() is None


def test_mesh_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSignatureVerifier(mesh="auto")


def test_key_table_words_are_cached_per_device(cases):
    table = cases[0]
    assert table.words_on("cpu") is table.words
    assert table.words_on(torch.device("cpu")) is table.words


@pytest.mark.kernel
def test_sharded_indexed_equals_the_jax_mesh():
    from mysticeti_tpu.ops import ed25519 as JE
    from mysticeti_tpu.parallel import mesh as JM

    raw, pks, msgs, sigs, _ = _cases(42, 40, n_keys=4)
    want, want_total = JM.sharded_verify_batch_indexed(
        JM.make_mesh(SHARDS), JE.KeyTable(raw), pks, msgs, sigs)
    got, total = M.sharded_verify_batch_indexed(
        M.make_mesh(devices=["cpu"] * SHARDS), E.KeyTable(raw, device="cpu"), pks, msgs, sigs)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert total == want_total
