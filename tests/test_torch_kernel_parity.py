"""The port's ``kernel_parity`` tool against the JAX package's.

``build_cases`` must give the JAX tool's cases byte for byte at the same
seed; the port's tool on the kernels' plain versions (``--device cpu``)
passes with every class present; a ``kernel``-marked case holds the JAX
package's ``verify_batch`` bits against the port's over the same cases.
"""
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mysticeti_tpu_torch.tools import kernel_parity as port  # noqa: E402
from tools import kernel_parity as jax_tool  # noqa: E402

CLASSES = {"valid", "corrupt_R", "corrupt_s", "corrupt_msg", "wrong_key", "noncanonical_s",
           "corrupt_pk"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions gain nothing from intra-op threads (their time is
    Python dispatch), and the suite runs several workers on the host's
    cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [2026, 7])
def test_build_cases_are_the_jax_tools_byte_for_byte(seed):
    ours = port.build_cases(500, seed)
    theirs = jax_tool.build_cases(500, seed)
    assert ours == theirs
    assert set(ours[4]) == CLASSES


def test_rfc_vectors_and_oracle_are_the_jax_tools():
    assert port.RFC8032_VECTORS == jax_tool.RFC8032_VECTORS
    assert port.L == jax_tool.L
    _, pks, msgs, sigs, _ = port.build_cases(200, 3)
    assert [port.oracle_verify(*c) for c in zip(pks, msgs, sigs)] == [
        jax_tool.oracle_verify(*c) for c in zip(pks, msgs, sigs)]


def test_the_tool_passes_on_the_plain_versions(tmp_path, capsys):
    out = str(tmp_path / "KERNEL_PARITY.json")
    assert port.main(["--device", "cpu", "--n", "64", "--out", out]) == 0
    doc = json.loads(open(out).read())
    summary = json.loads(capsys.readouterr().out.splitlines()[0])
    assert summary == {"device": "cpu", "card": None, "backend": "cpu", "pass": True}
    assert doc["pass"] and doc["rfc8032"] == {"accept_all_valid": True,
                                              "reject_all_corrupt": True}
    assert set(doc["randomized"]) == {"verify_batch_raw", "verify_batch_table_keyed"}
    for r in doc["randomized"].values():
        assert r["cases"] == 64 and r["mismatches"] == 0 and r["first_mismatches"] == []
        assert set(r["per_class"]) == CLASSES
        assert sum(c["cases"] for c in r["per_class"].values()) == 64
    # No launch on the CPU: the wrappers took their plain versions.
    assert set(doc["launches"].values()) == {0}


def test_a_wrong_verdict_fails_the_tool(tmp_path, monkeypatch):
    """A lane class that a dispatch path gets wrong shows as mismatches in
    that class and path, and as a non-zero exit (the JAX tool exits 0
    either way).  Both paths are stood in for by the oracle, the keyed one
    accepting every signature under a committee key."""
    from mysticeti_tpu_torch.ops import ed25519 as E

    def oracle(pks, msgs, sigs, device=None):
        return np.array([port.oracle_verify(*c) for c in zip(pks, msgs, sigs)])

    def accepts_committee_keys(table, pks, msgs, sigs):
        return oracle(pks, msgs, sigs) | np.array([pk in committee for pk in pks])

    committee = set(port.build_cases(1, 2026)[0])
    monkeypatch.setattr(E, "verify_batch", oracle)
    monkeypatch.setattr(E, "verify_batch_table", accepts_committee_keys)
    out = str(tmp_path / "KERNEL_PARITY.json")
    assert port.main(["--device", "cpu", "--n", "256", "--out", out]) == 1
    doc = json.loads(open(out).read())
    keyed = doc["randomized"]["verify_batch_table_keyed"]
    assert not doc["pass"] and keyed["mismatches"] > 0
    wrong = keyed["per_class"]["wrong_key"]
    assert wrong["mismatches"] == wrong["cases"] > 0
    assert keyed["per_class"]["valid"]["mismatches"] == 0
    assert keyed["per_class"]["corrupt_pk"]["mismatches"] == 0
    assert doc["randomized"]["verify_batch_raw"]["mismatches"] == 0
    assert doc["rfc8032"] == {"accept_all_valid": True, "reject_all_corrupt": True}


def test_the_tool_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.parity(4, 1)


@pytest.mark.kernel
def test_verdicts_equal_the_jax_packages_verify_batch():
    from mysticeti_tpu.ops import ed25519 as JE
    from mysticeti_tpu_torch.ops import ed25519 as E

    committee_keys, pks, msgs, sigs, labels = port.build_cases(64, 2026)
    want = np.array([port.oracle_verify(*c) for c in zip(pks, msgs, sigs)])
    jax_bits = np.asarray(JE.verify_batch(pks, msgs, sigs))
    assert (jax_bits == want).all()
    assert (E.verify_batch(pks, msgs, sigs, device="cpu") == jax_bits).all()
    table = E.KeyTable(committee_keys, device="cpu")
    jax_table = JE.KeyTable(committee_keys)
    jax_keyed = np.asarray(JE.verify_batch_table(jax_table, pks, msgs, sigs))
    assert (E.verify_batch_table(table, pks, msgs, sigs) == jax_keyed).all()
    assert (jax_keyed == want).all()
