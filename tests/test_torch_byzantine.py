"""The port's resilience scenarios against the JAX package's, and the port's
``real_crypto`` path on the kernels' plain versions.

``run_scenario("byzantine-at-f")`` (f = 3 of 10: equivocate, withhold,
invalid_sig) cut to 4 virtual s gives one verdict document on the JAX
package's sim re-sign oracle, on the port's, and on the port's
``real_crypto`` path with ``device="cpu"`` (every collector over the
port's ``TorchSignatureVerifier`` running the kernels' plain versions).
"""
import dataclasses

import pytest

from mysticeti_tpu_torch import scenarios
from mysticeti_tpu_torch.block_validator import SignatureVerifier, TorchSignatureVerifier
from mysticeti_tpu_torch.committee import Committee

pytestmark = pytest.mark.byzantine


def _byzantine_at_f(module, duration_s):
    return dataclasses.replace(module.scenario_by_name("byzantine-at-f"),
                               duration_s=duration_s)


class PlainKernelVerdicts(SignatureVerifier):
    """The port's ``TorchSignatureVerifier(device="cpu")`` (the kernels'
    plain versions) behind a verdict table: ``triples`` go through it in
    one bulk dispatch up front, since a plain dispatch costs ~0.7 s whatever
    its lanes and a scenario flushes thousands of 1-lane windows.  A triple
    outside the table is dispatched when it is asked for and counted in
    ``misses``."""

    def __init__(self, committee, triples):
        self.kernels = TorchSignatureVerifier(
            committee_keys=committee.public_key_bytes(), device="cpu")
        triples = sorted(set(triples))
        verdicts = self.kernels.verify_signatures(*map(list, zip(*triples)))
        self.table = {t: bool(ok) for t, ok in zip(triples, verdicts)}
        self.misses = 0

    def verify_signatures(self, public_keys, digests, signatures):
        keys = [(bytes(p), bytes(d), bytes(s))
                for p, d, s in zip(public_keys, digests, signatures)]
        missing = sorted({k for k in keys if k not in self.table})
        if missing:
            self.misses += len(missing)
            verdicts = self.kernels.verify_signatures(*map(list, zip(*missing)))
            self.table.update((k, bool(ok)) for k, ok in zip(missing, verdicts))
        return [self.table[k] for k in keys]


def test_byzantine_at_f_document_equals_across_packages_and_verifiers(tmp_path, monkeypatch):
    """The JAX package's oracle document = the port's oracle document = the
    port's ``real_crypto`` document on ``device="cpu"``; the plain kernels
    give the oracle's verdict on every (key, digest, signature) the
    scenario presented, rejections included."""
    from mysticeti_tpu import scenarios as J

    jax_doc = J.run_scenario(_byzantine_at_f(J, 4.0), str(tmp_path / "jax"))

    asked = {}
    verify = scenarios.SimResignOracleVerifier.verify_signatures

    def recorded(self, public_keys, digests, signatures):
        out = verify(self, public_keys, digests, signatures)
        for p, d, s, ok in zip(public_keys, digests, signatures, out):
            asked[(bytes(p), bytes(d), bytes(s))] = ok
        return out

    monkeypatch.setattr(scenarios.SimResignOracleVerifier, "verify_signatures", recorded)
    scenario = _byzantine_at_f(scenarios, 4.0)
    oracle_doc = scenarios.run_scenario(scenario, str(tmp_path / "oracle"))
    monkeypatch.undo()
    assert oracle_doc == jax_doc
    assert oracle_doc["safety_ok"] and oracle_doc["committed_leaders"] > 0
    assert oracle_doc["attack_counts"]["invalid_sig:9"] > 0

    backend = PlainKernelVerdicts(Committee.new_for_benchmarks(10), asked)
    assert backend.table == asked
    assert sum(not ok for ok in asked.values()) > 0
    card_doc = scenarios.run_scenario(scenario, str(tmp_path / "plain"), real_crypto=True,
                                      backend=backend)
    assert card_doc == oracle_doc
    assert backend.misses == 0


def test_real_crypto_runs_every_collector_over_one_kernel_backend(monkeypatch):
    """``real_crypto`` makes one ``TorchSignatureVerifier`` on ``device``
    over the committee's keys, warms it, and gives every node (and every
    restart) its own collector at the oracle factory's window over it."""
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier

    made = []

    class Recording(TorchSignatureVerifier):
        def __init__(self, **kwargs):
            made.append(kwargs)
            self.warmed = False

        def warmup(self):
            self.warmed = True

    monkeypatch.setattr("mysticeti_tpu_torch.block_validator.TorchSignatureVerifier", Recording)
    committee = Committee.new_for_benchmarks(4)
    factory = scenarios.verifier_factory("cuda-only", committee, device="cpu")
    collectors = [factory(a, committee, None) for a in (0, 1, 1)]
    assert made == [{"committee_keys": committee.public_key_bytes(), "device": "cpu"}]
    oracle = scenarios.oracle_verifier_factory(4)(0, committee, None)
    for collector in collectors:
        assert isinstance(collector, BatchedSignatureVerifier)
        assert collector.verifier is collectors[0].verifier and collector.verifier.warmed
        assert collector.max_delay_s == oracle.max_delay_s == 0.002
        assert collector.max_batch == oracle.max_batch and not collector.aggregate
    with pytest.raises(ValueError, match="unknown verifier kind"):
        scenarios.verifier_factory("tpu", committee)


def test_real_crypto_is_the_accelerator_kind_and_one_kind_per_run(monkeypatch, tmp_path):
    """``real_crypto=True`` (the JAX signature's flag) reaches
    ``verifier_factory`` as ``cuda-only``, the default is the sim re-sign
    oracle, and naming two different kinds raises before a twin runs."""
    kinds = []

    def stop(kind, *args, **kwargs):
        kinds.append(kind)
        raise RuntimeError("stop")

    monkeypatch.setattr(scenarios, "verifier_factory", stop)
    scenario = _byzantine_at_f(scenarios, 1.0)
    for kwargs in ({}, {"real_crypto": True}, {"real_crypto": True, "verifier": "cuda-only"},
                   {"verifier": "cpu"}):
        with pytest.raises(RuntimeError, match="stop"):
            scenarios.run_scenario(scenario, str(tmp_path), **kwargs)
    assert kinds == ["sim-oracle", "cuda-only", "cuda-only", "cpu"]
    for run in (scenarios.run_scenario, scenarios.run_matrix):
        with pytest.raises(ValueError, match="real_crypto"):
            run([scenario] if run is scenarios.run_matrix else scenario, str(tmp_path),
                real_crypto=True, verifier="sim-oracle")
    assert len(kinds) == 4
