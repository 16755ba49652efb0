"""Whole runs at a tiny size on the CPU, through the same receive path with
the collector over the CPU oracle: a sound run comes out correct; the
control (``control.py``) and each fault planted under the timed path come
out not correct; without a card the command exits non-zero and prints no
result.  A test marked ``card`` runs a tiny cell on the card where there is
one."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import check, control, run
from perfbench.reference.blocks import identity

from conftest import ROOT

SEED = 2**31 + 17


def correct(out) -> bool:
    return all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_a_sound_run_is_correct_and_reports_its_counts(tiny_cell):
    out = run.run_cell(tiny_cell(), SEED, 1.0, False, kind="cpu")
    w = out["window"]
    assert correct(out), out["checks"]
    assert w.blocks and w.answered.all()
    assert (w.rec["outcome"] == check.REJECTED).sum() > 0  # forged blocks rejected
    assert w.counters["lanes_sum"] > 0
    assert out["run"].episodes and "lanes_short" in out["checks"]


def test_the_control_comes_out_not_correct(tiny_cell):
    cell = tiny_cell()
    out = run.run_cell(cell, SEED, 1.0, False, kind="accept", patch=control.patch_for(cell))
    assert not correct(out)
    assert out["checks"]["verdict_mismatch"]["value"] > 0


def test_every_forged_block_accepted_counts_however_few(tiny_cell, monkeypatch):
    """A kernel that accepts a forged signature in a few lanes is caught
    whether or not the sample of accepted blocks reaches them."""
    from perfbench import traffic, wire

    monkeypatch.setattr(check, "ACCEPT_SAMPLE", 0)

    cell = tiny_cell(backlog_rounds=12)
    keys = wire.committee_keys(5, 4)
    pool = traffic.build_pool(cell.config, cell.mix, 5, keys)
    r = run.Records()
    for i, raw in enumerate(pool.raws):
        a, rnd, d, s = identity(raw)
        r.answer(r.add(i, (a, rnd, d, s)), check.ACCEPTED if i < 3 or not pool.forged[i] else check.REJECTED, 1.0)
    forged_first = int(pool.forged[:3].sum())
    assert forged_first and pool.forged.sum() > forged_first
    checks = check.compare(pool, r.columns(), [], wire.public_bytes(keys), 0, SEED)
    assert checks["verdict_mismatch"]["value"] == forged_first


class _Faulty:
    """The collector's backend with a fault planted where it answers."""

    def __init__(self, backend, fault: str) -> None:
        self.backend, self.fault = backend, fault

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def verify_signatures_async(self, pks, digests, sigs):
        from mysticeti_tpu_torch.verify_pipeline import CompletedDispatch

        n = len(sigs)
        if self.fault == "unchanged":  # no work done: the state it started from
            return CompletedDispatch([True] * n)
        if self.fault == "half":  # half of the batch left out, answered as passed
            half = n // 2
            return CompletedDispatch(list(self.backend.verify_signatures(pks[:half], digests[:half], sigs[:half]))
                                     + [True] * (n - half))
        out = list(self.backend.verify_signatures(pks, digests, sigs))
        return CompletedDispatch([not ok for ok in out[:1]] + out[1:])  # an answer altered


def _plant(fault: str):
    def patch(rx) -> None:
        if fault == "digest":  # stage 1's answer altered where it is produced
            decode = rx._decode

            def altered(raws):
                t0, t1, out = decode(raws)
                if out and out[0] is not None:
                    out[0]._signed_digest = bytes(32)
                return t0, t1, out

            rx._decode = altered
        else:
            rx.verifier.verifier = _Faulty(rx.verifier.verifier, fault)

    return patch


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "digest"])
def test_each_planted_fault_comes_out_not_correct(tiny_cell, fault):
    out = run.run_cell(tiny_cell(), SEED, 1.0, False, kind="cpu", patch=_plant(fault))
    assert not correct(out), (fault, out["checks"])


def test_without_a_card_the_command_exits_nonzero_and_prints_no_result(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "c50-catchup", "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert "no CUDA device" in p.stderr
    assert p.stdout.strip() == ""


def test_identity_of_a_block_is_its_header_and_digests(tiny_cell):
    from perfbench import traffic, wire

    cell = tiny_cell()
    pool = traffic.build_pool(cell.config, cell.mix, 3, wire.committee_keys(3, 4))
    a, r, d, s = identity(pool.raws[0])
    assert (a, r) == (int(pool.author[0]), int(pool.round[0])) and d != s


@pytest.mark.card
def test_a_tiny_cell_is_correct_on_the_card(tiny_cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    run.setup_env()
    out = run.run_cell(tiny_cell(), SEED, 1.0, True)
    assert correct(out), out["checks"]
    line = run.result_line(tiny_cell(), out, True)
    assert line["device"]["busy_s"] > 0
    json.dumps(line)
