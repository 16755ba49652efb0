"""The port bench's recovery ladder and record (``mysticeti_tpu_torch.bench``),
counterparts of ``tests/test_bench_ladder.py``: the parsed zero record on a
total failure, budget-skipped rungs recorded, and the healthy record's
compact shape.  The JAX bench's CPU-rung case has no counterpart: the
port's ladder has card rungs only.  Also the under-target accounting
(``tools.bench_probe`` in a child, attached to the record) and the live
append to the trend index with the card's name and power limit."""
import json
import subprocess

import pytest
import torch

from mysticeti_tpu_torch import bench
from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.ops import ed25519_cuda as K
from mysticeti_tpu_torch.tools import bench_trend

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture()
def card_bench(monkeypatch):
    """``bench.main`` past its card check: the ladder's rungs are faked by
    each test, nothing is built and nothing reaches a card."""
    monkeypatch.setattr(E, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(K, "build_all", lambda: None)
    monkeypatch.setattr(bench, "card_line", lambda: CARD)
    monkeypatch.setenv("BENCH_ACCOUNTING", "0")
    # Ladder tests must not append their synthetic measurements to the
    # port's trend index.
    monkeypatch.setenv("BENCH_TREND", "0")
    monkeypatch.delenv("BENCH_WORKER", raising=False)
    monkeypatch.delenv("BENCH_PROCS", raising=False)
    monkeypatch.delenv("BENCH_LADDER_BUDGET_S", raising=False)
    return bench


def _parse_record(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert out, "bench printed no record"
    return json.loads(out[-1])


def test_total_failure_still_emits_parsed_zero_record(card_bench, monkeypatch, capsys):
    def always_fails(*args, **kwargs):
        raise RuntimeError("nothing works")

    monkeypatch.setattr(card_bench, "_multi_process", always_fails)
    with pytest.raises(RuntimeError, match="nothing works"):
        card_bench.main()
    record = _parse_record(capsys)
    assert record["value"] == 0.0
    assert record["backend"] == "none"
    assert [r["ok"] for r in record["rungs"]] == [False, False, False]
    assert {r["backend"] for r in record["rungs"]} == {"cuda"}


def test_budget_skipped_rungs_are_recorded(card_bench, monkeypatch, capsys):
    """An exhausted ladder budget skips every rung after the first (there
    is no CPU rung to fall back to), each skip leaving per-rung evidence,
    and the run ends in the parsed zero record."""
    monkeypatch.setenv("BENCH_LADDER_BUDGET_S", "0")
    calls = []

    def fake_multi(batch, iters, trials, procs, ready_timeout_s, stall_timeout_s):
        calls.append(procs)
        raise RuntimeError("card unreachable: wedged context")

    monkeypatch.setattr(card_bench, "_multi_process", fake_multi)
    with pytest.raises(RuntimeError, match="wedged context"):
        card_bench.main()
    record = _parse_record(capsys)
    assert calls == [4]
    assert record["value"] == 0.0 and record["backend"] == "none"
    assert [r.get("skipped", False) for r in record["rungs"]] == [False, True, True]
    assert all(r["error"] == "ladder budget exhausted"
               for r in record["rungs"] if r.get("skipped"))


def test_first_rung_success_keeps_the_healthy_record_shape(card_bench, monkeypatch, capsys):
    monkeypatch.setattr(card_bench, "_multi_process", lambda *a, **k: 600000.0)
    card_bench.main()
    record = _parse_record(capsys)
    assert record == {"metric": "ed25519_verifies_per_sec", "value": 600000.0,
                      "unit": "sig/s", "vs_baseline": 1.2, "rung": 0, "procs": 4,
                      "batch": 16384, "backend": "cuda"}


PROBE = {"device": "NVIDIA H100 80GB HBM3", "null_rtt_ms": 0.05, "h2d_MBps": 4000.0,
         "kernel_ms_per_batch": 0.6, "kernel_only_sig_s": 2.7e7, "blob_bytes_per_batch": 1,
         "e2e_sig_s_16iters": 1.2e6, "e2e_ms_per_batch": 13.0}


def test_under_target_attaches_the_probes_accounting(card_bench, monkeypatch, capsys):
    monkeypatch.delenv("BENCH_ACCOUNTING")
    monkeypatch.setattr(card_bench, "_multi_process", lambda *a, **k: 400000.0)
    probes = []

    def fake_run(cmd, **kwargs):
        probes.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps(PROBE) + "\n", stderr="")

    monkeypatch.setattr(card_bench.subprocess, "run", fake_run)
    card_bench.main()
    record = _parse_record(capsys)
    assert probes and probes[0][1:] == ["-m", "mysticeti_tpu_torch.tools.bench_probe"]
    acct = record["accounting"]
    assert {k: acct[k] for k in PROBE} == PROBE
    assert acct["wire_ceiling_sig_s_at_100B"] == 4000.0 * 1e6 / 100.0
    assert acct["measured_fraction_of_wire_ceiling"] == 400000.0 / 4e7
    assert record["value"] == 400000.0 and record["rung"] == 0


def test_a_failed_probe_is_recorded_not_fatal(card_bench, monkeypatch, capsys):
    monkeypatch.delenv("BENCH_ACCOUNTING")
    monkeypatch.setattr(card_bench, "_multi_process", lambda *a, **k: 400000.0)
    monkeypatch.setattr(card_bench.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 1, stdout="", stderr="RuntimeError: no CUDA device"))
    card_bench.main()
    record = _parse_record(capsys)
    assert record["value"] == 400000.0
    assert record["accounting"]["error"].startswith("probe exited 1")


def test_the_live_record_lands_in_the_trend_index(card_bench, monkeypatch, capsys, tmp_path):
    index = str(tmp_path / "BENCH_TREND.json")
    monkeypatch.delenv("BENCH_TREND")
    monkeypatch.setenv("BENCH_TREND_PATH", index)
    monkeypatch.setattr(bench_trend, "card_line", lambda: CARD)
    monkeypatch.setattr(card_bench, "_multi_process", lambda *a, **k: 600000.0)
    card_bench.main()
    card_bench.main()
    records = bench_trend.load_index(index)["records"]
    assert [(r["source"], r["seq"], r["value"], r["card"]) for r in records] == [
        ("bench.py(live)", 1, 600000.0, CARD), ("bench.py(live)", 2, 600000.0, CARD)]
    assert capsys.readouterr().out.count("ed25519_verifies_per_sec") == 2
