"""The port's perf-trend tool (``mysticeti_tpu_torch.tools.bench_trend``)
against the JAX package's: counterparts of ``tests/test_bench_trend.py``'s
nine cases, ``normalize`` equal to the JAX tool's over every root artifact
that ``ARTIFACT_GLOBS`` matches (read only), and the port's departures: the
default scan directory and index under ``build/``, and every appended
record carrying the card's name and power limit (none where there is no
card)."""
import glob
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mysticeti_tpu_torch.tools import BUILD_DIR  # noqa: E402
from mysticeti_tpu_torch.tools import bench_trend as port  # noqa: E402
from mysticeti_tpu_torch.tools.bench_trend import (  # noqa: E402
    append_artifact,
    load_index,
    main,
    merge_index,
    normalize,
    regression_report,
)
from tools import bench_trend as jax_tool  # noqa: E402

pytestmark = pytest.mark.tracing

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def append_record(record, path):
    return port.append_record(record, path=path, card=CARD)


def _write(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


# -- normalization across the r1-r5 schema drift -----------------------------


def test_normalize_bench_wrapper_and_null(tmp_path):
    ok = normalize(_write(tmp_path, "BENCH_r01.json", {
        "n": 1, "rc": 0,
        "parsed": {"metric": "ed25519_verifies_per_sec", "value": 46747.5,
                   "unit": "sig/s", "vs_baseline": 0.09},
    }))
    assert ok == [{
        "round": 1, "source": "BENCH_r01.json",
        "metric": "ed25519_verifies_per_sec", "value": 46747.5,
        "unit": "sig/s", "vs_baseline": 0.09,
    }]
    # parsed=null (a failed round) records the GAP, never silence.
    null = normalize(_write(tmp_path, "BENCH_r05.json",
                            {"n": 5, "rc": 1, "parsed": None}))
    assert null[0]["value"] is None and "parsed=null" in null[0]["note"]


def test_normalize_fleet_shapes(tmp_path):
    # Fleet metrics are namespaced by artifact FAMILY: a TPU-fleet peak
    # must never share a regression trajectory with a CPU search.
    flat = normalize(_write(tmp_path, "MAXLOAD_r02.json", {
        "metric": "max_sustainable_load_tx_s", "verifier": "cpu", "nodes": 4,
        "max_sustainable_load_tx_s": 12800, "peak_committed_tx_s": 9754.5,
    }))
    assert {r["metric"] for r in flat} == {
        "MAXLOAD.max_sustainable_load_tx_s", "MAXLOAD.peak_committed_tx_s"
    }
    nested = normalize(_write(tmp_path, "MAXLOAD_TPU_r03.json", {
        "fleet_runs": {
            "cpu_search": {"verifier": "cpu", "peak_committed_tx_s": 19614.1},
            "hybrid_fixed": {"verifier": "tpu", "committed_tx_s": 10826.7},
        },
    }))
    assert {r["metric"] for r in nested} == {
        "MAXLOAD_TPU.cpu_search.peak_committed_tx_s",
        "MAXLOAD_TPU.hybrid_fixed.committed_tx_s",
    }
    runs = normalize(_write(tmp_path, "TENNODE_r05.json", {
        "runs": [
            {"verifier": "cpu", "committed_tx_s": 1703.0},
            {"verifier": "cpu", "committed_tx_s": 1500.0},
        ],
    }))
    assert runs == [{
        "round": 5, "source": "TENNODE_r05.json",
        "metric": "TENNODE.committed_tx_s",
        "value": 1703.0, "unit": "tx/s", "verifier": "cpu", "nodes": None,
    }]
    tax = normalize(_write(tmp_path, "MAXLOAD_TAX_r06.json", {
        "tpu_over_cpu": 1.17, "cpu_peak_committed_tx_s": 3104.9,
        "tpu_peak_committed_tx_s": 3643.3,
    }))
    assert {r["metric"] for r in tax} == {
        "tpu_over_cpu", "cpu_peak_committed_tx_s", "tpu_peak_committed_tx_s"
    }
    samples = normalize(_write(tmp_path, "BENCH_SAMPLES_r02.json", {
        "samples_utc": [{"time": "10:30", "value": 300.0},
                        {"time": "18:00", "value": 100.0}],
    }))
    assert {(r["metric"], r["value"]) for r in samples} == {
        ("bench_samples_best", 300.0), ("bench_samples_worst", 100.0)
    }
    unknown = normalize(_write(tmp_path, "BENCH_weird_r07.json",
                               {"someday": "maybe"}))
    assert unknown[0]["metric"] == "unparsed"


# -- the regression gate -----------------------------------------------------


def test_regression_gate_exit_codes(tmp_path, capsys):
    _write(tmp_path, "BENCH_r01.json",
           {"parsed": {"metric": "m", "value": 100.0, "unit": "u"}})
    _write(tmp_path, "BENCH_r02.json",
           {"parsed": {"metric": "m", "value": 95.0, "unit": "u"}})
    out = str(tmp_path / "BENCH_TREND.json")
    # 5% down: within the 10% tolerance.
    assert main(["--repo", str(tmp_path), "--out", out]) == 0
    report = capsys.readouterr().out
    assert "-5.0% vs best prior" in report
    # A >10% drop in a NEW round fails the gate.
    _write(tmp_path, "BENCH_r03.json",
           {"parsed": {"metric": "m", "value": 80.0, "unit": "u"}})
    assert main(["--repo", str(tmp_path), "--out", out]) == 2
    assert "REGRESSIONS" in capsys.readouterr().out


def test_index_is_append_only_and_idempotent(tmp_path):
    _write(tmp_path, "BENCH_r01.json",
           {"parsed": {"metric": "m", "value": 10.0, "unit": "u"}})
    out = str(tmp_path / "BENCH_TREND.json")
    main(["--repo", str(tmp_path), "--out", out])
    first = load_index(out)
    main(["--repo", str(tmp_path), "--out", out])
    second = load_index(out)
    assert first["records"] == second["records"]  # re-scan adds nothing
    # A live append survives the next artifact scan.
    append_record({"metric": "m", "value": 11.0, "unit": "u"}, path=out)
    main(["--repo", str(tmp_path), "--out", out])
    kinds = [(r["source"], r.get("seq")) for r in load_index(out)["records"]]
    assert ("bench.py(live)", 1) in kinds
    assert [r["card"] for r in load_index(out)["records"] if r["source"] == "bench.py(live)"] == [
        CARD]
    # A second live run is a DISTINCT record (seq bumps), not a dedup hit.
    append_record({"metric": "m", "value": 12.0, "unit": "u"}, path=out)
    assert ("bench.py(live)", 2) in [
        (r["source"], r.get("seq")) for r in load_index(out)["records"]
    ]


def test_live_records_shown_but_never_gate():
    records = [
        {"round": None, "source": "bench.py(live)", "metric": "m",
         "value": 50.0, "unit": "u", "seq": 1},
        {"round": 2, "source": "BENCH_r02.json", "metric": "m",
         "value": 200.0, "unit": "u"},
        {"round": 1, "source": "BENCH_r01.json", "metric": "m",
         "value": 100.0, "unit": "u"},
    ]
    lines, regressions = regression_report(records, 0.10)
    text = "\n".join(lines)
    assert text.index("r01") < text.index("r02") < text.index("live#1")
    # The low live record rides the report but must NOT gate (a laptop run
    # or a documented zero-record would flip CI red otherwise): the newest
    # ROUND (r02) is the best round, so no regression.
    assert regressions == []
    # A genuinely regressed ROUND still gates with live noise present.
    records.append({"round": 3, "source": "BENCH_r03.json", "metric": "m",
                    "value": 60.0, "unit": "u"})
    _lines, regressions = regression_report(records, 0.10)
    assert regressions and "BENCH_r03.json" in regressions[0]


def test_merge_dedups_by_key():
    index = {"records": [{"source": "a", "metric": "m", "value": 1.0}]}
    added = merge_index(index, [
        {"source": "a", "metric": "m", "value": 1.0},
        {"source": "a", "metric": "n", "value": 2.0},
    ])
    assert added == 1 and len(index["records"]) == 2


# -- acceptance: the real repo artifacts parse -------------------------------


def test_repo_artifacts_yield_nonempty_trajectory(capsys):
    """The port's tool over the root's rounds (``--repo``, report only)
    emits a non-empty trajectory with at least 5 rounds parsed."""
    main(["--repo", REPO, "--no-write"])
    out = capsys.readouterr().out
    header = out.splitlines()[0]
    assert "bench trend:" in header
    rounds = int(header.split("record(s),")[1].split("metric(s),")[1]
                 .split("round(s)")[0].strip())
    assert rounds >= 5, header


# -- SCENARIO family (the resilience matrix) ---------------------------------


def _scenario_doc(passed_map, determinism=True):
    return {
        "metric": "scenario_matrix",
        "scenarios": [
            {
                "scenario": {"name": name, "min_ratio": 0.8},
                "passed": ok,
                "throughput_ratio": 0.84 if ok else 0.41,
                "safety_ok": True,
            }
            for name, ok in passed_map.items()
        ],
        "determinism": (
            {"scenario": "byzantine-at-f", "byte_identical": True}
            if determinism
            else {}
        ),
    }


def test_normalize_scenario_matrix(tmp_path):
    records = normalize(_write(tmp_path, "SCENARIO_r12.json", _scenario_doc(
        {"byzantine-at-f": True, "wan-geo-profile": True}
    )))
    by_metric = {r["metric"]: r for r in records}
    row = by_metric["SCENARIO.byzantine-at-f.passed"]
    assert row["value"] == 1.0 and row["unit"] == "pass"
    assert row["ratio"] == 0.84 and row["min_ratio"] == 0.8
    assert by_metric["SCENARIO.determinism_byte_identical"]["value"] == 1.0
    # A failing scenario scores 0.0 — a pass->fail flip between rounds is
    # a 100% drop, exactly what the generic gate fires on.
    failed = normalize(_write(tmp_path, "SCENARIO_r13.json", _scenario_doc(
        {"byzantine-at-f": False}, determinism=False
    )))
    assert failed[0]["metric"] == "SCENARIO.byzantine-at-f.passed"
    assert failed[0]["value"] == 0.0


def test_scenario_pass_fail_flip_gates(tmp_path, capsys):
    _write(tmp_path, "SCENARIO_r12.json",
           _scenario_doc({"byzantine-at-f": True}, determinism=False))
    assert main(["--repo", str(tmp_path)]) == 0
    capsys.readouterr()
    _write(tmp_path, "SCENARIO_r13.json",
           _scenario_doc({"byzantine-at-f": False}, determinism=False))
    assert main(["--repo", str(tmp_path)]) == 2
    out = capsys.readouterr().out
    assert "SCENARIO.byzantine-at-f.passed" in out
    # Ratio noise between PASSING rounds never gates: the scored value is
    # the verdict, the ratio only context.


# -- against the JAX tool, and the port's departures -------------------------

ROOT_ARTIFACTS = sorted(
    os.path.basename(p)
    for pattern in jax_tool.ARTIFACT_GLOBS
    for p in glob.glob(os.path.join(REPO, pattern))
)


def test_the_artifact_families_are_the_jax_tools():
    assert port.ARTIFACT_GLOBS == jax_tool.ARTIFACT_GLOBS
    assert port.DEFAULT_TOLERANCE == jax_tool.DEFAULT_TOLERANCE
    assert len(ROOT_ARTIFACTS) >= 20


@pytest.mark.parametrize("name", ROOT_ARTIFACTS)
def test_normalize_equals_the_jax_tools_on_every_root_artifact(name):
    path = os.path.join(REPO, name)
    assert normalize(path) == jax_tool.normalize(path)


def test_report_equals_the_jax_tools_over_the_root_rounds():
    records = [rec for name in ROOT_ARTIFACTS for rec in normalize(os.path.join(REPO, name))]
    assert regression_report(records, 0.1) == jax_tool.regression_report(records, 0.1)


def test_default_scan_and_index_lie_under_build(monkeypatch, tmp_path):
    monkeypatch.delenv("BENCH_TREND_PATH", raising=False)
    assert port.DEFAULT_INDEX == os.path.join(BUILD_DIR, "BENCH_TREND.json")
    assert port._index_path(None) == port.DEFAULT_INDEX
    monkeypatch.setenv("BENCH_TREND_PATH", str(tmp_path / "i.json"))
    assert port._index_path(None) == str(tmp_path / "i.json")


def test_no_card_no_append(monkeypatch, tmp_path):
    """The port's index holds only the card's records: off a card's
    machine an append is skipped, and nothing is written."""
    monkeypatch.setattr(port, "card_line", lambda: None)
    out = str(tmp_path / "BENCH_TREND.json")
    assert port.append_record({"metric": "m", "value": 1.0, "unit": "u"}, path=out) is False
    artifact = _write(tmp_path, "DETSAN_r01.json", {"metric": "detsan", "clean": {
        "identical": True}})
    assert append_artifact(artifact, path=out) == 0
    assert not os.path.exists(out)
    monkeypatch.setattr(port, "card_line", lambda: CARD)
    assert port.append_record({"metric": "m", "value": 1.0, "unit": "u"}, path=out) is True


def test_append_artifact_tags_every_record_with_the_card(tmp_path):
    artifact = _write(tmp_path, "DETSAN_r03.json", {
        "metric": "detsan", "clean": {"identical": True, "events_a": 10},
        "planted": {"identical": False, "first_divergence": {"index": 4}},
        "fixtures": {"a": True}, "tripwire": {"strict_mode_raised": True}})
    out = str(tmp_path / "index" / "BENCH_TREND.json")
    assert append_artifact(artifact, path=out, card=CARD) == 4
    records = load_index(out)["records"]
    assert [dict(r, card=None) for r in records] == [
        dict(r, card=None) for r in jax_tool.normalize(artifact)]
    assert {r["card"] for r in records} == {CARD}
    # Folding the same artifact again adds nothing (append-only, dedup).
    assert append_artifact(artifact, path=out, card=CARD) == 0
