"""Perf-trend plane: normalize every bench artifact into one trajectory.

The port's copy of the JAX package's ``tools/bench_trend.py``: the same
``normalize`` (every artifact family and schema of the JAX package's
rounds), ``merge_index``, ``append_record``, ``regression_report`` and
``main``, with the same exit code 2 on a regression.  This tool:

* **normalizes** every ``BENCH_*.json`` / ``MAXLOAD_*`` / ``TENNODE_*`` ...
  artifact (tolerating the JAX rounds' r1-r5 schema drift and
  ``parsed: null`` records) into flat ``{round, source, metric, value,
  unit}`` records;
* maintains the **append-only** trend index (records are deduplicated by
  (source, metric, seq); re-running over the same artifacts is idempotent,
  new artifacts and live bench appends accumulate);
* prints the **terminal regression report** — per metric, the value by
  round with the delta vs the best prior round — and exits **non-zero
  (2) when the newest round of any metric regressed >10%** vs the best
  prior round;
* takes the live appends: ``python -m mysticeti_tpu_torch.bench``
  (:func:`append_record`), ``tools.perf_attr`` and ``tools.detsan
  --append-trend`` (:func:`append_artifact`).

Where it reads and writes differs from the JAX tool: the repository root
holds the JAX package's TPU-era rounds, and the port's trajectory holds only
the card's numbers.  So the default scan directory is the checkout's
``build/`` and the default index ``build/BENCH_TREND.json`` (``--repo`` /
``--out`` point anywhere, e.g. at the root's rounds with ``--no-write``),
and every record the port appends carries ``card``, ``nvidia-smi``'s name
and power limit of the card it was measured on; an append made where there
is no card is skipped.  A scanned artifact that names its card (the port's
fleet benches write ``card``) passes it to each of its records.

Usage:
    python -m mysticeti_tpu_torch.tools.bench_trend            # scan build/, update its index, report
    python -m mysticeti_tpu_torch.tools.bench_trend --repo /path --out /path/BENCH_TREND.json
    python -m mysticeti_tpu_torch.tools.bench_trend --no-write # report only
    python -m mysticeti_tpu_torch.tools.bench_trend --tolerance 0.2
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from mysticeti_tpu_torch.tools import BUILD_DIR, build_path, card as card_line

_ROUND_RE = re.compile(r"_r(\d+)\.json$")

ARTIFACT_GLOBS = (
    "BENCH_*.json", "MAXLOAD_*.json", "TENNODE_*.json", "OVERLOAD_*.json",
    "SCENARIO_*.json", "PERF_ATTR_*.json", "DETSAN_*.json",
    "FINALITY_*.json", "RECONFIG_*.json", "EXEC_*.json",
)

# >10% below the best prior round fails the gate.
DEFAULT_TOLERANCE = 0.10

INDEX_NAME = "BENCH_TREND.json"
DEFAULT_INDEX = build_path(INDEX_NAME)


def _record(round_, source, metric, value, unit, **extra) -> dict:
    rec = {
        "round": round_,
        "source": source,
        "metric": metric,
        "value": None if value is None else round(float(value), 3),
        "unit": unit,
    }
    rec.update(extra)
    return rec


def normalize(path: str) -> List[dict]:
    """Flatten one artifact into trend records.  Unknown shapes yield an
    unparsed marker record rather than nothing — the trajectory must show
    that a round produced an artifact even when it cannot score it."""
    source = os.path.basename(path)
    match = _ROUND_RE.search(source)
    round_ = int(match.group(1)) if match else None
    # The artifact FAMILY (MAXLOAD vs MAXLOAD_TPU vs TENNODE ...) namespaces
    # the fleet metrics: different families measure different
    # configurations, and comparing e.g. a TPU-fleet peak against a CPU
    # search would make the regression gate fire on configuration
    # differences instead of regressions.
    family = re.sub(r"_r\d+\.json$", "", source)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as exc:
        return [_record(round_, source, "unparsed", None, "",
                        note=f"unreadable: {exc}")]
    if not isinstance(doc, dict):
        return [_record(round_, source, "unparsed", None, "",
                        note="unrecognized shape")]
    out: List[dict] = []

    # BENCH_rNN: a round's wrapper {n, cmd, rc, tail, parsed: {...}|null}.
    if "parsed" in doc:
        parsed = doc.get("parsed")
        if isinstance(parsed, dict) and parsed.get("value") is not None:
            out.append(_record(
                round_, source, parsed.get("metric", "bench"),
                parsed["value"], parsed.get("unit", ""),
                vs_baseline=parsed.get("vs_baseline"),
            ))
        else:
            # parsed=null: the round ran and failed — record the failure so
            # the trajectory shows the gap instead of silently skipping it.
            out.append(_record(
                round_, source, "ed25519_verifies_per_sec", None, "sig/s",
                note=f"parsed=null (rc={doc.get('rc')})",
            ))
        return out

    # bench.py direct record (also what append_record receives).
    if doc.get("metric") == "ed25519_verifies_per_sec" and "value" in doc:
        out.append(_record(round_, source, doc["metric"], doc["value"],
                           doc.get("unit", "sig/s"),
                           vs_baseline=doc.get("vs_baseline")))
        return out

    # BENCH_SAMPLES_rNN: all-day samples; score the round by its best and
    # worst sample (the spread IS the story there).
    samples = doc.get("samples_utc")
    if isinstance(samples, list) and samples:
        values = [s.get("value") for s in samples if s.get("value") is not None]
        if values:
            out.append(_record(round_, source, "bench_samples_best",
                               max(values), "sig/s", samples=len(values)))
            out.append(_record(round_, source, "bench_samples_worst",
                               min(values), "sig/s", samples=len(values)))
        return out

    def fleet_run(rec: dict, prefix: str) -> None:
        """One orchestrator fleet-run blob, wherever it is nested."""
        for key, metric in (
            ("max_sustainable_load_tx_s", "max_sustainable_load_tx_s"),
            ("peak_committed_tx_s", "peak_committed_tx_s"),
            ("committed_tx_s", "committed_tx_s"),
        ):
            if rec.get(key) is not None:
                out.append(_record(
                    round_, source, f"{prefix}{metric}", rec[key], "tx/s",
                    verifier=rec.get("verifier"), nodes=rec.get("nodes"),
                ))

    # OVERLOAD: per-multiplier committed-vs-offered rungs + the no-collapse
    # ratios.  Its own family: the rungs measure degradation shape, and a
    # ratio near 1.0 is the win — gating it against MAXLOAD peaks would
    # compare different metrics.
    if doc.get("metric") == "overload_committed_vs_offered":
        for rung in doc.get("rungs") or []:
            mult = rung.get("multiplier")
            if mult is None or rung.get("committed_tx_s") is None:
                continue
            out.append(_record(
                round_, source, f"{family}.committed_tx_s_{mult}x",
                rung["committed_tx_s"], "tx/s",
                offered=rung.get("offered_tx_s"), nodes=doc.get("nodes"),
            ))
        acceptance = doc.get("acceptance") or {}
        for key in ("committed_3x_over_1x", "committed_5x_over_1x",
                    "sim_committed_3x_over_1x"):
            value = acceptance.get(key)
            if value is None:
                value = (doc.get("determinism") or {}).get(key)
            if value is not None:
                out.append(_record(round_, source, f"{family}.{key}", value,
                                   "ratio"))
        if out:
            return out
        return [_record(round_, source, "unparsed", None, "",
                        note="overload artifact with no scored rungs")]

    # SCENARIO: the resilience matrix (tools/scenario_matrix.py).  One
    # verdict row per scenario; the SCORED value is pass (1.0) / fail
    # (0.0), so the generic gate fires exactly when a scenario FLIPS from
    # pass to fail (a 100% drop) and never on throughput-ratio noise
    # between passing rounds — the ratio rides along as context.
    if doc.get("metric") == "scenario_matrix":
        for verdict in doc.get("scenarios") or []:
            scenario = (verdict.get("scenario") or {}).get("name")
            if not scenario:
                continue
            out.append(_record(
                round_, source, f"{family}.{scenario}.passed",
                1.0 if verdict.get("passed") else 0.0, "pass",
                ratio=verdict.get("throughput_ratio"),
                min_ratio=(verdict.get("scenario") or {}).get("min_ratio"),
                safety_ok=verdict.get("safety_ok"),
            ))
        determinism = doc.get("determinism") or {}
        if determinism.get("byte_identical") is not None:
            out.append(_record(
                round_, source, f"{family}.determinism_byte_identical",
                1.0 if determinism["byte_identical"] else 0.0, "pass",
                scenario=determinism.get("scenario"),
            ))
        if out:
            return out
        return [_record(round_, source, "unparsed", None, "",
                        note="scenario artifact with no verdicts")]

    # RECONFIG: the continuous-churn epoch-reconfiguration matrix
    # (tools/reconfig_matrix.py).  Verdict rows score pass (1.0) / fail
    # (0.0) like the scenario matrix — the generic gate fires exactly when
    # a churn scenario FLIPS from pass to fail; epochs reached and the
    # throughput ratio ride along as context.  The live-testbed epoch
    # cycle (one add-node + one remove-node epoch under load) and the
    # same-seed byte-identity check score the same way.
    if doc.get("metric") == "reconfig":
        for verdict in doc.get("scenarios") or []:
            scenario = (verdict.get("scenario") or {}).get("name")
            if not scenario:
                continue
            out.append(_record(
                round_, source, f"{family}.{scenario}.passed",
                1.0 if verdict.get("passed") else 0.0, "pass",
                ratio=verdict.get("throughput_ratio"),
                max_epoch=verdict.get("max_epoch"),
                min_epoch=verdict.get("min_epoch"),
                safety_ok=verdict.get("safety_ok"),
            ))
        determinism = doc.get("determinism") or {}
        if determinism.get("byte_identical") is not None:
            out.append(_record(
                round_, source, f"{family}.determinism_byte_identical",
                1.0 if determinism["byte_identical"] else 0.0, "pass",
                scenario=determinism.get("scenario"),
            ))
        live = doc.get("live") or {}
        if live.get("passed") is not None:
            out.append(_record(
                round_, source, f"{family}.live_epoch_cycle",
                1.0 if live["passed"] else 0.0, "pass",
                nodes=live.get("nodes"), epochs=live.get("epochs_reached"),
            ))
        if out:
            return out
        return [_record(round_, source, "unparsed", None, "",
                        note="reconfig artifact with no verdicts")]

    # DETSAN: the determinism-sanitizer verdict (tools/detsan.py).  Every
    # scored value is pass (1.0) / fail (0.0), so the generic gate fires
    # exactly when a determinism property FLIPS — the clean run-twice sim
    # stops being byte-identical, the bisector stops catching the planted
    # leak, or a historical-fixture detection regresses.
    if doc.get("metric") == "detsan":
        clean = doc.get("clean") or {}
        planted = doc.get("planted") or {}
        if clean.get("identical") is not None:
            out.append(_record(
                round_, source, f"{family}.clean_identical",
                1.0 if clean["identical"] else 0.0, "pass",
                events=clean.get("events_a"), nodes=doc.get("nodes"),
            ))
        if planted.get("identical") is not None:
            detected = (
                not planted["identical"]
                and planted.get("first_divergence") is not None
            )
            out.append(_record(
                round_, source, f"{family}.planted_leak_bisected",
                1.0 if detected else 0.0, "pass",
                first_divergence_index=(
                    (planted.get("first_divergence") or {}).get("index")
                ),
            ))
        for name, detected in sorted((doc.get("fixtures") or {}).items()):
            out.append(_record(
                round_, source, f"{family}.fixture_{name}_detected",
                1.0 if detected else 0.0, "pass",
            ))
        tripwire = doc.get("tripwire") or {}
        if tripwire.get("strict_mode_raised") is not None:
            out.append(_record(
                round_, source, f"{family}.tripwire_strict_raises",
                1.0 if tripwire["strict_mode_raised"] else 0.0, "pass",
                counted_reads=tripwire.get("counted_reads"),
            ))
        if out:
            return out
        return [_record(round_, source, "unparsed", None, "",
                        note="detsan artifact with no verdicts")]

    # FINALITY: the submit→finality SLI artifact (tools/finality_bench.py).
    # Latency is lower-is-better, so the SCORED value is its inverse
    # (finalizations per second at the percentile) — the generic
    # higher-is-better gate then fires exactly when p50/p99 finality gets
    # >tolerance SLOWER; the raw seconds ride along as context.  The
    # decision-ledger and server/client cross-check verdicts score as
    # pass (1.0) / fail (0.0) like the scenario matrix.
    if doc.get("metric") == "finality":
        server = doc.get("server") or {}
        for pct in ("p50", "p99"):
            seconds = server.get(f"{pct}_s")
            if seconds and seconds > 0:
                out.append(_record(
                    round_, source, f"{family}.finality_{pct}_inv",
                    1.0 / seconds, "1/s",
                    seconds=round(float(seconds), 6),
                    samples=server.get("samples"), nodes=doc.get("nodes"),
                ))
        acceptance = doc.get("acceptance") or {}
        for key in ("client_cross_check", "every_slot_explained"):
            if acceptance.get(key) is not None:
                out.append(_record(round_, source, f"{family}.{key}",
                                   1.0 if acceptance[key] else 0.0, "pass"))
        determinism = doc.get("determinism") or {}
        if determinism.get("byte_identical") is not None:
            out.append(_record(
                round_, source, f"{family}.ledger_byte_identical",
                1.0 if determinism["byte_identical"] else 0.0, "pass",
                digest=determinism.get("digest"),
            ))
        if out:
            return out
        return [_record(round_, source, "unparsed", None, "",
                        note="finality artifact with no scored percentiles")]

    # EXEC: the execution-plane artifact (tools/execution_bench.py).
    # Executed tx/s scores on the generic higher-is-better gate; every
    # agreement/determinism verdict scores pass (1.0) / fail (0.0), so the
    # gate fires exactly when state-root agreement or same-seed
    # reproducibility FLIPS.
    if doc.get("metric") == "execution":
        fleet = doc.get("fleet") or {}
        sim = doc.get("sim") or {}
        if fleet.get("executed_tx_s"):
            out.append(_record(
                round_, source, f"{family}.executed_tx_s",
                fleet["executed_tx_s"], "tx/s",
                nodes=doc.get("nodes"),
                executed_height_max=fleet.get("executed_height_max"),
            ))
        acceptance = doc.get("acceptance") or {}
        for key in ("fleet_roots_agree", "sim_passed", "sim_execution_ok"):
            if acceptance.get(key) is not None:
                out.append(_record(round_, source, f"{family}.{key}",
                                   1.0 if acceptance[key] else 0.0, "pass"))
        determinism = doc.get("determinism") or {}
        if determinism.get("byte_identical") is not None:
            out.append(_record(
                round_, source, f"{family}.root_chain_byte_identical",
                1.0 if determinism["byte_identical"] else 0.0, "pass",
                digest=determinism.get("root_chain_digest"),
            ))
        if out:
            return out
        return [_record(round_, source, "unparsed", None, "",
                        note="execution artifact with no verdicts")]

    # PERF_ATTR: the host attribution artifact (tools/perf_attr.py).  One
    # budget row per subsystem, scored as committed leaders per CPU-second
    # (HIGHER is better — the gate's direction), so any subsystem whose
    # per-leader cost creeps >tolerance fires the generic gate; the raw
    # µs/leader rides along as context.  attributed_ratio gates too: an
    # attribution map decaying toward "other" is itself a regression.
    if doc.get("metric") == "perf_attr":
        for sub, rec in sorted((doc.get("subsystems") or {}).items()):
            us = rec.get("us_per_leader") if isinstance(rec, dict) else None
            if not us or us <= 0:
                continue
            out.append(_record(
                round_, source, f"{family}.{sub}.leaders_per_cpu_s",
                1e6 / us, "ldr/cpu-s",
                us_per_leader=round(float(us), 3), cpu_s=rec.get("cpu_s"),
                nodes=doc.get("nodes"),
            ))
        if doc.get("attributed_ratio") is not None:
            out.append(_record(
                round_, source, f"{family}.attributed_ratio",
                doc["attributed_ratio"], "ratio",
            ))
        if out:
            return out
        return [_record(round_, source, "unparsed", None, "",
                        note="perf_attr artifact with no subsystem rows")]

    # MAXLOAD_TAX: same-window A/B.
    if "tpu_over_cpu" in doc:
        for key, unit in (
            ("cpu_peak_committed_tx_s", "tx/s"),
            ("tpu_peak_committed_tx_s", "tx/s"),
            ("tpu_over_cpu", "ratio"),
        ):
            if doc.get(key) is not None:
                out.append(_record(round_, source, key, doc[key], unit))
        return out

    # MAXLOAD_TPU: nested fleet_runs {name: run}.
    if isinstance(doc.get("fleet_runs"), dict):
        for name, rec in sorted(doc["fleet_runs"].items()):
            if isinstance(rec, dict):
                fleet_run(rec, f"{family}.{name}.")
        return out

    # TENNODE_r05-style: runs list — score the best committed rate.
    if isinstance(doc.get("runs"), list) and doc["runs"]:
        best = max(
            (r for r in doc["runs"] if isinstance(r, dict)),
            key=lambda r: r.get("committed_tx_s") or 0.0,
            default=None,
        )
        if best is not None:
            fleet_run(best, f"{family}.")
        return out

    # Flat orchestrator record (MAXLOAD_r02, TENNODE_r02).
    fleet_run(doc, f"{family}.")
    if out:
        return out
    return [_record(round_, source, "unparsed", None, "",
                    note="unrecognized shape")]


# ---------------------------------------------------------------------------
# The append-only index


def load_index(path: str) -> dict:
    try:
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and isinstance(doc.get("records"), list):
            return doc
    except (OSError, ValueError):
        pass
    return {"kind": "mysticeti-bench-trend", "records": []}


def _key(rec: dict) -> tuple:
    return (rec.get("source"), rec.get("metric"), rec.get("seq"))


def merge_index(index: dict, fresh: List[dict]) -> int:
    """Append records not already present (append-only: existing entries are
    never rewritten, so live bench.py appends survive re-scans)."""
    seen = {_key(r) for r in index["records"]}
    added = 0
    for rec in fresh:
        if _key(rec) in seen:
            continue
        index["records"].append(rec)
        seen.add(_key(rec))
        added += 1
    return added


def write_index(index: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _index_path(path: Optional[str]) -> str:
    return path or os.environ.get("BENCH_TREND_PATH", DEFAULT_INDEX)


def append_record(record: dict, path: Optional[str] = None,
                  card: Optional[str] = None) -> bool:
    """Live append from the bench: one measurement lands in the trend index
    the moment it is produced (``seq`` makes repeated live runs distinct
    where artifact records dedup by (source, metric)), with ``card`` (this
    machine's, by default).  Skipped (False) where there is no card.  Never
    raises — the trend plane must not be able to break a measurement."""
    try:
        card = card or card_line()
        if card is None:
            return False
        path = _index_path(path)
        index = load_index(path)
        seq = 1 + sum(
            1 for r in index["records"] if r.get("source") == "bench.py(live)"
        )
        rec = _record(
            None, "bench.py(live)", record.get("metric", "bench"),
            record.get("value"), record.get("unit", ""),
            vs_baseline=record.get("vs_baseline"), seq=seq, card=card,
        )
        index["records"].append(rec)
        write_index(index, path)
        return True
    except Exception:  # noqa: BLE001 - diagnostics only, never fail the bench
        return False


def append_artifact(artifact: str, path: Optional[str] = None,
                    card: Optional[str] = None) -> int:
    """Fold one artifact a port tool just wrote into the trend index: its
    ``normalize`` records, each with ``card`` (this machine's, by default),
    merged append-only.  Returns the records added; 0 where there is no
    card (the index holds only the card's records)."""
    card = card or card_line()
    if card is None:
        return 0
    path = _index_path(path)
    index = load_index(path)
    added = merge_index(index, [dict(rec, card=card) for rec in normalize(artifact)])
    write_index(index, path)
    return added


# ---------------------------------------------------------------------------
# The regression report


def trajectory(records: List[dict]) -> Dict[str, List[dict]]:
    """Per metric: the scored records in round order (unscored dropped)."""
    by_metric: Dict[str, List[dict]] = defaultdict(list)
    for rec in records:
        if rec.get("value") is None:
            continue
        by_metric[rec["metric"]].append(rec)
    for recs in by_metric.values():
        recs.sort(key=lambda r: (
            r["round"] if r.get("round") is not None else 1 << 30,
            r.get("seq") or 0,
            r["source"],
        ))
    return dict(by_metric)


def regression_report(records: List[dict], tolerance: float):
    """Returns (lines, regressions): per-metric round-by-round values with
    the delta vs the best PRIOR round; a metric whose newest round sits
    >tolerance below its best prior round is a regression."""
    by_metric = trajectory(records)
    lines: List[str] = []
    regressions: List[str] = []
    rounds_parsed = {
        rec["round"]
        for recs in by_metric.values()
        for rec in recs
        if rec.get("round") is not None
    }
    lines.append(
        f"bench trend: {sum(len(v) for v in by_metric.values())} scored "
        f"record(s), {len(by_metric)} metric(s), "
        f"{len(rounds_parsed)} round(s) parsed"
    )
    for metric in sorted(by_metric):
        recs = by_metric[metric]
        lines.append("")
        lines.append(f"{metric}:")
        best_prior: Optional[float] = None
        for rec in recs:
            value = rec["value"]
            label = (
                f"r{rec['round']:02d}" if rec.get("round") is not None
                else f"live#{rec.get('seq', '?')}"
            )
            delta = ""
            if best_prior is not None and best_prior > 0:
                pct = (value - best_prior) / best_prior * 100
                delta = f"  {pct:+7.1f}% vs best prior"
            lines.append(
                f"  {label:<8}{value:>14,.1f} {rec.get('unit', ''):<6}"
                f"{delta}  [{rec['source']}]"
            )
            best_prior = value if best_prior is None else max(best_prior, value)
        # Gate on the NEWEST ROUND only (history is context, not a
        # verdict).  Live bench.py appends (round=None) are shown above
        # but never gate: a casual laptop run or a documented zero-record
        # must not flip CI red against a real round's number.
        rounds = [r for r in recs if r.get("round") is not None]
        if len(rounds) >= 2:
            latest = rounds[-1]["value"]
            prior_best = max(r["value"] for r in rounds[:-1])
            if prior_best > 0 and latest < prior_best * (1 - tolerance):
                regressions.append(
                    f"{metric}: latest {latest:,.1f} is "
                    f"{(prior_best - latest) / prior_best * 100:.1f}% below "
                    f"best prior {prior_best:,.1f} ({rounds[-1]['source']})"
                )
    if regressions:
        lines.append("")
        lines.append(f"REGRESSIONS (> {tolerance * 100:.0f}% below best prior round):")
        for line in regressions:
            lines.append(f"  {line}")
    return lines, regressions


def _artifact_card(path: str) -> Optional[str]:
    """The ``card`` an artifact names at its top level, if any."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc.get("card") if isinstance(doc, dict) else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="bench_trend", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--repo", default=BUILD_DIR,
                        help="directory holding the round artifacts "
                        "(default: the checkout's build/)")
    parser.add_argument("--out", default=None,
                        help=f"trend index path (default: <repo>/{INDEX_NAME})")
    parser.add_argument("--no-write", action="store_true",
                        help="report only; do not update the index")
    parser.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                        help="regression gate: fail when the newest round "
                        "is more than this fraction below the best prior")
    args = parser.parse_args(argv)
    out = args.out or os.path.join(args.repo, INDEX_NAME)

    fresh: List[dict] = []
    for pattern in ARTIFACT_GLOBS:
        for path in sorted(glob.glob(os.path.join(args.repo, pattern))):
            if os.path.abspath(path) == os.path.abspath(out):
                continue
            card = _artifact_card(path)
            fresh.extend(dict(rec, card=card) if card else rec for rec in normalize(path))
    index = load_index(out)
    added = merge_index(index, fresh)
    if not args.no_write:
        write_index(index, out)
        print(f"{out}: {added} new record(s), "
              f"{len(index['records'])} total", file=sys.stderr)

    lines, regressions = regression_report(index["records"], args.tolerance)
    print("\n".join(lines))
    return 2 if regressions else 0


if __name__ == "__main__":
    raise SystemExit(main())
